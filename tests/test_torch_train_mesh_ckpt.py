"""Checkpoints and elastic restarts of the train step over a process mesh
(``launch.mesh.RankMesh``), on the CPU with gloo.

World 4 trains Qwen3 reduced on a (2, 2) mesh (``Trainer(mesh=...)``,
bf16 moments) for two steps, saves step 2 from the mesh, runs a third
step, resumes from step 2 on the same mesh and runs the third again, then
``elastic_restore``s step 2 onto (4, 1); world 2 then restores the same
step onto (1, 2) (``tests/train_mesh_ranks.py::ckpt_main``). Held:

  * the mesh's save writes the manifest and arrays of a one-device save
    of the same (gathered) state, and the JAX package loads it;
  * the resume on the same mesh is bit for bit;
  * every rank restored onto (4, 1), (1, 2), and a single process
    (the logical mesh), holds exactly its slice of each saved leaf, and
    one step runs finite there;
  * the same for the VLM (Qwen2-VL reduced, ``positions3`` given), the
    encoder-decoder (SeamlessM4T reduced: the ``enc``/``dec``/``xattn``
    leaves), the hybrid (Jamba reduced: the ``blocks/mamba`` leaves) and
    RWKV-6 (reduced: the ``tmix``/``cmix`` leaves) from a (2, 2) mesh,
    restored onto (4, 1) and a single process.
"""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_mesh_ranks as tr
from spawn_once import once
from repro.train import checkpoint as ref_ckpt
from repro_torch import configs
from repro_torch.core.tree import tree_leaves_with_path, tree_map
from repro_torch.distributed.spawn import run_ranks
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.dryrun import abstract_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import elastic_restore

SPAWN_LIMIT = 180.0
RESTORES = {4: (4, 1), 2: (1, 2)}
ARCH = "qwen3-0.6b"
FAMILY_ARCHS = {"vlm": "qwen2-vl-72b", "encdec": "seamless-m4t-large-v2",
                "hybrid": "jamba-1.5-large-398b", "ssm": "rwkv6-1.6b"}


def spawn_ckpt(tmp, arch, worlds):
    """``ckpt_main`` of ``arch`` at each (world, shape) of ``worlds``,
    one checkpoint directory for all."""
    directory = tmp / "ckpt"
    got = {}
    for w, shape in worlds:
        out = tmp / f"world{w}"
        out.mkdir()
        run_ranks(tr.ckpt_main, w, args=(str(directory), str(out), shape,
                                         RESTORES[w], arch),
                  backend="gloo", init_method=f"file://{out}/store",
                  timeout=60, join_timeout=SPAWN_LIMIT)
        got[w] = [pickle.loads((out / f"rank{r}.pkl").read_bytes())
                  for r in range(w)]
    return {"dir": str(directory), "world": got, "tmp": tmp, "arch": arch}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return once(tmp_path_factory, "train_mesh_ckpt", lambda: spawn_ckpt(
        tmp_path_factory.mktemp("train_mesh_ckpt"), ARCH,
        ((4, (2, 2)), (2, None))))


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory):
    """Each new family saved from (2, 2) and restored onto (4, 1)."""
    return once(tmp_path_factory, "train_mesh_ckpt_families", lambda: {
        f: spawn_ckpt(tmp_path_factory.mktemp(f"ckpt_{f}"), arch,
                      ((4, (2, 2)),))
        for f, arch in FAMILY_ARCHS.items()})


def whole_tree(runs):
    """The gathered step-2 state, as a tree of tensors."""
    flat = runs["world"][4][0]["whole"]
    return tr._unflatten(flat)


def manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def template(arch):
    cfg = configs.get_config(arch).reduced()
    _, shapes, _ = abstract_params(cfg)
    return {"params": shapes, "opt": {"mu": shapes, "nu": shapes,
                                      "step": None}}


def check_one_device_save(runs):
    one = ckpt.save_checkpoint(str(runs["tmp"] / "one"), 2,
                               whole_tree(runs), extra={"from": [2, 2]})
    mesh_dir = os.path.join(runs["dir"], "step_2")
    assert manifest(mesh_dir) == manifest(one)
    assert sorted(os.listdir(mesh_dir)) == sorted(os.listdir(one))
    for name in os.listdir(one):
        if name.endswith(".npz"):
            with np.load(os.path.join(one, name)) as a, \
                    np.load(os.path.join(mesh_dir, name)) as b:
                assert a.files == b.files
                for k in a.files:
                    assert a[k].dtype == b[k].dtype
                    assert a[k].tobytes() == b[k].tobytes(), k


def check_reference_loads(runs):
    whole = whole_tree(runs)

    def as_np(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(jnp.bfloat16)
        return t.numpy()
    want = tree_map(as_np, whole)
    got, extra, step = ref_ckpt.load_checkpoint(
        runs["dir"], jax.tree.map(jnp.asarray, want))
    assert step == 2 and extra == {"from": [2, 2]}
    have = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, got)))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        assert have[path].dtype == w.dtype
        assert have[path].tobytes() == w.tobytes(), path


def check_resume(runs):
    for r in runs["world"][4]:
        assert r["same"] and r["leaves"] > 0
        assert r["at"] == 2 and r["extra"] == {"from": [2, 2]}
        assert r["resumed"] == r["losses"][2:]
        assert all(np.isfinite(r["losses"]))
    assert len({tuple(r["losses"]) for r in runs["world"][4]}) == 1


def check_elastic_slices(runs, w):
    shape = RESTORES[w]
    whole = whole_tree(runs)
    stub = meshlib.Mesh(shape, ("data", "model"), "cpu")
    pspecs = meshlib.param_specs(whole["params"], stub)
    zspecs = meshlib.zero1_specs(pspecs, whole["params"], stub)
    specs = {"params": pspecs, "opt": {"mu": zspecs, "nu": zspecs,
                                       "step": ()}}
    spec_of = dict(tree_leaves_with_path(specs, is_leaf=meshlib.is_spec))
    for rank, r in enumerate(runs["world"][w]):
        got = r["restored"]
        coords = dict(zip(("data", "model"), got["coords"]))
        assert got["coords"] == tuple(np.unravel_index(rank, shape))
        for path, leaf in tree_leaves_with_path(whole):
            want = leaf
            for d, ax in enumerate(spec_of[path]):
                if ax is not None:
                    n = want.shape[d] // shape[("data", "model").index(ax)]
                    want = want.narrow(d, coords[ax] * n, n)
            key = "/".join(map(str, path))
            have = got["leaves"][key]
            assert have.dtype == want.dtype and torch.equal(have, want), key
            assert got["held"][key] == (
                tuple(want.shape), want.numel() * want.element_size())
        assert np.isfinite(got["losses"]).all()


def check_single_process_restore(runs):
    mesh = meshlib.make_host_mesh(1, 1, device="cpu")
    state, extra, step = elastic_restore(runs["dir"],
                                         template(runs["arch"]), mesh)
    assert step == 2
    whole = whole_tree(runs)
    for (p, a), (_, b) in zip(tree_leaves_with_path(state),
                              tree_leaves_with_path(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_mesh_save_is_the_one_device_save(runs):
    check_one_device_save(runs)


def test_reference_loads_the_mesh_save(runs):
    check_reference_loads(runs)


def test_resume_on_the_same_mesh_is_bit_for_bit(runs):
    check_resume(runs)


@pytest.mark.parametrize("w", sorted(RESTORES))
def test_elastic_restore_gives_each_rank_its_exact_slice(runs, w):
    check_elastic_slices(runs, w)


def test_elastic_restore_onto_a_single_process(runs):
    check_single_process_restore(runs)


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_family_mesh_save_is_the_one_device_save(family_runs, family):
    check_one_device_save(family_runs[family])


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_family_mesh_save_loads_into_the_reference(family_runs, family):
    check_reference_loads(family_runs[family])


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_family_resume_on_the_same_mesh_is_bit_for_bit(family_runs,
                                                       family):
    check_resume(family_runs[family])


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_family_elastic_restore_onto_4x1(family_runs, family):
    check_elastic_slices(family_runs[family], 4)


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_family_elastic_restore_onto_a_single_process(family_runs, family):
    check_single_process_restore(family_runs[family])
