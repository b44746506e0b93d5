"""The port's train step over a process mesh (``launch.mesh.RankMesh``:
one rank per mesh position, each holding only its shards) against the
JAX package's GSPMD step (``train.trainer.shard_train_step``) on the same
mesh shape, on the CPU.

The reference runs in subprocesses on 8 forced host devices, on meshes
built with ``Auto`` axis types: ``launch.mesh.make_host_mesh`` gives
``Explicit`` axes on the installed JAX, where the sharded step's embedding
gather fails (ROADMAP, reference caveats). Its inputs are placed under
its own specs first and every case runs under ``jax.sharding.set_mesh``,
so the EP MoE takes its ``shard_map`` path. The port runs over gloo
worlds 2 and 4 (8 with ``--runslow``), each spawned once for the module
(``tests/train_mesh_ranks.py``). Every case draws its f32 params from the
port's seeded init, runs its steps with f32 moments, and is held:

  * loss and grad_norm at every step within rtol 1e-5 of the
    reference's, and equal bit for bit on every rank;
  * every updated leaf, gathered (params and both moments: the moments
    carry the clipped gradient), within the relative L2 error of
    tests/test_torch_train.py (GRAD_REL_L2);
  * each rank holding only its ``param_specs`` / ``zero1_specs`` shards
    and its ``batch_specs`` block: the shapes and the storage bytes.

The cases cover what looks right on a (1, 1) mesh and is wrong elsewhere:
heads that do not line up with the column cut (SmolLM's published 9
heads over 3 kv heads, at widths cut to 8 per head: 4.5 heads a rank;
Qwen3 reduced at model 4: half a kv head a rank), a loss mask uneven
across the data shards, a batch of 1 that every data rank holds whole,
attention weights that ``param_specs`` leaves whole because ``model``
does not divide their width (Qwen3 reduced at 3 heads of 6 at model 4:
``wq``/``wk``/``wv``/``wo`` all whole, the kv groups shared out one a
rank and the fourth rank left none; at 4 query heads over 1 kv head of
6: ``wq`` cut, ``wk``/``wv`` whole),
the ('pod', 'data', 'model') mesh, the GSPMD MoE with a capacity that
drops tokens (queue places follow the global token order), and the EP
MoE (A14d) on (1, 4) and (2, 2), there also on a batch of 1 (each rank
runs every data block for its expert) — (2, 4) and (4, 2) with
``--runslow``.
"""
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import train_mesh_ranks as tr
from repro_torch.distributed.spawn import run_ranks
from repro_torch.launch import mesh as meshlib

ROOT = Path(__file__).resolve().parents[1]
GRAD_REL_L2, METRIC_RTOL = 2e-5, 1e-5       # as tests/test_torch_train.py
SPAWN_LIMIT = 180.0
DN = ("data", "model")
CASES = {
    "smollm_9_heads_2x2": dict(arch="smollm-135m", mesh=(2, 2), axes=DN,
                               ov={"n_heads": 9, "n_kv_heads": 3,
                                   "head_dim": 8}, batch=4, seq=16,
                               steps=3),
    "qwen3_1x4": dict(arch="qwen3-0.6b", mesh=(1, 4), axes=DN, batch=4,
                      seq=16, steps=3),
    "qwen3_pod_2x1x2": dict(arch="qwen3-0.6b", mesh=(2, 1, 2),
                            axes=("pod", "data", "model"), batch=4, seq=16,
                            steps=2),
    "qwen3_mask_2x2": dict(arch="qwen3-0.6b", mesh=(2, 2), axes=DN,
                           batch=4, seq=16, steps=2, mask=True),
    "qwen3_batch1_2x2": dict(arch="qwen3-0.6b", mesh=(2, 2), axes=DN,
                             batch=1, seq=16, steps=2),
    "dbrx_drop_2x2": dict(arch="dbrx-132b", mesh=(2, 2), axes=DN,
                          ov={"capacity_factor": 0.5}, batch=4, seq=16,
                          steps=2),
    "dbrx_ep_1x4": dict(arch="dbrx-132b", mesh=(1, 4), axes=DN, ep=True,
                        batch=4, seq=16, steps=2),
    "dbrx_ep_2x2": dict(arch="dbrx-132b", mesh=(2, 2), axes=DN, ep=True,
                        ov={"n_experts": 2, "top_k": 1}, batch=4, seq=16,
                        steps=2),
    "dbrx_ep_batch1_2x2": dict(arch="dbrx-132b", mesh=(2, 2), axes=DN,
                               ep=True, ov={"n_experts": 2, "top_k": 1},
                               batch=1, seq=16, steps=2),
    "qwen3_whole_qkvo_1x4": dict(arch="qwen3-0.6b", mesh=(1, 4), axes=DN,
                                 ov={"n_heads": 3, "n_kv_heads": 3,
                                     "head_dim": 6}, batch=4, seq=16,
                                 steps=2),
    "qwen3_whole_kv_1x4": dict(arch="qwen3-0.6b", mesh=(1, 4), axes=DN,
                               ov={"n_heads": 4, "n_kv_heads": 1,
                                   "head_dim": 6}, batch=4, seq=16,
                               steps=2),
    "smollm_9_heads_1x2": dict(arch="smollm-135m", mesh=(1, 2), axes=DN,
                               ov={"n_heads": 9, "n_kv_heads": 3,
                                   "head_dim": 8}, batch=2, seq=16,
                               steps=2),
    "qwen3_mask_2x1": dict(arch="qwen3-0.6b", mesh=(2, 1), axes=DN,
                           batch=4, seq=16, steps=2, mask=True),
    "dbrx_ep_2x4": dict(arch="dbrx-132b", mesh=(2, 4), axes=DN, ep=True,
                        batch=4, seq=16, steps=2),
    "dbrx_ep_4x2": dict(arch="dbrx-132b", mesh=(4, 2), axes=DN, ep=True,
                        ov={"n_experts": 2, "top_k": 1,
                            "capacity_factor": 0.5}, batch=4, seq=16,
                        steps=2),
}
SLOW = {"dbrx_ep_2x4", "dbrx_ep_4x2"}


def world_of(name) -> int:
    return int(np.prod(CASES[name]["mesh"]))


def case_param(name):
    return pytest.param(name, marks=pytest.mark.slow) if name in SLOW \
        else name


NAMES = [case_param(n) for n in CASES]


# ---------------------------------------------------------------------------
# the reference's sharded step (run as a script in a subprocess)
# ---------------------------------------------------------------------------

def _reference(inputs_path, out_path, names):
    import dataclasses
    import jax
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.launch import mesh as rmesh
    from repro.models import build_model
    from repro.optim import adamw_init
    from repro.train.trainer import shard_train_step
    z = np.load(inputs_path)
    out = {}
    for name in names:
        case = CASES[name]
        cfg = configs.get_config(case["arch"]).reduced(**case.get("ov", {}))
        if case.get("ep"):
            cfg = dataclasses.replace(cfg, moe_a2a=True)
        model = build_model(cfg)
        pre = f"{name}/"
        flat = {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}
        params = tr._unflatten({k[2:]: v for k, v in flat.items()
                                if k.startswith("p/")})
        batch = {k[2:]: v for k, v in flat.items() if k.startswith("b/")}
        opt = adamw_init(params, state_dtype="float32")
        n = world_of(name)
        mesh = jax.make_mesh(case["mesh"], case["axes"],
                             axis_types=(AxisType.Auto,) * len(case["axes"]),
                             devices=jax.devices()[:n])
        pspecs = rmesh.param_specs(params, mesh)
        zspecs = rmesh.zero1_specs(pspecs, params, mesh)

        def put(tree, specs):
            return jax.tree_util.tree_map(
                lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                tree, specs, is_leaf=lambda x: isinstance(x, P))
        step = shard_train_step(model, mesh, params, opt, batch)
        p = put(params, pspecs)
        o = {"mu": put(opt["mu"], zspecs), "nu": put(opt["nu"], zspecs),
             "step": opt["step"]}
        b = put(batch, rmesh.batch_specs(batch, mesh))
        with jax.sharding.set_mesh(mesh):
            for i in range(case["steps"]):
                p, o, m = step(p, o, b)
                for k in ("loss", "grad_norm", "lr"):
                    out[f"{name}/m/{i}/{k}"] = np.asarray(m[k])
        whole = jax.tree_util.tree_map(np.asarray, {"p": p, "o": o})
        for path, leaf in jax.tree_util.tree_leaves_with_path(whole):
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            out[f"{name}/w/{key}"] = leaf
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the runs: the reference in subprocesses, each world spawned once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh")
    slow = request.config.getoption("--runslow")
    names = [n for n in CASES if slow or n not in SLOW]
    arrays = {}
    for name in names:
        params, batch = tr.case_inputs(name, CASES[name])
        arrays.update({f"{name}/p/{k}": v
                       for k, v in tr._flat(params).items()})
        arrays.update({f"{name}/b/{k}": v for k, v in batch.items()})
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    worlds = sorted({world_of(n) for n in names})
    # one reference process per world, running while the worlds spawn
    refs = {w: subprocess.Popen(
        [sys.executable, __file__, "--ref", str(inputs),
         str(tmp / f"ref{w}.npz"),
         json.dumps([n for n in names if world_of(n) == w])],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for w in worlds}
    got, seconds = {}, {}
    try:
        for w in worlds:
            out = tmp / f"world{w}"
            out.mkdir()
            t0 = time.perf_counter()
            run_ranks(tr.train_main, w,
                      args=(str(inputs), {n: CASES[n] for n in names},
                            str(out)),
                      backend="gloo", init_method=f"file://{out}/store",
                      timeout=60, join_timeout=SPAWN_LIMIT)
            seconds[w] = time.perf_counter() - t0
            got[w] = [pickle.loads((out / f"rank{r}.pkl").read_bytes())
                      for r in range(w)]
        for proc in refs.values():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
    finally:
        for proc in refs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ref = {}
    for w in worlds:
        with np.load(tmp / f"ref{w}.npz") as z:
            ref.update(dict(z))
    return {"ref": ref, "world": got, "seconds": seconds}


def ranks_of(runs, name):
    return [r["cases"][name] for r in runs["world"][world_of(name)]]


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grad_norm_match_the_reference_step(runs, name):
    ranks = ranks_of(runs, name)
    for i, m in enumerate(ranks[0]["metrics"]):
        for k in ("loss", "grad_norm"):
            want = float(runs["ref"][f"{name}/m/{i}/{k}"])
            np.testing.assert_allclose(m[k + "_f"], want, rtol=METRIC_RTOL,
                                       err_msg=f"step {i} {k}")
        assert m["lr_f"] == float(runs["ref"][f"{name}/m/{i}/lr"])
    for r in ranks[1:]:                      # equal on every rank
        assert [{k: m[k] for k in ("loss", "grad_norm", "lr")}
                for m in r["metrics"]] == \
            [{k: m[k] for k in ("loss", "grad_norm", "lr")}
             for m in ranks[0]["metrics"]]


@pytest.mark.parametrize("name", NAMES)
def test_every_updated_leaf_matches_the_reference(runs, name):
    whole = ranks_of(runs, name)[0]["whole"]
    want = {k[len(name) + 3:]: v for k, v in runs["ref"].items()
            if k.startswith(f"{name}/w/")}
    assert set(whole) == set(want)
    worst = max((rel_l2(whole[k], want[k]), k) for k in want
                if want[k].dtype.kind == "f")
    assert worst[0] <= GRAD_REL_L2, worst
    assert np.array_equal(whole["o/step"], want["o/step"])


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_only_its_shards(runs, name):
    """Between steps: every leaf of params, moments and batch has its
    shard's shape under the reference's specs, and its storage holds
    that shard's bytes and no more."""
    from repro_torch.core.tree import tree_leaves_with_path
    case = CASES[name]
    params, batch = tr.case_inputs(name, case)
    stub = meshlib.Mesh(tuple(case["mesh"]), tuple(case["axes"]), "cpu")
    pspecs = meshlib.param_specs(params, stub)
    zspecs = meshlib.zero1_specs(pspecs, params, stub)
    want = {"o/step": ((), 4)}
    for pre, tree, specs in (("p", params, pspecs), ("o/mu", params, zspecs),
                             ("o/nu", params, zspecs),
                             ("b", batch, meshlib.batch_specs(batch, stub))):
        spec_of = dict(tree_leaves_with_path(specs, is_leaf=meshlib.is_spec))
        for path, leaf in tree_leaves_with_path(tree):
            shape = list(leaf.shape)
            for d, ax in enumerate(spec_of[path]):
                for a in (() if ax is None else
                          (ax,) if isinstance(ax, str) else ax):
                    shape[d] //= stub.shape[a]
            key = "/".join((pre,) + tuple(map(str, path)))
            want[key] = (tuple(shape), int(np.prod(shape)) * leaf.itemsize)
    for r in ranks_of(runs, name):
        assert r["held"] == want
    split = case["batch"] % int(np.prod(case["mesh"][:-1])) == 0
    assert all(r["batch_split"] == split for r in ranks_of(runs, name))


def test_the_drop_case_drops():
    """At capacity factor 0.5 the GSPMD MoE drops tokens: its loss is
    not the dropless one's."""
    from repro_torch.core.interop import params_from_numpy
    from repro_torch.models import build_model
    import dataclasses
    import torch
    case = CASES["dbrx_drop_2x2"]
    params, batch = tr.case_inputs("dbrx_drop_2x2", case)
    params = params_from_numpy(params, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    cfg = tr.case_config(case)
    drop = build_model(cfg, device="cpu").loss(params, batch)
    full = build_model(dataclasses.replace(cfg, capacity_factor=8.0),
                       device="cpu").loss(params, batch)
    assert abs(float(drop) - float(full)) > 1e-4


@pytest.mark.parametrize("name", [case_param(n) for n in CASES
                                  if CASES[n].get("ep")])
def test_ep_runs_one_expert_per_rank_and_one_all_reduce(runs, name):
    """A14d: each rank holds one expert's weights, and the EP layer's
    forward makes exactly one collective, the combine's all-reduce over
    ``model`` (the reference's psum)."""
    cfg = tr.case_config(CASES[name])
    for r in ranks_of(runs, name):
        ep = r["ep"]
        assert ep["w_gate"] == (1, cfg.d_model, cfg.d_ff)
        assert [axis for axis, _ in ep["all_reduces"]] == ["model"]


# ---------------------------------------------------------------------------
# the mesh, the collectives and the tensor-parallel pair
# ---------------------------------------------------------------------------

WORLDS = (2, 4)


@pytest.mark.parametrize("w", WORLDS)
def test_ranks_take_row_major_positions(runs, w):
    for rank, r in enumerate(runs["world"][w]):
        for name, rec in r["cases"].items():
            shape = CASES[name]["mesh"]
            assert rec["coords"] == tuple(
                int(c) for c in np.unravel_index(rank, shape))


@pytest.mark.parametrize("w", WORLDS)
def test_collectives_over_a_line(runs, w):
    base = np.arange(2 * w, dtype=np.float32)
    total = sum(range(1, w + 1))
    for rank, r in enumerate(runs["world"][w]):
        pr = r["probes"]
        assert pr["lines"] == {"data": None, "model": (rank, w)}
        assert pr["sum"] == (base * total).tolist()
        assert pr["bf16"] == (base * total).tolist()
        assert pr["max"] == (base * w).tolist()
        want = (base * total).reshape(w, 2)[rank:rank + 1]
        assert pr["scatter"] == want.tolist()


@pytest.mark.parametrize("w", WORLDS)
def test_copy_and_reduce_are_megatrons_pair(runs, w):
    """copy: identity forward, gradient summed over ``model``; reduce: sum
    forward, identity backward (``torch.distributed.nn``'s all_reduce
    would sum the gradient too); gather_last: columns side by side
    forward, each rank's columns' summed gradient backward."""
    total = sum(range(1, w + 1))
    for rank, r in enumerate(runs["world"][w]):
        pr = r["probes"]
        assert pr["copy"] == ([rank + 1.0] * 3, [float(total)] * 3)
        assert pr["reduce"] == ([float(total)] * 3, [rank + 1.0] * 3)
        y, g = pr["gather_last"]
        assert y == [sum(([q + 1.0] * 2 for q in range(w)), [])] * 2
        cols = np.arange(2 * w, dtype=np.float64)[2 * rank:2 * rank + 2]
        assert g == [(cols * w).tolist()] * 2


if __name__ == "__main__" and sys.argv[1:2] == ["--ref"]:
    _reference(sys.argv[2], sys.argv[3], json.loads(sys.argv[4]))
