"""The port's sharding rules (``repro_torch.launch.mesh``) against the JAX
package's: the same spec trees, entry for entry.

Every shipped config at full size, its params drawn as fake tensors by
the port's dry run (``launch.dryrun.abstract_params``) and as
``ShapeDtypeStruct``s by the reference (``jax.eval_shape``), on the
production meshes (16, 16) and (2, 16, 16) and on small host meshes. The
reference's rules read a mesh's ``axis_names`` and ``devices.shape``
only, so it gets a stub with those, and no 256 devices. Param, ZeRO-1,
batch (every shape kind) and cache specs (decode, and the long_500k
sequence split) must be equal; a reference ``PartitionSpec`` is compared
as the tuple of its entries.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import batches as ref_batches
from repro.launch import mesh as ref_mesh
from repro.models import build_model as ref_build_model
from repro_torch import configs
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.data import input_specs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "host": ((2, 4), ("data", "model"))}


class StubMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


def specs_equal(got, want):
    """A port spec tree against a reference PartitionSpec tree."""
    g = dict(tree_leaves_with_path(got, is_leaf=meshlib.is_spec))
    w = {p: tuple(s) for p, s in tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
    assert g.keys() == w.keys()
    for p in w:
        assert g[p] == w[p], (p, g[p], w[p])


@pytest.fixture(scope="module", params=configs.ARCH_IDS)
def arch_trees(request):
    arch = request.param
    cfg = configs.get_config(arch)
    model, params, mode = dryrun.abstract_params(cfg)
    ref = ref_build_model(ref_configs.get_config(arch))
    rparams = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    return arch, cfg, model, params, mode, ref, rparams


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_and_zero1_specs_match_reference(arch_trees, mesh):
    _, _, _, params, _, _, rparams = arch_trees
    shape, names = MESHES[mesh]
    m = meshlib.make_mesh(shape, names, device="meta")
    stub = StubMesh(shape, names)
    pspecs = meshlib.param_specs(params, m)
    rspecs = ref_mesh.param_specs(rparams, stub)
    specs_equal(pspecs, rspecs)
    specs_equal(meshlib.zero1_specs(pspecs, params, m),
                ref_mesh.zero1_specs(rspecs, rparams, stub))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_cache_specs_match_reference(arch_trees, mesh):
    arch, cfg, model, _, mode, ref, _ = arch_trees
    rcfg = ref_configs.get_config(arch)
    shape, names = MESHES[mesh]
    m = meshlib.make_mesh(shape, names, device="meta")
    stub = StubMesh(shape, names)
    for s in configs.applicable_shapes(cfg):
        b = s.global_batch
        specs_equal(meshlib.batch_specs(
            input_specs(cfg, batch=b, seq=s.seq_len, kind=s.kind), m),
            ref_mesh.batch_specs(ref_batches.input_specs(
                rcfg, batch=b, seq=s.seq_len, kind=s.kind), stub))
    b = 128
    kw = {"src_len": 64} if cfg.family == "encdec" else {}
    with mode:
        cache = model.init_cache(b, 256, **kw)
    rcache = jax.eval_shape(lambda: ref.init_cache(b, 256, **kw))
    specs_equal(meshlib.cache_specs(cache, m, b),
                ref_mesh.cache_specs(rcache, stub, b))
    if cfg.subquadratic:
        with mode:
            cache = model.init_cache(1, 512, **kw)
        rcache = jax.eval_shape(lambda: ref.init_cache(1, 512, **kw))
        specs_equal(
            meshlib.cache_specs(cache, m, 1, seq_shard=True, seq_len=512),
            ref_mesh.cache_specs(rcache, stub, 1, seq_shard=True,
                                 seq_len=512))


def test_rules_on_a_reduced_model():
    from repro_torch.models import build_model
    cfg = configs.get_config("qwen3-0.6b").reduced()
    params = build_model(cfg, device="cpu").init(0)
    mesh = meshlib.make_host_mesh(1, 1, device="cpu")
    specs = meshlib.param_specs(params, mesh)
    assert specs["embed"] == ("model", None)
    assert specs["layers"]["attn"]["wq"] == (None, None, "model")
    assert specs["layers"]["mlp"]["w_down"] == (None, "model", None)
    assert all(ax is None for ax in specs["final_norm"])
    z = meshlib.zero1_specs(specs, params, mesh)
    assert "data" in z["layers"]["attn"]["wq"]
    sh = meshlib.param_shardings(params, mesh)
    assert sh["embed"].spec == ("model", None)
    assert sh["embed"].device == torch.device("cpu")


def test_meshes_are_logical_over_one_device():
    m = meshlib.make_production_mesh(multi_pod=True, device="cpu")
    assert m.axis_names == ("pod", "data", "model")
    assert m.devices.shape == (2, 16, 16) and m.size == 512
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert set(m.devices.flat) == {torch.device("cpu")}
    assert meshlib.batch_axes(m) == ("pod", "data")
    assert meshlib.batch_axes(meshlib.make_host_mesh(device="cpu")) == \
        ("data",)
    one = meshlib.make_mesh((1, 2), ("data", "model"),
                            devices=["cpu", "cpu"])
    assert one.device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        meshlib.make_mesh((1, 2), ("data", "model"),
                          devices=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError):
        meshlib.make_mesh((2,), ("data", "model"), device="cpu")


def test_set_mesh_is_ambient_and_nested():
    assert meshlib.get_mesh() is None
    a = meshlib.make_host_mesh(1, 4, device="cpu")
    b = meshlib.make_host_mesh(2, 2, device="cpu")
    with meshlib.set_mesh(a):
        assert meshlib.get_mesh() is a
        with meshlib.set_mesh(b):
            assert meshlib.get_mesh() is b
        assert meshlib.get_mesh() is a
    assert meshlib.get_mesh() is None
