"""The port's checkpoints (``repro_torch.train.checkpoint``) against the JAX
package's on the CPU: one on-disk format.

A state written by either package loads in the other with equal leaves
(bit for bit, bf16 included) and dtypes; both packages write the same
manifest entries (keys, shards, dtypes, shapes, 16-hex SHA-256 prefixes)
for the same state, also when it spans several shards. Round trip,
corruption detection, retention, the atomic rename and the elastic
restore are held as in the reference's own tests.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as ref_ckpt
from repro_torch import configs
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.launch import mesh as meshlib
from repro_torch.models import build_model
from repro_torch.optim import adamw_init
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import elastic


def state_np(seed=0):
    """A params/opt-shaped state as NumPy, bf16 leaves included."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    bf = lambda *s: f(*s).astype(jnp.bfloat16)
    return {"params": {"embed": f(16, 8), "layers": {"wq": bf(2, 8, 8),
                                                     "ln1": f(2, 8)}},
            "opt": {"mu": {"embed": bf(16, 8)}, "nu": {"embed": bf(16, 8)},
                    "step": np.asarray(7, np.int32)}}


def to_torch(tree):
    def conv(a):
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(conv, tree)


def to_np(tree):
    def conv(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(jnp.bfloat16)
        return t.numpy()
    return {k: conv(v) for k, v in tree_leaves_with_path(tree)}


def flat_np(tree):
    return {p: np.asarray(v) for p, v in tree_leaves_with_path(
        jax.tree.map(np.asarray, tree))}


def assert_same(port_tree, np_tree):
    got, want = to_np(port_tree), flat_np(np_tree)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("shard_bytes", [512 << 20, 300])
def test_both_packages_write_the_same_manifest(tmp_path, shard_bytes):
    st = state_np()
    a = ckpt.save_checkpoint(str(tmp_path / "port"), 3, to_torch(st),
                             extra={"cursor": 3}, shard_bytes=shard_bytes)
    b = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 3,
                                 jax.tree.map(jnp.asarray, st),
                                 extra={"cursor": 3}, shard_bytes=shard_bytes)
    assert manifest(a) == manifest(b)
    assert (len(manifest(a)["shards"]) > 1) == (shard_bytes < 1e6)
    assert manifest(a)["entries"]["params/layers/wq"]["dtype"] == "bfloat16"


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    st = state_np(1)
    ref_ckpt.save_checkpoint(str(tmp_path), 5, jax.tree.map(jnp.asarray, st),
                             extra={"seed": 1})
    template = jax.tree.map(lambda t: torch.zeros_like(t), to_torch(st))
    got, extra, step = ckpt.load_checkpoint(str(tmp_path), template)
    assert step == 5 and extra == {"seed": 1}
    assert_same(got, st)
    assert got["opt"]["mu"]["embed"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int32


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    st = state_np(2)
    ckpt.save_checkpoint(str(tmp_path), 9, to_torch(st))
    got, _, step = ref_ckpt.load_checkpoint(
        str(tmp_path), jax.tree.map(jnp.asarray, st))
    assert step == 9
    want, have = flat_np(st), flat_np(got)
    for k in want:
        assert have[k].dtype == want[k].dtype
        assert have[k].tobytes() == want[k].tobytes(), k


def test_roundtrip_of_a_model_state(tmp_path):
    cfg = configs.get_config("dbrx-132b").reduced(param_dtype="bfloat16")
    params = build_model(cfg, device="cpu").init(0)
    state = {"params": params, "opt": adamw_init(params)}
    path = ckpt.save_checkpoint(str(tmp_path), 3, state, extra={"cursor": 3})
    assert os.path.basename(path) == "step_3"
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    loaded, extra, step = ckpt.load_checkpoint(str(tmp_path), state)
    assert step == 3 and extra["cursor"] == 3
    for (p, a), (q, b) in zip(tree_leaves_with_path(state),
                              tree_leaves_with_path(loaded)):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b), p


def test_corruption_detected(tmp_path):
    state = {"w": torch.arange(64, dtype=torch.float32)}
    path = ckpt.save_checkpoint(str(tmp_path), 1, state)
    shard = os.path.join(path, "shard_0.npz")
    data = dict(np.load(shard))
    data["w"] = data["w"] + 1
    np.savez(shard, **data)
    with pytest.raises(IOError, match="corruption"):
        ckpt.load_checkpoint(str(tmp_path), state)


def test_retention_and_latest_step(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path), {"w": torch.zeros(4)})
    state = {"w": torch.zeros((4,))}
    for s in range(6):
        ckpt.save_checkpoint(str(tmp_path), s, state, keep_last=3)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5
    os.makedirs(tmp_path / "step_9.tmp")          # a write that died
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_elastic_restore_onto_a_new_mesh(tmp_path):
    cfg = configs.get_config("qwen3-0.6b").reduced()
    params = build_model(cfg, device="cpu").init(0)
    state = {"params": params, "opt": adamw_init(params)}
    ckpt.save_checkpoint(str(tmp_path), 4, state)
    mesh = meshlib.make_host_mesh(2, 4, device="cpu")
    got, _, step = elastic.elastic_restore(str(tmp_path), state, mesh)
    assert step == 4
    for (p, a), (_, b) in zip(tree_leaves_with_path(state),
                              tree_leaves_with_path(got)):
        assert torch.equal(a, b) and b.device == mesh.device, p
    plan = elastic.remesh_plan(params, (4, 4), mesh, global_batch=8)
    assert plan == {"old_mesh": (4, 4), "new_mesh": (2, 4),
                    "per_device_batch": 4, "grad_accum": 1}
    with pytest.raises(ValueError, match="not divisible"):
        elastic.remesh_plan(params, (4, 4), mesh, global_batch=7)
