"""The port's batches and token pipeline (``repro_torch.data``) against the
JAX package's on the CPU: bit for bit.

Both draw from the same NumPy generators in the same order, so tokens,
labels and the stub embeddings (drawn in f32; bf16 ones rounded to
nearest even by both) must be equal bit for bit, for every family's
input tree (dense, vlm with patch embeddings, encdec with source frames)
and for every shard of a step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import batches as ref_batches
from repro.data.pipeline import SyntheticTokenPipeline as RefPipeline
from repro_torch import configs
from repro_torch.core import interop
from repro_torch.data import (ShapeDtypeStruct, SyntheticTokenPipeline,
                              input_specs, make_batch)

ARCHS = ("qwen3-0.6b", "qwen2-vl-72b", "dbrx-132b", "rwkv6-1.6b",
         "seamless-m4t-large-v2")


def bits(x):
    """A tensor's or array's bytes and dtype name (bf16 by its bits)."""
    if isinstance(x, torch.Tensor):
        return interop.to_numpy(x, np.dtype(jnp.bfloat16)
                                if x.dtype == torch.bfloat16 else None)
    return np.asarray(x)


def assert_same(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        g, w = bits(got[k]), bits(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def cfgs(arch, reduced):
    p, r = configs.get_config(arch), ref_configs.get_config(arch)
    return (p.reduced(), r.reduced()) if reduced else (p, r)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_and_specs_bit_for_bit(arch, kind, reduced):
    pc, rc = cfgs(arch, reduced)
    got = make_batch(pc, batch=2, seq=24, kind=kind, seed=7, device="cpu")
    want = ref_batches.make_batch(rc, batch=2, seq=24, kind=kind, seed=7)
    assert_same(got, want)
    specs = input_specs(pc, batch=2, seq=24, kind=kind)
    rspecs = ref_batches.input_specs(rc, batch=2, seq=24, kind=kind)
    assert list(specs) == list(rspecs)
    for k, s in specs.items():
        assert isinstance(s, ShapeDtypeStruct)
        assert s.shape == rspecs[k].shape and s.ndim == len(s.shape)
        assert str(s.dtype) == f"torch.{rspecs[k].dtype}"
        assert tuple(got[k].shape) == s.shape and got[k].dtype == s.dtype


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_bit_for_bit(arch, shards):
    pc, rc = cfgs(arch, reduced=arch != "seamless-m4t-large-v2")
    for shard in range(shards):
        mine = SyntheticTokenPipeline(pc, 8, 32, seed=5, num_shards=shards,
                                      shard=shard, device="cpu")
        ref = RefPipeline(rc, 8, 32, seed=5, num_shards=shards, shard=shard)
        for step in (0, 13):
            assert_same(mine.get_batch(step), ref.get_batch(step))
        assert mine.cursor_state(9) == ref.cursor_state(9)


def test_pipeline_is_deterministic_and_shards_differ():
    cfg = configs.get_config("smollm-135m").reduced()
    a = SyntheticTokenPipeline(cfg, 8, 32, seed=5, device="cpu")
    b = SyntheticTokenPipeline(cfg, 8, 32, seed=5, device="cpu")
    assert torch.equal(a.get_batch(13)["tokens"], b.get_batch(13)["tokens"])
    assert not torch.equal(a.get_batch(13)["tokens"],
                           a.get_batch(14)["tokens"])
    s0, s1 = (SyntheticTokenPipeline(cfg, 8, 32, num_shards=2, shard=s,
                                     device="cpu").get_batch(0)
              for s in (0, 1))
    assert tuple(s0["tokens"].shape) == (4, 32)
    assert not torch.equal(s0["tokens"], s1["tokens"])
    with pytest.raises(ValueError, match="shards"):
        SyntheticTokenPipeline(cfg, 6, 32, num_shards=4, device="cpu")


def test_next_token_labels():
    cfg = configs.get_config("smollm-135m").reduced()
    b = SyntheticTokenPipeline(cfg, 4, 16, device="cpu").get_batch(0)
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert torch.equal(b["labels"][:, -1], torch.zeros(4, dtype=torch.int32))
    assert b["tokens"].dtype == torch.int32
    assert int(b["tokens"].max()) < cfg.vocab and int(b["tokens"].min()) >= 0


def test_entry_points_default_to_cuda():
    cfg = configs.get_config("smollm-135m").reduced()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch(cfg, batch=1, seq=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticTokenPipeline(cfg, 1, 4)
