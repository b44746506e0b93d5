"""The port's encoder-decoder (``repro_torch.models.encdec``) and the
attention modes it needs (``layers.attention`` with ``causal=False`` and
with precomputed ``kv=``, ``layers.cross_kv``) against the JAX package's on
the CPU.

Attention weights and inputs are seeded NumPy draws (scaled so the softmax
is far from uniform); the model is the reference's ``reduced()``
seamless-m4t config with its weights drawn from ``PRNGKey(0)``, fed
seeded source frames of a length other than the cache's ``max_len``:
forward logits, then prefill and three decode steps, the logits and every
cache leaf after each. f32 agrees within rtol=1e-4 / atol=1e-5 (the same
math; XLA and PyTorch round matmuls and transcendentals in their own
orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.core import interop
from repro_torch.models import layers
from test_torch_models import close, pair, tokens

D, H, KV, HD = 32, 4, 2, 8


def attn_params(seed, qk_norm=False):
    rng = np.random.default_rng(seed)
    p = {k: rng.normal(size=shape).astype(np.float32) * 0.3
         for k, shape in (("wq", (D, H * HD)), ("wk", (D, KV * HD)),
                          ("wv", (D, KV * HD)), ("wo", (H * HD, D)))}
    if qk_norm:
        p["q_norm"] = rng.uniform(0.5, 1.5, HD).astype(np.float32)
        p["k_norm"] = rng.uniform(0.5, 1.5, HD).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            interop.params_from_numpy(p, device="cpu"))


def activations(seed, b, s):
    return np.random.default_rng(seed).normal(size=(b, s, D)).astype(
        np.float32)


def positions(b, s, start=0):
    return (start + np.broadcast_to(np.arange(s), (b, s))).astype(np.int32)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_bidirectional_attention_matches_reference(qk_norm, packed):
    rp, pp = attn_params(50, qk_norm)
    x = activations(51, 2, 7)
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, causal=False,
              packed_gqa=packed)
    want = ref_layers.attention(rp, jnp.asarray(x),
                                positions=jnp.asarray(positions(2, 7)), **kw)
    got = layers.attention(pp, torch.from_numpy(x),
                           positions=torch.from_numpy(positions(2, 7)), **kw)
    close(got, want)
    # the first query sees the last key: the causal output differs there
    causal = layers.attention(pp, torch.from_numpy(x),
                              positions=torch.from_numpy(positions(2, 7)),
                              **{**kw, "causal": True})
    assert not torch.allclose(causal[:, 0], got[:, 0], atol=1e-3)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_and_cross_kv_match_reference(qk_norm, packed):
    rp, pp = attn_params(52, qk_norm)
    enc = activations(53, 2, 11)
    x = activations(54, 2, 3)
    want_kv = ref_layers.cross_kv(rp, jnp.asarray(enc), n_kv=KV, head_dim=HD)
    got_kv = layers.cross_kv(pp, torch.from_numpy(enc), n_kv=KV, head_dim=HD)
    for g, w in zip(got_kv, want_kv):
        assert tuple(g.shape) == w.shape == (2, 11, KV, HD)
        close(g, w)
    # decode positions far from 0: a rotated q or k would change the output
    pos = positions(2, 3, start=40)
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, packed_gqa=packed)
    want = ref_layers.attention(rp, jnp.asarray(x), positions=jnp.asarray(pos),
                                kv=want_kv, **kw)
    got = layers.attention(pp, torch.from_numpy(x),
                           positions=torch.from_numpy(pos), kv=got_kv, **kw)
    close(got, want)
    moved = layers.attention(pp, torch.from_numpy(x),
                             positions=torch.from_numpy(pos - 40),
                             kv=got_kv, **kw)
    assert torch.equal(moved, got)


@pytest.fixture(scope="module")
def seamless():
    return pair("seamless-m4t-large-v2")


def test_init_draws_the_reference_layout(seamless):
    _, rparams, port, _ = seamless
    mine = port.init(0)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), mine) == \
        jax.tree.map(lambda a: (a.shape, f"torch.{a.dtype}"), rparams)
    assert torch.equal(mine["dec"]["ln_x"], torch.ones(2, 64))
    assert abs(float(mine["dec"]["xattn"]["wk"].std()) - 0.02) < 2e-3


@pytest.mark.parametrize("src_len,max_len", [(11, 16), (20, 16)])
def test_forward_prefill_decode_match_reference(seamless, src_len, max_len):
    ref, rparams, port, params = seamless
    b, s, steps = 2, 6, 3
    toks = tokens(55, b, s + steps)
    src = np.random.default_rng(56).normal(
        size=(b, src_len, 64)).astype(np.float32)
    batch = {"src_embeds": src, "tokens": toks[:, :s]}
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, _ = ref.forward(rparams, rbatch)
    got, aux = port.forward(params, batch)
    close(got, want)
    assert float(aux) == 0.0
    rcache = ref.init_cache(b, max_len, src_len=src_len)
    pcache = port.init_cache(b, max_len, src_len=src_len)
    assert tuple(pcache["xk"].shape) == rcache["xk"].shape == \
        (2, b, src_len, 4, 16)
    want, rcache = ref.prefill(rparams, rbatch, rcache)
    got, pcache = port.prefill(params, batch, pcache)
    for t in range(steps + 1):
        close(got, want)
        assert pcache["len"] == int(rcache["len"]) == s + t
        for k in ("k", "v", "xk", "xv"):
            assert tuple(pcache[k].shape) == rcache[k].shape
            close(pcache[k], rcache[k])
        if t < steps:
            nxt = {"tokens": toks[:, s + t:s + t + 1]}
            want, rcache = ref.decode_step(rparams, nxt, rcache)
            got, pcache = port.decode_step(params, nxt, pcache)
    # decoding computes the forward over the same source and fed tokens
    full, _ = port.forward(params, {"src_embeds": src, "tokens": toks})
    close(got[:, 0], full[:, -1])


def test_prefill_replaces_the_cross_cache_for_another_source_length(
        seamless):
    """A cache made for one source length serves another: prefill puts the
    real source's cross K/V in ``xk``/``xv`` instead of copying them into
    the preallocated rows, so decode attends to no zero rows."""
    _, _, port, params = seamless
    src = np.random.default_rng(57).normal(size=(1, 5, 64)).astype(
        np.float32)
    toks = tokens(58, 1, 4)
    cache = port.init_cache(1, 8, src_len=9)
    _, cache = port.prefill(params, {"src_embeds": src,
                                     "tokens": toks[:, :3]}, cache)
    assert tuple(cache["xk"].shape) == (2, 1, 5, 4, 16)
    got, _ = port.decode_step(params, {"tokens": toks[:, 3:]}, cache)
    full, _ = port.forward(params, {"src_embeds": src, "tokens": toks})
    close(got[:, 0], full[:, -1])
