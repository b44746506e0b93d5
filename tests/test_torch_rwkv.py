"""The port's RWKV-6 block and language model (``repro_torch.models.rwkv``,
``rwkv_lm``) against the JAX package's on the CPU.

Module tests take the reference's ``init_rwkv_tmix``/``init_rwkv_cmix``
from ``PRNGKey(0)`` and replace the leaves it initialises to constants
(the token-shift mixes, the decay base, the bonus ``u``, the head-norm
scale) with seeded NumPy draws, so every term of the WKV recurrence moves
the output. The model tests run the reference's ``reduced()`` rwkv6 config
with its own weights: forward logits, then prefill and three decode steps,
the logits and every cache leaf after each. f32 agrees within
rtol=1e-4 / atol=1e-5 (the same math, matmuls and transcendentals rounded
in XLA's and PyTorch's own orders); the bf16 projections of ``bf16_comm``
within 2% of the output's scale (a few bf16 ulps, rounded in their own
orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as ref_rwkv
from repro_torch.core import interop
from repro_torch.models import build_model, rwkv
from test_torch_models import close, pair, to_np, tokens

D, HEADS, FF = 32, 4, 48


def tmix_params():
    p = ref_rwkv.init_rwkv_tmix(jax.random.PRNGKey(0), D, HEADS)
    rng = np.random.default_rng(30)
    p = to_np(p)
    for k in ("mix_r", "mix_k", "mix_v", "mix_w", "w_base", "ln_x"):
        p[k] = rng.uniform(0.1, 0.9, size=p[k].shape).astype(np.float32)
    p["w_base"] -= 1.0
    p["u"] = rng.normal(size=p["u"].shape).astype(np.float32)
    for k in ("wr", "wk", "wv", "wo", "w_dd"):
        p[k] = p[k] * 10
    return ({k: jnp.asarray(v) for k, v in p.items()},
            interop.params_from_numpy(p, device="cpu"))


def cmix_params():
    p = to_np(ref_rwkv.init_rwkv_cmix(jax.random.PRNGKey(0), D, FF))
    p["mix_k"] = np.random.default_rng(31).uniform(
        0.1, 0.9, size=D).astype(np.float32)
    p = {k: v * 10 if k != "mix_k" else v for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            interop.params_from_numpy(p, device="cpu"))


def inputs(seed, b, s):
    return np.random.default_rng(seed).normal(size=(b, s, D)).astype(
        np.float32)


def tol(want, bf16):
    if not bf16:
        return {}
    return dict(rtol=0, atol=0.02 * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("bf16_comm,shard_hints",
                         [(False, False), (True, False), (True, True),
                          (False, True)])
def test_tmix_forward_then_steps_match_reference(bf16_comm, shard_hints):
    rp, pp = tmix_params()
    x = inputs(32, 2, 10)
    want, wst = ref_rwkv.rwkv_tmix_forward(
        rp, jnp.asarray(x[:, :7]), HEADS, return_state=True,
        bf16_comm=bf16_comm, shard_hints=shard_hints)
    got, gst = rwkv.rwkv_tmix_forward(
        pp, torch.from_numpy(x[:, :7]), HEADS, return_state=True,
        bf16_comm=bf16_comm, shard_hints=shard_hints)
    close(got, want, **tol(want, bf16_comm))
    close(gst["S"], wst["S"], **tol(wst["S"], bf16_comm))
    close(gst["x_prev"], wst["x_prev"])
    for t in range(7, 10):
        xt = x[:, t:t + 1]
        want, wst = ref_rwkv.rwkv_tmix_step(rp, wst, jnp.asarray(xt), HEADS,
                                            bf16_comm=bf16_comm)
        got, gst = rwkv.rwkv_tmix_step(pp, gst, torch.from_numpy(xt), HEADS,
                                       bf16_comm=bf16_comm)
        close(got, want, **tol(want, bf16_comm))
        close(gst["S"], wst["S"], **tol(wst["S"], bf16_comm))
        close(gst["x_prev"], wst["x_prev"])


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("bf16_comm", [False, True])
def test_cmix_forward_matches_reference(carry, bf16_comm):
    rp, pp = cmix_params()
    x = inputs(33, 2, 6)
    prev = inputs(34, 2, 1)[:, 0] if carry else None
    want = ref_rwkv.rwkv_cmix_forward(
        rp, jnp.asarray(x), None if prev is None else jnp.asarray(prev),
        bf16_comm=bf16_comm)
    got = rwkv.rwkv_cmix_forward(
        pp, torch.from_numpy(x),
        None if prev is None else torch.from_numpy(prev),
        bf16_comm=bf16_comm)
    close(got, want, **tol(want, bf16_comm))


def test_token_shift_promotes_a_bf16_input_with_an_f32_carry():
    x = inputs(35, 2, 4)
    carry = inputs(36, 2, 1)[:, 0]
    xb = jnp.asarray(x, jnp.bfloat16)
    want = ref_rwkv._token_shift(xb, jnp.asarray(carry))
    got = rwkv._token_shift(interop.to_tensor(np.asarray(xb), device="cpu"),
                            torch.from_numpy(carry))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_state_matches_reference():
    want = ref_rwkv.rwkv_init_state(3, D, HEADS)
    got = rwkv.rwkv_init_state(3, D, HEADS, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 and not v.any()
               for v in got.values())


@pytest.fixture(scope="module")
def rwkv6():
    return pair("rwkv6-1.6b")


def test_lm_init_draws_the_reference_layout(rwkv6):
    _, rparams, port, _ = rwkv6
    mine = port.init(0)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), mine) == \
        jax.tree.map(lambda a: (a.shape, f"torch.{a.dtype}"), rparams)
    tm = mine["layers"]["tmix"]
    assert torch.equal(tm["mix_r"], torch.full((2, 64), 0.5))
    assert not tm["u"].any() and not tm["w_base"].any()
    assert abs(float(tm["w_dd"].std()) - 0.002) < 2e-4


def test_lm_forward_prefill_decode_match_reference(rwkv6):
    ref, rparams, port, params = rwkv6
    b, s, steps = 2, 9, 3
    toks = tokens(37, b, s + steps)
    batch = {"tokens": toks[:, :s]}
    want, _ = ref.forward(rparams, batch)
    got, aux = port.forward(params, batch)
    close(got, want)
    assert float(aux) == 0.0
    rcache, pcache = ref.init_cache(b, 16), port.init_cache(b, 16)
    want, rcache = ref.prefill(rparams, batch, rcache)
    got, pcache = port.prefill(params, batch, pcache)
    for t in range(steps + 1):
        close(got, want)
        assert pcache["len"] == int(rcache["len"]) == s + t
        for k in ("S", "x_prev", "x_prev_c"):
            close(pcache[k], rcache[k])
        if t < steps:
            nxt = {"tokens": toks[:, s + t:s + t + 1]}
            want, rcache = ref.decode_step(rparams, nxt, rcache)
            got, pcache = port.decode_step(params, nxt, pcache)


def test_lm_in_float64_keeps_float64_and_decodes_the_forward(rwkv6):
    """The port's float64 mode, which the reference (no JAX x64) lacks:
    the same weights cast to f64 keep f64 in the logits and every cache
    leaf, agree with the f32 reference within its tolerance, and prefill
    plus decode give the forward's rows to f64 rounding."""
    ref, rparams, port, params = rwkv6
    cfg = dataclasses.replace(port.cfg, dtype="float64",
                              param_dtype="float64")
    wide = build_model(cfg, device="cpu")
    wparams = jax.tree.map(lambda t: t.double(), params)
    b, s, steps = 2, 9, 3
    toks = tokens(38, b, s + steps)
    full, _ = wide.forward(wparams, {"tokens": toks})
    assert full.dtype == torch.float64
    close(full, ref.forward(rparams, {"tokens": toks})[0])
    cache = wide.init_cache(b, 16)
    got, cache = wide.prefill(wparams, {"tokens": toks[:, :s]}, cache)
    rows = [got[:, 0]]
    for t in range(s, s + steps):
        got, cache = wide.decode_step(
            wparams, {"tokens": toks[:, t:t + 1]}, cache)
        rows.append(got[:, 0])
    assert all(cache[k].dtype == torch.float64
               for k in ("S", "x_prev", "x_prev_c"))
    close(torch.stack(rows, dim=1), full[:, s - 1:].numpy(), rtol=1e-12,
          atol=1e-12)
