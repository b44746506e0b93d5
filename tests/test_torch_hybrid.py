"""The port's Jamba-style hybrid (``repro_torch.models.hybrid``: Mamba and
attention superblocks with MoE every ``moe_period`` layers) against the
JAX package's on the CPU.

Two ``reduced()`` jamba configs, weights drawn by the reference from
``PRNGKey(0)`` and carried over by ``interop.params_from_numpy``: one
superblock of the published period 8 (7 Mamba layers, attention at index
4, MoE on the odd layers) and the period-2 cut that ``chip_smoke.py``
serves at published widths (a Mamba layer with a dense MLP, then an
attention layer with MoE). Forward logits, then prefill and three decode
steps, the logits and every cache leaf (``k``, ``v``, ``conv``, ``ssm``,
``len``) after each, within rtol=1e-4 / atol=1e-5 in f32 (the same math;
XLA and PyTorch round matmuls and transcendentals in their own orders).
The reference side of the 8-layer config takes ~20 s on a CPU when run
op by op, so each config is built once per module, and its params and
decode steps run under ``jax.jit``.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.models import hybrid
from test_torch_models import close, pair, tokens

CONFIGS = {"period8": {}, "period2": {"attn_period": 2, "n_layers": 2}}


@pytest.fixture(scope="module", params=list(CONFIGS))
def jamba(request):
    return pair("jamba-1.5-large-398b", jit_init=True,
                **CONFIGS[request.param])


def test_init_draws_the_reference_layout(jamba):
    _, rparams, port, _ = jamba
    mine = port.init(0)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), mine) == \
        jax.tree.map(lambda a: (a.shape, f"torch.{a.dtype}"), rparams)
    m = mine["blocks"]["mamba"]
    np.testing.assert_allclose(m["A_log"].numpy(), np.asarray(
        rparams["blocks"]["mamba"]["A_log"]), rtol=1e-6)
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    cfg = port.cfg
    assert hybrid._moe_slots(cfg) == [i for i in range(cfg.attn_period)
                                      if i % 2 == 1]


def test_forward_prefill_decode_match_reference(jamba):
    ref, rparams, port, params = jamba
    ref_decode = jax.jit(ref.decode_step)
    b, s, steps = 2, 9, 3
    toks = tokens(40, b, s + steps)
    batch = {"tokens": toks[:, :s]}
    want, waux = ref.forward(rparams, batch)
    got, gaux = port.forward(params, batch)
    close(got, want)
    close(gaux, waux)
    rcache, pcache = ref.init_cache(b, 16), port.init_cache(b, 16)
    for k in ("k", "v", "conv", "ssm"):
        assert tuple(pcache[k].shape) == rcache[k].shape
        assert pcache[k].dtype == torch.float32
    want, rcache = ref.prefill(rparams, batch, rcache)
    got, pcache = port.prefill(params, batch, pcache)
    for t in range(steps + 1):
        close(got, want)
        assert pcache["len"] == int(rcache["len"]) == s + t
        for k in ("k", "v", "conv", "ssm"):
            close(pcache[k], rcache[k])
        if t < steps:
            nxt = {"tokens": toks[:, s + t:s + t + 1]}
            want, rcache = ref_decode(rparams, nxt, rcache)
            got, pcache = port.decode_step(params, nxt, pcache)


def test_decode_matches_forward_on_the_port(jamba):
    _, _, port, params = jamba
    toks = tokens(41, 2, 8)
    full, _ = port.forward(params, {"tokens": toks})
    cache = port.init_cache(2, 8)
    got, cache = port.prefill(params, {"tokens": toks[:, :1]}, cache)
    close(got[:, 0], full[:, 0])
    for t in range(1, 8):
        got, cache = port.decode_step(params, {"tokens": toks[:, t:t + 1]},
                                      cache)
        close(got[:, 0], full[:, t])
