"""The port's ``ServeLoop`` against the JAX package's on the CPU.

The reduced qwen3-0.6b and dbrx-132b configs (f32), the reference's
weights carried over by ``interop.params_from_numpy``; five requests of
mixed prompt lengths and token budgets over two slots, so three waves, the
last padded. Every greedy token must equal the reference's, and every
logit row the loop computed (prefill and decode) must agree with the
reference's within rtol=1e-4 / atol=1e-5 (test_torch_models.py's f32
tolerance). With a shared ``AccessService`` the loop drains the pending
bulk submissions at each wave, as the reference's does.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build_model as ref_build_model
from repro.serve import AccessService as RefAccessService
from repro.serve.serve import Request as RefRequest
from repro.serve.serve import ServeLoop as RefServeLoop
from repro_torch import configs
from repro_torch.core import Engine, Scheduler, interop
from repro_torch.models import build_model
from repro_torch.serve import AccessService, ServeLoop
from repro_torch.serve.serve import Request

PROMPTS = ((5, 4), (9, 2), (3, 6), (7, 3), (4, 5))  # (prompt len, budget)


def record(loop, log):
    """Append every logit row ``loop``'s prefill/decode steps (the reference's
    jitted ones) compute to ``log``."""
    def wrap(fn):
        def call(p, b, c):
            logits, c = fn(p, b, c)
            log.append(logits.numpy() if isinstance(logits, torch.Tensor)
                       else np.asarray(logits, np.float32))
            return logits, c
        return call
    loop._prefill, loop._decode = wrap(loop._prefill), wrap(loop._decode)
    return loop


def requests(cls, vocab):
    rng = np.random.default_rng(21)
    return [cls(rid=i, prompt=rng.integers(1, vocab, size=n).astype(
        np.int32), max_new_tokens=m) for i, (n, m) in enumerate(PROMPTS)]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b"])
@pytest.mark.parametrize("with_access", [False, True])
def test_serve_loop_tokens_match_reference(arch, with_access):
    rcfg = ref_configs.get_config(arch).reduced()
    ref = ref_build_model(rcfg)
    rparams = ref.init(jax.random.PRNGKey(0))
    port = build_model(configs.get_config(arch).reduced(), device="cpu")
    params = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                       device="cpu")
    rlog, plog = [], []
    table = np.arange(64, dtype=np.float32).reshape(16, 4)
    idx = np.array([3, 1, 3, 15], np.int32)
    raccess = access = None
    if with_access:
        raccess = RefAccessService(tile_size=256, auto_flush=0)
        access = AccessService(Scheduler(engine=Engine(tile_size=256,
                                                       device="cpu")),
                               auto_flush=0)
        rt = raccess.submit_gather(table, idx, tenant="other")
        t = access.submit_gather(table, idx, tenant="other")
    rloop = record(RefServeLoop(ref, batch_slots=2, max_cache_len=32,
                                access=raccess), rlog)
    rloop.params = rparams
    loop = record(ServeLoop(port, batch_slots=2, max_cache_len=32,
                            access=access), plog)
    loop.params = params
    want = rloop.run(requests(RefRequest, rcfg.vocab))
    got = loop.run(requests(Request, rcfg.vocab))
    assert [r.rid for r in got] == [r.rid for r in want] == list(range(5))
    for g, w in zip(got, want):
        assert g.out_tokens == w.out_tokens
        assert len(g.out_tokens) == g.max_new_tokens
    assert len(plog) == len(rlog) == 3 + 4 + 6 + 5     # prefills + steps
    for g, w in zip(plog, rlog):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    if with_access:
        assert access.pending == 0 and raccess.pending == 0
        np.testing.assert_array_equal(access.wait(t).numpy(),
                                      np.asarray(raccess.wait(rt)))


def test_serve_loop_needs_params_and_ties_take_the_first_index():
    port = build_model(configs.get_config("smollm-135m").reduced(),
                       device="cpu")
    loop = ServeLoop(port, batch_slots=1, max_cache_len=8)
    with pytest.raises(ValueError, match="params"):
        loop.run([Request(rid=0, prompt=np.array([1, 2], np.int32))])
    # all-zero weights: every logit ties, so argmax takes token 0
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros_like(tree)
    loop.params = zeros(port.init(0))
    out = loop.run([Request(rid=0, prompt=np.array([5, 6], np.int32),
                            max_new_tokens=3)])
    assert out[0].out_tokens == [0, 0, 0]
