"""The port's Mamba (S6) block (``repro_torch.models.mamba``) against the
JAX package's on the CPU.

Weights are the reference's ``init_mamba`` from ``PRNGKey(0)``, carried
over by ``interop.params_from_numpy``, with the dense matrices scaled up
(x10) so that the conv, the selective scan and the skip term each move the
output well past the tolerance. Inputs are drawn with NumPy from a seed.
In f32 the port must agree within rtol=1e-4 / atol=1e-5 (the same math;
XLA's and PyTorch's CPU matmuls and transcendentals round in their own
orders). Prompt lengths 1 and 2 are shorter than the conv's history
(d_conv - 1 = 3), so the prefill's conv state holds padding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as ref_mamba
from repro_torch.core import interop
from repro_torch.models import mamba
from test_torch_models import close, to_np

D, EXPAND, STATE, CONV, DT_RANK = 16, 2, 4, 4, 3
DENSE = ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj")


def params(dtype=jnp.float32):
    """(reference params, port params) of one Mamba layer."""
    p = ref_mamba.init_mamba(jax.random.PRNGKey(0), D, expand=EXPAND,
                             d_state=STATE, d_conv=CONV, dt_rank=DT_RANK,
                             dtype=dtype)
    p = {k: (v * 10).astype(v.dtype) if k in DENSE else v
         for k, v in p.items()}
    return p, interop.params_from_numpy(to_np(p), device="cpu")


def inputs(seed, b, s, dtype=np.float32):
    x = np.random.default_rng(seed).normal(size=(b, s, D))
    return x.astype(np.float32).astype(dtype)


@pytest.mark.parametrize("s", [1, 2, 9])
def test_forward_then_steps_match_reference(s):
    rp, pp = params()
    x = inputs(s, 2, s + 3)
    want, wstate = ref_mamba.mamba_forward(rp, jnp.asarray(x[:, :s]),
                                           return_state=True)
    got, gstate = mamba.mamba_forward(pp, torch.from_numpy(x[:, :s]),
                                      return_state=True)
    close(got, want)
    for k in ("conv", "ssm"):
        close(gstate[k], wstate[k])
    assert gstate["conv"].dtype == torch.float32
    for t in range(s, s + 3):
        want, wstate = ref_mamba.mamba_step(rp, wstate,
                                            jnp.asarray(x[:, t:t + 1]))
        got, gstate = mamba.mamba_step(pp, gstate,
                                       torch.from_numpy(x[:, t:t + 1]))
        close(got, want)
        for k in ("conv", "ssm"):
            close(gstate[k], wstate[k])
    # the full forward computes the same function as prefill + steps
    full = ref_mamba.mamba_forward(rp, jnp.asarray(x))
    close(got[:, 0], np.asarray(full)[:, -1])


def test_forward_without_state_and_init_state():
    rp, pp = params()
    x = inputs(3, 2, 5)
    close(mamba.mamba_forward(pp, torch.from_numpy(x)),
          ref_mamba.mamba_forward(rp, jnp.asarray(x)))
    want = ref_mamba.mamba_init_state(rp, 3)
    got = mamba.mamba_init_state(pp, 3)
    for k in ("conv", "ssm"):
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.float32
        assert not got[k].any()


def test_bf16_mixes_dtypes_as_jax_promotes():
    """bf16 weights and activations: the products JAX promotes to f32
    (``uc @ x_proj``, ``dt_proj``) must not raise in torch, the outputs
    keep bf16 and the carried state f32. Both packages round bf16 in
    their own orders (XLA may fuse an elementwise chain and round once),
    so the bound is a few bf16 ulps of the output's scale."""
    rp, pp = params(jnp.bfloat16)
    x = inputs(4, 2, 6, dtype=jnp.bfloat16)
    want, wstate = ref_mamba.mamba_forward(rp, jnp.asarray(x[:, :5]),
                                           return_state=True)
    got, gstate = mamba.mamba_forward(
        pp, interop.to_tensor(np.asarray(x[:, :5]), device="cpu"),
        return_state=True)
    assert got.dtype == torch.bfloat16
    assert gstate["conv"].dtype == gstate["ssm"].dtype == torch.float32
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    close(got, np.asarray(want, np.float32), rtol=0, atol=0.02 * scale)
    want, _ = ref_mamba.mamba_step(rp, wstate, jnp.asarray(x[:, 5:]))
    got, _ = mamba.mamba_step(
        pp, gstate, interop.to_tensor(np.asarray(x[:, 5:]), device="cpu"))
    assert got.dtype == torch.bfloat16
    close(got, np.asarray(want, np.float32), rtol=0, atol=0.02 * scale)


def test_softplus_matches_jax_softplus():
    x = np.linspace(-40, 40, 161).astype(np.float32)
    got = mamba.softplus(torch.from_numpy(x))
    close(got, jax.nn.softplus(jnp.asarray(x)), rtol=1e-6, atol=0)
