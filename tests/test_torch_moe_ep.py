"""The port's expert-parallel MoE (``models.moe.moe_ffn_ep``) against the
JAX package's ``shard_map`` version on the CPU.

The reference runs in a subprocess with 8 forced host devices (as
tests/test_ep_moe.py runs it), on (data, model) meshes (2, 4), (1, 4)
and (4, 2), with one case that drops tokens at the per-shard capacity.
It writes its outputs, router logits and the gradients of sum(out**2)
(params and input) to an npz; the port runs the same seeded inputs over
its logical mesh of the same shape (``launch.mesh.set_mesh``). Outputs,
logits and gradients within rtol=1e-5 / atol=1e-6 in f32 (the same
math; the combine sums the columns in another order). ``moe_ffn_auto``
takes the EP path exactly where the reference does.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as meshlib
from repro_torch.models import moe
from repro_torch.train.trainer import value_and_grad
from spawn_once import once

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
# (data, model) mesh, top_k, capacity_factor; n_experts = model
CASES = {"dropless_2x4": ((2, 4), 2, 8.0), "drop_2x4": ((2, 4), 2, 0.5),
         "top1_1x4": ((1, 4), 1, 1.25), "drop_4x2": ((4, 2), 1, 0.25)}
D, F, B, S = 16, 24, 4, 16


def inputs(name):
    (dp, e), _, _ = CASES[name]
    rng = np.random.default_rng(len(name) * 7 + e)
    p = {"router": rng.normal(size=(D, e)).astype(np.float32),
         "w_gate": (rng.normal(size=(e, D, F)) * 0.1).astype(np.float32),
         "w_up": (rng.normal(size=(e, D, F)) * 0.1).astype(np.float32),
         "w_down": (rng.normal(size=(e, F, D)) * 0.1).astype(np.float32)}
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    return p, x


_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from repro.models import moe as M

    cases = json.loads(sys.argv[2])
    z = dict(np.load(sys.argv[1]))
    out = {}
    for name, ((dp, e), k, cf) in cases.items():
        p = {n: jnp.asarray(z[name + "/" + n])
             for n in ("router", "w_gate", "w_up", "w_down")}
        x = jnp.asarray(z[name + "/x"])
        mesh = jax.make_mesh((dp, e), ("data", "model"),
                             devices=jax.devices()[:dp * e])
        f = lambda p_, x_: M.moe_ffn_ep(p_, x_, n_experts=e, top_k=k,
                                        capacity_factor=cf)
        loss = lambda p_, x_: jnp.sum(f(p_, x_)[0] ** 2)
        both = lambda p_, x_: (f(p_, x_),
                               jax.grad(loss, argnums=(0, 1))(p_, x_))
        with jax.sharding.set_mesh(mesh):
            (o, lg), (gp, gx) = jax.jit(both)(p, x)
        out[name + "/out"] = np.asarray(o)
        out[name + "/logits"] = np.asarray(lg)
        out[name + "/dx"] = np.asarray(gx)
        for n, v in gp.items():
            out[name + "/d" + n] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    print("EP_REF_OK")
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's results on every case, from one subprocess."""
    return once(tmp_path_factory, "moe_ep_reference",
                lambda: _reference(tmp_path_factory.mktemp("ep")))


def _reference(tmp):
    path = tmp / "cases.npz"
    arrays = {}
    for name in CASES:
        p, x = inputs(name)
        arrays.update({f"{name}/{n}": v for n, v in p.items()})
        arrays[f"{name}/x"] = x
    np.savez(path, **arrays)
    r = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(path), json.dumps(CASES)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert "EP_REF_OK" in r.stdout, r.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_ep_matches_reference_outputs_and_gradients(reference, name):
    (dp, e), k, cf = CASES[name]
    p, x = inputs(name)
    p = {n: torch.from_numpy(v) for n, v in p.items()}
    x = torch.from_numpy(x)
    f = lambda p_, x_: moe.moe_ffn_ep(p_, x_, n_experts=e, top_k=k,
                                      capacity_factor=cf)
    with meshlib.set_mesh(meshlib.make_host_mesh(dp, e, device="cpu")):
        o, lg = f(p, x)
        _, g = value_and_grad(
            lambda t: (f(t["p"], t["x"])[0] ** 2).sum(), {"p": p, "x": x})
    close(o, reference[name + "/out"])
    close(lg, reference[name + "/logits"])
    close(g["x"], reference[name + "/dx"])
    for n in p:
        close(g["p"][n], reference[name + "/d" + n])


def test_drop_case_really_drops():
    (dp, e), k, cf = CASES["drop_2x4"]
    p, x = inputs("drop_2x4")
    p = {n: torch.from_numpy(v) for n, v in p.items()}
    x = torch.from_numpy(x)
    with meshlib.set_mesh(meshlib.make_host_mesh(dp, e, device="cpu")):
        o, _ = moe.moe_ffn_ep(p, x, n_experts=e, top_k=k,
                              capacity_factor=cf)
    want, _ = moe.moe_ffn(p, x, n_experts=e, top_k=k, capacity_factor=8.0)
    assert not torch.allclose(o, want, rtol=RTOL, atol=ATOL)
    assert int((o.abs().sum(-1) == 0).sum()) > 0       # dropped tokens


@pytest.mark.parametrize("mesh", [(1, 4), (2, 4), (4, 4)])
def test_dropless_ep_equals_moe_ffn(mesh):
    p, x = inputs("dropless_2x4")
    p = {n: torch.from_numpy(v) for n, v in p.items()}
    x = torch.from_numpy(x)
    want, wl = moe.moe_ffn(p, x, n_experts=4, top_k=2, capacity_factor=8.0)
    with meshlib.set_mesh(meshlib.make_host_mesh(*mesh, device="cpu")):
        got, gl = moe.moe_ffn_auto(p, x, n_experts=4, top_k=2,
                                   capacity_factor=8.0, use_ep=True)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(gl, wl, rtol=0, atol=0)


def test_auto_takes_ep_exactly_where_the_reference_does(monkeypatch):
    p, x = inputs("dropless_2x4")
    p = {n: torch.from_numpy(v) for n, v in p.items()}
    x = torch.from_numpy(x)
    calls = []
    real = moe.moe_ffn_ep
    monkeypatch.setattr(moe, "moe_ffn_ep",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    kw = dict(n_experts=4, top_k=2, capacity_factor=8.0)
    for mesh, use_ep, xx, want in (
            ((2, 4), True, x, 1),           # model axis == experts
            ((2, 4), False, x, 0),          # not asked for
            ((2, 2), True, x, 0),           # model axis != experts
            ((3, 4), True, x, 0),           # 64 tokens over 3 data shards
            ((1, 4), True, x[:1, :3], 1)):
        calls.clear()
        with meshlib.set_mesh(meshlib.make_host_mesh(*mesh, device="cpu")):
            moe.moe_ffn_auto(p, xx, use_ep=use_ep, **kw)
        assert len(calls) == want, (mesh, use_ep)
    calls.clear()
    moe.moe_ffn_auto(p, x, use_ep=True, **kw)          # no ambient mesh
    assert not calls


def test_remat_recompute_keeps_the_ambient_mesh():
    """The backward recomputes a remat layer on another thread (CUDA's
    autograd thread) or, as here, after the ``with`` block: it must take
    the forward's EP path again, or the recompute's shapes differ."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data import make_batch
    from repro_torch.models import build_model
    cfg = dataclasses.replace(configs.get_config("dbrx-132b").reduced(),
                              moe_a2a=True, remat="full")
    model = build_model(cfg, device="cpu")
    params = {k: v for k, v in model.init(0).items()}
    params["embed"] = params["embed"].clone().requires_grad_(True)
    batch = make_batch(cfg, batch=2, seq=16, seed=1, device="cpu")
    with meshlib.set_mesh(meshlib.make_host_mesh(1, 4, device="cpu")):
        loss = model.loss(params, batch)
    loss.backward()
    base = build_model(dataclasses.replace(cfg, moe_a2a=False),
                       device="cpu")
    _, g = value_and_grad(base.loss, {**params, "embed":
                                      params["embed"].detach()}, batch)
    torch.testing.assert_close(params["embed"].grad, g["embed"],
                               rtol=1e-5, atol=1e-7)
