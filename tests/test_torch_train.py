"""The port's train step (``repro_torch.train``) and training CLI
(``repro_torch.launch.train``) against the JAX package's on the CPU.

One reduced config of each family (dense, MoE, VLM, the hybrid at
attention period 2, SSM, encoder-decoder), f32, its weights drawn by the
port and carried to the reference as NumPy, one seeded batch of 2 x 16.

- Loss and every gradient leaf of ``model.loss`` against
  ``jax.value_and_grad``: the loss within rtol=1e-6, each leaf within a
  relative L2 error of 2e-5 (the same f32 math; XLA and PyTorch round
  matmuls, reductions and transcendentals in their own orders; measured
  up to 3e-6, on RWKV-6).
- Three ``make_train_step`` steps against the reference's jitted step,
  held on the loss only (rtol=1e-5). AdamW's first update is near
  ``lr * sign(g)``: a gradient of ~1e-12 whose sign differs by rounding
  moves its parameter by 2 lr, so the parameters after a step are not
  comparable leaf by leaf; the gradients are held tightly above and the
  update given equal gradients in tests/test_torch_optim.py.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build_model as ref_build_model
from repro.optim import adamw_init as ref_adamw_init
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch import configs
from repro_torch.core.tree import tree_leaves_with_path, tree_map
from repro_torch.data import SyntheticTokenPipeline, make_batch
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.optim import adamw_init
from repro_torch.train import Trainer, make_train_step
from repro_torch.train.trainer import (loss_and_clipped_grads,
                                       shard_train_step, value_and_grad)

FAMILIES = {"dense": ("qwen3-0.6b", {}), "moe": ("dbrx-132b", {}),
            "vlm": ("qwen2-vl-72b", {}),
            "hybrid": ("jamba-1.5-large-398b",
                       {"attn_period": 2, "n_layers": 2}),
            "ssm": ("rwkv6-1.6b", {}), "encdec": ("seamless-m4t-large-v2", {})}
LOSS_RTOL, GRAD_REL_L2, STEP_LOSS_RTOL = 1e-6, 2e-5, 1e-5


def rel_l2(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    diff = np.linalg.norm(got.double().numpy() - want)
    return diff / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """The port's model, params and batch, and the reference's gradients
    at step 0 and metrics over three steps (one compile for both)."""
    arch, ov = FAMILIES[request.param]
    cfg = configs.get_config(arch).reduced(**ov)
    port = build_model(cfg, device="cpu")
    params = port.init(0)
    batch = make_batch(cfg, batch=2, seq=16, seed=3, device="cpu")
    ref = ref_build_model(ref_configs.get_config(arch).reduced(**ov))
    rstep = ref_make_train_step(ref)
    both = jax.jit(lambda p, o, b: (jax.value_and_grad(ref.loss)(p, b),
                                    rstep(p, o, b)))
    rp = tree_map(lambda t: jnp.asarray(t.numpy()), params)
    rbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    ropt, metrics = ref_adamw_init(rp), []
    for i in range(3):
        vg, (rp, ropt, m) = both(rp, ropt, rbatch)
        if i == 0:
            loss, grads = vg
        metrics.append(jax.tree.map(np.asarray, {**m, "step": ropt["step"]}))
    grads = dict(tree_leaves_with_path(jax.tree.map(np.asarray, grads)))
    return port, params, batch, float(loss), grads, metrics


def test_loss_and_every_gradient_match_jax_value_and_grad(family):
    port, params, batch, want_loss, want, _ = family
    loss, got = value_and_grad(port.loss, params, batch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    got = dict(tree_leaves_with_path(got))
    assert got.keys() == want.keys()
    for p in want:
        assert got[p].shape == want[p].shape, p
        assert rel_l2(got[p], want[p]) <= GRAD_REL_L2, (p, rel_l2(
            got[p], want[p]))
    assert not any(t.requires_grad for t in
                   (v for _, v in tree_leaves_with_path(params)))


def test_three_train_steps_follow_the_reference_loss(family):
    port, params, batch, _, _, metrics = family
    step, opt, p = make_train_step(port), adamw_init(params), params
    for i, rm in enumerate(metrics):
        p, opt, m = step(p, opt, batch)
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=STEP_LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-5)
        assert m["lr"].numpy().tobytes() == rm["lr"].tobytes()
        assert int(opt["step"]) == int(rm["step"]) == i + 1
    for (_, a), (_, b) in zip(tree_leaves_with_path(p),
                              tree_leaves_with_path(params)):
        assert a.dtype == b.dtype and a.shape == b.shape


def test_value_and_grad_gives_zeros_for_unused_leaves():
    params = {"a": torch.tensor([1.0, 2.0]), "b": torch.tensor(3.0)}
    loss, g = value_and_grad(lambda p, k: (p["a"] * k).sum(), params, 2.0)
    assert float(loss) == 6.0
    assert torch.equal(g["a"], torch.tensor([2.0, 2.0]))
    assert torch.equal(g["b"], torch.tensor(0.0))


def test_ep_train_step_equals_the_dropless_baseline():
    """DBRX reduced with moe_a2a: the EP path over a (1, 4) logical mesh
    gives the loss and gradients of the GSPMD-baseline path."""
    cfg = configs.get_config("dbrx-132b").reduced(capacity_factor=4.0)
    ep = build_model(dataclasses.replace(cfg, moe_a2a=True), device="cpu")
    base = build_model(cfg, device="cpu")
    params = base.init(1)
    batch = make_batch(cfg, batch=2, seq=16, seed=4, device="cpu")
    want = loss_and_clipped_grads(base, params, batch)
    with meshlib.set_mesh(meshlib.make_host_mesh(1, 4, device="cpu")):
        got = loss_and_clipped_grads(ep, params, batch)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
    for (p, a), (_, b) in zip(tree_leaves_with_path(got[1]),
                              tree_leaves_with_path(want[1])):
        assert rel_l2(a, b.numpy()) <= GRAD_REL_L2, p


def test_sharded_step_runs_the_step_under_the_reference_specs():
    cfg = configs.get_config("smollm-135m").reduced()
    model = build_model(cfg, device="cpu")
    trainer = Trainer(model=model, mesh=None)
    params, opt = trainer.init_state(0)
    batch = make_batch(cfg, batch=2, seq=16, device="cpu")
    mesh = meshlib.make_host_mesh(2, 4, device="cpu")
    sharded = shard_train_step(model, mesh, params, opt, batch)
    pspecs = meshlib.param_specs(params, mesh)
    assert sharded.in_specs[0] == pspecs
    assert sharded.in_specs[1]["mu"] == meshlib.zero1_specs(pspecs, params,
                                                            mesh)
    assert sharded.in_specs[2] == {"tokens": ("data", None),
                                   "labels": ("data", None)}
    p1, o1, m1 = sharded(params, opt, batch)
    p2, o2, m2 = make_train_step(model)(params, opt, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    for (_, a), (_, b) in zip(tree_leaves_with_path((p1, o1)),
                              tree_leaves_with_path((p2, o2))):
        assert torch.equal(a, b)
    assert int(o1["step"]) == 1 and torch.isfinite(m1["loss"])


def manifest_entries(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["entries"]


def test_cli_trains_on_the_cpu_and_resumes_bit_for_bit(tmp_path, capsys):
    base = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--log-every", "1"]
    hist_a, hist_b = [], []
    assert train_cli.main(base + ["--ckpt-dir", str(tmp_path / "a")],
                          history=hist_a) == 0
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_2", tmp_path / "b" / "step_2")
    assert train_cli.main(base + ["--ckpt-dir", str(tmp_path / "b"),
                                  "--resume"], history=hist_b) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "checkpoint ->" in out
    assert [h["step"] for h in hist_a] == [0, 1, 2, 3]
    assert [h["step"] for h in hist_b] == [2, 3]
    assert hist_b == hist_a[2:]
    assert all(np.isfinite(h["loss"]) for h in hist_a)
    a, b = (manifest_entries(tmp_path / d / "step_4") for d in "ab")
    assert a == b and len(a) == 3 * len(tree_leaves_with_path(
        build_model(configs.get_config("qwen3-0.6b").reduced(),
                    device="cpu").init(0))) + 1


def test_pipeline_batches_feed_the_step():
    cfg = configs.get_config("seamless-m4t-large-v2").reduced()
    model = build_model(cfg, device="cpu")
    params, opt = Trainer(model=model, mesh=None).init_state(2)
    pipe = SyntheticTokenPipeline(cfg, 2, 16, device="cpu")
    step = Trainer(model=model, mesh=None, warmup=1).jitted_step()
    losses = []
    for s in range(3):
        params, opt, m = step(params, opt, pipe.get_batch(s))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and int(opt["step"]) == 3
    assert opt["mu"]["embed"].dtype == torch.bfloat16
