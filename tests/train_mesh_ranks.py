"""The rank side of tests/test_torch_train_mesh*.py: functions that
``distributed.spawn.run_ranks`` runs on every rank of a gloo group on the
CPU (torch, repro_torch and chip_smoke.py's NumPy position builder,
never JAX). Each writes what its rank saw to a pickle under ``out_dir``.
"""
import dataclasses
import importlib.util
import os
import pickle
from pathlib import Path

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.interop import params_from_numpy
from repro_torch.core.tree import tree_leaves_with_path, tree_map
from repro_torch.launch import mesh as meshlib
from repro_torch.models import build_model
from repro_torch.optim import adamw_init

SEED = 0

# chip_smoke.py's M-RoPE position builder (numpy only), so the smoke's
# positions3 is the one these cases hold against the reference
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_smoke)
vlm_positions3 = _smoke.vlm_positions3


def case_config(case):
    cfg = configs.get_config(case["arch"]).reduced(**case.get("ov", {}))
    if case.get("ep"):
        cfg = dataclasses.replace(cfg, moe_a2a=True)
    return cfg


def case_inputs(name, case):
    """The case's params (drawn by the port from SEED) and batch, as
    NumPy trees: the same arrays go to the reference. ``grid``: the VLM's
    ``positions3`` given (``vlm_positions3``); ``src``: the encoder's
    source length (the target's is ``seq // 2``); ``mask``: a loss mask
    uneven across the data shards."""
    from repro_torch.data import make_batch
    cfg = case_config(case)
    params = build_model(cfg, device="cpu").init(SEED)
    batch = {k: v.numpy() for k, v in make_batch(
        cfg, batch=case["batch"], seq=case["seq"], seed=3,
        device="cpu").items()}
    if "grid" in case:
        s_img = batch["patch_embeds"].shape[1]
        batch["positions3"] = vlm_positions3(
            case["batch"], s_img, batch["tokens"].shape[1], case["grid"])
    if "src" in case:
        rng = np.random.default_rng(4)
        batch["src_embeds"] = rng.normal(
            size=(case["batch"], case["src"], cfg.d_model)).astype(
                np.float32)
    if case.get("mask"):
        # the first rows keep 3 tokens, the last loses one
        mask = np.ones(batch["labels"].shape, np.float32)
        mask[0, 3:] = 0
        mask[-1, :1] = 0
        batch["loss_mask"] = mask
    return tree_map(lambda t: t.numpy(), params), batch


def _flat(tree) -> dict:
    return {"/".join(map(str, p)): t for p, t in tree_leaves_with_path(tree)}


def held(tree) -> dict:
    """Each leaf's shape and the bytes its storage holds."""
    return {k: (tuple(t.shape), t.untyped_storage().nbytes())
            for k, t in _flat(tree).items()}


def _counting(calls):
    from repro_torch.distributed import exchange
    real = exchange.all_reduce

    def counted(x, mesh, op="sum"):
        calls.append((mesh.axis, tuple(x.shape)))
        return real(x, mesh, op)
    return real, counted


def _ep_layer(mesh, cfg, params, batch):
    """One forward of the first MoE layer's EP MoE (a hybrid's first
    superblock's first MoE slot): the rank's expert weights and the
    all-reduces it makes."""
    from repro_torch.distributed import exchange
    from repro_torch.models import moe
    if "layers" in params:
        p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    else:
        p = {k: v[0, 0] for k, v in params["blocks"]["moe"].items()}
    x = torch.randn(batch, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    calls = []
    real, counted = _counting(calls)
    exchange.all_reduce = counted
    try:
        with meshlib.set_mesh(mesh):
            moe.moe_ffn_auto(p, x, n_experts=cfg.n_experts,
                             top_k=cfg.top_k, use_ep=True)
    finally:
        exchange.all_reduce = real
    return {"w_gate": tuple(p["w_gate"].shape), "all_reduces": calls}


def train_main(rank, world, inputs_path, cases, out_dir):
    """Every case whose mesh has ``world`` positions, as the reference
    runs it: the seeded inputs cut to this rank's shards, ``steps`` steps
    of ``shard_train_step``'s ``ProcessStep`` (f32 moments), then the
    whole leaves gathered."""
    from repro_torch.train.trainer import shard_train_step
    z = np.load(inputs_path)
    out = {"rank": rank, "cases": {}}
    for name, case in cases.items():
        if int(np.prod(case["mesh"])) != world:
            continue
        mesh = meshlib.make_process_mesh(case["mesh"], case["axes"],
                                         device="cpu")
        cfg = case_config(case)
        model = build_model(cfg, device="cpu")
        pre = f"{name}/"
        flat = {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}
        params = _unflatten({k[2:]: v for k, v in flat.items()
                             if k.startswith("p/")})
        params = params_from_numpy(params, device="cpu")
        batch = {k[2:]: torch.from_numpy(v) for k, v in flat.items()
                 if k.startswith("b/")}
        opt = adamw_init(params, state_dtype="float32")
        step = shard_train_step(model, mesh, params, opt, batch)
        ps, ospecs, bs = step.in_specs
        p = meshlib.shard_tree(params, ps, mesh)
        o = meshlib.shard_tree(opt, ospecs, mesh)
        b = meshlib.batch_block(batch, bs, mesh)
        metrics = []
        for _ in range(case["steps"]):
            p, o, m = step(p, o, b)
            metrics.append({k: v.numpy().tobytes() for k, v in m.items()})
            metrics[-1].update({k + "_f": float(v) for k, v in m.items()})
        rec = {"metrics": metrics, "coords": mesh.coords,
               "held": held({"p": p, "o": o, "b": b}),
               "batch_split": step.batch_split}
        whole = meshlib.gather_tree({"p": p, "o": o}, {"p": ps, "o": ospecs},
                                    mesh)
        if rank == 0:
            rec["whole"] = {k: v.numpy() for k, v in _flat(whole).items()}
        if case.get("ep"):
            from repro_torch.models import parallel as P
            rec["ep"] = _ep_layer(P.batch_mesh(mesh, step.batch_split), cfg,
                                  p, 2 if step.batch_split else case["batch"])
        out["cases"][name] = rec
    out["probes"] = _probes(rank, world)
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def _unflatten(flat: dict) -> dict:
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _probes(rank, world):
    """The collectives and the tensor-parallel pair on a (1, world) mesh:
    what each returns forward and backward."""
    from repro_torch.distributed import exchange
    from repro_torch.models import parallel as P
    mesh = meshlib.make_process_mesh((1, world), ("data", "model"),
                                     device="cpu")
    line = mesh.line("model")
    x = torch.arange(2 * world, dtype=torch.float32) * (rank + 1)
    got = {"lines": {k: None if v is None else (v.rank, v.num_shards)
                     for k, v in mesh.lines.items()},
           "sum": exchange.all_reduce(x, line).tolist(),
           "max": exchange.all_reduce(x, line, "max").tolist(),
           "bf16": exchange.all_reduce(x.bfloat16(), line).float().tolist(),
           "scatter": exchange.reduce_scatter(
               x.reshape(world, 2), line).tolist()}
    with meshlib.set_mesh(mesh):
        for name, fn in (("copy", P.copy), ("reduce", P.reduce)):
            t = torch.full((3,), float(rank + 1), requires_grad=True)
            y = fn(t, mesh)
            (y * (rank + 1)).sum().backward()
            got[name] = (y.detach().tolist(), t.grad.tolist())
        t = torch.full((2, 2), float(rank + 1), requires_grad=True)
        y = P.gather_last(t, mesh)
        (y * torch.arange(y.shape[-1])).sum().backward()
        got["gather_last"] = (y.detach().tolist(), t.grad.tolist())
    return got


def ckpt_inputs(arch):
    """The checkpoint cases' reduced config and 4 x 16 batch (the VLM's
    with ``positions3`` given)."""
    from repro_torch.data import make_batch
    cfg = configs.get_config(arch).reduced()
    batch = make_batch(cfg, batch=4, seq=16, seed=5, device="cpu")
    if cfg.family == "vlm":
        s_img = batch["patch_embeds"].shape[1]
        batch["positions3"] = torch.from_numpy(vlm_positions3(
            4, s_img, batch["tokens"].shape[1], (1, 1, s_img)))
    return cfg, batch


def ckpt_main(rank, world, directory, out_dir, shape, restore_shape,
              arch="qwen3-0.6b"):
    """(2, 2) at world 4: two steps of ``arch`` reduced (bf16 moments), a
    save at step 2 from the mesh, a third step; then a resume from step 2
    on the same mesh and its third step; then ``elastic_restore`` of
    step 2 onto ``restore_shape`` and one step there. At other worlds
    only the restore onto ``restore_shape``."""
    from repro_torch.launch.dryrun import abstract_params
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import elastic_restore
    from repro_torch.train.trainer import Trainer
    cfg, batch = ckpt_inputs(arch)
    model = build_model(cfg, device="cpu")
    _, template, _ = abstract_params(cfg)
    template = {"params": template, "opt": {"mu": template, "nu": template,
                                            "step": None}}
    out = {"rank": rank}

    def run(mesh, state, steps):
        trainer = Trainer(model=model, mesh=mesh, warmup=1, total_steps=8)
        step = trainer.jitted_step(batch)
        p, o = state
        b = meshlib.batch_block(batch, step.in_specs[2], mesh)
        losses = []
        for _ in range(steps):
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
        return (p, o), losses, step

    if shape is not None:
        mesh = meshlib.make_process_mesh(shape, ("data", "model"),
                                         device="cpu")
        trainer = Trainer(model=model, mesh=mesh, warmup=1, total_steps=8)
        state, losses, step = run(mesh, trainer.init_state(SEED), 2)
        specs = {"params": step.in_specs[0], "opt": step.in_specs[1]}
        tree = {"params": state[0], "opt": state[1]}
        ckpt.save_checkpoint(directory, 2, tree, mesh=mesh, specs=specs,
                             extra={"from": list(shape)})
        whole = meshlib.gather_tree(tree, specs, mesh)
        if rank == 0:
            out["whole"] = {k: v for k, v in _flat(whole).items()}
        state3, more, _ = run(mesh, state, 1)
        restored, extra, at = elastic_restore(directory, template, mesh)
        again, more2, _ = run(mesh, (restored["params"], restored["opt"]), 1)
        out.update(losses=losses + more, resumed=more2, extra=extra, at=at,
                   same=all(torch.equal(a, b) for (_, a), (_, b) in zip(
                       tree_leaves_with_path(state3),
                       tree_leaves_with_path(again))),
                   leaves=len(tree_leaves_with_path(state3)))
    mesh = meshlib.make_process_mesh(restore_shape, ("data", "model"),
                                     device="cpu")
    restored, _, _ = elastic_restore(directory, template, mesh)
    out["restored"] = {"coords": mesh.coords,
                       "leaves": {k: v for k, v in _flat(restored).items()},
                       "held": held(restored)}
    _, losses, _ = run(mesh, (restored["params"], restored["opt"]), 1)
    out["restored"]["losses"] = losses
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
