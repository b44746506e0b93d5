"""Multi-pod dry run: every (arch x input-shape) cell on the production
meshes, counted without allocating anything.

  single-pod mesh : (16, 16)     -> ("data", "model")        256 chips
  multi-pod mesh  : (2, 16, 16)  -> ("pod", "data", "model") 512 chips

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh single,multi [--force] [--out results/dryrun_torch]

The port of the JAX package's ``launch.dryrun``, which lowers and compiles
each cell with XLA. Here params, optimizer state, batch and cache are
fake tensors (``torch._subclasses.fake_tensor.FakeTensorMode``, torch's
counterpart of ``jax.eval_shape``): shapes and dtypes, no storage. The
model's ``init`` draws from a generator on the params' device, and no
generator exists for the ``meta`` device, so the fake params are drawn
from a (fake) CPU generator; the mesh is logical over ``meta``. Each cell
runs its function once under ``roofline.analyze_step`` (the train step,
``prefill`` or ``decode_step``) and writes
results/dryrun_torch/<mesh>/<arch>__<shape>.json (existing cells are
skipped unless --force) with the reference's keys where they mean
something here: arch, shape, n_params, n_active_params, mesh, kind,
mesh_label, status, chips, roofline (FLOPs and bytes of the whole step,
on one device), error and trace. ``memory_analysis`` holds per-device
bytes of the params, optimizer moments, batch and cache under the cell's
specs (a dim sharded over axes is divided by their sizes). XLA's
``temp_size_in_bytes``, ``generated_code_size_in_bytes`` and
``alias_size_in_bytes``, ``lower_s`` and ``compile_s`` have no
counterpart (nothing is compiled); ``analyze_s`` is the cell's time.

The recurrent families (Mamba's and RWKV's loops over time) run one fake
op per time step and layer: their long cells take minutes.
"""
import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, applicable_shapes, get_config
from repro_torch.configs.base import ARCH_IDS
from repro_torch.core.tree import tree_leaves
from repro_torch.data.batches import input_specs
from repro_torch.launch import mesh as meshlib
from repro_torch.models import build_model
from repro_torch.optim import adamw_init
from repro_torch.roofline import analysis as roofline
from repro_torch.train.trainer import make_train_step

META = torch.device("meta")


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh, logical over the ``meta`` device."""
    return meshlib.make_production_mesh(multi_pod=multi_pod, device=META)


def _fake(specs) -> dict:
    return {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in specs.items()}


def per_device_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` under ``specs``."""
    sizes = mesh.shape
    total = 0
    for leaf, spec in zip(tree_leaves(tree),
                          tree_leaves(specs, is_leaf=meshlib.is_spec)):
        if not isinstance(leaf, torch.Tensor):
            continue
        div = 1
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                div *= sizes.get(a, 1) if a is not None else 1
        total += leaf.numel() * leaf.element_size() // div
    return total


def _cache(model, cfg, shape):
    """The cache for decode/prefill cells (fake tensors)."""
    b, seq = shape.global_batch, shape.seq_len
    kw = {}
    if cfg.family == "encdec":
        kw["src_len"] = seq // 2
        max_len = seq - seq // 2
    elif cfg.sliding_window is not None and shape.name == "long_500k":
        max_len = cfg.sliding_window      # ring cache == window
    else:
        max_len = seq
    return model.init_cache(b, max_len, **kw)


def abstract_params(cfg):
    """The model of ``cfg`` and its params as fake tensors (shapes and
    dtypes, no storage), in the mode that made them."""
    mode = FakeTensorMode()
    with mode:
        model = build_model(cfg, device="cpu")
        return model, model.init(0), mode


def param_counts(cfg):
    """(n_params, n_active_params) of ``cfg``, from fake params."""
    _, params, _ = abstract_params(cfg)
    n_params = roofline.count_params(params)
    return n_params, int(n_params * roofline.active_param_fraction(cfg))


def analyze_cell(arch: str, shape_name: str, mesh, *,
                 cfg_overrides: dict | None = None):
    """Build one (arch, shape) cell from fake tensors and count it.
    Returns (meta, roofline report, memory dict)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    chips = int(mesh.devices.size)
    model, params, mode = abstract_params(cfg)
    with mode:
        n_params = roofline.count_params(params)
        n_active = int(n_params * roofline.active_param_fraction(cfg))
        meta = {"arch": arch, "shape": shape_name, "n_params": n_params,
                "n_active_params": n_active,
                "mesh": list(mesh.devices.shape), "kind": shape.kind}
        pspecs = meshlib.param_specs(params, mesh)
        mem = {"param_bytes_per_device":
               per_device_bytes(params, pspecs, mesh)}
        batch = _fake(input_specs(cfg, batch=shape.global_batch,
                                  seq=shape.seq_len, kind=shape.kind))
        mem["batch_bytes_per_device"] = per_device_bytes(
            batch, meshlib.batch_specs(batch, mesh), mesh)
        mflops = roofline.model_flops(
            cfg, batch=shape.global_batch, seq=shape.seq_len,
            kind=shape.kind, n_params=n_params, n_active_params=n_active)
        if shape.kind == "train":
            opt = adamw_init(params)
            zspecs = meshlib.zero1_specs(pspecs, params, mesh)
            mem["moment_bytes_per_device"] = 2 * per_device_bytes(
                opt["mu"], zspecs, mesh)
            fn, args = make_train_step(model), (params, opt, batch)
        else:
            cache = _cache(model, cfg, shape)
            cspecs = meshlib.cache_specs(
                cache, mesh, shape.global_batch,
                seq_shard=shape.name == "long_500k", seq_len=shape.seq_len)
            mem["cache_bytes_per_device"] = per_device_bytes(cache, cspecs,
                                                             mesh)
            fn = model.prefill if shape.kind == "prefill" \
                else model.decode_step
            args = (params, batch, cache)
        with torch.no_grad() if shape.kind != "train" \
                else torch.enable_grad():
            rep = roofline.analyze_step(fn, *args, chips=chips,
                                        model_flops_total=mflops)
    return meta, rep, mem


def _parse_overrides(sets):
    out = {}
    for kv in sets or []:
        k, v = kv.split("=", 1)
        if v in ("true", "false"):
            v = v == "true"
        elif v.isdigit():
            v = int(v)
        out[k] = v
    return out


def run_cell(arch: str, shape_name: str, mesh, mesh_label: str,
             out_dir: str, force: bool = False,
             overrides: dict | None = None):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape not in applicable_shapes(cfg):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_label,
                "status": "skipped",
                "reason": "long_500k needs sub-quadratic attention "
                          "(DESIGN.md §Arch-applicability)"}
    path = os.path.join(out_dir, mesh_label, f"{arch}__{shape_name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.time()
    try:
        meta, rep, mem = analyze_cell(arch, shape_name, mesh,
                                      cfg_overrides=overrides)
        result = {**meta, "mesh_label": mesh_label, "status": "ok",
                  "chips": int(mesh.devices.size), "memory_analysis": mem,
                  "roofline": rep.to_dict(),
                  "analyze_s": round(time.time() - t0, 1)}
    except Exception as e:  # noqa: BLE001 — record failures as data
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_label,
                  "status": "error", "error": f"{type(e).__name__}: {e}",
                  "trace": traceback.format_exc()[-2000:]}
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (e.g. opt_attention=true)")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.set)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    rows = []
    for mesh_label in args.mesh.split(","):
        mesh = make_production_mesh(multi_pod=(mesh_label == "multi"))
        for arch in archs:
            for shape_name in shapes:
                r = run_cell(arch, shape_name, mesh, mesh_label, args.out,
                             force=args.force, overrides=overrides)
                status = r["status"]
                extra = ""
                if status == "ok":
                    rf = r["roofline"]
                    extra = (f"dom={rf['dominant']} "
                             f"c={rf['compute_s']:.2e}s "
                             f"m={rf['memory_s']:.2e}s "
                             f"n={rf['collective_s']:.2e}s "
                             f"analyze={r['analyze_s']}s")
                elif status == "error":
                    extra = r["error"][:120]
                print(f"[{mesh_label}] {arch} x {shape_name}: "
                      f"{status} {extra}", flush=True)
                rows.append(r)
    ok = sum(1 for r in rows if r["status"] == "ok")
    sk = sum(1 for r in rows if r["status"] == "skipped")
    er = sum(1 for r in rows if r["status"] == "error")
    print(f"\ndry-run complete: {ok} ok, {sk} skipped, {er} errors")
    return 0 if er == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
