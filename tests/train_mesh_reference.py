"""The two sides of tests/test_torch_train_mesh.py and
tests/test_torch_train_mesh_families.py, and the checks both make.

``run_cases`` draws each case's inputs (``train_mesh_ranks.case_inputs``),
starts the reference's sharded step in one subprocess per world (this
file run as a script, on 8 forced host devices, meshes built with ``Auto``
axis types: ``launch.mesh.make_host_mesh`` gives ``Explicit`` axes on the
installed JAX, where the sharded step's embedding gather fails; ROADMAP,
reference caveats) and, while they run, spawns each gloo world once
(``train_mesh_ranks.train_main``). The ``check_*`` functions hold a
case's ranks against the reference:

  * loss and grad_norm at every step within rtol 1e-5 of the
    reference's, and equal bit for bit on every rank;
  * every updated leaf, gathered (params and both moments: the moments
    carry the clipped gradient), within the relative L2 error of
    tests/test_torch_train.py (GRAD_REL_L2);
  * each rank holding only its ``param_specs`` / ``zero1_specs`` shards
    and its ``batch_specs`` block (``launch.mesh.block_spec``): the shapes
    and the storage bytes.
"""
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import train_mesh_ranks as tr

ROOT = Path(__file__).resolve().parents[1]
GRAD_REL_L2, METRIC_RTOL = 2e-5, 1e-5       # as tests/test_torch_train.py
SPAWN_LIMIT = 180.0


def world_of(case) -> int:
    return int(np.prod(case["mesh"]))


def reference(inputs_path, out_path, cases):
    """The reference's sharded step on every case of ``cases`` (a dict
    name -> case): its metrics at each step and its whole leaves after
    the last, to ``out_path`` (npz)."""
    import dataclasses
    import jax
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.launch import mesh as rmesh
    from repro.models import build_model
    from repro.optim import adamw_init
    from repro.train.trainer import shard_train_step
    z = np.load(inputs_path)
    out = {}
    for name, case in cases.items():
        cfg = configs.get_config(case["arch"]).reduced(**case.get("ov", {}))
        if case.get("ep"):
            cfg = dataclasses.replace(cfg, moe_a2a=True)
        model = build_model(cfg)
        pre = f"{name}/"
        flat = {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}
        params = tr._unflatten({k[2:]: v for k, v in flat.items()
                                if k.startswith("p/")})
        batch = {k[2:]: v for k, v in flat.items() if k.startswith("b/")}
        opt = adamw_init(params, state_dtype="float32")
        mesh = jax.make_mesh(tuple(case["mesh"]), tuple(case["axes"]),
                             axis_types=(AxisType.Auto,) * len(case["axes"]),
                             devices=jax.devices()[:world_of(case)])
        pspecs = rmesh.param_specs(params, mesh)
        zspecs = rmesh.zero1_specs(pspecs, params, mesh)

        def put(tree, specs):
            return jax.tree_util.tree_map(
                lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                tree, specs, is_leaf=lambda x: isinstance(x, P))
        step = shard_train_step(model, mesh, params, opt, batch)
        p = put(params, pspecs)
        o = {"mu": put(opt["mu"], zspecs), "nu": put(opt["nu"], zspecs),
             "step": opt["step"]}
        b = put(batch, rmesh.batch_specs(batch, mesh))
        with jax.sharding.set_mesh(mesh):
            for i in range(case["steps"]):
                p, o, m = step(p, o, b)
                for k in ("loss", "grad_norm", "lr"):
                    out[f"{name}/m/{i}/{k}"] = np.asarray(m[k])
        whole = jax.tree_util.tree_map(np.asarray, {"p": p, "o": o})
        for path, leaf in jax.tree_util.tree_leaves_with_path(whole):
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            out[f"{name}/w/{key}"] = leaf
    np.savez(out_path, **out)


def run_cases(cases: dict, tmp: Path) -> dict:
    """Every case of ``cases`` on the reference and on the port's gloo
    worlds: ``{"ref": {key: array}, "world": {w: [rank results]},
    "seconds": {w: s}}``."""
    from repro_torch.distributed.spawn import run_ranks
    arrays = {}
    for name, case in cases.items():
        params, batch = tr.case_inputs(name, case)
        arrays.update({f"{name}/p/{k}": v
                       for k, v in tr._flat(params).items()})
        arrays.update({f"{name}/b/{k}": v for k, v in batch.items()})
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    worlds = sorted({world_of(c) for c in cases.values()})
    # one reference process per world, running while the worlds spawn
    refs = {w: subprocess.Popen(
        [sys.executable, __file__, str(inputs), str(tmp / f"ref{w}.npz"),
         json.dumps({n: c for n, c in cases.items() if world_of(c) == w})],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for w in worlds}
    got, seconds = {}, {}
    try:
        for w in worlds:
            out = tmp / f"world{w}"
            out.mkdir()
            t0 = time.perf_counter()
            run_ranks(tr.train_main, w, args=(str(inputs), cases, str(out)),
                      backend="gloo", init_method=f"file://{out}/store",
                      timeout=60, join_timeout=SPAWN_LIMIT)
            seconds[w] = time.perf_counter() - t0
            got[w] = [pickle.loads((out / f"rank{r}.pkl").read_bytes())
                      for r in range(w)]
        for proc in refs.values():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
    finally:
        for proc in refs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ref = {}
    for w in worlds:
        with np.load(tmp / f"ref{w}.npz") as z:
            ref.update(dict(z))
    return {"ref": ref, "world": got, "seconds": seconds}


def ranks_of(runs, name, case):
    return [r["cases"][name] for r in runs["world"][world_of(case)]]


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def check_metrics(runs, name, case):
    ranks = ranks_of(runs, name, case)
    for i, m in enumerate(ranks[0]["metrics"]):
        for k in ("loss", "grad_norm"):
            want = float(runs["ref"][f"{name}/m/{i}/{k}"])
            np.testing.assert_allclose(m[k + "_f"], want, rtol=METRIC_RTOL,
                                       err_msg=f"step {i} {k}")
        assert m["lr_f"] == float(runs["ref"][f"{name}/m/{i}/lr"])
    keys = ("loss", "grad_norm", "lr")
    for r in ranks[1:]:                      # equal on every rank
        assert [{k: m[k] for k in keys} for m in r["metrics"]] == \
            [{k: m[k] for k in keys} for m in ranks[0]["metrics"]]


def check_leaves(runs, name, case):
    whole = ranks_of(runs, name, case)[0]["whole"]
    want = {k[len(name) + 3:]: v for k, v in runs["ref"].items()
            if k.startswith(f"{name}/w/")}
    assert set(whole) == set(want)
    worst = max((rel_l2(whole[k], want[k]), k) for k in want
                if want[k].dtype.kind == "f")
    assert worst[0] <= GRAD_REL_L2, worst
    assert np.array_equal(whole["o/step"], want["o/step"])


def check_held(runs, name, case):
    """Between steps: every leaf of params, moments and batch has its
    shard's shape under the reference's specs (a batch leaf under
    ``block_spec``), and its storage holds that shard's bytes and no
    more; the batch counts as split where its DP axes divide it."""
    from repro_torch.core.tree import tree_leaves_with_path
    from repro_torch.launch import mesh as meshlib
    params, batch = tr.case_inputs(name, case)
    stub = meshlib.Mesh(tuple(case["mesh"]), tuple(case["axes"]), "cpu")
    pspecs = meshlib.param_specs(params, stub)
    zspecs = meshlib.zero1_specs(pspecs, params, stub)
    bspecs = meshlib.batch_specs(batch, stub)
    bspecs = {k: meshlib.block_spec(k, v.ndim, bspecs)
              for k, v in batch.items()}
    want = {"o/step": ((), 4)}
    for pre, tree, specs in (("p", params, pspecs), ("o/mu", params, zspecs),
                             ("o/nu", params, zspecs), ("b", batch, bspecs)):
        spec_of = dict(tree_leaves_with_path(specs, is_leaf=meshlib.is_spec))
        for path, leaf in tree_leaves_with_path(tree):
            shape = list(leaf.shape)
            for d, ax in enumerate(spec_of[path]):
                for a in (() if ax is None else
                          (ax,) if isinstance(ax, str) else ax):
                    shape[d] //= stub.shape[a]
            key = "/".join((pre,) + tuple(map(str, path)))
            want[key] = (tuple(shape), int(np.prod(shape)) * leaf.itemsize)
    ranks = ranks_of(runs, name, case)
    for r in ranks:
        assert r["held"] == want
    split = case["batch"] % int(np.prod(case["mesh"][:-1])) == 0
    assert all(r["batch_split"] == split for r in ranks)


if __name__ == "__main__":
    reference(sys.argv[1], sys.argv[2], json.loads(sys.argv[3]))
