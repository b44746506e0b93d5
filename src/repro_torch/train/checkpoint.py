"""Sharded checkpointing with restart + integrity manifest (pure NumPy IO).

Layout:  <dir>/step_<N>/
           manifest.json       step, entries (shard, dtype, shape, hash
                               per flattened leaf), shard list, extra
                               (data-pipeline cursor)
           shard_<k>.npz       flat param/optimizer leaves, chunked ~512MB

Fault-tolerance contract:
  * write is atomic: shards + manifest land in step_<N>.tmp, then one
    rename — a machine dying mid-write never corrupts the latest good step;
  * every shard carries a content hash checked on load (bit-rot/partial
    writes surface as errors, not silent divergence);
  * ``keep_last`` old steps are retained for rollback;
  * elastic restart: leaves are stored whole, so a restart may use any
    mesh shape (see train/elastic.py).

The port of the JAX package's ``train.checkpoint``, with its on-disk
format: the same flattened keys (``params/layers/attn/wq``), bf16 stored
as its uint16 bits with the true dtype in the manifest, the same 16-hex
SHA-256 prefixes of the stored bytes. A checkpoint written by either
package loads in the other. Loaded leaves are tensors on the template
leaf's device (the CPU where the template holds no tensor), or where
``shardings`` places them.

From a process mesh (``launch.mesh.RankMesh``), ``save_checkpoint`` with
``mesh=`` and ``specs=`` gathers whole leaves, one at a time, and rank 0
writes exactly the one-device files and manifest while the other ranks
wait at a barrier; ``train.elastic.elastic_restore`` reads whole leaves
on every rank and cuts each rank's shards for any mesh.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.tree import (path_key, tree_leaves_with_path,
                                   tree_map_with_path)

# npz can't store bf16/fp8: round-trip via a same-width unsigned view, with
# the true dtype recorded in the manifest.
_EXOTIC = {"bfloat16": (np.uint16, torch.int16),
           "float8_e4m3fn": (np.uint8, torch.uint8),
           "float8_e5m2": (np.uint8, torch.uint8)}


def _encode(t: torch.Tensor):
    """A tensor as (NumPy array as stored, true dtype name)."""
    t = t.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if name in _EXOTIC:
        store, bits = _EXOTIC[name]
        return t.contiguous().view(bits).numpy().view(store), name
    arr = t.contiguous().numpy()
    return arr, arr.dtype.name


def _decode(arr: np.ndarray, true_dtype: str) -> torch.Tensor:
    if true_dtype in _EXOTIC and arr.dtype == _EXOTIC[true_dtype][0]:
        bits = torch.from_numpy(arr.view(_EXOTIC[true_dtype][0]).copy())
        return bits.view(_EXOTIC[true_dtype][1]).view(
            getattr(torch, true_dtype))
    return torch.from_numpy(np.array(arr, copy=True))


def _hash(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def save_checkpoint(directory: str, step: int, state: Any, *,
                    extra: Optional[dict] = None, keep_last: int = 3,
                    shard_bytes: int = 512 << 20, mesh=None,
                    specs=None) -> str:
    """Write ``state`` as ``<directory>/step_<step>``; returns that path.
    With ``mesh`` a process mesh, ``state`` holds this rank's shards under
    the spec tree ``specs`` and every rank of the mesh calls it."""
    if mesh is not None:
        return _save_from_ranks(directory, step, state, extra=extra,
                                keep_last=keep_last,
                                shard_bytes=shard_bytes, mesh=mesh,
                                specs=specs)
    flat = {path_key(p): leaf for p, leaf in tree_leaves_with_path(state)}
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)

    shards, cur, cur_bytes, sid = [], {}, 0, 0
    manifest_entries = {}
    for key in sorted(flat):
        arr, true_dtype = _encode(torch.as_tensor(flat[key]))
        cur[key] = arr
        cur_bytes += arr.nbytes
        manifest_entries[key] = {
            "shard": sid, "dtype": true_dtype, "shape": list(arr.shape),
            "hash": _hash(arr)}
        if cur_bytes >= shard_bytes:
            np.savez(os.path.join(tmp, f"shard_{sid}.npz"), **cur)
            shards.append(sid)
            cur, cur_bytes, sid = {}, 0, sid + 1
    if cur:
        np.savez(os.path.join(tmp, f"shard_{sid}.npz"), **cur)
        shards.append(sid)

    manifest = {"step": step, "entries": manifest_entries,
                "shards": shards, "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish

    # retention
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for old in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, f"step_{old}"),
                      ignore_errors=True)
    return final


def _save_from_ranks(directory, step, state, *, extra, keep_last,
                     shard_bytes, mesh, specs) -> str:
    """Gather every leaf whole (on the host of rank 0 only), write as one
    device would on rank 0, and hold every rank at a barrier until the
    step is published."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import is_spec, whole_of
    spec_of = dict(tree_leaves_with_path(specs, is_leaf=is_spec))
    whole = {}
    for p, leaf in tree_leaves_with_path(state):
        t = whole_of(leaf, spec_of[p], mesh)
        if mesh.rank == 0:
            whole[p] = t.cpu()
        del t
    path = os.path.join(directory, f"step_{step}")
    if mesh.rank == 0:
        path = save_checkpoint(
            directory, step, tree_map_with_path(lambda p, _: whole[p],
                                                state),
            extra=extra, keep_last=keep_last, shard_bytes=shard_bytes)
    dist.barrier()
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def load_checkpoint(directory: str, template: Any, *,
                    step: Optional[int] = None,
                    shardings: Optional[Any] = None):
    """Load into the structure of ``template``; ``shardings`` (a tree of
    ``launch.mesh.NamedSharding`` shaped like ``template``) places each
    leaf on its mesh's device (elastic restart).
    Returns (state, manifest_extra, step)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for sid in manifest["shards"]:
        with np.load(os.path.join(path, f"shard_{sid}.npz")) as z:
            for k in z.files:
                arr = z[k]
                want = manifest["entries"][k]["hash"]
                got = _hash(arr)
                if want != got:
                    raise IOError(
                        f"checkpoint corruption: {k} hash {got} != {want}")
                flat[k] = _decode(arr, manifest["entries"][k]["dtype"])

    def place(p, like, *sharding):
        t = flat[path_key(p)]
        if sharding:
            return t.to(sharding[0].device)
        if isinstance(like, torch.Tensor):
            return t.to(like.device)
        return t

    extra = (shardings,) if shardings is not None else ()
    state = tree_map_with_path(place, template, *extra)
    return state, manifest["extra"], step
