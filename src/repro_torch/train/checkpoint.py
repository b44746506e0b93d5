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

Shard files are written and read side by side (``IO_THREADS`` threads:
the copies, checksums and hashes release the GIL); the files are those
of one writer.

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
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.tree import (path_key, tree_leaves_with_path,
                                   tree_map_with_path)

IO_THREADS = 8                 # shard files written or read at once

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
    """A stored array as a tensor of its true dtype; the array's own
    memory where it is writable (an array read from an npz is)."""
    if not arr.flags.writeable:
        arr = arr.copy()
    if true_dtype in _EXOTIC and arr.dtype == _EXOTIC[true_dtype][0]:
        bits = torch.from_numpy(arr)
        return bits.view(_EXOTIC[true_dtype][1]).view(
            getattr(torch, true_dtype))
    return torch.from_numpy(arr)


def _io_map(fn, items) -> list:
    """``fn`` over the shard ids ``items`` in up to IO_THREADS threads, in
    order: a shard file's bytes are copied, checksummed and hashed with
    the GIL released, so shards are written and read side by side."""
    items = list(items)
    if len(items) <= 1:
        return [fn(i) for i in items]
    with ThreadPoolExecutor(min(IO_THREADS, len(items))) as pool:
        return list(pool.map(fn, items))


def _hash(arr: np.ndarray) -> str:
    """The 16-hex SHA-256 prefix of the array's bytes in C order, hashed
    in place."""
    return hashlib.sha256(np.ascontiguousarray(arr)).hexdigest()[:16]


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
    flat = {path_key(p): torch.as_tensor(leaf)
            for p, leaf in tree_leaves_with_path(state)}
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)

    # leaves in key order, a shard closed once it holds shard_bytes
    groups, cur, cur_bytes = [], [], 0
    for key in sorted(flat):
        cur.append(key)
        cur_bytes += flat[key].numel() * flat[key].element_size()
        if cur_bytes >= shard_bytes:
            groups.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        groups.append(cur)

    def write(sid):
        arrays, entries = {}, {}
        for key in groups[sid]:
            arr, true_dtype = _encode(flat[key])
            arrays[key] = arr
            entries[key] = {"shard": sid, "dtype": true_dtype,
                            "shape": list(arr.shape), "hash": _hash(arr)}
        np.savez(os.path.join(tmp, f"shard_{sid}.npz"), **arrays)
        return entries

    manifest_entries = {}
    for entries in _io_map(write, range(len(groups))):
        manifest_entries.update(entries)
    manifest = {"step": step, "entries": manifest_entries,
                "shards": list(range(len(groups))), "extra": extra or {}}
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
    def read(sid):
        out = {}
        with np.load(os.path.join(path, f"shard_{sid}.npz")) as z:
            for k in z.files:
                arr = z[k]
                want = manifest["entries"][k]["hash"]
                got = _hash(arr)
                if want != got:
                    raise IOError(
                        f"checkpoint corruption: {k} hash {got} != {want}")
                out[k] = _decode(arr, manifest["entries"][k]["dtype"])
        return out

    flat = {}
    for part in _io_map(read, manifest["shards"]):
        flat.update(part)

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
