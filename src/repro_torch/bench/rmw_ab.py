"""A/B the row-table scatter-RMW kernel against another build of it, on one
GPU, at ``chip_smoke.py`` phase 4's shapes.

    python3 src/repro_torch/bench/rmw_ab.py --other OLD.cu

``OLD.cu`` is another version of ``kernels/csrc/row_table_rmw.cu`` with
the same C entry point (``dx_row_table_rmw``), for example an earlier
commit's, written out with ``git show <commit>:<path>`` into a directory
that ``.gitignore`` lists. It is built with the same ``nvcc`` flags as the
kernels. Both run on one engine tile of the smoke's zipf stream and one of
its uniform stream (its data, seed 0): first each updates a copy of the
same table once and the two results must be equal bit for bit, then each
is timed with CUDA events over ``chip_smoke.ITERS`` launches, in the
order other, this, this, other, twice, with ``index_add_`` beside them.
Prints the card's name and power limit, one line per timing and a JSON
summary as its last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
ROUNDS = 2


def build_other(source: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build
    out = build.BUILD_DIR / f"ab-{source.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                    str(source)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.dx_error_string.argtypes = [ctypes.c_int]
    lib.dx_error_string.restype = ctypes.c_char_p
    return lib


def other_rmw_(lib, table, tile_block, tile_first, offsets, vals, *,
               block_rows: int, lanes: int, op: str):
    """The other build's ``dx_row_table_rmw`` on the wrapper's arguments."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    num_tiles = tile_block.shape[0]
    # one byte per lane: room for a mark byte or a mark bit per lane
    scratch = torch.empty((num_tiles * lanes + 4,), dtype=torch.uint8,
                          device=table.device)
    fn = lib.dx_row_table_rmw
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(table.data_ptr(), tile_block.data_ptr(),
                tile_first.data_ptr(), offsets.data_ptr(), vals.data_ptr(),
                scratch.data_ptr(), table.shape[0], table.shape[1],
                num_tiles, block_rows, lanes, 0, sk.OP_CODES[op],
                build.current_stream(table.device))
    build.check(lib, status, "other row_table_rmw")
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="another version of row_table_rmw.cu")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("rmw_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    lib = build_other(args.other)
    A, V, B = cs.make_data(dev, cs.LOOKUPS, 0)
    summary = {"card": smi, "other": str(args.other), "iters": cs.ITERS}
    for stream in ("zipf", "uniform"):
        r_args, r_kw, nbytes, touched = cs.rmw_tile(A, V, B[stream][:cs.TILE])
        mine = sk.row_table_rmw_(A.clone(), *r_args, **r_kw)
        theirs = other_rmw_(lib, A.clone(), *r_args, **r_kw)
        torch.cuda.synchronize()
        if not torch.equal(mine.view(torch.int32), theirs.view(torch.int32)):
            raise AssertionError(f"{stream}: the two builds disagree")
        del mine, theirs
        work = A.clone()
        fns = {"other": lambda: other_rmw_(lib, work, *r_args, **r_kw),
               "this": lambda: sk.row_table_rmw_(work, *r_args, **r_kw)}
        rows = (r_args[0][:, None].long() * r_kw["block_rows"]
                + r_args[2]).reshape(-1)
        times = {"other": [], "this": []}
        for _ in range(ROUNDS):
            for name in ("other", "this", "this", "other"):
                ms = cs.time_ms(fns[name], cs.ITERS)
                times[name].append(ms)
                print(f"{stream:7s} {name:5s} {ms:.4f} ms", flush=True)
        lib_ms = cs.time_ms(lambda: work.index_add_(0, rows, r_args[-1]),
                            cs.ITERS)
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        print(f"{stream:7s} index_add_ {lib_ms:.4f} ms; bound {bound:.4f} ms "
              f"(bytes, {touched} rows touched)", flush=True)
        summary[stream] = dict(times, library_ms=lib_ms, bound_ms=bound,
                               touched=touched)
        del work
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
