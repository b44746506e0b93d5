"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``: pointers and the stream pass as
``c_void_p``, and every C entry point returns ``cudaGetLastError()``. The
build runs at first use, one ``nvcc`` process per source, all started
together, into ``kernels/_build/`` (listed in ``.gitignore``). A library's
file name carries a hash of its source and flags, so an edited source is
never served by a stale build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("row_table_gather.cu", "row_table_rmw.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def _target(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all running at once. Returns ``{source: compiler output}`` (ptxas
    register and spill counts) for the sources built by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for source in SOURCES:
        out = _target(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[source] = (proc, tmp, out)
    logs, failed = {}, []
    for source, (proc, tmp, out) in jobs.items():
        logs[source], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(source)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {s}\n{logs[s]}" for s in failed))
    return logs


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _libs.get(source)
    if lib is None:
        out = _target(source)
        if not out.exists():
            build_all()
        lib = ctypes.CDLL(str(out))
        lib.dx_error_string.argtypes = [ctypes.c_int]
        lib.dx_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        msg = lib.dx_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def current_stream(device) -> ctypes.c_void_p:
    import torch.cuda
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
