"""Port row-table kernels' plain versions vs the JAX package's.

On the CPU the port's kernel wrappers run their plain PyTorch versions
(``kernels/*/ref.py``); those are held against the reference's pure-jnp
oracles (``ops.*(use_ref=True)``, since the reference's Pallas kernels do
not run on the installed JAX) on ``tests/test_kernels.py``'s shapes and
dtypes. AND/OR/XOR, which the reference's ref rejects, are held against
the reference's ``bulk_rmw(use_kernel=False)``.

Tolerance: gathers and integer RMWs bit for bit; float ADD/MUL RMWs may
sum in another order, rtol=1e-5 / atol=1e-5 (f32) and rtol=2e-2 /
atol=1e-2 (bf16, one ulp); float MIN/MAX bit for bit.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bulk_rmw as ref_bulk_rmw
from repro.core import RowTablePlan
from repro.kernels.gather import ops as ref_gops
from repro.kernels.scatter_rmw import ops as ref_sops
from repro_torch.core import bulk_rmw, coalesce, interop, make_row_table_plan
from repro_torch.kernels.gather import gather as gk
from repro_torch.kernels.gather import ops as gops
from repro_torch.kernels.gather import ref as gref
from repro_torch.kernels.scatter_rmw import ops as sops
from repro_torch.kernels.scatter_rmw import ref as sref
from repro_torch.kernels.scatter_rmw import scatter_rmw as sk

SHAPES = [
    # (n_rows, d, n_idx, block_rows, lanes) — tests/test_kernels.py's
    (256, 128, 100, 64, 32),
    (1024, 128, 4096, 128, 128),
    (1024, 256, 513, 256, 64),
    (4096, 512, 2048, 512, 128),
    (777, 128, 300, 128, 32),       # non-multiple table rows
]
DTYPES = ["f32", "bf16", "i32", "u32"]
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=1e-2)}


def _np_table(rng, n, d, dtype):
    x = rng.normal(size=(n, d)).astype(np.float32)
    if dtype == "i32":
        return (x * 100).astype(np.int32)
    if dtype == "u32":
        return (x * 1e9).astype(np.int64).astype(np.uint32)
    if dtype == "bf16":
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    return x


def _torch(a):
    return interop.to_tensor(a, device="cpu")


def _compare(got: torch.Tensor, want, dtype, *, exact):
    want = np.asarray(want)
    got = interop.to_numpy(got, want.dtype)
    assert got.shape == want.shape
    if dtype == "bf16":
        got, want = got.astype(np.float32), want.astype(np.float32)
    if exact or dtype not in TOL:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL[dtype])


def _jax_plan(plan):
    fields = {f: jnp.asarray(getattr(plan, f).numpy()) for f in (
        "tile_block", "tile_first", "offsets", "src_pos", "valid",
        "n_tiles")}
    return RowTablePlan(**fields, block_rows=plan.block_rows,
                        lanes=plan.lanes, num_blocks=plan.num_blocks)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gather_plain_vs_reference(shape, dtype):
    n, d, t, br, lanes = shape
    rng = np.random.default_rng(7)
    table = _np_table(rng, n, d, dtype)
    idx = rng.integers(0, n, size=(t,)).astype(np.int32)
    n_pad = -(-n // br) * br
    plan = make_row_table_plan(coalesce(_torch(idx))[0], n_rows=n_pad,
                               block_rows=br, lanes=lanes)
    # the same plan on both sides (plans are held equal in
    # test_torch_reorder.py), so this compares the gathers alone
    want = ref_gops.row_table_gather(jnp.asarray(table), _jax_plan(plan),
                                     use_ref=True)
    before = gk.launches
    got = gops.row_table_gather(_torch(table), plan)
    assert gk.launches == before           # the CPU runs the plain version
    _compare(got, want, dtype, exact=True)


def _rmw_stream(rng, n, t):
    """Sorted, unique destinations framed by out-of-range ones (negative
    at the head, past the end at the tail), as bulk_rmw hands them on."""
    dest = np.unique(rng.integers(0, n, size=t))
    k = max(1, len(dest) // 16)
    return np.concatenate([-rng.integers(1, 5, size=k)[::-1] * 7, dest,
                           n + rng.integers(0, 5, size=k)]).astype(np.int32)


@pytest.mark.parametrize("op", ["ADD", "MAX", "MIN", "MUL"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_rmw_plain_vs_reference(shape, op):
    n, d, t, br, lanes = shape
    rng = np.random.default_rng(11)
    dtype = "f32" if op in ("ADD", "MIN") else "i32"
    table = _np_table(rng, n, d, dtype)
    dest = _rmw_stream(rng, n, t)
    vals = _np_table(rng, len(dest), d, dtype)
    want = ref_sops.row_table_rmw(jnp.asarray(table), jnp.asarray(dest),
                                  jnp.asarray(vals), op=op, block_rows=br,
                                  lanes=lanes, use_ref=True)
    tt = _torch(table)
    got = sops.row_table_rmw(tt, _torch(dest), _torch(vals), op=op,
                             block_rows=br, lanes=lanes)
    _compare(got, want, dtype, exact=op in ("MIN", "MAX"))
    np.testing.assert_array_equal(tt.numpy(), table)   # input not mutated


@pytest.mark.parametrize("op,dtype", [
    ("ADD", "bf16"), ("MUL", "f32"), ("MAX", "bf16"), ("MIN", "u32"),
    ("MAX", "u32"), ("ADD", "u32"), ("MUL", "u32")])
def test_rmw_plain_dtypes_vs_reference(op, dtype):
    n, d, t, br, lanes = 777, 8, 300, 128, 32
    rng = np.random.default_rng(5)
    table = _np_table(rng, n, d, dtype)
    dest = _rmw_stream(rng, n, t)
    vals = _np_table(rng, len(dest), d, dtype)
    if op == "MUL" and dtype == "f32":
        vals = (1 + 0.01 * vals).astype(np.float32)
    want = ref_sops.row_table_rmw(jnp.asarray(table), jnp.asarray(dest),
                                  jnp.asarray(vals), op=op, block_rows=br,
                                  lanes=lanes, use_ref=True)
    got = sops.row_table_rmw(_torch(table), _torch(dest), _torch(vals),
                             op=op, block_rows=br, lanes=lanes,
                             unsigned=dtype == "u32")
    _compare(got, want, dtype, exact=op in ("MIN", "MAX"))


@pytest.mark.parametrize("dtype", ["i32", "u32"])
@pytest.mark.parametrize("op", ["AND", "OR", "XOR"])
def test_rmw_bitwise_vs_reference_bulk(op, dtype):
    """The reference's ref raises for bitwise ops; judge the port's kernel
    path by the reference's bulk_rmw(use_kernel=False)."""
    n, d, t = 300, 8, 700
    rng = np.random.default_rng(3)
    table = _np_table(rng, n, d, dtype)
    idx = rng.integers(-20, n + 20, size=t).astype(np.int32)
    vals = _np_table(rng, t, d, dtype)
    want = ref_bulk_rmw(jnp.asarray(table), jnp.asarray(idx),
                        jnp.asarray(vals), op=op, use_kernel=False)
    got = bulk_rmw(_torch(table), _torch(idx), _torch(vals), op=op,
                   use_kernel=True, block_rows=64, lanes=32,
                   unsigned=dtype == "u32", device="cpu")
    _compare(got, want, dtype, exact=True)


def test_rmw_oob_destinations_dropped():
    """dests [-3, 0, 5, 5, 69, 70, 100] on 70 rows: the plan puts three
    lanes on row 69 and two on row 0 (clamped OOB lanes carry the
    identity); only the in-range updates land."""
    n, d = 70, 4
    table = np.arange(n * d, dtype=np.int32).reshape(n, d)
    dest = np.array([-3, 0, 5, 5, 69, 70, 100], np.int32)
    vals = np.full((7, d), 10, np.int32)
    want = ref_sops.row_table_rmw(jnp.asarray(table), jnp.asarray(dest),
                                  jnp.asarray(vals), op="ADD", block_rows=32,
                                  lanes=4, use_ref=True)
    got = sops.row_table_rmw(_torch(table), _torch(dest), _torch(vals),
                             op="ADD", block_rows=32, lanes=4)
    _compare(got, want, "i32", exact=True)
    expect = table.copy()
    expect[[0, 69]] += 10
    expect[5] += 20
    np.testing.assert_array_equal(got.numpy(), expect)


def test_kernel_wrappers_on_cpu_use_plain_versions():
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.normal(size=(64, 4)).astype(np.float32))
    plan = make_row_table_plan(torch.arange(0, 64, 3, dtype=torch.int32),
                               n_rows=64, block_rows=32, lanes=8)
    out = gk.row_table_gather(table, plan.tile_block, plan.offsets,
                              block_rows=32, lanes=8)
    assert torch.equal(out, gref.row_table_gather_ref(
        table, plan.tile_block, plan.offsets, block_rows=32, lanes=8))
    vals = torch.ones((plan.num_tiles * 8, 4))
    args = (plan.tile_block, plan.tile_first.to(torch.int32), plan.offsets,
            vals)
    copy = table.clone()
    assert sk.row_table_rmw_(copy, *args, block_rows=32, lanes=8) is copy
    assert torch.equal(copy, sref.row_table_rmw_ref_(table.clone(), *args,
                                                     block_rows=32, lanes=8))
    assert not torch.equal(copy, table)
    with pytest.raises(ValueError, match="multiple of block_rows"):
        gk.row_table_gather(table[:60], plan.tile_block, plan.offsets,
                            block_rows=32, lanes=8)
    with pytest.raises(ValueError, match="integer table"):
        sk.row_table_rmw_(table.clone(), *args, block_rows=32, lanes=8,
                          op="XOR")
