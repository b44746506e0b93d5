"""Port bulk ops (repro_torch.core.bulk_ops) vs repro.core.bulk_ops.

The port's ``bulk_*`` run on the CPU with every combination of
``use_kernel`` (the kernels' plain versions on the CPU) and ``optimize``,
on 1-D and 2-D tables, against the reference's ``bulk_*(use_kernel=False)``
with the same ``optimize``. Streams carry out-of-range indices (negative
and past the end) and, for stores, a condition mask.

Tolerance: gathers, scatters and integer RMWs bit for bit; float MIN/MAX
bit for bit; float ADD/MUL rtol=1e-5, atol=1e-5 (reduction order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bulk_ops as jb
from repro_torch.core import bulk_ops, interop

N_ROWS, N_IDX, D = 300, 700, 4


def _stream(seed: int):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N_ROWS, size=N_IDX).astype(np.int32)
    pos = rng.choice(N_IDX, size=N_IDX // 8, replace=False)
    idx[pos] = np.where(rng.random(pos.size) < 0.5,
                        -rng.integers(1, N_ROWS, size=pos.size),
                        N_ROWS + rng.integers(0, N_ROWS, size=pos.size))
    cond = rng.random(N_IDX) < 0.7
    return idx, cond


def _values(seed: int, shape, dtype: str):
    rng = np.random.default_rng(seed)
    if dtype == "f32":
        return rng.normal(size=shape).astype(np.float32)
    x = rng.integers(-2 ** 31, 2 ** 31, size=shape, dtype=np.int64)
    return x.astype(np.int32).view(np.uint32 if dtype == "u32" else np.int32)


def _t(a):
    return interop.to_tensor(a, device="cpu")


def _check(got, want, *, loose=False):
    want = np.asarray(want)
    got = interop.to_numpy(got, want.dtype)
    assert got.shape == want.shape and got.dtype == want.dtype
    if loose:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ndim", [1, 2])
def test_bulk_gather(ndim):
    idx, _ = _stream(0)
    table = _values(1, (N_ROWS,) + (D,) * (ndim - 1), "f32")
    want = jb.bulk_gather(jnp.asarray(table), jnp.asarray(idx))
    for sort, dedup in ((True, True), (True, False), (False, False)):
        for use_kernel in (False, True):
            got = bulk_ops.bulk_gather(_t(table), _t(idx), sort=sort,
                                       dedup=dedup, use_kernel=use_kernel,
                                       block_rows=64, lanes=32, device="cpu")
            _check(got, want)
    # multi-dimensional index streams keep their shape
    got = bulk_ops.bulk_gather(_t(table), _t(idx[:600].reshape(20, 30)),
                               device="cpu")
    _check(got, np.asarray(want)[:600].reshape((20, 30) + table.shape[1:]))


@pytest.mark.parametrize("optimize", [True, False])
@pytest.mark.parametrize("ndim", [1, 2])
def test_bulk_scatter(ndim, optimize):
    idx, cond = _stream(2)
    shape = (N_ROWS,) + (D,) * (ndim - 1)
    table = _values(3, shape, "i32")
    vals = _values(4, (N_IDX,) + shape[1:], "i32")
    for c in (None, cond):
        want = jb.bulk_scatter(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(vals), optimize=optimize,
                               cond=None if c is None else jnp.asarray(c))
        got = bulk_ops.bulk_scatter(_t(table), _t(idx), _t(vals),
                                    optimize=optimize, device="cpu",
                                    cond=None if c is None else _t(c))
        _check(got, want)


RMW_CASES = [(op, "i32") for op in ("ADD", "MIN", "MAX", "AND", "OR",
                                    "XOR", "MUL")]
RMW_CASES += [(op, "u32") for op in ("MIN", "MAX", "AND")]   # unsigned order
RMW_CASES += [(op, "f32") for op in ("ADD", "MIN", "MAX", "MUL")]


@pytest.mark.parametrize("op,dtype", RMW_CASES)
@pytest.mark.parametrize("ndim", [1, 2])
def test_bulk_rmw(ndim, op, dtype):
    idx, cond = _stream(5)
    shape = (N_ROWS,) + (D,) * (ndim - 1)
    table = _values(6, shape, dtype)
    vals = _values(7, (N_IDX,) + shape[1:], dtype)
    if op == "MUL" and dtype == "f32":
        vals = (1 + 0.01 * vals).astype(np.float32)
    loose = dtype == "f32" and op in ("ADD", "MUL")
    wants = {}
    for optimize in (True, False):
        # the reference runs bitwise ops down one path for both settings
        ref_opt = optimize or op in ("AND", "OR", "XOR")
        if ref_opt not in wants:
            wants[ref_opt] = jb.bulk_rmw(
                jnp.asarray(table), jnp.asarray(idx), jnp.asarray(vals),
                op=op, optimize=ref_opt, cond=jnp.asarray(cond))
        for use_kernel in (False, True):
            got = bulk_ops.bulk_rmw(
                _t(table), _t(idx), _t(vals), op=op, optimize=optimize,
                use_kernel=use_kernel, block_rows=64, lanes=32,
                unsigned=dtype == "u32", cond=_t(cond), device="cpu")
            _check(got, wants[ref_opt], loose=loose)


@pytest.mark.parametrize("op,dtype", [("ADD", "f32"), ("MIN", "u32"),
                                      ("MAX", "i32"), ("MUL", "i32"),
                                      ("AND", "u32"), ("XOR", "i32")])
def test_segment_combine(op, dtype):
    """Empty segments (ids 7 and past 9) read the identity / extremum."""
    rng = np.random.default_rng(8)
    seg = np.sort(rng.choice([0, 1, 2, 3, 4, 5, 6, 8, 9], size=64))
    vals = _values(9, (64, D), dtype)
    want = jb.segment_combine(jnp.asarray(vals), jnp.asarray(seg),
                              num_segments=12, op=op)
    got = bulk_ops.segment_combine(_t(vals), torch.as_tensor(seg),
                                   num_segments=12, op=op,
                                   unsigned=dtype == "u32")
    _check(got, want, loose=dtype == "f32")


def test_empty_streams_and_inputs_untouched():
    table = _t(_values(1, (N_ROWS, D), "i32"))
    before = table.clone()
    e = torch.zeros((0,), dtype=torch.int32)
    assert bulk_ops.bulk_rmw(table, e, torch.zeros((0, D), dtype=torch.int32),
                             device="cpu") is table
    assert bulk_ops.bulk_scatter(table, e, torch.zeros((0, D),
                                                       dtype=torch.int32),
                                 device="cpu") is table
    assert bulk_ops.bulk_gather(table, e, device="cpu").shape == (0, D)
    idx, _ = _stream(0)
    bulk_ops.bulk_rmw(table, _t(idx), torch.ones((N_IDX, D),
                                                 dtype=torch.int32),
                      use_kernel=True, device="cpu")
    bulk_ops.bulk_scatter(table, _t(idx), torch.ones((N_IDX, D),
                                                     dtype=torch.int32),
                          device="cpu")
    assert torch.equal(table, before)


def test_bitwise_rmw_on_float_table_raises():
    with pytest.raises(ValueError, match="integer table"):
        bulk_ops.bulk_rmw(torch.zeros(8), torch.zeros(2, dtype=torch.int32),
                          torch.ones(2), op="XOR", device="cpu")


def test_bulk_ops_need_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        bulk_ops.bulk_gather(torch.zeros(4), torch.zeros(2, dtype=torch.int32))
