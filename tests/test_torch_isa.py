"""Port ISA (repro_torch.core.isa) vs the JAX reference (repro.core.isa).

Inputs are made from a seed with NumPy and fed to both. Every comparison is
exact (NaN positions must agree): ``alu_apply`` and the conversions are
elementwise with one rounding, so they must agree bit for bit, bf16 and the
u32 container included. JAX runs with 64-bit types off, as the reference
does on this tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import isa as jisa
from repro_torch.core import interop, isa

DTYPES = ("f32", "i32", "u32", "bf16")
N = 512


def _operands(dtype: str, seed: int):
    rng = np.random.default_rng(seed)
    if dtype in ("f32", "bf16"):
        x = rng.normal(scale=100.0, size=N).astype(np.float32)
        x[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 3e38]
        return x
    x = rng.integers(-2 ** 31, 2 ** 31, size=N, dtype=np.int64)
    x[:6] = [0, 1, -1, 2 ** 31 - 1, -2 ** 31, 31]
    return x.astype(np.int32).view(np.uint32 if dtype == "u32" else np.int32)


def _shift_amounts(dtype: str, seed: int):
    rng = np.random.default_rng(seed)
    b = rng.integers(-40, 72, size=N).astype(np.int32)
    b[:6] = [0, 31, 32, 33, -1, -32]
    return b.view(np.uint32) if dtype == "u32" else b


def _jax(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(jisa.DTYPES[dtype])


def _port(a: np.ndarray, dtype: str):
    t = interop.to_tensor(a, device="cpu")
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _assert_equal(got: torch.Tensor, want):
    want = np.asarray(want)
    got = interop.to_numpy(got, want.dtype)
    assert got.dtype == want.dtype
    if want.dtype.name == "bfloat16":
        got, want = got.astype(np.float32), want.astype(np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", isa.ALU_OPS)
def test_alu_apply(op, dtype):
    a = _operands(dtype, 1)
    b = (_shift_amounts(dtype, 2) if op in ("SHR", "SHL")
         else _operands(dtype, 2))
    floating = dtype in ("f32", "bf16")
    if floating and op in ("AND", "OR", "XOR", "SHR", "SHL"):
        with pytest.raises(TypeError):
            jisa.alu_apply(op, _jax(a, dtype), _jax(b, dtype))
        with pytest.raises(TypeError):
            isa.alu_apply(op, _port(a, dtype), _port(b, dtype))
        return
    want = jisa.alu_apply(op, _jax(a, dtype), _jax(b, dtype))
    got = isa.alu_apply(op, _port(a, dtype), _port(b, dtype),
                        unsigned=dtype == "u32")
    _assert_equal(got, want)


@pytest.mark.parametrize("op,dtype", [
    (op, dt) for op in isa.RMW_OPS for dt in DTYPES
    if not (op in ("AND", "OR", "XOR") and dt in ("f32", "bf16"))])
def test_rmw_identity(op, dtype):
    want = jisa.rmw_identity(op, jisa.DTYPES[dtype])
    got = isa.rmw_identity(op, dtype)
    assert got.dtype == isa.DTYPES[dtype]
    _assert_equal(got, want)
    # the torch-dtype spelling with an explicit container flag agrees
    same = isa.rmw_identity(op, isa.DTYPES[dtype], unsigned=dtype == "u32")
    assert torch.equal(same, got)


@pytest.mark.parametrize("dst", DTYPES)
@pytest.mark.parametrize("src", DTYPES)
def test_convert_matches_astype(src, dst):
    """``astype`` between kinds: saturating float->int with NaN -> 0,
    bit-preserving i32<->u32, unsigned u32->float."""
    a = _operands(src, 3)
    want = _jax(a, src).astype(jisa.DTYPES[dst])
    got = isa.convert(_port(a, src), src, dst)
    _assert_equal(got, want)


@pytest.mark.parametrize("kb", DTYPES)
@pytest.mark.parametrize("ka", DTYPES)
def test_promotion_matches_jax(ka, kb):
    """Mixed-kind ALU operands promote as JAX does with x64 off (u32 with
    i32 computes in i32, ints with floats in the float)."""
    a, b = _operands(ka, 4), _operands(kb, 5)
    want = jisa.alu_apply("MAX", _jax(a, ka), _jax(b, kb))
    pa, pb, kind = isa.promote(_port(a, ka), ka, _port(b, kb), kb)
    got = isa.alu_apply("MAX", pa, pb, unsigned=kind == "u32")
    _assert_equal(got, want)


def test_widths_mirror_x64_off():
    for name in ("i64", "u64", "f64"):
        width = np.dtype(jax.dtypes.canonicalize_dtype(jisa.DTYPES[name]))
        assert isa.DTYPES[name].itemsize == width.itemsize == 4


def test_u32_register_out_of_range_raises():
    with pytest.raises(OverflowError):
        isa.scalar(-1, "u32", "cpu")
    assert int(isa.scalar(2 ** 32 - 1, "u32", "cpu")) == -1


def test_program_validation_mirrors_reference():
    with pytest.raises(ValueError, match="read after"):
        isa.AccessProgram((isa.IST("f32", "A", "i", "v"),
                           isa.ILD("f32", "A", "o", "i")))
    with pytest.raises(ValueError, match="duplicate"):
        isa.AccessProgram((isa.RNG("t", "t", "lo", "hi"),))
    with pytest.raises(ValueError, match="associative"):
        isa.IRMW("f32", "A", "SUB", "i", "v")
    prog = isa.AccessProgram((isa.SLD("i32", "X", "i", rs1="base"),
                              isa.ALUS("i32", "ADD", "j", "i", rs="k"),
                              isa.ILD("f32", "Y", "o", "w")))
    ref = jisa.AccessProgram((jisa.SLD("i32", "X", "i", rs1="base"),
                              jisa.ALUS("i32", "ADD", "j", "i", rs="k"),
                              jisa.ILD("f32", "Y", "o", "w")))
    assert prog.regions() == ref.regions()
    assert prog.register_names() == ref.register_names()
    assert prog.external_tiles() == ref.external_tiles()
    assert prog.scratch_tiles() == ref.scratch_tiles()
    with pytest.raises(ValueError, match="DX001"):
        prog.check_inputs({"X": 0, "Y": 0}, {"base": 0, "k": 1}, {})
