"""The port's optimizer (``repro_torch.optim``) against the JAX package's
on the CPU, on the same seeded NumPy inputs.

Bit for bit: the schedules (every step of four (warmup, total) pairs,
an int and a 0-d tensor step; the CPU cosine is the C library's ``cosf``,
as XLA's CPU backend calls), ``compress_grads``'s int8 ``q`` and its f32
scales (``torch.round`` and ``jnp.round`` both round half to even). The
AdamW update within rtol=2e-6 / atol=1e-9 in f32 given equal gradients
(XLA and PyTorch round ``b ** step`` and fused products in their own
orders; one ulp is 6e-8 relative), its bf16 moments within one bf16 ulp
(rtol=2**-7) where an f32 ulp moves the rounding. The global norm within
rtol=1e-6 (each package sums a leaf in its own order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro.optim import schedules as ref_sched
from repro_torch.optim import (adamw_init, adamw_update, compress_grads,
                               decompress_grads, global_norm_clip,
                               make_schedule)
from repro_torch.optim import compress, schedules

RTOL, ATOL = 2e-6, 1e-9
SHAPES = {"w": (37, 19), "b": (300,), "nest": {"k": (4, 5, 6), "s": ()}}


def np_tree(seed, shapes=SHAPES, scale=1.0):
    rng = np.random.default_rng(seed)

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return (rng.normal(size=s) * scale).astype(np.float32)
    return draw(shapes)


def to_torch(tree, dtype=None):
    return jax.tree.map(lambda a: torch.tensor(a, dtype=dtype), tree)


def to_jax(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype=dtype), tree)


def as_np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(t, dtype=np.float32) if t.dtype == jnp.bfloat16 \
        else np.asarray(t)


def assert_trees(got, want, rtol=RTOL, atol=ATOL):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        as_np(g), as_np(w), rtol=rtol, atol=atol), got, want)


@pytest.mark.parametrize("name", ["cosine", "wsd"])
@pytest.mark.parametrize("warmup,total", [(100, 10000), (1, 6), (10, 100),
                                          (7, 33)])
def test_schedules_bit_for_bit(name, warmup, total):
    want = ref_sched.make_schedule(name, peak_lr=3e-4, warmup=warmup,
                                   total=total)
    got = make_schedule(name, peak_lr=3e-4, warmup=warmup, total=total)
    for s in range(0, total + 3, max(1, total // 150)):
        for g, w in ((got(s), want(s)),
                     (got(torch.tensor(s, dtype=torch.int32)),
                      want(jnp.asarray(s, jnp.int32)))):
            assert g.dtype == torch.float32 and g.shape == ()
            assert g.numpy().tobytes() == np.asarray(w).tobytes(), (s, g, w)


def test_schedule_names_and_phases():
    with pytest.raises(ValueError, match="unknown schedule"):
        make_schedule("linear")
    s = make_schedule("wsd", peak_lr=1.0, warmup=10, total=100)
    assert float(s(5)) < 1.0
    assert float(s(50)) == 1.0
    assert float(s(99)) < 0.2
    cos = schedules.cosine_schedule(torch.tensor([0, 50, 100]), peak_lr=1.0,
                                    warmup=10, total=100)
    assert cos.shape == (3,) and float(cos[0]) == 0.0


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_init_matches_reference(state_dtype):
    params = np_tree(0)
    got = adamw_init(to_torch(params), state_dtype=state_dtype)
    want = ref_adamw.adamw_init(to_jax(params), state_dtype=state_dtype)
    assert got["step"].dtype == torch.int32 and got["step"].shape == ()
    jax.tree.map(lambda g, w: (g.shape == w.shape and str(g.dtype).endswith(
        str(w.dtype))) or pytest.fail(f"{g.dtype} {w.dtype}"), got, want)


@pytest.mark.parametrize("lr_as_tensor", [False, True])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype, lr_as_tensor):
    params = np_tree(1)
    rtol = RTOL if state_dtype == "float32" else 2 ** -7
    p, pw = to_torch(params), to_jax(params)
    s = adamw_init(p, state_dtype=state_dtype)
    sw = ref_adamw.adamw_init(pw, state_dtype=state_dtype)
    for step in range(3):
        grads = np_tree(10 + step, scale=1e-2)
        lr = 1e-2 * (step + 1)
        p, s = adamw_update(p, to_torch(grads), s,
                            lr=torch.tensor(lr) if lr_as_tensor else lr)
        pw, sw = ref_adamw.adamw_update(pw, to_jax(grads), sw,
                                        lr=jnp.float32(lr))
        assert_trees(p, pw)
        assert_trees(s["mu"], sw["mu"], rtol=rtol)
        assert_trees(s["nu"], sw["nu"], rtol=rtol)
        assert int(s["step"]) == int(sw["step"]) == step + 1


def test_adamw_update_is_out_of_place():
    p = to_torch(np_tree(2))
    before = jax.tree.map(torch.clone, p)
    s = adamw_init(p, state_dtype="float32")
    p2, s2 = adamw_update(p, to_torch(np_tree(3)), s, lr=0.1)
    jax.tree.map(lambda a, b: torch.equal(a, b) or pytest.fail("mutated"),
                 p, before)
    assert int(s["step"]) == 0 and int(s2["step"]) == 1
    assert not torch.equal(p2["w"], p["w"])


def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params, state_dtype="float32")
    for _ in range(200):
        params, state = adamw_update(params, {"w": 2 * params["w"]}, state,
                                     lr=0.05, weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.2


@pytest.mark.parametrize("grad_dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("n", [1, 256, 4097])
def test_compress_q_bit_for_bit(n, grad_dtype):
    rng = np.random.default_rng(n)
    g = {"a": rng.normal(size=(n,)).astype(np.float32) * 3,
         "b": {"c": rng.normal(size=(3, 7)).astype(np.float32)}}
    g["a"][: n // 3] = np.round(g["a"][: n // 3])      # ties after scaling
    resid = jax.tree.map(lambda a: (a * 1e-3).astype(np.float32), g)
    tdt = torch.bfloat16 if grad_dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if grad_dtype == "bfloat16" else jnp.float32
    for r in (None, resid):
        (q, sc), new_r = compress_grads(
            to_torch(g, tdt), None if r is None else to_torch(r, tdt))
        (qw, scw), new_rw = ref_compress.compress_grads(
            to_jax(g, jdt), None if r is None else to_jax(r, jdt))
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            a.numpy(), np.asarray(b)), q, qw)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            a.numpy(), np.asarray(b)), sc, scw)
        assert_trees(new_r, new_rw, rtol=1e-6, atol=1e-6)
        assert_trees(decompress_grads((q, sc), to_torch(g, tdt)),
                     ref_compress.decompress_grads((qw, scw),
                                                   to_jax(g, jdt)),
                     rtol=0, atol=0)


def test_quantize_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    q, scale = compress._quantize(x)
    assert float(scale[0, 0]) == 1.0
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


def test_compression_error_feedback():
    g = {"w": torch.from_numpy(np.random.default_rng(0)
                               .normal(size=(1024,)).astype(np.float32))}
    comp, resid = compress_grads(g)
    deco = decompress_grads(comp, g)
    err = (deco["w"] - g["w"]).abs()
    assert float(err.max()) < float(g["w"].abs().max()) / 64
    torch.testing.assert_close(deco["w"] + resid["w"], g["w"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("scale,max_norm", [(1.0, 1.0), (1e-3, 1.0),
                                            (10.0, 0.5)])
def test_global_norm_clip_matches_reference(scale, max_norm):
    grads = np_tree(4, scale=scale)
    got, gn = global_norm_clip(to_torch(grads), max_norm)
    want, wn = ref_compress.global_norm_clip(to_jax(grads), max_norm)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), rtol=1e-6)
    assert_trees(got, want, rtol=1e-6, atol=1e-9)
    total = np.sqrt(sum(float((t.double() ** 2).sum())
                        for t in jax.tree.leaves(got)))
    assert total <= max_norm * (1 + 1e-6)
