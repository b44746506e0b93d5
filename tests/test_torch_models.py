"""The port's decoder (``repro_torch.models``) and in-model page pool
(``repro_torch.serve.kv_cache``) against the JAX package's on the CPU.

Each model is the JAX package's ``reduced()`` config (2 layers, d_model 64,
vocab 256, f32), its weights drawn by the JAX package from a seed and
carried over key for key by ``interop.params_from_numpy``. Forward logits,
prefill logits and decode logits must agree within rtol=1e-4 / atol=1e-5:
the same f32 math, with XLA's and PyTorch's CPU matmuls and
transcendentals rounding in their own orders. Index handling is held
exactly: the embedding's out-of-range tokens (wrapped, clamped or
dropped), ``lax.top_k``'s tie order in the MoE router, a ``-1`` page in
``append_token`` and the ``dynamic_update_slice`` clamp of a cache write.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build_model as ref_build_model
from repro.models import embedding as ref_emb
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.serve import kv_cache as ref_kv
from repro_torch import configs
from repro_torch.core import interop
from repro_torch.models import build_model, embedding, layers, moe
from repro_torch.serve import kv_cache

RTOL, ATOL = 1e-4, 1e-5
ARCHS = ("qwen3-0.6b", "smollm-135m", "h2o-danube-3-4b", "qwen2-vl-72b",
         "dbrx-132b")


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def pair(arch, **overrides):
    """(reference model, its params, port model, the same params)."""
    rcfg = ref_configs.get_config(arch).reduced(**overrides)
    pcfg = configs.get_config(arch).reduced(**overrides)
    ref = ref_build_model(rcfg)
    rparams = ref.init(jax.random.PRNGKey(0))
    port = build_model(pcfg, device="cpu")
    return ref, rparams, port, interop.params_from_numpy(
        to_np(rparams), device="cpu")


def tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, s)).astype(np.int32)


def test_configs_match_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert set(configs.SHAPES) == set(ref_configs.SHAPES)
    for arch in configs.ARCH_IDS:
        p, r = configs.get_config(arch), ref_configs.get_config(arch)
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert dataclasses.asdict(p.reduced()) == \
            dataclasses.asdict(r.reduced())
        assert [s.name for s in configs.applicable_shapes(p)] == \
            [s.name for s in ref_configs.applicable_shapes(r)]
        assert p.activation_dtype == torch.bfloat16
        assert p.reduced().weight_dtype == torch.float32


def test_unported_families_raise():
    for arch in ("jamba-1.5-large-398b", "rwkv6-1.6b",
                 "seamless-m4t-large-v2"):
        with pytest.raises(NotImplementedError, match="A12"):
            build_model(configs.get_config(arch).reduced(), device="cpu")


def test_params_from_numpy_keeps_keys_layouts_and_dtypes():
    ref, rparams, _, params = pair("dbrx-132b")
    flat_r = jax.tree_util.tree_leaves_with_path(rparams)
    for path, leaf in flat_r:
        t = params
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        assert interop.isa_dtype(leaf.dtype) == "f32"
        assert t.dtype == torch.float32
    bf = interop.params_from_numpy(to_np(rparams), device="cpu",
                                   dtype=torch.bfloat16)
    assert bf["layers"]["moe"]["w_up"].dtype == torch.bfloat16


def test_init_draws_the_reference_layout():
    ref, rparams, port, _ = pair("qwen3-0.6b")
    mine = port.init(0)
    shapes = jax.tree.map(lambda a: a.shape, rparams)
    got = jax.tree.map(lambda t: tuple(t.shape), mine)
    assert got == shapes
    assert torch.equal(mine["final_norm"], torch.ones(64))
    w = mine["layers"]["attn"]["wq"]
    assert abs(float(w.std()) - 0.02) < 2e-3
    assert torch.equal(port.init(0)["embed"], mine["embed"])


# danube's sliding window (16 in reduced()) with a cache of the window's
# size (ring: writes wrap) and with a longer one (the window as a mask)
CACHES = [(a, 32) for a in ARCHS] + [("h2o-danube-3-4b", 16)]


@pytest.mark.parametrize("arch,max_len", CACHES, ids=str)
def test_forward_prefill_decode_match_reference(arch, max_len):
    ref, rparams, port, params = pair(arch)
    b, s, steps = 2, 12, 3
    toks = tokens(1, b, s + steps)
    batch = {"tokens": toks[:, :s]}
    extra = {}
    if arch == "qwen2-vl-72b":
        patches = np.random.default_rng(2).normal(
            size=(b, 4, 64)).astype(np.float32)
        pos3 = np.stack([np.broadcast_to(np.arange(4 + s), (b, 4 + s))
                         // d for d in (1, 2, 3)]).astype(np.int32)
        extra = {"patch_embeds": patches, "positions3": pos3}
    want, waux = ref.forward(rparams, {
        **batch, **{k: jnp.asarray(v) for k, v in extra.items()}})
    got, gaux = port.forward(params, {**batch, **extra})
    close(got, want)
    close(gaux, waux)

    rcache = ref.init_cache(b, max_len)
    pcache = port.init_cache(b, max_len)
    want, rcache = ref.prefill(rparams, batch, rcache)
    got, pcache = port.prefill(params, batch, pcache)
    close(got, want)
    extra = 6 if port.cfg.sliding_window else 0   # past window and ring
    for t in range(steps + extra):
        nxt = toks[:, s + t % steps][:, None]
        want, rcache = ref.decode_step(rparams, {"tokens": nxt}, rcache)
        got, pcache = port.decode_step(params, {"tokens": nxt}, pcache)
        close(got, want)
    assert pcache["len"] == int(rcache["len"])
    close(pcache["k"], rcache["k"])


def test_decode_matches_forward_on_the_port():
    _, _, port, params = pair("qwen3-0.6b")
    toks = tokens(3, 2, 10)
    full, _ = port.forward(params, {"tokens": toks})
    cache = port.init_cache(2, 16)
    got, cache = port.prefill(params, {"tokens": toks[:, :7]}, cache)
    close(got[:, 0], full[:, 6])
    for t in range(7, 10):
        got, cache = port.decode_step(
            params, {"tokens": toks[:, t:t + 1]}, cache)
        close(got[:, 0], full[:, t])


def test_remat_keeps_outputs_and_gradients():
    _, _, port, params = pair("smollm-135m")
    toks = tokens(4, 2, 8)
    outs = {}
    for mode in ("none", "full", "dots"):
        m = build_model(dataclasses.replace(port.cfg, remat=mode),
                        device="cpu")
        p = {k: v for k, v in params.items()}
        p["embed"] = params["embed"].clone().requires_grad_(True)
        logits, _ = m.forward(p, {"tokens": toks})
        logits.square().sum().backward()
        outs[mode] = (logits.detach(), p["embed"].grad)
    for mode in ("full", "dots"):
        assert torch.equal(outs[mode][0], outs["none"][0])
        torch.testing.assert_close(outs[mode][1], outs["none"][1])


@pytest.mark.parametrize("fwd", [False, True])
def test_embed_lookup_forward_with_oob_tokens(fwd):
    table = np.random.default_rng(5).normal(size=(16, 4)).astype(np.float32)
    toks = np.array([[1, -1, 16, 20], [-16, -20, 3, 3]], np.int32)
    want = ref_emb.embed_lookup(jnp.asarray(table), jnp.asarray(toks),
                                fwd, True)
    got = embedding.embed_lookup(torch.from_numpy(table),
                                 torch.from_numpy(toks), fwd, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bwd", [True, False])
@pytest.mark.parametrize("fwd", [False, True])
def test_embed_lookup_gradient_matches_jax_grad(fwd, bwd):
    rng = np.random.default_rng(6)
    table = rng.normal(size=(16, 4)).astype(np.float32)
    toks = rng.integers(0, 16, size=(3, 9)).astype(np.int32)
    toks[0, :5] = [-1, 16, -3, 40, -17]           # OOB: wrap, drop, clamp
    toks[1, :4] = 7                               # duplicates
    w = rng.normal(size=(3, 9, 4)).astype(np.float32)

    def ref_loss(tb):
        return (ref_emb.embed_lookup(tb, jnp.asarray(toks), fwd, bwd)
                * w).sum()

    want = jax.grad(ref_loss)(jnp.asarray(table))
    tb = torch.from_numpy(table).requires_grad_(True)
    (embedding.embed_lookup(tb, torch.from_numpy(toks), fwd, bwd)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def moe_params(seed, d=16, f=24, e=4, tie=True):
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(d, e)).astype(np.float32),
         "w_gate": rng.normal(size=(e, d, f)).astype(np.float32) * 0.1,
         "w_up": rng.normal(size=(e, d, f)).astype(np.float32) * 0.1,
         "w_down": rng.normal(size=(e, f, d)).astype(np.float32) * 0.1}
    if tie:       # experts 1 and 2 (and 0 and 3) get equal router logits
        p["router"][:, 2] = p["router"][:, 1]
        p["router"][:, 3] = p["router"][:, 0]
    return p


@pytest.mark.parametrize("combine", [True, False])
@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (2, 1.25), (2, 0.25)])
def test_moe_ffn_with_tied_router_logits(top_k, cf, combine):
    p = moe_params(7)
    x = np.random.default_rng(8).normal(size=(2, 24, 16)).astype(np.float32)
    want, wl = ref_moe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), n_experts=4, top_k=top_k,
                               capacity_factor=cf, dx100_combine=combine)
    pp = interop.params_from_numpy(p, device="cpu")
    got, gl = moe.moe_ffn(pp, torch.from_numpy(x), n_experts=4,
                          top_k=top_k, capacity_factor=cf,
                          dx100_combine=combine)
    close(gl, wl)
    close(got, want)
    _, want_e = jax.lax.top_k(wl, top_k)
    _, got_e = moe.top_k_stable(gl, top_k)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    close(moe.moe_aux_loss(gl, 4, top_k),
          ref_moe.moe_aux_loss(wl, 4, top_k))


def test_moe_ep_needs_a_mesh():
    pp = interop.params_from_numpy(moe_params(9), device="cpu")
    x = torch.zeros((1, 4, 16))
    with pytest.raises(NotImplementedError, match="A13"):
        moe.moe_ffn_ep(pp, x, n_experts=4, top_k=2)
    out, _ = moe.moe_ffn_auto(pp, x, n_experts=4, top_k=2, use_ep=True)
    assert out.shape == x.shape


@pytest.mark.parametrize("cache_len,ring", [(5, False), (14, False),
                                            (30, False), (21, True)])
def test_attention_cache_write_clamps_like_dynamic_update_slice(
        cache_len, ring):
    rng = np.random.default_rng(10)
    d, h, kv, hd, smax, s = 32, 4, 2, 8, 16, 3
    p = {k: rng.normal(size=shape).astype(np.float32) * 0.2
         for k, shape in (("wq", (d, h * hd)), ("wk", (d, kv * hd)),
                          ("wv", (d, kv * hd)), ("wo", (h * hd, d)))}
    x = rng.normal(size=(2, s, d)).astype(np.float32)
    ck = rng.normal(size=(2, smax, kv, hd)).astype(np.float32)
    cv = rng.normal(size=(2, smax, kv, hd)).astype(np.float32)
    pos = (cache_len + np.arange(s))[None].repeat(2, 0).astype(np.int32)
    kw = dict(n_heads=h, n_kv=kv, head_dim=hd, ring=ring, window=None)
    want, (wk, wv) = ref_layers.attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        positions=jnp.asarray(pos), cache=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_len=jnp.asarray(cache_len, jnp.int32), **kw)
    got, (gk, gv) = layers.attention(
        interop.params_from_numpy(p, device="cpu"), torch.from_numpy(x),
        positions=torch.from_numpy(pos),
        cache=(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())),
        cache_len=cache_len, **kw)
    # the slots the clamped write left alone are the input's, bit for bit
    start = cache_len % smax if ring else min(cache_len, smax - s)
    kept = np.ones(smax, bool)
    kept[start:start + s] = False
    for g, w, c in ((gk, wk, ck), (gv, wv, cv)):
        np.testing.assert_array_equal(np.asarray(w)[:, kept], c[:, kept])
        np.testing.assert_array_equal(g.numpy()[:, kept], c[:, kept])
        close(g, w)
    close(got, want)


@pytest.mark.parametrize("packed", [False, True])
def test_packed_gqa_and_sliding_window_attention(packed):
    rng = np.random.default_rng(11)
    d, h, kv, hd, s = 32, 4, 2, 8, 10
    p = {k: rng.normal(size=shape).astype(np.float32) * 0.2
         for k, shape in (("wq", (d, h * hd)), ("wk", (d, kv * hd)),
                          ("wv", (d, kv * hd)), ("wo", (h * hd, d)))}
    p["q_norm"] = np.ones(hd, np.float32) * 1.5
    p["k_norm"] = np.ones(hd, np.float32) * 0.5
    x = rng.normal(size=(2, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (2, s)).astype(np.int32)
    kw = dict(n_heads=h, n_kv=kv, head_dim=hd, window=4, packed_gqa=packed,
              theta=1e6)
    want = ref_layers.attention({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), positions=jnp.asarray(pos),
                                **kw)
    got = layers.attention(interop.params_from_numpy(p, device="cpu"),
                           torch.from_numpy(x),
                           positions=torch.from_numpy(pos), **kw)
    close(got, want)


def test_mrope_and_rms_norm_in_bf16():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos3 = rng.integers(0, 50, size=(3, 2, 5)).astype(np.int32)
    for sections in ((2, 3, 3), (1, 2, 2)):     # the second pads to hd/2
        want = ref_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                      1e4, sections)
        got = layers.apply_mrope(torch.from_numpy(x),
                                 torch.from_numpy(pos3), 1e4, sections)
        close(got, want)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = ref_layers.rms_norm(xb, jnp.full((16,), 1.5))
    got = layers.rms_norm(interop.to_tensor(np.asarray(xb), device="cpu"),
                          torch.full((16,), 1.5))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(interop.to_numpy(got),
                                  np.asarray(want, np.float32))


def kv_pair(seed=13):
    """The same small page pool in both packages, pages partly allocated
    (sequence 2's table is all ``-1``)."""
    rng = np.random.default_rng(seed)
    pages, ps, nkv, hd, b, mp = 6, 4, 2, 3, 3, 3
    rc = ref_kv.PagedKVCache.create(pages, ps, nkv, hd, b, mp,
                                    dtype=jnp.float32)
    rc = ref_kv.alloc_pages(rc, jnp.asarray([2, 1, 0], jnp.int32))
    pc = kv_cache.PagedKVCache.create(pages, ps, nkv, hd, b, mp,
                                      dtype=torch.float32, device="cpu")
    pc = kv_cache.alloc_pages(pc, torch.tensor([2, 1, 0], dtype=torch.int32))
    np.testing.assert_array_equal(pc.page_table.numpy(),
                                  np.asarray(rc.page_table))
    return rng, rc, pc, (b, nkv, hd)


def test_kv_cache_append_gather_and_attention_match_reference():
    rng, rc, pc, (b, nkv, hd) = kv_pair()
    for step in range(6):
        k = rng.integers(0, 8, size=(b, nkv, hd)).astype(np.float32)
        v = rng.integers(0, 8, size=(b, nkv, hd)).astype(np.float32)
        rc = ref_kv.append_token(rc, jnp.asarray(k), jnp.asarray(v))
        pc = kv_cache.append_token(pc, torch.from_numpy(k),
                                   torch.from_numpy(v))
        # sequence 2 has no page: its -1 page wraps onto the last page
        np.testing.assert_array_equal(pc.k_pool.numpy(),
                                      np.asarray(rc.k_pool))
        np.testing.assert_array_equal(pc.v_pool.numpy(),
                                      np.asarray(rc.v_pool))
        np.testing.assert_array_equal(pc.seq_lens.numpy(),
                                      np.asarray(rc.seq_lens))
    assert np.asarray(rc.k_pool)[-1].any()        # the wrapped writes
    for dedup in (True, False):
        rk, rv, rl = ref_kv.gather_pages(rc, dedup=dedup)
        gk, gv, gl = kv_cache.gather_pages(pc, dedup=dedup)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
    q = rng.normal(size=(b, 1, 2 * nkv, hd)).astype(np.float32)
    want = ref_kv.paged_decode_attention(jnp.asarray(q), rc, n_rep=2)
    got = kv_cache.paged_decode_attention(torch.from_numpy(q), pc, n_rep=2)
    close(got, want)


def test_kv_cache_append_past_the_table_reads_the_fill_value():
    """A length past the allocated page columns: JAX's take_along_axis
    reads INT32_MIN, and the int32 address wraps; the port mirrors it."""
    rng, rc, pc, (b, nkv, hd) = kv_pair(14)
    lens = np.array([13, 2, 5], np.int32)          # 13 // 4 = column 3
    rc = dataclasses.replace(rc, seq_lens=jnp.asarray(lens))
    pc = dataclasses.replace(pc, seq_lens=torch.from_numpy(lens))
    k = rng.integers(1, 8, size=(b, nkv, hd)).astype(np.float32)
    rc = ref_kv.append_token(rc, jnp.asarray(k), jnp.asarray(k))
    pc = kv_cache.append_token(pc, torch.from_numpy(k), torch.from_numpy(k))
    np.testing.assert_array_equal(pc.k_pool.numpy(), np.asarray(rc.k_pool))
