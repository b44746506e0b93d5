"""The port's paged-KV pool server (``repro_torch.serve.KvPoolServer``)
against the JAX package's, bit for bit, on the CPU.

``tests/test_kv_embedding.py::TestKvPoolServer``'s scenarios run through
both servers on the same NumPy inputs (integer-valued f32 K/V, so every
ADD is exact): a shared prefix, four sequences over two tenants, decode
batches that grow the pool mid-flight. After every step the port's pool,
each history it gathered, its page tables, lengths and stats must equal
the reference's; each window must coalesce the shared prefix across
tenants as the reference's does.
"""
import numpy as np
import pytest
import torch

from repro.serve import KvPoolServer as RefKvPoolServer
from repro_torch.core import Engine, Scheduler
from repro_torch.serve import AccessService, KvPoolServer


def servers(page_size=4, d=4, init_pages=4, growth_pages=2, seqs=4,
            prompt=3, prefix_pages=2, seed=3):
    """The reference's ``_server`` scenario in both packages (the same
    draws fed to both)."""
    rng = np.random.default_rng(seed)
    ref = RefKvPoolServer(page_size=page_size, d=d, init_pages=init_pages,
                          growth_pages=growth_pages)
    port = KvPoolServer(
        page_size=page_size, d=d, init_pages=init_pages,
        growth_pages=growth_pages,
        service=AccessService(Scheduler(engine=Engine(device="cpu")),
                              auto_flush=0))
    prefix = rng.integers(0, 4, size=(prefix_pages * page_size,
                                      2 * d)).astype(np.float32)
    ref.create_prefix("sys", prefix)
    port.create_prefix("sys", prefix)
    for i in range(seqs):
        kv = rng.integers(0, 4, size=(prompt + i % 3, 2 * d)).astype(
            np.float32)
        ref.admit(f"s{i}", f"tenant{i % 2}", kv, prefix="sys")
        port.admit(f"s{i}", f"tenant{i % 2}", kv, prefix="sys")
    same_state(port, ref)
    return ref, port, rng


def same_state(port, ref):
    assert port.pool.dtype == torch.float32
    np.testing.assert_array_equal(port.pool.numpy(), np.asarray(ref.pool))
    assert port.stats() == ref.stats()
    assert port.prefixes == ref.prefixes
    for name, seq in ref.seqs.items():
        mine = port.seqs[name]
        assert (mine.tenant, mine.pages, mine.n_shared, mine.length) == \
            (seq.tenant, seq.pages, seq.n_shared, seq.length)


def step(port, ref, new):
    hists, report = port.decode_batch(new)
    rhists, rreport = ref.decode_batch(new)
    assert sorted(hists) == sorted(rhists)
    for name, h in hists.items():
        np.testing.assert_array_equal(h.numpy(), np.asarray(rhists[name]))
    assert report.order == rreport.order
    # keyed by the table's id: compare the (gain, lanes, distinct) values
    assert sorted(report.gather_coalescing.values()) == \
        sorted(rreport.gather_coalescing.values())
    same_state(port, ref)
    return hists, report


def test_decode_batch_histories_and_appends():
    ref, port, rng = servers()
    pool0 = port.pool.numpy().copy()
    seq = port.seqs["s0"]
    idx0 = port._slots(seq.pages, 0, seq.length)
    new = {f"s{i}": rng.integers(0, 4, size=8).astype(np.float32)
           for i in range(4)}
    hists, _ = step(port, ref, new)
    # histories are the window-initial pool state
    np.testing.assert_array_equal(hists["s0"].numpy(), pool0[idx0])
    hists2, _ = step(port, ref,
                     {"s0": rng.integers(0, 4, size=8).astype(np.float32)})
    np.testing.assert_array_equal(hists2["s0"].numpy()[seq.length - 2],
                                  new["s0"])


def test_shared_prefix_coalesces_across_tenants():
    ref, port, rng = servers()
    _, report = step(port, ref, {
        f"s{i}": rng.integers(0, 4, size=8).astype(np.float32)
        for i in range(4)})
    gains = [g for (g, _, _) in report.gather_coalescing.values()]
    assert any(g > 1.0 for g in gains)


def test_pool_growth_mid_serving():
    ref, port, rng = servers(seqs=5)
    before = port.stats()["cap_pages"]
    for t in range(8):
        active = [f"s{i}" for i in range(5) if (i + t) % 4]  # a subset
        step(port, ref, {name: rng.integers(0, 4, size=8).astype(
            np.float32) for name in active})
    st = port.stats()
    assert st["cap_pages"] > before and st["growths"] > 0
    assert st["pool_rows"] == st["cap_pages"] * port.page_size


def test_admission_errors():
    ref, port, rng = servers()
    for srv in (port, ref):
        with pytest.raises(ValueError):
            srv.create_prefix("sys", np.zeros((8, 8), np.float32))
        with pytest.raises(ValueError):        # not page-aligned
            srv.create_prefix("odd", np.zeros((3, 8), np.float32))
        with pytest.raises(ValueError):        # duplicate sequence
            srv.admit("s0", "tenant0", np.zeros((2, 8), np.float32))
        with pytest.raises(KeyError):          # unknown prefix
            srv.admit("s9", "tenant0", np.zeros((2, 8), np.float32),
                      prefix="nope")
        with pytest.raises(KeyError):          # unadmitted sequence
            srv.decode_batch({"s9": np.zeros(8, np.float32)})


def test_no_prefix_and_empty_prompt():
    ref, port, rng = servers()
    solo = rng.integers(0, 4, size=(5, 8)).astype(np.float32)
    for srv in (port, ref):
        srv.admit("solo", "tenant9", solo)
        srv.admit("bare", "tenant9", np.zeros((0, 8), np.float32),
                  prefix="sys")
    for _ in range(2):
        step(port, ref, {n: rng.integers(0, 4, size=8).astype(np.float32)
                         for n in ("solo", "bare", "s1")})


def test_decode_batch_redeems_every_append():
    """Every append ticket of a window is redeemed (one pool), so the
    scheduler keeps no step's pool alive after the step."""
    _, port, rng = servers()
    for _ in range(3):
        port.decode_batch({f"s{i}": rng.integers(0, 4, size=8).astype(
            np.float32) for i in range(4)})
    assert port.service.scheduler._results == {}


def test_server_defaults_to_a_cuda_service():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KvPoolServer()
