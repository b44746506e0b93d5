"""The port's train step over a process mesh (``launch.mesh.RankMesh``:
one rank per mesh position, each holding only its shards) against the
JAX package's GSPMD step (``train.trainer.shard_train_step``) on the same
mesh shape, on the CPU: the reference in a subprocess per world, gloo
worlds 2 and 4 (8 with ``--runslow``) each spawned once for the module,
and the checks of ``tests/train_mesh_reference.py`` (loss and grad_norm
within rtol 1e-5 and equal on every rank, every updated leaf and both
moments within 2e-5 relative L2, each rank holding only its shards).
The reference's EP MoE takes its ``shard_map`` path under
``jax.sharding.set_mesh``.

The cases cover what looks right on a (1, 1) mesh and is wrong elsewhere:
heads that do not line up with the column cut (SmolLM's published 9
heads over 3 kv heads, at widths cut to 8 per head: 4.5 heads a rank;
Qwen3 reduced at model 4: half a kv head a rank), a loss mask uneven
across the data shards, a batch of 1 that every data rank holds whole,
attention weights that ``param_specs`` leaves whole because ``model``
does not divide their width (Qwen3 reduced at 3 heads of 6 at model 4:
``wq``/``wk``/``wv``/``wo`` all whole, the kv groups shared out one a
rank and the fourth rank left none; at 4 query heads over 1 kv head of
6: ``wq`` cut, ``wk``/``wv`` whole),
the ('pod', 'data', 'model') mesh, the GSPMD MoE with a capacity that
drops tokens (queue places follow the global token order), and the EP
MoE (A14d) on (1, 4) and (2, 2), there also on a batch of 1 (each rank
runs every data block for its expert) — (2, 4) and (4, 2) with
``--runslow``.
"""
import numpy as np
import pytest

import train_mesh_ranks as tr
import train_mesh_reference as ref

DN = ("data", "model")
CASES = {
    "smollm_9_heads_2x2": dict(arch="smollm-135m", mesh=(2, 2), axes=DN,
                               ov={"n_heads": 9, "n_kv_heads": 3,
                                   "head_dim": 8}, batch=4, seq=16,
                               steps=3),
    "qwen3_1x4": dict(arch="qwen3-0.6b", mesh=(1, 4), axes=DN, batch=4,
                      seq=16, steps=3),
    "qwen3_pod_2x1x2": dict(arch="qwen3-0.6b", mesh=(2, 1, 2),
                            axes=("pod", "data", "model"), batch=4, seq=16,
                            steps=2),
    "qwen3_mask_2x2": dict(arch="qwen3-0.6b", mesh=(2, 2), axes=DN,
                           batch=4, seq=16, steps=2, mask=True),
    "qwen3_batch1_2x2": dict(arch="qwen3-0.6b", mesh=(2, 2), axes=DN,
                             batch=1, seq=16, steps=2),
    "dbrx_drop_2x2": dict(arch="dbrx-132b", mesh=(2, 2), axes=DN,
                          ov={"capacity_factor": 0.5}, batch=4, seq=16,
                          steps=2),
    "dbrx_ep_1x4": dict(arch="dbrx-132b", mesh=(1, 4), axes=DN, ep=True,
                        batch=4, seq=16, steps=2),
    "dbrx_ep_2x2": dict(arch="dbrx-132b", mesh=(2, 2), axes=DN, ep=True,
                        ov={"n_experts": 2, "top_k": 1}, batch=4, seq=16,
                        steps=2),
    "dbrx_ep_batch1_2x2": dict(arch="dbrx-132b", mesh=(2, 2), axes=DN,
                               ep=True, ov={"n_experts": 2, "top_k": 1},
                               batch=1, seq=16, steps=2),
    "qwen3_whole_qkvo_1x4": dict(arch="qwen3-0.6b", mesh=(1, 4), axes=DN,
                                 ov={"n_heads": 3, "n_kv_heads": 3,
                                     "head_dim": 6}, batch=4, seq=16,
                                 steps=2),
    "qwen3_whole_kv_1x4": dict(arch="qwen3-0.6b", mesh=(1, 4), axes=DN,
                               ov={"n_heads": 4, "n_kv_heads": 1,
                                   "head_dim": 6}, batch=4, seq=16,
                               steps=2),
    "smollm_9_heads_1x2": dict(arch="smollm-135m", mesh=(1, 2), axes=DN,
                               ov={"n_heads": 9, "n_kv_heads": 3,
                                   "head_dim": 8}, batch=2, seq=16,
                               steps=2),
    "qwen3_mask_2x1": dict(arch="qwen3-0.6b", mesh=(2, 1), axes=DN,
                           batch=4, seq=16, steps=2, mask=True),
    "dbrx_ep_2x4": dict(arch="dbrx-132b", mesh=(2, 4), axes=DN, ep=True,
                        batch=4, seq=16, steps=2),
    "dbrx_ep_4x2": dict(arch="dbrx-132b", mesh=(4, 2), axes=DN, ep=True,
                        ov={"n_experts": 2, "top_k": 1,
                            "capacity_factor": 0.5}, batch=4, seq=16,
                        steps=2),
}
SLOW = {"dbrx_ep_2x4", "dbrx_ep_4x2"}


def world_of(name) -> int:
    return ref.world_of(CASES[name])


def case_param(name):
    return pytest.param(name, marks=pytest.mark.slow) if name in SLOW \
        else name


NAMES = [case_param(n) for n in CASES]


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """The reference in subprocesses and each gloo world spawned once
    (``train_mesh_reference.run_cases``)."""
    slow = request.config.getoption("--runslow")
    return ref.run_cases({n: c for n, c in CASES.items()
                          if slow or n not in SLOW},
                         tmp_path_factory.mktemp("train_mesh"))


def ranks_of(runs, name):
    return ref.ranks_of(runs, name, CASES[name])


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grad_norm_match_the_reference_step(runs, name):
    ref.check_metrics(runs, name, CASES[name])


@pytest.mark.parametrize("name", NAMES)
def test_every_updated_leaf_matches_the_reference(runs, name):
    ref.check_leaves(runs, name, CASES[name])


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_only_its_shards(runs, name):
    """Between steps: every leaf of params, moments and batch has its
    shard's shape under the reference's specs, and its storage holds
    that shard's bytes and no more."""
    ref.check_held(runs, name, CASES[name])


def test_the_drop_case_drops():
    """At capacity factor 0.5 the GSPMD MoE drops tokens: its loss is
    not the dropless one's."""
    from repro_torch.core.interop import params_from_numpy
    from repro_torch.models import build_model
    import dataclasses
    import torch
    case = CASES["dbrx_drop_2x2"]
    params, batch = tr.case_inputs("dbrx_drop_2x2", case)
    params = params_from_numpy(params, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    cfg = tr.case_config(case)
    drop = build_model(cfg, device="cpu").loss(params, batch)
    full = build_model(dataclasses.replace(cfg, capacity_factor=8.0),
                       device="cpu").loss(params, batch)
    assert abs(float(drop) - float(full)) > 1e-4


@pytest.mark.parametrize("name", [case_param(n) for n in CASES
                                  if CASES[n].get("ep")])
def test_ep_runs_one_expert_per_rank_and_one_all_reduce(runs, name):
    """A14d: each rank holds one expert's weights, and the EP layer's
    forward makes exactly one collective, the combine's all-reduce over
    ``model`` (the reference's psum)."""
    cfg = tr.case_config(CASES[name])
    for r in ranks_of(runs, name):
        ep = r["ep"]
        assert ep["w_gate"] == (1, cfg.d_model, cfg.d_ff)
        assert [axis for axis, _ in ep["all_reduces"]] == ["model"]


# ---------------------------------------------------------------------------
# the mesh, the collectives and the tensor-parallel pair
# ---------------------------------------------------------------------------

WORLDS = (2, 4)


@pytest.mark.parametrize("w", WORLDS)
def test_ranks_take_row_major_positions(runs, w):
    for rank, r in enumerate(runs["world"][w]):
        for name, rec in r["cases"].items():
            shape = CASES[name]["mesh"]
            assert rec["coords"] == tuple(
                int(c) for c in np.unravel_index(rank, shape))


@pytest.mark.parametrize("w", WORLDS)
def test_collectives_over_a_line(runs, w):
    base = np.arange(2 * w, dtype=np.float32)
    total = sum(range(1, w + 1))
    for rank, r in enumerate(runs["world"][w]):
        pr = r["probes"]
        assert pr["lines"] == {"data": None, "model": (rank, w)}
        assert pr["sum"] == (base * total).tolist()
        assert pr["bf16"] == (base * total).tolist()
        assert pr["max"] == (base * w).tolist()
        want = (base * total).reshape(w, 2)[rank:rank + 1]
        assert pr["scatter"] == want.tolist()


@pytest.mark.parametrize("w", WORLDS)
def test_copy_and_reduce_are_megatrons_pair(runs, w):
    """copy: identity forward, gradient summed over ``model``; reduce: sum
    forward, identity backward (``torch.distributed.nn``'s all_reduce
    would sum the gradient too); gather_last: columns side by side
    forward, each rank's columns' summed gradient backward."""
    total = sum(range(1, w + 1))
    for rank, r in enumerate(runs["world"][w]):
        pr = r["probes"]
        assert pr["copy"] == ([rank + 1.0] * 3, [float(total)] * 3)
        assert pr["reduce"] == ([float(total)] * 3, [rank + 1.0] * 3)
        y, g = pr["gather_last"]
        assert y == [sum(([q + 1.0] * 2 for q in range(w)), [])] * 2
        cols = np.arange(2 * w, dtype=np.float64)[2 * rank:2 * rank + 2]
        assert g == [(cols * w).tolist()] * 2
