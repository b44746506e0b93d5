"""The port's train step over a process mesh for the VLM (Qwen2-VL) and
encoder-decoder (SeamlessM4T) families against the JAX package's GSPMD
step, on the CPU, as tests/test_torch_train_mesh.py holds the dense and
MoE families (``train_mesh_reference``: the reference in a subprocess
per world, gloo worlds 2 and 4 each spawned once; loss and grad_norm
within rtol 1e-5 and equal on every rank, every updated leaf and both
moments within 2e-5 relative L2, each rank holding only its shards).

The cases cover what a (1, 1) mesh cannot show:

  * Qwen2-VL reduced with ``positions3`` given (a (temporal, height,
    width) grid for the patch tokens, the text after it, every row
    shifted): its batch is dim 1, which the reference's ``batch_specs``
    replicate at data 2; each rank takes its tokens' rows
    (``launch.mesh.block_spec``). At (2, 2), and on a batch of 1 that
    every data rank holds whole; at (1, 4) half a kv head a rank.
  * SeamlessM4T reduced with a source of 12 frames and a target of 8
    tokens (a cross-attention that swaps them fails), a loss mask uneven
    across the data shards, and vocab 258, which like the published
    256206 divides by 2 and not by 4: the tied embedding and head cut at
    (2, 2), whole at (1, 4). At (1, 4) also at 3 heads over 3 kv heads
    of 6 (18 columns: ``param_specs`` leaves ``wq``/``wk``/``wv``/``wo``
    whole in every attention, the cross-attention's included; the fourth
    rank computes no head) and at 6 heads of 6 (36 columns, 1.5 heads a
    rank: ``cross_kv`` all-gathers the columns of its heads). No even
    head width leaves 6 heads whole at model 4 (6 x 2k columns divide by
    4), so the whole-weight case takes 3.
"""
import pytest

import train_mesh_reference as ref

DN = ("data", "model")
VLM = dict(arch="qwen2-vl-72b", axes=DN, seq=64, grid=(1, 2, 2), steps=2)
SEAMLESS = dict(arch="seamless-m4t-large-v2", axes=DN, seq=16, src=12,
                batch=4, mask=True, steps=2)
CASES = {
    "qwen2vl_2x2": dict(VLM, mesh=(2, 2), batch=4),
    "qwen2vl_1x4": dict(VLM, mesh=(1, 4), batch=4),
    "qwen2vl_batch1_2x2": dict(VLM, mesh=(2, 2), batch=1),
    "seamless_2x2": dict(SEAMLESS, mesh=(2, 2), ov={"vocab": 258}),
    "seamless_1x4": dict(SEAMLESS, mesh=(1, 4), ov={"vocab": 258}),
    "seamless_whole_qkvo_1x4": dict(
        SEAMLESS, mesh=(1, 4), ov={"vocab": 258, "n_heads": 3,
                                   "n_kv_heads": 3, "head_dim": 6}),
    "seamless_6_heads_1x4": dict(
        SEAMLESS, mesh=(1, 4), ov={"vocab": 258, "n_heads": 6,
                                   "n_kv_heads": 6, "head_dim": 6}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref.run_cases(CASES, tmp_path_factory.mktemp("train_families"))


@pytest.mark.parametrize("name", CASES)
def test_loss_and_grad_norm_match_the_reference_step(runs, name):
    ref.check_metrics(runs, name, CASES[name])


@pytest.mark.parametrize("name", CASES)
def test_every_updated_leaf_matches_the_reference(runs, name):
    ref.check_leaves(runs, name, CASES[name])


@pytest.mark.parametrize("name", CASES)
def test_each_rank_holds_only_its_shards(runs, name):
    ref.check_held(runs, name, CASES[name])


def test_the_cases_reach_the_branches_they_name():
    """The specs the cases rely on: positions3 replicated by the
    reference at data 2 (so the rank's cut is the port's), the tied
    table cut at model 2 and whole at model 4, the attention weights
    whole at 3 heads of 6 and cut off the head boundary at 6."""
    from repro_torch.launch import mesh as meshlib
    import train_mesh_ranks as tr

    def specs(name):
        case = CASES[name]
        params, batch = tr.case_inputs(name, case)
        stub = meshlib.Mesh(case["mesh"], case["axes"], "cpu")
        return (meshlib.param_specs(params, stub),
                meshlib.batch_specs(batch, stub), batch)
    _, bspecs, batch = specs("qwen2vl_2x2")
    assert bspecs["positions3"] == (None, None, None)
    assert meshlib.block_spec("positions3", 3, bspecs) == \
        (None, "data", None)
    assert len({tuple(row) for row in batch["positions3"][0]}) == 4
    assert specs("seamless_2x2")[0]["embed"] == ("model", None)
    assert specs("seamless_1x4")[0]["embed"] == (None, None)
    batch = specs("seamless_2x2")[2]
    assert batch["src_embeds"].shape[1] == 12
    assert batch["tokens"].shape[1] == 8
    whole = specs("seamless_whole_qkvo_1x4")[0]
    for part in ("enc", "dec"):
        for attn in ("attn", "xattn") if part == "dec" else ("attn",):
            for w in ("wq", "wk", "wv", "wo"):
                assert whole[part][attn][w] == (None, None, None), (part, w)
    cut = specs("seamless_6_heads_1x4")[0]["dec"]["xattn"]
    assert cut["wk"] == (None, None, "model")      # 9 columns a rank
