"""The port's train step over a process mesh for the RWKV-6 family
(``ssm``) against the JAX package's GSPMD step, on the CPU, as
tests/test_torch_train_mesh.py holds the dense and MoE families
(``train_mesh_reference``: the reference in a subprocess per world, gloo
worlds 2 and 4 each spawned once; loss and grad_norm within rtol 1e-5
and equal on every rank, every updated leaf and both moments within
2e-5 relative L2, each rank holding only its shards; two steps, so that
the second runs at lr > 0).

RWKV-6 reduced (2 layers, d 64, 4 heads of 16, d_ff 128). The cases
cover what a (1, 1) mesh cannot show:

  * (2, 2) with a loss mask uneven across the data shards: the time-mix
    on the rank's two heads (its own columns of ``wr``/``wk``/``wv``/
    ``w_dd``, its heads of ``u``), the channel-mix's ``wv`` cut on its
    output columns, the tied table cut;
  * (1, 4) with vocab 258, which 4 does not divide: the table whole;
  * d 48 with 3 heads of 16 at (1, 2): 24 columns a rank, 1.5 heads, so
    each rank computes two whole heads from all-gathered columns, and
    ``u`` (3 heads) stays whole;
  * d_ff 130 at (1, 4): the channel-mix's ``wk`` whole (each rank uses
    all of it through ``copy``), its ``wv`` cut on its output columns;
  * d 45 with 3 heads of 15 at (1, 2): every time-mix weight and the
    channel-mix's ``wv`` whole, so the time-mix shares out whole heads of
    whole weights and the channel-mix is Megatron's pair over a share of
    ``d_ff``.
"""
import pytest

import train_mesh_reference as ref

DN = ("data", "model")
RWKV = dict(arch="rwkv6-1.6b", axes=DN, batch=4, seq=16, steps=2)
CASES = {
    "rwkv_mask_2x2": dict(RWKV, mesh=(2, 2), mask=True),
    "rwkv_vocab258_1x4": dict(RWKV, mesh=(1, 4), ov={"vocab": 258}),
    "rwkv_3_heads_1x2": dict(RWKV, mesh=(1, 2), batch=2,
                             ov={"d_model": 48, "n_heads": 3,
                                 "head_dim": 16}),
    "rwkv_dff130_1x4": dict(RWKV, mesh=(1, 4), ov={"d_ff": 130}),
    "rwkv_d45_1x2": dict(RWKV, mesh=(1, 2), batch=2,
                         ov={"d_model": 45, "n_heads": 3, "head_dim": 15}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref.run_cases(CASES, tmp_path_factory.mktemp("train_rwkv"))


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
    """The specs the cases rely on: the channel-mix's ``wv`` cut on its
    output columns, ``u`` cut on heads at (2, 2) and whole at 3 heads,
    the time-mix's columns cut mid-head at d 48, the table cut at
    (2, 2) and whole at vocab 258, the channel-mix's ``wk`` whole at
    d_ff 130, every time-mix weight and the channel-mix's ``wv`` whole
    at d 45."""
    from repro_torch.launch import mesh as meshlib
    import train_mesh_ranks as tr

    def specs(name):
        case = CASES[name]
        params, _ = tr.case_inputs(name, case)
        stub = meshlib.Mesh(case["mesh"], case["axes"], "cpu")
        return meshlib.param_specs(params, stub), params
    s, params = specs("rwkv_mask_2x2")
    cmix = params["layers"]["cmix"]
    assert cmix["wv"].shape[1:] == (128, 64)     # (d_ff, d_model)
    assert s["layers"]["cmix"]["wv"] == (None, None, "model")
    assert s["layers"]["tmix"]["u"] == (None, "model", None)
    assert s["layers"]["tmix"]["wo"] == (None, "model", None)
    for leaf in ("mix_r", "mix_k", "mix_v", "mix_w", "w_base", "ln_x"):
        assert set(s["layers"]["tmix"][leaf]) == {None}, leaf
    assert s["embed"] == ("model", None)
    assert specs("rwkv_vocab258_1x4")[0]["embed"] == (None, None)
    s, params = specs("rwkv_3_heads_1x2")
    assert params["layers"]["tmix"]["u"].shape[1:] == (3, 16)
    assert s["layers"]["tmix"]["u"] == (None, None, None)
    assert s["layers"]["tmix"]["wr"] == (None, None, "model")   # 24 a rank
    s, params = specs("rwkv_dff130_1x4")
    assert params["layers"]["cmix"]["wk"].shape[1:] == (64, 130)
    assert s["layers"]["cmix"]["wk"] == (None, None, None)
    assert s["layers"]["cmix"]["wv"] == (None, None, "model")
    s, params = specs("rwkv_d45_1x2")
    assert params["layers"]["tmix"]["u"].shape[1:] == (3, 15)
    for leaf in ("wr", "wk", "wv", "w_dd", "wo", "u"):
        assert set(s["layers"]["tmix"][leaf]) == {None}, leaf
    assert s["layers"]["cmix"]["wk"] == (None, None, "model")
    assert set(s["layers"]["cmix"]["wv"]) == {None}
