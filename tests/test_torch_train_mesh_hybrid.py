"""The port's train step over a process mesh for the hybrid family
(Jamba) against the JAX package's GSPMD step, on the CPU, as
tests/test_torch_train_mesh.py holds the dense and MoE families
(``train_mesh_reference``: the reference in a subprocess per world, a
gloo world spawned once; loss and grad_norm within rtol 1e-5 and equal
on every rank, every updated leaf and both moments within 2e-5 relative
L2, each rank holding only its shards; two steps, so that the second
runs at lr > 0).

Jamba reduced: one superblock of ``attn_period`` 8 (the attention layer
in slot 4, seven Mamba layers, dense FFNs in the even slots, MoE FFNs
over 4 experts in the odd ones), d 64, seq 16. The cases cover what a
(1, 1) mesh cannot show:

  * (2, 2): ``in_proj``'s column cut gives one ``model`` rank all of
    ``u`` and the other all of ``z``, so each rank all-gathers the
    product's columns for its channel block; ``x_proj``'s partial
    product is summed over ``model``; the tied table is cut;
  * (1, 4): a channel block of 32, half a kv head a rank;
  * d 45 with 4 heads over 2 kv heads of 16 at (1, 4): ``d_inner`` 90
    does not divide by 4, so ``param_specs`` cuts ``in_proj`` (180
    columns) and leaves every other Mamba leaf whole (each used on the
    rank's share through ``copy``);
  * the EP MoE (``moe_a2a``) at (1, 4), one expert a rank.
"""
import pytest

import train_mesh_reference as ref

DN = ("data", "model")
JAMBA = dict(arch="jamba-1.5-large-398b", axes=DN, batch=4, seq=16,
             steps=2)
CASES = {
    "jamba_2x2": dict(JAMBA, mesh=(2, 2)),
    "jamba_1x4": dict(JAMBA, mesh=(1, 4)),
    "jamba_d45_1x4": dict(JAMBA, mesh=(1, 4), ov=dict(
        d_model=45, n_heads=4, n_kv_heads=2, head_dim=16)),
    "jamba_ep_1x4": dict(JAMBA, mesh=(1, 4), ep=True),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref.run_cases(CASES, tmp_path_factory.mktemp("train_hybrid"))


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
    """The specs the cases rely on: at (2, 2) ``in_proj`` cut in halves
    that are ``u`` and ``z`` and every channel leaf cut; at d 45 only
    ``in_proj`` cut; the superblock holding attention, Mamba and MoE
    layers; EP on."""
    from repro_torch.launch import mesh as meshlib
    import train_mesh_ranks as tr

    def mamba_specs(name):
        case = CASES[name]
        params, _ = tr.case_inputs(name, case)
        stub = meshlib.Mesh(case["mesh"], case["axes"], "cpu")
        return meshlib.param_specs(params, stub)["blocks"]["mamba"], params
    cut, params = mamba_specs("jamba_2x2")
    d_inner = params["blocks"]["mamba"]["conv_w"].shape[-1]
    assert params["blocks"]["mamba"]["in_proj"].shape[-1] == 2 * d_inner
    assert cut["in_proj"][-1] == "model"        # rank 0: u, rank 1: z
    for leaf, dim in (("conv_w", -1), ("dt_proj", -1), ("x_proj", -2),
                      ("A_log", -2), ("D", -1), ("out_proj", -2)):
        assert cut[leaf][dim] == "model", leaf
    odd, params = mamba_specs("jamba_d45_1x4")
    assert params["blocks"]["mamba"]["conv_w"].shape[-1] == 90
    assert odd["in_proj"][-1] == "model"
    for leaf in ("conv_w", "dt_proj", "x_proj", "A_log", "D", "out_proj"):
        assert set(odd[leaf]) == {None}, leaf
    cfg = tr.case_config(CASES["jamba_1x4"])
    assert (cfg.n_layers, cfg.attn_period, cfg.moe_period,
            cfg.n_experts) == (8, 8, 2, 4)
    assert params["blocks"]["mlp"]["w_gate"].shape[1] == 4
    assert params["blocks"]["moe"]["w_gate"].shape[1] == 4
    assert params["blocks"]["mamba"]["in_proj"].shape[1] == 7
    assert tr.case_config(CASES["jamba_ep_1x4"]).moe_a2a
