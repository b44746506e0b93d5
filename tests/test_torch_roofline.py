"""The port's roofline analysis and dry run (``repro_torch.roofline``,
``repro_torch.launch.dryrun``) against the JAX package's.

The formulas (``model_flops``, ``active_param_fraction``,
``roofline_terms``' split and dominant term) equal the reference's on the
same inputs, with the H100's constants in place of the TPU's. The dry
run's ``n_params`` and ``n_active_params`` of all ten shipped configs at
full size, counted on fake tensors, equal the reference's
``count_params(jax.eval_shape(init))`` exactly. ``analyze_step`` counts
a matmul's FLOPs and bytes exactly, runs under ``FakeTensorMode`` with
no storage, and a dry-run cell writes the reference's keys.
"""
import json

import jax
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build_model as ref_build_model
from repro.roofline import analysis as ref_roofline
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.roofline import analysis as roofline


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_counts_match_the_reference(arch):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    n, n_active = dryrun.param_counts(cfg)
    shapes = jax.eval_shape(ref_build_model(rcfg).init,
                            jax.random.PRNGKey(0))
    want = ref_roofline.count_params(shapes)
    assert n == want
    assert n_active == int(want * ref_roofline.active_param_fraction(rcfg))
    assert roofline.active_param_fraction(cfg) == \
        ref_roofline.active_param_fraction(rcfg)
    for s in configs.SHAPES.values():
        kw = dict(batch=s.global_batch, seq=s.seq_len, kind=s.kind,
                  n_params=n, n_active_params=n_active)
        assert roofline.model_flops(cfg, **kw) == \
            ref_roofline.model_flops(rcfg, **kw)


@pytest.mark.parametrize("flops,nbytes,coll", [
    (1e15, 1e9, {}), (1e9, 1e13, {}), (1e9, 1e9, {"all-reduce": 10 ** 12})])
def test_roofline_terms_keep_the_reference_formulas(flops, nbytes, coll):
    got = roofline.roofline_terms(hlo_flops=flops, hlo_bytes=nbytes,
                                  coll_bytes=coll, chips=4,
                                  model_flops_total=2e15)
    want = ref_roofline.roofline_terms(hlo_flops=flops, hlo_bytes=nbytes,
                                       coll_bytes=coll, chips=4,
                                       model_flops_total=2e15, ici_links=1)
    assert got.compute_s == flops / 989e12
    assert got.memory_s == nbytes / 3.35e12
    assert got.collective_s == sum(coll.values()) / 450e9
    assert got.dominant == want.dominant or coll
    assert got.useful_ratio == want.useful_ratio
    assert set(got.to_dict()) == set(want.to_dict())


def test_analyze_step_counts_a_matmul():
    a, b = torch.ones(64, 128), torch.ones(128, 32)
    _, flops, nbytes, ops = roofline.count_step(torch.matmul, a, b)
    assert flops == 2 * 64 * 128 * 32
    assert nbytes == 4 * (64 * 128 + 128 * 32 + 64 * 32) and ops == 1
    rep = roofline.analyze_step(lambda x: (x @ b).reshape(-1), a,
                                model_flops_total=flops)
    assert rep.flops == flops and rep.useful_ratio == 1.0
    assert rep.bytes_accessed == nbytes          # the view counts nothing
    assert rep.dominant == "memory"


def test_dry_run_cell_on_fake_tensors(tmp_path):
    mesh = dryrun.make_production_mesh()
    assert mesh.device == torch.device("meta") and mesh.devices.size == 256
    r = dryrun.run_cell("smollm-135m", "decode_32k", mesh, "single",
                        str(tmp_path))
    assert r["status"] == "ok", r.get("error")
    for key in ("arch", "shape", "n_params", "n_active_params", "mesh",
                "kind", "mesh_label", "chips", "memory_analysis",
                "roofline"):
        assert key in r
    assert r["chips"] == 256 and r["mesh"] == [16, 16]
    mem = r["memory_analysis"]
    # the vocab (49152) and the width (576) split over model=16
    assert mem["param_bytes_per_device"] * 16 >= r["n_params"] * 2 * 0.9
    assert r["roofline"]["flops"] > 0
    with open(tmp_path / "single" / "smollm-135m__decode_32k.json") as f:
        assert json.load(f) == r
    skipped = dryrun.run_cell("qwen3-0.6b", "long_500k", mesh, "single",
                              str(tmp_path))
    assert skipped["status"] == "skipped"


def test_dry_run_train_cell_counts_the_step():
    cfg = configs.get_config("qwen3-0.6b").reduced()
    meta, rep, mem = dryrun.analyze_cell(
        "qwen3-0.6b", "train_4k", meshlib.make_host_mesh(2, 2, device="meta"),
        cfg_overrides={k: getattr(cfg, k) for k in (
            "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
            "head_dim")})
    n = meta["n_params"]
    assert mem["moment_bytes_per_device"] > 0
    # fwd + bwd + the remat recompute of every layer: more than 6 N D
    assert rep.flops > rep.model_flops_total == 6 * n * 256 * 4096
