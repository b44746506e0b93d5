"""Config schema + registry for the 10 assigned architectures.

Every architecture is selectable via ``--arch <id>`` in the launchers; each
carries its own input-shape suite (train_4k / prefill_32k / decode_32k /
long_500k) with per-family applicability rules (see DESIGN.md
§Arch-applicability).

The port's copy of the JAX package's ``configs``: the same data, with
``activation_dtype``/``weight_dtype`` as ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 1e4
    # vlm
    mrope_sections: Optional[Tuple[int, int, int]] = None
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # hybrid (jamba): one attention layer per `attn_period` layers, MoE every
    # `moe_period` layers; layers grouped into superblocks of attn_period.
    attn_period: int = 0
    moe_period: int = 0
    # ssm (mamba / rwkv)
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0             # 0 = d_model // 16
    # enc-dec
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # numerics
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "bfloat16"
    # activation checkpointing for the layer scan: "full" recomputes the
    # whole layer in backward (min memory), "dots" saves matmul outputs,
    # "none" saves everything (baseline w/o remat)
    remat: str = "full"
    # fully unroll the layer scans (dry-run cost accounting: XLA's
    # cost_analysis counts a while-loop body once, so scanned layers
    # under-report FLOPs/bytes by ~n_layers; unrolling restores exact
    # accounting at the price of a bigger HLO / longer compile)
    scan_unroll: bool = False
    # ---- beyond-paper performance knobs (EXPERIMENTS.md §Perf) ----
    # packed GQA: no KV head replication, bf16 QK/PV matmuls with f32
    # accumulation (cuts decode KV traffic by ~2*n_rep)
    opt_attention: bool = False
    # run cross-layer TP collectives in bf16 instead of f32
    bf16_collectives: bool = False
    # MoE dispatch/combine via shard_map all-to-all over the expert axis
    # instead of GSPMD gather/scatter
    moe_a2a: bool = False
    # explicit head-sharding constraints through recurrences (keeps the
    # WKV/SSM streams `model`-sharded instead of letting GSPMD all-gather)
    opt_shard_hints: bool = False

    @property
    def layer_unroll(self) -> int | bool:
        return True if self.scan_unroll else 1
    # schedule hints (minicpm uses WSD)
    schedule: str = "cosine"
    # DX100 engine integration
    dx100_embed_bwd: bool = True     # RMW-engine vocab-grad scatter
    dx100_embed_fwd: bool = False    # coalesced fwd gather
    dx100_tile: int = 16384
    # serve
    max_cache_len: int = 32768

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def weight_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(self.d_model // 16, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (DESIGN.md §Arch-applicability)."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    @property
    def has_decoder(self) -> bool:
        return True   # all assigned archs generate tokens

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        small = dict(
            n_layers=max(2, self.attn_period or 2),
            d_model=64, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            < self.n_heads else 4,
            d_ff=128, vocab=256, head_dim=16,
            n_experts=min(self.n_experts, 4), top_k=min(self.top_k, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            n_dec_layers=min(self.n_dec_layers, 2),
            sliding_window=16 if self.sliding_window else None,
            dtype="float32", param_dtype="float32",
            max_cache_len=64,
            mrope_sections=(2, 3, 3) if self.mrope_sections else None,
        )
        if self.attn_period:
            small["n_layers"] = self.attn_period  # one full superblock
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = (
    "qwen3-0.6b", "smollm-135m", "h2o-danube-3-4b", "minicpm-2b",
    "qwen2-vl-72b", "dbrx-132b", "grok-1-314b", "jamba-1.5-large-398b",
    "rwkv6-1.6b", "seamless-m4t-large-v2",
)

_MODULES = {
    "qwen3-0.6b": "qwen3_0_6b",
    "smollm-135m": "smollm_135m",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "minicpm-2b": "minicpm_2b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "dbrx-132b": "dbrx_132b",
    "grok-1-314b": "grok1_314b",
    "jamba-1.5-large-398b": "jamba15_large_398b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def applicable_shapes(cfg: ModelConfig):
    """The (arch x shape) cells this arch runs (40 total across the pool)."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.subquadratic:
            continue  # pure full-attention: skipped per prompt
        out.append(s)
    return out
