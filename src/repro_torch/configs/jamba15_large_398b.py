"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave.
[arXiv:2403.19887; hf]

9 superblocks x 8 layers (1 attn + 7 mamba), MoE every 2nd layer.
Sub-quadratic (O(1) mamba state; only 9 attn caches) => long_500k runs."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, head_dim=128,
    n_experts=16, top_k=2,
    attn_period=8, moe_period=2,
    ssm_state=16, ssm_expand=2, ssm_conv=4,
)
