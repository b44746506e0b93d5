"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536
— Finch, data-dependent decay. [arXiv:2404.05892; unverified]

Attention-free: the DX100 technique applies only at the embedding
(DESIGN.md §Arch-applicability). O(1) state => long_500k runs."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536, head_dim=64,
)
