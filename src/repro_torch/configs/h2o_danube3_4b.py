"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix, sliding-window attention.
[arXiv:2401.16818; unverified]

SWA (window 4096) makes the arch sub-quadratic => long_500k runs with a
window-bounded KV cache (DESIGN.md §Arch-applicability)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000, head_dim=120,
    sliding_window=4096, rope_theta=1e4,
)
