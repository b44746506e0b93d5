"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206 — enc-dec, multimodal. [arXiv:2308.11596; hf]

Audio frontend is a STUB: input_specs() supplies precomputed frame
embeddings. 24L = 12 encoder + 12 decoder; shape seq_len splits half/half
between source frames and target tokens (DESIGN.md)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64,
    n_enc_layers=12, n_dec_layers=12,
)
