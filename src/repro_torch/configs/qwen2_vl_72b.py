"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

Vision frontend is a STUB per the assignment: input_specs() supplies
precomputed patch embeddings; the model prepends them to the text stream
and applies M-RoPE with (temporal, height, width) position streams."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, head_dim=128,
    mrope_sections=(16, 24, 24), rope_theta=1e6,
)
