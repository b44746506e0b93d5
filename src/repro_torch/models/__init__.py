"""repro_torch.models — the model families the serving loop hosts (dense,
MoE and VLM decoders, the Mamba + attention hybrid, RWKV-6 and the
encoder-decoder); ``build_model(cfg, device=)`` is the entry point."""
from repro_torch.models.model import build_model  # noqa: F401

__all__ = ["build_model"]
