"""repro_torch.models — the decoder-only LM (dense, MoE and VLM families)
the serving loop hosts; ``build_model(cfg, device=)`` is the entry point."""
from repro_torch.models.model import build_model  # noqa: F401

__all__ = ["build_model"]
