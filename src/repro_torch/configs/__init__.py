from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig, ShapeConfig,
                                applicable_shapes, get_config)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig",
           "applicable_shapes", "get_config"]
