from repro_torch.configs.registry import (
    ARCH_IDS,
    SHAPES,
    ShapeSpec,
    build_model,
    get_config,
)

__all__ = ["ARCH_IDS", "SHAPES", "ShapeSpec", "build_model", "get_config"]
