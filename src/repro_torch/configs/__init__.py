from repro_torch.configs.registry import (
    ARCH_IDS,
    SHAPES,
    ShapeSpec,
    TensorSpec,
    build_model,
    get_config,
    input_specs,
    shape_applicable,
)

__all__ = ["ARCH_IDS", "SHAPES", "ShapeSpec", "TensorSpec", "build_model", "get_config",
           "input_specs", "shape_applicable"]
