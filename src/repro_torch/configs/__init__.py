from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401
