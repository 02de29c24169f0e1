"""Typed configuration for the PyTorch port (a copy of the reference's)."""
from repro_torch.config.base import (
    AttentionKind,
    BlockKind,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    list_configs,
    register_config,
)
from repro_torch.config.shapes import INPUT_SHAPES, get_shape

__all__ = [
    "AttentionKind",
    "BlockKind",
    "InputShape",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "get_config",
    "list_configs",
    "register_config",
    "INPUT_SHAPES",
    "get_shape",
]
