"""Typed configuration for the PyTorch port (a copy of the reference's)."""
from repro_torch.config.base import (
    AttentionKind,
    BlockKind,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    register_config,
)

__all__ = [
    "AttentionKind",
    "BlockKind",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "get_config",
    "register_config",
]
