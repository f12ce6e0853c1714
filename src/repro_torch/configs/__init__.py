"""Assigned architectures (+ the paper example LM) as selectable configs."""

from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    MoECfg,
    ShapeSpec,
    SSMCfg,
    get_config,
    list_archs,
    register_arch,
)

__all__ = [
    "SHAPES",
    "ArchConfig",
    "MoECfg",
    "ShapeSpec",
    "SSMCfg",
    "get_config",
    "list_archs",
    "register_arch",
]
