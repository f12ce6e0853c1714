"""Distribution substrate of the port: logical sharding rules on DeviceMesh /
DTensor, collectives over torch.distributed, elasticity."""

from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    Rules,
    constrain,
    current_mesh,
    pspec_for,
    sharding_for,
    tree_pspecs,
    tree_shardings,
    use_mesh,
)

__all__ = [
    "DEFAULT_RULES",
    "Rules",
    "constrain",
    "current_mesh",
    "pspec_for",
    "sharding_for",
    "tree_pspecs",
    "tree_shardings",
    "use_mesh",
]
