"""AdamW (decoupled weight decay, float32 state) — the port of
``repro.optim.adamw``.

The optimizer state mirrors the parameter tree.  Parameters may be
bfloat16; m, v and the update math are float32, and each updated
parameter is cast back to its own type.  ``adamw_update`` writes the new
parameters, m and v into the tensors it is given, under ``torch.no_grad``
(the port's stand-in for the reference's donated buffers: the values are
the reference's, and the step holds one copy of the state instead of two).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "clip_by_global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: Callable | float = 3e-4  # float or schedule(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack([torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]).sum())


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, tree), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step with gradients clipped to ``cfg.grad_clip`` by their
    global norm.  Updates ``params`` and ``state`` in place and returns
    (params, state, {grad_norm, lr})."""
    step = state["step"] + 1
    lr = cfg.lr(step) if callable(cfg.lr) else torch.full((), cfg.lr, dtype=torch.float32, device=step.device)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step32 = step.float()
    b1c = 1.0 - cfg.b1**step32
    b2c = 1.0 - cfg.b2**step32

    def upd(p, g, m, v):
        g = g.float() * scale  # clip_by_global_norm, a leaf at a time
        m.copy_(cfg.b1 * m + (1.0 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g))
        p32 = p.float()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)

    tree_map(upd, params, grads, state["m"], state["v"])
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
