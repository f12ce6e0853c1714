"""int8 error-feedback gradient compression — the port of
``repro.optim.grad_compress``.

Each gradient plus its carried residual is quantized to int8 with a
per-tensor scale (max |g| / 127, ``torch.round`` rounding half to even as
``jnp.round`` does) and dequantized; the quantization residual is carried
to the next step (error feedback), so compression is unbiased over time.
On one card nothing crosses a wire: the training step applies the round
trip to the accumulated gradient as the reference does under GSPMD.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_map

__all__ = ["init_error_state", "compress_tensor", "compress_tree"]


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_tensor(g, err):
    """(dequantized g after the int8 round trip, new error residual)."""
    g = g.float() + err
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, g - deq


def compress_tree(grads, err_state):
    out = tree_map(compress_tensor, grads, err_state)  # a (deq, err) pair at each leaf
    return _pick(out, 0), _pick(out, 1)


def _pick(tree, i: int):
    if isinstance(tree, tuple):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return [_pick(v, i) for v in tree]
