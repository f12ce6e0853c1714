"""Carry weights and caches between the reference and the port.

The port keeps the reference's parameter names and shapes, so a reference
parameter tree — as numpy arrays, for example
``jax.tree.map(np.asarray, params)`` — becomes the port's by a rename of
array type.  The KV caches differ in layout: the reference's is (layers, B,
T, KV, hd), the port's (layers, B, KV, T, hd), the kernels' layout.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.models import lm
from repro_torch.models.layers import Dtypes

__all__ = ["cache_to_reference", "params_from_numpy"]


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree, cfg, device=None) -> dict:
    """The reference's parameter tree (nested dicts and lists of numpy
    arrays) as the port's parameters on ``device``, in ``cfg.param_dtype``.
    Both packages then compute the same function."""
    lm.check_supported(cfg)
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['layers'])} layers, {cfg.name} has {cfg.n_layers}")
    dev = device_mod.resolve(device)
    dtype = Dtypes.from_cfg(cfg).param

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _tensor(node, dtype, dev)

    return conv(tree)


def cache_to_reference(cache) -> dict:
    """A port KV cache as numpy arrays in the reference's layout:
    k and v (layers, B, T, KV, hd) in float32, index int32."""
    return {
        "k": cache["k"].permute(0, 1, 3, 2, 4).float().cpu().numpy(),
        "v": cache["v"].permute(0, 1, 3, 2, 4).float().cpu().numpy(),
        "index": np.int32(cache["index"]),
    }
