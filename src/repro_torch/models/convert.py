"""Carry weights and caches between the reference and the port.

The port keeps the reference's parameter names and shapes, so a reference
parameter tree — as numpy arrays, for example
``jax.tree.map(np.asarray, params)`` — becomes the port's by a rename of
array type; each array keeps its float type (the reference keeps the
Mamba2 ``A_log``, ``D`` and ``dt_bias`` in float32 under a bfloat16
parameter type).  The KV caches differ in layout: the reference's is
(layers, B, T, KV, hd), the port's (layers, B, KV, T, hd), the kernels'
layout, and so do the encoder-decoder's cross-attention caches.  The
Mamba2 and xLSTM states have the reference's layout.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.models import lm
from repro_torch.models.layers import Dtypes

__all__ = ["cache_to_reference", "params_from_numpy"]


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``: bfloat16 and float32 arrays keep their type,
    other float types become ``dtype``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=None if t.dtype == torch.float32 else dtype)


def params_from_numpy(tree, cfg, device=None) -> dict:
    """The reference's parameter tree (nested dicts and lists of numpy
    arrays) as the port's parameters on ``device``; float types other than
    bfloat16 and float32 become ``cfg.param_dtype``.  Both packages then
    compute the same function."""
    if cfg.is_encdec:
        stacks = {"encoder": cfg.encoder_layers, "decoder": cfg.n_layers}
    else:
        lm.check_supported(cfg)
        stacks = {"layers": cfg.n_layers}
    for name, n in stacks.items():
        if len(tree[name]) != n:
            raise ValueError(f"tree has {len(tree[name])} {name} layers, {cfg.name} has {n}")
    dev = device_mod.resolve(device)
    dtype = Dtypes.from_cfg(cfg).param

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _tensor(node, dtype, dev)

    return conv(tree)


def _np(t) -> np.ndarray:
    return t.float().cpu().numpy()


def _kv_to_reference(kv) -> dict:
    """Every (layers, B, KV, T, hd) tensor of ``kv`` as (layers, B, T, KV,
    hd), and the index."""
    out = {name: _np(t.permute(0, 1, 3, 2, 4)) for name, t in kv.items() if name != "index"}
    return dict(out, index=np.int32(kv["index"]))


def cache_to_reference(cache) -> dict:
    """A port decode cache as numpy arrays (float32, index int32) in the
    reference's layout: for ``attn`` {k, v (layers, B, T, KV, hd), index},
    and for the encoder-decoder also {cross_k, cross_v} in that layout; for
    ``zamba2`` {ssm: {ssm, conv_x, conv_B, conv_C}, kv: {k, v, index}}; for
    ``xlstm`` {xlstm: one state dict per layer, index}."""
    if "ssm" in cache:
        return {"ssm": {k: _np(v) for k, v in cache["ssm"].items()}, "kv": _kv_to_reference(cache["kv"])}
    if "xlstm" in cache:

        def conv(node):
            return {k: conv(v) for k, v in node.items()} if isinstance(node, dict) else _np(node)

        return {"xlstm": [conv(st) for st in cache["xlstm"]], "index": np.int32(cache["index"])}
    return _kv_to_reference(cache)
