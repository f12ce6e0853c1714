"""Mamba2 block with the chunked SSD algorithm (arXiv:2405.21060) — the
port of ``repro.models.ssm``.

Prefill runs the SSD chunk scan through ``kernels.ssd_scan`` (the CUDA
kernel on the card, its plain version on the CPU) where the reference
computes it in jnp (``_ssd_chunked``); the kernel also returns the final
state the decode cache starts from.  Decode is the O(1) state update in
PyTorch, as in the reference: no kernel there.

Layout: d_inner = expand · d_model, heads nh = d_inner / head_dim, one B/C
group; depthwise causal convs on x, B and C separately.  ``A_log``, ``D``
and ``dt_bias`` are float32 whatever the parameter dtype, as in the
reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    causal_conv_silu,
    dense_axes,
    dense_init,
    merge_heads,
    norm_apply,
    normal,
    softplus,
    split_heads,
)

__all__ = ["make_ssm_cache", "mamba_apply", "mamba_axes", "mamba_decode", "mamba_init", "ssm_cache_axes"]

_PROJ_AXES = [
    ("wz", ("embed", "ssm_in")),
    ("wx", ("embed", "ssm_in")),
    ("wB", ("embed", "state")),
    ("wC", ("embed", "state")),
    ("wdt", ("embed", "ssm_heads")),
]


def mamba_init(gen, cfg, dtype) -> dict:
    d = cfg.d_model
    s = cfg.ssm
    d_in = s.expand * d
    nh = d_in // s.head_dim
    n = s.d_state
    dev = gen.device
    params = {}
    for (name, ax), cols in zip(_PROJ_AXES, (d_in, d_in, n, n, nh)):
        params[name] = dense_init(gen, (d, cols), ax, dtype)
    params["conv_x"] = normal(gen, (s.conv_kernel, d_in), 0.1, dtype)
    params["conv_B"] = normal(gen, (s.conv_kernel, n), 0.1, dtype)
    params["conv_C"] = normal(gen, (s.conv_kernel, n), 0.1, dtype)
    params["A_log"] = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=dev))
    params["D"] = torch.ones((nh,), dtype=torch.float32, device=dev)
    params["dt_bias"] = torch.zeros((nh,), dtype=torch.float32, device=dev)
    params["norm"] = {"scale": torch.ones((d_in,), dtype=dtype, device=dev)}
    params["out"] = dense_init(gen, (d_in, d), ("ssm_in", "embed"), dtype, scale=d_in**-0.5)
    return params


def mamba_axes(cfg) -> dict:
    """The logical axes of ``mamba_init``'s parameters."""
    axes = {name: dense_axes(ax) for name, ax in _PROJ_AXES}
    axes.update(
        conv_x=("conv_k", "ssm_in"),
        conv_B=("conv_k", "state"),
        conv_C=("conv_k", "state"),
        A_log=("ssm_heads",),
        D=("ssm_heads",),
        dt_bias=("ssm_heads",),
        norm={"scale": ("ssm_in",)},
        out=dense_axes(("ssm_in", "embed")),
    )
    return axes


def _in_proj(params, x):
    """The five input projections: z, x, B, C (x's type) and dt_raw."""
    return tuple(x @ params[name]["w"].to(x.dtype) for name in ("wz", "wx", "wB", "wC", "wdt"))


def _out(params, y, z, x_dtype, shape):
    y = merge_heads(y, y.shape[-2]).reshape(shape).to(x_dtype)
    y = y * F.silu(z)
    y = norm_apply(params["norm"], y, "rmsnorm")
    return y @ params["out"]["w"].to(x_dtype)


def mamba_apply(params, x, cfg, return_state: bool = False, kernels=ops.KERNELS):
    """Full-sequence Mamba2 block.  x (B, S, D) -> (B, S, D); with
    ``return_state`` also the decode-cache layer {ssm, conv_x, conv_B, conv_C}."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    d_in = s_cfg.expand * d
    nh = d_in // s_cfg.head_dim
    z, xr, Bm, Cm, dt_raw = _in_proj(params, x)
    xr, conv_x_state = causal_conv_silu(xr, params["conv_x"])
    Bm, conv_B_state = causal_conv_silu(Bm, params["conv_B"])
    Cm, conv_C_state = causal_conv_silu(Cm, params["conv_C"])
    xr = constrain(xr, ("act_batch", None, "act_ffn"))
    dt = softplus(dt_raw.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    xh = split_heads(xr, nh, s_cfg.head_dim)
    y, S_final = kernels.ssd_scan(xh, dt, A, Bm, Cm, s_cfg.chunk)
    y = y + params["D"][None, None, :, None] * xh.float()
    out = _out(params, y, z, x.dtype, (b, s, d_in))
    if return_state:
        return out, {"ssm": S_final, "conv_x": conv_x_state, "conv_B": conv_B_state, "conv_C": conv_C_state}
    return out


# ---------------------------------------------------------------------------
# decode (O(1) state update)
# ---------------------------------------------------------------------------
def make_ssm_cache(cfg, batch: int, n_layers: int, dtype, device) -> dict:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    k = s.conv_kernel
    return {
        "ssm": torch.zeros((n_layers, batch, nh, s.head_dim, s.d_state), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((n_layers, batch, k - 1, d_in), dtype=dtype, device=device),
        "conv_B": torch.zeros((n_layers, batch, k - 1, s.d_state), dtype=dtype, device=device),
        "conv_C": torch.zeros((n_layers, batch, k - 1, s.d_state), dtype=dtype, device=device),
    }


def ssm_cache_axes() -> dict:
    return {
        "ssm": ("layers", "cache_batch", "ssm_heads", None, None),
        "conv_x": ("layers", "cache_batch", None, "ssm_in"),
        "conv_B": ("layers", "cache_batch", None, "state"),
        "conv_C": ("layers", "cache_batch", None, "state"),
    }


def mamba_decode(params, x, cfg, cache_layer):
    """x (B, 1, D); ``cache_layer`` {ssm, conv_x, conv_B, conv_C} of one
    layer.  Returns (y (B, 1, D), the layer's new state)."""
    s_cfg = cfg.ssm
    b, _, d = x.shape
    d_in = s_cfg.expand * d
    nh = d_in // s_cfg.head_dim
    z, xr, Bm, Cm, dt_raw = _in_proj(params, x)
    xr, cx = causal_conv_silu(xr, params["conv_x"], cache_layer["conv_x"])
    Bm, cB = causal_conv_silu(Bm, params["conv_B"], cache_layer["conv_B"])
    Cm, cC = causal_conv_silu(Cm, params["conv_C"], cache_layer["conv_C"])
    dt = softplus(dt_raw.float() + params["dt_bias"][None, None, :])[:, 0]  # (b, nh)
    A = -torch.exp(params["A_log"])
    xh = xr.reshape(b, nh, s_cfg.head_dim).float()
    Bv = Bm[:, 0].float()
    Cv = Cm[:, 0].float()
    decay = torch.exp(dt * A[None, :])
    S_new = cache_layer["ssm"] * decay[..., None, None] + torch.einsum("bhp,bn,bh->bhpn", xh, Bv, dt)
    y = torch.einsum("bhpn,bn->bhp", S_new, Cv) + params["D"][None, :, None] * xh
    out = _out(params, y, z, x.dtype, (b, 1, d_in))
    return out, {"ssm": S_new, "conv_x": cx, "conv_B": cB, "conv_C": cC}
