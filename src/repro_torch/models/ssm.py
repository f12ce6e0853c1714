"""Mamba2 block with the chunked SSD algorithm (arXiv:2405.21060) — the
port of ``repro.models.ssm``.

Every kernel comes from the bundle the caller passes (``kernels.ops``'
``KERNELS``: the CUDA kernel on card tensors, its plain version on CPU and
meta tensors; or ``PLAIN``: the plain versions everywhere).  Prefill and
decode run the three depthwise causal convs, their biases and SiLU through
``kernels.causal_conv_silu``, one call each for x, B and C, where the
reference computes them in jnp.  Prefill runs the SSD chunk scan through
``kernels.ssd_scan`` where the reference computes it in jnp
(``_ssd_chunked``); the kernel also returns the final state the decode
cache starts from.  Decode is the O(1) state update in PyTorch, as in the
reference.  Both hand the scan's output to ``kernels.gated_rmsnorm``: the D
skip, the SiLU gate and the RMSNorm in one pass, where the reference runs
them in jnp.

Layout: d_inner = expand · d_model, heads nh = d_inner / head_dim,
``ssm.n_groups`` B/C groups (head h reads group h // (nh / n_groups));
depthwise causal convs on x, B and C separately, with a bias each where
``ssm.conv_bias``.  The gate then the RMSNorm (eps ``cfg.norm_eps``), over
each group's d_inner / n_groups channels (zamba2-7b: 3584).  One group, no
bias and one norm over d_inner is the reference's layout, which zamba2-1.2b
keeps.  ``A_log``, ``D`` and ``dt_bias`` are float32 whatever
the parameter dtype, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops
from repro_torch.models.layers import Spec, dense_spec, norm_spec, softplus, split_heads

__all__ = ["mamba_apply", "mamba_decode", "mamba_spec", "ssm_cache_spec"]


def _widths(cfg) -> tuple:
    """(d_inner, heads, B/C channels n_groups · d_state)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, s.n_groups * s.d_state


def mamba_spec(cfg, dtype) -> dict:
    d, s = cfg.d_model, cfg.ssm
    d_in, nh, n = _widths(cfg)
    spec = {
        "wz": dense_spec((d, d_in), ("embed", "ssm_in"), dtype),
        "wx": dense_spec((d, d_in), ("embed", "ssm_in"), dtype),
        "wB": dense_spec((d, n), ("embed", "state"), dtype),
        "wC": dense_spec((d, n), ("embed", "state"), dtype),
        "wdt": dense_spec((d, nh), ("embed", "ssm_heads"), dtype),
        "conv_x": Spec((s.conv_kernel, d_in), dtype, ("conv_k", "ssm_in"), std=0.1),
        "conv_B": Spec((s.conv_kernel, n), dtype, ("conv_k", "state"), std=0.1),
        "conv_C": Spec((s.conv_kernel, n), dtype, ("conv_k", "state"), std=0.1),
    }
    if s.conv_bias:
        for name, cols, ax in (("conv_x_b", d_in, "ssm_in"), ("conv_B_b", n, "state"), ("conv_C_b", n, "state")):
            spec[name] = Spec((cols,), dtype, (ax,), std=0.1)
    f32 = torch.float32

    def a_log(dev):
        return torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32, device=dev))

    spec.update(
        A_log=Spec((nh,), f32, ("ssm_heads",), fill=a_log),
        D=Spec((nh,), f32, ("ssm_heads",), fill=1.0),
        dt_bias=Spec((nh,), f32, ("ssm_heads",)),
        norm=norm_spec(d_in, "rmsnorm", dtype, "ssm_in"),
        out=dense_spec((d_in, d), ("ssm_in", "embed"), dtype, scale=d_in**-0.5),
    )
    return spec


def _in_proj(params, x):
    """The five input projections: z, x, B, C (x's type) and dt_raw."""
    return tuple(x @ params[name]["w"].to(x.dtype) for name in ("wz", "wx", "wB", "wC", "wdt"))


def _convs(params, xr, Bm, Cm, kernels, cache_layer=None):
    """The three depthwise causal convs (with their biases, if any) and SiLU,
    one call of the bundle's ``causal_conv_silu`` each: (x, B, C) and their
    next conv states."""
    out = []
    for name, t in (("conv_x", xr), ("conv_B", Bm), ("conv_C", Cm)):
        state = None if cache_layer is None else cache_layer[name]
        out.append(kernels.causal_conv_silu(t, params[name], state, params.get(name + "_b")))
    return [o[0] for o in out], [o[1] for o in out]


def _dt(params, dt_raw):
    return softplus(dt_raw.float() + params["dt_bias"][None, None, :])


def _out(params, y, xh, z, cfg, kernels):
    """The scan's y (b, s, h, p) f32 through the D skip on xh, the gate z and
    the RMSNorm over each B/C group's d_inner / n_groups channels, then the
    out-projection."""
    y = kernels.gated_rmsnorm(y, xh, z, params["D"], params["norm"]["scale"], cfg.ssm.n_groups, cfg.norm_eps)
    return y @ params["out"]["w"].to(z.dtype)


def mamba_apply(params, x, cfg, return_state: bool = False, kernels=ops.KERNELS):
    """Full-sequence Mamba2 block.  x (B, S, D) -> (B, S, D); with
    ``return_state`` also the decode-cache layer {ssm, conv_x, conv_B, conv_C}."""
    s_cfg = cfg.ssm
    nh = s_cfg.expand * x.shape[-1] // s_cfg.head_dim
    z, xr, Bm, Cm, dt_raw = _in_proj(params, x)
    (xr, Bm, Cm), (conv_x_state, conv_B_state, conv_C_state) = _convs(params, xr, Bm, Cm, kernels)
    xr = constrain(xr, ("act_batch", None, "act_ffn"))
    dt = _dt(params, dt_raw)
    A = -torch.exp(params["A_log"])
    xh = split_heads(xr, nh, s_cfg.head_dim)
    if s_cfg.n_groups > 1:  # (b, s, g, n): the kernel maps heads onto groups
        Bm, Cm = Bm.unflatten(-1, (s_cfg.n_groups, -1)), Cm.unflatten(-1, (s_cfg.n_groups, -1))
    y, S_final = kernels.ssd_scan(xh, dt, A, Bm, Cm, s_cfg.chunk)
    out = _out(params, y, xh, z, cfg, kernels)
    if return_state:
        return out, {"ssm": S_final, "conv_x": conv_x_state, "conv_B": conv_B_state, "conv_C": conv_C_state}
    return out


# ---------------------------------------------------------------------------
# decode (O(1) state update)
# ---------------------------------------------------------------------------
def ssm_cache_spec(cfg, batch: int, n_layers: int, dtype) -> dict:
    """The zeroed decode state of ``n_layers`` Mamba2 layers: the SSM state
    (float32) and the three conv states."""
    s = cfg.ssm
    d_in, nh, n = _widths(cfg)
    lead, k = (n_layers, batch), s.conv_kernel - 1
    ax = ("layers", "cache_batch")
    return {
        "ssm": Spec(lead + (nh, s.head_dim, s.d_state), torch.float32, ax + ("ssm_heads", None, None)),
        "conv_x": Spec(lead + (k, d_in), dtype, ax + (None, "ssm_in")),
        "conv_B": Spec(lead + (k, n), dtype, ax + (None, "state")),
        "conv_C": Spec(lead + (k, n), dtype, ax + (None, "state")),
    }


def mamba_decode(params, x, cfg, cache_layer, kernels=ops.KERNELS):
    """x (B, 1, D); ``cache_layer`` {ssm, conv_x, conv_B, conv_C} of one
    layer; ``kernels`` the bundle whose ``causal_conv_silu`` and
    ``gated_rmsnorm`` it calls.  Returns
    (y (B, 1, D), the layer's new state)."""
    s_cfg = cfg.ssm
    b, _, d = x.shape
    d_in = s_cfg.expand * d
    nh = d_in // s_cfg.head_dim
    z, xr, Bm, Cm, dt_raw = _in_proj(params, x)
    (xr, Bm, Cm), (cx, cB, cC) = _convs(params, xr, Bm, Cm, kernels, cache_layer)
    dt = _dt(params, dt_raw)[:, 0]  # (b, nh)
    A = -torch.exp(params["A_log"])
    xh = xr.reshape(b, nh, s_cfg.head_dim).float()
    Bv = Bm[:, 0].float()
    Cv = Cm[:, 0].float()
    decay = torch.exp(dt * A[None, :])
    if s_cfg.n_groups > 1:  # each head's group: (b, nh, n)
        Bv = Bv.unflatten(-1, (s_cfg.n_groups, -1)).repeat_interleave(nh // s_cfg.n_groups, dim=1)
        Cv = Cv.unflatten(-1, (s_cfg.n_groups, -1)).repeat_interleave(nh // s_cfg.n_groups, dim=1)
        S_new = cache_layer["ssm"] * decay[..., None, None] + torch.einsum("bhp,bhn,bh->bhpn", xh, Bv, dt)
        y = torch.einsum("bhpn,bhn->bhp", S_new, Cv)
    else:
        S_new = cache_layer["ssm"] * decay[..., None, None] + torch.einsum("bhp,bn,bh->bhpn", xh, Bv, dt)
        y = torch.einsum("bhpn,bn->bhp", S_new, Cv)
    heads = (b, 1, nh, s_cfg.head_dim)  # prefill's (b, s, h, p) at s = 1
    out = _out(params, y.reshape(heads).contiguous(), xr.reshape(heads), z, cfg, kernels)
    return out, {"ssm": S_new, "conv_x": cx, "conv_B": cB, "conv_C": cC}
