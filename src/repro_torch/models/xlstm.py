"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory),
arXiv:2405.04517 — the port of ``repro.models.xlstm``.

mLSTM: the full sequence (prefill) runs through ``kernels.mlstm_chunk``
(the CUDA kernel on the card, its plain version on the CPU), which also
returns the final (C, n, m); the reference runs a time scan of the
recurrent form (``_mlstm_cell_scan``), the same function.  Decode is one
step of that recurrence in PyTorch.

sLSTM has no kernel of its own: its time scan is a loop over positions, as
the reference's is a ``lax.scan``; decode is the same loop of length one.

Both blocks, prefill and decode, run their conv4 front (depthwise causal
conv and SiLU) through the bundle's ``causal_conv_silu``, where the
reference computes it in jnp.

Block layout per the paper's 125M configuration: mLSTM with projection
factor 2 (up → conv → cell → gated down), sLSTM with a conv4 front and a
GLU FFN of factor 4/3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import per_shard
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    Spec,
    dense_spec,
    merge_heads,
    norm_apply,
    norm_spec,
    softplus,
    split_heads,
)

__all__ = [
    "MLSTM_CHUNK",
    "is_slstm",
    "mlstm_apply",
    "mlstm_decode",
    "mlstm_spec",
    "slstm_apply",
    "slstm_decode",
    "slstm_spec",
    "xlstm_cache_spec",
]

MLSTM_CHUNK = 256  # the TPU kernel's default chunk; the CUDA kernel's largest


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_spec(cfg, dtype) -> dict:
    d = cfg.d_model
    d_in = 2 * d  # projection factor 2
    nh = cfg.n_heads
    spec = {}
    for name, shape, ax in (
        ("up", (d, d_in), ("embed", "ssm_in")),
        ("gate", (d, d_in), ("embed", "ssm_in")),
        ("wq", (d_in, d_in), ("ssm_in", None)),
        ("wk", (d_in, d_in), ("ssm_in", None)),
        ("wv", (d_in, d_in), ("ssm_in", None)),
        ("wif", (d_in, 2 * nh), ("ssm_in", None)),
        ("down", (d_in, d), ("ssm_in", "embed")),
    ):
        spec[name] = dense_spec(shape, ax, dtype, scale=shape[0] ** -0.5)
    spec["conv"] = Spec((4, d_in), dtype, ("conv_k", "ssm_in"), std=0.1)
    spec["norm"] = norm_spec(d_in, "rmsnorm", dtype, "ssm_in")
    return spec


def _log_sigmoid(x):
    return -softplus(-x)


def _mlstm_in(params, x, nh, kernels, conv_state=None):
    """Projections of an mLSTM block, the conv through the bundle's
    ``causal_conv_silu``: (q, k, v (B, S, nh, hd) in x's type, log_i, log_f
    (B, S, nh) f32, the output gate g, the conv state)."""
    b, s, _ = x.shape
    u = x @ params["up"]["w"].to(x.dtype)
    g = x @ params["gate"]["w"].to(x.dtype)
    hd = u.shape[-1] // nh
    c, conv_state = kernels.causal_conv_silu(u, params["conv"], conv_state)
    q = split_heads(c @ params["wq"]["w"].to(x.dtype), nh, hd)
    k = split_heads(c @ params["wk"]["w"].to(x.dtype), nh, hd)
    v = split_heads(u @ params["wv"]["w"].to(x.dtype), nh, hd)
    gates = (c @ params["wif"]["w"].to(x.dtype)).float()
    return q, k, v, gates[..., :nh].contiguous(), _log_sigmoid(gates[..., nh:]).contiguous(), g, conv_state


def _mlstm_out(params, h, g, x_dtype, kernels):
    y = merge_heads(h, h.shape[2]).to(x_dtype)
    y = norm_apply(params["norm"], y, "rmsnorm", kernels=kernels)
    y = y * F.silu(g)
    return y @ params["down"]["w"].to(x_dtype)


def mlstm_apply(params, x, cfg, return_state: bool = False, kernels=ops.KERNELS):
    """Full-sequence mLSTM block from the zero state.  x (B, S, D) ->
    (B, S, D); with ``return_state`` also the decode state {C, n, m, conv}."""
    q, k, v, log_i, log_f, g, conv_state = _mlstm_in(params, x, cfg.n_heads, kernels)
    h, C, n, m = kernels.mlstm_chunk(q, k, v, log_i, log_f, MLSTM_CHUNK)
    out = _mlstm_out(params, h, g, x.dtype, kernels)
    if return_state:
        return out, {"C": C, "n": n, "m": m, "conv": conv_state}
    return out


def mlstm_decode(params, x, cfg, state, kernels=ops.KERNELS):
    """One step of the stabilised recurrence.  x (B, 1, D); ``state``
    {C (B, nh, hd, hd), n (B, nh, hd), m (B, nh), conv}.  Returns (y, new state)."""
    q, k, v, log_i, log_f, g, conv_state = _mlstm_in(params, x, cfg.n_heads, kernels, state["conv"])
    q, k, v = (t[:, 0].float() for t in (q, k, v))  # (B, nh, hd)
    li, lf = log_i[:, 0], log_f[:, 0]  # (B, nh)
    scale = q.shape[-1] ** -0.5
    m = state["m"]
    m_new = torch.maximum(lf + m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + m - m_new)
    C = f_p[..., None, None] * state["C"] + i_p[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = f_p[..., None] * state["n"] + i_p[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C) * scale
    den = torch.maximum(torch.einsum("bhk,bhk->bh", q, n).abs() * scale, torch.exp(-m_new))
    h = (num / den[..., None])[:, None]  # (B, 1, nh, hd)
    return _mlstm_out(params, h, g, x.dtype, kernels), {"C": C, "n": n, "m": m_new, "conv": conv_state}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_spec(cfg, dtype) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    spec = {name: dense_spec((d, d), ("embed", None), dtype) for name in ("wz", "wi", "wf", "wo")}
    for name in ("rz", "ri", "rf"):
        spec[name] = {"w": Spec((nh, hd, hd), dtype, (None, "head_dim", "head_dim"), std=hd**-0.5)}
    spec["conv"] = Spec((4, d), dtype, ("conv_k", "embed"), std=0.1)
    spec["norm"] = norm_spec(d, "rmsnorm", dtype)
    d_ff = int(d * 4 / 3)  # GLU ffn, projection factor 4/3
    spec["ffn_up"] = dense_spec((d, d_ff), ("embed", "ffn"), dtype)
    spec["ffn_gate"] = dense_spec((d, d_ff), ("embed", "ffn"), dtype)
    spec["ffn_down"] = dense_spec((d_ff, d), ("ffn", "embed"), dtype, scale=d_ff**-0.5)
    return spec


def _slstm_cell_scan(z_in, i_in, f_in, o_in, params, nh, hd, state=None):
    """z/i/f/o inputs (B, S, D), the input part of each pre-activation; the
    recurrent part is added step by step.  Returns (h (B, S, D) f32, final
    {h, c, n, m})."""
    b, s, d = z_in.shape
    dev = z_in.device
    if state is None:
        h = torch.zeros((b, d), dtype=torch.float32, device=dev)
        c = torch.zeros_like(h)
        n = torch.zeros_like(h)
        m = torch.full((b, d), float("-inf"), dtype=torch.float32, device=dev)
    else:
        h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    rz, ri, rf = (params[name]["w"].float() for name in ("rz", "ri", "rf"))
    zs, is_, fs = (t.float() for t in (z_in, i_in, f_in))
    o = torch.sigmoid(o_in.float())  # depends on the input alone

    def rec(h, r):  # block-diagonal recurrent product, (B, D) -> (B, D)
        return merge_heads(torch.einsum("bnk,nkl->bnl", split_heads(h, nh, hd), r), nh)

    hs = []
    for t in range(s):
        z = torch.tanh(zs[:, t] + rec(h, rz))
        li = is_[:, t] + rec(h, ri)
        lf = _log_sigmoid(fs[:, t] + rec(h, rf))
        m_new = torch.maximum(lf + m, li)
        i_p = torch.exp(li - m_new)
        f_p = torch.exp(lf + m - m_new)
        c = f_p * c + i_p * z
        n = f_p * n + i_p
        h = o[:, t] * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), {"h": h, "c": c, "n": n, "m": m}


_CELL = ("h", "c", "n", "m")


def _slstm_scan_per_shard(z_in, i_in, f_in, o_in, params, nh, hd, state=None):
    """``_slstm_cell_scan`` on DTensors: the recurrence mixes no batch rows,
    so each rank scans its own rows on local tensors (``per_shard.run``)
    instead of running every step's ops through DTensor."""
    st = [] if state is None else [state[k] for k in _CELL]

    def scan(z, i, f, o, rz, ri, rf, *s):
        weights = {"rz": {"w": rz}, "ri": {"w": ri}, "rf": {"w": rf}}
        hs, cell = _slstm_cell_scan(z, i, f, o, weights, nh, hd, dict(zip(_CELL, s)) if s else None)
        return (hs, *(cell[k] for k in _CELL))

    b = {"batch": 0}
    args = (z_in, i_in, f_in, o_in, params["rz"]["w"], params["ri"]["w"], params["rf"]["w"], *st)
    out = per_shard.run(scan, args, (b,) * 4 + ({},) * 3 + (b,) * len(st), (b,) * 5)
    return out[0], dict(zip(_CELL, out[1:]))


def slstm_apply(params, x, cfg, return_state: bool = False, state=None, kernels=ops.KERNELS):
    """sLSTM block.  x (B, S, D) -> (B, S, D); ``state`` {cell, conv}
    continues from a decode state; the conv runs through the bundle's
    ``causal_conv_silu``."""
    nh = cfg.n_heads
    hd = x.shape[-1] // nh
    cx, conv_state = kernels.causal_conv_silu(x, params["conv"], None if state is None else state["conv"])
    z_in = x @ params["wz"]["w"].to(x.dtype)
    o_in = x @ params["wo"]["w"].to(x.dtype)
    i_in = cx @ params["wi"]["w"].to(x.dtype)
    f_in = cx @ params["wf"]["w"].to(x.dtype)
    scan = _slstm_scan_per_shard if per_shard.is_dtensor(z_in) else _slstm_cell_scan
    h, cell = scan(z_in, i_in, f_in, o_in, params, nh, hd, None if state is None else state["cell"])
    h = norm_apply(params["norm"], h.to(x.dtype), "rmsnorm", kernels=kernels)
    up = h @ params["ffn_up"]["w"].to(x.dtype)
    gate = h @ params["ffn_gate"]["w"].to(x.dtype)
    y = (F.silu(gate) * up) @ params["ffn_down"]["w"].to(x.dtype)
    if return_state:
        return y, {"cell": cell, "conv": conv_state}
    return y


def slstm_decode(params, x, cfg, state, kernels=ops.KERNELS):
    return slstm_apply(params, x, cfg, return_state=True, state=state, kernels=kernels)


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------
def is_slstm(cfg, li: int) -> bool:
    """Layer ``li`` is an sLSTM block (one in every ``slstm_every``)."""
    return (li + 1) % cfg.slstm_every == 0


def xlstm_cache_spec(cfg, batch: int, dtype) -> list:
    """Each layer's decode state from the zero state: the cells and the
    conv state zeroed, the stabiliser m at -1e30."""
    d = cfg.d_model
    nh = cfg.n_heads
    d_in = 2 * d
    hd_m = d_in // nh
    f32 = torch.float32

    def state(li: int) -> dict:
        if is_slstm(cfg, li):
            cell = {k: Spec((batch, d), f32, ("cache_batch", None)) for k in ("h", "c", "n")}
            cell["m"] = Spec((batch, d), f32, ("cache_batch", None), fill=-1e30)
            return {"cell": cell, "conv": Spec((batch, 3, d), dtype, ("cache_batch", None, None))}
        return {
            "C": Spec((batch, nh, hd_m, hd_m), f32, ("cache_batch", None, None, None)),
            "n": Spec((batch, nh, hd_m), f32, ("cache_batch", None, None)),
            "m": Spec((batch, nh), f32, ("cache_batch", None), fill=-1e30),
            "conv": Spec((batch, 3, d_in), dtype, ("cache_batch", None, "ssm_in")),
        }

    return [state(li) for li in range(cfg.n_layers)]
