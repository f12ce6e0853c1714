"""Mixture-of-Experts FFN with static-capacity sort-free dispatch — the port
of ``repro.models.moe`` — and a dropless dispatch of the port's own.

Routing: softmax router → top-k → position-in-expert via masked cumsum →
scatter into an (experts, batch, capacity, d) buffer → expert products
batched over the experts → gather + weighted combine.  Capacity overflow
drops slots (GShard semantics); the Switch load-balancing loss is returned
beside y.  ``cfg.moe_dispatch == "einsum"`` takes GShard's one-hot
dispatch over token groups instead.  No Pallas kernel is involved in the
reference: the expert products stay batched matrix products.

Top-k takes ties toward the lower expert index, as ``jax.lax.top_k`` does
(``torch.topk`` does not promise an order among ties).  Router logits are
computed in x's type, the softmax and the gate renormalisation in float32,
and the gate weights are cast to x's type only at the combine.

``cfg.moe_dispatch == "dropless"`` (granite-4.0-h-small's published
router) drops nothing: float32 router logits, their top k (ties toward the
lower expert) and a softmax over those k; the (token, slot) assignments
sorted by expert (stably, so token order within an expert), the rows
gathered, both expert products run grouped over the experts' contiguous
segments (the bundle's ``grouped_mm``, whose segment ends stay on the
card: no host sync, whatever the routing), each row scaled by its gate
weight before the down projection, and the rows put back in (token, slot)
order through the inverse permutation and summed over the k slots.  No
document's result depends on the others in its batch.

Experts lie as ``up`` / ``gate`` / ``down`` (E, d, f), (E, f, d), or, with
``moe.fused_gate_up``, as published: ``input_linear`` (E, 2f, d), whose
first f rows feed the SiLU and the next f the up half, and
``output_linear`` (E, d, f).  Every dispatch reads either.  The shared MLP
is ``moe.d_ff_shared`` wide where the config gives that width.

Spans (``trace``): ``moe`` around each layer call, with a leaf ``route``
(router, top-k, sort) inside the dropless dispatch.  Counters: ``STATS``
(a ``MoEStats``: layer calls, tokens, assignments, the busiest expert's
assignments summed over calls, and dropped slots), the busiest expert's
and the dropped counts kept on the card until read.

Under a mesh (``distributed.sharding.use_mesh``) the dispatch buffers and
expert outputs are constrained at the reference's sites; the port's
buffers are (experts, batch rows, capacity, d), so their logical axes are
the reference's with the first two swapped.  Outside a mesh ``constrain``
returns its input.
"""

from __future__ import annotations

import dataclasses
import threading

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.distributed import per_shard
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops
from repro_torch.models.layers import ACT, Spec, dense_spec, mlp_apply, mlp_spec

__all__ = [
    "STATS",
    "MoEStats",
    "moe_apply",
    "moe_apply_dropless",
    "moe_apply_einsum",
    "moe_apply_scatter",
    "moe_spec",
    "route",
    "scatter_capacity",
    "slot_positions",
]

BUF_AXES = ("act_experts", "act_batch", None, None)


@dataclasses.dataclass
class MoEStats:
    """Counters of the MoE layers over the process's life.  The busiest
    expert's assignments and the dropped slots are summed on the card and
    read by ``snapshot``."""

    forwards: int = 0  # MoE layer calls
    tokens: int = 0
    assignments: int = 0  # (token, slot) pairs routed: tokens × k
    _card: dict = dataclasses.field(default_factory=dict, repr=False)  # device -> int64 [busiest, dropped]
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock, repr=False)

    def add(self, tokens: int, k: int, busiest=None, dropped=None) -> None:
        """One layer call: its token count, k, and 0-d integer tensors of its
        busiest expert's assignments and of its dropped slots (None: not
        counted; DTensors and shape-only tensors are not counted)."""
        with self._lock:
            self.forwards += 1
            self.tokens += tokens
            self.assignments += tokens * k
            for i, v in enumerate((busiest, dropped)):
                if type(v) is torch.Tensor and v.device.type != "meta":
                    acc = self._card.get(v.device)
                    if acc is None:
                        acc = self._card[v.device] = torch.zeros(2, dtype=torch.int64, device=v.device)
                    acc[i].add_(v)

    def snapshot(self) -> dict:
        with self._lock:
            card = [int(v) for v in sum(a.cpu() for a in self._card.values()).tolist()] if self._card else [0, 0]
            return {"forwards": self.forwards, "tokens": self.tokens, "assignments": self.assignments,
                    "busiest": card[0], "dropped": card[1]}


STATS = MoEStats()


def moe_spec(cfg, dtype) -> dict:
    """Router (d, E); ``up`` and ``gate`` (E, d, f) with std d^-1/2, ``down``
    (E, f, d) with std f^-1/2 (``fused_gate_up``: ``input_linear`` (E, 2f,
    d) and ``output_linear`` (E, d, f), as published); a shared-expert MLP
    when the config has one."""
    d, m = cfg.d_model, cfg.moe
    e, f = m.n_experts, m.d_ff_expert
    spec = {"router": dense_spec((d, e), ("embed", "experts"), dtype)}
    if m.fused_gate_up:
        spec["input_linear"] = {"w": Spec((e, 2 * f, d), dtype, ("experts", "ffn", "embed"), std=d**-0.5)}
        spec["output_linear"] = {"w": Spec((e, d, f), dtype, ("experts", "embed", "ffn"), std=f**-0.5)}
    else:
        spec["up"] = {"w": Spec((e, d, f), dtype, ("experts", "embed", "ffn"), std=d**-0.5)}
        spec["gate"] = {"w": Spec((e, d, f), dtype, ("experts", "embed", "ffn"), std=d**-0.5)}
        spec["down"] = {"w": Spec((e, f, d), dtype, ("experts", "ffn", "embed"), std=f**-0.5)}
    if m.n_shared_experts:
        spec["shared"] = mlp_spec(d, m.d_ff_shared or f * m.n_shared_experts, True, dtype)
    return spec


def moe_apply(params, x, cfg, act: str, kernels=ops.KERNELS):
    """x (B, S, D) -> (y (B, S, D), aux) through the dispatch the config
    names, inside a ``moe`` span."""
    sp = trace.ON and trace.begin("moe")
    if cfg.moe_dispatch == "dropless":
        out = moe_apply_dropless(params, x, cfg, act, kernels)
    elif cfg.moe_dispatch == "einsum":
        out = moe_apply_einsum(params, x, cfg, act)
    else:
        out = moe_apply_scatter(params, x, cfg, act)
    if sp:
        trace.finish(sp)
    return out


def route(params, x, cfg) -> tuple:
    """(probs float32 (..., E), gate_w float32 (..., k) renormalised,
    gate_i int64 (..., k)): the top k of the router's softmax in descending
    order, ties toward the lower expert index."""
    logits = x @ params["router"]["w"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gate_w, gate_i = vals[..., :k], idx[..., :k]
    return probs, gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9), gate_i


def _aux_loss(probs, gate_i, e: int):
    """Switch's load-balancing loss, E · mean_e(fraction routed top-1 to e ·
    mean router probability of e), over every token."""
    frac = F.one_hot(gate_i[..., 0].reshape(-1), e).float().mean(0)
    return e * (frac * probs.reshape(-1, e).mean(0)).mean()


def slot_positions(gate_i, e: int, cap: int) -> tuple:
    """gate_i (R, n, k) -> (expert of each slot (R, n·k), its 0-based
    position among the slots routed to that expert in token-major order, and
    whether that position is below ``cap``)."""
    flat_i = gate_i.reshape(gate_i.shape[0], -1)
    oh = F.one_hot(flat_i, e)
    pos = (oh.cumsum(1) * oh).amax(-1) - 1
    return flat_i, pos, pos < cap


def scatter_capacity(s: int, cfg) -> int:
    """Slots each expert takes per batch row of ``s`` tokens in the scatter
    dispatch: the capacity factor's share, at least 1, at most s·k."""
    m = cfg.moe
    return min(max(1, int((s * m.top_k / m.n_experts) * m.capacity_factor + 0.9999)), s * m.top_k)


def _experts(params, buf, act: str):
    """buf (E, rows, d) -> the experts' gated FFN outputs (E, rows, d)."""
    dt = buf.dtype
    if "input_linear" in params:
        gate, up = torch.bmm(buf, params["input_linear"]["w"].to(dt).transpose(1, 2)).chunk(2, dim=-1)
        return torch.bmm(ACT[act](gate) * up, params["output_linear"]["w"].to(dt).transpose(1, 2))
    h = ACT[act](torch.bmm(buf, params["gate"]["w"].to(dt))) * torch.bmm(buf, params["up"]["w"].to(dt))
    return torch.bmm(h, params["down"]["w"].to(dt))


def _shared(params, x, act: str):
    return mlp_apply(params["shared"], x, act, True) if "shared" in params else 0.0


def moe_apply_scatter(params, x, cfg, act: str):
    """x (B, S, D) -> (y, aux).  Capacity is per batch row; a dropped slot
    adds zeros at position cap - 1 and contributes nothing to y."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    cap = scatter_capacity(s, cfg)

    probs, gate_w, gate_i = route(params, x, cfg)
    aux = _aux_loss(probs, gate_i, e)
    flat_i, pos, keep = slot_positions(gate_i, e, cap)

    # row of each (token, slot) in the (E, B, cap) buffer, flattened
    rows = torch.arange(b, device=x.device)[:, None]
    slot = ((flat_i * b + rows) * cap + torch.where(keep, pos, cap - 1)).reshape(-1)
    contrib = x.repeat_interleave(k, dim=1).masked_fill(~keep[..., None], 0).reshape(-1, d)
    # on a mesh every rank scatters and gathers the flat rows whole (DTensor
    # has no sharding strategy for index_add_); the buffer and the experts'
    # outputs are laid out at the reference's sites
    buf = per_shard.replicated(lambda sl, c: c.new_zeros((e * b * cap, d)).index_add_(0, sl, c), slot, contrib)
    buf = constrain(buf.view(e, b, cap, d), BUF_AXES)

    out = constrain(_experts(params, buf.view(e, b * cap, d), act).view(e, b, cap, d), BUF_AXES)
    back = per_shard.replicated(lambda o, sl: o.reshape(-1, d).index_select(0, sl), out, slot)
    back = back.view(b, s * k, d).masked_fill(~keep[..., None], 0)
    y = (back.view(b, s, k, d) * gate_w[..., None].to(x.dtype)).sum(dim=2)
    STATS.add(b * s, k, dropped=(~keep).sum() if type(keep) is torch.Tensor else None)
    return y + _shared(params, x, act), aux


def moe_apply_einsum(params, x, cfg, act: str):
    """GShard's one-hot dispatch (arXiv:2006.16668): tokens regroup into
    (G, g) with g = min(group_size, tokens), capacity per group."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    tokens = b * s
    g = min(m.group_size, tokens)
    if tokens % g:
        raise ValueError(f"{tokens} tokens do not divide into groups of {g}")
    G = tokens // g
    cap = max(1, int((g * k / e) * m.capacity_factor + 0.9999))

    xg = constrain(x.reshape(G, g, d), ("act_batch", None, None))
    probs, gate_w, gate_i = route(params, xg, cfg)
    aux = _aux_loss(probs, gate_i, e)
    _, pos, keep = slot_positions(gate_i, e, cap)
    oh = F.one_hot(gate_i, e).float()  # (G, g, k, e)
    # a dropped slot's position one-hot is all zeros, as jax.nn.one_hot(cap, cap)
    pos_oh = F.one_hot(torch.where(keep, pos, cap).view(G, g, k), cap + 1)[..., :cap].float()
    disp = constrain(torch.einsum("Ggke,Ggkc->Ggec", oh, pos_oh).to(x.dtype), ("act_batch", None, "act_experts", None))
    comb = constrain(
        torch.einsum("Ggke,Ggkc,Ggk->Ggec", oh, pos_oh, gate_w).to(x.dtype), ("act_batch", None, "act_experts", None)
    )

    buf = constrain(torch.einsum("Ggec,Ggd->eGcd", disp, xg), BUF_AXES)
    out = constrain(_experts(params, buf.reshape(e, G * cap, d), act).view(e, G, cap, d), BUF_AXES)
    y = torch.einsum("Ggec,eGcd->Ggd", comb, out).reshape(b, s, d)
    return y + _shared(params, x, act), aux


def moe_apply_dropless(params, x, cfg, act: str, kernels=ops.KERNELS):
    """x (B, S, D) -> (y, aux) with every (token, slot) computed: see the
    module's docstring.  The experts lie as published (``fused_gate_up``).
    ``aux`` is Switch's loss on the router's softmax, as the other
    dispatches give it."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    xf = x.reshape(b * s, d)
    t = xf.shape[0]
    sr = trace.ON and trace.begin("route", leaf=True)
    logits = xf.float() @ params["router"]["w"].float()
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gate_w, gate_i = torch.softmax(top[:, :k], dim=-1), idx[:, :k]
    experts, order = torch.sort(gate_i.reshape(-1), stable=True)  # assignments by expert, then token
    offs = torch.searchsorted(experts, torch.arange(e, device=x.device), right=True, out_int32=True)
    if sr:
        trace.finish(sr)
    aux = _aux_loss(torch.softmax(logits, dim=-1), gate_i, e)
    w_in = params["input_linear"]["w"].transpose(1, 2)  # (E, d, 2f) views of the published layout
    w_out = params["output_linear"]["w"].transpose(1, 2)
    h = kernels.grouped_mm(xf.index_select(0, order // k), w_in, offs)
    gate, up = h.chunk(2, dim=-1)
    h = ACT[act](gate) * up
    del gate, up
    h = h * gate_w.reshape(-1)[order, None].to(h.dtype)
    out = kernels.grouped_mm(h, w_out, offs)
    del h
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(), device=x.device))
    y = out.index_select(0, inv).view(t, k, d).sum(dim=1).view(b, s, d)
    busiest = torch.diff(offs, prepend=offs.new_zeros(1)).max()
    STATS.add(t, k, busiest=busiest)
    return y + _shared(params, x, act), aux
