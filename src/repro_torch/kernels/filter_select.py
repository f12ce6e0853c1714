"""Fused columnar Filter+Select over int32 bit-planes.

Port of ``repro.kernels.filter_select.filter_select_planes``: for each tile
of rows, the predicate ``col <op> threshold`` is evaluated on the predicate
column's planes (float32 through the bit pattern with IEEE NaN / ±0
semantics, int32 directly, int64 as a two-word hi / sign-flipped-lo
compare), rows at or past ``n_rows`` are masked, and the survivors' planes
move to the front of their tile in row order with the rest of the tile
zero.  A count per tile rides along.  Bits move unchanged, so every
fixed-width dtype survives exactly.

``filter_select_planes`` launches the CUDA kernel (``csrc/filter_select.cu``)
for tensors on a CUDA device and runs ``filter_select_planes_plain`` — the
same function in plain PyTorch — for tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["OPS", "KINDS", "filter_select_planes", "filter_select_planes_plain", "launches"]

OPS = ("lt", "le", "gt", "ge", "eq", "ne")
KINDS = ("f32", "i32", "i64")
_INT32_SIGN = -(2**31)  # xor flips the sign bit: signed cmp == unsigned cmp

_CMP = {
    "lt": torch.lt,
    "le": torch.le,
    "gt": torch.gt,
    "ge": torch.ge,
    "eq": torch.eq,
    "ne": torch.ne,
}

launches = _build.LaunchCounter("filter_select_planes")


def _scalars(scalars) -> tuple:
    """``[n_rows, t_hi bits, t_lo bits]`` as Python ints (host data: the
    kernel takes them as arguments)."""
    if isinstance(scalars, torch.Tensor):
        scalars = scalars.cpu().numpy()
    n_rows, t_hi, t_lo = (int(v) for v in np.asarray(scalars).reshape(-1)[:3])
    return n_rows, _as_i32(t_hi), _as_i32(t_lo)


def _as_i32(v: int) -> int:
    return ((v + 2**31) % 2**32) - 2**31


def _check_args(n: int, tile: int, op: str, kind: str, p: int) -> None:
    if op not in OPS:
        raise ValueError(f"unknown comparison {op!r}; expected one of {OPS}")
    if kind not in KINDS:
        raise ValueError(f"unknown predicate kind {kind!r}; expected one of {KINDS}")
    if tile <= 0 or tile > 1024 or tile % 32:
        raise ValueError(f"tile must be a multiple of 32 in [32, 1024], got {tile}")
    if n % tile:
        raise ValueError(f"row count {n} is not a multiple of tile {tile}")
    if p < (2 if kind == "i64" else 1):
        raise ValueError(f"{kind} predicate needs {2 if kind == 'i64' else 1} planes, got {p}")


def _pred_mask(pred: torch.Tensor, t_hi: int, t_lo: int, op: str, kind: str) -> torch.Tensor:
    cmp = _CMP[op]
    if kind == "f32":
        x = pred[:, 0].contiguous().view(torch.float32)
        thr = torch.tensor([t_hi], dtype=torch.int32, device=pred.device).view(torch.float32)[0]
        return cmp(x, thr)
    if kind == "i32":
        return cmp(pred[:, 0], t_hi)
    hi = pred[:, 0]
    lo = pred[:, 1] ^ _INT32_SIGN
    if op == "eq":
        return (hi == t_hi) & (lo == t_lo)
    if op == "ne":
        return (hi != t_hi) | (lo != t_lo)
    lt = (hi < t_hi) | ((hi == t_hi) & (lo < t_lo))
    if op == "lt":
        return lt
    if op == "ge":
        return ~lt
    gt = (hi > t_hi) | ((hi == t_hi) & (lo > t_lo))
    return gt if op == "gt" else ~gt


def filter_select_planes_plain(pred_planes, table, scalars, op: str = "gt", kind: str = "f32", tile: int = 256):
    """Plain PyTorch version of the kernel: the same outputs, bit for bit,
    on any device."""
    n, d = table.shape
    _check_args(n, tile, op, kind, pred_planes.shape[1])
    n_rows, t_hi, t_lo = _scalars(scalars)
    rows = torch.arange(n, device=table.device)
    mask = _pred_mask(pred_planes, t_hi, t_lo, op, kind) & (rows < n_rows)
    per_tile = mask.view(-1, tile)
    counts = per_tile.sum(dim=1, dtype=torch.int32)
    slot = torch.cumsum(per_tile.to(torch.int32), dim=1) - 1
    tile_base = torch.arange(n // tile, device=table.device).unsqueeze(1) * tile
    dest = (tile_base + slot).reshape(-1)[mask]
    out = torch.zeros_like(table)
    out[dest] = table[mask]
    return out, counts


def filter_select_planes(pred_planes, table, scalars, op: str = "gt", kind: str = "f32", tile: int = 256):
    """pred_planes: (N, P) int32; table: (N, D) int32 bit-planes of the
    output columns; scalars: ``[n_rows, t_hi bits, t_lo bits]`` on the host.
    Returns (per-tile-compacted (N, D) int32 planes, counts (N // tile,)
    int32) on the inputs' device."""
    if _build.runs_plain(table):
        return filter_select_planes_plain(pred_planes, table, scalars, op, kind, tile)
    if table.device.type != "cuda":
        raise ValueError(f"filter_select_planes runs on cuda or cpu, got {table.device}")
    dev = table.device
    _build.check_tensor(table, "table", torch.int32, dev, 2)
    _build.check_tensor(pred_planes, "pred_planes", torch.int32, dev, 2)
    n, d = table.shape
    if pred_planes.shape[0] != n:
        raise ValueError(f"pred_planes has {pred_planes.shape[0]} rows, table {n}")
    _check_args(n, tile, op, kind, pred_planes.shape[1])
    n_rows, t_hi, t_lo = _scalars(scalars)
    out = torch.empty((n, d), dtype=torch.int32, device=dev)
    counts = torch.empty((n // tile,), dtype=torch.int32, device=dev)
    if n == 0:
        return out, counts
    rc = _build.library().dacp_filter_select_planes(
        pred_planes.data_ptr(),
        pred_planes.shape[1],
        table.data_ptr(),
        d,
        n,
        tile,
        max(0, min(n_rows, n)),
        t_hi,
        t_lo,
        OPS.index(op),
        KINDS.index(kind),
        out.data_ptr(),
        counts.data_ptr(),
        _build.stream_of(table),
    )
    _build.check(rc, "filter_select_planes")
    launches.bump()
    return out, counts
