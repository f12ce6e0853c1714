"""Segment reductions for per-morsel partial aggregation.

Port of ``repro.kernels.segment_reduce``.  ``GroupState`` factorizes a
morsel's key columns into dense group ids; these kernels fold the morsel's
value columns into per-group accumulators:

  * ``segment_sum_tiles`` — per-group sums of **8-bit limb planes** widened
    to int32 (the backend encodes them; 8 limbs per int64 column) plus the
    group counts.  Under ``SUM_ROW_CAP`` rows every limb sum stays below
    2^26, so int32 addition is exact in any order and the host recombines
    the limbs wraparound-identically to numpy.
  * ``segment_minmax_tiles`` — per-group min or max of each float32 / int32
    column (``fns`` picks per column); empty groups hold the identities
    (+inf / -inf, int32 extremes).  float32 folds through the
    order-preserving int32 key ``b >= 0 ? b : b ^ 0x7FFFFFFF``, which puts
    -0.0 below +0.0 and NaN beyond the infinities; the backend sends only
    finite float32 columns without -0.0, where that order is numpy's.

Rows at or past ``n_rows`` and group ids outside ``[0, ngroups)`` add
nothing.  Each wrapper launches its CUDA kernel (``csrc/segment_reduce.cu``)
for CUDA tensors and runs the plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = [
    "SUM_ROW_CAP",
    "segment_sum_tiles",
    "segment_sum_tiles_plain",
    "segment_minmax_tiles",
    "segment_minmax_tiles_plain",
    "sum_launches",
    "minmax_launches",
]

# 8-bit limbs: |limb| <= 255 (top limb signed, in [-128, 127]), so a sum over
# SUM_ROW_CAP rows is < 2^26 — exact in the int32 accumulator.
SUM_ROW_CAP = 262144
_F32_IDENT = {"min": 0x7F800000, "max": -2139095041}  # keys of +inf and -inf
_I32_IDENT = {"min": 2**31 - 1, "max": -(2**31)}
_MAX_GROUPS_MINMAX = 1536  # 32 columns of keys per group in 227 KB of shared memory

sum_launches = _build.LaunchCounter("segment_sum_tiles")
minmax_launches = _build.LaunchCounter("segment_minmax_tiles")


def _check_rows(n: int, tile: int, ngroups: int) -> None:
    if n % tile:
        raise ValueError(f"row count {n} is not a multiple of tile {tile}")
    if ngroups < 1:
        raise ValueError(f"ngroups must be >= 1, got {ngroups}")


def _valid_rows(gidx: torch.Tensor, n_rows: int, ngroups: int) -> torch.Tensor:
    rows = torch.arange(gidx.shape[0], device=gidx.device)
    return (rows < n_rows) & (gidx >= 0) & (gidx < ngroups)


def segment_sum_tiles_plain(gidx, limbs, n_rows, ngroups: int, tile: int = 256):
    """Plain PyTorch version of ``segment_sum_tiles``."""
    n, s = limbs.shape
    _check_rows(n, tile, ngroups)
    ok = _valid_rows(gidx, int(n_rows), ngroups)
    g = gidx[ok].to(torch.int64)
    sums = torch.zeros((ngroups, s), dtype=torch.int32, device=limbs.device).index_add_(0, g, limbs[ok])
    counts = torch.zeros((ngroups,), dtype=torch.int32, device=limbs.device)
    counts.index_add_(0, g, torch.ones_like(g, dtype=torch.int32))
    return sums, counts


def segment_sum_tiles(gidx, limbs, n_rows, ngroups: int, tile: int = 256):
    """gidx: (N,) int32 in [0, ngroups); limbs: (N, S) int32 8-bit limb
    planes; rows >= n_rows are padding.  Returns (limb sums (ngroups, S)
    int32, counts (ngroups,) int32) on the inputs' device."""
    if _build.runs_plain(limbs):
        return segment_sum_tiles_plain(gidx, limbs, n_rows, ngroups, tile)
    if limbs.device.type != "cuda":
        raise ValueError(f"segment_sum_tiles runs on cuda or cpu, got {limbs.device}")
    dev = limbs.device
    _build.check_tensor(limbs, "limbs", torch.int32, dev, 2)
    _build.check_tensor(gidx, "gidx", torch.int32, dev, 1)
    n, s = limbs.shape
    if gidx.shape[0] != n:
        raise ValueError(f"gidx has {gidx.shape[0]} rows, limbs {n}")
    _check_rows(n, tile, ngroups)
    sums = torch.zeros((ngroups, s), dtype=torch.int32, device=dev)
    counts = torch.zeros((ngroups,), dtype=torch.int32, device=dev)
    rc = _build.library().dacp_segment_sum(
        gidx.data_ptr(),
        limbs.data_ptr(),
        s,
        max(0, min(int(n_rows), n)),
        ngroups,
        sums.data_ptr(),
        counts.data_ptr(),
        _build.stream_of(limbs),
    )
    _build.check(rc, "segment_sum_tiles")
    sum_launches.bump()
    return sums, counts


def _f32_key(bits: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 key of float32 bits (its own inverse)."""
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def segment_minmax_tiles_plain(gidx, vals, n_rows, ngroups: int, fns, tile: int = 256):
    """Plain PyTorch version of ``segment_minmax_tiles``: the same key order
    and identities, so the same bits for any input."""
    n, m = vals.shape
    _check_rows(n, tile, ngroups)
    fns = tuple(fns)
    f32 = vals.dtype == torch.float32
    keys = _f32_key(vals.contiguous().view(torch.int32)) if f32 else vals
    ok = _valid_rows(gidx, int(n_rows), ngroups)
    g = gidx[ok].to(torch.int64)
    k_ok = keys[ok]
    ident = _F32_IDENT if f32 else _I32_IDENT
    cols = []
    for j, fn in enumerate(fns):
        acc = torch.full((ngroups,), ident[fn], dtype=torch.int32, device=vals.device)
        acc.scatter_reduce_(0, g, k_ok[:, j].contiguous(), "amax" if fn == "max" else "amin", include_self=True)
        cols.append(acc)
    out = torch.stack(cols, dim=1) if cols else torch.empty((ngroups, 0), dtype=torch.int32, device=vals.device)
    return _f32_key(out).view(torch.float32) if f32 else out


def segment_minmax_tiles(gidx, vals, n_rows, ngroups: int, fns, tile: int = 256):
    """gidx: (N,) int32; vals: (N, M) float32 or int32; ``fns[j]`` is "min"
    or "max" for column j.  Returns per-group reductions (ngroups, M) on the
    inputs' device; groups with no rows hold the identity."""
    fns = tuple(fns)
    if any(fn not in ("min", "max") for fn in fns):
        raise ValueError(f"fns must be 'min' or 'max', got {fns}")
    if _build.runs_plain(vals):
        return segment_minmax_tiles_plain(gidx, vals, n_rows, ngroups, fns, tile)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_minmax_tiles runs on cuda or cpu, got {vals.device}")
    dev = vals.device
    if vals.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"segment_minmax_tiles takes float32 or int32 values, got {vals.dtype}")
    _build.check_tensor(vals, "vals", vals.dtype, dev, 2)
    _build.check_tensor(gidx, "gidx", torch.int32, dev, 1)
    n, m = vals.shape
    if gidx.shape[0] != n or len(fns) != m:
        raise ValueError(f"gidx rows {gidx.shape[0]} / fns {len(fns)} do not match vals {tuple(vals.shape)}")
    _check_rows(n, tile, ngroups)
    if ngroups > _MAX_GROUPS_MINMAX:
        raise ValueError(f"segment_minmax_tiles takes at most {_MAX_GROUPS_MINMAX} groups, got {ngroups}")
    out = torch.empty((ngroups, m), dtype=vals.dtype, device=dev)
    fn_flags = np.asarray([fn == "max" for fn in fns], np.int32)
    rc = _build.library().dacp_segment_minmax(
        gidx.data_ptr(),
        vals.data_ptr(),
        m,
        max(0, min(int(n_rows), n)),
        ngroups,
        int(vals.dtype == torch.float32),
        fn_flags.ctypes.data,
        out.data_ptr(),
        _build.stream_of(vals),
    )
    _build.check(rc, "segment_minmax_tiles")
    minmax_launches.bump()
    return out
