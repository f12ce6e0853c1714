"""Grouped matrix products over contiguous row segments: the expert
products of the dropless MoE dispatch (``models.moe.moe_apply_dropless``).

    a (A, K), b (G, K, N), offs (G,) int32 -> (A, N) in a's type

Rows ``[offs[g-1], offs[g])`` of ``a`` (``offs[-1]`` read as 0) are
multiplied by ``b[g]``; ``offs`` is the cumulative end of each segment,
on a's device, and its last entry is A.  No TPU kernel of
``repro.kernels`` does this (the reference's MoE batches a capacity buffer
through ``einsum``).

On a card the wrapper calls PyTorch's grouped GEMM (``torch._grouped_mm``:
for bfloat16 CUTLASS's grouped kernel on Hopper, float32 accumulation,
which reads the segment ends on the card: no host sync, whatever the
routing; float32 takes PyTorch's fallback, which reads them on the host).  ``b`` may be a transposed view, (G, N, K) in memory, as the
published expert weights lie.  On CPU and meta tensors it runs
``grouped_mm_plain``, one product a segment (the segment ends read on the
host).  Bound by operations at the cell's shapes (2·A·K·N FLOPs).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["grouped_mm", "grouped_mm_plain", "launches"]

launches = _build.LaunchCounter("grouped_mm")


def grouped_mm_plain(a, b, offs):
    """Plain PyTorch version: one product a segment, in a's type."""
    out = a.new_empty((a.shape[0], b.shape[-1]))
    if a.device.type == "meta":
        return out
    start = 0
    for g, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = a[start:end] @ b[g].to(a.dtype)
        start = end
    return out


def grouped_mm(a, b, offs):
    """a (A, K) rows in segment order; b (G, K, N); offs (G,) int32 segment
    ends -> (A, N) in a's type."""
    if _build.runs_plain(a):
        return grouped_mm_plain(a, b, offs)
    if a.device.type != "cuda":
        raise ValueError(f"grouped_mm runs on cuda or cpu, got {a.device}")
    if a.dim() != 2 or b.dim() != 3 or offs.dim() != 1 or a.shape[1] != b.shape[1] or offs.shape[0] != b.shape[0]:
        raise ValueError(f"grouped_mm: a {tuple(a.shape)}, b {tuple(b.shape)}, offs {tuple(offs.shape)} do not fit")
    if offs.dtype != torch.int32 or offs.device != a.device:
        raise ValueError(f"grouped_mm: offs must be int32 on {a.device}, got {offs.dtype} on {offs.device}")
    out = torch._grouped_mm(a, b.to(a.dtype), offs=offs)
    launches.bump()
    return out
