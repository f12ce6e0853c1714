"""Public wrappers for the port's kernels, with the names and signatures
of ``repro.kernels.ops``.

Each takes torch tensors and returns tensors on their device: on a CUDA
device it launches the hand-written kernel (built from ``csrc/`` at first
use) or raises; on the CPU it runs the kernel's plain PyTorch version.
``LAUNCHES`` maps each wrapper to its thread-safe launch counter.

``ssd_scan`` and ``mlstm_chunk`` are not ported yet (ROADMAP Queue 2).
"""

from __future__ import annotations

from repro_torch.kernels import filter_select, fused_pipeline, project_arith, segment_reduce
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention import launches as _decode_launches
from repro_torch.kernels.filter_select import filter_select_planes
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import launches as _flash_launches
from repro_torch.kernels.fused_pipeline import fused_chain_tiles
from repro_torch.kernels.project_arith import project_tiles
from repro_torch.kernels.segment_reduce import SUM_ROW_CAP, segment_minmax_tiles, segment_sum_tiles

__all__ = [
    "flash_attention",
    "decode_attention",
    "filter_select_planes",
    "project_tiles",
    "segment_sum_tiles",
    "segment_minmax_tiles",
    "fused_chain_tiles",
    "SUM_ROW_CAP",
    "LAUNCHES",
]

LAUNCHES = {
    "filter_select_planes": filter_select.launches,
    "project_tiles": project_arith.launches,
    "segment_sum_tiles": segment_reduce.sum_launches,
    "segment_minmax_tiles": segment_reduce.minmax_launches,
    "fused_chain_tiles": fused_pipeline.launches,
    "flash_attention": _flash_launches,
    "decode_attention": _decode_launches,
}
