"""Public wrappers for the port's kernels, with the names and signatures
of ``repro.kernels.ops``.

Each takes torch tensors and returns tensors on their device: on a CUDA
device it launches the hand-written kernel (built from ``csrc/`` at first
use) or raises; on the CPU it runs the kernel's plain PyTorch version.
``LAUNCHES`` maps each wrapper to its thread-safe launch counter, and
counts apart the attention launches at a padded head dim and the SSD
scan's launches in B/C groups and at d_state 128.  Every
TPU kernel of ``repro.kernels`` has its wrapper here.

On card tensors that need a gradient, ``flash_attention``, ``ssd_scan``,
``mlstm_chunk``, ``gated_rmsnorm``, ``causal_conv_silu`` and ``rms_norm`` launch their kernel forward and take
the plain version's backward (``grad.PlainBackward``); ``decode_attention``
raises.

``ssd_scan`` and ``mlstm_chunk`` return their final state beside y (the
TPU kernels return y alone), because the model's prefill hands it to the
decode cache.

The model zoo calls its eight kernels through a ``ModelKernels`` bundle:
``KERNELS`` (the wrappers) unless a caller passes ``PLAIN`` (the plain
versions), which holds the kernels against their plain versions on the
card.  The bundle also carries ``decode_attention_partials``, the decode
kernel's partial (m, l, acc) that a decode over a cache sharded by position
merges across ranks (``distributed.per_shard``); its launches count with
``decode_attention``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.kernels import filter_select, fused_pipeline, project_arith, segment_reduce
from repro_torch.kernels.causal_conv import causal_conv_silu, causal_conv_silu_plain
from repro_torch.kernels.causal_conv import launches as _conv_launches
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_partials,
    decode_attention_partials_plain,
    decode_attention_plain,
)
from repro_torch.kernels.decode_attention import launches as _decode_launches
from repro_torch.kernels.decode_attention import padded_launches as _decode_padded
from repro_torch.kernels.filter_select import filter_select_planes
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention import launches as _flash_launches
from repro_torch.kernels.flash_attention import padded_launches as _flash_padded
from repro_torch.kernels.fused_pipeline import fused_chain_tiles
from repro_torch.kernels.gated_norm import gated_rmsnorm, gated_rmsnorm_plain
from repro_torch.kernels.gated_norm import launches as _gated_launches
from repro_torch.kernels.grouped_mm import grouped_mm, grouped_mm_plain
from repro_torch.kernels.grouped_mm import launches as _grouped_launches
from repro_torch.kernels.mlstm_chunk import launches as _mlstm_launches
from repro_torch.kernels.mlstm_chunk import mlstm_chunk, mlstm_chunk_plain
from repro_torch.kernels.project_arith import project_tiles
from repro_torch.kernels.rms_norm import launches as _rms_launches
from repro_torch.kernels.rms_norm import rms_norm, rms_norm_plain
from repro_torch.kernels.segment_reduce import SUM_ROW_CAP, segment_minmax_tiles, segment_sum_tiles
from repro_torch.kernels.ssd_scan import grouped_launches as _ssd_grouped
from repro_torch.kernels.ssd_scan import launches as _ssd_launches
from repro_torch.kernels.ssd_scan import wide_state_launches as _ssd_wide
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

__all__ = [
    "flash_attention",
    "decode_attention",
    "ssd_scan",
    "mlstm_chunk",
    "gated_rmsnorm",
    "causal_conv_silu",
    "grouped_mm",
    "rms_norm",
    "filter_select_planes",
    "project_tiles",
    "segment_sum_tiles",
    "segment_minmax_tiles",
    "fused_chain_tiles",
    "SUM_ROW_CAP",
    "LAUNCHES",
    "KERNELS",
    "PLAIN",
    "ModelKernels",
]

LAUNCHES = {
    "filter_select_planes": filter_select.launches,
    "project_tiles": project_arith.launches,
    "segment_sum_tiles": segment_reduce.sum_launches,
    "segment_minmax_tiles": segment_reduce.minmax_launches,
    "fused_chain_tiles": fused_pipeline.launches,
    "flash_attention": _flash_launches,
    "decode_attention": _decode_launches,
    "ssd_scan": _ssd_launches,
    "mlstm_chunk": _mlstm_launches,
    "gated_rmsnorm": _gated_launches,
    "causal_conv_silu": _conv_launches,
    "grouped_mm": _grouped_launches,  # the dropless MoE's expert products: two a MoE layer
    "rms_norm": _rms_launches,  # the model's RMSNorm: before each block, the final norm, the q/k norms
    # of the launches above: attention at a padded head dim (zamba2-7b's 224), the SSD scan in B/C groups
    # and at d_state 128 (granite-4.0-h-small's)
    "flash_attention_padded": _flash_padded,
    "decode_attention_padded": _decode_padded,
    "ssd_scan_grouped": _ssd_grouped,
    "ssd_scan_n128": _ssd_wide,
}


@dataclasses.dataclass(frozen=True)
class ModelKernels:
    """The kernel functions the model zoo calls, and the decode kernel's
    partials for a cache sharded by position."""

    flash_attention: Callable
    decode_attention: Callable
    ssd_scan: Callable
    mlstm_chunk: Callable
    decode_attention_partials: Callable
    gated_rmsnorm: Callable
    causal_conv_silu: Callable
    grouped_mm: Callable
    rms_norm: Callable


KERNELS = ModelKernels(
    flash_attention,
    decode_attention,
    ssd_scan,
    mlstm_chunk,
    decode_attention_partials,
    gated_rmsnorm,
    causal_conv_silu,
    grouped_mm,
    rms_norm,
)
PLAIN = ModelKernels(
    flash_attention_plain,
    decode_attention_plain,
    ssd_scan_plain,
    mlstm_chunk_plain,
    decode_attention_partials_plain,
    gated_rmsnorm_plain,
    causal_conv_silu_plain,
    grouped_mm_plain,
    rms_norm_plain,
)
