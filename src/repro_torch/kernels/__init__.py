"""Hand-written CUDA kernels of the port (Hopper, ``sm_90a``).

    filter_select     — fused Filter+Select over int32 bit-planes
    project_arith     — projection arithmetic as a postfix program per row
    segment_reduce    — per-group limb sums, counts and min/max
    fused_pipeline    — filter → project → compaction → segment fold in
                        one launch per morsel
    flash_attention   — causal or full GQA attention (prefill)
    decode_attention  — one query token against a KV cache (decode)
    ssd_scan          — the Mamba2 SSD chunk scan, returning the final state
    mlstm_chunk       — the chunkwise mLSTM, returning the final (C, n, m)
    gated_norm        — the Mamba2 mixer's D skip, SiLU gate and grouped
                        RMSNorm after the scan, in one pass
    causal_conv       — the depthwise causal conv, its bias and SiLU at the
                        front of the Mamba2 and xLSTM blocks, in one pass
    rms_norm          — the model's RMSNorm over the last dim, in one pass
                        (the wrapper is ``ops.rms_norm``; the package's
                        ``rms_norm`` is this module)
    grouped_mm        — the dropless MoE's expert products over contiguous
                        row segments (PyTorch's grouped GEMM on the card,
                        not a kernel of this package)

Every TPU kernel of ``repro.kernels`` has its CUDA counterpart here;
``gated_norm``, ``causal_conv`` and ``rms_norm`` replace chains the JAX
package leaves to jnp.

Importing this package builds nothing: the kernels compile at their first
CUDA launch (``_build``).  Each wrapper runs its plain PyTorch version for
tensors on the CPU.
"""

from repro_torch.kernels import ops
from repro_torch.kernels.ops import (
    causal_conv_silu,
    decode_attention,
    filter_select_planes,
    flash_attention,
    fused_chain_tiles,
    gated_rmsnorm,
    grouped_mm,
    mlstm_chunk,
    project_tiles,
    segment_minmax_tiles,
    segment_sum_tiles,
    ssd_scan,
)

__all__ = [
    "ops",
    "filter_select_planes",
    "project_tiles",
    "segment_sum_tiles",
    "segment_minmax_tiles",
    "fused_chain_tiles",
    "flash_attention",
    "decode_attention",
    "ssd_scan",
    "mlstm_chunk",
    "gated_rmsnorm",
    "causal_conv_silu",
    "grouped_mm",
]
