"""The model's RMSNorm over the last dim, in one kernel.

    x (..., W), scale (W,), eps -> (..., W) in x's type

    out = act( float(x) · rsqrt(mean over W of float(x)² + eps) · float(scale) )

``act`` is x's type.  The JAX package has no kernel here: it computes the
norm in jnp (``repro.models.layers.norm_apply``), as the port did in six
PyTorch kernels (a cast, the square, the mean, two broadcast multiplies and
the cast back), each a pass over the rows in device memory.

For a CUDA tensor the wrapper launches ``csrc/rms_norm.cu`` (x float32 or
bfloat16, scale float32 or bfloat16; W a multiple of 8 and at most 8192; the
last dim contiguous, the leading dims one stride apart, every row and the
scale on a 16-byte boundary) or raises; for a CPU tensor it runs
``rms_norm_plain``, the expressions the model ran before this kernel.  The
kernel keeps the plain version's single rounding point and its float32
arithmetic; only the order of the sum of squares differs, so it is held to
``gated_norm.ULPS``.  On card tensors that need a gradient the output
carries the plain version's backward (``grad.PlainBackward``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, grad
from repro_torch.kernels.gated_norm import DTYPE_CODES, MAX_WIDTH, ULPS, VEC

__all__ = ["MAX_WIDTH", "ULPS", "launches", "rms_norm", "rms_norm_plain"]

launches = _build.LaunchCounter("rms_norm")


def rms_norm_plain(x, scale, eps: float):
    """Plain PyTorch version: ``models.layers.norm_apply``'s RMSNorm as it
    stood."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def _rows(x):
    """x as (rows, W) with one row stride, a view of its memory; raises
    where the kernel cannot walk its rows."""
    if x.stride(-1) != 1:
        raise ValueError(f"rms_norm: the last dim must be contiguous, got strides {x.stride()}")
    try:
        return x.view(-1, x.shape[-1])
    except RuntimeError:
        raise ValueError(f"rms_norm: the leading dims of shape {tuple(x.shape)} and strides {x.stride()} "
                         "are not one stride apart") from None


def _check(x, scale):
    """Validate the inputs of a CUDA launch and return x as (rows, W);
    raise on what the kernel does not take."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"rms_norm takes float32 or bfloat16 activations, got {x.dtype}")
    if scale.dtype not in DTYPE_CODES:
        raise TypeError(f"rms_norm takes a float32 or bfloat16 scale, got {scale.dtype}")
    if type(x) is not torch.Tensor:  # a DTensor's data_ptr() is 0: it never reaches a kernel
        _build.check_tensor(x, "rms_norm: x", x.dtype, x.device, x.dim())
    _build.check_tensor(scale, "rms_norm: scale", scale.dtype, x.device, 1)
    w = x.shape[-1] if x.dim() else 0
    if w % VEC or not 0 < w <= MAX_WIDTH:
        raise ValueError(f"rms_norm: a width of {w}: it must be a multiple of {VEC} channels, at most {MAX_WIDTH}")
    if scale.shape[0] != w:
        raise ValueError(f"rms_norm: scale has shape {tuple(scale.shape)}, expected ({w},)")
    rows = _rows(x)
    if rows.shape[0] > 1 and rows.stride(0) < w:
        raise ValueError(f"rms_norm: rows {rows.stride(0)} elements apart overlap at a width of {w}")
    if x.data_ptr() % 16 or (rows.shape[0] > 1 and rows.stride(0) * x.element_size() % 16) or scale.data_ptr() % 16:
        raise ValueError("rms_norm: every row of x and the scale must start on a 16-byte boundary")
    return rows


def rms_norm(x, scale, eps: float):
    """x (..., W) float32 or bfloat16, scale (W,) -> (..., W) in x's type."""
    if _build.runs_plain(x):
        return rms_norm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cuda or cpu, got {x.device}")
    if grad.needs_grad(x, scale):
        return grad.PlainBackward.apply(_launch, rms_norm_plain, {"eps": eps}, x, scale)
    return _launch(x, scale, eps=eps)


def _launch(x, scale, eps: float):
    """The CUDA kernel on card tensors; raises on what it does not take."""
    rows = _check(x, scale)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rc = _build.library().dacp_rms_norm(
        x.data_ptr(),
        scale.data_ptr(),
        out.data_ptr(),
        DTYPE_CODES[x.dtype],
        DTYPE_CODES[scale.dtype],
        rows.shape[0],
        rows.stride(0) if rows.shape[0] > 1 else rows.shape[1],
        rows.shape[1],
        float(eps),
        _build.stream_of(x),
    )
    _build.check(rc, "rms_norm")
    launches.bump()
    return out
