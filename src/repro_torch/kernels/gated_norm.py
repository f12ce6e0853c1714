"""The Mamba2 mixer's output path after the SSD scan: the D skip, the SiLU
gate and the RMSNorm over each B/C group, in one kernel.

    y (b, s, h, p) f32, x (b, s, h, p), z (b, s, h·p), D (h,) f32, scale (h·p,)
        -> (b, s, h·p) in z's type

    u   = act(y + D[h] · float(x))
    g   = act(u · silu(z))
    out = act(float(g) · rsqrt(mean over the group of float(g)² + eps) · float(scale))

``act`` is the activation type (z's), in which the model holds u, silu(z)
and g; ``groups`` splits h·p into equal groups (zamba2-7b: 2 of 3584;
zamba2-1.2b: 1 of 4096, the whole row).  The JAX package has no kernel
here: it computes the chain in jnp (``repro.models.ssm``), as the port did
in a dozen PyTorch kernels, each a pass over the row in device memory.

For a CUDA tensor the wrapper launches ``csrc/gated_norm.cu`` (x, z and
the output float32 or bfloat16, scale float32 or bfloat16; each group a
multiple of 8 channels and at most 8192, the head dim a multiple of 8;
contiguous operands on 16-byte boundaries) or raises; for a CPU tensor it
runs ``gated_rmsnorm_plain``, the expressions the model ran before this
kernel.  The kernel keeps the plain version's rounding points and its
float32 arithmetic; only the order of the sum of squares differs.  On card
tensors that need a gradient the output carries the plain version's
backward (``grad.PlainBackward``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, grad

__all__ = ["MAX_WIDTH", "ULPS", "gated_rmsnorm", "gated_rmsnorm_plain", "launches", "ulps"]

VEC = 8  # channels a 16-byte vector of bfloat16 holds: a group's width and the head dim are multiples of it
MAX_WIDTH = 1024 * VEC  # one vector a thread of a 1024-thread block
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# units in the last place the kernel may differ by from the plain version, by output type: only the
# order of the sum of squares differs, which moves rsqrt's float32 result by a unit or two; bfloat16's
# rounding absorbs that but for a value next to a rounding boundary, and float32 carries it through
# two products (tests/test_torch_gated_norm.py emulates the kernel's order on the CPU)
ULPS = {torch.bfloat16: 1, torch.float32: 8}

launches = _build.LaunchCounter("gated_rmsnorm")


def ulps(a, b) -> int:
    """The largest distance between two tensors of one type, in units in
    the last place of that type (each value's place in the order of the
    type's finite values, differenced)."""

    def ordered(t):
        bits = t.detach().cpu().contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32).long()
        mag = bits & (0x7FFF if t.element_size() == 2 else 0x7FFFFFFF)
        return torch.where(bits < 0, -mag, mag)

    return int((ordered(a) - ordered(b)).abs().max())


def gated_rmsnorm_plain(y, x, z, D, scale, groups: int, eps: float):
    """Plain PyTorch version: the expressions of ``models.ssm``'s ``_out``
    and ``_gated_norm`` (and the skip of ``mamba_apply``) as they stood."""
    from repro_torch.kernels.rms_norm import rms_norm_plain  # which imports this module's constants
    from repro_torch.models.layers import merge_heads  # the models import this package first

    y = y + D[None, None, :, None] * x.float()
    y = merge_heads(y, y.shape[-2]).reshape(z.shape).to(z.dtype)
    y = y * F.silu(z)
    if groups == 1:
        return rms_norm_plain(y, scale, eps)
    yf = y.float().unflatten(-1, (groups, -1))
    yf = yf * torch.rsqrt(yf.square().mean(dim=-1, keepdim=True) + eps)
    return (yf.flatten(-2) * scale.float()).to(y.dtype)


def _check(y, x, z, D, scale, groups: int) -> None:
    """Validate the inputs of a CUDA launch; raise on what the kernel does not take."""
    if z.dtype not in DTYPE_CODES:
        raise TypeError(f"gated_rmsnorm takes float32 or bfloat16 activations, got {z.dtype}")
    if scale.dtype not in DTYPE_CODES:
        raise TypeError(f"gated_rmsnorm takes a float32 or bfloat16 scale, got {scale.dtype}")
    _build.check_tensor(y, "gated_rmsnorm: y", torch.float32, z.device, 4)
    b, s, h, p = y.shape
    d = h * p
    for what, t, dtype, shape in (
        ("x", x, z.dtype, (b, s, h, p)),
        ("z", z, z.dtype, (b, s, d)),
        ("D", D, torch.float32, (h,)),
        ("scale", scale, scale.dtype, (d,)),
    ):
        _build.check_tensor(t, f"gated_rmsnorm: {what}", dtype, z.device, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"gated_rmsnorm: {what} has shape {tuple(t.shape)}, expected {shape}")
    if groups < 1 or d % groups or (d // groups) % VEC or d // groups > MAX_WIDTH or p % VEC:
        raise ValueError(f"gated_rmsnorm: {groups} groups over {d} channels (heads of {p}): each group and the "
                         f"head dim must be a multiple of {VEC} channels, a group at most {MAX_WIDTH}")
    if y.numel() == 0:
        raise ValueError(f"gated_rmsnorm: empty input {tuple(y.shape)}")
    if any(t.data_ptr() % 16 for t in (y, x, z, scale)):
        raise ValueError("gated_rmsnorm: y, x, z and scale must start on a 16-byte boundary")


def gated_rmsnorm(y, x, z, D, scale, groups: int, eps: float):
    """y (b, s, h, p) f32; x (b, s, h, p) and z (b, s, h·p) in the
    activation type; D (h,) f32; scale (h·p,) -> (b, s, h·p) in z's type."""
    if _build.runs_plain(y):
        return gated_rmsnorm_plain(y, x, z, D, scale, groups, eps)
    if y.device.type != "cuda":
        raise ValueError(f"gated_rmsnorm runs on cuda or cpu, got {y.device}")
    kwargs = {"groups": groups, "eps": eps}
    if grad.needs_grad(y, x, z, D, scale):
        return grad.PlainBackward.apply(_launch, gated_rmsnorm_plain, kwargs, y, x, z, D, scale)
    return _launch(y, x, z, D, scale, **kwargs)


def _launch(y, x, z, D, scale, groups: int, eps: float):
    """The CUDA kernel on card tensors; raises on what it does not take."""
    _check(y, x, z, D, scale, groups)
    b, s, h, p = y.shape
    out = torch.empty(z.shape, dtype=z.dtype, device=z.device)
    rc = _build.library().dacp_gated_rmsnorm(
        y.data_ptr(),
        x.data_ptr(),
        z.data_ptr(),
        D.data_ptr(),
        scale.data_ptr(),
        out.data_ptr(),
        DTYPE_CODES[z.dtype],
        DTYPE_CODES[scale.dtype],
        b * s,
        h * p,
        groups,
        p,
        float(eps),
        _build.stream_of(y),
    )
    _build.check(rc, "gated_rmsnorm")
    launches.bump()
    return out
