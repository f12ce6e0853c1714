"""The front of the Mamba2 and xLSTM blocks: a depthwise causal conv over
the sequence, its bias and SiLU, in one kernel.

    x (B, S, C), w (K, C), state (B, K-1, C) or None, bias (C,) or None
        -> (y (B, S, C) in x's type, the next state: the last K-1 inputs)

    y[b, t, c] = silu( bias[c] + sum_{i < K} x[b, t-(K-1)+i, c] · w[i, c] )

with the state's rows, or zeros, before t = 0.  The JAX package has no
kernel here: it computes the conv in jnp (``repro.models.layers``), as the
port did in a cat, K strided multiplies, K adds, the bias add and SiLU, each
a pass over (B, S, C) in device memory.

For a CUDA tensor the wrapper launches ``csrc/causal_conv.cu`` (x float32
or bfloat16, K from 1 to 4, any width; w, state and bias taken in x's type,
as the plain version casts them) or raises; for a CPU tensor it runs
``causal_conv_silu_plain``, the expressions the model ran before this
kernel.  The kernel keeps the plain version's rounding points and its order
of the taps' sum, so the two agree bit for bit.  The next state is a view of
x's last K-1 rows, or, where S < K-1 (a decode step), the small cat of the
state's last rows and x.  On card tensors that need a gradient y carries the
plain version's backward (``grad.PlainBackward``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, grad

__all__ = ["MAX_K", "causal_conv_silu", "causal_conv_silu_plain", "launches", "next_state"]

VEC = 8  # channels a thread holds: one 16-byte vector of bfloat16
MAX_K = 4
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = _build.LaunchCounter("causal_conv_silu")


def causal_conv_silu_plain(x, w, state=None, bias=None):
    """Plain PyTorch version: ``models.layers.causal_conv_silu``'s
    expressions as they stood.  Returns (y, the last K-1 raw inputs: the
    next state)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i : i + x.shape[1], :] * w[i].to(x.dtype) for i in range(k))
    if bias is not None:
        y = y + bias.to(x.dtype)
    return F.silu(y), (xp[:, -(k - 1) :, :] if k > 1 else None)


def _plain_y(x, w, state, bias):
    return causal_conv_silu_plain(x, w, state, bias)[0]


def next_state(x, state, k: int):
    """The last K-1 raw inputs of ``cat(state, x)`` (the plain version's next
    state): a view of x where S >= K-1, else the small cat of the state's
    last rows (zeros without a state) and x."""
    if k == 1:
        return None
    s = x.shape[1]
    if s >= k - 1:
        return x[:, s - (k - 1) :, :]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    return torch.cat([state.to(x.dtype)[:, s:, :], x], dim=1)


def _check(x, w, state, bias) -> None:
    """Validate the inputs of a CUDA launch; raise on what the kernel does not take."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"causal_conv_silu takes float32 or bfloat16 activations, got {x.dtype}")
    _build.check_tensor(x, "causal_conv_silu: x", x.dtype, x.device, 3)
    b, s, c = x.shape
    _build.check_tensor(w, "causal_conv_silu: w", x.dtype, x.device, 2)
    k = w.shape[0]
    if not 1 <= k <= MAX_K or w.shape[1] != c:
        raise ValueError(f"causal_conv_silu: w has shape {tuple(w.shape)}, expected (K, {c}) with K from 1 to {MAX_K}")
    for what, t, shape in (("state", state, (b, k - 1, c)), ("bias", bias, (c,))):
        if t is None:
            continue
        _build.check_tensor(t, f"causal_conv_silu: {what}", x.dtype, x.device, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"causal_conv_silu: {what} has shape {tuple(t.shape)}, expected {shape}")
    if x.numel() == 0:
        raise ValueError(f"causal_conv_silu: empty input {tuple(x.shape)}")


def causal_conv_silu(x, w, state=None, bias=None):
    """x (B, S, C); w (K, C); state (B, K-1, C) or None; bias (C,) or None
    -> (y (B, S, C) in x's type, the next state (B, K-1, C), None at K 1)."""
    if _build.runs_plain(x):
        return causal_conv_silu_plain(x, w, state, bias)
    if x.device.type != "cuda":
        raise ValueError(f"causal_conv_silu runs on cuda or cpu, got {x.device}")
    if grad.needs_grad(x, w, state, bias):
        y = grad.PlainBackward.apply(_launch, _plain_y, {}, x, w, state, bias)
    else:
        y = _launch(x, w, state, bias)
    return y, next_state(x, state, w.shape[0])


def _launch(x, w, state, bias):
    """The CUDA kernel on card tensors (w, state and bias in x's type, as the
    plain version casts them); raises on what it does not take."""
    w, state, bias = (None if t is None else t.to(x.dtype).contiguous() for t in (w, state, bias))
    _check(x, w, state, bias)
    b, s, c = x.shape
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    operands = [t for t in (x, w, state, bias, y) if t is not None]
    vec_io = c % VEC == 0 and all(t.data_ptr() % 16 == 0 for t in operands)
    rc = _build.library().dacp_causal_conv_silu(
        x.data_ptr(),
        w.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if state is None else state.data_ptr(),
        y.data_ptr(),
        DTYPE_CODES[x.dtype],
        b,
        s,
        c,
        w.shape[0],
        int(vec_io),
        _build.stream_of(x),
    )
    _build.check(rc, "causal_conv_silu")
    launches.bump()
    return y
