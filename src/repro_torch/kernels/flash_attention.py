"""Flash attention (causal or full, GQA) — the port of
``repro.kernels.flash_attention``.

    q (B, KV, G, S, hd), k/v (B, KV, T, hd) -> (B, KV, G, S, hd) in q's type

Scores in float32 times ``scale`` (default ``hd**-0.5``); causal masks ``qpos < kpos`` with
-1e30; softmax in float32; p rounded to v's type before the PV product.  Any
S and T (the TPU kernel needs both to divide its tiles).

For a CUDA tensor the wrapper launches the hand-written kernel
``csrc/flash_attention.cu`` (float32 or bfloat16, hd 32/64/128/256, any
strides with a contiguous head dim — the model passes permuted views of its
projections without copying, and the output takes q's memory layout; hd
224, zamba2-7b's, runs as 256 on copies of q, k and v padded with zeros,
which change no score and no output column, the output a view of the
first 224 columns) or
raises; for a CPU tensor it runs ``flash_attention_plain``.  On a card
tensor that needs a gradient the kernel's output carries the plain
version's backward (``grad.PlainBackward``).  The kernel is
bound by operations.  For bfloat16, every serving call, both products run
on the tensor cores as Hopper's ``wgmma`` (bf16 -> float32): one block of
two warpgroups per (b·kv, g, 128 query rows), two blocks per SM, q and k/v
tiles loaded by TMA from tensor maps of the views (a two-stage ring), the
softmax on the accumulator fragments in registers, p fed to the second
product from registers; its rows must be 16-byte aligned.  float32
inputs, held to 3e-5, which bf16 or TF32 products cannot meet, take a
CUDA-core kernel of float32 FMAs.  See the source for the design.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, grad

__all__ = ["HEAD_DIMS", "NEG_INF", "PADDED_HEAD_DIMS", "flash_attention", "flash_attention_plain", "launches",
           "padded_launches"]

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
PADDED_HEAD_DIMS = {224: 256}  # head dims the kernels take zero-padded to the next one they hold
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = _build.LaunchCounter("flash_attention")
padded_launches = _build.LaunchCounter("flash_attention_padded")  # of those, at a padded head dim (224)


def flash_attention_plain(q, k, v, causal: bool = True, scale=None):
    """Plain PyTorch version: the same function, with the (S, T) scores
    materialised."""
    hd = q.shape[-1]
    s, t = q.shape[3], k.shape[2]
    scores = torch.einsum("bngsh,bnth->bngst", q.float(), k.float()) * (hd**-0.5 if scale is None else scale)
    if causal:
        keep = torch.arange(s, device=q.device)[:, None] >= torch.arange(t, device=q.device)[None, :]
        scores = scores.masked_fill(~keep, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,bnth->bngsh", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def check_inputs(name: str, q, k, v, q_ndim: int) -> None:
    """Validate attention inputs for a CUDA launch: one device, one dtype the
    kernel takes, a supported head dim, contiguous head dims and matching
    (B, KV, T, hd) shapes."""
    for what, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {what} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {what} is {t.dtype}, q is {q.dtype}")
        if t.dim() != (q_ndim if what == "q" else 4):
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}")
        if t.numel() == 0:
            raise ValueError(f"{name}: {what} is empty")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {what} must have a contiguous head dim (stride {t.stride()})")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    hd = q.shape[-1]
    if hd not in HEAD_DIMS and hd not in PADDED_HEAD_DIMS:
        raise ValueError(f"{name} takes head dims {HEAD_DIMS + tuple(PADDED_HEAD_DIMS)}, got {hd}")
    b, kv = q.shape[:2]
    if k.shape != v.shape or tuple(k.shape[:2]) != (b, kv) or k.shape[3] != hd:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match k {tuple(k.shape)} / v {tuple(v.shape)}")


def _check_rows_aligned(*tensors) -> None:
    """The bfloat16 kernel copies rows in 16-byte pieces: every base address
    and every outer stride (of a dimension longer than 1) must be a multiple
    of 16 bytes."""
    for what, t in zip("qkv", tensors):
        step = t.element_size()
        outer = zip(t.shape[:-1], t.stride()[:-1])
        if t.data_ptr() % 16 or any(n > 1 and st * step % 16 for n, st in outer):
            raise ValueError(f"flash_attention: {what} rows are not 16-byte aligned (strides {t.stride()})")


def flash_attention(q, k, v, causal: bool = True, block_q: int = 512, block_k: int = 512, scale=None):
    """q: (B, KV, G, S, hd); k/v: (B, KV, T, hd) -> (B, KV, G, S, hd);
    ``scale`` the scores' (None: hd^-0.5).

    ``block_q`` and ``block_k`` keep the signature of
    ``repro.kernels.ops.flash_attention``; they size the TPU kernel's tiles
    and change nothing here (the CUDA kernel's tiles are 128 × 64 in
    bfloat16, 64 × 32 in float32)."""
    if _build.runs_plain(q):
        return flash_attention_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    if grad.needs_grad(q, k, v):
        return grad.PlainBackward.apply(_launch, flash_attention_plain, {"causal": causal, "scale": scale}, q, k, v)
    return _launch(q, k, v, causal, scale)


def pad_head_dim(t, hd: int):
    """``t`` with its head dim zero-padded to ``hd`` (a new dense tensor)."""
    return torch.nn.functional.pad(t, (0, hd - t.shape[-1]))


def _launch(q, k, v, causal: bool, scale=None):
    """The CUDA kernel on card tensors; raises on what it does not take."""
    check_inputs("flash_attention", q, k, v, 5)
    hd = q.shape[-1]
    if hd in PADDED_HEAD_DIMS:
        wide = PADDED_HEAD_DIMS[hd]
        out = _launch(pad_head_dim(q, wide), pad_head_dim(k, wide), pad_head_dim(v, wide), causal,
                      hd**-0.5 if scale is None else scale)
        padded_launches.bump()
        return out[..., :hd]
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q, k, v)
    b, kv, g, s, hd = q.shape
    t = k.shape[2]
    out = torch.empty_like(q)  # q's layout when q is a permuted dense view
    strides = np.asarray([*q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *out.stride()[:4]], np.int64)
    rc = _build.library().dacp_flash_attention(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        DTYPE_CODES[q.dtype],
        b,
        kv,
        g,
        s,
        t,
        hd,
        int(bool(causal)),
        0.0 if scale is None else float(scale),
        strides.ctypes.data,
        _build.stream_of(q),
    )
    _build.check(rc, "flash_attention")
    launches.bump()
    return out
