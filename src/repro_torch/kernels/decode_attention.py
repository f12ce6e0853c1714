"""Decode attention (one query token per head against a KV cache) — the
port of ``repro.kernels.decode_attention``.

    q (B, KV, G, hd), k/v (B, KV, T, hd), length -> (B, KV, G, hd) in q's type

Positions ``>= length`` are masked with -1e30; scores, softmax and the
accumulation are float32; p is rounded to v's type before the PV product.
With ``length == 0`` the output is zero, as the TPU kernel's is.  Any T (the
TPU kernel needs T to divide its tile).

For a CUDA tensor the wrapper launches the hand-written kernels of
``csrc/decode_attention.cu`` (float32 or bfloat16, hd 32/64/128/256, G at
most 32, q/k/v with any strides and a contiguous head dim) or raises; for a
CPU tensor it runs ``decode_attention_plain``.  It is on no training path
and has no gradient: on the card it raises for inputs that need one
(``grad.refuse``).  The work is bound by bytes
(each step reads the cache up to ``length`` once), so the kernel splits the
positions into chunks, one block per (chunk, b·kv), up to two blocks on
each SM in one wave (at most ``MAX_SPLITS`` chunks), and the chunks' partial (m, l,
acc) land in scratch the wrapper allocates.  Which kernel runs is decided by
dtype: bfloat16 runs both products on the tensor cores and merges the
partials in the same launch, the chunks of one b·kv forming a thread block
cluster; float32 runs on the CUDA cores, where its 3e-5 tolerance keeps it,
and a second kernel merges the partials.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import _build, grad
from repro_torch.kernels.flash_attention import DTYPE_CODES, NEG_INF, check_inputs

__all__ = ["MAX_GROUP", "MAX_SPLITS", "TILE", "decode_attention", "decode_attention_plain", "launches", "split_plan"]

TILE = 64  # kv rows per tile of the CUDA kernel
MAX_GROUP = 32  # query heads per kv head that the CUDA kernel holds
MAX_SPLITS = 16  # chunks per b·kv: the bf16 kernel's cluster holds one block per chunk

launches = _build.LaunchCounter("decode_attention")


def decode_attention_plain(q, k, v, length):
    """Plain PyTorch version: the same function over the whole cache."""
    length = int(length)
    if length <= 0:
        return torch.zeros_like(q)
    hd = q.shape[-1]
    t = k.shape[2]
    scores = torch.einsum("bngh,bnth->bngt", q.float(), k.float()) * hd**-0.5
    keep = torch.arange(t, device=q.device) < length
    scores = scores.masked_fill(~keep, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngt,bnth->bngh", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(bkv: int, length: int, sms: int) -> tuple:
    """(splits, chunk): chunks of whole tiles over ``[0, length)``, as many
    as two blocks per SM over ``bkv`` (batch × kv heads) allow in one wave,
    at most ``MAX_SPLITS``."""
    tiles = -(-length // TILE)
    want = min(MAX_SPLITS, max(1, 2 * sms // bkv))
    chunk = -(-tiles // min(tiles, want)) * TILE
    return -(-length // chunk), chunk


def decode_attention(q, k, v, length, block_k: int = 1024):
    """q: (B, KV, G, hd); k/v: (B, KV, T, hd); length: int or 0-d tensor,
    attend to positions < length.

    ``block_k`` keeps the signature of ``repro.kernels.ops.decode_attention``;
    it sizes the TPU kernel's tile and changes nothing here."""
    if _build.runs_plain(q):
        return decode_attention_plain(q, k, v, length)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, got {q.device}")
    grad.refuse("decode_attention", q, k, v)  # on no training path: no gradient
    check_inputs("decode_attention", q, k, v, 4)
    b, kv, g, hd = q.shape
    t = k.shape[2]
    length = int(length)
    if not 0 <= length <= t:
        raise ValueError(f"decode_attention: length {length} outside [0, {t}]")
    if g > MAX_GROUP:
        raise ValueError(f"decode_attention holds at most {MAX_GROUP} query heads per kv head, got {g}")
    out = torch.empty((b, kv, g, hd), dtype=q.dtype, device=q.device)
    if length == 0:
        return out.zero_()
    splits, chunk = split_plan(b * kv, length, _sm_count(q.device.index))
    part_m = torch.empty((splits, b * kv, g), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((splits, b * kv, g, hd), dtype=torch.float32, device=q.device)
    strides = np.asarray([*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]], np.int64)
    rc = _build.library().dacp_decode_attention(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        DTYPE_CODES[q.dtype],
        b,
        kv,
        g,
        t,
        hd,
        length,
        chunk,
        splits,
        strides.ctypes.data,
        part_m.data_ptr(),
        part_l.data_ptr(),
        part_acc.data_ptr(),
        _build.stream_of(q),
    )
    _build.check(rc, "decode_attention")
    launches.bump()
    return out
