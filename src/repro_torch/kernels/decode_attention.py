"""Decode attention (one query token per head against a KV cache) — the
port of ``repro.kernels.decode_attention``.

    q (B, KV, G, hd), k/v (B, KV, T, hd), length -> (B, KV, G, hd) in q's type

Scores are q·k times ``scale`` (default hd^-0.5).
Positions ``>= length`` are masked with -1e30; scores, softmax and the
accumulation are float32; p is rounded to v's type before the PV product.
With ``length == 0`` the output is zero, as the TPU kernel's is.  Any T (the
TPU kernel needs T to divide its tile).

For a CUDA tensor the wrapper launches the hand-written kernels of
``csrc/decode_attention.cu`` (float32 or bfloat16, hd 32/64/128/256, G at
most 32, q/k/v with any strides and a contiguous head dim; hd 224 runs as
256 on zero-padded copies of q and of the cache's first ``length``
positions, as ``flash_attention`` pads) or raises; for a
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

``decode_attention_partials`` runs the same launch and hands out the
chunks' merged partial (m, l, acc) over positions ``< length`` instead of
the output: the building block of the decode over a cache sharded by
position (``distributed.collectives.seq_sharded_decode_attention``), whose
ranks merge their partials with one all-reduce MAX and two SUM.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import _build, grad
from repro_torch.kernels.flash_attention import DTYPE_CODES, NEG_INF, PADDED_HEAD_DIMS, check_inputs, pad_head_dim

__all__ = [
    "MAX_GROUP",
    "MAX_SPLITS",
    "TILE",
    "decode_attention",
    "decode_attention_partials",
    "decode_attention_partials_plain",
    "decode_attention_plain",
    "launches",
    "padded_launches",
    "split_plan",
]

TILE = 64  # kv rows per tile of the CUDA kernel
MAX_GROUP = 32  # query heads per kv head that the CUDA kernel holds
MAX_SPLITS = 16  # chunks per b·kv: the bf16 kernel's cluster holds one block per chunk

launches = _build.LaunchCounter("decode_attention")
padded_launches = _build.LaunchCounter("decode_attention_padded")  # of those, at a padded head dim (224)


def decode_attention_plain(q, k, v, length, scale=None):
    """Plain PyTorch version: the same function over the whole cache."""
    length = int(length)
    if length <= 0:
        return torch.zeros_like(q)
    hd = q.shape[-1]
    t = k.shape[2]
    scores = torch.einsum("bngh,bnth->bngt", q.float(), k.float()) * (hd**-0.5 if scale is None else scale)
    keep = torch.arange(t, device=q.device) < length
    scores = scores.masked_fill(~keep, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngt,bnth->bngh", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _empty_partials(q):
    """(m, l, acc) of a slice with no position to attend to: m = -1e30 and
    l = acc = 0, which weigh nothing in a merge with any slice that has one."""
    b, kv, g, hd = q.shape
    m = torch.full((b, kv, g, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kv, g, 1), dtype=torch.float32, device=q.device)
    return m, l, torch.zeros((b, kv, g, hd), dtype=torch.float32, device=q.device)


def decode_attention_partials_plain(q, k, v, length, scale=None):
    """Plain PyTorch version of ``decode_attention_partials``, in
    ``decode_attention_plain``'s float32 arithmetic."""
    length = int(length)
    if length <= 0:
        return _empty_partials(q)
    hd = q.shape[-1]
    t = k.shape[2]
    s = torch.einsum("bngh,bnth->bngt", q.float(), k.float()) * (hd**-0.5 if scale is None else scale)
    s = s.masked_fill(~(torch.arange(t, device=q.device) < length), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bngt,bnth->bngh", p.to(v.dtype).float(), v.float())
    return m, l, acc


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


def _checked(name: str, q, k, v, length) -> int:
    """``length`` as an int, after the checks of a CUDA launch."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {q.device}")
    grad.refuse(name, q, k, v)  # on no training path: no gradient
    check_inputs(name, q, k, v, 4)
    t = k.shape[2]
    length = int(length)
    if not 0 <= length <= t:
        raise ValueError(f"{name}: length {length} outside [0, {t}]")
    if q.shape[2] > MAX_GROUP:
        raise ValueError(f"{name} holds at most {MAX_GROUP} query heads per kv head, got {q.shape[2]}")
    return length


def _launch(entry: str, q, k, v, length: int, outs: tuple, scale=None) -> None:
    """One launch of ``entry`` over positions ``< length`` (> 0), writing
    ``outs`` (the output, or m, l, acc), with the split-K scratch."""
    b, kv, g, hd = q.shape
    if hd in PADDED_HEAD_DIMS:  # zero columns change no score, and their outputs are dropped
        wide = PADDED_HEAD_DIMS[hd]
        outs_w = [torch.empty((*o.shape[:-1], wide), dtype=o.dtype, device=o.device) if o.shape[-1] == hd else o
                  for o in outs]
        _launch(entry, pad_head_dim(q, wide), pad_head_dim(k[:, :, :length], wide),
                pad_head_dim(v[:, :, :length], wide), length, tuple(outs_w), hd**-0.5 if scale is None else scale)
        for o, w in zip(outs, outs_w):
            if w is not o:
                o.copy_(w[..., :hd])
        padded_launches.bump()
        return
    splits, chunk = split_plan(b * kv, length, _sm_count(q.device.index))
    part_m = torch.empty((splits, b * kv, g), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((splits, b * kv, g, hd), dtype=torch.float32, device=q.device)
    strides = np.asarray([*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]], np.int64)
    rc = getattr(_build.library(), entry)(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        *(o.data_ptr() for o in outs),
        DTYPE_CODES[q.dtype],
        b,
        kv,
        g,
        k.shape[2],
        hd,
        length,
        chunk,
        splits,
        0.0 if scale is None else float(scale),
        strides.ctypes.data,
        part_m.data_ptr(),
        part_l.data_ptr(),
        part_acc.data_ptr(),
        _build.stream_of(q),
    )
    _build.check(rc, entry)
    launches.bump()


def decode_attention(q, k, v, length, block_k: int = 1024, scale=None):
    """q: (B, KV, G, hd); k/v: (B, KV, T, hd); length: int or 0-d tensor,
    attend to positions < length; ``scale`` the scores' (None: hd^-0.5).

    ``block_k`` keeps the signature of ``repro.kernels.ops.decode_attention``;
    it sizes the TPU kernel's tile and changes nothing here."""
    if _build.runs_plain(q):
        return decode_attention_plain(q, k, v, length, scale)
    length = _checked("decode_attention", q, k, v, length)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if length == 0:
        return out.zero_()
    _launch("dacp_decode_attention", q, k, v, length, (out,), scale)
    return out


def decode_attention_partials(q, k, v, length, scale=None):
    """The partial softmax state over positions ``< length`` of this slice of
    the cache, combinable across slices: q (B, KV, G, hd), k/v (B, KV, T,
    hd) -> m, l (B, KV, G, 1) and acc (B, KV, G, hd), float32.  m is the
    largest score (q·k times hd^-0.5, natural units), l = Σ e^(s - m) over
    the unrounded p, acc = Σ p·v with p rounded to v's type.  The contract
    of ``distributed.collectives.partial_decode_attention``.

    With ``length == 0`` nothing is launched and (m, l, acc) = (-1e30, 0,
    0), which drops out of any merge with a slice that has a position.  The
    reference's partials of an empty slice hold l = T and acc = Σ v instead
    (every score masked to the same -1e30): the two merge alike unless every
    slice is empty, where the reference's average of v is an artefact and
    this gives zeros, as ``decode_attention`` does at length 0.  One launch,
    counted with ``decode_attention``'s."""
    if _build.runs_plain(q):
        return decode_attention_partials_plain(q, k, v, length, scale)
    length = _checked("decode_attention_partials", q, k, v, length)
    if length == 0:
        return _empty_partials(q)
    b, kv, g, hd = q.shape
    m = torch.empty((b, kv, g, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, kv, g, hd), dtype=torch.float32, device=q.device)
    _launch("dacp_decode_attention_partials", q, k, v, length, (m, l, acc), scale)
    return m, l, acc
