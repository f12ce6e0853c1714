"""Explicit collective patterns over ``torch.distributed`` — the port of
``repro.distributed.collectives``.

  * ``seq_sharded_decode_attention`` — flash-decoding across ranks: each
    rank of the mesh's ``seq_axis`` holds a slice of a long KV cache,
    computes partial (m, l, acc) over it (``partial_decode_attention``, plain
    PyTorch as in the reference, unless the caller passes another function
    of that contract, such as the decode kernel's
    ``kernels.decode_attention.decode_attention_partials``), and the partials
    merge with one ``all_reduce(MAX)`` and two ``all_reduce(SUM)`` of
    O(B·H·hd) bytes instead of gathering a multi-GB cache.
  * ``compressed_psum`` — an int8 wire format for a gradient sum over a slow
    axis: int8 payload accumulated in int32, the per-tensor scale merged by
    ``all_reduce(MAX)`` (error feedback is the caller's).

Both run over the process group of one dim of a ``DeviceMesh`` and take
either DTensors (k and v sharded over ``seq_axis`` on dim 2, q and x
replicated) or each rank's local tensors; they return the replicated
result as the rank's local tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["compressed_psum", "partial_decode_attention", "seq_sharded_decode_attention"]

NEG_INF = -1e30


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def partial_decode_attention(q, k, v, valid_len):
    """Partial softmax stats over a LOCAL kv shard.

    q: (B, KV, G, hd); k/v: (B, KV, Tlocal, hd).  Returns (m, l, acc) with
    shapes ((B,KV,G,1), (B,KV,G,1), (B,KV,G,hd)), float32 — combinable
    across shards."""
    hd = q.shape[-1]
    t = k.shape[2]
    s = torch.einsum("bngh,bnth->bngt", q, k).float() * hd**-0.5
    mask = torch.arange(t, device=q.device) < valid_len
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bngt,bnth->bngh", p.to(v.dtype), v).float()
    return m, l, acc


def seq_sharded_decode_attention(mesh, q, k, v, index, seq_axis: str = "data", partials=partial_decode_attention):
    """Decode attention with the KV cache sharded over ``seq_axis``.

    q (B, KV, G, hd) replicated over ``seq_axis``; k/v (B, KV, T, hd), the
    port's cache layout, each rank holding the contiguous slice of T at its
    coordinate on ``seq_axis``; ``index`` an int or 0-d tensor: attend to
    global positions ``<= index``.  ``partials(q, k, v, valid_len)`` makes
    each rank's (m, l, acc), as ``partial_decode_attention`` does.  Returns
    (B, KV, G, hd) in q's type, the same on every rank."""
    q_l, k_l, v_l = _local(q), _local(k), _local(v)
    group = mesh.get_group(seq_axis)
    t_local = k_l.shape[2]
    start = mesh.get_local_rank(seq_axis) * t_local
    # positions valid within this shard: global position < index + 1
    valid = min(max(int(index) + 1 - start, 0), t_local)
    m, l, acc = partials(q_l, k_l, v_l, valid)
    m_glob = m.clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_glob)
    l_sum = l * corr
    acc_sum = acc * corr
    dist.all_reduce(l_sum, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(acc_sum, op=dist.ReduceOp.SUM, group=group)
    out = acc_sum / torch.clamp(l_sum, min=1e-30)
    return out.to(q_l.dtype)


def compressed_psum(mesh, x, axis: str = "pod"):
    """int8-wire sum of every rank's ``x`` across ``axis`` (the per-tensor
    scale travels alongside); float32, the same on every rank."""
    x_l = _local(x)
    group = mesh.get_group(axis)
    # a true division, as the reference's: a CUDA division by a host scalar
    # multiplies by its reciprocal, which can round the scale differently
    amax = torch.clamp(x_l.abs().amax(), min=1e-12)
    scale = amax / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(x_l / scale), -127, 127).to(torch.int8)
    # int8 payload crosses the axis; accumulate in int32 to avoid overflow
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    scale_max = scale.float().reshape(1)
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    return total.float() * scale_max[0]
