"""The model kernels on DTensors: each rank runs the kernel on its own shard.

Attention and the two scans are independent across the batch and across
heads, the gated RMSNorm across the batch (its group spans heads), the
depthwise causal conv across the batch and channels and the RMSNorm across
every dim but its last, so
on a mesh each rank can call the kernel wrapper (the CUDA kernel on a
card, the plain version on the CPU or on meta tensors) on its local slice:
the SPMD lowering the reference's compiler performs.  ``run`` lays
every operand out so that the mesh dims sharding the leading operand's
batch or head dim shard the same role in every operand, replicates the
rest, calls the wrapper on the local tensors and wraps its outputs back as
DTensors.  ``on_shards`` puts the model kernels of a ``ModelKernels``
bundle behind ``run`` with their dim maps (``models.build`` does so for
every bundle); plain tensors go straight to the kernel, and any DTensor
operand sends the call through ``run``.  The gated
RMSNorm's map names the batch alone, so ``run`` gathers the heads that a
mesh splits (zamba2-1.2b's one group spans all of them) and moves nothing
when the operands are replicated.  The conv's map keeps batch and
channels sharded and gathers nothing but a sharded sequence, which its
callers never hand it.  The RMSNorm's map names every dim but the last:
each row is whole on a rank, and ``run`` gathers a last dim that a mesh
splits before the kernel, as it gathers the gated norm's heads.

A KV cache whose positions are sharded (``cache_seq_long``) runs the
flash-decoding merge of ``collectives.seq_sharded_decode_attention`` over
that mesh dim instead of gathering the cache.  On card tensors each rank's
partial (m, l, acc) comes from the bundle's ``decode_attention_partials``
(the decode kernel, one launch a rank); on CPU and meta tensors from the
plain ``collectives.partial_decode_attention``, as the reference's do.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import cost_site
from repro_torch.kernels import _build
from repro_torch.kernels.ops import ModelKernels

__all__ = ["is_dtensor", "on_shards", "replicated", "run", "write_at"]


def is_dtensor(t) -> bool:
    if type(t) is torch.Tensor:  # the common case, without importing DTensor
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def run(fn, args: tuple, dims: tuple, out_dims: tuple, lead: int = 0, seq_merge=None):
    """``fn(*local args)`` on every rank's shard.  ``dims[i]`` maps the roles
    of ``args[i]`` ("batch", "heads", "seq") to its tensor dims, and
    ``out_dims`` those of each output (one dict per output, a tuple of
    outputs when ``fn`` returns one).  The mesh dims that shard a role dim
    of ``args[lead]`` shard that role everywhere.  A None operand or output
    passes through as None.  A mesh dim sharding the
    "seq" role calls ``seq_merge(mesh, axis name, *local args)`` in place
    of ``fn``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = args[lead].device_mesh
    by_dim = {d: role for role, d in dims[lead].items()}
    roles = [by_dim.get(p.dim) if p.is_shard() else None for p in args[lead].placements]

    def placements(dmap: dict) -> tuple:
        return tuple(Shard(dmap[r]) if r in dmap else Replicate() for r in roles)

    local = []
    for a, dmap in zip(args, dims):
        if a is None:  # an optional operand left out
            local.append(None)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        want = placements(dmap)
        if tuple(a.placements) != want:
            a = a.redistribute(mesh, want)
        local.append(a.to_local())
    seq_axes = [mesh.mesh_dim_names[i] for i, r in enumerate(roles) if r == "seq"]
    if len(seq_axes) > 1:
        raise ValueError(f"positions sharded over more than one mesh axis: {seq_axes}")
    out = seq_merge(mesh, seq_axes[0], *local) if seq_axes else fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = tuple(
        None if o is None else DTensor.from_local(o, mesh, placements(dmap), run_check=False)
        for o, dmap in zip(outs, out_dims, strict=True)
    )
    return wrapped[0] if single else wrapped


def write_at(cache, new, index: int, dim: int) -> None:
    """``cache``'s position ``index`` along ``dim`` set to ``new`` (the
    cache's shape without ``dim``), in place, for a DTensor cache: ``new`` is
    laid out as the cache on its other dims, and only the ranks whose slice
    of ``dim`` holds ``index`` write, into their local tensor.  A cache
    sharded along ``dim`` (a long context's positions) is not gathered."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = cache.device_mesh
    want = tuple(
        Replicate() if p.is_shard(dim) else Shard(p.dim - 1) if p.is_shard() and p.dim > dim else p
        for p in cache.placements
    )
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(new.placements) != want:
        new = new.redistribute(mesh, want)
    start, size = 0, cache.shape[dim]
    coord = mesh.get_coordinate()
    for i, p in enumerate(cache.placements):  # nested splits of dim, major to minor in mesh order
        if p.is_shard(dim):
            size //= mesh.size(i)
            start += coord[i] * size
    if start <= index < start + size:
        cache.to_local().select(dim, index - start).copy_(new.to_local())


def replicated(fn, *args):
    """``fn(*args)``; when any of ``args`` is a DTensor, every rank runs ``fn``
    on the whole (replicated) operands and the result is a replicated
    DTensor: for an op DTensor has no sharding strategy for.  The forward's
    work is filed under the cost site "replicated"."""
    lead = next((i for i, a in enumerate(args) if is_dtensor(a)), None)
    if lead is None:
        return fn(*args)
    with cost_site("replicated"):  # work GSPMD would not run: counted apart by the dry-run
        return run(fn, args, ({},) * len(args), ({},), lead=lead)


_Q = {"batch": 0, "heads": 1, "groups": 2}  # (B, KV, G, ...) queries and outputs
_BH = {"batch": 0, "heads": 2}  # (b, s, h, ...)
_ST = {"batch": 0, "heads": 1}  # (b, h, ...) states
_B = {"batch": 0}  # a group spans heads: only the batch stays sharded
_BC = {"batch": 0, "channels": 2}  # (B, S, C) of the depthwise conv: each channel stands alone
# kernel: (each tensor operand's roles, each output's roles, the operand whose layout leads)
_ROLES = {
    "flash_attention": ((_Q, _ST, _ST), (_Q,), 0),
    "decode_attention": ((_Q, dict(_ST, seq=2), dict(_ST, seq=2)), (_Q,), 1),
    "ssd_scan": ((_BH, _BH, {"heads": 0}, {"batch": 0}, {"batch": 0}), (_BH, _ST), 0),
    "mlstm_chunk": ((_BH,) * 5, (_BH, _ST, _ST, _ST), 0),
    "gated_rmsnorm": ((_B, _B, _B, {}, {}), (_B,), 0),
    "causal_conv_silu": ((_BC, {"channels": 1}, _BC, {"channels": 0}), (_BC, _BC), 0),
    # the expert products' rows are the routing's order, not the batch's: every rank runs them whole
    "grouped_mm": (({}, {}, {}), ({},), 0),
}


def _decode_merge(length, partials):
    def merge(mesh, axis, q, k, v):  # positions sharded: flash-decoding across ranks
        make = collectives.partial_decode_attention if _build.runs_plain(k) else partials
        return collectives.seq_sharded_decode_attention(mesh, q, k, v, int(length) - 1, seq_axis=axis, partials=make)

    return merge


def _sharded(name: str, fn, partials):
    dims, out_dims, lead = _ROLES[name]
    n = len(dims)

    def call(*args, **kwargs):
        # the leading operand's layout leads; where it is a plain tensor, the first DTensor operand's
        # (a decode step's conv state is a DTensor before the stream it convolves becomes one)
        first = lead if is_dtensor(args[lead]) else next((i for i, a in enumerate(args[:n]) if is_dtensor(a)), None)
        if first is None:
            return fn(*args, **kwargs)
        rest = args[n:]
        merge = None
        if name == "decode_attention":
            merge = _decode_merge(rest[0] if rest else kwargs["length"], partials)
        return run(lambda *local: fn(*local, *rest, **kwargs), args[:n], dims, out_dims, lead=first, seq_merge=merge)

    return call


def _rms_norm(fn):
    def call(x, scale, eps):
        lead = 0 if is_dtensor(x) else 1 if is_dtensor(scale) else None
        if lead is None:
            return fn(x, scale, eps)
        rows = {i: i for i in range(x.dim() - 1)}  # each row stands alone: the leading dims keep their shards
        return run(lambda lx, ls: fn(lx, ls, eps), (x, scale), (rows, {}), (rows,), lead=lead)

    return call


def on_shards(kernels: ModelKernels) -> ModelKernels:
    """``kernels`` with each model kernel run per rank on DTensor operands;
    ``decode_attention_partials`` stays as it is and makes the ranks'
    partials of a decode over a cache sharded by position."""
    partials = kernels.decode_attention_partials
    wrapped = {name: _sharded(name, getattr(kernels, name), partials) for name in _ROLES}
    return ModelKernels(**wrapped, decode_attention_partials=partials, rms_norm=_rms_norm(kernels.rms_norm))
