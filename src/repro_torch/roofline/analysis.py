"""Roofline analysis of the dry-run's traces — the port of
``repro.roofline.analysis``, on one NVIDIA H100.

Three terms per (arch × shape × mesh), all in seconds:

    compute    = flops_per_device / PEAK_FLOPS      (989 TFLOP/s dense bf16)
    memory     = bytes_per_device / HBM_BW          (3.35 TB/s HBM3)
    collective = collective_bytes_per_device / LINK_BW  (450 GB/s NVLink)

``HW`` holds the H100 SXM data sheet's rates (NVIDIA's figures at the full
700 W), the card's memory as ``torch.cuda.get_device_properties`` reports
it, and the card the figures belong to as ``nvidia-smi
--query-gpu=name,power.limit`` prints it.  A card set below 700 W runs
slower than these rates under load.

The dry-run has no compiler to ask, so the operands come from the traced
step itself: flops from ``torch.utils.flop_counter``'s formulas over each
rank's local operations, and collective bytes from the collectives that
DTensor runs, recorded by ``CollectiveBytesMode`` (a
``CommDebugMode`` that also keeps each collective's result size and group
size).  ``collective_bytes`` sums them with the reference's operand
conventions: an all-gather's operand is its result over the group size, a
reduce-scatter's its result times the group size, every other collective's
its result.  Both modes also file what they count under the cost site
that was open when it ran (``distributed.sharding.cost_site``: work at the
port's DTensor workarounds, which the reference's cells do not run).
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.sharding import current_cost_site

__all__ = [
    "HW",
    "CollectiveBytesMode",
    "DeviceCostMode",
    "collective_bytes",
    "dominant_term",
    "model_flops",
    "roofline_terms",
]


class HW:
    CARD = "NVIDIA H100 80GB HBM3, 700.00 W"  # nvidia-smi name, power.limit
    PEAK_FLOPS = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
    HBM_BW = 3.35e12  # bytes/s, HBM3
    LINK_BW = 450e9  # bytes/s per GPU per direction, NVLink 4 (900 GB/s both ways)
    CHIPS_PER_POD = 256  # the production mesh's pod: 16 × 16 ranks
    HBM_BYTES = 85_024_276_480  # torch.cuda.get_device_properties(0).total_memory


_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

# op name (functional or c10d) -> reference kind
_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class CollectiveBytesMode(CommDebugMode):
    """``CommDebugMode`` that keeps its collective counts (``comm_counts``,
    ``get_comm_counts()``) and also records, for every collective a rank
    runs, (kind, result bytes, group size, cost site) in ``records``.  It keeps no
    per-operation log (``CommDebugMode``'s costs a dict for every op of a
    traced step, which the dry-run's long scans cannot afford)."""

    def __init__(self):
        super().__init__()
        self.records: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor lower the op to collectives and local ops
        out = func(*args, **(kwargs or {}))
        packet = getattr(func, "_overloadpacket", None)
        kind = _KINDS.get(getattr(packet, "__name__", ""))
        if kind is not None:
            self.comm_counts[packet] += 1
            self.records.append((kind, *_result_and_group(packet.__name__, args, out), current_cost_site()))
        return out


def _result_and_group(name: str, args, out) -> tuple:
    if name.startswith(("all_gather_into_tensor", "reduce_scatter_tensor")):
        return _nbytes(_tensors(out)), int(args[1] if name.startswith("all_gather") else args[2])
    if name.endswith("_"):  # c10d: the tensors written in place, and the group object
        pg = torch.distributed.ProcessGroup.unbox(next(a for a in args if isinstance(a, torch.ScriptObject)))
        return _nbytes(_tensors(args[0])), pg.size()
    return _nbytes(_tensors(out)), 1


# ops that only re-view or allocate: they move no bytes
_VIEWS = {
    "view", "_unsafe_view", "reshape", "as_strided", "expand", "permute", "transpose", "t", "slice", "select",
    "squeeze", "unsqueeze", "alias", "detach", "split", "split_with_sizes", "unbind", "chunk", "narrow",
    "diagonal", "unfold", "view_as_real", "view_as_complex", "lift_fresh", "empty", "empty_strided",
    "empty_like", "new_empty", "new_empty_strided", "_wrap_tensor_autograd",
}


class DeviceCostMode(TorchDispatchMode):
    """Counts what one rank computes: ``flops`` by ``torch.utils.flop_counter``'s
    formulas and ``bytes`` as every non-view op's input and output bytes
    (the counterpart of a compiler's bytes accessed, with no fusion), over
    the local tensors a DTensor op runs on.  A DTensor op is handed back
    (``NotImplemented``) so that DTensor lowers it to the rank's local ops,
    which come back here: the global op is not counted, nor the
    ``FakeTensor`` ops DTensor runs on global shapes to propagate shapes.
    ``by_site`` holds the part of each count run inside a cost site."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_site: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors(out) + _tensors(list(args))):
            return out
        packet = getattr(func, "_overloadpacket", None)
        formula = flop_registry.get(packet)
        flops = formula(*args, **kwargs, out_val=out) if formula is not None else 0
        name = getattr(packet, "__name__", "")
        moved = 0
        if name.rstrip("_") not in _VIEWS and name not in _KINDS:
            moved = _nbytes(_tensors(list(args) + list(kwargs.values()))) + _nbytes(_tensors(out))
        self.flops += flops
        self.bytes += moved
        site = current_cost_site()
        if site is not None:
            part = self.by_site.setdefault(site, {"flops": 0, "bytes": 0})
            part["flops"] += flops
            part["bytes"] += moved
        return out


def collective_bytes(comm_mode) -> dict:
    """-> {kind: operand bytes per device} over ``comm_mode.records``, with
    ``_counts`` (collectives per kind), ``_total`` and ``_by_site`` (the
    operand bytes run inside each cost site)."""
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    by_site: dict = {}
    for kind, result_bytes, group, site in comm_mode.records:
        if kind == "all-gather":
            operand = result_bytes // max(group, 1)
        elif kind == "reduce-scatter":
            operand = result_bytes * group
        else:
            operand = result_bytes
        out[kind] += operand
        counts[kind] += 1
        if site is not None:
            by_site[site] = by_site.get(site, 0) + operand
    out["_counts"] = counts
    out["_by_site"] = by_site
    out["_total"] = sum(out[k] for k in _COLLECTIVES)
    return out


def roofline_terms(flops_per_device: float, bytes_per_device: float, collective_bytes_per_device: float) -> dict:
    compute = flops_per_device / HW.PEAK_FLOPS
    memory = bytes_per_device / HW.HBM_BW
    collective = collective_bytes_per_device / HW.LINK_BW
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    terms["bound"] = dominant_term(terms)
    total = max(compute, memory, collective)
    terms["roofline_frac_compute"] = compute / total if total > 0 else 0.0
    return terms


def dominant_term(terms: dict) -> str:
    vals = {
        "compute": terms["compute_s"],
        "memory": terms["memory_s"],
        "collective": terms["collective_s"],
    }
    return max(vals, key=vals.get)


def model_flops(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode); N = active params."""
    n = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
