"""Pluggable compute backends for the morsel executor (paper §III-D).

A *backend* supplies the vectorized kernels that operator evaluators run on
each morsel: predicate evaluation, filtering, the fused filter+select that
the executor peepholes out of adjacent Filter→Select pairs, projection
arithmetic, and per-morsel segment reductions for partial aggregation.
Backends are looked up in a **kernel registry** keyed ``(backend name,
op name)``; resolution falls back to the numpy reference kernels, so a
backend only overrides the ops it accelerates and everything else keeps
reference semantics bit-for-bit.

Two backends ship in-tree:

  * ``numpy``  — the reference implementation (always present).
  * ``torch``  — dispatches eligible morsels to the hand-written CUDA
    kernels in ``repro_torch.kernels`` on an explicit device (``"cuda"``
    unless the caller asks for ``"cpu"``, where the kernels' plain PyTorch
    versions run).  Columns cross into the kernels as **int32 bit-planes**
    (one plane per 4 bytes of width), so compaction and reduction move bit
    patterns exactly — the kernels are bit-identical to numpy for every
    fixed-width dtype, including ``-0.0``, NaN payloads, Inf, and
    full-range int64.  Eligibility is decided per morsel *and per column*,
    by the same rules as the reference's Pallas backend; anything outside a
    kernel's envelope — var-width columns, validity masks, unsupported
    literal / column dtype pairings — runs the numpy kernel, so results are
    identical either way.  An eligible morsel always launches: a kernel
    that fails to build or launch on a CUDA device raises.

Dispatchable ops:

    filter_select   predicate ``col <cmp> lit`` with ``<cmp>`` in
                    {<, <=, >, >=, ==, !=}; predicate column float32 /
                    int32 / int64; projected columns any fixed-width dtype
    filter          the unfused form (projects every column)
    project         arithmetic Expr chains (+ - * / over float32 columns,
                    + - * over int32 columns, python-scalar literals) whose
                    postfix program fits one launch
    segment_reduce  per-group partial folds: count always, sum for integer
                    columns (8-bit-limb exact, wraparound-identical to
                    numpy), min/max for finite float32 without -0.0,
                    int32-safe integer, and the wide dtypes int64 / uint32 /
                    uint64 / float64 via a two-word hi/lo compare — two
                    masked-reduce kernel passes over an order-preserving
                    int64 key image (uint64: top-bit flip; float64:
                    sign-magnitude fold, NaN and -0.0 ineligible), exact
                    over the full 64-bit range; float sums and mean partial
                    sums fold through an explicit **f64-accumulating
                    reference path** (host-side — kernel lanes are 32-bit —
                    counted in ``TorchBackend.f64_folds``); ≤ 256 groups per
                    morsel

``get_backend("auto")`` resolves to torch.

Whole-chain fused pipelines: ``plan_fused_chain`` compiles an eligible
filter → project → segment-fold chain (the reference's eligibility rules)
into a :class:`FusedChainPlan` that runs each morsel as ONE
``fused_chain_tiles`` launch on the plan's device — the backend's, or the
CUDA index ``ExecutorConfig.devices`` binds it to.  On a CUDA device the
plan stages the next morsel's kernel inputs while the current one computes:
pinned host tensors, ``non_blocking`` H2D copies on a side stream, fenced
by an event the launch stream waits on.  Build, copy and launch failures
raise; only the host-side envelope checks, made before any launch, send a
morsel back to the per-op path.
"""

from __future__ import annotations

import math
import threading
from typing import Callable

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import trace
from repro_torch.core.batch import Column, RecordBatch
from repro_torch.core.env import env_str
from repro_torch.core.expr import Expr
from repro_torch.kernels import fused_pipeline
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.filter_select import _pred_mask
from repro_torch.kernels.project_arith import fits as _program_fits

__all__ = [
    "ComputeBackend",
    "KERNELS",
    "register_kernel",
    "get_backend",
    "available_backends",
    "BACKENDS",
    "FUSED_INELIGIBLE",
    "plan_fused_chain",
    "FusedChainPlan",
]


# ---------------------------------------------------------------------------
# kernel registry
# ---------------------------------------------------------------------------
KERNELS: dict = {"numpy": {}, "torch": {}}


def register_kernel(backend: str, op: str):
    """Register ``fn(backend_instance, ...)`` as ``op`` for ``backend``."""

    def deco(fn: Callable) -> Callable:
        KERNELS.setdefault(backend, {})[op] = fn
        return fn

    return deco


class ComputeBackend:
    """Kernel dispatch facade.  Instances are stateless and thread-safe."""

    name = "numpy"

    def kernel(self, op: str) -> Callable:
        impl = KERNELS.get(self.name, {}).get(op)
        if impl is None:
            impl = KERNELS["numpy"][op]
        return impl

    # -- morsel-level entry points (used by operator evaluators) ------------
    def eval_predicate(self, batch: RecordBatch, predicate: Expr) -> np.ndarray:
        return self.kernel("eval_predicate")(self, batch, predicate)

    def filter(self, batch: RecordBatch, predicate: Expr):
        """Apply a predicate; returns the surviving rows or ``None`` when the
        whole morsel is filtered out (no empty frames downstream)."""
        return self.kernel("filter")(self, batch, predicate)

    def filter_select(self, batch: RecordBatch, predicate: Expr, columns: list):
        """Fused filter + column projection (the executor's peephole)."""
        return self.kernel("filter_select")(self, batch, predicate, columns)

    def project(self, batch: RecordBatch, exprs: dict, out_schema):
        """Projection arithmetic over one morsel (shaped to ``out_schema``)."""
        return self.kernel("project")(self, batch, exprs, out_schema)

    def segment_reduce(self, gidx: np.ndarray, ngroups: int, specs: list, n_rows: int) -> dict:
        """Per-group partial reductions for one factorized morsel.

        ``specs`` is ``[(state_name, fn, values), ...]`` with ``fn`` in
        {count, sum, fsum, min, max} (``values`` is None for count; ``fsum``
        marks a float sum from a fresh state, foldable in the backend's
        f64-accumulating reference path).  Returns a dict mapping the state
        names the backend accelerated to per-group arrays of length
        ``ngroups``; callers scatter the rest with numpy.  The numpy
        backend accelerates nothing (``{}``)."""
        return self.kernel("segment_reduce")(self, gidx, ngroups, specs, n_rows)


# ---------------------------------------------------------------------------
# numpy reference kernels
# ---------------------------------------------------------------------------
@register_kernel("numpy", "eval_predicate")
def _np_eval_predicate(bk, batch: RecordBatch, predicate: Expr) -> np.ndarray:
    return np.asarray(predicate.evaluate(batch), dtype=bool)


@register_kernel("numpy", "filter")
def _np_filter(bk, batch: RecordBatch, predicate: Expr):
    mask = _np_eval_predicate(bk, batch, predicate)
    if mask.all():
        return batch
    if not mask.any():
        return None
    return batch.filter(mask)


@register_kernel("numpy", "filter_select")
def _np_filter_select(bk, batch: RecordBatch, predicate: Expr, columns: list):
    out = _np_filter(bk, batch, predicate)
    return None if out is None else out.select(columns)


@register_kernel("numpy", "project")
def _np_project(bk, batch: RecordBatch, exprs: dict, out_schema):
    from repro_torch.core.operators import project_morsel

    return project_morsel(batch, exprs, out_schema)


@register_kernel("numpy", "segment_reduce")
def _np_segment_reduce(bk, gidx, ngroups, specs, n_rows) -> dict:
    return {}  # reference path: GroupState scatters with numpy ufuncs


class NumpyBackend(ComputeBackend):
    name = "numpy"


# ---------------------------------------------------------------------------
# int32 bit-plane column codec (host side of the kernels)
# ---------------------------------------------------------------------------
_WIDE = {"float64", "int64", "uint64"}  # two planes: hi word, lo word
_NARROW_INT = {"int8", "int16", "uint8", "uint16", "bool"}  # widened exactly


def _plane_count(dtype_name: str) -> int:
    return 2 if dtype_name in _WIDE else 1


def _col_planes(values: np.ndarray, dtype_name: str) -> list:
    """Encode one fixed-width column into int32 bit-planes (lossless)."""
    v = np.ascontiguousarray(values)
    if dtype_name in _WIDE:
        b = v.view(np.int64)
        hi = (b >> 32).astype(np.int32)
        lo = (b & np.int64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        return [hi, lo]
    if dtype_name == "float16":
        return [v.view(np.uint16).astype(np.int32)]
    if dtype_name in _NARROW_INT:
        return [v.astype(np.int32)]
    return [v.view(np.int32)]  # float32 / int32 / uint32


def _planes_to_values(planes: np.ndarray, dtype) -> np.ndarray:
    """Decode (n, planes) int32 back into the column's numpy dtype."""
    name = dtype.name
    if name in _WIDE:
        hi = planes[:, 0].astype(np.int64)
        lo = np.ascontiguousarray(planes[:, 1]).view(np.uint32).astype(np.int64)
        return ((hi << 32) | lo).view(dtype.np_dtype)
    if name == "float16":
        return planes[:, 0].astype(np.uint16).view(np.float16)
    if name in _NARROW_INT:
        return planes[:, 0].astype(dtype.np_dtype)
    return np.ascontiguousarray(planes[:, 0]).view(dtype.np_dtype)


# ---------------------------------------------------------------------------
# torch backend
# ---------------------------------------------------------------------------
class TorchBackend(ComputeBackend):
    """Per-op dispatch to the CUDA kernels on ``device``.  Host arrays are
    encoded with the numpy codec above, copied to the device, folded by one
    kernel launch, and copied back; on a ``cpu`` device the kernels' plain
    PyTorch versions run instead."""

    name = "torch"
    tile = 256

    def __init__(self, device: str | torch.device | None = None):
        self.device = device_mod.resolve(device)
        self._lock = threading.Lock()
        self.kernel_calls = 0  # observability: kernel dispatch count
        # float sums folded through the f64-accumulating reference path
        # (host-side; the kernels' 32-bit lanes cannot hold f64)
        self.f64_folds = 0

    def _count(self, calls: int = 0, folds: int = 0) -> None:
        with self._lock:
            self.kernel_calls += calls
            self.f64_folds += folds

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @staticmethod
    def to_host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()


# -- fused filter+select ----------------------------------------------------
_CMP_OPS = {"lt", "le", "gt", "ge", "eq", "ne"}
_PRED_KINDS = {"float32": "f32", "int32": "i32", "int64": "i64"}
_INT32_SIGN = 0x80000000


def _normalize_threshold(t, dtype_name: str, op: str):
    """Map a predicate literal onto kernel-comparable form for a column
    dtype.  Returns ``(kind, op, t_hi, t_lo)`` or ``None`` when the f32/int
    kernel comparison could not reproduce numpy's promotion semantics
    (e.g. a strong float64 scalar against a float32 column that is not
    exactly representable, or a float literal against an int64 column).
    Non-integer float literals against int32 columns rewrite to the
    equivalent integer comparison (``v > 2.5  ⇔  v > 2``)."""
    if isinstance(t, (bool, np.bool_)):
        return None
    if dtype_name == "float32":
        if isinstance(t, (int, float)) or (isinstance(t, np.floating) and t.dtype.itemsize <= 4):
            # weak python scalars (and <=32-bit float scalars) compare in
            # float32 under numpy-2 promotion — the kernel's native compare
            try:
                return ("f32", op, float(np.float32(t)), 0)
            except (OverflowError, ValueError):
                return None
        if isinstance(t, (np.integer, np.floating)):
            # strong 64-bit scalars promote the reference comparison to
            # float64; parity holds only for exactly-representable values
            thr = float(np.float32(t))
            return ("f32", op, thr, 0) if thr == t else None
        return None
    if dtype_name in ("int32", "int64"):
        if isinstance(t, np.uint64):
            return None  # numpy promotes int64 vs uint64 to float64
        if isinstance(t, (int, np.integer)):
            ti = int(t)
        elif isinstance(t, (float, np.floating)) and dtype_name == "int32":
            tf = float(t)
            if not np.isfinite(tf):
                return None
            if not tf.is_integer():
                if op in ("eq", "ne"):
                    return None  # constant mask; let numpy broadcast it
                # v <cmp> 2.5 is an integer comparison against floor(2.5)
                op = {"gt": "gt", "ge": "gt", "lt": "le", "le": "le"}[op]
                ti = int(np.floor(tf))
            else:
                ti = int(tf)
        else:
            return None  # float literals vs int64 compare in lossy float64
        lo, hi = (-(2**31), 2**31 - 1) if dtype_name == "int32" else (-(2**63), 2**63 - 1)
        if not (lo <= ti <= hi):
            return None  # reference raises (weak) or promotes (strong)
        if dtype_name == "int32":
            return ("i32", op, ti, 0)
        t_hi = ti >> 32
        t_lo = (ti & 0xFFFFFFFF) ^ _INT32_SIGN  # sign-flipped low word
        if t_lo >= 2**31:
            t_lo -= 2**32
        return ("i64", op, t_hi, t_lo)
    return None


def _fused_plan(batch: RecordBatch, predicate: Expr, columns: list):
    """Eligibility check for the fused filter+select kernel.  Returns
    ``(op, kind, t_hi, t_lo, pred_name)`` or ``None`` (→ numpy kernel)."""
    if not (
        isinstance(predicate, Expr)
        and predicate.op in _CMP_OPS
        and isinstance(predicate.args[0], Expr)
        and predicate.args[0].op == "col"
        and isinstance(predicate.args[1], Expr)
        and predicate.args[1].op == "lit"
    ):
        return None
    pred_name = predicate.args[0].args[0]
    schema = batch.schema
    if pred_name not in schema:
        return None
    pf = schema.field(pred_name)
    if pf.dtype.name not in _PRED_KINDS or batch.column(pred_name).validity is not None:
        return None
    norm = _normalize_threshold(predicate.args[1].args[0], pf.dtype.name, predicate.op)
    if norm is None:
        return None
    kind, op, t_hi, t_lo = norm
    for name in columns:
        if name not in schema:
            return None
        f = schema.field(name)
        if f.dtype.is_varwidth or batch.column(name).validity is not None:
            return None
    return op, kind, t_hi, t_lo, pred_name


@register_kernel("torch", "filter_select")
def _tc_filter_select(bk: TorchBackend, batch: RecordBatch, predicate: Expr, columns: list):
    plan = _fused_plan(batch, predicate, columns)
    if plan is None or batch.num_rows == 0:
        return _np_filter_select(bk, batch, predicate, columns)
    op, kind, t_hi, t_lo, pred_name = plan
    tile = bk.tile
    n = batch.num_rows
    n_pad = -(-n // tile) * tile
    out_schema = batch.schema.select(columns)
    pred_planes = _col_planes(batch.column(pred_name).values, batch.schema.field(pred_name).dtype.name)
    pred_arr = np.zeros((n_pad, len(pred_planes)), np.int32)
    for j, p in enumerate(pred_planes):
        pred_arr[:n, j] = p
    spans = []  # (plane start, plane count) per output column
    pos = 0
    for f in out_schema:
        k = _plane_count(f.dtype.name)
        spans.append((pos, k))
        pos += k
    table = np.zeros((n_pad, pos), np.int32)
    for f, (start, _k) in zip(out_schema, spans):
        for j, p in enumerate(_col_planes(batch.column(f.name).values, f.dtype.name)):
            table[:n, start + j] = p
    t_hi_bits = int(np.array([t_hi], np.float32).view(np.int32)[0]) if kind == "f32" else int(t_hi)
    scalars = np.asarray([n, t_hi_bits, int(t_lo)], np.int32)
    out, counts = kernel_ops.filter_select_planes(
        bk.to_device(pred_arr), bk.to_device(table), scalars, op, kind, tile=tile
    )
    bk._count(calls=1)
    counts = bk.to_host(counts)
    n_sel = int(counts.sum())
    if n_sel == 0:
        return None
    out = bk.to_host(out)
    compact = np.concatenate([out[i * tile : i * tile + int(c)] for i, c in enumerate(counts) if c])
    cols = [
        Column(f.dtype, values=_planes_to_values(compact[:, start : start + k], f.dtype))
        for f, (start, k) in zip(out_schema, spans)
    ]
    return RecordBatch(out_schema, cols)


@register_kernel("torch", "filter")
def _tc_filter(bk: TorchBackend, batch: RecordBatch, predicate: Expr):
    # the unfused form projects every column through the plane kernel
    return _tc_filter_select(bk, batch, predicate, list(batch.schema.names))


# -- project arithmetic ------------------------------------------------------
_ARITH_F32 = {"add", "sub", "mul", "div"}
_ARITH_I32 = {"add", "sub", "mul"}  # int div/mod promote to float64 in numpy
# numpy's float32 + - * / loops return the FIRST of two NaN operands on
# arrays of 16 elements or fewer, and the second for + and * on longer ones,
# the rule the kernels apply at any length (numpy 2.0.2, x86).  float32
# arithmetic that numpy would run on so few rows is left to numpy.
_NUMPY_SHORT_LOOP = 16


def _contraction_safe(op: str, a, b) -> bool:
    """XLA's CPU backend contracts a float ``mul`` feeding ``add``/``sub``
    into a single-rounding FMA during LLVM codegen (nothing at the HLO level
    survives to prevent it), while numpy rounds the product separately — a
    1-ulp divergence whenever the product is inexact.  Only exact products
    are immune, so a float32 mul may sit directly under add/sub solely when
    one factor is a power-of-two literal (a mantissa-preserving scale).
    Division never contracts, and integer arithmetic is exact.

    The CUDA kernel never contracts (``__fmul_rn`` / ``__fadd_rn``), but the
    rule stays so that the port dispatches exactly the morsels the
    reference does."""
    if op not in ("add", "sub"):
        return True
    for t in (a, b):
        if t[0] != "mul":
            continue
        if not any(
            s[0] == "lit" and _is_pow2_f32(s[1]) for s in (t[1], t[2])
        ):
            return False
    return True


def _is_pow2_f32(v) -> bool:
    v32 = float(np.float32(v))
    return v32 != 0.0 and math.isfinite(v32) and abs(math.frexp(v32)[0]) == 0.5


def _lit_value(v, group: str):
    """A literal's value in kernel arithmetic of ``group`` ("float32" |
    "int32"), or None where numpy would promote: weak scalars (and <=32-bit
    float scalars) keep f32 arithmetic; an int64 scalar or an integer
    outside int32 would promote to int64 (or raise) in numpy.  A NaN
    literal is left to numpy too: against a NaN column element numpy's
    choice between the two depends on the element's place in its loop."""
    if isinstance(v, (bool, np.bool_)):
        return None
    if group == "float32":
        if isinstance(v, (int, float)) or (isinstance(v, np.floating) and v.dtype.itemsize <= 4):
            return None if math.isnan(float(v)) else float(v)
        return None
    if isinstance(v, (int, np.integer)) and not isinstance(v, np.uint64):
        vi = int(v)
        if isinstance(v, np.int64) or not (-(2**31) <= vi <= 2**31 - 1):
            return None
        return vi
    return None


def _arith_descr(e, batch: RecordBatch, group: str, col_idx: dict):
    """Lower an Expr subtree to a kernel descriptor, interning column
    indices into ``col_idx``.  Returns None when any node falls outside the
    kernel envelope for ``group`` ("float32" | "int32")."""
    if not isinstance(e, Expr):
        return None
    if e.op == "col":
        name = e.args[0]
        if name not in batch.schema:
            return None
        f = batch.schema.field(name)
        if f.dtype.name != group or batch.column(name).validity is not None:
            return None
        if name not in col_idx:
            col_idx[name] = len(col_idx)
        return ("col", col_idx[name])
    if e.op == "lit":
        v = _lit_value(e.args[0], group)
        return None if v is None else ("lit", v)
    allowed = _ARITH_F32 if group == "float32" else _ARITH_I32
    if e.op not in allowed or len(e.args) != 2:
        return None
    a = _arith_descr(e.args[0], batch, group, col_idx)
    if a is None:
        return None
    b = _arith_descr(e.args[1], batch, group, col_idx)
    if b is None:
        return None
    if group == "float32" and not _contraction_safe(e.op, a, b):
        return None
    return (e.op, a, b)


@register_kernel("torch", "project")
def _tc_project(bk: TorchBackend, batch: RecordBatch, exprs: dict, out_schema):
    from repro_torch.core.operators import project_morsel

    if batch.num_rows == 0:
        return project_morsel(batch, exprs, out_schema)
    # plan each expression independently (per-column eligibility)
    groups: dict = {}  # group dtype -> (col_idx, [(out name, descr)])
    for name, e in exprs.items():
        f = out_schema.field(name)
        if f.dtype.name not in ("float32", "int32"):
            continue
        if f.dtype.name == "float32" and batch.num_rows <= _NUMPY_SHORT_LOOP:
            continue
        group = f.dtype.name
        col_idx = groups.setdefault(group, ({}, []))[0]
        snapshot = dict(col_idx)
        descr = _arith_descr(e, batch, group, col_idx)
        # a tree whose postfix program overflows the kernel's register stack
        # (or one launch's instructions) stays on numpy, decided before launch
        if descr is None or descr[0] in ("col", "lit") or not _program_fits(descr, group):
            col_idx.clear()
            col_idx.update(snapshot)  # drop columns interned by the failed plan
            continue
        groups[group][1].append((name, descr))
    planned = {name: None for g in groups.values() for name, _ in g[1]}
    if not planned:
        return project_morsel(batch, exprs, out_schema)
    n = batch.num_rows
    tile = bk.tile
    n_pad = -(-n // tile) * tile
    for group, (col_idx, outs) in groups.items():
        if not outs:
            continue
        np_dt = np.dtype(group)
        table = np.zeros((n_pad, max(1, len(col_idx))), np_dt)
        for cname, j in col_idx.items():
            table[:n, j] = batch.column(cname).values
        res = bk.to_host(kernel_ops.project_tiles(bk.to_device(table), tuple(d for _, d in outs), tile=tile))
        for j, (name, _d) in enumerate(outs):
            planned[name] = np.ascontiguousarray(res[:n, j])
    bk._count(calls=1)
    # assemble exactly like the reference evaluator: kernel outputs for the
    # planned exprs, numpy evaluation (+dtype coercion) for the rest
    new_cols = {}
    for name, e in exprs.items():
        f = out_schema.field(name)
        vals = planned.get(name)
        if vals is None:
            vals = np.asarray(e.evaluate(batch))
            if vals.ndim == 0:
                vals = np.full(batch.num_rows, vals[()])
            if not f.dtype.is_varwidth and vals.dtype != f.dtype.np_dtype:
                vals = vals.astype(f.dtype.np_dtype)
        new_cols[name] = Column.from_values(f.dtype, vals)
    cols = [new_cols[f.name] if f.name in new_cols else batch.column(f.name) for f in out_schema]
    return RecordBatch(out_schema, cols)


# -- segment reductions (partial aggregation) -------------------------------
_SEG_GROUP_CAP = 256
_SUM_LIMBS = 8  # 8-bit limbs, int64 coverage


def _sum_limbs(values: np.ndarray) -> list:
    v = values.astype(np.int64)
    limbs = [((v >> (8 * k)) & np.int64(0xFF)).astype(np.int32) for k in range(_SUM_LIMBS - 1)]
    limbs.append((v >> (8 * (_SUM_LIMBS - 1))).astype(np.int32))  # signed top limb
    return limbs


def _limbs_to_int64(sums: np.ndarray) -> np.ndarray:
    """(G, 8) int32 limb sums -> (G,) int64 (wraparound-identical to numpy)."""
    with np.errstate(over="ignore"):
        total = np.zeros(sums.shape[0], np.int64)
        for k in range(_SUM_LIMBS):
            total += sums[:, k].astype(np.int64) << np.int64(8 * k)
    return total


def _mm_eligible(values: np.ndarray, kind: str):
    """Kernel-ready min/max column or None.  float32 must be finite and
    hold no -0.0: the kernel's order-preserving key puts -0.0 below +0.0,
    while numpy's sequential fold keeps whichever tied zero comes later (the
    rule the float64 path applies too); integers must fit int32."""
    dt = values.dtype
    if dt == np.float32:
        if not np.isfinite(values).all() or ((values == 0.0) & np.signbit(values)).any():
            return None
        return values
    if dt.kind == "b" or (dt.kind == "i" and dt.itemsize <= 4) or (dt.kind == "u" and dt.itemsize <= 2):
        return values.astype(np.int32)
    return None


_I64_MAX = np.int64(2**63 - 1)
_I64_MIN = np.int64(-(2**63))
_U64_TOP = np.uint64(1 << 63)
_F64_LOW63 = np.int64(0x7FFFFFFFFFFFFFFF)


def _decode_i64(arr: np.ndarray, fn: str) -> np.ndarray:
    return arr  # empty-group sentinels (int64 extremes) ARE the identities


def _decode_u64(arr: np.ndarray, fn: str) -> np.ndarray:
    # inverse of the top-bit flip; the min sentinel int64-max decodes to
    # uint64-max and the max sentinel int64-min to 0 — the uint64 identities
    return arr.view(np.uint64) ^ _U64_TOP


def _decode_f64(arr: np.ndarray, fn: str) -> np.ndarray:
    # empty-group sentinels are unreachable from (non-NaN) float bits —
    # substitute the float identities before inverting the order map
    arr = arr.copy()
    if fn == "min":
        sent = arr == _I64_MAX
        inf = np.float64(np.inf)
    else:
        sent = arr == _I64_MIN
        inf = np.float64(-np.inf)
    bits = np.where(arr >= 0, arr, arr ^ _F64_LOW63)
    out = bits.view(np.float64).copy()
    out[sent] = inf
    return out


def _mm_wide_eligible(values: np.ndarray):
    """``(int64 order keys, decoder)`` for the two-word min/max path, or
    None.  The keys are an order-preserving int64 image of the column, fed
    through two ``segment_minmax_tiles`` passes (signed hi words, then
    sign-flipped lo words); the decoder maps group extremes (and the
    empty-group sentinels) back to the column dtype:

      * int64   — identity (sentinels are already the int64 identities)
      * uint32  — widens exactly into int64
      * uint64  — top-bit flip: ``u ^ 2^63`` viewed signed orders as uint64
      * float64 — sign-magnitude fold: non-negative bit patterns order as
        floats already; negative ones have all low 63 bits flipped.  NaN is
        ineligible (total order ≠ numpy's NaN propagation) and so is -0.0
        (bitwise total order would distinguish it from +0.0 where numpy's
        min/max result depends on operand order); ±Inf are fine.
    """
    dt = values.dtype
    if dt.kind == "i" and dt.itemsize == 8:
        return values, _decode_i64
    if dt.kind == "u" and dt.itemsize == 4:
        return values.astype(np.int64), _decode_i64
    if dt.kind == "u" and dt.itemsize == 8:
        return (values ^ _U64_TOP).view(np.int64), _decode_u64
    if dt == np.float64:
        if np.isnan(values).any() or ((values == 0.0) & np.signbit(values)).any():
            return None
        b = values.view(np.int64)
        return np.where(b >= 0, b, b ^ _F64_LOW63), _decode_f64
    return None


_LO_SIGN = np.uint32(0x80000000)


def _wide_words(v64: np.ndarray):
    """(hi, lo') int32 words of an int64 column whose lexicographic
    (signed hi, signed lo') order equals the int64 order: hi is the signed
    top word, lo' the sign-flipped low word."""
    hi = (v64 >> np.int64(32)).astype(np.int32)
    lo = ((v64 & np.int64(0xFFFFFFFF)).astype(np.uint32) ^ _LO_SIGN).view(np.int32)
    return hi, lo


def _wide_decode(hi: np.ndarray, lo_s: np.ndarray) -> np.ndarray:
    lo_u = (lo_s.view(np.uint32) ^ _LO_SIGN).astype(np.int64)
    return (hi.astype(np.int64) << np.int64(32)) | lo_u


@register_kernel("torch", "segment_reduce")
def _tc_segment_reduce(bk: TorchBackend, gidx, ngroups, specs, n_rows) -> dict:
    if ngroups == 0 or ngroups > _SEG_GROUP_CAP or n_rows > kernel_ops.SUM_ROW_CAP or n_rows == 0:
        return {}
    sums: list = []  # (state name, values)
    fsums: list = []  # (state name, f64 values) — host f64 reference path
    mms: dict = {"f32": [], "i32": []}  # kind -> [(state name, fn, col)]
    wides: list = []  # (state name, fn, int64 keys, decoder) — two-word min/max
    count_names: list = []
    for name, fn, values in specs:
        if fn == "count":
            count_names.append(name)
        elif fn == "fsum":
            fsums.append((name, values))
        elif fn == "sum":
            if values is not None and values.dtype.kind in "iub":
                sums.append((name, values))
        elif fn in ("min", "max") and values is not None:
            col = _mm_eligible(values, fn)
            if col is not None:
                mms["f32" if col.dtype == np.float32 else "i32"].append((name, fn, col))
            else:
                wide = _mm_wide_eligible(values)
                if wide is not None:
                    wides.append((name, fn, wide[0], wide[1]))
    if not (sums or count_names or mms["f32"] or mms["i32"] or wides or fsums):
        return {}
    tile = bk.tile
    n_pad = -(-n_rows // tile) * tile
    g_pad = -(-ngroups // 8) * 8
    g32 = np.zeros(n_pad, np.int32)
    g32[:n_rows] = np.asarray(gidx, np.int64)[:n_rows]
    g_dev = bk.to_device(g32) if (sums or count_names or mms["f32"] or mms["i32"] or wides) else None
    out: dict = {}
    kernel_used = False
    if sums or count_names:
        limb_tbl = np.zeros((n_pad, max(1, _SUM_LIMBS * len(sums))), np.int32)
        for i, (_name, values) in enumerate(sums):
            for k, limb in enumerate(_sum_limbs(values)):
                limb_tbl[:n_rows, _SUM_LIMBS * i + k] = limb
        s_res, c_res = kernel_ops.segment_sum_tiles(g_dev, bk.to_device(limb_tbl), n_rows, g_pad, tile=tile)
        s_res, c_res = bk.to_host(s_res), bk.to_host(c_res)
        for i, (name, _values) in enumerate(sums):
            out[name] = _limbs_to_int64(s_res[:ngroups, _SUM_LIMBS * i : _SUM_LIMBS * (i + 1)])
        for name in count_names:
            out[name] = c_res[:ngroups].astype(np.int64)
        kernel_used = True
    for kind, entries in mms.items():
        if not entries:
            continue
        np_dt = np.float32 if kind == "f32" else np.int32
        tbl = np.zeros((n_pad, len(entries)), np_dt)
        for j, (_name, _fn, col) in enumerate(entries):
            tbl[:n_rows, j] = col
        fns = tuple(fn for _n, fn, _c in entries)
        res = bk.to_host(kernel_ops.segment_minmax_tiles(g_dev, bk.to_device(tbl), n_rows, g_pad, fns, tile=tile))
        for j, (name, _fn, _c) in enumerate(entries):
            out[name] = np.ascontiguousarray(res[:ngroups, j])
        kernel_used = True
    if wides:
        # two-word compare: pass 1 reduces the signed hi words; pass 2
        # reduces the sign-flipped lo words among only the rows whose hi
        # word equals their group's extreme (others masked to the identity
        # sentinel).  Lexicographic (hi, lo') == int64 order on the
        # order-preserving keys; each column's decoder maps the extremes
        # (and the empty-group sentinels) back to the source dtype — int64 /
        # uint32 directly, uint64 / float64 by inverting their monotone
        # int64 image (see ``_mm_wide_eligible``).  The host orchestrates
        # both passes, as the reference does.
        fns = tuple(fn for _n, fn, _c, _d in wides)
        hi_tbl = np.zeros((n_pad, len(wides)), np.int32)
        lo_cols = []
        for j, (_name, _fn, col, _dec) in enumerate(wides):
            hi, lo = _wide_words(col)
            hi_tbl[:n_rows, j] = hi
            lo_cols.append((hi, lo))
        h_res = bk.to_host(kernel_ops.segment_minmax_tiles(g_dev, bk.to_device(hi_tbl), n_rows, g_pad, fns, tile=tile))
        lo_tbl = np.empty((n_pad, len(wides)), np.int32)
        for j, (_name, fn, _col, _dec) in enumerate(wides):
            sent = np.int32(2**31 - 1) if fn == "min" else np.int32(-(2**31))
            lo_tbl[:, j] = sent
            hi, lo = lo_cols[j]
            at_extreme = hi == h_res[:, j][g32[:n_rows]]
            lo_tbl[:n_rows, j] = np.where(at_extreme, lo, sent)
        l_res = bk.to_host(kernel_ops.segment_minmax_tiles(g_dev, bk.to_device(lo_tbl), n_rows, g_pad, fns, tile=tile))
        for j, (name, fn, _col, decode) in enumerate(wides):
            keys64 = _wide_decode(h_res[:ngroups, j], np.ascontiguousarray(l_res[:ngroups, j]))
            out[name] = decode(keys64, fn)
        kernel_used = True
    for name, values in fsums:
        # f64-accumulating reference path: bit-identical to the numpy
        # scatter because a fresh state's accumulators start at +0.0 and
        # np.add.at adds this morsel's values in the same row order
        acc = np.zeros(ngroups, np.float64)
        np.add.at(acc, np.asarray(gidx, np.int64), np.asarray(values, np.float64))
        out[name] = acc
    bk._count(calls=int(kernel_used), folds=len(fsums))
    return out


# ---------------------------------------------------------------------------
# whole-chain fused pipelines: one launch per morsel
# ---------------------------------------------------------------------------
# Sentinel returned by FusedChainPlan.run/.fold when THIS morsel falls
# outside the compiled envelope (validity mask appeared, row/group caps
# exceeded, non-finite or -0.0 float32 min/max input, NaN arithmetic that
# numpy would run on a short array); the caller runs the per-op path for
# that morsel only.  It is decided on the host before any launch.
FUSED_INELIGIBLE = object()

_FLOAT_NAMES = {"float16", "float32", "float64"}
# a float sum's source column as the fused kernel widens it (else "i32": the
# int32 plane of int32, the narrow ints and bool)
_FSUM_KIND = {"float32": "f32", "float64": "f64", "float16": "f16", "uint32": "u32", "int64": "i64", "uint64": "u64"}
_TORCH_DT = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}


def _lower_pred(pred, mapping: dict, src_schema):
    """Lower a filter predicate against SOURCE column names.  Returns
    ``(op, kind, t_hi_bits, t_lo, src_name)`` or None."""
    if not (
        isinstance(pred, Expr)
        and pred.op in _CMP_OPS
        and isinstance(pred.args[0], Expr)
        and pred.args[0].op == "col"
        and isinstance(pred.args[1], Expr)
        and pred.args[1].op == "lit"
    ):
        return None
    m = mapping.get(pred.args[0].args[0])
    if m is None or m[0] != "src":
        return None
    sname = m[1]
    dtn = src_schema.field(sname).dtype.name
    if dtn not in _PRED_KINDS:
        return None
    norm = _normalize_threshold(pred.args[1].args[0], dtn, pred.op)
    if norm is None:
        return None
    kind, op, t_hi, t_lo = norm
    t_hi_bits = int(np.array([t_hi], np.float32).view(np.int32)[0]) if kind == "f32" else int(t_hi)
    return op, kind, t_hi_bits, int(t_lo), sname


def _lower_arith_named(e, mapping: dict, src_schema, group: str):
    """Lower an Expr to a descriptor tree over SOURCE column names.
    Computed-of-computed inlines the earlier tree when the group matches:
    the stored f32/i32 column value IS the in-kernel subtree value (each op
    rounds in the group dtype either way), so inlining is exact."""
    if not isinstance(e, Expr):
        return None
    if e.op == "col":
        m = mapping.get(e.args[0])
        if m is None:
            return None
        if m[0] == "src":
            if src_schema.field(m[1]).dtype.name != group:
                return None
            return ("col", m[1])
        return m[2] if m[1] == group else None
    if e.op == "lit":
        v = _lit_value(e.args[0], group)
        return None if v is None else ("lit", v)
    allowed = _ARITH_F32 if group == "float32" else _ARITH_I32
    if e.op not in allowed or len(e.args) != 2:
        return None
    a = _lower_arith_named(e.args[0], mapping, src_schema, group)
    if a is None:
        return None
    b = _lower_arith_named(e.args[1], mapping, src_schema, group)
    if b is None:
        return None
    if group == "float32" and not _contraction_safe(e.op, a, b):
        return None
    return (e.op, a, b)


def _intern_tree(tree, idx: dict):
    """Replace source column names in a descriptor tree with table indices."""
    if tree[0] == "col":
        name = tree[1]
        if name not in idx:
            idx[name] = len(idx)
        return ("col", idx[name])
    if tree[0] == "lit":
        return tree
    return (tree[0], _intern_tree(tree[1], idx), _intern_tree(tree[2], idx))


def plan_fused_chain(specs: list, in_schema, agg=None, backend=None):
    """Compile a pipeline's op-spec chain into a :class:`FusedChainPlan`
    (one ``fused_chain_tiles`` launch per morsel), or None when any link
    falls outside the kernel envelope (→ the per-op path runs unchanged).

    ``specs`` is the executor's ``[(kind, args), ...]`` chain.  Eligible
    chains are any combination of at most one ``filter`` (predicate
    ``col <cmp> lit`` on a float32/int32/int64 source column), ``select``,
    and ``project`` (f32/i32 arithmetic or cast-free renames) — evaluated
    symbolically against SOURCE columns, so the kernel reads the original
    morsel regardless of where the filter sits in the chain.  With ``agg``
    (``(keys, aggs, mode, in_schema)``) the plan also folds the per-morsel
    partial aggregate in the same launch: counts, integer sums (8-bit-limb
    passthrough / 4-limb in-kernel for computed int32), f32 + narrow-int
    min/max, and float sums folded in float64 on the device in row order
    (the host's f64 fold where a survivor is NaN or ±inf).
    Float-keyed aggregates are ineligible (the pre-filter factorization
    could pick a different -0.0/NaN representative than the reference's
    post-filter one); wide min/max and var-width outputs are ineligible.

    Eligibility is the reference's.  Two host limits of the CUDA kernel are
    added, both decided here: each dtype's descriptor trees must fit one
    postfix program, and the segment fold's accumulators for the group cap
    must fit a block's shared memory (``fused_pipeline.fits``)."""
    if backend is None or getattr(backend, "name", None) != "torch" or in_schema is None:
        return None
    mapping = {f.name: ("src", f.name) for f in in_schema}
    cur = in_schema
    filt = None
    f32_after_filter = False  # numpy evaluates some float32 tree on the filtered rows
    for kind_, args in specs:
        if kind_ == "filter":
            if filt is not None:
                return None
            filt = _lower_pred(args[0], mapping, in_schema)
            if filt is None:
                return None
        elif kind_ == "select":
            cols = list(args[0])
            if any(c not in mapping for c in cols):
                return None
            mapping = {c: mapping[c] for c in cols}
            cur = cur.select(cols)
        elif kind_ == "project":
            exprs, out_schema = args
            new_map = {}
            for f in out_schema:
                e = exprs.get(f.name)
                if e is None:
                    m = mapping.get(f.name)
                    if m is None:
                        return None
                    new_map[f.name] = m
                    continue
                if isinstance(e, Expr) and e.op == "col":
                    m = mapping.get(e.args[0])
                    if m is None:
                        return None
                    src_dt = in_schema.field(m[1]).dtype.name if m[0] == "src" else m[1]
                    if src_dt != f.dtype.name:
                        return None  # dtype-coercing rename: outside the kernel
                    new_map[f.name] = m
                    continue
                if f.dtype.name not in ("float32", "int32"):
                    return None
                tree = _lower_arith_named(e, mapping, in_schema, f.dtype.name)
                if tree is None or tree[0] in ("col", "lit"):
                    return None
                new_map[f.name] = ("arith", f.dtype.name, tree)
                f32_after_filter |= filt is not None and f.dtype.name == "float32"
            mapping = new_map
            cur = out_schema
        else:
            return None  # map / probe break the fusable chain
    if filt is None and agg is None:
        return None
    if not cur.fields:
        return None

    # -- assemble the kernel input/output layout --------------------------
    f_trees: dict = {}  # name-tree -> index among f32 computed columns
    i_trees: dict = {}
    pass_fields: list = []  # (src name, dtype, plane start, plane count)
    pass_pos = 0

    def _computed(m):
        _tag, group, tree = m
        trees = f_trees if group == "float32" else i_trees
        if tree not in trees:
            trees[tree] = len(trees)
        return ("f32" if group == "float32" else "i32", trees[tree])

    def _pass_ref(sname, dtype):
        nonlocal pass_pos
        for s, dt, start, k in pass_fields:
            if s == sname:
                return ("pass", start, k, dt)
        k = _plane_count(dtype.name)
        pass_fields.append((sname, dtype, pass_pos, k))
        ref = ("pass", pass_pos, k, dtype)
        pass_pos += k
        return ref

    out_decode = None
    key_srcs: list = []
    gcnt_states: list = []
    limb_srcs: list = []
    csum_states: list = []
    mmf: list = []
    mmi: list = []
    fsums: list = []
    if agg is None:
        out_decode = []
        for f in cur:
            m = mapping[f.name]
            if m[0] == "src":
                if f.dtype.is_varwidth:
                    return None
                out_decode.append((f, _pass_ref(m[1], f.dtype)))
            else:
                out_decode.append((f, _computed(m)))
    else:
        keys, aggs, mode, agg_schema = agg
        for k in keys:
            m = mapping.get(k)
            if m is None or m[0] != "src":
                return None
            if in_schema.field(m[1]).dtype.name in _FLOAT_NAMES:
                return None
            key_srcs.append((k, m[1]))

        def _fsum_ref(m):
            if m[0] == "src":
                dt = in_schema.field(m[1]).dtype
                return None if dt.is_varwidth else _pass_ref(m[1], dt)
            return _computed(m)

        for out, spec in aggs.items():
            fn = spec["fn"]
            if fn == "count":
                if mode == "final":
                    m = mapping.get(out)
                    if m is None or m[0] != "src":
                        return None
                    limb_srcs.append((out, m[1]))
                else:
                    gcnt_states.append(out)
            elif fn == "mean":
                psrc = f"{out}__psum" if mode == "final" else spec.get("column")
                m = mapping.get(psrc)
                if m is None:
                    return None
                r = _fsum_ref(m)
                if r is None:
                    return None
                fsums.append((f"{out}__psum", r))
                if mode == "final":
                    m2 = mapping.get(f"{out}__pcnt")
                    if m2 is None or m2[0] != "src":
                        return None
                    limb_srcs.append((f"{out}__pcnt", m2[1]))
                else:
                    gcnt_states.append(f"{out}__pcnt")
            elif fn == "sum":
                src = out if mode == "final" else spec.get("column")
                m = mapping.get(src)
                if m is None:
                    return None
                if m[0] == "src":
                    dt = in_schema.field(m[1]).dtype.np_dtype
                    if dt.kind in "iub":
                        limb_srcs.append((out, m[1]))
                    elif dt.kind == "f":
                        fsums.append((out, _pass_ref(m[1], in_schema.field(m[1]).dtype)))
                    else:
                        return None
                elif m[1] == "int32":
                    csum_states.append((out, _computed(m)[1]))
                else:
                    fsums.append((out, _computed(m)))
            elif fn in ("min", "max"):
                src = out if mode == "final" else spec.get("column")
                m = mapping.get(src)
                if m is None or m[0] != "src":
                    return None
                dt = in_schema.field(m[1]).dtype.np_dtype
                if dt == np.float32:
                    mmf.append((out, fn, m[1]))
                elif dt.kind == "b" or (dt.kind == "i" and dt.itemsize <= 4) or (dt.kind == "u" and dt.itemsize <= 2):
                    mmi.append((out, fn, m[1]))
                else:
                    return None
            else:
                return None

    af_idx: dict = {}
    ai_idx: dict = {}
    descrs_f = tuple(_intern_tree(t, af_idx) for t, _j in sorted(f_trees.items(), key=lambda kv: kv[1]))
    descrs_i = tuple(_intern_tree(t, ai_idx) for t, _j in sorted(i_trees.items(), key=lambda kv: kv[1]))
    limb_cols = max(1, _SUM_LIMBS * len(limb_srcs))
    csums = tuple(idx for _state, idx in csum_states)
    g_cap = _SEG_GROUP_CAP if agg is not None else 8
    if not fused_pipeline.fits(descrs_f, descrs_i, csums, limb_cols, max(1, len(mmf)), max(1, len(mmi)), g_cap,
                               nfsums=len(fsums)):
        return None  # the CUDA kernel's launch limits, decided before any launch
    af_cols = [s for s, _ in sorted(af_idx.items(), key=lambda kv: kv[1])]
    ai_cols = [s for s, _ in sorted(ai_idx.items(), key=lambda kv: kv[1])]
    checked = {s for s, _dt, _p, _k in pass_fields} | set(af_cols) | set(ai_cols)
    checked |= {s for _st, s in limb_srcs} | {s for _st, _fn, s in mmf} | {s for _st, _fn, s in mmi}
    if filt is not None:
        checked.add(filt[4])
    return FusedChainPlan(
        backend,
        filt=filt,
        out_schema=cur if agg is None else None,
        out_decode=out_decode,
        agg=None if agg is None else (list(agg[0]), dict(agg[1]), agg[2], agg[3]),
        key_srcs=key_srcs,
        gcnt_states=gcnt_states,
        limb_srcs=limb_srcs,
        csum_states=csum_states,
        mmf=mmf,
        mmi=mmi,
        fsums=fsums,
        pass_fields=pass_fields,
        pass_width=pass_pos,
        descrs_f=descrs_f,
        descrs_i=descrs_i,
        af_cols=af_cols,
        ai_cols=ai_cols,
        checked_cols=sorted(checked),
        f32_after_filter=f32_after_filter,
    )


class FusedChainPlan:
    """Runtime for a compiled device-resident pipeline (see
    :func:`plan_fused_chain`).  ``run`` streams one morsel through the
    filter/project chain; ``fold`` additionally produces the per-morsel
    partial ``GroupState`` — byte-identical to the reference per-op fold.
    ``stage`` pre-uploads a morsel's kernel inputs (double buffering: the
    H2D transfer of morsel *i+1* overlaps the compute of morsel *i*);
    staged buffers are torn down by ``clear_staged`` on pipeline exit or
    cancel.  Per-morsel envelope violations return ``FUSED_INELIGIBLE``.
    The float sums come from the launch (``fsum_device_folds``), or from
    the compacted table folded on the host where a survivor is NaN or ±inf
    (``fsum_host_folds``)."""

    def __init__(
        self,
        backend,
        *,
        filt,
        out_schema,
        out_decode,
        agg,
        key_srcs,
        gcnt_states,
        limb_srcs,
        csum_states,
        mmf,
        mmi,
        fsums,
        pass_fields,
        pass_width,
        descrs_f,
        descrs_i,
        af_cols,
        ai_cols,
        checked_cols,
        f32_after_filter=False,
    ):
        self._bk = backend
        self._tile = backend.tile
        if filt is None:
            self._op, self._kind, self._t_hi, self._t_lo, self._pred_src = "gt", "none", 0, 0, None
        else:
            self._op, self._kind, self._t_hi, self._t_lo, self._pred_src = filt
        self._out_schema = out_schema
        self._out_decode = out_decode
        if agg is None:
            self._agg_keys = self._aggs = self._mode = self._agg_schema = None
        else:
            self._agg_keys, self._aggs, self._mode, self._agg_schema = agg
        self._key_srcs = key_srcs
        self._gcnt_states = gcnt_states
        self._limb_srcs = limb_srcs
        self._csum_states = csum_states
        self._mmf = mmf
        self._mmi = mmi
        self._fsums = fsums
        self._pass_fields = pass_fields
        self._dp = max(1, pass_width)
        self._limb_base = max(1, _SUM_LIMBS * len(limb_srcs))
        self._descrs_f = descrs_f
        self._descrs_i = descrs_i
        self._nf = len(descrs_f)
        self._csums = tuple(idx for _state, idx in csum_states)
        self._fns_f = tuple(fn for _s, fn, _c in mmf) or ("min",)
        self._fns_i = tuple(fn for _s, fn, _c in mmi) or ("min",)
        self._af_cols = af_cols
        self._ai_cols = ai_cols
        self._with_gidx = bool(fsums)
        self._gidx_off = self._dp + len(descrs_f) + len(descrs_i)
        self._fsum_cols = tuple(self._fsum_col(ref) for _state, ref in fsums)
        self._checked_cols = checked_cols
        self._f32_after_filter = f32_after_filter
        self._sizer = None
        self._dev_idx = None
        self._dev = None
        self._side = None  # the plan's staging stream on a CUDA device
        self._dev_lock = threading.Lock()
        self._staged: dict = {}
        self._stage_lock = threading.Lock()
        self._stage_closed = False

    # -- executor wiring ----------------------------------------------------
    def bind(self, sizer, device_index=None) -> None:
        """Attach the pipeline's stat sink and (optional) CUDA device pin."""
        self._sizer = sizer
        self._dev_idx = device_index

    def _bump(self, counter: str, k: int = 1) -> None:
        if self._sizer is not None:
            self._sizer.bump(counter, k)

    def _device(self) -> torch.device:
        """The plan's device: the backend's, or ``cuda:<index>`` when the
        executor pinned an index.  An index this host lacks raises."""
        with self._dev_lock:
            if self._dev is None:
                if self._dev_idx is None:
                    self._dev = self._bk.device
                else:
                    count = torch.cuda.device_count()
                    if not 0 <= self._dev_idx < count:
                        raise RuntimeError(
                            f"CUDA device index {self._dev_idx} was asked for (ExecutorConfig.devices / "
                            f"DACP_DEVICES), but this host has {count} CUDA device(s)"
                        )
                    self._dev = torch.device("cuda", self._dev_idx)
            return self._dev

    def _side_stream(self, dev: torch.device):
        with self._dev_lock:
            if self._side is None:
                self._side = torch.cuda.Stream(device=dev)
            return self._side

    # -- per-morsel envelope ------------------------------------------------
    def _pad(self, n: int) -> int:
        return -(-n // self._tile) * self._tile

    def _morsel_ok(self, batch: RecordBatch) -> bool:
        n = batch.num_rows
        if n == 0 or n > kernel_ops.SUM_ROW_CAP:
            return False
        for name in self._checked_cols:
            if batch.column(name).validity is not None:
                return False
        return True

    def _short_nan_arith(self, batch: RecordBatch) -> bool:
        """Whether numpy would run float32 arithmetic on NaN inputs over at
        most ``_NUMPY_SHORT_LOOP`` rows — the morsel's, or the survivors'
        when a float32 tree follows the filter — where its choice between
        two NaN operands differs from the kernel's.  Without a NaN input
        every NaN operand carries the same default bits, so the choice
        cannot show."""
        if not self._nf or not any(np.isnan(batch.column(s).values).any() for s in self._af_cols):
            return False
        rows = batch.num_rows
        if self._f32_after_filter and self._kind != "none":
            planes = _col_planes(batch.column(self._pred_src).values, batch.schema.field(self._pred_src).dtype.name)
            pred = torch.from_numpy(np.ascontiguousarray(np.stack(planes, axis=1)))
            rows = int(_pred_mask(pred, self._t_hi, self._t_lo, self._op, self._kind).sum())
        return rows <= _NUMPY_SHORT_LOOP

    # -- double-buffered uploads ---------------------------------------------
    def stage(self, batch: RecordBatch) -> None:
        """Begin the upload of ``batch``'s kernel inputs.  On a CUDA device
        they are encoded into pinned host tensors and copied with
        ``non_blocking`` on the plan's side stream, so the copy overlaps the
        previous morsel's kernel; an event marks its end.  On the CPU the
        encoded tensors are kept as they are.  run/fold pops the staged
        inputs by batch identity."""
        if self._stage_closed or not self._morsel_ok(batch):
            return
        dev = self._device()
        sp = trace.ON and trace.begin("stage", getattr(self._sizer, "request_id", None), leaf=True)
        event = None
        if dev.type == "cuda":
            host = self._encode(batch, pin=True)
            side = self._side_stream(dev)
            with torch.cuda.stream(side):
                put = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
                event = torch.cuda.Event()
                event.record(side)
        else:
            put = self._encode(batch)
        if sp:
            trace.finish(sp)
        with self._stage_lock:
            if self._stage_closed:  # raced a CANCEL teardown: drop, don't leak
                return
            self._staged[id(batch)] = (batch.num_rows, put, event)

    def _take_staged(self, batch: RecordBatch):
        with self._stage_lock:
            entry = self._staged.pop(id(batch), None)
        if entry is None or entry[0] != batch.num_rows:
            return None
        return entry[1], entry[2]

    def clear_staged(self) -> None:
        """Drop every in-flight staged buffer and refuse new ones (pipeline
        exit / CANCEL): a worker racing the teardown inside the source lock
        must not re-stage after the sweep."""
        with self._stage_lock:
            self._stage_closed = True
            self._staged.clear()

    @property
    def staged_count(self) -> int:
        with self._stage_lock:
            return len(self._staged)

    def _inputs(self, batch: RecordBatch, staged, dev: torch.device) -> dict:
        """The morsel's kernel inputs on ``dev``: the staged ones, once the
        launch stream has waited for their copy, or a fresh encode."""
        if staged is None:
            arrs = self._encode(batch)
            return arrs if dev.type == "cpu" else {k: v.to(dev) for k, v in arrs.items()}
        arrs, event = staged
        if event is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(event)
            for t in arrs.values():
                t.record_stream(cur)  # the allocator must not reuse them before the launch ends
        return arrs

    # -- host-side encode / decode -------------------------------------------
    def _encode(self, batch: RecordBatch, pin: bool = False) -> dict:
        n = batch.num_rows
        n_pad = self._pad(n)
        sch = batch.schema
        views: dict = {}

        def table(name, width, np_dt):
            t = torch.zeros((n_pad, max(1, width)), dtype=_TORCH_DT[np.dtype(np_dt)], pin_memory=pin)
            views[name] = t
            return t.numpy()

        if self._kind == "none":
            table("pred", 1, np.int32)
        else:
            planes = _col_planes(batch.column(self._pred_src).values, sch.field(self._pred_src).dtype.name)
            pred = table("pred", len(planes), np.int32)
            for j, p in enumerate(planes):
                pred[:n, j] = p
        pass_tbl = table("pass", self._dp, np.int32)
        for s, dtype, start, _k in self._pass_fields:
            for j, p in enumerate(_col_planes(batch.column(s).values, dtype.name)):
                pass_tbl[:n, start + j] = p
        limb = table("limb", self._limb_base, np.int32)
        for i, (_state, s) in enumerate(self._limb_srcs):
            for k, plane in enumerate(_sum_limbs(np.asarray(batch.column(s).values))):
                limb[:n, _SUM_LIMBS * i + k] = plane
        mmf = table("mmf", len(self._mmf), np.float32)
        for j, (_state, _fn, s) in enumerate(self._mmf):
            mmf[:n, j] = batch.column(s).values
        mmi = table("mmi", len(self._mmi), np.int32)
        for j, (_state, _fn, s) in enumerate(self._mmi):
            mmi[:n, j] = np.asarray(batch.column(s).values).astype(np.int32)
        af = table("af", len(self._af_cols), np.float32)
        for j, s in enumerate(self._af_cols):
            af[:n, j] = batch.column(s).values
        ai = table("ai", len(self._ai_cols), np.int32)
        for j, s in enumerate(self._ai_cols):
            ai[:n, j] = batch.column(s).values
        return views

    def _compact(self, ctab: np.ndarray, counts: np.ndarray) -> np.ndarray:
        t = self._tile
        parts = [ctab[i * t : i * t + int(c)] for i, c in enumerate(counts) if c]
        return np.concatenate(parts) if parts else ctab[:0]

    def _fsum_col(self, ref) -> tuple:
        """(plane offset in a ctab row, kernel kind) of a float sum's column."""
        if ref[0] == "pass":
            return ref[1], _FSUM_KIND.get(ref[3].name, "i32")
        return (self._dp + ref[1], "f32") if ref[0] == "f32" else (self._dp + self._nf + ref[1], "i32")

    def _decode_ref(self, compact: np.ndarray, ref):
        tag = ref[0]
        if tag == "pass":
            _t, start, k, dtype = ref
            return _planes_to_values(compact[:, start : start + k], dtype)
        off = self._dp + ref[1] if tag == "f32" else self._dp + self._nf + ref[1]
        col = np.ascontiguousarray(compact[:, off])
        return col.view(np.float32) if tag == "f32" else col

    def _launch(self, arrs: dict, gidx: torch.Tensor, n: int, segmented: bool, ngroups: int):
        scalars = np.asarray([n, self._t_hi, self._t_lo, 0], np.int32)
        return kernel_ops.fused_chain_tiles(
            scalars,
            arrs["pred"],
            gidx,
            arrs["pass"],
            arrs["limb"],
            arrs["mmf"],
            arrs["mmi"],
            arrs["af"],
            arrs["ai"],
            op=self._op,
            kind=self._kind,
            descrs_f=self._descrs_f,
            descrs_i=self._descrs_i,
            csums=self._csums,
            fns_f=self._fns_f,
            fns_i=self._fns_i,
            with_gidx=self._with_gidx,
            segmented=segmented,
            ngroups=ngroups,
            tile=self._tile,
            fsums=self._fsum_cols if segmented else (),
        )

    # -- streaming chain ------------------------------------------------------
    def run(self, batch: RecordBatch):
        """filter → project → select in one launch.  Returns the output
        morsel, None (fully filtered), or ``FUSED_INELIGIBLE``."""
        staged = self._take_staged(batch)
        if not self._morsel_ok(batch) or self._short_nan_arith(batch):
            return FUSED_INELIGIBLE
        dev = self._device()
        sp = trace.ON and trace.begin("launch", leaf=True)
        arrs = self._inputs(batch, staged, dev)
        gidx = torch.zeros(self._pad(batch.num_rows), dtype=torch.int32, device=dev)
        out = self._launch(arrs, gidx, batch.num_rows, segmented=False, ngroups=8)
        if sp:
            trace.finish(sp)
        sp = trace.ON and trace.begin("readback", leaf=True)
        counts = out[1].cpu().numpy()
        ctab = out[0].cpu().numpy() if counts.any() else None
        if sp:
            trace.finish(sp)
        self._bump("fused_launches")
        if staged is not None:
            self._bump("transfers_overlapped")
        if ctab is None:
            return None
        sp = trace.ON and trace.begin("decode", leaf=True)
        compact = self._compact(ctab, counts)
        cols = []
        for f, ref in self._out_decode:
            vals = self._decode_ref(compact, ref)
            cols.append(Column(f.dtype, values=vals) if ref[0] == "pass" else Column.from_values(f.dtype, vals))
        if sp:
            trace.finish(sp)
        return RecordBatch(self._out_schema, cols)

    # -- aggregate fold --------------------------------------------------------
    def fold(self, batch: RecordBatch):
        """Per-morsel partial aggregate in one launch.  Returns a
        ``GroupState`` byte-identical to the reference per-op fold over the
        filtered morsel, None (no surviving rows), or ``FUSED_INELIGIBLE``.
        Group ids come from factorizing the PRE-filter morsel; the kernel's
        per-group minimum surviving row index reorders the survivors into
        first-seen-filtered order, matching the reference interning."""
        staged = self._take_staged(batch)
        if not self._morsel_ok(batch) or self._short_nan_arith(batch):
            return FUSED_INELIGIBLE
        for _state, fn, s in self._mmf:
            # the reference refuses non-finite float32 min/max inputs; the
            # port also refuses -0.0, as its per-op path does
            if _mm_eligible(batch.column(s).values, fn) is None:
                return FUSED_INELIGIBLE
        from repro_torch.core.operators import GroupState
        from repro_torch.core.schema import Field, Schema

        keys = [k for k, _s in self._key_srcs]
        if all(k == s for k, s in self._key_srcs):
            kb = batch
        else:
            fields = [Field(k, batch.schema.field(s).dtype) for k, s in self._key_srcs]
            kb = RecordBatch(Schema(fields), [batch.column(s) for _k, s in self._key_srcs])
        sp = trace.ON and trace.begin("factorize", leaf=True)
        tmp = GroupState(keys, {}, self._mode, kb.schema, vectorized=True)
        gidx_full = tmp._factorize(kb)
        if sp:
            trace.finish(sp)
        ng = len(tmp.gids)
        if ng == 0 or ng > _SEG_GROUP_CAP:
            return FUSED_INELIGIBLE
        g_pad = max(8, -(-ng // 8) * 8)
        dev = self._device()
        sp = trace.ON and trace.begin("launch", leaf=True)
        arrs = self._inputs(batch, staged, dev)
        n = batch.num_rows
        g32 = np.zeros(self._pad(n), np.int32)
        g32[:n] = gidx_full
        out = self._launch(arrs, torch.from_numpy(g32).to(dev), n, segmented=True, ngroups=g_pad)
        if sp:
            trace.finish(sp)
        sp = trace.ON and trace.begin("readback", leaf=True)
        gsum, gcnt, gmmf, gmmi, gfirst, fsum, nonfinite = fused_pipeline.groups_to_host(out)
        gcnt_v = gcnt[:ng]
        alive = np.flatnonzero(gcnt_v > 0)
        # a NaN or ±inf survivor: the float64 sums folded on the host, from the compacted table
        host_fold = bool(self._fsums and alive.size and nonfinite[0])
        ctab, counts = (out[0].cpu().numpy(), out[1].cpu().numpy()) if host_fold else (None, None)
        if sp:
            trace.finish(sp)
        self._bump("fused_launches")
        if staged is not None:
            self._bump("transfers_overlapped")
        if alive.size == 0:
            return None
        if self._fsums:
            self._bump("fsum_host_folds" if host_fold else "fsum_device_folds")
        sp = trace.ON and trace.begin("decode", leaf=True)
        perm = alive[np.argsort(gfirst[:ng][alive], kind="stable")]
        st = GroupState(
            self._agg_keys, self._aggs, self._mode, self._agg_schema, vectorized=True, backend=self._bk
        )
        st.key_rows = [tmp.key_rows[g] for g in perm]
        st.gids = {kt: i for i, kt in enumerate(st.key_rows)}
        acc: dict = {}
        for state in self._gcnt_states:
            acc[state] = gcnt_v[perm].astype(np.int64)
        for i, (state, _s) in enumerate(self._limb_srcs):
            acc[state] = _limbs_to_int64(gsum[:, _SUM_LIMBS * i : _SUM_LIMBS * (i + 1)][perm])
        base = self._limb_base
        for j, (state, _idx) in enumerate(self._csum_states):
            s4 = gsum[perm, base + 4 * j : base + 4 * (j + 1)].astype(np.int64)
            acc[state] = s4[:, 0] + (s4[:, 1] << 8) + (s4[:, 2] << 16) + (s4[:, 3] << 24)
        for j, (state, _fn, _s) in enumerate(self._mmf):
            acc[state] = gmmf[perm, j].astype(np.float64)
        for j, (state, _fn, _s) in enumerate(self._mmi):
            acc[state] = gmmi[perm, j].astype(np.int64)
        if host_fold:
            compact = self._compact(ctab, counts)
            g_sel = compact[:, self._gidx_off]
            for state, ref in self._fsums:
                vals = np.asarray(self._decode_ref(compact, ref), np.float64)
                accf = np.zeros(ng, np.float64)
                np.add.at(accf, g_sel, vals)
                acc[state] = accf[perm]
        else:
            for j, (state, _ref) in enumerate(self._fsums):
                acc[state] = fsum[perm, j]
        for name, (_init, dt) in st._state_specs().items():
            st.acc[name] = np.ascontiguousarray(np.asarray(acc[name], dt))
        if sp:
            trace.finish(sp)
        return st

# ---------------------------------------------------------------------------
# backend selection
# ---------------------------------------------------------------------------
BACKENDS = {"numpy": NumpyBackend, "torch": TorchBackend}
_instances: dict = {}
_instances_lock = threading.Lock()


def available_backends() -> list:
    return ["numpy", "torch"]


def get_backend(name: str | None = None, device: str | torch.device | None = None) -> ComputeBackend:
    """Resolve a backend by name.  ``auto`` (default, or env
    ``DACP_BACKEND``) is torch.  The torch backend runs on ``device``
    (``"cuda"`` when None; ``"cpu"`` only when asked for) and raises when a
    CUDA device is asked for and none is present; numpy ignores it."""
    name = name or env_str("DACP_BACKEND")
    if name == "auto":
        name = "torch"
    if name not in BACKENDS:
        raise KeyError(f"unknown compute backend {name!r}; known: {sorted(BACKENDS)}")
    key = (name, None if name == "numpy" else str(device_mod.resolve(device)))
    with _instances_lock:
        inst = _instances.get(key)
        if inst is None:
            inst = _instances[key] = NumpyBackend() if name == "numpy" else TorchBackend(key[1])
        return inst
