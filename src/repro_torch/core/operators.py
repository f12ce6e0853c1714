"""Operator library: morsel-pure evaluators + the reference pull driver
(paper §III-B, §IV-B).

The module is split in two layers since the executor refactor:

  * **morsel-pure functions** (``filter_morsel``, ``select_morsel``,
    ``project_morsel``, ``map_morsel``, ``join_probe_morsel``) — each maps
    one RecordBatch to at most one RecordBatch with no cross-batch state.
    They are the unit of work the morsel-driven parallel driver
    (``repro_torch.core.executor``) hands to its workers, and they take a
    ``ComputeBackend`` so eligible morsels dispatch to Pallas kernels.
  * **streaming evaluators + ``execute``** — the reference lazy pull chain
    (reverse supply): building an executor does no work; iterating the
    output recursively pulls from inputs one batch at a time — the paper's
    §III-D execution model, single-threaded.  ``SDFEngine`` uses the
    parallel driver by default and keeps this path as the ``num_workers=0``
    reference/fallback.

``map`` operators reference functions from a **named registry** — the DAG
itself never carries code.  Each registered fn declares the columns it reads
and writes so the pushdown optimizer can reorder filters around it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from repro_torch.core.batch import Column, RecordBatch, concat_batches
from repro_torch.core.dag import Dag, Node
from repro_torch.core.dtypes import resolve as resolve_dtype
from repro_torch.core.errors import PlanError, SchemaError
from repro_torch.core.expr import Expr
from repro_torch.core.schema import Field, Schema
from repro_torch.core.sdf import StreamingDataFrame

__all__ = [
    "MapFn",
    "register_map",
    "get_map",
    "MAP_REGISTRY",
    "execute",
    "execute_node",
    "filter_morsel",
    "select_morsel",
    "project_morsel",
    "project_schema",
    "map_morsel",
    "join_schema",
    "build_join_table",
    "join_probe_indices",
    "join_probe_morsel",
    "GroupState",
    "agg_out_fields",
]


# ---------------------------------------------------------------------------
# map-fn registry
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MapFn:
    name: str
    fn: Callable  # (RecordBatch, **params) -> RecordBatch
    schema_fn: Callable  # (Schema, **params) -> Schema
    reads: tuple  # column names read ("*" = all)
    writes: tuple  # column names written/created


MAP_REGISTRY: dict = {}


def register_map(name: str, reads=("*",), writes=()):
    def deco(fn):
        def default_schema(schema: Schema, **params) -> Schema:
            return schema

        schema_fn = getattr(fn, "schema_fn", default_schema)
        MAP_REGISTRY[name] = MapFn(name, fn, schema_fn, tuple(reads), tuple(writes))
        return fn

    return deco


def get_map(name: str) -> MapFn:
    try:
        return MAP_REGISTRY[name]
    except KeyError:
        raise PlanError(f"map fn {name!r} is not registered on this server") from None


# a few built-in maps used by the data pipeline and tests -------------------------
def _schema_add(name: str, dtype: str):
    def sf(schema: Schema, **params) -> Schema:
        out = name if "out" not in params else params["out"]
        f = Field(out, resolve_dtype(dtype))
        if out in schema:
            return schema  # replaced in-place by with_column
        return schema.append(f)

    return sf


def _blob_lengths(batch: RecordBatch, column: str, out: str = "nbytes") -> RecordBatch:
    c = batch.column(column)
    if c.dtype.is_varwidth:
        lens = (c.offsets[1:] - c.offsets[:-1]).astype(np.int64)
    else:
        lens = np.full(batch.num_rows, c.dtype.width, dtype=np.int64)
    return batch.with_column(Field(out, resolve_dtype("int64")), Column.from_values(resolve_dtype("int64"), lens))


_blob_lengths.schema_fn = _schema_add("nbytes", "int64")
register_map("blob_lengths", reads=("*",), writes=("nbytes",))(_blob_lengths)


def _lowercase(batch: RecordBatch, column: str) -> RecordBatch:
    c = batch.column(column)
    vals = [v.lower() if isinstance(v, str) else v for v in c.to_pylist()]
    return batch.with_column(batch.schema.field(column), Column.from_values(c.dtype, vals))


register_map("lowercase", reads=("*",), writes=())(_lowercase)


# ---------------------------------------------------------------------------
# morsel-pure operator functions (shared by the pull chain and the parallel
# executor; each maps one batch -> one batch or None, no cross-batch state)
# ---------------------------------------------------------------------------
def filter_morsel(batch: RecordBatch, predicate: Expr, backend=None) -> RecordBatch | None:
    """Surviving rows of one morsel, or None when fully masked (no empty
    frames downstream).  ``backend`` dispatches eligible morsels to
    accelerator kernels; None means the numpy reference path."""
    if backend is not None:
        return backend.filter(batch, predicate)
    mask = np.asarray(predicate.evaluate(batch), dtype=bool)
    if mask.all():
        return batch
    if not mask.any():
        return None
    return batch.filter(mask)


def select_morsel(batch: RecordBatch, columns: list) -> RecordBatch:
    return batch.select(columns)


def map_morsel(batch: RecordBatch, mf: "MapFn", fn_params: dict) -> RecordBatch:
    return mf.fn(batch, **fn_params)


def project_morsel(batch: RecordBatch, exprs: dict, out_schema: Schema) -> RecordBatch:
    """Evaluate projection exprs against one morsel, shaping the output to a
    precomputed schema (dtype-coerced — morsel workers must all agree)."""
    new_cols = {}
    for name, e in exprs.items():
        vals = np.asarray(e.evaluate(batch))
        if vals.ndim == 0:
            vals = np.full(batch.num_rows, vals[()])
        f = out_schema.field(name)
        if not f.dtype.is_varwidth and vals.dtype != f.dtype.np_dtype:
            vals = vals.astype(f.dtype.np_dtype)
        new_cols[name] = Column.from_values(f.dtype, vals)
    cols = [new_cols[f.name] if f.name in new_cols else batch.column(f.name) for f in out_schema]
    return RecordBatch(out_schema, cols)


# ---------------------------------------------------------------------------
# per-node streaming evaluators
# ---------------------------------------------------------------------------
def _eval_filter(node: Node, ins: list) -> StreamingDataFrame:
    (src,) = ins
    pred: Expr = node.params["predicate"]

    def gen() -> Iterator[RecordBatch]:
        for b in src.iter_batches():
            out = filter_morsel(b, pred)
            if out is not None:
                yield out

    return StreamingDataFrame(src.schema, gen)


def _eval_select(node: Node, ins: list) -> StreamingDataFrame:
    (src,) = ins
    cols = list(node.params["columns"])
    schema = src.schema.select(cols)

    def gen():
        for b in src.iter_batches():
            yield select_morsel(b, cols)

    return StreamingDataFrame(schema, gen)


def project_schema(src_schema: Schema, exprs: dict, keep: bool) -> Schema:
    return _infer_project_schema(src_schema, exprs, keep)


def _infer_project_schema(src_schema: Schema, exprs: dict, keep: bool) -> Schema:
    """Infer projection dtypes by evaluating on an empty batch (cheap, exact)."""
    from repro_torch.core import dtypes as _dt

    empty = RecordBatch.empty(src_schema)
    fields = list(src_schema.fields) if keep else []
    names = {f.name for f in fields}
    for name, e in exprs.items():
        vals = np.asarray(e.evaluate(empty))
        if vals.ndim == 0:  # literal broadcast: dtype of the scalar
            vals = np.asarray([vals[()]])
        try:
            dt = _dt.from_numpy(vals.dtype)
        except KeyError:
            dt = _dt.STRING
        f = Field(name, dt)
        if name in names:
            fields[[x.name for x in fields].index(name)] = f
        else:
            fields.append(f)
            names.add(name)
    return Schema(fields)


def _eval_project(node: Node, ins: list) -> StreamingDataFrame:
    (src,) = ins
    exprs: dict = node.params["exprs"]
    keep: bool = bool(node.params.get("keep", True))

    schema_holder = {"schema": _infer_project_schema(src.schema, exprs, keep)}

    def _projected(b: RecordBatch):
        from repro_torch.core import dtypes as _dt

        cols = []
        for name, e in exprs.items():
            vals = np.asarray(e.evaluate(b))
            if vals.ndim == 0:
                vals = np.full(b.num_rows, vals[()])
            dt = _dt.from_numpy(vals.dtype)
            cols.append((Field(name, dt), Column.from_values(dt, vals)))
        return cols

    def gen():
        for b in src.iter_batches():
            new_cols = _projected(b)
            if keep:
                out = b
                for f, c in new_cols:
                    out = out.with_column(f, c)
            else:
                out = RecordBatch(Schema([f for f, _ in new_cols]), [c for _, c in new_cols])
            schema_holder["schema"] = out.schema
            yield out

    return StreamingDataFrame(schema_holder["schema"], gen)


def _eval_map(node: Node, ins: list) -> StreamingDataFrame:
    (src,) = ins
    mf = get_map(node.params["fn"])
    fn_params = dict(node.params.get("fn_params", {}))
    schema = mf.schema_fn(src.schema, **fn_params)

    def gen():
        for b in src.iter_batches():
            yield map_morsel(b, mf, fn_params)

    return StreamingDataFrame(schema, gen)


def _eval_rebatch(node: Node, ins: list) -> StreamingDataFrame:
    (src,) = ins
    rows = int(node.params["rows"])
    if rows <= 0:
        raise PlanError("rebatch rows must be positive")

    def gen():
        pend: list = []
        pend_rows = 0
        for b in src.iter_batches():
            pend.append(b)
            pend_rows += b.num_rows
            while pend_rows >= rows:
                merged = concat_batches(pend)
                yield merged.slice(0, rows)
                rest = merged.slice(rows, merged.num_rows)
                pend = [rest] if rest.num_rows else []
                pend_rows = rest.num_rows
        if pend_rows:
            yield concat_batches(pend)

    return StreamingDataFrame(src.schema, gen)


def _eval_limit(node: Node, ins: list) -> StreamingDataFrame:
    (src,) = ins
    n = int(node.params["n"])

    def gen():
        seen = 0
        if n <= 0:
            return
        for b in src.iter_batches():
            if seen + b.num_rows >= n:
                yield b.slice(0, n - seen)  # no further upstream pulls
                return
            seen += b.num_rows
            yield b

    return StreamingDataFrame(src.schema, gen)


# ---------------------------------------------------------------------------
# aggregation (group_by().agg() — full / partial / final modes)
# ---------------------------------------------------------------------------
def _sum_dtype(dt):
    return resolve_dtype("int64") if dt.is_integer else resolve_dtype("float64")


def agg_out_fields(in_schema: Schema, keys: list, aggs: dict, mode: str) -> list:
    return _agg_out_fields(in_schema, keys, aggs, mode)


def _agg_out_fields(in_schema: Schema, keys: list, aggs: dict, mode: str) -> list:
    """Output fields for an aggregate node.  ``partial`` emits decomposed
    state (sum+count for mean) so partials union/exchange cleanly and a
    ``final`` stage can combine them."""
    fields = [in_schema.field(k) for k in keys]
    for out, spec in aggs.items():
        fn = spec["fn"]
        column = spec.get("column")
        if fn == "count":
            fields.append(Field(out, resolve_dtype("int64")))
        elif fn == "mean":
            if mode == "partial":
                fields.append(Field(f"{out}__psum", resolve_dtype("float64")))
                fields.append(Field(f"{out}__pcnt", resolve_dtype("int64")))
            else:
                fields.append(Field(out, resolve_dtype("float64")))
        elif fn == "sum":
            src = in_schema.field(_agg_src(out, spec, mode)).dtype
            fields.append(Field(out, _sum_dtype(src)))
        else:  # min / max keep the input dtype
            src = in_schema.field(_agg_src(out, spec, mode)).dtype
            fields.append(Field(out, src))
    return fields


def _agg_src(out: str, spec: dict, mode: str) -> str:
    """Column an agg reads: the user column, or the partial-state column when
    combining (mode=final reads the partial stage's output names)."""
    if mode == "final":
        return out
    return spec.get("column")


class GroupState:
    """Incremental hash-aggregation state across batches (streaming: the
    input is consumed batch-by-batch, never concatenated).

    ``vectorized=True`` (the parallel executor's mode) factorizes fixed-width
    key columns with ``np.unique`` — the python loop shrinks from per-row to
    per-distinct-group-per-batch.  Var-width keys keep the reference row loop
    so first-seen group order is preserved for string keys either way.

    Partial states combine with ``merge`` — the morsel driver builds one
    state per morsel and merges them in morsel order, so the grouped output
    is deterministic regardless of worker count.

    ``backend`` (a ``ComputeBackend``) lets the per-batch fold dispatch to
    the backend's ``segment_reduce`` kernel once the keys are factorized:
    eligible aggregates (counts, integer sums, int32/finite-f32 min/max)
    fold on the accelerator, the rest scatter with numpy — bit-identical
    either way, so a ``None`` backend is the reference semantics.
    """

    def __init__(
        self,
        keys: list,
        aggs: dict,
        mode: str,
        in_schema: Schema,
        vectorized: bool = False,
        backend=None,
    ):
        self.keys = keys
        self.aggs = aggs
        self.mode = mode
        self.in_schema = in_schema
        self.backend = backend
        self.vectorized = vectorized and all(not in_schema.field(k).dtype.is_varwidth for k in keys)
        self.gids: dict = {}  # key tuple -> group id
        self.key_rows: list = []  # representative key values per group
        # state name -> numpy accumulator (grown as groups appear)
        self.acc: dict = {name: np.zeros(0, dt) for name, (_, dt) in self._state_specs().items()}

    def _state_specs(self) -> dict:
        """state name -> (init value, accumulator numpy dtype).

        Integer sum/min/max accumulate in int64 (exact — float64 would
        silently corrupt values past 2^53); floats accumulate in float64.
        """
        specs = {}
        for out, spec in self.aggs.items():
            fn = spec["fn"]
            if fn == "mean":
                specs[f"{out}__psum"] = (0.0, np.float64)
                specs[f"{out}__pcnt"] = (0, np.int64)
            elif fn == "count":
                specs[out] = (0, np.int64)
            else:
                src_dt = self.in_schema.field(_agg_src(out, spec, self.mode)).dtype
                if src_dt.is_integer:
                    if fn in ("min", "max") and src_dt.name == "uint64":
                        # int64 accumulation would wrap values past 2^63 and
                        # compare them under signed order — min over
                        # [1, 2^63+5] must be 1, not the wrapped negative
                        init = {"min": np.iinfo(np.uint64).max, "max": 0}[fn]
                        specs[out] = (init, np.uint64)
                    else:
                        init = {"sum": 0, "min": np.iinfo(np.int64).max, "max": np.iinfo(np.int64).min}[fn]
                        specs[out] = (init, np.int64)
                else:
                    init = {"sum": 0.0, "min": np.inf, "max": -np.inf}[fn]
                    specs[out] = (init, np.float64)
        return specs

    def _intern_groups(self, key_tuples) -> np.ndarray:
        """Map key tuples to (new or existing) group ids."""
        out = np.empty(len(key_tuples), dtype=np.int64)
        gids = self.gids
        for i, kt in enumerate(key_tuples):
            g = gids.get(kt)
            if g is None:
                g = len(gids)
                gids[kt] = g
                self.key_rows.append(kt)
            out[i] = g
        return out

    def _factorize_dense(self, a: np.ndarray):
        """Sort-free factorization for a single integer key over a small
        value range: one scatter builds a first-occurrence LUT instead of
        ``np.unique``'s full-array argsort (the hot path of the aggregate
        fold).  Returns per-row group ids, or None when ineligible."""
        if a.dtype.kind not in "iu" or len(a) == 0:
            return None
        mn, mx = int(a.min()), int(a.max())
        span = mx - mn + 1
        if span > max(1024, 4 * len(a)):
            return None  # LUT would dwarf the batch; np.unique wins
        if a.dtype.kind == "u":
            # native unsigned subtract is exact (every value >= mn) and keeps
            # uint64 keys above 2^63 out of lossy int64 territory
            off = (a - mn).astype(np.int64) if mn else a.astype(np.int64)
        else:
            # widen BEFORE subtracting: narrow signed dtypes (int8 keys
            # spanning -100..100) would wrap in native arithmetic
            off = a.astype(np.int64) - mn
        first = np.full(span, -1, np.int64)
        first[off[::-1]] = np.arange(len(a) - 1, -1, -1, dtype=np.int64)
        vals_off = np.flatnonzero(first >= 0)
        order = np.argsort(first[vals_off], kind="stable")  # first-seen rank
        rank = np.empty(len(order), np.int64)
        rank[order] = np.arange(len(order))
        lut = np.empty(span, np.int64)
        lut[vals_off] = rank
        uniq_keys = [(int(v) + mn,) for v in vals_off[order].tolist()]
        return self._intern_groups(uniq_keys)[lut[off]]

    def _factorize(self, batch: RecordBatch) -> np.ndarray:
        """Per-row group ids for one batch.  The vectorized path matches the
        reference row loop exactly: new groups intern in first-seen row
        order, and any validity mask on a key column falls back to the row
        loop (null keys must stay distinct from the sentinel value)."""
        key_cols = [batch.column(k) for k in self.keys]
        if self.vectorized and all(c.validity is None for c in key_cols):
            arrs = [np.ascontiguousarray(c.values) for c in key_cols]
            if len(arrs) == 1:
                dense = self._factorize_dense(arrs[0])
                if dense is not None:
                    return dense
                uniq, first_idx, inv = np.unique(arrs[0], return_index=True, return_inverse=True)
            else:
                comb = np.empty(batch.num_rows, dtype=[(f"k{i}", a.dtype) for i, a in enumerate(arrs)])
                for i, a in enumerate(arrs):
                    comb[f"k{i}"] = a
                uniq, first_idx, inv = np.unique(comb, return_index=True, return_inverse=True)
            # np.unique sorts; re-rank uniques by first occurrence so group
            # ids come out in first-seen row order (reference parity)
            order = np.argsort(first_idx, kind="stable")
            rank = np.empty(len(order), np.int64)
            rank[order] = np.arange(len(order))
            uniq = uniq[order]
            uniq_keys = [(v,) for v in uniq.tolist()] if len(arrs) == 1 else [tuple(v) for v in uniq.tolist()]
            return self._intern_groups(uniq_keys)[rank[inv.reshape(-1)]]
        # reference path: factorize the key tuple per row
        key_lists = [c.to_pylist() for c in key_cols]
        return self._intern_groups(list(zip(*key_lists)))

    def _grow(self) -> None:
        """Grow every accumulator to the current group count in one shot."""
        ngroups = len(self.gids)
        for name, (init, dt) in self._state_specs().items():
            cur = self.acc[name]
            if len(cur) < ngroups:
                self.acc[name] = np.concatenate([cur, np.full(ngroups - len(cur), init, dt)])

    def _kernel_specs(self, batch: RecordBatch, fresh: bool = False) -> list:
        """(state name, fn, values) triples for ``backend.segment_reduce``.
        The backend accelerates the subset it can reproduce bit-exactly and
        ``update`` scatters the remainder with numpy.

        Float sums (and mean partial sums) are tagged ``fsum`` when the
        state is ``fresh`` (no groups yet — the executor's per-morsel fold):
        starting from +0.0 accumulators, a backend may fold them in its
        f64-accumulating reference path bit-identically.  A reused state
        keeps the plain ``sum`` tag (sequential ``np.add.at`` into non-zero
        accumulators has no order-free equivalent), which backends ignore.
        """
        specs = []
        for out, spec in self.aggs.items():
            fn = spec["fn"]
            if fn == "count":
                if self.mode == "final":
                    specs.append((out, "sum", np.asarray(batch.column(out).values)))
                else:
                    specs.append((out, "count", None))
            elif fn == "mean":
                # psum folds in float64 — fresh states expose it as an
                # ``fsum``; pcnt is a plain count (final mode: a sum of the
                # partial counts)
                if fresh:
                    psrc = f"{out}__psum" if self.mode == "final" else spec["column"]
                    specs.append((f"{out}__psum", "fsum", np.asarray(batch.column(psrc).to_numpy(), np.float64)))
                if self.mode == "final":
                    specs.append((f"{out}__pcnt", "sum", np.asarray(batch.column(f"{out}__pcnt").values)))
                else:
                    specs.append((f"{out}__pcnt", "count", None))
            else:
                vals = np.asarray(batch.column(_agg_src(out, spec, self.mode)).to_numpy())
                if fn == "sum" and fresh and vals.dtype.kind == "f":
                    specs.append((out, "fsum", np.asarray(vals, np.float64)))
                else:
                    specs.append((out, fn, vals))
        return specs

    def update(self, batch: RecordBatch) -> None:
        n = batch.num_rows
        if n == 0:
            return
        fresh = not self.gids
        gidx = self._factorize(batch)
        self._grow()
        ngroups = len(self.gids)
        kres: dict = {}
        if self.backend is not None:
            kres = self.backend.segment_reduce(gidx, ngroups, self._kernel_specs(batch, fresh), n) or {}
        counts = None

        def _counts():
            nonlocal counts
            if counts is None:
                counts = np.bincount(gidx, minlength=ngroups)
            return counts

        # scatter each batch's values straight into the (dtype-exact)
        # accumulators; kernel-folded states combine vectorized instead
        for out, spec in self.aggs.items():
            fn = spec["fn"]
            if fn == "count":
                if out in kres:
                    self.acc[out][:ngroups] += kres[out]
                elif self.mode == "final":
                    vals = np.asarray(batch.column(out).values, dtype=np.int64)
                    np.add.at(self.acc[out], gidx, vals)
                else:
                    self.acc[out] += _counts()
            elif fn == "mean":
                pc, ps = f"{out}__pcnt", f"{out}__psum"
                if self.mode == "final":
                    if ps in kres:
                        self.acc[ps][:ngroups] += kres[ps]
                    else:
                        np.add.at(self.acc[ps], gidx, np.asarray(batch.column(ps).values, np.float64))
                    if pc in kres:
                        self.acc[pc][:ngroups] += kres[pc]
                    else:
                        np.add.at(self.acc[pc], gidx, np.asarray(batch.column(pc).values, np.int64))
                else:
                    if ps in kres:
                        self.acc[ps][:ngroups] += kres[ps]
                    else:
                        vals = np.asarray(batch.column(spec["column"]).to_numpy(), dtype=np.float64)
                        np.add.at(self.acc[ps], gidx, vals)
                    if pc in kres:
                        self.acc[pc][:ngroups] += kres[pc]
                    else:
                        self.acc[pc] += _counts()
            else:  # sum / min / max
                cur = self.acc[out]
                if out in kres:
                    if fn == "sum":
                        cur[:ngroups] += kres[out]
                    else:
                        op = np.minimum if fn == "min" else np.maximum
                        cur[:ngroups] = op(cur[:ngroups], kres[out].astype(cur.dtype))
                else:
                    vals = np.asarray(batch.column(_agg_src(out, spec, self.mode)).to_numpy()).astype(cur.dtype)
                    op = {"sum": np.add, "min": np.minimum, "max": np.maximum}[fn]
                    op.at(cur, gidx, vals)

    def merge(self, other: "GroupState") -> "GroupState":
        """Combine another partial state into this one (same keys/aggs/mode).
        Each of ``other``'s groups maps to a distinct group here, so the
        combine is a plain fancy-indexed binary op per accumulator."""
        self.merge_indexed(other)
        return self

    def merge_indexed(self, other: "GroupState") -> np.ndarray:
        """``merge``, returning the group index of each of ``other``'s groups
        in this state (the spill path maps per-group metadata through it)."""
        m = len(other.key_rows)
        if m == 0:
            return np.zeros(0, np.int64)
        idx = self._intern_groups(other.key_rows)
        self._grow()
        for out, spec in self.aggs.items():
            fn = spec["fn"]
            if fn == "mean":
                for part in (f"{out}__psum", f"{out}__pcnt"):
                    self.acc[part][idx] += other.acc[part][:m]
            else:
                op = {"sum": np.add, "count": np.add, "min": np.minimum, "max": np.maximum}[fn]
                cur = self.acc[out]
                cur[idx] = op(cur[idx], other.acc[out][:m])
        return idx

    def approx_nbytes(self) -> int:
        """Accounted size of this state: accumulator buffers plus an
        estimate of the python-side group directory (dict slot + key tuple
        + interned key values).  Used by the executor's memory budget — an
        estimate is fine, the budget is a spill trigger, not an allocator."""
        acc = sum(a.nbytes for a in self.acc.values())
        per_group = 56  # dict entry + tuple header
        for k in self.keys:
            dt = self.in_schema.field(k).dtype
            per_group += 24 if dt.is_varwidth else dt.width + 8
        return acc + len(self.key_rows) * per_group

    def _key_column(self, f, vals: list) -> Column:
        """Key output column; null keys (masked input rows) materialize as a
        validity-masked column rather than crashing ``from_values``."""
        null = [v is None for v in vals]
        if not any(null):
            return Column.from_values(f.dtype, vals)
        fill = "" if f.dtype.name == "string" else (b"" if f.dtype.name == "binary" else 0)
        c = Column.from_values(f.dtype, [fill if m else v for v, m in zip(vals, null)])
        c.validity = np.asarray([not m for m in null], dtype=bool)
        return c

    def result(self, out_schema: Schema) -> RecordBatch:
        ngroups = len(self.key_rows)
        data = {}
        for i, k in enumerate(self.keys):
            data[k] = [row[i] for row in self.key_rows]
        for out, spec in self.aggs.items():
            fn = spec["fn"]
            if fn == "mean":
                psum = self.acc[f"{out}__psum"]
                pcnt = self.acc[f"{out}__pcnt"]
                if self.mode == "partial":
                    data[f"{out}__psum"] = psum
                    data[f"{out}__pcnt"] = pcnt
                else:
                    data[out] = psum / np.maximum(pcnt, 1)
            else:
                f = out_schema.field(out)
                vals = self.acc[out]
                data[out] = vals.astype(f.dtype.np_dtype) if ngroups else np.zeros(0, f.dtype.np_dtype)
        cols = []
        for f in out_schema:
            vals = data[f.name]
            if f.name in self.keys and not isinstance(vals, np.ndarray):
                cols.append(self._key_column(f, vals))
            else:
                cols.append(Column.from_values(f.dtype, vals if not isinstance(vals, np.ndarray) else np.asarray(vals, f.dtype.np_dtype)))
        return RecordBatch(out_schema, cols)


def _eval_aggregate(node: Node, ins: list) -> StreamingDataFrame:
    (src,) = ins
    keys = list(node.params["keys"])
    aggs = dict(node.params["aggs"])
    mode = node.params.get("mode", "full")
    missing = [k for k in keys if k not in src.schema]
    if missing:
        raise SchemaError(f"aggregate keys missing from input: {missing}")
    out_schema = Schema(_agg_out_fields(src.schema, keys, aggs, mode))

    def gen():
        state = GroupState(keys, aggs, mode, src.schema)
        for b in src.iter_batches():
            state.update(b)
        yield state.result(out_schema)

    return StreamingDataFrame(out_schema, gen)


# back-compat alias for the pre-refactor private name
_GroupState = GroupState


# ---------------------------------------------------------------------------
# join (inner equi-join: right side builds the hash table, left side probes)
# ---------------------------------------------------------------------------
def join_schema(left: Schema, right: Schema, on: list) -> tuple:
    return _join_schema(left, right, on)


def build_join_table(build: RecordBatch, on: list) -> dict:
    """key tuple -> row indices of the (materialized) build side."""
    table: dict = {}
    if build.num_rows:
        for i, kt in enumerate(zip(*[build.column(k).to_pylist() for k in on])):
            table.setdefault(kt, []).append(i)
    return table


def join_probe_indices(batch: RecordBatch, table: dict, on: list) -> tuple:
    """(probe row indices, build row indices) of the matches of one morsel —
    probe-major, build rows in build order within each probe row."""
    probe_keys = list(zip(*[batch.column(k).to_pylist() for k in on]))
    lidx, ridx = [], []
    for i, kt in enumerate(probe_keys):
        for j in table.get(kt, ()):
            lidx.append(i)
            ridx.append(j)
    return np.asarray(lidx, np.int64), np.asarray(ridx, np.int64)


def join_probe_morsel(
    batch: RecordBatch, build: RecordBatch, table: dict, on: list, payload: list, schema: Schema
) -> RecordBatch | None:
    """Probe one morsel against a prebuilt hash table; None when no matches."""
    if batch.num_rows == 0:
        return None
    lidx, ridx = join_probe_indices(batch, table, on)
    if len(lidx) == 0:
        return None
    lpart = batch.take(lidx)
    rpart = build.take(ridx)
    cols = list(lpart.columns)
    for name in payload:
        cols.append(rpart.column(name))
    return RecordBatch(schema, cols)


def _join_schema(left: Schema, right: Schema, on: list) -> tuple:
    """(schema, right_payload_names, rename_map).  Right non-key columns that
    collide with left names get an ``_r`` suffix."""
    for k in on:
        if k not in left or k not in right:
            raise SchemaError(f"join key {k!r} missing from an input")
    fields = list(left.fields)
    left_names = {f.name for f in fields}
    payload, rename = [], {}
    for f in right:
        if f.name in on:
            continue
        name = f.name
        if name in left_names:
            name = f"{f.name}_r"
            if name in left_names:
                raise SchemaError(f"join output column collision on {name!r}")
            rename[f.name] = name
        fields.append(Field(name, f.dtype, f.nullable, f.metadata))
        payload.append(f.name)
    return Schema(fields), payload, rename


def _eval_join(node: Node, ins: list) -> StreamingDataFrame:
    left, right = ins
    on = list(node.params["on"])
    schema, payload, _rename = _join_schema(left.schema, right.schema, on)

    def gen():
        # build: materialize the right side into key -> row indices
        build = right.collect()
        table = build_join_table(build, on)
        # probe: stream the left side, emitting matches per batch
        for b in left.iter_batches():
            out = join_probe_morsel(b, build, table, on, payload, schema)
            if out is not None:
                yield out

    return StreamingDataFrame(schema, gen)


def _eval_union(node: Node, ins: list) -> StreamingDataFrame:
    schema = ins[0].schema
    for s in ins[1:]:
        if not s.schema.equals(schema):
            raise SchemaError("union over mismatched schemas")

    def gen():
        for s in ins:
            yield from s.iter_batches()

    return StreamingDataFrame(schema, gen)


_EVAL = {
    "filter": _eval_filter,
    "select": _eval_select,
    "project": _eval_project,
    "map": _eval_map,
    "rebatch": _eval_rebatch,
    "limit": _eval_limit,
    "union": _eval_union,
    "aggregate": _eval_aggregate,
    "join": _eval_join,
}


def execute_node(node: Node, inputs: list) -> StreamingDataFrame:
    try:
        fn = _EVAL[node.op]
    except KeyError:
        raise PlanError(f"operator {node.op!r} has no local evaluator") from None
    return fn(node, inputs)


def execute(dag: Dag, source_resolver: Callable[[Node], StreamingDataFrame]) -> StreamingDataFrame:
    """Wire the DAG into a lazy pull pipeline and return the output SDF.

    ``source_resolver`` materializes ``source`` / ``exchange`` leaves — the
    server resolves URIs against its catalog; the scheduler resolves exchanges
    against remote pulls.
    """
    materialized: dict = {}
    for nid in dag.topological_order():
        node = dag.nodes[nid]
        if node.op in ("source", "exchange"):
            materialized[nid] = source_resolver(node)
        else:
            materialized[nid] = execute_node(node, [materialized[i] for i in node.inputs])
    return materialized[dag.output]
