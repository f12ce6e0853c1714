"""Parquet adapter (optional ``pyarrow``): row-group pruning pushdown.

pyarrow is an *optional* dependency.  When it is missing the registry
matcher reports False, so ``.parquet`` files degrade cleanly to the blob
catch-all (capability degradation, not an import error) — DESCRIBE still
answers with bytes, and a scan still streams chunks.

With pyarrow present:

  * column projection is native (``ParquetFile.iter_batches(columns=...)``
    never decodes unprojected column chunks);
  * predicate *pruning* uses the footer's per-row-group min/max statistics:
    a comparison or isin conjunct that is provably false for a whole row
    group skips it before any data pages are read.  Pruning is a superset
    optimization — the whole predicate stays residual — and a row group
    whose stats are absent, or whose column has nulls (the residual filter
    sees fill values for those), is never skipped;
  * the row-group index is the ``part_range`` split unit.
"""

from __future__ import annotations

import importlib.util

import numpy as np

from repro_torch.core import dtypes
from repro_torch.core.batch import Column, RecordBatch
from repro_torch.core.expr import Expr
from repro_torch.core.schema import Field, Schema
from repro_torch.core.sdf import StreamingDataFrame
from repro_torch.server.adapters.base import (
    DEFAULT_BATCH_ROWS,
    Capabilities,
    ScanAdapter,
    split_conjuncts,
)

# Availability is probed WITHOUT importing: `import repro_torch.server` reaches
# this module through the adapter registry, and eagerly initializing
# pyarrow (thread pools, allocator arenas) on every server/client import
# would tax processes that never touch a .parquet file.  The real import
# happens on first adapter use.
try:  # pragma: no cover - exercised by the no-pyarrow CI leg
    HAVE_PYARROW = importlib.util.find_spec("pyarrow") is not None
except (ImportError, ValueError):
    HAVE_PYARROW = False
pa = pq = None  # bound by _load()

__all__ = ["ParquetAdapter", "HAVE_PYARROW", "is_parquet_file"]


def _load():
    """Import pyarrow on first use; returns the parquet module."""
    global pa, pq
    if pq is None:
        import pyarrow as _pa
        import pyarrow.parquet as _pq

        pa, pq = _pa, _pq
    return pq


def is_parquet_file(path: str) -> bool:
    return HAVE_PYARROW and path.lower().endswith(".parquet")


def _arrow_dtype(t):
    if pa.types.is_boolean(t):
        return dtypes.BOOL
    if pa.types.is_integer(t):
        return dtypes.INT64
    if pa.types.is_floating(t):
        return dtypes.FLOAT64
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return dtypes.STRING
    if pa.types.is_binary(t) or pa.types.is_large_binary(t):
        return dtypes.BINARY
    return None  # unsupported arrow type -> column dropped from the SDF view


def _schema_of(pf) -> Schema:
    fields = []
    sch = pf.schema_arrow
    for i in range(len(sch)):
        f = sch.field(i)
        dt = _arrow_dtype(f.type)
        if dt is not None:
            fields.append(Field(f.name, dt, nullable=f.nullable))
    return Schema(fields)


def _fill(dt):
    if dt is dtypes.STRING:
        return ""
    if dt is dtypes.BINARY:
        return b""
    return False if dt is dtypes.BOOL else 0


def _column_from_arrow(arr, dt) -> Column:
    """Arrow chunked/array -> SDF Column, nulls becoming masked fill values."""
    if hasattr(arr, "combine_chunks"):
        arr = arr.combine_chunks()
    nulls = arr.null_count
    if dt.is_varwidth:
        vals = arr.to_pylist()
        col = Column.from_values(dt, [_fill(dt) if v is None else v for v in vals])
        if nulls:
            col.validity = np.asarray([v is not None for v in vals], bool)
        return col
    if nulls:
        np_vals = arr.fill_null(_fill(dt)).to_numpy(zero_copy_only=False)
        col = Column(dt, values=np.ascontiguousarray(np_vals.astype(dt.np_dtype)))
        col.validity = ~np.asarray(arr.is_null().to_numpy(zero_copy_only=False), bool)
        return col
    np_vals = arr.to_numpy(zero_copy_only=False)
    return Column(dt, values=np.ascontiguousarray(np_vals.astype(dt.np_dtype)))


def _cmp_prunable(e: Expr):
    """conjunct -> (col, op, lits) for forms the row-group pruner handles."""
    if not isinstance(e, Expr):
        return None
    if e.op == "isin":
        a, vals = e.args
        if isinstance(a, Expr) and a.op == "col" and all(type(v) in (bool, int, float) for v in vals):
            return a.args[0], "isin", [float(v) for v in vals]
        return None
    if e.op not in ("eq", "lt", "le", "gt", "ge"):
        return None
    a, b = e.args
    flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}
    if isinstance(a, Expr) and a.op == "col" and isinstance(b, Expr) and b.op == "lit":
        name, lit, op = a.args[0], b.args[0], e.op
    elif isinstance(b, Expr) and b.op == "col" and isinstance(a, Expr) and a.op == "lit":
        name, lit, op = b.args[0], a.args[0], flip[e.op]
    else:
        return None
    if type(lit) not in (bool, int, float):
        return None
    return name, op, [float(lit)]


def _group_skippable(meta_rg, col_index: dict, conjuncts: list) -> bool:
    for c in conjuncts:
        pr = _cmp_prunable(c)
        if pr is None:
            continue
        name, op, lits = pr
        ci = col_index.get(name)
        if ci is None:
            continue
        col_meta = meta_rg.column(ci)
        st = col_meta.statistics
        # nulls would be fill values to the residual filter — never skip then
        if st is None or not st.has_min_max or (st.null_count or 0) != 0:
            continue
        try:
            lo, hi = float(st.min), float(st.max)
        except (TypeError, ValueError):
            continue
        if op == "isin":
            if all(v < lo or v > hi for v in lits):
                return True
            continue
        (lit,) = lits
        if (
            (op == "eq" and (lit < lo or lit > hi))
            or (op == "lt" and lo >= lit)
            or (op == "le" and lo > lit)
            or (op == "gt" and hi <= lit)
            or (op == "ge" and hi < lit)
        ):
            return True
    return False


class ParquetAdapter(ScanAdapter):
    format = "parquet"

    def capabilities(self) -> Capabilities:
        return Capabilities(column_projection=True, predicate_pruning=True, part_ranges=True)

    def schema(self) -> Schema:
        with _load().ParquetFile(self.path) as pf:
            return _schema_of(pf)

    def stats(self) -> dict:
        out = super().stats()
        with _load().ParquetFile(self.path) as pf:
            out["rows"] = pf.metadata.num_rows
            out["row_groups"] = pf.metadata.num_row_groups
        return out

    def part_count(self) -> int | None:
        with _load().ParquetFile(self.path) as pf:
            return max(1, pf.metadata.num_row_groups)

    def scan(
        self,
        columns=None,
        predicate: Expr | None = None,
        batch_rows=DEFAULT_BATCH_ROWS,
        part_range=None,
        report: dict | None = None,
        **_kw,
    ):
        conjuncts = split_conjuncts(predicate)
        path = self.path

        with _load().ParquetFile(path) as pf:
            schema = _schema_of(pf)
            meta = pf.metadata
            col_index = {meta.schema.column(i).name: i for i in range(meta.num_columns)}
            groups = list(range(meta.num_row_groups))
            if part_range is not None:
                lo, hi = int(part_range[0]), int(part_range[1])
                groups = groups[lo:hi]
            keep = [g for g in groups if not (conjuncts and _group_skippable(meta.row_group(g), col_index, conjuncts))]

        if columns is not None:
            names = [n for n in schema.names if n in set(columns)]
        else:
            names = list(schema.names)
        out_schema = schema.select(names)
        if report is not None:
            report["row_groups_total"] = len(groups)
            report["row_groups_read"] = len(keep)
            report["rows_emitted"] = 0

        def gen():
            if not keep:
                return
            with pq.ParquetFile(path) as pf:
                for tbl_batch in pf.iter_batches(batch_size=batch_rows, row_groups=keep, columns=names or None):
                    cols = []
                    for f in out_schema:
                        cols.append(_column_from_arrow(tbl_batch.column(f.name), f.dtype))
                    b = RecordBatch(out_schema, cols)
                    if report is not None:
                        report["rows_emitted"] += b.num_rows
                    yield b

        return StreamingDataFrame(out_schema, gen)
