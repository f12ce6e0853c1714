"""Format adapter interface + registry (the Scan contract).

Every physical format the datasource understands is an adapter behind ONE
interface, so the layers above (optimizer pushdown R6/R7, catalog DESCRIBE,
the partition-parallel planner, plan-cache fingerprints) never see format
names — they see capabilities:

  * ``schema()``   — the SDF schema, from *bounded* metadata reads only
    (headers, sidecars, a capped line/row sample — never a full data scan);
  * ``stats()``    — per-format statistics (row counts, byte sizes, column
    min/max where the format makes them cheap) for DESCRIBE and the
    optimizer/mesh-planner cost models;
  * ``scan()``     — the data path.  The contract is *superset semantics*:
    the returned stream contains at least every row matching ``predicate``
    (an adapter may use it natively — compiled SQL, row-group pruning,
    block skipping — or ignore it entirely);
  * ``residual_predicate()`` — the pushed-vs-residual split: the part of a
    predicate the adapter does NOT evaluate exactly, which the caller must
    re-apply on the stream.  ``None`` means the scan output is exact.
    Pruning-only adapters (Parquet row groups, JSONL blocks) return the
    whole predicate: skipping storage regions is a superset optimization,
    not an exact filter;
  * ``part_count()``/``part_range`` — the partition-parallel split unit
    (columnar part files, Parquet row groups, JSONL index blocks, SQLite
    rowid windows).  Disjoint contiguous ranges concatenated in order are
    byte-identical to the full scan;
  * ``version()``  — a cheap mutation stamp (size + mtime_ns) folded into
    plan-cache fingerprints so cached results die with the bytes they came
    from.

Registration order matters: ``resolve(path)`` returns the first matching
adapter, with directory kinds probed before file extensions and a
content-sniffing fallback (SQLite magic) before the blob catch-all.
"""

from __future__ import annotations

import os

import numpy as np

from repro_torch.core.batch import Column, RecordBatch
from repro_torch.core.expr import Expr, and_
from repro_torch.core.schema import Schema

__all__ = [
    "Capabilities",
    "ScanAdapter",
    "register_adapter",
    "resolve",
    "registered_formats",
    "split_conjuncts",
    "join_conjuncts",
    "build_masked_batch",
    "DEFAULT_BATCH_ROWS",
    "DEFAULT_CHUNK_BYTES",
]

DEFAULT_BATCH_ROWS = 65536
DEFAULT_CHUNK_BYTES = 4 << 20


class Capabilities:
    """What an adapter does natively (everything else is the caller's job).

    column_projection — ``scan(columns=...)`` reads only those columns.
    predicate_pushdown — some predicates are evaluated *exactly* inside the
        format (``residual_predicate`` drops them).
    predicate_pruning — predicates skip storage regions via stats (row
        groups, index blocks) but rows must still be re-filtered.
    part_ranges — ``scan(part_range=(lo, hi))`` is a seekable disjoint
        split over ``part_count()`` units.
    """

    __slots__ = ("column_projection", "predicate_pushdown", "predicate_pruning", "part_ranges")

    def __init__(
        self,
        column_projection: bool = False,
        predicate_pushdown: bool = False,
        predicate_pruning: bool = False,
        part_ranges: bool = False,
    ):
        self.column_projection = column_projection
        self.predicate_pushdown = predicate_pushdown
        self.predicate_pruning = predicate_pruning
        self.part_ranges = part_ranges

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class ScanAdapter:
    """One physical source (file or directory) opened as an SDF."""

    format = "?"

    def __init__(self, path: str):
        self.path = path

    # -- metadata (bounded reads only) --------------------------------------
    def capabilities(self) -> Capabilities:
        return Capabilities()

    def schema(self) -> Schema:
        raise NotImplementedError

    def stats(self) -> dict:
        """Per-format stats for DESCRIBE / cost models.  Always includes
        ``bytes``; ``rows`` and ``columns`` (per-column min/max) when the
        format makes them cheap; ``parts`` when part-splittable."""
        out = {"format": self.format, "bytes": self._source_bytes()}
        parts = self.part_count()
        if parts is not None:
            out["parts"] = parts
        return out

    def version(self) -> dict:
        """Mutation stamp for plan-cache fingerprints: any byte-level change
        to the source must change it.  st_mtime_ns catches same-size
        rewrites that a float-seconds mtime can miss."""
        st = os.stat(self.path)
        return {"size": st.st_size, "mtime_ns": st.st_mtime_ns}

    def part_count(self) -> int | None:
        """Number of part_range split units, or None when not splittable."""
        return None

    # -- pushed-vs-residual contract ----------------------------------------
    def residual_predicate(self, predicate: Expr | None) -> Expr | None:
        """The part of ``predicate`` the caller must still apply to the scan
        output.  Default: everything (the adapter evaluates nothing)."""
        return predicate

    # -- data path ----------------------------------------------------------
    def scan(
        self,
        columns=None,
        predicate: Expr | None = None,
        batch_rows: int = DEFAULT_BATCH_ROWS,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        scan_workers: int = 1,
        part_range=None,
        report: dict | None = None,
    ):
        """Stream the source as RecordBatches (superset semantics, see the
        module docstring).  ``report``, when given, is filled with scan
        accounting (rows/bytes emitted, regions skipped) for benchmarks."""
        raise NotImplementedError

    # -- helpers ------------------------------------------------------------
    def _source_bytes(self) -> int:
        if os.path.isdir(self.path):
            total = 0
            for dirpath, _d, files in os.walk(self.path):
                for fn in files:
                    try:
                        total += os.path.getsize(os.path.join(dirpath, fn))
                    except OSError:
                        pass
            return total
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: list = []  # (name, matcher(path) -> bool, factory(path) -> ScanAdapter)


def register_adapter(name: str, matcher, factory, before: str | None = None) -> None:
    """Register a format.  ``matcher(path)`` decides applicability (called
    in registration order); ``factory(path)`` builds the adapter.  ``before``
    inserts ahead of an existing entry (the blob catch-all must stay last)."""
    entry = (name, matcher, factory)
    if before is not None:
        for i, (nm, _m, _f) in enumerate(_REGISTRY):
            if nm == before:
                _REGISTRY.insert(i, entry)
                return
    _REGISTRY.append(entry)


def registered_formats() -> list:
    return [nm for nm, _m, _f in _REGISTRY]


def resolve(path: str) -> ScanAdapter:
    """First matching adapter for ``path`` (the blob catch-all always
    matches, so this never fails for an existing path)."""
    for _nm, matcher, factory in _REGISTRY:
        if matcher(path):
            return factory(path)
    raise AssertionError(f"no adapter matched {path!r} (blob catch-all missing?)")


# ---------------------------------------------------------------------------
# predicate conjunct helpers (the pushed-vs-residual split unit)
# ---------------------------------------------------------------------------
def split_conjuncts(predicate: Expr | None) -> list:
    """Flatten nested ``and`` nodes into a conjunct list (order preserved)."""
    if predicate is None:
        return []
    out, stack = [], [predicate]
    while stack:
        e = stack.pop()
        if isinstance(e, Expr) and e.op == "and":
            stack.append(e.args[1])
            stack.append(e.args[0])
        else:
            out.append(e)
    # stack order above yields left-to-right already; keep deterministic
    return out


def join_conjuncts(conjuncts: list) -> Expr | None:
    if not conjuncts:
        return None
    return and_(*conjuncts)


# ---------------------------------------------------------------------------
# row-major -> columnar with validity (shared by sqlite / jsonl adapters)
# ---------------------------------------------------------------------------
def _fill_value(dtype):
    if dtype.is_varwidth:
        return "" if dtype.name == "string" else b""
    if dtype.name == "bool":
        return False
    return 0


def build_masked_batch(schema: Schema, cols: dict, missing: dict) -> RecordBatch:
    """Build a batch from per-column python value lists.

    ``missing[name]`` is a bool list marking absent/NULL entries; those
    positions carry the dtype's fill value (0 / "" / b"") in ``cols`` and a
    False validity bit, so a missing int field becomes a masked zero instead
    of coercing ``None`` into the column builder."""
    out = []
    for f in schema:
        vals = cols[f.name]
        col = Column.from_values(f.dtype, vals)
        miss = missing.get(f.name)
        if miss is not None and any(miss):
            col.validity = ~np.asarray(miss, dtype=bool)
        out.append(col)
    return RecordBatch(schema, out)
