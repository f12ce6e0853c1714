"""SQLite/SDIF adapter (stdlib ``sqlite3``): exact native pushdown.

SDIF ships a whole dataset as one SQLite container; this adapter opens the
first user table as an SDF and compiles the *supported subset* of ``Expr``
predicates and the column projection into the SQL that SQLite executes
in-situ — compiled conjuncts are dropped from the residual (the pushdown is
exact, unlike the pruning-only formats).

Compilation is deliberately conservative; a conjunct is pushed only when
every piece provably evaluates the same under SQLite as under the in-memory
``Expr`` engine:

  * every referenced column has **zero NULLs** (checked per scan) — SQL
    three-valued logic vs the SDF's fill-value semantics can only diverge
    on NULLs, so NULL-free columns make ``NOT``/``OR``/comparisons exact
    (REAL NaN is stored as NULL by SQLite, so NaN columns are excluded by
    the same gate);
  * literals match the column's dtype family (no cross-type comparisons,
    whose ordering SQLite defines but numpy does not);
  * arithmetic is add/sub/mul on numerics only (SQLite integer ``/`` and
    ``%`` sign semantics differ from numpy);
  * ``length()`` compiles as ``length(CAST(x AS BLOB))`` — byte length,
    matching the SDF's offsets-diff definition for UTF-8 strings.

Everything else stays residual.  ``part_range`` windows the rowid-ordered
(filtered) stream in units of ``DACP_SQLITE_PART_ROWS`` via LIMIT/OFFSET,
so disjoint ranges concatenate byte-identically to the full scan.
"""

from __future__ import annotations

import os
import sqlite3
from contextlib import closing

from repro_torch.core import dtypes
from repro_torch.core.env import env_int
from repro_torch.core.errors import SchemaError
from repro_torch.core.expr import Expr
from repro_torch.core.schema import Field, Schema
from repro_torch.core.sdf import StreamingDataFrame
from repro_torch.server.adapters.base import (
    DEFAULT_BATCH_ROWS,
    Capabilities,
    ScanAdapter,
    build_masked_batch,
    join_conjuncts,
    split_conjuncts,
)

__all__ = ["SqliteAdapter", "is_sqlite_file", "SQLITE_EXTS"]

SQLITE_EXTS = (".sqlite", ".sqlite3", ".db", ".sdif")
_MAGIC = b"SQLite format 3\x00"

_NUMERIC = (dtypes.INT64, dtypes.FLOAT64, dtypes.BOOL)


def is_sqlite_file(path: str) -> bool:
    if not os.path.isfile(path):
        return False
    if os.path.splitext(path)[1].lower() in SQLITE_EXTS:
        return True
    try:
        with open(path, "rb") as f:
            return f.read(len(_MAGIC)) == _MAGIC
    except OSError:
        return False


def _affinity_dtype(decltype: str):
    d = (decltype or "").upper()
    if "INT" in d:
        return dtypes.INT64
    if "BOOL" in d:
        return dtypes.BOOL
    if any(t in d for t in ("CHAR", "CLOB", "TEXT")):
        return dtypes.STRING
    if not d or "BLOB" in d:
        return dtypes.BINARY
    if any(t in d for t in ("REAL", "FLOA", "DOUB")):
        return dtypes.FLOAT64
    return dtypes.FLOAT64  # NUMERIC and friends


def _quote_ident(name: str) -> str:
    return '"' + name.replace('"', '""') + '"'


class _Uncompilable(Exception):
    pass


class _SqlCompiler:
    """Expr -> (sql, params) under the exactness gates above."""

    def __init__(self, dtype_by_col: dict, null_free: set):
        self.dtypes = dtype_by_col
        self.null_free = null_free

    def compile(self, e: Expr):
        params: list = []
        sql, _dt = self._emit(e, params)
        return sql, params

    def _lit_dtype(self, v):
        if type(v) is bool:
            return dtypes.BOOL
        if type(v) is int:
            return dtypes.INT64
        if type(v) is float:
            return dtypes.FLOAT64
        if type(v) is str:
            return dtypes.STRING
        if type(v) in (bytes, bytearray):
            return dtypes.BINARY
        raise _Uncompilable(f"literal {type(v).__name__}")

    @staticmethod
    def _compatible(a, b) -> bool:
        return (a in _NUMERIC and b in _NUMERIC) or a is b

    def _emit(self, e: Expr, params: list):
        """Returns (sql_fragment, dtype) — dtype None for boolean results."""
        op = e.op
        if op == "col":
            name = e.args[0]
            if name not in self.dtypes:
                raise _Uncompilable(f"unknown column {name}")
            if name not in self.null_free:
                raise _Uncompilable(f"column {name} has NULLs")
            return _quote_ident(name), self.dtypes[name]
        if op == "lit":
            v = e.args[0]
            dt = self._lit_dtype(v)
            params.append(int(v) if type(v) is bool else v)
            return "?", dt
        if op in ("eq", "ne", "lt", "le", "gt", "ge"):
            a, da = self._emit(e.args[0], params)
            b, db = self._emit(e.args[1], params)
            if not self._compatible(da, db):
                raise _Uncompilable("cross-type comparison")
            sym = {"eq": "=", "ne": "<>", "lt": "<", "le": "<=", "gt": ">", "ge": ">="}[op]
            return f"({a} {sym} {b})", None
        if op in ("and", "or"):
            a, _ = self._emit(e.args[0], params)
            b, _ = self._emit(e.args[1], params)
            return f"({a} {'AND' if op == 'and' else 'OR'} {b})", None
        if op == "not":
            a, _ = self._emit(e.args[0], params)
            return f"(NOT {a})", None
        if op in ("add", "sub", "mul"):
            a, da = self._emit(e.args[0], params)
            b, db = self._emit(e.args[1], params)
            if da not in _NUMERIC or db not in _NUMERIC:
                raise _Uncompilable("non-numeric arithmetic")
            sym = {"add": "+", "sub": "-", "mul": "*"}[op]
            out = dtypes.FLOAT64 if dtypes.FLOAT64 in (da, db) else dtypes.INT64
            return f"({a} {sym} {b})", out
        if op == "isin":
            a, da = self._emit(e.args[0], params)
            vals = e.args[1]
            if not vals:
                return "(1=0)", None
            for v in vals:
                if not self._compatible(da, self._lit_dtype(v)):
                    raise _Uncompilable("cross-type isin")
            params.extend(int(v) if type(v) is bool else v for v in vals)
            return f"({a} IN ({', '.join('?' * len(vals))}))", None
        if op == "contains":
            a, da = self._emit(e.args[0], params)
            needle = e.args[1]
            if da is not dtypes.STRING or not isinstance(needle, str) or not needle:
                raise _Uncompilable("contains on non-string / empty needle")
            params.append(needle)
            return f"(instr({a}, ?) > 0)", None
        if op == "startswith":
            a, da = self._emit(e.args[0], params)
            prefix = e.args[1]
            if da is not dtypes.STRING or not isinstance(prefix, str):
                raise _Uncompilable("startswith on non-string")
            params.append(prefix)
            return f"(substr({a}, 1, {len(prefix)}) = ?)", None
        if op == "length":
            a, da = self._emit(e.args[0], params)
            if da not in (dtypes.STRING, dtypes.BINARY):
                raise _Uncompilable("length on non-varwidth")
            return f"length(CAST({a} AS BLOB))", dtypes.INT64
        raise _Uncompilable(f"op {op}")


def _coerce_cell(v, dt):
    """sqlite cell -> (value, missing) under the column dtype."""
    if v is None:
        if dt is dtypes.STRING:
            return "", True
        if dt is dtypes.BINARY:
            return b"", True
        return (False, True) if dt is dtypes.BOOL else (0, True)
    try:
        if dt is dtypes.STRING:
            return (v if isinstance(v, str) else str(v)), False
        if dt is dtypes.BINARY:
            return (bytes(v) if not isinstance(v, str) else v.encode()), False
        if dt is dtypes.BOOL:
            return bool(v), False
        if dt is dtypes.FLOAT64:
            return float(v), False
        return int(v), False
    except (TypeError, ValueError):
        return _coerce_cell(None, dt)


class SqliteAdapter(ScanAdapter):
    format = "sqlite"

    def __init__(self, path: str):
        super().__init__(path)
        self._split_memo: tuple | None = None  # (predicate, sql, params, residual)

    def capabilities(self) -> Capabilities:
        return Capabilities(column_projection=True, predicate_pushdown=True, part_ranges=True)

    def _connect(self):
        # read-only URI: a scan must never create or lock-for-write the db
        return sqlite3.connect(f"file:{self.path}?mode=ro", uri=True)

    def _table(self, conn) -> str:
        row = conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' AND name NOT LIKE 'sqlite_%' LIMIT 1"
        ).fetchone()
        if row is None:
            raise SchemaError(f"sqlite file {self.path} has no tables")
        return row[0]

    def _table_info(self, conn):
        t = self._table(conn)
        info = conn.execute(f"PRAGMA table_info({_quote_ident(t)})").fetchall()
        fields = [Field(name, _affinity_dtype(decl), nullable=not notnull) for _cid, name, decl, notnull, _d, _pk in info]
        return t, Schema(fields)

    # -- metadata -----------------------------------------------------------
    def schema(self) -> Schema:
        with closing(self._connect()) as conn:
            return self._table_info(conn)[1]

    def stats(self) -> dict:
        out = super().stats()
        with closing(self._connect()) as conn:
            t, schema = self._table_info(conn)
            qt = _quote_ident(t)
            out["table"] = t
            out["rows"] = conn.execute(f"SELECT COUNT(*) FROM {qt}").fetchone()[0]
            cols = {}
            for f in schema:
                if f.dtype not in _NUMERIC:
                    continue
                qc = _quote_ident(f.name)
                mn, mx = conn.execute(f"SELECT MIN({qc}), MAX({qc}) FROM {qt}").fetchone()
                if mn is not None:
                    cols[f.name] = {"min": mn, "max": mx}
            if cols:
                out["columns"] = cols
        return out

    def part_count(self) -> int | None:
        unit = env_int("DACP_SQLITE_PART_ROWS")
        with closing(self._connect()) as conn:
            t = self._table(conn)
            rows = conn.execute(f"SELECT COUNT(*) FROM {_quote_ident(t)}").fetchone()[0]
        return max(1, -(-rows // unit)) if rows else 1

    # -- pushed-vs-residual -------------------------------------------------
    def _split(self, predicate: Expr | None):
        """(pushed_sql | None, params, residual) — memoized per predicate so
        residual_predicate() and scan() agree on one split."""
        if self._split_memo is not None and self._split_memo[0] is predicate:
            return self._split_memo[1:]
        if predicate is None:
            self._split_memo = (None, None, [], None)
            return None, [], None
        with closing(self._connect()) as conn:
            t, schema = self._table_info(conn)
            qt = _quote_ident(t)
            referenced = predicate.referenced_columns() & set(schema.names)
            null_free = set()
            for name in referenced:
                qc = _quote_ident(name)
                nulls = conn.execute(f"SELECT COUNT(*) - COUNT({qc}) FROM {qt}").fetchone()[0]
                if nulls == 0:
                    null_free.add(name)
        comp = _SqlCompiler({f.name: f.dtype for f in schema}, null_free)
        pushed_sql, params, residual = [], [], []
        for c in split_conjuncts(predicate):
            try:
                sql, p = comp.compile(c)
            except _Uncompilable:
                residual.append(c)
                continue
            pushed_sql.append(sql)
            params.extend(p)
        where = " AND ".join(pushed_sql) if pushed_sql else None
        res = join_conjuncts(residual)
        self._split_memo = (predicate, where, params, res)
        return where, params, res

    def residual_predicate(self, predicate: Expr | None) -> Expr | None:
        return self._split(predicate)[2]

    # -- data path ----------------------------------------------------------
    def scan(
        self,
        columns=None,
        predicate: Expr | None = None,
        batch_rows=DEFAULT_BATCH_ROWS,
        part_range=None,
        report: dict | None = None,
        **_kw,
    ):
        where, params, residual = self._split(predicate)
        with closing(self._connect()) as conn:
            t, full = self._table_info(conn)
            if report is not None:
                report["rows_total"] = conn.execute(f"SELECT COUNT(*) FROM {_quote_ident(t)}").fetchone()[0]
        if columns is not None:
            names = [n for n in full.names if n in set(columns)]
        else:
            names = list(full.names)
        schema = full.select(names)
        sql = f"SELECT {', '.join(_quote_ident(n) for n in names)} FROM {_quote_ident(t)}"
        qparams = list(params)
        if where:
            sql += f" WHERE {where}"
        sql += " ORDER BY rowid"
        if part_range is not None:
            lo, hi = int(part_range[0]), int(part_range[1])
            unit = env_int("DACP_SQLITE_PART_ROWS")
            sql += " LIMIT ? OFFSET ?"
            qparams += [(hi - lo) * unit, lo * unit]
        if report is not None:
            report["pushed_sql"] = where
            report["rows_emitted"] = 0
        path = self.path

        def gen():
            with closing(sqlite3.connect(f"file:{path}?mode=ro", uri=True)) as conn:
                cur = conn.execute(sql, qparams)
                while True:
                    rows = cur.fetchmany(batch_rows)
                    if not rows:
                        break
                    cols: dict = {n: [] for n in names}
                    miss: dict = {n: [] for n in names}
                    for row in rows:
                        for n, v, f in zip(names, row, schema):
                            val, m = _coerce_cell(v, f.dtype)
                            cols[n].append(val)
                            miss[n].append(m)
                    if report is not None:
                        report["rows_emitted"] += len(rows)
                    yield build_masked_batch(schema, cols, miss)

        return StreamingDataFrame(schema, gen)
