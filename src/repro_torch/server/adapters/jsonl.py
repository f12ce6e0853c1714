"""Indexed JSONL adapter (ZDS-style) + schema-flexible inference.

Two fixes over the seed scanner, which let the *first record* define the
schema:

  * **inference** samples the first ``DACP_JSONL_SNIFF_LINES`` records,
    unions their fields, and widens conflicting numeric dtypes
    (bool ⊂ int64 ⊂ float64; anything mixed with strings/nested values
    becomes the json-text string column the seed already used);
  * **missing values** (absent keys, JSON ``null``, uncoercible values past
    the sample window) become validity-masked fill values instead of
    coercing ``None`` into the column builder.

The sidecar index (``_<name>.zdx.json``, atomic tmp+rename, invisible to
File-List Framing) stores per-block line offsets and per-field numeric
min/max + presence counts.  It buys three things:

  * **block skipping** — a comparison conjunct provably false for a whole
    block (via min/max) skips the block's bytes entirely.  Skipping is only
    applied when the field is present in every row of the block, so the
    decision is sound against the residual re-filter (which sees fill
    values for masked rows);
  * **seekable ``part_range`` scans** — the block is the partition-parallel
    split unit for a single JSONL file;
  * **exact schema + row counts** for DESCRIBE without re-streaming (the
    index schema is unioned over the whole file, not just the sample).

The index is built lazily on the first scan (``DACP_JSONL_INDEX=0``
disables it); until one exists, schema() answers from the bounded sample
and the file reports no parts.
"""

from __future__ import annotations

import json
import os

from repro_torch.core import dtypes
from repro_torch.core.env import env_bool, env_int
from repro_torch.core.errors import SchemaError
from repro_torch.core.expr import Expr
from repro_torch.core.schema import Field, Schema
from repro_torch.core.sdf import StreamingDataFrame
from repro_torch.server.adapters.base import (
    DEFAULT_BATCH_ROWS,
    Capabilities,
    ScanAdapter,
    build_masked_batch,
    split_conjuncts,
)

__all__ = ["JsonlAdapter", "jsonl_stream_sdf", "infer_jsonl_schema", "sidecar_path"]

INDEX_VERSION = 1

# json value type -> column dtype (bool before int: bool is an int subclass)
_JSON_DT = {bool: dtypes.BOOL, int: dtypes.INT64, float: dtypes.FLOAT64, str: dtypes.STRING}


def _value_dtype(v):
    if v is None:
        return None  # null carries no type evidence
    for t, dt in _JSON_DT.items():
        if type(v) is t:
            return dt
    return dtypes.STRING  # nested values are kept as their json text


def _widen(cur, new):
    if cur is None:
        return new
    if new is None or cur is new:
        return cur
    pair = {cur.name, new.name}
    if pair <= {"bool", "int64"}:
        return dtypes.INT64
    if pair <= {"bool", "int64", "float64"}:
        return dtypes.FLOAT64
    return dtypes.STRING


def infer_jsonl_schema(records) -> Schema:
    """Union fields over ``records`` (first-seen order), widening dtypes."""
    order: list = []
    seen: dict = {}
    for rec in records:
        for k, v in rec.items():
            if k not in seen:
                order.append(k)
                seen[k] = None
            seen[k] = _widen(seen[k], _value_dtype(v))
    if not order:
        raise SchemaError("jsonl sample has no fields")
    # default nullable flag: missing values surface as column *validity*
    # masks, and schema-equality checks (union) compare the field flag
    return Schema([Field(k, seen[k] or dtypes.STRING) for k in order])


def _coerce(v, dt):
    """(value, missing) under the column dtype; uncoercible -> masked fill."""
    if v is None:
        return _fill(dt), True
    try:
        if dt is dtypes.STRING:
            return (v if isinstance(v, str) else json.dumps(v)), False
        if dt is dtypes.FLOAT64:
            return float(v), False
        if dt is dtypes.INT64:
            return int(v), False
        if dt is dtypes.BOOL:
            return bool(v), False
    except (TypeError, ValueError):
        return _fill(dt), True
    return _fill(dt), True


def _fill(dt):
    if dt is dtypes.STRING:
        return ""
    if dt is dtypes.BOOL:
        return False
    return 0


class _Builder:
    """Accumulates parsed records into masked columnar batches."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self.cols: dict = {f.name: [] for f in schema}
        self.miss: dict = {f.name: [] for f in schema}
        self.n = 0

    def add(self, rec: dict) -> None:
        for f in self.schema:
            if f.name in rec:
                v, m = _coerce(rec[f.name], f.dtype)
            else:
                v, m = _fill(f.dtype), True
            self.cols[f.name].append(v)
            self.miss[f.name].append(m)
        self.n += 1

    def flush(self):
        b = build_masked_batch(self.schema, self.cols, self.miss)
        self.cols = {f.name: [] for f in self.schema}
        self.miss = {f.name: [] for f in self.schema}
        self.n = 0
        return b


def _sample_records(opener, limit: int) -> list:
    recs = []
    with opener() as f:
        for line in f:
            if not line.strip():
                continue
            recs.append(json.loads(line))
            if len(recs) >= limit:
                break
    return recs


def jsonl_stream_sdf(opener, batch_rows: int, what: str, sniff_lines: int | None = None) -> StreamingDataFrame:
    """Plain streaming JSONL scan over a re-openable binary line stream
    (files without an index, and in-memory ``scan_bytes`` payloads)."""
    if sniff_lines is None:
        sniff_lines = env_int("DACP_JSONL_SNIFF_LINES")
    sample = _sample_records(opener, sniff_lines)
    if not sample:
        raise SchemaError(f"empty jsonl {what}")
    schema = infer_jsonl_schema(sample)

    def gen():
        bld = _Builder(schema)
        with opener() as f:
            for line in f:
                if not line.strip():
                    continue
                bld.add(json.loads(line))
                if bld.n >= batch_rows:
                    yield bld.flush()
        if bld.n:
            yield bld.flush()

    return StreamingDataFrame(schema, gen)


# ---------------------------------------------------------------------------
# sidecar index
# ---------------------------------------------------------------------------
def sidecar_path(path: str) -> str:
    d, name = os.path.split(path)
    # `_*.json` names are invisible to File-List Framing and catalog listings
    return os.path.join(d, f"_{name}.zdx.json")


def _source_stamp(path: str) -> dict:
    st = os.stat(path)
    return {"size": st.st_size, "mtime_ns": st.st_mtime_ns}


class JsonlAdapter(ScanAdapter):
    format = "jsonl"

    def capabilities(self) -> Capabilities:
        return Capabilities(predicate_pruning=True, part_ranges=True)

    # -- index lifecycle ----------------------------------------------------
    def load_index(self) -> dict | None:
        """The sidecar index, or None when absent/stale.  Never builds."""
        try:
            with open(sidecar_path(self.path)) as f:
                idx = json.load(f)
        except (OSError, ValueError):
            return None
        if idx.get("version") != INDEX_VERSION or idx.get("source") != _source_stamp(self.path):
            return None
        return idx

    def ensure_index(self) -> dict | None:
        """Load-or-build (one full pass; persisted atomically when the
        directory is writable, else kept in memory for this scan)."""
        idx = self.load_index()
        if idx is not None:
            return idx
        idx = self._build_index()
        if idx is None:
            return None
        d = os.path.dirname(os.path.abspath(self.path))
        if os.access(d, os.W_OK):
            tmp = sidecar_path(self.path) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(idx, f)
            os.replace(tmp, sidecar_path(self.path))
        return idx

    def _build_index(self) -> dict | None:
        block_rows = env_int("DACP_JSONL_BLOCK_ROWS")
        stamp = _source_stamp(self.path)
        order: list = []
        widened: dict = {}
        blocks: list = []
        cur: dict | None = None
        offset = 0
        total = 0

        def close_block():
            if cur is None or cur["rows"] == 0:
                return
            fields = {}
            for k, st in cur["stats"].items():
                ent = {"present": st["present"]}
                if st["min"] is not None:
                    ent["min"] = st["min"]
                    ent["max"] = st["max"]
                fields[k] = ent
            blocks.append({"offset": cur["offset"], "rows": cur["rows"], "fields": fields})

        with open(self.path, "rb") as f:
            for line in f:
                ln = len(line)
                if line.strip():
                    rec = json.loads(line)
                    if cur is None or cur["rows"] >= block_rows:
                        close_block()
                        cur = {"offset": offset, "rows": 0, "stats": {}}
                    for k, v in rec.items():
                        if k not in widened:
                            order.append(k)
                            widened[k] = None
                        widened[k] = _widen(widened[k], _value_dtype(v))
                        st = cur["stats"].setdefault(k, {"present": 0, "min": None, "max": None})
                        if v is not None:
                            st["present"] += 1
                            if type(v) in (bool, int, float):
                                num = float(v)
                                st["min"] = num if st["min"] is None else min(st["min"], num)
                                st["max"] = num if st["max"] is None else max(st["max"], num)
                    cur["rows"] += 1
                    total += 1
                offset += ln
        close_block()
        if total == 0:
            return None
        schema = Schema([Field(k, widened[k] or dtypes.STRING) for k in order])
        return {
            "version": INDEX_VERSION,
            "source": stamp,
            "block_rows": block_rows,
            "rows": total,
            "schema": schema.to_json(),
            "blocks": blocks,
        }

    # -- metadata -----------------------------------------------------------
    def schema(self) -> Schema:
        idx = self.load_index()
        if idx is not None:
            return Schema.from_json(idx["schema"])
        sample = _sample_records(lambda: open(self.path, "rb"), env_int("DACP_JSONL_SNIFF_LINES"))
        if not sample:
            raise SchemaError(f"empty jsonl {self.path}")
        return infer_jsonl_schema(sample)

    def stats(self) -> dict:
        out = super().stats()
        idx = self.load_index()
        if idx is not None:
            out["rows"] = idx["rows"]
            out["blocks"] = len(idx["blocks"])
        return out

    def part_count(self) -> int | None:
        idx = self.load_index()  # never build from a metadata query
        if idx is None:
            return None
        return len(idx["blocks"])

    # -- block skipping -----------------------------------------------------
    @staticmethod
    def _block_skippable(block: dict, conjuncts: list) -> bool:
        """True when some conjunct is provably false for every row of the
        block.  Only total (present == rows) numeric fields participate, so
        the residual filter — which sees fill values for masked rows — can
        never disagree with a skip."""
        for c in conjuncts:
            bound = _cmp_bound(c)
            if bound is None:
                continue
            name, op, lit = bound
            st = block["fields"].get(name)
            if st is None or st["present"] != block["rows"] or "min" not in st:
                continue
            lo, hi = st["min"], st["max"]
            if (
                (op == "eq" and (lit < lo or lit > hi))
                or (op == "lt" and lo >= lit)
                or (op == "le" and lo > lit)
                or (op == "gt" and hi <= lit)
                or (op == "ge" and hi < lit)
            ):
                return True
        return False

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
        if not env_bool("DACP_JSONL_INDEX"):
            return jsonl_stream_sdf(lambda: open(self.path, "rb"), batch_rows, self.path)
        idx = self.ensure_index()
        if idx is None:  # empty file
            return jsonl_stream_sdf(lambda: open(self.path, "rb"), batch_rows, self.path)
        schema = Schema.from_json(idx["schema"])
        blocks = idx["blocks"]
        if part_range is not None:
            lo, hi = int(part_range[0]), int(part_range[1])
            blocks = blocks[lo:hi]
        conjuncts = split_conjuncts(predicate)
        path = self.path
        if report is not None:
            report["blocks_total"] = len(blocks)
            report["blocks_read"] = 0
            report["rows_emitted"] = 0

        def gen():
            bld = _Builder(schema)
            with open(path, "rb") as f:
                for block in blocks:
                    if conjuncts and self._block_skippable(block, conjuncts):
                        continue
                    if report is not None:
                        report["blocks_read"] += 1
                    f.seek(block["offset"])
                    read = 0
                    while read < block["rows"]:
                        line = f.readline()
                        if not line:
                            break
                        if not line.strip():
                            continue
                        bld.add(json.loads(line))
                        read += 1
                        if bld.n >= batch_rows:
                            if report is not None:
                                report["rows_emitted"] += bld.n
                            yield bld.flush()
            if bld.n:
                if report is not None:
                    report["rows_emitted"] += bld.n
                yield bld.flush()

        return StreamingDataFrame(schema, gen)


def _cmp_bound(e: Expr):
    """``col CMP lit`` (either side) -> (col, normalized_op, float(lit))."""
    if not isinstance(e, Expr) or e.op not in ("eq", "lt", "le", "gt", "ge"):
        return None
    a, b = e.args
    flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}
    if isinstance(a, Expr) and a.op == "col" and isinstance(b, Expr) and b.op == "lit":
        col, lit, op = a.args[0], b.args[0], e.op
    elif isinstance(b, Expr) and b.op == "col" and isinstance(a, Expr) and a.op == "lit":
        col, lit, op = b.args[0], a.args[0], flip[e.op]
    else:
        return None
    if type(lit) not in (bool, int, float):
        return None
    return col, op, float(lit)
