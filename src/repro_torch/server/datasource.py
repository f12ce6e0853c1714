"""Multimodal Data Source (paper §IV-A), dispatching through the format
adapter registry (``repro_torch.server.adapters``).

Every physical source — CSV/JSONL/NPZ/NPY files, SQLite/SDIF and Parquet
containers, columnar datasets, File-List-Framed directories, raw blobs —
is an adapter behind one ``Scan`` interface.  This module is the policy
layer on top:

  * resolve the adapter and validate the request against its schema
    (strict user columns vs advisory optimizer hints);
  * split the predicate into the part the adapter evaluates natively
    (compiled SQL, metadata-before-content filtering) and the **residual**
    the stream is re-filtered with (adapters only promise *superset
    semantics*: stats-based pruning may keep non-matching rows);
  * hand the adapter the column set it must materialize (projected output
    columns plus whatever the residual needs) when it supports native
    projection;
  * apply residual predicate + final projection to the stream.

``scan_bytes`` is the in-memory twin of ``scan_path`` for expandable blob
columns (client-side ``open_blob``): structured payloads parse straight
from the byte buffer, batch-by-batch, with no temp file spooling.
"""

from __future__ import annotations

import io
import os

import numpy as np

from repro_torch.core.env import env_int
from repro_torch.core.errors import ResourceNotFound, SchemaError
from repro_torch.core.expr import Expr
from repro_torch.core.sdf import StreamingDataFrame
from repro_torch.server import adapters
from repro_torch.server.adapters import (
    DEFAULT_BATCH_ROWS,
    DEFAULT_CHUNK_BYTES,
    bytes_chunks_sdf,
    csv_stream_sdf,
    jsonl_stream_sdf,
    npy_array_sdf,
    npz_arrays_sdf,
)
from repro_torch.server.adapters.columnar import columnar_parts, is_columnar_dataset
from repro_torch.server.adapters.jsonl import _JSON_DT  # noqa: F401 - compat re-export
from repro_torch.server.adapters.structured import infer_csv_schema as _infer_csv_schema  # noqa: F401 - compat

__all__ = [
    "scan_path",
    "scan_bytes",
    "write_sdf_dataset",
    "columnar_part_count",
    "part_count",
    "source_stats",
    "DEFAULT_BATCH_ROWS",
    "STRUCTURED_EXTS",
]

# validated read: a garbage DACP_SCAN_WORKERS warns and falls back instead
# of crashing this module's import (the raw int() here used to do exactly that)
DEFAULT_SCAN_WORKERS = env_int("DACP_SCAN_WORKERS")

STRUCTURED_EXTS = {".csv", ".jsonl", ".npz", ".npy"}


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
def scan_path(
    path: str,
    columns=None,
    predicate: Expr | None = None,
    batch_rows: int = DEFAULT_BATCH_ROWS,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    strict_columns: bool = True,
    scan_workers: int = DEFAULT_SCAN_WORKERS,
    part_range=None,
    report: dict | None = None,
) -> StreamingDataFrame:
    """Open any path (file or directory) as an SDF with pushdown applied.

    ``strict_columns=True`` (user-facing GET): unknown column names raise
    ``SchemaError`` — a typo must not silently vanish.  ``False`` (optimizer
    pruning hints, which are computed structurally and may name columns from
    the other side of a join): the scan keeps the intersection.

    ``scan_workers > 1`` reads multi-file sources (columnar dataset parts,
    file-list blob content) with a bounded reader pool, emitting batches in
    the same order as the sequential scan.

    ``part_range=(lo, hi)`` restricts the scan to the adapter's split units
    ``[lo, hi)`` (columnar part files, Parquet row groups, JSONL index
    blocks, SQLite rowid windows).  Disjoint contiguous ranges concatenated
    in order reproduce the full scan byte-identically.  Sources without
    ``part_ranges`` capability ignore it.

    ``report``, when given, is filled with the adapter's scan accounting
    (regions skipped, rows/files read) — the benchmark harness reads it.
    """
    if not os.path.exists(path):
        raise ResourceNotFound(f"no such path: {path}")
    adapter = adapters.resolve(path)
    caps = adapter.capabilities()
    schema = adapter.schema()

    if predicate is not None:
        missing = predicate.referenced_columns() - set(schema.names)
        if missing:
            raise SchemaError(f"predicate references missing columns {sorted(missing)}")
    out_cols = list(columns) if columns is not None else None
    if out_cols is not None:
        have = set(schema.names)
        unknown = [c for c in out_cols if c not in have]
        if unknown and strict_columns:
            raise SchemaError(f"no such columns {unknown} (have {schema.names})")
        # advisory pruning: ignore hinted columns this source doesn't have
        out_cols = [c for c in out_cols if c in have]

    residual = adapter.residual_predicate(predicate) if predicate is not None else None

    native_cols = None
    if caps.column_projection and out_cols is not None:
        # the adapter materializes the projection plus whatever the residual
        # re-filter needs; the extra columns are dropped again below
        need = set(out_cols) | (residual.referenced_columns() if residual is not None else set())
        native_cols = [c for c in schema.names if c in need]

    sdf = adapter.scan(
        columns=native_cols,
        predicate=predicate,
        batch_rows=batch_rows,
        chunk_bytes=chunk_bytes,
        scan_workers=scan_workers,
        part_range=part_range if caps.part_ranges else None,
        report=report,
    )
    return _finalize(sdf, out_cols, residual)


def _finalize(sdf: StreamingDataFrame, out_cols, residual: Expr | None) -> StreamingDataFrame:
    """Residual re-filter + final projection on an adapter's stream."""
    schema = sdf.schema
    out_schema = schema.select(out_cols) if out_cols is not None else schema
    if residual is None and (out_cols is None or list(out_cols) == list(schema.names)):
        return sdf

    def gen():
        for b in sdf.iter_batches():
            if residual is not None:
                mask = np.asarray(residual.evaluate(b), bool)
                if not mask.any():
                    continue
                if not mask.all():
                    b = b.filter(mask)
            if out_cols is not None:
                b = b.select(out_cols)
            yield b

    return StreamingDataFrame(out_schema, gen)


def scan_bytes(
    data: bytes,
    fmt: str = "",
    columns=None,
    predicate: Expr | None = None,
    batch_rows: int = DEFAULT_BATCH_ROWS,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> StreamingDataFrame:
    """Open an in-memory payload (an expanded blob column value) as an SDF.

    Structured formats parse straight from the buffer and stream in batches;
    unknown formats become a lazy chunk stream over memoryview slices.  The
    payload is never written to disk and never force-collected.
    """
    ext = "." + fmt.lower().lstrip(".") if fmt else ""
    if ext == ".csv":
        text = data.decode()
        sdf = csv_stream_sdf(lambda: io.StringIO(text, newline=""), batch_rows, "<memory>")
    elif ext == ".jsonl":
        sdf = jsonl_stream_sdf(lambda: io.BytesIO(data), batch_rows, "<memory>")
    elif ext == ".npz":
        with np.load(io.BytesIO(data)) as z:
            arrays = {k: z[k] for k in z.files}
        sdf = npz_arrays_sdf(arrays, batch_rows)
    elif ext == ".npy":
        sdf = npy_array_sdf(np.load(io.BytesIO(data)), batch_rows)
    else:
        sdf = bytes_chunks_sdf(data, chunk_bytes)
    return _apply_pushdown(sdf, columns, predicate)


def _apply_pushdown(sdf: StreamingDataFrame, columns, predicate, strict_columns: bool = True) -> StreamingDataFrame:
    """In-stream pushdown for sources with no adapter (in-memory payloads)."""
    schema = sdf.schema
    if predicate is not None:
        pred_cols = predicate.referenced_columns()
        missing = pred_cols - set(schema.names)
        if missing:
            raise SchemaError(f"predicate references missing columns {sorted(missing)}")
    out_cols = list(columns) if columns is not None else None
    if out_cols is not None:
        have = set(schema.names)
        unknown = [c for c in out_cols if c not in have]
        if unknown and strict_columns:
            raise SchemaError(f"no such columns {unknown} (have {schema.names})")
        out_cols = [c for c in out_cols if c in have]
    return _finalize(sdf, out_cols, predicate)


# ---------------------------------------------------------------------------
# metadata entry points (no data bytes read)
# ---------------------------------------------------------------------------
def part_count(path: str) -> int | None:
    """The adapter's partition-parallel split-unit count for ``path``, or
    None when the source is not part-splittable.  Metadata only — the
    planner uses this for eligibility, and DESCRIBE reports it so remote
    coordinators can decide without walking the tree."""
    if not os.path.exists(path):
        return None
    adapter = adapters.resolve(path)
    if not adapter.capabilities().part_ranges:
        return None
    try:
        return adapter.part_count()
    except Exception:  # noqa: BLE001 - stats must not break discovery
        return None


def source_stats(path: str) -> dict | None:
    """The adapter's DESCRIBE stats for ``path`` (format, bytes, rows/parts
    where cheap), or None when unresolvable."""
    if not os.path.exists(path):
        return None
    adapter = adapters.resolve(path)
    try:
        return adapter.stats()
    except Exception:  # noqa: BLE001 - stats must not break discovery
        return {"format": adapter.format}


def columnar_part_count(path: str) -> int | None:
    """Back-compat shim: part count for *columnar dataset* directories only
    (pre-adapter callers).  New code should use :func:`part_count`."""
    if not os.path.isdir(path) or not is_columnar_dataset(path):
        return None
    return len(columnar_parts(path))


# ---------------------------------------------------------------------------
# PUT persistence: SDF -> columnar part files (round-trips via scan_path)
# ---------------------------------------------------------------------------
def write_sdf_dataset(root: str, sdf: StreamingDataFrame, rows_per_part: int = 1 << 20) -> int:
    import json

    os.makedirs(root, exist_ok=True)
    tmp_schema = os.path.join(root, "_schema.json.tmp")
    with open(tmp_schema, "w") as f:
        json.dump(sdf.schema.to_json(), f)
    os.replace(tmp_schema, os.path.join(root, "_schema.json"))

    part = 0
    total = 0
    for batch in sdf.iter_batches():
        arrays = {}
        for fld, colobj in zip(batch.schema, batch.columns):
            if fld.dtype.is_varwidth:
                arrays[f"{fld.name}__offsets"] = colobj.offsets
                arrays[f"{fld.name}__data"] = colobj.data
            else:
                arrays[fld.name] = colobj.values
        tmp = os.path.join(root, f".part-{part:05d}.npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, os.path.join(root, f"part-{part:05d}.npz"))
        total += batch.num_rows
        part += 1
    return total
