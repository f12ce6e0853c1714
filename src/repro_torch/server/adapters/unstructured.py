"""Blob + File-List-Framing adapters.

``BlobAdapter`` is the catch-all: any unrecognized file streams as binary
chunks (one ``chunk``/``offset`` batch per ``chunk_bytes``).

``FileListAdapter`` maps a plain directory via File-List Framing: file
metadata becomes standard columns and file *content* a Binary blob column.
Its native pushdown is the in-situ core of the paper: metadata-only
conjuncts are evaluated BEFORE any content read, so filtered-out files are
never opened, and dropping ``content`` from the projection turns the scan
into a pure ``os.stat`` listing.  Conjuncts that touch ``content`` stay
residual (the caller applies them to the streamed blobs).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.core import dtypes
from repro_torch.core.batch import Column, RecordBatch
from repro_torch.core.schema import Field, Schema
from repro_torch.core.sdf import StreamingDataFrame
from repro_torch.server.adapters.base import (
    DEFAULT_BATCH_ROWS,
    DEFAULT_CHUNK_BYTES,
    Capabilities,
    ScanAdapter,
    join_conjuncts,
    split_conjuncts,
)

__all__ = ["BlobAdapter", "FileListAdapter", "bytes_chunks_sdf", "list_files", "META_FIELDS", "CONTENT_FIELD"]

META_FIELDS = [
    Field("name", dtypes.STRING),
    Field("path", dtypes.STRING),
    Field("format", dtypes.STRING),
    Field("size", dtypes.INT64),
    Field("mtime", dtypes.FLOAT64),
]
CONTENT_FIELD = Field("content", dtypes.BINARY)
_META_NAMES = {f.name for f in META_FIELDS}

_CHUNK_SCHEMA = Schema([Field("chunk", dtypes.BINARY), Field("offset", dtypes.INT64)])


# ---------------------------------------------------------------------------
# blob
# ---------------------------------------------------------------------------
def bytes_chunks_sdf(data: bytes, chunk_bytes: int) -> StreamingDataFrame:
    view = memoryview(data)

    def gen():
        size = len(view)
        for s in range(0, max(size, 1), chunk_bytes):
            e = min(s + chunk_bytes, size)
            yield RecordBatch.from_pydict({"chunk": [bytes(view[s:e])], "offset": [s]}, _CHUNK_SCHEMA)
            if size == 0:
                break

    return StreamingDataFrame(_CHUNK_SCHEMA, gen)


class BlobAdapter(ScanAdapter):
    """An unstructured file = stream of binary chunks (one column)."""

    format = "blob"

    def schema(self) -> Schema:
        return _CHUNK_SCHEMA

    def scan(self, columns=None, predicate=None, chunk_bytes=DEFAULT_CHUNK_BYTES, **_kw):
        path = self.path
        size = os.path.getsize(path)

        def gen():
            mm = np.memmap(path, dtype=np.uint8, mode="r") if size else np.zeros(0, np.uint8)
            for s in range(0, max(size, 1), chunk_bytes):
                e = min(s + chunk_bytes, size)
                chunk = bytes(mm[s:e]) if size else b""
                yield RecordBatch.from_pydict({"chunk": [chunk], "offset": [s]}, _CHUNK_SCHEMA)
                if size == 0:
                    break

        return StreamingDataFrame(_CHUNK_SCHEMA, gen)


# ---------------------------------------------------------------------------
# file-list framing
# ---------------------------------------------------------------------------
def list_files(root: str) -> list:
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in sorted(filenames):
            if fn.startswith("_") and fn.endswith(".json"):
                continue  # sidecars (_schema.json, _<name>.zdx.json) are metadata
            p = os.path.join(dirpath, fn)
            out.append(p)
    out.sort()
    return out


def _read_file(p: str) -> bytes:
    with open(p, "rb") as f:
        return f.read()


class FileListAdapter(ScanAdapter):
    format = "filelist"

    def capabilities(self) -> Capabilities:
        return Capabilities(column_projection=True, predicate_pushdown=True)

    def schema(self) -> Schema:
        return Schema(list(META_FIELDS) + [CONTENT_FIELD])

    def stats(self) -> dict:
        out = super().stats()
        out["rows"] = len(list_files(self.path))
        return out

    def residual_predicate(self, predicate):
        if predicate is None:
            return None
        residual = [c for c in split_conjuncts(predicate) if not c.referenced_columns() <= _META_NAMES]
        return join_conjuncts(residual)

    def _native_predicate(self, predicate):
        if predicate is None:
            return None
        native = [c for c in split_conjuncts(predicate) if c.referenced_columns() <= _META_NAMES]
        return join_conjuncts(native)

    def scan(
        self,
        columns=None,
        predicate=None,
        batch_rows=DEFAULT_BATCH_ROWS,
        scan_workers: int = 1,
        report: dict | None = None,
        **_kw,
    ):
        root = self.path
        native = self._native_predicate(predicate)
        # `content` is read only when projected — and when a residual
        # conjunct needs it, the caller includes it in `columns`
        want_content = columns is None or "content" in columns
        fields = list(META_FIELDS) + ([CONTENT_FIELD] if want_content else [])
        schema = Schema(fields)
        out_names = [c for c in (columns if columns is not None else schema.names) if c in set(schema.names)]
        out_schema = schema.select(out_names)
        files = list_files(root)
        meta_rows = min(batch_rows, 1024)
        if report is not None:
            report["files_total"] = len(files)
            report["files_read"] = 0

        def meta_batch(paths: list) -> RecordBatch:
            return RecordBatch.from_pydict(
                {
                    "name": [os.path.basename(p) for p in paths],
                    "path": [os.path.relpath(p, root) for p in paths],
                    "format": [os.path.splitext(p)[1].lstrip(".").lower() for p in paths],
                    "size": np.asarray([os.path.getsize(p) for p in paths], np.int64),
                    "mtime": np.asarray([os.path.getmtime(p) for p in paths], np.float64),
                },
                Schema(META_FIELDS),
            )

        def gen():
            pool = None
            try:
                for s in range(0, len(files), meta_rows):
                    paths = files[s : s + meta_rows]
                    mb = meta_batch(paths)
                    if native is not None:
                        # in-situ: metadata conjuncts run BEFORE any content read
                        keep = np.asarray(native.evaluate(mb), bool)
                        if not keep.any():
                            continue
                        mb = mb.filter(keep)
                        paths = [p for p, k in zip(paths, keep) if k]
                    if want_content:
                        if scan_workers > 1 and len(paths) > 1:
                            if pool is None:  # one reader pool per scan, not per batch
                                pool = ThreadPoolExecutor(max_workers=scan_workers)
                            # parallel content reads; map() preserves path order
                            blobs = list(pool.map(_read_file, paths))
                        else:
                            blobs = [_read_file(p) for p in paths]
                        if report is not None:
                            report["files_read"] += len(paths)
                        mb = mb.with_column(CONTENT_FIELD, Column.from_values(dtypes.BINARY, blobs))
                    yield mb.select(out_schema.names)
            finally:
                if pool is not None:
                    pool.shutdown(wait=False)

        return StreamingDataFrame(out_schema, gen)
