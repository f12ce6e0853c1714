"""CSV / NPZ / NPY adapters (the seed structured formats, now behind the
Scan interface).  Scan behavior is byte-identical to the pre-adapter
``datasource`` if/elif: these formats have no native pushdown, so the whole
predicate is residual and column projection happens in the caller.

Schema/stats come from bounded metadata reads: the npy/npz array *headers*
(zip central directory + npy magic, data blocks never touched) and a capped
CSV row probe — the same sniffing DESCRIBE has always promised.
"""

from __future__ import annotations

import csv as _csv
import os
import zipfile

import numpy as np

from repro_torch.core import dtypes
from repro_torch.core.batch import Column, RecordBatch
from repro_torch.core.errors import SchemaError
from repro_torch.core.schema import Field, Schema
from repro_torch.core.sdf import StreamingDataFrame
from repro_torch.server.adapters.base import DEFAULT_BATCH_ROWS, ScanAdapter

__all__ = [
    "CsvAdapter",
    "NpzAdapter",
    "NpyAdapter",
    "infer_csv_schema",
    "csv_stream_sdf",
    "npz_arrays_sdf",
    "npy_array_sdf",
    "read_npy_header",
]


# ---------------------------------------------------------------------------
# csv
# ---------------------------------------------------------------------------
def infer_csv_schema(rows: list, names: list) -> Schema:
    fields = []
    cols = list(zip(*rows)) if rows else [[] for _ in names]
    for name, vals in zip(names, cols):
        dt = dtypes.INT64
        for v in vals:
            try:
                int(v)
            except ValueError:
                dt = dtypes.FLOAT64
                try:
                    float(v)
                except ValueError:
                    dt = dtypes.STRING
                    break
        fields.append(Field(name, dt))
    return Schema(fields)


def csv_stream_sdf(opener, batch_rows: int, what: str) -> StreamingDataFrame:
    """``opener`` returns a fresh text stream per iteration (file or memory)."""
    schema = _csv_probe_schema(opener, what)

    def gen():
        with opener() as f:
            reader = _csv.reader(f)
            next(reader)  # header
            buf: list = []
            for row in reader:
                buf.append(row)
                if len(buf) >= batch_rows:
                    yield _rows_to_batch(schema, buf)
                    buf = []
            if buf:
                yield _rows_to_batch(schema, buf)

    return StreamingDataFrame(schema, gen)


def _csv_probe_schema(opener, what: str) -> Schema:
    with opener() as f:
        reader = _csv.reader(f)
        try:
            names = next(reader)
        except StopIteration:
            raise SchemaError(f"empty csv {what}") from None
        probe = []
        for row in reader:
            probe.append(row)
            if len(probe) >= 256:
                break
    return infer_csv_schema(probe, names)


def _rows_to_batch(schema: Schema, rows: list) -> RecordBatch:
    cols = []
    for i, f in enumerate(schema):
        raw = [r[i] for r in rows]
        if f.dtype is dtypes.STRING:
            cols.append(Column.from_values(f.dtype, raw))
        elif f.dtype.is_integer:
            cols.append(Column.from_values(f.dtype, np.asarray(raw, np.int64)))
        else:
            cols.append(Column.from_values(f.dtype, np.asarray(raw, np.float64)))
    return RecordBatch(schema, cols)


class CsvAdapter(ScanAdapter):
    format = "csv"

    def schema(self) -> Schema:
        return _csv_probe_schema(lambda: open(self.path, newline=""), self.path)

    def scan(self, columns=None, predicate=None, batch_rows=DEFAULT_BATCH_ROWS, **_kw):
        return csv_stream_sdf(lambda: open(self.path, newline=""), batch_rows, self.path)


# ---------------------------------------------------------------------------
# npz / npy
# ---------------------------------------------------------------------------
def npz_schema(arrays: dict) -> Schema:
    fields = []
    for k in sorted(arrays):
        if k.endswith("__offsets") or k == "__nrows__":
            continue
        if k.endswith("__data") and f"{k[: -len('__data')]}__offsets" in arrays:
            base = k[: -len("__data")]
            fields.append(Field(base, dtypes.BINARY))
        else:
            fields.append(Field(k, dtypes.from_numpy(arrays[k].dtype)))
    return Schema(sorted(fields, key=lambda f: f.name))


def npz_arrays_sdf(arrays: dict, batch_rows: int) -> StreamingDataFrame:
    schema = npz_schema(arrays)
    n = None
    for f in schema:
        if f.dtype.is_varwidth:
            n2 = len(arrays[f"{f.name}__offsets"]) - 1
        else:
            n2 = len(arrays[f.name])
        n = n2 if n is None else min(n, n2)
    n = n or 0

    def make_col(f: Field, s: int, e: int) -> Column:
        if f.dtype.is_varwidth:
            off = arrays[f"{f.name}__offsets"].astype(np.int64)
            data = arrays[f"{f.name}__data"].astype(np.uint8)
            seg = off[s : e + 1]
            return Column(f.dtype, offsets=seg - seg[0], data=data[seg[0] : seg[-1]])
        return Column(f.dtype, values=np.ascontiguousarray(arrays[f.name][s:e]))

    def gen():
        for s in range(0, max(n, 1), batch_rows):
            e = min(s + batch_rows, n)
            if e <= s and n > 0:
                break
            yield RecordBatch(schema, [make_col(f, s, e) for f in schema])
            if n == 0:
                break

    return StreamingDataFrame(schema, gen)


def npy_array_sdf(arr: np.ndarray, batch_rows: int) -> StreamingDataFrame:
    flat = arr.reshape(arr.shape[0], -1) if arr.ndim > 1 else arr.reshape(-1, 1)
    # N-d arrays frame as one column per trailing index ("v0", "v1", ...)
    ncol = flat.shape[1]
    dt = dtypes.from_numpy(arr.dtype)
    schema = Schema([Field(f"v{i}", dt) for i in range(ncol)]) if ncol > 1 else Schema([Field("values", dt)])

    def gen():
        for s in range(0, len(flat), batch_rows):
            seg = np.ascontiguousarray(flat[s : s + batch_rows])
            cols = [Column(dt, values=np.ascontiguousarray(seg[:, i])) for i in range(ncol)]
            yield RecordBatch(schema, cols)

    return StreamingDataFrame(schema, gen)


def read_npy_header(f):
    """(shape, dtype) from an npy stream using only public numpy API."""
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, _fortran, dt = np.lib.format.read_array_header_1_0(f)
    else:
        shape, _fortran, dt = np.lib.format.read_array_header_2_0(f)
    return shape, dt


def _min_rows(cur, new):
    return new if cur is None else min(cur, new)


class NpzAdapter(ScanAdapter):
    format = "npz"

    def _headers(self) -> dict:
        """Member array headers only — the zip data blocks are never read."""
        headers = {}
        with zipfile.ZipFile(self.path) as z:
            for member in z.namelist():
                if not member.endswith(".npy"):
                    continue
                with z.open(member) as f:
                    shape, dt = read_npy_header(f)
                headers[member[: -len(".npy")]] = (shape, np.dtype(dt))
        return headers

    def _schema_rows(self):
        headers = self._headers()
        fields, rows = [], None
        for k in sorted(headers):
            if k.endswith("__offsets") or k == "__nrows__":
                continue
            if k.endswith("__data") and f"{k[: -len('__data')]}__offsets" in headers:
                base = k[: -len("__data")]
                fields.append(Field(base, dtypes.BINARY))
                rows = _min_rows(rows, int(headers[f"{base}__offsets"][0][0]) - 1)
            else:
                fields.append(Field(k, dtypes.from_numpy(headers[k][1])))
                rows = _min_rows(rows, int(headers[k][0][0]) if headers[k][0] else 0)
        return Schema(sorted(fields, key=lambda f: f.name)), rows

    def schema(self) -> Schema:
        return self._schema_rows()[0]

    def stats(self) -> dict:
        out = super().stats()
        _schema, rows = self._schema_rows()
        if rows is not None:
            out["rows"] = rows
        return out

    def scan(self, columns=None, predicate=None, batch_rows=DEFAULT_BATCH_ROWS, **_kw):
        with np.load(self.path, mmap_mode="r") as z:
            arrays = {k: z[k] for k in z.files}
        return npz_arrays_sdf(arrays, batch_rows)


class NpyAdapter(ScanAdapter):
    format = "npy"

    def _schema_rows(self):
        with open(self.path, "rb") as f:
            shape, dt = read_npy_header(f)
        base = dtypes.from_numpy(np.dtype(dt))
        ncol = 1
        if len(shape) > 1:
            ncol = int(np.prod(shape[1:]))
        if ncol > 1:
            return Schema([Field(f"v{i}", base) for i in range(ncol)]), int(shape[0])
        return Schema([Field("values", base)]), int(shape[0]) if shape else None

    def schema(self) -> Schema:
        return self._schema_rows()[0]

    def stats(self) -> dict:
        out = super().stats()
        _schema, rows = self._schema_rows()
        if rows is not None:
            out["rows"] = rows
        return out

    def scan(self, columns=None, predicate=None, batch_rows=DEFAULT_BATCH_ROWS, **_kw):
        return npy_array_sdf(np.load(self.path, mmap_mode="r"), batch_rows)
