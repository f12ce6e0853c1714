"""Record Batch beta_k — the atomic unit of transport (paper §III-A).

A RecordBatch holds a finite set of rows conforming to a Schema, laid out
**columnar** in memory: every fixed-width column is one contiguous
little-endian numpy buffer; var-width columns (string/binary) are an
``int64`` offsets buffer (n+1) plus a ``uint8`` data buffer — the layout that
makes zero-copy hand-off between the wire and application memory possible
(the paper's Arrow rationale, re-implemented without the Arrow dependency).

Buffer protocol: ``to_buffers()`` emits ``(header_json, [memoryview, ...])``
and ``from_buffers()`` reconstructs a batch without copying (``np.frombuffer``
views into the framed payload).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import dtypes
from repro_torch.core.dtypes import DType
from repro_torch.core.errors import SchemaError, TypeMismatchError
from repro_torch.core.schema import Field, Schema

__all__ = ["Column", "RecordBatch", "concat_batches"]

_ALIGN = 8


def _pad(n: int) -> int:
    return (-n) % _ALIGN


class Column:
    """One typed column: fixed-width values or (offsets, data) var-width."""

    __slots__ = ("dtype", "values", "offsets", "data", "validity")

    def __init__(self, dtype: DType, values=None, offsets=None, data=None, validity=None):
        self.dtype = dtype
        self.values = values  # fixed-width: np.ndarray
        self.offsets = offsets  # var-width: int64[n+1]
        self.data = data  # var-width: uint8[*]
        self.validity = validity  # optional bool[n]
        if dtype.is_varwidth:
            assert offsets is not None and data is not None
            assert offsets.dtype == np.int64 and data.dtype == np.uint8
        else:
            assert values is not None
            if values.dtype != dtype.np_dtype:
                raise TypeMismatchError(
                    f"column buffer dtype {values.dtype} != declared {dtype.name}"
                )

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_values(dtype: DType, seq) -> "Column":
        dtype = dtypes.resolve(dtype)
        if dtype.is_varwidth:
            blobs = []
            for v in seq:
                if isinstance(v, str):
                    v = v.encode()
                elif isinstance(v, (bytes, bytearray, memoryview, np.ndarray)):
                    v = bytes(v)
                else:
                    raise TypeMismatchError(f"cannot store {type(v).__name__} in {dtype.name}")
                blobs.append(v)
            lens = np.fromiter((len(b) for b in blobs), dtype=np.int64, count=len(blobs))
            offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
            np.cumsum(lens, out=offsets[1:])
            data = np.frombuffer(b"".join(blobs), dtype=np.uint8) if blobs else np.zeros(0, np.uint8)
            return Column(dtype, offsets=offsets, data=data)
        arr = np.asarray(seq, dtype=dtype.np_dtype)
        if arr.ndim != 1:
            arr = arr.reshape(-1)
        return Column(dtype, values=np.ascontiguousarray(arr))

    # -- access ---------------------------------------------------------------
    def __len__(self) -> int:
        if self.dtype.is_varwidth:
            return len(self.offsets) - 1
        return len(self.values)

    @property
    def nbytes(self) -> int:
        if self.dtype.is_varwidth:
            n = self.offsets.nbytes + self.data.nbytes
        else:
            n = self.values.nbytes
        if self.validity is not None:
            n += self.validity.nbytes
        return n

    def value(self, i: int):
        if self.validity is not None and not self.validity[i]:
            return None
        if self.dtype.is_varwidth:
            raw = bytes(self.data[self.offsets[i] : self.offsets[i + 1]])
            return raw.decode() if self.dtype.name == "string" else raw
        v = self.values[i]
        return v.item() if isinstance(v, np.generic) else v

    def to_pylist(self) -> list:
        return [self.value(i) for i in range(len(self))]

    def to_numpy(self) -> np.ndarray:
        if self.dtype.is_varwidth:
            raise TypeMismatchError(f"{self.dtype.name} column is not dense-numeric")
        return self.values

    # -- kernels used by the operator library ---------------------------------
    def take(self, idx: np.ndarray) -> "Column":
        validity = self.validity[idx] if self.validity is not None else None
        if not self.dtype.is_varwidth:
            return Column(self.dtype, values=self.values[idx], validity=validity)
        lens = self.offsets[1:][idx] - self.offsets[:-1][idx]
        new_off = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=new_off[1:])
        out = np.empty(int(new_off[-1]), dtype=np.uint8)
        for j, i in enumerate(idx):
            out[new_off[j] : new_off[j + 1]] = self.data[self.offsets[i] : self.offsets[i + 1]]
        return Column(self.dtype, offsets=new_off, data=out, validity=validity)

    def filter(self, mask: np.ndarray) -> "Column":
        return self.take(np.flatnonzero(mask))

    def slice(self, start: int, stop: int) -> "Column":
        validity = self.validity[start:stop] if self.validity is not None else None
        if not self.dtype.is_varwidth:
            return Column(self.dtype, values=self.values[start:stop], validity=validity)
        off = self.offsets[start : stop + 1]
        data = self.data[off[0] : off[-1]]
        return Column(self.dtype, offsets=off - off[0], data=data, validity=validity)

    # -- buffers ---------------------------------------------------------------
    def buffers(self):
        """Returns (layout_descriptor, [np buffers]) for wire framing."""
        bufs, kinds = [], []
        if self.validity is not None:
            bufs.append(np.ascontiguousarray(self.validity))
            kinds.append("validity")
        if self.dtype.is_varwidth:
            bufs.append(np.ascontiguousarray(self.offsets))
            kinds.append("offsets")
            bufs.append(np.ascontiguousarray(self.data))
            kinds.append("data")
        else:
            bufs.append(np.ascontiguousarray(self.values))
            kinds.append("data")
        return kinds, bufs

    @staticmethod
    def from_buffers(dtype: DType, n_rows: int, kinds, raw_views) -> "Column":
        m = dict(zip(kinds, raw_views))
        validity = None
        if "validity" in m:
            validity = np.frombuffer(m["validity"], dtype=np.bool_, count=n_rows)
        if dtype.is_varwidth:
            offsets = np.frombuffer(m["offsets"], dtype=np.int64, count=n_rows + 1)
            data = np.frombuffer(m["data"], dtype=np.uint8)
            data = data[: int(offsets[-1])]
            return Column(dtype, offsets=offsets, data=data, validity=validity)
        values = np.frombuffer(m["data"], dtype=dtype.np_dtype, count=n_rows)
        return Column(dtype, values=values, validity=validity)


class RecordBatch:
    """schema + columns, all the same length."""

    __slots__ = ("schema", "columns", "num_rows")

    def __init__(self, schema: Schema, columns):
        columns = list(columns)
        if len(columns) != len(schema):
            raise SchemaError(f"{len(columns)} columns for {len(schema)}-field schema")
        n = len(columns[0]) if columns else 0
        for f, c in zip(schema, columns):
            if len(c) != n:
                raise SchemaError(f"ragged batch: column {f.name} has {len(c)} rows != {n}")
            if c.dtype != f.dtype:
                raise TypeMismatchError(f"column {f.name}: {c.dtype.name} != schema {f.dtype.name}")
        self.schema = schema
        self.columns = columns
        self.num_rows = n

    # -- construction ----------------------------------------------------------
    @staticmethod
    def from_pydict(data: dict, schema: Schema | None = None) -> "RecordBatch":
        if schema is None:
            fields = []
            for k, v in data.items():
                arr = np.asarray(v)
                if arr.dtype.kind in ("U", "S", "O"):
                    dt = dtypes.STRING
                    if len(arr) and isinstance(np.asarray(v, dtype=object).reshape(-1)[0], (bytes, bytearray)):
                        dt = dtypes.BINARY
                else:
                    dt = dtypes.from_numpy(arr.dtype)
                fields.append(Field(k, dt))
            schema = Schema(fields)
        cols = [Column.from_values(schema.dtype(k), data[k]) for k in schema.names]
        return RecordBatch(schema, cols)

    @staticmethod
    def empty(schema: Schema) -> "RecordBatch":
        return RecordBatch(schema, [Column.from_values(f.dtype, []) for f in schema])

    # -- access ------------------------------------------------------------------
    def column(self, name: str) -> Column:
        return self.columns[self.schema.index(name)]

    def __len__(self) -> int:
        return self.num_rows

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns)

    def row(self, i: int) -> dict:
        return {f.name: c.value(i) for f, c in zip(self.schema, self.columns)}

    def iter_rows(self):
        """Iterator<Row> semantics over a columnar physical layout (§III-A)."""
        for i in range(self.num_rows):
            yield self.row(i)

    def to_pydict(self) -> dict:
        return {f.name: c.to_pylist() for f, c in zip(self.schema, self.columns)}

    # -- relational kernels --------------------------------------------------------
    def select(self, names) -> "RecordBatch":
        return RecordBatch(self.schema.select(names), [self.column(n) for n in names])

    def take(self, idx: np.ndarray) -> "RecordBatch":
        idx = np.asarray(idx, dtype=np.int64)
        return RecordBatch(self.schema, [c.take(idx) for c in self.columns])

    def filter(self, mask: np.ndarray) -> "RecordBatch":
        mask = np.asarray(mask, dtype=bool)
        if len(mask) != self.num_rows:
            raise SchemaError(f"mask length {len(mask)} != {self.num_rows}")
        return self.take(np.flatnonzero(mask))

    def slice(self, start: int, stop: int) -> "RecordBatch":
        start = max(0, min(start, self.num_rows))
        stop = max(start, min(stop, self.num_rows))
        return RecordBatch(self.schema, [c.slice(start, stop) for c in self.columns])

    def with_column(self, field: Field, col: Column) -> "RecordBatch":
        if field.name in self.schema:
            i = self.schema.index(field.name)
            fields = list(self.schema.fields)
            fields[i] = field
            cols = list(self.columns)
            cols[i] = col
            return RecordBatch(Schema(fields), cols)
        return RecordBatch(self.schema.append(field), list(self.columns) + [col])

    # -- wire -------------------------------------------------------------------
    def to_buffers(self):
        """(header: dict, buffers: [np.ndarray]) — buffers are NOT copied."""
        header_cols, bufs = [], []
        for f, c in zip(self.schema, self.columns):
            kinds, cb = c.buffers()
            header_cols.append(
                {"name": f.name, "kinds": kinds, "lens": [int(b.nbytes) for b in cb]}
            )
            bufs.extend(cb)
        header = {"num_rows": int(self.num_rows), "columns": header_cols}
        return header, bufs

    @staticmethod
    def from_buffers(schema: Schema, header: dict, payload: memoryview) -> "RecordBatch":
        """Zero-copy reconstruct from a contiguous 8-aligned payload."""
        n = int(header["num_rows"])
        cols = []
        pos = 0
        for f, hc in zip(schema, header["columns"]):
            views = []
            for ln in hc["lens"]:
                views.append(payload[pos : pos + ln])
                pos += ln + _pad(ln)
            cols.append(Column.from_buffers(f.dtype, n, hc["kinds"], views))
        return RecordBatch(schema, cols)

    _PAD = b"\x00" * (_ALIGN - 1)

    @staticmethod
    def payload_parts(bufs) -> list:
        """Buffer parts (with 8-byte alignment padding interleaved) ready for
        a writev-style frame write — **no concatenation copy**.  Views
        reference the column memory directly; the writer streams them out
        sequentially (``FrameWriter.write_frame`` with a list body)."""
        parts = []
        for b in bufs:
            raw = memoryview(b).cast("B")
            parts.append(raw)
            p = _pad(len(raw))
            if p:
                parts.append(RecordBatch._PAD[:p])
        return parts

    @staticmethod
    def payload_bytes(bufs) -> bytes:
        """Concatenate buffers with 8-byte alignment (the frame body)."""
        return b"".join(RecordBatch.payload_parts(bufs))


def concat_batches(batches) -> RecordBatch:
    batches = [b for b in batches if b.num_rows >= 0]
    if not batches:
        raise SchemaError("concat of zero batches")
    schema = batches[0].schema
    for b in batches[1:]:
        if not b.schema.equals(schema):
            raise SchemaError(f"schema mismatch in concat: {b.schema} vs {schema}")
    cols = []
    for i, f in enumerate(schema):
        if f.dtype.is_varwidth:
            offs = [b.columns[i].offsets for b in batches]
            datas = [b.columns[i].data for b in batches]
            lens = np.concatenate([o[1:] - o[:-1] for o in offs]) if offs else np.zeros(0, np.int64)
            new_off = np.zeros(len(lens) + 1, dtype=np.int64)
            np.cumsum(lens, out=new_off[1:])
            data = np.concatenate(datas) if datas else np.zeros(0, np.uint8)
            col = Column(f.dtype, offsets=new_off, data=data)
        else:
            col = Column(f.dtype, values=np.concatenate([b.columns[i].values for b in batches]))
        v = [b.columns[i].validity for b in batches]
        if any(x is not None for x in v):
            col.validity = np.concatenate(
                [x if x is not None else np.ones(b.num_rows, bool) for x, b in zip(v, batches)]
            )
        cols.append(col)
    return RecordBatch(schema, cols)
