"""Columnar-dataset adapter: a directory of ``part-*.npz`` files plus a
``_schema.json`` sidecar (what PUT persistence writes).  The sorted part
file is the ``part_range`` split unit — batches never span part files, so
disjoint contiguous ranges concatenated in order reproduce the full scan
byte-identically (the partition-parallel planner's contract).
"""

from __future__ import annotations

import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.core.batch import Column, RecordBatch
from repro_torch.core.schema import Schema
from repro_torch.core.sdf import StreamingDataFrame
from repro_torch.server.adapters.base import DEFAULT_BATCH_ROWS, Capabilities, ScanAdapter
from repro_torch.server.adapters.structured import npz_arrays_sdf

__all__ = ["ColumnarAdapter", "is_columnar_dataset", "columnar_parts"]


def is_columnar_dataset(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "_schema.json"))


def columnar_parts(root: str) -> list:
    return sorted(p for p in os.listdir(root) if p.startswith("part-") and p.endswith(".npz"))


class ColumnarAdapter(ScanAdapter):
    format = "columnar"

    def capabilities(self) -> Capabilities:
        return Capabilities(part_ranges=True)

    def schema(self) -> Schema:
        with open(os.path.join(self.path, "_schema.json")) as f:
            return Schema.from_json(json.load(f))

    def part_count(self) -> int | None:
        return len(columnar_parts(self.path))

    def version(self) -> dict:
        # the newest part file + the part list length catch both appended
        # parts and a rewritten sidecar schema
        latest, size = 0, 0
        for fn in ["_schema.json"] + columnar_parts(self.path):
            try:
                st = os.stat(os.path.join(self.path, fn))
            except OSError:
                continue
            latest = max(latest, st.st_mtime_ns)
            size += st.st_size
        return {"size": size, "mtime_ns": latest, "parts": self.part_count()}

    def scan(
        self,
        columns=None,
        predicate=None,
        batch_rows=DEFAULT_BATCH_ROWS,
        scan_workers: int = 1,
        part_range=None,
        **_kw,
    ):
        root = self.path
        schema = self.schema()
        parts = columnar_parts(root)
        if part_range is not None:
            lo, hi = int(part_range[0]), int(part_range[1])
            parts = parts[lo:hi]

        def _cast(batch: RecordBatch) -> RecordBatch:
            # npz inference loses STRING-vs-BINARY and column order; restore both
            cols = []
            for f in schema:
                c = batch.column(f.name)
                if f.dtype.is_varwidth and c.dtype is not f.dtype:
                    c = Column(f.dtype, offsets=c.offsets, data=c.data, validity=c.validity)
                cols.append(c)
            return RecordBatch(schema, cols)

        def _load(p: str) -> dict:
            with np.load(os.path.join(root, p), mmap_mode="r") as z:
                return {k: z[k] for k in z.files}

        def gen():
            if scan_workers <= 1 or len(parts) <= 1:
                for p in parts:
                    for b in npz_arrays_sdf(_load(p), batch_rows).iter_batches():
                        yield _cast(b)
                return
            # bounded read-ahead: up to scan_workers part files decode in
            # background threads while earlier parts stream out, in part order
            with ThreadPoolExecutor(max_workers=scan_workers) as pool:
                pending: deque = deque()
                it = iter(parts)
                for p in it:
                    pending.append(pool.submit(_load, p))
                    if len(pending) >= scan_workers:
                        break
                while pending:
                    arrays = pending.popleft().result()
                    nxt = next(it, None)
                    if nxt is not None:
                        pending.append(pool.submit(_load, nxt))
                    for b in npz_arrays_sdf(arrays, batch_rows).iter_batches():
                        yield _cast(b)

        return StreamingDataFrame(schema, gen)
