"""StreamingDataFrame D = <S, F>  (paper §III-A, eq. 1).

An SDF is a Schema plus an ordered stream of RecordBatches.  It exposes
``Iterator<Row>`` logical semantics while moving data in columnar batches.
Computation downstream of an SDF starts as soon as beta_0 arrives — nothing
here ever waits for the full stream (lazy/streaming by construction).

The batch stream is produced by a zero-argument factory so an SDF can be
re-iterated (fresh generator per consumer) when the underlying source allows
it; one-shot network streams simply raise on the second iteration.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator

from repro_torch.core.batch import RecordBatch, concat_batches
from repro_torch.core.errors import SchemaError
from repro_torch.core.schema import Schema

__all__ = ["StreamingDataFrame", "SDF"]


class StreamingDataFrame:
    __slots__ = ("schema", "_factory", "__weakref__")

    def __init__(self, schema: Schema, batch_factory: Callable[[], Iterator[RecordBatch]]):
        self.schema = schema
        self._factory = batch_factory

    # -- constructors -----------------------------------------------------------
    @staticmethod
    def from_batches(batches: Iterable[RecordBatch], schema: Schema | None = None) -> "StreamingDataFrame":
        batches = list(batches)
        if schema is None:
            if not batches:
                raise SchemaError("cannot infer schema from zero batches")
            schema = batches[0].schema
        for b in batches:
            if not b.schema.equals(schema):
                raise SchemaError("inconsistent batch schema in SDF")
        return StreamingDataFrame(schema, lambda: iter(batches))

    @staticmethod
    def from_pydict(data: dict, schema: Schema | None = None, batch_rows: int = 65536) -> "StreamingDataFrame":
        full = RecordBatch.from_pydict(data, schema)

        def gen():
            for s in range(0, max(full.num_rows, 1), batch_rows):
                yield full.slice(s, s + batch_rows)

        return StreamingDataFrame(full.schema, gen)

    @staticmethod
    def from_generator(schema: Schema, gen_factory: Callable[[], Iterator[RecordBatch]]) -> "StreamingDataFrame":
        return StreamingDataFrame(schema, gen_factory)

    @staticmethod
    def one_shot(schema: Schema, iterator: Iterator[RecordBatch]) -> "StreamingDataFrame":
        state = {"used": False}

        def gen():
            if state["used"]:
                raise SchemaError("one-shot SDF stream already consumed")
            state["used"] = True
            return iterator

        return StreamingDataFrame(schema, gen)

    # -- transformation -------------------------------------------------------
    def map_batches(
        self, fn: Callable[[RecordBatch], RecordBatch], schema: Schema | None = None
    ) -> "StreamingDataFrame":
        """Lazily apply ``fn`` to every batch (executor/engine glue — e.g.
        per-batch accounting or casting).  ``schema`` overrides the output
        schema when ``fn`` changes it; defaults to the input schema."""
        out_schema = schema if schema is not None else self.schema

        def gen() -> Iterator[RecordBatch]:
            for b in self.iter_batches():
                yield fn(b)

        return StreamingDataFrame(out_schema, gen)

    # -- consumption ----------------------------------------------------------
    def iter_batches(self) -> Iterator[RecordBatch]:
        return iter(self._factory())

    def __iter__(self) -> Iterator[dict]:
        return self.iter_rows()

    def iter_rows(self) -> Iterator[dict]:
        """Iterator<Row> view (paper: logical rows, physical batches)."""
        for batch in self.iter_batches():
            yield from batch.iter_rows()

    def collect(self) -> RecordBatch:
        batches = list(self.iter_batches())
        if not batches:
            return RecordBatch.empty(self.schema)
        return concat_batches(batches)

    def head(self, n: int = 10) -> RecordBatch:
        got, rows = [], 0
        for b in self.iter_batches():
            need = n - rows
            if b.num_rows > need:
                b = b.slice(0, need)
            got.append(b)
            rows += b.num_rows
            if rows >= n:
                break
        if not got:
            return RecordBatch.empty(self.schema)
        return concat_batches(got)

    def count_rows(self) -> int:
        return sum(b.num_rows for b in self.iter_batches())


SDF = StreamingDataFrame
