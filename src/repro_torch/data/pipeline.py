"""The LM training data pipeline, expressed as a DACP COOK DAG.

The paper's in-situ principle applied to training input: tokenization and
packing run **at the data server** (a ``map`` operator in the COOK DAG);
only fixed-length token blobs cross the wire, already shaped for
``JaxFeed``.  Raw text never reaches the training hosts.

Registered map fns:
    tokenize_and_pack(column, seq_len)  — text column → 'tokens' Binary blobs
                                          of exactly (seq_len+1) int32 values
                                          (shift-by-one happens device-side)
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import dtypes
from repro_torch.core.batch import Column, RecordBatch
from repro_torch.core.operators import register_map
from repro_torch.core.schema import Field, Schema
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["training_dag", "TOKENS_COLUMN"]

TOKENS_COLUMN = "tokens"
_TOK = ByteTokenizer()


def _tokenize_schema(schema: Schema, **params) -> Schema:
    keep = [f for f in schema.fields if f.name != TOKENS_COLUMN]
    return Schema(keep + [Field(TOKENS_COLUMN, dtypes.BINARY)])


def _tokenize_and_pack(batch: RecordBatch, column: str, seq_len: int) -> RecordBatch:
    texts = batch.column(column).to_pylist()
    blobs = []
    for t in texts:
        ids = _TOK.encode(t or "")
        packed = _TOK.pack(ids, int(seq_len) + 1)  # +1 → tokens/labels shift
        blobs.append(packed.tobytes())
    out = batch.with_column(Field(TOKENS_COLUMN, dtypes.BINARY), Column.from_values(dtypes.BINARY, blobs))
    return out


_tokenize_and_pack.schema_fn = _tokenize_schema
register_map("tokenize_and_pack", reads=("*",), writes=(TOKENS_COLUMN,))(_tokenize_and_pack)


def training_dag(corpus_uri: str, text_column: str = "text", seq_len: int = 4096, batch_rows: int = 256):
    """source → tokenize_and_pack → select(tokens) → rebatch."""
    from repro_torch.core.dag import Dag

    b = Dag.build()
    src = b.source(corpus_uri)
    tok = b.add("map", {"fn": "tokenize_and_pack", "fn_params": {"column": text_column, "seq_len": int(seq_len)}}, [src])
    sel = b.add("select", {"columns": [TOKENS_COLUMN]}, [tok])
    reb = b.add("rebatch", {"rows": int(batch_rows)}, [sel])
    return b.finish(reb)
