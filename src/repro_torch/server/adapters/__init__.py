"""Format adapter registry for the datasource (see ``base`` for the
contract).  Importing this package registers the built-in formats; the
order below is the resolution order:

  directory kinds first (columnar dataset sidecar beats plain directory),
  then file extensions, then content sniffing (SQLite magic without a
  known extension), and the blob catch-all last so ``resolve`` never
  fails for an existing path.

``register_adapter(..., before="blob")`` is the extension point for new
formats.
"""

from __future__ import annotations

import os

from repro_torch.server.adapters.base import (
    DEFAULT_BATCH_ROWS,
    DEFAULT_CHUNK_BYTES,
    Capabilities,
    ScanAdapter,
    build_masked_batch,
    join_conjuncts,
    register_adapter,
    registered_formats,
    resolve,
    split_conjuncts,
)
from repro_torch.server.adapters.columnar import ColumnarAdapter, columnar_parts, is_columnar_dataset
from repro_torch.server.adapters.jsonl import JsonlAdapter, infer_jsonl_schema, jsonl_stream_sdf
from repro_torch.server.adapters.parquet import HAVE_PYARROW, ParquetAdapter, is_parquet_file
from repro_torch.server.adapters.sqlite import SqliteAdapter, is_sqlite_file
from repro_torch.server.adapters.structured import (
    CsvAdapter,
    NpyAdapter,
    NpzAdapter,
    csv_stream_sdf,
    infer_csv_schema,
    npy_array_sdf,
    npz_arrays_sdf,
    read_npy_header,
)
from repro_torch.server.adapters.unstructured import (
    CONTENT_FIELD,
    META_FIELDS,
    BlobAdapter,
    FileListAdapter,
    bytes_chunks_sdf,
    list_files,
)

__all__ = [
    "Capabilities",
    "ScanAdapter",
    "register_adapter",
    "registered_formats",
    "resolve",
    "split_conjuncts",
    "join_conjuncts",
    "build_masked_batch",
    "DEFAULT_BATCH_ROWS",
    "DEFAULT_CHUNK_BYTES",
    "ColumnarAdapter",
    "FileListAdapter",
    "BlobAdapter",
    "CsvAdapter",
    "JsonlAdapter",
    "NpzAdapter",
    "NpyAdapter",
    "SqliteAdapter",
    "ParquetAdapter",
    "HAVE_PYARROW",
    "is_columnar_dataset",
    "is_sqlite_file",
    "is_parquet_file",
    "columnar_parts",
    "list_files",
    "META_FIELDS",
    "CONTENT_FIELD",
    "infer_csv_schema",
    "infer_jsonl_schema",
    "csv_stream_sdf",
    "jsonl_stream_sdf",
    "npz_arrays_sdf",
    "npy_array_sdf",
    "bytes_chunks_sdf",
    "read_npy_header",
]


def _ext(suffix: str):
    return lambda path: os.path.isfile(path) and path.lower().endswith(suffix)


register_adapter("columnar", is_columnar_dataset, ColumnarAdapter)
register_adapter("filelist", os.path.isdir, FileListAdapter)
register_adapter("csv", _ext(".csv"), CsvAdapter)
register_adapter("jsonl", _ext(".jsonl"), JsonlAdapter)
register_adapter("npz", _ext(".npz"), NpzAdapter)
register_adapter("npy", _ext(".npy"), NpyAdapter)
register_adapter("parquet", is_parquet_file, ParquetAdapter)
register_adapter("sqlite", is_sqlite_file, SqliteAdapter)  # extension OR magic sniff
register_adapter("blob", lambda path: True, BlobAdapter)
