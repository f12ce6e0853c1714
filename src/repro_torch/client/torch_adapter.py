"""PyTorch adapter: feeds DACP SDF streams into the port's serving and
training loops (the port of ``repro.client.jax_adapter``).

  * columnar batches → host numpy arrays with **zero copies** (fixed-width
    columns are already contiguous buffers; token sequences travel as Binary
    blobs and are reinterpreted with ``np.frombuffer``);
  * **pull-based but prefetched**: the DACP stream stays lazy, yet a depth-N
    background buffer keeps the next host batch ready while the current step
    runs;
  * ``TorchFeed`` stages each batch in pinned host memory and copies it to
    the card with ``non_blocking``, so the upload overlaps the host's next
    batch.  The device is explicit: ``"cuda"`` unless the caller asks for
    ``"cpu"``.  Over a ``DeviceMesh`` it returns DTensors laid out as
    ``P(batch_axes, None)``, as ``JaxFeed(mesh=)`` does: each rank uploads
    only its own rows.

``batch_to_arrays``, ``tokens_from_blob_column`` and ``PrefetchIterator``
are numpy-only and identical to the reference's.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.core.errors import DacpError
from repro_torch.core.sdf import StreamingDataFrame

__all__ = ["batch_to_arrays", "tokens_from_blob_column", "PrefetchIterator", "TorchFeed"]


def batch_to_arrays(batch, columns=None) -> dict:
    """RecordBatch -> {name: np.ndarray} for fixed-width columns (zero-copy)."""
    out = {}
    names = columns if columns is not None else batch.schema.names
    for name in names:
        c = batch.column(name)
        if c.dtype.is_varwidth:
            continue  # blobs handled by tokens_from_blob_column
        out[name] = c.values
    return out


def tokens_from_blob_column(batch, column: str, seq_len: int, dtype=np.int32) -> np.ndarray:
    """Binary column of fixed-size token blobs -> (rows, seq_len) array.

    Each blob is ``seq_len * dtype.itemsize`` bytes (the pipeline's
    ``tokenize_and_pack`` map guarantees this); reinterpretation is zero-copy
    when the blob column data is contiguous and aligned.
    """
    c = batch.column(column)
    itemsize = np.dtype(dtype).itemsize
    want = seq_len * itemsize
    lens = c.offsets[1:] - c.offsets[:-1]
    if not (lens == want).all():
        raise DacpError(f"blob column {column!r} has ragged token rows (want {want} bytes)")
    if int(c.offsets[0]) % itemsize == 0 and c.data.flags["C_CONTIGUOUS"]:
        flat = c.data[int(c.offsets[0]) : int(c.offsets[-1])]
        try:
            return np.frombuffer(flat, dtype=dtype).reshape(len(lens), seq_len)
        except ValueError:
            pass  # unaligned view; fall through to copy
    rows = [np.frombuffer(bytes(c.data[c.offsets[i] : c.offsets[i + 1]]), dtype=dtype) for i in range(len(lens))]
    return np.stack(rows)


class PrefetchIterator:
    """Depth-``depth`` background prefetch over any iterator."""

    _END = object()

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: list = []

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # propagate into consumer thread
                self._err.append(e)
            finally:
                self._q.put(self._END)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            if self._err:
                raise self._err[0]
            raise StopIteration
        return item


class TorchFeed:
    """SDF stream -> torch training/serving batches on one device.

    feed = TorchFeed(stream_factory, token_column="tokens", seq_len=4096,
                     global_batch=256, device="cuda")
    for step, batch in enumerate(feed):   # batch: {"tokens", "labels"} int32
        ...

    ``tokens`` is every row but its last token and ``labels`` every row but
    its first, as in ``JaxFeed``.  With ``mesh`` (a ``DeviceMesh``) each
    batch is a pair of DTensors sharded over ``batch_axes`` on the rows
    (``P(batch_axes, None)``) and replicated over the other mesh axes: the
    rank at flat coordinate r over ``batch_axes`` (of n) holds rows
    [r·B/n, (r+1)·B/n) of the global batch, on the mesh's device type
    (``device`` is then not taken).  Every rank reads the same stream.
    """

    def __init__(
        self,
        stream_factory,
        token_column: str,
        seq_len: int,
        global_batch: int,
        mesh=None,
        batch_axes=("data",),
        dtype=np.int32,
        prefetch: int = 2,
        drop_remainder: bool = True,
        device=None,
    ):
        from repro_torch import device as device_mod

        self.stream_factory = stream_factory
        self.token_column = token_column
        self.seq_len = int(seq_len)
        self.global_batch = int(global_batch)
        self.mesh = mesh
        self.batch_axes = tuple(batch_axes)
        self.dtype = dtype
        self.prefetch = prefetch
        self.drop_remainder = drop_remainder
        if mesh is None:
            self.device = device_mod.resolve(device)
            return
        if device is not None:
            raise ValueError("TorchFeed over a mesh places batches on the mesh's devices: pass no device")
        self.device = device_mod.resolve(mesh.device_type)
        names = mesh.mesh_dim_names
        missing = [a for a in self.batch_axes if a not in names]
        if missing:
            raise ValueError(f"batch axes {missing} are not axes of the mesh {names}")
        # the rank's flat coordinate over batch_axes, major to minor in mesh order
        coord = mesh.get_coordinate()
        self._shards, self._shard = 1, 0
        for i, name in enumerate(names):
            if name in self.batch_axes:
                self._shards, self._shard = self._shards * mesh.size(i), self._shard * mesh.size(i) + coord[i]
        if self.global_batch % self._shards:
            raise ValueError(f"global batch {self.global_batch} does not split over {self._shards} batch shards")

    def _host_batches(self):
        pending: list = []
        have = 0
        sdf: StreamingDataFrame = self.stream_factory()
        for rb in sdf.iter_batches():
            toks = tokens_from_blob_column(rb, self.token_column, self.seq_len, self.dtype)
            pending.append(toks)
            have += toks.shape[0]
            while have >= self.global_batch:
                buf = np.concatenate(pending, axis=0) if len(pending) > 1 else pending[0]
                yield buf[: self.global_batch]
                rest = buf[self.global_batch :]
                pending = [rest] if len(rest) else []
                have = len(rest)
        if have and not self.drop_remainder:
            yield np.concatenate(pending, axis=0)

    def _to_device(self, host: np.ndarray) -> dict:
        import torch

        if self.mesh is not None:
            if len(host) % self._shards:
                raise ValueError(f"a batch of {len(host)} rows does not split over {self._shards} batch shards")
            rows = len(host) // self._shards
            host = host[self._shard * rows : (self._shard + 1) * rows]
        tokens = torch.from_numpy(np.array(host, dtype=self.dtype))  # a writable copy of the blob view
        if self.device.type == "cuda":
            # pinned staging: the copy runs asynchronously on the current
            # stream, which orders it before any kernel that reads the batch
            tokens = tokens.pin_memory().to(self.device, non_blocking=True)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if self.mesh is None:
            return batch
        from torch.distributed.tensor import DTensor

        from repro_torch.distributed.sharding import placements_for

        placements = placements_for((self.batch_axes, None), self.mesh)
        n = self._shards * len(host)
        return {
            k: DTensor.from_local(v.contiguous(), self.mesh, placements, run_check=False,
                                  shape=(n, v.shape[1]), stride=(v.shape[1], 1))
            for k, v in batch.items()
        }

    def __iter__(self):
        host_it = PrefetchIterator(self._host_batches(), depth=self.prefetch)
        for host in host_it:
            yield self._to_device(host)
