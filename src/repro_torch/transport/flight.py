"""Streaming SDF transfer over a channel (the DoGet/DoPut analogue).

``send_sdf`` frames: SCHEMA, BATCH*, END.  ``recv_sdf`` returns a one-shot
StreamingDataFrame whose batches materialize lazily as frames arrive — the
receiver's compute starts on beta_0 without waiting for beta_{k+1}
(paper §III-A streaming semantics).
"""

from __future__ import annotations

from typing import Iterator

from repro_torch.core.batch import RecordBatch
from repro_torch.core.errors import DacpError, TransportError
from repro_torch.core.schema import Schema
from repro_torch.core.sdf import StreamingDataFrame
from repro_torch.transport import framing

__all__ = ["send_sdf", "recv_sdf", "send_error"]


def send_sdf(channel, sdf: StreamingDataFrame) -> int:
    """Stream an SDF; returns total rows sent.  Errors mid-stream are framed."""
    channel.send(framing.SCHEMA, {"schema": sdf.schema.to_json()})
    rows = 0
    try:
        for batch in sdf.iter_batches():
            header, bufs = batch.to_buffers()
            # zero-copy send: column buffers go to the channel as a list of
            # views, written writev-style without concatenation
            channel.send(framing.BATCH, header, RecordBatch.payload_parts(bufs))
            rows += batch.num_rows
    except DacpError as e:
        channel.send(framing.ERROR, e.to_wire())
        raise
    channel.send(framing.END, {"rows": rows})
    return rows


def send_error(channel, err: DacpError) -> None:
    channel.send(framing.ERROR, err.to_wire())


def recv_sdf(channel, timeout: float | None = None) -> StreamingDataFrame:
    ftype, header, _ = channel.recv(timeout=timeout)
    if ftype == framing.ERROR:
        raise DacpError.from_wire(header)
    if ftype != framing.SCHEMA:
        raise TransportError(f"expected SCHEMA frame, got {ftype}")
    schema = Schema.from_json(header["schema"])

    def batches() -> Iterator[RecordBatch]:
        while True:
            ft, hd, body = channel.recv(timeout=timeout)
            if ft == framing.BATCH:
                yield RecordBatch.from_buffers(schema, hd, body)
            elif ft == framing.END:
                return
            elif ft == framing.ERROR:
                raise DacpError.from_wire(hd)
            else:
                raise TransportError(f"unexpected frame type {ft} inside stream")

    return StreamingDataFrame.one_shot(schema, batches())
