"""Columnar stream framing — the wire format under GET/PUT/COOK.

This is the Arrow-Flight analogue (paper §IV: "Apache Arrow Flight serves as
the underlying Transport Layer"), re-implemented without the dependency.  A
DACP stream is a sequence of frames:

    +--------+------+----------+------------+------------+---------+-----+------+
    | "DACP" | type | reserved | header_len | body_len   | header  | pad | body |
    | 4 B    | 1 B  | 3 B      | u64 LE     | u64 LE     | JSON    |     | raw  |
    +--------+------+----------+------------+------------+---------+-----+------+

The body of a BATCH frame is the 8-aligned concatenation of raw column
buffers (``RecordBatch.payload_parts``); the header carries the buffer
layout.  Senders hand ``FrameWriter`` the buffer list and it is written
writev-style — no concatenation copy on the send path.  Receivers
reconstruct columns with ``np.frombuffer`` views into the body — one memcpy
from the socket, zero further copies (§III-A Zero-Copy).

Frame types:
    SCHEMA   header = schema json                      (opens an SDF stream)
    BATCH    header = buffer layout, body = buffers
    END      header = {"rows": total}                  (closes the stream)
    ERROR    header = DacpError wire form
    REQUEST  header = {verb, uri, token, ...}, body = optional payload (DAG)
    OK       header = ack / result metadata

DACP v2 multiplexing: a REQUEST may carry a ``rid`` (request id) in its
header; every frame belonging to that request's response — OK, SCHEMA,
BATCH, END, ERROR, and upload stream frames — echoes the same ``rid``.
Tagged requests from concurrent callers interleave on one channel; frames
without a ``rid`` follow the v1 one-request-at-a-time discipline, so v1
peers interoperate unchanged (they simply never tag).

Flow streams additionally tag each BATCH header with a monotone ``seq``
(assigned once, at produce time, by the server's FlowManager): a FETCH that
resumes from a cursor re-sends the retained frames with their original
headers and payload parts, so the replay is byte-identical.  Receivers that
ignore ``seq`` (the blocking COOK path) are unaffected — it is just another
header key alongside the buffer layout.
"""

from __future__ import annotations

import json
import struct

from repro_torch.core.errors import TransportError

__all__ = [
    "SCHEMA",
    "BATCH",
    "END",
    "ERROR",
    "REQUEST",
    "OK",
    "PROTOCOL_VERSION",
    "encode_frame",
    "FrameReader",
    "FrameWriter",
]

PROTOCOL_VERSION = 2

MAGIC = b"DACP"
SCHEMA, BATCH, END, ERROR, REQUEST, OK = 1, 2, 3, 4, 5, 6
_NAMES = {1: "SCHEMA", 2: "BATCH", 3: "END", 4: "ERROR", 5: "REQUEST", 6: "OK"}

_HDR = struct.Struct("<4sB3sQQ")
_ALIGN = 8

MAX_HEADER = 64 * 1024 * 1024
MAX_BODY = 1 << 40


def _pad(n: int) -> int:
    return (-n) % _ALIGN


def encode_frame(ftype: int, header: dict, body: bytes = b"") -> bytes:
    hjson = json.dumps(header, separators=(",", ":")).encode()
    head = _HDR.pack(MAGIC, ftype, b"\x00\x00\x00", len(hjson), len(body))
    return b"".join([head, hjson, b"\x00" * _pad(len(hjson)), body])


class FrameWriter:
    """Writes frames to a file-like object with .write (socket.makefile('wb'))."""

    def __init__(self, raw):
        self._raw = raw
        self.bytes_written = 0

    def write_frame(self, ftype: int, header: dict, body=b"") -> None:
        """``body`` is bytes-like OR a list of 8-aligned buffer parts.

        A list is written writev-style — each column buffer goes to the
        (buffered) stream in sequence with **no concatenation copy**, which
        is what keeps the send path zero-copy from ``RecordBatch`` memory
        to the socket (§III-A).
        """
        hjson = json.dumps(header, separators=(",", ":")).encode()
        if isinstance(body, (list, tuple)):
            parts = [p if isinstance(p, memoryview) else memoryview(p) for p in body]
            parts = [p.cast("B") if p.format != "B" or p.ndim != 1 else p for p in parts]
        else:
            parts = [memoryview(body).cast("B")] if len(body) else []
        body_len = sum(len(p) for p in parts)
        head = _HDR.pack(MAGIC, ftype, b"\x00\x00\x00", len(hjson), body_len)
        self._raw.write(head)
        self._raw.write(hjson)
        p = _pad(len(hjson))
        if p:
            self._raw.write(b"\x00" * p)
        for part in parts:
            self._raw.write(part)
        self.bytes_written += len(head) + len(hjson) + p + body_len
        flush = getattr(self._raw, "flush", None)
        if flush:
            flush()


class FrameReader:
    """Reads frames from a file-like object with .read(n) (socket.makefile('rb'))."""

    def __init__(self, raw):
        self._raw = raw
        self.bytes_read = 0

    def _read_exact(self, n: int) -> memoryview:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = self._raw.readinto(view[got:]) if hasattr(self._raw, "readinto") else None
            if k is None:
                chunk = self._raw.read(n - got)
                if not chunk:
                    raise TransportError(f"stream truncated at {got}/{n} bytes")
                view[got : got + len(chunk)] = chunk
                got += len(chunk)
            elif k == 0:
                raise TransportError(f"stream truncated at {got}/{n} bytes")
            else:
                got += k
        self.bytes_read += n
        return view

    def read_frame(self):
        head = self._read_exact(_HDR.size)
        magic, ftype, _rsv, hlen, blen = _HDR.unpack(head)
        if magic != MAGIC:
            raise TransportError(f"bad magic {bytes(magic)!r}")
        if ftype not in _NAMES:
            raise TransportError(f"unknown frame type {ftype}")
        if hlen > MAX_HEADER or blen > MAX_BODY:
            raise TransportError(f"frame too large (h={hlen}, b={blen})")
        hraw = self._read_exact(hlen + _pad(hlen))[:hlen]
        try:
            header = json.loads(bytes(hraw).decode())
        except Exception as e:
            raise TransportError(f"bad frame header json: {e}") from None
        body = self._read_exact(blen) if blen else memoryview(b"")
        return ftype, header, body
