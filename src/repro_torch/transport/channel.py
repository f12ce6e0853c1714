"""Bidirectional channels carrying DACP frames.

Two implementations with one interface:

  * ``InProcChannel``  — queue-pair passing decoded frames directly
    (true zero-copy; used by the in-process cluster, tests, and the
    training data path when faird is co-hosted).
  * ``SocketChannel``  — TCP, frames serialized with ``framing`` (used by
    the standalone server and the wire-accurate benchmarks).

Interface (duplex):
    send(ftype, header, body)    recv() -> (ftype, header, body)
    close()                      bytes_sent / bytes_received

``TaggedChannel`` layers DACP v2 multiplexing on top of either: it is a
per-request *view* over a shared channel that stamps outbound frames with
the request id and receives inbound frames from a demux-fed inbox, so the
flight helpers (``send_sdf``/``recv_sdf``) run unmodified over a channel
carrying many interleaved requests.
"""

from __future__ import annotations

import queue
import socket
import threading

from repro_torch.core.errors import TransportError
from repro_torch.transport import framing

__all__ = ["InProcChannel", "SocketChannel", "TaggedChannel", "channel_pair", "connect_tcp"]

_CLOSE = object()


class InProcChannel:
    def __init__(self, inbox: queue.Queue, outbox: queue.Queue):
        self._in = inbox
        self._out = outbox
        self.bytes_sent = 0
        self.bytes_received = 0
        self._closed = False

    def send(self, ftype: int, header: dict, body=b"") -> None:
        if self._closed:
            raise TransportError("send on closed channel")
        if isinstance(body, (list, tuple)):
            # writev-style buffer list: in-proc frames stay decoded, so the
            # parts are joined here (the peer reconstructs views into it)
            body = b"".join(memoryview(p).cast("B") for p in body)
        elif not isinstance(body, (bytes, memoryview)):
            body = bytes(body)
        # account bytes as-if framed, so in-proc benchmarks report wire sizes
        self.bytes_sent += 24 + len(str(header)) + (len(body) if body is not None else 0)
        self._out.put((ftype, dict(header), body))

    def recv(self, timeout: float | None = None):
        try:
            item = self._in.get(timeout=timeout)
        except queue.Empty:
            raise TransportError("recv timeout") from None
        if item is _CLOSE:
            raise TransportError("channel closed by peer")
        ftype, header, body = item
        self.bytes_received += 24 + len(str(header)) + len(body)
        return ftype, header, memoryview(body) if not isinstance(body, memoryview) else body

    def close(self) -> None:
        # signal BOTH directions: the peer's reader gets EOF, and a local
        # reader blocked in recv wakes with "channel closed" — matching the
        # socket channel, where closing the fd unblocks the reader thread
        # (the session read-loop relies on this to fail in-flight calls)
        if not self._closed:
            self._closed = True
            for q in (self._out, self._in):
                try:
                    q.put_nowait(_CLOSE)
                except Exception:
                    pass


def channel_pair():
    a2b: queue.Queue = queue.Queue()
    b2a: queue.Queue = queue.Queue()
    return InProcChannel(b2a, a2b), InProcChannel(a2b, b2a)


class SocketChannel:
    def __init__(self, sock: socket.socket):
        self._sock = sock
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = sock.makefile("rb", buffering=1 << 20)
        self._wfile = sock.makefile("wb", buffering=1 << 20)
        self._reader = framing.FrameReader(self._rfile)
        self._writer = framing.FrameWriter(self._wfile)

    @property
    def bytes_sent(self) -> int:
        return self._writer.bytes_written

    @property
    def bytes_received(self) -> int:
        return self._reader.bytes_read

    def send(self, ftype: int, header: dict, body=b"") -> None:
        # a locally-closed file object raises ValueError (not OSError):
        # normalize so reconnect/resume paths see one transport failure
        # type whichever side tore the connection down first
        try:
            self._writer.write_frame(ftype, header, body)
        except ValueError as e:
            raise TransportError(f"send on closed channel: {e}") from e

    def recv(self, timeout: float | None = None):
        if timeout is not None:
            self._sock.settimeout(timeout)
        try:
            return self._reader.read_frame()
        except socket.timeout:
            raise TransportError("recv timeout") from None
        except ValueError as e:
            raise TransportError(f"recv on closed channel: {e}") from e
        finally:
            if timeout is not None:
                try:
                    self._sock.settimeout(None)
                except OSError:
                    pass

    def close(self) -> None:
        # flush pending writes, then shut the socket down BEFORE closing the
        # buffered reader: a concurrent recv (session reader thread) holds
        # the buffer lock while blocked in readinto, and only the shutdown
        # wakes it — closing the file first would deadlock on that lock.
        try:
            self._wfile.close()
        except Exception:
            pass
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._rfile.close()
        except Exception:
            pass
        self._sock.close()


INBOX_FRAMES = 256  # per-request demux inbox bound (upload backpressure)


class TaggedChannel:
    """One multiplexed request's view of a shared duplex channel.

    * ``send`` stamps ``rid`` into the frame header and serializes writes
      through the shared lock (a frame is several writes on a socket file;
      concurrent handlers must not interleave mid-frame).
    * ``recv`` pops frames from this request's inbox, which the owning demux
      loop fills with frames whose header carried the matching ``rid``.
      Queued exceptions (connection death) re-raise on the consumer side.
      The inbox is bounded: when a handler drains an upload slower than the
      socket delivers it, ``push`` blocks the demux loop, which propagates
      backpressure to the peer instead of buffering the stream in memory.
    * ``rid=None`` degrades to an untagged pass-through used by the v1
      one-at-a-time path, where the dispatcher may read the channel directly.
    """

    def __init__(self, base, rid, send_lock: threading.Lock):
        self._base = base
        self.rid = rid
        self._send_lock = send_lock
        self.inbox: queue.Queue = queue.Queue(maxsize=INBOX_FRAMES)
        self._done = False

    @property
    def bytes_sent(self) -> int:
        return self._base.bytes_sent

    @property
    def bytes_received(self) -> int:
        return self._base.bytes_received

    def send(self, ftype: int, header: dict, body=b"") -> None:
        if self.rid is not None:
            header = dict(header)
            header["rid"] = self.rid
        with self._send_lock:
            self._base.send(ftype, header, body)

    def recv(self, timeout: float | None = None):
        if self.rid is None:
            return self._base.recv(timeout=timeout)
        try:
            item = self.inbox.get(timeout=timeout)
        except queue.Empty:
            raise TransportError("recv timeout") from None
        if isinstance(item, Exception):
            raise item
        return item

    def push(self, item) -> None:
        """Demux side: deliver a frame tuple (or a terminal exception).
        Blocks on a full inbox (backpressure) but re-checks ``finish`` so a
        dead handler's leftover frames are dropped, not wedged on."""
        while not self._done:
            try:
                self.inbox.put(item, timeout=0.25)
                return
            except queue.Full:
                continue

    def finish(self) -> None:
        """Handler completed/died: subsequent pushes for this rid drop."""
        self._done = True

    def close(self) -> None:
        """No-op: the demux loop owns the underlying channel's lifecycle."""


def connect_tcp(host: str, port: int, timeout: float = 10.0) -> SocketChannel:
    s = socket.create_connection((host, port), timeout=timeout)
    s.settimeout(None)
    return SocketChannel(s)
