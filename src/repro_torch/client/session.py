"""DACP v2 persistent, multiplexed client session (paper §III-C, redesigned).

One ``DacpSession`` holds one long-lived channel to a faird server and
multiplexes every verb over it:

  * each REQUEST is tagged with a fresh ``rid``; a background reader thread
    demultiplexes response/stream frames by ``rid`` into per-request inboxes,
    so any number of requests can be in flight concurrently — GET streams
    interleave with COOKs, SUBMITs and PINGs on the same socket;
  * the HELLO phase runs once per connection; when the session token nears
    expiry the session transparently re-HELLOs *on the same channel* (no
    reconnect, no caller-visible pause) and retries once on a server-side
    ``TokenError``;
  * a peer that does not advertise ``proto >= 2`` in its HELLO response is a
    legacy v1 server: the session falls back to the channel-per-request
    discipline with identical semantics (and byte accounting);
  * a dead session channel is re-established lazily on the next request —
    in-flight requests surface the transport error to their callers;
  * flow verbs (START/FETCH/STATUS/CANCEL) expose the server's flow
    lifecycle: ``start`` returns a flow id immediately, ``fetch`` streams
    seq-numbered result frames from a cursor and acks them in-band (OK
    frames on the rid) so the server can release delivered buffers — a
    reconnecting ``fetch`` from the last consumed seq replays nothing and
    loses nothing.

The verb surface: GET, PUT, COOK, START, FETCH, STATUS, CANCEL, SUBMIT,
LIST, DESCRIBE, PING, BYE.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
import weakref

from repro_torch.core.batch import RecordBatch
from repro_torch.core.errors import DacpError, PermissionDenied, TokenError, TransportError
from repro_torch.core.schema import Schema
from repro_torch.core.sdf import StreamingDataFrame
from repro_torch.transport import framing
from repro_torch.transport.channel import INBOX_FRAMES
from repro_torch.transport.flight import recv_sdf, send_sdf

__all__ = ["DacpSession"]

# INBOX_FRAMES (shared with the server-side TaggedChannel) bounds each
# request's demux inbox: the reader blocks (briefly, re-checking for release)
# once a consumer lags that many frames behind, so one slow stream applies
# backpressure instead of buffering an entire GET in client memory.
# A stream whose consumer neither drains nor releases it for this long is
# aborted so it cannot wedge the session's demux loop permanently.
STALL_TIMEOUT_S = 60.0


class _Call:
    """Client half of one in-flight request: a channel-like object whose
    ``recv`` drains the rid's demuxed inbox and whose ``send`` emits
    rid-tagged frames (PUT upload streams)."""

    __slots__ = ("_session", "rid", "_inbox", "_released", "_sem")

    def __init__(self, session: "DacpSession", rid: int, sem=None):
        self._session = session
        self.rid = rid
        self._inbox: queue.Queue = queue.Queue(maxsize=INBOX_FRAMES)
        self._released = False
        self._sem = sem  # in-flight slot held until release

    def send(self, ftype: int, header: dict, body=b"") -> None:
        self._session._send_tagged(ftype, dict(header), body, self.rid)

    def recv(self, timeout: float | None = None):
        try:
            item = self._inbox.get(timeout=timeout)
        except queue.Empty:
            raise TransportError("recv timeout") from None
        if isinstance(item, Exception):
            raise item
        return item

    def push(self, item) -> None:
        """Demux side.  Blocks when the consumer lags (bounded memory), but
        re-checks for release so frames for an abandoned request are dropped
        rather than wedging the session's read loop.  A consumer that holds
        the stream without draining it for STALL_TIMEOUT_S aborts with an
        error instead of stalling the whole session forever."""
        waited = 0.0
        while not self._released:
            try:
                self._inbox.put(item, timeout=0.25)
                return
            except queue.Full:
                waited += 0.25
                if waited >= STALL_TIMEOUT_S:
                    self.release()
                    self.push_error(TransportError(f"stream consumer stalled > {STALL_TIMEOUT_S:.0f}s; aborted"))
                    return

    def push_error(self, e: Exception) -> None:
        """Terminal error delivery: never blocks — evicts queued frames if
        the inbox is full (the stream is dead, the error must get through)."""
        while True:
            try:
                self._inbox.put_nowait(e)
                return
            except queue.Full:
                try:
                    self._inbox.get_nowait()
                except queue.Empty:
                    pass

    def release(self) -> None:
        if not self._released:
            self._released = True
            # free the in-flight slot before touching the session lock: a
            # thread holding that lock may be blocked in sem.acquire(), and
            # taking the lock first would complete the hold-and-wait cycle
            if self._sem is not None:
                self._sem.release()
            self._session._release(self.rid)

    def close(self) -> None:  # channel-duck-typing for flight helpers
        self.release()


class DacpSession:
    """Persistent multiplexed connection (v2) with legacy v1 fallback."""

    def __init__(
        self,
        channel_factory,
        authority: str,
        subject: str = "anonymous",
        credential: str | None = None,
        multiplex: bool = True,
    ):
        self._factory = channel_factory
        self.authority = authority
        self.subject = subject
        self.credential = credential
        self.multiplex = multiplex  # False forces channel-per-request (benchmarks)
        self.v2: bool | None = None  # unknown until the first HELLO
        self.max_inflight = 1
        self.connects = 0  # channels opened (1 per session lifetime on v2)
        self._ch = None
        self._lock = threading.RLock()
        self._send_lock = threading.Lock()
        self._rids = itertools.count(1)
        self._pending: dict = {}
        self._inflight_sem = None  # BoundedSemaphore(max_inflight) once v2
        self._token: str | None = None
        self._token_exp = 0.0
        self._token_iat = 0.0
        # byte accounting for channels this session has retired (legacy mode
        # channels, dead session channels); live-channel bytes add on top
        self._retired_sent = 0
        self._retired_received = 0

    # -- byte accounting ---------------------------------------------------------
    @property
    def bytes_sent(self) -> int:
        ch = self._ch
        return self._retired_sent + (ch.bytes_sent if ch is not None else 0)

    @property
    def bytes_received(self) -> int:
        ch = self._ch
        return self._retired_received + (ch.bytes_received if ch is not None else 0)

    def _retire(self, ch) -> None:
        self._retired_sent += ch.bytes_sent
        self._retired_received += ch.bytes_received
        try:
            ch.close()
        except DacpError:
            pass

    # -- connection / token lifecycle --------------------------------------------
    def _hello_header(self) -> dict:
        hdr = {"verb": "HELLO", "subject": self.subject}
        if self.credential is not None:
            hdr["credential"] = self.credential
        if self.multiplex:
            hdr["proto"] = framing.PROTOCOL_VERSION
        return hdr

    def _store_token(self, resp: dict) -> None:
        self._token = resp["token"]
        self._token_exp = float(resp.get("expires", time.time() + 240))
        self._token_iat = time.time()

    def _token_fresh(self) -> bool:
        if self._token is None:
            return False
        ttl = max(self._token_exp - self._token_iat, 0.0)
        margin = min(5.0, max(0.05, 0.2 * ttl))
        return time.time() < self._token_exp - margin

    def connect(self, timeout: float | None = None):
        """Establish the session (idempotent).  Detects v1 vs v2 peers."""
        with self._lock:
            if self.v2 and self._ch is not None:
                return
            ch = self._factory()
            self.connects += 1
            try:
                ch.send(framing.REQUEST, self._hello_header())  # dacpcheck: ignore[blocking] reason=single-flight HELLO; nothing can use the session before it exists
                ftype, resp, _ = ch.recv(timeout=timeout)  # dacpcheck: ignore[blocking] reason=single-flight HELLO; connect takes no other lock so no ordering cycle
            except DacpError:
                self._retire(ch)
                raise
            if ftype == framing.ERROR:
                self._retire(ch)
                raise DacpError.from_wire(resp)
            self._store_token(resp)
            if self.multiplex and int(resp.get("proto", 1)) >= 2:
                self.v2 = True
                self.max_inflight = int(resp.get("max_inflight", 1))
                self._inflight_sem = threading.BoundedSemaphore(max(1, self.max_inflight))
                self._ch = ch
                threading.Thread(target=self._read_loop, args=(ch,), daemon=True).start()
            else:
                self.v2 = False
                self._retire(ch)

    def _read_loop(self, ch) -> None:
        """Demux: route every inbound frame to the rid's in-flight call."""
        while True:
            try:
                ftype, header, body = ch.recv()
            except Exception as exc:  # channel death in ANY form ends the loop
                e = exc if isinstance(exc, DacpError) else TransportError(f"session channel lost: {exc}")
                with self._lock:
                    if self._ch is ch:
                        self._retired_sent += ch.bytes_sent
                        self._retired_received += ch.bytes_received
                        self._ch = None
                    pending, self._pending = self._pending, {}
                for call in pending.values():
                    call.push_error(e)
                return
            rid = header.get("rid") if isinstance(header, dict) else None
            with self._lock:
                call = self._pending.get(rid)
            if call is not None:
                call.push((ftype, header, body))
            # frames for released/unknown rids are dropped (late stragglers)

    def _refresh_token(self, force: bool = False) -> str:
        """Mint/renew the session token; on v2 the re-HELLO rides the live
        session channel (no reconnect).

        The refresh round-trip runs with the session lock *released*.  The
        old shape held ``_lock`` across ``_begin``, which blocks on the
        in-flight semaphore — but a slot only frees via ``_Call.release``,
        which needs ``_lock``: with ``max_inflight`` requests outstanding a
        token refresh deadlocked the whole session.  (The v1 branch also did
        a full network round-trip under the lock, stalling every other
        thread for a peer round-trip.)
        """
        with self._lock:
            if self.v2 is None:
                self.connect()  # dacpcheck: ignore[blocking] reason=first-use HELLO; no caller holds a slot before the session exists
                return self._token
            if not force and self._token_fresh():
                return self._token
            if self.v2 and self._ch is None:
                # session channel died: re-establish (fresh HELLO included)
                self.v2 = None
                self.connect()  # dacpcheck: ignore[blocking] reason=dead-channel recovery; pending calls already got transport errors, no slot is held
                return self._token
            v2 = self.v2
        if v2:
            # rides the live session channel; recv outside the lock (the
            # reader thread and slot holders must be able to make progress)
            call = self._begin(self._hello_header())
            try:
                ftype, resp, _ = call.recv()
                if ftype == framing.ERROR:
                    raise DacpError.from_wire(resp)
            finally:
                call.release()
        else:
            ch = self._factory()
            try:
                ch.send(framing.REQUEST, self._hello_header())
                ftype, resp, _ = ch.recv()
                if ftype == framing.ERROR:
                    raise DacpError.from_wire(resp)
            finally:
                with self._lock:
                    self.connects += 1
                    self._retire(ch)
        with self._lock:
            self._store_token(resp)
            return self._token

    # -- request plumbing (v2) -----------------------------------------------------
    def _begin(self, header: dict, body=b"") -> _Call:
        """Allocate a rid, register its inbox, and send the REQUEST frame.
        Blocks on the in-flight semaphore when the session already has
        max_inflight requests outstanding (queue, don't get rejected)."""
        with self._lock:
            if self._ch is None:
                self.v2 = None
                self.connect()  # dacpcheck: ignore[blocking] reason=lazy reconnect before any slot is taken; connect holds only _lock
                if not self.v2:
                    raise TransportError(f"peer {self.authority} no longer speaks v2")
            sem = self._inflight_sem
        if sem is not None:
            sem.acquire()
        with self._lock:
            if self._ch is None:  # died while we waited for a slot
                sem.release()
                raise TransportError("session channel lost")
            rid = next(self._rids)
            call = _Call(self, rid, sem)
            self._pending[rid] = call
            ch = self._ch
        header = dict(header)
        header["rid"] = rid
        try:
            with self._send_lock:
                ch.send(framing.REQUEST, header, body)
        except DacpError:
            self._release(rid)
            raise
        return call

    def _send_tagged(self, ftype: int, header: dict, body, rid: int) -> None:
        header["rid"] = rid
        ch = self._ch
        if ch is None:
            raise TransportError("session channel closed")
        with self._send_lock:
            ch.send(ftype, header, body)

    def _release(self, rid: int) -> None:
        with self._lock:
            self._pending.pop(rid, None)

    def _call_v2(self, header: dict, body=b"", authenticated: bool = True, token: str | None = None) -> _Call:
        if authenticated:
            header = dict(header)
            header["token"] = token or self._refresh_token()
        return self._begin(header, body)

    def _roundtrip(self, header: dict, body=b"", authenticated: bool = True, timeout: float | None = None) -> dict:
        """Single REQUEST -> OK exchange (v2 path), with one re-HELLO retry
        when the server rejects the session token (clock skew past the
        client-side freshness margin)."""
        for attempt in (0, 1):
            call = self._call_v2(header, body, authenticated=authenticated)
            try:
                ftype, resp, _ = call.recv(timeout=timeout)
                if ftype == framing.ERROR:
                    err = DacpError.from_wire(resp)
                    if isinstance(err, TokenError) and authenticated and attempt == 0:
                        self._refresh_token(force=True)
                        continue
                    raise err
                resp.pop("rid", None)  # transport tag, not payload
                return resp
            finally:
                call.release()

    def _stream_result(self, sdf: StreamingDataFrame, call: _Call) -> StreamingDataFrame:
        holder: dict = {}

        def gen():
            try:
                yield from sdf.iter_batches()
            finally:
                holder.clear()
                call.release()

        out = StreamingDataFrame.one_shot(sdf.schema, gen())
        # a never-iterated generator skips its finally even on GC; tie the
        # release to the SDF's lifetime so an abandoned stream frees its rid.
        # The generator must in turn pin the SDF (holder cell): a caller that
        # keeps only `sdf.iter_batches()` would otherwise GC the SDF, fire
        # the finalizer mid-stream, and drop the rest of the stream's frames.
        holder["sdf"] = out
        weakref.finalize(out, call.release)
        return out

    # -- legacy plumbing (v1 channel-per-request) ----------------------------------
    def _legacy_channel(self):
        ch = self._factory()
        self.connects += 1
        return ch

    def _legacy_stream(self, sdf: StreamingDataFrame, ch) -> StreamingDataFrame:
        def gen():
            try:
                yield from sdf.iter_batches()
            finally:
                self._retire(ch)

        return StreamingDataFrame.one_shot(sdf.schema, gen())

    def _legacy_roundtrip(self, hdr: dict, body=b"", authenticated: bool = True, timeout: float | None = None) -> dict:
        """Single REQUEST -> OK exchange on a fresh channel (v1 discipline)."""
        ch = self._legacy_channel()
        try:
            if authenticated:
                hdr = dict(hdr)
                hdr["token"] = self._refresh_token()
            ch.send(framing.REQUEST, hdr, body)
            ftype, resp, _ = ch.recv(timeout=timeout)
            if ftype == framing.ERROR:
                raise DacpError.from_wire(resp)
            return resp
        finally:
            self._retire(ch)

    # -- verbs ----------------------------------------------------------------------
    def get(
        self,
        uri: str,
        token: str | None = None,
        columns=None,
        predicate=None,
        batch_rows: int | None = None,
        advisory_columns: bool = False,
    ) -> StreamingDataFrame:
        hdr = {"verb": "GET", "uri": str(uri)}
        if columns is not None:
            hdr["columns"] = list(columns)
            if advisory_columns:
                # optimizer-pruned hint set: the scan keeps the intersection
                hdr["columns_mode"] = "advisory"
        if predicate is not None:
            hdr["predicate"] = predicate.to_json()
        if batch_rows:
            hdr["batch_rows"] = int(batch_rows)
        if self.v2 is None:
            self.connect()
        if self.v2:
            call = self._call_v2(hdr, token=token)
            try:
                sdf = recv_sdf(call)
            except TokenError:
                call.release()
                if token is not None:
                    raise  # caller-scoped token (flow pulls): not ours to renew
                self._refresh_token(force=True)
                call = self._call_v2(hdr)
                try:
                    sdf = recv_sdf(call)
                except DacpError:
                    call.release()
                    raise
            except DacpError:
                call.release()
                raise
            return self._stream_result(sdf, call)
        ch = self._legacy_channel()
        try:
            hdr["token"] = token or self._refresh_token()
            ch.send(framing.REQUEST, hdr)
            sdf = recv_sdf(ch)
        except DacpError:
            self._retire(ch)
            raise
        return self._legacy_stream(sdf, ch)

    def put(self, uri: str, sdf: StreamingDataFrame) -> dict:
        hdr = {"verb": "PUT", "uri": str(uri)}
        if self.v2 is None:
            self.connect()
        if self.v2:
            for attempt in (0, 1):
                call = self._call_v2(hdr)
                try:
                    ftype, resp, _ = call.recv()
                    if ftype == framing.ERROR:
                        err = DacpError.from_wire(resp)
                        if isinstance(err, TokenError) and attempt == 0:
                            # safe to retry: no stream frames were sent yet
                            self._refresh_token(force=True)
                            continue
                        raise err
                    send_sdf(call, sdf)
                    ftype, resp, _ = call.recv()
                    if ftype == framing.ERROR:
                        raise DacpError.from_wire(resp)
                    resp.pop("rid", None)
                    return resp
                finally:
                    call.release()
        ch = self._legacy_channel()
        try:
            hdr["token"] = self._refresh_token()
            ch.send(framing.REQUEST, hdr)
            ftype, resp, _ = ch.recv()
            if ftype == framing.ERROR:
                raise DacpError.from_wire(resp)
            send_sdf(ch, sdf)
            ftype, resp, _ = ch.recv()
            if ftype == framing.ERROR:
                raise DacpError.from_wire(resp)
            return resp
        finally:
            self._retire(ch)

    def cook(self, dag) -> StreamingDataFrame:
        body = dag.to_bytes()
        if self.v2 is None:
            self.connect()
        if self.v2:
            call = self._call_v2({"verb": "COOK"}, body)
            try:
                sdf = recv_sdf(call)
            except TokenError:
                call.release()
                self._refresh_token(force=True)
                call = self._call_v2({"verb": "COOK"}, body)
                try:
                    sdf = recv_sdf(call)
                except DacpError:
                    call.release()
                    raise
            except DacpError:
                call.release()
                raise
            return self._stream_result(sdf, call)
        ch = self._legacy_channel()
        try:
            ch.send(framing.REQUEST, {"verb": "COOK", "token": self._refresh_token()}, body)
            sdf = recv_sdf(ch)
        except DacpError:
            self._retire(ch)
            raise
        return self._legacy_stream(sdf, ch)

    # -- flow verbs -----------------------------------------------------------------
    def start(self, dag, priority: int = 0) -> dict:
        """Asynchronous COOK: returns ``{"flow_id", "state", "shared"}``
        immediately; consume with ``fetch`` / wrap in a client ``Flow``
        handle.  ``priority`` orders this flow within the tenant's admission
        queue (higher dispatches first); ``shared`` is True when the plan
        matched a live/cached identical flow server-side (no re-execution)."""
        hdr = {"verb": "START"}
        if priority:
            hdr["priority"] = int(priority)
        body = dag.to_bytes()
        if self.v2 is None:
            self.connect()
        if self.v2:
            return self._roundtrip(hdr, body)
        return self._legacy_roundtrip(hdr, body)

    def status(self, flow_id: str, token: str | None = None) -> dict:
        hdr = {"verb": "STATUS", "flow_id": flow_id}
        return self._flow_roundtrip(hdr, token)

    def cancel(self, flow_id: str, token: str | None = None, deadline: float | None = None) -> dict:
        hdr = {"verb": "CANCEL", "flow_id": flow_id}
        if deadline is not None:
            hdr["deadline"] = float(deadline)
        return self._flow_roundtrip(hdr, token)

    def _flow_roundtrip(self, hdr: dict, token: str | None) -> dict:
        if self.v2 is None:
            self.connect()
        if token is not None:
            # caller-scoped flow token (scheduler-held): not ours to renew
            hdr = dict(hdr)
            hdr["token"] = token
            if self.v2:
                return self._roundtrip(hdr, authenticated=False)
            return self._legacy_roundtrip(hdr, authenticated=False)
        if self.v2:
            return self._roundtrip(hdr)
        return self._legacy_roundtrip(hdr)

    def fetch(self, flow_id: str, from_seq: int = 0, token: str | None = None, consumer: str | None = None):
        """Open a flow's result stream at ``from_seq``.

        Returns ``(schema, frames)`` where ``frames`` yields ``(seq, batch)``
        tuples in seq order; over a v2 session each delivered frame is acked
        in-band so the server can drop it from the flow buffer.  On channel
        death the iterator raises ``TransportError`` — the caller re-fetches
        from its last consumed seq + 1 and the replay is byte-identical.

        ``consumer`` names this reader's cursor on the server's (possibly
        multi-consumer, shared) flow buffer: readers ack independently and
        the buffer trims to the slowest; a stable id lets a reconnect resume
        the same cursor.  Omitted, the server assigns an ephemeral cursor."""
        hdr = {"verb": "FETCH", "flow_id": flow_id, "from_seq": int(from_seq)}
        if consumer is not None:
            hdr["consumer"] = str(consumer)
        if self.v2 is None:
            self.connect()
        if self.v2:
            for attempt in (0, 1):
                call = self._call_v2(hdr, token=token)
                try:
                    return self._fetch_frames(call)
                except TokenError:
                    call.release()
                    if token is not None or attempt == 1:
                        raise
                    self._refresh_token(force=True)
                except DacpError:
                    call.release()
                    raise
        ch = self._legacy_channel()
        try:
            hdr["token"] = token or self._refresh_token()
            ch.send(framing.REQUEST, hdr)
            return self._fetch_frames(ch, legacy=True)
        except DacpError:
            self._retire(ch)
            raise

    def _fetch_frames(self, call, legacy: bool = False):
        """SCHEMA handshake + the (seq, batch) frame iterator for one FETCH."""
        ftype, header, _ = call.recv()
        if ftype == framing.ERROR:
            raise DacpError.from_wire(header)
        if ftype != framing.SCHEMA:
            raise TransportError(f"expected SCHEMA frame, got {ftype}")
        schema = Schema.from_json(header["schema"])

        def frames():
            try:
                while True:
                    ft, hd, body = call.recv()
                    if ft == framing.BATCH:
                        seq = int(hd.get("seq", -1))
                        yield seq, RecordBatch.from_buffers(schema, hd, body)
                        if not legacy:
                            try:
                                # in-band ack: the server releases seqs < ack
                                call.send(framing.OK, {"ack": seq + 1})
                            except (DacpError, OSError):
                                # channel died (a raw socket raises OSError
                                # straight from send); the next recv surfaces
                                # the death as a resumable TransportError
                                pass
                    elif ft == framing.END:
                        return
                    elif ft == framing.ERROR:
                        raise DacpError.from_wire(hd)
                    else:
                        raise TransportError(f"unexpected frame type {ft} inside flow stream")
            finally:
                if legacy:
                    self._retire(call)
                else:
                    call.release()

        return schema, frames()

    def submit(self, fragment, flow_id: str, exchange_tokens: dict) -> str:
        hdr = {"verb": "SUBMIT", "flow_id": flow_id, "exchange_tokens": exchange_tokens}
        body = fragment.to_bytes()
        if self.v2 is None:
            self.connect()
        if self.v2:
            return self._roundtrip(hdr, body)["token"]
        return self._legacy_roundtrip(hdr, body)["token"]

    def list(
        self,
        prefix: str | None = None,
        offset: int = 0,
        limit: int | None = None,
        scope: str | None = None,
    ) -> dict:
        """Catalog enumeration with paging (LIST).

        ``scope``: ``None`` lets the server pick (federated when it has a
        mesh), ``"local"`` pins the answer to that server's own catalog,
        ``"mesh"`` requests the federation explicitly."""
        hdr = {"verb": "LIST", "offset": int(offset)}
        if prefix is not None:
            hdr["prefix"] = prefix
        if limit is not None:
            hdr["limit"] = int(limit)
        if scope is not None:
            hdr["scope"] = scope
        if self.v2 is None:
            self.connect()
        if self.v2:
            return self._roundtrip(hdr)
        return self._legacy_roundtrip(hdr)

    def describe(self, uri: str, scope: str | None = None) -> dict:
        """Schema + stats + policy for a URI (DESCRIBE) — no data movement.
        ``scope="local"`` stops the server from forwarding a peer-owned URI
        through its mesh."""
        hdr = {"verb": "DESCRIBE", "uri": str(uri)}
        if scope is not None:
            hdr["scope"] = scope
        if self.v2 is None:
            self.connect()
        if self.v2:
            return self._roundtrip(hdr)
        return self._legacy_roundtrip(hdr)

    def ping(self, timeout: float = 5.0) -> dict:
        if self.v2 is None:
            try:
                self.connect(timeout=timeout)  # liveness probes must stay bounded
            except PermissionDenied:
                pass  # PING is unauthenticated: probe on a bare channel below
        if self.v2:
            return self._roundtrip({"verb": "PING"}, authenticated=False, timeout=timeout)
        return self._legacy_roundtrip({"verb": "PING"}, authenticated=False, timeout=timeout)

    def close(self) -> None:
        """Polite BYE + channel teardown.  Safe to call repeatedly."""
        with self._lock:
            ch, self._ch = self._ch, None
            pending, self._pending = self._pending, {}
        if ch is None:
            return
        try:
            with self._send_lock:
                ch.send(framing.REQUEST, {"verb": "BYE", "rid": 0})
        except DacpError:
            pass
        err = TransportError("session closed")
        for call in pending.values():
            call.push_error(err)
        self._retire(ch)
