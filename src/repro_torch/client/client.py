"""faird client SDK (paper §IV-D) — DACP v2.

A lightweight client that masks channel management and the phased interaction
(HELLO → token → requests).  Since v2 every ``DacpClient`` owns a persistent
**multiplexed session** (``repro_torch.client.session.DacpSession``): one long-lived
channel carries all verbs concurrently, the token renews transparently
mid-session, and legacy v1 peers transparently degrade to the old
channel-per-request discipline.

The client does not execute computations: the chainable ``RemoteFrame`` API
builds a logical DAG client-side; triggering consumption serializes the DAG
and submits it as a **flow** (START + resumable FETCH) on v2 peers, falling
back to the blocking COOK verb against legacy v1 peers.  ``group_by(...)
.agg(...)`` and ``join(...)`` lower to ``aggregate`` / ``join`` operators
that the optimizer pushes toward the data (cross-domain plans ship partial
aggregates, not raw rows).  Structured results arrive as zero-copy columnar
batches; Binary blob columns re-open ("expand") as new SDFs via
``open_blob`` — parsed in memory, never spooled.

``Flow`` is the client half of the flow lifecycle: a handle with
``stream()/collect()`` (transparent reconnect-and-resume from the last
consumed seq), ``status()`` (server-side progress) and ``cancel()``.
"""

from __future__ import annotations

import os
import time

from repro_torch.core.dag import Dag, DagBuilder
from repro_torch.core.errors import DacpError, FlowCancelled, TransportError
from repro_torch.core.expr import Expr
from repro_torch.core.sdf import StreamingDataFrame
from repro_torch.client.session import DacpSession

__all__ = ["DacpClient", "Flow", "RemoteFrame", "GroupedFrame", "open_blob", "AGG_FNS"]

AGG_FNS = ("sum", "mean", "min", "max", "count")


class Flow:
    """Client handle on a server-side flow (asynchronous COOK / SUBMIT).

    ``stream()`` FETCHes the seq-numbered result frames and transparently
    reconnects on channel death: the handle tracks the last consumed seq
    and re-FETCHes from there, so the delivered batch sequence is exactly
    the uninterrupted one — byte-identical, nothing replayed or lost.
    Terminal flow states (CANCELLED/FAILED) are never retried.

    Each handle carries a stable ``consumer`` id: its independent cursor on
    the server-side flow buffer.  Flows can be **shared** — a START whose
    plan fingerprint matches a live or cached flow attaches to it instead
    of re-executing (``shared`` is True on such handles); every consumer
    then reads the one buffer at its own pace."""

    def __init__(self, client: "DacpClient", flow_id: str, token: str | None = None, max_attempts: int = 4, backoff_s: float = 0.05, shared: bool = False):
        self._client = client
        self.flow_id = flow_id
        self._token = token  # scoped pull token for submit flows (scheduler)
        self.max_attempts = max_attempts
        self.backoff_s = backoff_s
        self.next_seq = 0  # resume cursor: last consumed seq + 1
        self.shared = shared  # server matched this plan to an existing flow
        # this handle's cursor key on the (possibly shared) flow buffer;
        # stable across reconnects so the resume keeps the same watermark
        self.consumer = f"c-{os.urandom(8).hex()}"

    def status(self) -> dict:
        return self._client.session.status(self.flow_id, token=self._token)

    def cancel(self, deadline: float | None = None) -> dict:
        return self._client.session.cancel(self.flow_id, token=self._token, deadline=deadline)

    def stream(self) -> StreamingDataFrame:
        """The flow's result SDF with transparent reconnect-and-resume."""
        schema, frames = self._fetch()

        def gen():
            frs = frames
            attempts = 0
            while True:
                try:
                    for seq, batch in frs:
                        self.next_seq = seq + 1
                        attempts = 0  # progress resets the retry budget
                        yield batch
                    return
                except FlowCancelled:
                    raise  # terminal by contract
                except (TransportError, OSError) as err:
                    # channel died mid-stream (raw sockets surface OSError
                    # straight from send/recv): re-FETCH from the cursor —
                    # the server retained every unacked frame, so the
                    # resumed stream continues byte-identically
                    while True:
                        attempts += 1
                        if attempts >= self.max_attempts:
                            raise err from None
                        time.sleep(self.backoff_s * (2**attempts))
                        try:
                            _schema, frs = self._fetch()
                            break
                        except FlowCancelled:
                            raise
                        except (TransportError, OSError) as e2:
                            err = e2

        return StreamingDataFrame.one_shot(schema, gen())

    def _fetch(self):
        return self._client.session.fetch(
            self.flow_id, from_seq=self.next_seq, token=self._token, consumer=self.consumer
        )

    def collect(self):
        return self.stream().collect()

    def iter_batches(self):
        return self.stream().iter_batches()


class DacpClient:
    """One logical connection to a faird server (multiplexed session)."""

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
        self.session = DacpSession(
            channel_factory,
            authority,
            subject=subject,
            credential=credential,
            multiplex=multiplex,
        )

    # -- wire accounting -----------------------------------------------------------
    @property
    def bytes_sent(self) -> int:
        return self.session.bytes_sent

    @property
    def bytes_received(self) -> int:
        return self.session.bytes_received

    # -- verbs --------------------------------------------------------------------
    def get(
        self,
        uri: str,
        token: str | None = None,
        columns=None,
        predicate: Expr | None = None,
        batch_rows: int | None = None,
        advisory_columns: bool = False,
    ) -> StreamingDataFrame:
        return self.session.get(
            uri,
            token=token,
            columns=columns,
            predicate=predicate,
            batch_rows=batch_rows,
            advisory_columns=advisory_columns,
        )

    def put(self, uri: str, sdf: StreamingDataFrame) -> dict:
        return self.session.put(uri, sdf)

    def cook(self, dag: Dag) -> StreamingDataFrame:
        return self.session.cook(dag)

    # -- flow lifecycle --------------------------------------------------------------
    def start(self, dag: Dag, priority: int = 0) -> Flow:
        """Asynchronous COOK: START the plan as a server-side flow and
        return a ``Flow`` handle immediately (no result bytes move yet).
        ``priority`` orders the flow in the tenant's admission queue; the
        handle's ``shared`` flag reports a plan-cache hit (the server
        attached us to an identical live/retained flow — no re-execution)."""
        resp = self.session.start(dag, priority=priority)
        return Flow(self, resp["flow_id"], shared=bool(resp.get("shared")))

    def flow(self, flow_id: str, token: str | None = None) -> Flow:
        """Attach a handle to an existing flow (e.g. a registered SUBMIT
        fragment, using its scoped pull token)."""
        return Flow(self, flow_id, token=token)

    def status(self, flow_id: str) -> dict:
        return self.session.status(flow_id)

    def cancel(self, flow_id: str, token: str | None = None, deadline: float | None = None) -> dict:
        return self.session.cancel(flow_id, token=token, deadline=deadline)

    def submit(self, fragment: Dag, flow_id: str, exchange_tokens: dict) -> str:
        """Internal (scheduler): register a plan fragment; returns pull token."""
        return self.session.submit(fragment, flow_id, exchange_tokens)

    def list(
        self,
        prefix: str | None = None,
        offset: int = 0,
        limit: int | None = None,
        scope: str | None = None,
    ) -> dict:
        """Enumerate the peer's catalog (paged).  Metadata only — no data
        moves.  When the server is part of a catalog mesh the default answer
        is federated (entries carry an ``authority`` field and unreachable
        peers are flagged in ``degraded``); ``scope="local"`` pins it to the
        server's own catalog."""
        return self.session.list(prefix=prefix, offset=offset, limit=limit, scope=scope)

    def describe(self, uri: str, scope: str | None = None) -> dict:
        """Schema + stats + policy for a URI, without streaming any data.
        A URI owned by a mesh peer is forwarded there transparently unless
        ``scope="local"``."""
        return self.session.describe(uri, scope=scope)

    def ping(self, timeout: float = 5.0) -> dict:
        return self.session.ping(timeout=timeout)

    def close(self) -> None:
        self.session.close()

    # -- chainable API ---------------------------------------------------------------
    def open(self, uri: str) -> "RemoteFrame":
        b = DagBuilder()
        nid = b.source(uri)
        return RemoteFrame(self, b, nid)

    def dataframe(self, uri: str) -> "RemoteFrame":
        return self.open(uri)


class RemoteFrame:
    """Chainable, lazy, serializable — the user-facing DAG builder."""

    def __init__(self, client: DacpClient, builder: DagBuilder, head: str):
        self._client = client
        self._b = builder
        self._head = head

    def _chain(self, op: str, params: dict, extra_inputs=()) -> "RemoteFrame":
        nid = self._b.add(op, params, [self._head, *extra_inputs])
        return RemoteFrame(self._client, self._b, nid)

    def _merge(self, other: "RemoteFrame") -> None:
        # merge the other builder's nodes into ours (ids are globally unique)
        self._b.nodes.update(other._b.nodes)

    def filter(self, predicate: Expr) -> "RemoteFrame":
        return self._chain("filter", {"predicate": predicate})

    def select(self, *columns) -> "RemoteFrame":
        cols = list(columns[0]) if len(columns) == 1 and isinstance(columns[0], (list, tuple)) else list(columns)
        return self._chain("select", {"columns": cols})

    def project(self, keep: bool = True, **exprs: Expr) -> "RemoteFrame":
        return self._chain("project", {"exprs": exprs, "keep": keep})

    def map(self, fn: str, **fn_params) -> "RemoteFrame":
        return self._chain("map", {"fn": fn, "fn_params": fn_params})

    def rebatch(self, rows: int) -> "RemoteFrame":
        return self._chain("rebatch", {"rows": int(rows)})

    def limit(self, n: int) -> "RemoteFrame":
        return self._chain("limit", {"n": int(n)})

    def union(self, other: "RemoteFrame") -> "RemoteFrame":
        self._merge(other)
        nid = self._b.add("union", {}, [self._head, other._head])
        return RemoteFrame(self._client, self._b, nid)

    # -- relational ops (v2) -------------------------------------------------------
    def group_by(self, *keys) -> "GroupedFrame":
        """Start a grouped aggregation: ``rf.group_by("k").agg(total=("sum", "v"))``."""
        ks = list(keys[0]) if len(keys) == 1 and isinstance(keys[0], (list, tuple)) else list(keys)
        if not ks:
            raise ValueError("group_by needs at least one key column")
        return GroupedFrame(self, ks)

    def join(self, other: "RemoteFrame", on) -> "RemoteFrame":
        """Inner equi-join on key columns.  Right-side non-key columns that
        collide with left names are suffixed ``_r``."""
        on = [on] if isinstance(on, str) else list(on)
        if not on:
            raise ValueError("join needs at least one key column")
        self._merge(other)
        nid = self._b.add("join", {"on": on}, [self._head, other._head])
        return RemoteFrame(self._client, self._b, nid)

    # -- terminal ops -------------------------------------------------------------
    def dag(self) -> Dag:
        return self._b.finish(self._head).copy()

    def stream(self) -> StreamingDataFrame:
        """Consume the frame: on a v2 peer the DAG runs as a flow (START +
        FETCH) so the stream survives channel drops via seq-based resume;
        legacy v1 peers get the blocking COOK verb with identical rows."""
        dag = self.dag()
        sess = self._client.session
        if sess.v2 is None:
            try:
                sess.connect()
            except DacpError:
                return self._client.cook(dag)  # surface errors the COOK way
        if sess.v2:
            return self._client.start(dag).stream()
        return self._client.cook(dag)

    def start(self, priority: int = 0) -> "Flow":
        """START the DAG as a server-side flow; returns the ``Flow`` handle
        (status/cancel/stream) without pulling any result bytes."""
        return self._client.start(self.dag(), priority=priority)

    def iter_batches(self):
        return self.stream().iter_batches()

    def iter_rows(self):
        return self.stream().iter_rows()

    def collect(self):
        return self.stream().collect()

    def head(self, n: int = 10):
        return self.limit(n).stream().collect()

    def count_rows(self) -> int:
        return self.stream().count_rows()


class GroupedFrame:
    """``RemoteFrame.group_by(...)`` result: holds keys, awaits ``agg``."""

    def __init__(self, frame: RemoteFrame, keys: list):
        self._frame = frame
        self._keys = keys

    def agg(self, **aggs) -> RemoteFrame:
        """Each kwarg is an output column: ``name=("fn", "column")`` with fn in
        sum/mean/min/max/count, or ``name="count"`` for a bare row count."""
        if not aggs:
            raise ValueError("agg needs at least one aggregation")
        norm = {}
        for out, spec in aggs.items():
            if isinstance(spec, str):
                fn, column = spec, None
            else:
                fn, column = spec
            fn = fn.lower()
            if fn not in AGG_FNS:
                raise ValueError(f"unknown aggregation fn {fn!r} (have {AGG_FNS})")
            if fn != "count" and column is None:
                raise ValueError(f"aggregation {out}={fn!r} needs a source column")
            norm[out] = {"fn": fn, "column": column}
        return self._frame._chain("aggregate", {"keys": list(self._keys), "aggs": norm, "mode": "full"})

    def count(self, name: str = "count") -> RemoteFrame:
        return self.agg(**{name: "count"})


def open_blob(value: bytes, fmt: str = "") -> StreamingDataFrame:
    """Expandable blob column (paper §III-A): re-open binary content as a new
    SDF.  Structured formats (csv/jsonl/npz/npy) parse in-memory and stream
    batch-by-batch; anything else becomes a lazy chunk stream.  No temp files,
    no full materialization."""
    from repro_torch.server.datasource import scan_bytes

    return scan_bytes(bytes(value), fmt)
