"""faird — the DACP reference server (paper §IV).

Request verbs (REQUEST frame header ``{"verb": ..., "uri": ..., "token": ...}``):

    HELLO    credentials → short-lived session token (phased interaction,
             §III-C); a v2 HELLO also pins the channel as a persistent
             multiplexed session (response advertises ``proto``)
    GET      stream an SDF; honors scan pushdown params (columns / predicate)
    PUT      ingest an SDF stream into a dataset path
    COOK     body = DAG json; blocking execute-and-stream.  Since the flow
             redesign this is START+FETCH server-side: the plan runs as an
             (anonymous) flow whose buffered frames are drained inline —
             same wire shape as before, for v1/v2 peers alike
    START    body = DAG json; returns a flow handle (``flow_id``) at once —
             the plan runs asynchronously under the server's FlowManager
    FETCH    stream a flow's seq-numbered result frames from ``from_seq``;
             cursor-based and resumable — a reconnecting client re-FETCHes
             from its last acked seq and gets byte-identical frames.  Over a
             v2 session the client acks in-band (OK frames on the rid)
    STATUS   flow progress: state, seq/rows/bytes counters, live executor
             morsel counts + spill counters, per-subtask scheduler state
    CANCEL   cancel a flow; propagates cross-domain to child SUBMIT flows
             and tears down executor pipelines/spill files within a deadline
    SUBMIT   internal: register a plan fragment; returns a flow pull token
    LIST     paged catalog enumeration — metadata only, no data files opened
    DESCRIBE schema + stats + policy for one URI — metadata only
    PING     heartbeat (scheduler liveness probes + flow-table counters)
    BYE      close the connection / session

DACP v2 multiplexing: a REQUEST carrying a ``rid`` is dispatched to a worker
thread whose response frames are stamped with the same ``rid``, so many
requests interleave concurrently on one channel (one session = one channel =
N in-flight requests).  Requests without a ``rid`` take the v1 synchronous
path unchanged, which is the legacy-peer fallback.

The same handler serves in-process channel pairs (co-hosted data plane — the
usual deployment inside a training pod) and TCP sockets (standalone server).
"""

from __future__ import annotations

import queue
import threading
import time

from repro_torch import trace
from repro_torch.core.dag import Dag
from repro_torch.core.env import env_int, env_str
from repro_torch.core.errors import DacpError, PermissionDenied, ResourceNotFound, TokenError, TransportError
from repro_torch.core.executor import ExecutorConfig, prefetch_sdf
from repro_torch.core.expr import Expr
from repro_torch.core.planner import partition_plan
from repro_torch.core.planner import plan as plan_dag
from repro_torch.core.pushdown import optimize
from repro_torch.core.tokens import TokenAuthority
from repro_torch.core.uri import parse as parse_uri
from repro_torch.server.catalog import Catalog
from repro_torch.server.datasource import part_count as source_part_count
from repro_torch.server.datasource import write_sdf_dataset
from repro_torch.server.engine import SDFEngine
from repro_torch.server.mesh import MeshRegistry
from repro_torch.server.plancache import fingerprint as plan_fingerprint
from repro_torch.transport import framing
from repro_torch.transport.channel import TaggedChannel
from repro_torch.transport.flight import recv_sdf, send_error, send_sdf

__all__ = ["FairdServer"]

MAX_INFLIGHT = 64  # advertised per-session concurrency budget


class FairdServer:
    def __init__(
        self,
        authority: str,
        catalog: Catalog | None = None,
        secret: bytes | None = None,
        credentials: dict | None = None,
        network=None,
        protocol_version: int = framing.PROTOCOL_VERSION,
        executor: ExecutorConfig | None = None,
        peers=None,
        mesh: MeshRegistry | None = None,
    ):
        self.authority = authority
        self.aliases = {authority}  # addresses under which peers reach us
        self.catalog = catalog or Catalog()
        self.tokens = TokenAuthority(secret=secret)
        # subject -> shared secret; None = accept anonymous HELLO
        self.credentials = credentials
        self.network = network  # set by the cluster; used for cross-domain pulls
        # protocol_version=1 serves the legacy wire protocol only (tests /
        # staged rollouts); v2 peers then fall back to channel-per-request.
        self.protocol_version = protocol_version
        # morsel-executor configuration: worker count, morsel rows, compute
        # backend, producer-queue depth for outbound streams
        self.executor = executor if executor is not None else ExecutorConfig()
        self.engine = SDFEngine(
            authority,
            self.catalog,
            self.tokens,
            remote_pull=self._remote_pull,
            aliases=self.aliases,
            executor=self.executor,
        )
        self.flows = self.engine.flows  # lifecycle owner of every COOK/SUBMIT
        # federated catalog mesh: explicit peer list, or DACP_PEERS, or none.
        # The network_fn is late-bound because the cluster wires
        # ``server.network`` after construction; the catalog invalidation
        # listener keeps federated answers from outliving a local PUT.
        if mesh is None:
            if peers is None:
                peers = [p.strip() for p in env_str("DACP_PEERS").split(",") if p.strip()]
            if peers:
                mesh = MeshRegistry(
                    authority,
                    self.catalog,
                    lambda: self.network,
                    peers,
                    local_load_fn=lambda: self.flows.stats()["active"],
                )
        self.mesh = mesh
        if self.mesh is not None:
            self.catalog.on_invalidate(self.mesh.invalidate_local)
        self.started_at = time.time()
        self.stats = {
            "get": 0,
            "put": 0,
            "cook": 0,
            "submit": 0,
            "list": 0,
            "describe": 0,
            "start": 0,
            "fetch": 0,
            "status": 0,
            "cancel": 0,
            "rows_out": 0,
            "rows_in": 0,
        }
        self._tcp_server = None

    # ------------------------------------------------------------------ wiring
    def _remote_pull(self, uri_str, token_raw, columns=None, predicate=None):
        if self.network is None:
            raise ResourceNotFound(f"server {self.authority} has no network for {uri_str}")
        client = self.network.client_for(parse_uri(uri_str).authority)
        # columns here come from optimizer pruning (exchange/source leaves):
        # advisory on the remote scan, never a user-input error
        return client.get(uri_str, token=token_raw, columns=columns, predicate=predicate, advisory_columns=True)

    # ------------------------------------------------------------------ auth
    def _hello(self, header: dict) -> dict:
        subject = header.get("subject", "anonymous")
        if self.credentials is not None:
            secret = header.get("credential")
            if self.credentials.get(subject) != secret:
                raise PermissionDenied(f"bad credentials for {subject!r}")
        tok = self.tokens.mint(subject)
        resp = {"token": tok.raw, "authority": self.authority, "expires": tok.claims["exp"]}
        if self.protocol_version >= 2 and int(header.get("proto", 1)) >= 2:
            resp["proto"] = min(self.protocol_version, int(header["proto"]))
            resp["max_inflight"] = MAX_INFLIGHT
        return resp

    def _authorize(self, header: dict, verb: str) -> str:
        uri = header.get("uri", "")
        resource = parse_uri(uri).path if uri else "*"
        claims = self.tokens.verify(header.get("token", ""), resource=resource, verb=verb)
        # dataset-level policy inheritance
        if uri:
            u = parse_uri(uri)
            if u.segments and u.segments[0] not in (".flow",):
                try:
                    ds = self.catalog.get(u.segments[0])
                except ResourceNotFound:
                    ds = None
                if ds is not None:
                    ds.policy.check(claims.get("sub", ""))
        return claims.get("sub", "")

    # ------------------------------------------------------------------ dispatch
    def handle_channel(self, channel) -> None:
        """Serve one connection until EOF/close.

        The loop is a demux: REQUEST frames with a ``rid`` spawn a worker
        whose responses are rid-tagged (multiplexed session); non-REQUEST
        frames with a ``rid`` are routed to the in-flight worker that owns it
        (PUT upload streams); untagged REQUESTs run inline, one at a time —
        the v1 wire discipline.
        """
        send_lock = threading.Lock()
        inflight: dict = {}  # rid -> TaggedChannel of the worker serving it
        try:
            while True:
                try:
                    ftype, header, body = channel.recv()
                except DacpError:
                    return  # peer closed
                rid = header.get("rid") if isinstance(header, dict) else None
                if ftype != framing.REQUEST:
                    tc = inflight.get(rid)
                    if tc is not None:
                        tc.push((ftype, header, body))
                    else:
                        with send_lock:
                            send_error(channel, DacpError(f"unexpected frame type {ftype} outside a request"))
                    continue
                if rid is None or self.protocol_version < 2:
                    # v1 synchronous path (legacy peers, and v1-only servers)
                    plain = TaggedChannel(channel, None, send_lock)
                    try:
                        done = self._dispatch(plain, header, body)
                    except DacpError as e:
                        send_error(plain, e)
                        done = False
                    except Exception as e:  # defensive: never kill the connection loop
                        send_error(plain, DacpError(f"internal: {type(e).__name__}: {e}"))
                        done = False
                    if done:
                        return
                    continue
                verb = header.get("verb", "").upper()
                if verb == "BYE":
                    with send_lock:
                        channel.send(framing.OK, {"rid": rid})
                    return
                if len(inflight) >= MAX_INFLIGHT:
                    # the budget advertised at HELLO is a hard per-session cap
                    err = DacpError(f"too many in-flight requests (max {MAX_INFLIGHT})").to_wire()
                    err["rid"] = rid
                    with send_lock:
                        channel.send(framing.ERROR, err)
                    continue
                tc = TaggedChannel(channel, rid, send_lock)
                inflight[rid] = tc
                threading.Thread(
                    target=self._serve_request,
                    args=(tc, header, body, inflight),
                    daemon=True,
                ).start()
        finally:
            # unblock any worker waiting on an upload stream
            err = TransportError("connection closed")
            for tc in list(inflight.values()):
                tc.push(err)

    def _serve_request(self, tc: TaggedChannel, header: dict, body, inflight: dict) -> None:
        """One multiplexed request, served on its own worker thread."""
        try:
            self._dispatch(tc, header, body)
        except DacpError as e:
            send_error(tc, e)
        except Exception as e:  # defensive: surface, never wedge the session
            send_error(tc, DacpError(f"internal: {type(e).__name__}: {e}"))
        finally:
            tc.finish()  # unblock the demux loop if it's mid-push to us
            inflight.pop(tc.rid, None)

    def _dispatch(self, channel, header: dict, body) -> bool:
        verb = header.get("verb", "").upper()
        if verb not in ("COOK", "START", "FETCH"):
            return self._dispatch_verb(channel, verb, header, body)
        # the COOK path's requests: a span each while the recorder is on,
        # which it is while a torch.profiler session records
        trace.follow_profiler()
        span = trace.ON and trace.begin("request")
        try:
            return self._dispatch_verb(channel, verb, header, body, span)
        finally:
            if span:
                trace.finish(span)

    def _dispatch_verb(self, channel, verb: str, header: dict, body, span=False) -> bool:
        """Serve one request; ``span``: its open ``request`` span, or False."""
        if verb == "HELLO":
            channel.send(framing.OK, self._hello(header))
            return False
        if verb == "PING":
            pong = {
                "authority": self.authority,
                "uptime": time.time() - self.started_at,
                "stats": self.stats,
                "executor": self.engine.executor_stats(),
                "flows": self.flows.stats(),
            }
            if self.mesh is not None:
                pong["mesh"] = {"peers": self.mesh.peer_states()}
            channel.send(framing.OK, pong)
            return False
        if verb == "GET":
            self._authorize(header, "GET")
            self.stats["get"] += 1
            uri = parse_uri(header["uri"])
            if uri.segments and uri.segments[0] == ".flow":
                flow_id = uri.segments[1]
                self.engine.verify_flow_token(flow_id, header.get("token"))
                sdf = self.engine.take_flow(flow_id)
            else:
                predicate = Expr.from_json(header["predicate"]) if header.get("predicate") else None
                sdf = self.engine.open_uri(
                    header["uri"],
                    columns=header.get("columns"),
                    predicate=predicate,
                    batch_rows=header.get("batch_rows"),
                    strict_columns=header.get("columns_mode") != "advisory",
                )
            # producer-queue streaming: scan/compute runs ahead of the socket
            self.stats["rows_out"] += send_sdf(channel, prefetch_sdf(sdf, self.executor.stream_depth))
            return False
        if verb == "PUT":
            self._authorize(header, "PUT")
            self.stats["put"] += 1
            uri = parse_uri(header["uri"])
            ds, path = self.catalog.resolve_uri(uri)
            if ds is None:
                raise ResourceNotFound("PUT requires a dataset path")
            channel.send(framing.OK, {"ready": True})
            sdf = recv_sdf(channel)
            rows = write_sdf_dataset(path, sdf)
            self.catalog.invalidate_stats(ds)  # next fingerprint sees the write
            self.stats["rows_in"] += rows
            channel.send(framing.OK, {"rows": rows, "path": uri.path})
            return False
        if verb == "COOK":
            # blocking verb, kept for v1/v2 peers — implemented as START +
            # inline FETCH-from-0 (ack-on-send: COOK has no resume contract).
            # Identical plans ride the fingerprint cache: concurrent COOKs
            # share one flow, and a completed cacheable flow is retained for
            # replay rather than dropped
            subject = self._authorize(header, "COOK")
            self.stats["cook"] += 1
            dag = Dag.from_bytes(bytes(body))
            fl, _shared = self._start_flow(subject, dag, header)
            if span:
                trace.adopt(span, fl.stats.request_id)
            try:
                self.stats["rows_out"] += self._serve_flow_stream(channel, fl, 0, ack_on_send=True)
            finally:
                self.flows.release_cook(fl, network=self.network)
            return False
        if verb == "START":
            # asynchronous COOK: return a flow handle immediately.  The
            # response's ``shared`` flag tells the client its plan matched a
            # live/retained flow (the executor will not run again for it)
            subject = self._authorize(header, "COOK")
            self.stats["start"] += 1
            dag = Dag.from_bytes(bytes(body))
            fl, shared = self._start_flow(subject, dag, header)
            if span:
                trace.adopt(span, fl.stats.request_id)
            channel.send(framing.OK, {"flow_id": fl.flow_id, "state": fl.state, "shared": shared})
            return False
        if verb == "FETCH":
            self.stats["fetch"] += 1
            fl = self._flow_for(header, verb="FETCH")
            if span:
                trace.adopt(span, fl.stats.request_id)
            if fl.kind == "submit":
                self.flows.activate(fl)  # lazy loading: first FETCH runs the fragment
            from_seq = int(header.get("from_seq", 0))
            # the client-supplied consumer id keys this FETCH's independent
            # cursor on the (possibly shared) flow buffer; consumers that
            # don't send one get an ephemeral cursor for this stream only
            cid = header.get("consumer")
            # a v2 rid carries in-band acks; the v1 inline path cannot, so it
            # degrades to ack-on-send (no mid-stream resume on legacy wires)
            ack_on_send = getattr(channel, "rid", None) is None
            self.stats["rows_out"] += self._serve_flow_stream(
                channel, fl, from_seq, ack_on_send=ack_on_send, cid=cid
            )
            return False
        if verb == "STATUS":
            self.stats["status"] += 1
            fl = self._flow_for(header, verb="STATUS")
            channel.send(framing.OK, self.flows.status(fl))
            return False
        if verb == "CANCEL":
            self.stats["cancel"] += 1
            fl = self._flow_for(header, verb="CANCEL")
            deadline = float(header.get("deadline", 5.0))
            channel.send(framing.OK, self.flows.cancel(fl.flow_id, deadline_s=deadline, network=self.network))
            return False
        if verb == "SUBMIT":
            # internal cross-domain fragment registration (scheduler-called)
            claims = self.tokens.verify(header.get("token", ""), resource="*", verb="COOK")
            self.stats["submit"] += 1
            frag = Dag.from_bytes(bytes(body))
            flow_id = header["flow_id"]
            exchange_tokens = header.get("exchange_tokens", {})
            for n in frag.nodes.values():
                if n.op == "exchange" and n.params.get("producer") in exchange_tokens:
                    n.params["token"] = exchange_tokens[n.params["producer"]]
            pull_token = self.engine.publish_flow(
                flow_id,
                lambda stats=None, cancel=None, frag=frag: self.engine.execute_dag(
                    frag.copy(), stats=stats, cancel=cancel
                ),
                owner=claims.get("sub", ""),
            )
            channel.send(framing.OK, {"flow_id": flow_id, "token": pull_token})
            return False
        if verb == "LIST":
            # discovery: catalog enumeration with paging — no data files
            # opened.  With a mesh configured the default scope is the whole
            # federation (scope="local" answers from this catalog only — the
            # scatter recursion guard and the explicit opt-out)
            self._authorize(header, "GET")
            self.stats["list"] += 1
            scope = header.get("scope") or ("mesh" if self.mesh is not None else "local")
            if scope == "mesh" and self.mesh is not None:
                page = self.mesh.federated_list(
                    prefix=header.get("prefix"),
                    offset=int(header.get("offset", 0)),
                    limit=header.get("limit"),
                )
                channel.send(framing.OK, page)
                return False
            page = self.catalog.list_entries(
                prefix=header.get("prefix"),
                offset=int(header.get("offset", 0)),
                limit=header.get("limit"),
            )
            channel.send(framing.OK, {"authority": self.authority, **page})
            return False
        if verb == "DESCRIBE":
            # discovery: schema + stats + policy from catalog metadata only.
            # A URI owned by a mesh peer is forwarded there (TTL-cached) —
            # mesh-transparent DESCRIBE — unless the client pinned
            # scope="local"
            subject = self._authorize(header, "GET")
            self.stats["describe"] += 1
            uri = parse_uri(header["uri"])
            if (
                self.mesh is not None
                and header.get("scope") != "local"
                and uri.authority
                and uri.authority not in self.aliases
                and uri.authority in self.mesh.peers
            ):
                channel.send(framing.OK, self.mesh.federated_describe(header["uri"], uri.authority))
                return False
            channel.send(framing.OK, self.engine.describe_uri(header["uri"], subject=subject))
            return False
        if verb == "BYE":
            channel.send(framing.OK, {})
            return True
        raise DacpError(f"unknown verb {verb!r}")

    # ------------------------------------------------------------------ COOK / flows
    def cook(self, dag: Dag):
        """Optimize → plan → schedule cross-domain fragments → root stream."""
        sdf, _sched = self.plan_and_schedule(dag)
        return sdf

    def plan_and_schedule(self, dag: Dag, stats=None, cancel=None, attach=None):
        """``cook`` plus the scheduler that ran it — the flow path keeps the
        scheduler for STATUS (per-subtask state) and CANCEL propagation.
        ``attach(sched)`` fires before registration starts so a concurrent
        CANCEL can reach children submitted while the plan is still being
        laid out."""
        from repro_torch.server.scheduler import CrossDomainScheduler

        sp = trace.ON and trace.begin("plan", stats.request_id if stats is not None else None, leaf=True)
        try:
            dag = optimize(dag)
            placement = self.mesh.choose_domain if self.mesh is not None else None
            the_plan = plan_dag(dag, client_domain=self.authority, placement=placement)
            k = env_int("DACP_PARTITION_PARALLEL")
            if k >= 2 and self.network is not None:
                # partition-parallel SUBMIT: split eligible columnar scans into
                # K child flows over disjoint part ranges (byte-identical merge
                # through the ordered partition union — see planner.partition_plan)
                the_plan = partition_plan(the_plan, self._part_count, k)
            sched = CrossDomainScheduler(coordinator=self, network=self.network, cancel=cancel)
            if attach is not None:
                attach(sched)
            return sched.run(the_plan, stats=stats), sched
        finally:
            if sp:
                trace.finish(sp)

    def _part_count(self, uri_str: str) -> int | None:
        """Split-unit count of a part-splittable source (columnar dataset
        parts, Parquet row groups, JSONL index blocks, SQLite rowid windows)
        for partition-parallel eligibility: local sources via the format
        adapter, peer datasets via the mesh's cached federated DESCRIBE;
        None = ineligible."""
        try:
            uri = parse_uri(uri_str)
        except Exception:  # noqa: BLE001 - the plan will surface the bad uri itself
            return None
        if not uri.segments or uri.segments[0] == ".flow":
            return None
        if uri.authority in self.aliases:
            try:
                _ds, path = self.catalog.resolve_uri(uri)
            except ResourceNotFound:
                return None
            return source_part_count(path) if path else None
        if self.mesh is not None and uri.authority in self.mesh.peers:
            try:
                d = self.mesh.federated_describe(uri_str, uri.authority)
            except (DacpError, OSError):
                return None
            parts = (d.get("stats") or {}).get("parts")
            return int(parts) if parts is not None else None
        return None

    def _flow_runner(self, dag: Dag):
        """Producer entry point for a cook flow (START / blocking COOK)."""

        def runner(stats, cancel, attach=None):
            return self.plan_and_schedule(dag, stats=stats, cancel=cancel, attach=attach)

        return runner

    def _start_flow(self, subject: str, dag: Dag, header: dict):
        """START/COOK entry: fingerprint the plan and start (or attach to)
        its flow under admission control -> (flow, shared)."""
        priority = int(header.get("priority", 0) or 0)
        fp = None
        if self.flows.plan_cache.enabled:
            fp, cacheable = plan_fingerprint(dag, self.engine.source_version)
            if not cacheable:
                fp = None
        fl, shared = self.flows.start_cached(subject, self._flow_runner(dag), fp, priority=priority)
        return fl, shared

    def _flow_for(self, header: dict, verb: str):
        """Resolve + authorize a flow verb's target.

        Submit-kind flows accept their single-purpose scoped pull token (the
        scheduler/coordinator holds it); otherwise the session token must
        carry COOK rights and its subject must own the flow — or be one of
        the subjects a shared (plan-cache) flow was attached for."""
        flow_id = header.get("flow_id") or ""
        fl = self.flows.get(flow_id)
        token = header.get("token")
        if fl.kind == "submit" and token:
            try:
                self.engine.verify_flow_token(flow_id, token)
                return fl
            except TokenError:
                pass  # fall through to owner-session auth
        claims = self.tokens.verify(token or "", resource="*", verb="COOK")
        sub = claims.get("sub", "")
        if fl.owner and sub != fl.owner and sub not in fl.shared_with:
            raise PermissionDenied(f"flow {flow_id} is owned by another subject")
        return fl

    def _serve_flow_stream(self, channel, fl, from_seq: int, ack_on_send: bool, cid: str | None = None) -> int:
        """Stream a flow's buffered frames from ``from_seq``: SCHEMA, then
        seq-tagged BATCH frames, then END/ERROR.  ``ack_on_send`` releases
        each frame as soon as it is written (blocking COOK / legacy FETCH);
        otherwise frames are retained until the client acks in-band, which
        is what makes a re-FETCH after a dropped channel byte-identical.

        ``cid`` is the consumer's cursor key on the flow's ack table; a
        client-supplied id persists across reconnects (its cursor survives
        for the resume), an ephemeral one is unregistered when this stream
        ends so it never pins the trim watermark."""
        mgr = self.flows
        ephemeral = cid is None
        if ephemeral:
            cid = f"_srv-{id(channel):x}-{from_seq}"
        with fl.cond:
            fl.consumers += 1  # idle-reap exemption while this loop serves
        finished = False
        try:
            rows, finished = self._serve_flow_frames(channel, fl, from_seq, ack_on_send, cid)
            return rows
        finally:
            with fl.cond:
                fl.consumers -= 1
            if ephemeral or finished:
                # a finished (END/ERROR-delivered) cursor is done for good;
                # a named cursor that died mid-stream stays registered so
                # the buffer keeps its unacked frames for the re-FETCH
                mgr.unregister_consumer(fl, cid)

    def _serve_flow_frames(self, channel, fl, from_seq: int, ack_on_send: bool, cid: str):
        mgr = self.flows
        mgr.ack(fl, from_seq, cid)  # registers the cursor at its start seq
        schema_json = mgr.wait_ready(fl)
        sp = trace.ON and trace.begin("send", leaf=True)
        channel.send(framing.SCHEMA, {"schema": schema_json, "flow_id": fl.flow_id, "from_seq": from_seq})
        if sp:
            trace.finish(sp)
        cursor = from_seq
        rows = 0
        while True:
            if not ack_on_send and not self._drain_acks(channel, fl, cid):
                return rows, False  # consumer channel died; the flow stays resumable
            item = mgr.next_frame(fl, cursor, timeout=0.1)
            if item is None:
                continue
            kind = item[0]
            try:
                if kind == "batch":
                    _k, hdr, parts, nrows = item
                    sp = trace.ON and trace.begin("send", leaf=True)
                    channel.send(framing.BATCH, hdr, parts)
                    if sp:
                        trace.finish(sp)
                    cursor += 1
                    rows += nrows
                    if ack_on_send:
                        mgr.ack(fl, cursor, cid)
                elif kind == "end":
                    sp = trace.ON and trace.begin("send", leaf=True)
                    channel.send(framing.END, {"rows": item[1], "next_seq": cursor})
                    if sp:
                        trace.finish(sp)
                    mgr.mark_delivered(fl)
                    return rows, True
                else:  # terminal error (FAILED / CANCELLED / released seq)
                    send_error(channel, DacpError.from_wire(item[1]))
                    return rows, True
            except (DacpError, OSError):
                # the consumer's socket died mid-write: stop serving quietly;
                # unacked frames stay buffered for the re-FETCH
                return rows, False

    def _drain_acks(self, channel, fl, cid: str) -> bool:
        """Apply in-band acks queued on a v2 FETCH's rid; False when the
        consumer's channel died (stop serving, keep the flow resumable)."""
        inbox = getattr(channel, "inbox", None)
        if inbox is None:
            return True
        while True:
            try:
                item = inbox.get_nowait()
            except queue.Empty:
                return True
            if isinstance(item, Exception):
                return False
            ftype, hdr, _body = item
            if ftype == framing.OK and isinstance(hdr, dict) and "ack" in hdr:
                self.flows.ack(fl, int(hdr["ack"]), cid)

    # ------------------------------------------------------------------ TCP
    def serve_tcp(self, host: str = "127.0.0.1", port: int = 0):
        import socket

        from repro_torch.transport.channel import SocketChannel

        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(64)
        self._tcp_server = srv
        actual_port = srv.getsockname()[1]
        self.aliases.add(f"{host}:{actual_port}")
        if host in ("127.0.0.1", "0.0.0.0"):
            self.aliases.add(f"localhost:{actual_port}")
            self.aliases.add(f"127.0.0.1:{actual_port}")

        def loop():
            while True:
                try:
                    conn, _ = srv.accept()
                except OSError:
                    return
                t = threading.Thread(target=self.handle_channel, args=(SocketChannel(conn),), daemon=True)
                t.start()

        threading.Thread(target=loop, daemon=True).start()
        if self.mesh is not None:
            self.mesh.start()  # standalone deployment: heartbeat from boot
        return actual_port

    def shutdown(self) -> None:
        import socket

        if self.mesh is not None:
            self.mesh.stop()
        if self._tcp_server is not None:
            # close() alone does not wake a thread already blocked in
            # accept(): the syscall pins the kernel socket, so the listener
            # keeps accepting one more connection after "shutdown".
            # shutdown(SHUT_RDWR) aborts the blocked accept immediately.
            try:
                self._tcp_server.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._tcp_server.close()
            except OSError:
                pass
