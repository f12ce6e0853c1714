"""Flow lifecycle manager — asynchronous, cancellable, resumable
reverse-supply flows (paper §III-D, redesigned execution surface).

Every running COOK and SUBMIT is owned by the server's ``FlowManager`` as a
**flow**: an id, a state machine, bounded result buffering, and seq-numbered
result batches.  The lifecycle::

    PLANNED ──► RUNNING ──► DRAINING ──► DONE
       ▲           │            │
    QUEUED ────────┴────────────┴──────► CANCELLED / FAILED

  * ``PLANNED``   the flow exists; no computation has produced anything yet
                  (START just returned, or a SUBMIT fragment awaits its
                  first pull — lazy loading is preserved).
  * ``QUEUED``    admission control is holding the flow: its tenant is over
                  quota or the shared producer-slot budget is exhausted; the
                  weighted-fair dispatcher will grant it a slot (STATUS
                  reports ``queue_position``/``eta_s`` so clients back off).
  * ``RUNNING``   a producer thread is driving the plan; batches accumulate
                  in the flow's bounded buffer.
  * ``DRAINING``  the producer finished (END is buffered) but unacked
                  batches remain for a (re)connecting consumer.
  * ``DONE``      END was delivered.  ``CANCELLED``/``FAILED`` are the other
                  terminal states.

**Seq-numbered, resumable, multi-consumer.**  Each result batch gets a
monotonically increasing ``seq``; the buffered wire form (BATCH header +
zero-copy payload parts) is retained until consumed.  Any number of
consumers hold **independent cursors** on the one buffer — each FETCH
registers a consumer id whose acks advance independently; the trim
watermark is the *minimum* over registered consumers, so the buffer trims
to the slowest reader.  A reconnecting client re-FETCHes from its last
acked seq and receives byte-identical frames.

**Bounded buffering.**  The producer blocks once the flow holds more than
``DACP_FLOW_BUFFER`` *unacked* bytes (and at least one unacked batch),
propagating backpressure into the executor's reorder window instead of
buffering an unbounded result server-side.

**Admission + fair dispatch.**  Cook-flow producers no longer spawn
unconditionally: ``AdmissionController`` (``repro_torch.server.admission``)
grants producer slots under per-tenant quotas and dispatches queued flows
in weighted-fair order (``DACP_FLOW_QUOTA_*``).  Submit-kind fragments
bypass admission — they are children of an already-admitted parent plan,
and queueing them behind the parent's own quota would deadlock the plan.

**Plan-fingerprint cache.**  ``start_cached`` collapses identical COOK
plans onto one shared flow (``repro_torch.server.plancache``): the first START
reserves the fingerprint and runs once with ``retain_all`` buffering (acked
frames are *retained*, not dropped — they stop counting against the
unacked-byte backpressure budget but replay for later consumers); further
identical STARTs attach as extra refs/consumers.  Completed cacheable flows
are retained up to ``DACP_PLAN_CACHE_BYTES`` for instant replay and are
exempt from the retention reaper until their cache TTL lapses.  A flow
whose result outgrows the cache budget is demoted mid-run to plain bounded
buffering.

**Cancellation.**  ``cancel`` on a flow with multiple attached handles just
detaches one (ref-counted); the last handle's cancel flips the flow's
cancel event (checked by the morsel executor between morsels and by the
producer between batches), asks the cross-domain scheduler to CANCEL child
SUBMIT flows at their domains, and joins the producer within a deadline.
A still-QUEUED flow cancels instantly (dequeued, no producer to join).

**Retention.**  Terminal flows (DONE/FAILED/CANCELLED) and their buffered
batches are reaped after ``DACP_FLOW_TTL`` seconds (cache-retained flows:
after the cache TTL); a flow no consumer has touched for ``idle_ttl_s`` is
cancelled and reaped.  Reap counts are PING-visible (``flows.reaped``).

SUBMIT-published fragments live here too (kind ``submit``): they keep the
token-gated lazy ``factory`` activation used by exchange GETs, and a FETCH
on them activates the same buffered/resumable machinery.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

from repro_torch.core.batch import RecordBatch
from repro_torch.core.env import env_bytes, env_float
from repro_torch.core.errors import DacpError, FlowCancelled, ResourceNotFound
from repro_torch.core.executor import ExecutorStats
from repro_torch.server.admission import AdmissionController
from repro_torch.server.plancache import PlanCache

__all__ = ["FlowManager", "FlowRecord", "FLOW_STATES", "FLOW_TTL_S"]

FLOW_STATES = ("PLANNED", "QUEUED", "RUNNING", "DRAINING", "DONE", "CANCELLED", "FAILED")

# live TTL for published (SUBMIT) fragments awaiting activation — unchanged
# from the pre-flow engine table
FLOW_TTL_S = 600.0


class FlowRecord:
    """One flow: state machine + seq-numbered bounded result buffer."""

    __slots__ = (
        "flow_id",
        "kind",  # "cook" (START/COOK) | "submit" (published fragment)
        "owner",
        "state",
        "priority",  # START-carried dispatch priority (higher first)
        "created_at",
        "finished_at",
        "touched",
        "error",  # wire dict once FAILED
        "schema_json",
        "cancel",  # threading.Event — the executor's cancellation hook
        "cond",  # guards every mutable field below (one lock per flow)
        "buffer",  # seq -> (header dict, payload parts, nbytes, rows)
        "base_seq",  # lowest seq still in the buffer
        "ack_floor",  # min acked seq over registered consumers (watermark)
        "next_seq",  # next seq the producer will assign
        "end_rows",  # total rows, set when the producer finishes cleanly
        "rows_emitted",
        "bytes_emitted",
        "buffered_bytes",  # total bytes in buffer (retained + unacked)
        "retained_bytes",  # bytes below the watermark kept for cache replay
        "retain_all",  # cacheable: acked frames are retained, not dropped
        "fingerprint",  # plan fingerprint when this flow rides the cache
        "cache_expires_at",  # retention-reap exemption for committed entries
        "refs",  # attached START/COOK handles (shared-flow refcount)
        "shared_with",  # subjects besides the owner allowed flow verbs
        "acks",  # consumer id -> acked-upto seq (independent cursors)
        "hold_seqs",  # floor holds for attached-but-not-yet-fetching consumers
        "enqueued_at",  # admission: when the flow was queued (wait metrics)
        "admitted_at",  # admission: when the producer slot was granted
        "stats",  # per-flow ExecutorStats (morsels, spill counters)
        "scheduler",  # CrossDomainScheduler for cross-domain plans
        "producer",  # producer thread once activated
        "consumers",  # serve loops currently attached (idle-reap exemption)
        # submit-kind only:
        "factory",
        "token_raw",
        "expires_at",
        "pulls",
        "rows_out",
    )

    def __init__(self, flow_id: str, kind: str, owner: str):
        self.flow_id = flow_id
        self.kind = kind
        self.owner = owner
        self.state = "PLANNED"
        self.priority = 0
        self.created_at = time.time()
        self.finished_at = None
        self.touched = self.created_at
        self.error = None
        self.schema_json = None
        self.cancel = threading.Event()
        self.cond = threading.Condition()
        self.buffer: dict = {}
        self.base_seq = 0
        self.ack_floor = 0
        self.next_seq = 0
        self.end_rows = None
        self.rows_emitted = 0
        self.bytes_emitted = 0
        self.buffered_bytes = 0
        self.retained_bytes = 0
        self.retain_all = False
        self.fingerprint = None
        self.cache_expires_at = None
        self.refs = 1
        self.shared_with: set = set()
        self.acks: dict = {}
        self.hold_seqs: list = []
        self.enqueued_at = None
        self.admitted_at = None
        self.stats = ExecutorStats()
        self.scheduler = None
        self.producer = None
        self.consumers = 0
        self.factory = None
        self.token_raw = None
        self.expires_at = None
        self.pulls = 0
        self.rows_out = 0

    @property
    def terminal(self) -> bool:
        return self.state in ("DONE", "CANCELLED", "FAILED")

    @property
    def ended(self) -> bool:
        """Producer finished cleanly (END is buffered or delivered)."""
        return self.end_rows is not None

    @property
    def unacked_bytes(self) -> int:
        return self.buffered_bytes - self.retained_bytes


class FlowManager:
    """Server-side owner of every flow (see module docstring)."""

    def __init__(
        self,
        authority: str,
        buffer_bytes: int | None = None,
        retain_ttl_s: float | None = None,
        idle_ttl_s: float = FLOW_TTL_S,
        admission: AdmissionController | None = None,
        plan_cache: PlanCache | None = None,
    ):
        self.authority = authority
        # per-flow unacked-byte budget; the producer blocks past it
        self.buffer_bytes = (
            buffer_bytes if buffer_bytes is not None else env_bytes("DACP_FLOW_BUFFER")
        )
        # terminal flows (and their buffers) are reaped after this long
        self.retain_ttl_s = (
            retain_ttl_s if retain_ttl_s is not None else env_float("DACP_FLOW_TTL")
        )
        self.idle_ttl_s = idle_ttl_s
        self.admission = admission if admission is not None else AdmissionController()
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache()
        self.reaped = 0  # PING-visible: flows reclaimed by the retention TTL
        self._flows: dict = {}
        self._lock = threading.Lock()
        self._ids = itertools.count(1)

    # ------------------------------------------------------------------ registry
    def _new_id(self) -> str:
        return f"F{next(self._ids)}-{os.urandom(4).hex()}"

    def get(self, flow_id: str) -> FlowRecord:
        with self._lock:
            self._reap_locked()
            fl = self._flows.get(flow_id)
        if fl is None:
            raise ResourceNotFound(f"no flow {flow_id!r}")
        fl.touched = time.time()
        return fl

    def drop(self, flow_id: str) -> None:
        with self._lock:
            fl = self._flows.pop(flow_id, None)
        if fl is not None:
            self._forget(fl)

    def _forget(self, fl: FlowRecord) -> None:
        """Accounting teardown for a flow leaving the table: release its
        unacked bytes from the tenant quota and its cache entry (if any)."""
        with fl.cond:
            released = fl.unacked_bytes
            fl.buffer.clear()
            fl.buffered_bytes = 0
            fl.retained_bytes = 0
            fl.cond.notify_all()
        if released:
            self.admission.add_bytes(fl.owner, -released)
        if fl.fingerprint:
            self.plan_cache.invalidate(fl.fingerprint, fl.flow_id)

    def flow_ids(self) -> list:
        with self._lock:
            self._reap_locked()
            return sorted(self._flows)

    def _reap_locked(self) -> None:
        now = time.time()
        dead = []
        for fid, fl in self._flows.items():
            if fl.terminal and fl.finished_at is not None and now - fl.finished_at > self.retain_ttl_s:
                # cache-retained flows outlive the retention TTL: they ARE
                # the plan cache's storage, reaped when the entry expires
                if fl.retain_all and fl.cache_expires_at is not None and now < fl.cache_expires_at:
                    continue
                dead.append(fid)  # retention TTL: DONE/FAILED/CANCELLED + buffers
            elif fl.kind == "submit" and fl.producer is None and fl.expires_at is not None and fl.expires_at < now:
                dead.append(fid)  # unactivated published fragment expired
            elif not fl.terminal and fl.state != "QUEUED" and fl.consumers <= 0 and now - fl.touched > self.idle_ttl_s:
                # abandoned mid-run: nothing attached and untouched — a live
                # consumer blocked waiting for a slow plan's first batch has
                # its serve loop attached (consumers > 0) and is never reaped
                dead.append(fid)
        for fid in dead:
            fl = self._flows.pop(fid)
            if not fl.terminal:
                fl.cancel.set()
                with fl.cond:
                    fl.cond.notify_all()
            self._forget(fl)
            self.reaped += 1

    def reap(self) -> None:
        with self._lock:
            self._reap_locked()

    def records(self) -> list:
        """Read-only snapshot of every flow record, id-sorted.  Monitoring
        MUST use this rather than ``get`` in a loop: it never refreshes the
        idle clocks (a dashboard poll must not keep abandoned flows alive)
        and runs the reaper once, not per flow."""
        with self._lock:
            self._reap_locked()
            return [self._flows[fid] for fid in sorted(self._flows)]

    def stats(self) -> dict:
        """PING surface: flow counts by state, retention-reap counter, plus
        the admission dispatcher's and plan cache's serving counters."""
        with self._lock:
            self._reap_locked()
            by_state: dict = {}
            buffered = 0
            retained = 0
            for fl in self._flows.values():
                by_state[fl.state] = by_state.get(fl.state, 0) + 1
                buffered += fl.buffered_bytes
                retained += fl.retained_bytes
            return {
                "active": len(self._flows),
                "by_state": by_state,
                "buffered_bytes": buffered,
                "retained_bytes": retained,
                "reaped": self.reaped,
                "admission": self.admission.stats(),
                "plan_cache": self.plan_cache.stats(),
            }

    # ------------------------------------------------------------------ start
    def start(self, owner: str, runner, flow_id: str | None = None, priority: int = 0) -> FlowRecord:
        """Create a cook-kind flow and submit it to admission control: with
        quota headroom the producer launches immediately (the default
        unlimited quotas preserve pre-admission behavior); otherwise the
        flow parks in ``QUEUED`` until the weighted-fair dispatcher grants
        it a slot.

        ``runner(stats, cancel, attach) -> (StreamingDataFrame, scheduler |
        None)`` plans and schedules the DAG (injected by the server so the
        manager stays free of planner dependencies); ``attach(sched)`` must
        be called as soon as the scheduler exists so a CANCEL that lands
        mid-registration still reaches the already-submitted children."""
        fl = FlowRecord(flow_id or self._new_id(), "cook", owner)
        fl.priority = int(priority)
        with self._lock:
            self._reap_locked()
            self._flows[fl.flow_id] = fl
        self._submit(fl, runner)
        return fl

    def start_cached(self, owner: str, runner, fingerprint: str | None, priority: int = 0):
        """START with the plan cache: -> (flow, shared).

        A live flow already running (or retaining) the identical plan gets
        this START attached as an extra ref/consumer (``shared=True`` — the
        executor runs once for N clients); otherwise the fingerprint is
        reserved and a fresh ``retain_all`` flow starts.  ``fingerprint``
        None (uncacheable plan or disabled cache) degrades to plain
        ``start``."""
        if not fingerprint or not self.plan_cache.enabled:
            return self.start(owner, runner, priority=priority), False
        for _ in range(4):  # ghost entries (reaped flows) retry the reserve
            fresh_id = self._new_id()
            existing = self.plan_cache.lookup_or_reserve(fingerprint, fresh_id)
            if existing is None:
                fl = FlowRecord(fresh_id, "cook", owner)
                fl.priority = int(priority)
                fl.fingerprint = fingerprint
                fl.retain_all = True
                with self._lock:
                    self._reap_locked()
                    self._flows[fl.flow_id] = fl
                self._submit(fl, runner)
                return fl, False
            fl = self._attach_shared(existing, owner)
            if fl is not None:
                return fl, True
            self.plan_cache.invalidate(fingerprint, existing)
        return self.start(owner, runner, priority=priority), False

    def _attach_shared(self, flow_id: str, subject: str):
        """Attach another handle to a live/retained shared flow; None when
        the flow is gone, failed, cancelled, or demoted (can't replay)."""
        with self._lock:
            fl = self._flows.get(flow_id)
        if fl is None:
            return None
        with fl.cond:
            if fl.state in ("FAILED", "CANCELLED") or fl.cancel.is_set() or not fl.retain_all:
                return None
            fl.refs += 1
            if subject != fl.owner:
                fl.shared_with.add(subject)
            # hold the trim watermark at the replay start until this
            # consumer's first FETCH registers its cursor
            fl.hold_seqs.append(fl.base_seq)
            fl.touched = time.time()
        return fl

    def _submit(self, fl: FlowRecord, runner) -> None:
        def spawn():
            self._spawn_producer(fl, runner)

        if not self.admission.submit(fl, spawn):
            with fl.cond:
                if fl.state == "PLANNED" and fl.producer is None and not fl.terminal:
                    fl.state = "QUEUED"
                    fl.cond.notify_all()

    def publish(self, flow_id: str, factory, token_raw: str, ttl_s: float = FLOW_TTL_S, owner: str = "") -> FlowRecord:
        """Register a SUBMIT fragment as a lazily-activated flow."""
        fl = FlowRecord(flow_id, "submit", owner)
        fl.factory = factory
        fl.token_raw = token_raw
        fl.expires_at = time.time() + ttl_s
        with self._lock:
            self._reap_locked()
            self._flows[flow_id] = fl
        return fl

    def activate(self, fl: FlowRecord) -> None:
        """FETCH on a submit flow: start the buffered producer (idempotent).
        The factory's stream becomes seq-numbered and resumable.  Submit
        fragments bypass admission — a parent plan already holds (or is)
        the admitted slot; queueing its children behind the same tenant
        quota would deadlock the plan."""
        factory = fl.factory

        def runner(stats, cancel, attach):
            return factory(stats=stats, cancel=cancel), None

        self._spawn_producer(fl, runner)

    def _spawn_producer(self, fl: FlowRecord, runner) -> None:
        # claim-then-start: the producer slot is taken atomically under the
        # flow lock, so two racing first-FETCHes can never both spawn (a
        # double producer would interleave two copies of the stream into
        # one seq space)
        t = threading.Thread(target=self._produce, args=(fl, runner), daemon=True)
        started = False
        with fl.cond:
            if fl.producer is None and not fl.terminal:
                fl.producer = t
                if fl.state == "QUEUED":
                    fl.state = "PLANNED"
                started = True
        if started:
            t.start()
        elif fl.kind != "submit":
            # granted a slot but the flow died first (cancel race): free it
            self.admission.release(fl)

    # ------------------------------------------------------------------ producer
    def _produce(self, fl: FlowRecord, runner) -> None:
        try:
            self._produce_inner(fl, runner)
        finally:
            self._settle_cache(fl)
            if fl.kind != "submit":
                self.admission.release(fl)

    def _produce_inner(self, fl: FlowRecord, runner) -> None:
        def attach(sched):
            with fl.cond:
                fl.scheduler = sched

        try:
            sdf, sched = runner(fl.stats, fl.cancel, attach)
            with fl.cond:
                fl.scheduler = sched
                fl.schema_json = sdf.schema.to_json()
                if not fl.terminal:
                    fl.state = "RUNNING"
                fl.cond.notify_all()
            it = sdf.iter_batches()
            try:
                for batch in it:
                    if fl.cancel.is_set():
                        break
                    self._buffer_put(fl, batch)
                    if fl.retain_all and fl.bytes_emitted > self.plan_cache.budget_bytes:
                        # the result outgrew the cache: demote to plain
                        # bounded buffering before memory runs away
                        self.plan_cache.invalidate(fl.fingerprint, fl.flow_id)
                        self._demote(fl)
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()  # tears down executor workers / prefetchers / spill
        except FlowCancelled:
            pass  # the cancel path below settles the state
        except BaseException as e:  # noqa: BLE001 - becomes the flow's FAILED error
            err = e if isinstance(e, DacpError) else DacpError(f"flow failed: {type(e).__name__}: {e}")
            with fl.cond:
                if not fl.terminal:
                    fl.state = "FAILED"
                    fl.error = err.to_wire()
                    fl.finished_at = time.time()
                fl.cond.notify_all()
            return
        with fl.cond:
            if fl.cancel.is_set():
                if not fl.terminal:
                    fl.state = "CANCELLED"
                    fl.finished_at = time.time()
            elif not fl.terminal:
                fl.end_rows = fl.rows_emitted
                fl.state = "DRAINING" if len(fl.buffer) > (fl.ack_floor - fl.base_seq) else "DONE"
                if fl.state == "DONE":
                    fl.finished_at = time.time()
            fl.cond.notify_all()

    def _settle_cache(self, fl: FlowRecord) -> None:
        """Producer exit: commit a cleanly-finished cacheable flow to the
        plan cache (demoting LRU victims past the byte budget) or drop its
        reservation.  Runs outside any lock ordering hazard: the cache lock
        is a leaf, flow conds are taken one at a time."""
        fp = fl.fingerprint
        if not fp:
            return
        with fl.cond:
            ok = (
                fl.retain_all
                and fl.ended
                and not fl.cancel.is_set()
                and fl.state not in ("FAILED", "CANCELLED")
            )
            nbytes = fl.bytes_emitted
        if not ok:
            self.plan_cache.invalidate(fp, fl.flow_id)
            self._demote(fl)
            return
        victims = self.plan_cache.commit(fp, fl.flow_id, nbytes)
        if fl.flow_id in victims:
            self._demote(fl)  # over budget (or superseded): not retained
            victims = [v for v in victims if v != fl.flow_id]
        else:
            with fl.cond:
                fl.cache_expires_at = time.time() + self.plan_cache.ttl_s
        for vid in victims:
            with self._lock:
                victim = self._flows.get(vid)
            if victim is not None:
                self._demote(victim)

    def _demote(self, fl: FlowRecord) -> None:
        """Stop retaining acked frames: drop everything below the consumer
        watermark and fall back to plain bounded buffering + normal TTL."""
        with fl.cond:
            fl.retain_all = False
            fl.cache_expires_at = None
            while fl.base_seq < fl.ack_floor:
                entry = fl.buffer.pop(fl.base_seq, None)
                if entry is not None:
                    fl.buffered_bytes -= entry[2]
                fl.base_seq += 1
            fl.retained_bytes = 0
            fl.cond.notify_all()

    def _buffer_put(self, fl: FlowRecord, batch: RecordBatch) -> None:
        header, bufs = batch.to_buffers()
        parts = RecordBatch.payload_parts(bufs)  # zero-copy views, pinned by the buffer
        nbytes = sum(len(p) for p in parts)
        with fl.cond:
            # bounded buffering: block while over budget with >= 1 *unacked*
            # batch retained (a single oversized batch must still pass
            # through; cache-retained frames below the watermark are acked
            # and do not count against the backpressure budget)
            while (
                not fl.cancel.is_set()
                and fl.next_seq > fl.ack_floor
                and fl.unacked_bytes + nbytes > self.buffer_bytes
            ):
                fl.cond.wait(timeout=0.1)
            if fl.cancel.is_set():
                raise FlowCancelled(f"flow {fl.flow_id} cancelled")
            header["seq"] = fl.next_seq
            fl.buffer[fl.next_seq] = (header, parts, nbytes, batch.num_rows)
            fl.next_seq += 1
            fl.rows_emitted += batch.num_rows
            fl.bytes_emitted += nbytes
            fl.buffered_bytes += nbytes
            fl.cond.notify_all()
        self.admission.add_bytes(fl.owner, nbytes)

    # ------------------------------------------------------------------ consume
    def ack(self, fl: FlowRecord, upto_seq: int, cid: str = "_") -> None:
        """Consumer ``cid``'s cursor advanced to ``upto_seq``.  The trim
        watermark is the minimum over all registered consumers (+ floor
        holds for attached-but-not-yet-reading consumers): frames below it
        are dropped — or, on cache-retained flows, moved to the retained
        set, where they stop counting against producer backpressure."""
        fl.touched = time.time()
        with fl.cond:
            if cid not in fl.acks and fl.hold_seqs:
                fl.hold_seqs.pop()  # first read converts an attach-time hold
            if upto_seq > fl.acks.get(cid, -1):
                fl.acks[cid] = upto_seq
            self._advance_floor_locked(fl)
            fl.cond.notify_all()  # producer may be blocked on the budget
        self.admission.kick()  # freed tenant bytes may admit queued flows

    def unregister_consumer(self, fl: FlowRecord, cid: str) -> None:
        """A consumer finished (END delivered) or was ephemeral: remove its
        cursor so it no longer pins the trim watermark."""
        with fl.cond:
            fl.acks.pop(cid, None)
            self._advance_floor_locked(fl)
            fl.cond.notify_all()

    def _advance_floor_locked(self, fl: FlowRecord) -> None:
        candidates = list(fl.acks.values()) + list(fl.hold_seqs)
        if not candidates:
            return
        floor = min(candidates)
        if floor <= fl.ack_floor:
            return  # the watermark never regresses
        released = 0
        for seq in range(fl.ack_floor, floor):
            entry = fl.buffer.get(seq)
            if entry is None:
                continue
            if fl.retain_all:
                fl.retained_bytes += entry[2]  # kept for replay, off-budget
            else:
                del fl.buffer[seq]
                fl.buffered_bytes -= entry[2]
            released += entry[2]
        fl.ack_floor = floor
        if not fl.retain_all:
            fl.base_seq = floor
        if released:
            self.admission.add_bytes(fl.owner, -released)

    def wait_ready(self, fl: FlowRecord, timeout: float = 60.0) -> str:
        """Block until the flow's schema is known; raise its terminal error."""
        deadline = time.time() + timeout
        with fl.cond:
            while fl.schema_json is None:
                if fl.state == "FAILED":
                    raise DacpError.from_wire(fl.error)
                if fl.state == "CANCELLED" or fl.cancel.is_set():
                    raise FlowCancelled(f"flow {fl.flow_id} cancelled")
                rem = deadline - time.time()
                if rem <= 0:
                    raise DacpError(f"flow {fl.flow_id} produced no schema within {timeout}s")
                fl.cond.wait(timeout=min(rem, 0.25))
            return fl.schema_json

    def next_frame(self, fl: FlowRecord, cursor: int, timeout: float = 0.1):
        """The frame at ``cursor``, or what terminates the stream there.

        Returns ``("batch", header, parts, rows)`` | ``("end", total_rows)``
        | ``("error", wire_dict)`` | ``None`` (nothing yet — poll again).

        Only an actual delivery refreshes the flow's idle clock — the serve
        loop's own polling must not keep an abandoned flow alive, or the
        idle reaper could never reclaim it (acks and STATUS/FETCH requests
        are the consumer-liveness signals).
        """
        with fl.cond:
            entry = fl.buffer.get(cursor)
            if entry is not None:
                fl.touched = time.time()
                return ("batch", entry[0], entry[1], entry[3])
            if cursor < fl.base_seq:
                return (
                    "error",
                    DacpError(
                        f"flow {fl.flow_id}: seq {cursor} was acked and released "
                        f"(resume must start at >= {fl.base_seq})"
                    ).to_wire(),
                )
            if fl.ended and cursor >= fl.next_seq:
                return ("end", fl.end_rows)
            if fl.state == "FAILED":
                return ("error", fl.error)
            if fl.state == "CANCELLED" or fl.cancel.is_set():
                return ("error", FlowCancelled(f"flow {fl.flow_id} cancelled").to_wire())
            fl.cond.wait(timeout=timeout)  # dacpcheck: ignore[blocking] reason=timed poll contract; caller loops and re-checks cursor/state on None
            return None

    def mark_delivered(self, fl: FlowRecord) -> None:
        """END reached a consumer: the flow is DONE (buffer retained until
        the retention/cache TTL reaps it — a late resume can still re-read)."""
        with fl.cond:
            if not fl.terminal:
                fl.state = "DONE"
                fl.finished_at = time.time()
            fl.cond.notify_all()

    # ------------------------------------------------------------------ status
    def status(self, fl: FlowRecord) -> dict:
        with fl.cond:
            retained_batches = max(0, fl.ack_floor - fl.base_seq) if fl.retain_all else 0
            d = {
                "flow_id": fl.flow_id,
                "kind": fl.kind,
                "state": fl.state,
                "owner": fl.owner,
                "priority": fl.priority,
                "next_seq": fl.next_seq,
                "acked_seq": fl.ack_floor,
                # buffered_* report the unacked working set (what counts
                # against DACP_FLOW_BUFFER); retained_* is the cache replica
                "buffered_batches": len(fl.buffer) - retained_batches,
                "buffered_bytes": fl.unacked_bytes,
                "retained_batches": retained_batches,
                "retained_bytes": fl.retained_bytes,
                "rows_emitted": fl.rows_emitted,
                "bytes_emitted": fl.bytes_emitted,
                "total_rows": fl.end_rows,
                "error": fl.error,
                "age_s": time.time() - fl.created_at,
                "refs": fl.refs,
                "shared": fl.refs > 1,
                "cached": bool(fl.retain_all and fl.fingerprint),
                "consumer_cursors": len(fl.acks),
            }
            queued = fl.state == "QUEUED"
        if queued:
            # back-off surface: exact dispatch rank + EWMA-based ETA
            d.update(self.admission.queue_info(fl) or {"queue_position": None, "eta_s": None})
        d["executor"] = fl.stats.to_dict()
        sched = fl.scheduler
        if sched is not None:
            d["subtasks"] = sched.snapshot()
        if fl.kind == "submit":
            d["pulls"] = fl.pulls
            d["rows_out"] = fl.rows_out
        return d

    # ------------------------------------------------------------------ cancel
    def cancel(self, flow_id: str, deadline_s: float = 5.0, network=None) -> dict:
        """Cancel a flow handle.

        Shared flows are ref-counted: while other handles remain attached a
        cancel just detaches (``detached: True``) and the execution is
        untouched.  The last handle's cancel always wins — even over cache
        retention (the entry is invalidated; an explicit CANCEL means "free
        these resources").  It flips the flow's cancel event, propagates to
        child SUBMIT flows
        cross-domain, and joins the producer within ``deadline_s`` so
        executor pipelines and spill files are torn down boundedly.  A
        still-QUEUED flow is dequeued and settled instantly."""
        try:
            fl = self.get(flow_id)
        except ResourceNotFound:
            return {"flow_id": flow_id, "state": "UNKNOWN", "released": True}
        with fl.cond:
            if fl.refs > 1:
                # other handles (live riders or cached-result readers) are
                # still attached: just detach, never touch the execution
                fl.refs -= 1
                return {
                    "flow_id": flow_id,
                    "state": fl.state,
                    "released": False,
                    "detached": True,
                    "refs": fl.refs,
                }
        t0 = time.time()
        already = fl.terminal
        fl.cancel.set()
        with fl.cond:
            fl.cond.notify_all()
        if self.admission.remove(fl):
            # never dispatched: no producer, no children — settle instantly
            with fl.cond:
                if not fl.terminal:
                    fl.state = "CANCELLED"
                    fl.finished_at = time.time()
                fl.cond.notify_all()
            self._release_buffers(fl)
            if fl.fingerprint:
                self.plan_cache.invalidate(fl.fingerprint, fl.flow_id)
            return {"flow_id": flow_id, "state": "CANCELLED", "released": True, "children_cancelled": 0}
        children = 0
        sched = fl.scheduler
        if not already and sched is not None:
            children = self._cancel_children(sched, network, deadline_s)
        producer = fl.producer
        if producer is not None and producer.is_alive():
            producer.join(timeout=max(0.0, deadline_s - (time.time() - t0)))
        released = producer is None or not producer.is_alive()
        with fl.cond:
            if not fl.terminal:
                fl.state = "CANCELLED"
                fl.finished_at = time.time()
            state = fl.state
            fl.cond.notify_all()
        if released:
            self._release_buffers(fl)
            if fl.fingerprint:
                self.plan_cache.invalidate(fl.fingerprint, fl.flow_id)
        return {
            "flow_id": flow_id,
            "state": state,
            "released": released,
            "children_cancelled": children,
        }

    def _release_buffers(self, fl: FlowRecord) -> None:
        with fl.cond:
            released = fl.unacked_bytes
            fl.buffer.clear()
            fl.buffered_bytes = 0
            fl.retained_bytes = 0
            fl.retain_all = False
            fl.cond.notify_all()
        if released:
            self.admission.add_bytes(fl.owner, -released)

    def _cancel_children(self, sched, network, deadline_s: float) -> int:
        """Propagate CANCEL to every child SUBMIT registration (local
        children cancel in-process, remote ones over the wire)."""
        n = 0
        for authority, child_id, token in sched.children():
            try:
                if authority == self.authority:
                    self.cancel(child_id, deadline_s=deadline_s)
                elif network is not None:
                    network.client_for(authority).cancel(child_id, token=token, deadline=deadline_s)
                n += 1
            except DacpError:
                pass  # best-effort: a dead child domain has nothing to tear down
        return n

    def release_cook(self, fl: FlowRecord, network=None) -> None:
        """Blocking COOK teardown: detach this rider's handle; the flow is
        only cancelled + dropped when it was the last handle AND the flow
        isn't a completed cache-retained entry (which future identical
        COOKs replay from)."""
        with fl.cond:
            fl.refs = max(0, fl.refs - 1)
            healthy = not fl.cancel.is_set() and fl.state not in ("FAILED", "CANCELLED")
            # keep while other handles ride the flow, or once it completed
            # as a retained cache entry; a sole rider dying mid-run tears
            # the plan down (frees workers/spill) exactly as before
            keep = healthy and (fl.refs > 0 or (fl.retain_all and fl.ended))
        if not keep:
            self.cancel(fl.flow_id, deadline_s=5.0, network=network)
            self.drop(fl.flow_id)

    # ------------------------------------------------------------------ submit-kind streaming (GET .flow)
    def take(self, fl: FlowRecord):
        """Legacy streaming activation for exchange pulls (GET .flow): a
        fresh stream per pull, with per-batch cancellation checks so a
        CANCELLed fragment unblocks its puller promptly."""
        fl.pulls += 1
        fl.touched = time.time()
        if fl.cancel.is_set() or fl.state == "CANCELLED":
            raise FlowCancelled(f"flow {fl.flow_id} cancelled")
        sdf = fl.factory()
        from repro_torch.core.sdf import StreamingDataFrame

        def gen():
            with fl.cond:
                if not fl.terminal and fl.state == "PLANNED":
                    fl.state = "RUNNING"
            for b in sdf.iter_batches():
                if fl.cancel.is_set():
                    raise FlowCancelled(f"flow {fl.flow_id} cancelled")
                fl.rows_out += b.num_rows
                yield b
            with fl.cond:
                if not fl.terminal and fl.producer is None:
                    fl.state = "DRAINING"  # delivered once; TTL may still re-pull

        return StreamingDataFrame.one_shot(sdf.schema, gen())
