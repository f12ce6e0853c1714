"""Admission control + weighted-fair dispatch for flows (multi-tenant
serving, ROADMAP "production-scale serving" item).

PR 5's FlowManager launched every START on its own producer thread at once —
one greedy tenant could pin every executor worker and buffer arbitrarily
many result bytes.  The AdmissionController sits in front of producer
spawning:

  * **Quotas.**  Per-principal concurrency (``DACP_FLOW_QUOTA_CONCURRENCY``
    running producers each) and buffered-byte budget
    (``DACP_FLOW_QUOTA_BYTES`` of unacked result bytes across a tenant's
    flows), plus a shared producer-slot total (``DACP_FLOW_QUOTA_SLOTS``).
    ``0`` means unlimited — the default, so single-tenant deployments see
    no behavior change.
  * **Weighted-fair dispatch.**  Queued flows dispatch by stride
    scheduling: each tenant has a virtual time advanced by ``1/weight`` per
    dispatch (``DACP_FLOW_QUOTA_WEIGHTS="alice=4,bob=1"``), so over time
    tenants get slots proportional to weight regardless of arrival order.
    Within a tenant, flows dispatch by the ``priority`` carried in START
    (higher first), FIFO among equals.
  * **Back-off signals.**  STATUS on a queued flow reports its exact
    ``queue_position`` (simulated dispatch order) and an ``eta_s`` from the
    EWMA of recent producer runtimes; PING exposes wait-time and dispatch
    counters for load shedding.

Lock ordering: the controller lock is taken *without* any flow's ``cond``
held; ``spawn`` callbacks (which briefly take a flow's ``cond``) run after
the controller lock is released.  Per-tenant byte accounting is a separate
leaf lock so the producer can report from under its flow ``cond``."""

from __future__ import annotations

import heapq
import itertools
import threading
import time

from repro_torch.core.env import env_bytes, env_int, env_weights, parse_weights

__all__ = ["AdmissionController", "parse_weights"]

_EWMA_ALPHA = 0.2


class AdmissionController:
    """Grants producer slots to flows; queues the rest per tenant."""

    def __init__(
        self,
        total_slots: int | None = None,
        concurrency: int | None = None,
        bytes_quota: int | None = None,
        weights: dict | None = None,
    ):
        # 0 = unlimited for every quota knob (the default)
        self.total_slots = (
            total_slots if total_slots is not None else env_int("DACP_FLOW_QUOTA_SLOTS")
        )
        self.concurrency = (
            concurrency if concurrency is not None else env_int("DACP_FLOW_QUOTA_CONCURRENCY")
        )
        self.bytes_quota = (
            bytes_quota if bytes_quota is not None else env_bytes("DACP_FLOW_QUOTA_BYTES")
        )
        self.weights = (
            dict(weights) if weights is not None else env_weights("DACP_FLOW_QUOTA_WEIGHTS")
        )
        self._lock = threading.Lock()
        self._running: dict = {}  # tenant -> live producer count
        self._running_total = 0
        self._queues: dict = {}  # tenant -> heap of (-priority, seq, fl, spawn)
        self._vtime: dict = {}  # tenant -> stride virtual time
        self._seq = itertools.count()
        # leaf lock: producers report buffered bytes from under their flow cond
        self._acct_lock = threading.Lock()
        self._tenant_bytes: dict = {}  # tenant -> unacked buffered bytes
        # observability
        self.dispatched = 0
        self.queued_total = 0  # flows that had to wait at least once
        self.wait_count = 0
        self.wait_total_s = 0.0
        self.ewma_wait_s = 0.0
        self.ewma_runtime_s = 0.0

    def weight(self, tenant: str) -> float:
        return self.weights.get(tenant, 1.0)

    # ------------------------------------------------------------------ byte accounting
    def add_bytes(self, tenant: str, delta: int) -> None:
        """Producer/ack path: tenant's unacked buffered bytes changed.
        Leaf lock only — safe to call while holding a flow's ``cond``."""
        with self._acct_lock:
            self._tenant_bytes[tenant] = max(0, self._tenant_bytes.get(tenant, 0) + delta)

    def tenant_bytes(self, tenant: str) -> int:
        with self._acct_lock:
            return self._tenant_bytes.get(tenant, 0)

    # ------------------------------------------------------------------ admission
    def _admissible_locked(self, tenant: str) -> bool:
        if self.total_slots and self._running_total >= self.total_slots:
            return False
        if self.concurrency and self._running.get(tenant, 0) >= self.concurrency:
            return False
        if self.bytes_quota and self.tenant_bytes(tenant) >= self.bytes_quota:
            return False
        return True

    def _grant_locked(self, tenant: str) -> None:
        self._running[tenant] = self._running.get(tenant, 0) + 1
        self._running_total += 1
        self.dispatched += 1
        # stride: charge the tenant's virtual time for the slot it just got
        base = min(self._vtime.values()) if self._vtime else 0.0
        self._vtime[tenant] = max(self._vtime.get(tenant, base), base) + 1.0 / self.weight(tenant)

    def submit(self, fl, spawn) -> bool:
        """Admit ``fl`` (True: slot granted, ``spawn`` ran) or queue it
        (False: the dispatcher will run ``spawn`` when a slot frees)."""
        tenant = fl.owner
        with self._lock:
            if self._admissible_locked(tenant):
                self._grant_locked(tenant)
                fl.admitted_at = time.time()
                dispatch = True
            else:
                fl.enqueued_at = time.time()
                heapq.heappush(
                    self._queues.setdefault(tenant, []),
                    (-int(getattr(fl, "priority", 0)), next(self._seq), fl, spawn),
                )
                self.queued_total += 1
                dispatch = False
        if dispatch:
            spawn()
        return dispatch

    def release(self, fl) -> None:
        """A producer finished (or a granted flow was cancelled): free its
        slot, record its runtime, and dispatch whatever now fits."""
        tenant = fl.owner
        with self._lock:
            if self._running.get(tenant, 0) > 0:
                self._running[tenant] -= 1
                self._running_total -= 1
                if not self._running[tenant]:
                    del self._running[tenant]
            started = getattr(fl, "admitted_at", None)
            if started:
                rt = time.time() - started
                self.ewma_runtime_s = (
                    rt if self.ewma_runtime_s == 0.0 else _EWMA_ALPHA * rt + (1 - _EWMA_ALPHA) * self.ewma_runtime_s
                )
            spawns = self._dispatch_locked()
        for s in spawns:
            s()

    def kick(self) -> None:
        """Re-try dispatch after external capacity changed (acks freed a
        tenant's byte quota).  Must not be called under any flow's cond."""
        if not self._queues:
            return  # racy-but-safe fast path: acks are per-batch hot
        with self._lock:
            spawns = self._dispatch_locked()
        for s in spawns:
            s()

    def remove(self, fl) -> bool:
        """CANCEL of a still-queued flow: drop it from its tenant queue.
        True if it was queued (caller settles it without a producer)."""
        with self._lock:
            q = self._queues.get(fl.owner)
            if not q:
                return False
            for i, (_p, _s, qfl, _sp) in enumerate(q):
                if qfl is fl:
                    q.pop(i)
                    heapq.heapify(q)
                    if not q:
                        del self._queues[fl.owner]
                    return True
        return False

    def _dispatch_locked(self) -> list:
        """Pop queued flows in weighted-fair order while slots fit; returns
        their spawn callbacks for the caller to run outside the lock."""
        spawns = []
        while True:
            ready = [t for t, q in self._queues.items() if q and self._admissible_locked(t)]
            if not ready:
                return spawns
            # stride scheduling: lowest virtual time goes first
            base = min(self._vtime.values()) if self._vtime else 0.0
            tenant = min(ready, key=lambda t: (self._vtime.get(t, base), t))
            _p, _s, fl, spawn = heapq.heappop(self._queues[tenant])
            if not self._queues[tenant]:
                del self._queues[tenant]
            self._grant_locked(tenant)
            now = time.time()
            fl.admitted_at = now
            waited = now - (fl.enqueued_at or now)
            self.wait_count += 1
            self.wait_total_s += waited
            self.ewma_wait_s = (
                waited if self.ewma_wait_s == 0.0 else _EWMA_ALPHA * waited + (1 - _EWMA_ALPHA) * self.ewma_wait_s
            )
            spawns.append(spawn)

    # ------------------------------------------------------------------ back-off surface
    def queue_info(self, fl) -> dict | None:
        """Queue position (0 = next to dispatch) + ETA for a queued flow;
        None when the flow isn't queued.  The position is the flow's rank in
        a simulated dispatch: stride order across tenants, priority order
        within — exactly what ``_dispatch_locked`` would do as slots free."""
        with self._lock:
            queues = {t: sorted(q) for t, q in self._queues.items() if q}
            if not any(any(e[2] is fl for e in q) for q in queues.values()):
                return None
            vtime = dict(self._vtime)
            base = min(vtime.values()) if vtime else 0.0
            position = 0
            while True:
                ready = [t for t, q in queues.items() if q]
                tenant = min(ready, key=lambda t: (vtime.get(t, base), t))
                entry = queues[tenant].pop(0)
                if not queues[tenant]:
                    del queues[tenant]
                vtime[tenant] = max(vtime.get(tenant, base), base) + 1.0 / self.weight(tenant)
                if entry[2] is fl:
                    break
                position += 1
            slots = self.total_slots or max(1, self._running_total or 1)
            eta = (position + 1) * self.ewma_runtime_s / max(1, slots) if self.ewma_runtime_s else None
            return {"queue_position": position, "eta_s": eta}

    def stats(self) -> dict:
        with self._lock:
            return {
                "slots": self.total_slots,
                "concurrency": self.concurrency,
                "bytes_quota": self.bytes_quota,
                "running": dict(self._running),
                "running_total": self._running_total,
                "queued": {t: len(q) for t, q in self._queues.items()},
                "queued_depth": sum(len(q) for q in self._queues.values()),
                "dispatched": self.dispatched,
                "waited": self.wait_count,
                "wait_total_s": self.wait_total_s,
                "ewma_wait_s": self.ewma_wait_s,
                "ewma_runtime_s": self.ewma_runtime_s,
            }
