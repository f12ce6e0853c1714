"""Cross-domain scheduler (paper §III-D).

Takes a ``Plan`` (sub-tasks in dependency order) and coordinates execution:

  * **registration** — each remote fragment is SUBMITted to its domain; the
    domain publishes it as a lazily-evaluated flow and returns a short-lived
    pull token.  No data moves at this point (lazy loading).  Registration
    proceeds in **dependency waves**: fragments whose upstream tokens are
    already known submit concurrently — over the v2 multiplexed sessions the
    SUBMITs to N domains (or N fragments to one domain) interleave on the
    live channels instead of serializing.
  * **token-gated pulls** — downstream fragments receive the upstream flow
    tokens; when the outermost consumer pulls, activation cascades upstream
    (reverse supply).
  * **fault handling / transaction control** — submits retry with backoff and
    fail over to dataset replicas.  The *delivered* root stream rides the
    flow lifecycle: the coordinator FETCHes the remote root flow through a
    client-side ``Flow`` handle whose cursor-based seq resume replays a
    dropped channel byte-identically (no rows re-skipped, no re-execution).
    Only when the producing server itself is lost does the scheduler fall
    back to re-registering the fragment chain and skipping already-delivered
    rows (deterministic fragments ⇒ exactly-once delivery either way).
  * **cancellation** — the scheduler records every registration; a flow
    CANCEL walks ``children()`` and propagates to each child SUBMIT flow at
    its domain, and the ``cancel`` event stops retry/backoff loops.
  * **overlap** — exchange pulls are prefetched on background threads (the
    morsel executor starts every exchange leaf's prefetcher when a stage
    activates, and the delivered root stream is pulled ``prefetch_batches``
    ahead of the consumer), so network transfer overlaps local compute.
  * **monitoring** — per-subtask attempt/state log (``snapshot()`` feeds the
    STATUS verb) + server heartbeats.
"""

from __future__ import annotations

import threading
import time

from repro_torch.core.errors import DacpError, FlowCancelled, SubTaskFailed
from repro_torch.core.executor import prefetch_sdf
from repro_torch.core.planner import Plan, SubTask
from repro_torch.core.sdf import StreamingDataFrame

__all__ = ["CrossDomainScheduler", "SchedulerEvent"]


class SchedulerEvent:
    __slots__ = ("t", "kind", "subtask", "detail")

    def __init__(self, kind: str, subtask: str, detail: str = ""):
        self.t = time.time()
        self.kind = kind
        self.subtask = subtask
        self.detail = detail

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"[{self.kind}] {self.subtask} {self.detail}"


class CrossDomainScheduler:
    def __init__(
        self,
        coordinator,
        network,
        max_attempts: int = 3,
        backoff_s: float = 0.05,
        straggler_after_s: float = 30.0,
        cancel: threading.Event | None = None,
    ):
        self.coordinator = coordinator
        self.network = network
        self.max_attempts = max_attempts
        self.backoff_s = backoff_s
        self.straggler_after_s = straggler_after_s
        # flow-lifecycle cancellation: set by the owning flow's CANCEL; stops
        # retry loops and is checked between delivered batches
        self.cancel = cancel
        self.events: list = []
        # subtask id -> {"domain", "flow_id", "token", "state", "attempts"}
        self.subtasks: dict = {}
        self._lock = threading.Lock()

    def _log(self, kind: str, subtask: str, detail: str = "") -> None:
        with self._lock:
            self.events.append(SchedulerEvent(kind, subtask, detail))

    def _note(self, sid: str, **fields) -> None:
        with self._lock:
            self.subtasks.setdefault(sid, {"attempts": 0}).update(fields)

    def _cancelled(self) -> bool:
        return self.cancel is not None and self.cancel.is_set()

    def _is_local(self, domain: str) -> bool:
        return domain == self.coordinator.authority or domain in getattr(self.coordinator, "aliases", ())

    # ------------------------------------------------------------------ observability
    def snapshot(self) -> dict:
        """Per-subtask scheduler state for the STATUS verb."""
        with self._lock:
            return {
                "subtasks": {sid: dict(rec) for sid, rec in self.subtasks.items()},
                "events": [repr(e) for e in self.events[-32:]],
            }

    def children(self) -> list:
        """Every live child registration as ``(authority, flow_id, token)``
        — the CANCEL propagation fan-out."""
        with self._lock:
            return [
                (rec["domain"], rec["flow_id"], rec.get("token"))
                for rec in self.subtasks.values()
                if rec.get("flow_id") is not None
            ]

    # ------------------------------------------------------------------ submit
    def _candidate_domains(self, st: SubTask) -> list:
        if self._is_local(st.domain):
            return [st.domain]
        doms = [st.domain]
        if self.network is not None:
            doms += self.network.replicas_of(st.domain)
        return doms

    def _submit_one(self, st: SubTask, flow_tokens: dict, attempt_tag: str = "") -> tuple:
        """Register a fragment at its domain (or replica).  Returns
        (authority, flow_id, pull_token)."""
        ex_tokens = {}
        for n in st.dag.nodes.values():
            if n.op == "exchange":
                prod = n.params.get("producer")
                if prod in flow_tokens:
                    ex_tokens[prod] = flow_tokens[prod][2]  # raw token
                    n.params["uri"] = flow_tokens[prod][3]  # re-point at winner
        last_err: Exception | None = None
        for authority in self._candidate_domains(st):
            flow_id = f"{st.id}{attempt_tag}"
            frag = st.dag.copy()
            if authority != st.domain:
                # replica serves a mirror: re-point in-domain sources at it
                for n in frag.nodes.values():
                    if n.op == "source" and n.params.get("uri", "").startswith(f"dacp://{st.domain}/"):
                        n.params["uri"] = n.params["uri"].replace(f"dacp://{st.domain}/", f"dacp://{authority}/", 1)
            for attempt in range(self.max_attempts):
                if self._cancelled():
                    raise FlowCancelled(f"plan cancelled while registering {st.id}")
                try:
                    client = self.network.client_for(authority)
                    tok = client.submit(frag, flow_id, ex_tokens)
                    self._log("submit", st.id, f"@{authority} attempt={attempt}{attempt_tag}")
                    self._note(st.id, domain=authority, flow_id=flow_id, token=tok, state="registered")
                    uri = f"dacp://{authority}/.flow/{flow_id}"
                    return authority, flow_id, tok, uri
                except (DacpError, OSError) as e:
                    # raw sockets surface dead servers as OSError
                    # (ConnectionRefusedError/BrokenPipeError), not DacpError
                    last_err = e
                    self._log("submit_fail", st.id, f"@{authority}: {e}")
                    self._note(st.id, state="retrying")
                    with self._lock:
                        self.subtasks[st.id]["attempts"] = self.subtasks[st.id].get("attempts", 0) + 1
                    time.sleep(self.backoff_s * (2**attempt))
        self._note(st.id, state="failed")
        raise SubTaskFailed(f"subtask {st.id} could not be registered anywhere: {last_err}")

    # ------------------------------------------------------------------ run
    def run(self, plan: Plan, stats=None) -> StreamingDataFrame:
        flow_tokens: dict = {}  # subtask id -> (authority, flow_id, token, uri)
        local_root = self._is_local(plan.root.domain)

        remote_subtasks = [st for st in plan.subtasks if not (st.id == plan.root_id and local_root)]
        pending = list(remote_subtasks)
        while pending:
            # dependency wave: everything whose upstream tokens are known
            wave = [st for st in pending if all(d in flow_tokens for d in st.depends_on)]
            if not wave:  # defensive: never wedge on a malformed plan
                wave = pending[:1]
            pending = [st for st in pending if st not in wave]
            results: dict = {}
            errors: dict = {}

            def register(st: SubTask) -> None:
                try:
                    results[st.id] = self._submit_one(st, flow_tokens)
                except Exception as e:  # noqa: BLE001 - re-raised below
                    errors[st.id] = e

            local_wave = [st for st in wave if self._is_local(st.domain)]
            remote_wave = [st for st in wave if not self._is_local(st.domain)]
            threads = [threading.Thread(target=register, args=(st,), daemon=True) for st in remote_wave[1:]]
            for t in threads:
                t.start()
            if remote_wave:
                register(remote_wave[0])  # reuse the caller's thread for one
            for t in threads:
                t.join()
            for st in local_wave:
                # coordinator-local fragment published on the local engine
                ex = {
                    n.params.get("producer"): flow_tokens[n.params.get("producer")]
                    for n in st.dag.nodes.values()
                    if n.op == "exchange" and n.params.get("producer") in flow_tokens
                }
                frag = st.dag.copy()
                for n in frag.nodes.values():
                    if n.op == "exchange" and n.params.get("producer") in ex:
                        n.params["token"] = ex[n.params["producer"]][2]
                        n.params["uri"] = ex[n.params["producer"]][3]
                engine = self.coordinator.engine
                tok = engine.publish_flow(
                    st.id,
                    lambda stats=None, cancel=None, frag=frag: engine.execute_dag(
                        frag.copy(), stats=stats, cancel=cancel
                    ),
                )
                results[st.id] = (
                    self.coordinator.authority,
                    st.id,
                    tok,
                    f"dacp://{self.coordinator.authority}/.flow/{st.id}",
                )
                self._note(st.id, domain=self.coordinator.authority, flow_id=st.id, token=tok, state="local")
                self._log("publish_local", st.id)
            for e in errors.values():
                raise e
            flow_tokens.update(results)

        if local_root:
            root = plan.root
            frag = root.dag.copy()
            for n in frag.nodes.values():
                if n.op == "exchange" and n.params.get("producer") in flow_tokens:
                    rec = flow_tokens[n.params["producer"]]
                    n.params["token"] = rec[2]
                    n.params["uri"] = rec[3]
            self._log("execute_root", root.id, f"@{self.coordinator.authority}")
            self._note(root.id, domain=self.coordinator.authority, flow_id=None, state="executing")
            return self.coordinator.engine.execute_dag(frag, stats=stats, cancel=self.cancel)

        # remote root: FETCH its flow with seq-resume + re-register fallback
        return self._resumable_pull(plan, flow_tokens)

    # ------------------------------------------------------------------ pulls
    def _open_root_flow(self, plan: Plan, flow_tokens: dict):
        """Client-side ``Flow`` handle on the remote root's registered flow.
        Its FETCH stream resumes from the last acked seq across channel
        drops — the transport-level half of exactly-once delivery."""
        authority, flow_id, tok, _uri = flow_tokens[plan.root_id]
        client = self.network.client_for(authority)
        return client.flow(flow_id, token=tok)

    def _resumable_pull(self, plan: Plan, flow_tokens: dict) -> StreamingDataFrame:
        root = plan.root
        state = {"tokens": dict(flow_tokens), "delivered": 0}
        first = self._open_root_flow(plan, state["tokens"]).stream()
        schema = first.schema
        sched = self

        def reregister():
            # the producing server (and its flow buffers) are gone: re-register
            # the whole remote chain on replicas and skip rows already
            # delivered — the coarse fallback under seq-based resume
            tag = f"_r{int(time.time()*1000) % 1000000}"
            new_tokens: dict = {}
            for st in plan.subtasks:
                new_tokens[st.id] = sched._submit_one(st, new_tokens, attempt_tag=tag)
            state["tokens"] = new_tokens
            sched._log("reopen", root.id, f"skip={state['delivered']}")
            return sched._open_root_flow(plan, new_tokens).stream()

        def gen():
            stream = prefetch_sdf(first, depth=4)
            attempts = 0
            while True:
                try:
                    # rows delivered BEFORE this (re)opened stream must be
                    # skipped; snapshot the count — comparing against the
                    # live counter would eat fresh batches on the first pass
                    to_skip = state["delivered"]
                    skipped = 0
                    for batch in stream.iter_batches():
                        if skipped < to_skip:
                            take = min(batch.num_rows, to_skip - skipped)
                            skipped += take
                            if take == batch.num_rows:
                                continue
                            batch = batch.slice(take, batch.num_rows)
                        state["delivered"] += batch.num_rows
                        yield batch
                    return
                except FlowCancelled:
                    raise  # cancellation is terminal, never retried
                except (DacpError, OSError) as e:
                    # OSError: a dead server over raw TCP — the Flow handle
                    # re-raises it after its own reconnect budget, and the
                    # replica-failover re-registration below must still run
                    if sched._cancelled():
                        raise FlowCancelled(f"plan cancelled during root pull: {e}") from e
                    attempts += 1
                    sched._log("pull_fail", root.id, f"{e} (attempt {attempts})")
                    if attempts >= sched.max_attempts:
                        raise SubTaskFailed(f"root pull failed after {attempts} attempts: {e}") from e
                    time.sleep(sched.backoff_s * (2**attempts))
                    stream = prefetch_sdf(reregister(), depth=4)

        return StreamingDataFrame.one_shot(schema, gen())

    # ------------------------------------------------------------------ monitor
    def heartbeat(self, authorities: list, timeout: float = 2.0) -> dict:
        out = {}
        for a in authorities:
            try:
                info = self.network.ping(a, timeout=timeout)
                out[a] = {"alive": True, "uptime": info.get("uptime", 0.0)}
            except (DacpError, OSError) as e:
                out[a] = {"alive": False, "error": str(e)}
        return out
