"""Morsel-driven parallel pipeline driver (paper §III-D: "as fast as the
hardware allows").

``execute_parallel`` compiles an (optimized) COOK DAG into **pipelines** —
maximal chains of morsel-pure operators (filter/select/project/map)
separated by **pipeline breakers** (aggregate build, join build).  Each
pipeline's source stream is cut into *morsels* (RecordBatch slices of
``morsel_rows``) that a pool of worker threads drains concurrently; results
are reassembled **in input order** through a bounded reorder window, which
doubles as backpressure: workers stop pulling new morsels when the consumer
falls more than ``window`` morsels behind.  Output batches therefore stream
to the caller as they are produced — the first batch is yielded while later
morsels are still being scanned/computed, preserving SDF streaming
semantics, and results are byte-deterministic for a given morsel size
regardless of worker count.

Breakers:

  * ``aggregate`` — each worker folds its morsel into a private
    ``GroupState`` (vectorized factorization); the consumer merges the
    partial states in morsel order, so group order matches the reference
    single-threaded pull chain.
  * ``join`` — the build side runs as its own parallel stage to a
    materialized hash table (built once, shared read-only); probing is
    morsel-pure and stays inside the probe pipeline.
  * ``limit`` / ``rebatch`` — inherently sequential; they run as a serial
    tail over the (already parallel) upstream stage via the reference
    evaluators.

Every pipeline source is wrapped in a bounded **prefetcher** thread started
at stage activation, so scans and cross-domain exchange pulls overlap with
compute — and union branches pull their exchanges concurrently instead of
serially (the scheduler's network/compute overlap).

Compute is delegated to a pluggable backend (``repro_torch.core.backend``):
adjacent Filter→Select pairs are peephole-fused into the backend's
``filter_select`` kernel, projection arithmetic runs through the backend's
``project`` kernel, and aggregate folds hand factorized morsels to the
backend's ``segment_reduce`` kernel — the torch backend dispatches each to
the CUDA kernels in ``repro_torch.kernels`` when the morsel is eligible, on
the device that ``ExecutorConfig.device`` names.

Morsel sizing is either static (``morsel_rows=N``: byte-deterministic
output for a given N regardless of worker count) or adaptive
(``morsel_rows="auto"``: each pipeline tunes its slice size from an EWMA of
observed morsel latency toward ~1 ms/morsel, clamped to [4096, 262144];
row *order* is still deterministic, but float aggregation partial sums may
group differently run-to-run as boundaries move).  Each run's
``ExecutorStats`` (``get_last_stats()``) reports per-pipeline morsel counts
and the tuned size.

Memory budget: ``ExecutorConfig.memory_budget`` (env ``DACP_MEMORY_BUDGET``)
bounds the combined bytes of all breaker build states in a run through a
shared ``MemoryAccountant``.  When an aggregate's merged ``GroupState`` or
a join's collected build side crosses the budget, the breaker switches to
**grace-hash spill** (``repro_torch.core.spill``): state/build batches partition
to wire-framed temp files by key hash and partitions are processed one at a
time (recursively re-partitioned while still over budget) — the morsel
driver, reorder window, and deterministic merge order are untouched, and
results stay byte-identical to in-memory execution.  Spill counters
(partitions/batches/bytes written, recursion depth) ride on
``ExecutorStats`` and the server PING response.

Laziness contract: building the executor does no work; worker threads spin
up on the first pull of the output SDF and wind down when it is exhausted
or closed.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Iterator

from repro_torch import trace
from repro_torch.core.backend import FUSED_INELIGIBLE, ComputeBackend, get_backend, plan_fused_chain
from repro_torch.core.batch import RecordBatch, concat_batches
from repro_torch.core.dag import Dag, Node
from repro_torch.core.env import env_bytes, env_devices, env_dir, env_int, env_morsel_rows, env_str, knob_default
from repro_torch.core.errors import FlowCancelled, PlanError, SchemaError
from repro_torch.core.operators import (
    GroupState,
    agg_out_fields,
    build_join_table,
    execute_node,
    filter_morsel,
    get_map,
    join_probe_morsel,
    join_schema,
    map_morsel,
    project_schema,
    select_morsel,
)
from repro_torch.core.schema import Schema
from repro_torch.core.sdf import StreamingDataFrame
from repro_torch.core.spill import (
    ROWID_COL,
    GraceHashAggregate,
    MemoryAccountant,
    collect_build,
    spilled_join_stream,
)

__all__ = [
    "ExecutorConfig",
    "ExecutorStats",
    "execute_parallel",
    "prefetch_sdf",
    "default_workers",
    "get_last_stats",
]

DEFAULT_MORSEL_ROWS = knob_default("DACP_MORSEL_ROWS")
# adaptive ("auto") morsel sizing envelope: EWMA of observed per-morsel
# latency steers the size toward AUTO_TARGET_S per morsel, clamped.
AUTO_MORSEL_MIN = 4096
AUTO_MORSEL_MAX = 262144
AUTO_MORSEL_INIT = 16384
AUTO_TARGET_S = 1e-3
_STREAMING_OPS = ("filter", "select", "project", "map")


def default_workers() -> int:
    return env_int("DACP_EXECUTOR_WORKERS")


@dataclass
class ExecutorConfig:
    """Executor tuning knobs (engine/server-level configuration).

    num_workers   morsel worker threads per pipeline stage; 1 = sequential
                  in-line execution (no threads), 0 = delegate to the
                  reference pull chain (``operators.execute``).
    morsel_rows   rows per morsel (source batches are sliced to this), or
                  ``"auto"``: each pipeline tunes its own size from an EWMA
                  of observed morsel latency (target ~1 ms/morsel, clamped
                  to [4096, 262144]); the chosen size lands in the run's
                  ``ExecutorStats``.
    backend       compute backend name ("numpy" | "torch" | "auto"; auto is
                  torch).
    device        the torch backend's device: "cuda" (default; raises when
                  no card is present) or "cpu", where the kernels' plain
                  PyTorch versions run.  Not a tuning knob: the caller
                  states where the work runs.
    window        reorder/backpressure window in morsels (0 → 4×workers).
    prefetch_batches  per-source prefetch queue depth (0 disables).
    stream_depth  producer-queue depth used by the server when streaming
                  result frames (faird GET/COOK overlap; 0 disables).
    scan_workers  parallel file readers inside datasource scans.
    memory_budget combined byte budget for breaker build states (aggregate
                  GroupStates + join build sides) per run; crossing it
                  switches the breaker to grace-hash spill-to-disk.  0 =
                  unbounded (no spilling).  Env ``DACP_MEMORY_BUDGET``
                  accepts ``262144`` / ``256KB`` / ``16m`` forms.
    spill_dir     directory for spill partition files (None = the system
                  temp dir; env ``DACP_SPILL_DIR``).
    spill_fanout  partitions per grace-hash level (≥ 2).
    devices       CUDA device indices that fused-pipeline stages
                  round-robin their device-resident launches/staged uploads
                  across (None = ``device``; env ``DACP_DEVICES`` as a
                  comma-separated list, validated with warn + fallback).
                  Each fused plan stages its morsels to and launches on
                  ``cuda:<index>``; an index the host lacks raises.
    """

    num_workers: int = field(default_factory=default_workers)
    morsel_rows: int | str = field(default_factory=lambda: env_morsel_rows("DACP_MORSEL_ROWS"))
    backend: str = field(default_factory=lambda: env_str("DACP_BACKEND"))
    window: int = 0
    prefetch_batches: int = 4
    stream_depth: int = 4
    scan_workers: int = field(default_factory=lambda: env_int("DACP_SCAN_WORKERS"))
    memory_budget: int = field(default_factory=lambda: env_bytes("DACP_MEMORY_BUDGET"))
    spill_dir: str | None = field(default_factory=lambda: env_dir("DACP_SPILL_DIR"))
    spill_fanout: int = 8
    devices: tuple | None = field(default_factory=lambda: env_devices("DACP_DEVICES"))
    device: str = "cuda"

    def __post_init__(self) -> None:
        mr = self.morsel_rows
        if isinstance(mr, str):
            if mr.strip().lower() != "auto":
                raise ValueError(f"morsel_rows must be a positive int or 'auto', got {mr!r}")
            self.morsel_rows = "auto"
        elif mr < 1:
            raise ValueError(f"morsel_rows must be >= 1, got {mr}")
        if self.memory_budget < 0:
            raise ValueError(f"memory_budget must be >= 0 (0 = unbounded), got {self.memory_budget}")
        if self.spill_fanout < 2:
            raise ValueError(f"spill_fanout must be >= 2, got {self.spill_fanout}")
        if self.devices is not None:
            devs = tuple(int(d) for d in self.devices)
            if not devs or any(d < 0 for d in devs):
                raise ValueError(f"devices must be a non-empty tuple of indices >= 0, got {self.devices!r}")
            self.devices = devs

    @property
    def auto_morsels(self) -> bool:
        return self.morsel_rows == "auto"

    def initial_morsel_rows(self) -> int:
        return AUTO_MORSEL_INIT if self.auto_morsels else max(1, int(self.morsel_rows))

    def effective_window(self) -> int:
        return self.window if self.window > 0 else 4 * max(1, self.num_workers)


# ---------------------------------------------------------------------------
# adaptive morsel sizing + run stats
# ---------------------------------------------------------------------------
class _MorselSizer:
    """Per-pipeline morsel-size controller.  Workers report each morsel's
    (rows, seconds); an EWMA least-squares fit of the latency model
    ``t(rows) = a + b·rows`` steers the next slice size toward ``target_s``
    per morsel — with a floor that keeps the fixed per-morsel overhead ``a``
    (python dispatch, per-morsel GroupState churn, lock traffic) under
    ~1/(1+_OVERHEAD_K) of each morsel's latency, so a host where overhead
    rivals the 1 ms target (GIL-bound CPUs) doesn't get starved into
    tiny, throughput-losing morsels.  Where overhead is negligible
    (vectorized/TPU compute), the floor vanishes and the controller is a
    pure ~1 ms latency target.  Clamped, in 4096-row steps.  Thread-safe;
    reads are a single attribute load.

    The same latency signal also feeds the pipeline's **reorder window**
    and **prefetch depth** (adaptive mode only): when morsels run at or
    under the latency target the window stays at its configured maximum
    (morsels are cheap — keep every worker busy and the sources read
    ahead); when a morsel costs k× the target, in-flight buffering is
    scaled down by ~1/k toward one morsel per worker, bounding the memory
    held by the reorder buffer and the source queues to a roughly constant
    *time depth* instead of a constant morsel count."""

    _ALPHA = 0.15  # EWMA weight for the regression moments
    _OVERHEAD_K = 8  # morsel must be >= K× the fixed overhead

    def __init__(
        self,
        initial: int,
        adaptive: bool,
        target_s: float = AUTO_TARGET_S,
        lo: int = AUTO_MORSEL_MIN,
        hi: int = AUTO_MORSEL_MAX,
        workers: int = 1,
        window: int = 4,
        prefetch: int = 4,
        request_id: int | None = None,
    ):
        self.size = initial
        self.request_id = request_id  # the run's ExecutorStats.request_id, for its spans
        self.adaptive = adaptive
        self.target_s = target_s
        self.lo = lo
        self.hi = hi
        self.workers = max(1, workers)
        self.max_window = max(self.workers + 1, window)
        self.max_prefetch = max(1, prefetch)
        self.window = self.max_window
        self.prefetch_depth = self.max_prefetch
        self.morsels = 0
        self.rows = 0
        # fused device-resident pipeline counters (bumped by FusedChainPlan
        # and the micro-morsel coalescer; surfaced via ExecutorStats)
        self.fused_launches = 0
        self.transfers_overlapped = 0
        self.micromorsels_coalesced = 0
        self._m = None  # EWMA moments (E[r], E[t], E[r²], E[r·t])
        self._lock = threading.Lock()

    def current(self) -> int:
        return self.size

    def bump(self, counter: str, k: int = 1) -> None:
        with self._lock:
            setattr(self, counter, getattr(self, counter) + k)

    def observe(self, rows: int, seconds: float) -> None:
        if rows <= 0:
            return
        with self._lock:
            self.morsels += 1
            self.rows += rows
            if not self.adaptive or seconds <= 0.0:
                return
            r, t = float(rows), float(seconds)
            if self._m is None:
                self._m = [r, t, r * r, r * t]
            else:
                al = self._ALPHA
                m = self._m
                m[0] += al * (r - m[0])
                m[1] += al * (t - m[1])
                m[2] += al * (r * r - m[2])
                m[3] += al * (r * t - m[3])
            mr, mt, mrr, mrt = self._m
            var = mrr - mr * mr
            if var > (0.05 * mr) ** 2:  # enough size variety to fit the intercept
                b = (mrt - mr * mt) / var
                a = mt - b * mr
                a = max(a, 0.0)
                b = max(b, mt / mr * 1e-3, 1e-12)
            else:
                a, b = 0.0, mt / mr  # single operating point: pure latency model
            want = max(self.target_s / b, self._OVERHEAD_K * a / b)
            size = int(min(self.hi, max(self.lo, want)))
            self.size = max(self.lo, min(self.hi, size - size % 4096))
            # in-flight scaling from the same signal: fast morsels keep the
            # full window/prefetch; morsels k× over target shrink both ~1/k
            ratio = min(1.0, self.target_s / max(mt, 1e-12))
            lo_w = self.workers + 1
            self.window = lo_w + int(round((self.max_window - lo_w) * ratio))
            self.prefetch_depth = max(1, min(self.max_prefetch, 1 + int(round((self.max_prefetch - 1) * ratio))))


_request_ids = itertools.count(1)


@dataclass
class ExecutorStats:
    """Per-run executor observability.  One entry per pipeline stage drive:
    ``{"morsel_rows": final size, "auto": bool, "morsels": n, "rows": n,
    "window": reorder-window morsels, "prefetch_depth": source read-ahead}``.
    Completed entries land as each stage finishes; stages still driving are
    reported live (``"live": True`` — flow STATUS progress) from their
    attached sizers.  When the run has a memory budget, ``to_dict()``
    additionally carries the shared accountant's ``"spill"`` counters
    (budget, bytes/partitions/batches spilled, grace-hash recursion depth).
    ``request_id``, a serial of the process, tags every span of the run
    (``repro_torch.trace``)."""

    pipelines: list = field(default_factory=list)
    accountant: MemoryAccountant | None = None
    live: list = field(default_factory=list)
    request_id: int = field(default_factory=lambda: next(_request_ids))

    @staticmethod
    def _entry(sizer: _MorselSizer) -> dict:
        return {
            "morsel_rows": sizer.size,
            "auto": sizer.adaptive,
            "morsels": sizer.morsels,
            "rows": sizer.rows,
            "window": sizer.window,
            "prefetch_depth": sizer.prefetch_depth,
            "fused_launches": sizer.fused_launches,
            "transfers_overlapped": sizer.transfers_overlapped,
            "micromorsels_coalesced": sizer.micromorsels_coalesced,
        }

    def attach(self, sizer: _MorselSizer) -> None:
        self.live.append(sizer)

    def record(self, sizer: _MorselSizer) -> None:
        try:
            self.live.remove(sizer)
        except ValueError:
            pass
        self.pipelines.append(self._entry(sizer))

    def chosen_morsel_rows(self) -> int | None:
        """The (last pipeline's) tuned morsel size, or None before any
        pipeline completed."""
        return self.pipelines[-1]["morsel_rows"] if self.pipelines else None

    def progress(self) -> dict:
        """Aggregate morsel/row progress across finished + live stages."""
        done = list(self.pipelines)
        running = [self._entry(s) for s in list(self.live)]
        return {
            "morsels_done": sum(p["morsels"] for p in done + running),
            "rows_processed": sum(p["rows"] for p in done + running),
            "stages_done": len(done),
            "stages_running": len(running),
            "fused_launches": sum(p.get("fused_launches", 0) for p in done + running),
            "transfers_overlapped": sum(p.get("transfers_overlapped", 0) for p in done + running),
            "micromorsels_coalesced": sum(p.get("micromorsels_coalesced", 0) for p in done + running),
        }

    def to_dict(self) -> dict:
        d = {"pipelines": list(self.pipelines), **self.progress()}
        if self.accountant is not None:
            d["spill"] = self.accountant.to_dict()
        return d


_last_stats: ExecutorStats | None = None
_last_stats_lock = threading.Lock()


def get_last_stats() -> ExecutorStats | None:
    """Stats of the most recently *created* parallel execution (its entries
    appear as the lazy output is consumed)."""
    with _last_stats_lock:
        return _last_stats


# ---------------------------------------------------------------------------
# bounded source prefetch (network/disk ↔ compute overlap)
# ---------------------------------------------------------------------------
_DONE = object()


class _Prefetch:
    """Pulls an SDF's batches on a background thread into a bounded queue.
    Exceptions (e.g. a dead exchange pull) are re-raised to the consumer
    with their original type, so upstream resilience/retry still works.
    ``depth_fn`` (optional) makes the bound dynamic: the adaptive morsel
    sizer shrinks source read-ahead when batches turn out expensive."""

    def __init__(self, sdf: StreamingDataFrame, depth: int, depth_fn=None, request_id: int | None = None):
        self._sdf = sdf
        self._request_id = request_id
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._depth_fn = depth_fn
        self._stop = False
        self._exc: BaseException | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def _run(self) -> None:
        try:
            it = iter(self._sdf.iter_batches())
            while True:
                sp = trace.ON and trace.begin("source", self._request_id, leaf=True)
                b = next(it, _DONE)
                if sp:
                    trace.finish(sp)
                if b is _DONE:
                    break
                if not self._put(b):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer side
            self._exc = e
        self._put(_DONE)

    def _put(self, item) -> bool:
        while not self._stop:
            if self._depth_fn is not None and self._q.qsize() >= self._depth_fn():
                time.sleep(0.01)  # dynamic bound tightened below queue capacity
                continue
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> Iterator[RecordBatch]:
        self.start()
        while not self._stop:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is _DONE:
                if self._exc is not None:
                    raise self._exc
                return
            yield item

    def close(self) -> None:
        self._stop = True


def prefetch_sdf(sdf: StreamingDataFrame, depth: int = 4) -> StreamingDataFrame:
    """Producer-queue wrapper: batches are computed ``depth`` ahead of the
    consumer on a background thread (the server uses this to overlap result
    production with socket writes)."""
    if depth <= 0:
        return sdf

    def gen():
        pf = _Prefetch(sdf, depth)
        try:
            yield from pf
        finally:
            pf.close()

    return StreamingDataFrame(sdf.schema, gen)


# ---------------------------------------------------------------------------
# ordered morsel runs
# ---------------------------------------------------------------------------
class _Branch:
    """One pipeline input: a source SDF plus the op specs applied to its
    morsels.  Unions contribute several branches to the same stage."""

    __slots__ = ("sdf", "specs")

    def __init__(self, sdf: StreamingDataFrame, specs: list | None = None):
        self.sdf = sdf
        self.specs = specs if specs is not None else []


def _apply_ops(cops, batch: RecordBatch) -> RecordBatch | None:
    """Apply a compiled ``(ops, plan)`` chain to one morsel.  A fused plan
    runs the whole chain in one device launch; a morsel outside the kernel
    envelope (nulls, overflow rows) falls back to the per-op closures,
    byte-identically."""
    ops, plan = cops
    if plan is not None:
        out = plan.run(batch)
        if out is not FUSED_INELIGIBLE:
            return out
    sp = trace.ON and trace.begin("perop", leaf=True)
    for op in ops:
        batch = op(batch)
        if batch is None:
            break
    if sp:
        trace.finish(sp)
    return batch


def _morsel_slices(batch: RecordBatch, sizer: _MorselSizer):
    n = batch.num_rows
    if n <= sizer.current():
        yield batch
        return
    s = 0
    while s < n:
        rows = max(1, sizer.current())  # re-read: "auto" retunes mid-batch
        yield batch.slice(s, s + rows)
        s += rows


def _branch_items(cops, batches, sizer: _MorselSizer, cfg: ExecutorConfig, do_stage: bool):
    """One branch's batches → morsels, in input order.

    Adaptive mode coalesces runs of tiny source batches into a single
    morsel (**micro-morsel batching**: when the sizer picks sizes larger
    than what the source produces, launches amortize over the coalesced
    run instead of one per fragment; output order is preserved because
    only *consecutive* batches merge).  On a fused plan, each emitted
    morsel's kernel inputs are staged to the device before the morsel is
    handed to a worker (**double-buffering**: H2D transfers are async,
    so morsel N+1's upload overlaps morsel N's compute)."""
    plan = cops[1]
    pending: list = []
    pending_rows = 0

    def emit(m):
        if plan is not None and do_stage:
            plan.stage(m)
        return m

    def flush():
        nonlocal pending, pending_rows
        if not pending:
            return None
        m = pending[0] if len(pending) == 1 else concat_batches(pending)
        if len(pending) > 1:
            sizer.bump("micromorsels_coalesced", len(pending) - 1)
        pending = []
        pending_rows = 0
        return emit(m)

    for batch in batches:
        if cfg.auto_morsels and batch.num_rows < sizer.current():
            if pending and pending_rows + batch.num_rows > sizer.current():
                out = flush()
                if out is not None:
                    yield out
            pending.append(batch)
            pending_rows += batch.num_rows
            continue
        out = flush()
        if out is not None:
            yield out
        for m in _morsel_slices(batch, sizer):
            yield emit(m)
    out = flush()
    if out is not None:
        yield out


_device_rr = itertools.count()  # round-robin cursor over cfg.devices


def _run_ordered(
    branches: list,
    cfg: ExecutorConfig,
    backend: ComputeBackend,
    make_item: Callable,
    stats: ExecutorStats | None = None,
    cancel: threading.Event | None = None,
    agg=None,
):
    """Drive branches' morsels through a worker pool; yield non-None
    ``make_item(cops, morsel)`` results in strict input order.

    With ``num_workers <= 1`` this degrades to a fully synchronous loop —
    no threads, reference pull-chain behavior.

    ``agg`` (``(keys, aggs, mode, in_schema)``) marks an aggregate drive:
    the fused-chain planner then folds the partial aggregate into the same
    per-morsel launch as the streaming ops.

    ``cancel`` is the flow-lifecycle hook: when the event fires, workers
    stop claiming morsels and the driver raises ``FlowCancelled`` instead
    of blocking on upstream, so a CANCELled plan releases its threads,
    prefetchers, and spill files within a bounded delay."""
    compiled = [(br, _finalize_ops(br.specs, backend, br.sdf.schema, agg)) for br in branches]
    rid = stats.request_id if stats is not None else None
    sizer = _MorselSizer(
        cfg.initial_morsel_rows(),
        cfg.auto_morsels,
        workers=max(1, cfg.num_workers),
        window=cfg.effective_window(),
        prefetch=cfg.prefetch_batches,
        request_id=rid,
    )
    plans = [cops[1] for _, cops in compiled if cops[1] is not None]
    for pl in plans:
        dev = cfg.devices[next(_device_rr) % len(cfg.devices)] if cfg.devices else None
        pl.bind(sizer, dev)
    if stats is not None:
        stats.attach(sizer)  # live progress (flow STATUS) before the stage ends

    if cfg.num_workers <= 1:
        try:
            for br, cops in compiled:
                for m in _branch_items(cops, br.sdf.iter_batches(), sizer, cfg, do_stage=False):
                    if cancel is not None and cancel.is_set():
                        raise FlowCancelled("execution cancelled")
                    t0 = time.perf_counter_ns()
                    sp = trace.ON and trace.begin("morsel", rid, start=t0)
                    out = make_item(cops, m)
                    t1 = time.perf_counter_ns()
                    sizer.observe(m.num_rows, (t1 - t0) * 1e-9)
                    if sp:
                        trace.finish(sp, t1)
                    if out is not None:
                        yield out
        finally:
            for pl in plans:
                pl.clear_staged()
            if stats is not None:
                stats.record(sizer)
        return

    depth_fn = (lambda: sizer.prefetch_depth) if cfg.auto_morsels else None
    prefetchers = [_Prefetch(br.sdf, cfg.prefetch_batches, depth_fn=depth_fn, request_id=rid) for br, _ in compiled]
    for pf in prefetchers:
        pf.start()  # all sources (incl. every exchange pull) activate now

    def morsels():
        for (_, cops), pf in zip(compiled, prefetchers):
            for m in _branch_items(cops, pf, sizer, cfg, do_stage=True):
                yield cops, m

    it = morsels()
    src_lock = threading.Lock()
    cond = threading.Condition()
    state = {"assigned": 0, "next": 0, "total": None, "error": None, "stop": False, "buf": {}}

    def worker():
        while True:
            with cond:
                while (
                    not state["stop"]
                    and state["error"] is None
                    and not (cancel is not None and cancel.is_set())
                    and state["assigned"] - state["next"] >= sizer.window
                ):
                    cond.wait(timeout=0.1)
                if state["stop"] or state["error"] is not None or (cancel is not None and cancel.is_set()):
                    return
            with src_lock:
                if state["total"] is not None:
                    return
                try:
                    cops, m = next(it)
                except StopIteration:
                    state["total"] = state["assigned"]
                    with cond:
                        cond.notify_all()
                    return
                except BaseException as e:  # noqa: BLE001 - surfaced to consumer
                    with cond:
                        if state["error"] is None:
                            state["error"] = e
                        state["total"] = state["assigned"]
                        cond.notify_all()
                    return
                seq = state["assigned"]
                state["assigned"] = seq + 1
            try:
                t0 = time.perf_counter_ns()
                sp = trace.ON and trace.begin("morsel", rid, start=t0)
                out = make_item(cops, m)
                t1 = time.perf_counter_ns()
                sizer.observe(m.num_rows, (t1 - t0) * 1e-9)
                if sp:
                    trace.finish(sp, t1)
            except BaseException as e:  # noqa: BLE001 - surfaced to consumer
                with cond:
                    if state["error"] is None:
                        state["error"] = e
                    cond.notify_all()
                return
            with cond:
                state["buf"][seq] = out
                cond.notify_all()

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(cfg.num_workers)]
    for t in threads:
        t.start()
    try:
        while True:
            with cond:
                while (
                    state["next"] not in state["buf"]
                    and state["error"] is None
                    and not (cancel is not None and cancel.is_set())
                    and not (state["total"] is not None and state["next"] >= state["total"])
                ):
                    cond.wait(timeout=0.1)
                if cancel is not None and cancel.is_set():
                    raise FlowCancelled("execution cancelled")
                if state["error"] is not None:
                    raise state["error"]
                if state["next"] not in state["buf"]:
                    return  # total reached: all morsels emitted
                item = state["buf"].pop(state["next"])
                state["next"] += 1
                cond.notify_all()
            if item is not None:
                yield item
    finally:
        with cond:
            state["stop"] = True
            cond.notify_all()
        for pf in prefetchers:
            pf.close()
        for pl in plans:
            pl.clear_staged()  # CANCEL/teardown: no leaked staged device buffers
        if stats is not None:
            stats.record(sizer)


# ---------------------------------------------------------------------------
# op-spec finalization (backend binding + filter→select fusion)
# ---------------------------------------------------------------------------
def _finalize_ops(specs: list, backend: ComputeBackend, in_schema: Schema | None = None, agg=None) -> tuple:
    """Turn compile-time op specs into ``(morsel closures, fused plan)``.

    When the whole chain (and, for aggregate drives, the fold) fits the
    fused-pipeline kernel envelope, ``plan`` is a
    :class:`~repro_torch.core.backend.FusedChainPlan` that executes everything in
    ONE device launch per morsel; the per-op closures remain the fallback
    for morsels outside the envelope.  Independently, adjacent
    filter+select pairs are peephole-fused into the backend's two-op
    kernel on the per-op path."""
    plan = plan_fused_chain(specs, in_schema, agg=agg, backend=backend) if in_schema is not None else None
    ops: list = []
    i = 0
    while i < len(specs):
        kind, args = specs[i]
        if kind == "filter" and i + 1 < len(specs) and specs[i + 1][0] == "select":
            pred, cols = args[0], list(specs[i + 1][1][0])
            ops.append(lambda b, _p=pred, _c=cols: backend.filter_select(b, _p, _c))
            i += 2
            continue
        if kind == "filter":
            pred = args[0]
            ops.append(lambda b, _p=pred: filter_morsel(b, _p, backend))
        elif kind == "select":
            cols = list(args[0])
            ops.append(lambda b, _c=cols: select_morsel(b, _c))
        elif kind == "project":
            exprs, out_schema = args
            ops.append(lambda b, _e=exprs, _s=out_schema: backend.project(b, _e, _s))
        elif kind == "map":
            mf, fn_params = args
            ops.append(lambda b, _m=mf, _p=fn_params: map_morsel(b, _m, _p))
        elif kind == "probe":
            once, on, payload, schema = args
            ops.append(
                lambda b, _o=once, _on=on, _pl=payload, _s=schema: join_probe_morsel(
                    b, _o.get()[0], _o.get()[1], _on, _pl, _s
                )
            )
        else:  # pragma: no cover - compiler invariant
            raise PlanError(f"unknown morsel op {kind!r}")
        i += 1
    return ops, plan


class _Once:
    """Thread-safe lazily-computed value (join build table)."""

    def __init__(self, factory: Callable):
        self._factory = factory
        self._lock = threading.Lock()
        self._value = None
        self._ready = False

    def get(self):
        if not self._ready:
            with self._lock:
                if not self._ready:
                    self._value = self._factory()
                    self._ready = True
        return self._value


# ---------------------------------------------------------------------------
# DAG → pipeline compiler
# ---------------------------------------------------------------------------
class _Compiler:
    def __init__(
        self,
        dag: Dag,
        resolver: Callable[[Node], StreamingDataFrame],
        cfg: ExecutorConfig,
        backend: ComputeBackend,
        stats: ExecutorStats | None = None,
        acct: MemoryAccountant | None = None,
        cancel=None,
    ):
        self.dag = dag
        self.resolver = resolver
        self.cfg = cfg
        self.backend = backend
        self.stats = stats
        self.cancel = cancel  # flow-lifecycle cancellation event (or None)
        # one accountant per run, shared by every breaker in the plan
        self.acct = acct if acct is not None else MemoryAccountant(cfg.memory_budget)
        self._memo: dict = {}  # node id -> (branches, schema)

    def compile(self) -> StreamingDataFrame:
        branches, schema = self._stream(self.dag.output)
        return self._stage_sdf(branches, schema)

    # -- stage assembly -----------------------------------------------------
    def _stage_sdf(self, branches: list, schema: Schema) -> StreamingDataFrame:
        if len(branches) == 1 and not branches[0].specs:
            return branches[0].sdf  # nothing to compute: pass the source through

        def gen():
            yield from _run_ordered(branches, self.cfg, self.backend, _apply_ops, self.stats, self.cancel)

        return StreamingDataFrame(schema, gen)

    def _collect_stage(self, branches: list, schema: Schema) -> RecordBatch:
        got = list(_run_ordered(branches, self.cfg, self.backend, _apply_ops, self.stats, self.cancel))
        return concat_batches(got) if got else RecordBatch.empty(schema)

    # -- recursive compilation ---------------------------------------------
    def _stream(self, nid: str) -> tuple:
        memo = self._memo.get(nid)
        if memo is not None:
            branches, schema = memo
            # consumers mutate spec lists; hand each its own copy
            return [_Branch(br.sdf, list(br.specs)) for br in branches], schema
        out = self._compile_node(self.dag.nodes[nid])
        self._memo[nid] = out
        branches, schema = out
        return [_Branch(br.sdf, list(br.specs)) for br in branches], schema

    def _compile_node(self, node: Node) -> tuple:
        op = node.op
        if op in ("source", "exchange"):
            sdf = self.resolver(node)
            return [_Branch(sdf)], sdf.schema
        if op in _STREAMING_OPS:
            branches, schema = self._stream(node.inputs[0])
            spec, schema = self._streaming_spec(node, schema)
            for br in branches:
                br.specs.append(spec)
            return branches, schema
        if op == "union":
            branches, schema = self._stream(node.inputs[0])
            for other in node.inputs[1:]:
                b2, s2 = self._stream(other)
                if not s2.equals(schema):
                    raise SchemaError("union over mismatched schemas")
                branches.extend(b2)
            return branches, schema
        if op == "aggregate":
            return self._compile_aggregate(node)
        if op == "join":
            return self._compile_join(node)
        if op in ("limit", "rebatch"):
            # sequential-by-nature: serial tail over the parallel upstream
            branches, schema = self._stream(node.inputs[0])
            sdf = execute_node(node, [self._stage_sdf(branches, schema)])
            return [_Branch(sdf)], sdf.schema
        raise PlanError(f"operator {op!r} has no parallel evaluator")

    def _streaming_spec(self, node: Node, in_schema: Schema) -> tuple:
        if node.op == "filter":
            return ("filter", (node.params["predicate"],)), in_schema
        if node.op == "select":
            cols = list(node.params["columns"])
            return ("select", (cols,)), in_schema.select(cols)
        if node.op == "project":
            exprs = dict(node.params["exprs"])
            keep = bool(node.params.get("keep", True))
            out_schema = project_schema(in_schema, exprs, keep)
            return ("project", (exprs, out_schema)), out_schema
        if node.op == "map":
            mf = get_map(node.params["fn"])
            fn_params = dict(node.params.get("fn_params", {}))
            return ("map", (mf, fn_params)), mf.schema_fn(in_schema, **fn_params)
        raise PlanError(f"not a streaming op: {node.op!r}")  # pragma: no cover

    def _compile_aggregate(self, node: Node) -> tuple:
        keys = list(node.params["keys"])
        aggs = dict(node.params["aggs"])
        mode = node.params.get("mode", "full")
        branches, in_schema = self._stream(node.inputs[0])
        missing = [k for k in keys if k not in in_schema]
        if missing:
            raise SchemaError(f"aggregate keys missing from input: {missing}")
        out_schema = Schema(agg_out_fields(in_schema, keys, aggs, mode))
        cfg, backend, stats, acct, cancel = self.cfg, self.backend, self.stats, self.acct, self.cancel
        spillable = acct.enabled and GraceHashAggregate.supported(keys, aggs, mode, in_schema)
        if acct.enabled and keys and not spillable:
            # a keyless aggregate is a single bounded group — but a name
            # collision with the reserved spill columns means this breaker
            # runs UNBOUNDED despite the budget; never silently
            warnings.warn(
                f"aggregate on keys {keys} cannot grace-hash spill (reserved spill-column "
                f"name collision); its state is NOT memory-budgeted",
                stacklevel=2,
            )

        def fold(cops, morsel):
            ops, plan = cops
            if plan is not None:
                # fused device-resident fold: filter → project → compact →
                # segment fold in ONE launch, GroupState materialized from
                # the kernel's per-group accumulators (byte-identical)
                st = plan.fold(morsel)
                if st is not FUSED_INELIGIBLE:
                    return st
            b = _apply_ops((ops, None), morsel)
            if b is None or b.num_rows == 0:
                return None
            # backend-aware fold: eligible aggregates run on the
            # segment-reduce kernel once keys are factorized (pushdown R9
            # partials on the accelerator)
            sp = trace.ON and trace.begin("perop", leaf=True)
            st = GroupState(keys, aggs, mode, in_schema, vectorized=True, backend=backend)
            st.update(b)
            if sp:
                trace.finish(sp)
            return st

        def agg_gen():
            # breaker: fold morsels into per-morsel partial states in
            # parallel, merge them in morsel order (deterministic output).
            # Under a memory budget the merged state's accounted bytes are
            # tracked; crossing the budget switches to grace-hash spill —
            # the partial states (prefix first, then per-morsel) scatter to
            # disk by key hash and re-merge per partition, byte-identically.
            total = GroupState(keys, aggs, mode, in_schema, vectorized=True)
            spiller = None
            reserved = 0
            rid = stats.request_id if stats is not None else None
            try:
                for st in _run_ordered(branches, cfg, backend, fold, stats, cancel, agg=(keys, aggs, mode, in_schema)):
                    if spiller is not None:
                        spiller.spill_state(st)
                        continue
                    sp = trace.ON and trace.begin("merge", rid, leaf=True)
                    total.merge(st)
                    if sp:
                        trace.finish(sp)
                    if spillable:
                        nb = total.approx_nbytes()
                        acct.adjust(nb - reserved)
                        reserved = nb
                        if acct.over():
                            spiller = GraceHashAggregate(
                                keys,
                                aggs,
                                mode,
                                in_schema,
                                out_schema,
                                acct,
                                backend=backend,
                                morsel_rows=cfg.initial_morsel_rows(),
                                fanout=cfg.spill_fanout,
                                spill_dir=cfg.spill_dir,
                            )
                            spiller.spill_state(total)
                            total = None
                            acct.adjust(-reserved)
                            reserved = 0
                sp = trace.ON and trace.begin("finalize", rid, leaf=True)
                out = total.result(out_schema) if spiller is None else spiller.result()
                if sp:
                    trace.finish(sp)
                yield out
            finally:
                acct.adjust(-reserved)
                if spiller is not None:
                    spiller.close()

        return [_Branch(StreamingDataFrame(out_schema, agg_gen))], out_schema

    def _compile_join(self, node: Node) -> tuple:
        on = list(node.params["on"])
        left_branches, ls = self._stream(node.inputs[0])
        right_branches, rs = self._stream(node.inputs[1])
        schema, payload, _rename = join_schema(ls, rs, on)

        if self.acct.enabled:
            if ROWID_COL not in ls:
                return self._compile_join_budgeted(left_branches, ls, right_branches, rs, on, payload, schema)
            warnings.warn(
                f"join probe schema contains the reserved column {ROWID_COL!r}; "
                f"its build side is NOT memory-budgeted",
                stacklevel=2,
            )

        def build():
            rb = self._collect_stage(right_branches, rs)
            return rb, build_join_table(rb, on)

        once = _Once(build)
        for br in left_branches:
            br.specs.append(("probe", (once, on, payload, schema)))
        return left_branches, schema

    def _compile_join_budgeted(self, left_branches, ls, right_branches, rs, on, payload, schema) -> tuple:
        """Memory-budgeted join: the build side collects under the shared
        accountant and grace-hash spills past the budget.  When the build
        fits, probing stays **morsel-parallel** — a probe-spec stage over
        the left stage's output (one extra stage hop vs the unbudgeted
        fused path, the price of not knowing spill-vs-mem until the build
        runs; left sources may be one-shot exchange pulls, so the decision
        cannot be retried).  Only a spilled build degrades to the serial
        partition-paired drive.  Collected results are byte-identical to
        the fused in-memory probe either way."""
        cfg, backend, stats, acct, cancel = self.cfg, self.backend, self.stats, self.acct, self.cancel

        def build():
            batches = _run_ordered(right_branches, cfg, backend, _apply_ops, stats, cancel)
            return collect_build(
                batches,
                rs,
                on,
                acct,
                fanout=cfg.spill_fanout,
                spill_dir=cfg.spill_dir,
            )

        once = _Once(build)

        class _MemTable:
            """probe-spec adapter: .get() -> (build batch, table)."""

            def get(self):
                res = once.get()
                assert res[0] == "mem"  # only consulted on the in-memory path
                return res[1], res[2]

        left_sdf = self._stage_sdf(left_branches, ls)

        def join_gen():
            res = once.get()
            if res[0] == "mem":
                probe_branches = [_Branch(left_sdf, [("probe", (_MemTable(), on, payload, schema))])]
                yield from _run_ordered(probe_branches, cfg, backend, _apply_ops, stats, cancel)
            else:
                yield from spilled_join_stream(
                    res[1],
                    left_sdf.iter_batches(),
                    on,
                    payload,
                    schema,
                    ls,
                    acct,
                    morsel_rows=cfg.initial_morsel_rows(),
                    fanout=cfg.spill_fanout,
                    spill_dir=cfg.spill_dir,
                )

        return [_Branch(StreamingDataFrame(schema, join_gen))], schema


def execute_parallel(
    dag: Dag,
    source_resolver: Callable[[Node], StreamingDataFrame],
    config: ExecutorConfig | None = None,
    stats: ExecutorStats | None = None,
    cancel=None,
) -> StreamingDataFrame:
    """Wire the DAG into morsel-parallel pipelines and return the output SDF.

    Semantics match ``operators.execute`` (same rows, same order for a given
    morsel size); execution is lazy — workers start on the first pull.
    ``stats`` (or ``get_last_stats()``) collects per-pipeline morsel counts
    and the tuned morsel size as the output is consumed.  ``cancel`` (a
    ``threading.Event``) is the flow-lifecycle cancellation hook: setting it
    makes every stage raise ``FlowCancelled`` and release its workers,
    prefetchers, and spill state within a bounded delay."""
    global _last_stats
    cfg = config or ExecutorConfig()
    backend = get_backend(cfg.backend, device=cfg.device)
    if stats is None:
        stats = ExecutorStats()
    acct = MemoryAccountant(cfg.memory_budget)
    stats.accountant = acct
    with _last_stats_lock:
        _last_stats = stats
    sdf = _Compiler(dag, source_resolver, cfg, backend, stats, acct, cancel).compile()
    if not trace.ON:
        return sdf
    # the COOK's span: from here until its output is exhausted or closed
    sp = trace.begin("cook", stats.request_id, detached=True)

    def gen():
        try:
            yield from sdf.iter_batches()
        finally:
            trace.finish(sp)

    return StreamingDataFrame(sdf.schema, gen)
