"""The span recorder (``repro_torch.trace``) on the COOK path, on the CPU.

Off, no span site enters the recorder: nothing reads a clock for it or
allocates.  On, a fused aggregate COOK through ``execute_parallel`` (torch
backend, ``device="cpu"``, four workers) leaves one ``cook`` span, carries
its run's request id on every span of every thread, one ``morsel`` span per
morsel the executor counted, each child inside its parent, and a thread CPU
time no longer than the wall time.  Under a ``torch.profiler`` session the
leaf spans, put on the profiler's clock by the recorder's clock samples,
fall inside their ``dacp.<name>`` ranges, and a served COOK turns the
recorder on and off with the session."""

import threading
import time
import tracemalloc

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import repro_torch.core.batch as port_batch  # noqa: E402
import repro_torch.core.dag as port_dag  # noqa: E402
import repro_torch.core.executor as port_executor  # noqa: E402
import repro_torch.core.sdf as port_sdf  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.core.expr import col  # noqa: E402

ROWS = 6000
LEAVES = {"source", "stage", "factorize", "launch", "readback", "decode", "perop", "merge", "finalize", "plan", "send"}


@pytest.fixture(autouse=True)
def _recorder_off():
    trace.disable()
    yield
    trace.disable()


def _arrays(n=ROWS):
    rng = np.random.default_rng(11)
    return {"station": rng.integers(0, 40, n).astype(np.int32),
            "temp": (rng.standard_normal(n) * 8 + 15).astype(np.float32)}


def _dag():
    bld = port_dag.Dag.build()
    node = bld.source("dacp://h:1/obs")
    node = bld.add("project", {"exprs": {"st": col("station"), "t": col("temp"), "dh": col("temp") - 17.5},
                               "keep": False}, [node])
    node = bld.add("filter", {"predicate": col("t") > 17.5}, [node])
    node = bld.add("aggregate", {"keys": ["st"], "aggs": {"hours": {"fn": "count"},
                                                          "degree_hours": {"fn": "sum", "column": "dh"}}}, [node])
    return bld.finish(node)


def _cook(num_workers=4):
    """A fused aggregate COOK -> (result, stats)."""
    batch = port_batch.RecordBatch.from_pydict(_arrays())

    def gen():
        for s in range(0, batch.num_rows, 1000):
            yield batch.slice(s, s + 1000)

    stats = port_executor.ExecutorStats()
    cfg = port_executor.ExecutorConfig(num_workers=num_workers, morsel_rows=500, backend="torch", device="cpu")
    out = port_executor.execute_parallel(_dag(), lambda n: port_sdf.StreamingDataFrame(batch.schema, gen), cfg,
                                         stats=stats).collect()
    return out, stats


def _cpu_tick_ns() -> int:
    """The step of this host's thread CPU clock (some hosts count it in
    scheduler ticks of several milliseconds)."""
    steps, last = [], time.thread_time_ns()
    deadline = time.perf_counter() + 0.2
    while len(steps) < 3 and time.perf_counter() < deadline:
        now = time.thread_time_ns()
        if now != last:
            steps.append(now - last)
            last = now
    return max(steps, default=0)


def _check_tree(spans):
    by_id = {s.span_id: s for s in spans}
    slack = 2 * _cpu_tick_ns() + 1_000_000
    for s in spans:
        assert s.start_ns <= s.end_ns, s
        if s.cpu_start_ns is not None:
            assert s.cpu_end_ns - s.cpu_start_ns <= s.end_ns - s.start_ns + slack, s
        if s.parent is not None and s.parent in by_id:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)


def test_off_no_span_site_enters_the_recorder(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span site entered the recorder while it was off")

    for name in ("begin", "finish", "adopt"):
        monkeypatch.setattr(trace, name, refuse)
    tracemalloc.start()
    try:
        out, stats = _cook()
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    assert out.num_rows == 40 and stats.pipelines[0]["fused_launches"] > 0
    assert not snap.filter_traces([tracemalloc.Filter(True, trace.__file__)]).statistics("filename")
    assert trace.disable().spans == []


def test_a_cook_leaves_one_cook_span_and_its_request_id_on_every_thread():
    trace.enable()
    out, stats = _cook()
    rec = trace.disable()
    spans = rec.spans
    names = {s.name for s in spans}
    assert out.num_rows == 40
    assert [s.name for s in spans].count("cook") == 1
    assert {"source", "stage", "morsel", "factorize", "launch", "readback", "decode", "merge", "finalize"} <= names
    assert {s.request for s in spans} == {stats.request_id}
    threads = {s.name: s.thread for s in spans}
    assert threads["source"] != threads["morsel"] != threads["cook"]  # prefetch, worker, consumer
    assert len({s.thread for s in spans if s.name == "morsel"}) >= 2
    assert [s.name for s in spans].count("morsel") == sum(p["morsels"] for p in stats.pipelines)
    cook = next(s for s in spans if s.name == "cook")
    for s in spans:
        if s.name in ("source", "morsel", "stage", "merge", "finalize"):
            assert s.parent == cook.span_id, s
        if s.name in ("factorize", "launch", "readback", "decode"):
            assert spans[[x.span_id for x in spans].index(s.parent)].name == "morsel", s
    _check_tree(spans)
    assert len(rec.clock) == 2 and rec.clock[0][2] <= cook.start_ns and cook.end_ns <= rec.clock[1][0]


def test_request_ids_differ_between_runs_and_a_second_recording_starts_empty():
    trace.enable()
    _, s1 = _cook()
    _, s2 = _cook()
    spans = trace.disable().spans
    assert s1.request_id != s2.request_id
    assert {s.request for s in spans} == {s1.request_id, s2.request_id}
    trace.enable()
    assert trace.disable().spans == []


def test_leaf_spans_fall_inside_their_profiler_ranges():
    """One worker: the COOK runs on this thread, which the profiler records."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.enable()
        _cook(num_workers=1)
        rec = trace.disable()
    offsets = [unix - (a + b) // 2 for a, unix, b in rec.clock]
    slack = max(b - a for a, _u, b in rec.clock) + abs(offsets[0] - offsets[-1]) + 200_000
    ranges: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("dacp."):
            ranges.setdefault(e.name()[5:], []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    leaves = sorted((s for s in rec.spans if s.name in LEAVES), key=lambda s: s.start_ns)
    assert leaves and {s.name for s in leaves} == set(ranges)
    for name, got in ranges.items():
        mine = [s for s in leaves if s.name == name]
        assert len(mine) == len(got), name
        for s, (r0, r1) in zip(mine, sorted(got)):
            assert s.start_ns + offsets[0] - slack <= r0 and r1 <= s.end_ns + offsets[0] + slack, (s, r0, r1)
    assert not any(s.name in ("cook", "morsel") for s in leaves)


def test_follow_profiler_turns_the_recorder_on_with_a_session_and_off_after_it():
    trace.follow_profiler()
    assert not trace.ON
    with profile(activities=[ProfilerActivity.CPU]):
        trace.follow_profiler()
        assert trace.ON
        trace.finish(trace.begin("plan"))
        trace.follow_profiler()  # a clock sample
    trace.follow_profiler()
    assert not trace.ON
    rec = trace.disable()
    assert [s.name for s in rec.spans] == ["plan"] and len(rec.clock) == 3
    trace.enable()  # a recording enable() started is not the profiler's to stop
    trace.follow_profiler()
    assert trace.ON


def test_a_served_cook_under_a_profiler_carries_its_request_id_from_request_to_send(tmp_path):
    from repro_torch.client import LocalNetwork
    from repro_torch.server import FairdServer, write_sdf_dataset

    arrays = _arrays()

    def gen():
        for s in range(0, ROWS, 1000):
            yield port_batch.RecordBatch.from_pydict({k: v[s : s + 1000] for k, v in arrays.items()})

    probe = port_batch.RecordBatch.from_pydict({k: v[:1] for k, v in arrays.items()})
    write_sdf_dataset(str(tmp_path / "obs"), port_sdf.StreamingDataFrame(probe.schema, gen))
    srv = FairdServer("h1:3101", executor=port_executor.ExecutorConfig(num_workers=2, morsel_rows=500,
                                                                        backend="torch", device="cpu"))
    srv.catalog.register_path("obs", str(tmp_path / "obs"))
    net = LocalNetwork()
    net.register(srv)
    client = net.client_for("h1:3101")

    def cook(base):
        return (client.open("dacp://h1:3101/obs").project(keep=False, st=col("station"), t=col("temp"))
                .filter(col("t") > base).group_by("st").agg(hours="count").collect())

    with profile(activities=[ProfilerActivity.CPU]):
        cook(17.5)  # START, then FETCH: a request span each
    cook(18.5)  # the first request after the session turns the recorder off
    assert not trace.ON
    spans = trace.disable().spans
    requests = [s for s in spans if s.name == "request"]
    assert len(requests) == 2 and len({s.request for s in requests}) == 1
    assert {s.request for s in spans} == {requests[0].request}
    assert {"plan", "cook", "morsel", "send"} <= {s.name for s in spans}
    ids = {s.span_id for s in requests}
    for s in spans:
        if s.name in ("send", "plan", "cook"):
            assert s.parent is None or s.parent in ids, s
    assert all(s.parent in ids for s in spans if s.name == "send")
    _check_tree(spans)


def test_torch_profiler_records_only_the_thread_that_started_it():
    """Why the readers take the spans from the recorder and not from the
    profiler's events: a range opened on another thread is not recorded."""
    def other():
        with torch.autograd.profiler.record_function("dacp.other"):
            pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t = threading.Thread(target=other)
        t.start()
        t.join(10)
        with torch.autograd.profiler.record_function("dacp.own"):
            pass
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "dacp.own" in names and "dacp.other" not in names
