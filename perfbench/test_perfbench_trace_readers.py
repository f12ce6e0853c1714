"""The readers of the program's spans (``morsel_host_ms``,
``idle_share.executor_host``, ``idle_share.between_cooks``) on a traced
window built by hand, with known device intervals, spans and clock samples;
nothing to read without spans or without the program's recorder; the idle
gaps of ``breakdown`` named by the spans open through them; and, on the
card, a traced run of the cell that reports all three and names its gaps.

    python -m pytest -m gpu perfbench/test_perfbench_trace_readers.py   # on the card
"""

import math
import sys
import time

import pytest

pytest.importorskip("torch")

from perfbench import harness, spans  # noqa: E402
from perfbench import run as bench_run  # noqa: E402
from repro_torch import trace as recorder  # noqa: E402

MS = 1_000_000
OFF = 1_700_000_000 * 1_000_000_000  # the profiler's clock (Unix time) against perf_counter_ns


def _span(name, start_ms, end_ms, cpu_ms, request, span_id=0, parent=None, thread=1):
    cpu = (0, cpu_ms * MS) if cpu_ms is not None else (None, None)
    return recorder.Span(name, start_ms * MS, end_ms * MS, *cpu, thread=thread, span_id=span_id, parent=parent,
                         request=request)


# request 0 was running when the recorder started (no cook span); requests 1 and 2 are whole COOKs
SPANS = [
    _span("morsel", 90, 110, 10, 0),
    _span("cook", 120, 480, None, 1),
    _span("stage", 125, 130, 5, 1),
    _span("morsel", 130, 250, 60, 1),
    _span("launch", 200, 210, 1, 1),
    _span("morsel", 260, 400, 100, 1),
    _span("merge", 400, 420, 20, 1),
    _span("request", 490, 515, 25, 2),
    _span("cook", 520, 1080, None, 2),
    _span("source", 525, 528, 3, 2),
    _span("morsel", 530, 700, 80, 2),
    _span("morsel", 950, 1050, 50, 2),  # ends past the window
]
# the recorder's clock samples: on at 100 ms, off at 1100 ms
CLOCK = [(100 * MS, 100 * MS + OFF, 100 * MS), (1100 * MS, 1100 * MS + OFF, 1100 * MS)]
# the card: busy 50-150 (half of it before the recorded part), 200-300 and 600-650 ms
DEVICE = [[OFF + 50 * MS, OFF + 150 * MS], [OFF + 200 * MS, OFF + 300 * MS], [OFF + 600 * MS, OFF + 650 * MS]]


class _Run:
    def __init__(self, spans_=SPANS, clock=CLOCK, intervals=DEVICE):
        self.trace = harness.Trace(False)
        self.trace._t0, self.trace.window_s, self.trace.intervals = 0.0, 1.0, intervals
        self.trace.spans = spans.window(self.trace, recorder.Recording(list(spans_), clock, 0))


def _read(name, run):
    return harness.metric_reader(name).read(run)


def test_the_window_is_the_recorded_part_on_the_profilers_clock():
    w = _Run().trace.spans
    assert (w.lo, w.hi) == (OFF + 100 * MS, OFF + 1000 * MS)
    assert w.idle == [[OFF + a * MS, OFF + b * MS] for a, b in ((150, 200), (300, 600), (650, 1000))]
    assert w.disagree_ns == 0
    assert w.cooks() == [[OFF + a * MS, OFF + b * MS] for a, b in ((90, 110), (120, 480), (520, 1080))]


def test_morsel_host_ms():
    # stage and morsel spans ending in [100, 1000] ms: CPU 10 + 5 + 60 + 100 + 80 over 4 morsels
    assert _read("morsel_host_ms", _Run()) == pytest.approx(255 / 4)


def test_idle_share_executor_host():
    # idle and inside source/stage/morsel/merge within a COOK: 150-200, 300-420, 525-528, 530-600, 650-700, 950-1000
    assert _read("idle_share.executor_host", _Run()) == pytest.approx(100.0 * (50 + 120 + 3 + 70 + 50 + 50) / 900)


def test_idle_share_between_cooks():
    # idle and no COOK open: 480-520 ms (the request span there is no COOK)
    assert _read("idle_share.between_cooks", _Run()) == pytest.approx(100.0 * 40 / 900)


def test_the_two_idle_shares_sum_to_no_more_than_the_idle_share():
    run = _Run()
    idle = 100.0 * spans.length(run.trace.spans.idle) / 900 / MS
    assert _read("idle_share.executor_host", run) + _read("idle_share.between_cooks", run) <= idle


def test_spans_are_put_on_the_profilers_clock_between_the_samples():
    drift = [(100 * MS, 100 * MS + OFF, 100 * MS), (1100 * MS, 1100 * MS + OFF + 1000, 1100 * MS)]
    w = _Run(clock=drift).trace.spans
    assert w.disagree_ns == 1000
    cook = next(s for s in w.spans if s[0] == "cook" and s[4] == 2)
    assert cook[1] == 520 * MS + OFF + 420 and cook[2] == 1080 * MS + OFF + 980


def test_nothing_to_read_without_spans():
    run = _Run(spans_=[])
    assert run.trace.spans is None
    for name in ("morsel_host_ms", "idle_share.executor_host", "idle_share.between_cooks"):
        assert _read(name, run) is None


def test_nothing_to_read_in_a_tree_without_the_recorder(monkeypatch):
    import repro_torch

    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    monkeypatch.delattr(repro_torch, "trace")
    run = _Run()
    del run.trace.spans
    assert spans._take() is None
    for name in ("morsel_host_ms", "idle_share.executor_host", "idle_share.between_cooks"):
        assert _read(name, run) is None


# a COOK (span 1) with workers on threads 2-4: at 175 ms two stages and a morsel's launch are innermost, at 450 ms
# a source batch and the merge; nothing is open at 825 ms (after the COOK) nor at 30 ms (before the recorder)
GAP_SPANS = [
    _span("launch", 170, 180, 1, 1, span_id=6, parent=2, thread=2),
    _span("stage", 160, 190, 1, 1, span_id=3, parent=1, thread=3),
    _span("stage", 150, 200, 1, 1, span_id=5, parent=1, thread=4),
    _span("morsel", 130, 250, 1, 1, span_id=2, parent=1, thread=2),
    _span("merge", 440, 460, 1, 1, span_id=8, parent=1, thread=3),
    _span("cook", 120, 480, None, 1, span_id=1),
    _span("source", 400, 500, 1, 1, span_id=7, parent=1, thread=5),
]
# the card busy 0-10, 50-150, 200-300, 600-650 and 1000-1010 ms; the host's profiled ops through 700-950 ms
GAP_DEVICE = [[OFF + a * MS, OFF + b * MS] for a, b in ((0, 10), (50, 150), (200, 300), (600, 650), (1000, 1010))]
GAP_HOST = [(OFF + 700 * MS, OFF + 950 * MS, "outer_op"), (OFF + 800 * MS, OFF + 900 * MS, "inner_op")]


def test_idle_gaps_are_named_by_the_innermost_spans_open_through_them():
    run = _Run(spans_=GAP_SPANS, intervals=GAP_DEVICE)
    run.trace.host = GAP_HOST
    gaps = run.trace.breakdown(run.trace.spans)["idle_gaps"]
    assert [g[0] for g in gaps] == ["outer_op", "merge,source", "stage×2,launch", "host"]
    assert [g[1] for g in gaps] == pytest.approx([0.35, 0.30, 0.05, 0.04])
    # without spans, the host's outermost op, else "host"
    assert [g[0] for g in run.trace.breakdown()["idle_gaps"]] == ["outer_op", "host", "host", "host"]


def test_an_idle_gaps_name_is_cut_to_96_characters():
    many = [_span(f"leaf_{i:02d}", 160, 190, 1, 1, span_id=10 + i, thread=10 + i) for i in range(40)]
    run = _Run(spans_=many, intervals=GAP_DEVICE)
    names = [g[0] for g in run.trace.breakdown(run.trace.spans)["idle_gaps"]]
    assert names[2] == ",".join(f"leaf_{i:02d}" for i in range(40))[:96]


@pytest.mark.gpu
def test_a_traced_run_of_the_cell_reports_the_span_metrics(cuda_card):
    harness.prepare_environment()
    cell = harness.find_cell("obs16m.fused_agg", 2**31 + 211, 10.0, True)
    line = bench_run.run_cell(cell, time.perf_counter())
    got = {k: v["value"] for k, v in line["metrics"].items()}
    for name in ("morsel_host_ms", "idle_share.executor_host", "idle_share.between_cooks", "idle_share.cook"):
        assert math.isfinite(got[name]), (name, got)
    assert got["idle_share.executor_host"] + got["idle_share.between_cooks"] <= got["idle_share.cook"] + 0.5
    assert line["correct"] is True
    spans_named = {"request", "plan", "send", "cook", "source", "stage", "morsel", "factorize", "launch", "readback",
                   "decode", "perop", "merge", "finalize"}
    gaps = [name for name, _s in line["breakdown"]["idle_gaps"]]
    assert any(part.split("×")[0] in spans_named for name in gaps for part in name.split(",")), gaps


@pytest.mark.gpu
def test_an_untraced_run_of_the_cell_reads_the_cards_time_a_cook(cuda_card):
    harness.prepare_environment()
    cell = harness.find_cell("obs16m.fused_agg", 2**31 + 223, 10.0, False)
    line = bench_run.run_cell(cell, time.perf_counter())
    assert line["correct"] is True
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values()), line["metrics"]
