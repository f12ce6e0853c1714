"""The program's spans in a traced window, on the profiler's clock, for the
readers in ``metrics/``.

The port's recorder (``repro_torch.trace``) turns itself on at the first
COOK request of a ``torch.profiler`` session and keeps its spans in the
process.  ``of(run)`` takes them once, puts them on the profiler's clock by
the recorder's clock samples (``perf_counter_ns`` against Unix time, which
the profiler stamps its events in), and keeps the result on the run's
``Trace`` as ``spans``.  The readers' window is the recorded part of the
traced one: from the recorder's first clock sample to the window's end.
None where the program has no recorder (a tree before it) or recorded
nothing there.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

# the executor's host work on a COOK: what a worker, the prefetch thread or the merging thread is inside
EXECUTOR_HOST = ("source", "stage", "morsel", "merge", "finalize")


@dataclasses.dataclass
class Window:
    spans: list  # [(name, start ns, end ns, thread CPU ns or None, request id, span id, parent id)], profiler's clock
    lo: int  # the recorded part of the traced window, on the profiler's clock
    hi: int
    idle: list  # [[start, end]]: the part of [lo, hi] in which the card ran nothing
    disagree_ns: int  # the spread of the clock samples' offsets

    def named(self, *names) -> list:
        return [s for s in self.spans if s[0] in names]

    def cooks(self) -> list:
        """Each COOK's interval: its ``cook`` span, or, for a COOK the
        recorder met already running, its executor spans' extent."""
        out = [[s[1], s[2]] for s in self.named("cook")]
        have = {s[4] for s in self.named("cook")}
        extent: dict = {}
        for name, start, end, _cpu, request, *_ids in self.named(*EXECUTOR_HOST):
            if request not in have:
                lo, hi = extent.get(request, (start, end))
                extent[request] = (min(lo, start), max(hi, end))
        return merge(out + [list(v) for v in extent.values()])

    def innermost(self, t: int) -> list:
        """The names of the spans open at ``t`` (profiler's clock) that no
        span open at ``t`` has as its parent, on any thread."""
        open_ = [s for s in self.spans if s[1] <= t < s[2]]
        parents = {s[6] for s in open_}
        return [s[0] for s in open_ if s[5] not in parents]


def of(run) -> Window | None:
    t = run.trace
    if not hasattr(t, "spans"):
        t.spans = window(t, _take())
    return t.spans


def _take():
    try:
        from repro_torch import trace
    except ImportError:
        return None
    return trace.disable()


def window(t, rec) -> Window | None:
    """``rec`` (a ``repro_torch.trace.Recording``) over the traced window of
    ``t`` (a ``harness.Trace``)."""
    if rec is None or not rec.spans or not rec.clock or not t.window_s:
        return None
    # each sample's offset of Unix time from perf_counter_ns, interpolated between samples (in integers
    # around the first: Unix nanoseconds lie past float64's exact integers)
    offsets = [unix - (a + b) // 2 for a, unix, b in rec.clock]
    mids = np.array([(a + b) // 2 for a, _unix, b in rec.clock], np.float64)
    drift = np.array([o - offsets[0] for o in offsets], np.float64)

    def conv(x):
        x = np.asarray(x, np.int64)
        return x + offsets[0] + np.rint(np.interp(x.astype(np.float64), mids, drift)).astype(np.int64)

    t0 = t._t0 * 1e9
    lo, hi = (int(v) for v in conv([max(t0, rec.clock[0][2]), min(t0 + t.window_s * 1e9, rec.clock[-1][0])]))
    if hi <= lo:
        return None
    starts = conv([s.start_ns for s in rec.spans])
    ends = conv([s.end_ns for s in rec.spans])
    spans = [(s.name, int(a), int(b), None if s.cpu_start_ns is None else s.cpu_end_ns - s.cpu_start_ns, s.request,
              s.span_id, s.parent) for s, a, b in zip(rec.spans, starts, ends)]
    idle = subtract([[lo, hi]], merge([[max(s, lo), min(e, hi)] for s, e in t.intervals if e > lo and s < hi]))
    w = Window(spans, lo, hi, idle, max(offsets) - min(offsets))
    inside = sum(1 for s in spans if lo <= s[2] <= hi)
    print(f"perfbench: program spans: {len(spans)} recorded, {inside} ending in the recorded {(hi - lo) * 1e-9:.3f} s "
          f"of the {t.window_s:.3f} s window, {rec.dropped} dropped; clock samples disagree by "
          f"{w.disagree_ns * 1e-3:.1f} us over {len(rec.clock)}", file=sys.stderr)
    return w


# ---------------------------------------------------------------------------
# intervals: lists of [start, end], sorted and disjoint once merged
# ---------------------------------------------------------------------------
def merge(intervals) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def intersect(a: list, b: list) -> list:
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append([s, e])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: list, b: list) -> list:
    out = []
    for s, e in a:
        for bs, be in b:
            if be <= s or bs >= e:
                continue
            if bs > s:
                out.append([s, bs])
            s = max(s, be)
        if s < e:
            out.append([s, e])
    return out


def length(intervals: list) -> int:
    return sum(e - s for s, e in intervals)
