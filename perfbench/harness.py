"""The benchmark's core: finds a cell's files by name, keeps the window's
clocks and the trace, and builds the result line.

A cell is ``workloads/<cell>.json`` (its configuration, traffic kind and
traffic parameters).  Its configuration is ``BENCHMARK.json``'s entry of
that name, whose ``file`` holds the sizes.  Its traffic kind is the driver
``traffic/<kind>.py`` (``driver(cell)``), which holds all that the
benchmark's tools and tests know of the kind:

- ``run(cell, t_start, control=None)`` drives the program for the window
  and returns a ``Run``; with ``control`` (its ``CONTROL.name``) it also
  reads the control on the same requests, into ``facts["control"]``;
- ``CONTROL``, a ``Control``: the control's name, the ``Check`` it has to
  fail, and a window that compares as many requests as a run does;
- ``tiny(cell)`` returns the cell at a size a CPU test holds.

Each per-layer metric is the reader ``metrics/<name>.py``, whose
``read(run)`` returns a number or None (nothing to read there).  A new
configuration, traffic kind or mix, or metric is new files and entries in
``BENCHMARK.json``: nothing here names one.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import NamedTuple

from perfbench import spans

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names that may not be loaded
PEAK_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def prepare_environment() -> None:
    """Caches inside the checkout at fixed paths, the program importable,
    and no library loading JAX by itself."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _load(kind: str, name: str):
    """``<kind>/<name>.py`` as a module of its own."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file {path.relative_to(ROOT)}")
    mod_name = f"perfbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def traffic_driver(kind: str):
    return _load("traffic", kind)


def metric_reader(name: str):
    return _load("metrics", name)


class Control(NamedTuple):
    """A traffic kind's control: the reference put in the program's place in
    the precision below the configuration's."""

    name: str  # handed to the driver's run(..., control=name)
    check: str  # the Check whose number the control has to fail
    seconds: float  # a window that finishes and compares as many requests as a run does


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads``, with everything it names read in."""

    name: str
    entry: dict  # the BENCHMARK.json workload entry
    params: dict  # workloads/<name>.json
    config: dict  # the configuration's file
    end_to_end: list  # the metric entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` lists;
    without that key, every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def find_cell(name: str, seed: int, seconds: float, trace: bool, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    params = load_json(BENCH / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, entry, params, load_json(ROOT / conf["file"]), e2e, layer, seed, seconds, trace)


def driver(cell: Cell):
    """The cell's traffic driver, with its ``run``, ``CONTROL`` and ``tiny``."""
    return traffic_driver(cell.params["kind"])


# ---------------------------------------------------------------------------
# clocks and statistics
# ---------------------------------------------------------------------------
def rate(completions, window_start: float, window_end: float):
    """(work per second, units counted): the work of every completion
    (time, work) inside the window over the time from the window's start to
    the last completion inside it; None when nothing completed."""
    inside = [(t, w) for t, w in completions if window_start < t <= window_end]
    if not inside:
        return None, 0
    last = max(t for t, _ in inside)
    return sum(w for _, w in inside) / (last - window_start), len(inside)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------
class Trace:
    """A ``torch.profiler`` window over the measured window or part of it.

    ``start()`` / ``stop()`` bound it.  After ``stop()``: ``kernels`` {name:
    device seconds}, ``launches`` {name: count}, ``busy_s`` (the union of the
    device's activity), ``window_s`` and ``intervals`` (the device's
    activity, merged, ns)."""

    def __init__(self, enabled: bool, host_ops: bool = True):
        self.enabled = enabled
        self.host_ops = host_ops  # False: the card's activity alone (and the CUDA calls that start it)
        self.prof = None
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernels: dict = {}
        self.launches: dict = {}
        self.intervals: list = []
        self.host: list = []  # (start ns, end ns, name) of the host's top-level ops
        self.events = (0, 0)  # device and host events read
        self._t0 = 0.0

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start on a
        process (CUPTI's) takes seconds, which would otherwise fall inside
        the window."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=self._activities(ProfilerActivity)):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def _activities(self, kinds) -> list:
        return [kinds.CPU, kinds.CUDA] if self.host_ops else [kinds.CUDA]

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=self._activities(ProfilerActivity))
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.prof is None:
            return
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        self._read()
        self.prof = None

    def _read(self) -> None:
        from torch.autograd import DeviceType

        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                device.append((start, start + dur))
                self.kernels[e.name()] = self.kernels.get(e.name(), 0.0) + dur * 1e-9
                self.launches[e.name()] = self.launches.get(e.name(), 0) + 1
            else:
                host.append((start, start + dur, e.name()))
        device.sort()
        merged: list = []
        for s, e in device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.intervals = merged
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        self.host = host
        self.events = (len(device), len(host))

    def kernel_seconds(self, *patterns: str) -> float:
        return sum(v for k, v in self.kernels.items() if any(p in k for p in patterns))

    def kernel_launches(self, *patterns: str) -> int:
        return sum(v for k, v in self.launches.items() if any(p in k for p in patterns))

    def breakdown(self, window=None) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the device.  A gap is named by the program's innermost spans
        open through its middle, on any thread (``window``, a
        ``spans.Window``), counted by name, most frequent first; where none
        is open there, by the host operation that was (the outermost one)."""
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        gaps = []
        for (_s0, e0), (s1, _e1) in zip(self.intervals, self.intervals[1:]):
            gaps.append((s1 - e0, e0, s1))
        gaps.sort(reverse=True)
        named = []
        for length, e0, s1 in gaps[:10]:
            mid = (e0 + s1) // 2
            label = _count_names(window.innermost(mid)) if window is not None else ""
            if not label:
                around = [(s, e, n) for s, e, n in self.host if s <= mid <= e]
                label = min(around, key=lambda t: t[0])[2] if around else "host"
            named.append([label[:96], length * 1e-9])
        return {"device_ops": [[k[:96], v] for k, v in ops], "idle_gaps": named}


def _count_names(names) -> str:
    """``stage×3,source``: each name with its count past one, most frequent
    first (then by name)."""
    order = sorted(collections.Counter(names).items(), key=lambda kv: (-kv[1], kv[0]))
    return ",".join(n if k == 1 else f"{n}×{k}" for n, k in order)


# ---------------------------------------------------------------------------
# a run's outcome
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Check:
    """One number compared, beside its limit: correct while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What a traffic driver hands back after its window."""

    attempted: int
    failed: int
    end_to_end: dict  # metric name -> value (the cell's end-to-end metrics)
    checks: list  # [Check]
    memory_peak_bytes: int
    trace: Trace
    facts: dict  # counts from shapes and counters the per-layer readers use
    samples: dict = dataclasses.field(default_factory=dict)  # sample counts, printed to stderr


def device_info(count: int, peak: int, device: str) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count, "memory_peak_bytes": peak}


def result_line(cell: Cell, run: Run, setup_s: float) -> dict:
    """The contract's last line; metrics as measured, with all their digits."""
    metrics: dict = {}
    if cell.trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else run.end_to_end.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = device_info(cell.entry["chips"], run.memory_peak_bytes, cell.device)
    out = {
        "correct": bool(run.checks) and all(c.ok for c in run.checks) and run.failed == 0,
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": dev,
    }
    if cell.trace and run.trace.prof is None and run.trace.enabled:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown(spans.of(run))
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return out


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the modules
    this process has loaded), each compared whole."""
    return sorted({m.split(".", 1)[0] for m in (sys.modules if names is None else names)} & set(FORBIDDEN))
