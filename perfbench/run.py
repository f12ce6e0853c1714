"""Run one cell of the benchmark and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  With ``--trace 0`` the line holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics read from a profiled run.
Without the cards, or with a module of JAX or of the JAX package loaded once
the window has closed, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.prepare_environment()
    cell = harness.find_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {cell.name} needs {chips} CUDA card(s), this machine has {have}", file=sys.stderr)
        return 2
    line = run_cell(cell, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: modules loaded that the port may not load: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(line))
    return 0


def run_cell(cell, t_start: float) -> dict:
    """Drive the cell's traffic and build its line; the checks go to
    standard error as its last lines."""
    run = harness.driver(cell).run(cell, t_start)
    line = harness.result_line(cell, run, run.facts["setup_s"])
    if cell.trace:
        print(f"perfbench: trace events read (device, host): {run.trace.events}", file=sys.stderr)
    for name, n in run.samples.items():
        print(f"perfbench: {name}: {n}", file=sys.stderr)
    for c in run.checks:
        print(f"perfbench check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    return line


if __name__ == "__main__":
    sys.exit(main())
