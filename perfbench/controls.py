"""Readings that set a cell's limits: the program's compared numbers over
many seeds, and the control's (the reference in the precision below the
configuration's, as the cell's traffic driver declares it in ``CONTROL``)
on the same requests, in one process.

    python3 perfbench/controls.py --workload <cell> --seeds 11,12,13 --seconds 8

One JSON line a seed: the cell's checks as the run compared them, and the
control's reading beside them.  The benchmark's own runs never compute the
control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    harness.prepare_environment()
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.find_cell(args.workload, seed, args.seconds, False)
        driver = harness.driver(cell)
        t = time.perf_counter()
        run = driver.run(cell, t, control=driver.CONTROL.name)
        line = {"workload": cell.name, "seed": seed, "attempted": run.attempted, "failed": run.failed,
                "checks": {c.name: c.value for c in run.checks}, "limits": {c.name: c.limit for c in run.checks},
                "control": run.facts.get("control"), "samples": run.samples, "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
