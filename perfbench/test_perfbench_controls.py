"""The controls on the card, at each cell's own size: the reference put in
the program's place in the precision below the configuration's (float32
sums for the float64 sums and means) fails the cell's comparison, where the
program passes it.

    python -m pytest -m gpu perfbench/test_perfbench_controls.py   # on the card
"""

import time

import pytest

from perfbench import harness

pytestmark = pytest.mark.gpu

CONTROLS = {"cook": ("float32", "reply_values_differing")}
# a window that finishes and compares as many requests as a run does
SECONDS = {"obs16m.fused_agg": 25.0}


@pytest.mark.parametrize("name", [w["name"] for w in harness.benchmark()["workloads"]])
def test_the_control_fails_where_the_program_passes(cuda_card, name):
    harness.prepare_environment()
    cell = harness.find_cell(name, 2**31 + 101, SECONDS.get(name, 25.0), False)
    control, number = CONTROLS[cell.params["kind"]]
    run = harness.traffic_driver(cell.params["kind"]).run(cell, time.perf_counter(), control=control)
    check = next(c for c in run.checks if c.name == number)
    assert all(c.ok for c in run.checks), run.checks
    assert run.facts["control"][number] > check.limit, (run.facts["control"], check)
