"""The controls on the card, at each cell's own size: the control that the
cell's traffic driver declares (``CONTROL``: the reference put in the
program's place in the precision below the configuration's) fails the check
it names, where the program passes every check, over the window it names.

    python -m pytest -m gpu perfbench/test_perfbench_controls.py   # on the card
"""

import dataclasses
import time

import pytest

from perfbench import harness

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("name", [w["name"] for w in harness.benchmark()["workloads"]])
def test_the_control_fails_where_the_program_passes(cuda_card, name):
    harness.prepare_environment()
    cell = harness.find_cell(name, 2**31 + 101, 0.0, False)
    driver = harness.driver(cell)
    control = driver.CONTROL
    run = driver.run(dataclasses.replace(cell, seconds=control.seconds), time.perf_counter(), control=control.name)
    check = next(c for c in run.checks if c.name == control.check)
    assert all(c.ok for c in run.checks), run.checks
    assert run.facts["control"][control.check] > check.limit, (run.facts["control"], check)
