"""Each cell driven end to end at a tiny size on the CPU (its traffic
driver's ``tiny``): the look for a card skipped, a valid last line printed;
the check each driver's control has to fail among those its runs make; the
same with the timed path broken underneath, where ``correct`` has to come
out false; the command refusing to run without the card it asks for; and
nothing of JAX or of the JAX package loaded."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from perfbench import harness  # noqa: E402
from perfbench import run as bench_run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def tiny(name: str, seconds: float = 2.0, seed: int = 2**33 + 17):
    """The cell on the CPU at a size a test holds: its code, at the size its
    traffic driver's ``tiny`` gives."""
    cell = harness.find_cell(name, seed, seconds, False)
    cell.device = "cpu"
    return harness.driver(cell).tiny(cell)


def line_of(cell, **kwargs) -> dict:
    run = harness.driver(cell).run(cell, time.perf_counter(), **kwargs)
    return json.loads(json.dumps(harness.result_line(cell, run, run.facts["setup_s"])))


CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
# each traffic kind, with the first cell of it
KINDS = {}
for _name in CELLS:
    KINDS.setdefault(harness.load_json(harness.BENCH / "workloads" / f"{_name}.json")["kind"], _name)


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_prints_a_valid_last_line(name):
    cell = tiny(name)
    line = bench_run.run_cell(cell, time.perf_counter())
    line = json.loads(json.dumps(line))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["metrics"]["setup_s"]["unit"] == "s" and line["metrics"]["setup_s"]["value"] > 0
    reported = {m["name"] for m in cell.end_to_end}
    on_the_host = {m["name"] for m in cell.end_to_end if m["source"] == "host_clock"}  # a CPU run reads no card
    assert on_the_host <= set(line["metrics"]) <= reported
    assert list(line)[-1] == "checks" and all(set(v) == {"value", "limit"} for v in line["checks"].values())


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_control_names_a_check_that_a_run_makes(kind):
    cell = tiny(KINDS[kind], seconds=0.5)
    driver = harness.driver(cell)
    run = driver.run(cell, time.perf_counter())
    assert driver.CONTROL.check in {c.name for c in run.checks}


def _altered_result(monkeypatch):
    """An answer altered where it is produced: the first value of the last
    aggregate of every reply."""
    from repro_torch.core import operators

    real = operators.GroupState.result

    def result(self, out_schema):
        batch = real(self, out_schema)
        batch.columns[-1].values[0] += 1
        return batch

    monkeypatch.setattr(operators.GroupState, "result", result)


def _half_the_morsels(monkeypatch):
    """Half of the work left out: every second morsel's partial state is
    never merged into the COOK's."""
    from repro_torch.core import operators

    real = operators.GroupState.merge_indexed
    seen = [0]

    def merge_indexed(self, other):
        seen[0] += 1
        return real(self, other) if seen[0] % 2 else real(self, type(other)(other.keys, other.aggs, other.mode,
                                                                              other.in_schema))

    monkeypatch.setattr(operators.GroupState, "merge_indexed", merge_indexed)


@pytest.mark.parametrize("fault", [_altered_result, _half_the_morsels])
def test_a_broken_cook_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = line_of(tiny("obs16m.fused_agg"))
    assert line["correct"] is False and line["checks"]["reply_values_differing"]["value"] > 0


def test_the_command_refuses_a_machine_without_the_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", str(2**31 + 3),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and "needs 1 CUDA card" in res.stderr
    assert not [ln for ln in res.stdout.splitlines() if ln.startswith("{")]


def test_the_command_refuses_a_checkout_without_the_program(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", "5", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert not [ln for ln in res.stdout.splitlines() if ln.startswith("{")]


_PROBE = r"""
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {root!r} + "/perfbench")
import test_perfbench_cells as t
from perfbench import harness, run
harness.prepare_environment()
cell = t.tiny({name!r}, seconds=0.5)
run.run_cell(cell, time.perf_counter())
print(json.dumps([harness.forbidden_modules(), sorted({{m.split(".")[0] for m in sys.modules}})]))
"""


@pytest.mark.parametrize("name", CELLS)
def test_a_run_loads_nothing_of_jax_or_the_jax_package(name):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT), name=name)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    forbidden, loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert forbidden == [] and "repro_torch" in loaded
    assert not {"jax", "jaxlib", "flax", "repro"} & set(loaded)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["jaxlike", "repro_torch", "repro_torch.models", "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "jaxlib", "flax", "repro_torch"]) == [
        "flax", "jax", "jaxlib", "repro"]
