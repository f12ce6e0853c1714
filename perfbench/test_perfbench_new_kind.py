"""A cell of a traffic kind the benchmark has not seen is new files and
entries alone.  A copy of ``BENCHMARK.json`` and ``perfbench/`` takes a toy
cell (a driver, a workload, a configuration and a per-layer reader, and
their entries); every file that was there stays byte for byte, and on the
copy the layout tests, the cell's CPU run, the JAX probe and the controls'
tool take the new cell."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
KIND, CONFIG, CELL, METRIC = "toy_counts", "toy64", "toy64.counts", "toy_groups_filled"

DRIVER = '''"""Traffic kind ``toy_counts``: counts of seeded group ids through the
port's segment sum, held to ``np.bincount``."""

import time

import numpy as np

from perfbench.harness import Check, Control, Run, Trace

CONTROL = Control("int8", "counts_differing", 0.2)


def tiny(cell):
    return cell


def run(cell, t_start, control=None):
    import torch

    from repro_torch.kernels.segment_reduce import segment_sum_tiles

    conf = cell.config
    ids = np.random.default_rng([cell.seed, 1]).integers(0, conf["groups"], conf["rows"]).astype(np.int32)
    gidx = torch.from_numpy(ids)
    ones = torch.ones((conf["rows"], 1), dtype=torch.int32)
    setup_s = time.perf_counter() - t_start
    done, t0 = [], time.perf_counter()
    while time.perf_counter() < t0 + cell.seconds or not done:
        _sums, counts = segment_sum_tiles(gidx, ones, conf["rows"], conf["groups"])
        done.append((time.perf_counter(), conf["rows"]))
    want = np.bincount(ids, minlength=conf["groups"])
    got = counts.numpy()
    facts = {"setup_s": setup_s, "groups_filled": int((got > 0).sum()), "groups": conf["groups"]}
    if control == CONTROL.name:
        facts["control"] = {CONTROL.check: int((want.astype(np.int8) != want).sum())}
    return Run(attempted=len(done), failed=0, end_to_end={},  # its card metric: no card on the CPU
               checks=[Check("counts_differing", float((got != want).sum()), 0.0)], memory_peak_bytes=0,
               trace=Trace(False), facts=facts)
'''
READER = '''"""toy_groups_filled (%): the groups that some row fell in."""


def read(run):
    if "groups_filled" not in run.facts:
        return None
    return 100.0 * run.facts["groups_filled"] / run.facts["groups"]
'''
FILES = {
    f"perfbench/traffic/{KIND}.py": DRIVER,
    f"perfbench/metrics/{METRIC}.py": READER,
    f"perfbench/configs/{CONFIG}.json": json.dumps({"name": CONFIG, "rows": 16384, "groups": 64, "reduced": []}),
    f"perfbench/workloads/{CELL}.json": json.dumps({"config": CONFIG, "kind": KIND}),
}
ENTRIES = {
    "configs": {"name": CONFIG, "source": "https://numpy.org/doc/stable/reference/generated/numpy.bincount.html",
                "file": f"perfbench/configs/{CONFIG}.json", "reduced": [], "why": "a toy: 16384 ids in 64 groups"},
    "workloads": {"name": CELL, "config": CONFIG, "traffic": "counts", "chips": 1,
                  "why": "a toy: one segment sum after another, the port's plain version"},
    "per_layer": {"name": METRIC, "unit": "%", "better": "higher", "source": "program_counter", "layer": "kernels",
                  "moves": "cook_kernel_ms", "workloads": [CELL]},
}


def add_toy_cell(root: Path) -> None:
    """The toy cell added to the checkout at ``root``: new files, new
    entries, and its name appended to ``cook_kernel_ms``'s cells."""
    for rel, text in FILES.items():
        path = root / rel
        assert not path.exists(), rel
        path.write_text(text)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for section, entry in ENTRIES.items():
        bench[section].append(entry)
    next(m for m in bench["end_to_end"] if m["name"] == "cook_kernel_ms")["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in (root / "perfbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_of_a_new_kind_is_new_files_and_entries_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    before, old = _files(tmp_path), json.loads((tmp_path / "BENCHMARK.json").read_text())
    add_toy_cell(tmp_path)

    after, new = _files(tmp_path), json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert {k: after[k] for k in before} == before and sorted(set(after) - set(before)) == sorted(FILES)
    for m in old["end_to_end"]:
        if m["name"] == "cook_kernel_ms":
            m["workloads"].append(CELL)
    assert set(new) == set(old)
    for section, value in old.items():  # the entries that were there, then the toy's
        if not isinstance(value, list):
            assert new[section] == value, section
            continue
        assert new[section][: len(value)] == value, section
        assert new[section][len(value):] == ([ENTRIES[section]] if section in ENTRIES else []), section

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    tests = ["perfbench/test_perfbench_layout.py"] + [
        f"perfbench/test_perfbench_cells.py::{t}" for t in (
            f"test_a_cell_prints_a_valid_last_line[{CELL}]",
            f"test_a_run_loads_nothing_of_jax_or_the_jax_package[{CELL}]",
            f"test_the_control_names_a_check_that_a_run_makes[{KIND}]")]
    res = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", *tests], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    summary = res.stdout.strip().splitlines()[-1]
    assert re.search(r"\d+ passed", summary) and "skipped" not in summary and "deselected" not in summary, summary

    res = subprocess.run([sys.executable, "perfbench/controls.py", "--workload", CELL, "--seeds", "3,4",
                          "--seconds", "0.2"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert [ln["seed"] for ln in lines] == [3, 4]
    assert all(ln["checks"] == {"counts_differing": 0.0} and ln["control"]["counts_differing"] > 0 for ln in lines)
