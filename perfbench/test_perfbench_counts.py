"""The benchmark's own counts of bytes, against the numbers the
repository's card runs were judged by; the readers of the per-layer
metrics on a run of known numbers; and the rate over the window."""

import pytest

from perfbench import harness
from perfbench.counts import dataplane

# chip_smoke.py's fused aggregate morsel: a filter on one float32 column, one passed-through column, one
# integer sum in limbs and one computed, min f32, max i32, one computed column of each type, every row kept
SMOKE_PLAN = dict(pred_cols=1, pass_cols=1, limb_sums=1, csums=1, min_f32=1, max_i32=1, af_cols=1, ai_cols=1,
                  computed_f32=1, computed_i32=1, with_gidx=True)


def test_fused_chain_morsel_bytes():
    # 65536 rows, 200 groups: 0.00149 ms at 3.35 TB/s
    nbytes = dataplane.fused_chain_bytes(65536, 65536, 256, 200, **SMOKE_PLAN)
    assert nbytes == 4 * 65536 * 15 + 4 * 65536 * 4 + 4 * 256 + 4 * 200 * 16
    assert nbytes / harness.PEAK_HBM_BYTES_PER_S * 1e3 == pytest.approx(0.00149, abs=5e-6)


def test_fused_chain_bytes_of_the_cells_plan():
    plan = harness.load_json(harness.BENCH / "workloads" / "obs16m.fused_agg.json")["fused_plan"]
    # read: predicate, group id, the mean's column, the arithmetic's input; written a survivor: the mean's
    # column, the computed one, the group id; a group: count and first row
    assert dataplane.fused_chain_bytes(1000, 300, 4, 10, **plan) == 4 * 1000 * 4 + 4 * 300 * 3 + 4 * 4 + 4 * 10 * 2


class _Trace:
    kernels = {"fused_chain_kernel<1>": 0.003, "fused_init_kernel": 0.001, "memcpy": 0.5}
    launches = {"fused_chain_kernel<1>": 10, "fused_init_kernel": 10, "memcpy": 40}
    window_s, busy_s, intervals = 2.0, 0.5, [[0, 1]]

    kernel_seconds = harness.Trace.kernel_seconds
    kernel_launches = harness.Trace.kernel_launches


class _Run:
    trace = _Trace()
    facts = {"rows_per_cook": 2000, "survivors_per_cook": 500.0, "tiles_per_cook": 8, "group_slots_per_cook": 20,
             "morsels_per_cook": 5, "cooks": 3, "fused_launches": 12,
             "fused_plan": dict(SMOKE_PLAN, limb_sums=0, csums=0, min_f32=0, max_i32=0, ai_cols=0,
                                computed_i32=0)}


def test_the_per_layer_readers_on_known_numbers():
    per_cook = dataplane.fused_chain_bytes(2000, 500.0, 8, 20, **_Run.facts["fused_plan"])
    want = 100.0 * 10 * per_cook / 5 / harness.PEAK_HBM_BYTES_PER_S / 0.004
    assert harness.metric_reader("fused_chain_roofline").read(_Run()) == pytest.approx(want)
    assert harness.metric_reader("fused_morsel_share").read(_Run()) == pytest.approx(100.0 * 12 / 15)
    assert harness.metric_reader("idle_share.cook").read(_Run()) == pytest.approx(75.0)


def test_a_reader_with_nothing_to_read_returns_nothing():
    class Empty:
        trace = type("T", (), {"kernels": {}, "launches": {}, "window_s": 0.0, "busy_s": 0.0, "intervals": [],
                               "kernel_seconds": harness.Trace.kernel_seconds,
                               "kernel_launches": harness.Trace.kernel_launches})()
        facts = {"cooks": 0, "fused_launches": 0}

    for m in harness.benchmark()["per_layer"]:
        assert harness.metric_reader(m["name"]).read(Empty()) is None, m["name"]


def test_rate_counts_completions_inside_the_window_to_the_last_one():
    done = [(1.0, 10), (2.0, 10), (4.0, 10), (11.0, 10)]
    assert harness.rate(done, 0.0, 10.0) == (30 / 4.0, 3)
    assert harness.rate([(11.0, 5)], 0.0, 10.0) == (None, 0)
