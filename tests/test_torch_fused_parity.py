"""Fused-chain parity: the port's torch backend (device ``"cpu"``, where
``fused_chain_tiles`` runs its plain PyTorch version) runs eligible
filter → project → segment-fold chains as ONE fused launch per morsel, and
its results are **byte-identical** to the reference ``repro`` numpy
backend's.  These are the fused tests of ``tests/test_backend_parity.py``
and the fused-staging CANCEL test of ``tests/test_executor.py``, driven
with the same numpy arrays through both packages, plus the port's own
envelope rules: -0.0 in float32 min/max, both-NaN operands on small
morsels, the shared-memory refusal and the device binding."""

import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.batch as ref_batch  # noqa: E402
import repro.core.dag as ref_dag  # noqa: E402
import repro.core.executor as ref_executor  # noqa: E402
import repro.core.expr as ref_expr  # noqa: E402
import repro.core.sdf as ref_sdf  # noqa: E402
import repro_torch.core.backend as port_backend  # noqa: E402
import repro_torch.core.batch as port_batch  # noqa: E402
import repro_torch.core.dag as port_dag  # noqa: E402
import repro_torch.core.executor as port_executor  # noqa: E402
import repro_torch.core.expr as port_expr  # noqa: E402
import repro_torch.core.sdf as port_sdf  # noqa: E402
from repro_torch.core.errors import FlowCancelled  # noqa: E402

N_ROWS = 700  # spans multiple kernel tiles (256) incl. a ragged tail
_NAN_A = np.array([0x7FA00001], np.uint32).view(np.float32)[0]
_NAN_B = np.array([0xFFB00002], np.uint32).view(np.float32)[0]


class _Pkg:
    def __init__(self, batch, dag, executor, expr, sdf, cfg):
        self.batch, self.dag, self.executor, self.expr, self.sdf, self.cfg = batch, dag, executor, expr, sdf, cfg


REF = _Pkg(ref_batch, ref_dag, ref_executor, ref_expr, ref_sdf, {"backend": "numpy"})
PORT = _Pkg(port_batch, port_dag, port_executor, port_expr, port_sdf, {"backend": "torch", "device": "cpu"})


def _torch_cpu():
    return port_backend.get_backend("torch", device="cpu")


def _random_arrays(rng, n=N_ROWS):
    """A shuffled mix of fixed-width dtypes + a string key; the float32
    column carries -0.0 and int64 spans the full 64-bit range."""
    f32 = rng.standard_normal(n).astype(np.float32)
    f32[::97] = -0.0
    data = {
        "f32_a": f32,
        "f32_b": (rng.standard_normal(n) * 3).astype(np.float32),
        "f64_c": rng.standard_normal(n),
        "i64_d": rng.integers(-(2**62), 2**62, n),
        "i32_e": rng.integers(0, 9, n).astype(np.int32),
        "u8_f": rng.integers(0, 255, n).astype(np.uint8),
        "f16_g": rng.standard_normal(n).astype(np.float16),
        "bool_h": rng.integers(0, 2, n).astype(bool),
        "tag": np.asarray([f"g{i}" for i in rng.integers(0, 6, n)]),
    }
    names = list(data)
    rng.shuffle(names)
    return {k: data[k] for k in names}


def _batch(pkg, arrays):
    return pkg.batch.RecordBatch.from_pydict({k: v.copy() for k, v in arrays.items()})


def _sdf(pkg, batch, rows=200):
    def gen():
        for s in range(0, batch.num_rows, rows):
            yield batch.slice(s, s + rows)

    return pkg.sdf.StreamingDataFrame(batch.schema, gen)


def _column_bytes(batch):
    out = {}
    for f, c in zip(batch.schema, batch.columns):
        if f.dtype.is_varwidth:
            out[f.name] = (c.offsets.tobytes(), c.data.tobytes())
        else:
            out[f.name] = c.values.tobytes()
    return out


def _assert_byte_identical(a, b):
    if a is None or b is None:
        assert a is b
        return
    assert a.schema.to_json() == b.schema.to_json()
    assert a.num_rows == b.num_rows
    ab, bb = _column_bytes(a), _column_bytes(b)
    for name in ab:
        assert ab[name] == bb[name], f"column {name} differs between backends"


def _chain(links):
    """``links`` = [(op, params_fn(col))] from a source → build_dag(dag, col)."""

    def build(dag, col):
        bld = dag.Dag.build()
        node = bld.source("dacp://h:1/d")
        for op, params in links:
            node = bld.add(op, params(col), [node])
        return bld.finish(node)

    return build


def _fused_run(pkg, build_dag, arrays, **cfg_kw):
    batch = _batch(pkg, arrays)
    stats = pkg.executor.ExecutorStats()
    cfg = pkg.executor.ExecutorConfig(num_workers=2, morsel_rows=200, **{**pkg.cfg, **cfg_kw})
    with np.errstate(all="ignore"):
        out = pkg.executor.execute_parallel(build_dag(pkg.dag, pkg.expr.col), lambda n: _sdf(pkg, batch), cfg,
                                            stats=stats).collect()
    return out, stats


def _port_vs_numpy(build_dag, arrays, **cfg_kw):
    """(port result, port stats, per-op kernel calls during it, numpy result)."""
    bk = _torch_cpu()
    before = bk.kernel_calls
    got, stats = _fused_run(PORT, build_dag, arrays, **cfg_kw)
    calls = bk.kernel_calls - before
    want, _ = _fused_run(REF, build_dag, arrays, **cfg_kw)
    return got, stats, calls, want


# ---------------------------------------------------------------------------
# the reference's fused tests (tests/test_backend_parity.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_fused_chain_random_eligible_chains_parity(seed):
    """Random eligible filter/select/project chains — filter leading or
    mid-chain, computed-of-computed arithmetic, mixed-dtype passthrough —
    run as ONE fused launch per morsel, byte-identical to numpy, with the
    per-op kernels silent."""
    rng = np.random.default_rng(100 + seed)
    arrays = _random_arrays(np.random.default_rng(seed))
    pc, thr = [
        ("f32_a", float(rng.standard_normal())),
        ("i32_e", int(rng.integers(0, 9))),
        ("i64_d", int(rng.integers(-(2**61), 2**61))),
    ][seed % 3]
    cmp_op = ["lt", "le", "gt", "ge", "eq", "ne"][int(rng.integers(6))]
    # pow2 scale: the only mul shape allowed directly under add/sub
    scale = float(2.0 ** int(rng.integers(-3, 4)))
    z_lit = float(rng.standard_normal())
    w_lit = int(rng.integers(1, 5))
    links = [
        ("filter", lambda c: {"predicate": getattr(c(pc), f"__{cmp_op}__")(thr)}),
        ("project", lambda c: {"exprs": {"y": c("f32_a") * scale + c("f32_b"), "z": (c("f32_a") - c("f32_b")) * z_lit,
                                         "w": c("i32_e") * w_lit - 3}, "keep": True}),
        ("project", lambda c: {"exprs": {"y2": c("y") * 0.5}, "keep": True}),  # computed-of-computed
        ("select", lambda c: {"columns": ["y", "y2", "z", "w", "f32_a", "i64_d", "u8_f", "f16_g", "bool_h"]}),
    ]
    if seed % 2:
        links = [links[1], links[2], links[0], links[3]]  # filter mid-chain
    got, stats, calls, want = _port_vs_numpy(_chain(links), arrays)
    _assert_byte_identical(got, want)
    assert stats.progress()["fused_launches"] > 0, "eligible chain did not fuse"
    assert calls == 0, "fused chain still launched per-op kernels"


def test_fused_chain_nan_negzero_payload_parity():
    """-0.0 / NaN / ±Inf payloads ride the fused compaction verbatim, and a
    NaN-poisoned predicate column keeps IEEE comparison semantics."""
    n = 600
    arrays = {
        "a": np.asarray([1.0, -0.0, np.nan, -1.0, np.inf, 0.0] * (n // 6), np.float32),
        "b": np.asarray([-np.inf, np.nan, -0.0, 2.5, -2.5, np.nan] * (n // 6), np.float32),
    }
    links = [("filter", lambda c: {"predicate": c("a") <= 0.0}),
             ("project", lambda c: {"exprs": {"c": c("b") * 2.0}, "keep": True})]
    got, stats, _calls, want = _port_vs_numpy(_chain(links), arrays)
    _assert_byte_identical(got, want)
    assert stats.progress()["fused_launches"] > 0


def test_fused_chain_full_range_int64_parity():
    """Full-range int64 payloads (both 32-bit words live) survive the
    bit-plane passthrough unchanged; the int64 predicate compares as two
    words."""
    rng = np.random.default_rng(21)
    v = rng.integers(-(2**63), 2**63 - 1, 640, dtype=np.int64)
    v[:4] = [2**63 - 1, -(2**63), -1, 0]
    arrays = {"v": v, "k": rng.integers(0, 9, 640).astype(np.int32)}
    links = [("filter", lambda c: {"predicate": c("v") > -(2**62)}), ("select", lambda c: {"columns": ["v", "k"]})]
    got, stats, _calls, want = _port_vs_numpy(_chain(links), arrays)
    _assert_byte_identical(got, want)
    assert stats.progress()["fused_launches"] > 0


def _agg_links(aggs, keys=("i32_e",)):
    return [
        ("filter", lambda c: {"predicate": c("f32_a") > -0.25}),
        ("project", lambda c: {"exprs": {"c": (c("f32_a") - 0.5) * 3.0}, "keep": True}),
        ("aggregate", lambda c: {"keys": list(keys), "aggs": aggs}),
    ]


def test_fused_aggregate_single_launch_per_morsel():
    """filter → project → group-by folds in the SAME launch: the fused
    counter ticks exactly once per morsel and the per-op kernels (filter,
    project, segment-reduce) stay silent."""
    aggs = {
        "n": {"fn": "count"},
        "s64": {"fn": "sum", "column": "i64_d"},
        "sc": {"fn": "sum", "column": "c"},
        "m": {"fn": "mean", "column": "f64_c"},
        "lo": {"fn": "min", "column": "f32_b"},
        "hi": {"fn": "max", "column": "u8_f"},
    }
    got, stats, calls, want = _port_vs_numpy(_chain(_agg_links(aggs)), _random_arrays(np.random.default_rng(23)))
    _assert_byte_identical(got, want)
    assert stats.progress()["fused_launches"] == 4  # 700 rows / 200-row morsels
    assert calls == 0, "fused fold still launched per-op kernels"


def test_fused_chain_composes_with_spill(monkeypatch):
    """Fused folds × grace-hash spill (DACP_MEMORY_BUDGET=256KB): per-morsel
    partials come off the fused launch, the merged state crosses the budget
    and spills, and the result stays byte-identical to the in-memory numpy
    run."""
    rng = np.random.default_rng(24)
    n = 4000
    arrays = {
        "g": rng.permutation(n).astype(np.int64),  # ~200 fresh groups per morsel
        "v": rng.integers(-(2**40), 2**40, n),
        "x": rng.standard_normal(n).astype(np.float32),
    }
    aggs = {"n": {"fn": "count"}, "sv": {"fn": "sum", "column": "v"}, "lo": {"fn": "min", "column": "x"}}
    build = _chain([("filter", lambda c: {"predicate": c("x") > -2.5}),
                    ("aggregate", lambda c: {"keys": ["g"], "aggs": aggs})])
    want, _ = _fused_run(REF, build, arrays)
    monkeypatch.setenv("DACP_MEMORY_BUDGET", "256KB")
    assert port_executor.ExecutorConfig(backend="torch", device="cpu").memory_budget == 256 * 1024
    got, stats = _fused_run(PORT, build, arrays)
    _assert_byte_identical(got, want)
    assert stats.progress()["fused_launches"] > 0, "spill run did not use the fused path"
    assert stats.to_dict()["spill"]["spills"] >= 1, "budget never triggered a spill"


# ---------------------------------------------------------------------------
# the float sums, folded on the device
# ---------------------------------------------------------------------------
_FSUM_CASES = ["order", "zeros-denormals", "one-survivor", "all-survive", "none-survive", "int-mean"]


def _fsum_arrays(case: str):
    """(arrays, aggs, morsels with survivors) of one float-sum case: three
    groups, each six-row pattern whole in one group, four 200-row morsels."""
    rng = np.random.default_rng(60 + _FSUM_CASES.index(case))
    n = N_ROWS
    i = np.arange(n)
    k = (i // 6 % 3).astype(np.int32)
    keep = (rng.random(n) < 0.8).astype(np.int32)
    a = (rng.standard_normal(n) * 30).astype(np.float32)
    b = rng.standard_normal(n) * 1e3
    if case == "order":  # sums the rows' order decides
        a = np.resize(np.array([1e16, 1.0, -1e16, 1.0, 3.0e-8, -0.5], np.float32), n)
        b = np.resize([1e16, 1.0, -1e16, 1.0, 2.0**-30, -1e-300], n)
    elif case == "zeros-denormals":  # group 2: only -0.0
        a = np.resize(np.array([-0.0, 1e-45, -1e-45, 3e-39, -0.0, -2.5e-40], np.float32), n)
        b = np.resize([-0.0, 5e-324, -0.0, 2.2250738585072014e-308, -5e-324, -0.0], n)
        k = np.where(i % 6 == 0, 2, i % 2).astype(np.int32)
    elif case == "one-survivor":  # group 1: one survivor a morsel
        keep[k == 1] = 0
        keep[[int(np.flatnonzero(k[m : m + 200] == 1)[0]) + m for m in range(0, n, 200)]] = 1
    elif case == "all-survive":
        keep[:] = 1
    elif case == "none-survive":  # the second morsel: none
        keep[200:400] = 0
    arrays = {"k": k, "keep": keep, "a": a, "b": b}
    aggs = {"n": {"fn": "count"}, "sa": {"fn": "sum", "column": "a"}, "ma": {"fn": "mean", "column": "a"},
            "sb": {"fn": "sum", "column": "b"}, "mb": {"fn": "mean", "column": "b"}, "sc": {"fn": "sum", "column": "c"}}
    if case == "int-mean":  # integer columns widen to float64, int64 / uint64 past 2^53 to the nearest double
        arrays.update(
            i64=rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64),
            u64=rng.integers(2**63, 2**64 - 1, n, dtype=np.uint64),
            i32=rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32),
            u32=rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
            i8=rng.integers(-128, 128, n).astype(np.int8),
            u16=rng.integers(0, 2**16, n).astype(np.uint16), f16=rng.standard_normal(n).astype(np.float16),
            flag=rng.integers(0, 2, n).astype(bool))
        aggs = {f"m_{c}": {"fn": "mean", "column": c} for c in ("i64", "u64", "i32", "u32", "i8", "u16", "f16", "flag")}
    return arrays, aggs, 3 if case == "none-survive" else 4


def _fsum_chain(aggs):
    return _chain([("filter", lambda c: {"predicate": c("keep") == 1}),
                   ("project", lambda c: {"exprs": {"c": c("a") * 0.5}, "keep": True}),
                   ("aggregate", lambda c: {"keys": ["k"], "aggs": aggs})])


@pytest.mark.parametrize("case", _FSUM_CASES)
def test_fused_float_sums_fold_on_the_device_like_numpy(case):
    """Float sums and means' partial sums of float32, float64, computed
    float32 and integer columns come from the fused launch, bit for bit
    numpy's: sums the rows' order decides (1e16, 1, -1e16), -0.0 and
    denormals (a group of -0.0 alone sums to +0.0), a group with one
    survivor, a morsel where every row or none survives, integers past
    2^53.  ``fsum_device_folds`` counts the morsels with survivors."""
    arrays, aggs, alive = _fsum_arrays(case)
    got, stats, calls, want = _port_vs_numpy(_fsum_chain(aggs), arrays)
    _assert_byte_identical(got, want)
    prog = stats.progress()
    assert prog["fused_launches"] == 4 and calls == 0
    assert prog["fsum_device_folds"] == alive and prog["fsum_host_folds"] == 0
    if case == "zeros-denormals":
        g2 = int(np.flatnonzero(got.column("k").values == 2)[0])
        assert got.column("sa").values[g2 : g2 + 1].tobytes() == np.zeros(1).tobytes()


@pytest.mark.parametrize("special", ["nan", "inf", "both-infs"])
def test_fused_float_sum_over_nan_or_inf_folds_on_the_host(special):
    """A NaN (with a payload) or ±inf survivor in a float-sum column: that
    morsel's sums are folded on the host from the compacted table, as
    before, and give numpy's bits; the other morsels' come from the
    device."""
    arrays, aggs, _alive = _fsum_arrays("all-survive")
    a = arrays["a"]
    if special == "nan":
        a[250] = _NAN_A
    elif special == "inf":
        a[250] = np.inf
    else:
        a[250], a[256] = np.inf, -np.inf  # rows 250 and 256: both in group 2
    got, stats, _calls, want = _port_vs_numpy(_fsum_chain(aggs), arrays)
    _assert_byte_identical(got, want)
    prog = stats.progress()
    assert prog["fused_launches"] == 4
    assert prog["fsum_host_folds"] == 1 and prog["fsum_device_folds"] == 3


@pytest.mark.parametrize("chain", ["fold-without-float-sums", "streaming-run"])
def test_chains_without_float_sums_launch_no_fold(chain, monkeypatch):
    """A fold whose aggregates hold no float sum (count, integer sums,
    min/max) and a streaming filter/project chain pass no float sums to the
    launch, and neither fold counter moves."""
    from repro_torch.kernels import ops

    seen = []
    real = ops.fused_chain_tiles

    def spy(*args, **static):
        seen.append(static["fsums"])
        return real(*args, **static)

    monkeypatch.setattr(ops, "fused_chain_tiles", spy)
    if chain == "fold-without-float-sums":
        aggs = {"n": {"fn": "count"}, "s64": {"fn": "sum", "column": "i64_d"}, "lo": {"fn": "min", "column": "f32_b"},
                "hi": {"fn": "max", "column": "u8_f"}}
        build = _chain(_agg_links(aggs))
    else:
        build = _chain([("filter", lambda c: {"predicate": c("f32_a") > -0.25}),
                        ("project", lambda c: {"exprs": {"c": c("f32_a") * 3.0}, "keep": True}),
                        ("select", lambda c: {"columns": ["c", "f64_c", "i64_d"]})])
    got, stats, _calls, want = _port_vs_numpy(build, _random_arrays(np.random.default_rng(29)))
    _assert_byte_identical(got, want)
    prog = stats.progress()
    assert prog["fused_launches"] == len(seen) == 4 and all(f == () for f in seen)
    assert prog["fsum_device_folds"] == 0 and prog["fsum_host_folds"] == 0


# ---------------------------------------------------------------------------
# staging and CANCEL (tests/test_executor.py)
# ---------------------------------------------------------------------------
def test_cancel_mid_batch_clears_staged_buffers(monkeypatch):
    """CANCEL with coalesced morsels in flight on the fused path: the
    teardown sweeps every staged buffer, including one staged by a worker
    racing the sweep."""
    plans = []
    orig_bind = port_backend.FusedChainPlan.bind

    def spy_bind(self, sizer, device_index=None):
        plans.append(self)
        return orig_bind(self, sizer, device_index)

    high_water = []
    orig_stage = port_backend.FusedChainPlan.stage

    def spy_stage(self, batch):
        orig_stage(self, batch)
        high_water.append(self.staged_count)

    monkeypatch.setattr(port_backend.FusedChainPlan, "bind", spy_bind)
    monkeypatch.setattr(port_backend.FusedChainPlan, "stage", spy_stage)

    n = 60_000
    full = port_batch.RecordBatch.from_pydict(
        {"x": np.random.default_rng(3).standard_normal(n).astype(np.float32), "k": np.arange(n, dtype=np.int64)}
    )
    build = _chain([("filter", lambda c: {"predicate": c("x") > -3.0}), ("select", lambda c: {"columns": ["x", "k"]})])
    cancel = threading.Event()
    base = threading.active_count()
    cfg = port_executor.ExecutorConfig(num_workers=4, morsel_rows="auto", backend="torch", device="cpu")
    out = port_executor.execute_parallel(build(port_dag, port_expr.col), lambda nn: _sdf(PORT, full, rows=150), cfg,
                                         cancel=cancel)
    it = out.iter_batches()
    next(it)  # first morsel out: later morsels are staged/coalesced in flight
    cancel.set()
    with pytest.raises(FlowCancelled):
        for _ in it:
            pass
    deadline = time.time() + 5
    while time.time() < deadline and threading.active_count() > base:
        time.sleep(0.05)  # workers/prefetchers wind down before we inspect
    assert plans, "chain did not compile to a fused plan"
    assert max(high_water, default=0) > 0, "double-buffering never staged a morsel"
    deadline = time.time() + 5
    while time.time() < deadline and any(p.staged_count for p in plans):
        time.sleep(0.05)
    assert all(p.staged_count == 0 for p in plans), "staged buffers leaked past CANCEL"
    # a straggler worker staging after the sweep must be refused, not leaked
    plans[0].stage(full.slice(0, 150))
    assert plans[0].staged_count == 0


def test_staged_morsels_count_as_overlapped_transfers():
    """With workers, every morsel the fused plan launches on was staged
    first: ``transfers_overlapped`` counts them."""
    arrays = _random_arrays(np.random.default_rng(31), n=2000)
    links = [("filter", lambda c: {"predicate": c("i32_e") >= 2}), ("select", lambda c: {"columns": ["f32_a", "u8_f"]})]
    got, stats, _calls, want = _port_vs_numpy(_chain(links), arrays)
    _assert_byte_identical(got, want)
    prog = stats.progress()
    assert prog["fused_launches"] == 10 and prog["transfers_overlapped"] == 10


# ---------------------------------------------------------------------------
# the port's envelope rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("order", ["pos_first", "neg_first"])
@pytest.mark.parametrize("fn", ["min", "max"])
def test_fused_f32_minmax_over_signed_zeros_goes_per_op(fn, order):
    """A float32 min/max group holding both +0.0 and -0.0: numpy keeps the
    later tied zero, the kernel's key would not.  The fused fold refuses
    such a morsel before launch; the per-op path refuses the column too, so
    numpy folds it and the bits match in either row order."""
    zeros = [0.0, -0.0] if order == "pos_first" else [-0.0, 0.0]
    arrays = {
        "k": np.asarray([0, 0] * 100 + [1, 1] * 100, np.int32),
        "v": np.asarray(zeros * 100 + [1.0, -1.0] * 100, np.float32),
        "w": np.arange(400, dtype=np.int32),
    }
    build = _chain([("filter", lambda c: {"predicate": c("w") >= 0}),
                    ("aggregate", lambda c: {"keys": ["k"], "aggs": {"x": {"fn": fn, "column": "v"}}})])
    got, stats, _calls, want = _port_vs_numpy(build, arrays)
    _assert_byte_identical(got, want)
    # morsel 1 (rows 0-199) holds the zeros and goes per-op; morsel 2 fuses
    assert stats.progress()["fused_launches"] == 1, "a morsel holding -0.0 reached the fused fold"
    # without -0.0 both morsels fuse
    arrays["v"] = np.abs(arrays["v"])
    got, stats, _calls, want = _port_vs_numpy(build, arrays)
    _assert_byte_identical(got, want)
    assert stats.progress()["fused_launches"] == 2


def _both_nan_arrays():
    n = 400
    a = np.full(n, 1.5, np.float32)
    b = np.full(n, 2.0, np.float32)
    k = np.zeros(n, np.int32)
    hits = np.arange(3, n, 37)  # ≤ 16 survivors in every 200-row morsel
    a[hits], b[hits], k[hits] = _NAN_A, _NAN_B, 1
    return {"a": a, "b": b, "k": k}


def test_fused_both_nan_operands_project_before_filter_match_numpy():
    """``c = a + b`` with both operands NaN, computed over the whole
    200-row morsel before the filter keeps ≤ 16 rows: numpy's loop returns
    the second operand quieted, and so does the fused kernel."""
    build = _chain([("project", lambda c: {"exprs": {"c": c("a") + c("b")}, "keep": True}),
                    ("filter", lambda c: {"predicate": c("k") == 1})])
    got, stats, _calls, want = _port_vs_numpy(build, _both_nan_arrays())
    _assert_byte_identical(got, want)
    assert stats.progress()["fused_launches"] == 2
    assert (got.column("c").values.view(np.uint32) == 0xFFF00002).all()


def test_fused_both_nan_operands_on_few_survivors_go_per_op():
    """Filter first: numpy evaluates ``a + b`` on the ≤ 16 surviving rows,
    and on arrays that short its loop returns the FIRST NaN operand, where
    the kernels return the second.  The fused plan counts the survivors on
    the host before launch and leaves such a morsel to the per-op path,
    whose project leaves float32 arithmetic on ≤ 16 rows to numpy."""
    arrays = _both_nan_arrays()
    build = _chain([("filter", lambda c: {"predicate": c("k") == 1}),
                    ("project", lambda c: {"exprs": {"c": c("a") + c("b")}, "keep": True})])
    got, stats, _calls, want = _port_vs_numpy(build, arrays)
    _assert_byte_identical(got, want)
    assert got.num_rows == 11
    assert (got.column("c").values.view(np.uint32) == 0x7FE00001).all()  # the first operand, quieted
    assert stats.progress()["fused_launches"] == 0
    # without NaN inputs the two operands cannot differ, and the chain fuses
    arrays["a"][:], arrays["b"][:] = 1.5, 2.0
    got, stats, _calls, want = _port_vs_numpy(build, arrays)
    _assert_byte_identical(got, want)
    assert stats.progress()["fused_launches"] == 2


def test_nan_literal_is_left_to_numpy():
    """``a + nan`` against NaN elements of ``a``: numpy's choice between
    the two depends on the element's place in its loop, so neither the
    planner nor the per-op project takes a NaN literal."""
    arrays = _both_nan_arrays()
    build = _chain([("project", lambda c: {"exprs": {"c": c("a") + float("nan")}, "keep": True}),
                    ("filter", lambda c: {"predicate": c("k") >= 0})])
    got, stats, calls, want = _port_vs_numpy(build, arrays)
    _assert_byte_identical(got, want)
    assert stats.progress()["fused_launches"] == 0 and calls == 2  # the filters; numpy projects


def _wide_sum_plan(n_sums: int):
    arrays = {"k": np.arange(64, dtype=np.int32) % 4, "v": np.arange(64, dtype=np.int64), "x": np.ones(64, np.float32)}
    batch = _batch(PORT, arrays)
    aggs = {f"s{i}": {"fn": "sum", "column": "v"} for i in range(n_sums)}
    pred = port_expr.col("x") > 0.0
    plan = port_backend.plan_fused_chain(
        [("filter", (pred,))], batch.schema, agg=(["k"], aggs, "full", batch.schema), backend=_torch_cpu()
    )
    return plan, arrays, aggs


def test_plan_over_the_shared_memory_footprint_is_refused():
    """28 summed int64 columns need 224 limb accumulators per group: at the
    256-group cap that is 233,472 bytes, above a block's 232,320.  The
    planner refuses the plan before any launch and the chain runs per-op,
    byte-identically; 27 still fuse."""
    plan, arrays, aggs = _wide_sum_plan(28)
    assert plan is None
    ok, _a, _g = _wide_sum_plan(27)
    assert isinstance(ok, port_backend.FusedChainPlan)
    build = _chain([("filter", lambda c: {"predicate": c("x") > 0.0}),
                    ("aggregate", lambda c: {"keys": ["k"], "aggs": aggs})])
    got, stats, _calls, want = _port_vs_numpy(build, arrays)
    _assert_byte_identical(got, want)
    assert stats.progress()["fused_launches"] == 0


def test_device_index_the_host_lacks_raises():
    """``ExecutorConfig.devices`` binds plans to CUDA indices; an index the
    host does not have raises instead of staging somewhere else."""
    import torch

    missing = torch.cuda.device_count() + 64
    plan, arrays, _aggs = _wide_sum_plan(2)
    plan.bind(None, missing)
    with pytest.raises(RuntimeError, match="CUDA device index"):
        plan.stage(_batch(PORT, arrays))
    links = [("filter", lambda c: {"predicate": c("x") > 0.0}), ("select", lambda c: {"columns": ["v"]})]
    with pytest.raises(RuntimeError, match="CUDA device index"):
        _fused_run(PORT, _chain(links), arrays, devices=(missing,))


def test_planner_names_the_torch_backend():
    arrays = _random_arrays(np.random.default_rng(1))
    schema = _batch(PORT, arrays).schema
    specs = [("filter", (port_expr.col("i32_e") > 3,)), ("select", (["i32_e", "f32_a"],))]
    assert isinstance(port_backend.plan_fused_chain(specs, schema, backend=_torch_cpu()), port_backend.FusedChainPlan)
    assert port_backend.plan_fused_chain(specs, schema, backend=port_backend.get_backend("numpy")) is None
    assert port_backend.plan_fused_chain(specs, None, backend=_torch_cpu()) is None
