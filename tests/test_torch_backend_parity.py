"""Port ↔ reference backend parity: the port's torch backend (on the CPU,
where each kernel runs its plain PyTorch version) must produce RecordBatches
**byte-identical** to the reference ``repro`` numpy backend — filter/select
over every predicate dtype and comparison, multi-dtype projections, project
arithmetic and segment-reduce aggregation, including ``-0.0``, NaN payloads
and full-range int64.  These are the per-op generators of
``tests/test_backend_parity.py`` (the fused-chain ones belong to the next
slice), driven with the same numpy arrays through both packages."""

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.backend as ref_backend  # noqa: E402
import repro.core.batch as ref_batch  # noqa: E402
import repro.core.dag as ref_dag  # noqa: E402
import repro.core.executor as ref_executor  # noqa: E402
import repro.core.expr as ref_expr  # noqa: E402
import repro.core.operators as ref_operators  # noqa: E402
import repro.core.schema as ref_schema  # noqa: E402
import repro.core.sdf as ref_sdf  # noqa: E402
import repro_torch.core.backend as port_backend  # noqa: E402
import repro_torch.core.batch as port_batch  # noqa: E402
import repro_torch.core.dag as port_dag  # noqa: E402
import repro_torch.core.executor as port_executor  # noqa: E402
import repro_torch.core.expr as port_expr  # noqa: E402
import repro_torch.core.operators as port_operators  # noqa: E402
import repro_torch.core.schema as port_schema  # noqa: E402
import repro_torch.core.sdf as port_sdf  # noqa: E402

N_ROWS = 700  # spans multiple kernel tiles (256) incl. a ragged tail


class _Pkg:
    def __init__(self, batch, dag, executor, expr, operators, sdf, backend, cfg):
        self.batch, self.dag, self.executor, self.expr = batch, dag, executor, expr
        self.operators, self.sdf, self.backend, self.cfg = operators, sdf, backend, cfg


REF = _Pkg(ref_batch, ref_dag, ref_executor, ref_expr, ref_operators, ref_sdf, lambda: ref_backend.get_backend("numpy"), {"backend": "numpy"})
PORT = _Pkg(port_batch, port_dag, port_executor, port_expr, port_operators, port_sdf,
            lambda: port_backend.get_backend("torch", device="cpu"), {"backend": "torch", "device": "cpu"})


def _random_arrays(rng, n=N_ROWS):
    """A shuffled mix of fixed-width dtypes + a string key.  The float32
    column carries -0.0; int64 spans the full 64-bit range."""
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


def _run(pkg, build_dag, arrays, **cfg):
    """``build_dag(dag_module, col)`` → Dag, run on ``pkg``'s executor."""
    batch = _batch(pkg, arrays)
    dag = build_dag(pkg.dag, pkg.expr.col)
    config = pkg.executor.ExecutorConfig(num_workers=2, morsel_rows=200, **{**pkg.cfg, **cfg})
    return pkg.executor.execute_parallel(dag, lambda n: _sdf(pkg, batch), config).collect()


def _both(build_dag, arrays, **cfg):
    _assert_byte_identical(_run(REF, build_dag, arrays, **cfg), _run(PORT, build_dag, arrays, **cfg))


def _op_parity(arrays, call, expect_dispatch: bool):
    """Run ``call(backend, batch, col)`` on the port (torch, cpu) and the
    reference numpy backend; checks the port's dispatch count."""
    bk = PORT.backend()
    before = bk.kernel_calls
    got = call(bk, _batch(PORT, arrays), PORT.expr.col)
    assert bk.kernel_calls == before + int(expect_dispatch), "dispatch count"
    want = call(REF.backend(), _batch(REF, arrays), REF.expr.col)
    return got, want


# ---------------------------------------------------------------------------
# fused filter+select
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize(
    "pred_col,sel_cols",
    [
        ("f32_a", ["f32_a", "f32_b"]),  # all-f32 kernel
        ("f64_c", ["f64_c", "i64_d"]),  # f64 predicate: numpy
        ("i64_d", ["f32_a", "tag"]),  # string in projection: numpy
        ("i64_d", ["i64_d", "f64_c", "u8_f"]),  # i64 predicate, mixed planes
        ("i32_e", ["i32_e", "f16_g", "bool_h"]),  # i32 predicate, narrow cols
    ],
)
def test_filter_select_parity(seed, pred_col, sel_cols):
    def build(dag, col):
        bld = dag.Dag.build()
        s = bld.source("dacp://h:1/d")
        f = bld.add("filter", {"predicate": col(pred_col) > 0.25}, [s])
        return bld.finish(bld.add("select", {"columns": sel_cols}, [f]))

    _both(build, _random_arrays(np.random.default_rng(seed)))


@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge", "eq", "ne"])
@pytest.mark.parametrize("pred_col,threshold", [("f32_a", 0.25), ("i32_e", 4), ("i64_d", 0)])
def test_comparison_set_parity(op, pred_col, threshold):
    """Every comparison × predicate dtype dispatches AND stays
    byte-identical (eq/ne exercise the padded-tail row masking)."""
    arrays = _random_arrays(np.random.default_rng(3))
    got, want = _op_parity(
        arrays,
        lambda bk, b, col: bk.filter_select(b, getattr(col(pred_col), f"__{op}__")(threshold), [pred_col, "f32_b"]),
        True,
    )
    _assert_byte_identical(got, want)


def test_eq_matches_exact_int64_value():
    arrays = _random_arrays(np.random.default_rng(11))
    target = int(arrays["i64_d"][123])
    got, want = _op_parity(arrays, lambda bk, b, col: bk.filter_select(b, col("i64_d") == target, ["i64_d"]), True)
    _assert_byte_identical(got, want)
    assert got.num_rows >= 1


def test_negative_zero_is_bit_exact():
    data = np.asarray([-0.0, 1.0, -0.0, -1.0, 0.0] * 60, np.float32)
    arrays = {"a": data, "b": data[::-1].copy()}
    got, want = _op_parity(arrays, lambda bk, b, col: bk.filter_select(b, col("a") <= 0.0, ["a", "b"]), True)
    _assert_byte_identical(got, want)
    assert np.signbit(got.column("a").values).any()


@pytest.mark.parametrize("which", [0, 1, 2])
def test_nonfinite_dispatches_bit_exact(which):
    data = np.asarray([1.0, np.inf, -1.0, np.nan, 2.0] * 60, np.float32)
    data[3::50] = np.array([0x7FA00001], np.uint32).view(np.float32)[0]
    arrays = {"a": data, "b": data[::-1].copy()}
    preds = [lambda c: c("a") > 0.5, lambda c: c("a") != 1.0, lambda c: c("a") <= 0.5]
    got, want = _op_parity(arrays, lambda bk, b, col: bk.filter_select(b, preds[which](col), ["a", "b"]), True)
    _assert_byte_identical(got, want)


@pytest.mark.parametrize("threshold", [5, np.int64(5), np.float32(0.5), np.float16(0.5), np.float64(0.25)])
def test_numpy_typed_literals_dispatch(threshold):
    arrays = _random_arrays(np.random.default_rng(5))
    got, want = _op_parity(arrays, lambda bk, b, col: bk.filter_select(b, col("f32_a") > threshold, ["f32_a"]), True)
    _assert_byte_identical(got, want)


@pytest.mark.parametrize("pred,dispatch", [(("gt", 2.5), True), (("le", 2.5), True), (("lt", 4.5), True), (("ge", 4.5), True), (("eq", 2.5), False)])
def test_float_literal_on_int_column_rewrites(pred, dispatch):
    """``i32 > 2.5`` rewrites to the integer comparison and dispatches;
    ``i32 == 2.5`` (a constant mask) stays on numpy."""
    arrays = _random_arrays(np.random.default_rng(6))
    op, t = pred
    got, want = _op_parity(
        arrays, lambda bk, b, col: bk.filter_select(b, getattr(col("i32_e"), f"__{op}__")(t), ["i32_e"]), dispatch
    )
    _assert_byte_identical(got, want)


def test_unsupported_shapes_stay_on_numpy():
    """f64 predicates, masked columns and var-width projections run the
    (bit-identical) numpy kernel, with no launch."""
    arrays = _random_arrays(np.random.default_rng(8))
    got, want = _op_parity(arrays, lambda bk, b, col: bk.filter_select(b, col("f64_c") > 0, ["i64_d", "f64_c"]), False)
    _assert_byte_identical(got, want)
    got, want = _op_parity(arrays, lambda bk, b, col: bk.filter_select(b, col("i64_d") > 0, ["tag"]), False)
    _assert_byte_identical(got, want)
    bk = PORT.backend()
    b = _batch(PORT, arrays)
    masked = port_batch.Column.from_values(b.schema.field("f32_a").dtype, b.column("f32_a").values)
    masked.validity = np.ones(b.num_rows, bool)
    before = bk.kernel_calls
    bk.filter_select(b.with_column(b.schema.field("f32_a"), masked), port_expr.col("f32_a") > 0.0, ["f32_a"])
    assert bk.kernel_calls == before


# ---------------------------------------------------------------------------
# project arithmetic
# ---------------------------------------------------------------------------
_PROJECTS = [
    (lambda c: {"y": c("f32_a") * 2.0 + 1.1}, True),
    (lambda c: {"y": c("f32_a") / c("f32_b"), "z": c("f32_a") - c("f32_b") * 0.5}, True),
    (lambda c: {"w": c("i32_e") * 3 - 7}, False),
    (lambda c: {"y": (c("f32_a") + c("f32_b")) * (c("f32_a") - 2.0)}, True),
    (lambda c: {"y": c("f32_a") * 2.5, "d": c("f64_c") + 1.0}, True),  # f64 expr → numpy per expr
]


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("case", range(len(_PROJECTS)))
def test_project_parity(seed, case):
    exprs_fn, keep = _PROJECTS[case]

    def build(dag, col):
        bld = dag.Dag.build()
        s = bld.source("dacp://h:1/d")
        return bld.finish(bld.add("project", {"exprs": exprs_fn(col), "keep": keep}, [s]))

    _both(build, _random_arrays(np.random.default_rng(seed)))


def _project_call(exprs_fn):
    def call(bk, b, col):
        pkg = PORT if bk is PORT.backend() else REF
        exprs = exprs_fn(col)
        return bk.project(b, exprs, pkg.operators.project_schema(b.schema, exprs, True))

    return call


def test_project_kernel_dispatches():
    arrays = _random_arrays(np.random.default_rng(9))
    got, want = _op_parity(arrays, _project_call(lambda c: {"y": c("f32_a") * 2.0 + 1.0}), True)
    _assert_byte_identical(got, want)


def test_project_division_by_zero_parity():
    a = np.asarray([1.0, -1.0, 0.0, 2.0, np.inf, np.nan] * 50, np.float32)
    b = np.asarray([0.0, 0.0, 0.0, 1.0, np.inf, 1.0] * 50, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        got, want = _op_parity(
            {"a": a, "b": b},
            _project_call(lambda c: {"q": c("a") / c("b"), "r": c("a") - c("b"), "s": c("a") * c("b")}),
            True,
        )
    _assert_byte_identical(got, want)  # inf and nan bit patterns included


def test_project_denormals_and_nan_payloads_parity():
    a = np.asarray([1e-45, -1e-45, 3e-39, 0.0, 5.0] * 60, np.float32)
    a[::7] = np.array([0x7FA00001], np.uint32).view(np.float32)[0]
    b = np.asarray([0.0, 1e-45, -3e-39, 1e-45, np.inf] * 60, np.float32)
    b[::11] = np.array([0xFFB00002], np.uint32).view(np.float32)[0]
    with np.errstate(all="ignore"):
        got, want = _op_parity(
            {"a": a, "b": b},
            _project_call(lambda c: {"q": c("a") / c("b"), "r": c("a") - c("b") * 2.0, "s": (c("a") + c("b")) * 0.5}),
            True,
        )
    _assert_byte_identical(got, want)


@pytest.mark.parametrize("rows,dispatch", [(10, False), (16, False), (17, True), (300, True)])
def test_project_both_nan_operands_match_numpy_at_any_length(rows, dispatch):
    """numpy returns the first of two NaN operands on arrays of ≤ 16
    elements and the second (add, mul) on longer ones; the kernel applies
    the long rule, so float32 projections of ≤ 16 rows stay on numpy."""
    a = np.full(rows, np.array([0x7FA00001], np.uint32).view(np.float32)[0])
    b = np.full(rows, np.array([0xFFB00002], np.uint32).view(np.float32)[0])
    with np.errstate(invalid="ignore"):
        got, want = _op_parity(
            {"a": a, "b": b}, _project_call(lambda c: {"s": c("a") + c("b"), "p": c("a") * c("b")}), dispatch
        )
    _assert_byte_identical(got, want)


def test_project_int32_wraps_like_numpy():
    a = np.asarray([2**31 - 1, -(2**31), 65536, -7] * 70, np.int32)
    got, want = _op_parity(
        {"a": a, "b": a[::-1].copy()}, _project_call(lambda c: {"m": c("a") * c("b") + 1, "d": c("a") - c("b")}), True
    )
    _assert_byte_identical(got, want)


# ---------------------------------------------------------------------------
# aggregation (segment-reduce kernels)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("key", ["i32_e", "tag"])
def test_filter_aggregate_parity(seed, key):
    def build(dag, col):
        bld = dag.Dag.build()
        s = bld.source("dacp://h:1/d")
        f = bld.add("filter", {"predicate": col("f32_a") > -0.5}, [s])
        aggs = {
            "n": {"fn": "count"},
            "s64": {"fn": "sum", "column": "i64_d"},
            "m": {"fn": "mean", "column": "f64_c"},
            "lo": {"fn": "min", "column": "f32_b"},
            "hi": {"fn": "max", "column": "i32_e"},
            "s8": {"fn": "sum", "column": "u8_f"},
        }
        return bld.finish(bld.add("aggregate", {"keys": [key], "aggs": aggs}, [f]))

    _both(build, _random_arrays(np.random.default_rng(seed)))


def _group_states(arrays, keys, aggs, batches=None):
    """Fold ``batches`` (default: one batch of ``arrays``) into a port
    GroupState on the torch backend and a reference one on numpy."""
    bk = PORT.backend()
    batches = batches or [arrays]
    pb = [_batch(PORT, a) for a in batches]
    rb = [_batch(REF, a) for a in batches]
    st = port_operators.GroupState(keys, aggs, "full", pb[0].schema, vectorized=True, backend=bk)
    ref = ref_operators.GroupState(keys, aggs, "full", rb[0].schema, vectorized=True)
    before = bk.kernel_calls
    with np.errstate(over="ignore"):
        for p, r in zip(pb, rb):
            st.update(p)
            ref.update(r)
    assert st.key_rows == ref.key_rows
    for name in ref.acc:
        assert st.acc[name].dtype == ref.acc[name].dtype, name
        assert st.acc[name].tobytes() == ref.acc[name].tobytes(), name
    return bk.kernel_calls - before


def test_segment_reduce_kernel_dispatches():
    arrays = _random_arrays(np.random.default_rng(10))
    aggs = {"n": {"fn": "count"}, "s": {"fn": "sum", "column": "i64_d"}, "hi": {"fn": "max", "column": "i32_e"}}
    assert _group_states(arrays, ["i32_e"], aggs) == 1


def test_segment_reduce_int64_wraparound_parity():
    big = np.asarray([2**62, 2**62, 2**62, -(2**61)] * 64, np.int64)
    keys = np.asarray([0, 1, 0, 1] * 64, np.int32)
    assert _group_states({"k": keys, "v": big}, ["k"], {"s": {"fn": "sum", "column": "v"}}) == 1


def test_segment_reduce_nan_minmax_stays_on_numpy():
    vals = np.asarray([1.0, np.nan, -2.0, 3.0] * 64, np.float32)
    keys = np.asarray([0, 0, 1, 1] * 64, np.int32)
    assert _group_states({"k": keys, "v": vals}, ["k"], {"lo": {"fn": "min", "column": "v"}}) == 0


@pytest.mark.parametrize("order", ["pos_first", "neg_first"])
@pytest.mark.parametrize("fn", ["min", "max"])
def test_segment_reduce_mixed_signed_zero_group(order, fn):
    """A float32 min/max group holding both +0.0 and -0.0: numpy's
    sequential fold keeps whichever tied zero comes later, while the
    kernel's order-preserving key would always pick -0.0 for min and +0.0
    for max.  The port declares such a column ineligible before launch, so
    the group's bits match numpy in either row order."""
    zeros = [0.0, -0.0] if order == "pos_first" else [-0.0, 0.0]
    vals = np.asarray(zeros * 64 + [1.0, -1.0] * 64, np.float32)
    keys = np.asarray([0, 0] * 64 + [1, 1] * 64, np.int32)
    launched = _group_states({"k": keys, "v": vals}, ["k"], {"x": {"fn": fn, "column": "v"}})
    assert launched == 0


def test_segment_reduce_f32_minmax_without_negative_zero_dispatches():
    vals = np.asarray([0.0, 1.5, -2.0, 3.0] * 64, np.float32)
    keys = np.asarray([0, 0, 1, 1] * 64, np.int32)
    aggs = {"lo": {"fn": "min", "column": "v"}, "hi": {"fn": "max", "column": "v"}}
    assert _group_states({"k": keys, "v": vals}, ["k"], aggs) == 1


def test_masked_keys_still_use_value_kernel():
    from repro.core import dtypes as rdt
    from repro_torch.core import dtypes as pdt

    bk = PORT.backend()
    out = []
    for batch_mod, dt, schema_mod, ops_mod, backend in (
        (port_batch, pdt, port_schema, port_operators, bk),
        (ref_batch, rdt, ref_schema, ref_operators, None),
    ):
        schema = schema_mod.Schema([schema_mod.Field("k", dt.INT64), schema_mod.Field("v", dt.INT64)])
        kc = batch_mod.Column.from_values(dt.INT64, [1, 1, 2, 2] * 64)
        kc.validity = np.asarray([True, False, True, True] * 64)
        vc = batch_mod.Column.from_values(dt.INT64, list(range(256)))
        aggs = {"s": {"fn": "sum", "column": "v"}, "n": {"fn": "count"}}
        st = ops_mod.GroupState(["k"], aggs, "full", schema, vectorized=True, backend=backend)
        before = bk.kernel_calls
        st.update(batch_mod.RecordBatch(schema, [kc, vc]))
        out.append((st, bk.kernel_calls - before))
    (st, calls), (ref, _) = out
    assert calls == 1
    assert st.key_rows == ref.key_rows
    assert st.acc["s"].tobytes() == ref.acc["s"].tobytes() and st.acc["n"].tobytes() == ref.acc["n"].tobytes()


def test_segment_reduce_int64_minmax_two_word_parity():
    rng = np.random.default_rng(17)
    vals = rng.integers(-(2**63), 2**63 - 1, 512, dtype=np.int64)
    vals[1::4] = vals[::4] | np.int64(1)  # hi-word ties: the lo-word pass decides
    keys = rng.integers(0, 9, 512).astype(np.int32)
    aggs = {"lo": {"fn": "min", "column": "v"}, "hi": {"fn": "max", "column": "v"}}
    assert _group_states({"k": keys, "v": vals}, ["k"], aggs) == 1


def test_segment_reduce_uint32_minmax_parity():
    rng = np.random.default_rng(18)
    vals = rng.integers(0, 2**32 - 1, 512, dtype=np.uint32)
    keys = rng.integers(0, 5, 512).astype(np.int32)
    assert _group_states({"k": keys, "v": vals}, ["k"], {"hi": {"fn": "max", "column": "v"}}) == 1


def test_segment_reduce_uint64_minmax_parity():
    rng = np.random.default_rng(19)
    vals = rng.integers(0, 2**64 - 1, 512, dtype=np.uint64)
    vals[:4] = [1, 2**63 + 5, 2**64 - 1, 0]
    keys = rng.integers(0, 7, 512).astype(np.int32)
    keys[:4] = 0
    aggs = {"lo": {"fn": "min", "column": "v"}, "hi": {"fn": "max", "column": "v"}}
    assert _group_states({"k": keys, "v": vals}, ["k"], aggs) == 1


def test_segment_reduce_float64_minmax_parity():
    rng = np.random.default_rng(20)
    vals = rng.standard_normal(512) * 10.0 ** rng.integers(-200, 200, 512)
    vals[:4] = [np.inf, -np.inf, 5e-324, -5e-324]
    keys = rng.integers(0, 6, 512).astype(np.int32)
    keys[:4] = 1
    aggs = {"lo": {"fn": "min", "column": "v"}, "hi": {"fn": "max", "column": "v"}}
    assert _group_states({"k": keys, "v": vals}, ["k"], aggs) == 1


def test_segment_reduce_float64_sentinels_on_absent_groups():
    b1 = {"k": np.asarray([0, 1, 2, 3] * 64, np.int32), "v": np.arange(256, dtype=np.float64) - 128.0}
    b2 = {"k": np.asarray([1, 3] * 128, np.int32), "v": -(np.arange(256, dtype=np.float64)) * 7.5}
    aggs = {"lo": {"fn": "min", "column": "v"}, "hi": {"fn": "max", "column": "v"}}
    assert _group_states(b1, ["k"], aggs, batches=[b1, b2]) >= 1  # b2 holds -0.0: numpy folds it


@pytest.mark.parametrize("poison", ["nan", "negzero"])
def test_segment_reduce_float64_nan_negzero_stay_on_numpy(poison):
    vals = np.arange(256, dtype=np.float64)
    vals[7] = np.nan if poison == "nan" else -0.0
    keys = np.asarray([0, 1] * 128, np.int32)
    assert _group_states({"k": keys, "v": vals}, ["k"], {"lo": {"fn": "min", "column": "v"}}) == 0


def test_float_sums_take_f64_reference_path():
    arrays = _random_arrays(np.random.default_rng(19))
    aggs = {
        "sf": {"fn": "sum", "column": "f32_a"},
        "sd": {"fn": "sum", "column": "f64_c"},
        "m": {"fn": "mean", "column": "f64_c"},
    }
    bk = PORT.backend()
    before = bk.f64_folds
    _group_states(arrays, ["i32_e"], aggs)
    assert bk.f64_folds == before + 3, "float sums fell back silently"


def test_spill_composes_with_torch_backend():
    def build(dag, col):
        bld = dag.Dag.build()
        s = bld.source("dacp://h:1/d")
        aggs = {
            "n": {"fn": "count"},
            "s64": {"fn": "sum", "column": "i64_d"},
            "sf": {"fn": "sum", "column": "f32_a"},
            "lo64": {"fn": "min", "column": "i64_d"},
        }
        return bld.finish(bld.add("aggregate", {"keys": ["tag"], "aggs": aggs}, [s]))

    arrays = _random_arrays(np.random.default_rng(20), n=2000)
    bk = PORT.backend()
    before = bk.kernel_calls
    stats = port_executor.ExecutorStats()
    batch = _batch(PORT, arrays)
    cfg = port_executor.ExecutorConfig(num_workers=2, morsel_rows=200, backend="torch", device="cpu", memory_budget=1)
    got = port_executor.execute_parallel(build(port_dag, port_expr.col), lambda n: _sdf(PORT, batch), cfg, stats=stats).collect()
    assert bk.kernel_calls > before, "spilling disabled kernel dispatch"
    assert stats.to_dict()["spill"]["spills"] >= 1
    _assert_byte_identical(got, _run(REF, build, arrays))


def test_auto_backend_is_torch_and_cuda_is_explicit():
    import torch

    assert port_backend.get_backend("auto", device="cpu") is PORT.backend()
    assert port_backend.plan_fused_chain([], None, backend=PORT.backend()) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port_backend.get_backend("torch")
        with pytest.raises(RuntimeError, match="cuda"):
            port_backend.get_backend("torch", device="cuda")
