"""The port's CUDA kernels on the card: each against its plain PyTorch
version (run on the CPU, bit for bit) at the widest morsel the backend hands
it, and the torch backend on ``cuda`` against the reference numpy backend.

Needs a CUDA card; skips without one.  On the card:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, filter_select, project_arith, segment_reduce  # noqa: E402

pytestmark = pytest.mark.gpu

N = 262144  # SUM_ROW_CAP rows
TILE = 256


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU form")
    return torch.device("cuda", 0)


def _bits(t) -> bytes:
    return t.detach().cpu().contiguous().numpy().tobytes()


def _f32(rng, n):
    v = (rng.standard_normal(n) * 10).astype(np.float32)
    v[::97] = -0.0
    v[1::101] = np.nan
    v[2::103] = np.array([0x7FA00001], np.uint32).view(np.float32)[0]
    v[3::107] = np.inf
    v[4::109] = -np.inf
    v[5::113] = np.float32(1e-45)
    return v


@pytest.mark.parametrize("kind", filter_select.KINDS)
@pytest.mark.parametrize("op", filter_select.OPS)
def test_filter_select_kernel(dev, op, kind):
    rng = np.random.default_rng(filter_select.OPS.index(op) * 3 + filter_select.KINDS.index(kind))
    if kind == "f32":
        pred = _f32(rng, N).view(np.int32).reshape(N, 1)
        t_hi, t_lo = int(np.array([0.5], np.float32).view(np.int32)[0]), 0
    elif kind == "i32":
        pred = rng.integers(-50, 50, N).astype(np.int32).reshape(N, 1)
        t_hi, t_lo = 3, 0
    else:
        v = rng.integers(-(2**63), 2**63 - 1, N, dtype=np.int64)
        v[::7] = v[10]
        pred = np.stack([(v >> 32).astype(np.int32), (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)], axis=1)
        lo = (int(v[10]) & 0xFFFFFFFF) ^ 0x80000000
        t_hi, t_lo = int(v[10]) >> 32, lo - 2**32 if lo >= 2**31 else lo
    table = rng.integers(-(2**31), 2**31, size=(N, 8), dtype=np.int64).astype(np.int32)
    scalars = np.array([N - 100, t_hi, t_lo], np.int32)
    p, t = torch.from_numpy(pred), torch.from_numpy(table)
    got = filter_select.filter_select_planes(p.to(dev), t.to(dev), scalars, op, kind, TILE)
    want = filter_select.filter_select_planes_plain(p, t, scalars, op, kind, TILE)
    assert filter_select.launches.value > 0
    for g, w in zip(got, want):
        assert _bits(g) == _bits(w)


def _project_tree(rng, depth: int, d: int, ops: tuple, lits: tuple):
    if depth <= 1 or rng.random() < 0.2:
        if rng.random() < 0.7:
            return ("col", int(rng.integers(d)))
        return ("lit", lits[int(rng.integers(len(lits)))])
    op = ops[int(rng.integers(len(ops)))]
    return (op, _project_tree(rng, depth - 1, d, ops, lits), _project_tree(rng, depth - 1, d, ops, lits))


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "view4"])
@pytest.mark.parametrize("n", [TILE, N], ids=["one_tile", "wide"])
@pytest.mark.parametrize("k", [1, 3, 33])
@pytest.mark.parametrize("d", [1, 2, 11])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_project_kernel(dev, dtype, d, k, n, offset):
    """Every row's K outputs from D columns, the first tree holding
    STACK_MAX values at once; ``offset`` 1 starts the table 4 bytes past a
    16-byte boundary."""
    rng = np.random.default_rng(1000 * d + 10 * k + offset + (n == N))
    if dtype == "float32":
        table = np.stack([_f32(rng, n) for _ in range(d)], axis=1)
        table[::5, -1] = 0.0
        ops, lits = ("add", "sub", "mul", "div"), (273.15, 0.5, -1013.0, 1e-3, 3.0)
        fixed = (
            ("add", ("col", 0), ("lit", 273.15)),
            ("sub", ("mul", ("col", 1), ("lit", 0.5)), ("lit", 1013.0)),
            ("div", ("col", 0), ("col", 1)),
            ("mul", ("sub", ("col", 0), ("col", 1)), ("add", ("col", 1), ("lit", 1e-3))),
        )
    else:
        table = rng.integers(-(2**31), 2**31, size=(n, d), dtype=np.int64).astype(np.int32)
        table[:3] = [-(2**31)], [2**31 - 1], [-1]
        ops, lits = ("add", "sub", "mul"), (3, 1, -7, 2**31 - 1, -(2**31))
        fixed = (("mul", ("col", 0), ("col", 1)), ("add", ("mul", ("col", 0), ("lit", 3)), ("lit", 1)))
    deep = ("col", d - 1)
    for i in range(project_arith.STACK_MAX - 1):
        deep = (ops[i % len(ops)], ("col", i % d), deep)
    # the deepest tree, the COOK's projections where the table has two
    # columns, then random trees
    descrs = ([deep] + list(fixed if d > 1 else ()))[:k]
    while len(descrs) < k:
        t = _project_tree(rng, 5, d, ops, lits)
        if project_arith.fits(t, dtype):
            descrs.append(t)
    descrs = tuple(descrs)
    t = torch.from_numpy(table)
    flat = torch.zeros(n * d + offset, dtype=t.dtype, device=dev)
    flat[offset:] = t.reshape(-1).to(dev)
    view = flat[offset:].view(n, d)
    assert view.data_ptr() % 16 == 4 * offset
    got = project_arith.project_tiles(view, descrs, TILE)
    want = project_arith.project_tiles_plain(t, descrs, TILE)
    assert project_arith.launches.value > 0
    assert _bits(got) == _bits(want)


def _slot_word(kind, slot, arg=0):
    return kind | (slot << 4) | (arg << 8)


_PA = project_arith
# Each breaks the annotated program of ("div", col 0, col 1) stored to
# column 0, run as float32 over a (256, 2) table: (instruction, new word),
# or the whole program and the dtype flag it is sent with
_BAD_PROGRAMS = {
    "push_slot": (1, _slot_word(_PA.I_COL, 0, 1)),
    "op_slot": (2, _slot_word(_PA.I_DIV, 1)),
    "store_slot": (3, _slot_word(_PA.I_STORE, 1, 0)),
    "column_out_of_range": (1, _slot_word(_PA.I_COL, 1, 2)),
    "store_out_of_range": (3, _slot_word(_PA.I_STORE, 0, 1)),
    "op_argument": (2, _slot_word(_PA.I_DIV, 0, 1)),
    "unknown_kind": (2, _slot_word(7, 0)),
    "push_without_literal_bit": (1, _slot_word(_PA.I_LIT, 1)),
    "stack_left_over": (3, _slot_word(_PA.I_LIT | _PA.LIT_BIT, 1)),
    "literal_op_slot": (2, _slot_word(_PA.I_DIV | _PA.LIT_BIT, 0)),
    "int32_division": None,
    "stack_overflow": None,
}


@pytest.mark.parametrize("bad", sorted(_BAD_PROGRAMS))
def test_project_kernel_refuses_a_bad_program(dev, bad):
    """``dacp_project_tiles`` checks an annotated program's slots, indices
    and kinds before launch and returns cudaErrorInvalidValue for a bad one;
    the valid program beside it runs."""
    code = _PA.annotate(*_PA.compile_program((("div", ("col", 0), ("col", 1)),), "float32")[0])
    table = torch.ones((TILE, 2), dtype=torch.float32, device=dev)
    out = torch.zeros((TILE, 1), dtype=torch.float32, device=dev)

    def run(prog, is_f32=1):
        prog = np.ascontiguousarray(prog, np.int32)
        return _build.library().dacp_project_tiles(
            table.data_ptr(), 2, TILE, is_f32, prog.ctypes.data, len(prog), out.data_ptr(), 1, _build.stream_of(table)
        )

    assert run(code) == 0
    torch.cuda.synchronize()
    assert _bits(out) == _bits(torch.ones((TILE, 1)))
    if bad == "int32_division":
        rc = run(code, is_f32=0)
    elif bad == "stack_overflow":
        rc = run([[_slot_word(_PA.I_COL, s, 0), 0] for s in range(_PA.STACK_MAX + 1)])
    else:
        i, word = _BAD_PROGRAMS[bad]
        bad_code = code.copy()
        bad_code[i, 0] = word
        rc = run(bad_code)
    assert rc == 1  # cudaErrorInvalidValue


def _groups(rng, n: int, ngroups: int, dist: str) -> np.ndarray:
    if dist == "one":  # every row in one group
        return np.full(n, ngroups // 2, np.int32)
    if dist == "zipf":  # the stations of the COOKs: Zipf 1/k^1.1
        w = 1.0 / (np.arange(ngroups) + 1.0) ** 1.1
        return rng.choice(ngroups, size=n, p=w / w.sum()).astype(np.int32)
    return rng.integers(0, ngroups, n).astype(np.int32)


@pytest.mark.parametrize(
    "ngroups,n,s,dist",
    [
        (1, N, 16, "uniform"),
        (200, N, 16, "uniform"),
        (256, N, 16, "uniform"),
        (200, N, 8, "one"),
        (200, 65536, 8, "zipf"),  # the aggregate COOK's morsel
        (256, N, 16, "zipf"),
        (1, N, 32, "uniform"),
    ],
)
def test_segment_kernels(dev, ngroups, n, s, dist):
    rng = np.random.default_rng(ngroups * 100 + s + len(dist))
    gidx = _groups(rng, n, ngroups, dist)
    limbs = rng.integers(-128, 256, size=(n, s)).astype(np.int32)
    vf = np.stack([_f32(rng, n) for _ in range(4)], axis=1)
    vi = rng.integers(-(2**31), 2**31, size=(n, 4), dtype=np.int64).astype(np.int32)
    g = torch.from_numpy(gidx)
    got = segment_reduce.segment_sum_tiles(g.to(dev), torch.from_numpy(limbs).to(dev), n - 3, ngroups, TILE)
    want = segment_reduce.segment_sum_tiles_plain(g, torch.from_numpy(limbs), n - 3, ngroups, TILE)
    for a, b in zip(got, want):
        assert _bits(a) == _bits(b)
    fns = ("min", "max", "max", "min")
    for vals in (vf, vi):
        v = torch.from_numpy(vals)
        got = segment_reduce.segment_minmax_tiles(g.to(dev), v.to(dev), n - 3, ngroups, fns, TILE)
        want = segment_reduce.segment_minmax_tiles_plain(g, v, n - 3, ngroups, fns, TILE)
        assert _bits(got) == _bits(want)


def _on_card(dev, a: np.ndarray, offset: bool = False):
    """``a`` on the card; with ``offset``, as a contiguous view that starts
    4 bytes past a 16-byte boundary."""
    src = torch.from_numpy(np.ascontiguousarray(a))
    if not offset:
        return src.to(dev)
    flat = torch.empty(src.numel() + 1, dtype=src.dtype, device=dev)
    view = flat[1:].view(src.shape)
    view.copy_(src)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize(
    "tile,d,rows,passing,view",
    [
        (32, 5, "ragged", "some", ""),
        (128, 11, "ragged", "some", ""),
        (1024, 11, "ragged", "some", ""),
        (TILE, 1, "ragged", "some", ""),
        (TILE, 5, "ragged", "some", ""),
        (TILE, 11, "ragged", "some", ""),
        (TILE, 64, "ragged", "some", ""),  # 64 KB of planes a tile: above the 48 KB default
        (1024, 60, "ragged", "some", ""),  # 240 KB a tile: the columns split over gridDim.y, 16-byte copies
        (1024, 61, "ragged", "some", ""),  # split, and 61 is no multiple of 4: 4-byte copies
        (TILE, 11, "zero", "some", ""),
        (TILE, 11, "boundary", "some", ""),
        (TILE, 11, "all", "all", ""),
        (TILE, 11, "all", "none", ""),
        (TILE, 11, "ragged", "some", "pred"),
        (TILE, 11, "ragged", "some", "table"),
        (TILE, 12, "ragged", "some", "table"),
    ],
)
def test_filter_select_kernel_tiles_widths_and_views(dev, tile, d, rows, passing, view):
    """Bit for bit against the plain version across the kernel's paths: the
    tiles the wrapper takes, plane counts whose staged tile fits, needs the
    shared-memory opt-in or splits its columns, n_rows at 0 and on a tile
    boundary, predicates that pass every row or none, and views 4 bytes off
    a 16-byte boundary (the 4-byte path)."""
    n = 16384
    rng = np.random.default_rng(tile + d + len(rows) + len(passing) + len(view))
    v = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    pred = np.stack([(v >> 32).astype(np.int32), (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)], axis=1)
    thr = {"some": int(v[10]), "all": -(2**63), "none": -(2**63)}[passing]
    op = "lt" if passing == "none" else "ge"
    lo = (thr & 0xFFFFFFFF) ^ 0x80000000
    scalars = np.array([0, thr >> 32, lo - 2**32 if lo >= 2**31 else lo], np.int64)
    scalars[0] = {"ragged": n - 37, "zero": 0, "boundary": n // 2, "all": n}[rows]
    table = rng.integers(-(2**31), 2**31, size=(n, d), dtype=np.int64).astype(np.int32)
    got = filter_select.filter_select_planes(
        _on_card(dev, pred, view == "pred"), _on_card(dev, table, view == "table"), scalars, op, "i64", tile
    )
    want = filter_select.filter_select_planes_plain(torch.from_numpy(pred), torch.from_numpy(table), scalars, op,
                                                     "i64", tile)
    for g, w in zip(got, want):
        assert _bits(g) == _bits(w)
    survivors = int(want[1].sum())
    assert survivors == {"zero": 0, "all": n if passing == "all" else 0}.get(rows, survivors)


@pytest.mark.parametrize(
    "ngroups,n,m,dist,rows,view",
    [
        (1, N, 4, "uniform", "ragged", False),
        (1536, N, 4, "uniform", "ragged", False),  # the most groups the kernel takes
        (1536, 65536, 32, "uniform", "ragged", False),  # 192 KB of bins a block
        (200, N, 33, "uniform", "ragged", False),  # two column chunks over gridDim.y in one fold launch
        (200, N, 4, "uniform", "zero", False),  # every group holds the identity
        (200, N, 4, "one", "ragged", False),  # every row in one group
        (200, 65536, 1, "zipf", "all", False),  # the aggregate COOK's morsel
        (256, N, 4, "zipf", "ragged", True),  # vals 4 bytes off a 16-byte boundary
    ],
)
def test_segment_minmax_kernel_edges(dev, ngroups, n, m, dist, rows, view):
    """Bit for bit against the plain version, float32 (NaN, ±0, ±inf,
    denormals) and int32, each with min and max columns mixed."""
    rng = np.random.default_rng(ngroups + n + m + len(dist))
    gidx = _groups(rng, n, ngroups, dist)
    n_rows = {"ragged": n - 3, "zero": 0, "all": n}[rows]
    fns = tuple(("min", "max", "max", "min")[j % 4] for j in range(m))
    g = torch.from_numpy(gidx)
    for vals in (
        np.stack([_f32(rng, n) for _ in range(m)], axis=1),
        rng.integers(-(2**31), 2**31, size=(n, m), dtype=np.int64).astype(np.int32),
    ):
        got = segment_reduce.segment_minmax_tiles(g.to(dev), _on_card(dev, vals, view), n_rows, ngroups, fns, TILE)
        want = segment_reduce.segment_minmax_tiles_plain(g, torch.from_numpy(vals), n_rows, ngroups, fns, TILE)
        assert _bits(got) == _bits(want)
        if rows == "zero":
            ident = segment_reduce.segment_minmax_tiles_plain(g[:0], torch.from_numpy(vals[:0]), 0, ngroups, fns, TILE)
            assert _bits(got) == _bits(ident)


def test_backend_on_cuda_matches_reference_numpy(dev):
    """The torch backend on cuda through the executor, against the
    reference numpy backend: filter+select, projection and aggregation."""
    repro_executor = pytest.importorskip("repro.core.executor")
    import repro.core.batch as rb
    import repro.core.dag as rd
    import repro.core.expr as rx
    import repro.core.sdf as rs
    import repro_torch.core.batch as pb
    import repro_torch.core.dag as pd
    import repro_torch.core.executor as pe
    import repro_torch.core.expr as px
    import repro_torch.core.sdf as ps
    from repro_torch.core.backend import get_backend

    rng = np.random.default_rng(9)
    n = 20000
    arrays = {
        "k": rng.integers(0, 50, n).astype(np.int32),
        "a": _f32(rng, n),
        "b": (rng.standard_normal(n) * 3).astype(np.float32),
        "i": rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64),
        "q": rng.integers(0, 4, n).astype(np.uint8),
    }

    def run(batch_mod, dag_mod, expr_mod, sdf_mod, exec_mod, **cfg):
        col = expr_mod.col
        batch = batch_mod.RecordBatch.from_pydict({k: v.copy() for k, v in arrays.items()})
        outs = []
        for chain in ("select", "agg"):
            bld = dag_mod.Dag.build()
            s = bld.source("dacp://h:1/d")
            p = bld.add("project", {"exprs": {"c": col("a") * 0.5 - col("b"), "s3": col("k") * 3 + 1}, "keep": True}, [s])
            f = bld.add("filter", {"predicate": col("s3") != 22}, [p])
            if chain == "select":
                out = bld.add("select", {"columns": ["k", "c", "i", "a"]}, [f])
            else:
                aggs = {"n": {"fn": "count"}, "s": {"fn": "sum", "column": "i"}, "lo": {"fn": "min", "column": "b"},
                        "hi": {"fn": "max", "column": "i"}, "m": {"fn": "mean", "column": "c"}, "sq": {"fn": "sum", "column": "q"}}
                out = bld.add("aggregate", {"keys": ["k"], "aggs": aggs}, [f])
            dag = bld.finish(out)

            def gen(batch=batch):
                for st in range(0, n, 4096):
                    yield batch.slice(st, st + 4096)

            sdf = sdf_mod.StreamingDataFrame(batch.schema, gen)
            config = exec_mod.ExecutorConfig(num_workers=2, morsel_rows=4096, **cfg)
            with np.errstate(all="ignore"):
                res = exec_mod.execute_parallel(dag, lambda node, sdf=sdf: sdf, config).collect()
            outs.append({f.name: c.values.tobytes() for f, c in zip(res.schema, res.columns)})
        return outs

    bk = get_backend("torch", device="cuda")
    before = bk.kernel_calls
    got = run(pb, pd, px, ps, pe, backend="torch", device="cuda")
    assert bk.kernel_calls > before
    want = run(rb, rd, rx, rs, repro_executor, backend="numpy")
    assert got == want


# ---------------------------------------------------------------------------
# the fused chain kernel and its staged plan
# ---------------------------------------------------------------------------
def _smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def _fused_edge_case(label):
    """(numpy inputs, static args) of the grid's edge cases, from the fused
    aggregate COOK's morsel: every row in one group, no survivors, fewer
    tiles than SMs, a row count that is no multiple of the tile, and a plan
    whose fold fills the shared memory of a block."""
    from repro_torch.kernels import fused_pipeline

    rng = np.random.default_rng(6)
    arrays, static = next((a, s) for lb, a, s in _smoke()._fused_cases(rng) if lb == "main")
    arrays = [np.array(a) for a in arrays]
    static = dict(static)
    n = arrays[3].shape[0]
    if label == "one-group":
        arrays[2][:] = 7
        arrays[8][:] = 7
    elif label == "no-survivors":
        arrays[0][1] = int(np.array([np.inf], np.float32).view(np.int32)[0])  # pressure > inf
    elif label == "few-tiles":
        arrays = [arrays[0]] + [a[: 16 * TILE] for a in arrays[1:]]
        arrays[0][0] = 16 * TILE
    elif label == "ragged-rows":
        arrays[0][0] = n - 3 * TILE - 17
    elif label == "shared-limit":  # limb columns up to SHARED_MAX_BYTES at 256 groups
        cols = fused_pipeline.SHARED_MAX_BYTES // (4 * 256) - 4 * len(static["csums"]) - 2 - 1 - 1
        assert fused_pipeline.shared_bytes(256, cols, 1, 1, 1) <= fused_pipeline.SHARED_MAX_BYTES
        assert fused_pipeline.shared_bytes(256, cols + 1, 1, 1, 1) > fused_pipeline.SHARED_MAX_BYTES
        arrays = [arrays[0]] + [a[: 64 * TILE] for a in arrays[1:]]
        arrays[0][0] = 64 * TILE - 5
        g = rng.integers(0, 256, 64 * TILE).astype(np.int32)
        arrays[2], arrays[8] = g, g.reshape(-1, 1).copy()
        arrays[4] = rng.integers(0, 256, (64 * TILE, cols)).astype(np.int32)
        static["ngroups"] = 256
    return arrays, static


@pytest.mark.parametrize(
    "label",
    ["main", "wide", "stream-i64", "specials", "cell", "one-group", "no-survivors", "few-tiles", "ragged-rows",
     "shared-limit"],
)
def test_fused_chain_kernel(dev, label):
    """The five configurations ``chip_smoke.py`` checks (the fused aggregate
    COOK's morsel, the widest envelope, a streaming int64-predicate chain,
    special values in every table and the benchmark cell's morsel with its
    float sums) and the grid's edge cases, bit for bit against the plain
    version."""
    from repro_torch.kernels import fused_pipeline

    cases = {lb: (arrays, static) for lb, arrays, static in _smoke()._fused_cases(np.random.default_rng(5))}
    arrays, static = cases[label] if label in cases else _fused_edge_case(label)
    t_cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays[1:]]
    got = fused_pipeline.fused_chain_tiles(arrays[0], *(t.to(dev) for t in t_cpu), **static, tile=TILE)
    want = fused_pipeline.fused_chain_tiles_plain(arrays[0], *t_cpu, **static, tile=TILE)
    assert fused_pipeline.launches.value > 0
    for g, w in zip(got, want):
        assert _bits(g) == _bits(w)


_FOLD_CASES = ["cell", "zipf-120", "zipf-256", "ragged", "ordered", "wide-kinds", "nonfinite"]


def _fold_case(label):
    """(numpy inputs, static args) of a float-sum fold at the cell's morsel
    shape: 65536 rows of temperatures (the cell's two float sums) over
    station-years, or over 120 or 256 Zipf-skewed groups, a ragged tail,
    values a sum in row order must keep in order, float64 and the wide
    integer kinds, and NaN / ±inf survivors."""
    smoke = _smoke()
    rng = np.random.default_rng(_FOLD_CASES.index(label))
    arrays, static = smoke._cell_morsel(rng)
    arrays, static = [np.array(a) for a in arrays], dict(static)
    n = arrays[3].shape[0]
    temp = arrays[7][:, 0]
    if label in ("zipf-120", "zipf-256", "ragged", "wide-kinds", "nonfinite"):
        g = 256 if label == "zipf-256" else 120
        arrays[2], static["ngroups"] = smoke._skewed_groups(rng, n, g), g
    if label == "ragged":
        arrays[0][0] = n - 3 * TILE - 17
    elif label == "ordered":  # 3.0e7 beside tenths of a degree: the sums round
        temp[::97] = np.float32(3.0e7)
    elif label == "nonfinite":
        temp[1000::5000] = np.inf
        temp[1003::7000] = -np.inf  # filtered out: only +inf survives `temp > base`
    elif label == "wide-kinds":  # [t | f64 hi, lo | i64 hi, lo | u64 hi, lo | u32], then dh
        f64 = rng.standard_normal(n) * 10.0 ** rng.integers(-5, 6, n)
        f64[np.flatnonzero(temp > np.float32(12.5))[7::4096]] = np.nan
        i64 = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
        u64 = rng.integers(2**63, 2**64 - 1, n, dtype=np.uint64)
        u32 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
        arrays[3] = np.concatenate([arrays[3], smoke._i64_words(f64.view(np.int64)), smoke._i64_words(i64),
                                    smoke._i64_words(u64.view(np.int64)), u32.reshape(n, 1)], axis=1)
        static["fsums"] = ((0, "f32"), (1, "f64"), (3, "i64"), (5, "u64"), (7, "u32"), (8, "f32"))
    arrays[1] = temp.view(np.int32).reshape(n, 1).copy()
    if label != "wide-kinds":
        arrays[3] = arrays[1].copy()
    return arrays, static


def _add_at_fsums(arrays, static):
    """The float sums by ``np.add.at`` over the survivors in row order, NaN
    where a group's column holds a NaN or ±inf, and the flag."""
    scalars, pred, gidx, pass_tbl, af = arrays[0], arrays[1], arrays[2], arrays[3], arrays[7]
    base = static["descrs_f"][0][2][1]
    n = pass_tbl.shape[0]
    mask = (np.arange(n) < scalars[0]) & (pred[:, 0].view(np.float32) > np.float32(base))
    with np.errstate(all="ignore"):
        dh = af[:, 0] - np.float32(base)
    planes = np.concatenate([pass_tbl, dh.view(np.int32).reshape(n, 1)], axis=1)[mask]
    g, g_n = gidx[mask], static["ngroups"]
    out, bad = np.zeros((g_n, len(static["fsums"]))), np.zeros((g_n, len(static["fsums"])), bool)
    for j, (off, kind) in enumerate(static["fsums"]):
        w = planes[:, off]
        if kind in ("f64", "i64", "u64"):
            word = (w.astype(np.int64) << 32) | planes[:, off + 1].view(np.uint32).astype(np.int64)
            vals = word.view({"f64": np.float64, "i64": np.int64, "u64": np.uint64}[kind]).astype(np.float64)
        else:
            vals = w.view({"f32": np.float32, "u32": np.uint32}[kind]).astype(np.float64)
        with np.errstate(all="ignore"):
            np.add.at(out[:, j], g, vals)
        bad[g[~np.isfinite(vals)], j] = True
    out[bad] = np.nan
    return out, int(bad.any())


@pytest.mark.parametrize("label", _FOLD_CASES)
def test_fused_float_sums_on_the_card(dev, label):
    """The fold kernel's float sums and flag at the cell's morsel shape, bit
    for bit against the plain version and against ``np.add.at`` in row
    order; every output read back through the one pinned copy equals its
    own read."""
    from repro_torch.kernels import fused_pipeline

    arrays, static = _fold_case(label)
    t_cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays[1:]]
    got = fused_pipeline.fused_chain_tiles(arrays[0], *(t.to(dev) for t in t_cpu), **static, tile=TILE)
    want = fused_pipeline.fused_chain_tiles_plain(arrays[0], *t_cpu, **static, tile=TILE)
    for g, w in zip(got, want):
        assert _bits(g) == _bits(w)
    fsum, flag = _add_at_fsums(arrays, static)
    assert _bits(got[7]) == fsum.tobytes() and got[8].item() == flag
    assert flag == (label in ("wide-kinds", "nonfinite"))
    assert [a.tobytes() for a in fused_pipeline.groups_to_host(got)] == [_bits(t) for t in got[2:]]


def _fused_plans(n=65536):
    """A streaming and an aggregate fused plan on the cuda backend over one
    morsel of station observations."""
    from repro_torch.core.backend import get_backend, plan_fused_chain
    from repro_torch.core.batch import RecordBatch
    from repro_torch.core.expr import col
    from repro_torch.core.operators import project_schema

    rng = np.random.default_rng(12)
    batch = RecordBatch.from_pydict({
        "station": rng.integers(0, 200, n).astype(np.int32),
        "temp": _f32(rng, n),
        "pressure": (rng.standard_normal(n) * 9 + 1013).astype(np.float32),
        "ts": rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64),
        "qc": rng.integers(0, 4, n).astype(np.uint8),
    })
    bk = get_backend("torch", device="cuda")
    exprs = {"tk": col("temp") + 273.15, "s3": col("station") * 3 + 1}
    proj = ("project", (exprs, project_schema(batch.schema, exprs, True)))
    sch = project_schema(batch.schema, exprs, True)
    stream = plan_fused_chain([proj, ("filter", (col("temp") > 0.0,))], batch.schema, backend=bk)
    aggs = {"n": {"fn": "count"}, "sq": {"fn": "sum", "column": "qc"}, "s3s": {"fn": "sum", "column": "s3"},
            "lo": {"fn": "min", "column": "pressure"}, "hi": {"fn": "max", "column": "qc"},
            "m": {"fn": "mean", "column": "tk"}}
    agg = plan_fused_chain([proj, ("filter", (col("pressure") > 1013.0,))], batch.schema,
                           agg=(["station"], aggs, "full", sch), backend=bk)
    assert stream is not None and agg is not None
    return batch, stream, agg


def _state_bytes(st):
    return [tuple(st.key_rows)] + [st.acc[k].tobytes() for k in sorted(st.acc)]


def test_fused_staged_run_matches_unstaged(dev):
    """A morsel staged through pinned memory and the side stream gives the
    same bytes as the same morsel uploaded at launch time."""
    batch, stream, agg = _fused_plans()
    plain = stream.run(batch)
    stream.stage(batch)
    assert stream.staged_count == 1
    staged = stream.run(batch)
    assert stream.staged_count == 0
    assert [c.values.tobytes() for c in staged.columns] == [c.values.tobytes() for c in plain.columns]
    st_plain = agg.fold(batch)
    agg.stage(batch)
    st_staged = agg.fold(batch)
    assert _state_bytes(st_staged) == _state_bytes(st_plain)


def test_fused_launch_with_a_bad_argument_raises(dev, monkeypatch):
    """A launch the C entry point refuses raises: the plan does not turn it
    into FUSED_INELIGIBLE."""
    from repro_torch.kernels import fused_pipeline

    batch, _stream, agg = _fused_plans(4096)
    bad = (np.array([0 | (999 << 8)], np.int32), np.zeros(1, np.uint32), 1, 0)  # a column past the table, no store
    monkeypatch.setattr(fused_pipeline, "_program", lambda descrs, dtype_name: bad)
    with pytest.raises(RuntimeError, match="CUDA error"):
        agg.fold(batch)


def test_fused_plans_round_robin_over_devices(dev, monkeypatch):
    """``ExecutorConfig.devices`` binds each fused plan to a CUDA index in
    turn; plans on every card give the bytes of the numpy backend."""
    import repro_torch.core.backend as port_backend
    import repro_torch.core.batch as pb
    import repro_torch.core.dag as pd
    import repro_torch.core.executor as pe
    import repro_torch.core.expr as px
    import repro_torch.core.sdf as ps

    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more CUDA cards")
    bound = []
    orig_bind = port_backend.FusedChainPlan.bind

    def spy_bind(self, sizer, device_index=None):
        bound.append(device_index)
        return orig_bind(self, sizer, device_index)

    monkeypatch.setattr(port_backend.FusedChainPlan, "bind", spy_bind)
    rng = np.random.default_rng(21)
    n = 40000
    batch = pb.RecordBatch.from_pydict({"x": _f32(rng, n), "k": rng.integers(0, 50, n).astype(np.int32),
                                        "v": rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)})
    col = px.col
    bld = pd.Dag.build()
    s = bld.source("dacp://h:1/d")
    f = bld.add("filter", {"predicate": col("x") > 0.25}, [s])
    p = bld.add("project", {"exprs": {"y": col("x") * 0.5}, "keep": True}, [f])
    dag = bld.finish(bld.add("aggregate", {"keys": ["k"], "aggs": {"n": {"fn": "count"}, "s": {"fn": "sum", "column": "v"},
                                                                   "m": {"fn": "mean", "column": "y"}}}, [p]))

    def run(**cfg):
        def gen():
            for st in range(0, n, 4096):
                yield batch.slice(st, st + 4096)

        stats = pe.ExecutorStats()
        config = pe.ExecutorConfig(num_workers=2, morsel_rows=4096, **cfg)
        res = pe.execute_parallel(dag, lambda node: ps.StreamingDataFrame(batch.schema, gen), config, stats=stats)
        res = res.collect()
        return [c.values.tobytes() for c in res.columns], stats.progress()["fused_launches"]

    want, _ = run(backend="numpy")
    for _ in range(count):
        got, fused = run(backend="torch", device="cuda", devices=tuple(range(count)))
        assert got == want and fused > 0
    assert set(bound) == set(range(count))


# ---------------------------------------------------------------------------
# the attention kernels and the dense LM on them
# ---------------------------------------------------------------------------
def _attn_tol(dtype):
    # tests/test_kernels.py's tolerances: bfloat16 rounds p and the output
    # to 8 bits of mantissa, float32 differs only in the order of the sums
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=3e-5, atol=3e-5)


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize(
    "b,kv,g,s,t,hd,dtype,causal",
    [
        (4, 8, 4, 1024, 1024, 128, torch.bfloat16, True),  # granite-3-8b prefill, one layer
        (2, 2, 2, 1000, 1000, 128, torch.bfloat16, True),  # ragged tiles
        (1, 2, 3, 77, 77, 64, torch.float32, True),
        (2, 1, 4, 5, 130, 32, torch.float32, False),
        (1, 1, 8, 200, 200, 256, torch.float32, True),
        (1, 1, 8, 200, 200, 256, torch.bfloat16, False),
        (2, 2, 2, 256, 256, 64, torch.float32, False),
        (4, 32, 1, 1024, 1024, 64, torch.bfloat16, True),  # zamba2-1.2b's shared attention block
        (1, 2, 2, 129, 129, 128, torch.bfloat16, True),  # one row past a 128-row q tile
        (2, 2, 2, 100, 300, 128, torch.bfloat16, False),  # full, T > S
        (2, 2, 2, 300, 100, 64, torch.bfloat16, False),  # full, S > T
        (1, 2, 2, 1000, 1000, 256, torch.bfloat16, True),
        (4, 16, 1, 1024, 1024, 128, torch.bfloat16, True),  # moonshot-v1-16b-a3b's MHA, G 1 at hd 128
        (4, 12, 1, 1500, 1500, 64, torch.bfloat16, False),  # whisper-small's encoder, ragged 1500
        (4, 12, 1, 1024, 1500, 64, torch.bfloat16, False),  # whisper-small's cross-attention at prefill
        (4, 12, 1, 1024, 1024, 64, torch.bfloat16, True),  # whisper-small's decoder self-attention
    ],
)
def test_flash_attention_kernel(dev, b, kv, g, s, t, hd, dtype, causal):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.flash_attention import launches as flash_launches

    rng = np.random.default_rng(s * 7 + hd)
    q = _randn(rng, (b, kv, g, s, hd), dtype, dev)
    k = _randn(rng, (b, kv, t, hd), dtype, dev)
    v = _randn(rng, (b, kv, t, hd), dtype, dev)
    before = flash_launches.value
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_launches.value == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


@pytest.mark.parametrize("kv,g,hd", [(2, 4, 128), (4, 1, 64)])  # granite's grouping; zamba2's G 1, hd 64
def test_flash_attention_kernel_takes_the_models_strided_views(dev, kv, g, hd):
    """q as the model hands it, a (B, KV, G, S, hd) view of (B, S, KV, G, hd)
    memory, k and v as views of a larger cache: the output takes q's
    layout and matches the plain version."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    rng = np.random.default_rng(11)
    b, s, t_max = 2, 300, 512
    q = _randn(rng, (b, s, kv, g, hd), torch.bfloat16, dev).permute(0, 2, 3, 1, 4)
    cache = _randn(rng, (2, b, kv, t_max, hd), torch.bfloat16, dev)
    k, v = cache[0, :, :, :s], cache[1, :, :, :s]
    got = flash_attention(q, k, v, causal=True)
    assert got.stride() == q.stride()
    want = flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(torch.bfloat16))


def test_flash_attention_kernel_refuses_misaligned_rows(dev):
    """The bfloat16 kernel copies rows in 16-byte pieces: a view whose rows
    start off a 16-byte boundary raises before launch."""
    from repro_torch.kernels.flash_attention import flash_attention

    base = torch.zeros((1, 1, 1, 64 * 64 + 1), dtype=torch.bfloat16, device=dev)
    q = base[..., 1:].reshape(1, 1, 1, 64, 64)
    k = torch.zeros((1, 1, 64, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, k, k)


@pytest.mark.parametrize(
    "b,kv,g,t,length,hd,dtype",
    [
        (4, 8, 4, 1056, 1025, 128, torch.bfloat16),  # granite-3-8b, first decode step
        (4, 8, 4, 1056, 1056, 128, torch.bfloat16),
        (2, 2, 4, 1000, 17, 64, torch.float32),
        (1, 1, 1, 1000, 1000, 128, torch.float32),
        (2, 3, 32, 300, 129, 256, torch.bfloat16),
        (3, 2, 8, 64, 1, 32, torch.float32),
        (1, 1, 4, 4096, 4096, 256, torch.bfloat16),  # 16 chunks: a 16-block cluster, one block per SM
        (4, 16, 1, 1056, 1025, 128, torch.bfloat16),  # moonshot-v1-16b-a3b, first decode step
        (4, 12, 1, 1056, 1025, 64, torch.bfloat16),  # whisper-small's self-attention
        (4, 12, 1, 1500, 1500, 64, torch.bfloat16),  # whisper-small's cross-attention: length the whole cache
    ],
)
def test_decode_attention_kernel(dev, b, kv, g, t, length, hd, dtype):
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
    from repro_torch.kernels.decode_attention import launches as decode_launches

    rng = np.random.default_rng(t + length)
    q = _randn(rng, (b, kv, g, hd), dtype, dev)
    k = _randn(rng, (b, kv, t, hd), dtype, dev)
    v = _randn(rng, (b, kv, t, hd), dtype, dev)
    before = decode_launches.value
    got = decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    assert decode_launches.value == before + 1
    want = decode_attention_plain(q, k, v, length)
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


def test_decode_attention_kernel_length_zero_is_zero(dev):
    from repro_torch.kernels.decode_attention import decode_attention

    q = torch.ones((1, 1, 4, 64), device=dev)
    k = torch.ones((1, 1, 64, 64), device=dev)
    assert torch.count_nonzero(decode_attention(q, k, k, 0)).item() == 0


def _assert_partials_close(got, want, dtype):
    """The decode kernel's partial (m, l, acc) against the plain version's:
    m (natural units) within the attention tolerance, l relatively, acc
    within the tolerance at its peak and, divided by l, the output within
    the attention tolerance."""
    tol = _attn_tol(dtype)["rtol"]
    m, l, acc = got
    wm, wl, wacc = want
    torch.testing.assert_close(m, wm, rtol=tol, atol=tol)
    torch.testing.assert_close(l, wl, rtol=tol, atol=0.0)
    torch.testing.assert_close(acc, wacc, rtol=tol, atol=tol * float(wacc.abs().max()))
    torch.testing.assert_close(acc / l, wacc / wl, **_attn_tol(dtype))


# (B, KV, T): one chunk per b·kv (B·KV past two blocks an SM), or up to sixteen (a cluster past the
# portable eight blocks: 16 at the whole 4096 positions, 13 at the ragged 3077)
_SPLIT_SHAPES = {"one_split": (9, 32, 1100), "sixteen_splits": (1, 2, 4096)}


@pytest.mark.parametrize("splits", sorted(_SPLIT_SHAPES))
@pytest.mark.parametrize("length", ["zero", "one", "ragged", "full"])
@pytest.mark.parametrize("g", [1, 4, 17])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_decode_attention_partials_kernel(dev, dtype, hd, g, length, splits):
    """``decode_attention_partials`` on the card (one launch of the decode
    kernel whose merge hands out the partials) against its plain version:
    length 0 launches nothing and gives (-1e30, 0, 0)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_partials,
        decode_attention_partials_plain,
        launches,
        split_plan,
    )

    b, kv, t = _SPLIT_SHAPES[splits]
    n = {"zero": 0, "one": 1, "ragged": t * 3 // 4 + 5, "full": t}[length]
    if n > 64:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        chunks = split_plan(b * kv, n, sms)[0]
        assert chunks == 1 if splits == "one_split" else chunks == (16 if n == t else 13)
    rng = np.random.default_rng(n + hd + g)
    q = _randn(rng, (b, kv, g, hd), dtype, dev)
    k = _randn(rng, (b, kv, t, hd), dtype, dev)
    v = _randn(rng, (b, kv, t, hd), dtype, dev)
    before = launches.value
    got = decode_attention_partials(q, k, v, n)
    torch.cuda.synchronize()
    assert launches.value == before + (n > 0)
    assert [tuple(x.shape) for x in got] == [(b, kv, g, 1), (b, kv, g, 1), (b, kv, g, hd)]
    assert all(x.dtype == torch.float32 and x.device == dev for x in got)
    if n == 0:
        assert bool((got[0] == -1e30).all()) and not got[1].any() and not got[2].any()
        return
    _assert_partials_close(got, decode_attention_partials_plain(q, k, v, n), dtype)


@pytest.mark.parametrize("length", [301, 97], ids=["ragged_last_slice", "two_slices_empty"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_decode_attention_partials_of_four_slices_merge_into_the_whole_cache_launch(dev, dtype, length):
    """Four slices of a cache, each's kernel partials merged by the formula
    of ``collectives.seq_sharded_decode_attention`` (max of m, then l and acc
    weighted by e^(m - max)), equal one ``decode_attention`` launch over the
    whole cache.  The first slice's keys are scaled up, so the slices' m
    differ by several units: m in any other units than the natural ones
    would weigh them wrongly."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_partials

    rng = np.random.default_rng(length)
    b, kv, g, hd, t = 2, 4, 4, 64, 384
    q = _randn(rng, (b, kv, g, hd), dtype, dev)
    k = _randn(rng, (b, kv, t, hd), dtype, dev)
    v = _randn(rng, (b, kv, t, hd), dtype, dev)
    k[:, :, : t // 4] *= 4
    parts = []
    for r in range(4):
        lo = r * t // 4
        valid = min(max(length - lo, 0), t // 4)
        parts.append(decode_attention_partials(q, k[:, :, lo : lo + t // 4], v[:, :, lo : lo + t // 4], valid))
    m_glob = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    assert float((parts[0][0] - parts[1][0]).abs().max()) > 2  # the slices' score scales differ
    l_sum = sum(l * torch.exp(m - m_glob) for m, l, _ in parts)
    acc_sum = sum(acc * torch.exp(m - m_glob) for m, _, acc in parts)
    got = (acc_sum / torch.clamp(l_sum, min=1e-30)).to(dtype)
    want = decode_attention(q, k, v, length)
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))
    peak = float(want.float().abs().max())  # and within chip_smoke.py's limit: 4 half ulps of bf16 at the peak
    assert float((got.float() - want.float()).abs().max()) <= 4 * 2.0**-8 * peak


T_DEC = 1056  # granite-3-8b's cache at 1024 + 32 positions


@pytest.mark.parametrize(
    "g,hd,length,view",
    [
        (4, 128, 1, "dense"),
        (4, 128, 63, "dense"),
        (4, 128, 64, "dense"),
        (4, 128, 65, "dense"),
        (4, 128, T_DEC - 1, "dense"),
        (4, 128, T_DEC, "dense"),
        (1, 64, 700, "dense"),  # zamba2-1.2b's shared attention block
        (32, 256, 300, "dense"),  # two blocks of 16 query rows
        (12, 128, 500, "dense"),  # 16 query rows a block, four of them padding
        (17, 64, 300, "dense"),  # a second block holding one query row
        (4, 128, 1025, "cache"),  # k, v slices of a stacked (layers, B, KV, T, hd) cache
        (4, 64, 200, "odd"),  # rows off a 16-byte boundary: copied element by element
    ],
)
def test_decode_attention_bf16_kernel_lengths_and_views(dev, g, hd, length, view):
    """The tensor-core kernel at the tile edges of `length` (one row, one
    tile less one, one tile, one past, the whole cache), at both ends of G
    and hd, and on the views the model hands it, against the plain version
    at bfloat16's 2e-2."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain

    rng = np.random.default_rng(length * 3 + hd + g)
    b, kv = 2, 3
    q = _randn(rng, (b, kv, g, hd), torch.bfloat16, dev)
    if view == "cache":
        cache = _randn(rng, (2, 3, b, kv, T_DEC, hd), torch.bfloat16, dev)
        k, v = cache[0, 1], cache[1, 1]
    elif view == "odd":
        flat = _randn(rng, (2, b, kv, T_DEC, hd + 1), torch.bfloat16, dev)
        k, v = flat[0, ..., 1:], flat[1, ..., :-1]
    else:
        k, v = (_randn(rng, (b, kv, T_DEC, hd), torch.bfloat16, dev) for _ in range(2))
    for _ in range(2):  # the second call finds the last-block counters the first one left
        got = decode_attention(q, k, v, length)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), decode_attention_plain(q, k, v, length).float(),
                                   **_attn_tol(torch.bfloat16))


def test_lm_kernel_path_matches_plain_path_on_the_card(dev):
    """Reduced granite-3-8b in float32 on the card: prefill and three decode
    steps through the kernels against the same model through the plain
    versions, with exactly one flash launch per layer per prefill and one
    decode launch per layer per step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import attention, build

    cfg = get_config("granite-3-8b").reduced()
    kern, plain = build(cfg), build(cfg, attention.PLAIN)
    params = kern.init(torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 259, (3, 45)).astype(np.int32)).to(dev)
    for c in ops.LAUNCHES.values():
        c.reset()
    got, cache_k = kern.prefill(params, {"tokens": tokens[:, :40]}, 48)
    assert ops.LAUNCHES["flash_attention"].value == cfg.n_layers
    want, cache_p = plain.prefill(params, {"tokens": tokens[:, :40]}, 48)
    assert ops.LAUNCHES["flash_attention"].value == cfg.n_layers
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for i in range(3):
        tok = tokens[:, 40 + i : 41 + i]
        got, cache_k = kern.decode_step(params, tok, cache_k)
        want, cache_p = plain.decode_step(params, tok, cache_p)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert ops.LAUNCHES["decode_attention"].value == 3 * cfg.n_layers
    assert ops.LAUNCHES["rms_norm"].value == 4 * (2 * cfg.n_layers + 1)  # ln1, ln2 a layer, the final norm
    torch.testing.assert_close(cache_k["k"], cache_p["k"], rtol=1e-5, atol=1e-5)


def test_torch_feed_stages_batches_on_the_card(dev, tmp_path):
    """TorchFeed on cuda gives the CPU feed's batches, on the card."""
    import repro_torch.data  # noqa: F401  registers tokenize_and_pack
    from repro_torch.client import LocalNetwork
    from repro_torch.client.torch_adapter import TorchFeed
    from repro_torch.core.executor import ExecutorConfig
    from repro_torch.data import training_dag, write_token_corpus
    from repro_torch.server import FairdServer

    write_token_corpus(str(tmp_path / "c.jsonl"), docs=12, seed=3)
    net = LocalNetwork()
    srv = FairdServer("h:1", executor=ExecutorConfig(device="cpu"))
    srv.catalog.register_path("c", str(tmp_path))
    net.register(srv)
    client = net.client_for("h:1")
    dag = training_dag("dacp://h:1/c/c.jsonl", seq_len=32, batch_rows=4)
    cpu = list(TorchFeed(lambda: client.cook(dag), "tokens", 33, 4, device="cpu"))
    gpu = list(TorchFeed(lambda: client.cook(dag), "tokens", 33, 4, device=dev))
    assert len(cpu) == len(gpu) == 3
    for a, b in zip(cpu, gpu):
        assert b["tokens"].device.type == "cuda"
        assert torch.equal(a["tokens"], b["tokens"].cpu()) and torch.equal(a["labels"], b["labels"].cpu())


# ---------------------------------------------------------------------------
# the SSD and mLSTM kernels and the zamba2 / xlstm models on them
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "b,s,h,p,n,chunk,dtype",
    [
        (4, 1024, 64, 64, 64, 256, torch.bfloat16),  # zamba2-1.2b prefill, one layer
        (2, 1000, 8, 64, 64, 256, torch.bfloat16),  # ragged tail chunk
        (2, 100, 3, 32, 16, 32, torch.float32),  # reduced widths
        (1, 77, 2, 64, 32, 64, torch.float32),
        (2, 5, 2, 32, 16, 256, torch.float32),
        (1, 4096, 8, 64, 64, 256, torch.bfloat16),  # 16 chunks: the carry over many
        (2, 100, 8, 64, 64, 256, torch.bfloat16),  # shorter than one chunk
        (2, 300, 8, 64, 32, 96, torch.bfloat16),  # chunk 96: no multiple of 64
        (2, 200, 8, 32, 16, 64, torch.bfloat16),  # p 32, n 16
        (1, 1000, 6, 64, 64, 128, torch.bfloat16),  # ragged tail, heads no multiple of the block's 4
    ],
)
def test_ssd_scan_kernel(dev, b, s, h, p, n, chunk, dtype):
    """y and the final state within tests/test_kernels.py's 2e-4: both sides
    compute in float32 from the same inputs."""
    from repro_torch.kernels.ssd_scan import launches as ssd_launches
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    rng = np.random.default_rng(s + p + n)
    x = _randn(rng, (b, s, h, p), dtype, dev)
    dt = torch.from_numpy((np.abs(rng.standard_normal((b, s, h))) * 0.1).astype(np.float32)).to(dev)
    A = torch.from_numpy(-np.abs(rng.standard_normal(h)).astype(np.float32)).to(dev)
    B, C = _randn(rng, (b, s, n), dtype, dev), _randn(rng, (b, s, n), dtype, dev)
    before = ssd_launches.value
    got = ssd_scan(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert ssd_launches.value == before + 1
    for g, w in zip(got, ssd_scan_plain(x, dt, A, B, C, chunk)):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize(
    "b,s,h,d,chunk,dtype",
    [
        (4, 1024, 4, 384, 256, torch.bfloat16),  # xlstm-125m prefill, one layer
        (2, 1000, 2, 384, 256, torch.float32),  # ragged tail chunk
        (2, 100, 3, 64, 32, torch.float32),  # reduced width
        (2, 64, 2, 32, 16, torch.bfloat16),
        (1, 130, 2, 128, 64, torch.float32),
        (1, 70, 1, 256, 256, torch.float32),
    ],
)
def test_mlstm_chunk_kernel(dev, b, s, h, d, chunk, dtype):
    """y and the final (C, n, m) within tests/test_kernels.py's 5e-4."""
    from repro_torch.kernels.mlstm_chunk import launches as mlstm_launches
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk, mlstm_chunk_plain

    rng = np.random.default_rng(s + d)
    q, k, v = (_randn(rng, (b, s, h, d), dtype, dev) for _ in range(3))
    li = torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32)).to(dev)
    lf = torch.from_numpy((rng.standard_normal((b, s, h)) - 1.0).astype(np.float32)).to(dev)
    before = mlstm_launches.value
    got = mlstm_chunk(q, k, v, li, lf, chunk)
    torch.cuda.synchronize()
    assert mlstm_launches.value == before + 1
    for g, w in zip(got, mlstm_chunk_plain(q, k, v, li, lf, chunk)):
        torch.testing.assert_close(g, w, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize(
    "s,d,chunk",
    [
        (256, 384, 256),  # one chunk
        (1024, 384, 256),  # four chunks, as xlstm-125m's prefill
        (1000, 384, 256),  # ragged last chunk
        (100, 32, 16),  # narrow head, short chunks
        (300, 128, 100),  # chunks that are no multiple of the 64-row key tile
    ],
)
def test_mlstm_chunk_bf16_kernel_chunks(dev, s, d, chunk):
    """The two-pass tensor-core kernels against the plain version, y and the
    final (C, n, m) within 5e-4."""
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk, mlstm_chunk_plain

    rng = np.random.default_rng(s * 5 + d)
    b, h = 2, 2
    q, k, v = (_randn(rng, (b, s, h, d), torch.bfloat16, dev) for _ in range(3))
    li = torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32)).to(dev)
    lf = torch.from_numpy((rng.standard_normal((b, s, h)) - 1.0).astype(np.float32)).to(dev)
    got = mlstm_chunk(q, k, v, li, lf, chunk)
    torch.cuda.synchronize()
    for g, w in zip(got, mlstm_chunk_plain(q, k, v, li, lf, chunk)):
        torch.testing.assert_close(g, w, rtol=5e-4, atol=5e-4)


def test_scan_kernels_refuse_bad_arguments(dev, monkeypatch):
    """An unsupported width raises before launch; a chunk the C entry point
    refuses raises after it, and the launch does not count."""
    import sys

    from repro_torch.kernels import ops
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    from repro_torch.kernels.ssd_scan import ssd_scan

    ssd_mod = sys.modules["repro_torch.kernels.ssd_scan"]  # the package re-exports the function under its name
    x = torch.zeros((1, 600, 2, 48), device=dev)
    dt = torch.zeros((1, 600, 2), device=dev)
    A = -torch.ones(2, device=dev)
    B = torch.zeros((1, 600, 16), device=dev)
    with pytest.raises(ValueError, match="takes p in"):
        ssd_scan(x, dt, A, B, B)
    with pytest.raises(ValueError, match="head dims"):
        mlstm_chunk(x, x, x, dt, dt)
    before = ops.LAUNCHES["ssd_scan"].value
    monkeypatch.setattr(ssd_mod, "MAX_CHUNK", 1024)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ssd_scan(x[..., :32].contiguous(), dt, A, B, B, chunk=512)
    assert ops.LAUNCHES["ssd_scan"].value == before


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m"])
def test_hybrid_kernel_path_matches_plain_path_on_the_card(dev, arch):
    """Reduced zamba2 and xlstm in float32 on the card: prefill and three
    decode steps through the kernels against the plain versions, with the
    exact launch counts of each path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build

    cfg = get_config(arch).reduced()
    kern, plain = build(cfg), build(cfg, ops.PLAIN)
    params = kern.init(torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 259, (3, 75)).astype(np.int32)).to(dev)
    for c in ops.LAUNCHES.values():
        c.reset()
    got, cache_k = kern.prefill(params, {"tokens": tokens[:, :70]}, 80)
    want, cache_p = plain.prefill(params, {"tokens": tokens[:, :70]}, 80)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for i in range(3):
        tok = tokens[:, 70 + i : 71 + i]
        got, cache_k = kern.decode_step(params, tok, cache_k)
        want, cache_p = plain.decode_step(params, tok, cache_p)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    counts = {n: c.value for n, c in ops.LAUNCHES.items() if c.value}
    if arch.startswith("zamba2"):
        n_attn = cfg.n_layers // cfg.attn_every
        assert counts == {"ssd_scan": cfg.n_layers, "flash_attention": n_attn, "decode_attention": 3 * n_attn,
                          "gated_rmsnorm": 4 * cfg.n_layers,  # prefill and three decode steps
                          "causal_conv_silu": 3 * 4 * cfg.n_layers,  # x, B and C a layer a forward
                          "rms_norm": 4 * (cfg.n_layers + 2 * n_attn + 1)}  # a layer's, ln_a and ln_m, the final
        torch.testing.assert_close(cache_k["ssm"]["ssm"], cache_p["ssm"]["ssm"], rtol=1e-4, atol=1e-4)
    else:
        n_m = sum((li + 1) % cfg.slstm_every != 0 for li in range(cfg.n_layers))
        assert counts == {"mlstm_chunk": n_m, "causal_conv_silu": 4 * cfg.n_layers,  # one a block a forward
                          "rms_norm": 4 * cfg.n_layers}  # each block's inner norm a forward


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "whisper-small"])
def test_moe_and_encdec_kernel_path_matches_plain_path_on_the_card(dev, arch):
    """Reduced MoE LMs and the reduced encoder-decoder in float32 on the
    card: prefill and three decode steps through the kernels against the
    plain versions, with the exact launch counts of each path (whisper: one
    flash launch per encoder layer and two per decoder layer per prefill,
    two decode launches per decoder layer per step)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build

    cfg = get_config(arch).reduced()
    kern, plain = build(cfg), build(cfg, ops.PLAIN)
    params = kern.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, 259, (3, 45)).astype(np.int32)).to(dev)
    batch = {"tokens": tokens[:, :40]}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rng.normal(size=(3, cfg.enc_seq, cfg.d_model)).astype(np.float32)).to(dev)
    for c in ops.LAUNCHES.values():
        c.reset()
    got, cache_k = kern.prefill(params, batch, 48)
    want, cache_p = plain.prefill(params, batch, 48)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for i in range(3):
        tok = tokens[:, 40 + i : 41 + i]
        got, cache_k = kern.decode_step(params, tok, cache_k)
        want, cache_p = plain.decode_step(params, tok, cache_p)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    counts = {n: c.value for n, c in ops.LAUNCHES.items() if c.value}
    if cfg.is_encdec:
        assert counts == {"flash_attention": cfg.encoder_layers + 2 * cfg.n_layers, "decode_attention": 6 * cfg.n_layers}
        torch.testing.assert_close(cache_k["cross_k"], cache_p["cross_k"], rtol=1e-5, atol=1e-5)
    else:  # ln1 and ln2 a layer and the final norm a forward
        assert counts == {"flash_attention": cfg.n_layers, "decode_attention": 3 * cfg.n_layers,
                          "rms_norm": 4 * (2 * cfg.n_layers + 1)}
    torch.testing.assert_close(cache_k["k"], cache_p["k"], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# gradients through the model kernels, and training steps on the card
# ---------------------------------------------------------------------------
def _grads(fn, inputs, gouts, used):
    args = [t.detach().requires_grad_(True) for t in inputs]
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return outs, torch.autograd.grad([outs[i] for i in used], args, [gouts[i] for i in used], allow_unused=True)


def _kernel_case(kernel, dtype, dev, rng):
    """(kernel, plain version, inputs, forward tolerance) at reduced shapes."""
    from repro_torch.kernels import ops

    if kernel == "flash_attention":
        q, k, v = (_randn(rng, sh, dtype, dev) for sh in ((2, 2, 2, 130, 64), (2, 2, 130, 64), (2, 2, 130, 64)))
        return ops.flash_attention, ops.flash_attention_plain, (q, k, v), _attn_tol(dtype)["rtol"]
    if kernel == "causal_conv_silu":  # zamba2-7b's B/C width with a bias and a state: y and the next state
        x, w, st, bias = (_randn(rng, sh, dtype, dev) for sh in ((2, 100, 128), (4, 128), (2, 3, 128), (128,)))
        return ops.causal_conv_silu, ops.causal_conv_silu_plain, (x, w, st, bias), 2.0**-8 if dtype == torch.bfloat16 else 2.0**-20
    if kernel == "rms_norm":  # reduced zamba2-7b's ln_a width; the backward is the plain version's
        x, scale = _randn(rng, (2, 100, 256), dtype, dev), _randn(rng, (256,), dtype, dev)
        fn = functools.partial(ops.rms_norm, eps=1e-5)
        plain = functools.partial(ops.rms_norm_plain, eps=1e-5)
        return fn, plain, (x, scale), 2.0**-8 if dtype == torch.bfloat16 else 2.0**-20
    if kernel == "gated_rmsnorm":  # reduced zamba2-7b's two groups; the backward is the plain version's
        y = _randn(rng, (2, 100, 8, 32), torch.float32, dev)
        x, z = _randn(rng, (2, 100, 8, 32), dtype, dev), _randn(rng, (2, 100, 256), dtype, dev)
        D, scale = _randn(rng, (8,), torch.float32, dev), _randn(rng, (256,), dtype, dev)
        fn = functools.partial(ops.gated_rmsnorm, groups=2, eps=1e-5)
        plain = functools.partial(ops.gated_rmsnorm_plain, groups=2, eps=1e-5)
        return fn, plain, (y, x, z, D, scale), 2.0**-8 if dtype == torch.bfloat16 else 2.0**-20
    if kernel == "ssd_scan":
        x, B, C = (_randn(rng, sh, dtype, dev) for sh in ((2, 300, 8, 32), (2, 300, 16), (2, 300, 16)))
        dt = torch.from_numpy((np.abs(rng.standard_normal((2, 300, 8))) * 0.1).astype(np.float32)).to(dev)
        A = torch.from_numpy(-np.exp(rng.uniform(0.0, np.log(16.0), 8)).astype(np.float32)).to(dev)
        return ops.ssd_scan, ops.ssd_scan_plain, (x, dt, A, B, C), 2e-4
    q, k, v = (_randn(rng, (2, 100, 2, 64), dtype, dev) for _ in range(3))
    li = torch.from_numpy(rng.standard_normal((2, 100, 2)).astype(np.float32)).to(dev)
    lf = torch.from_numpy((rng.standard_normal((2, 100, 2)) - 1.0).astype(np.float32)).to(dev)
    return ops.mlstm_chunk, ops.mlstm_chunk_plain, (q, k, v, li, lf), 5e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "kernel", ["flash_attention", "ssd_scan", "mlstm_chunk", "gated_rmsnorm", "causal_conv_silu", "rms_norm"]
)
def test_model_kernel_gradients_match_plain_version_on_the_card(dev, kernel, dtype):
    """On card tensors that need a gradient each kernel launches once and
    returns outputs with a grad_fn; the input gradients (every output used,
    then the first alone) hold to the plain version's within the forward
    tolerance of max |grad|."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(17)
    fn, plain, inputs, tol = _kernel_case(kernel, dtype, dev, rng)
    outs = plain(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gouts = [_randn(rng, tuple(o.shape), o.dtype, dev) for o in outs]
    for used in (range(len(outs)), (0,)):
        before = ops.LAUNCHES[kernel].value
        got_outs, got = _grads(fn, inputs, gouts, used)
        assert ops.LAUNCHES[kernel].value == before + 1
        assert all(o.grad_fn is not None for o in got_outs)
        _, want = _grads(plain, inputs, gouts, used)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert float((g.float() - w.float()).abs().max()) <= tol * float(w.float().abs().max())


def test_decode_attention_refuses_a_gradient_on_the_card(dev):
    from repro_torch.kernels import ops

    rng = np.random.default_rng(5)
    q, k, v = (_randn(rng, sh, torch.bfloat16, dev) for sh in ((2, 2, 2, 64), (2, 2, 64, 64), (2, 2, 64, 64)))
    before = ops.LAUNCHES["decode_attention"].value
    with pytest.raises(RuntimeError, match="decode_attention"):
        ops.decode_attention(q.requires_grad_(True), k, v, 64)
    assert ops.LAUNCHES["decode_attention"].value == before
    with torch.no_grad():
        assert ops.decode_attention(q, k, v, 64).shape == (2, 2, 2, 64)


@pytest.mark.parametrize("arch", ["granite-3-8b", "xlstm-125m"])
def test_train_step_kernel_path_matches_plain_path_on_the_card(dev, arch):
    """A reduced configuration in float32 on the card (remat on): one loss
    + backward and one train step (two microbatches) through the kernels
    and through the plain versions from the same weights and batch.  The
    losses are finite; the kernel path launches its kernels (a recomputed
    attention block launches again; xlstm has no remat) and the plain path
    none; loss, grad norm and every gradient leaf agree within the CPU
    tests' tolerances (1e-4 attention, 5e-4 mLSTM, of the largest
    gradient)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.optim.accumulate import value_and_grad
    from repro_torch.train import make_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
    tol = 1e-4 if arch.startswith("granite") else 5e-4
    if arch.startswith("granite"):  # remat runs each block's two norms again; the final norm once
        per_micro = {"flash_attention": 2 * cfg.n_layers, "rms_norm": 4 * cfg.n_layers + 1}
    else:  # every xlstm block's conv and inner norm, the mLSTM blocks' chunk scans
        per_micro = {"mlstm_chunk": sum((li + 1) % cfg.slstm_every != 0 for li in range(cfg.n_layers)),
                     "causal_conv_silu": cfg.n_layers, "rms_norm": cfg.n_layers}
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 259, (4, 65)).astype(np.int64)).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    lk, _, gk = value_and_grad(build(cfg).loss_fn, params, batch)
    lp, _, gp = value_and_grad(build(cfg, ops.PLAIN).loss_fn, params, batch)
    assert np.isfinite(float(lk)) and abs(float(lk) - float(lp)) <= tol * abs(float(lp))
    scale = max(float(g.abs().max()) for g in tree_leaves(gp))
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        assert float((a - b).abs().max()) <= tol * scale
    opt = AdamWConfig(lr=warmup_cosine(1e-3, 1, 4))
    metrics = []
    for kernels, launches in ((ops.KERNELS, {k: 2 * n for k, n in per_micro.items()}), (ops.PLAIN, {})):
        for c in ops.LAUNCHES.values():
            c.reset()
        state = make_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(0), device=dev)
        _, m = make_train_step(cfg, opt, 2, kernels=kernels)(state, batch)
        torch.cuda.synchronize()
        assert {n: c.value for n, c in ops.LAUNCHES.items() if c.value} == launches
        assert np.isfinite(float(m["loss"]))
        metrics.append(m)
    for key in ("loss", "grad_norm"):
        assert abs(float(metrics[0][key]) - float(metrics[1][key])) <= tol * float(metrics[1][key])


# ---------------------------------------------------------------------------
# the distributed collectives: four gloo ranks on the one card
# ---------------------------------------------------------------------------
_DIST_SCRIPT = r"""
import os, sys
sys.path.insert(0, sys.argv[3])
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.collectives import compressed_psum, seq_sharded_decode_attention
    from repro_torch.kernels.decode_attention import decode_attention_partials

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = init_device_mesh("cuda", (4,), mesh_dim_names=("data",))
    gq = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((2, 4, 4, 64), generator=gq, device=dev, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(10 + rank)
    k = torch.randn((2, 4, 96, 64), generator=g, device=dev, dtype=torch.bfloat16)
    v = torch.randn((2, 4, 96, 64), generator=g, device=dev, dtype=torch.bfloat16)
    got = seq_sharded_decode_attention(mesh, q, k, v, 300, seq_axis="data")
    kernel = seq_sharded_decode_attention(mesh, q, k, v, 300, seq_axis="data", partials=decode_attention_partials)
    x = torch.randn((512, 96), generator=g, device=dev, dtype=torch.float32)
    card = compressed_psum(mesh, x, axis="data")
    cpu = compressed_psum(mesh, x.cpu(), axis="data")
    if rank == 0:
        torch.save({"out": got.float().cpu(), "kernel": kernel.float().cpu(), "card": card.cpu(), "cpu": cpu}, out)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(rank_main, args=(int(sys.argv[1]), sys.argv[2]), nprocs=4, start_method="spawn")
"""


def test_seq_sharded_decode_and_int8_psum_over_four_gloo_ranks_on_the_card(dev, tmp_path):
    """8a-8b of chip_smoke.py at a small size: the decode sharded over four
    gloo ranks (CUDA tensors, one card), with the plain partials and with
    the kernel's (``decode_attention_partials``), against one
    ``decode_attention`` launch over the whole cache (bf16 tolerance), and
    ``compressed_psum`` on card tensors equal bit for bit to the same gloo
    ranks on CPU tensors."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.kernels import ops

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    root = Path(__file__).resolve().parents[1]
    script = tmp_path / "ranks.py"
    script.write_text(_DIST_SCRIPT)
    out = tmp_path / "out.pt"
    res = subprocess.run([sys.executable, str(script), str(port), str(out), str(root / "src")], capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    got = torch.load(out)
    gq = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((2, 4, 4, 64), generator=gq, device=dev, dtype=torch.bfloat16)
    ks, vs = [], []
    for rank in range(4):
        g = torch.Generator(device=dev).manual_seed(10 + rank)
        ks.append(torch.randn((2, 4, 96, 64), generator=g, device=dev, dtype=torch.bfloat16))
        vs.append(torch.randn((2, 4, 96, 64), generator=g, device=dev, dtype=torch.bfloat16))
    before = ops.LAUNCHES["decode_attention"].value
    want = ops.decode_attention(q, torch.cat(ks, dim=2), torch.cat(vs, dim=2), 301).float().cpu()
    assert ops.LAUNCHES["decode_attention"].value == before + 1
    peak = float(want.abs().max())  # and within chip_smoke.py's limit: 4 half ulps of bf16 at the peak
    for name in ("out", "kernel"):
        torch.testing.assert_close(got[name], want, rtol=2e-2, atol=2e-2)
        assert peak > 0 and float((got[name] - want).abs().max()) <= 4 * 2.0**-8 * peak
    assert torch.equal(got["card"].view(torch.int32), got["cpu"].view(torch.int32))


def test_decode_on_card_dtensors_launches_the_kernel_or_raises(dev):
    """The models' decode on card DTensors (``per_shard.on_shards``, world 1):
    a cache laid out by batch and heads launches ``decode_attention`` on
    each rank's shard; a cache sharded over its positions launches the
    kernel's partials (``decode_attention_partials``) once and merges them,
    equal to the whole-cache launch within the attention tolerance, and no
    plain version runs in its place.  (A position-sharded cache on card
    tensors raised here before the kernel handed out its partials.)"""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed import collectives
    from repro_torch.distributed.per_shard import on_shards
    from repro_torch.kernels import ops

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        g = torch.Generator(device=dev).manual_seed(3)
        q = torch.randn((2, 4, 4, 64), generator=g, device=dev, dtype=torch.bfloat16)
        k = torch.randn((2, 4, 128, 64), generator=g, device=dev, dtype=torch.bfloat16)
        v = torch.randn((2, 4, 128, 64), generator=g, device=dev, dtype=torch.bfloat16)
        decode = on_shards(ops.KERNELS).decode_attention
        with torch.no_grad():
            want = ops.decode_attention(q, k, v, 100)
            before = ops.LAUNCHES["decode_attention"].value
            got = decode(q, DTensor.from_local(k, mesh, (Shard(0),)), DTensor.from_local(v, mesh, (Shard(0),)), 100)
            assert ops.LAUNCHES["decode_attention"].value == before + 1
            assert torch.equal(got.to_local(), want)
            kd, vd = DTensor.from_local(k, mesh, (Shard(2),)), DTensor.from_local(v, mesh, (Replicate(),))
            plain = collectives.partial_decode_attention
            collectives.partial_decode_attention = None  # the plain partials must not run on card tensors
            try:
                merged = decode(q, kd, vd, 100)
            finally:
                collectives.partial_decode_attention = plain
            assert ops.LAUNCHES["decode_attention"].value == before + 2
            assert isinstance(merged, DTensor) and merged.to_local().device == dev
            torch.testing.assert_close(merged.to_local().float(), want.float(), rtol=2e-2, atol=2e-2)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# zamba2-7b: attention at head dim 224 with the caller's scale, the SSD scan in B/C groups, and the model at its
# published widths against the plain float32 reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "b,kv,s,dtype,scale",
    [
        (1, 32, 2048, torch.bfloat16, 112**-0.5),  # zamba2-7b's shared block: 32 heads of 224, scale (224/2)^-0.5
        (2, 4, 300, torch.float32, 0.3),
        (1, 8, 1000, torch.bfloat16, None),
    ],
)
def test_flash_attention_kernel_at_head_dim_224(dev, b, kv, s, dtype, scale):
    """Run as 256 on zero-padded copies: within the kernel's usual tolerances
    of the plain version at 224, one launch counted as padded."""
    import sys

    fa = sys.modules["repro_torch.kernels.flash_attention"]  # the package's own name is the wrapper function
    rng = np.random.default_rng(s)
    q = _randn(rng, (b, s, kv, 1, 224), dtype, dev).permute(0, 2, 3, 1, 4)  # the model's view
    k, v = _randn(rng, (b, kv, s, 224), dtype, dev), _randn(rng, (b, kv, s, 224), dtype, dev)
    before, padded = fa.launches.value, fa.padded_launches.value
    got = fa.flash_attention(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    assert fa.launches.value == before + 1 and fa.padded_launches.value == padded + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = fa.flash_attention_plain(q, k, v, True, scale)
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


@pytest.mark.parametrize(
    "b,g,t,length,dtype,scale",
    [
        (2, 1, 4096, 1025, torch.bfloat16, 112**-0.5),  # zamba2-7b's decode: MHA, G 1
        (2, 2, 300, 129, torch.float32, 0.2),
        (1, 1, 4096, 4096, torch.bfloat16, None),
    ],
)
def test_decode_attention_kernel_at_head_dim_224(dev, b, g, t, length, dtype, scale):
    import sys

    da = sys.modules["repro_torch.kernels.decode_attention"]  # the package's own name is the wrapper function
    rng = np.random.default_rng(t + length)
    q = _randn(rng, (b, 32, g, 224), dtype, dev)
    k, v = _randn(rng, (b, 32, t, 224), dtype, dev), _randn(rng, (b, 32, t, 224), dtype, dev)
    before, padded = da.launches.value, da.padded_launches.value
    got = da.decode_attention(q, k, v, length, scale=scale)
    torch.cuda.synchronize()
    assert da.launches.value == before + 1 and da.padded_launches.value == padded + 1
    want = da.decode_attention_plain(q, k, v, length, scale)
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


@pytest.mark.parametrize(
    "b,s,h,p,n,g,chunk,dtype",
    [
        (1, 4096, 112, 64, 64, 2, 256, torch.bfloat16),  # zamba2-7b: 112 heads reading 2 groups, 16 chunks
        (2, 1000, 8, 64, 64, 2, 256, torch.bfloat16),  # ragged tail
        (2, 300, 8, 32, 16, 2, 64, torch.float32),
        (2, 200, 6, 32, 16, 3, 64, torch.float32),  # 2 heads a group
    ],
)
def test_ssd_scan_kernel_in_groups(dev, b, s, h, p, n, g, chunk, dtype):
    """B and C (b, s, g, n): within test_ssd_scan_kernel's 2e-4 of the plain
    version, which scans each group's heads in turn."""
    import sys

    ssd = sys.modules["repro_torch.kernels.ssd_scan"]  # the package's own name is the wrapper function
    rng = np.random.default_rng(s + h + g)
    x = _randn(rng, (b, s, h, p), dtype, dev)
    dt = torch.from_numpy((np.abs(rng.standard_normal((b, s, h))) * 0.1).astype(np.float32)).to(dev)
    A = torch.from_numpy(-np.abs(rng.standard_normal(h)).astype(np.float32)).to(dev)
    B, C = _randn(rng, (b, s, g, n), dtype, dev), _randn(rng, (b, s, g, n), dtype, dev)
    before, grouped = ssd.launches.value, ssd.grouped_launches.value
    got = ssd.ssd_scan(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert ssd.launches.value == before + 1 and ssd.grouped_launches.value == grouped + 1
    for a, w in zip(got, ssd.ssd_scan_plain(x, dt, A, B, C, chunk)):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize(
    "b,s,h,p,groups,scale_dtype",
    [
        (3, 4096, 112, 64, 2, None),  # zamba2-7b's longest forward in the scoring cell
        (4, 1024, 64, 64, 1, None),  # zamba2-1.2b: one group over all 4096 channels
        (4, 1024, 64, 64, 1, torch.float32),  # float32 parameters under bfloat16 activations
        (1, 1, 112, 64, 2, None),  # decode, one row
        (4, 1, 112, 64, 2, None),  # decode, four rows
        (3, 333, 112, 64, 2, None),  # an odd row count
        (2, 75, 8, 32, 2, None),  # reduced zamba2-7b
    ],
)
def test_gated_rmsnorm_kernel_matches_plain_version(dev, b, s, h, p, groups, scale_dtype, dtype):
    """One launch; every element within ``gated_norm.ULPS`` units in the last
    place of the plain version on the card."""
    import sys

    gn = sys.modules["repro_torch.kernels.gated_norm"]
    rng = np.random.default_rng(b * s + h + groups)
    y = _randn(rng, (b, s, h, p), torch.float32, dev)
    x = _randn(rng, (b, s, h, p), dtype, dev)
    z = (2 * _randn(rng, (b, s, h * p), torch.float32, dev)).to(dtype)
    D = _randn(rng, (h,), torch.float32, dev) + 1
    scale = (0.1 * _randn(rng, (h * p,), torch.float32, dev) + 1).to(scale_dtype or dtype)
    before = gn.launches.value
    got = gn.gated_rmsnorm(y, x, z, D, scale, groups, 1e-5)
    torch.cuda.synchronize()
    assert gn.launches.value == before + 1
    want = gn.gated_rmsnorm_plain(y, x, z, D, scale, groups, 1e-5)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape == (b, s, h * p)
    assert bool(torch.isfinite(got.float()).all())
    assert gn.ulps(got, want) <= gn.ULPS[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize(
    "shape,scale_dtype,view",
    [
        ((12288, 3584), None, None),  # zamba2-7b's stream at the scoring cell's longest forward
        ((12288, 4096), None, None),  # granite-4.0-h-small's
        ((12288, 7168), None, None),  # zamba2-7b's ln_a over cat(x, emb)
        ((4, 1, 4096), None, None),  # a decode step
        ((2, 333, 8, 128), None, None),  # q/k norms over the head dim: several rows a block
        ((4, 1, 4096), torch.float32, None),  # float32 parameters under bfloat16 activations
        ((3, 64, 3584), None, "last"),  # prefill's final norm on the last position's strided rows
        ((1000, 8), None, None),  # the narrowest row
        ((999, 520), None, None),  # a block a row with threads past the row's vectors
        ((777, 2048), None, None),  # the widest row at one vector a thread
        ((999, 2056), None, None),  # two vectors a thread, the last thread's second past the row
        ((300, 8192), None, None),  # the widest row
    ],
)
def test_rms_norm_kernel_matches_plain_version(dev, shape, scale_dtype, view, dtype):
    """One launch at each launch shape; every element within
    ``gated_norm.ULPS`` units in the last place of the plain version on the
    card."""
    import sys

    rn, gn = sys.modules["repro_torch.kernels.rms_norm"], sys.modules["repro_torch.kernels.gated_norm"]
    rng = np.random.default_rng(sum(shape))
    x = 3 * _randn(rng, shape, torch.float32, dev)
    x = x.to(dtype)[:, -1:] if view == "last" else x.to(dtype)
    scale = (0.1 * _randn(rng, shape[-1:], torch.float32, dev) + 1).to(scale_dtype or dtype)
    before = rn.launches.value
    got = rn.rms_norm(x, scale, 1e-5)
    torch.cuda.synchronize()
    assert rn.launches.value == before + 1
    want = rn.rms_norm_plain(x, scale, 1e-5)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape == x.shape
    assert bool(torch.isfinite(got.float()).all())
    assert gn.ulps(got, want) <= rn.ULPS[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize(
    "b,s,c,k,bias,state",
    [
        (3, 4096, 7168, 4, True, False),  # zamba2-7b's x at the scoring cell's longest forward
        (3, 4096, 128, 4, True, False),  # zamba2-7b's B and C
        (4, 1024, 4096, 4, False, False),  # zamba2-1.2b's x: no bias
        (4, 1024, 64, 4, False, False),  # zamba2-1.2b's B and C
        (4, 1024, 1536, 4, False, False),  # xlstm-125m's mLSTM
        (2, 333, 1001, 4, True, False),  # an odd width: the scalar path
        (4, 1, 7168, 4, True, True),  # a decode step from a state
        (4, 1, 128, 4, True, True),
        (2, 2, 256, 4, False, True),  # fewer positions than the state holds
        (2, 100, 256, 3, True, True),  # shorter filters
        (2, 100, 256, 2, True, False),
        (2, 100, 256, 1, True, False),
    ],
)
def test_causal_conv_silu_kernel_matches_plain_version(dev, b, s, c, k, bias, state, dtype):
    """One launch; y and the next state bit for bit the plain version's on
    the card."""
    import sys

    cc = sys.modules["repro_torch.kernels.causal_conv"]
    raw = lambda t: _bits(t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32))  # noqa: E731
    rng = np.random.default_rng(b * s + c + k)
    x, w = _randn(rng, (b, s, c), dtype, dev), (0.5 * _randn(rng, (k, c), torch.float32, dev)).to(dtype)
    st = _randn(rng, (b, k - 1, c), dtype, dev) if state else None
    bias = _randn(rng, (c,), dtype, dev) if bias else None
    before = cc.launches.value
    got, got_state = cc.causal_conv_silu(x, w, st, bias)
    torch.cuda.synchronize()
    assert cc.launches.value == before + 1
    want, want_state = cc.causal_conv_silu_plain(x, w, st, bias)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape == (b, s, c)
    assert bool(torch.isfinite(got.float()).all())
    assert raw(got) == raw(want)
    if k == 1:
        assert got_state is None and want_state is None
    else:
        assert got_state.shape == want_state.shape == (b, k - 1, c) and raw(got_state) == raw(want_state)


@pytest.mark.parametrize("c", [8, 1], ids=["vector", "scalar"])
def test_causal_conv_silu_kernel_matches_plain_version_on_every_bfloat16_input(dev, c):
    """silu's input in bfloat16 has 65536 values; at K 1 with a unit weight
    the conv hands each of them, NaNs, infinities and subnormals included,
    to silu unchanged: every output bit for bit the plain version's."""
    import sys

    cc = sys.modules["repro_torch.kernels.causal_conv"]
    x = torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).reshape(1, -1, c)
    x, w = x.to(dev), torch.ones((1, c), dtype=torch.bfloat16, device=dev)
    got, _ = cc.causal_conv_silu(x, w)
    want, _ = cc.causal_conv_silu_plain(x, w)
    bad = (got.view(torch.int16) != want.view(torch.int16)).nonzero()
    assert bad.numel() == 0, [hex(int(x.view(torch.int16)[tuple(i)]) & 0xFFFF) for i in bad[:8].tolist()]


def test_zamba2_7b_at_its_published_widths_prefill_and_decode_match_the_reference(dev):
    """7,356,749,648 parameters in bfloat16 from the seed; prefill of one
    document of 1000 tokens, then 16 decode steps through the cache, with
    the CUDA kernels (13 hd-224 flash launches at prefill, 81 grouped scans,
    13 decode launches a step, 81 gated RMSNorms, 243 convs and 108
    RMSNorms a forward).  The 17 positions' logits against the plain
    float32 reference's forward over the 1016 tokens, run layer by layer on
    the program's weights.  Random weights amplify bfloat16's rounding over
    81 layers: an H100 measured 0.30 largest and 0.085 mean absolute
    difference (of logits up to 4.9); held to 0.75 and 0.2, which the
    reference in float8 products (4.6 and 0.53) fails."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from perfbench import harness
    from perfbench.reference import zamba2 as reference
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model_zoo import build
    from repro_torch.tree import tree_leaves

    cfg = get_config("zamba2-7b")
    conf = harness.load_json(harness.BENCH / "configs" / "zamba2-7b.json")
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(2**31 + 7), dev)
    assert sum(t.numel() for t in tree_leaves(params)) == cfg.n_params() == 7_356_749_648
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, 1016)).to(dev)
    counts = {name: ops.LAUNCHES[name].value for name in ("flash_attention_padded", "ssd_scan_grouped",
                                                          "decode_attention_padded", "gated_rmsnorm",
                                                          "causal_conv_silu", "rms_norm")}
    with torch.no_grad():
        last, cache = api.prefill(params, {"tokens": toks[None, :1000]}, 1016)
        assert cache["kv"]["k"].shape == (13, 1, 32, 1016, 224) and cache["ssm"]["ssm"].shape == (81, 1, 112, 64, 64)
        got = [last[0, -1].float()]
        for i in range(16):
            logits, cache = api.decode_step(params, toks[None, 1000 + i : 1001 + i], cache)
            got.append(logits[0, -1].float())
        got = torch.stack(got)
        want = reference.forward(params, toks, conf)[999:]
        low = reference.forward(params, toks, conf, fp8=True)[999:]
    assert ops.LAUNCHES["flash_attention_padded"].value - counts["flash_attention_padded"] == 13
    assert ops.LAUNCHES["ssd_scan_grouped"].value - counts["ssd_scan_grouped"] == 81
    assert ops.LAUNCHES["decode_attention_padded"].value - counts["decode_attention_padded"] == 13 * 16
    assert ops.LAUNCHES["gated_rmsnorm"].value - counts["gated_rmsnorm"] == 81 * (1 + 16)  # 81 a forward
    assert ops.LAUNCHES["causal_conv_silu"].value - counts["causal_conv_silu"] == 243 * (1 + 16)  # x, B, C: 243 a forward
    assert ops.LAUNCHES["rms_norm"].value - counts["rms_norm"] == 108 * (1 + 16)  # 81 + 2 · 13 + 1 a forward
    err = (got - want).abs()
    assert float(err.max()) <= 0.75 and float(err.mean()) <= 0.2, (float(err.max()), float(err.mean()))
    low_err = (low - want).abs()
    assert float(low_err.max()) > 0.75 or float(low_err.mean()) > 0.2


def test_granite_4_0_h_small_at_its_published_widths_launches_each_kernel_once_a_layer(dev):
    """32,207,337,984 parameters in bfloat16 from the seed; one forward of
    256 tokens through the kernels: 36 Mamba2 layers (one ``ssd_scan`` at
    d_state 128, one ``gated_rmsnorm`` and three convs each), 4 attention
    layers, 40 MoE layers (two grouped products each) and 81 RMSNorms (ln1
    and ln2 a layer, the final norm), and finite logits.  ``chip_smoke.py``
    (phase 5b) holds this model's logits to the plain path's and to the
    float32 reference's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model_zoo import build

    cfg = get_config("granite-4.0-h-small")
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(2**31 + 9), dev)
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (1, 256))).to(dev)
    try:
        with torch.no_grad():
            before = {name: c.value for name, c in ops.LAUNCHES.items()}
            logits, _ = api.forward(params, {"tokens": toks})
            torch.cuda.synchronize()
            launches = {name: c.value - before[name] for name, c in ops.LAUNCHES.items() if c.value > before[name]}
        assert launches == {"ssd_scan": 36, "ssd_scan_n128": 36, "gated_rmsnorm": 36, "causal_conv_silu": 108,
                            "flash_attention": 4, "grouped_mm": 80, "rms_norm": 81}
        assert logits.shape == (1, 256, cfg.vocab_size) and bool(torch.isfinite(logits.float()).all())
    finally:
        del params
        torch.cuda.empty_cache()


# granite-4.0-h-small: the SSD scan at d_state 128 in one group, and the dropless MoE's grouped expert products
@pytest.mark.parametrize(
    "b,s,h,p,chunk,dtype",
    [
        (3, 4096, 128, 64, 256, torch.bfloat16),  # granite-4.0-h-small's longest forward in the scoring cell
        (2, 1000, 128, 64, 256, torch.bfloat16),  # ragged tail chunk
        (1, 300, 8, 64, 256, torch.bfloat16),  # one ragged chunk
        (2, 700, 8, 32, 256, torch.bfloat16),  # p 32
        (1, 1000, 6, 64, 128, torch.bfloat16),  # heads no multiple of the block's 4
        (2, 600, 8, 64, 256, torch.float32),
        (2, 300, 4, 32, 96, torch.float32),  # chunk 96, ragged
    ],
)
def test_ssd_scan_kernel_at_d_state_128(dev, b, s, h, p, chunk, dtype):
    """n = 128, one B/C group (b, s, n): within test_ssd_scan_kernel's 2e-4
    of the plain version, each launch counted at n = 128."""
    import sys

    ssd = sys.modules["repro_torch.kernels.ssd_scan"]
    rng = np.random.default_rng(s + h + p)
    x = _randn(rng, (b, s, h, p), dtype, dev)
    dt = torch.from_numpy((np.abs(rng.standard_normal((b, s, h))) * 0.1).astype(np.float32)).to(dev)
    A = torch.from_numpy(-np.exp(rng.uniform(0.0, np.log(16.0), h)).astype(np.float32)).to(dev)
    B, C = _randn(rng, (b, s, 128), dtype, dev), _randn(rng, (b, s, 128), dtype, dev)
    before, wide = ssd.launches.value, ssd.wide_state_launches.value
    got = ssd.ssd_scan(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert ssd.launches.value == before + 1 and ssd.wide_state_launches.value == wide + 1
    for a, w in zip(got, ssd.ssd_scan_plain(x, dt, A, B, C, chunk)):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("tokens,dtype", [(4096, torch.bfloat16), (333, torch.float32)], ids=["bf16", "f32"])
def test_dropless_moe_on_the_card_matches_its_plain_loop(dev, tokens, dtype):
    """One MoE layer at granite-4.0-h-small's widths (d 4096, 72 experts of
    768, top 10, the shared MLP of 1536), routed on the card: the grouped
    expert products (``torch._grouped_mm``) against the same dispatch
    through the plain per-expert loop on the same card tensors.  bfloat16,
    the cell's type, runs with no host sync (checked in PyTorch's sync
    debug mode) and lands within 2^-7 of the largest output (each product
    rounded to bf16 in another order); float32 (PyTorch's fallback, which
    reads the segment ends on the host) within 1e-4.  Every assignment is
    counted, none dropped."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.layers import materialize

    cfg = get_config("granite-4.0-h-small")
    params = materialize(moe.moe_spec(cfg, dtype), dev, torch.Generator(device=dev).manual_seed(tokens))
    x = _randn(np.random.default_rng(tokens), (1, tokens, cfg.d_model), dtype, dev)
    before, grouped = moe.STATS.snapshot(), ops.LAUNCHES["grouped_mm"].value
    torch.cuda.set_sync_debug_mode("error" if dtype == torch.bfloat16 else 0)
    try:
        got, _ = moe.moe_apply_dropless(params, x, cfg, "silu", ops.KERNELS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = moe.STATS.snapshot()
    assert ops.LAUNCHES["grouped_mm"].value == grouped + 2
    assert after["assignments"] - before["assignments"] == tokens * 10 and after["dropped"] == before["dropped"]
    want, _ = moe.moe_apply_dropless(params, x, cfg, "silu", ops.PLAIN)
    err = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
    assert err <= (2.0**-7 if dtype == torch.bfloat16 else 1e-4), err
