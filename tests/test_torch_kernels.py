"""The port's data-plane kernels against the JAX reference kernels, bit for
bit (tolerance 0: the bar is byte-identity with numpy).

Each ``repro.kernels.ops`` function runs as ``tests/test_kernels.py`` runs
it on the CPU (Pallas interpret mode); its ``repro_torch.kernels.ops``
counterpart gets the same numpy arrays as CPU tensors, where the wrapper
runs the kernel's plain PyTorch version.  The CUDA kernels themselves are
held to those plain versions on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402
from repro_torch.kernels import project_arith  # noqa: E402

TILE = 256
N = 3 * TILE
N_ROWS = N - 41  # ragged tail: the last tile is partly padding

_NAN_A = np.array([0x7FA00001], np.uint32).view(np.float32)[0]
_NAN_B = np.array([0xFFB00002], np.uint32).view(np.float32)[0]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_bits(ref, port):
    ref = np.asarray(ref)
    port = port.numpy()
    assert ref.shape == port.shape and ref.dtype == port.dtype
    assert ref.tobytes() == port.tobytes()


def _f32_col(rng, n, denormals=True):
    """float32 column with -0.0, NaN payloads, ±inf, denormals (unless asked
    not to) and ties with the 0.5 threshold planted."""
    v = (rng.standard_normal(n) * 3).astype(np.float32)
    v[::37] = -0.0
    v[5::41] = 0.0
    v[7::43] = np.nan
    v[9::47] = _NAN_A
    v[11::53] = np.inf
    v[13::59] = -np.inf
    if denormals:
        v[15::61] = np.float32(1e-45)
    v[17::67] = np.float32(0.5)  # ties with the threshold
    return v


def _i64_col(rng, n):
    v = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    v[:6] = [-(2**63), 2**63 - 1, 0, -1, 2**32, -(2**32)]
    v[6::29] = v[100]  # ties with the threshold below
    return v


def _pred(kind, rng, n=N):
    """(pred planes, t_hi bits, t_lo bits) for a predicate column of n rows."""
    if kind == "f32":
        v = _f32_col(rng, n)
        return v.view(np.int32).reshape(n, 1), int(np.array([0.5], np.float32).view(np.int32)[0]), 0
    if kind == "i32":
        v = rng.integers(-50, 50, n).astype(np.int32)
        v[:2] = [-(2**31), 2**31 - 1]
        return v.reshape(n, 1), 3, 0
    v = _i64_col(rng, n)
    t = int(v[100])
    hi = (v >> 32).astype(np.int32)
    lo = (v & np.int64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    t_lo = ((t & 0xFFFFFFFF) ^ 0x80000000) - (2**32 if ((t & 0xFFFFFFFF) ^ 0x80000000) >= 2**31 else 0)
    return np.stack([hi, lo], axis=1), t >> 32, t_lo


# ---------------------------------------------------------------------------
# filter_select_planes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["f32", "i32", "i64"])
@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge", "eq", "ne"])
def test_filter_select_planes_matches_jax(op, kind):
    rng = np.random.default_rng(["lt", "le", "gt", "ge", "eq", "ne"].index(op) * 3 + ["f32", "i32", "i64"].index(kind))
    pred, t_hi, t_lo = _pred(kind, rng)
    table = rng.integers(-(2**31), 2**31, size=(N, 5), dtype=np.int64).astype(np.int32)
    table[:, 0] = _f32_col(rng, N).view(np.int32)
    scalars = np.array([N_ROWS, t_hi, t_lo], np.int32)
    ref_out, ref_cnt = ref_ops.filter_select_planes(jnp.asarray(pred), jnp.asarray(table), scalars, op=op, kind=kind, tile=TILE)
    out, cnt = port_ops.filter_select_planes(_t(pred), _t(table), scalars, op, kind, tile=TILE)
    _assert_bits(ref_out, out)
    _assert_bits(ref_cnt, cnt)


@pytest.mark.parametrize(
    "tile,d,n,n_rows",
    [
        (128, 3, N, N - 5),
        (32, 3, N, N - 37),  # the smallest tile
        (1024, 3, 2048, 2048 - 100),  # the largest
        (TILE, 1, N, N_ROWS),  # one plane
        (TILE, 3, N, 0),  # no row survives: every tile all zeros, every count 0
        (TILE, 3, N, 2 * TILE),  # n_rows on a tile boundary
    ],
)
def test_filter_select_planes_other_tile(tile, d, n, n_rows):
    rng = np.random.default_rng(5 + tile + d)
    pred, t_hi, t_lo = _pred("f32", rng, n)
    table = rng.integers(-(2**31), 2**31, size=(n, d), dtype=np.int64).astype(np.int32)
    scalars = np.array([n_rows, t_hi, t_lo], np.int32)
    ref = ref_ops.filter_select_planes(jnp.asarray(pred), jnp.asarray(table), scalars, op="gt", kind="f32", tile=tile)
    got = port_ops.filter_select_planes(_t(pred), _t(table), scalars, "gt", "f32", tile=tile)
    for r, g in zip(ref, got):
        _assert_bits(r, g)


# ---------------------------------------------------------------------------
# project_tiles
# ---------------------------------------------------------------------------
_F32_DESCRS = [
    (("add", ("col", 0), ("lit", 273.15)), ("sub", ("mul", ("col", 1), ("lit", 0.5)), ("lit", 1013.0))),
    (("div", ("col", 0), ("col", 1)), ("sub", ("col", 0), ("col", 0)), ("mul", ("col", 1), ("col", 0))),
    (("add", ("col", 0), ("mul", ("lit", 0.1), ("lit", 0.2))),),  # literal-only subtree folds in Python
    (("div", ("add", ("col", 0), ("col", 1)), ("sub", ("col", 1), ("lit", 2.0))),),
]


def _hazard_table(denormals: bool) -> np.ndarray:
    rng = np.random.default_rng(11)
    table = np.stack([_f32_col(rng, N, denormals), _f32_col(rng, N, denormals)], axis=1)
    table[::3, 1] = 0.0
    table[::7, 0] = np.inf
    table[::11, 1] = np.inf
    table[1::11, 0] = 0.0
    return table


@pytest.mark.parametrize("descrs", _F32_DESCRS, ids=range(len(_F32_DESCRS)))
def test_project_tiles_f32_matches_jax(descrs):
    """0/0, inf - inf, 0 * inf, NaN operands and ±0: the port rewrites the
    card's canonical NaN to the host's bits."""
    table = _hazard_table(denormals=False)
    ref = ref_ops.project_tiles(jnp.asarray(table), descrs, tile=TILE)
    got = port_ops.project_tiles(_t(table), descrs, tile=TILE)
    _assert_bits(ref, got)


def test_project_tiles_keeps_denormals_like_numpy():
    """Denormal operands: numpy keeps them (1e-45 / 0 is inf, 1e-45 - 2e-45
    is -1e-45); the JAX kernel on the CPU flushes them to zero, so here the
    bar is numpy itself — the bar the backend parity holds the port to."""
    table = _hazard_table(denormals=True)
    a, b = table[:, 0], table[:, 1]
    descrs = _F32_DESCRS[1] + _F32_DESCRS[3]
    with np.errstate(all="ignore"):
        want = np.stack([a / b, a - a, b * a, (a + b) / (b - 2.0)], axis=1).astype(np.float32)
    got = port_ops.project_tiles(_t(table), descrs, tile=TILE)
    assert (table.view(np.uint32) == 1).any()
    assert got.numpy().tobytes() == want.tobytes()


def test_project_tiles_i32_wraps_like_jax():
    rng = np.random.default_rng(12)
    table = rng.integers(-(2**31), 2**31, size=(N, 2), dtype=np.int64).astype(np.int32)
    descrs = (
        ("mul", ("col", 0), ("col", 1)),
        ("add", ("mul", ("col", 0), ("lit", 3)), ("lit", 1)),
        ("sub", ("col", 1), ("lit", 2**31 - 1)),
    )
    ref = ref_ops.project_tiles(jnp.asarray(table), descrs, tile=TILE)
    got = port_ops.project_tiles(_t(table), descrs, tile=TILE)
    _assert_bits(ref, got)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_project_tiles_both_nan_operands_follow_numpy(op):
    """Both operands NaN: numpy's vectorised loops return the second operand
    (quieted) for add and mul and the first for sub and div.  The port
    follows numpy; the JAX kernel returns the first for all four (a
    reference divergence recorded in PERF.md)."""
    a = np.full(N, _NAN_A)
    b = np.full(N, _NAN_B)
    with np.errstate(invalid="ignore"):
        want = {"add": np.add, "sub": np.subtract, "mul": np.multiply, "div": np.divide}[op](a, b)
    got = port_ops.project_tiles(_t(np.stack([a, b], axis=1)), ((op, ("col", 0), ("col", 1)),), tile=TILE)
    assert got[:, 0].numpy().tobytes() == want.tobytes()


def test_project_program_limits_are_declared_before_launch():
    deep = ("col", 0)
    for _ in range(project_arith.STACK_MAX):
        deep = ("add", ("col", 0), deep)  # right-leaning: one stack slot per level
    assert not project_arith.fits(deep)
    assert project_arith.fits(("add", ("col", 0), ("lit", 1.0)))
    assert not project_arith.fits(("add", ("lit", 1.0), ("lit", 2.0)))  # folds to a constant
    assert not project_arith.fits(("mul", ("col", 0), ("lit", 2**40)), "int32")


# ---------------------------------------------------------------------------
# segment_sum_tiles / segment_minmax_tiles
# ---------------------------------------------------------------------------
def _limbs(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    cols = [((v >> (8 * k)) & 0xFF).astype(np.int32) for k in range(7)] + [(v >> 56).astype(np.int32)]
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("ngroups", [1, 8, 200, 256])
@pytest.mark.parametrize("cols", [1, 2])
def test_segment_sum_tiles_matches_jax(ngroups, cols):
    rng = np.random.default_rng(ngroups * 10 + cols)
    gidx = rng.integers(0, ngroups, N).astype(np.int32)
    limbs = np.concatenate([_limbs(_i64_col(rng, N)) for _ in range(cols)], axis=1)
    ref = ref_ops.segment_sum_tiles(jnp.asarray(gidx), jnp.asarray(limbs), N_ROWS, ngroups, tile=TILE)
    got = port_ops.segment_sum_tiles(_t(gidx), _t(limbs), N_ROWS, ngroups, tile=TILE)
    for r, g in zip(ref, got):
        _assert_bits(r, g)


def _skewed_gidx(rng, n: int, ngroups: int, dist: str) -> np.ndarray:
    """Group ids as the COOKs see them: every row in one group, or Zipf
    1/k^1.1 over the groups (a fifth of the rows in group 0 at 200)."""
    if dist == "one":
        return np.full(n, ngroups // 2, np.int32)
    w = 1.0 / (np.arange(ngroups) + 1.0) ** 1.1
    return rng.choice(ngroups, size=n, p=w / w.sum()).astype(np.int32)


@pytest.mark.parametrize("dist", ["one", "zipf"])
@pytest.mark.parametrize("ngroups,cols", [(200, 1), (256, 2)])
def test_segment_sum_tiles_skewed_groups_match_jax(dist, ngroups, cols):
    """The skew the CUDA kernel aggregates in the warp before its shared
    atomics: a warp of rows in one group, and Zipf-distributed stations."""
    rng = np.random.default_rng(ngroups + cols + len(dist))
    n = 8 * TILE
    gidx = _skewed_gidx(rng, n, ngroups, dist)
    limbs = np.concatenate([_limbs(_i64_col(rng, n)) for _ in range(cols)], axis=1)
    ref = ref_ops.segment_sum_tiles(jnp.asarray(gidx), jnp.asarray(limbs), n - 41, ngroups, tile=TILE)
    got = port_ops.segment_sum_tiles(_t(gidx), _t(limbs), n - 41, ngroups, tile=TILE)
    for r, g in zip(ref, got):
        _assert_bits(r, g)


@pytest.mark.parametrize(
    "ngroups,cols,n_rows",
    [
        (1, 4, N_ROWS),
        (8, 4, N_ROWS),
        (256, 4, N_ROWS),
        (1536, 4, N_ROWS),  # the most groups the kernel takes
        (8, 33, N_ROWS),  # two chunks of the kernel's 32 columns
        (8, 4, 0),  # no rows: every group holds the identity
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_segment_minmax_tiles_matches_jax(ngroups, cols, n_rows, dtype):
    """Inside the backend's envelope (float32 finite or ±inf, no NaN and no
    -0.0; any int32), with empty groups holding the identities."""
    rng = np.random.default_rng(ngroups + cols + (0 if dtype == "float32" else 1000))
    gidx = rng.integers(0, max(1, ngroups // 2), N).astype(np.int32)  # upper groups stay empty
    if dtype == "float32":
        vals = (rng.standard_normal((N, cols)) * 100).astype(np.float32)
        vals[::31, 0] = np.inf
        vals[::37, 1] = -np.inf
        vals[::41, 2] = 0.0
        vals[::43, 3] = np.float32(-3.5)
    else:
        vals = rng.integers(-(2**31), 2**31, size=(N, cols), dtype=np.int64).astype(np.int32)
    fns = tuple(("min", "max", "max", "min")[j % 4] for j in range(cols))
    ref = ref_ops.segment_minmax_tiles(jnp.asarray(gidx), jnp.asarray(vals), n_rows, ngroups, fns, tile=TILE)
    got = port_ops.segment_minmax_tiles(_t(gidx), _t(vals), n_rows, ngroups, fns, tile=TILE)
    _assert_bits(ref, got)


def test_segment_minmax_key_order_outside_the_envelope():
    """The plain version (and the kernel held to it) orders float32 by key:
    -0.0 below +0.0 whatever the row order, and NaN beyond the infinities.
    The backend keeps such columns on numpy (see the backend parity tests)."""
    vals = np.array([[0.0], [-0.0], [-0.0], [0.0], [1.0], [np.nan]] + [[2.0]] * (TILE - 6), np.float32)
    gidx = np.array([0, 0, 1, 1, 2, 2] + [3] * (TILE - 6), np.int32)
    lo = port_ops.segment_minmax_tiles(_t(gidx), _t(vals), TILE, 4, ("min",), tile=TILE).numpy()[:, 0]
    hi = port_ops.segment_minmax_tiles(_t(gidx), _t(vals), TILE, 4, ("max",), tile=TILE).numpy()[:, 0]
    assert np.signbit(lo[0]) and np.signbit(lo[1])
    assert not np.signbit(hi[0]) and not np.signbit(hi[1])
    assert lo[2] == 1.0 and np.isnan(hi[2])


def test_segment_minmax_keeps_denormals_like_numpy():
    """A denormal extreme survives (the JAX kernel on the CPU flushes it to
    -0.0): the bar is numpy's ``minimum.at`` / ``maximum.at``."""
    rng = np.random.default_rng(21)
    gidx = rng.integers(0, 8, N).astype(np.int32)
    vals = np.abs(rng.standard_normal((N, 2))).astype(np.float32)
    vals[gidx == 3, 0] = np.float32(1e-45)
    vals[gidx == 5, 1] = np.float32(-1e-45)
    lo = np.full(8, np.inf, np.float32)
    hi = np.full(8, -np.inf, np.float32)
    np.minimum.at(lo, gidx, vals[:, 0])
    np.maximum.at(hi, gidx, vals[:, 1])
    got = port_ops.segment_minmax_tiles(_t(gidx), _t(vals), N, 8, ("min", "max"), tile=TILE).numpy()
    assert got[:, 0].tobytes() == lo.tobytes()
    assert got[:, 1].tobytes() == hi.tobytes()
