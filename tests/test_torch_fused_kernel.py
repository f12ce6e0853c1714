"""The port's fused chain kernel (``fused_chain_tiles``) against the JAX
reference kernel, bit for bit (tolerance 0): all seven outputs compared
whole.

The reference runs as ``tests/test_kernels.py`` runs it on the CPU (Pallas
interpret mode); the port's wrapper gets the same numpy arrays as CPU
tensors, where it runs its plain PyTorch version.  The JAX kernel flushes
denormals and returns the first NaN operand on the CPU (ROADMAP Queue 3),
so the projection inputs handed to it hold neither; the NaN / denormal
behaviour is held against the port's ``project_tiles_plain`` and numpy
instead.  The CUDA kernel itself is held to the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_pipeline import fused_chain_tiles as ref_fused  # noqa: E402
from repro_torch.kernels import fused_pipeline  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402
from repro_torch.kernels.project_arith import project_tiles_plain  # noqa: E402

TILE = 256
N = 3 * TILE
N_ROWS = N - 41  # ragged tail: the last tile is partly padding

# contraction-safe trees (a float mul feeds add/sub only by a power of two),
# so XLA's CPU FMA contraction cannot change the reference's bits
DESCRS_F = (
    ("add", ("mul", ("col", 0), ("lit", 2.0)), ("col", 1)),
    ("mul", ("sub", ("col", 0), ("col", 1)), ("lit", 0.37)),
    ("div", ("col", 1), ("add", ("col", 0), ("lit", 7.5))),
)
DESCRS_I = (
    ("add", ("mul", ("col", 0), ("lit", 3)), ("lit", 1)),
    ("sub", ("mul", ("col", 0), ("col", 1)), ("lit", 2**31 - 1)),
)


def _i64_words(v: np.ndarray) -> np.ndarray:
    return np.stack([(v >> 32).astype(np.int32), (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)], axis=1)


def _signed32(v: int) -> int:
    return ((v + 2**31) % 2**32) - 2**31


def _limbs(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    cols = [((v >> (8 * k)) & 0xFF).astype(np.int32) for k in range(7)] + [(v >> 56).astype(np.int32)]
    return np.stack(cols, axis=1)


def _inputs(rng, kind: str, ngroups: int):
    """(scalars, pred, gidx, pass, limb, mmf, mmi, af, ai) as numpy arrays."""
    f32 = (rng.standard_normal(N) * 2).astype(np.float32)
    f32[3::29] = np.float32(0.5)  # ties with the threshold
    i32 = rng.integers(-20, 20, N).astype(np.int32)
    i64 = rng.integers(-(2**63), 2**63 - 1, N, dtype=np.int64)
    i64[:4] = [-(2**63), 2**63 - 1, 0, -1]
    i64[5::31] = i64[200]
    if kind == "f32":
        pred, t_hi, t_lo = f32.view(np.int32).reshape(N, 1), int(np.array([0.5], np.float32).view(np.int32)[0]), 0
    elif kind == "i32":
        pred, t_hi, t_lo = i32.reshape(N, 1), 3, 0
    elif kind == "i64":
        pred = _i64_words(i64)
        t_hi, t_lo = int(i64[200] >> 32), _signed32((int(i64[200]) & 0xFFFFFFFF) ^ 0x80000000)
    else:
        pred, t_hi, t_lo = np.zeros((N, 1), np.int32), 0, 0
    scalars = np.array([N_ROWS, t_hi, t_lo, 0], np.int32)
    # payload planes: every bit pattern moves verbatim, NaN payloads included
    pass_tbl = rng.integers(-(2**31), 2**31, size=(N, 5), dtype=np.int64).astype(np.int32)
    pass_tbl[::17, 0] = np.array([0x7FA00001], np.uint32).view(np.int32)[0]
    limb = np.concatenate([_limbs(i64), _limbs(rng.integers(0, 4, N))], axis=1)
    # min/max columns: finite, no -0.0 and no denormals (the backend's and
    # the JAX kernel's common envelope)
    mmf = (rng.standard_normal((N, 2)) * 50).astype(np.float32)
    mmi = rng.integers(-(2**31), 2**31, size=(N, 2), dtype=np.int64).astype(np.int32)
    af = (rng.standard_normal((N, 2)) * 3).astype(np.float32)
    ai = rng.integers(-(2**31), 2**31, size=(N, 2), dtype=np.int64).astype(np.int32)
    ai[::7, 0] = rng.integers(-1000, 1000, len(ai[::7]))
    gidx = rng.integers(0, min(ngroups, 200), N).astype(np.int32)
    return scalars, pred, gidx, pass_tbl, limb, mmf, mmi, af, ai


def _run_both(arrays, **static):
    ref = ref_fused(*(jnp.asarray(a) for a in arrays), **static, tile=TILE, interpret=True)
    got = port_ops.fused_chain_tiles(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), **static, tile=TILE)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _assert_outputs_identical(ref, got):
    names = ("ctab", "counts", "gsum", "gcnt", "gmmf", "gmmi", "gfirst")
    for name, r, g in zip(names, ref, got):
        assert r.shape == g.shape and r.dtype == g.dtype, (name, r.shape, g.shape, r.dtype, g.dtype)
        assert r.tobytes() == g.tobytes(), f"{name} differs from the JAX kernel"


@pytest.mark.parametrize("ngroups", [8, 256])
@pytest.mark.parametrize("segmented", [True, False])
@pytest.mark.parametrize("kind", ["none", "f32", "i32", "i64"])
def test_fused_chain_tiles_matches_jax(kind, segmented, ngroups):
    rng = np.random.default_rng(["none", "f32", "i32", "i64"].index(kind) * 4 + 2 * segmented + (ngroups == 256))
    arrays = _inputs(rng, kind, ngroups)
    op = {"none": "gt", "f32": "ge", "i32": "ne", "i64": "lt"}[kind]
    ref, got = _run_both(
        arrays,
        op=op,
        kind=kind,
        descrs_f=DESCRS_F,
        descrs_i=DESCRS_I,
        csums=(1, 0),
        fns_f=("max", "min"),
        fns_i=("min", "max"),
        with_gidx=True,
        segmented=segmented,
        ngroups=ngroups,
    )
    _assert_outputs_identical(ref, got)
    if segmented:
        assert got[3].sum() == got[1].sum()  # every survivor folded into a group


@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge", "eq", "ne"])
def test_fused_chain_tiles_every_comparison_without_projection(op):
    """Passthrough-only plans (width-1 zero dummies for every unused table)
    under each comparison on an int64 predicate."""
    rng = np.random.default_rng(40 + ["lt", "le", "gt", "ge", "eq", "ne"].index(op))
    scalars, pred, gidx, pass_tbl, limb, _mmf, _mmi, _af, _ai = _inputs(rng, "i64", 8)
    z32 = np.zeros((N, 1), np.int32)
    arrays = (scalars, pred, gidx, pass_tbl, limb[:, :8].copy(), np.zeros((N, 1), np.float32), z32,
              np.zeros((N, 1), np.float32), z32)
    ref, got = _run_both(arrays, op=op, kind="i64", descrs_f=(), descrs_i=(), csums=(), fns_f=("min",),
                         fns_i=("min",), with_gidx=False, segmented=True, ngroups=8)
    _assert_outputs_identical(ref, got)


def test_fused_chain_tiles_keeps_nan_and_denormals_like_numpy():
    """NaN payloads (one and both operands), invalid operations and
    denormals in the projection inputs: the computed columns of the
    survivors carry the bits of ``project_tiles_plain`` on the same rows, and
    numpy's on arrays longer than 16 elements."""
    rng = np.random.default_rng(7)
    nan_a = np.array([0x7FA00001], np.uint32).view(np.float32)[0]
    nan_b = np.array([0xFFB00002], np.uint32).view(np.float32)[0]
    a = (rng.standard_normal(N) * 3).astype(np.float32)
    b = (rng.standard_normal(N) * 3).astype(np.float32)
    a[::11], b[::13] = nan_a, nan_b  # both NaN where the strides meet
    a[1::17], b[1::17] = np.float32(1e-45), 0.0  # denormal / 0
    a[2::19], b[2::19] = np.inf, np.inf  # inf - inf
    a[4::23] = np.float32(3e-39)
    af = np.stack([a, b], axis=1)
    descrs = (("add", ("col", 0), ("col", 1)), ("sub", ("col", 0), ("col", 1)), ("mul", ("col", 0), ("col", 1)),
              ("div", ("col", 0), ("col", 1)), ("mul", ("col", 0), ("lit", 0.5)))
    keep = (rng.random(N) < 0.6).astype(np.int32)
    z32 = torch.zeros((N, 1), dtype=torch.int32)
    got = port_ops.fused_chain_tiles(
        np.array([N_ROWS, 1, 0, 0], np.int32), torch.from_numpy(keep.reshape(N, 1)), torch.zeros(N, dtype=torch.int32),
        z32, z32, torch.zeros((N, 1)), z32, torch.from_numpy(af), z32,
        op="eq", kind="i32", descrs_f=descrs, descrs_i=(), csums=(), fns_f=("min",), fns_i=("min",),
        with_gidx=False, segmented=False, ngroups=8, tile=TILE,
    )
    ctab, counts = got[0].numpy(), got[1].numpy()
    survivors = np.flatnonzero((keep == 1) & (np.arange(N) < N_ROWS))
    front = np.concatenate([ctab[i * TILE : i * TILE + c] for i, c in enumerate(counts)])
    per_op = project_tiles_plain(torch.from_numpy(af), descrs, TILE).numpy()
    assert front[:, 1:].tobytes() == np.ascontiguousarray(per_op[survivors]).tobytes()
    with np.errstate(all="ignore"):
        want = np.stack([a + b, a - b, a * b, a / b, a * np.float32(0.5)], axis=1)
    assert front[:, 1:].tobytes() == np.ascontiguousarray(want[survivors]).tobytes()


def test_fused_chain_tiles_unsegmented_outputs_hold_initial_values():
    rng = np.random.default_rng(9)
    arrays = _inputs(rng, "f32", 16)
    got = port_ops.fused_chain_tiles(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), op="gt", kind="f32", descrs_f=(),
        descrs_i=DESCRS_I, csums=(0,), fns_f=("min", "max"), fns_i=("max", "min"), with_gidx=False,
        segmented=False, ngroups=16, tile=TILE,
    )
    _ctab, _counts, gsum, gcnt, gmmf, gmmi, gfirst = (g.numpy() for g in got)
    assert not gsum.any() and not gcnt.any()
    assert (gmmf[:, 0] == np.inf).all() and (gmmf[:, 1] == -np.inf).all()
    assert (gmmi[:, 0] == -(2**31)).all() and (gmmi[:, 1] == 2**31 - 1).all()
    assert (gfirst == 2**31 - 1).all()


def test_fused_plan_limits_are_declared_before_launch():
    """A plan fits one launch when each dtype's trees make one postfix
    program and the fold's accumulators for the group cap fit a block's
    shared memory; the wrapper refuses the rest before touching the card."""
    assert fused_pipeline.fits(DESCRS_F, DESCRS_I, (0,), 8, 1, 1, 256)
    deep = ("col", 0)
    for _ in range(17):
        deep = ("add", ("col", 0), deep)  # right-leaning: one stack slot per level
    assert not fused_pipeline.fits((deep,), (), (), 8, 1, 1, 256)
    many = tuple(("add", ("col", 0), ("lit", float(k) + 0.5)) for k in range(70))  # > 64 literals
    assert not fused_pipeline.fits(many, (), (), 8, 1, 1, 256)
    assert fused_pipeline.shared_bytes(256, 8 * 27, 0, 1, 1) <= fused_pipeline.SHARED_MAX_BYTES
    assert not fused_pipeline.fits((), (), (), 8 * 28, 1, 1, 256)
    with pytest.raises(ValueError, match="multiple of 8"):
        z = torch.zeros((TILE, 1), dtype=torch.int32)
        port_ops.fused_chain_tiles(
            np.zeros(4, np.int32), z, torch.zeros(TILE, dtype=torch.int32), z, z, torch.zeros((TILE, 1)), z,
            torch.zeros((TILE, 1)), z, op="gt", kind="none", descrs_f=(), descrs_i=(), csums=(), fns_f=("min",),
            fns_i=("min",), with_gidx=False, segmented=True, ngroups=12, tile=TILE,
        )


@pytest.mark.parametrize(
    "plan,footprint,admitted",
    [
        ("main", 12800, True),  # the fused aggregate COOK: 8 qc limbs, one csum, 200 stations
        ("wide", 34816, True),  # the widest envelope: two int64 sums, two csums, 256 groups
        ("under-limit", 231424, True),  # 222 limb columns at 256 groups
        ("over-limit", 232448, False),  # one more
    ],
)
def test_fused_plan_footprints_and_fits_stay_put(plan, footprint, admitted):
    """The plans that ``fits`` admits do not shrink: a change of the kernel's
    shared footprint cannot quietly send these morsels to the per-op path."""
    tk, s3 = ("add", ("col", 0), ("lit", 273.15)), ("add", ("mul", ("col", 0), ("lit", 3)), ("lit", 1))
    hazard_f = (("div", ("col", 0), ("col", 1)), ("sub", ("col", 0), ("col", 1)), ("add", ("col", 1), ("col", 0)))
    hazard_i = (("mul", ("col", 0), ("col", 1)), ("sub", ("col", 0), ("lit", 2**31 - 1)))
    args = {
        "main": ((tk,), (s3,), (0,), 8, 1, 1, 200),
        "wide": (hazard_f, hazard_i, (0, 1), 16, 4, 4, 256),
        "under-limit": ((), (), (), 222, 1, 1, 256),
        "over-limit": ((), (), (), 223, 1, 1, 256),
    }[plan]
    descrs_f, descrs_i, csums, limb_cols, mf, mi, ngroups = args
    assert fused_pipeline.SHARED_MAX_BYTES == 232320
    assert fused_pipeline.shared_bytes(ngroups, limb_cols, len(csums), mf, mi) == footprint
    assert fused_pipeline.fits(descrs_f, descrs_i, csums, limb_cols, mf, mi, ngroups) is admitted
