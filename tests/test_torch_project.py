"""``project_tiles`` on the CPU, bit for bit.

The plain version runs the unannotated postfix program on a stack; these
tests hold it against the JAX kernel (``repro.kernels.project_arith`` in
Pallas interpret mode, as ``tests/test_kernels.py`` runs it) and against
numpy where the two references differ: the JAX kernel on the CPU flushes
denormals and, of two NaN operands, returns the first for every op, while
the port follows numpy.  The slot-annotated program the CUDA kernel runs
(``repro_torch.kernels.project_arith.annotate``) is run here by a model of
the kernel's slot machine and held against the plain version.  The kernel
itself, and its check of an annotated program's slots, are held on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import operator

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.project_arith import project_tiles as jax_project_tiles  # noqa: E402
from repro_torch.kernels import project_arith as pa  # noqa: E402

TILE = 256
N = 3 * TILE
OPS_F32 = ("add", "sub", "mul", "div")
OPS_I32 = ("add", "sub", "mul")
# Literals of the trees held to the JAX kernel are powers of two: XLA's
# simplifier turns x / c into x * (1 / c) and folds c1 * (c2 * x) into
# (c1 * c2) * x, which round as numpy does only then.  The trees held to
# numpy take any literal.
LITS_POW2 = (0.5, 2.0, -4.0, 0.25, -8.0, 1024.0)
LITS_F32 = (0.5, 2.0, -3.0, 0.1, 273.15, -1013.0, 4.0, 1e-3)
LITS_I32 = (3, -7, 1, 2**31 - 1, -(2**31), 65537)

_NAN_A = np.array([0x7FA00001], np.uint32).view(np.float32)[0]
_NAN_B = np.array([0xFFB00002], np.uint32).view(np.float32)[0]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax(table: np.ndarray, descrs) -> np.ndarray:
    return np.asarray(jax_project_tiles(jnp.asarray(table), tuple(descrs), tile=TILE, interpret=True))


def _is_pow2(v) -> bool:
    m, _ = np.frexp(np.float32(v))
    return abs(float(m)) == 0.5


def _jax_exact(op: str, a, b) -> bool:
    """Whether XLA's CPU backend rounds ``(op, a, b)`` as numpy does.  It
    contracts a ``mul`` under ``add``/``sub`` into an FMA unless a factor is
    a power-of-two literal (the backend's eligibility rule,
    ``_contraction_safe``), and its simplifier rewrites a division of or by
    a division (a / (b / c) into (a * c) / b)."""
    if op in ("add", "sub"):
        return not any(t[0] == "mul" and not any(s[0] == "lit" and _is_pow2(s[1]) for s in t[1:]) for t in (a, b))
    return op != "div" or (a[0] != "div" and b[0] != "div")


def _tree(rng, depth: int, d: int, lits: tuple):
    """A random descriptor of at most ``depth`` levels over ``lits``; a
    float32 one's ops are those XLA's CPU backend rounds as numpy does."""
    if depth <= 1 or rng.random() < 0.2:
        if rng.random() < 0.7:
            return ("col", int(rng.integers(d)))
        return ("lit", lits[int(rng.integers(len(lits)))])
    a, b = _tree(rng, depth - 1, d, lits), _tree(rng, depth - 1, d, lits)
    ops = OPS_I32 if lits is LITS_I32 else [op for op in OPS_F32 if _jax_exact(op, a, b)]
    return (ops[int(rng.integers(len(ops)))], a, b)


def _deep(d: int, dtype: str):
    """A right-leaning chain that holds exactly STACK_MAX values at once."""
    ops = ("add", "div", "sub") if dtype == "float32" else OPS_I32
    tree = ("col", d - 1)
    for i in range(pa.STACK_MAX - 1):
        tree = (ops[i % len(ops)], ("col", i % d), tree)
    return tree


def _descrs(rng, d: int, lits: tuple, k: int) -> tuple:
    dtype = "int32" if lits is LITS_I32 else "float32"
    out = [_deep(d, dtype)]
    while len(out) < k:
        t = _tree(rng, 6, d, lits)
        if pa.fits(t, dtype):
            out.append(t)
    return tuple(out)


def _finite_f32(rng, shape) -> np.ndarray:
    """Small multiples of 1/2 with zeros and ±inf, no NaN and no denormal:
    every NaN a tree makes is the default NaN on both references, and no
    result falls below float32's normal range, where XLA's CPU backend
    flushes to zero."""
    v = (rng.integers(-16, 17, size=shape) / 2).astype(np.float32)
    flat = v.reshape(-1)
    flat[::13] = 0.0
    flat[5::29] = np.inf
    flat[7::31] = -np.inf
    return v


@pytest.mark.parametrize("seed", range(4))
def test_random_f32_trees_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    d = 3
    table = _finite_f32(rng, (N, d))
    descrs = _descrs(rng, d, LITS_POW2, 4)
    assert _slots(pa.annotate(*pa.compile_program((descrs[0],), "float32")[0])) == pa.STACK_MAX
    got = pa.project_tiles(_t(table), descrs, TILE)
    assert got.numpy().tobytes() == _jax(table, descrs).tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_random_i32_trees_match_jax(seed):
    rng = np.random.default_rng(200 + seed)
    d = 3
    table = rng.integers(-(2**31), 2**31, size=(N, d), dtype=np.int64).astype(np.int32)
    table[:4] = [[-(2**31), 2**31 - 1, -1], [2**31 - 1, 2**31 - 1, 0], [-(2**31), -1, 1], [65536, 65536, 3]]
    descrs = _descrs(rng, d, LITS_I32, 4)
    got = pa.project_tiles(_t(table), descrs, TILE)
    assert got.numpy().tobytes() == _jax(table, descrs).tobytes()


def _np_eval(d, table: np.ndarray):
    if d[0] == "col":
        return np.ascontiguousarray(table[:, d[1]])  # numpy's NaN choice differs on strided views
    if d[0] == "lit":
        return d[1]  # a Python scalar: weak, as in the kernels
    a, b = _np_eval(d[1], table), _np_eval(d[2], table)
    if isinstance(a, float) and isinstance(b, float):  # Python arithmetic, as the kernels fold
        return {"add": operator.add, "sub": operator.sub, "mul": operator.mul, "div": operator.truediv}[d[0]](a, b)
    return {"add": np.add, "sub": np.subtract, "mul": np.multiply, "div": np.divide}[d[0]](a, b)


def _hazard_f32(rng, shape) -> np.ndarray:
    """NaN payloads, both NaN operands on one row, ±inf, ±0, denormals."""
    v = (rng.standard_normal(shape) * 3).astype(np.float32)
    flat = v.reshape(-1)
    flat[::11] = 0.0
    flat[1::17] = -0.0
    flat[2::19] = _NAN_A
    flat[3::23] = _NAN_B
    flat[4::29] = np.nan
    flat[5::31] = np.inf
    flat[6::37] = -np.inf
    flat[7::41] = np.float32(1e-45)
    flat[8::43] = np.float32(-3e-39)
    return v


@pytest.mark.parametrize("seed", range(3))
def test_random_f32_trees_with_hazards_match_numpy(seed):
    """Arrays longer than 16 elements: numpy's vectorised loops, whose NaN
    bits the port follows (the JAX kernel differs on two NaN operands and
    flushes denormals)."""
    rng = np.random.default_rng(300 + seed)
    d = 2
    table = _hazard_f32(rng, (N, d))
    descrs = _descrs(rng, d, LITS_F32, 5)
    with np.errstate(all="ignore"):
        want = np.stack([np.broadcast_to(_np_eval(t, table), (N,)) for t in descrs], axis=1).astype(np.float32)
    got = pa.project_tiles(_t(table), descrs, TILE)
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize(
    "case",
    ["zero_by_zero", "inf_minus_inf", "one_nan", "both_nan", "denormals", "i32_extremes"],
)
def test_hazard_columns(case):
    a = np.zeros(N, np.float32)
    b = np.zeros(N, np.float32)
    descrs = tuple((op, ("col", 0), ("col", 1)) for op in OPS_F32) + (
        ("sub", ("mul", ("col", 0), ("lit", 0.5)), ("lit", 1013.0)),
        ("div", ("col", 1), ("lit", 3.0)),
    )
    if case == "zero_by_zero":
        a[1::2] = -0.0
    elif case == "inf_minus_inf":
        a[:], b[:] = np.inf, np.inf
        b[::3] = -np.inf
    elif case == "one_nan":
        a[:], b[:] = _NAN_A, 2.5
        a[::2], b[::2] = 1.5, _NAN_B
    elif case == "both_nan":
        a[:], b[:] = _NAN_A, _NAN_B
    elif case == "denormals":
        a[:] = np.float32(1e-45)
        b[:] = np.float32(2e-45)
        b[::4] = 0.0
    else:
        table = np.zeros((N, 2), np.int32)
        table[::2, 0] = -(2**31)
        table[1::2, 0] = 2**31 - 1
        table[:, 1] = -1
        table[::3, 1] = -(2**31)
        table[1::5, 1] = 2**31 - 1
        descrs = tuple((op, ("col", 0), ("col", 1)) for op in OPS_I32) + (
            ("add", ("mul", ("col", 0), ("lit", 3)), ("lit", 1)),
            ("sub", ("col", 1), ("lit", 2**31 - 1)),
        )
        got = pa.project_tiles(_t(table), descrs, TILE)
        assert got.numpy().tobytes() == _jax(table, descrs).tobytes()
        return
    table = np.stack([a, b], axis=1)
    with np.errstate(all="ignore"):
        want = np.stack([np.broadcast_to(_np_eval(t, table), (N,)) for t in descrs], axis=1).astype(np.float32)
    got = pa.project_tiles(_t(table), descrs, TILE)
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("limit", ["literals", "instructions"])
def test_program_split_over_two_launches(limit):
    """A tuple past one launch's literals (LITS_MAX) or instructions
    (PROG_MAX) runs as two programs; the result is the same bits."""
    rng = np.random.default_rng(7)
    table = _finite_f32(rng, (N, 2))
    if limit == "literals":
        descrs = tuple(("add", ("col", i % 2), ("lit", float(i) + 0.5)) for i in range(pa.LITS_MAX + 6))
    else:
        chain = ("col", 0)
        for _ in range(30):
            chain = ("sub", ("div", chain, ("col", 0)), ("col", 1))
        descrs = (chain,) * 3
    assert len(pa.compile_program(descrs, "float32")) == 2
    got = pa.project_tiles(_t(table), descrs, TILE)
    assert got.numpy().tobytes() == _jax(table, descrs).tobytes()


def _w(kind, slot, arg=0):
    return kind | (slot << 4) | (arg << 8)


def test_annotate_names_slots_and_fuses_literals():
    """(pressure * 0.5 - 1013.0) is a load, two literal ops and a store, all
    at slot 0; a / b holds two values and divides slot 0 by the top."""
    bits = lambda v: int(np.array([v], np.float32).view(np.int32)[0])  # noqa: E731
    L = pa.LIT_BIT
    code = pa.annotate(*pa.compile_program((("sub", ("mul", ("col", 1), ("lit", 0.5)), ("lit", 1013.0)),), "float32")[0])
    assert code.tolist() == [[_w(pa.I_COL, 0, 1), 0], [_w(pa.I_MUL | L, 0), bits(0.5)],
                             [_w(pa.I_SUB | L, 0), bits(1013.0)], [_w(pa.I_STORE, 0, 0), 0]]
    code = pa.annotate(*pa.compile_program((("div", ("lit", 2.0), ("col", 0)), ("div", ("col", 0), ("col", 1))), "float32")[0])
    assert code.tolist() == [[_w(pa.I_LIT | L, 0), bits(2.0)], [_w(pa.I_COL, 1, 0), 0], [_w(pa.I_DIV, 0), 0],
                             [_w(pa.I_STORE, 0, 0), 0], [_w(pa.I_COL, 0, 0), 0], [_w(pa.I_COL, 1, 1), 0],
                             [_w(pa.I_DIV, 0), 0], [_w(pa.I_STORE, 0, 1), 0]]
    assert _slots(code) == 2


def _slots(code: np.ndarray) -> int:
    """The most values an annotated program holds at once."""
    return max((w >> 4) & 0xF for w in code[:, 0].tolist()) + 1


def _run_annotated(table: torch.Tensor, descrs: tuple) -> torch.Tensor:
    """The CUDA kernel's slot machine, a whole column a slot: each
    instruction reads and writes the slots its word names, a literal op
    takes its row's literal as the right operand."""
    dtype = "float32" if table.dtype == torch.float32 else "int32"
    out = torch.empty((table.shape[0], len(descrs)), dtype=table.dtype)
    for chunk, lits in pa.compile_program(descrs, dtype):
        code = pa.annotate(chunk, lits)
        lit = torch.from_numpy(code[:, 1].copy()).view(table.dtype)
        slots: list = [None] * pa.STACK_MAX
        for i, w in enumerate(code[:, 0].tolist()):
            kind, s, arg = w & 0xF, (w >> 4) & 0xF, w >> 8
            if kind == pa.I_COL:
                slots[s] = table[:, arg]
            elif kind == pa.I_LIT | pa.LIT_BIT:
                slots[s] = lit[i]
            elif kind == pa.I_STORE:
                out[:, arg] = slots[s]
            elif kind & pa.LIT_BIT:
                slots[s] = pa._apply_plain(kind & ~pa.LIT_BIT, slots[s], lit[i], dtype == "float32")
            else:
                slots[s] = pa._apply_plain(kind, slots[s], slots[s + 1], dtype == "float32")
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_annotated_program_matches_plain(dtype, seed):
    """Random trees up to STACK_MAX values, literals on either side; float32
    over NaN payloads, ±inf, ±0 and denormals, int32 over its extremes."""
    rng = np.random.default_rng(400 + seed)
    d = 3
    if dtype == "float32":
        table = _hazard_f32(rng, (N, d))
        descrs = _descrs(rng, d, LITS_F32, 6)
    else:
        table = rng.integers(-(2**31), 2**31, size=(N, d), dtype=np.int64).astype(np.int32)
        table[:3] = [[-(2**31)] * d, [2**31 - 1] * d, [-1] * d]
        descrs = _descrs(rng, d, LITS_I32, 6)
    got = _run_annotated(_t(table), descrs)
    assert got.numpy().tobytes() == pa.project_tiles_plain(_t(table), descrs, TILE).numpy().tobytes()


@pytest.mark.parametrize("limit", ["literals", "instructions"])
def test_annotated_split_programs_match_plain(limit):
    """A tuple annotated as several programs, each slot named afresh."""
    rng = np.random.default_rng(8)
    table = _hazard_f32(rng, (N, 2))
    if limit == "literals":
        descrs = tuple(("sub", ("lit", float(i) + 0.5), ("col", i % 2)) for i in range(pa.LITS_MAX + 6))
    else:
        chain = ("col", 0)
        for i in range(30):
            chain = ("sub", ("div", chain, ("col", 0)), ("mul", ("col", 1), ("lit", 1.5 + i)))
        descrs = (chain,) * 3
    assert len(pa.compile_program(descrs, "float32")) > 1
    got = _run_annotated(_t(table), descrs)
    assert got.numpy().tobytes() == pa.project_tiles_plain(_t(table), descrs, TILE).numpy().tobytes()
