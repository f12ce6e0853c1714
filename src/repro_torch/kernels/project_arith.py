"""Projection arithmetic: a COOK ``project`` node's ``+ - * /`` chains over
float32 or int32 columns, evaluated in one pass over the morsel.

Port of ``repro.kernels.project_arith.project_tiles``.  The compute backend
lowers each eligible expression to a hashable descriptor —

    ("col", j)            column j of the morsel table
    ("lit", v)            Python scalar (weak-typed, numpy-2 promotion)
    (op, a, b)            op in {add, sub, mul, div}, a/b descriptors

— and ``project_tiles`` evaluates a tuple of them over an (N, D) table into
(N, len(descrs)) of the table's dtype.  The TPU kernel is compiled per
descriptor signature; this port instead flattens the tuple on the host into
a **postfix program** (cached per tuple) that one precompiled CUDA kernel
per dtype runs for every row (``csrc/project_arith.cu``).  Literal-only
subtrees fold on the host in Python arithmetic, exactly as the Pallas trace
folds them.  A tree that needs more than ``STACK_MAX`` stack slots, or more
instructions or literals than one launch carries, does not ``fit``: the
backend leaves it to numpy before any launch.  Before a launch ``annotate``
names each instruction's stack slot (the stack depth there), pairs each
instruction with its literal and folds a literal push into the binary op
that takes it, so the kernel decodes few instructions and keeps no stack in
local memory; the kernel's host side checks the slots before it launches.

Semantics are numpy's on an x86 host: float32 ops round once each (no FMA),
division is correctly rounded, int32 wraps modulo 2^32, and a NaN result
takes the host's bits — the NaN operand quieted (both NaN: the second for
add/mul, the first for sub/div, as numpy's vectorised loops do), else
0xFFC00000.  ``project_tiles_plain`` runs the unannotated postfix program
on a stack in plain PyTorch, independent of ``annotate``, and defines those
bits on any device.

The unannotated programs of ``compile_program`` are also what the fused
chain kernel runs (``fused_pipeline.py``).
"""

from __future__ import annotations

import functools
import operator

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = [
    "STACK_MAX",
    "PROG_MAX",
    "LITS_MAX",
    "fits",
    "compile_program",
    "annotate",
    "project_tiles",
    "project_tiles_plain",
    "launches",
]

# Limits of one launch; they match PROG_MAX / LITS_MAX / STACK_MAX in
# csrc/project_arith.cu.
PROG_MAX = 256
LITS_MAX = 64
STACK_MAX = 16

I_COL, I_LIT, I_ADD, I_SUB, I_MUL, I_DIV, I_STORE = range(7)
# Annotated instructions (csrc/project_arith.cu) are (word, literal) pairs,
# word = kind | slot << 4 | arg << 8; a kind with LIT_BIT set takes the
# pair's literal.
LIT_BIT = 8
_BINARY = (I_ADD, I_SUB, I_MUL, I_DIV)
_OPCODE = {"add": I_ADD, "sub": I_SUB, "mul": I_MUL, "div": I_DIV}
_PY = {"add": operator.add, "sub": operator.sub, "mul": operator.mul, "div": operator.truediv}
_DTYPES = {"float32": torch.float32, "int32": torch.int32}
_QUIET = 0x00400000
_HOST_NAN = -4194304  # 0xFFC00000 as int32: x86's default NaN

launches = _build.LaunchCounter("project_tiles")


def _fold(d):
    """Fold literal-only subtrees with Python arithmetic (what the Pallas
    trace does with two Python scalars)."""
    if d[0] in ("col", "lit"):
        return d
    a, b = _fold(d[1]), _fold(d[2])
    if a[0] == "lit" and b[0] == "lit":
        return ("lit", _PY[d[0]](a[1], b[1]))
    return (d[0], a, b)


def _lit_bits(v, dtype_name: str) -> int:
    if dtype_name == "float32":
        with np.errstate(over="ignore"):
            return int(np.array([v], np.float32).view(np.uint32)[0])
    if isinstance(v, (bool, np.bool_)) or not isinstance(v, (int, np.integer)):
        raise ValueError(f"int32 projection takes integer literals, got {v!r}")
    if not -(2**31) <= int(v) <= 2**31 - 1:
        raise OverflowError(f"Python integer {int(v)} out of bounds for int32")
    return int(v) & 0xFFFFFFFF


def _emit(d, dtype_name: str, code: list, lits: list) -> int:
    """Append ``d``'s postfix code; returns the stack depth it needs."""
    tag = d[0]
    if tag == "col":
        code.append(I_COL | (int(d[1]) << 8))
        return 1
    if tag == "lit":
        code.append(I_LIT | (len(lits) << 8))
        lits.append(_lit_bits(d[1], dtype_name))
        return 1
    if tag not in _OPCODE or (tag == "div" and dtype_name == "int32"):
        raise ValueError(f"descriptor op {tag!r} is not supported for {dtype_name}")
    da = _emit(d[1], dtype_name, code, lits)
    db = _emit(d[2], dtype_name, code, lits)
    code.append(_OPCODE[tag])
    return max(da, 1 + db)


def _one(d, dtype_name: str, k: int):
    code: list = []
    lits: list = []
    depth = _emit(_fold(d), dtype_name, code, lits)
    code.append(I_STORE | (k << 8))
    return code, lits, depth


def fits(descr, dtype_name: str = "float32") -> bool:
    """Whether one launch can evaluate ``descr``: it reads a column (a
    literal-only tree folds to a constant), and its program stays within
    the stack, instruction and literal limits."""
    if dtype_name not in _DTYPES:
        return False
    try:
        folded = _fold(descr)
        code, lits, depth = _one(descr, dtype_name, 0)
    except (ArithmeticError, ValueError):
        return False
    return folded[0] != "lit" and depth <= STACK_MAX and len(code) <= PROG_MAX and len(lits) <= LITS_MAX


@functools.lru_cache(maxsize=256)
def compile_program(descrs: tuple, dtype_name: str) -> tuple:
    """The postfix programs for ``descrs``: a tuple of (code int32, lits
    uint32) pairs, one per launch, packed greedily within the limits."""
    chunks = []
    code: list = []
    lits: list = []
    for k, d in enumerate(descrs):
        c, lv, depth = _one(d, dtype_name, k)
        if depth > STACK_MAX or len(c) > PROG_MAX or len(lv) > LITS_MAX:
            raise ValueError(f"descriptor {k} needs {depth} stack slots, {len(c)} instructions, {len(lv)} literals")
        if len(code) + len(c) > PROG_MAX or len(lits) + len(lv) > LITS_MAX:
            chunks.append((np.asarray(code, np.int32), np.asarray(lits, np.uint32)))
            code, lits = [], []
        base = len(lits)
        code += [(x + (base << 8)) if (x & 0xFF) == I_LIT else x for x in c]
        lits += lv
    if code:
        chunks.append((np.asarray(code, np.int32), np.asarray(lits, np.uint32)))
    return tuple(chunks)


def annotate(code: np.ndarray, lits: np.ndarray) -> np.ndarray:
    """The annotated form of a postfix program, as the kernel runs it: one
    (word, literal) row per instruction, word = kind | slot << 4 | arg << 8.
    The slot is the stack depth below the top (the depth before a push, a
    register op's left operand, the slot a store takes the top from).  A
    literal push followed by a binary op becomes one instruction, the op
    with LIT_BIT set, whose right operand is the row's literal."""
    words = code.tolist()
    bits = lits.view(np.int32).tolist()
    out: list = []
    sp = 0
    i = 0
    while i < len(words):
        op, arg = words[i] & 0xFF, words[i] >> 8
        nxt = words[i + 1] & 0xFF if i + 1 < len(words) else None
        if op == I_LIT and nxt in _BINARY:
            out.append((nxt | LIT_BIT | ((sp - 1) << 4), bits[arg]))
            i += 2
            continue
        if op == I_LIT:
            out.append((I_LIT | LIT_BIT | (sp << 4), bits[arg]))
            sp += 1
        elif op == I_COL:
            out.append((I_COL | (sp << 4) | (arg << 8), 0))
            sp += 1
        elif op == I_STORE:
            sp -= 1
            out.append((I_STORE | (sp << 4) | (arg << 8), 0))
        else:
            sp -= 1
            out.append((op | ((sp - 1) << 4), 0))
        i += 1
    return np.asarray(out, np.int32).reshape(-1, 2)


@functools.lru_cache(maxsize=256)
def _annotated(descrs: tuple, dtype_name: str) -> tuple:
    """``compile_program``'s chunks, annotated."""
    return tuple(annotate(code, lits) for code, lits in compile_program(descrs, dtype_name))


def _check_args(table, descrs, tile: int) -> str:
    n = table.shape[0]
    if table.dim() != 2:
        raise ValueError(f"table must be 2-D, got shape {tuple(table.shape)}")
    if n % tile:
        raise ValueError(f"row count {n} is not a multiple of tile {tile}")
    for name, dt in _DTYPES.items():
        if table.dtype == dt:
            return name
    raise TypeError(f"project_tiles takes float32 or int32 tables, got {table.dtype}")


def _host_nan(op: int, a: torch.Tensor, b: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    a, b, r = torch.broadcast_tensors(a, b, r)
    na, nb = torch.isnan(a), torch.isnan(b)
    both_pick = b if op in (I_ADD, I_MUL) else a
    pick = torch.where(na & nb, both_pick, torch.where(na, a, b))
    bits = pick.contiguous().view(torch.int32) | _QUIET
    bits = torch.where(na | nb, bits, torch.full_like(bits, _HOST_NAN))
    return torch.where(torch.isnan(r), bits.view(torch.float32), r)


def _apply_plain(op: int, a: torch.Tensor, b: torch.Tensor, is_f32: bool) -> torch.Tensor:
    if is_f32:
        r = {I_ADD: torch.add, I_SUB: torch.sub, I_MUL: torch.mul, I_DIV: torch.div}[op](a, b)
        return _host_nan(op, a, b, r) if torch.isnan(r).any() else r
    r = {I_ADD: torch.add, I_SUB: torch.sub, I_MUL: torch.mul}[op](a.to(torch.int64), b.to(torch.int64))
    return (((r + 2**31) % 2**32) - 2**31).to(torch.int32)  # wrap modulo 2^32


def project_tiles_plain(table, descrs, tile: int = 256):
    """Plain PyTorch version of the kernel: runs the same postfix programs
    column-wise and gives the same bits on any device."""
    dtype_name = _check_args(table, descrs, tile)
    dt = _DTYPES[dtype_name]
    is_f32 = dtype_name == "float32"
    n = table.shape[0]
    out = torch.empty((n, len(descrs)), dtype=dt, device=table.device)
    for code, lits in compile_program(tuple(descrs), dtype_name):
        lit_t = torch.from_numpy(lits.view(np.int32).copy()).to(table.device).view(dt)
        stack: list = []
        for c in code.tolist():
            op, arg = c & 0xFF, c >> 8
            if op == I_COL:
                stack.append(table[:, arg])
            elif op == I_LIT:
                stack.append(lit_t[arg])
            elif op == I_STORE:
                out[:, arg] = stack.pop()
            else:
                b = stack.pop()
                a = stack.pop()
                stack.append(_apply_plain(op, a, b, is_f32))
    return out


def project_tiles(table, descrs, tile: int = 256):
    """table: (N, D) float32|int32, N a multiple of ``tile``; ``descrs`` is a
    tuple of expression descriptors.  Returns (N, len(descrs)) in the table
    dtype on the table's device; padding rows hold the program's value on
    the zero padding (the caller trims to the morsel size)."""
    if _build.runs_plain(table):
        return project_tiles_plain(table, descrs, tile)
    if table.device.type != "cuda":
        raise ValueError(f"project_tiles runs on cuda or cpu, got {table.device}")
    dtype_name = _check_args(table, descrs, tile)
    _build.check_tensor(table, "table", _DTYPES[dtype_name], table.device, 2)
    n, d = table.shape
    k = len(descrs)
    out = torch.empty((n, k), dtype=table.dtype, device=table.device)
    lib = _build.library()
    for code in _annotated(tuple(descrs), dtype_name):
        rc = lib.dacp_project_tiles(
            table.data_ptr(),
            d,
            n,
            int(dtype_name == "float32"),
            code.ctypes.data,
            len(code),
            out.data_ptr(),
            k,
            _build.stream_of(table),
        )
        _build.check(rc, "project_tiles")
        launches.bump()
    return out
