"""Whole-chain fused pipeline: filter → project → compaction → segment fold
of one morsel in one launch.

Port of ``repro.kernels.fused_pipeline.fused_chain_tiles``, with the same
inputs, outputs and static plan parameters:

    op, kind       predicate comparison + column kind ("none" = no filter)
    descrs_f/_i    project_arith descriptor trees over the f32 / i32 tables
    csums          indices into ``descrs_i`` whose outputs are summed
                   (4-limb in-kernel decomposition)
    fns_f/_i       "min"/"max" per column of the f32 / i32 min/max tables
    with_gidx      append the group-id column to the compaction table
    segmented      run the segment fold (False = streaming chain: the group
                   outputs keep their initial values)
    ngroups        padded group count (multiple of 8)
    fsums          the float sums, ``(plane offset in a ctab row, kind)``
                   with kind in ``FSUM_KINDS``: each group's float64 sum of
                   the column over its survivors in row order (needs
                   ``with_gidx`` and ``segmented``; the port's addition)

The CUDA kernel (``csrc/fused_chain.cu``) replaces the TPU kernel's one-hot
compaction matmul with a block prefix sum and its sequential-grid group
state with shared-memory accumulators, warp-aggregated before their shared
atomics and folded into the outputs by global atomics, over a grid-stride
loop of at most two blocks per SM; each tile's compacted rows are staged in
shared memory and leave as one contiguous block.  It is bound by bytes:
each input table is read once and ctab written once.  Its descriptor trees
travel as one postfix program per dtype, so a plan whose trees need more
than one program, or whose segment fold needs more shared memory than a
block has, does not ``fit`` and is refused by the planner before any
launch.

The float sums are the host's float64 fold moved to the card: a third
launch after the chain folds each group's sums in row order, bit for bit
``np.add.at`` over the survivors, and raises a flag where a survivor is NaN
or ±inf, whose sums the caller then folds on the host.  On the card the
outputs lie in one allocation (``FusedOutputs``) and the group outputs in
one range of it, which ``groups_to_host`` reads back in one copy.

``fused_chain_tiles_plain`` is the same function in plain PyTorch (the
compaction of ``filter_select_planes_plain``, the programs of
``project_tiles_plain``, the folds of the segment kernels' plain versions,
and ``np.add.at`` for the float sums); the wrapper runs it for tensors on
the CPU.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.filter_select import OPS, _pred_mask, _scalars
from repro_torch.kernels.project_arith import compile_program, fits as _descr_fits, project_tiles_plain
from repro_torch.kernels.segment_reduce import segment_minmax_tiles_plain, segment_sum_tiles_plain

__all__ = [
    "FSUM_KINDS",
    "KINDS",
    "SHARED_MAX_BYTES",
    "FusedOutputs",
    "fused_chain_tiles",
    "fused_chain_tiles_plain",
    "fits",
    "groups_to_host",
    "launches",
    "shared_bytes",
]

KINDS = ("f32", "i32", "i64", "none")
# a float sum's column as the kernel widens it (csrc/fused_chain.cu FS_*):
# float32 / float64 / int32 (and the narrow ints) / uint32 / int64 / uint64
# / float16 planes
FSUM_KINDS = ("f32", "f64", "i32", "u32", "i64", "u64", "f16")
_FSUM_WIDE = {"f64": np.float64, "i64": np.int64, "u64": np.uint64}  # two planes: hi, lo
# Limits of one launch; they match csrc/fused_chain.cu.
SHARED_MAX_BYTES = 232320  # 227 KB per block, less the kernel's 128 static bytes
CSUM_MAX = 64
MM_COLS_MAX = 256
FSUM_MAX = 64
_I32_MAX = 2**31 - 1

launches = _build.LaunchCounter("fused_chain_tiles")


def shared_bytes(ngroups: int, limb_cols: int, ncsums: int, mf: int, mi: int) -> int:
    """Shared memory of one block of the segmented kernel's accumulators: per
    group the limb sums, the count, the min/max columns and the first row.
    The kernel stages a tile's compacted rows beside them where they fit."""
    return 4 * ngroups * (limb_cols + 4 * ncsums + 2 + mf + mi)


def _program(descrs: tuple, dtype_name: str) -> tuple:
    """The one postfix program (code int32, lits uint32) for ``descrs``."""
    if not descrs:
        return np.zeros(1, np.int32), np.zeros(1, np.uint32), 0, 0
    chunks = compile_program(tuple(descrs), dtype_name)
    if len(chunks) != 1:
        raise ValueError(f"{dtype_name} descriptors need {len(chunks)} programs; the fused kernel runs one")
    code, lits = chunks[0]
    return code, (lits if lits.size else np.zeros(1, np.uint32)), len(code), len(lits)


def fits(descrs_f: tuple, descrs_i: tuple, csums: tuple, limb_cols: int, mf: int, mi: int, ngroups: int,
         nfsums: int = 0) -> bool:
    """Whether one launch takes this plan: each dtype's trees fit one postfix
    program, at most ``FSUM_MAX`` float sums, and the segmented fold's
    accumulators for ``ngroups`` groups fit a block's shared memory."""
    for descrs, dt in ((descrs_f, "float32"), (descrs_i, "int32")):
        if not all(_descr_fits(d, dt) for d in descrs):
            return False
        if descrs and len(compile_program(tuple(descrs), dt)) != 1:
            return False
    if len(csums) > CSUM_MAX or mf > MM_COLS_MAX or mi > MM_COLS_MAX or nfsums > FSUM_MAX:
        return False
    return shared_bytes(ngroups, limb_cols, len(csums), mf, mi) <= SHARED_MAX_BYTES


def _check_args(pred, gidx, pass_tbl, limb_tbl, mmf, mmi, af, ai, op, kind, descrs_f, descrs_i, csums, fns_f, fns_i,
                ngroups, tile, fsums, with_gidx, segmented):
    n = pass_tbl.shape[0]
    if op not in OPS:
        raise ValueError(f"unknown comparison {op!r}; expected one of {OPS}")
    if kind not in KINDS:
        raise ValueError(f"unknown predicate kind {kind!r}; expected one of {KINDS}")
    if tile <= 0 or tile > 1024 or tile % 32:
        raise ValueError(f"tile must be a multiple of 32 in [32, 1024], got {tile}")
    if n % tile:
        raise ValueError(f"row count {n} is not a multiple of tile {tile}")
    if ngroups <= 0 or ngroups % 8:
        raise ValueError(f"ngroups must be a positive multiple of 8, got {ngroups}")
    for name, t, dt in (("pred", pred, torch.int32), ("pass_tbl", pass_tbl, torch.int32),
                        ("limb_tbl", limb_tbl, torch.int32), ("mmf", mmf, torch.float32),
                        ("mmi", mmi, torch.int32), ("af", af, torch.float32), ("ai", ai, torch.int32)):
        if t.dim() != 2 or t.shape[0] != n:
            raise ValueError(f"{name} must be ({n}, k), got {tuple(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    if gidx.dim() != 1 or gidx.shape[0] != n or gidx.dtype != torch.int32:
        raise ValueError(f"gidx must be ({n},) int32, got {tuple(gidx.shape)} {gidx.dtype}")
    if pred.shape[1] < (2 if kind == "i64" else 1):
        raise ValueError(f"{kind} predicate needs {2 if kind == 'i64' else 1} planes, got {pred.shape[1]}")
    if len(fns_f) != mmf.shape[1] or len(fns_i) != mmi.shape[1]:
        raise ValueError(f"fns {fns_f} / {fns_i} do not match min/max widths {mmf.shape[1]} / {mmi.shape[1]}")
    if any(fn not in ("min", "max") for fn in tuple(fns_f) + tuple(fns_i)):
        raise ValueError(f"fns must be 'min' or 'max', got {fns_f} / {fns_i}")
    if any(not 0 <= k < len(descrs_i) for k in csums):
        raise ValueError(f"csums {csums} index outside the {len(descrs_i)} i32 descriptors")
    if fsums:
        if not (with_gidx and segmented):
            raise ValueError("float sums need with_gidx and segmented")
        if len(fsums) > FSUM_MAX:
            raise ValueError(f"{len(fsums)} float sums; one launch folds at most {FSUM_MAX}")
        last = pass_tbl.shape[1] + len(descrs_f) + len(descrs_i)  # the gidx column's plane
        for off, fkind in fsums:
            if fkind not in FSUM_KINDS:
                raise ValueError(f"unknown float-sum kind {fkind!r}; expected one of {FSUM_KINDS}")
            if off < 0 or off + (2 if fkind in _FSUM_WIDE else 1) > last:
                raise ValueError(f"float sum at plane {off} ({fkind}) lies outside the {last} value planes")


def _widen(rows: np.ndarray, off: int, kind: str) -> np.ndarray:
    """numpy's float64 of one float-sum column, from its int32 planes."""
    w = np.ascontiguousarray(rows[:, off])
    if kind in _FSUM_WIDE:
        lo = np.ascontiguousarray(rows[:, off + 1]).view(np.uint32).astype(np.int64)
        return ((w.astype(np.int64) << 32) | lo).view(_FSUM_WIDE[kind]).astype(np.float64)
    if kind == "f32":
        return w.view(np.float32).astype(np.float64)
    if kind == "u32":
        return w.view(np.uint32).astype(np.float64)
    if kind == "f16":
        return w.astype(np.uint16).view(np.float16).astype(np.float64)
    return w.astype(np.float64)


def _fsum_plain(rows: np.ndarray, g: np.ndarray, fsums: tuple, ngroups: int):
    """(fsum (ngroups, len(fsums)) float64, nonfinite) of the survivors'
    ``rows`` in row order with group ids ``g``: ``np.add.at`` from +0.0,
    and the canonical NaN where a group's column holds a NaN or ±inf."""
    ok = (g >= 0) & (g < ngroups)
    rows, g = rows[ok], g[ok]
    fsum = np.zeros((ngroups, len(fsums)), np.float64)
    bad = np.zeros(fsum.shape, bool)
    for j, (off, kind) in enumerate(fsums):
        vals = _widen(rows, off, kind)
        acc = np.zeros(ngroups, np.float64)
        with np.errstate(all="ignore"):
            np.add.at(acc, g, vals)
        fsum[:, j] = acc
        bad[g[~np.isfinite(vals)], j] = True
    fsum[bad] = np.nan
    return fsum, int(bad.any())


def fused_chain_tiles_plain(scalars, pred, gidx, pass_tbl, limb_tbl, mmf, mmi, af, ai, *, op, kind, descrs_f, descrs_i,
                            csums, fns_f, fns_i, with_gidx, segmented, ngroups, tile=256, fsums=()):
    """Plain PyTorch version of the kernel: the same nine outputs, bit for
    bit, on any device (the float sums through numpy on the host)."""
    _check_args(pred, gidx, pass_tbl, limb_tbl, mmf, mmi, af, ai, op, kind, descrs_f, descrs_i, csums, fns_f, fns_i,
                ngroups, tile, fsums, with_gidx, segmented)
    n = pass_tbl.shape[0]
    dev = pass_tbl.device
    n_rows, t_hi, t_lo = _scalars(scalars)
    rows = torch.arange(n, device=dev)
    mask = rows < n_rows
    if kind != "none":
        mask = mask & _pred_mask(pred, t_hi, t_lo, op, kind)
    parts = [pass_tbl]
    icols = None
    if descrs_f:
        parts.append(project_tiles_plain(af, tuple(descrs_f), tile).view(torch.int32))
    if descrs_i:
        icols = project_tiles_plain(ai, tuple(descrs_i), tile)
        parts.append(icols)
    if with_gidx:
        parts.append(gidx.unsqueeze(1))
    full = torch.cat(parts, dim=1) if len(parts) > 1 else pass_tbl
    per_tile = mask.view(-1, tile)
    counts = per_tile.sum(dim=1, dtype=torch.int32)
    slot = torch.cumsum(per_tile.to(torch.int32), dim=1) - 1
    tile_base = torch.arange(n // tile, device=dev).unsqueeze(1) * tile
    dest = (tile_base + slot).reshape(-1)[mask]
    ctab = torch.zeros((n, full.shape[1]), dtype=torch.int32, device=dev)
    ctab[dest] = full[mask]

    # rows outside the fold carry group id -1, which no group matches
    g_fold = torch.where(mask, gidx, -1) if segmented else torch.full_like(gidx, -1)
    limbs = limb_tbl
    if csums:
        extra = []
        for k in csums:
            v = icols[:, k]
            extra += [(v >> (8 * s)) & 0xFF for s in range(3)]
            extra.append(v >> 24)  # signed top limb (arithmetic shift)
        limbs = torch.cat([limb_tbl, torch.stack(extra, dim=1)], dim=1)
    gsum, gcnt = segment_sum_tiles_plain(g_fold, limbs.contiguous(), n, ngroups, tile)
    gmmf = segment_minmax_tiles_plain(g_fold, mmf, n, ngroups, tuple(fns_f), tile)
    gmmi = segment_minmax_tiles_plain(g_fold, mmi, n, ngroups, tuple(fns_i), tile)
    ok = (g_fold >= 0) & (g_fold < ngroups)
    gfirst = torch.full((ngroups,), _I32_MAX, dtype=torch.int32, device=dev)
    gfirst.scatter_reduce_(0, g_fold[ok].to(torch.int64), rows[ok].to(torch.int32), "amin", include_self=True)
    fsum, nonfinite = np.zeros((ngroups, 0), np.float64), 0
    if fsums:
        fsum, nonfinite = _fsum_plain(full[mask].cpu().numpy(), gidx[mask].cpu().numpy(), tuple(fsums), ngroups)
    fsum = torch.from_numpy(fsum).to(dev)
    nonfinite = torch.tensor([nonfinite], dtype=torch.int32, device=dev)
    return ctab, counts, gsum, gcnt, gmmf, gmmi, gfirst, fsum, nonfinite


_NP_DT = {torch.int32: np.int32, torch.float32: np.float32, torch.float64: np.float64}
# the outputs' order in their allocation: ctab first (16-byte aligned for the kernel's vector stores), then the
# group outputs (fsum first, so its float64 is aligned), the counts; the kernel's ticket after them
_MEMORY_ORDER = (0, 7, 2, 3, 4, 5, 6, 8, 1)


class FusedOutputs(Sequence):
    """The nine outputs of a launch on the card, in one int32 allocation.
    Each is made as a view when it is asked for, and ``groups_to_host``
    reads the group outputs' range without making any: a torch call from
    Python lets another executor worker take the interpreter, so a fold
    that made nine views a morsel waited for it nine more times."""

    def __init__(self, dev, shapes: list):
        self._shapes = shapes  # [(dtype, shape)] of the nine outputs
        self._parts: list = [None] * len(shapes)  # (offset, words)
        off = 0
        for i in _MEMORY_ORDER:
            dt, shape = shapes[i]
            words = math.prod(shape) * dt.itemsize // 4
            self._parts[i] = (off, words)
            off += words
        self._ticket = off
        self.flat = torch.empty(off + 1, dtype=torch.int32, device=dev)
        self._base = self.flat.data_ptr()
        self.groups = (self._parts[7][0], self._parts[1][0])  # words [start, end) of the group outputs

    def __len__(self) -> int:
        return len(self._shapes)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return tuple(self[j] for j in range(len(self))[i])
        (off, words), (dt, shape) = self._parts[i], self._shapes[i]
        return self.flat[off : off + words].view(dt).view(shape)

    def ptr(self, i: int | None) -> int:
        """Address of output ``i``, or of the ticket for None."""
        return self._base + 4 * (self._ticket if i is None else self._parts[i][0])

    def groups_on_host(self) -> list:
        start, end = self.groups
        host = torch.empty(end - start, dtype=torch.int32, pin_memory=self.flat.is_cuda)
        host.copy_(self.flat[start:end])
        words = host.numpy()
        out = []
        for i in range(2, len(self)):
            (off, n), (dt, shape) = self._parts[i], self._shapes[i]
            out.append(words[off - start : off - start + n].view(_NP_DT[dt]).reshape(shape))
        return out


def _outputs(dev, n: int, dc: int, n_tiles: int, ngroups: int, ls: int, mf: int, mi: int, nfs: int) -> FusedOutputs:
    i32 = torch.int32
    return FusedOutputs(dev, [(i32, (n, dc)), (i32, (n_tiles,)), (i32, (ngroups, ls)), (i32, (ngroups,)),
                              (torch.float32, (ngroups, mf)), (i32, (ngroups, mi)), (i32, (ngroups,)),
                              (torch.float64, (ngroups, nfs)), (i32, (1,))])


def groups_to_host(out) -> list:
    """The group outputs of one call (``out[2:]``: gsum, gcnt, gmmf, gmmi,
    gfirst, fsum, nonfinite) as numpy arrays.  On the card they cross in one
    blocking device-to-host copy into pinned memory, carved by numpy."""
    if isinstance(out, FusedOutputs):
        return out.groups_on_host()
    return [t.numpy() for t in out[2:]]


def fused_chain_tiles(scalars, pred, gidx, pass_tbl, limb_tbl, mmf, mmi, af, ai, *, op, kind, descrs_f, descrs_i, csums,
                      fns_f, fns_i, with_gidx, segmented, ngroups, tile=256, fsums=()):
    """One launch over the whole morsel chain.

    Inputs (all row tables padded to a multiple of ``tile``; unused tables
    are width-1 zero dummies):

        scalars   (4,)      int32  [n_rows, t_hi bits, t_lo bits, 0] (host)
        pred      (N, P)    int32  filter-column bit-planes
        gidx      (N,)      int32  full-morsel group ids (zeros unsegmented)
        pass_tbl  (N, Dp)   int32  compaction passthrough planes
        limb_tbl  (N, L)    int32  passthrough sum-column 8-bit limb planes
        mmf       (N, Mf)   f32    min/max float32 columns
        mmi       (N, Mi)   i32    min/max int columns (widened)
        af        (N, Af)   f32    projection-arithmetic input columns
        ai        (N, Ai)   i32    projection-arithmetic input columns

    Returns ``(ctab, counts, gsum, gcnt, gmmf, gmmi, gfirst, fsum,
    nonfinite)`` on the inputs' device: the per-tile-compacted table ``[pass
    | computed f32 | computed i32 | gidx?]`` (rows past each tile's count
    zero) with per-tile survivor counts, and per-group limb sums
    ``[passthrough | in-kernel csums]``, counts, min/max extremes, the
    minimum surviving row index (``2^31-1`` for groups with no survivors),
    the float sums (ngroups, len(fsums)) float64 (the canonical NaN where a
    group's column holds a NaN or ±inf survivor) and their flag (1,) int32,
    set where any does."""
    if _build.runs_plain(pass_tbl):
        return fused_chain_tiles_plain(
            scalars, pred, gidx, pass_tbl, limb_tbl, mmf, mmi, af, ai, op=op, kind=kind, descrs_f=descrs_f,
            descrs_i=descrs_i, csums=csums, fns_f=fns_f, fns_i=fns_i, with_gidx=with_gidx, segmented=segmented,
            ngroups=ngroups, tile=tile, fsums=fsums,
        )
    if pass_tbl.device.type != "cuda":
        raise ValueError(f"fused_chain_tiles runs on cuda or cpu, got {pass_tbl.device}")
    dev = pass_tbl.device
    for name, t in (("pred", pred), ("gidx", gidx), ("pass_tbl", pass_tbl), ("limb_tbl", limb_tbl), ("mmf", mmf),
                    ("mmi", mmi), ("af", af), ("ai", ai)):
        _build.check_tensor(t, name, t.dtype, dev, t.dim())
    _check_args(pred, gidx, pass_tbl, limb_tbl, mmf, mmi, af, ai, op, kind, descrs_f, descrs_i, csums, fns_f, fns_i,
                ngroups, tile, fsums, with_gidx, segmented)
    n, dp = pass_tbl.shape
    length = limb_tbl.shape[1]
    mf, mi = mmf.shape[1], mmi.shape[1]
    nf, ni = len(descrs_f), len(descrs_i)
    dc = dp + nf + ni + (1 if with_gidx else 0)
    ls = length + 4 * len(csums)
    n_rows, t_hi, t_lo = _scalars(scalars)
    code_f, lits_f, n_code_f, n_lits_f = _program(tuple(descrs_f), "float32")
    code_i, lits_i, n_code_i, n_lits_i = _program(tuple(descrs_i), "int32")
    csum_arr = np.asarray(list(csums) or [0], np.int32)
    fns_f_arr = np.asarray([fn == "max" for fn in fns_f], np.int32)
    fns_i_arr = np.asarray([fn == "max" for fn in fns_i], np.int32)
    fs_off = np.asarray([off for off, _k in fsums] or [0], np.int32)
    fs_kind = np.asarray([FSUM_KINDS.index(k) for _o, k in fsums] or [0], np.int32)
    out = _outputs(dev, n, dc, n // tile, ngroups, ls, mf, mi, len(fsums))
    lib = _build.library()
    with torch.cuda.device(dev):  # the launch goes to the current device's context
        rc = lib.dacp_fused_chain(
            pred.data_ptr(), pred.shape[1], gidx.data_ptr(), pass_tbl.data_ptr(), dp, limb_tbl.data_ptr(), length,
            mmf.data_ptr(), mf, mmi.data_ptr(), mi, af.data_ptr(), af.shape[1], ai.data_ptr(), ai.shape[1],
            n, tile, max(0, min(n_rows, n)), t_hi, t_lo, OPS.index(op), KINDS.index(kind),
            code_f.ctypes.data, n_code_f, lits_f.ctypes.data, n_lits_f, nf,
            code_i.ctypes.data, n_code_i, lits_i.ctypes.data, n_lits_i, ni,
            csum_arr.ctypes.data, len(csums), fns_f_arr.ctypes.data, fns_i_arr.ctypes.data,
            int(bool(with_gidx)), int(bool(segmented)), ngroups,
            *(out.ptr(i) for i in range(7)), out.ptr(None), fs_off.ctypes.data, fs_kind.ctypes.data, len(fsums),
            out.ptr(7), out.ptr(8), _build.stream_of(pass_tbl),
        )
    _build.check(rc, "fused_chain_tiles")
    launches.bump()
    return out
