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

``fused_chain_tiles_plain`` is the same function in plain PyTorch (the
compaction of ``filter_select_planes_plain``, the programs of
``project_tiles_plain``, the folds of the segment kernels' plain versions);
the wrapper runs it for tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.filter_select import OPS, _pred_mask, _scalars
from repro_torch.kernels.project_arith import compile_program, fits as _descr_fits, project_tiles_plain
from repro_torch.kernels.segment_reduce import segment_minmax_tiles_plain, segment_sum_tiles_plain

__all__ = [
    "KINDS",
    "SHARED_MAX_BYTES",
    "fused_chain_tiles",
    "fused_chain_tiles_plain",
    "fits",
    "launches",
    "shared_bytes",
]

KINDS = ("f32", "i32", "i64", "none")
# Limits of one launch; they match csrc/fused_chain.cu.
SHARED_MAX_BYTES = 232320  # 227 KB per block, less the kernel's 128 static bytes
CSUM_MAX = 64
MM_COLS_MAX = 256
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


def fits(descrs_f: tuple, descrs_i: tuple, csums: tuple, limb_cols: int, mf: int, mi: int, ngroups: int) -> bool:
    """Whether one launch takes this plan: each dtype's trees fit one postfix
    program, and the segmented fold's accumulators for ``ngroups`` groups fit
    a block's shared memory."""
    for descrs, dt in ((descrs_f, "float32"), (descrs_i, "int32")):
        if not all(_descr_fits(d, dt) for d in descrs):
            return False
        if descrs and len(compile_program(tuple(descrs), dt)) != 1:
            return False
    if len(csums) > CSUM_MAX or mf > MM_COLS_MAX or mi > MM_COLS_MAX:
        return False
    return shared_bytes(ngroups, limb_cols, len(csums), mf, mi) <= SHARED_MAX_BYTES


def _check_args(pred, gidx, pass_tbl, limb_tbl, mmf, mmi, af, ai, op, kind, descrs_f, descrs_i, csums, fns_f, fns_i,
                ngroups, tile):
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


def fused_chain_tiles_plain(scalars, pred, gidx, pass_tbl, limb_tbl, mmf, mmi, af, ai, *, op, kind, descrs_f, descrs_i,
                            csums, fns_f, fns_i, with_gidx, segmented, ngroups, tile=256):
    """Plain PyTorch version of the kernel: the same seven outputs, bit for
    bit, on any device."""
    _check_args(pred, gidx, pass_tbl, limb_tbl, mmf, mmi, af, ai, op, kind, descrs_f, descrs_i, csums, fns_f, fns_i,
                ngroups, tile)
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
    return ctab, counts, gsum, gcnt, gmmf, gmmi, gfirst


def fused_chain_tiles(scalars, pred, gidx, pass_tbl, limb_tbl, mmf, mmi, af, ai, *, op, kind, descrs_f, descrs_i, csums,
                      fns_f, fns_i, with_gidx, segmented, ngroups, tile=256):
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

    Returns ``(ctab, counts, gsum, gcnt, gmmf, gmmi, gfirst)`` on the
    inputs' device: the per-tile-compacted table ``[pass | computed f32 |
    computed i32 | gidx?]`` (rows past each tile's count zero) with per-tile
    survivor counts, and per-group limb sums ``[passthrough | in-kernel
    csums]``, counts, min/max extremes, and the minimum surviving row index
    (``2^31-1`` for groups with no survivors)."""
    if _build.runs_plain(pass_tbl):
        return fused_chain_tiles_plain(
            scalars, pred, gidx, pass_tbl, limb_tbl, mmf, mmi, af, ai, op=op, kind=kind, descrs_f=descrs_f,
            descrs_i=descrs_i, csums=csums, fns_f=fns_f, fns_i=fns_i, with_gidx=with_gidx, segmented=segmented,
            ngroups=ngroups, tile=tile,
        )
    if pass_tbl.device.type != "cuda":
        raise ValueError(f"fused_chain_tiles runs on cuda or cpu, got {pass_tbl.device}")
    dev = pass_tbl.device
    for name, t in (("pred", pred), ("gidx", gidx), ("pass_tbl", pass_tbl), ("limb_tbl", limb_tbl), ("mmf", mmf),
                    ("mmi", mmi), ("af", af), ("ai", ai)):
        _build.check_tensor(t, name, t.dtype, dev, t.dim())
    _check_args(pred, gidx, pass_tbl, limb_tbl, mmf, mmi, af, ai, op, kind, descrs_f, descrs_i, csums, fns_f, fns_i,
                ngroups, tile)
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
    ctab = torch.empty((n, dc), dtype=torch.int32, device=dev)
    counts = torch.empty((n // tile + 1,), dtype=torch.int32, device=dev)  # the last int: the kernel's ticket
    gsum = torch.empty((ngroups, ls), dtype=torch.int32, device=dev)
    gcnt = torch.empty((ngroups,), dtype=torch.int32, device=dev)
    gmmf = torch.empty((ngroups, mf), dtype=torch.float32, device=dev)
    gmmi = torch.empty((ngroups, mi), dtype=torch.int32, device=dev)
    gfirst = torch.empty((ngroups,), dtype=torch.int32, device=dev)
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
            ctab.data_ptr(), counts.data_ptr(), gsum.data_ptr(), gcnt.data_ptr(), gmmf.data_ptr(), gmmi.data_ptr(),
            gfirst.data_ptr(), counts.data_ptr() + 4 * (n // tile), _build.stream_of(pass_tbl),
        )
    _build.check(rc, "fused_chain_tiles")
    launches.bump()
    return ctab, counts[: n // tile], gsum, gcnt, gmmf, gmmi, gfirst
