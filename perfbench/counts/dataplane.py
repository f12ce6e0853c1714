"""Bytes of the data plane's fused chain, from the COOK's shapes.

After ``chip_smoke.py``'s ``_fused_bytes``: every input table of a
``fused_chain_tiles`` launch read once, the surviving rows written once
compacted, the tile counts and the group outputs written once.  A plan's
tables are named by the workload's ``fused_plan``: how many columns each
input table holds (tables the plan does not use hold none), how many
computed columns the kernel writes, and whether it keeps each row's group.
"""

from __future__ import annotations

TILE = 256  # rows of a tile: the kernels' tile
SUM_LIMBS = 8  # an integer sum rides in eight byte limbs


def fused_chain_bytes(rows: int, survivors: int, tiles: int, group_slots: int, *, pred_cols: int,
                      pass_cols: int, limb_sums: int, csums: int, min_f32: int, max_i32: int, af_cols: int,
                      ai_cols: int, computed_f32: int, computed_i32: int, with_gidx: bool) -> int:
    """Bytes that launches over ``rows`` rows in all must move, of which
    ``survivors`` pass the filter, in ``tiles`` tiles, folding
    ``group_slots`` groups in all (each launch's groups summed): the
    predicate's planes, the group ids, the passed-through planes, the
    integer sums' limbs, the min/max columns and the arithmetic's inputs
    read; each survivor's passed and computed columns and group id written;
    a count a tile; each group's sums, count, first row and min/max."""
    read = 4 * rows * (pred_cols + 1 + pass_cols + SUM_LIMBS * limb_sums + min_f32 + max_i32 + af_cols + ai_cols)
    written = 4 * survivors * (pass_cols + computed_f32 + computed_i32 + int(with_gidx))
    per_group = SUM_LIMBS * limb_sums + 4 * csums + 2 + min_f32 + max_i32
    return read + written + 4 * tiles + 4 * group_slots * per_group

