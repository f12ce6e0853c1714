"""fused_chain_roofline (%): the bytes of the fused chain's launches in the
traced window (``counts.dataplane.fused_chain_bytes`` over a COOK's shapes
and its mean survivors, for the plan the workload's ``fused_plan`` names,
shared out over the COOK's launches) at the card's 3.35 TB/s, over the
device time of its two kernels (init and chain) in the same trace."""

from perfbench.counts.dataplane import fused_chain_bytes
from perfbench.harness import PEAK_HBM_BYTES_PER_S


def read(run):
    t, f = run.trace, run.facts
    launches = t.kernel_launches("fused_chain_kernel")
    seconds = t.kernel_seconds("fused_chain_kernel", "fused_init_kernel")
    if not launches or not seconds or "survivors_per_cook" not in f:
        return None
    per_cook = fused_chain_bytes(f["rows_per_cook"], f["survivors_per_cook"], f["tiles_per_cook"],
                                 f["group_slots_per_cook"], **f["fused_plan"])
    return 100.0 * launches * per_cook / f["morsels_per_cook"] / PEAK_HBM_BYTES_PER_S / seconds
