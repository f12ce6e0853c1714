"""moe_experts_roofline (%): the expert products' FLOPs in the traced
window, the MoE's assignments there (``facts["moe_counts"]``, from the
port's ``models.moe.STATS``) times 2 · 3 · d · f
(``counts.granitemoehybrid.expert_flops_per_assignment``), at 989
TFLOP/s, over the device time of the kernels that compute them: the
grouped GEMM that ``torch._grouped_mm`` launches on Hopper (CUTLASS's
kernel over a ``GroupProblemShape``) and the kernel that lays out its
groups' pointers and strides from the segment ends
(``prepare_grouped_gemm_data``), both by the names the card's trace gives
them."""

from perfbench.counts.granitemoehybrid import PEAK_BF16_FLOPS, expert_flops_per_assignment

KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(run):
    f, t = run.facts, run.trace
    counts = f.get("moe_counts")
    seconds = t.kernel_seconds(*KERNELS)
    if not counts or not counts.get("assignments") or not seconds:
        return None
    return 100.0 * counts["assignments"] * expert_flops_per_assignment(f["conf"]) / PEAK_BF16_FLOPS / seconds
