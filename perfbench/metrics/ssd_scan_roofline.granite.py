"""ssd_scan_roofline.granite (%): the least bytes of the traced
``ssd_scan`` launches at d_state 128 (``counts.granitemoehybrid.ssd_bytes``:
x, dt, B and C read once, y and the final state written once, at each
forward's (batch, padded length)) at 3.35 TB/s (H100 SXM), over the device
time of the scan's three kernels (state, carry, out) at n = 128.  A launch
is counted by its ``out`` kernel; the window's bytes are its launches
times their mean over a COOK's forwards."""

from perfbench.counts.granitemoehybrid import ssd_bytes
from perfbench.harness import PEAK_HBM_BYTES_PER_S

OUT, ALL = "ssd_scan_kernel_out<64, 128>", ("ssd_scan_kernel_state<64, 128>", "ssd_scan_kernel_carry<64, 128>",
                                            "ssd_scan_kernel_out<64, 128>")


def read(run):
    f, t = run.facts, run.trace
    launches = t.kernel_launches(OUT)
    seconds = t.kernel_seconds(*ALL)
    if not launches or not seconds or "forwards" not in f or "layer_types" not in f.get("conf", {}):
        return None
    per_launch = sum(ssd_bytes(f["conf"], batch, seq) for batch, seq in f["forwards"]) / len(f["forwards"])
    return 100.0 * launches * per_launch / PEAK_HBM_BYTES_PER_S / seconds
