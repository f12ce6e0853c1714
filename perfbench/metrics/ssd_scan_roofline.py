"""ssd_scan_roofline (%): the least bytes of the traced grouped
``ssd_scan`` launches (``counts.zamba2.ssd_bytes``: x, dt, B and C read
once, y and the final state written once, at each forward's (batch,
padded length)) at 3.35 TB/s (H100 SXM), over the device time of the
scan's three kernels (state, carry, out).  A launch is counted by its
``out`` kernel; the window's bytes are its launches times their mean over
a COOK's forwards."""

from perfbench.counts.zamba2 import ssd_bytes
from perfbench.harness import PEAK_HBM_BYTES_PER_S


def read(run):
    f, t = run.facts, run.trace
    launches = t.kernel_launches("ssd_scan_kernel_out")
    seconds = t.kernel_seconds("ssd_scan_kernel")
    if not launches or not seconds or "forwards" not in f:
        return None
    per_launch = sum(ssd_bytes(f["conf"], batch, seq) for batch, seq in f["forwards"]) / len(f["forwards"])
    return 100.0 * launches * per_launch / PEAK_HBM_BYTES_PER_S / seconds
