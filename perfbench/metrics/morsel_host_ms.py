"""morsel_host_ms (ms): the executor's host CPU time a morsel.  The thread
CPU time of the ``stage`` spans (a morsel's encode and copy issue, which a
worker runs before taking it) and the ``morsel`` spans (a worker's fold of
it: factorize, launch, readback, decode) that end in the recorded part of
the traced window, over the number of ``morsel`` spans there.  From the
port's span recorder (``perfbench.spans``)."""

from perfbench import spans


def read(run):
    w = spans.of(run)
    if w is None:
        return None
    inside = [s for s in w.named("stage", "morsel") if w.lo <= s[2] <= w.hi and s[3] is not None]
    morsels = sum(1 for s in inside if s[0] == "morsel")
    if not morsels:
        return None
    return sum(s[3] for s in inside) / morsels * 1e-6
