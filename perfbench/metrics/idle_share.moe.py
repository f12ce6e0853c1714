"""idle_share.moe (%): the share of the recorded part of the traced window
(``perfbench.spans``) in which nothing ran on the card while a ``moe``
span was open: the MoE layers' host work (routing, the dispatch's launches
issued slower than the card runs them).  From the port's span recorder
and the trace's device intervals."""

from perfbench import spans


def read(run):
    w = spans.of(run)
    if w is None or not run.trace.intervals:
        return None
    moe = spans.merge([[s[1], s[2]] for s in w.named("moe")])
    if not moe:
        return None
    return 100.0 * spans.length(spans.intersect(w.idle, moe)) / (w.hi - w.lo)
