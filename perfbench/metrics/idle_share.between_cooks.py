"""idle_share.between_cooks (%): the share of the recorded part of the
traced window (``perfbench.spans``) in which nothing ran on the card and no
COOK was open (no ``cook`` span): the reply's last frames, the client, the
next request and its plan.  The card's intervals are those
``idle_share.cook`` reads."""

from perfbench import spans


def read(run):
    w = spans.of(run)
    if w is None or not run.trace.intervals:
        return None
    return 100.0 * (spans.length(w.idle) - spans.length(spans.intersect(w.idle, w.cooks()))) / (w.hi - w.lo)
