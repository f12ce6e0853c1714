"""idle_share.executor_host (%): the share of the recorded part of the
traced window (``perfbench.spans``) in which nothing ran on the card while,
inside a COOK, some thread of the executor was in host work: a ``source``
batch pulled, a morsel's ``stage``, a worker's ``morsel`` (its fold and
every child), a ``merge`` or the ``finalize``.  The card's intervals are
those ``idle_share.cook`` reads."""

from perfbench import spans


def read(run):
    w = spans.of(run)
    if w is None or not run.trace.intervals:
        return None
    host = spans.intersect(spans.merge([[s[1], s[2]] for s in w.named(*spans.EXECUTOR_HOST)]), w.cooks())
    return 100.0 * spans.length(spans.intersect(w.idle, host)) / (w.hi - w.lo)
