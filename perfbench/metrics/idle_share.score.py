"""idle_share.score (%): the share of the recorded part of the traced
window (``perfbench.spans``) in which nothing ran on the card while a
``score`` span was open: the scoring map's host work (unpacking the
documents, building each forward's batch, launching the model's kernels
faster or slower than the card runs them, the log-probabilities' copy
back).  From the port's span recorder and the trace's device intervals."""

from perfbench import spans


def read(run):
    w = spans.of(run)
    if w is None or not run.trace.intervals:
        return None
    scoring = spans.merge([[s[1], s[2]] for s in w.named("score")])
    if not scoring:
        return None
    return 100.0 * spans.length(spans.intersect(w.idle, scoring)) / (w.hi - w.lo)
