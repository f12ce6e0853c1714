"""idle_share.cook (%): the share of the traced part of the COOK window in
which nothing ran on the card (kernels and copies, from the trace)."""


def read(run):
    t = run.trace
    if not t.window_s or not t.intervals:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
