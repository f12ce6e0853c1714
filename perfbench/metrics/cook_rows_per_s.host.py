"""cook_rows_per_s.host (rows/s): the source rows of every COOK completed in
the window over the time from the window's start to the last completion in
it, on the host clock (``facts["rows_per_s"]`` of the traffic driver).  The
host's cores set it, and their speed drifts from minute to minute on the
card's machine, so it is read per layer and held to no bound."""


def read(run):
    return run.facts.get("rows_per_s")
