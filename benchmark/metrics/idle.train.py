"""Share of the untraced window in which no device operation ran, in
percent: 1 - (device busy seconds a train call, from the profiler's trace of
the traced calls) x (train calls a second of the untraced window).  The
profiler slows the host, so the traced window's own idle share would
partly measure the profiler."""


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.calls * run.calls_per_s)
