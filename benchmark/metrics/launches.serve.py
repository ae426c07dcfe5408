"""Device operations (kernels, copies, sets) a serve call runs, from the
profiler's trace of the traced calls."""


def read(run):
    if run.kind != "serve" or run.trace is None or not run.trace.ops:
        return None
    return len(run.trace.ops) / run.trace.calls
