"""Device milliseconds a serving call spends in operations launched inside
the model's decoder (the ``bench.decoder`` range the benchmark opens around
``model.decoder``), from the profiler's trace."""


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    s = run.trace.device_s_in("decoder")
    return 1e3 * s / run.trace.calls if s > 0 else None
