"""Host milliseconds from calling the train entry to its return, before any
synchronisation, averaged over every call of the window (host clock)."""


def read(run):
    if run.kind != "train" or not run.issue_s:
        return None
    return 1e3 * sum(run.issue_s) / len(run.issue_s)
