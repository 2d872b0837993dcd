"""The nearest-rank 95th percentile of every call's time in the window,
in ms: from the call to the ``synchronize()`` after it."""

from portbench import stats


def read(run):
    return stats.percentile(run.window.call_s, 95) * 1e3
