"""Keys of the calls completed in the window over the window's seconds (a
pair counts as one key)."""

from portbench import stats


def read(run):
    return stats.rate(run.window.keys, run.window.seconds)
