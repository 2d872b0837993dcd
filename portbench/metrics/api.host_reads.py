"""Times a call that the program's host waited for a device value (a
flag, the planner's sample, a count): the delta of ``host_reads`` in
``tpusort_torch.ops.msd.counters()`` over the traced stretch, a call.
Each such wait is a ``tpusort.read.<site>`` span; a trace without any
``tpusort.api.`` span reads nothing."""

from portbench import spans


def read(run):
    tr = run.trace
    if tr is None or "host_reads" not in tr.counters or \
            not spans.union(tr, spans.API):
        return None
    return tr.counters["host_reads"] / tr.calls
