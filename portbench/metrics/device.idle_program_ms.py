"""Device-idle ms a call that falls inside the program's public calls: the
traced stretch less the device's busy intervals, intersected with the
union of the ``tpusort.api.`` spans.  The idle that the program's host
code leaves; the rest of ``device.idle_pct``'s idle lies outside every
call, and is the caller's.  A trace without device operations or without
any ``tpusort.api.`` span reads nothing."""

from portbench import spans


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    api = spans.union(tr, spans.API)
    if not api:
        return None
    return spans.length(spans.intersect(spans.idle(tr), api)) * 1e3 / tr.calls
