"""Host ms a call inside the program's public calls (the union of the
``tpusort.api.`` spans) less its waits for device values (the union of
the ``tpusort.read.`` spans): the host's own work of a call, planning and
enqueueing.  Most of it runs while the card works through what was
queued before, so it moves ``keys_per_s`` only where it coincides with
the card's idle, which ``device.idle_program_ms`` reads; a cut here that
leaves that metric flat leaves the rate flat.  A trace without any
``tpusort.api.`` span reads nothing."""

from portbench import spans


def read(run):
    tr = run.trace
    if tr is None:
        return None
    api = spans.union(tr, spans.API)
    if not api:
        return None
    reads = spans.intersect(spans.union(tr, spans.READ), api)
    return (spans.length(api) - spans.length(reads)) * 1e3 / tr.calls
