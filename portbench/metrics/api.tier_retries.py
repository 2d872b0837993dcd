"""Tier dispatches a call that overflowed and handed on to the next tier
(``api.py``'s chain radix -> equi-depth -> exact), from the deltas of
``tpusort_torch.ops.msd.counters()`` over the traced stretch: the tiers
dispatched (``radix_tiers``, ``equidepth_runs``, ``overflow_fallbacks``)
less the calls that a tier finished (every call but the identity routes).
An engine that hands a shape to the exact sort counts
``reference_routes``, which does not say which tier it was in: then the
metric reads nothing."""

DISPATCHES = ("radix_tiers", "equidepth_runs", "overflow_fallbacks")


def read(run):
    tr = run.trace
    if tr is None or not all(k in tr.counters for k in DISPATCHES):
        return None
    c = tr.counters
    if c.get("reference_routes", 0):
        return None
    dispatched = sum(c[k] for k in DISPATCHES)
    finished = tr.calls - c.get("identity_routes", 0)
    return (dispatched - finished) / tr.calls
