"""The program's own host spans in a traced stretch, as intervals.

``tpusort_torch`` marks each public call with a host span named
``tpusort.api.<entry>`` and each place where its host waits for a device
value with ``tpusort.read.<site>`` (function-scope profiler records, which
:func:`portbench.trace.from_profiler` keeps among the host operations).  A
program without them leaves these unions empty, and the metrics that read
them then read nothing.
"""

from __future__ import annotations

from typing import List, Tuple

from portbench.trace import Trace, merge

API = "tpusort.api."
READ = "tpusort.read."

Intervals = List[Tuple[float, float]]


def union(tr: Trace, prefix: str) -> Intervals:
    """The union of the host spans whose name starts with ``prefix``, cut
    to the stretch."""
    return [(max(a, tr.t0), min(b, tr.t1))
            for a, b in merge((a, b) for name, a, b in tr.host_ops
                              if name.startswith(prefix))
            if b > tr.t0 and a < tr.t1]


def length(iv: Intervals) -> float:
    return sum(b - a for a, b in iv)


def intersect(x: Intervals, y: Intervals) -> Intervals:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle(tr: Trace) -> Intervals:
    """The stretch less the device's busy intervals."""
    out, t = [], tr.t0
    for a, b in tr.busy():
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if tr.t1 > t:
        out.append((t, tr.t1))
    return out
