"""The port's overflow policy, in one place.

The radix and equi-depth engines size their digit runs statically and
report a run that overflowed as a flag: a 0-d bool tensor on the device,
or None where they handed the input to an exact sort.  They take no
fallback themselves.  Each caller states its chain of attempts, the last
an exact sort, and :func:`first_clear` runs it.  This is the only place
in ``tpusort_torch`` that reads an overflow flag on the host.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from tpusort_torch.ops import msd as _msd
from tpusort_torch.utils.log import host_read

__all__ = ["first_clear"]


def first_clear(attempts: Sequence[Callable], site: str,
                route: str = "overflow_fallbacks",
                first_sync: Optional[Callable] = None):
    """Run ``attempts`` in turn until one's flag is clear and return its
    (planes, values).  Each attempt returns (planes, values, flag); a
    flag of None stands without a read, and the last attempt always
    stands.  Each flag read is a ``host_read`` at ``site``; the last
    attempt, run after a flag, counts ``route``.  ``first_sync`` runs
    after the first attempt is queued and before its flag is read, so
    the host works while the device sorts.  A flagged result is freed
    before the next attempt runs."""
    last = len(attempts) - 1
    out = None
    for i, attempt in enumerate(attempts):
        if i == last and i:
            _msd.count_route(route)
        out = None
        *out, flag = attempt()
        if first_sync is not None:
            first_sync()
            first_sync = None
        if i == last or flag is None:
            break
        with host_read(site):
            if not bool(flag):
                break
    return tuple(out)
