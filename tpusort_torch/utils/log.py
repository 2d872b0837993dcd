"""Leveled logging, host spans and the host-read count.

Port of ``tpusort/utils/log.py``: the analog of the reference's
``APPLOG_*`` leveled printf logging (``msb/src/utils/app_log.h:32-44``)
and its ``DEBUG_LEVEL``-gated timer macros
(``msb/src/benchmark/debug_logger.h:6-65``), on the stdlib logger so it
composes with host applications.  The logger is named ``tpusort_torch``.

The level comes from ``TPUSORT_LOG`` (TRACE/DEBUG/INFO/WARNING/ERROR,
default WARNING), the same variable the JAX package reads.

:func:`span` marks a stretch of the program's host code (named
``tpusort.<layer>...``) for ``torch.profiler`` and, at TRACE, logs its host
time (:func:`spanned` does so for every call of a function);
:func:`host_read` marks a place where the host blocks on a device
value and counts it, read through ``ops.msd.counters()``, as
:func:`count` counts the bytes of the 64-bit split and join and of the
merge-body launches.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import threading
import time

__all__ = ["logger", "span", "spanned", "host_read", "count", "set_level",
           "TRACE"]

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

logger = logging.getLogger("tpusort_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter(
            "[tpusort_torch %(levelname)s %(asctime)s] %(message)s",
            datefmt="%H:%M:%S"))
    logger.addHandler(_h)
    logger.propagate = False


def set_level(level) -> None:
    """Set the logger's level: a number, or a name (TRACE, DEBUG, INFO,
    WARNING, ERROR)."""
    if isinstance(level, str):
        level = TRACE if level.upper() == "TRACE" else \
            getattr(logging, level.upper())
    logger.setLevel(level)


set_level(os.environ.get("TPUSORT_LOG", "WARNING"))

try:
    from torch._C._profiler import _RecordFunctionFast as _Fast
except ImportError:                                   # an older torch
    _Fast = None

# the host reads, the bytes the 64-bit split and join copy (``dtypes.py``)
# and the bytes K1's, K1b's and K2's merge-body launches read and write
# (``kernels/partition.py``, ``kernels/bitonic.py``), since the last
# reset_counters(); a lock, as the global sort's shards run threads of
# their own
COUNTS = {"host_reads": 0, "split_join_bytes": 0, "merge_bytes": 0}
_COUNT_LOCK = threading.Lock()


class _Logged:
    """A span that also logs its block's host ms at TRACE."""
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str, rf):
        self.name, self.rf = name, rf

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self.t0) * 1e3
        if self.rf is not None:
            self.rf.__exit__(*exc)
        logger.log(TRACE, "%s: %.3f ms", self.name, ms)
        return False


def span(name: str):
    """A context manager that marks a block of host code as ``name`` for
    ``torch.profiler``; at TRACE (``TPUSORT_LOG=TRACE``) it also logs the
    block's host ms, which on a card is the time to enqueue its work, not
    the device time.

    The event is a function-scope record, not ``record_function``'s user
    annotation: the profiler keeps it among the host operations on the
    clock of the device's activity, nested by time, so a trace can charge
    host time and the device's idle time to the program's own steps; and
    with no profiler running it costs under a microsecond, against about
    ten for ``record_function``.  Where torch lacks the record, only the
    log remains."""
    rf = None if _Fast is None else _Fast(name)
    if logger.isEnabledFor(TRACE):
        return _Logged(name, rf)
    return contextlib.nullcontext() if rf is None else rf


def spanned(name: str):
    """Decorate a function so that each call runs in :func:`span`
    ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(key: str, amount: int = 1) -> None:
    """Add ``amount`` to the counter ``key`` of :data:`COUNTS`."""
    with _COUNT_LOCK:
        COUNTS[key] += amount


def host_read(site: str):
    """:func:`span` ``tpusort.read.<site>`` around a place where the host
    waits for a device value (a flag, a sample, a count), counted in
    ``host_reads`` on every device."""
    count("host_reads")
    return span("tpusort.read." + site)
