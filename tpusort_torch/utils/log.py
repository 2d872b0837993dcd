"""Leveled logging and debug timers.

Port of ``tpusort/utils/log.py``: the analog of the reference's
``APPLOG_*`` leveled printf logging (``msb/src/utils/app_log.h:32-44``)
and its ``DEBUG_LEVEL``-gated timer macros
(``msb/src/benchmark/debug_logger.h:6-65``), on the stdlib logger so it
composes with host applications.  The logger is named ``tpusort_torch``.

The level comes from ``TPUSORT_LOG`` (TRACE/DEBUG/INFO/WARNING/ERROR,
default WARNING), the same variable the JAX package reads.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator

__all__ = ["logger", "timed", "set_level", "TRACE"]

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


@contextlib.contextmanager
def timed(name: str, level: int = logging.DEBUG) -> Iterator[None]:
    """Log the host time of a block at ``level`` (the START/STOP_CPU_TIMER
    analog, ``debug_logger.h:14-29``).  On a card this is the time to
    enqueue the block's kernels, not their device time, which
    :mod:`tpusort_torch.utils.timing` measures."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.log(level, "%s: %.3f ms", name,
                   (time.perf_counter() - t0) * 1e3)
