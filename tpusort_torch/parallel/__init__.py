"""The distributed global sort (``global_sort``, ``make_global_sort``,
``make_global_sort_planes``), its communicators (``comm``) and K7, the
window exchange (``ring``)."""

from tpusort_torch.parallel.comm import InProcessComm, ProcessGroupComm
from tpusort_torch.parallel.global_sort import (
    global_sort, make_global_sort, make_global_sort_planes)

__all__ = ["InProcessComm", "ProcessGroupComm", "global_sort",
           "make_global_sort", "make_global_sort_planes"]
