"""tpusort_torch: the PyTorch + CUDA (Hopper) port of tpusort.

The MSD radix sort of 1-D uint32/int32/float32 and uint64/int64/float64
tensors, keys only or with 32- and 64-bit payloads, stable or unstable,
over the whole key or a bit range, plus ``argsort``, the plane interface
``sort_planes`` and ``sort_pairs_lsb_in_value``; ``sort`` and
``sort_planes`` run the host tiering (radix, then the equi-depth skew
tier, then the exact sort; presorted inputs come back after one check).
``sort_batched`` sorts the rows of a (B, K) tensor and ``segmented_sort``
ragged segments given by offsets; ``ops.scan`` (prefix sums and scans) and
``ops.histogram`` (``histogram_even``, ``digit_histogram``) are the scan
and histogram primitives.  ``algorithm=`` names an engine of the registry
(``register_engine``, ``available_engines``).  ``parallel.global_sort``,
``make_global_sort`` and ``make_global_sort_planes`` sort across shards
of a communicator: ``parallel.InProcessComm`` (d shards on one device, in
one process) or ``parallel.ProcessGroupComm`` (a ``torch.distributed``
group).  On a CUDA tensor the partition passes, the leaves, the collapse,
the tile sorts, the prefix sum, the digit histogram and the global sort's
window exchange run as hand-written sm_90a kernels (``tpusort_torch/csrc``),
built with nvcc at first use; on a CPU tensor they run as their plain
PyTorch versions.  The JAX package ``tpusort`` is the reference the port is
tested against; this package never imports jax.
"""

from tpusort_torch.api import (
    argsort,
    available_engines,
    register_engine,
    sort,
    sort_keys,
    sort_keys_descending,
    sort_pairs,
    sort_pairs_descending,
    sort_pairs_lsb_in_value,
    sort_planes,
    unstable_sort_keys,
    unstable_sort_pairs,
)
from tpusort_torch.configs import SortConfig, get_config, register_config
from tpusort_torch.ops.segmented import segmented_sort, sort_batched

__version__ = "0.1.0"
