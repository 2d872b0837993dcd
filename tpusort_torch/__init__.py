"""tpusort_torch: the PyTorch + CUDA (Hopper) port of tpusort.

The keys-only MSD radix sort of 1-D uint32/int32/float32 tensors.  On a CUDA
tensor the partition passes and the leaf run as hand-written sm_90a kernels
(``tpusort_torch/csrc``), built with nvcc at first use; on a CPU tensor they
run as their plain PyTorch versions.  The JAX package ``tpusort`` is the
reference the port is tested against; this package never imports jax.
"""

from tpusort_torch.api import (
    sort,
    sort_keys,
    sort_keys_descending,
    unstable_sort_keys,
)
from tpusort_torch.configs import SortConfig, get_config, register_config

__version__ = "0.1.0"
