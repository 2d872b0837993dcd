"""K7: the all-to-all of per-shard windows behind the global sort's
``exchange="rdma"`` route.

PyTorch port of ``tpusort/parallel/ring.py:ring_all_to_all``.  The TPU
kernel pushes: each shard DMAs its windows straight into its peers' receive
buffers over ICI.  Here shard r pulls: :func:`ring_all_to_all` gets the d
shards' (d, window) send buffers and writes window r of each into its own
output (``csrc/ring.cu``, one launch on a CUDA tensor; see that file for the
design).  The communicator (``parallel.comm``) hands every shard its peers'
send buffers and puts a barrier on either side of the launch.  On a CPU
tensor the wrapper runs :func:`ring_all_to_all_plain`.
"""

from __future__ import annotations

import collections
from typing import Sequence

import torch

from tpusort_torch.kernels import _build

__all__ = ["ring_all_to_all", "ring_all_to_all_plain"]


def ring_all_to_all_plain(sends: Sequence[torch.Tensor],
                          rank: int) -> torch.Tensor:
    """Plain PyTorch K7: row s of the result is ``sends[s][rank]``."""
    return torch.stack([s[rank] for s in sends])


def _ring_all_to_all_cuda(sends: Sequence[torch.Tensor],
                          rank: int) -> torch.Tensor:
    d, window = sends[0].shape
    out = torch.empty((d, window), dtype=torch.int32, device=sends[0].device)
    err = _build.library().tpusort_ring_pull(
        _build.pointers(sends), d, rank, window, out.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "ring_all_to_all")
    _build.count_launch(ring_all_to_all, 0, 1)
    return out


def ring_all_to_all(sends: Sequence[torch.Tensor], rank: int) -> torch.Tensor:
    """On shard ``rank`` of d: the (d, window) int32 tensor whose row s is
    the window shard s sends to this shard, ``sends[s][rank]``.

    ``sends``: every shard's (d, window) int32 send buffer, row b for
    shard b, window % 128 == 0 (the TPU kernel's (rows, 128) tiling), all
    contiguous and on one device.  The caller makes sure every buffer has
    been written before the call and is not reused before every shard has
    made its call (``parallel.comm``).  Launches ``csrc/ring.cu`` on a CUDA
    tensor; runs :func:`ring_all_to_all_plain` on a CPU tensor.
    """
    d = len(sends)
    if d < 1:
        raise ValueError("ring_all_to_all needs at least one shard")
    dev = sends[0].device
    for s in sends:
        if s.dtype != torch.int32 or s.dim() != 2 or s.shape[0] != d \
                or s.shape != sends[0].shape or s.device != dev \
                or not s.is_contiguous():
            raise ValueError(f"sends must be {d} contiguous ({d}, window) "
                             "int32 tensors of one shape on one device")
    if sends[0].shape[1] % 128:
        raise ValueError(f"window {sends[0].shape[1]} is not a multiple of "
                         "128")
    if not 0 <= rank < d:
        raise ValueError(f"rank {rank} outside [0, {d})")
    if dev.type == "cpu":
        return ring_all_to_all_plain(sends, rank)
    if dev.type == "cuda":
        return _ring_all_to_all_cuda(sends, rank)
    raise ValueError(f"no K7 for device {dev}")


ring_all_to_all.launches = 0
ring_all_to_all.modes = collections.Counter()
