"""Small-array fast path: one tile, one K3 launch.

PyTorch port of ``tpusort/ops/small.py``: the whole problem fits one tile,
so one launch of the row tile sort (``kernels.bitonic.sort_tiles``) sorts
it with no passes, histograms or exchanges (CUB's single-tile dispatch).
Unstable: exact for keys, a permutation within equal keys for pairs.  The
same delegation rules as the JAX module send everything else to the stable
reference sort: several key planes, bit-range sorts, payloads that are not
32-bit words, pairs whose length needs pad slots, and more than one tile.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from tpusort_torch.kernels.bitonic import sort_tiles
from tpusort_torch.ops.reference import sort_twiddled_reference

_MAX_SINGLE_TILE = 1 << 14


def single_tile_ok(
    planes: Tuple[torch.Tensor, ...],
    values: Sequence[torch.Tensor],
    *,
    begin_bit: int,
    end_bit: int,
    total_bits: int,
    config=None,
) -> bool:
    """Whether :func:`sort_twiddled_bitonic` sorts these operands on K3
    (True) or delegates to the reference sort (False).  Payloads come back
    unstable, so callers route only keys and unstable pairs here."""
    n = planes[0].shape[0]
    pad = (-n) % 128
    tile_max = min(
        config.small_n_threshold if config is not None else _MAX_SINGLE_TILE,
        _MAX_SINGLE_TILE,
    )
    return not (
        n == 0
        or len(planes) != 1
        or begin_bit != 0
        or end_bit != total_bits
        or n + pad > tile_max
        or any(v.dtype != torch.int32 for v in values)
        or (pad and values)  # as in JAX: no pad slots for pairs
    )


def sort_twiddled_bitonic(
    planes: Tuple[torch.Tensor, ...],
    values: Sequence[torch.Tensor],
    *,
    begin_bit: int,
    end_bit: int,
    total_bits: int,
    config=None,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Sort twiddled int32 plane(s) + int32 payloads ascending in one K3
    launch, or delegate to the reference sort (see :func:`single_tile_ok`).
    """
    bits = dict(begin_bit=begin_bit, end_bit=end_bit, total_bits=total_bits)
    if not single_tile_ok(planes, values, config=config, **bits):
        return sort_twiddled_reference(planes, values, **bits)
    n = planes[0].shape[0]
    pad = (-n) % 128
    key = torch.nn.functional.pad(planes[0], (0, pad), value=-1)
    out = sort_tiles([key[None, :]] + [v[None, :] for v in values])
    return (out[0][0, :n],), tuple(o[0, :n] for o in out[1:])
