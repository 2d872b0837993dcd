"""Reference sort: semantically exact, the oracle and the exact fallback.

PyTorch port of ``tpusort/ops/reference.py``.  This module is the only place
the port calls ``torch.sort``: as the oracle that the kernels and the engine
are held against, and as the exact fallback the engine takes when a run
overflows its padded capacity.

Planes are int32 tensors holding unsigned bit patterns (plane 0 = the most
significant 32 bits).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from tpusort_torch.dtypes import INT32_MIN


def _mask_plane_bits(
    planes: Tuple[torch.Tensor, ...], begin_bit: int, end_bit: int,
    total_bits: int,
) -> Tuple[torch.Tensor, ...]:
    """Zero out bits outside [begin_bit, end_bit) across the plane stack."""
    if begin_bit == 0 and end_bit == total_bits:
        return planes
    out = []
    nplanes = len(planes)
    for i, p in enumerate(planes):
        plane_lo = 32 * (nplanes - 1 - i)
        lo = max(begin_bit - plane_lo, 0)
        hi = min(end_bit - plane_lo, 32)
        if hi <= lo:
            out.append(torch.zeros_like(p))
            continue
        mask = ((1 << hi) - 1) & ~((1 << lo) - 1) & 0xFFFFFFFF
        out.append(p & (mask - (1 << 32) if mask >= 1 << 31 else mask))
    return tuple(out)


def sort_twiddled_reference(
    planes: Tuple[torch.Tensor, ...],
    values: Sequence[torch.Tensor],
    *,
    begin_bit: int,
    end_bit: int,
    total_bits: int,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Stable ascending sort of twiddled int32 plane(s) + payloads, by the
    unsigned value of bits [begin_bit, end_bit).

    Lexicographic over planes by stable sorts from the least significant
    planes up, two planes a sort: (hi, lo) make one int64 word, hi with its
    sign bit flipped, so that int64 order is the pair's unsigned order."""
    masked = _mask_plane_bits(tuple(planes), begin_bit, end_bit, total_bits)
    perm = None
    for i in range(len(masked), 0, -2):
        key = masked[i - 1].to(torch.int64) & 0xFFFFFFFF
        if i >= 2:
            key |= (masked[i - 2] ^ INT32_MIN).to(torch.int64) << 32
        if perm is not None:
            key = key[perm]
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
    return (
        tuple(p[perm] for p in planes),
        tuple(v[perm] for v in values),
    )


def sort_rows_lex(
    planes: Sequence[torch.Tensor], values: Sequence[torch.Tensor] = (),
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Each row of 2-D int32 bit-pattern planes sorted by the planes'
    unsigned lexicographic value (plane 0 most significant), the value
    rows carried along: the tile sort of the kernels' plain versions.
    Stable, by stable sorts from the least significant plane up; an
    unstable kernel may order ties otherwise.  Flipping the sign bit maps
    unsigned order onto int32 order without widening."""
    if len(planes) == 1 and not values:
        return (torch.sort(planes[0] ^ INT32_MIN, dim=1).values ^ INT32_MIN,), ()
    perm = None
    for p in reversed(planes):
        key = p if perm is None else torch.gather(p, 1, perm)
        order = torch.sort(key ^ INT32_MIN, dim=1, stable=True).indices
        perm = order if perm is None else torch.gather(perm, 1, order)
    return (tuple(torch.gather(p, 1, perm) for p in planes),
            tuple(torch.gather(v, 1, perm) for v in values))
