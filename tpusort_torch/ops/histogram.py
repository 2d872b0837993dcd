"""Histogram ops.

PyTorch port of ``tpusort/ops/histogram.py``: ``histogram_even`` with exact
rational bin edges computed on the host, and ``digit_histogram``, whose
global form goes through K6 (``kernels.scanhist.digit_histogram_tiles``:
the hand-written kernel on a CUDA tensor, its plain version on a CPU
tensor); the per-tile forms stay plain PyTorch.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional

import numpy as np
import torch

from tpusort_torch.dtypes import INT32_MIN
from tpusort_torch.kernels.scanhist import (
    MAX_DIGIT_BITS, digit_histogram_tiles, digit_of)

__all__ = ["histogram_even", "digit_histogram"]

_NUMPY_DTYPES = {
    torch.uint8: np.uint8, torch.int8: np.int8, torch.int16: np.int16,
    torch.int32: np.int32, torch.uint32: np.uint32, torch.int64: np.int64,
    torch.float32: np.float32, torch.float64: np.float64,
}


def histogram_even(x: torch.Tensor, num_bins: int, lo, hi, *,
                   dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Counts of x in num_bins equal-width bins spanning [lo, hi).

    ``lo``/``hi`` are host scalars.  Bin edges are computed on the host
    with exact rational arithmetic and compared directly against ``x``,
    never through a float divide, so boundary values bin exactly even for
    full-range 32-bit inputs (a float32 ``(x - lo) / width`` misbins keys
    above 2^24).
    """
    if num_bins <= 0:
        raise ValueError("num_bins must be positive")
    if x.dtype not in _NUMPY_DTYPES:
        raise TypeError(f"histogram_even does not take {x.dtype}")
    xdt = np.dtype(_NUMPY_DTYPES[x.dtype])
    span = Fraction(hi) - Fraction(lo)
    is_int = np.issubdtype(xdt, np.integer)
    info = np.iinfo(xdt) if is_int else np.finfo(np.float32)

    def _edge(j: int):
        """Smallest representable value of x's dtype inside bin j (the
        exact edge lo + j*span/num_bins, rounded up to the dtype grid)."""
        e = Fraction(lo) + Fraction(j) * span / num_bins
        if is_int:
            v = -((-e.numerator) // e.denominator)  # ceil
            return int(np.clip(v, int(info.min), int(info.max) + 1))
        t = np.float32(float(e))
        if Fraction(float(t)) < e:
            t = np.nextafter(t, np.float32(np.inf), dtype=np.float32)
        return t

    # uint32 has no comparisons on every device: flip the sign bit, which
    # maps unsigned order onto int32 order, and move the edges alike
    bias = 0
    if x.dtype == torch.uint32:
        x, bias = x.view(torch.int32) ^ INT32_MIN, 1 << 31

    # count_ge[j] = #(x >= edge_j); bin j's count = count_ge[j] -
    # count_ge[j+1], with x < hi enforced by the exact top edge (x < hi is
    # equivalent to x < edge(num_bins) on the dtype grid).
    edges = [_edge(j) for j in range(num_bins + 1)]
    if is_int and Fraction(hi) > int(info.max):
        in_hi = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    else:
        in_hi = x < (edges[num_bins] - bias if is_int
                     else float(edges[num_bins]))
    ge = []
    for e in edges:
        if is_int and e > int(info.max):
            ge.append(torch.zeros((), dtype=dtype, device=x.device))
        else:
            cmp = (x >= (e - bias if is_int else float(e))) & in_hi
            ge.append(cmp.sum(dtype=dtype))
    return torch.stack([ge[j] - ge[j + 1] for j in range(num_bins)])


def digit_histogram(keys: torch.Tensor, shift: int, bits: int, *,
                    tiles: int = 1, dtype: torch.dtype = torch.int32,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Per-tile counts of the ``bits``-wide digit at ``shift``.

    keys: (N,) uint32 (or int32 bit patterns), N divisible by ``tiles``;
    returns (tiles, 2**bits).  The global form (``tiles == 1``, ``bits`` <=
    8, int32 counts) goes through K6 for a CUDA tensor, or wherever
    ``use_kernel`` is True (its plain version on a CPU tensor); False, and
    the per-tile forms, take plain PyTorch.  Any N: the TPU kernel's tile
    multiple is not part of the contract.
    """
    r = 1 << bits
    route = tiles == 1 and bits <= MAX_DIGIT_BITS and dtype == torch.int32 \
        and keys.dim() == 1
    route = route and (keys.is_cuda if use_kernel is None else use_kernel)
    if route:
        return digit_histogram_tiles(keys, shift, bits)[None, :]
    d = digit_of(keys.reshape(tiles, -1), shift, bits)
    d = d + torch.arange(tiles, dtype=torch.int32,
                         device=keys.device)[:, None] * r
    return torch.bincount(d.reshape(-1), minlength=tiles * r) \
        .reshape(tiles, r).to(dtype)
