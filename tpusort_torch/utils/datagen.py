"""Test and benchmark inputs, made with numpy from a seeded generator.

Port of ``tpusort/utils/datagen.py``.  JAX and PyTorch random streams differ,
so inputs are made with numpy and the same arrays are handed to both
packages.  :func:`zipf_keys_torch` makes the same distribution on a card,
for sizes where numpy would take seconds (the chip scripts).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["random_keys", "entropy_keys", "enumerated_values", "zipf_keys",
           "zipf_keys_torch", "segment_offsets"]

_DTYPES = tuple(np.dtype(d) for d in (np.uint32, np.int32, np.float32,
                                      np.uint64, np.int64, np.float64))


def _check(dtype) -> np.dtype:
    dtype = np.dtype(dtype)
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype}")
    return dtype


def random_keys(rng: np.random.Generator, n: int, dtype=np.uint32) -> np.ndarray:
    """Uniform random keys: uniform bit patterns for integers, uniform in
    [0, 1) for floats."""
    dtype = _check(dtype)
    if dtype.kind == "f":
        return rng.random(n, dtype=dtype)
    raw = rng.integers(0, 1 << 32, (n, dtype.itemsize // 4), dtype=np.uint32)
    return raw.reshape(-1).view(dtype)


def entropy_keys(rng: np.random.Generator, n: int, entropy_level: int,
                 dtype=np.uint32) -> np.ndarray:
    """AND of ``entropy_level`` uniform bit draws; level 0 gives all zeros.
    Higher levels bias bits toward 0 (heavy duplication); level 1 is
    uniform.  Floats get the bit pattern."""
    dtype = _check(dtype)
    words = n * (dtype.itemsize // 4)
    out = np.zeros(words, dtype=np.uint32)
    if entropy_level:
        out = ~out
        for _ in range(entropy_level):
            out &= rng.integers(0, 1 << 32, words, dtype=np.uint32)
    return out.view(dtype)


def enumerated_values(n: int, dtype=np.uint32) -> np.ndarray:
    """Values 0..n-1: with them as payloads, the sorted values are the
    permutation, so a pair sort is checked in O(n)."""
    return np.arange(n, dtype=dtype)


def segment_offsets(rng: np.random.Generator, n: int,
                    num_segments: int) -> np.ndarray:
    """(num_segments + 1,) int64 offsets of a ragged batch covering
    [0, n): the inner boundaries are uniform draws, sorted, so segment
    lengths vary about as exponentials do and some segments are empty."""
    inner = np.sort(rng.integers(0, n + 1, num_segments - 1))
    return np.concatenate([[0], inner, [n]]).astype(np.int64)


def zipf_keys(rng: np.random.Generator, n: int, *, alpha: float = 1.1,
              universe: int = 1 << 20, dtype=np.uint64) -> np.ndarray:
    """Zipfian keys over ``universe`` distinct values: value rank i (from
    0) drawn with weight (i + 1)^-alpha by inverse-CDF sampling of float32
    uniforms, then spread over the key space by a multiplicative hash, so
    heavy duplication is kept.  The CDF and the spread constants are those
    of ``tpusort/utils/datagen.py:zipf_keys``; the uniforms come from
    ``rng``."""
    dtype = _check(dtype)
    ranks = np.arange(1, universe + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** (-alpha))
    cdf /= cdf[-1]
    u = rng.random(n, dtype=np.float32).astype(np.float64)
    idx = np.searchsorted(cdf, u).astype(np.uint64)
    if dtype.itemsize == 8:
        return (idx * np.uint64(0x9E3779B97F4A7C15)).view(dtype)
    spread = (idx * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
    return spread.astype(np.uint32).view(dtype)


def zipf_keys_torch(gen: torch.Generator, n: int, *, alpha: float = 1.1,
                    universe: int = 1 << 20,
                    dtype=torch.int32) -> torch.Tensor:
    """:func:`zipf_keys` made with torch on ``gen``'s device: the same CDF
    and spread constants, float32 uniforms from ``gen``.  Returns int32
    (or, for a 64-bit ``dtype``, int64) bit patterns viewed as ``dtype``."""
    dev = gen.device
    w = torch.arange(1, universe + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(w ** -alpha, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, dtype=torch.float32, device=dev, generator=gen)
    idx = torch.searchsorted(cdf, u.to(torch.float64))
    if torch.empty(0, dtype=dtype).element_size() == 8:
        # 0x9E3779B97F4A7C15 as an int64: the product wraps mod 2^64
        return (idx * (0x9E3779B97F4A7C15 - (1 << 64))).view(dtype)
    x = (idx * 2654435761) & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32).view(dtype)
