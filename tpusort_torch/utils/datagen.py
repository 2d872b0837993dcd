"""Test and benchmark inputs, made with numpy from a seeded generator.

Port of ``tpusort/utils/datagen.py``.  JAX and PyTorch random streams differ,
so inputs are made with numpy and the same arrays are handed to both
packages.
"""

from __future__ import annotations

import numpy as np

__all__ = ["random_keys", "entropy_keys", "enumerated_values"]

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
