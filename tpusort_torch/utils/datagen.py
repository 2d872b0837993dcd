"""Test and benchmark inputs, made with numpy from a seeded generator.

Port of ``tpusort/utils/datagen.py``.  JAX and PyTorch random streams differ,
so inputs are made with numpy and the same arrays are handed to both
packages.
"""

from __future__ import annotations

import numpy as np

__all__ = ["random_keys", "entropy_keys"]

_DTYPES = (np.dtype(np.uint32), np.dtype(np.int32), np.dtype(np.float32))


def _check(dtype) -> np.dtype:
    dtype = np.dtype(dtype)
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype}")
    return dtype


def random_keys(rng: np.random.Generator, n: int, dtype=np.uint32) -> np.ndarray:
    """Uniform random keys: uniform bit patterns for integers, uniform in
    [0, 1) for float32."""
    dtype = _check(dtype)
    if dtype == np.float32:
        return rng.random(n, dtype=np.float32)
    return rng.integers(0, 1 << 32, n, dtype=np.uint32).view(dtype)


def entropy_keys(rng: np.random.Generator, n: int, entropy_level: int,
                 dtype=np.uint32) -> np.ndarray:
    """AND of ``entropy_level`` uniform bit draws; level 0 gives all zeros.
    Higher levels bias bits toward 0 (heavy duplication); level 1 is
    uniform.  Floats get the bit pattern."""
    dtype = _check(dtype)
    out = np.zeros(n, dtype=np.uint32)
    if entropy_level:
        out = ~out
        for _ in range(entropy_level):
            out &= rng.integers(0, 1 << 32, n, dtype=np.uint32)
    return out.view(dtype)
