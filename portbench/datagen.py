"""Key and value generators, made with torch on any device from a seed.

The rules are those of the MSB sort's test generator
(``msb/tests/data_gen.h``): uniform bit patterns (``:34-42``); entropy
reduced by ANDing ``level`` uniform draws, so each bit is set with
probability 2^-level and level 0 gives all zeros (``:44-76``); values
0..n-1, so a pair sort is checked in O(n) (``:79-85``).  Zipf keys follow
``tpusort_torch/utils/datagen.py:zipf_keys_torch`` (the same CDF and
spread constants).  A traffic file names a rule and its parameters
(:func:`make_keys`).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_INT32_MIN = -(1 << 31)
# bit-pattern dtypes of 32 and 64 bits, by the names the configs use
DTYPES = {name: getattr(torch, name) for name in
          ("uint32", "int32", "float32", "uint64", "int64", "float64")}


def generator(device: torch.device, seed: int, *stream: int) -> torch.Generator:
    """A torch generator on ``device`` for one stream of a run: the
    64-bit state is drawn from ``seed`` and the stream's numbers, so every
    pool input can be made again on its own."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), *stream])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0]))
    return gen


def uniform_words(gen: torch.Generator, words: int) -> torch.Tensor:
    """``words`` uniform 32-bit patterns as int32."""
    return torch.randint(_INT32_MIN, 1 << 31, (words,), dtype=torch.int32,
                         device=gen.device, generator=gen)


def entropy_and_words(gen: torch.Generator, words: int,
                      level: int) -> torch.Tensor:
    """The AND of ``level`` uniform draws, as int32: level 0 is all zeros,
    level 1 uniform, and level k sets each bit with probability 2^-k."""
    if level < 0:
        raise ValueError(f"entropy level must be >= 0, got {level}")
    out = torch.zeros(words, dtype=torch.int32, device=gen.device)
    if level:
        out = uniform_words(gen, words)
        for _ in range(level - 1):
            out &= uniform_words(gen, words)
    return out


def zipf_words(gen: torch.Generator, n: int, wide: bool, *,
               alpha: float = 1.1, universe: int = 1 << 20) -> torch.Tensor:
    """Zipfian keys over ``universe`` values (rank i drawn with weight
    (i + 1)^-alpha), spread over the key space by a multiplicative hash:
    n int32 words, or 2n for 64-bit keys (``wide``)."""
    dev = gen.device
    w = torch.arange(1, universe + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(w ** -alpha, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, dtype=torch.float32, device=dev, generator=gen)
    idx = torch.searchsorted(cdf, u.to(torch.float64))
    if wide:
        return (idx * (0x9E3779B97F4A7C15 - (1 << 64))).view(torch.int32)
    x = (idx * 2654435761) & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32)


def make_keys(rule: Mapping, gen: torch.Generator, n: int,
              dtype: torch.dtype) -> torch.Tensor:
    """``n`` keys of ``dtype`` by one traffic rule:
    ``{"rule": "uniform"}``, ``{"rule": "entropy_and", "level": k}`` or
    ``{"rule": "zipf", "alpha": a, "universe": u}``."""
    per = torch.empty((), dtype=dtype).element_size() // 4
    kind = rule["rule"]
    if kind == "uniform":
        words = uniform_words(gen, n * per)
    elif kind == "entropy_and":
        words = entropy_and_words(gen, n * per, int(rule["level"]))
    elif kind == "zipf":
        words = zipf_words(gen, n, per == 2,
                           alpha=float(rule.get("alpha", 1.1)),
                           universe=int(rule.get("universe", 1 << 20)))
    else:
        raise ValueError(f"unknown key rule {kind!r}")
    return words.view(dtype)


def enumerated_values(n: int, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    """Values 0..n-1 in ``dtype`` (32 or 64 bits)."""
    wide = torch.empty((), dtype=dtype).element_size() == 8
    return torch.arange(n, dtype=torch.int64 if wide else torch.int32,
                        device=device).view(dtype)
