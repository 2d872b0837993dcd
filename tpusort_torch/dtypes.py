"""Order-preserving key <-> unsigned-bits mappings ("twiddling").

PyTorch port of ``tpusort/dtypes.py``: a radix sort works on unsigned bit
patterns, so each key dtype is mapped through an order-preserving bijection
onto 32-bit unsigned words (CUB's ``Traits<T>::TwiddleIn/TwiddleOut``):

* unsigned ints  -> identity
* signed ints    -> flip the sign bit
* floats         -> flip the sign bit if positive, all bits if negative

Descending order complements the twiddled bits, so every kernel below sorts
ascending.

Each 32-bit plane is carried as a ``torch.int32`` tensor holding the bit
pattern (PyTorch's CPU ``uint32`` lacks shifts, comparisons and ``where``).
Code that needs the unsigned order compares planes widened to int64
(``x.to(torch.int64) & 0xFFFFFFFF``) or with the sign bit flipped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

__all__ = [
    "KeyTraits",
    "traits_for",
    "key_bits",
    "twiddle_in",
    "twiddle_out",
    "SUPPORTED_KEY_DTYPES",
]

INT32_MIN = -(1 << 31)       # the bit pattern 0x80000000 as an int32


@dataclass(frozen=True)
class KeyTraits:
    """Static per-dtype information used by the sort engines."""

    name: str
    bits: int                 # total key bits (32 or 64)
    planes: int               # number of 32-bit planes (1 or 2)
    is_float: bool
    is_signed: bool


_TRAITS = {
    torch.uint32: KeyTraits("uint32", 32, 1, False, False),
    torch.int32: KeyTraits("int32", 32, 1, False, True),
    torch.float32: KeyTraits("float32", 32, 1, True, True),
    torch.uint64: KeyTraits("uint64", 64, 2, False, False),
    torch.int64: KeyTraits("int64", 64, 2, False, True),
    torch.float64: KeyTraits("float64", 64, 2, True, True),
}
_DTYPE_OF = {t.name: d for d, t in _TRAITS.items()}

SUPPORTED_KEY_DTYPES = tuple(t.name for t in _TRAITS.values())


def traits_for(dtype: torch.dtype) -> KeyTraits:
    if dtype not in _TRAITS:
        raise TypeError(
            f"unsupported key dtype {dtype}; supported: {SUPPORTED_KEY_DTYPES}"
        )
    return _TRAITS[dtype]


def key_bits(dtype: torch.dtype) -> int:
    return traits_for(dtype).bits


def _twiddle32_in(u: torch.Tensor, traits: KeyTraits) -> torch.Tensor:
    """Map an int32 bit-pattern plane to its order-preserving image."""
    if traits.is_float:
        # negative (sign bit set): flip all bits; else flip the sign bit
        return u ^ ((u >> 31) | INT32_MIN)
    if traits.is_signed:
        return u ^ INT32_MIN
    return u


def _twiddle32_out(t: torch.Tensor, traits: KeyTraits) -> torch.Tensor:
    if traits.is_float:
        # after twiddle-in, originally negative keys have the sign bit clear
        return t ^ (~(t >> 31) | INT32_MIN)
    if traits.is_signed:
        return t ^ INT32_MIN
    return t


def _require_32bit(traits: KeyTraits) -> None:
    if traits.planes != 1:
        raise NotImplementedError(
            f"{traits.name} keys are not ported yet (ROADMAP Queue 1 item 4: "
            "64-bit keys as two planes)"
        )


def twiddle_in(
    keys: torch.Tensor, *, descending: bool = False
) -> Tuple[Tuple[torch.Tensor, ...], KeyTraits]:
    """Map keys to int32 bit-pattern plane(s) whose ascending *unsigned*
    order equals the requested key order.  Returns ``((plane,), traits)``;
    the bits are preserved exactly (NaN payloads, -0.0 and +0.0)."""
    traits = traits_for(keys.dtype)
    _require_32bit(traits)
    t = _twiddle32_in(keys.view(torch.int32), traits)
    return ((~t,) if descending else (t,)), traits


def twiddle_out(
    planes: Tuple[torch.Tensor, ...],
    traits: KeyTraits,
    *,
    descending: bool = False,
) -> torch.Tensor:
    """Inverse of :func:`twiddle_in`; returns keys of ``traits``' dtype."""
    _require_32bit(traits)
    (t,) = planes
    if descending:
        t = ~t
    return _twiddle32_out(t, traits).view(_DTYPE_OF[traits.name])
