"""Order-preserving key <-> unsigned-bits mappings ("twiddling").

PyTorch port of ``tpusort/dtypes.py``: a radix sort works on unsigned bit
patterns, so each key dtype is mapped through an order-preserving bijection
onto 32-bit unsigned words (CUB's ``Traits<T>::TwiddleIn/TwiddleOut``):

* unsigned ints  -> identity
* signed ints    -> flip the sign bit
* floats         -> flip the sign bit if positive, all bits if negative

Descending order complements the twiddled bits, so every kernel below sorts
ascending.

A 64-bit key becomes two planes, (hi, lo), plane 0 the most significant
word, compared lexicographically; a 64-bit value becomes two words alike.
The split makes each word a contiguous copy, and the join stacks the two
back: plain PyTorch copies on the device, inside the host spans
``tpusort.planes.split`` and ``tpusort.planes.join``.  Each copy's
elements read and written, from the tensors' sizes, are counted in
``split_join_bytes`` (``ops.msd.counters()``): 16 bytes a key for each
split and each join of a 64-bit operand.  No span or count is made where
no 64-bit operand is.  Each 32-bit plane is carried as a ``torch.int32``
tensor holding the bit pattern (PyTorch's CPU ``uint32`` lacks shifts,
comparisons and ``where``).
Code that needs the unsigned order compares planes widened to int64
(``x.to(torch.int64) & 0xFFFFFFFF``) or with the sign bit flipped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from tpusort_torch.utils.log import count, span

__all__ = [
    "KeyTraits",
    "traits_for",
    "key_bits",
    "twiddle_in",
    "twiddle_out",
    "twiddle_planes_in",
    "twiddle_planes_out",
    "split64",
    "join64",
    "value_words",
    "join_values",
    "SUPPORTED_KEY_DTYPES",
]

INT32_MIN = -(1 << 31)       # the bit pattern 0x80000000 as an int32
SPLIT = "tpusort.planes.split"
JOIN = "tpusort.planes.join"


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


def split64(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) int32 bit-pattern planes of a 1-D 64-bit tensor, as two
    contiguous copies of the strided words of its int32 view: the same
    words as ``tpusort.dtypes.split64_host``, without a trip through the
    host (little-endian: word 1 of each element is hi)."""
    if keys.element_size() != 8:
        raise ValueError(f"split64 expects a 64-bit dtype, got {keys.dtype}")
    if keys.numel() == 0:         # an empty tensor's stride may not view
        empty = torch.empty(0, dtype=torch.int32, device=keys.device)
        return empty, empty.clone()
    words = keys.contiguous().view(torch.int32).reshape(-1, 2)
    with span(SPLIT):
        hi, lo = words[:, 1].contiguous(), words[:, 0].contiguous()
    # two strided copies, each reading its words and writing them
    count("split_join_bytes", 2 * (hi.nbytes + lo.nbytes))
    return hi, lo


def join64(hi: torch.Tensor, lo: torch.Tensor,
           dtype: torch.dtype = torch.uint64) -> torch.Tensor:
    """Inverse of :func:`split64`: a 1-D tensor of the 64-bit ``dtype``."""
    with span(JOIN):
        out = torch.stack((lo.view(torch.int32), hi.view(torch.int32)),
                          dim=1)
    # one stack, reading both words and writing them interleaved
    count("split_join_bytes", 2 * out.nbytes)
    return out.view(torch.int64).reshape(-1).view(dtype)


def twiddle_planes_in(
    planes: Tuple[torch.Tensor, ...], traits: KeyTraits, *,
    descending: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Twiddle raw int32 bit-pattern plane(s) of a key (plane 0 = most
    significant word) into planes whose unsigned lexicographic order is the
    requested key order."""
    if traits.planes == 1:
        (u,) = planes
        t = _twiddle32_in(u.view(torch.int32), traits)
        return (~t,) if descending else (t,)
    hi, lo = (p.view(torch.int32) for p in planes)
    if traits.is_float:
        # negative (hi sign bit set): flip every bit; else the sign bit
        sign = hi >> 31
        hi, lo = hi ^ (sign | INT32_MIN), lo ^ sign
    elif traits.is_signed:
        hi = hi ^ INT32_MIN
    if descending:
        hi, lo = ~hi, ~lo
    return (hi, lo)


def twiddle_planes_out(
    planes: Tuple[torch.Tensor, ...], traits: KeyTraits, *,
    descending: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Inverse of :func:`twiddle_planes_in` (returns raw int32 planes)."""
    if traits.planes == 1:
        (t,) = planes
        if descending:
            t = ~t
        return (_twiddle32_out(t, traits),)
    hi, lo = planes
    if descending:
        hi, lo = ~hi, ~lo
    if traits.is_float:
        # originally negative keys have the hi sign bit clear by now
        keep = ~(hi >> 31)
        hi, lo = hi ^ (keep | INT32_MIN), lo ^ keep
    elif traits.is_signed:
        hi = hi ^ INT32_MIN
    return (hi, lo)


def twiddle_in(
    keys: torch.Tensor, *, descending: bool = False
) -> Tuple[Tuple[torch.Tensor, ...], KeyTraits]:
    """Map keys to int32 bit-pattern plane(s) whose ascending *unsigned*
    lexicographic order equals the requested key order.  Returns
    ``((plane,) | (hi, lo), traits)``; the bits are preserved exactly (NaN
    payloads, -0.0 and +0.0)."""
    traits = traits_for(keys.dtype)
    raw = (keys.view(torch.int32),) if traits.planes == 1 else split64(keys)
    return twiddle_planes_in(raw, traits, descending=descending), traits


def twiddle_out(
    planes: Tuple[torch.Tensor, ...],
    traits: KeyTraits,
    *,
    descending: bool = False,
) -> torch.Tensor:
    """Inverse of :func:`twiddle_in`; returns keys of ``traits``' dtype."""
    raw = twiddle_planes_out(planes, traits, descending=descending)
    dtype = _DTYPE_OF[traits.name]
    if traits.planes == 1:
        return raw[0].view(dtype)
    return join64(raw[0], raw[1], dtype)


def value_words(vt: Sequence[torch.Tensor], n: int, device: torch.device
                ) -> Tuple[List[torch.Tensor], List[Tuple[str, torch.dtype]]]:
    """Payloads as int32 words: a 32-bit value is one word (a view), a
    64-bit value two (hi, lo)."""
    words, spec = [], []
    for v in vt:
        if not isinstance(v, torch.Tensor) or v.dim() != 1 or \
                v.shape[0] != n or v.device != device:
            raise ValueError("values must be 1-D tensors of the keys' length "
                             "on the keys' device")
        v = v.contiguous()
        if v.element_size() == 8:
            words += split64(v)
            spec.append(("v64", v.dtype))
        elif v.element_size() == 4:
            words.append(v.view(torch.int32))
            spec.append(("v32", v.dtype))
        else:
            raise TypeError(f"values must be 32- or 64-bit, got {v.dtype}")
    return words, spec


def join_values(words: Sequence[torch.Tensor],
                spec: Sequence[Tuple[str, torch.dtype]]) -> List[torch.Tensor]:
    out, it = [], iter(words)
    for kind, dtype in spec:
        if kind == "v64":
            hi, lo = next(it), next(it)
            out.append(join64(hi, lo, dtype))
        else:
            out.append(next(it).view(dtype))
    return out
