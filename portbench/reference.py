"""The plain reference: a stable sort in plain PyTorch, the controls, and
the comparison that decides ``correct``.

Keys order by their bit patterns as ``tpusort_torch`` documents it:
unsigned and signed integers by value, floats by the IEEE total order of
their bits (-0.0 before +0.0, NaNs by sign and payload beyond the
infinities).  :func:`order_key` maps each dtype onto int64 with that
order, and ``torch.sort(stable=True)`` does the rest.  Nothing here
imports the program.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

_I32_LOW = 0x7FFFFFFF
_I64_MIN = -(1 << 63)
_I64_LOW = (1 << 63) - 1


def order_key(keys: torch.Tensor) -> torch.Tensor:
    """int64 keys whose signed order is the sort order of ``keys``, for
    the 32- and 64-bit integer and float dtypes (64-bit unsigned keys as
    their bits with the top bit flipped)."""
    dt = keys.dtype
    if dt == torch.uint32:
        return keys.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if dt == torch.int32:
        return keys.to(torch.int64)
    if dt == torch.float32:
        b = keys.view(torch.int32)
        return (b ^ ((b >> 31) & _I32_LOW)).to(torch.int64)
    if dt == torch.uint64:
        return keys.view(torch.int64) ^ _I64_MIN
    if dt == torch.int64:
        return keys.clone()
    if dt == torch.float64:
        b = keys.view(torch.int64)
        return b ^ ((b >> 63) & _I64_LOW)
    raise TypeError(f"no reference order for {dt}")


def _as_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def _take(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t[index]`` through the signed view (no CUDA indexing of unsigned
    dtypes)."""
    return _as_bits(t)[index].view(t.dtype)


def _sort_by(order: torch.Tensor, keys: torch.Tensor,
             values: Optional[torch.Tensor]):
    _, perm = torch.sort(order, stable=True)
    out = _take(keys, perm)
    return out if values is None else (out, _take(values, perm))


def stable_sort(keys: torch.Tensor, values: Optional[torch.Tensor] = None):
    """Keys ascending, equal keys in input order; with ``values``,
    (keys, values) permuted alike."""
    return _sort_by(order_key(keys), keys, values)


def control_low_bit(keys: torch.Tensor, values: Optional[torch.Tensor] = None):
    """The control for the order guarantee: the reference sorting by every
    bit of the key but the lowest, one bit below the configuration's key
    width (as a radix sort that dropped a digit bit would)."""
    return _sort_by(order_key(keys) >> 1, keys, values)


def control_reversed_ties(keys: torch.Tensor, values: torch.Tensor):
    """The control for the stability guarantee: the reference with equal
    keys' values in reverse input order."""
    def flip(t):
        return _as_bits(t).flip(0).view(t.dtype)

    return stable_sort(flip(keys), flip(values))


def mismatches(got, want: torch.Tensor) -> int:
    """Positions at which ``got`` differs from ``want`` bit for bit; all of
    them where ``got`` is no tensor of ``want``'s dtype and shape."""
    if not isinstance(got, torch.Tensor) or got.dtype != want.dtype \
            or got.shape != want.shape or got.device != want.device:
        return want.numel()
    return int((_as_bits(got) != _as_bits(want)).sum())


def compare(out, keys: torch.Tensor, values: Optional[torch.Tensor],
            stable: bool) -> Dict[str, int]:
    """The numbers compared for one output of the program on (keys,
    values): ``key_mismatches`` against the reference's keys; for pairs
    ``value_mismatches`` against its stable values (``stable``), or,
    unstable, against its values put in order within each run of equal
    keys, on both sides."""
    if values is None:
        return {"key_mismatches": mismatches(out, stable_sort(keys))}
    got_k, got_v = out if isinstance(out, tuple) and len(out) == 2 \
        else (None, None)
    want_k, want_v = stable_sort(keys, values)
    res = {"key_mismatches": mismatches(got_k, want_k)}
    if not stable and mismatches(got_v, want_v) and \
            isinstance(got_v, torch.Tensor) and got_v.shape == want_v.shape:
        got_v = _values_by_pair(want_k, got_v)
        want_v = _values_by_pair(want_k, want_v)
    res["value_mismatches"] = mismatches(got_v, want_v)
    return res


def _values_by_pair(sorted_keys: torch.Tensor, v: torch.Tensor):
    """``v`` put in order within each run of equal ``sorted_keys``: sorted
    by value, then stably by key."""
    _, p = torch.sort(order_key(v), stable=True)
    _, q = torch.sort(order_key(sorted_keys)[p], stable=True)
    return _take(v, p[q])
