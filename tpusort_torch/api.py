"""Public sort API of the PyTorch port.

Port of ``tpusort/api.py``: ``sort`` and its key-only and pair wrappers,
``argsort``, ``sort_planes`` and ``sort_pairs_lsb_in_value``, for 1-D
uint32/int32/float32 and uint64/int64/float64 keys with optional 32- or
64-bit payloads, over the whole key or a ``begin_bit``/``end_bit`` range,
on a CUDA device (the hand-written kernels) or on the CPU (their plain
PyTorch versions).  Outputs lie on the input's device.

64-bit keys and values are split into (hi, lo) int32 planes with views on
the device (``dtypes.split64``) and joined back the same way: the same
words the JAX package's numpy host boundary makes, without the round trip.
The host tiering of the JAX API (ROADMAP Queue 1 item 7) is not ported, so
every call runs the engine directly, as under ``jit``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from tpusort_torch import configs as _configs
from tpusort_torch import dtypes as _dtypes
from tpusort_torch.ops.msd import sort_twiddled_msd

__all__ = [
    "sort",
    "argsort",
    "sort_keys",
    "sort_keys_descending",
    "sort_pairs",
    "sort_pairs_descending",
    "sort_pairs_lsb_in_value",
    "sort_planes",
    "unstable_sort_keys",
    "unstable_sort_pairs",
]


def _normalize_values(values) -> Tuple[Tuple[torch.Tensor, ...], bool, bool]:
    """Returns (value_tuple, had_values, was_single)."""
    if values is None:
        return (), False, False
    if isinstance(values, (tuple, list)):
        return tuple(values), True, False
    return (values,), True, True


def _value_words(vt: Sequence[torch.Tensor], n: int, device: torch.device
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
            words += _dtypes.split64(v)
            spec.append(("v64", v.dtype))
        elif v.element_size() == 4:
            words.append(v.view(torch.int32))
            spec.append(("v32", v.dtype))
        else:
            raise TypeError(f"values must be 32- or 64-bit, got {v.dtype}")
    return words, spec


def _join_values(words: Sequence[torch.Tensor],
                 spec: Sequence[Tuple[str, torch.dtype]]) -> List[torch.Tensor]:
    out, it = [], iter(words)
    for kind, dtype in spec:
        if kind == "v64":
            hi, lo = next(it), next(it)
            out.append(_dtypes.join64(hi, lo, dtype))
        else:
            out.append(next(it).view(dtype))
    return out


def _sort_twiddled(planes, traits, vt, *, begin_bit, end_bit, stable,
                   device):
    """Check the bit range, pick the config and run the engine on
    twiddled planes; returns (sorted planes, sorted values)."""
    eb = traits.bits if end_bit is None else end_bit
    if not 0 <= begin_bit < eb <= traits.bits:
        raise ValueError(
            f"invalid bit range [{begin_bit}, {eb}) for {traits.name}")
    n = planes[0].shape[0]
    words, spec = _value_words(vt, n, device)
    cfg = _configs.get_config(traits.bits, bool(vt), device.type)
    if cfg.default_algorithm != "msd":
        raise NotImplementedError(
            f"engine {cfg.default_algorithm!r} is not ported; only 'msd' is")
    sp, sw = sort_twiddled_msd(planes, words, begin_bit=begin_bit, end_bit=eb,
                               total_bits=traits.bits, config=cfg,
                               stable=stable)
    return sp, _join_values(sw, spec)


def sort(
    keys: torch.Tensor,
    values=None,
    *,
    descending: bool = False,
    begin_bit: int = 0,
    end_bit: Optional[int] = None,
    stable: bool = True,
):
    """Radix sort of a 1-D tensor of uint32/int32/float32 or
    uint64/int64/float64 keys, ascending or ``descending``, by the keys'
    bit patterns (NaN payloads, -0.0 and +0.0 keep their bits and sort by
    them), optionally carrying ``values``: one tensor or a tuple of
    tensors of the keys' length.  With ``begin_bit``/``end_bit`` only bits
    [begin_bit, end_bit) of the twiddled key order it (``descending``
    complements the bits first); the keys come back whole.  Stable by
    default (keys equal in those bits keep their input order, payloads
    too, ascending or descending); ``stable=False`` lets equal keys reorder
    their payloads.  Keys-only output does not depend on ``stable``.
    Returns the sorted keys, or ``(keys, values)`` when values are
    given."""
    if not isinstance(keys, torch.Tensor):
        raise TypeError("keys must be a torch.Tensor")
    if keys.dim() != 1:
        raise NotImplementedError("tpusort_torch sorts 1-D tensors")
    vt, had, single = _normalize_values(values)
    planes, traits = _dtypes.twiddle_in(keys.contiguous(),
                                        descending=descending)
    sp, sv = _sort_twiddled(planes, traits, vt, begin_bit=begin_bit,
                            end_bit=end_bit, stable=stable,
                            device=keys.device)
    out = _dtypes.twiddle_out(sp, traits, descending=descending)
    if not had:
        return out
    return out, (sv[0] if single else tuple(sv))


def sort_planes(
    planes,
    values=None,
    *,
    key_dtype: str = "uint64",
    descending: bool = False,
    begin_bit: int = 0,
    end_bit: Optional[int] = None,
    stable: bool = True,
):
    """Sort keys given as 32-bit bit-pattern planes (plane 0 the most
    significant word): two planes for a 64-bit ``key_dtype``, one for a
    32-bit one.  ``key_dtype`` names the logical key type and selects the
    order-preserving twiddle.  Returns the sorted planes as uint32 tensors
    (and the values, if given)."""
    traits = _dtypes.traits_for(getattr(torch, key_dtype, None))
    planes = tuple(planes)
    if len(planes) != traits.planes:
        raise ValueError(f"{traits.name} expects {traits.planes} 32-bit "
                         f"plane(s), got {len(planes)}")
    if any(p.element_size() != 4 or p.dim() != 1 or p.shape != planes[0].shape
           or p.device != planes[0].device for p in planes):
        raise ValueError("planes must be 1-D 32-bit tensors of one length "
                         "on one device")
    vt, had, single = _normalize_values(values)
    tw = _dtypes.twiddle_planes_in(
        tuple(p.contiguous().view(torch.int32) for p in planes), traits,
        descending=descending)
    sp, sv = _sort_twiddled(tw, traits, vt, begin_bit=begin_bit,
                            end_bit=end_bit, stable=stable,
                            device=planes[0].device)
    out = tuple(p.view(torch.uint32) for p in
                _dtypes.twiddle_planes_out(sp, traits, descending=descending))
    if not had:
        return out
    return out, (sv[0] if single else tuple(sv))


def argsort(
    keys: torch.Tensor,
    *,
    descending: bool = False,
    begin_bit: int = 0,
    end_bit: Optional[int] = None,
) -> torch.Tensor:
    """Indices (int64) that stably sort ``keys``.

    Full-range 32-bit keys sort the composite (twiddled key, index) planes
    keys-only: the index plane is both the stable tiebreak and the output.
    Other keys (64-bit, or a ``begin_bit``/``end_bit`` range) take the
    stable pairs path with the index as payload."""
    if not isinstance(keys, torch.Tensor) or keys.dim() != 1:
        raise NotImplementedError("tpusort_torch sorts 1-D tensors")
    n = keys.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=keys.device)
    traits = _dtypes.traits_for(keys.dtype)
    eb = traits.bits if end_bit is None else end_bit
    if begin_bit == 0 and eb == traits.bits == 32:
        (tw,), _ = _dtypes.twiddle_in(keys.contiguous(),
                                      descending=descending)
        _, perm = sort_planes((tw, idx), key_dtype="uint64", stable=False)
    else:
        _, perm = sort(keys, idx, descending=descending, begin_bit=begin_bit,
                       end_bit=end_bit)
    return perm.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def sort_keys(keys, **kw):
    return sort(keys, **kw)


def sort_keys_descending(keys, **kw):
    return sort(keys, descending=True, **kw)


def sort_pairs(keys, values, **kw):
    return sort(keys, values, **kw)


def sort_pairs_descending(keys, values, **kw):
    return sort(keys, values, descending=True, **kw)


def unstable_sort_keys(keys, **kw):
    return sort(keys, stable=False, **kw)


def unstable_sort_pairs(keys, values, **kw):
    return sort(keys, values, stable=False, **kw)


def sort_pairs_lsb_in_value(keys: torch.Tensor, values: torch.Tensor,
                            num_lsb_bytes: int = 4, *,
                            descending: bool = False):
    """Unstable pair sort of 32-bit ``keys`` by the composite key (key,
    low ``num_lsb_bytes`` bytes of the 32-bit value), ascending or
    ``descending``.  The masked value bytes ride as the second key plane of
    the raw 2-plane path, and the whole value as the payload (port of
    ``tpusort.api.sort_pairs_lsb_in_value``).  Returns (keys, values)."""
    if not 1 <= num_lsb_bytes <= 4:
        raise ValueError("num_lsb_bytes must be in 1..4")
    if not isinstance(values, torch.Tensor) or values.element_size() != 4:
        raise ValueError("values must be a 32-bit dtype")
    if not isinstance(keys, torch.Tensor) or keys.dim() != 1:
        raise NotImplementedError("tpusort_torch sorts 1-D tensors")
    if _dtypes.traits_for(keys.dtype).planes != 1:
        raise NotImplementedError(
            "lsb-in-value needs a free plane slot: 32-bit key dtypes only")
    (plane,), traits = _dtypes.twiddle_in(keys.contiguous())
    (v,), _ = _value_words((values,), keys.shape[0], keys.device)
    mask = (1 << (8 * num_lsb_bytes)) - 1
    comp = (plane, v & (mask - (1 << 32) if mask >= 1 << 31 else mask))
    if descending:
        comp = tuple(~p for p in comp)
    cfg = _configs.get_config(64, True, keys.device.type)
    sp, (sv,) = sort_twiddled_msd(comp, (v,), begin_bit=0, end_bit=64,
                                  total_bits=64, config=cfg, stable=False)
    k_plane = ~sp[0] if descending else sp[0]
    return _dtypes.twiddle_out((k_plane,), traits), sv.view(values.dtype)
