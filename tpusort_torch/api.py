"""Public sort API of the PyTorch port.

Port of ``tpusort/api.py:sort`` and its keys-only wrappers, for 1-D
uint32/int32/float32 tensors on a CUDA device (the hand-written kernels) or
on the CPU (their plain PyTorch versions).  The output lies on the input's
device.  Keys-only output is the same for stable and unstable sorts.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpusort_torch import configs as _configs
from tpusort_torch import dtypes as _dtypes
from tpusort_torch.ops.msd import sort_twiddled_msd


def sort(
    keys: torch.Tensor,
    values=None,
    *,
    descending: bool = False,
    begin_bit: int = 0,
    end_bit: Optional[int] = None,
    stable: bool = True,
) -> torch.Tensor:
    """Radix sort of a 1-D uint32/int32/float32 tensor, ascending or
    ``descending``, by the keys' bit patterns (NaN payloads, -0.0 and +0.0
    keep their bits and sort by them).  ``stable`` is accepted for API
    parity: keys-only output does not depend on it."""
    if values is not None:
        raise NotImplementedError(
            "values (key-value sorts) are not ported yet: ROADMAP Queue 1 "
            "item 4")
    if not isinstance(keys, torch.Tensor):
        raise TypeError("keys must be a torch.Tensor")
    if keys.dim() != 1:
        raise NotImplementedError("tpusort_torch sorts 1-D tensors")
    traits = _dtypes.traits_for(keys.dtype)
    if traits.bits != 32:
        raise NotImplementedError(
            f"{traits.name} keys are not ported yet: ROADMAP Queue 1 item 4")
    eb = traits.bits if end_bit is None else end_bit
    if not 0 <= begin_bit < eb <= traits.bits:
        raise ValueError(
            f"invalid bit range [{begin_bit}, {eb}) for {traits.name}")
    if begin_bit != 0 or eb != traits.bits:
        raise NotImplementedError(
            "begin_bit/end_bit sub-range sorts are not ported yet: ROADMAP "
            "Queue 1 item 5")
    cfg = _configs.get_config(traits.bits, False, keys.device.type)
    if cfg.default_algorithm != "msd":
        raise NotImplementedError(
            f"engine {cfg.default_algorithm!r} is not ported; only 'msd' is")
    planes, traits = _dtypes.twiddle_in(keys.contiguous(),
                                        descending=descending)
    out = sort_twiddled_msd(planes, begin_bit=0, end_bit=32, total_bits=32,
                            config=cfg)
    return _dtypes.twiddle_out(out, traits, descending=descending)


def sort_keys(keys, **kw):
    return sort(keys, **kw)


def sort_keys_descending(keys, **kw):
    return sort(keys, descending=True, **kw)


def unstable_sort_keys(keys, **kw):
    return sort(keys, stable=False, **kw)
