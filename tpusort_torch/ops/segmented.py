"""Segmented (batched) sort.

PyTorch port of ``tpusort/ops/segmented.py`` (the
``DeviceSegmentedRadixSort`` analog).  Two entry points:

* :func:`sort_batched`, uniform segments: each row of (B, K) keys sorted on
  its own.  Full-range unstable sorts of 32-bit keys with K a multiple of
  128 up to 2^14 run on K3 (``kernels.bitonic.sort_tiles``, one CTA a row)
  for CUDA tensors; everything else takes the stable row sort of the
  reference module;
* :func:`segmented_sort`, ragged segments given by offsets: one sort by
  (segment, key).  Full-range sorts of 32-bit keys on CUDA tensors run the
  raw-key engine (K1 passes and the K2 leaf) once over the whole batch;
  64-bit keys and bit windows take the exact reference sort.

Bit-range sub-sorts (``begin_bit``/``end_bit``) compare only the masked key
window while the full keys ride as payload, and are stable.

Where the engine route departs from JAX's.  JAX feeds the engine the
planes (segment id << shift, key) in input order.  The engine cuts
contiguous tiles and segment ids rise with position, so every tile holds
one pass-0 digit, its run overflows, and the whole call falls back to the
exact sort; below 2^15 segments the zeros under the id do the same.  Here
the contract is the same and the mechanism differs
(:func:`_sort_on_engine`):

* the leading plane is not the segment id but each element's estimated
  place in the output, segment start + key * segment length / 2^32,
  scaled to 32 bits (:func:`_spread_plane`).  It orders elements as
  (segment, key) does, and on uniform keys it is uniform whatever the
  number, the sizes and the raggedness of the segments, so the digit runs
  fill evenly; the key itself is the second plane and comes back as it is;
* pass 0 reads strided tiles (``msd.strided_feed``): every tile mirrors
  the whole batch.  The raw path is unstable and the stable route carries a
  position plane, so the input order is free.

Keys far from uniform inside segments larger than a run (normal-variate
floats, heavy duplicates) overflow all the same.  From
``planner.PLANNER_MIN_N`` keys on, a strided sample of the leading plane
goes through the host planner's prefix-mass check first, as the API's tier
chain does, and a batch it finds doomed takes the exact sort at once
(counted in ``reference_routes``); one that overflows unforeseen takes it
after the engine (``overflow_fallbacks``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpusort_torch import dtypes as _dtypes
from tpusort_torch import planner as _planner
from tpusort_torch.configs import get_config
from tpusort_torch.kernels.bitonic import sort_tiles
from tpusort_torch.kernels.partition import MAX_VALUES
from tpusort_torch.ops import msd as _msd
from tpusort_torch.ops.reference import (
    _mask_plane_bits, sort_rows_lex, sort_twiddled_reference)
from tpusort_torch.ops.tiers import first_clear
from tpusort_torch.utils.log import host_read, spanned

__all__ = ["segmented_sort", "sort_batched"]

_MAX_TILE = 1 << 14
# the engine route's sample gate: 2^22 keys are 128 a bucket at the deepest
# level of a 15-bit plan, where the heaviest of 2^15 uniform buckets lies 4
# to 5 standard deviations over the mean; under 64 a bucket that noise
# alone would pass for skew
_GATE_SAMPLE = 1 << 22
_GATE_MIN_PER_BUCKET = 64


def _masked_planes(planes, traits, begin_bit: int, end_bit: Optional[int]):
    """(comparison planes, is_full_range): masked to [begin_bit, end_bit)
    when a proper sub-range is requested."""
    eb = traits.bits if end_bit is None else end_bit
    if not (0 <= begin_bit < eb <= traits.bits):
        raise ValueError(
            f"invalid bit range [{begin_bit}, {eb}) for {traits.name}"
        )
    if begin_bit == 0 and eb == traits.bits:
        return planes, True
    return _mask_plane_bits(tuple(planes), begin_bit, eb, traits.bits), False


def _normalize(values) -> Tuple[Tuple[torch.Tensor, ...], bool]:
    if values is None:
        return (), False
    if isinstance(values, (tuple, list)):
        return tuple(values), False
    return (values,), True


def _tile_route_ok(device_type: str, key_planes: int, full_range: bool,
                   stable: bool, k: int, vt: Sequence[torch.Tensor]) -> bool:
    """Whether :func:`sort_batched` sorts these rows on K3 (JAX's gate,
    ``tpusort/ops/segmented.py:69-82``, with the card in the TPU's place).
    JAX also wants a power-of-two K with values, because its virtual pad
    could take a payload from a genuine all-ones key; the port's K3 breaks
    ties by slot index, so a pad never does (the rule ``ops/small.py``
    settled: any multiple of 128 may carry values)."""
    return (device_type == "cuda" and key_planes == 1 and full_range
            and not stable and k > 0 and k % 128 == 0 and k <= _MAX_TILE
            and all(v.element_size() == 4 for v in vt))


@spanned("tpusort.api.sort_batched")
def sort_batched(
    keys: torch.Tensor,
    values=None,
    *,
    descending: bool = False,
    begin_bit: int = 0,
    end_bit: Optional[int] = None,
    stable: bool = False,
):
    """Sort each row of (B, K) keys independently (uniform segments), by
    the keys' bit patterns as :func:`tpusort_torch.sort` does, carrying
    ``values`` (one (B, K) tensor or a tuple of them, 32- or 64-bit).
    Unstable by default: equal keys may reorder their values.  Returns the
    sorted keys, or ``(keys, values)``."""
    if keys.dim() != 2:
        raise ValueError("sort_batched expects (B, K) keys")
    b, k = keys.shape
    planes, traits = _dtypes.twiddle_in(keys.reshape(-1),
                                        descending=descending)
    vt, single = _normalize(values)
    if any(tuple(v.shape) != (b, k) or v.device != keys.device for v in vt):
        raise ValueError("values must be (B, K) tensors on the keys' device")
    cmp_planes, full_range = _masked_planes(planes, traits, begin_bit,
                                            end_bit)
    if _tile_route_ok(keys.device.type, traits.planes, full_range, stable,
                      k, vt):
        words = [v.contiguous().view(torch.int32) for v in vt]
        out = sort_tiles([planes[0].reshape(b, k), *words])
        sorted_planes, sorted_words = (out[0].reshape(-1),), out[1:]
        spec = [("v32", v.dtype) for v in vt]
    else:
        # the exact way: the stable row sort by the comparison planes, the
        # full planes (under a bit window) and the value words carried
        words, spec = _dtypes.value_words([v.reshape(-1) for v in vt], b * k,
                                   keys.device)
        carry = [] if full_range else list(planes)
        sp, sv = sort_rows_lex([p.reshape(b, k) for p in cmp_planes],
                               [w.reshape(b, k) for w in (*carry, *words)])
        sorted_planes = tuple(p.reshape(-1) for p in
                              (sp if full_range else sv[:len(planes)]))
        sorted_words = sv[len(carry):]
    out_keys = _dtypes.twiddle_out(sorted_planes, traits,
                                   descending=descending).reshape(b, k)
    if values is None:
        return out_keys
    outs = tuple(o.reshape(b, k) for o in _dtypes.join_values(
        [w.reshape(-1) for w in sorted_words], spec))
    return out_keys, (outs[0] if single else outs)


def _checked_offsets(segment_offsets, n: int) -> np.ndarray:
    """The offsets on the host as int64, checked: a non-decreasing
    (num_segments + 1,) array covering [0, n)."""
    if isinstance(segment_offsets, torch.Tensor):
        with host_read("segment_offsets"):
            so = segment_offsets.detach().cpu().numpy()
    else:
        so = np.asarray(segment_offsets)
    if (so.ndim != 1 or so.shape[0] < 2 or so[0] != 0 or so[-1] != n
            or np.any(np.diff(so.astype(np.int64)) < 0)):
        raise ValueError(
            "segment_offsets must be a non-decreasing (num_segments+1,)"
            f" array covering [0, {n}) (got first="
            f"{so.flat[0] if so.size else '?'},"
            f" last={so.flat[-1] if so.size else '?'})"
        )
    return so.astype(np.int64)


def _spread_plane(offsets: np.ndarray, seg_id: torch.Tensor,
                  key: torch.Tensor, n: int) -> torch.Tensor:
    """The leading plane of the engine route's composite key: for each
    element (all n of the batch, or a sample of them), where in [0, n) its
    key would land if its segment's keys were
    uniform, start + ((key * length) >> 32), scaled to the 32-bit range
    (an int32 bit pattern, never all-ones).  It rises with the segment and,
    inside a segment, with the key, so sorting by (this plane, key) is
    sorting by (segment, key); and uniform keys spread it evenly over the
    range however long or ragged the segments are, which is what the
    engine's digit runs need."""
    dev = key.device
    starts = _msd.to_device(offsets[:-1], dev)
    lens = _msd.to_device(np.diff(offsets), dev)
    est = starts[seg_id] + (((key.to(torch.int64) & 0xFFFFFFFF)
                             * lens[seg_id]) >> 32)
    est = torch.div(est << 32, n, rounding_mode="floor")
    return (est - ((est >> 31) << 32)).to(torch.int32)


def _segment_ids(offsets: np.ndarray, pos: torch.Tensor) -> torch.Tensor:
    """The segment of each position, int32."""
    return torch.searchsorted(
        _msd.to_device(offsets[1:].astype(np.int32), pos.device), pos,
        right=True, out_int32=True)


def _looks_doomed(offsets: np.ndarray, key: torch.Tensor, plan) -> bool:
    """The host planner's prefix-mass check on a strided sample of the
    spread plane: whether some digit prefix of the plan holds so much of
    the batch that its runs would overflow (keys far from uniform inside
    segments larger than a run: normal-variate floats, heavy duplicates).
    The sample (up to ``_GATE_SAMPLE`` keys) is counted on the device by
    its leading digit bits, and the host reads the heaviest bucket of each
    pass's level, one number a pass, before anything of the sort is
    queued.  Levels with under ``_GATE_MIN_PER_BUCKET`` samples a bucket
    are left to the engine's flag.  A wrong guess costs time only: the
    flag still guards the output."""
    n = key.shape[0]
    pos = torch.arange(0, n, max(1, n // _GATE_SAMPLE), dtype=torch.int32,
                       device=key.device)
    m = pos.shape[0]
    levels, cumw = [], 0
    for spec in plan.passes:
        cumw += spec.width
        if cumw > 32 or m < _GATE_MIN_PER_BUCKET << cumw:
            break
        levels.append((cumw, spec))
    if not levels:
        return False
    sample = _spread_plane(offsets, _segment_ids(offsets, pos),
                           key[pos.long()], n)
    deepest = levels[-1][0]
    counts = torch.bincount(
        (sample.to(torch.int64) & 0xFFFFFFFF) >> (32 - deepest),
        minlength=1 << deepest)
    heaviest = torch.stack([counts.reshape(1 << w, -1).sum(dim=1).max()
                            for w, _ in levels])
    with host_read("segment_levels"):
        heaviest = heaviest.cpu().tolist()
    return any(_planner.prefix_mass_overflows(float(c), m, w, spec, n)
               for c, (w, spec) in zip(heaviest, levels))


def _sort_exact(seg_id: torch.Tensor, planes, cmp_planes, words,
                full_range: bool = True):
    """The exact way: the stable sort by (segment, comparison planes), the
    full planes (under a bit window) and the value words carried.
    Returns (sorted key planes, sorted words, None): an exact attempt."""
    carry = [] if full_range else list(planes)
    bits = 32 * (1 + len(cmp_planes))
    sp, sv = sort_twiddled_reference(
        (seg_id, *cmp_planes), (*carry, *words), begin_bit=0, end_bit=bits,
        total_bits=bits)
    return (sp[1:] if full_range else sv[:len(planes)]), sv[len(carry):], \
        None


def _sort_on_engine(
    offsets: np.ndarray, seg_id: torch.Tensor, key: torch.Tensor,
    words: Sequence[torch.Tensor], *, stable: bool, config=None,
) -> Tuple[Tuple[torch.Tensor], List[torch.Tensor]]:
    """The engine route of :func:`segmented_sort`: one raw-key engine run
    (K1 passes, the K2 leaf) over the (n,) twiddled key plane and value
    words of a batch with these host ``offsets`` and per-element segment
    ids, ascending by the planes (:func:`_spread_plane`, key), and by a
    position plane after them when ``stable`` and there are values.
    Returns ((sorted key plane,), sorted words).  The exact way
    (:func:`_sort_exact`) sorts instead where the sample gate says the
    runs would overflow (batches of ``planner.PLANNER_MIN_N`` keys and
    more; counted in ``reference_routes``, nothing launched), and after
    the engine where a run did overflow (``ops.tiers``, site
    ``segmented_flag``; counted in ``overflow_fallbacks``).
    ``config`` defaults to the 64-bit row of the tensors' device.

    Pass 0 reads strided tiles (in input order a tile would hold one
    stretch of one segment, so one digit).  The spread plane is never
    all-ones, so no valid key equals the invalid-slot sentinel and the
    pairs need no sentinel check.  Inputs too small for a plan go through
    ``msd.sort_twiddled_msd``, which delegates them.
    """
    n = key.shape[0]
    if config is None:
        config = get_config(64, bool(words), key.device.type)
    nplanes = 3 if stable and words else 2
    total = 32 * nplanes
    kwargs = config.plan_kwargs()
    min_n = kwargs.pop("min_n")
    plan = _msd._plan_cached(n, 0, total, "raw",
                             tuple(sorted(kwargs.items()))) \
        if n >= min_n else None

    def exact():
        return _sort_exact(seg_id, (key,), (key,), words)

    if (plan is not None and n >= _planner.PLANNER_MIN_N
            and _looks_doomed(offsets, key, plan)):
        _msd.count_route("reference_routes")
        return exact()[:2]

    def engine():
        planes = [_spread_plane(offsets, seg_id, key, n), key]
        if nplanes == 3:
            planes.append(torch.arange(n, dtype=torch.int32,
                                       device=key.device))
        if plan is None:
            sp, sv, overflow = _msd.sort_twiddled_msd(
                tuple(planes), tuple(words), begin_bit=0, end_bit=total,
                total_bits=total, config=config, stable=False)
            outs = [*sp, *sv]
        else:
            ops, ctable = _msd.strided_feed([*planes, *words], n, plan)
            del planes
            data, (ctable, q), overflow = _msd.run_passes(
                ops, nplanes, n, plan, unstable=bool(words),
                init_chain=(ctable, 128, None))
            del ops
            outs = _msd.raw_leaf(data, ctable, q, plan, nplanes, n)
        return (outs[1],), list(outs[nplanes:]), overflow

    return first_clear([engine, exact], "segmented_flag")


@spanned("tpusort.api.segmented_sort")
def segmented_sort(
    keys: torch.Tensor,
    segment_offsets,
    values=None,
    *,
    descending: bool = False,
    begin_bit: int = 0,
    end_bit: Optional[int] = None,
    stable: bool = True,
):
    """Sort within ragged segments (stable by default, CUB semantics).

    segment_offsets: (num_segments + 1,) integers (a tensor on any device,
    or a host array) of segment boundaries covering [0, n): offsets[0] ==
    0, offsets[-1] == n, non-decreasing; anything else raises ValueError
    (the check reads the offsets on the host).  ``values``: one 1-D tensor
    or a tuple of them, 32- or 64-bit.

    ``begin_bit``/``end_bit`` compare only that key-bit window;
    ``stable=False`` lets equal keys of a segment reorder their values.
    Returns the sorted keys, or ``(keys, values)``.
    """
    if keys.dim() != 1:
        raise ValueError("segmented_sort expects 1-D keys")
    n = keys.shape[0]
    dev = keys.device
    offsets = _checked_offsets(segment_offsets, n)
    planes, traits = _dtypes.twiddle_in(keys.contiguous(),
                                        descending=descending)
    vt, single = _normalize(values)
    words, spec = _dtypes.value_words(vt, n, dev)
    cmp_planes, full_range = _masked_planes(planes, traits, begin_bit,
                                            end_bit)
    seg_id = _segment_ids(offsets,
                          torch.arange(n, dtype=torch.int32, device=dev))

    def finish(sorted_planes, sorted_words):
        out_keys = _dtypes.twiddle_out(tuple(sorted_planes), traits,
                                       descending=descending)
        if values is None:
            return out_keys
        outs = tuple(_dtypes.join_values(sorted_words, spec))
        return out_keys, (outs[0] if single else outs)

    # the engine route (JAX gates it to the TPU alike): 32-bit keys over
    # the full range, as many value words as K1 and K2 carry
    if (dev.type == "cuda" and traits.planes == 1 and full_range and n
            and len(words) <= MAX_VALUES):
        return finish(*_sort_on_engine(offsets, seg_id, planes[0], words,
                                       stable=stable))
    return finish(*_sort_exact(seg_id, planes, cmp_planes, words,
                               full_range)[:2])
