"""Equi-depth (sampled-splitter) MSD engine: the skew tier.

PyTorch port of ``tpusort/ops/equidepth.py``.  The radix engine's static
per-digit run capacities overflow on consistently biased distributions
(entropy-reduced keys, Zipfian duplication, presorted blocks).  This engine
makes the buckets adaptive instead:

* sample the twiddled input with a static stride, sort the sample once
  (through the radix engine itself at 2^18 samples or more), and read an
  equi-depth quantile table of R^p - 1 splitters plus each splitter
  value's run endpoints in sample ranks (its tie span);
* feed pass 0 through a strided, index-bit-mixed tile assignment, so that
  every tile mirrors the global distribution (presorted runs would fill
  one bucket of a contiguous tile);
* pass j partitions each tile of segment g against the R-1 splitters
  Q[((g*R + i) * R^(p-1-j)) - 1] with K1b, the splitter mode of the
  partition kernel (``kernels.partition.partition_pass_fused``): the sorted
  tile's buckets are contiguous, and each cut lands at the proportional
  position inside its tie range, clipped by the capacity with a backward
  relief sweep;
* the last pass's capacity is widened for the sample's quantile noise
  (:func:`_widen_last`), and the leaf is the radix engine's (K2);
* a cut forced outside its legal range poisons the tile's counts and
  raises the overflow flag.

Keys only and unstable pairs of 1-2 key planes over the full bit range,
plus stable 32-bit pairs through the composite (key, position) planes;
everything else is delegated to the reference sort.  Unlike the JAX
engine, which folds the fallback into the graph with ``lax.cond``, this one
returns its overflow flag on the device and takes no fallback: its callers
state theirs through ``ops/tiers.py``, which reads the flag.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpusort_torch.configs import get_config
from tpusort_torch.kernels.partition import partition_pass_fused
from tpusort_torch.ops import msd as _msd
from tpusort_torch.ops.reference import sort_twiddled_reference
from tpusort_torch.ops.tiers import first_clear
from tpusort_torch.utils.log import span, spanned

__all__ = ["sort_twiddled_equidepth", "supports"]


def _sample_cap(n: int) -> int:
    """The largest sample: 2^22 up to n = 2^28, then n / 64, so the deepest
    splitter level's relative noise stays constant."""
    return max(1 << 22, n >> 6)


def _widen_last(plan: "_msd.MsdPlan", n: int, m_sample: int,
                leaf_max: int) -> "_msd.MsdPlan":
    """Widen the final pass's run capacity for quantile noise (port of
    ``tpusort.ops.equidepth._widen_last``).  The deepest splitter level
    adds a bucket-share error common to every tile, relative sigma about
    sqrt(nq / m); the worst of nq buckets runs about sqrt(2 ln nq) sigma
    over the mean, with the binomial tile tail on top.  The plan is kept
    when the geometry cannot absorb the wider run (the runtime flag then
    guards it)."""
    last = plan.passes[-1]
    p = len(plan.passes)
    nq = last.r ** p
    sq = math.sqrt(nq / max(m_sample, 1))
    zq = math.sqrt(2 * math.log(max(nq, 2)))
    t_last = last.n_seg * last.t_seg
    mean = n / (t_last * last.r)     # per-(tile, bucket) valid occupancy
    mean_q = mean * (1 + zq * sq)
    required = mean_q + 6.5 * math.sqrt(max(mean_q, 1.0))
    s_new = -(-int(required) // 128) * 128
    if s_new <= last.s:
        return plan
    seg = last.t_seg * s_new
    if s_new > last.k or seg > leaf_max or seg % 128:
        return plan
    passes = plan.passes[:-1] + (replace(last, s=s_new),)
    return _msd.MsdPlan(
        m1=plan.m1, passes=passes, seg=seg, n_segments=plan.n_segments,
        m_final=plan.n_segments * seg, rem_lo=plan.rem_lo,
        rem_width=plan.rem_width,
    )


def supports(nplanes: int, n_values: int, begin_bit: int, end_bit: int,
             total_bits: int, stable: bool = False) -> bool:
    """Whether the splitter pipeline itself can run this shape: the full
    bit range of 1-2 key planes; stable pairs only with one plane (the
    composite (key, position) planes take the second)."""
    if begin_bit != 0 or end_bit != total_bits or total_bits != 32 * nplanes:
        return False
    if stable and n_values:
        return nplanes == 1
    return nplanes in (1, 2)


class _EqTable:
    """Equi-depth splitter table with sample-resolution tie spans.

    q[p][z] is plane p's word of the key at boundary slot z (int32 bit
    patterns); lo/hi are that value's run endpoints in sample ranks
    (searchsorted left/right); ranks are the slots' sample ranks (numpy);
    m is the sample size."""

    __slots__ = ("q", "lo", "hi", "ranks", "m")

    def __init__(self, q, lo, hi, ranks, m):
        self.q, self.lo, self.hi, self.ranks, self.m = q, lo, hi, ranks, m


@spanned("tpusort.equidepth.sample")
def _quantile_table(planes: Sequence[torch.Tensor], n: int, nq: int,
                    sample_log2: Optional[int] = None) -> _EqTable:
    """Equi-depth splitters and tie spans from a strided sample of
    planes[:n] (port of ``tpusort.ops.equidepth._quantile_table``).  A
    sample of 2^18 or more sorts through the radix engine, and a skewed
    sample then takes the exact reference sort (JAX selects in the graph;
    here the flag is read on the host, and this fallback is counted apart
    from the call's, as ``sample_fallbacks``); a smaller sample sorts
    through the reference sort."""
    if sample_log2 is None:
        target = max(1 << 16, min(_sample_cap(n), n // 8))
    else:
        target = 1 << sample_log2
    stride = max(1, n // target)
    samples = tuple(p[:n:stride].contiguous() for p in planes)
    m = samples[0].shape[0]
    bits = 32 * len(planes)
    ref_bits = dict(begin_bit=0, end_bit=bits, total_bits=bits)
    cfg = get_config(bits, False, samples[0].device.type)
    chain = [lambda: (*sort_twiddled_reference(samples, (), **ref_bits),
                      None)]
    if m >= (1 << 18):
        chain.insert(0, lambda: _msd.sort_twiddled_msd(
            samples, (), config=cfg, **ref_bits))
    samples, _ = first_clear(chain, "sample_flag", route="sample_fallbacks")
    # the ranks are static; int64, as i * m overflows int32 in deep tables
    # (nq 32767 x m 2^23)
    i = np.arange(1, nq + 1, dtype=np.int64)
    ranks = np.minimum(i * m // (nq + 1), m - 1).astype(np.int32)
    dev = samples[0].device
    rk = _msd.to_device(ranks.astype(np.int64), dev)
    q = [s[rk] for s in samples]
    # the run endpoints of each slot's value: the sorted sample's run ids
    # (a running count of value changes) are non-decreasing, so a binary
    # search finds each run's ends (JAX takes two running-max scans, which
    # are slow here)
    neq = samples[0][1:] != samples[0][:-1]
    for s in samples[1:]:
        neq = neq | (s[1:] != s[:-1])
    run = torch.cumsum(torch.cat([torch.ones(1, dtype=torch.bool,
                                             device=dev), neq]), dim=0)
    at = run[rk]
    first = torch.searchsorted(run, at).to(torch.int32)
    last1 = torch.searchsorted(run, at, right=True).to(torch.int32)
    return _EqTable(q, first, last1, ranks, m)


@spanned("tpusort.equidepth.splitters")
def _pass_splitters(table: _EqTable, p: int, j: int, r: int,
                    t_seg: int) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Per-tile splitters and tie fractions for pass j of p (port of
    ``tpusort.ops.equidepth._pass_splitters``): ((T_j, r-1) int32 words per
    plane, (T_j, r-1) int32 16-bit fixed-point fractions).  Segment g uses
    Q[((g*r + i) * r^(p-1-j)) - 1]; the fraction is the share of the
    splitter value's sample copies that lies below this boundary's rank,
    renormalized to the enclosing segment's slice of that value, computed
    in float32 as JAX does."""
    nq = table.ranks.shape[0]
    dev = table.lo.device
    i = np.arange(1, r, dtype=np.int64)[None, :]
    g = np.arange(r ** j, dtype=np.int64)[:, None]
    stride = r ** (p - 1 - j)
    z = (g * r + i) * stride - 1                       # (r^j, r-1)
    zt = _msd.to_device(z, dev)
    spl_seg = [qp[zt] for qp in table.q]
    lo = table.lo[zt]                                  # the value's span
    span = torch.clamp(table.hi[zt] - lo, min=1)
    rk = table.ranks

    def rank_at(slots):
        s_ = np.clip(slots, 0, nq - 1)
        rr = rk[s_].astype(np.int64)
        rr = np.where(slots < 0, 0, rr)
        return np.where(slots >= nq, table.m, rr)

    r_z = rank_at(z)
    r_l = rank_at((g * r * stride - 1) * np.ones_like(z))
    r_r = rank_at(((g + 1) * r * stride - 1) * np.ones_like(z))

    def below(ranks_np):
        rt = _msd.to_device(ranks_np.astype(np.int32), dev)
        return torch.minimum(torch.clamp(rt - lo, min=0), span)

    num = below(r_z) - below(r_l)
    den = torch.clamp(below(r_r) - below(r_l), min=1)
    frac = torch.clamp(
        (num.to(torch.float32) / den.to(torch.float32) * 65536.0)
        .to(torch.int32), 0, 65536)
    return ([sp.repeat_interleave(t_seg, dim=0) for sp in spl_seg],
            frac.repeat_interleave(t_seg, dim=0))


def _run_pipeline(
    planes: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    n: int,
    plan: "_msd.MsdPlan",
    q: _EqTable,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The splitter passes (one K1b launch each) and the raw-key leaf (K2)
    over twiddled int32 plane(s) plus payload words, which ride unstably
    (port of ``tpusort.ops.equidepth._run_pipeline``).  Returns the sorted
    (n,) operands [planes..., values...] and the overflow flag, a 0-d bool
    tensor on the device; the caller decides what to do with it."""
    nplanes = len(planes)
    p = len(plan.passes)
    r = plan.passes[0].r
    dev = planes[0].device
    ops, ctable = _msd.strided_feed([*planes, *values], n, plan)
    qg = 128
    prev_s = None
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for j, spec in enumerate(plan.passes):
        with span("tpusort.pass"):
            t = spec.n_seg * spec.t_seg
            tiled = [o.reshape(t, spec.k) for o in ops]
            spl, frac = _pass_splitters(q, p, j, r, spec.t_seg)
            ops, counts = partition_pass_fused(
                tiled[:nplanes], tiled[nplanes:],
                ctable.reshape(t, spec.k // qg), q_in=qg, n=n, r=spec.r,
                s=spec.s, lo_bit=spec.lo_bit, width=spec.width,
                sorted_run=None if prev_s is None else prev_s & -prev_s,
                t_seg=spec.t_seg, splitters=spl, splitter_fracs=frac,
                unstable=True)
            del tiled
            overflow |= (counts > spec.s).any()
            ctable, qg = _msd.next_counts_table(counts, spec)
            prev_s = spec.s
    # the raw-key leaf, as the radix engine's: segments are value ranges in
    # ascending order, and adjacent segments share only equal (boundary)
    # values, so tiles of whole segments sort into global order
    return _msd.raw_leaf(ops, ctable, qg, plan, nplanes, n), overflow


def _prepare(n: int, plan_kwargs: Optional[dict]):
    """Resolve plan kwargs into (msd kwargs, min_n, sample_log2, sample
    size, leaf_max) (port of ``tpusort.ops.equidepth._prepare``)."""
    kwargs = dict(plan_kwargs or {})
    min_n = kwargs.pop("min_n", 1 << 16)
    sample_log2 = kwargs.pop("sample_log2", None)
    if sample_log2 is not None:
        m_sample = 1 << sample_log2
    else:
        m_sample = max(1 << 16, min(_sample_cap(n), n // 8))
    leaf_max = kwargs.get("leaf_max") or max(
        2 * kwargs.get("k", 1 << 14), 1 << 15
    )
    return kwargs, min_n, sample_log2, m_sample, leaf_max


def sort_twiddled_equidepth(
    planes: Tuple[torch.Tensor, ...],
    values: Sequence[torch.Tensor] = (),
    *,
    begin_bit: int,
    end_bit: int,
    total_bits: int,
    config=None,
    plan_kwargs: Optional[dict] = None,
    stable: bool = False,
):
    """Ascending sort of twiddled int32 planes (plane 0 most significant)
    with int32 payload words through the equi-depth pipeline (port of
    ``tpusort.ops.equidepth.sort_twiddled_equidepth``).

    Keys only and unstable pairs of 1-2 key planes over the full bit
    range; stable 32-bit pairs through the composite (key, position)
    planes.  Other shapes, inputs below ``min_n`` and sizes with no plan
    are delegated to the exact reference sort.  The plan comes from
    ``plan_kwargs`` or else ``config`` (its ``skew_sample_log2`` sets the
    sample size).  With payloads a valid key equal to the all-ones
    invalid-slot sentinel raises the overflow flag too, as payloads ride
    unstably past it.

    Returns (planes, values, overflow), as ``ops.msd.sort_twiddled_msd``
    does: the flag a 0-d bool tensor on the device, or None where the
    input went to the reference sort.
    """
    n = planes[0].shape[0]
    if plan_kwargs is None and config is not None:
        plan_kwargs = config.plan_kwargs()
        if config.skew_sample_log2 is not None:
            plan_kwargs["sample_log2"] = config.skew_sample_log2
    kwargs, min_n, sample_log2, m_sample, leaf_max = _prepare(n, plan_kwargs)
    plan = None
    if (supports(len(planes), len(values), begin_bit, end_bit, total_bits,
                 stable=stable)
            and n >= min_n and all(v.element_size() == 4 for v in values)):
        if stable and values:
            # the composite (key, position) planes: the position is
            # unique, so the unstable 2-plane pipeline is stable by key,
            # and the all-ones sentinel never equals a real (key, position)
            gidx = torch.arange(n, dtype=torch.int32,
                                device=planes[0].device)
            sp, sv, ovf = sort_twiddled_equidepth(
                (planes[0], gidx), values, begin_bit=0, end_bit=64,
                total_bits=64, plan_kwargs=plan_kwargs, stable=False)
            return sp[:1], sv, ovf
        plan = _msd._plan_cached(n, begin_bit, end_bit, "raw",
                                 tuple(sorted(kwargs.items())))
    if plan is None:
        _msd.count_route("reference_routes")
        return (*sort_twiddled_reference(planes, values, begin_bit=begin_bit,
                                         end_bit=end_bit,
                                         total_bits=total_bits), None)
    plan = _widen_last(plan, n, m_sample, leaf_max)
    _msd.count_route("equidepth_runs")
    q = _quantile_table(planes, n, plan.passes[0].r ** len(plan.passes) - 1,
                        sample_log2=sample_log2)
    out, overflow = _run_pipeline(planes, values, n, plan, q)
    if values:
        # pairs ride unstably past the invalid-slot sentinel: a valid key
        # equal to it could swap payloads with a dropped pad slot
        is_max = planes[0] == -1
        for p_ in planes[1:]:
            is_max &= p_ == -1
        overflow |= is_max.any()
    nplanes = len(planes)
    return tuple(out[:nplanes]), tuple(out[nplanes:]), overflow
