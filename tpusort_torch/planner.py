"""Host-side tier pre-classifier.

The port's own copy of ``tpusort/planner.py`` (numpy only; the values,
thresholds and margins are the same).  The analog of the reference's
CPU-in-the-loop block planner (``msb/src/sort/gpu_radix_sort.cu:29-104``):
a tiny strided sample of the
twiddled keys is pulled to the host, and cheap numpy statistics predict
whether the radix engine's static per-run capacities would overflow.  The
host tier chain (``tpusort_torch.api``) then skips the doomed radix run and
dispatches the equi-depth skew tier directly — mispredictions are safe in
both directions (the flag-mode overflow check still guards correctness;
a false skip only costs the radix pipeline's higher throughput).

Two signals, matched to the two ways static capacities die:

* **prefix mass**: per-pass, the sampled fraction of the heaviest digit
  prefix; a run's expected occupancy ``n * f / t_seg`` near its capacity
  means binomial + locality spikes will overflow it (entropy-AND ladders,
  Zipf duplication, constant keys).
* **sortedness**: the fraction of non-decreasing adjacent sample pairs; a
  ~sorted input concentrates each contiguous radix tile into one digit
  (per-tile counts ~ K, not K/R) regardless of the global histogram.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["predict_radix_overflow", "prefix_mass_overflows",
           "predict_presorted",
           "PLANNER_MIN_N", "SAMPLE_TARGET"]

# Below this the radix attempt is cheap enough to just run (the sample
# fetch + host sync would rival the sort itself).
PLANNER_MIN_N = 1 << 24
SAMPLE_TARGET = 1 << 16

# Predict overflow when the heaviest run's expected occupancy exceeds this
# fraction of its capacity (the planner sizes capacity at uniform mean +
# 6.5 sigma, so sustained mass near capacity has no noise margin left).
_MASS_MARGIN = 0.85
# ~Sorted inputs concentrate tiles; random inputs sit near 0.5.
_SORTEDNESS_LIMIT = 0.95
# Minimum samples per prefix bucket for the mass estimate to be usable.
_MIN_SAMPLES_PER_BUCKET = 8


def predict_presorted(samples: Sequence[np.ndarray]) -> bool:
    """True if the strided sample is EXACTLY non-decreasing (lexicographic
    over planes) — the trigger for the already-sorted short-circuit (one
    cheap device-side full check, then identity).  The analog of the
    reference's finished buckets skipping all remaining passes
    (``msb/src/sort/gpu_radix_sort.h:359-360,482-485``) taken to its
    limit: a globally sorted input (constant keys included — the entropy-0
    ladder rung) costs one comparison pass, not a sort."""
    if samples[0].size < 2:
        return False
    lt = np.zeros(samples[0].size - 1, bool)   # strictly less at a
    eq = np.ones(samples[0].size - 1, bool)    # higher plane already
    for s in samples:                          # most-significant first
        lt = lt | (eq & (s[:-1] < s[1:]))
        eq = eq & (s[:-1] == s[1:])
    return bool(np.all(lt | eq))


def sortedness(sample: np.ndarray) -> float:
    """Max of the ascending and descending adjacent-pair fractions: a
    reverse-sorted input concentrates radix tiles into single digits
    exactly like an ascending one."""
    if sample.size < 2:
        return 0.0
    asc = float(np.mean(sample[1:] >= sample[:-1]))
    return max(asc, 1.0 - asc + float(np.mean(sample[1:] == sample[:-1])))


def predict_radix_overflow(
    sample_top: np.ndarray, plan, n: int
) -> bool:
    """True if the radix engine's padded capacities look doomed.

    ``sample_top``: strided sample of the TWIDDLED most-significant key
    word (uint32); ``plan``: the ``MsdPlan`` the engine would run; ``n``:
    full problem size.
    """
    m = int(sample_top.size)
    if m < 1024 or plan is None:
        return False
    if sortedness(sample_top) > _SORTEDNESS_LIMIT:
        return True
    cumw = 0
    for spec in plan.passes:
        cumw += spec.width
        if cumw > 32:
            break  # sample only covers the top word
        nbuckets = 1 << cumw
        if m < _MIN_SAMPLES_PER_BUCKET * nbuckets:
            break  # too noisy at this depth; shallower levels decide
        shift = np.uint32(32 - cumw)
        pref = (sample_top >> shift).astype(np.int64)
        counts = np.bincount(pref, minlength=nbuckets)
        if prefix_mass_overflows(float(counts.max()), m, cumw, spec, n):
            return True
    return False


def prefix_mass_overflows(cmax: float, m: int, cumw: int, spec,
                          n: int) -> bool:
    """Whether pass ``spec``'s runs look doomed, given that the heaviest of
    the 2^cumw digit prefixes it completes holds ``cmax`` of ``m`` sampled
    keys (of ``n``)."""
    nbuckets = 1 << cumw
    # debias the max bucket by the expected max-order-statistic excess
    # of a uniform multinomial (~sqrt(2 ln B * mean)) so sampling noise
    # at deep levels doesn't flag uniform inputs.  The excess uses the
    # UNIFORM MEAN m/B, not cmax itself — debiasing by the observed max
    # would scale the correction with the very skew being detected and
    # eat ~sqrt(cmax/mean) x too much of a heavy bucket's mass
    mean = m / nbuckets
    cmax -= np.sqrt(2.0 * np.log(nbuckets) * max(mean, 1.0))
    # run (tile, digit) at this pass holds the elements of one full
    # cumw-bit prefix, split across the segment's t_seg tiles
    exp_max = n * (cmax / m) / max(spec.t_seg, 1)
    return bool(exp_max > _MASS_MARGIN * spec.s)
