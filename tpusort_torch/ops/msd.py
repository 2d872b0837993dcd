"""MSD hybrid radix sort engine: the raw-key and general paths.

PyTorch port of ``tpusort/ops/msd.py``.  The planning part (``PassSpec``,
``MsdPlan``, ``plan_msd``) is copied verbatim: it is pure Python, and the
JAX module imports jax at module level.

The raw-key path takes full-range keys only (1-3 planes), unstable pairs,
and stable pairs of one-plane keys; the general (digit, idx) path takes
the rest: bit-range sorts, keys only or with payloads, and stable pairs
of multi-plane keys.

* each partition pass (``run_passes``) calls the fused partition kernel
  (``kernels.partition.partition_pass_fused``) once: on the raw path K1
  sorts every (T, K) tile by the raw key planes (invalid slots become
  0xFFFFFFFF); on the general path K1c partitions it stably by the digit.
  With payloads K1 and K2 break ties by slot index and rank invalid slots
  after every valid one, a valid all-ones key included, so the raw path
  is stable on the contiguous feed: a pass lays run d of tile j at
  [seg][d][j], so slot order is input order in every later tile.
  Either cuts R digit runs padded to S and writes them with their payloads
  straight into the digit-major exchanged layout of the next pass;
* validity is never stored per element: each pass returns a (T, R) counts
  table, and the next consumer derives validity from it;
* the raw leaf, K2 (``kernels.bitonic.sort_tiles_counts_collapsed``),
  sorts packed tiles of whole final segments and writes each tile's valid
  prefix to its dense output offset.  The general leaf (:func:`_leaf_sort`)
  sorts each segment stably by its remaining bits where (remainder,
  position) fits 32 bits (:func:`packed_leaf`): on a card K3's runs body
  reads the segment from the last pass's runs and writes it dense, else a
  packed (segment, remainder, position) word on K3 followed by the
  collapse K4; where it does not fit, K2 on the masked planes plus the
  position;
* a run that overflows its capacity (count > S) raises a flag on the
  device, which :func:`sort_twiddled_msd` returns with its output and
  never reads: the caller's chain of attempts (``ops/tiers.py``) reads it
  and takes the next attempt, down to the exact sort;
* inputs too small for a plan go to the single-tile path (K3,
  ``ops/small.py``) where it applies, and to the reference sort otherwise.

The per-phase engine (``utils/profiling.py``, JAX's per-phase profiler)
runs the same passes apart: :func:`_partition_pass` computes the digit
histogram, run starts and a sortkey in plain PyTorch, K8
(``kernels.partition.partition_tiles``) sorts and cuts each tile, and
:func:`_exchange` copies the runs into digit-major order; then
:func:`sort_segments` (the leaf without its collapse) and K4.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpusort_torch.kernels import _build
from tpusort_torch.kernels.bitonic import (
    leaf_merge_geometry, leaf_runs_geometry, leaf_tile_cap, sort_leaf_runs,
    sort_tiles, sort_tiles_counts, sort_tiles_counts_collapsed,
    sort_tiles_masked, sort_tiles_plain)
from tpusort_torch.kernels.collapse import (
    collapse_segments, collapse_segments_plain)
from tpusort_torch.kernels.partition import (
    MAX_PLANES, _histogram, _partition_pass_general_cuda,
    _partition_pass_splitter_cuda, extract_bits, partition_pass_fused,
    partition_tiles)
from tpusort_torch.kernels.scanhist import (
    digit_histogram_tiles, prefix_sum_tiles)
from tpusort_torch.ops.reference import (
    _mask_plane_bits, sort_twiddled_reference)
from tpusort_torch.ops.small import single_tile_ok, sort_twiddled_bitonic
from tpusort_torch.parallel.ring import ring_all_to_all
from tpusort_torch.utils.log import COUNTS, count, span, spanned

# ---------------------------------------------------------------------------
# Geometry planning (verbatim from tpusort/ops/msd.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PassSpec:
    n_seg: int       # independent segments this pass operates within
    t_seg: int       # tiles per segment
    k: int           # tile size (elements)
    r: int           # radix (runs per tile)
    s: int           # padded run capacity (elements, multiple of 128)
    lo_bit: int      # LSB position of this pass's digit
    width: int       # digit width in bits (<= log2(r))


@dataclass(frozen=True)
class MsdPlan:
    m1: int                      # padded element count entering pass 1
    passes: Tuple[PassSpec, ...]
    seg: int                     # final segment size (elements)
    n_segments: int
    m_final: int
    rem_lo: int                  # leaf sorts bits [rem_lo, rem_lo + rem_width)
    rem_width: int


def plan_msd(
    n: int,
    begin_bit: int,
    end_bit: int,
    *,
    k: int = 1 << 14,
    r: int = 32,
    s1: Optional[int] = None,
    s: Optional[int] = None,
    leaf_max: Optional[int] = None,
    leaf_profile: str = "raw",
    t1_force: Optional[int] = None,
) -> Optional[MsdPlan]:
    """Compute a static pass plan, or None if no feasible plan exists.

    Geometry invariants (all checked):
      * every pass's tiles hold exactly K elements and emit R runs of S;
      * pass outputs regroup into next-pass tiles without straddling digit
        segments (T_seg multiple of K/S_prev runs-per-tile, segments multiples
        of K);
      * the final segments are <= leaf_max and multiples of 128.

    ``leaf_profile`` keys the cost model on the leaf kernel VARIANT the
    remaining bit width will select (the ``GetSortKernel`` analog,
    ``msb/src/sort/gpu_sort_config.h:250-264``): ``"raw"`` paths sort the
    raw key planes (width-independent); ``"packed"`` paths pack
    (rem, idx) into one sortkey word and fall to the ~5x multikey XLA
    leaf when ``rem_width + idx_bits + 1 > 32`` — so near that boundary
    the search trades an extra partition pass against the slow leaf.
    """
    import math

    log_r = r.bit_length() - 1
    if s1 is None:
        s1 = ((3 * k // (2 * r)) // 128) * 128      # alpha ~ 1.5 on pass 1
    if s is None:
        s = k // r                                  # alpha-preserving after
    if leaf_max is None:
        # leaf tiles up to 2*K fit VMEM comfortably for 1-2 operand merges;
        # a bigger leaf saves a whole partition pass at awkward sizes
        leaf_max = max(2 * k, 1 << 15)
    if k % (r * 128) or s % 128 or s1 % 128:
        return None

    bits = end_bit - begin_bit

    import math as _math

    def _cap_ok(kp: int, cap: int, density: float) -> bool:
        """Run capacity must clear the binomial mean by ~6.5 sigma, or
        uniform inputs would routinely trip the overflow fallback."""
        mean = kp * density / r
        sigma = _math.sqrt(max(mean * (1 - 1 / r), 1.0))
        return cap >= mean + 6.5 * sigma

    def _try(p: int, t1: int) -> Optional[MsdPlan]:
        """Build a p-pass plan with T1 tiles, or None if infeasible."""
        density = (k / r) / s1          # valid fraction after pass 0
        if not _cap_ok(k, s1, 1.0):
            return None
        seg = t1 * s1
        specs = [PassSpec(1, t1, k, r, s1, end_bit - min(log_r, bits),
                          min(log_r, bits))]
        n_seg = r
        for _ in range(1, p):
            # segments must be whole numbers of tiles (tiles may not span
            # two digit segments — that would interleave order boundaries).
            # When the default tile size doesn't divide the segment, shrink
            # this pass's tile (e.g. 2^29: seg3 = 24576 = 3 * 8192).
            kp = k
            while kp >= r * 128 and seg % kp:
                kp //= 2
            if kp < r * 128 or seg % kp:
                return None
            sp_ = kp // r if s == k // r else s
            if sp_ % 128 or sp_ > kp:
                return None
            if not _cap_ok(kp, sp_, density):
                return None
            t_seg = seg // kp
            consumed = sum(q.width for q in specs)
            width = min(log_r, bits - consumed)
            if width <= 0:
                return None
            lo = end_bit - consumed - width
            specs.append(PassSpec(n_seg, t_seg, kp, r, sp_, lo, width))
            seg = t_seg * sp_
            n_seg *= r
        if seg > leaf_max or seg % 128:
            return None
        consumed = sum(sp.width for sp in specs)
        return MsdPlan(
            m1=t1 * k,
            passes=tuple(specs),
            seg=seg,
            n_segments=n_seg,
            m_final=n_seg * seg,
            rem_lo=begin_bit,
            rem_width=bits - consumed,
        )

    # Non-network per-pass cost (emit window slices + starts compare-reduces
    # + exchanged-out write), in compare-exchange stage-equivalents per
    # element.  Re-calibrated r4 (benchmarks/pass_decomp.py at the adopted
    # k=65536 geometry, 2^28): stage price 2.39 ps/elem; starts +6.4 ms,
    # exchanged write +5 ms per pass = ~43 ps = ~18 slots; the fused
    # leaf+collapse runs ~17-22 ms over its slot model = ~20 slots.
    _OH_PASS = 18.0
    _OH_LEAF = 20.0      # fused leaf+collapse write discipline

    def _leaf_slots(seg: int, run: int) -> float:
        """Exact compare-exchange stage-slots (stages x elements) of the
        raw-key leaf network over one ``seg``-element tile with sorted
        ``run``-subruns: the staged f*2^a merge when it applies (its final
        phases run on partial/padded extents — counted exactly, matching
        kernels.bitonic._merge_sorted_runs_fpow2), else the pow2-padded
        bitonic merge."""
        from tpusort_torch.kernels.bitonic import merge_staged_factor

        c = run.bit_length() - 1
        f = merge_staged_factor(seg)
        if f and (seg // f) % run == 0:
            blk = seg // f
            a = blk.bit_length() - 1
            slots = sum(range(c + 1, a + 1)) * seg        # phases c..a-1
            slots += (a + 1) * (f - 1) * blk              # phase a, front
            if f == 5:
                slots += (a + 2) * 4 * blk                # phase a+1, front
            # cascade back-insertion: (f-1) directed 2-block merges of
            # (a+1) stages each, plus ~2 block reversals
            slots += (a + 1) * 2 * (f - 1) * blk + 2 * a * blk
            return float(slots)
        pow2 = 1 << (seg - 1).bit_length()
        return float(sum(range(c + 1, pow2.bit_length())) * pow2)

    def _cost(plan: MsdPlan) -> float:
        """Stage-slot cost model (CE stages x elements + per-pass emit/HBM
        overheads, with penalties for batching-hostile tiny t_seg)."""
        total = 0.0
        prev_s = None
        for sp in plan.passes:
            nb_pen = 1.0 if sp.t_seg % 4 == 0 else 1.35
            lgk = sp.k.bit_length() - 1
            if prev_s is None:
                stages = lgk * (lgk + 1) / 2          # full sort
            else:
                k0 = (prev_s & -prev_s).bit_length() - 1
                stages = sum(range(k0 + 1, lgk + 1))  # merge tail
            total += (stages * nb_pen + _OH_PASS) * sp.n_seg * sp.t_seg * sp.k
            prev_s = sp.s
        # leaf: merge from the last pass's pow2 run size
        run = prev_s & -prev_s
        # leaf variant keyed on the remaining bit width (GetSortKernel
        # analog): the packed-sortkey network needs rem + idx (+ tie
        # headroom) to fit one u32 word; past that the leaf drops to the
        # multikey XLA sort (~5x slower per element).  Raw-key leaves
        # (keys-only / unstable pairs / composite stable) sort the key
        # planes themselves — width-independent.
        leaf_mult = 1.0
        if leaf_profile == "packed":
            idx_bits = (plan.seg - 1).bit_length()
            if plan.seg >= (1 << idx_bits):
                idx_bits += 1
            leaf_mult = (
                5.0 if plan.rem_width + idx_bits + 1 > 32 else 1.15
            )
        total += plan.n_segments * (
            _leaf_slots(plan.seg, run) * leaf_mult + _OH_LEAF * plan.seg
        )
        return total

    best = None
    for p in range(1, 5):
        if bits < log_r * p:
            break
        if t1_force is not None:
            # fixed pass-0 tile count (the sorted-window finish: the input
            # IS the padded physical layout, m1 = t1*k exactly)
            plan = _try(p, t1_force)
            if plan is not None:
                c = _cost(plan)
                if best is None or c < best[0]:
                    best = (c, plan)
            continue
        quantum = k // math.gcd(s1, k)
        tiles_needed = -(-n // k)
        t1_base = -(-tiles_needed // quantum) * quantum
        for step in range(512):
            t1 = t1_base + step * quantum
            if t1 * k > max(8 * n, 1 << 23):
                break
            plan = _try(p, t1)
            if plan is not None:
                c = _cost(plan)
                if best is None or c < best[0]:
                    best = (c, plan)
        # keep searching other pass counts and t1 values: more passes or
        # more padding can beat a batching-hostile shallower plan
    return None if best is None else best[1]


# ---------------------------------------------------------------------------
# Route counters
# ---------------------------------------------------------------------------

# Engine and API routes, as plain integers.  The kernel launch counts live
# on the kernel wrappers (``partition_pass_fused.launches`` for K1's raw
# branch, ``_partition_pass_splitter_cuda.launches`` for its splitter mode
# K1b, ``_partition_pass_general_cuda.launches`` for its general branch
# K1c, ``sort_tiles_counts_collapsed.launches``, ``sort_tiles.launches``,
# ``collapse_segments.launches``, ``prefix_sum_tiles.launches``,
# ``digit_histogram_tiles.launches``, ``sort_tiles_counts.launches``,
# ``sort_tiles_masked.launches``, ``ring_all_to_all.launches``,
# ``partition_tiles.launches`` (K8, the per-phase engine's passes), and
# ``.modes`` by key planes and payload words), which count only where they
# launch a CUDA kernel; :func:`counters` and :func:`mode_counters` read them.
# The host reads and the bytes of the split and join, of the merge
# bodies, of K1c and of the packed leaf are counted in ``utils.log.COUNTS``.
_ROUTES = {"reference_routes": 0, "overflow_fallbacks": 0,
           "radix_tiers": 0, "equidepth_runs": 0, "sample_fallbacks": 0,
           "identity_routes": 0, "exchange_fallbacks": 0}
_KERNELS = {"k1_launches": partition_pass_fused,
            "k1b_launches": _partition_pass_splitter_cuda,
            "k1c_launches": _partition_pass_general_cuda,
            "k2_launches": sort_tiles_counts_collapsed,
            "k3_launches": sort_tiles,
            "k4_launches": collapse_segments,
            "k5_launches": prefix_sum_tiles,
            "k6_launches": digit_histogram_tiles,
            "k9_launches": sort_tiles_counts,
            "k10_launches": sort_tiles_masked,
            "k7_launches": ring_all_to_all,
            "k8_launches": partition_tiles}


def count_route(name: str) -> None:
    """Count one route taken (a key of :func:`counters` that is not a
    kernel's launches)."""
    with _build._LOCK:
        _ROUTES[name] += 1


def counters() -> dict:
    """Since the last :func:`reset_counters`: K1 (raw branch), K1b
    (splitter mode), K1c (general branch), K2, K3, K4, K5 (prefix sum), K6
    (digit histogram), K9 and K10 (the tile sorts by counts and by mask),
    K7 (the global sort's window exchange) and K8 (the per-phase engine's
    partition passes) launches; reference routes
    (an engine delegating: no plan and no single-tile path, or a shape the
    equi-depth engine does not take); overflow fallbacks (exact sorts after
    an overflow flag, each counted by ``ops/tiers.py`` at the end of its
    caller's chain); the radix tiers the tier chain
    dispatched; the equi-depth pipelines run, and the exact sorts their
    samples took after an overflow; presorted inputs returned as they
    were; global sorts whose exchange would overflow its capacity, which
    gather and sort every shard instead (once a call); the places where
    the host waited for a device value (``host_reads``, each a
    ``tpusort.read.*`` span); the bytes the 64-bit split and join copied
    (``split_join_bytes``, from the tensors' sizes: ``dtypes.split64``
    and ``join64``); the bytes K1's, K1b's and K2's merge-body launches
    read and write (``merge_bytes``: 8 B a valid key and operand word, the
    key planes plus payload words, from the launch's arguments), and K1c's
    launches alike (``general_bytes``); the bytes the general path's packed
    leaf reads and writes (``packed_leaf_bytes``, :func:`_leaf_sort`: 8 B a
    valid key and operand word of K3 and of K4)."""
    return dict({k: fn.launches for k, fn in _KERNELS.items()}, **_ROUTES,
                **COUNTS)


def mode_counters() -> dict:
    """Launches since the last :func:`reset_counters` by kernel and mode:
    {("K1" | "K1b" | "K1c" | "K2" | "K3" | "K4" | "K5" | "K6" | "K7" | "K8"
    | "K9" | "K10", key planes, payload words[, tag]): launches}.  K1c
    counts its key planes and value words; K4 compares no keys, so its mode
    is (0, operand words); K5's and K7's are (0, 1), K6's (1, 0) and K8's
    (1, data operands).  K1's emit-only launches (tiles that are one sorted
    run, the windows finish's pass 0) carry the tag "emit-only"; K1's, K1b's
    and K2's merge-body launches (tiles that arrive as sorted runs, merged
    from their valid prefixes) the tag "merge"; K1's and K1b's runs-body
    launches (a pass 0 sorted by warp runs, then merged) the tag "runs",
    and so do K3's (the packed leaf read from the last pass's runs,
    :func:`packed_leaf`; K3's row sorts carry no tag)."""
    return {("K" + k[1:k.index("_")], *mode): c
            for k, fn in _KERNELS.items()
            for mode, c in fn.modes.items() if c}


def reset_counters() -> None:
    with _build._LOCK:
        for fn in _KERNELS.values():
            fn.launches = 0
            fn.modes.clear()
        for key in _ROUTES:
            _ROUTES[key] = 0
        for key in COUNTS:
            COUNTS[key] = 0


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def run_passes(
    ops: Sequence[torch.Tensor], nplanes: int, n: int, plan: MsdPlan,
    unstable: bool = False, general: bool = False,
    init_chain: Optional[Tuple[torch.Tensor, int, Optional[int]]] = None,
) -> Tuple[List[torch.Tensor], Tuple[torch.Tensor, int], torch.Tensor]:
    """All partition passes, one K1 (raw) or K1c (``general``) launch each
    (port of ``_run_passes_pallas``).

    ``ops``: the (plan.m1,) int32 operands, ``nplanes`` key planes then
    payload words, valid below ``n``.  Validity rides as counts tables:
    pass 0 takes it from ``n``, or from ``init_chain`` = (flat counts
    table, its q, sorted run) where the caller laid the input out
    otherwise: the strided feed (sorted run None) or the sorted windows
    (sorted run K, which makes K1's pass 0 emit-only).  Each pass emits
    (T, R) counts, which :func:`next_counts_table` turns into the next
    consumer's table.  Returns (flat runs of the last pass per operand,
    (counts table, q), overflow as a 0-d bool tensor on the device).
    """
    ctable, q, prev_run = init_chain if init_chain is not None \
        else (None, None, None)
    ops = list(ops)
    overflow = torch.zeros((), dtype=torch.bool, device=ops[0].device)
    for spec in plan.passes:
        with span("tpusort.pass"):
            t = spec.n_seg * spec.t_seg
            tiled = [o.reshape(t, spec.k) for o in ops]
            cin = None if ctable is None else ctable.reshape(t, spec.k // q)
            # emitted runs are monotone slices of sorted tiles, so chunks
            # of the previous run size's pow2 part are sorted: K1 only
            # merges
            ops, counts = partition_pass_fused(
                tiled[:nplanes], tiled[nplanes:], cin, q_in=q, r=spec.r,
                s=spec.s, lo_bit=spec.lo_bit, width=spec.width,
                n=n, sorted_run=prev_run,
                unstable=unstable, t_seg=spec.t_seg, general=general,
            )
            prev_run = spec.s & -spec.s
            overflow |= (counts > spec.s).any()
            ctable, q = next_counts_table(counts, spec)
    return ops, (ctable, q), overflow


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A small host array on ``dev``; to a card through pinned memory,
    asynchronously, so the host does not wait for the queued kernels."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory().to(dev, non_blocking=True) \
        if dev.type == "cuda" else t


@spanned("tpusort.feed")
def strided_feed(operands: Sequence[torch.Tensor], n: int, plan: MsdPlan
                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Pass 0's input: the (n,) operands padded to plan.m1 and laid out
    in strided, index-bit-mixed tiles, with the 128-slot counts table of
    their validity (port of ``tpusort/ops/equidepth.py:285-325``).  Tile t
    takes elements {j*T + mix(t)}, so every tile mirrors the global
    distribution; mix swaps the two halves of the tile index (t = a*B + b
    -> b*A + a), because a pure stride aliases rank-structured (presorted)
    input at deeper passes.  Every operand moves alike."""
    k0 = plan.passes[0].k
    t1 = plan.m1 // k0
    dev = operands[0].device
    a_mix = 1 << ((t1.bit_length() - 1) // 2)
    b_mix = t1 // a_mix
    t_idx = torch.arange(t1, dtype=torch.int64, device=dev)
    if a_mix * b_mix == t1:
        mixvec = (t_idx % b_mix) * a_mix + t_idx // b_mix
    else:
        a_mix, b_mix = t1, 1                   # a plain transpose
        mixvec = t_idx
    ops = []
    for o in operands:
        # out[a, b, j] = in[j, b, a], as two copies: the first transposes
        # within blocks of 128 rows, so its strided reads stay in a span
        # the L2 cache holds, and the second moves 128-word runs (one
        # strided copy would read one word per 32-byte sector across the
        # whole array)
        x = torch.nn.functional.pad(o, (0, plan.m1 - n)).reshape(
            k0 // 128, 128, b_mix, a_mix)
        x = x.permute(0, 2, 3, 1).contiguous()
        ops.append(x.permute(2, 1, 0, 3).reshape(-1))
    del x
    # tile t's slot j holds element j*T + mix(t), valid iff < n, so its
    # valid prefix is ceil((n - mix(t)) / T) slots long
    thr = torch.div(n - mixvec + t1 - 1, t1, rounding_mode="floor")
    ctable = torch.clamp(
        thr[:, None] - torch.arange(k0 // 128, dtype=torch.int64,
                                    device=dev)[None, :] * 128,
        0, 128).to(torch.int32).reshape(-1)
    return ops, ctable


def exchanged_counts(counts: torch.Tensor, spec: PassSpec) -> torch.Tensor:
    """A pass's (T, R) counts clipped to S, flat in the digit-major order
    of its exchanged runs: the valid prefix of each run of S slots."""
    return counts.clamp(max=spec.s).reshape(
        spec.n_seg, spec.t_seg, spec.r).transpose(1, 2).reshape(-1)


def counts_table(run_counts: torch.Tensor, s: int) -> Tuple[torch.Tensor, int]:
    """The validity table of runs of ``s`` slots with ``run_counts`` (flat,
    at most ``s``) valid slots each: every run split into chunks of q =
    s & -s slots (the largest power of two dividing S, so each chunk of a
    pass's run is an ascending subrun).  Returns (flat table, q)."""
    q = s & -s
    c = (run_counts[:, None] - torch.arange(s // q, dtype=torch.int32,
                                            device=run_counts.device) * q)
    return c.clamp(0, q).reshape(-1), q


def next_counts_table(
    counts: torch.Tensor, spec: PassSpec
) -> Tuple[torch.Tensor, int]:
    """The validity table a pass's (T, R) counts give its consumer
    (:func:`counts_table` of the :func:`exchanged_counts`).  Returns (flat
    table, q)."""
    return counts_table(exchanged_counts(counts, spec), spec.s)


def leaf_tiles(plan: MsdPlan, nplanes: int = 1, has_values: bool = False,
               q: Optional[int] = None) -> Tuple[int, int]:
    """(number, size) of the raw leaf's tiles: one final segment a tile
    where K2 merges it from the last pass's runs (its merge body), else
    whole final segments packed up to 2^15 slots per tile, or fewer where
    K2 holds more operands (its network body's shared-memory tile cap).
    Packing whole segments leaves the dense output unchanged; a merged
    tile gains nothing by it (the segments are in order already) and
    would pay a merge level more.  ``q`` is the counts table's chunk
    (:func:`counts_table`'s, by default), so that the choice here is the
    one K2's wrapper makes on the same shape."""
    run = plan.passes[-1].s & -plan.passes[-1].s
    if leaf_merge_geometry(plan.seg, run if q is None else q, run, nplanes,
                           int(has_values)):
        return plan.n_segments, plan.seg
    cap = min(1 << 15, leaf_tile_cap(nplanes, has_values))
    pack = 1
    while (pack * 2 * plan.seg <= cap
           and plan.n_segments % (pack * 2) == 0):
        pack *= 2
    return plan.n_segments // pack, pack * plan.seg


@functools.lru_cache(maxsize=128)
def _plan_cached(n: int, begin_bit: int, end_bit: int, leaf_profile: str,
                 kwargs: Tuple[Tuple[str, int], ...]):
    """The plan for n keys sorted by bits [begin_bit, end_bit) with the
    ``leaf_profile`` ("raw" or "packed") leaf.  ``plan_msd`` is pure, and
    its search costs about 10 ms of host Python at 2^28 (the JAX engine
    pays it once per trace); uncached it would run before every sort's
    first launch."""
    return plan_msd(n, begin_bit, end_bit, leaf_profile=leaf_profile,
                    **dict(kwargs))


def _idx_bits(seg: int) -> int:
    """Width of the leaf's position field: it has headroom above seg - 1,
    so an invalid slot's all-ones sorts strictly after every valid slot of
    its segment, and a valid position is never all-ones."""
    idx_bits = (seg - 1).bit_length()
    return idx_bits + 1 if seg >= (1 << idx_bits) else idx_bits


def leaf_is_wide(plan: MsdPlan) -> bool:
    """Whether the general leaf's (remainder, position) word would not fit
    32 bits with a bit to spare, so that the leaf runs on K2."""
    return plan.rem_width + _idx_bits(plan.seg) + 1 > 32


@spanned("tpusort.leaf.pack")
def packed_leaf_rows(
    ops: List[torch.Tensor], nplanes: int, ctable: torch.Tensor, q: int,
    plan: MsdPlan,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """K3's operands for the narrow general leaf (port of the packed branch
    of ``_leaf_sort``): rows of whole final segments, operand 0 the packed
    word ``segment | rem << idx_bits | position`` (all-ones in
    rem | position for invalid slots), then every operand of ``ops``.
    Empties ``ops``.  Returns (rows, (nseg,) int32 valid counts)."""
    nseg, seg = plan.n_segments, plan.seg
    dev = ops[0].device
    ct = ctable.reshape(nseg, seg // q)
    idx_bits = _idx_bits(seg)
    # pack whole segments per K3 row while the segment id fits the word
    pack = 1
    while (pack * 2 * seg <= 16384 and nseg % (pack * 2) == 0
           and (pack * 2 - 1).bit_length() + plan.rem_width + idx_bits <= 32):
        pack *= 2
    valid = (torch.arange(q, device=dev)[None, None, :]
             < ct[:, :, None]).reshape(nseg, seg)
    field = plan.rem_width + idx_bits
    # int32 throughout: rem | position fits 31 bits, so only the segment
    # id, or-ed in last as a per-row bit pattern, reaches the sign bit
    rem = torch.zeros((nseg, seg), dtype=torch.int32, device=dev)
    for i, p in enumerate(ops[:nplanes]):
        base = 32 * (nplanes - 1 - i)
        lo = max(plan.rem_lo, base)
        hi = min(plan.rem_lo + plan.rem_width, base + 32)
        if hi > lo:       # the arithmetic shift's sign bits are masked off
            rem |= ((p.reshape(nseg, seg) >> (lo - base))
                    & ((1 << (hi - lo)) - 1)) << (lo - plan.rem_lo)
    key = torch.where(valid, (rem << idx_bits)
                      | torch.arange(seg, dtype=torch.int32, device=dev),
                      (1 << field) - 1)
    del rem, valid
    segid = (torch.arange(nseg, device=dev) % pack) << field
    key |= (segid - ((segid >> 31) << 32)).to(torch.int32)[:, None]
    rows = (nseg // pack, pack * seg)
    to_sort = [key.reshape(rows)] + [o.reshape(rows) for o in ops]
    ops.clear()
    return to_sort, ct.sum(dim=1, dtype=torch.int32)


def wide_leaf_operands(
    ops: List[torch.Tensor], nplanes: int, ctable: torch.Tensor, q: int,
    plan: MsdPlan,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """K2's operands for the wide general leaf, one final segment a tile:
    the range-masked key planes and the segment position as key planes,
    then every operand of ``ops`` as payloads.  Empties ``ops``.  Returns
    (operands, (nseg, seg // q) counts table)."""
    nseg, seg = plan.n_segments, plan.seg
    tiled = [o.reshape(nseg, seg) for o in ops]
    ops.clear()
    masked = _mask_plane_bits(tuple(tiled[:nplanes]), plan.rem_lo,
                              plan.rem_lo + plan.rem_width, 32 * nplanes)
    pos = torch.arange(seg, dtype=torch.int32,
                       device=tiled[0].device).expand(nseg, seg)
    return [*masked, pos, *tiled], ctable.reshape(nseg, seg // q)


def key_from_sortkey(plan: MsdPlan, nplanes: int) -> bool:
    """Whether the packed leaf can rebuild the key plane from its sorted
    word instead of carrying it (JAX's ``key_from_sortkey``): one plane,
    whose passes, each at its full digit width, and remainder cover all 32
    bits, so that a final segment's index is the key's prefix."""
    return (nplanes == 1 and plan.rem_lo == 0
            and sum(sp.width for sp in plan.passes) + plan.rem_width == 32
            and all(sp.width == sp.r.bit_length() - 1 for sp in plan.passes))


def sort_segments(
    ops: List[torch.Tensor], nplanes: int, ctable: torch.Tensor, q: int,
    plan: MsdPlan,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Sort each final segment stably by its remaining key bits: the leaf
    without the collapse (port of ``tpusort/ops/msd.py:_leaf_sort``).
    ``ops``: the last pass's flat runs, ``nplanes`` key planes then payload
    words, valid where the counts table (``ctable``, ``q``) says; the list
    is emptied.  Returns ((nseg, seg) int32 tensors, one per operand, each
    segment's valid slots sorted at its head and unspecified words behind
    them; the (nseg,) int32 valid counts).

    Where the word fits (:func:`leaf_is_wide` false), K3 sorts the
    :func:`packed_leaf_rows`; when :func:`key_from_sortkey` holds the key
    plane does not ride, and is rebuilt from the sorted word as the
    segment index above its remainder bits.  Otherwise K9 sorts each
    segment by the range-masked planes and the position
    (:func:`wide_leaf_operands`; JAX sorts them with ``lax.sort``, outside
    any kernel).
    """
    nseg, seg = plan.n_segments, plan.seg
    if leaf_is_wide(plan):
        operands, ct = wide_leaf_operands(ops, nplanes, ctable, q, plan)
        out = sort_tiles_counts(operands, ct, q, num_keys=nplanes + 1)
        return out[nplanes + 1:], ct.sum(dim=1, dtype=torch.int32)
    rows, seg_counts = packed_leaf_rows(ops, nplanes, ctable, q, plan)
    rebuild = key_from_sortkey(plan, nplanes)
    if rebuild:
        del rows[1]                      # the key plane, rebuilt below
    out = [o.reshape(nseg, seg) for o in sort_tiles(rows)]
    del rows
    if not rebuild:
        return out[1:], seg_counts
    # the word's remainder field; its segment id and the arithmetic
    # shift's sign bits are masked off
    rem = (out[0] >> _idx_bits(seg)) & ((1 << plan.rem_width) - 1)
    prefix = torch.arange(nseg, dtype=torch.int64,
                          device=rem.device) << plan.rem_width
    prefix = (prefix - ((prefix >> 31) << 32)).to(torch.int32)
    return [rem | prefix[:, None], *out[1:]], seg_counts


@spanned("tpusort.leaf")
def _leaf_sort(
    ops: List[torch.Tensor], nplanes: int, ctable: torch.Tensor, q: int,
    plan: MsdPlan, n: int,
) -> List[torch.Tensor]:
    """The general path's leaf (port of ``_leaf_sort`` and the collapse
    after it): each final segment sorted stably by its remaining key bits
    [rem_lo, rem_lo + rem_width), and the segments' valid prefixes written
    densely.  ``ops``: the last pass's flat runs, ``nplanes`` key planes
    then payload words, valid where the counts table (``ctable``, ``q``)
    says; the list is emptied so that the pass buffers can go once the
    leaf has read them.  Returns the (n,) outputs, one per operand.

    Within a segment the valid slots hold input order (K1c is stable), so
    the segment-local position breaks ties in input order.  Where
    (remainder, position) fits one word with a bit to spare, the packed
    leaf (:func:`packed_leaf`) sorts each segment.  Otherwise (the wide
    remainder) K2 sorts each segment by the range-masked planes plus the
    position (:func:`wide_leaf_operands`), which is unique, and writes the
    dense output itself.  The packed branch counts ``packed_leaf_bytes``
    as the rows move them, whichever body runs: 8 B a valid key for each
    of K3's operands on the rows (the word, then every operand but a key
    plane rebuilt from the word) and each of K4's.
    """
    if leaf_is_wide(plan):
        operands, ct = wide_leaf_operands(ops, nplanes, ctable, q, plan)
        outs = sort_tiles_counts_collapsed(operands, ct, q, n,
                                           num_keys=nplanes + 1)
        return outs[nplanes + 1:]
    k3_ops = 1 + len(ops) - key_from_sortkey(plan, nplanes)
    count("packed_leaf_bytes", 8 * n * (k3_ops + len(ops)))
    return packed_leaf(ops, nplanes, ctable, q, plan, n)


def packed_leaf(
    ops: List[torch.Tensor], nplanes: int, ctable: torch.Tensor, q: int,
    plan: MsdPlan, n: int,
) -> List[torch.Tensor]:
    """The narrow general leaf: each final segment sorted stably by its
    remainder bits and the segments' valid prefixes written dense, as
    :func:`_leaf_sort` takes them (``ops`` emptied).  On a card, where
    :func:`kernels.bitonic.leaf_runs_geometry` takes the segment's shape,
    K3's runs body (:func:`kernels.bitonic.sort_leaf_runs`) reads each
    segment straight from the last pass's runs, sorts its valid slots by
    the remainder word and their compact index, which rises with input
    order as the position does, and writes it dense: the order of the
    rows, bit for bit, with no row built.  Elsewhere, and on the CPU, the
    rows: :func:`sort_segments` (the row build, K3 on the rows), then
    K4."""
    nseg, seg = plan.n_segments, plan.seg
    if ops[0].device.type == "cuda" and \
            leaf_runs_geometry(seg, q, nplanes, len(ops)):
        tiled = [o.reshape(nseg, seg) for o in ops]
        ops.clear()
        return sort_leaf_runs(tiled, ctable.reshape(nseg, seg // q), q, n,
                              num_keys=nplanes, rem_lo=plan.rem_lo,
                              rem_width=plan.rem_width)
    return collapse_segments(*sort_segments(ops, nplanes, ctable, q, plan),
                             n)


def packed_leaf_plain(
    ops: Sequence[torch.Tensor], nplanes: int, ctable: torch.Tensor, q: int,
    plan: MsdPlan, n: int,
) -> List[torch.Tensor]:
    """Plain PyTorch :func:`packed_leaf` on any device, the version its
    runs body is held to: :func:`packed_leaf_rows`, K3's and K4's plain
    versions (``ops`` is not emptied)."""
    rows, seg_counts = packed_leaf_rows(list(ops), nplanes, ctable, q, plan)
    out = sort_tiles_plain(rows)
    del rows
    return collapse_segments_plain(
        [o.reshape(plan.n_segments, plan.seg) for o in out[1:]], seg_counts,
        n)


@spanned("tpusort.leaf")
def raw_leaf(data: Sequence[torch.Tensor], ctable: torch.Tensor, q: int,
             plan: MsdPlan, nplanes: int, n: int) -> List[torch.Tensor]:
    """The raw path's leaf: K2 over tiles of whole final segments of the
    last pass's runs (``nplanes`` key planes then payload words), which
    are ascending in chunks of the largest power of two dividing the last
    S.  Returns the dense (n,) outputs."""
    nt, tile = leaf_tiles(plan, nplanes, len(data) > nplanes, q)
    last_s = plan.passes[-1].s
    return sort_tiles_counts_collapsed(
        [o.reshape(nt, tile) for o in data],
        ctable.reshape(nt, tile // q), q, n,
        sorted_run=(last_s & -last_s), num_keys=nplanes,
    )


# ---------------------------------------------------------------------------
# The per-phase engine: partition passes with the histogram, starts and
# sortkey in plain PyTorch and K8 between them (``utils/profiling.py``)
# ---------------------------------------------------------------------------


def _valid_mask(run_counts: torch.Tensor, s_prev: int, t: int,
                k: int) -> torch.Tensor:
    """(T, K) bool validity from the previous pass's run counts (port of
    ``_valid_mask``): the element at flat position p is valid iff
    p mod S_prev < run_counts[p div S_prev]."""
    pos = torch.arange(s_prev, dtype=torch.int32, device=run_counts.device)
    return (pos[None, :] < run_counts.reshape(-1, 1)).reshape(t, k)


def initial_run_counts(n: int, plan: MsdPlan,
                       device=None) -> torch.Tensor:
    """Pass 0's run counts for n keys padded to plan.m1: one run a tile
    of K slots, the first n slots valid ((m1 // K,) int32)."""
    k0 = plan.passes[0].k
    return (n - torch.arange(plan.m1 // k0, device=device) * k0) \
        .clamp(0, k0).to(torch.int32)


def pass_sortkey(
    planes: Sequence[torch.Tensor], run_counts: torch.Tensor, s_prev: int,
    spec: PassSpec,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8's inputs for one pass over the (T, K) tiles of the key planes
    (the plain PyTorch part of JAX's ``_partition_pass``): validity from
    the previous pass's run counts, each tile's (T, R) int32 digit counts
    and their exclusive cumsum (the run starts), and the (T, K) int32
    sortkey (digit, or R where invalid) << log2(K) | slot.  Returns
    (sortkey, starts, counts)."""
    t, k, r = spec.n_seg * spec.t_seg, spec.k, spec.r
    if (r + 1) * k > 1 << 32:
        raise ValueError("sortkey overflow: (r+1) * K must fit in 32 bits")
    valid = _valid_mask(run_counts, s_prev, t, k)
    digit = torch.where(valid, extract_bits(planes, spec.lo_bit, spec.width),
                        r)
    del valid
    # JAX sums a one-hot (T, K, R) array; R + 1 bins, R for the invalid
    # slots, give the same counts without it (8.6 G elements at 2^28)
    counts = _histogram(digit, r + 1)[:, :r].contiguous()
    starts = torch.cumsum(counts, dim=1, dtype=torch.int32) - counts
    key = (digit << (k.bit_length() - 1)) | torch.arange(k,
                                                         device=digit.device)
    del digit
    return (key - ((key >> 31) << 32)).to(torch.int32), starts, counts


def _exchange(o: torch.Tensor, spec: PassSpec) -> torch.Tensor:
    """Digit-major exchange within each segment: the (T, R*S) tile-major
    runs, flat, run d of tile (seg, j) at [seg, d, j].  A copy here (free
    in XLA's fused pass)."""
    return o.reshape(spec.n_seg, spec.t_seg, spec.r, spec.s) \
        .transpose(1, 2).reshape(-1)


def _partition_pass(
    ops: List[torch.Tensor], planes_slice: slice, run_counts: torch.Tensor,
    s_prev: int, spec: PassSpec,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """One MSD partition pass over flat int32 operands, [plane0, plane1?,
    values...], valid where the previous pass's ``run_counts`` (runs of
    ``s_prev`` slots; pass 0: of K slots, from n) say (port of
    ``tpusort/ops/msd.py:_partition_pass``): :func:`pass_sortkey`, then K8
    (``partition_tiles``: the kernel on a card, its plain version on the
    CPU; JAX's ``use_pallas``), then :func:`_exchange`.  Returns (the
    exchanged runs of every operand, flat; their (n_seg*R*t_seg,) int32
    counts clipped to S; a 0-d bool overflow flag on the device)."""
    t = spec.n_seg * spec.t_seg
    tiled = [o.reshape(t, spec.k) for o in ops]
    sortkey, starts, counts = pass_sortkey(tiled[planes_slice], run_counts,
                                           s_prev, spec)
    overflow = (counts > spec.s).any()
    out = partition_tiles([sortkey, *tiled], starts, r=spec.r, s=spec.s)
    del sortkey, tiled
    return ([_exchange(o, spec) for o in out], exchanged_counts(counts, spec),
            overflow)


def sort_windows_msd(
    planes: Tuple[torch.Tensor, ...],
    values: Sequence[torch.Tensor],
    *,
    window_counts: torch.Tensor,
    window: int,
    n: int,
    total_bits: int,
    plan_kwargs: Optional[dict] = None,
    config=None,
):
    """Finish a padded layout of windows that are already sorted (port of
    ``tpusort.ops.msd.sort_windows_msd``).

    The inputs are flat (m0,) int32 operands, m0 = n_windows * window,
    ``nplanes`` key planes then payload words; window w holds a sorted
    valid prefix of ``window_counts[w]`` slots ((n_windows,) integers on
    the operands' device), then unspecified words.  The window counts seed
    the validity chain at tile granularity, pass 0 runs K1 with
    ``sorted_run`` = K, which only emits (the tile is already one sorted
    run), the later passes merge, and the raw leaf (K2, :func:`raw_leaf`)
    writes the dense (n,) result.  Keys only or unstable pairs; with
    payloads the caller checks for valid keys equal to the all-ones
    sentinel (the global sort does).  A tile of pass 0 is a slice of one
    window's sorted run, so a window of more than about one tile of keys
    crowds a few digits and overflows, as JAX's does.

    Returns ``(ops, overflow)``, ops = [planes..., values...] dense (n,)
    and the flag a 0-d bool tensor on the device, or ``None`` where the
    geometry admits no plan (the caller then compacts and sorts).  The
    leaf packs whole segments as :func:`leaf_tiles` does, so a tile fits
    K2's shared memory (JAX packs up to 2^15 slots).
    """
    nplanes = len(planes)
    ops = [*planes, *values]
    m0 = ops[0].shape[0]
    if plan_kwargs is None and config is not None:
        plan_kwargs = config.plan_kwargs()
    kwargs = dict(plan_kwargs or {})
    kwargs.pop("min_n", None)
    kwargs.setdefault("leaf_profile", "raw")
    k = kwargs.get("k", 1 << 16)
    if nplanes > MAX_PLANES or total_bits != 32 * nplanes:
        return None
    if m0 % k or window % k or m0 // window < 1:
        return None
    plan = plan_msd(n, 0, total_bits, t1_force=m0 // k, **kwargs)
    if plan is None or plan.m1 != m0:
        return None
    # tile j of window w holds clip(count_w - j*K, 0, K) valid slots as a
    # prefix (tiles never straddle windows: window % K == 0)
    tiles_per_w = window // k
    c0 = (window_counts.to(torch.int32)[:, None]
          - torch.arange(tiles_per_w, dtype=torch.int32,
                         device=window_counts.device)[None, :] * k
          ).clamp(0, k).reshape(-1)
    data, (ctable, q), overflow = run_passes(
        ops, nplanes, n, plan, unstable=bool(values), init_chain=(c0, k, k))
    del ops
    return raw_leaf(data, ctable, q, plan, nplanes, n), overflow


def sort_twiddled_msd(
    planes: Tuple[torch.Tensor, ...],
    values: Sequence[torch.Tensor] = (),
    *,
    begin_bit: int,
    end_bit: int,
    total_bits: int,
    config,
    stable: bool = True,
    strided: bool = False,
):
    """Ascending sort of twiddled int32 planes (plane 0 most significant)
    by the unsigned value of bits [begin_bit, end_bit), with int32 payload
    words, on the tensors' device (port of
    ``tpusort.ops.msd.sort_twiddled_msd`` in its ``on_overflow="flag"``
    mode).  Returns (sorted planes, sorted values, overflow); the planes
    come back whole, bits outside the range included.  ``overflow`` is a
    0-d bool tensor on the device, set where a run overflowed its
    capacity and the output is then not sorted, or None where the input
    went to an exact sort.  The engine takes no fallback: its callers
    state theirs through ``ops.tiers``.

    Full-range keys only (1-3 planes), unstable pairs (``stable=False``)
    and stable pairs of one-plane keys run K1 and K2 on the raw key
    planes.  With payloads both compare equal keys by slot index and rank
    an invalid slot after every valid one (a valid all-ones key included),
    and slot order is input order on the contiguous feed, so the result
    is the stable order.  Everything else, bit ranges and stable pairs of
    multi-plane keys, takes the general path: K1c passes, which keep input
    order within a digit, then :func:`_leaf_sort`; it is stable, keys only
    or not.  Delegates to the single-tile path or the reference sort below
    ``config.min_n`` or when no plan exists.

    Keys-only bit-range sorts take K1c, not JAX's route: the Pallas engine
    sends them to its raw-key branch, which sorts each tile by the whole
    key and so loses input order within the range (ROADMAP Queue 3).

    ``strided=True`` (the raw path only; not in JAX) lays pass 0's input
    out in strided tiles (:func:`strided_feed`), so that each tile mirrors
    the whole input: for inputs made of long ascending runs, whose
    contiguous tiles would each fall into a few digits and overflow.  The
    global sort's finish sorts such inputs (the received runs).  The
    strided tiles break input order, so stable pairs with it take the
    general path.
    """
    nplanes = len(planes)
    full = begin_bit == 0 and end_bit == total_bits == 32 * nplanes
    n = planes[0].shape[0]
    # stable one-plane pairs: K1 and K2 keep slot order, which is input
    # order on the contiguous feed (not the strided one)
    raw = full and nplanes <= MAX_PLANES and (
        not values or not stable or (nplanes == 1 and not strided))
    bits = dict(begin_bit=begin_bit, end_bit=end_bit, total_bits=total_bits)
    kwargs = config.plan_kwargs()
    min_n = kwargs.pop("min_n")
    plan = _plan_cached(n, begin_bit, end_bit, "raw" if raw else "packed",
                        tuple(sorted(kwargs.items()))) if n >= min_n else None
    if plan is None:
        if (not values or not stable) and \
                single_tile_ok(planes, values, config=config, **bits):
            sp, sv = sort_twiddled_bitonic(planes, values, config=config,
                                           **bits)
        else:
            count_route("reference_routes")
            sp, sv = sort_twiddled_reference(planes, values, **bits)
        return sp, sv, None
    # The host reads the overflow flag, so no fallback workspace is
    # reserved in advance and the JAX engine's 2^29 in-graph cap does not
    # apply.
    init = None
    if strided and raw:
        ops, ctable0 = strided_feed([*planes, *values], n, plan)
        init = (ctable0, 128, None)
    else:
        ops = [torch.nn.functional.pad(o, (0, plan.m1 - n))
               if plan.m1 > n else o for o in (*planes, *values)]
    data, (ctable, q_fin), overflow = run_passes(
        ops, nplanes, n, plan, unstable=raw and bool(values),
        general=not raw, init_chain=init)
    del ops
    outs = (raw_leaf(data, ctable, q_fin, plan, nplanes, n) if raw
            else _leaf_sort(data, nplanes, ctable, q_fin, plan, n))
    del data, ctable                     # free the pass buffers first
    return tuple(outs[:nplanes]), tuple(outs[nplanes:]), overflow
