"""K1, K1b and K1c: the fused MSD partition pass, raw-key, splitter and
general branches; K8: the tile partition by a caller's sortkey.

PyTorch port of ``tpusort/kernels/partition.py:partition_pass_fused``:

* the raw-key branch (K1) sorts each tile by 1-3 key planes, with payload
  words riding along; on a CUDA tensor it launches
  ``csrc/partition.cu``: the register network of ``csrc/reg_sort.cuh``
  per tile, laid out by ``kernels/bitonic.py:tile_sort_geometry``; or,
  where the tile arrives as sorted runs under a counts table (passes 1
  and 2), K2's merge of the runs' valid prefixes
  (:func:`partition_merge_geometry`, ``csrc/merge_runs.cuh``); or, where
  no sorted run arrives (pass 0), each warp's run sorted in registers and
  on shuffles and the runs merged as passes 1 and 2 merge them
  (:func:`partition_runs_geometry`).  With payloads equal keys keep their
  slot order, by a slot index under the last plane, and invalid slots
  sort after every valid one: the tile's order is the stable one, in both
  versions and all three bodies;
* its splitter mode (K1b, the equi-depth skew tier) sorts each tile the
  same way and cuts the runs at per-tile splitters instead of digit
  boundaries; on a CUDA tensor it launches the same kernel's splitter
  template (``csrc/partition.cu``);
* the general branch (K1c) partitions each tile stably by its digit, with
  planes and payload words riding in input order; on a CUDA tensor it
  launches ``csrc/partition_general.cu`` (a blocked stable rank, no sort,
  and the runs staged in shared memory so that their stores coalesce).

K8 (:func:`partition_tiles`, the port of ``partition_tiles``) orders each
tile stably by a sortkey its caller built and cuts the data operands at
the caller's run starts; on a CUDA tensor it launches
``csrc/partition_tiles.cu`` (a blocked stable rank of the sortkey's varying
bits, no sort, and the runs staged in shared memory).

See those files for the designs and what bounds them.  On a CPU tensor
the wrapper runs the plain PyTorch version of the same contract
(:func:`partition_pass_fused_plain`, :func:`partition_pass_splitter_plain`,
:func:`partition_pass_general_plain`, :func:`partition_tiles_plain`), which
the tests hold against the Pallas kernel and the card holds the CUDA
kernels against.
"""

from __future__ import annotations

import collections
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from tpusort_torch.dtypes import INT32_MIN
from tpusort_torch.kernels import _build
from tpusort_torch.ops.reference import sort_rows_lex
from tpusort_torch.utils.log import count

MAX_TILE = 1 << 15     # the slot index is 16-bit; 128 KB a key plane
MAX_RADIX = 256        # the kernel's shared-memory histogram
MAX_PLANES = 3         # key planes the kernels compare
MAX_VALUES = 8         # payload words per launch
MAX_OPERANDS = 16      # planes + payload words of a K1c or K4 launch
MAX_RUNS = 128         # K8's runs a tile: the Pallas kernel's one lane row
SMEM_MAX = 232_448     # dynamic + static shared memory of one CTA (sm_90)
# K1's static shared memory (two arrays of MAX_RADIX ints and a count) as
# ptxas lays it out (csrc/partition.cu: kStaticSmem)
K1_STATIC_SMEM = 2064


def tile_smem_bytes(slots: int, num_keys: int, has_values: bool) -> int:
    """Dynamic shared memory of a kernel tile: 4 bytes a slot for each key
    plane, plus a 2-byte slot index when payloads ride."""
    return slots * (4 * num_keys + (2 if has_values else 0))


def check_fits(what: str, slots: int, num_keys: int, n_values: int,
               static_smem: int = 0) -> None:
    """Raise ValueError unless a CUDA kernel's tile of ``slots`` slots with
    ``num_keys`` key planes and ``n_values`` payload words fits one CTA."""
    smem = tile_smem_bytes(slots, num_keys, n_values > 0) + static_smem
    if slots > MAX_TILE or num_keys > MAX_PLANES or n_values > MAX_VALUES \
            or smem > SMEM_MAX:
        raise ValueError(
            f"{what}: a tile of {slots} slots with {num_keys} key plane(s) "
            f"and {n_values} payload word(s) exceeds the kernel's shared "
            f"memory ({smem} of {SMEM_MAX} bytes) or operand limits")


def extract_bits(planes: Sequence[torch.Tensor], lo: int,
                 width: int) -> torch.Tensor:
    """Bits [lo, lo + width) of the multi-plane int32 key (plane 0 = most
    significant 32 bits), as int64 (port of ``_extract_bits_arrays``)."""
    nplanes = len(planes)
    out = torch.zeros(planes[0].shape, dtype=torch.int64,
                      device=planes[0].device)
    for i, p in enumerate(planes):
        base = 32 * (nplanes - 1 - i)
        ov_lo, ov_hi = max(lo, base), min(lo + width, base + 32)
        if ov_hi > ov_lo:
            chunk = ((p.to(torch.int64) & 0xFFFFFFFF) >> (ov_lo - base)) \
                & ((1 << (ov_hi - ov_lo)) - 1)
            out |= chunk << (ov_lo - lo)
    return out


def _valid(keys: torch.Tensor, counts_in: Optional[torch.Tensor],
           q_in: Optional[int], n: Optional[int]) -> torch.Tensor:
    """(T, K) validity: from the global index vs n (pass 0) or from the
    counts table (subrun i of q_in slots holds counts_in[t, i] valid
    slots as a prefix)."""
    T, K = keys.shape
    if counts_in is None:
        return (torch.arange(T * K, device=keys.device) < n).reshape(T, K)
    sub = torch.arange(K, device=keys.device) % q_in
    return sub[None, :] < counts_in.repeat_interleave(q_in, dim=1)


def sort_valid_rows(planes: Sequence[torch.Tensor],
                    values: Sequence[torch.Tensor], valid: torch.Tensor
                    ) -> Tuple[Tuple[torch.Tensor, ...],
                               Tuple[torch.Tensor, ...]]:
    """Each (T, K) row sorted by its key planes with the invalid slots'
    planes rewritten to all-ones, payloads carried along, stably: the tile
    sort of the kernels with a validity source.  With payloads an invalid
    slot sorts after every valid one, a valid all-ones key included (its
    slot index in the kernels is 0xFFFF, ``csrc/reg_sort.cuh:kPadIndex``):
    here by a least significant plane of the slot's invalidity."""
    keys = [torch.where(valid, p, -1) for p in planes]
    if not values:
        return sort_rows_lex(keys)
    sp, sv = sort_rows_lex([*keys, (~valid).to(torch.int32)], values)
    return sp[:-1], sv


def partition_pass_fused_plain(
    planes: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    counts_in: Optional[torch.Tensor],
    *,
    q_in: Optional[int],
    n: Optional[int],
    r: int,
    s: int,
    lo_bit: int,
    width: int,
    t_seg: int,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch K1 on (T, K) int32 planes and values: returns (flat
    exchanged runs (T*R*S,) per operand, counts (T, R) int32).  Slots past
    a run's count hold unspecified words, as in the kernel; ties keep
    their input order (any order is legal)."""
    valid = _valid(planes[0], counts_in, q_in, n)
    sp, sv = sort_valid_rows(planes, values, valid)
    n_valid = valid.sum(dim=1, dtype=torch.int32)
    hist = _histogram(extract_bits(sp, lo_bit, width), r)
    start = torch.cumsum(hist, dim=1, dtype=torch.int32) - hist
    counts = hist.clone()
    counts[:, r - 1] = n_valid - start[:, r - 1]
    return _emit_runs((*sp, *sv), start, s, t_seg), counts


def _dither(T: int, r: int, device) -> torch.Tensor:
    """(T, R-1) int64: the Pallas kernel's per-(tile, boundary) rounding
    offset in [0, 2^16), from the int32 hash of tile t and boundary d,
    computed mod 2^32 (only bits 15-30 of the sum survive)."""
    t = torch.arange(T, dtype=torch.int64, device=device)[:, None]
    d = torch.arange(1, r, dtype=torch.int64, device=device)[None, :]
    h = (t * 0x9E3779B9 + ((d * 0x85EBCA6B) & 0x7FFFFFFF)) & 0xFFFFFFFF
    return (h >> 15) & 0xFFFF


def _lex_below(sorted_planes: Sequence[torch.Tensor],
               words: Sequence[torch.Tensor]) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """(#slots < w, #slots <= w) per row, lexicographically over the planes
    (unsigned), of (T, K) planes against (T,) words, over every slot."""
    lt = eq = None
    for p, w in zip(sorted_planes, words):
        x = p ^ INT32_MIN
        y = (w ^ INT32_MIN)[:, None]
        l_, e_ = x < y, x == y
        lt, eq = (l_, e_) if lt is None else (lt | (eq & l_), eq & e_)
    a = lt.sum(dim=1)
    return a, a + eq.sum(dim=1)


def partition_pass_splitter_plain(
    planes: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    counts_in: Optional[torch.Tensor],
    *,
    splitters: Sequence[torch.Tensor],
    splitter_fracs: torch.Tensor,
    q_in: Optional[int],
    n: Optional[int],
    r: int,
    s: int,
    t_seg: int,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch K1b on (T, K) int32 planes and values, with one
    (T, R-1) int32 splitter word array per plane and (T, R-1) tie fractions
    (16-bit fixed point, read as unsigned): each tile sorted as in
    :func:`partition_pass_fused_plain`, then cut at the Pallas kernel's
    points (``tpusort/kernels/partition.py:214-313``).  Boundary d may cut
    anywhere in [a_d, b_d] = [#slots < s_d, #slots <= s_d], counted over
    every slot, invalid ones (all-ones) included; it aims at a_d + frac *
    (b_d - a_d) with a dithered rounding, clipped to [max(a_d, prev),
    prev + S] and n_valid, then a backward sweep raises cuts within b_d so
    the top run fits S.  A tile whose cut left its range, or whose top run
    exceeds S, gets count 0 = K + 1.  Returns (flat exchanged runs per
    operand, counts (T, R) int32)."""
    valid = _valid(planes[0], counts_in, q_in, n)
    sp, sv = sort_valid_rows(planes, values, valid)
    T, K = sp[0].shape
    dev = sp[0].device
    n_valid = valid.sum(dim=1)
    fd = splitter_fracs.to(torch.int64) & 0xFFFFFFFF
    u = _dither(T, r, dev)
    cuts = [torch.zeros(T, dtype=torch.int64, device=dev)]
    bounds = [None]
    flag = torch.zeros(T, dtype=torch.bool, device=dev)
    for d in range(1, r):
        a, b = _lex_below(sp, [w[:, d - 1] for w in splitters])
        lo = torch.maximum(a, cuts[-1])
        hi = cuts[-1] + s
        flag |= lo > hi
        f = fd[:, d - 1]
        prod = ((f.clamp(max=0xFFFF) * (b - a) + u[:, d - 1])
                & 0xFFFFFFFF) >> 16
        tgt = torch.where(f >= 1 << 16, b, a + prod)
        cuts.append(torch.minimum(torch.minimum(torch.maximum(tgt, lo), hi),
                                  n_valid))
        bounds.append(b)
    cuts.append(n_valid)
    for d in range(r - 1, 0, -1):
        cuts[d] = torch.maximum(cuts[d],
                                torch.minimum(cuts[d + 1] - s, bounds[d]))
    start = torch.stack(cuts[:r], dim=1)
    counts = torch.stack(cuts[1:], dim=1) - start
    flag |= counts[:, r - 1] > s
    counts[:, 0] = torch.where(flag, K + 1, counts[:, 0])
    return (_emit_runs((*sp, *sv), start.to(torch.int32), s, t_seg),
            counts.to(torch.int32))


def _histogram(digit: torch.Tensor, bins: int) -> torch.Tensor:
    """(T, bins) int32 counts of each row's int64 digits."""
    return torch.zeros(digit.shape[0], bins, dtype=torch.int32,
                       device=digit.device).scatter_add_(
        1, digit, torch.ones_like(digit, dtype=torch.int32))


def _emit_runs(sorted_ops: Sequence[torch.Tensor], start: torch.Tensor,
               s: int, t_seg: int) -> List[torch.Tensor]:
    """Cut each sorted (T, K) tile into R runs of S slots from ``start``
    ((T, R) int32) and lay them out digit-major, run d of tile (seg, j) at
    out[seg, d, j]; slots past the tile's end repeat its last slot."""
    T, K = sorted_ops[0].shape
    r = start.shape[1]
    idx = (start[:, :, None]
           + torch.arange(s, device=start.device, dtype=torch.int32))
    idx = idx.clamp(max=K - 1).reshape(T, r * s).long()
    return [torch.gather(o, 1, idx).reshape(T // t_seg, t_seg, r, s)
            .transpose(1, 2).reshape(-1) for o in sorted_ops]


def _general_digit(planes: Sequence[torch.Tensor], valid: torch.Tensor,
                   digit: Optional[torch.Tensor], r: int, lo_bit: int,
                   width: int) -> torch.Tensor:
    """(T, K) int64 digit of each slot: key bits [lo_bit, lo_bit + width)
    or the caller's digit plane (as unsigned); R where the slot is invalid
    or the digit is not below R."""
    d = extract_bits(planes, lo_bit, width) if digit is None else \
        digit.to(torch.int64) & 0xFFFFFFFF
    return torch.where(valid & (d < r), d, r)


def partition_pass_general_plain(
    planes: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    counts_in: Optional[torch.Tensor],
    *,
    q_in: Optional[int],
    n: Optional[int],
    r: int,
    s: int,
    lo_bit: int,
    width: int,
    t_seg: int,
    digit: Optional[torch.Tensor] = None,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch K1c on (T, K) int32 planes and values: each tile
    stably sorted by its digit (R for invalid slots, which drop out), then
    cut into runs exactly as :func:`partition_pass_fused_plain` cuts them.
    Returns (flat exchanged runs (T*R*S,) per operand, counts (T, R) int32
    = the valid slots of each digit).  Slots past a run's count hold
    unspecified words, as in the kernel."""
    valid = _valid(planes[0], counts_in, q_in, n)
    d = _general_digit(planes, valid, digit, r, lo_bit, width)
    order = torch.sort(d, dim=1, stable=True).indices
    counts = _histogram(d, r + 1)[:, :r].contiguous()
    start = torch.cumsum(counts, dim=1, dtype=torch.int32) - counts
    ops = [torch.gather(o, 1, order) for o in (*planes, *values)]
    return _emit_runs(ops, start, s, t_seg), counts


def _raw_geometry(K: int, num_keys: int, n_vals: int):
    """K1's and K1b's layout of a K-slot tile on its CTA for the network
    body: the row tile sorts' (``kernels/bitonic.py:tile_sort_geometry``),
    which imports this module, hence the import here."""
    from tpusort_torch.kernels.bitonic import tile_sort_geometry
    return tile_sort_geometry(K, num_keys, n_vals)


@functools.lru_cache(maxsize=None)
def partition_merge_geometry(K: int, q_in: Optional[int],
                             sorted_run: Optional[int], num_keys: int,
                             n_vals: int):
    """The geometry of K1's and K1b's merge body for (T, K) tiles with a
    counts table of ``q_in``-slot chunks and the caller's ``sorted_run``
    (``kernels/bitonic.MergeGeometry``), or None where they run another
    body.  Pure: it reads only the call's shape, so every caller gets the
    same body on the same shape.

    The merge body (``csrc/partition.cu: partition_sorted`` on K2's
    ``csrc/merge_runs.cuh``) loads each run's valid prefix alone and
    merges the runs, where the network sorts the whole padded tile.  It
    runs where the tile arrives as sorted runs under a counts table (a
    later pass: ``sorted_run`` > 0 and ``q_in``) that are not the whole
    tile (``sorted_run`` = K only emits, on the network body), on the
    geometry of K2's merge (:func:`kernels.bitonic.leaf_merge_geometry`:
    runs of L = min(sorted_run, q_in & -q_in) >= 128 slots, at most 256 a
    tile, the fewest threads that cover K at the planes' merge slots, at
    most 768), with the buffer beside K1's static arrays within a CTA.
    So at 2^28 passes 1 and 2 (K = 16,384, runs of 256 then 512) merge
    for keys, key + value and 2 planes + value (704 threads, about 205 KB);
    pass 0 takes the runs body (:func:`partition_runs_geometry`), and
    emit-only and 3 planes (1,024 threads at 16 slots) the network."""
    if not q_in or not sorted_run or sorted_run >= K:
        return None
    from tpusort_torch.kernels.bitonic import leaf_merge_geometry
    geo = leaf_merge_geometry(K, q_in, sorted_run, num_keys, n_vals)
    if geo is None or geo.smem_bytes + K1_STATIC_SMEM > SMEM_MAX:
        return None
    return geo


# csrc/partition.cu: the runs body's largest tile (kRunsMaxTile)
RUNS_MAX_TILE = 1 << 14


@functools.lru_cache(maxsize=None)
def partition_runs_geometry(K: int, sorted_run: Optional[int],
                            num_keys: int, n_vals: int):
    """The geometry of K1's and K1b's runs body for (T, K) tiles with the
    caller's ``sorted_run`` (``kernels/bitonic.MergeGeometry``: each
    warp's sorted run of ``run`` slots, ``threads``, ``slots`` a thread,
    the buffer's ``smem_bytes``), or None where they run another body.
    Pure: it reads only the call's shape, so every caller gets the same
    body on the same shape.

    The runs body (``csrc/partition.cu: sort_runs``) takes a tile that does
    not arrive as sorted runs (``sorted_run`` None or 0, with a counts
    table or without: pass 0 and the strided feed's pass 0): each warp
    sorts 32 x ``slots`` slots with ``csrc/reg_sort.cuh``'s register and
    shuffle steps alone, keeps its run's valid prefix in K2's merge buffer,
    and the runs are merged as the merge body merges them
    (``csrc/merge_runs.cuh``), where the network sorts the whole padded
    tile.  A thread sorts ``slots`` slots and holds as many outputs in each
    merge level: 32 where a slot is one register word (one plane, no
    payload), else 16; so a tile takes K / slots threads, from a warp up,
    and K is at most ``RUNS_MAX_TILE`` (64 registers a thread).  The warp
    runs are 1,024 or 512 slots, at most ``MERGE_MAX_RUNS`` a tile; one or
    two key planes (three would hold 48 key words of outputs a thread,
    past the registers); and the buffer,
    :func:`kernels.bitonic.merge_smem_bytes`, beside K1's static arrays
    within a CTA.  At 2^28 and 2^27 (K = 16,384) pass 0 runs here for keys
    (512 threads), key + value, 2 planes and 2 planes + value (1,024);
    emit-only (``sorted_run`` = K) and the later passes' sorted runs do
    not."""
    from tpusort_torch.kernels.bitonic import (MERGE_MAX_RUNS,
                                               MergeGeometry,
                                               merge_smem_bytes)
    if sorted_run or not 1 <= num_keys <= 2:
        return None
    slots = 32 if num_keys == 1 and not n_vals else 16
    run = 32 * slots
    threads = K // slots
    if K % run or K // run > MERGE_MAX_RUNS or K > RUNS_MAX_TILE \
            or threads < 32:
        return None
    smem = merge_smem_bytes(K, num_keys, n_vals > 0, K // run)
    if smem + K1_STATIC_SMEM > SMEM_MAX:
        return None
    return MergeGeometry(run, threads, slots, smem)


def _bodies(K: int, q_in: Optional[int], sorted_run: Optional[int],
            num_keys: int, n_vals: int):
    """(runs geometry, merge geometry, the launch's geometry) of a K1 or
    K1b launch: the runs body, else the merge body, else the network."""
    runs = partition_runs_geometry(K, sorted_run, num_keys, n_vals)
    merge = None if runs else partition_merge_geometry(
        K, q_in, sorted_run, num_keys, n_vals)
    return runs, merge, runs or merge or _raw_geometry(K, num_keys, n_vals)


def _partition_pass_cuda(
    planes: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    counts_in: Optional[torch.Tensor],
    *,
    q_in: Optional[int],
    n: Optional[int],
    r: int,
    s: int,
    lo_bit: int,
    width: int,
    t_seg: int,
    sorted_run: Optional[int],
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    T, K = planes[0].shape
    check_fits("partition_pass_fused", K, len(planes), len(values),
               K1_STATIC_SMEM)
    if r > MAX_RADIX:
        raise ValueError(f"R={r} exceeds the kernel's {MAX_RADIX} digits")
    if counts_in is not None:
        counts_in = counts_in.to(torch.int32).contiguous()
    dev = planes[0].device
    outs = [torch.empty(T * r * s, dtype=torch.int32, device=dev)
            for _ in range(len(planes) + len(values))]
    counts = torch.empty(T, r, dtype=torch.int32, device=dev)
    np_ = len(planes)
    runs, merge, geo = _bodies(K, q_in if counts_in is not None else None,
                               sorted_run, np_, len(values))
    err = _build.library().tpusort_partition_raw(
        _build.pointers(planes), _build.pointers(outs[:np_]), np_,
        _build.pointers(values), _build.pointers(outs[np_:]), len(values),
        None if counts_in is None else counts_in.data_ptr(),
        q_in or 0, -1 if n is None else n, T, K, r, s, lo_bit, width,
        t_seg, sorted_run or 0, merge.run if merge else 0,
        runs.run if runs else 0, geo.threads, geo.slots, geo.smem_bytes,
        counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "partition_pass_fused")
    # a tile that is one sorted run skips the network: K1 only emits
    _build.count_launch(partition_pass_fused, np_, len(values),
                        *(("runs",) if runs else
                          ("emit-only",) if sorted_run == K else
                          ("merge",) if merge else ()))
    if merge and n is not None:
        count("merge_bytes", 8 * n * (np_ + len(values)))
    return outs, counts


def _partition_pass_splitter_cuda(
    planes: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    counts_in: Optional[torch.Tensor],
    *,
    splitters: Sequence[torch.Tensor],
    splitter_fracs: torch.Tensor,
    q_in: Optional[int],
    n: Optional[int],
    r: int,
    s: int,
    t_seg: int,
    sorted_run: Optional[int],
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    T, K = planes[0].shape
    check_fits("partition_pass_fused (splitters)", K, len(planes),
               len(values), K1_STATIC_SMEM)
    if r > MAX_RADIX:
        raise ValueError(f"R={r} exceeds the kernel's {MAX_RADIX} runs")
    if counts_in is not None:
        counts_in = counts_in.to(torch.int32).contiguous()
    dev = planes[0].device
    outs = [torch.empty(T * r * s, dtype=torch.int32, device=dev)
            for _ in range(len(planes) + len(values))]
    counts = torch.empty(T, r, dtype=torch.int32, device=dev)
    np_ = len(planes)
    runs, merge, geo = _bodies(K, q_in if counts_in is not None else None,
                               sorted_run, np_, len(values))
    err = _build.library().tpusort_partition_splitter(
        _build.pointers(planes), _build.pointers(outs[:np_]), np_,
        _build.pointers(values), _build.pointers(outs[np_:]), len(values),
        None if counts_in is None else counts_in.data_ptr(),
        q_in or 0, -1 if n is None else n, T, K, r, s, t_seg,
        sorted_run or 0, merge.run if merge else 0, runs.run if runs else 0,
        _build.pointers(splitters), splitter_fracs.data_ptr(), geo.threads,
        geo.slots, geo.smem_bytes, counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "partition_pass_fused (splitters)")
    _build.count_launch(_partition_pass_splitter_cuda, np_, len(values),
                        *(("runs",) if runs else
                          ("merge",) if merge else ()))
    if merge and n is not None:
        count("merge_bytes", 8 * n * (np_ + len(values)))
    return outs, counts


# K1b launches are counted apart from K1's (``ops.msd.counters``)
_partition_pass_splitter_cuda.launches = 0
_partition_pass_splitter_cuda.modes = collections.Counter()


def _partition_pass_general_cuda(
    planes: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    counts_in: Optional[torch.Tensor],
    *,
    q_in: Optional[int],
    n: Optional[int],
    r: int,
    s: int,
    lo_bit: int,
    width: int,
    t_seg: int,
    digit: Optional[torch.Tensor],
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    T, K = planes[0].shape
    n_ops = len(planes) + len(values)
    # shared memory is 6 bytes a slot plus at most 16 KB for the digits
    # (csrc/partition_general.cu: GenSmem): any K up to MAX_TILE fits
    if K > MAX_TILE or n_ops > MAX_OPERANDS or r > MAX_RADIX:
        raise ValueError(
            f"partition_pass_fused (general): a tile of {K} slots with "
            f"{n_ops} operand(s) and R={r} exceeds the kernel's limits "
            f"({MAX_TILE} slots, {MAX_OPERANDS} operands, {MAX_RADIX} "
            "digits)")
    if counts_in is not None:
        counts_in = counts_in.to(torch.int32).contiguous()
    dev = planes[0].device
    ops = [*planes, *values]
    outs = [torch.empty(T * r * s, dtype=torch.int32, device=dev)
            for _ in ops]
    counts = torch.empty(T, r, dtype=torch.int32, device=dev)
    err = _build.library().tpusort_partition_general(
        _build.pointers(ops), _build.pointers(outs), n_ops, len(planes),
        None if digit is None else digit.data_ptr(),
        None if counts_in is None else counts_in.data_ptr(),
        q_in or 0, -1 if n is None else n, T, K, r, s, lo_bit, width, t_seg,
        counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "partition_pass_fused (general)")
    _build.count_launch(_partition_pass_general_cuda, len(planes),
                        len(values))
    return outs, counts


# K1c launches are counted apart from K1's (``ops.msd.counters``)
_partition_pass_general_cuda.launches = 0
_partition_pass_general_cuda.modes = collections.Counter()


def _splitter_operands(splitters, fracs, n_planes: int, T: int, r: int,
                       dev) -> List[torch.Tensor]:
    """The splitter word arrays, then the fractions, checked: (T, R-1)
    int32 on the keys' device, one word array per key plane."""
    spl = list(splitters) if isinstance(splitters, (list, tuple)) \
        else [splitters]
    if len(spl) != n_planes:
        raise ValueError("need one splitter word array per key plane")
    if fracs is None:          # greedy fill: ties pack earlier runs first
        fracs = torch.full((T, r - 1), 1 << 16, dtype=torch.int32,
                           device=dev)
    for a in (*spl, fracs):
        if a.dtype != torch.int32 or tuple(a.shape) != (T, r - 1) \
                or a.device != dev:
            raise ValueError(f"splitters and splitter_fracs must be "
                             f"({T}, {r - 1}) int32 tensors on the keys' "
                             "device")
    return [a.contiguous() for a in (*spl, fracs)]


def partition_pass_fused(
    planes: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    counts_in: Optional[torch.Tensor],
    *,
    r: int,
    s: int,
    lo_bit: int,
    width: int,
    q_in: Optional[int] = None,
    n: Optional[int] = None,
    sorted_run: Optional[int] = None,
    unstable: bool = False,
    t_seg: Optional[int] = None,
    digit: Optional[torch.Tensor] = None,
    splitters: Optional[torch.Tensor] = None,
    splitter_fracs: Optional[torch.Tensor] = None,
    general: bool = False,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One fused MSD partition pass over (T, K) int32 bit-pattern tiles of
    key planes (plane 0 most significant) and payload words.

    Validity comes from ``counts_in`` ((T, K // q_in) int32: subrun i of
    ``q_in`` slots holds counts_in[t, i] valid slots as a prefix), or, for
    pass 0 (``counts_in`` None), from the global slot index vs ``n``.  A
    merge-body launch counts its bytes at ``n`` valid keys (8 B a key and
    operand word, ``merge_bytes`` in ``utils.log.COUNTS``), so the callers
    give ``n`` to every pass; a launch without it is not counted.  The
    digit is bits [lo_bit, lo_bit + width) of the whole multi-plane key, or
    the caller's ``digit`` plane ((T, K) int32, values below ``r``).  With
    ``t_seg`` (tiles per digit segment) run d of tile (seg, j) goes to
    out[seg, d, j] and the runs come back flat (T*R*S,); without it,
    tile-major (T, R*S).  Returns (runs of every plane then every value,
    counts (T, R) int32); counts may exceed ``s``, and the caller checks
    overflow.  Slots past a run's count are unspecified.

    The branch follows JAX's routing.  1-3 planes with no payloads or with
    ``unstable`` payloads take the raw-key branch (K1): each tile is sorted
    by the planes, invalid slots becoming 0xFFFFFFFF in every plane, and
    ``sorted_run`` says the tile already consists of ascending runs of that
    power-of-two length (the kernel then only merges).  The name is JAX's:
    the branch is stable within a tile here (equal keys keep their slot
    order, and an invalid slot sorts after a valid all-ones key), which
    the engine's stable one-plane route relies on.  Stable payloads,
    a ``digit`` plane or more than 3 planes take the general branch (K1c):
    each tile is partitioned stably by its digit, invalid slots dropped,
    and every operand keeps its input order within a run; ``sorted_run`` is
    ignored.  ``general=True`` sends the other calls there too: the engine
    needs a stable partition for keys-only bit-range sorts, which the raw
    branch cannot give, since it orders equal digits by the whole key.  The
    TPU-only ``batch`` and ``interpret`` arguments are gone.

    ``splitters`` (the raw branch only; K1b, the equi-depth splitter mode)
    cuts the sorted tile at splitter values instead of digit boundaries:
    one (T, R-1) int32 word array per key plane (a tensor alone for one
    plane), with ``splitter_fracs`` ((T, R-1) int32, 16-bit fixed point in
    [0, 65536]; default 65536, the greedy fill) saying where inside a tie
    range each cut lies (:func:`partition_pass_splitter_plain`).
    ``lo_bit`` and ``width`` are then unused; a tile whose cut left its
    legal range reports count 0 = K + 1.
    """
    raw = (not general and digit is None and len(planes) <= MAX_PLANES
           and (not values or unstable))
    if splitters is not None and not raw:
        raise ValueError("splitters mode requires the raw-key path")
    if splitters is None and splitter_fracs is not None:
        raise ValueError("splitter_fracs needs splitters")
    ops = list(planes) + list(values)
    if not planes or any(o.dtype != torch.int32 or o.dim() != 2
                         for o in ops):
        raise ValueError("planes and values must be (T, K) int32 "
                         "bit-pattern tensors")
    ops = [o.contiguous() for o in ops]
    T, K = ops[0].shape
    dev = ops[0].device
    if any(o.shape != ops[0].shape or o.device != dev for o in ops):
        raise ValueError("every operand must have the same shape and device")
    if digit is not None:
        if digit.dtype != torch.int32 or digit.shape != ops[0].shape \
                or digit.device != dev:
            raise ValueError("digit must be a (T, K) int32 tensor on the "
                             "keys' device")
        digit = digit.contiguous()
    if K % 128 or K & (K - 1) or s <= 0 or s % 128:
        raise ValueError(f"bad tile geometry K={K} S={s}")
    # the TPU's general branch packs (digit or R) << log2(K) | slot into one
    # word; the kernels here keep no such key, but take the same shapes
    if not raw and ((r + 1) << (K.bit_length() - 1)) > (1 << 32):
        raise ValueError("sortkey overflow: (r+1) * K must fit in 32 bits")
    total = 32 * len(planes)
    if width <= 0 or (1 << width) > r or not 0 <= lo_bit <= total - width:
        raise ValueError(f"digit bits [{lo_bit}, {lo_bit + width}) do not "
                         f"fit {total}-bit keys and R={r}")
    if counts_in is not None:
        if q_in is None or q_in <= 0 or q_in % 128 or K % q_in:
            raise ValueError(f"bad validity granularity q_in={q_in}")
        if tuple(counts_in.shape) != (T, K // q_in):
            raise ValueError(f"counts_in must be ({T}, {K // q_in})")
        if counts_in.device != dev:
            raise ValueError("counts_in must be on the keys' device")
    elif n is None:
        raise ValueError("pass 0 (no counts_in) needs n")
    if sorted_run and (sorted_run & (sorted_run - 1) or K % sorted_run):
        raise ValueError(f"sorted_run={sorted_run} must be a power of two "
                         f"dividing K={K}")
    seg_tiles = 1 if t_seg is None else t_seg
    if T % seg_tiles:
        raise ValueError(f"T={T} is not a multiple of t_seg={t_seg}")
    kp, kv = ops[:len(planes)], ops[len(planes):]
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no K1 for device {dev}")
    kw = dict(q_in=q_in, n=n, r=r, s=s, t_seg=seg_tiles)
    if splitters is not None:
        *spl, fracs = _splitter_operands(splitters, splitter_fracs,
                                         len(planes), T, r, dev)
        kw.update(splitters=spl, splitter_fracs=fracs)
        if dev.type == "cpu":
            outs, counts = partition_pass_splitter_plain(kp, kv, counts_in,
                                                         **kw)
        else:
            outs, counts = _partition_pass_splitter_cuda(
                kp, kv, counts_in, sorted_run=sorted_run, **kw)
    elif raw and dev.type == "cpu":
        outs, counts = partition_pass_fused_plain(
            kp, kv, counts_in, lo_bit=lo_bit, width=width, **kw)
    elif raw:
        outs, counts = _partition_pass_cuda(
            kp, kv, counts_in, lo_bit=lo_bit, width=width,
            sorted_run=sorted_run, **kw)
    elif dev.type == "cpu":
        outs, counts = partition_pass_general_plain(
            kp, kv, counts_in, lo_bit=lo_bit, width=width, digit=digit, **kw)
    else:
        outs, counts = _partition_pass_general_cuda(
            kp, kv, counts_in, lo_bit=lo_bit, width=width, digit=digit, **kw)
    if t_seg is None:
        outs = [o.reshape(T, r * s) for o in outs]
    return outs, counts


partition_pass_fused.launches = 0
partition_pass_fused.modes = collections.Counter()


def partition_tiles_plain(ops: Sequence[torch.Tensor], starts: torch.Tensor,
                          *, r: int, s: int) -> List[torch.Tensor]:
    """Plain PyTorch K8 (the counterpart of ``_sort_tiles_xla`` +
    ``_expand_xla``): each (T, K) row's slots ordered by the sortkey
    ``ops[0]`` as unsigned (ties in slot order), then each data operand
    gathered at the sorted slots clamp(starts[t, d] + j, 0, K - 1), run d
    at columns [d * S, (d + 1) * S).  Returns one (T, R*S) int32 tensor per
    data operand."""
    T, K = ops[0].shape
    order = torch.sort(ops[0] ^ INT32_MIN, dim=1, stable=True).indices
    pos = (starts.to(torch.int64)[:, :, None]
           + torch.arange(s, device=starts.device)).clamp(0, K - 1)
    src = torch.gather(order, 1, pos.reshape(T, r * s))
    return [torch.gather(o, 1, src) for o in ops[1:]]


def _partition_tiles_cuda(ops: Sequence[torch.Tensor], starts: torch.Tensor,
                          *, r: int, s: int) -> List[torch.Tensor]:
    T, K = ops[0].shape
    data = ops[1:]
    if K > MAX_TILE or len(data) > MAX_VALUES:
        raise ValueError(
            f"partition_tiles: a tile of {K} slots with {len(data)} data "
            f"operand(s) exceeds the kernel's limits ({MAX_TILE} slots, "
            f"{MAX_VALUES} data operands)")
    dev = ops[0].device
    outs = [torch.empty(T, r * s, dtype=torch.int32, device=dev)
            for _ in data]
    err = _build.library().tpusort_partition_tiles(
        ops[0].data_ptr(), _build.pointers(data), _build.pointers(outs),
        len(data), starts.data_ptr(), T, K, r, s,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "partition_tiles")
    _build.count_launch(partition_tiles, 1, len(data))
    return outs


def partition_tiles(ops: Sequence[torch.Tensor], starts: torch.Tensor, *,
                    r: int, s: int) -> List[torch.Tensor]:
    """K8: order each tile by a sortkey the caller built and emit its data
    operands as R runs of S slots from the caller's run starts (port of
    ``tpusort/kernels/partition.py:partition_tiles``).

    ``ops`` = [sortkey, data...], each (T, K) int32 (bit patterns; the
    sortkey compares as unsigned); ``starts``: (T, R) int32 run starts in
    the sorted tile.  Returns one (T, R*S) int32 tensor per data operand:
    out[t, d*S + j] = sorted[t, clamp(starts[t, d] + j, 0, K - 1)]; the
    sortkey is not emitted.  The order is stable: equal sortkeys keep
    their slot order (the engine's sortkey, (digit or R) << log2(K) |
    slot, has none).  So every slot is defined, those past a run's count
    too: they repeat slots of the same tile, never words past it (the
    Pallas kernel leaves them garbage).  K is a power of two and a
    multiple of 128, S a multiple of 128, R at most 128, and there are 1
    to ``MAX_VALUES`` data operands; on a card K is at most ``MAX_TILE``.
    The TPU-only ``batch`` and ``interpret`` arguments are gone.
    """
    ops = [o.contiguous() for o in ops]
    if len(ops) < 2 or any(o.dtype != torch.int32 or o.dim() != 2
                           for o in ops):
        raise ValueError("partition_tiles takes a sortkey and 1 or more data "
                         "operands, (T, K) int32 bit-pattern tensors")
    T, K = ops[0].shape
    dev = ops[0].device
    if any(o.shape != ops[0].shape or o.device != dev for o in ops):
        raise ValueError("every operand must have the same shape and device")
    if K % 128 or K & (K - 1) or s <= 0 or s % 128:
        raise ValueError(f"bad tile geometry K={K} S={s}")
    if not 1 <= r <= MAX_RUNS:
        raise ValueError(f"R={r} must be in [1, {MAX_RUNS}]")
    if starts.dtype != torch.int32 or tuple(starts.shape) != (T, r) \
            or starts.device != dev:
        raise ValueError(f"starts must be a ({T}, {r}) int32 tensor on the "
                         "operands' device")
    starts = starts.contiguous()
    if dev.type == "cpu":
        return partition_tiles_plain(ops, starts, r=r, s=s)
    if dev.type == "cuda":
        return _partition_tiles_cuda(ops, starts, r=r, s=s)
    raise ValueError(f"no K8 for device {dev}")


partition_tiles.launches = 0
partition_tiles.modes = collections.Counter()
