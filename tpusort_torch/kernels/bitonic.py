"""K2 (the fused raw-key leaf sort + dense collapse), K3 (the row tile
sort), and K9 and K10 (the raw-key tile sorts with validity from a counts
table and from a mask).

PyTorch port of ``tpusort/kernels/bitonic.py:sort_tiles_counts_collapsed``
(``_counts_sort_collapse_kernel``, 1-3 key planes and payloads),
``sort_tiles`` (``_sort_kernel``), ``sort_tiles_counts``
(``_counts_sort_kernel``) and ``sort_tiles_masked``
(``_masked_sort_kernel``).  On a CUDA tensor each wrapper launches its
hand-written kernel (``csrc/bitonic.cu``, ``csrc/sort_tiles.cu``; one CTA
per tile on the register network of ``csrc/reg_sort.cuh``, see those files
for the design and what bounds it; each lays a row out on the CTA by
:func:`tile_sort_geometry`).  On a CPU
tensor it runs the plain PyTorch version of the same contract
(``*_plain``).
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from tpusort_torch.kernels import _build
from tpusort_torch.kernels.partition import (
    MAX_OPERANDS, MAX_TILE, RUNS_MAX_TILE, SMEM_MAX, _valid, check_fits,
    sort_valid_rows, tile_smem_bytes)
from tpusort_torch.ops.reference import sort_rows_lex
from tpusort_torch.utils.log import count

LANES = 128


def merge_staged_factor(k_real: int) -> int:
    """The odd block factor f for which the staged f*2^a merge applies
    (f in {3, 5}), or 0.  The planner's leaf cost model reads it."""
    for f in (3, 5):
        blk = k_real // f
        if f * blk == k_real and blk >= LANES and (blk & (blk - 1)) == 0:
            return f
    return 0


def _pow2(k: int) -> int:
    return 1 << (k - 1).bit_length()


def leaf_tile_cap(num_keys: int, has_values: bool) -> int:
    """The largest power-of-two tile K2 holds in one CTA's shared memory
    with ``num_keys`` key planes (plus the slot index with payloads)."""
    cap = MAX_TILE
    while tile_smem_bytes(cap, num_keys, has_values) > SMEM_MAX:
        cap //= 2
    return cap


class TileGeometry(NamedTuple):
    """How K2, K3, K9 and K10 (and K1, K1b) lay one row out on a CTA
    (``csrc/reg_sort.cuh``):
    ``threads`` threads each hold ``slots`` consecutive slots in registers,
    ``chunks`` times over, and the row's P slots live in ``smem_bytes`` of
    shared memory between the steps that need it."""
    threads: int
    slots: int
    chunks: int
    smem_bytes: int


# A thread's slots in registers: the 32-bit words of a slot (its key planes,
# one more for the slot index packed with the last plane) times the slots.
# Up to _REG_WORDS of them a CTA may have 1024 threads (64 registers each),
# up to twice that 512 (128 registers); csrc/reg_sort.cuh builds no
# instance beyond, where it would spill.
_REG_WORDS = 32
_MAX_THREADS = 1024
_MAX_SLOTS = 32


@functools.lru_cache(maxsize=None)
def tile_sort_geometry(K: int, num_keys: int, n_vals: int) -> TileGeometry:
    """The geometry of the row tile sorts for rows of K slots (padded to
    P = the power of two >= K) with ``num_keys`` key planes and ``n_vals``
    payload words.  Pure: the wrappers pass it to the C entry points, which
    refuse any geometry with threads * slots * chunks != P.

    A thread takes the most slots (a power of two, at most 32) whose words
    fit ``2 * _REG_WORDS`` registers: 32 for a key alone or a key and its
    index, 16 for three or four words; with more than ``_REG_WORDS`` words
    a thread the CTA has at most 512 threads, else 1024; at least one warp
    a row, and a row longer than the threads' registers is done in
    ``chunks`` passes.  So a 2,048-key row takes 64 threads and a
    16,384-key row 512, with or without a payload."""
    p = _pow2(K)
    words = num_keys + (1 if n_vals else 0)
    slots = 1 << ((2 * _REG_WORDS // words).bit_length() - 1)
    slots = min(slots, _MAX_SLOTS, p // 32)
    cap = _MAX_THREADS if slots * words <= _REG_WORDS else _MAX_THREADS // 2
    threads = min(p // slots, cap)
    return TileGeometry(threads, slots, p // (threads * slots),
                        tile_smem_bytes(p, num_keys, n_vals > 0))


class MergeGeometry(NamedTuple):
    """How K2's merge body lays one leaf tile out on a CTA
    (``csrc/merge_runs.cuh``): the tile's runs of ``run`` slots are merged
    by ``threads`` threads, each holding up to ``slots`` outputs of a level
    in registers, over one compact buffer of ``smem_bytes``."""
    run: int
    threads: int
    slots: int
    smem_bytes: int


# csrc/merge_runs.cuh: the shortest run and the most runs a tile it takes;
# the outputs a merge thread holds in registers for one, two or three key
# planes (merge_slots: 48 key words at most) and the most threads a tile
MERGE_MIN_RUN = 128
MERGE_MAX_RUNS = 256
MERGE_SLOTS = {1: 32, 2: 24, 3: 16}
MERGE_THREADS = 768


def merge_smem_bytes(K: int, num_keys: int, has_values: bool,
                     runs: int) -> int:
    """Dynamic shared memory of K2's merge body: each key plane (and two
    arrays of slot indices) over K + K / 32 words, a pad word after every
    32 slots, then the runs' starts and their count."""
    return (K + K // 32) * (4 * num_keys + (4 if has_values else 0)) \
        + 4 * (runs + 2)


@functools.lru_cache(maxsize=None)
def leaf_merge_geometry(K: int, q: int, sorted_run: int, num_keys: int,
                        n_vals: int) -> Optional[MergeGeometry]:
    """The geometry of K2's merge body for a (T, K) leaf with a counts
    table of q-slot chunks and the caller's ``sorted_run``, or None where
    K2 runs its network body.  Pure: it reads only the call's shape.

    The merge runs where the tile arrives as sorted runs (``sorted_run`` >
    0): runs of the largest power of two dividing both q and
    ``sorted_run``, each of whose valid prefix ascends, at least
    ``MERGE_MIN_RUN`` slots and at most ``MERGE_MAX_RUNS`` a tile.  A
    thread holds ``slots`` outputs of a level, 32, 24 or 16 for one, two
    or three key planes (``MERGE_SLOTS``: the most whose key words fit its
    registers), and a tile takes the fewest threads that cover it, at most
    ``MERGE_THREADS``, so that more tiles share an SM and one tile's loads
    and stores overlap another's merge (on an H100, at the 2^28 keys leaf,
    384 threads of 32 slots ran K2 in 2.99 ms where 768 of 16 took 3.68).
    And the buffer must fit a CTA's shared memory.  So the 2^28 paths'
    leaves (one final segment a tile, :func:`tpusort_torch.ops.msd.
    leaf_tiles`: 12,288 slots of 24 runs of 512, one to three planes, a
    value or not) merge, and ``sorted_run`` 0 (the wide leaf after K1c's
    unsorted runs) takes the network."""
    if sorted_run <= 0:
        return None
    run = min(sorted_run, q & -q)
    runs = K // run
    slots = MERGE_SLOTS[num_keys]
    threads = -(-K // (slots * 32)) * 32
    if run < MERGE_MIN_RUN or K % run or runs > MERGE_MAX_RUNS \
            or K > MAX_TILE or threads > MERGE_THREADS:
        return None
    smem = merge_smem_bytes(K, num_keys, n_vals > 0, runs)
    if smem > SMEM_MAX:
        return None
    return MergeGeometry(run, threads, slots, smem)


# csrc/merge_runs.cuh: runs_slots(1, false), the slots a thread sorts in
# its warp's run where a slot is one word (the packed leaf's remainder with
# its compact index under it)
LEAF_RUNS_SLOTS = 32


def leaf_runs_smem_bytes(seg: int) -> int:
    """Dynamic shared memory of the packed leaf's runs body
    (``csrc/sort_tiles.cu``: ``leaf_smem_bytes``): the merge buffer of one
    plane and no index, then ``seg`` uint16 sorted indices."""
    return merge_smem_bytes(seg, 1, False, seg // (32 * LEAF_RUNS_SLOTS)) \
        + 2 * seg


@functools.lru_cache(maxsize=None)
def leaf_runs_geometry(seg: int, q: int, num_keys: int,
                       n_ops: int) -> Optional[MergeGeometry]:
    """The geometry of the packed leaf's runs body (``csrc/sort_tiles.cu``:
    ``sort_tiles_kernel<NK>``) for final segments of ``seg`` slots under
    a counts table of q-slot chunks, with ``num_keys`` key planes among
    ``n_ops`` operands, or None where the leaf stays on the rows (the row
    build, K3's network over the padded rows, K4).  Pure: it reads only
    the call's shape.

    The body sorts one segment a CTA by one word a slot, its remainder
    with its compact index under it (``LEAF_RUNS_SLOTS`` slots a thread in
    warp runs of 32 of them, ``run``), merges the runs (``MERGE_SLOTS[1]``
    outputs a thread, ``slots``, as many) and writes the segment dense.
    It takes one or two key planes, at most ``MAX_OPERANDS`` operands, a
    ``seg`` that is a multiple of the warp run and at most
    ``RUNS_MAX_TILE`` (its index is 16 bits), a q that is a multiple of
    ``LEAF_RUNS_SLOTS`` dividing ``seg``, and at most ``MERGE_MAX_RUNS``
    chunks (one warp scans their counts); ``seg / LEAF_RUNS_SLOTS``
    threads, and :func:`leaf_runs_smem_bytes`.  So the 2^28 bit-range
    pairs' leaf (12,288, 512, one plane) takes it with 384 threads; the
    2^24 pairs' (768-slot segments) and the 2^24 keys' (24,576) stay on
    the rows."""
    run = 32 * LEAF_RUNS_SLOTS
    if not 1 <= num_keys <= 2 or n_ops > MAX_OPERANDS or seg <= 0 \
            or seg % run or seg > RUNS_MAX_TILE or q <= 0 \
            or q % LEAF_RUNS_SLOTS or seg % q or seg // q > MERGE_MAX_RUNS:
        return None
    return MergeGeometry(run, seg // LEAF_RUNS_SLOTS, MERGE_SLOTS[1],
                         leaf_runs_smem_bytes(seg))


def sort_leaf_runs(ops: Sequence[torch.Tensor], counts: torch.Tensor, q: int,
                   n_out: int, *, num_keys: int, rem_lo: int,
                   rem_width: int) -> list:
    """The packed leaf's runs body on a card: each (nseg, seg) row of the
    int32 operands (``num_keys`` key planes, then payload words: the last
    partition pass's runs, slot i of a row valid iff i % q < counts[s,
    i // q], the counts in [0, q]) sorted stably by bits [rem_lo, rem_lo +
    rem_width) of its key (``rem_width`` and the bits of ``seg - 1`` at
    most 31 together, as the packed leaf leaves them) and written dense,
    the rows' valid prefixes in row order, to (n_out,) outputs, one per
    operand; words past the valid total are zero.  The key planes come back whole.  Two launches:
    ``csrc/collapse.cu``'s offsets over the rows' valid counts, then one
    CTA a row (``csrc/sort_tiles.cu``).  Its shapes are those of
    :func:`leaf_runs_geometry`; the plain version is the composite of
    ``ops.msd.packed_leaf_plain``.  Counts one launch of K3 with the tag
    "runs"."""
    nseg, seg = _check_ops(ops, "sort_leaf_runs")
    geo = leaf_runs_geometry(seg, q, num_keys, len(ops))
    if geo is None or ops[0].device.type != "cuda":
        raise ValueError(f"sort_leaf_runs: no runs body for ({nseg}, {seg}) "
                         f"q={q} with {num_keys} key plane(s) of {len(ops)} "
                         f"operand(s) on {ops[0].device}")
    if tuple(counts.shape) != (nseg, seg // q) \
            or counts.device != ops[0].device:
        raise ValueError(f"counts must be ({nseg}, {seg // q}) on the "
                         "operands' device")
    if rem_width < 0 or rem_width + (seg - 1).bit_length() > 31 \
            or rem_lo < 0 or rem_lo + rem_width > 32 * num_keys:
        raise ValueError(f"bits [{rem_lo}, {rem_lo + rem_width}) of "
                         f"{num_keys} plane(s)")
    return _sort_leaf_runs_cuda([o.contiguous() for o in ops],
                                counts.to(torch.int32).contiguous(), q,
                                n_out, num_keys, rem_lo, rem_width, geo)


def _sort_leaf_runs_cuda(ops: Sequence[torch.Tensor], counts: torch.Tensor,
                         q: int, n_out: int, num_keys: int, rem_lo: int,
                         rem_width: int, geo: MergeGeometry) -> list:
    nseg, seg = ops[0].shape
    dev = ops[0].device
    seg_counts = counts.sum(dim=1, dtype=torch.int32)
    offsets = torch.empty(nseg + 1, dtype=torch.int64, device=dev)
    outs = [torch.empty(n_out, dtype=torch.int32, device=dev) for _ in ops]
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.library()
    _build.check(lib.tpusort_collapse_offsets(
        seg_counts.data_ptr(), 0, offsets.data_ptr(), nseg, seg, stream),
        "sort_leaf_runs")
    _build.check(lib.tpusort_sort_leaf_runs(
        _build.pointers(ops), _build.pointers(outs), len(ops), num_keys,
        counts.data_ptr(), q, offsets.data_ptr(), n_out, nseg, seg, rem_lo,
        rem_width, geo.run, geo.threads, geo.smem_bytes, stream),
        "sort_leaf_runs")
    _build.count_launch(sort_tiles, num_keys, len(ops) - num_keys, "runs")
    return outs


def _check_ops(ops, what: str) -> Tuple[int, int]:
    if not ops or any(o.dtype != torch.int32 or o.dim() != 2 for o in ops):
        raise ValueError(f"{what} operands must be (T, K) int32 "
                         "bit-pattern tensors")
    if any(o.shape != ops[0].shape or o.device != ops[0].device
           for o in ops):
        raise ValueError(f"{what} operands must share shape and device")
    return tuple(ops[0].shape)


def sort_tiles_counts_collapsed_plain(
    ops: Sequence[torch.Tensor], counts: torch.Tensor, q: int, n_out: int,
    num_keys: int = 1,
) -> list:
    """Plain PyTorch K2 on (T, K) int32 operands (``num_keys`` key planes,
    then payloads): each tile's valid slots sorted, and the tiles' valid
    prefixes concatenated in tile order into (n_out,) per operand.  Slots
    past the total valid count are zero."""
    valid = _valid(ops[0], counts, q, None)
    sp, sv = sort_valid_rows(ops[:num_keys], ops[num_keys:], valid)
    K = ops[0].shape[1]
    tile_counts = counts.sum(dim=1)
    keep = torch.arange(K, device=ops[0].device)[None, :] < \
        tile_counts[:, None]
    outs = []
    for o in (*sp, *sv):
        dense = o[keep][:n_out]
        out = torch.zeros(n_out, dtype=torch.int32, device=o.device)
        out[: dense.numel()] = dense
        outs.append(out)
    return outs


def _sort_tiles_counts_collapsed_cuda(
    ops: Sequence[torch.Tensor], counts: torch.Tensor, q: int, n_out: int,
    sorted_run: int, num_keys: int,
) -> list:
    T, K = ops[0].shape
    p = _pow2(K)                           # virtual power-of-two pad
    n_vals = len(ops) - num_keys
    check_fits("sort_tiles_counts_collapsed", p, num_keys, n_vals)
    merge = leaf_merge_geometry(K, q, sorted_run, num_keys, n_vals)
    if sorted_run and (K % sorted_run or (p - K) % sorted_run):
        sorted_run = 0
    counts = counts.to(torch.int32).contiguous()
    dev = ops[0].device
    # dense offset of each tile: exclusive cumsum of the valid counts
    offsets = torch.zeros(T + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts.sum(dim=1, dtype=torch.int64), dim=0, out=offsets[1:])
    outs = [torch.empty(n_out, dtype=torch.int32, device=dev) for _ in ops]
    geo = merge or tile_sort_geometry(K, num_keys, n_vals)
    err = _build.library().tpusort_leaf_collapse(
        _build.pointers(ops[:num_keys]), _build.pointers(outs[:num_keys]),
        num_keys, _build.pointers(ops[num_keys:]),
        _build.pointers(outs[num_keys:]), n_vals, counts.data_ptr(), q,
        offsets.data_ptr(), n_out, T, K, p, sorted_run,
        merge.run if merge else 0, geo.threads, geo.slots, geo.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "sort_tiles_counts_collapsed")
    _build.count_launch(sort_tiles_counts_collapsed, num_keys, n_vals,
                        *(("merge",) if merge else ()))
    if merge:
        count("merge_bytes", 8 * n_out * len(ops))
    return outs


def sort_tiles_counts_collapsed(
    op,
    counts: torch.Tensor,
    q: int,
    n_out: int,
    *,
    sorted_run: int = 0,
    num_keys: int = 1,
):
    """Sort each (T, K) int32 tile by its valid slots (slot i valid iff
    i % q < counts[t, i // q]; invalid slots become 0xFFFFFFFF in every key
    plane) and write each tile's valid prefix to the dense (n_out,) output
    at the exclusive cumsum of the tiles' valid counts.  The first
    ``num_keys`` operands are key planes (plane 0 most significant); the
    rest are payload words that ride along.  The contract allows any order
    of equal keys; in both versions ties keep slot order (the kernel
    compares equal keys by slot index), and an invalid slot sorts after
    every valid one, a valid all-ones key included, so each tile's valid
    prefix holds its valid slots alone.  ``sorted_run``: the tile already
    consists of ascending runs of that power-of-two length once invalid
    slots are rewritten.

    ``op`` is one tensor (returns one) or a list (returns a list), as in
    the JAX wrapper.
    """
    single = not isinstance(op, (list, tuple))
    ops = [op] if single else list(op)
    if not 1 <= num_keys <= len(ops):
        raise ValueError(f"num_keys={num_keys} for {len(ops)} operand(s)")
    T, K = _check_ops(ops, "sort_tiles_counts_collapsed")
    ops = [o.contiguous() for o in ops]
    if K % LANES or q <= 0 or q % LANES or K % q or n_out < 0:
        raise ValueError(f"bad tile geometry K={K} q={q} n_out={n_out}")
    if tuple(counts.shape) != (T, K // q):
        raise ValueError(f"counts must be ({T}, {K // q})")
    dev = ops[0].device
    if counts.device != dev:
        raise ValueError("counts must be on the keys' device")
    if sorted_run & (sorted_run - 1):
        raise ValueError(f"sorted_run={sorted_run} must be a power of two")
    if dev.type == "cpu":
        outs = sort_tiles_counts_collapsed_plain(ops, counts, q, n_out,
                                                 num_keys)
    elif dev.type == "cuda":
        outs = _sort_tiles_counts_collapsed_cuda(ops, counts, q, n_out,
                                                 sorted_run, num_keys)
    else:
        raise ValueError(f"no K2 for device {dev}")
    return outs[0] if single else outs


sort_tiles_counts_collapsed.launches = 0
sort_tiles_counts_collapsed.modes = collections.Counter()


def sort_tiles_plain(operands: Sequence[torch.Tensor]
                     ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch K3: each row sorted by operand 0 as unsigned, the
    other operands carried along, stably."""
    sp, sv = sort_rows_lex(operands[:1], operands[1:])
    return (*sp, *sv)


def _sort_tiles_cuda(operands: Sequence[torch.Tensor]
                     ) -> Tuple[torch.Tensor, ...]:
    T, K = operands[0].shape
    p = _pow2(K)
    vals = operands[1:]
    check_fits("sort_tiles", p, 1, len(vals))
    outs = [torch.empty_like(o) for o in operands]
    if T:
        dev = operands[0].device
        geo = tile_sort_geometry(K, 1, len(vals))
        err = _build.library().tpusort_sort_tiles(
            operands[0].data_ptr(), outs[0].data_ptr(),
            _build.pointers(vals), _build.pointers(outs[1:]), len(vals), T,
            K, p, geo.threads, geo.slots, geo.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, "sort_tiles")
        _build.count_launch(sort_tiles, 1, len(vals))
    return tuple(outs)


def sort_tiles(operands: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Sort each row-tile of the (T, K) int32 operands ascending by
    operand 0 as unsigned; the other operands ride along.  The contract
    allows any order of equal keys; both versions keep their input order
    (the kernel compares equal keys by slot index).  K is a multiple of
    128; a K that is not a power of two is padded virtually with
    0xFFFFFFFF keys.  With payloads the pad slots lose every tie with a
    genuine 0xFFFFFFFF key, so each row's payloads come back a permutation
    of its own.  Returns the sorted operands."""
    ops = [o.contiguous() for o in operands]
    T, K = _check_ops(ops, "sort_tiles")
    if K % LANES or K == 0:
        raise ValueError(f"tile size {K} must be a positive multiple of "
                         f"{LANES}")
    dev = ops[0].device
    if dev.type == "cpu":
        return sort_tiles_plain(ops)
    if dev.type == "cuda":
        return _sort_tiles_cuda(ops)
    raise ValueError(f"no K3 for device {dev}")


sort_tiles.launches = 0
sort_tiles.modes = collections.Counter()


def _sort_valid_plain(ops: Sequence[torch.Tensor], valid: torch.Tensor,
                      num_keys: int) -> list:
    """Each row sorted as :func:`sort_valid_rows` sorts it."""
    sp, sv = sort_valid_rows(ops[:num_keys], ops[num_keys:], valid)
    return [*sp, *sv]


def sort_tiles_counts_plain(ops: Sequence[torch.Tensor],
                            counts: torch.Tensor, q: int,
                            num_keys: int = 1) -> list:
    """Plain PyTorch K9 on (T, K) int32 operands."""
    return _sort_valid_plain(ops, _valid(ops[0], counts, q, None), num_keys)


def sort_tiles_masked_plain(ops: Sequence[torch.Tensor], mask: torch.Tensor,
                            num_keys: int = 1) -> list:
    """Plain PyTorch K10 on (T, K) int32 operands."""
    return _sort_valid_plain(ops, mask != 0, num_keys)


def _sort_tiles_valid_cuda(wrapper, ops: Sequence[torch.Tensor],
                           counts: Optional[torch.Tensor], q: int,
                           mask: Optional[torch.Tensor], sorted_run: int,
                           num_keys: int) -> list:
    """K9 (``counts``) or K10 (``mask``): one launch of the validity
    template of ``csrc/sort_tiles.cu``, counted on ``wrapper``."""
    T, K = ops[0].shape
    p = _pow2(K)                           # virtual power-of-two pad
    n_vals = len(ops) - num_keys
    check_fits(wrapper.__name__, p, num_keys, n_vals)
    if sorted_run and (K % sorted_run or (p - K) % sorted_run):
        sorted_run = 0
    outs = [torch.empty_like(o) for o in ops]
    if T:
        dev = ops[0].device
        geo = tile_sort_geometry(K, num_keys, n_vals)
        err = _build.library().tpusort_sort_tiles_valid(
            _build.pointers(ops[:num_keys]), _build.pointers(outs[:num_keys]),
            num_keys, _build.pointers(ops[num_keys:]),
            _build.pointers(outs[num_keys:]), n_vals,
            None if counts is None else counts.data_ptr(), q,
            None if mask is None else mask.data_ptr(), T, K, p, sorted_run,
            geo.threads, geo.slots, geo.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, wrapper.__name__)
        _build.count_launch(wrapper, num_keys, n_vals)
    return outs


def _valid_sort_operands(op, num_keys: int, what: str):
    """(single, contiguous operands, T, K) of a K9 or K10 call, checked."""
    single = not isinstance(op, (list, tuple))
    ops = [op] if single else list(op)
    if not 1 <= num_keys <= len(ops):
        raise ValueError(f"num_keys={num_keys} for {len(ops)} operand(s)")
    T, K = _check_ops(ops, what)
    if K % LANES or K == 0:
        raise ValueError(f"tile size {K} must be a positive multiple of "
                         f"{LANES}")
    return single, [o.contiguous() for o in ops], T, K


def sort_tiles_counts(
    op,
    counts: torch.Tensor,
    q: int,
    *,
    sorted_run: int = 0,
    num_keys: int = 1,
):
    """K9: sort each (T, K) int32 tile by its valid slots, validity from a
    (T, K // q) counts table (slot i valid iff i % q < counts[t, i // q]).
    The first ``num_keys`` operands are key planes (plane 0 most
    significant, compared as unsigned words), the rest payload words that
    ride along (the contract allows any order of equal keys; both versions
    keep their input order).  Each tile comes back whole: its valid
    elements sorted at the head, every key plane 0xFFFFFFFF behind them
    (an invalid slot sorts after a valid all-ones key, so the head's
    payloads are the valid slots' own); the payloads behind the valid
    prefix are unspecified.  K is a multiple of 128 and is padded
    virtually to a power of two.  ``sorted_run``: the tile already consists of ascending
    runs of that power-of-two length once invalid slots are rewritten (a
    hint: the result is the same without it).

    ``op`` is one tensor (returns one) or a list (returns a list), as in
    the JAX wrapper.
    """
    single, ops, T, K = _valid_sort_operands(op, num_keys,
                                             "sort_tiles_counts")
    if q <= 0 or q % LANES or K % q:
        raise ValueError(f"bad tile geometry K={K} q={q}")
    if tuple(counts.shape) != (T, K // q):
        raise ValueError(f"counts must be ({T}, {K // q})")
    dev = ops[0].device
    if counts.device != dev:
        raise ValueError("counts must be on the keys' device")
    if sorted_run & (sorted_run - 1):
        raise ValueError(f"sorted_run={sorted_run} must be a power of two")
    if dev.type == "cpu":
        outs = sort_tiles_counts_plain(ops, counts, q, num_keys)
    elif dev.type == "cuda":
        outs = _sort_tiles_valid_cuda(
            sort_tiles_counts, ops, counts.to(torch.int32).contiguous(), q,
            None, sorted_run, num_keys)
    else:
        raise ValueError(f"no K9 for device {dev}")
    return outs[0] if single else outs


sort_tiles_counts.launches = 0
sort_tiles_counts.modes = collections.Counter()


def sort_tiles_masked(
    op,
    mask: torch.Tensor,
    *,
    sorted_run: int = 0,
    num_keys: int = 1,
):
    """K10: as :func:`sort_tiles_counts`, with validity from a (T, K) mask
    (non-zero = valid; bool or any integer dtype).  ``sorted_run`` is
    accepted and not used: a mask may clear any slot of a run, and the full
    sort gives the same result."""
    single, ops, T, K = _valid_sort_operands(op, num_keys,
                                             "sort_tiles_masked")
    if tuple(mask.shape) != (T, K):
        raise ValueError(f"mask must be ({T}, {K})")
    dev = ops[0].device
    if mask.device != dev:
        raise ValueError("mask must be on the keys' device")
    if sorted_run & (sorted_run - 1):
        raise ValueError(f"sorted_run={sorted_run} must be a power of two")
    if dev.type == "cpu":
        outs = sort_tiles_masked_plain(ops, mask, num_keys)
    elif dev.type == "cuda":
        flags = mask if mask.dtype == torch.bool else mask != 0
        outs = _sort_tiles_valid_cuda(
            sort_tiles_masked, ops, None, 0, flags.contiguous(), 0, num_keys)
    else:
        raise ValueError(f"no K10 for device {dev}")
    return outs[0] if single else outs


sort_tiles_masked.launches = 0
sort_tiles_masked.modes = collections.Counter()
