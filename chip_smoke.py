#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

Run from the repository root:  python3 chip_smoke.py

It builds the hand-written kernels from ``tpusort_torch/csrc`` (nvcc,
sm_90a, one process per source) and runs these phases; any failure exits
non-zero:

1. build the kernels and report the card (name, power limit);
2. K1 (``partition_pass_fused``) keys-only vs its plain PyTorch version at
   the 2^28 plan's shapes: pass 0 with a ragged n, and pass 1 with the
   counts table pass 0 gives;
3. K2 (``sort_tiles_counts_collapsed``) keys-only vs plain at the leaf
   (its merge body: one final segment a tile, merged from its runs);
4. ``tpusort_torch.sort`` of 2^28 uniform uint32 keys: bit-identical to the
   reference sort, one radix tier (the host planner keeps it), one K1
   launch per pass (pass 0 on the runs body, the rest on the merge body),
   one K2 launch, no reference route and no fallback;
5. int32, float32 descending with NaN, -0.0 and +0.0 planted, and uint32
   with a block of 0xFFFFFFFF (which ties the invalid-slot sentinel), at
   2^24: bit-identical to the reference, through the kernels;
6. the registered "msd" engine (radix, then exact) on 2^24 constant keys:
   the overflow fallback fires, the output is exact; and the card's tier
   chain (``ops.tiers``: radix, equi-depth, exact) sorting runs of 4096
   equal keys through the equi-depth engine;
7. K1 with payloads vs plain at the pairs 2^28 plan's pass 0 and pass 1
   shapes, for the composite (key, position) planes + a value and for one
   unique key plane + a value;
8. K2 with payloads vs plain, bit for bit, at the stable pairs leaf (2
   planes + a value) and the unstable pairs leaf (a unique key plane + a
   value); then K1 and
   K2 with 2 key planes vs plain at the 2^27 uint64 plan's shapes, and
   with 2 planes + 2 value words at the 2^24 int64 pairs plan's shapes;
9. K3 (``sort_tiles``) vs plain at (1, 16384), (1, 16384 - 128 k) (the
   virtual pad) and (8192, 2048), keys and keys + a value; the single rows
   also timed back to back (20 calls between two events);
10. ``sort_pairs`` of 2^28 uniform uint32 keys with ``values = arange``:
    keys and values bit-identical to the stable reference, K1 x passes,
    K2 x 1 on the key plane alone (no position plane), no reference route
    and no fallback;
11. ``unstable_sort_pairs`` at 2^28: keys exact, the values a permutation
    with keys_in[values_out] == keys_out;
12. 2^27 uint64 keys; at 2^24 float64 descending with NaN and +-0
    planted, int64 keys with int64 values (unstable), argsort against
    ``torch.sort(stable=True).indices``, unstable and stable pairs with a
    block of 16 0xFFFFFFFF keys (K1 and K2, no fallback) and of 128 (the
    radix tier overflows; the equi-depth tier, then for unstable pairs the
    exact fallback), exact against the stable reference; the single-tile
    path (through K3) for keys at n = 16384 and n = 1000, and for unstable
    pairs at n = 16384 and n = 15616 with a block of 0xFFFFFFFF keys;
13. K1c (the general branch of ``partition_pass_fused``) vs its plain
    version, bit for bit on the counts and every valid slot, payloads
    included, on pass 0 and pass 1 of the general path's plans: the 2^28
    uint32 [0, 24) pairs plan (a key and a value), the 2^28 keys-only
    [8, 32) plan, the 2^27 stable uint64 pairs plan (2 planes + 2 value
    words) and the 2^24 int64 argsort plan (2 planes + the index);
14. the packed leaf of the first two on the rows: K3 on the packed
    (segment, remainder, position) rows at (32768, 12288), then K4
    (``collapse_segments``) on K3's output, each vs its plain version, and
    the dense result equal to the stable sort of the input (no call takes
    the rows at these shapes since K3's runs body); 14b. K3's runs body
    (``msd.packed_leaf``: ``sort_tiles_kernel<NK>`` after the offsets) on
    the same leaves, one launch tagged "runs" each, vs its plain version
    (the rows' composite) bit for bit and vs the stable sort, timed in
    turns with plain and the library call and traced once (``trace:``);
    then K4 on 64 segments of 2^21 slots,
    the shape the TPU sends to its chunked kernel (K4c), vs plain; each
    packed leaf's K4 call traced once (device ms by kernel, printed beside
    its CUDA-event time);
15. the wide leaf of the last two: K2 with 3 key planes (the masked planes
    and the position) and 4 (or 3) payload words at (32768, 6144) (or
    (32768, 768)) vs its plain version, and equal to the stable sort;
16. the general path end to end against the stable reference, each run
    through K1c x 3 and its leaf with no fallback: ``sort_pairs(end_bit=24)``
    at 2^28, keys-only ``sort(begin_bit=8)`` at 2^28 (about 16 keys per
    window value, so their input order is checked), stable uint64 pairs
    with int64 values at 2^27, int64 ``argsort`` at 2^24; then
    ``sort_pairs_lsb_in_value`` at 2^24 (K1 and K2), and constant keys over
    [8, 24), which overflow the radix tier and go to the exact sort;
18. K1b (the splitter mode of ``partition_pass_fused``) vs its plain
    version, bit for bit on the counts and every valid slot, fed as the
    equi-depth engine feeds it (strided tiles, splitters and tie fractions
    from the input's own quantile table): the 2^28 keys plan's pass 0 and
    pass 1 on Zipf 1.1 keys, pass 0 of the 2^28 composite stable-pairs
    plan (2 planes + a value) and of the unstable-pairs plan (a unique key
    + a value), and pass 0 of the 2^27 u64 plan on Zipf 1.1 keys;
19. the skew tier end to end, each against the reference: ``sort`` of
    2^28 Zipf 1.1 keys and of entropy-3 keys, stable ``sort_pairs`` and
    ``unstable_sort_pairs`` of Zipf keys with ``values = arange``, 2^27 u64
    Zipf keys; each must skip the radix tier, run one equi-depth pipeline
    of 3 K1b passes and take no exact fallback (else the counters are
    printed and the script fails); stable ``sort_pairs`` of the
    entropy-3 keys likewise.  The leaf inputs (``msd.raw_leaf``'s
    arguments) of the entropy-3 keys, the entropy-3 pairs and the Zipf
    pairs go to K2 and its plain version, bit for bit: the merge body at
    the skew tier's tiles (runs of 640 counted in chunks of q = 128,
    chained back), timed as the kernels-line rows "K2 ... (skew leaf)"
    with the merge launches of their call.  Presorted and constant 2^28
    keys come back through the identity path with no K1, K1b or K2
    launch; and a warm-cache run (uniform, uniform, constant, Zipf) stays
    exact;
20. K5 (``prefix_sum_tiles``) vs its plain version (``torch.cumsum``):
    int32 and uint32, inclusive and exclusive, at 2^28 and 2^28 - 12345,
    values up to 2^20 so the sums wrap, and on a view that starts off a
    16-byte boundary, bit for bit; float32 at 2^28 against a float64
    cumsum within 1e-5 of the running sum, float32 zeros and ones at 2^24
    exactly, and two runs of one float32 input bit for bit;
21. K6 (``digit_histogram_tiles``) vs plain (``torch.bincount``),
    exactly, at 2^28 - 12345 keys off a 16-byte boundary and in ten modes
    at 2^28, each timed with plain and ``torch.bincount``, traced once
    (device ms by kernel) and its host enqueue timed, both printed beside
    the CUDA-event time: uniform keys at
    (shift, bits) = (24, 8), (27, 5), (0, 3), (31, 1); constant keys at
    (24, 8) and (0, 3); presorted keys at (24, 8) and (0, 8); two words
    alternating key by key at (24, 8); Zipf 1.1 keys at (0, 8);
22. ``ops.scan.inclusive_sum`` / ``exclusive_sum`` and
    ``ops.histogram.digit_histogram`` (in K6's ten modes) through their
    public routes: one K5 or K6 launch each (K5 is one single-pass kernel
    after one fill of its descriptors);
23. K9 (``sort_tiles_counts``) and K10 (``sort_tiles_masked``) vs plain at
    (8192, 2048) keys, (2048, 12288) key + value (the virtual pad) and 2
    planes + a value at (4096, 4096), with ragged counts and a random
    mask: the key planes over the whole tile (all-ones behind the valid
    prefix), the payloads over the valid prefix.  They have no caller above
    the kernel level, as in the JAX package: the kernels line reports 0
    launches on a path for them and says so in ``note``, and one call of
    the public wrapper must count one launch.  Their bound counts this
    run's valid words: invalid slots are not read;
24. ``sort_batched``: (8192, 2048) and (2^14, 16384) uint32 keys + int32
    values, (2^17, 2048) uint32 keys and float32 descending rows with NaN,
    each against ``torch.sort(dim=1)`` and through one K3 launch; K3 vs
    plain at the two large shapes;
25. ``segmented_sort`` at n = 2^26.  First the route as the JAX package
    builds it ((segment id << shift, key) planes in input order through the
    engine in flag mode): its overflow flag is printed.  Then K1 and K2
    with 3 planes + a value and 2 planes + a value vs plain at the
    route's plans; then five batches, each keys only, unstable pairs and
    stable pairs with ``values = arange``, against the stable reference
    sort of (segment, key), the route and the counters printed: uniform
    uint32 keys in 2^16 equal segments (which must run K1 x passes and
    K2 x 1 with no fallback) and in 2^16 ragged ones (uniform random
    offsets), float32 normal variates in the same two batches, and 16
    distinct keys in 64 segments of 2^20.  A batch that the sample gate
    sent to the exact sort is run once more with the gate off, and must
    then overflow the engine;
26. K7 (``parallel.ring.ring_all_to_all``) vs its plain version, bit for
    bit, for all 8 shards at the send buffers of the global sort's rdma
    route at 2^28 keys and capacity factor 2.0 ((8, 2^23) words each);
27. K1 emit-only (``sorted_run`` = K, the windows finish's pass 0) vs its
    plain version at that route's pass-0 shape ((4096, 16384) tiles, one
    count a tile), keys and a key with a value;
28. ``parallel.make_global_sort`` over ``InProcessComm(8)`` on the card at
    2^28 uint32 keys, each case against the reference sort of the whole
    tensor with its launches checked: the collective exchange with the
    collapse finish (K4 once a shard), the rdma exchange with the windows
    finish at factor 2.0 (K7 and emit-only K1 once a shard and operand;
    its windows span many tiles, so its pass 0 overflows and each shard
    takes the exact sort), keys and unstable pairs (values a permutation
    riding with their keys), Zipf 1.1 keys (the default route), 2^20 keys
    through the windows finish with no overflow, presorted keys at factor
    1.0 (the
    exchange overflows; the gathered exact sort), ``adaptive=True`` (the
    second call takes no fallback), and ``make_global_sort_planes`` on
    2^27 uint64 keys; then K4 vs plain at the collapse finish's shape,
    and that call traced once, as in phase 14;
17. timings, median of 5 CUDA-event runs, alternating: the 2^28 sort
    against ``torch.sort``, the 2^28 pairs sort against ``torch.sort``
    (stable) plus the values gather, 2^27 uint64 keys against
    ``torch.sort`` of the keys as int64 with the sign bit flipped, the
    2^28 [0, 24) pairs sort against ``torch.sort(stable=True)`` of the
    masked keys plus the gathers, the 2^27 stable uint64 pairs against
    ``torch.sort(stable=True)`` of the flipped keys plus the gathers, the
    Zipf, entropy-3 and presorted 2^28 sorts against the same call forced
    through radix then exact (the registered "msd" engine) and
    ``torch.sort``, ``sort_batched`` against ``torch.sort(dim=1)`` (plus
    the gather), ``segmented_sort`` of the five batches against
    ``torch.sort(stable=True)`` of the (segment, key) int64 composite plus
    the gathers (a gated batch also with the gate off: the engine, its
    overflow, then the exact sort), each global sort case of phase 28
    against ``torch.sort`` of the whole tensor, and each kernel
    mode against its plain version (and K1, K1b, K1c, K2, K3, K5, K6, K9,
    K10, K7 and K4 against one PyTorch call, or one and its gathers,
    computing the same function: for K9 and K10 with two planes and K9's
    wide leaf a stable ``torch.sort(dim=1)`` of the planes' int64
    composite, for K4 boolean mask indexing; for K1, K1b and K1c with 1-2
    planes a stable ``torch.sort(dim=1)`` of the tile's key (K1c: its
    digit), the gathers and the scatter into the run layout, K1b's runs
    cut by ``torch.searchsorted`` at the splitters; for K2 with 1-2 planes
    a stable ``torch.sort(dim=1)`` of the tiles with invalid slots
    all-ones, the gathers and boolean mask indexing of the valid
    prefixes; none for three planes, which no single call orders).
29. the per-phase engine (``utils/profiling.py``): K8
    (``partition_tiles``) vs its plain version, fed as ``_partition_pass``
    feeds it, at the 2^28 uint32 plan's pass 0 ((16384, 16384) tiles,
    R 32, S 768) and pass 1 (S 512, the counts pass 0 gave), with the key
    as the one data operand and with the key and a value, bit for bit on
    every valid slot; the phase chain (``run_msd_phases``: K8 x 3, the
    packed leaf on K3 with the key rebuilt from its word, K4) at 2^28
    keys and 2^28 pairs (``values = arange``), and at 2^27 uint64 keys
    (K8 x 3, the wide leaf on K9, K4), each equal to the stable reference
    with no overflow and exactly those launches; K9 vs plain at that wide
    leaf's shape; then ``profile_msd_phases(1 << 28)`` and its pairs on
    the card, their tables printed; it runs after the timings of 17 and
    times its kernel modes itself;
30. K3, K9 and K10 at the edge shapes of their geometry
    (``kernels/bitonic.py:tile_sort_geometry``): the ``-Xptxas -v`` lines
    of every instance in ``sort_tiles.cu`` (29 row sorts and the runs
    body's 2; none may spill); K3 vs
    plain bit for bit at every P from 128 to 32768, K = P and P - 128,
    keys of 16 distinct words with a block of 0xFFFFFFFF, 0, 1 and 8
    payloads (index ties make it stable, so the payloads compare too), one
    row and enough rows to fill every SM, operands 4 bytes off a 16-byte
    boundary; K9 and K10 with 1-3 planes at every P the shared memory
    takes, every ``sorted_run`` from 128 to K, the key planes over the
    tile and the payloads over the valid prefix;
31. K1 and K1b (``csrc/partition.cu`` on ``csrc/reg_sort.cuh``) and K5
    (``csrc/scanhist.cu``) at their edges: the ``-Xptxas -v`` lines of the
    62 instances of ``partition_raw_kernel`` (42 of the network body, 12
    of the merge body, 8 of the runs body) and the 6 kernels of
    ``scanhist.cu``, K6's two among them (none may spill, counting the
    lines of the functions an instance calls out of line too); K1 vs plain
    bit for bit on the counts and every valid slot, payloads included (ties
    keep their slot order, as in plain), at K = 2^9 .. 2^14 (one warp run
    a tile in the runs body at 512 and 1,024) with 1-3 planes, 0, 1, 2 and
    8 payloads and every ``sorted_run`` from none through 128 .. K, on
    keys with ties and a block of 0xFFFFFFFF; K1b vs plain on Zipf 1.1
    keys cut at their own quantiles, with and without a ``sorted_run``;
32. K2 (``csrc/bitonic.cu`` on ``csrc/reg_sort.cuh``) and K1c
    (``csrc/partition_general.cu``) at their edges: the ``-Xptxas -v``
    lines of the 27 instances of ``leaf_collapse_kernel`` (21 of the
    network body, 6 of the merge body) and of
    ``partition_general_kernel`` (none may spill); K2 vs plain bit for
    bit, key planes and payloads (ties keep their slot order), at K = P
    and P - 128 for every P from 128 to the shared-memory limit, 1-3
    planes, 0, 1 and 8 payloads, every ``sorted_run`` from none through
    128 .. K, a tile with no valid slot, ``n_out`` cutting the last
    tiles, dense offsets off 16 bytes, tied keys with 0xFFFFFFFF (its path
    shapes are phases 3, 8, 8b, 15 and 25); K1c vs plain bit for bit on
    the counts and every valid slot at K = 128 .. 32768, R = 1, 2, 16, 32
    and 256, S below and above the counts, a digit straddling two planes,
    the digit plane, 16 operands, pass 0 and later passes, ``t_seg`` > 1;
33. K8 (``csrc/partition_tiles.cu``, a blocked stable rank of the
    sortkey) and K4 (``csrc/collapse.cu``, an output-driven copy) at their
    edges: the ``-Xptxas -v`` lines of their 4 kernels (none may spill);
    K8 vs plain bit for bit on every slot, the clamped ones too, at K =
    128 .. 32768, R = 1 .. 128, 1, 2 and 8 data operands, on the engine's
    sortkeys, tied ones (the order is stable, as plain's), ones on which
    the kernel's vote fails, random and constant words, one tile and 300,
    the engine's and vote-failing sortkeys and their data in views 4 bytes
    off a 16-byte boundary (the scalar loads);
    K4 vs plain with nseg from 1 to 2^16: one segment over many chunks,
    tiny and empty segments, ``n_out`` cutting a segment, sum == ``n_out``,
    16 operands, int64 counts past the segment and below 0, ``n_out`` past
    the sum;
34. K1's and K1b's merge body (``csrc/partition.cu: partition_sorted``
    after ``merge_runs.cuh: merge_tile``) on its paths' own inputs:
    ``sort`` and stable ``sort_pairs`` of 2^28 uniform and entropy-3 keys
    and ``sort`` of 2^27 uniform uint64 keys (the benchmark's five K1 and
    K1b cells: K1 keys, K1 key + value, K1b keys, K1b composite + value,
    K1 2 planes), each exact, with one launch in the "runs" mode (pass 0)
    and two in the "merge" mode; then each call's passes 1 and 2 (runs of
    256, then 512) kernel vs plain, bit for bit on the counts and every
    valid slot, and timed in turns with plain (kernels-line rows "K1
    <mode> (merge, pass <j>)");
35. K1's and K1b's runs body (``csrc/partition.cu: sort_runs``) on the
    same five calls' pass 0 (K = 16,384 tiles, S 768; K1b on the skew
    tier's strided feed, q 128), in the loop of phase 34: kernel vs plain
    bit for bit on the counts and every valid slot, one launch in the
    "runs" mode, timed in turns with plain (kernels-line rows "K1 <mode>
    (runs, pass 0)").

The line before the last is a JSON summary of the kernels: each template
mode compared, with its launches in the run of the path that drives it at
that shape (counters set to 0 just before), or 0 where no path does, its
time, its plain version's time, its bound (the least time for the words
it must move at 3.35 TB/s, or its operations at 67 T/s, the larger; K8
counts its whole sortkey read and each data operand's valid words read
and written, not the clamped slots past a run's count), the
time of a PyTorch call computing the same function where there is one
(K1, K1b, K1c and K2 with 1-2 planes, K3, K5, K6, K9 and K10, K7, K8, K4
and K4c) and a remark or null (why a three-plane mode has none); the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import re
import statistics
import subprocess
import time
from types import SimpleNamespace

MAIN_N = 1 << 28
RAGGED_N = MAIN_N - 12345
SMALL_N = 1 << 24
U64_N = 1 << 27
SEG_N = 1 << 26          # segmented_sort's size
REPS = 5
SEED = 20261016
HBM_BPS = 3.35e12        # H100 SXM memory rate (bytes/s)
ALU_OPS = 67e12          # H100 SXM non-tensor 32-bit rate (ops/s)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def ptxas_spills(log_path, match, src_of) -> dict:
    """[spill store bytes, spill load bytes] of each kernel in the build log
    at ``log_path`` whose name ``match`` accepts, summed over every
    ``spill`` line of its entry: ptxas prints one for the kernel and one
    for each function it calls out of line, so the last line alone may be
    a callee's.  Prints each line, ``src_of(name)`` naming the source."""
    spills, fn_name = {}, None
    for line in log_path.read_text().splitlines():
        if "Compiling entry function" in line:
            fn_name = line.split("'")[1]
        elif fn_name and match(fn_name) \
                and ("spill" in line or "registers" in line):
            print(f"  ptxas {src_of(fn_name)} {fn_name}: {line.strip()}",
                  flush=True)
            if "spill" in line:
                st, ld = (int(w) for w in re.findall(r"(\d+) bytes spill",
                                                     line))
                was = spills.get(fn_name, [0, 0])
                spills[fn_name] = [was[0] + st, was[1] + ld]
    return spills


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "card and has no CPU run")

    import tpusort_torch
    from tpusort_torch import dtypes, planner
    from tpusort_torch.configs import get_config
    from tpusort_torch.kernels import _build
    from tpusort_torch.kernels.bitonic import (
        leaf_merge_geometry, leaf_runs_geometry, sort_tiles,
        sort_tiles_counts,
        sort_tiles_counts_collapsed,
        sort_tiles_counts_collapsed_plain, sort_tiles_counts_plain,
        sort_tiles_masked, sort_tiles_masked_plain, sort_tiles_plain)
    from tpusort_torch.kernels.collapse import (
        collapse_segments, collapse_segments_plain)
    from tpusort_torch import api as tapi
    from tpusort_torch.kernels.partition import (
        _partition_pass_general_cuda,
        extract_bits, partition_merge_geometry, partition_pass_fused,
        partition_pass_fused_plain, partition_pass_general_plain,
        partition_pass_splitter_plain, partition_runs_geometry,
        partition_tiles, partition_tiles_plain)
    from tpusort_torch.kernels.scanhist import (
        digit_histogram_tiles, digit_histogram_tiles_plain, prefix_sum_tiles,
        prefix_sum_tiles_plain)
    from tpusort_torch.ops import equidepth, histogram, msd, scan, tiers
    from tpusort_torch.kernels.partition import SMEM_MAX, tile_smem_bytes
    from tpusort_torch.ops.reference import sort_rows_lex, sort_twiddled_reference
    from tpusort_torch.utils.datagen import segment_offsets, zipf_keys_torch
    from tpusort_torch.utils.profiling import (
        msd_phase_inputs, profile_msd_phases, run_msd_phases)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    np_rng = np.random.default_rng(SEED)
    t_start = time.perf_counter()

    def log(msg: str) -> None:
        print(f"[{time.perf_counter() - t_start:7.1f}s] {msg}", flush=True)

    def random_i32(n: int) -> torch.Tensor:
        return torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                             device=dev, generator=gen)

    def unique_i32(n: int) -> torch.Tensor:
        """n distinct words spread over the whole 32-bit range: a random
        permutation times an odd constant (a bijection mod 2^32)."""
        x = (torch.randperm(n, device=dev, generator=gen) * 0x9E3779B1) \
            & 0xFFFFFFFF
        return (x - ((x >> 31) << 32)).to(torch.int32)

    def sync_ms(fn) -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def time_alt(*fns):
        """REPS CUDA-event times (ms) of each function, in turns whose
        order reverses every round (plain, kernel, kernel, plain), after
        one warm-up of each; one list per function, in argument order."""
        for fn in fns:
            fn()
        acc = [[] for _ in fns]
        for i in range(REPS):
            order = list(zip(fns, acc))[::-1]
            for fn, a in (order if i % 2 == 0 else order[::-1]):
                a.append(sync_ms(fn))
        return tuple(acc)

    def device_ms(fn):
        """(device ms, the kernels' names and ms) of one call of fn traced
        by torch.profiler after a warm call: what the card ran, without the
        time it waited on the host inside a CUDA-event window.  A trace
        that caught no kernel at all (the profiler lost it) is taken
        again, up to three times."""
        from tpusort_torch.utils.profile_calls import _device_ms_by_name

        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            by_name = sorted(_device_ms_by_name(prof).items(),
                             key=lambda kv: -kv[1])
            if by_name:
                break
        return (sum(ms for _, ms in by_name),
                "; ".join(f"{k[:48]} {ms:.3f}" for k, ms in by_name))

    def host_us(fn) -> float:
        """Host microseconds fn takes to return on an idle card: the
        work it queues, not the work's time on the card."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        t = time.perf_counter() - t
        torch.cuda.synchronize()
        return t * 1e6

    def time_pair(kernel_fn, plain_fn):
        return time_alt(kernel_fn, plain_fn)

    def k4_library(segs, seg_counts):
        """K4's PyTorch call: each operand's valid row prefixes by boolean
        mask indexing, ``x[arange(seg) < counts[:, None]]``."""
        keep = torch.arange(segs[0].shape[1], device=dev)[None, :] \
            < seg_counts[:, None]
        return [o[keep] for o in segs]

    def bound(words: int, ops: int = 0):
        """(ms, "bytes" | "operations"): the least time of ``words`` 32-bit
        words moved at the H100's 3.35 TB/s, or of ``ops`` 32-bit integer
        operations at 67 T/s (its non-tensor float32 rate), the larger."""
        b_ms, o_ms = words * 4 / HBM_BPS * 1e3, ops / ALU_OPS * 1e3
        return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

    def log2(k: int) -> int:
        return (k - 1).bit_length()

    INT64_MAX = (1 << 63) - 1

    def composite64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
        """Two unsigned 32-bit planes as one int64 whose signed order is
        their lexicographic unsigned order (the sign bit flipped)."""
        return ((hi.long() & 0xFFFFFFFF) << 32 | (lo.long() & 0xFFFFFFFF)) \
            ^ (-(1 << 63))

    def fmt(ts) -> str:
        """Median ms of the samples, with their range."""
        return (f"{statistics.median(ts):.3f} ms "
                f"[{min(ts):.3f}..{max(ts):.3f}]")

    def u32(x: torch.Tensor) -> torch.Tensor:
        return x.view(torch.int32).long() & 0xFFFFFFFF

    def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
        return int((u32(a) - u32(b)).abs().max()) if a.numel() else 0

    def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
        if a.shape != b.shape or a.element_size() != b.element_size():
            return False
        w = torch.int64 if a.element_size() == 8 else torch.int32
        return torch.equal(a.view(w), b.view(w))

    def reference_sort(keys: torch.Tensor, values=(), descending=False,
                       begin_bit=0, end_bit=None):
        """The stable reference sort (torch.sort, plane by plane) by bits
        [begin_bit, end_bit) of the twiddled keys."""
        planes, traits = dtypes.twiddle_in(keys, descending=descending)
        sp, sv = sort_twiddled_reference(
            planes, values, begin_bit=begin_bit,
            end_bit=traits.bits if end_bit is None else end_bit,
            total_bits=traits.bits)
        out = dtypes.twiddle_out(sp, traits, descending=descending)
        return (out, sv) if values else out

    def valid_slots(counts: torch.Tensor, spec) -> torch.Tensor:
        """(T*R*S,) bool: the exchanged-run slots the counts mark valid."""
        c = counts.clamp(0, spec.s).reshape(
            spec.n_seg, spec.t_seg, spec.r).transpose(1, 2)
        s_idx = torch.arange(spec.s, device=counts.device)
        return (s_idx < c[..., None]).reshape(-1)

    def tile_valid(t: int, k: int, counts_in, q_in, n) -> torch.Tensor:
        """(t, k) validity from the global index vs n, or from a counts
        table of q_in-slot chunks."""
        if counts_in is None:
            return (torch.arange(t * k, device=dev) < n).reshape(t, k)
        return (torch.arange(k, device=dev) % q_in)[None, :] \
            < counts_in.repeat_interleave(q_in, dim=1)

    def sort_word(planes_, valid) -> torch.Tensor:
        """1-2 key planes, invalid slots all-ones, as one word whose signed
        order is their unsigned lexicographic order (the sign bit flipped,
        or the int64 composite of two)."""
        ks = [torch.where(valid, pl, -1) for pl in planes_]
        return ks[0] ^ dtypes.INT32_MIN if len(ks) == 1 else composite64(*ks)

    def runs_library(sorted_ops, run, r, s, t_seg):
        """The scatter of sorted (T, K) tiles into the (seg, d, tile, S) run
        layout of the next pass, as PyTorch calls: ``run`` is each sorted
        slot's run, r where it drops.  Returns (flat runs, (T, r) counts)."""
        t_, k_ = run.shape
        cnt = torch.zeros(t_, r + 1, dtype=torch.int64, device=dev) \
            .scatter_add_(1, run, torch.ones_like(run))
        j = torch.arange(k_, device=dev)[None, :] \
            - (cnt.cumsum(1) - cnt).gather(1, run)
        ok = (run < r) & (j < s)
        tile = torch.arange(t_, device=dev)[:, None]
        dst = (((tile // t_seg * r + run) * t_seg + tile % t_seg) * s + j)[ok]
        outs = []
        for o in sorted_ops:
            out = torch.empty(t_ * r * s, dtype=torch.int32, device=dev)
            out[dst] = o[ok]
            outs.append(out)
        return outs, cnt[:, :r]

    def partition_library(planes_, values_, counts_in, kw, splitters=None):
        """K1 (K1b with ``splitters``) as PyTorch calls on 1-2 key planes: a
        stable ``torch.sort(dim=1)`` of the tiles' key (``sort_word``), the
        gathers of every operand, each sorted slot's run (its digit; K1b: a
        batched ``torch.searchsorted`` at the splitters, without the tie
        fractions), and the scatter into the run layout."""
        t_, k_ = planes_[0].shape
        valid = tile_valid(t_, k_, counts_in, kw["q_in"], kw["n"])
        word = sort_word(planes_, valid)
        srt = torch.sort(word, dim=1, stable=True)
        ops_ = [torch.gather(o, 1, srt.indices) for o in (*planes_, *values_)]
        if splitters is None:
            run = extract_bits(ops_[:len(planes_)], kw["lo_bit"], kw["width"])
        else:
            edges = sort_word(splitters, torch.ones_like(splitters[0],
                                                         dtype=torch.bool))
            run = torch.searchsorted(edges, srt.values, right=True)
        pos = torch.arange(k_, device=dev)[None, :]
        run = torch.where(pos < valid.sum(1, keepdim=True), run, kw["r"])
        return runs_library(ops_, run, kw["r"], kw["s"], kw["t_seg"])

    def general_library(planes_, values_, counts_in, kw, digit=None):
        """K1c as PyTorch calls: each slot's digit (R where it drops), a
        stable ``torch.sort(dim=1)`` of the digits, the gathers of every
        operand and the scatter into the run layout."""
        t_, k_ = planes_[0].shape
        valid = tile_valid(t_, k_, counts_in, kw["q_in"], kw["n"])
        d = extract_bits(planes_, kw["lo_bit"], kw["width"]) if digit is None \
            else digit.long() & 0xFFFFFFFF
        d = torch.where(valid & (d < kw["r"]), d, kw["r"])
        srt = torch.sort(d, dim=1, stable=True)
        ops_ = [torch.gather(o, 1, srt.indices) for o in (*planes_, *values_)]
        return runs_library(ops_, srt.values, kw["r"], kw["s"], kw["t_seg"])

    def leaf_library(ops_, ct, q_, nk, n_out):
        """K2 as PyTorch calls on 1-2 key planes: a stable
        ``torch.sort(dim=1)`` of the tiles' key (invalid slots all-ones;
        ``sort_word``), the gathers of the payloads, and boolean mask
        indexing of each tile's valid prefix."""
        t_, k_ = ops_[0].shape
        valid = tile_valid(t_, k_, ct, q_, None)
        srt = torch.sort(sort_word(ops_[:nk], valid), dim=1, stable=True)
        keep = torch.arange(k_, device=dev)[None, :] < ct.sum(1)[:, None]
        return [torch.gather(o, 1, srt.indices)[keep][:n_out] for o in ops_]

    NO_LIBRARY_96 = ("library_ms null: no single PyTorch call orders 96-bit "
                     "keys (three planes)")

    def plan_for(n: int, end_bit: int, cfg, begin_bit=0, profile="raw"):
        kw = cfg.plan_kwargs()
        kw.pop("min_n")
        return msd.plan_msd(n, begin_bit, end_bit, leaf_profile=profile,
                            **kw)

    def k1_vs_plain(name, planes, values, plan, n, general=False):
        """K1, or K1c with ``general``, kernel vs plain on pass 0 (validity
        from n) and pass 1 (from pass 0's counts table); returns (max abs
        err, kernel times, plain times, words, operations) with the times
        of pass 0 and its least work: n words of each operand read and
        written plus the counts, and a sort of each tile (K1) or one digit
        per key (K1c), and with 1-2 planes the times of its PyTorch calls
        (``partition_library``, ``general_library``).  K1c is a stable
        partition, so any keys compare bit for bit; K1's callers give it
        unique keys (its ties keep slot order as plain's do, which phase
        31 checks)."""
        kid = "K1c" if general else "K1"
        plain_fn = (partition_pass_general_plain if general
                    else partition_pass_fused_plain)
        branch = dict(general=True) if general else dict(unstable=True)
        sp0, sp1 = plan.passes[0], plan.passes[1]
        t0 = sp0.n_seg * sp0.t_seg
        ops = [o.reshape(t0, sp0.k) for o in (*planes, *values)]
        np_ = len(planes)
        arg0 = dict(r=sp0.r, s=sp0.s, lo_bit=sp0.lo_bit, width=sp0.width,
                    n=n, q_in=None, t_seg=sp0.t_seg)
        k_out, k_cnt = partition_pass_fused(ops[:np_], ops[np_:], None,
                                            **branch, **arg0)
        p_out, p_cnt = plain_fn(ops[:np_], ops[np_:], None, **arg0)
        check(torch.equal(k_cnt, p_cnt), f"{kid} {name} pass 0: counts differ")
        check(int(k_cnt.sum()) == n, f"{kid} {name} pass 0: counts != n")
        m = valid_slots(k_cnt, sp0)
        err = 0
        for k, p in zip(k_out, p_out):
            check(same_bits(k[m], p[m]), f"{kid} {name} pass 0: slots differ")
            err = max(err, max_abs_err(k[m], p[m]))
        library = general_library if general else partition_library
        times = time_alt(
            lambda: partition_pass_fused(ops[:np_], ops[np_:], None,
                                         **branch, **arg0),
            lambda: plain_fn(ops[:np_], ops[np_:], None, **arg0),
            *([lambda: library(ops[:np_], ops[np_:], None, arg0)]
              if np_ <= 2 else []))
        del p_out, m, ops
        ctable, q = msd.next_counts_table(k_cnt, sp0)
        t1 = sp1.n_seg * sp1.t_seg
        ops = [o.reshape(t1, sp1.k) for o in k_out]
        cin = ctable.reshape(t1, sp1.k // q)
        arg1 = dict(r=sp1.r, s=sp1.s, lo_bit=sp1.lo_bit, width=sp1.width,
                    n=None, t_seg=sp1.t_seg, q_in=q)
        k_out1, k_cnt1 = partition_pass_fused(
            ops[:np_], ops[np_:], cin, sorted_run=sp0.s & -sp0.s, **branch,
            **arg1)
        p_out1, p_cnt1 = plain_fn(ops[:np_], ops[np_:], cin, **arg1)
        check(torch.equal(k_cnt1, p_cnt1),
              f"{kid} {name} pass 1: counts differ")
        m = valid_slots(k_cnt1, sp1)
        for k, p in zip(k_out1, p_out1):
            check(same_bits(k[m], p[m]), f"{kid} {name} pass 1: slots differ")
            err = max(err, max_abs_err(k[m], p[m]))
        log(f"{kid} {name} == plain on pass 0 ({t0} x {sp0.k}, S={sp0.s}, "
            f"lo_bit={sp0.lo_bit}, n={n}) and pass 1 ({t1} x {sp1.k}, "
            f"S={sp1.s}, lo_bit={sp1.lo_bit}, q_in={q}); max_abs_err {err}")
        n_ops = len(planes) + len(values)
        return (err, *times[:2], 2 * n * n_ops + t0 * sp0.r,
                n if general else n * log2(sp0.k), *times[2:])

    def k2_vs_plain(name, planes, values, plan, n):
        """K2 kernel vs plain at the leaf ``plan`` reaches after its K1
        passes over the operands (each plan.m1 long), bit for bit (ties
        keep their slot order in both); returns ((max abs err, kernel
        times, plain times, words, operations, and with 1-2 planes the
        times of ``leaf_library``), the kernel's dense outputs)."""
        data, (ctable, q_fin), overflow = msd.run_passes(
            [*planes, *values], len(planes), n, plan, unstable=bool(values))
        check(not bool(overflow), f"K2 {name}: uniform keys overflowed")
        return k2_leaf_vs_plain(name, data, ctable, q_fin, plan, len(planes),
                                n)

    def k2_leaf_vs_plain(name, data, ctable, q_fin, plan, np_, n):
        """K2 kernel vs plain on the raw leaf's inputs (``msd.raw_leaf``'s
        arguments) in the raw leaf's tiles, bit for bit; returns as
        ``k2_vs_plain``."""
        nt, tile = msd.leaf_tiles(plan, np_, len(data) > np_, q_fin)
        leaf = [o.reshape(nt, tile) for o in data]
        ct = ctable.reshape(nt, tile // q_fin)
        run = plan.passes[-1].s & -plan.passes[-1].s

        def kernel():
            return sort_tiles_counts_collapsed(leaf, ct, q_fin, n,
                                               sorted_run=run, num_keys=np_)

        def plain():
            return sort_tiles_counts_collapsed_plain(leaf, ct, q_fin, n, np_)

        k_dense, p_dense = kernel(), plain()
        err = 0
        for k, p in zip(k_dense, p_dense):
            check(same_bits(k, p), f"K2 {name}: dense outputs differ")
            err = max(err, max_abs_err(k, p))
        del p_dense
        times = time_alt(
            kernel, plain,
            *([lambda: leaf_library(leaf, ct, q_fin, np_, n)]
              if np_ <= 2 else []))
        log(f"K2 {name} == plain at ({nt}, {tile}) q={q_fin} "
            f"sorted_run={run}; max_abs_err {err}")
        return (err, *times[:2], 2 * n * len(leaf) + ct.numel() + nt,
                n * (log2(tile) - log2(run)), *times[2:]), k_dense

    def general_leaf_inputs(name, planes, values, plan, n):
        """The last K1c pass's runs of the operands and their counts
        table: what the general leaf reads."""
        data, (ctable, q), overflow = msd.run_passes(
            [*planes, *values], len(planes), n, plan, general=True)
        check(not bool(overflow), f"{name}: uniform keys overflowed")
        return data, ctable, q

    def packed_leaf_vs_plain(name, planes, values, plan, n, range_bits):
        """K3 on the packed leaf rows and K4 on K3's output, each against
        its plain version at the shapes ``plan`` gives; the dense result
        must be the stable sort of the input by ``range_bits``.  Returns
        the K3 and the K4 (max abs err, kernel times, plain times, words,
        operations, library times); K3's library call is ``torch.sort``
        of the rows plus a gather per payload."""
        np_ = len(planes)
        check(not msd.leaf_is_wide(plan), f"{name}: the leaf is not packed")
        data, ctable, q = general_leaf_inputs(name, planes, values, plan, n)
        rows, seg_counts = msd.packed_leaf_rows(data, np_, ctable, q, plan)
        del data, ctable
        k_rows, p_rows = sort_tiles(rows), sort_tiles_plain(rows)
        # valid keys are unique; the invalid slots of a segment tie and
        # may carry their payloads in any order, so only valid slots count
        nseg, seg = plan.n_segments, plan.seg
        m = (torch.arange(seg, device=dev)[None, :]
             < seg_counts[:, None]).reshape(rows[0].shape)
        check(same_bits(k_rows[0], p_rows[0]), f"K3 {name}: keys differ")
        err3 = max_abs_err(k_rows[0], p_rows[0])
        for k, p in zip(k_rows[1:], p_rows[1:]):
            check(same_bits(k[m], p[m]), f"K3 {name}: payloads differ")
            err3 = max(err3, max_abs_err(k[m], p[m]))
        del p_rows, m
        flipped = rows[0] ^ dtypes.INT32_MIN

        def library():
            order = torch.sort(flipped, dim=1).indices
            return [torch.gather(o, 1, order) for o in rows[1:]]

        t3 = time_alt(lambda: sort_tiles(rows), lambda: sort_tiles_plain(rows),
                      library)
        w3 = 2 * rows[0].numel() * len(rows)
        o3 = rows[0].numel() * log2(rows[0].shape[1])
        del rows, flipped
        log(f"K3 {name} == plain at {tuple(k_rows[0].shape)} with "
            f"{len(k_rows) - 1} payload words; max_abs_err {err3}")
        segs = [o.reshape(nseg, seg) for o in k_rows[1:]]
        del k_rows
        k_dense = collapse_segments(segs, seg_counts, n)
        p_dense = collapse_segments_plain(segs, seg_counts, n)
        err4 = 0
        for k, p in zip(k_dense, p_dense):
            check(same_bits(k, p), f"K4 {name}: dense outputs differ")
            err4 = max(err4, max_abs_err(k, p))
        del p_dense
        t4 = time_alt(lambda: collapse_segments(segs, seg_counts, n),
                      lambda: collapse_segments_plain(segs, seg_counts, n),
                      lambda: k4_library(segs, seg_counts))
        w4 = 2 * n * len(segs) + nseg
        dev_ms, kernels = device_ms(
            lambda: collapse_segments(segs, seg_counts, n))
        print(f"trace: K4 {len(segs)} operand(s) at {name}: CUDA-event "
              f"median {statistics.median(t4[0]):.3f} ms, device "
              f"{dev_ms:.3f} ms ({kernels}) on {card}", flush=True)
        del segs
        log(f"K4 {name} == plain at ({nseg}, {seg}) with {len(k_dense)} "
            f"operand(s), n_out={n}; max_abs_err {err4}")
        want = reference_sort(planes[0][:n].view(torch.uint32),
                              tuple(v[:n] for v in values),
                              begin_bit=range_bits[0], end_bit=range_bits[1])
        wk, wv = want if values else (want, ())
        check(same_bits(k_dense[0], wk)
              and all(same_bits(a, b) for a, b in zip(k_dense[1:], wv)),
              f"{name}: the packed leaf's output is not the stable sort")
        return (err3, *t3[:2], w3, o3, t3[2]), \
            (err4, *t4[:2], w4, 0, t4[2])

    def packed_runs_vs_plain(name, planes, values, plan, n, range_bits):
        """K3's runs body (``msd.packed_leaf`` on the card) on the last
        K1c pass's runs at the shapes ``plan`` gives, against its plain
        version (the row build, K3's and K4's plain versions), bit for bit
        on every output word, and the stable sort of the input by
        ``range_bits``.  Returns (max abs err, kernel times, plain times,
        words, operations, library times); the library call is a stable
        ``torch.sort`` of each segment's remainder words (made before the
        timing, invalid slots all-ones), a gather per operand and the
        valid prefixes by boolean mask indexing."""
        np_ = len(planes)
        data, ctable, q = general_leaf_inputs(name, planes, values, plan, n)
        nseg, seg = plan.n_segments, plan.seg
        geo = leaf_runs_geometry(seg, q, np_, len(data))
        check(geo is not None, f"{name}: no runs body for ({nseg}, {seg}) "
              f"q {q}")

        def kernel():
            return msd.packed_leaf(list(data), np_, ctable, q, plan, n)

        def plain():
            return msd.packed_leaf_plain(data, np_, ctable, q, plan, n)

        msd.reset_counters()
        k_dense = kernel()
        check(msd.mode_counters() == {("K3", np_, len(values), "runs"): 1},
              f"K3 runs {name}: {msd.mode_counters()}")
        p_dense = plain()
        err = 0
        for k, p in zip(k_dense, p_dense):
            check(same_bits(k, p), f"K3 runs {name}: dense outputs differ")
            err = max(err, max_abs_err(k, p))
        del p_dense
        want = reference_sort(planes[0][:n].view(torch.uint32),
                              tuple(v[:n] for v in values),
                              begin_bit=range_bits[0], end_bit=range_bits[1])
        wk, wv = want if values else (want, ())
        check(same_bits(k_dense[0], wk)
              and all(same_bits(a, b) for a, b in zip(k_dense[1:], wv)),
              f"K3 runs {name}: the output is not the stable sort")
        del k_dense, want, wk, wv
        ct = ctable.reshape(nseg, seg // q)
        keep = (torch.arange(q, device=dev)[None, None, :]
                < ct[:, :, None]).reshape(nseg, seg)
        rem = (data[0].reshape(nseg, seg) >> plan.rem_lo) \
            & ((1 << plan.rem_width) - 1)
        rem = torch.where(keep, rem, (1 << 31) - 1)
        rows = [o.reshape(nseg, seg) for o in data]

        def library():
            order = torch.sort(rem, dim=1, stable=True).indices
            return [torch.gather(o, 1, order)[keep.sum(1)[:, None] > torch
                    .arange(seg, device=dev)[None, :]] for o in rows]

        times = time_alt(kernel, plain, library)
        dev_ms, kernels = device_ms(kernel)
        print(f"trace: K3 runs body at {name}: CUDA-event median "
              f"{statistics.median(times[0]):.3f} ms, device {dev_ms:.3f} ms "
              f"({kernels}) on {card}", flush=True)
        log(f"K3 runs body {name} == plain at ({nseg}, {seg}) q {q}, "
            f"{geo.threads} threads, {len(data)} operand(s); max_abs_err "
            f"{err}")
        del data, ctable, ct, keep, rem, rows
        return (err, *times[:2], 2 * n * (np_ + len(values)) + nseg * seg // q
                + nseg, n * log2(seg), times[2])

    def wide_leaf_vs_plain(name, planes, values, plan, n):
        """K2 on the wide leaf's operands (range-masked planes + position
        as keys, planes and values as payloads) against its plain version;
        the keys are unique, so every output compares bit for bit.
        Returns ((max abs err, kernel times, plain times, words,
        operations), dense outputs of the carried operands)."""
        np_ = len(planes)
        check(msd.leaf_is_wide(plan), f"{name}: the leaf is not wide")
        data, ctable, q = general_leaf_inputs(name, planes, values, plan, n)
        ops, ct = msd.wide_leaf_operands(data, np_, ctable, q, plan)
        del data, ctable

        def kernel():
            return sort_tiles_counts_collapsed(ops, ct, q, n,
                                               num_keys=np_ + 1)

        def plain():
            return sort_tiles_counts_collapsed_plain(ops, ct, q, n, np_ + 1)

        k_dense, p_dense = kernel(), plain()
        err = 0
        for k, p in zip(k_dense, p_dense):
            check(same_bits(k, p), f"K2 {name}: dense outputs differ")
            err = max(err, max_abs_err(k, p))
        del p_dense
        times = time_pair(kernel, plain)
        log(f"K2 {name} == plain at {tuple(ops[0].shape)} with {np_ + 1} "
            f"key planes and {len(ops) - np_ - 1} payload words; "
            f"max_abs_err {err}")
        return (err, *times, 2 * n * len(ops) + ct.numel(),
                n * log2(ops[0].shape[1])), k_dense[np_ + 1:]

    def drive(fn):
        """Run one path with every counter set to 0 just before; returns
        (its output, route counters, launches by (kernel, planes, payload
        words))."""
        torch.cuda.synchronize()
        msd.reset_counters()
        out = fn()
        torch.cuda.synchronize()
        return out, msd.counters(), msd.mode_counters()

    def k2(modes, nk: int, nv: int) -> int:
        """K2's launches in a mode on either body (the merge body's carry
        the tag "merge")."""
        return modes.get(("K2", nk, nv), 0) + \
            modes.get(("K2", nk, nv, "merge"), 0)

    def pass0(modes, kid: str, nk: int, nv: int) -> int:
        """K1's or K1b's pass-0 launches in a mode, on the body its shape
        takes: the runs body (tag "runs") or the network (no tag)."""
        return modes.get((kid, nk, nv), 0) + \
            modes.get((kid, nk, nv, "runs"), 0)

    # kernel mode -> (max_abs_err, kernel times, plain times, words the
    # function must move, its operations, library call times or absent)
    results = {}
    # kernel mode -> launches of that template mode in the run of the path
    # that gives it the shape it was compared at; a mode compared at a shape
    # no path runs reports 0
    launches = {}
    # kernel mode -> a remark for its row of the kernels line
    notes = {}

    # ---- phase 1: build and report -----------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"phase 1 ok: built {lib_path.name} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    cfg = get_config(32, False, "cuda")
    plan = plan_for(RAGGED_N, 32, cfg)
    check(plan is not None and len(plan.passes) == 3,
          f"2^28 plan should have 3 passes: {plan}")
    log(f"plan for n={RAGGED_N}: m1={plan.m1} passes="
        f"{[(p.n_seg, p.t_seg, p.k, p.s) for p in plan.passes]} "
        f"seg={plan.seg}")

    # ---- phase 2: K1 kernel vs plain at the main path's shapes --------
    sp0, sp1 = plan.passes[0], plan.passes[1]
    t0_tiles = sp0.n_seg * sp0.t_seg
    keys = random_i32(plan.m1)
    tiles0 = keys.reshape(t0_tiles, sp0.k)
    arg0 = dict(r=sp0.r, s=sp0.s, lo_bit=sp0.lo_bit, width=sp0.width,
                n=RAGGED_N, t_seg=sp0.t_seg)
    (k_out0,), k_cnt0 = partition_pass_fused([tiles0], [], None, **arg0)
    (p_out0,), p_cnt0 = partition_pass_fused_plain([tiles0], [], None,
                                                   q_in=None, **arg0)
    check(torch.equal(k_cnt0, p_cnt0), "K1 pass 0: counts differ")
    m0 = valid_slots(k_cnt0, sp0)
    check(same_bits(k_out0[m0], p_out0[m0]), "K1 pass 0: valid slots differ")
    k1_err = max_abs_err(k_out0[m0], p_out0[m0])
    check(int(k_cnt0.sum()) == RAGGED_N, "K1 pass 0: counts do not sum to n")
    k1_times, k1_plain_times, k1_lib_times = time_alt(
        lambda: partition_pass_fused([tiles0], [], None, **arg0),
        lambda: partition_pass_fused_plain([tiles0], [], None, q_in=None,
                                           **arg0),
        lambda: partition_library([tiles0], [], None,
                                  dict(arg0, q_in=None)))
    del p_out0, m0

    ctable, q = msd.next_counts_table(k_cnt0, sp0)
    t1_tiles = sp1.n_seg * sp1.t_seg
    tiles1 = k_out0.reshape(t1_tiles, sp1.k)
    cin1 = ctable.reshape(t1_tiles, sp1.k // q)
    arg1 = dict(r=sp1.r, s=sp1.s, lo_bit=sp1.lo_bit, width=sp1.width,
                n=None, t_seg=sp1.t_seg, q_in=q)
    (k_out1,), k_cnt1 = partition_pass_fused(
        [tiles1], [], cin1, sorted_run=sp0.s & -sp0.s, **arg1)
    (p_out1,), p_cnt1 = partition_pass_fused_plain([tiles1], [], cin1, **arg1)
    check(torch.equal(k_cnt1, p_cnt1), "K1 pass 1: counts differ")
    m1 = valid_slots(k_cnt1, sp1)
    check(same_bits(k_out1[m1], p_out1[m1]), "K1 pass 1: valid slots differ")
    k1_err = max(k1_err, max_abs_err(k_out1[m1], p_out1[m1]))
    results["K1 keys"] = (k1_err, k1_times, k1_plain_times,
                          2 * RAGGED_N + t0_tiles * sp0.r,
                          RAGGED_N * log2(sp0.k), k1_lib_times)
    log(f"phase 2 ok: K1 == plain on pass 0 ({t0_tiles} x {sp0.k}, "
        f"n={RAGGED_N}) and pass 1 ({t1_tiles} x {sp1.k}, q_in={q}, "
        f"sorted_run={sp0.s & -sp0.s}); max_abs_err {k1_err}")
    del keys, tiles0, k_out0, k_cnt0, p_cnt0, tiles1, cin1, ctable
    del k_out1, k_cnt1, p_out1, p_cnt1, m1

    # ---- phase 3: K2 kernel vs plain at the leaf shape ----------------
    keys = random_i32(plan.m1)
    nt, tile = msd.leaf_tiles(plan)
    # one final segment a tile: K2 merges it from the last pass's runs
    check(tile == 12288, f"leaf tile {tile}, expected 12288")
    results["K2 keys"], (k_dense,) = k2_vs_plain("keys", [keys], [], plan,
                                                 RAGGED_N)
    want = reference_sort(keys[:RAGGED_N].view(torch.uint32))
    check(same_bits(k_dense, want.view(torch.int32)),
          "K2 output is not the sorted input")
    log("phase 3 ok: K2 equals the reference sort of the ragged input")
    del keys, k_dense, want

    # ---- phase 4: the main path at 2^28 -------------------------------
    # every counter of msd.counters() at 0: a call adds only what it ran
    msd.reset_counters()
    quiet = msd.counters()
    x = random_i32(MAIN_N).view(torch.uint32)
    main_plan = plan_for(MAIN_N, 32, cfg)
    t0 = time.perf_counter()
    out, main_counts, modes = drive(lambda: tpusort_torch.sort(x))
    wall = time.perf_counter() - t0
    log(f"main path counters: {main_counts} {modes} (first call, "
        f"{wall:.3f} s)")
    check(out.dtype == torch.uint32 and out.shape == x.shape
          and out.device == x.device, "main path: wrong dtype/shape/device")
    check(same_bits(out, reference_sort(x)),
          "main path: 2^28 sort differs from the reference")
    # host reads: the planner's sample and the tier's flag; merge bytes:
    # 8 a key for each merge launch (K1's passes 1-2 and K2), one word each
    check(main_counts == dict(quiet, k1_launches=len(main_plan.passes),
                              k2_launches=1, radix_tiers=1, host_reads=2,
                              merge_bytes=8 * MAIN_N * len(main_plan.passes)),
          f"main path did not run K1 x{len(main_plan.passes)} + K2 "
          f"without overflow: {main_counts}")
    # pass 0 on the runs body, passes 1 and 2 on the merge body
    check(modes.get(("K1", 1, 0, "runs")) == 1
          and modes.get(("K1", 1, 0, "merge")) == len(main_plan.passes) - 1,
          f"main path: not one runs-body K1 and the rest merged: {modes}")
    launches["K1 keys"] = pass0(modes, "K1", 1, 0)
    launches["K2 keys"] = k2(modes, 1, 0)
    log("phase 4 ok: 2^28 uint32 sort == reference, overflow False, "
        f"K1 x{main_counts['k1_launches']}, K2 x{main_counts['k2_launches']}")
    del out

    # ---- phase 5: other dtypes and inputs at 2^24 ---------------------
    small_plan = plan_for(SMALL_N, 32, cfg)
    f32_bits = random_i32(SMALL_N)
    # NaN, NaN with a payload, negative NaN with a payload, -0.0, +0.0
    planted = torch.tensor([0x7FC00000, 0x7FC00005, 0xFFC00001, 0x80000000,
                            0], dtype=torch.int64).to(torch.int32)
    for i, v in enumerate(planted.tolist()):
        f32_bits[i * 997 + 11::65521] = v
    ff_block = random_i32(SMALL_N)
    ff_block[5_000_000:5_000_128] = -1                   # 0xFFFFFFFF
    cases = [
        ("int32", random_i32(SMALL_N), False),
        ("float32 desc + NaN/-0/+0", f32_bits.view(torch.float32), True),
        ("uint32 + 0xFFFFFFFF block", ff_block.view(torch.uint32), False),
    ]
    for name, keys, desc in cases:
        msd.reset_counters()
        got = tpusort_torch.sort(keys, descending=desc)
        c = msd.counters()
        check(same_bits(got, reference_sort(keys, descending=desc)),
              f"{name}: differs from the reference")
        check(c["k1_launches"] == len(small_plan.passes)
              and c["k2_launches"] == 1 and c["overflow_fallbacks"] == 0,
              f"{name}: did not go through the kernels: {c}")
        log(f"phase 5 ok: {name} at 2^24 == reference via the kernels")
    del f32_bits, ff_block, cases, keys, got

    # ---- phase 6: the engine's fallbacks on constant keys ---------------
    # (the API returns constant keys as they are: phase 19)
    zeros = torch.zeros(SMALL_N, dtype=torch.int32, device=dev)
    bits32 = dict(begin_bit=0, end_bit=32, total_bits=32)
    msd.reset_counters()
    (got,), _ = tapi._ENGINES["msd"]((zeros,), (), config=cfg, **bits32)
    c = msd.counters()
    check(c["overflow_fallbacks"] == 1, f"constant keys: no fallback: {c}")
    check(same_bits(got, zeros), "constant keys: output differs")
    # the card's tier chain (ops.tiers): an overflowed keys-only sort goes
    # through the equi-depth engine before the exact sort
    ramp = torch.arange(SMALL_N, dtype=torch.int32, device=dev) >> 12
    msd.reset_counters()
    (got,), _ = tiers.first_clear([
        lambda: msd.sort_twiddled_msd((ramp,), (), config=cfg, **bits32),
        lambda: equidepth.sort_twiddled_equidepth((ramp,), (), config=cfg,
                                                  **bits32),
        lambda: (*sort_twiddled_reference((ramp,), (), **bits32), None)],
        "tier_flag")
    c = msd.counters()
    check(c["equidepth_runs"] == 1 and c["k1b_launches"] >= 2
          and c["overflow_fallbacks"] == 0,
          f"the equi-depth tier did not sort 4096-key runs: {c}")
    check(same_bits(got, ramp), "equi-depth tier: output differs")
    log("phase 6 ok: constant keys took the exact fallback; the "
        f"equi-depth tier sorted runs of equal keys ({c})")
    del zeros, got, ramp

    # ---- phase 7: K1 with payloads at the pairs plan's shapes ---------
    pcfg = get_config(32, True, "cuda")
    pairs_plan = plan_for(RAGGED_N, 64, pcfg)        # composite planes
    plain_plan = plan_for(RAGGED_N, 32, pcfg)        # one key plane
    check(pairs_plan is not None and plain_plan is not None
          and len(pairs_plan.passes) == 3, f"pairs plan: {pairs_plan}")
    log(f"pairs plan for n={RAGGED_N}: m1={pairs_plan.m1} passes="
        f"{[(p.n_seg, p.t_seg, p.k, p.s) for p in pairs_plan.passes]} "
        f"seg={pairs_plan.seg}")
    m1 = pairs_plan.m1
    key = random_i32(m1)
    pos = torch.arange(m1, dtype=torch.int32, device=dev)
    val = random_i32(m1)
    results["K1 composite+value"] = k1_vs_plain(
        "composite (key, position) + value", [key, pos], [val], pairs_plan,
        RAGGED_N)
    ukey = unique_i32(plain_plan.m1)
    uval = random_i32(plain_plan.m1)
    results["K1 key+value"] = k1_vs_plain(
        "unique key + value", [ukey], [uval], plain_plan, RAGGED_N)
    log("phase 7 ok")

    # ---- phase 8: K2 with payloads at the pairs leaves ----------------
    nt, tile = msd.leaf_tiles(pairs_plan, 2, True)
    check(tile == 12288, f"pairs leaf tile {tile}, expected 12288")
    results["K2 composite+value"], k_dense = k2_vs_plain(
        "composite (key, position) + value", [key, pos], [val], pairs_plan,
        RAGGED_N)
    wk, (wpos, wv) = reference_sort(key[:RAGGED_N].view(torch.uint32),
                                    (pos[:RAGGED_N], val[:RAGGED_N]))
    check(same_bits(k_dense[0], wk) and same_bits(k_dense[1], wpos)
          and same_bits(k_dense[2], wv),
          "K2 pairs output is not the stable sort of the input")
    del key, pos, val, k_dense, wk, wpos, wv
    results["K2 key+value"], k_dense = k2_vs_plain(
        "unique key + value", [ukey], [uval], plain_plan, RAGGED_N)
    wk, (wv,) = reference_sort(ukey[:RAGGED_N].view(torch.uint32),
                               (uval[:RAGGED_N],))
    check(same_bits(k_dense[0], wk) and same_bits(k_dense[1], wv),
          "K2 unique key + value output is not the sorted input")
    log("phase 8 ok: both pairs leaves equal the stable sort of the input")
    del ukey, uval, k_dense, wk, wv

    # ---- phase 8b: two key planes, bare and with two value words -------
    u64_plan = plan_for(U64_N, 64, get_config(64, False, "cuda"))
    check(u64_plan is not None, "no plan for 2^27 uint64 keys")
    hi, lo = random_i32(u64_plan.m1), random_i32(u64_plan.m1)
    results["K1 2 planes"] = k1_vs_plain("2 planes (u64 2^27)", [hi, lo],
                                         [], u64_plan, U64_N)
    results["K2 2 planes"], _ = k2_vs_plain("2 planes (u64 2^27)", [hi, lo],
                                            [], u64_plan, U64_N)
    del hi, lo, _
    i64p_plan = plan_for(SMALL_N, 64, get_config(64, True, "cuda"))
    check(i64p_plan is not None, "no plan for 2^24 int64 pairs")
    ops = [unique_i32(i64p_plan.m1)] + \
        [random_i32(i64p_plan.m1) for _ in range(3)]
    results["K1 2 planes+2 values"] = k1_vs_plain(
        "2 planes + 2 values (i64 pairs 2^24)", ops[:2], ops[2:], i64p_plan,
        SMALL_N)
    results["K2 2 planes+2 values"], _ = k2_vs_plain(
        "2 planes + 2 values (i64 pairs 2^24)", ops[:2], ops[2:], i64p_plan,
        SMALL_N)
    log("phase 8b ok")
    del ops, _

    # ---- phase 9: K3 vs plain -----------------------------------------
    for name, (t, k, nv) in {
        "K3 (1, 16384)": (1, 16384, 0),
        "K3 (1, 16384) + value": (1, 16384, 1),
        "K3 (1, 15616) + value (pad)": (1, 16384 - 128 * 6, 1),
        "K3 (8192, 2048) + value": (8192, 2048, 1),
    }.items():
        ops = [unique_i32(t * k).reshape(t, k)] + \
            [random_i32(t * k).reshape(t, k) for _ in range(nv)]
        got = sort_tiles(ops)
        want = sort_tiles_plain(ops)
        err = 0
        for g, w in zip(got, want):
            check(same_bits(g, w), f"{name}: differs from plain")
            err = max(err, max_abs_err(g, w))
        flipped = ops[0] ^ dtypes.INT32_MIN

        def library():
            order = torch.sort(flipped, dim=1).indices
            return [torch.gather(o, 1, order) for o in ops[1:]]

        tk, tp, tl = time_alt(lambda: sort_tiles(ops),
                              lambda: sort_tiles_plain(ops), library)
        results[name] = (err, tk, tp, 2 * t * k * len(ops), t * k * log2(k),
                         tl)
        if t == 1:
            # a single row's call is short enough that the host's time
            # before the launch shows in it; 20 calls between two events
            # overlap the host's work with the card's
            bk, bl = (sync_ms(lambda f=f: [f() for _ in range(20)]) / 20
                      for f in (lambda: sort_tiles(ops), library))
            print(f"time: {name} back to back, 20 calls: kernel {bk:.4f} "
                  f"ms a call vs library {bl:.4f} on {card}", flush=True)
        log(f"phase 9 ok: {name} == plain, max_abs_err {err}")
    del ops, got, want

    # ---- phase 10: sort_pairs at 2^28 ----------------------------------
    vals = torch.arange(MAIN_N, dtype=torch.int32, device=dev) \
        .view(torch.uint32)
    pairs_main = plan_for(MAIN_N, 32, pcfg)
    t0 = time.perf_counter()
    (ko, vo), pairs_counts, modes = drive(
        lambda: tpusort_torch.sort_pairs(x, vals))
    wall = time.perf_counter() - t0
    log(f"pairs path counters: {pairs_counts} {modes} (first call, "
        f"{wall:.3f} s)")
    wk, (wv,) = reference_sort(x, (vals.view(torch.int32),))
    check(ko.dtype == torch.uint32 and vo.dtype == torch.uint32
          and same_bits(ko, wk) and same_bits(vo, wv),
          "sort_pairs 2^28: keys or values differ from the stable reference")
    check(pairs_counts == dict(quiet, k1_launches=len(pairs_main.passes),
                               k2_launches=1, radix_tiers=1, host_reads=2,
                               merge_bytes=16 * MAIN_N
                               * len(pairs_main.passes)),
          f"sort_pairs did not run K1 x{len(pairs_main.passes)} + K2 "
          f"without overflow: {pairs_counts}")
    # the key plane alone: no composite (key, position) planes
    check(modes == {("K1", 1, 1, "runs"): 1,
                    ("K1", 1, 1, "merge"): len(pairs_main.passes) - 1,
                    ("K2", 1, 1, "merge"): 1},
          f"sort_pairs did not run the one-plane key+value modes (K1's "
          f"runs body, then K1's and K2's merge bodies): {modes}")
    launches["K1 key+value"] = pass0(modes, "K1", 1, 1)
    launches["K2 key+value"] = k2(modes, 1, 1)
    log("phase 10 ok: 2^28 sort_pairs == stable reference, keys and values, "
        "on the key plane alone")
    del ko, vo, wk, wv

    # ---- phase 11: unstable_sort_pairs at 2^28 -------------------------
    (ko, vo), unstable_counts, modes = drive(
        lambda: tpusort_torch.unstable_sort_pairs(x, vals))
    check(same_bits(ko, reference_sort(x)), "unstable pairs: keys differ")
    check(same_bits(x.view(torch.int32)[vo.view(torch.int32).long()], ko),
          "unstable pairs: keys_in[values_out] != keys_out")
    check(same_bits(torch.sort(vo.view(torch.int32)).values,
                    vals.view(torch.int32)),
          "unstable pairs: values are not a permutation")
    check(unstable_counts["k2_launches"] == 1
          and unstable_counts["overflow_fallbacks"] == 0
          and unstable_counts["reference_routes"] == 0,
          f"unstable pairs did not run the kernels: {unstable_counts}")
    check(modes == {("K1", 1, 1, "runs"): 1,
                    ("K1", 1, 1, "merge"): len(pairs_main.passes) - 1,
                    ("K2", 1, 1, "merge"): 1},
          f"unstable pairs did not run the one-plane key+value modes (K1's "
          f"runs body, then K1's and K2's merge bodies): {modes}")
    log(f"phase 11 ok: 2^28 unstable_sort_pairs: keys exact, values a "
        f"permutation ({unstable_counts})")
    del ko, vo

    # ---- phase 12: 64-bit keys, argsort, sentinel, single tile --------
    def through_kernels(name, fn, k3=False):
        got, c, modes = drive(fn)
        if k3:
            check(c["k3_launches"] == 1 and c["reference_routes"] == 0,
                  f"{name}: did not go through K3: {c}")
        else:
            check(c["k1_launches"] >= 2 and c["k2_launches"] == 1
                  and c["overflow_fallbacks"] == 0
                  and c["reference_routes"] == 0,
                  f"{name}: did not go through K1 and K2: {c}")
        return got, modes

    x64 = torch.stack([random_i32(U64_N), random_i32(U64_N)], 1) \
        .view(torch.int64)[:, 0]
    got, modes = through_kernels(
        "uint64 2^27", lambda: tpusort_torch.sort(x64.view(torch.uint64)))
    check(same_bits(got, reference_sort(x64.view(torch.uint64))),
          "uint64 2^27: differs from the reference")
    launches["K1 2 planes"] = pass0(modes, "K1", 2, 0)
    launches["K2 2 planes"] = k2(modes, 2, 0)
    log("phase 12 ok: uint64 keys at 2^27 == reference via the kernels")
    del got
    f64 = x64[:SMALL_N].clone()
    # NaN, NaN with a payload, negative NaN with a payload, -0.0, +0.0:
    # 16 copies each (the 2^24 multi-plane plan's last pass has S = 256,
    # so hundreds of equal keys in one run would overflow it)
    for i, v in enumerate([0x7FF8000000000000, 0x7FF8000000000005,
                           0xFFF8000000000001 - (1 << 64), -(1 << 63), 0]):
        f64[i * 997 + 11::1048573] = v
    f64 = f64.view(torch.float64)
    got, _ = through_kernels(
        "float64 desc", lambda: tpusort_torch.sort(f64, descending=True))
    check(same_bits(got, reference_sort(f64, descending=True)),
          "float64 desc + NaN/-0/+0: differs from the reference")
    log("phase 12 ok: float64 descending with NaN/-0/+0 at 2^24")
    i64 = x64[:SMALL_N]
    i64v = x64[SMALL_N:2 * SMALL_N]
    (ko, vo), modes = through_kernels(
        "int64 pairs", lambda: tpusort_torch.unstable_sort_pairs(i64, i64v))
    check(same_bits(ko, reference_sort(i64)), "int64 pairs: keys differ")
    order = torch.argsort(i64v)       # i64v holds distinct words: map back
    src = order[torch.searchsorted(i64v[order], vo)]
    check(same_bits(i64[src], ko) and same_bits(i64v[src], vo),
          "int64 pairs: values do not ride with their keys")
    launches["K1 2 planes+2 values"] = pass0(modes, "K1", 2, 2)
    launches["K2 2 planes+2 values"] = k2(modes, 2, 2)
    log("phase 12 ok: int64 keys with int64 values (unstable) at 2^24")
    del ko, vo, order, src
    a32 = random_i32(SMALL_N)
    got, _ = through_kernels("argsort", lambda: tpusort_torch.argsort(a32))
    check(torch.equal(got, torch.sort(a32, stable=True).indices),
          "argsort differs from torch.sort(stable=True).indices")
    log("phase 12 ok: argsort at 2^24 == torch.sort(stable=True).indices")
    ff = random_i32(SMALL_N)
    # equal keys share a run: a block of 16 fits the 2^24 plan's last runs
    # of 256 beside their uniform keys (128 overflowed them)
    ff[5_000_000:5_000_016] = -1
    ffv = torch.arange(SMALL_N, dtype=torch.int32, device=dev)
    # an invalid slot ranks after a valid all-ones key, so neither takes
    # the fallback
    for name, fn in (("unstable", tpusort_torch.unstable_sort_pairs),
                     ("stable", tpusort_torch.sort_pairs)):
        msd.reset_counters()
        ko, vo = fn(ff.view(torch.uint32), ffv)
        c = msd.counters()
        check(c["overflow_fallbacks"] == 0 and c["reference_routes"] == 0
              and c["equidepth_runs"] == 0 and c["k2_launches"] == 1,
              f"0xFFFFFFFF {name} pairs did not run the kernels alone: {c}")
        wk, (wv,) = reference_sort(ff.view(torch.uint32), (ffv,))
        check(same_bits(ko, wk), f"0xFFFFFFFF {name} pairs: keys differ")
        if name == "stable":
            check(same_bits(vo, wv), "0xFFFFFFFF stable pairs: values "
                  "differ from the stable reference")
        else:
            check(same_bits(torch.sort(vo).values, ffv)
                  and same_bits(ff[vo.long()], ko.view(torch.int32)),
                  "0xFFFFFFFF unstable pairs: values are not the keys' own")
    log("phase 12 ok: unstable and stable pairs with 0xFFFFFFFF keys ran "
        "K1 and K2 with no fallback, exact")
    # a block of 128 equal keys (of any value) overflows those runs: the
    # radix tier hands the call to the equi-depth tier, whose sentinel
    # check sends unstable pairs with an all-ones key on to the exact
    # sort; stable pairs finish there, on the composite (key, position)
    # planes
    ff[5_000_000:5_000_128] = -1
    for name, fn, fallbacks in (
            ("unstable", tpusort_torch.unstable_sort_pairs, 1),
            ("stable", tpusort_torch.sort_pairs, 0)):
        msd.reset_counters()
        ko, vo = fn(ff.view(torch.uint32), ffv)
        c = msd.counters()
        check(c["equidepth_runs"] == 1
              and c["overflow_fallbacks"] == fallbacks
              and c["reference_routes"] == 0,
              f"128 0xFFFFFFFF keys, {name} pairs: not the equi-depth tier "
              f"and {fallbacks} fallback: {c}")
        wk, (wv,) = reference_sort(ff.view(torch.uint32), (ffv,))
        check(same_bits(ko, wk) and same_bits(vo, wv),
              f"128 0xFFFFFFFF keys, {name} pairs: keys or values differ "
              "from the stable reference")
        log(f"phase 12 ok: {name} pairs with 128 0xFFFFFFFF keys took the "
            f"equi-depth tier and {fallbacks} exact fallback, exact ({c})")
    del ff, ffv, ko, vo, wk, wv
    for n in (16384, 1000):
        s = random_i32(n).view(torch.uint32)
        got, modes = through_kernels(
            f"single tile n={n}", lambda: tpusort_torch.sort(s), k3=True)
        check(same_bits(got, reference_sort(s)),
              f"single tile n={n}: differs from the reference")
        if n == 16384:
            launches["K3 (1, 16384)"] = modes.get(("K3", 1, 0), 0)
    # unstable pairs on one tile; at 15616 the tile is padded virtually to
    # 16384, and a block of 0xFFFFFFFF keys ties the pad slots
    for n, mode in ((16384, "K3 (1, 16384) + value"),
                    (16384 - 128 * 6, "K3 (1, 15616) + value (pad)")):
        s = random_i32(n)
        s[1000:3000] = -1
        s = s.view(torch.uint32)
        pos = torch.arange(n, dtype=torch.int32, device=dev)
        (ko, vo), modes = through_kernels(
            f"single tile pairs n={n}",
            lambda: tpusort_torch.unstable_sort_pairs(s, pos), k3=True)
        check(same_bits(ko, reference_sort(s)),
              f"single tile pairs n={n}: keys differ from the reference")
        check(same_bits(torch.sort(vo).values, pos)
              and same_bits(s.view(torch.int32)[vo.long()], ko),
              f"single tile pairs n={n}: values are not the keys' own")
        launches[mode] = modes.get(("K3", 1, 1), 0)
    log("phase 12 ok: the single-tile path ran K3 for keys at n=16384 and "
        "n=1000, and for unstable pairs at n=16384 and n=15616 with "
        "0xFFFFFFFF keys")

    # ---- phase 13: K1c vs plain at the general path's plans -----------
    def gplan(n, cfg_row, begin_bit, end_bit, passes, seg):
        p = plan_for(n, end_bit, get_config(*cfg_row, "cuda"), begin_bit,
                     "packed")
        check(p is not None and len(p.passes) == passes and p.seg == seg,
              f"general plan for n={n} {cfg_row} [{begin_bit}, {end_bit}): "
              f"{p}")
        log(f"general plan for n={n} {cfg_row} [{begin_bit}, {end_bit}): "
            f"m1={p.m1} (K, S, lo_bit)="
            f"{[(q.k, q.s, q.lo_bit) for q in p.passes]} "
            f"leaf ({p.n_segments}, {p.seg}) rem_width={p.rem_width}")
        return p

    r24_plan = gplan(RAGGED_N, (32, True), 0, 24, 3, 12288)
    check([(q.k, q.s, q.lo_bit) for q in r24_plan.passes]
          == [(16384, 768, 19), (16384, 512, 14), (16384, 512, 9)]
          and r24_plan.n_segments == 32768,
          f"[0, 24) pairs plan: {r24_plan}")
    r24_key, r24_val = random_i32(r24_plan.m1), random_i32(r24_plan.m1)
    results["K1c key+value"] = k1_vs_plain(
        "[0, 24) key + value (2^28 pairs)", [r24_key], [r24_val], r24_plan,
        RAGGED_N, general=True)
    w8_plan = gplan(RAGGED_N, (32, False), 8, 32, 3, 12288)
    w8_key = random_i32(w8_plan.m1)
    results["K1c key"] = k1_vs_plain("[8, 32) keys only (2^28)", [w8_key],
                                     [], w8_plan, RAGGED_N, general=True)
    u64p_plan = gplan(U64_N, (64, True), 0, 64, 3, 6144)
    u64p_ops = [random_i32(u64p_plan.m1) for _ in range(4)]
    results["K1c 2 planes+2 values"] = k1_vs_plain(
        "2 planes + 2 values (stable u64 pairs 2^27)", u64p_ops[:2],
        u64p_ops[2:], u64p_plan, U64_N, general=True)
    i64a_plan = gplan(SMALL_N, (64, True), 0, 64, 3, 768)
    i64a_ops = [random_i32(i64a_plan.m1) for _ in range(2)] + \
        [torch.arange(i64a_plan.m1, dtype=torch.int32, device=dev)]
    results["K1c 2 planes+value"] = k1_vs_plain(
        "2 planes + index (int64 argsort 2^24)", i64a_ops[:2], i64a_ops[2:],
        i64a_plan, SMALL_N, general=True)
    log("phase 13 ok")

    # ---- phase 14: the packed leaf, K3 then K4 ------------------------
    results["K3 packed leaf + 2 values"], results["K4 2 operands"] = \
        packed_leaf_vs_plain("[0, 24) key + value (2^28 pairs)", [r24_key],
                             [r24_val], r24_plan, RAGGED_N, (0, 24))
    results["K3 packed leaf + value"], results["K4 1 operand"] = \
        packed_leaf_vs_plain("[8, 32) keys only (2^28)", [w8_key], [],
                             w8_plan, RAGGED_N, (8, 32))
    # ---- phase 14b: the packed leaf's runs body ------------------------
    results["K3 runs leaf + value"] = packed_runs_vs_plain(
        "[0, 24) key + value (2^28 pairs)", [r24_key], [r24_val], r24_plan,
        RAGGED_N, (0, 24))
    results["K3 runs leaf"] = packed_runs_vs_plain(
        "[8, 32) keys only (2^28)", [w8_key], [], w8_plan, RAGGED_N, (8, 32))
    log("phase 14b ok: K3's runs body equals its plain version (the rows) "
        "and the stable sort at the 2^28 plans' leaves")
    del r24_key, r24_val, w8_key
    # segments over 2^20 slots, which the TPU sends to its chunked kernel
    # (K4c); no path of the port runs this shape yet
    segs = [random_i32(64 << 21).reshape(64, 1 << 21) for _ in range(2)]
    seg_counts = torch.randint(0, (1 << 21) + 1, (64,), dtype=torch.int32,
                               device=dev, generator=gen)
    n_out = int(seg_counts.sum()) - 1000
    k_dense = collapse_segments(segs, seg_counts, n_out)
    p_dense = collapse_segments_plain(segs, seg_counts, n_out)
    check(all(same_bits(k, p) for k, p in zip(k_dense, p_dense)),
          "K4 at (64, 2^21): dense outputs differ")
    t4c = time_alt(lambda: collapse_segments(segs, seg_counts, n_out),
                   lambda: collapse_segments_plain(segs, seg_counts, n_out),
                   lambda: k4_library(segs, seg_counts))
    results["K4c (64, 2^21) 2 operands"] = (
        max(max_abs_err(k, p) for k, p in zip(k_dense, p_dense)),
        *t4c[:2], 2 * 2 * n_out + 64, 0, t4c[2])
    del segs, k_dense, p_dense
    log("phase 14 ok: K3 on the packed rows and K4 after it equal their "
        "plain versions, and their output is the stable sort; K4 equals "
        "its plain version on segments of 2^21 slots")

    # ---- phase 15: the wide leaf on K2 --------------------------------
    results["K2 3 planes+4 values"], dense = wide_leaf_vs_plain(
        "stable u64 pairs (2^27)", u64p_ops[:2], u64p_ops[2:], u64p_plan,
        U64_N)
    want_planes, want_vals = sort_twiddled_reference(
        tuple(o[:U64_N] for o in u64p_ops[:2]),
        tuple(o[:U64_N] for o in u64p_ops[2:]), begin_bit=0, end_bit=64,
        total_bits=64)
    check(all(same_bits(a, b) for a, b in
              zip(dense, (*want_planes, *want_vals))),
          "wide leaf: the output is not the stable sort of the input")
    del u64p_ops, dense, want_planes, want_vals
    results["K2 3 planes+3 values"], dense = wide_leaf_vs_plain(
        "int64 argsort (2^24)", i64a_ops[:2], i64a_ops[2:], i64a_plan,
        SMALL_N)
    del i64a_ops, dense
    log("phase 15 ok: K2 on the wide leaf equals its plain version and "
        "the stable sort")

    # ---- phase 16: the general path end to end -------------------------
    def through_general(name, fn, wide):
        got, c, modes = drive(fn)
        runs = sum(k for m, k in modes.items() if m[-1] == "runs")
        check(c["k1c_launches"] == 3 and c["k1_launches"] == 0
              and c["k2_launches"] == int(wide)
              and c["k3_launches"] == runs == int(not wide)
              and c["k4_launches"] == 0
              and c["overflow_fallbacks"] == 0
              and c["reference_routes"] == 0,
              f"{name}: did not run K1c x3 and the "
              f"{'wide leaf' if wide else 'runs body'}: {c} {modes}")
        log(f"{name} counters: {c} {modes}")
        return got, modes

    (ko, vo), modes = through_general(
        "sort_pairs [0, 24) 2^28",
        lambda: tpusort_torch.sort_pairs(x, vals, end_bit=24), wide=False)
    wk, (wv,) = reference_sort(x, (vals.view(torch.int32),), end_bit=24)
    check(same_bits(ko, wk) and same_bits(vo, wv),
          "sort_pairs [0, 24) 2^28: differs from the stable reference")
    launches["K1c key+value"] = modes.get(("K1c", 1, 1), 0)
    launches["K3 runs leaf + value"] = modes.get(("K3", 1, 1, "runs"), 0)
    del ko, vo, wk, wv
    log("phase 16 ok: sort_pairs(end_bit=24) at 2^28 == stable reference")
    got, modes = through_general(
        "sort [8, 32) 2^28 keys only",
        lambda: tpusort_torch.sort(x, begin_bit=8), wide=False)
    # 2^28 keys over 2^24 window values: ~16 keys a value, whose order
    # the window does not decide, so input order is checked
    check(same_bits(got, reference_sort(x, begin_bit=8)),
          "sort [8, 32) 2^28: differs from the stable reference")
    check(not same_bits(got, reference_sort(x)),
          "sort [8, 32) 2^28: no ties in the window, order unchecked")
    launches["K1c key"] = modes.get(("K1c", 1, 0), 0)
    launches["K3 runs leaf"] = modes.get(("K3", 1, 0, "runs"), 0)
    del got
    log("phase 16 ok: keys-only sort(begin_bit=8) at 2^28 == stable "
        "reference, ties in input order")
    v64 = torch.stack([random_i32(U64_N), random_i32(U64_N)], 1) \
        .view(torch.int64)[:, 0]
    u64 = x64.view(torch.uint64)
    (ko, vo), modes = through_general(
        "stable u64 pairs 2^27",
        lambda: tpusort_torch.sort_pairs(u64, v64), wide=True)
    wk, (whi, wlo) = reference_sort(u64, dtypes.split64(v64))
    check(same_bits(ko, wk) and same_bits(vo, dtypes.join64(whi, wlo,
                                                            torch.int64)),
          "stable u64 pairs 2^27: differs from the stable reference")
    launches["K1c 2 planes+2 values"] = modes.get(("K1c", 2, 2), 0)
    launches["K2 3 planes+4 values"] = k2(modes, 3, 4)
    del ko, vo, wk, whi, wlo
    log("phase 16 ok: stable uint64 pairs with int64 values at 2^27 == "
        "stable reference")
    i64 = x64[:SMALL_N]
    got, modes = through_general("int64 argsort 2^24",
                                 lambda: tpusort_torch.argsort(i64),
                                 wide=True)
    check(torch.equal(got, torch.sort(i64, stable=True).indices),
          "int64 argsort differs from torch.sort(stable=True).indices")
    launches["K1c 2 planes+value"] = modes.get(("K1c", 2, 1), 0)
    launches["K2 3 planes+3 values"] = k2(modes, 3, 3)
    log("phase 16 ok: int64 argsort at 2^24 == torch.sort(stable=True)")
    lk, lv = random_i32(SMALL_N), unique_i32(SMALL_N)
    (ko, vo), c, modes = drive(
        lambda: tpusort_torch.sort_pairs_lsb_in_value(lk, lv, 2))
    comp = (lk.long() << 16) | (lv.long() & 0xFFFF)
    check(same_bits(ko, lk[torch.sort(comp).indices])
          and same_bits(torch.sort(comp).values,
                        (ko.long() << 16) | (vo.long() & 0xFFFF)),
          "sort_pairs_lsb_in_value: keys or value bytes out of order")
    order = torch.argsort(lv)
    src = order[torch.searchsorted(lv[order], vo)]
    check(same_bits(lk[src], ko) and same_bits(lv[src], vo),
          "sort_pairs_lsb_in_value: values do not ride with their keys")
    check(c["k1_launches"] >= 2 and c["k2_launches"] == 1
          and c["overflow_fallbacks"] == 0 and c["reference_routes"] == 0,
          f"sort_pairs_lsb_in_value did not run K1 and K2: {c}")
    # the one path left on the composite + value modes (phases 7 and 8
    # compare them at the 2^28 pairs plan, where no path runs them now)
    for kid, n_launch in (("K1", pass0(modes, "K1", 2, 1)
                           + modes.get(("K1", 2, 1, "merge"), 0)),
                          ("K2", k2(modes, 2, 1))):
        notes[f"{kid} composite+value"] = (
            "no path at this shape: 0 launches; sort_pairs_lsb_in_value at "
            f"2^24 launches it x{n_launch}")
    del lk, lv, ko, vo, comp, order, src
    log("phase 16 ok: sort_pairs_lsb_in_value (2 bytes) at 2^24 through K1 "
        "and K2")
    zk = torch.full((SMALL_N,), 0x12345678, dtype=torch.int32,
                    device=dev).view(torch.uint32)
    zv = torch.arange(SMALL_N, dtype=torch.int32, device=dev)
    (ko, vo), c, _ = drive(
        lambda: tpusort_torch.sort_pairs(zk, zv, begin_bit=8, end_bit=24))
    # the radix tier overflows; the equi-depth tier takes no bit range and
    # hands the call to the exact reference sort (as JAX's does)
    check(c["radix_tiers"] == 1 and c["k1c_launches"] >= 1
          and c["reference_routes"] == 1 and c["equidepth_runs"] == 0,
          f"constant keys [8, 24): not the exact sort after K1c: {c}")
    check(same_bits(ko, zk) and same_bits(vo, zv),
          "constant keys [8, 24): the fallback is not exact and stable")
    del zk, zv, ko, vo
    log("phase 16 ok: constant keys over [8, 24) raised overflow and the "
        "exact sort took over")

    # ---- phase 18: K1b vs plain at the equi-depth plans' shapes --------
    def eq_plan(n: int, cfg_row, nbits: int):
        """The equi-depth plan of n keys under a "cuda" row, widened, and
        its sample size's log2 (None: automatic)."""
        kw, _, s_log2, m, lmax = equidepth._prepare(
            n, get_config(*cfg_row, "cuda").plan_kwargs())
        p_ = equidepth._widen_last(msd.plan_msd(n, 0, nbits, **kw), n, m,
                                   lmax)
        return p_, s_log2

    def k1b_vs_plain(name, planes, values, n, cfg_row, npasses):
        """K1b kernel vs plain on the first ``npasses`` passes of the
        equi-depth plan of these (n,) operands, fed as the engine feeds
        them (strided tiles, the q = 128 counts table, splitters and tie
        fractions from the operands' own quantile table), each pass on the
        kernel's output of the last: counts exactly, every valid slot bit
        for bit.  Returns (max abs err, kernel and plain times of pass 0,
        words, operations)."""
        nk = len(planes)
        plan_, s_log2 = eq_plan(n, cfg_row, 32 * nk)
        p_, r_ = len(plan_.passes), plan_.passes[0].r
        table = equidepth._quantile_table(tuple(planes), n, r_ ** p_ - 1,
                                          sample_log2=s_log2)
        ops, ctable = msd.strided_feed([*planes, *values], n, plan_)
        qg, prev_s, err, out = 128, None, 0, None
        for j in range(npasses):
            spec = plan_.passes[j]
            t = spec.n_seg * spec.t_seg
            tiled = [o.reshape(t, spec.k) for o in ops]
            spl, frac = equidepth._pass_splitters(table, p_, j, r_,
                                                  spec.t_seg)
            cin = ctable.reshape(t, spec.k // qg)
            run = None if prev_s is None else prev_s & -prev_s
            kw = dict(q_in=qg, n=None, r=spec.r, s=spec.s, t_seg=spec.t_seg)

            def kernel():
                return partition_pass_fused(
                    tiled[:nk], tiled[nk:], cin, lo_bit=spec.lo_bit,
                    width=spec.width, sorted_run=run, unstable=True,
                    splitters=spl, splitter_fracs=frac, **kw)

            def plain():
                return partition_pass_splitter_plain(
                    tiled[:nk], tiled[nk:], cin, splitters=spl,
                    splitter_fracs=frac, **kw)

            k_out, k_cnt = kernel()
            p_out, p_cnt = plain()
            check(torch.equal(k_cnt, p_cnt),
                  f"K1b {name} pass {j}: counts differ")
            check(int(k_cnt.max()) <= spec.s
                  and int(k_cnt.sum()) == n,
                  f"K1b {name} pass {j}: a run overflowed or counts != n")
            m = valid_slots(k_cnt, spec)
            for k, p in zip(k_out, p_out):
                check(same_bits(k[m], p[m]),
                      f"K1b {name} pass {j}: slots differ")
                err = max(err, max_abs_err(k[m], p[m]))
            del p_out, m
            if j == 0:
                times = time_alt(
                    kernel, plain,
                    *([lambda: partition_library(
                        tiled[:nk], tiled[nk:], cin, kw, splitters=spl)]
                      if nk <= 2 else []))
                out = (2 * n * len(ops) + cin.numel() + t * spec.r
                       + t * (spec.r - 1) * (nk + 1), n * log2(spec.k))
            log(f"K1b {name} == plain on pass {j} ({t} x {spec.k}, "
                f"S={spec.s}, q_in={qg}, sorted_run={run}); "
                f"max_abs_err {err}")
            ctable, qg = msd.next_counts_table(k_cnt, spec)
            prev_s = spec.s
            ops = k_out
        return (err, *times[:2], *out, *times[2:])

    zk = zipf_keys_torch(gen, MAIN_N)       # Zipf 1.1 over 2^20 values
    results["K1b keys"] = k1b_vs_plain("Zipf 1.1 keys (2^28)", [zk], [],
                                       MAIN_N, (32, False), 2)
    zpos = torch.arange(MAIN_N, dtype=torch.int32, device=dev)
    results["K1b composite+value"] = k1b_vs_plain(
        "composite (Zipf key, position) + value (2^28 pairs)", [zk, zpos],
        [random_i32(MAIN_N)], MAIN_N, (32, True), 1)
    ukey = unique_i32(MAIN_N)
    results["K1b key+value"] = k1b_vs_plain(
        "unique key + value (2^28 unstable pairs)", [ukey],
        [random_i32(MAIN_N)], MAIN_N, (32, True), 1)
    del ukey
    z64 = zipf_keys_torch(gen, U64_N, dtype=torch.int64)
    results["K1b 2 planes"] = k1b_vs_plain(
        "2 planes, Zipf 1.1 (u64 2^27)", list(dtypes.split64(z64)), [],
        U64_N, (64, False), 1)
    log("phase 18 ok")

    # ---- phase 19: the skew tier and the host tiering end to end -------
    def through_skew(name, fn, passes, skip_radix=True):
        """Run one call with the counters at 0: the equi-depth tier ran
        once, with ``passes`` K1b launches, no exact fallback and (with
        ``skip_radix``) no radix attempt.  Returns (output, launches by
        mode)."""
        # the tier cache is blind to the distribution (as in JAX): a cold
        # call classifies this input, not the last uniform one
        tapi._TIER_CACHE.clear()
        got, c, modes = drive(fn)
        log(f"{name} counters: {c} {modes}")
        if c["overflow_fallbacks"] or (skip_radix and c["radix_tiers"]):
            print(f"tier counters of {name}: {c}", flush=True)
            fail(f"{name}: the skew tier fell back or radix was tried")
        check(c["equidepth_runs"] == 1 and c["k1b_launches"] == passes,
              f"{name}: not one equi-depth run of {passes} K1b passes: {c}")
        return got, modes

    def leaf_args(fn):
        """(fn's output, the arguments of its largest ``msd.raw_leaf``
        call: the skew tier's own leaf, not its sample sort's)."""
        seen, real = [], msd.raw_leaf

        def spy(*args):
            seen.append(args)
            return real(*args)

        msd.raw_leaf = spy
        try:
            out = fn()
        finally:
            msd.raw_leaf = real
        check(bool(seen), "no msd.raw_leaf call")
        return out, max(seen, key=lambda a: a[5])

    def skew_leaf_vs_plain(mode, name, args, modes):
        """K2 kernel vs plain on the skew tier's leaf inputs ``args`` (its
        runs of S = 640 counted in chunks of 128, chained back by the merge
        body), bit for bit; a kernels-line row "K2 <mode> (skew leaf)" with
        the merge body's launches in ``modes``."""
        data, ctable, q_, plan_, nk, n_ = args
        nv = len(data) - nk
        run = plan_.passes[-1].s & -plan_.passes[-1].s
        tile = msd.leaf_tiles(plan_, nk, nv > 0, q_)[1]
        check(leaf_merge_geometry(tile, q_, run, nk, nv) is not None,
              f"K2 {name} (skew leaf): ({tile}, q {q_}, sorted_run {run}) "
              "does not take the merge body")
        row = f"K2 {mode} (skew leaf)"
        results[row], _ = k2_leaf_vs_plain(f"{name} (skew leaf)", data,
                                           ctable, q_, plan_, nk, n_)
        launches[row] = modes.get(("K2", nk, nv, "merge"), 0)
        check(launches[row] >= 1, f"{row}: no merge launch: {modes}")
        _, tk, tp, words, ops, *lib = results[row]
        log(f"{row}: kernel {fmt(tk)} vs plain {fmt(tp)}"
            + (f" vs library {fmt(lib[0])}" if lib else "")
            + f", bound {bound(words, ops)[0]:.3f} ms, "
            f"{launches[row]} merge launch(es) in the call")

    zu = zk.view(torch.uint32)
    got, modes = through_skew("sort Zipf 1.1 2^28",
                              lambda: tpusort_torch.sort(zu), 3)
    check(same_bits(got, reference_sort(zu)),
          "Zipf 2^28: differs from the reference")
    launches["K1b keys"] = pass0(modes, "K1b", 1, 0)
    log("phase 19 ok: Zipf 1.1 keys at 2^28 took the skew tier, exact")
    e3 = (random_i32(MAIN_N) & random_i32(MAIN_N)
          & random_i32(MAIN_N)).view(torch.uint32)
    (got, e3_leaf), modes = through_skew(
        "sort entropy-3 2^28", lambda: leaf_args(
            lambda: tpusort_torch.sort(e3)), 3)
    check(same_bits(got, reference_sort(e3)),
          "entropy-3 2^28: differs from the reference")
    del got
    skew_leaf_vs_plain("keys", "entropy-3 keys", e3_leaf, modes)
    del e3_leaf
    log("phase 19 ok: entropy-3 keys at 2^28 took the skew tier, exact; "
        "K2 on its leaf inputs == plain")
    ((ko, vo), e3_leaf), modes = through_skew(
        "stable sort_pairs entropy-3 2^28", lambda: leaf_args(
            lambda: tpusort_torch.sort_pairs(e3, vals)), 3)
    wk, (wv,) = reference_sort(e3, (vals.view(torch.int32),))
    check(same_bits(ko, wk) and same_bits(vo, wv),
          "stable entropy-3 pairs 2^28: differs from the stable reference")
    del ko, vo, wk, wv
    skew_leaf_vs_plain("composite+value", "stable entropy-3 pairs", e3_leaf,
                       modes)
    del e3_leaf
    log("phase 19 ok: stable entropy-3 pairs at 2^28 took the skew tier, "
        "exact; K2 on its leaf inputs == plain")
    ((ko, vo), z_leaf), modes = through_skew(
        "stable sort_pairs Zipf 2^28", lambda: leaf_args(
            lambda: tpusort_torch.sort_pairs(zu, vals)), 3)
    wk, (wv,) = reference_sort(zu, (vals.view(torch.int32),))
    check(same_bits(ko, wk) and same_bits(vo, wv),
          "stable Zipf pairs 2^28: differs from the stable reference")
    launches["K1b composite+value"] = pass0(modes, "K1b", 2, 1)
    del ko, vo, wk, wv
    skew_leaf_vs_plain("composite+value Zipf", "stable Zipf pairs", z_leaf,
                       modes)
    del z_leaf
    log("phase 19 ok: stable Zipf pairs at 2^28, keys and values exact; K2 "
        "on its leaf inputs == plain")
    (ko, vo), modes = through_skew(
        "unstable_sort_pairs Zipf 2^28",
        lambda: tpusort_torch.unstable_sort_pairs(zu, vals), 3)
    check(same_bits(ko, reference_sort(zu)), "unstable Zipf pairs: keys")
    check(same_bits(zk[vo.view(torch.int32).long()], ko.view(torch.int32))
          and same_bits(torch.sort(vo.view(torch.int32)).values,
                        vals.view(torch.int32)),
          "unstable Zipf pairs: values are not a permutation of their keys")
    launches["K1b key+value"] = pass0(modes, "K1b", 1, 1)
    del ko, vo
    log("phase 19 ok: unstable Zipf pairs at 2^28")
    z64u = z64.view(torch.uint64)
    got, modes = through_skew("sort u64 Zipf 2^27",
                              lambda: tpusort_torch.sort(z64u), 3)
    check(same_bits(got, reference_sort(z64u)),
          "u64 Zipf 2^27: differs from the reference")
    launches["K1b 2 planes"] = pass0(modes, "K1b", 2, 0)
    del got, z64, z64u
    log("phase 19 ok: u64 Zipf keys at 2^27 took the skew tier, exact")
    presorted = reference_sort(x)
    const = torch.full((MAIN_N,), 0x12345678, dtype=torch.int32,
                       device=dev).view(torch.uint32)
    for name, keys in (("presorted", presorted), ("constant", const)):
        got, c, _ = drive(lambda: tpusort_torch.sort(keys))
        # host reads: the planner's sample and the sortedness check
        check(c == dict(quiet, identity_routes=1, host_reads=2),
              f"{name} 2^28: not the identity path with no launch: {c}")
        check(same_bits(got, keys) and got.data_ptr() != keys.data_ptr(),
              f"{name} 2^28: not a copy of the input")
        log(f"phase 19 ok: {name} 2^28 keys came back through the identity "
            f"path, no K1, K1b or K2 launch ({c})")
    del got
    tapi._TIER_CACHE.clear()
    for i, (name, keys) in enumerate((("uniform", x), ("uniform", x),
                                      ("constant", const), ("Zipf", zu))):
        got, c, _ = drive(lambda: tpusort_torch.sort(keys))
        check(same_bits(got, reference_sort(keys)),
              f"warm-cache call {i} ({name}): differs from the reference")
        log(f"phase 19 ok: warm-cache call {i} ({name}) exact: {c}; cache "
            f"{list(tapi._TIER_CACHE.values())}")
    del got

    # ---- phase 20: K5 vs plain ------------------------------------------
    small = torch.randint(0, 1 << 20, (MAIN_N,), dtype=torch.int32,
                          device=dev, generator=gen)
    check(int(small.sum(dtype=torch.int64)) > 1 << 32,
          "K5: the int32 sums would not wrap")
    for name, xin in (("int32", small), ("uint32", small.view(torch.uint32))):
        for n_ in (MAIN_N, RAGGED_N):
            for excl in (False, True):
                got = prefix_sum_tiles(xin[:n_], exclusive=excl)
                want = prefix_sum_tiles_plain(xin[:n_], exclusive=excl)
                check(got.dtype == xin.dtype and same_bits(got, want),
                      f"K5 {name} n={n_} exclusive={excl}: differs from "
                      "plain")
                del got, want
    for off in (1, 3):                    # off a 16-byte boundary
        check(same_bits(prefix_sum_tiles(small[off:RAGGED_N]),
                        prefix_sum_tiles_plain(small[off:RAGGED_N])),
              f"K5 int32 view at +{off}: differs from plain")
    log("phase 20 ok: K5 == plain bit for bit, int32 and uint32, inclusive "
        f"and exclusive, n={MAIN_N} and n={RAGGED_N}, wrapping sums, and "
        "on views off a 16-byte boundary")

    def k5_times(xin, excl):
        xi_ = xin.view(torch.int32) if xin.dtype == torch.uint32 else xin
        return time_alt(
            lambda: prefix_sum_tiles(xin, exclusive=excl),
            lambda: prefix_sum_tiles_plain(xin, exclusive=excl),
            lambda: torch.cumsum(xi_, 0, dtype=xi_.dtype))

    t5 = k5_times(small, False)
    results["K5 int32 inclusive"] = (0, *t5[:2], 2 * MAIN_N, MAIN_N, t5[2])
    t5 = k5_times(small.view(torch.uint32), True)
    results["K5 uint32 exclusive"] = (0, *t5[:2], 2 * MAIN_N, MAIN_N, t5[2])
    f32 = torch.rand(MAIN_N, device=dev, generator=gen)
    got = prefix_sum_tiles(f32)
    check(same_bits(got, prefix_sum_tiles(f32)),
          "K5 float32: two runs of one input differ")
    exact = torch.cumsum(f32.double(), 0)
    rel = float(((got.double() - exact).abs() / exact).max())
    plain32 = prefix_sum_tiles_plain(f32)
    rel_plain = float(((plain32.double() - exact).abs() / exact).max())
    f32_err = float((got - plain32).abs().max())
    check(rel < 1e-5, f"K5 float32 2^28: relative error {rel} vs float64")
    del exact, plain32, got
    bits01 = (torch.randint(0, 2, (SMALL_N,), device=dev, generator=gen))
    for excl in (False, True):
        want = torch.cumsum(bits01, 0) - (bits01 if excl else 0)
        check(torch.equal(prefix_sum_tiles(bits01.float(), exclusive=excl),
                          want.float()),
              f"K5 float32 0/1 at 2^24 exclusive={excl}: not exact")
    t5 = k5_times(f32, False)
    results["K5 float32 inclusive"] = (f32_err, *t5[:2], 2 * MAIN_N, MAIN_N,
                                       t5[2])
    log(f"phase 20 ok: K5 float32 at 2^28 within {rel:.3e} of the float64 "
        f"running sum (tolerance 1e-5; torch.cumsum: {rel_plain:.3e}; "
        f"max abs difference from plain {f32_err}); 0/1 values at 2^24 "
        "exact; two runs bit-identical")
    del bits01, want

    # ---- phase 21: K6 vs plain ------------------------------------------
    odd = x[3:3 + RAGGED_N]
    got = digit_histogram_tiles(odd, 24, 8)
    check(torch.equal(got, digit_histogram_tiles_plain(odd, 24, 8))
          and int(got.sum()) == RAGGED_N,
          f"K6 at n={RAGGED_N} off a 16-byte boundary: differs from plain")
    alt_word = torch.tensor(0x3C5A96F0, dtype=torch.int32, device=dev)
    alternating = torch.where(
        torch.arange(MAIN_N, device=dev) % 2 == 1, ~alt_word, alt_word) \
        .view(torch.uint32)
    # K6's modes: every digit width of its two counting paths on the keys
    # that give the run pairs and the register fields the least and the
    # most to do; each also through the public route in phase 22
    k6_modes = (("uniform", x, 24, 8), ("constant", const, 24, 8),
                ("uniform", x, 27, 5), ("uniform", x, 0, 3),
                ("uniform", x, 31, 1), ("constant", const, 0, 3),
                ("presorted", presorted, 24, 8), ("presorted", presorted, 0, 8),
                ("alternating", alternating, 24, 8), ("Zipf 1.1", zu, 0, 8))
    for name, keys, shift, nbits in k6_modes:
        got = digit_histogram_tiles(keys, shift, nbits)
        check(torch.equal(got, digit_histogram_tiles_plain(keys, shift, nbits))
              and int(got.sum()) == MAIN_N,
              f"K6 {name} ({shift}, {nbits}) at 2^28: differs from plain")
        ki = keys.view(torch.int32)
        t6 = time_alt(
            lambda: digit_histogram_tiles(keys, shift, nbits),
            lambda: digit_histogram_tiles_plain(keys, shift, nbits),
            lambda: torch.bincount((ki >> shift) & ((1 << nbits) - 1),
                                   minlength=1 << nbits))
        mode = f"K6 {name} ({shift}, {nbits})"
        results[mode] = (0, *t6[:2], MAIN_N + (1 << nbits), MAIN_N, t6[2])
        # a single call's CUDA-event window also holds the wrapper's host
        # work on an idle card, a large share at a third of a millisecond
        dev_ms, kernels = device_ms(
            lambda: digit_histogram_tiles(keys, shift, nbits))
        enqueue_us = statistics.median(
            host_us(lambda: digit_histogram_tiles(keys, shift, nbits))
            for _ in range(9))
        notes[mode] = (f"device ms of a traced call {dev_ms:.4f}; the "
                       f"wrapper's host enqueue {enqueue_us:.1f} us")
        print(f"trace: {mode}: CUDA-event median "
              f"{statistics.median(t6[0]):.3f} ms, device {dev_ms:.4f} ms "
              f"({kernels}), host enqueue {enqueue_us:.1f} us (median of "
              f"9) on {card}", flush=True)
        log(f"phase 21 ok: {mode} == plain exactly: kernel {fmt(t6[0])}, "
            f"plain {fmt(t6[1])}, torch.bincount {fmt(t6[2])}")
    check(int(digit_histogram_tiles(const, 24, 8)[0x12]) == MAIN_N,
          "K6 constant keys: not all in bin 0x12")
    log(f"phase 21 ok: K6 == plain exactly in {len(k6_modes)} modes at 2^28 "
        f"and at n={RAGGED_N} off alignment")
    del odd, got

    # ---- phase 22: the public scan and histogram routes ------------------
    for mode, fn, want_fn in (
            ("K5 int32 inclusive", lambda: scan.inclusive_sum(small),
             lambda: prefix_sum_tiles_plain(small)),
            ("K5 uint32 exclusive",
             lambda: scan.exclusive_sum(small.view(torch.uint32)),
             lambda: prefix_sum_tiles_plain(small.view(torch.uint32),
                                            exclusive=True)),
            ("K5 float32 inclusive", lambda: scan.inclusive_sum(f32), None)):
        got, c, modes = drive(fn)
        check(c == dict(quiet, k5_launches=1),
              f"{mode}: the public route did not launch K5 once: {c}")
        check(want_fn is None or same_bits(got, want_fn()),
              f"{mode}: the public route differs from plain")
        launches[mode] = modes.get(("K5", 0, 1), 0)
        notes[mode] = ("one launch of the single-pass kernel, after one "
                       "fill that zeroes its descriptors")
    for name, keys, shift, nbits in k6_modes:
        got, c, modes = drive(
            lambda: histogram.digit_histogram(keys, shift, nbits))
        mode = f"K6 {name} ({shift}, {nbits})"
        check(c == dict(quiet, k6_launches=1)
              and got.shape == (1, 1 << nbits) and int(got.sum()) == MAIN_N,
              f"digit_histogram ({mode}): not one K6 launch: {c}")
        launches[mode] = modes.get(("K6", 1, 0), 0)
    log("phase 22 ok: inclusive_sum, exclusive_sum and digit_histogram "
        f"(in K6's {len(k6_modes)} modes) launched K5 or K6 once each")
    del small, f32, got, alternating

    # ---- phase 23: K9 and K10 vs plain -----------------------------------
    for shape_name, (t, k, nk, nv, q_) in {
        "(8192, 2048)": (8192, 2048, 1, 0, 128),
        "(2048, 12288) + value": (2048, 12288, 1, 1, 512),
        "2 planes + value (4096, 4096)": (4096, 4096, 2, 1, 256),
    }.items():
        ops = [unique_i32(t * k).reshape(t, k)] + \
            [random_i32(t * k).reshape(t, k) for _ in range(nk - 1 + nv)]
        cnts = torch.randint(0, q_ + 1, (t, k // q_), dtype=torch.int32,
                             device=dev, generator=gen)
        mask = torch.rand(t, k, device=dev, generator=gen) < 0.7
        flipped = ops[0] ^ dtypes.INT32_MIN
        comp = composite64(ops[0], ops[1]) if nk == 2 else None
        for kid, kernel, plain, valid in (
                ("K9", lambda: sort_tiles_counts(ops, cnts, q_, num_keys=nk),
                 lambda: sort_tiles_counts_plain(ops, cnts, q_, nk),
                 (torch.arange(k, device=dev) % q_)[None, :]
                 < cnts.repeat_interleave(q_, dim=1)),
                ("K10", lambda: sort_tiles_masked(ops, mask, num_keys=nk),
                 lambda: sort_tiles_masked_plain(ops, mask, nk), mask)):
            mode = f"{kid} {shape_name}"
            got, want = kernel(), plain()
            head = torch.arange(k, device=dev)[None, :] \
                < valid.sum(dim=1)[:, None]
            err = 0
            for i, (g, w) in enumerate(zip(got, want)):
                if i < nk:
                    check(same_bits(g, w) and bool((g[~head] == -1).all()),
                          f"{mode}: key plane {i} differs from plain")
                    err = max(err, max_abs_err(g, w))
                else:
                    check(same_bits(g[head], w[head]),
                          f"{mode}: payload {i - nk} differs on the valid "
                          "prefix")
                    err = max(err, max_abs_err(g[head], w[head]))
            del got, want, head
            fns = [kernel, plain]
            if nk == 1:          # one PyTorch sort of the rewritten rows
                top = (1 << 31) - 1

                def library(valid=valid):
                    order = torch.sort(torch.where(valid, flipped, top),
                                       dim=1).indices
                    return [torch.gather(o, 1, order) for o in ops[1:]]
            else:                # a stable sort of the int64 composite
                def library(valid=valid):
                    order = torch.sort(torch.where(valid, comp, INT64_MAX),
                                       dim=1, stable=True).indices
                    return [torch.gather(o, 1, order) for o in ops[1:]]
            fns.append(library)
            tk, tp, *tl = time_alt(*fns)
            # the words this run's data needs: invalid slots are never
            # read and the payloads behind the valid prefix never written
            nvalid = int(valid.sum())
            results[mode] = (err, tk, tp,
                             nvalid * len(ops) + t * k * nk + nvalid * nv
                             + (cnts.numel() if kid == "K9" else t * k // 4),
                             nvalid * log2(k), *tl)
            _, c, modes = drive(kernel)
            check(c == dict(quiet, **{f"k{kid[1:]}_launches": 1})
                  and modes.get((kid, nk, nv), 0) == 1,
                  f"{mode}: a call of the wrapper is not one {kid} launch: "
                  f"{c} {modes}")
            notes[mode] = (
                "no path at this shape: 0 launches (one call of the wrapper "
                "is one launch); the per-phase engine's wide leaf runs K9 "
                "(its row below)" if kid == "K9" else
                "no caller above the kernel level: 0 launches on a path "
                "(one call of the wrapper is one launch)")
            log(f"phase 23 ok: {mode} == plain, max_abs_err {err}; "
                f"{nvalid} of {t * k} slots valid")
    del ops, cnts, mask, flipped, valid, comp

    # ---- phase 24: sort_batched -------------------------------------------
    def batched(name, keys, values, k3_mode, **kw):
        got, c, modes = drive(
            lambda: tpusort_torch.sort_batched(keys, values, **kw))
        check(c == dict(quiet, k3_launches=1),
              f"sort_batched {name}: not one K3 launch: {c}")
        ko = got if values is None else got[0]
        planes, traits = dtypes.twiddle_in(keys.reshape(-1), **kw)
        want = dtypes.twiddle_out(
            ((torch.sort(planes[0].reshape(keys.shape) ^ dtypes.INT32_MIN,
                         dim=1).values ^ dtypes.INT32_MIN).reshape(-1),),
            traits, **kw)
        check(ko.shape == keys.shape and ko.dtype == keys.dtype
              and same_bits(ko.reshape(-1), want),
              f"sort_batched {name}: keys differ from torch.sort(dim=1)")
        if values is not None:
            vo = got[1]
            check(same_bits(torch.sort(vo, dim=1).values, values)
                  and same_bits(
                      keys.reshape(-1).view(torch.int32)[
                          vo.reshape(-1).long()],
                      ko.reshape(-1).view(torch.int32)),
                  f"sort_batched {name}: values are not the rows' own")
        log(f"phase 24 ok: sort_batched {name} == torch.sort(dim=1), one K3 "
            f"launch ({modes})")
        return modes.get(k3_mode, 0)

    def k3_vs_plain(mode, ops):
        got, want = sort_tiles(ops), sort_tiles_plain(ops)
        err = 0
        for g, w in zip(got, want):
            check(same_bits(g, w), f"{mode}: differs from plain")
            err = max(err, max_abs_err(g, w))
        del got, want
        flipped = ops[0] ^ dtypes.INT32_MIN

        def library():
            s_ = torch.sort(flipped, dim=1)
            return [torch.gather(o, 1, s_.indices) for o in ops[1:]]

        tk, tp, tl = time_alt(lambda: sort_tiles(ops),
                              lambda: sort_tiles_plain(ops), library)
        t, k = ops[0].shape
        results[mode] = (err, tk, tp, 2 * t * k * len(ops), t * k * log2(k),
                         tl)
        log(f"phase 24 ok: {mode} == plain, max_abs_err {err}")

    rows_v = torch.arange(MAIN_N, dtype=torch.int32, device=dev)
    bk = unique_i32(8192 * 2048).reshape(8192, 2048)
    launches["K3 (8192, 2048) + value"] = batched(
        "(8192, 2048) uint32 + int32 values", bk.view(torch.uint32),
        rows_v[:8192 * 2048].reshape(8192, 2048), ("K3", 1, 1))
    bk = unique_i32(MAIN_N)
    k3_vs_plain("K3 (131072, 2048)", [bk.reshape(1 << 17, 2048)])
    launches["K3 (131072, 2048)"] = batched(
        "(2^17, 2048) uint32", bk.view(torch.uint32).reshape(1 << 17, 2048),
        None, ("K3", 1, 0))
    k3_vs_plain("K3 (16384, 16384) + value",
                [bk.reshape(1 << 14, 1 << 14), rows_v.reshape(1 << 14, -1)])
    launches["K3 (16384, 16384) + value"] = batched(
        "(2^14, 16384) uint32 + int32 values",
        bk.view(torch.uint32).reshape(1 << 14, 1 << 14),
        rows_v.reshape(1 << 14, 1 << 14), ("K3", 1, 1))
    fb = random_i32(1 << 24)
    fb[::4099] = 0x7FC00000                 # NaN rows
    batched("(8192, 2048) float32 descending with NaN",
            fb.view(torch.float32).reshape(8192, 2048), None, ("K3", 1, 0),
            descending=True)
    del fb

    # ---- phase 25: segmented_sort at 2^26 ---------------------------------
    sk = x[:SEG_N]
    ski = sk.view(torch.int32)
    nseg = 1 << 16
    eq_offs = torch.arange(nseg + 1, dtype=torch.int64).numpy() \
        * (SEG_N // nseg)
    scfg = get_config(64, False, "cuda")
    # the route as JAX builds it (tpusort/ops/segmented.py:176-190)
    seg_eq = torch.arange(SEG_N, dtype=torch.int32, device=dev) \
        >> (26 - 16)
    shift = 32 - max((nseg - 1).bit_length(), 1)
    (_, jk), _, jflag = drive(lambda: msd.sort_twiddled_msd(
        (seg_eq << shift, ski), (), begin_bit=0, end_bit=64, total_bits=64,
        config=scfg))[0]
    log(f"segmented_sort as JAX feeds the engine (segment id << {shift}, "
        f"key; input order) at n=2^26, {nseg} equal segments: overflow flag "
        f"{bool(jflag)}, counters {msd.counters()}")
    print(f"repro: JAX's segmented engine feed at 2^26 with {nseg} equal "
          f"segments overflows: {bool(jflag)}", flush=True)
    del jk, jflag

    seg3_plan = plan_for(SEG_N, 96, get_config(64, True, "cuda"))
    seg2_plan = plan_for(SEG_N, 64, get_config(64, True, "cuda"))
    check(seg3_plan is not None and seg2_plan is not None
          and msd.leaf_tiles(seg3_plan, 3, True)[1] <= 16384,
          f"segmented plans: {seg3_plan} {seg2_plan}")
    log(f"segmented 3-plane plan for n=2^26: m1={seg3_plan.m1} (K, S, "
        f"lo_bit)={[(p.k, p.s, p.lo_bit) for p in seg3_plan.passes]} leaf "
        f"{msd.leaf_tiles(seg3_plan, 3, True)}")
    m3 = seg3_plan.m1
    ops3 = [random_i32(m3), random_i32(m3),
            torch.arange(m3, dtype=torch.int32, device=dev), random_i32(m3)]
    results["K1 3 planes+value"] = k1_vs_plain(
        "3 planes + value (stable segmented pairs 2^26)", ops3[:3], ops3[3:],
        seg3_plan, SEG_N)
    results["K2 3 planes+value"], _ = k2_vs_plain(
        "3 planes + value (stable segmented pairs 2^26)", ops3[:3], ops3[3:],
        seg3_plan, SEG_N)
    del ops3, _
    m2 = seg2_plan.m1
    ops2 = [unique_i32(m2), random_i32(m2), random_i32(m2)]
    results["K1 2 planes+value"] = k1_vs_plain(
        "2 planes + value (unstable segmented pairs 2^26)", ops2[:2],
        ops2[2:], seg2_plan, SEG_N)
    results["K2 2 planes+value"], _ = k2_vs_plain(
        "2 planes + value (unstable segmented pairs 2^26)", ops2[:2],
        ops2[2:], seg2_plan, SEG_N)
    del ops2, _

    svals = rows_v[:SEG_N]
    rag_offs = segment_offsets(np_rng, SEG_N, nseg)

    def seg_ids(offs):
        return torch.searchsorted(
            torch.from_numpy(offs[1:]).to(dev),
            torch.arange(SEG_N, dtype=torch.int64, device=dev),
            right=True).to(torch.int32)

    def seg_route(c, passes):
        """Which way a segmented_sort went, by its counters."""
        if (c["k1_launches"] == passes and c["k2_launches"] == 1
                and c["overflow_fallbacks"] == 0
                and c["reference_routes"] == 0):
            return "engine", f"the engine (K1 x {passes}, K2 x 1)"
        if (c["reference_routes"] == 1 and c["k1_launches"] == 0
                and c["overflow_fallbacks"] == 0):
            return "gated", ("the exact sort, chosen by the sample gate "
                             "with no engine run")
        if c["overflow_fallbacks"] == 1:
            return "overflow", "the exact sort after the engine overflowed"
        return "other", "an unexpected route"

    def seg_batch(batch, keys, offs, must_run):
        """segmented_sort of (n,) keys in the batch's segments: keys only,
        unstable and stable pairs against the stable reference sort of
        (segment, key), the route of each printed; the route names."""
        (plane,), traits = dtypes.twiddle_in(keys)
        (_, wk), (wv,) = sort_twiddled_reference(
            (seg_ids(offs), plane), (svals,), begin_bit=0, end_bit=64,
            total_bits=64)
        wk = dtypes.twiddle_out((wk,), traits)
        lens = offs[1:] - offs[:-1]
        log(f"{batch}: lengths {int(lens.min())}..{int(lens.max())}")
        routes = []
        for mode, vals_, stable_, k_mode in (
                ("keys only", None, True, (2, 0)),
                ("unstable pairs", svals, False, (2, 1)),
                ("stable pairs", svals, True, (3, 1))):
            got, c, modes = drive(lambda: tpusort_torch.segmented_sort(
                keys, offs, vals_, stable=stable_))
            plan_ = seg3_plan if k_mode[0] == 3 else seg2_plan
            kind, route = seg_route(c, len(plan_.passes))
            routes.append(kind)
            print(f"route: segmented_sort {mode}, {batch}: {route}; "
                  f"{c} {modes}", flush=True)
            check(kind != "other" and (kind == "engine" or not must_run),
                  f"segmented_sort {mode}, {batch}: did not run through "
                  f"K1 and K2 without a fallback: {c}")
            ko = got if vals_ is None else got[0]
            check(ko.dtype == keys.dtype and same_bits(ko, wk),
                  f"segmented_sort {mode}, {batch}: keys differ from the "
                  "stable reference of (segment, key)")
            if vals_ is not None and stable_:
                check(same_bits(got[1], wv),
                      f"segmented_sort {mode}, {batch}: values differ")
            elif vals_ is not None:
                check(same_bits(keys.view(torch.int32)[got[1].long()], wk)
                      and same_bits(torch.sort(got[1]).values, svals),
                      f"segmented_sort {mode}, {batch}: values are not a "
                      "permutation riding with their keys")
            if must_run and vals_ is not None:
                row = f"{k_mode[0]} planes+value"
                launches[f"K1 {row}"] = pass0(modes, "K1", *k_mode)
                launches[f"K2 {row}"] = k2(modes, *k_mode)
            del got, ko
        log(f"phase 25 ok: segmented_sort at 2^26, {batch}: keys only, "
            "unstable and stable pairs == the stable reference")
        return routes

    # keys far from uniform: normal variates crowd a few exponents, 16
    # distinct keys make groups of 2^16 equal ones in a 2^20 segment.  In
    # segments shorter than a leaf run that costs nothing; in longer ones
    # the engine's runs overflow, which the sample gate should foresee
    normal = torch.randn(SEG_N, device=dev, generator=gen)
    dup16 = (torch.randint(0, 16, (SEG_N,), dtype=torch.int32, device=dev,
                           generator=gen) * 0x01234567).view(torch.uint32)
    big_offs = torch.arange(65, dtype=torch.int64).numpy() << 20
    seg_cases = (
        ("uniform uint32, 2^16 equal segments", sk, eq_offs, True),
        ("uniform uint32, 2^16 ragged segments", sk, rag_offs, False),
        ("float32 normal variates, 2^16 equal segments", normal, eq_offs,
         False),
        ("float32 normal variates, 2^16 ragged segments", normal, rag_offs,
         False),
        ("16 distinct uint32 keys, 64 segments of 2^20", dup16, big_offs,
         False))
    seg_routes = {batch: seg_batch(batch, keys, offs, must_run)
                  for batch, keys, offs, must_run in seg_cases}
    # the gate's verdict held against the engine itself: with the gate
    # off, a batch it turned away must overflow
    gate_min_n = planner.PLANNER_MIN_N
    for batch, keys, offs, _ in seg_cases:
        if "gated" not in seg_routes[batch]:
            continue
        planner.PLANNER_MIN_N = 1 << 62
        _, c, _ = drive(lambda: tpusort_torch.segmented_sort(keys, offs))
        planner.PLANNER_MIN_N = gate_min_n
        print(f"route: segmented_sort keys only, {batch}, sample gate off: "
              f"{seg_route(c, len(seg2_plan.passes))[1]}; {c}", flush=True)
        check(c["overflow_fallbacks"] == 1,
              f"segmented_sort {batch}: the sample gate turned away a "
              f"batch the engine sorts: {c}")

    # ---- phase 26: K7 vs plain at the rdma route's send shape ---------
    from tpusort_torch.parallel import (
        InProcessComm, make_global_sort, make_global_sort_planes)
    from tpusort_torch.parallel.ring import (
        ring_all_to_all, ring_all_to_all_plain)

    gs_d = 8
    gs_shard = MAIN_N // gs_d
    # the rdma + windows route's window at capacity factor 2.0: whole
    # engine tiles (K 16384), 2^23 words at 2^28 keys
    gs_cap = -(-2 * (gs_shard // gs_d) // 16384) * 16384
    sends = [random_i32(gs_d * gs_cap).reshape(gs_d, gs_cap)
             for _ in range(gs_d)]
    k7_err = 0
    for r in range(gs_d):
        got, want = ring_all_to_all(sends, r), ring_all_to_all_plain(sends, r)
        check(same_bits(got, want), f"K7 rank {r}: differs from plain")
        k7_err = max(k7_err, max_abs_err(got, want))
    del got, want

    def k7_all():
        return [ring_all_to_all(sends, r) for r in range(gs_d)]

    def k7_plain_all():
        return [ring_all_to_all_plain(sends, r) for r in range(gs_d)]

    t7 = time_alt(k7_all, k7_plain_all,
                  lambda: torch.stack(sends).transpose(0, 1).contiguous())
    # one row is one operand's exchange over the d shards: d launches
    results[f"K7 ({gs_d}, {gs_cap}) x {gs_d} shards"] = (
        k7_err, *t7[:2], 2 * gs_d * gs_d * gs_cap, 0, t7[2])
    notes[f"K7 ({gs_d}, {gs_cap}) x {gs_d} shards"] = (
        "one operand's exchange: one launch a shard, each pulling window r "
        "of the d send buffers; library: torch.stack of the send buffers, "
        "transposed, made contiguous")
    del sends
    log(f"phase 26 ok: K7 == plain bit for bit for all {gs_d} ranks at "
        f"({gs_d}, {gs_cap}) send buffers; max_abs_err {k7_err}")

    # ---- phase 27: K1 emit-only vs plain at the windows finish's pass 0 --
    wcfg = get_config(32, False, "cuda")
    wkw = wcfg.plan_kwargs()
    wkw.pop("min_n")
    w_plan = msd.plan_msd(gs_shard, 0, 32, t1_force=gs_d * gs_cap // 16384,
                          **wkw)
    check(w_plan is not None and w_plan.m1 == gs_d * gs_cap,
          f"no windows plan at 2^28 / {gs_d} shards, factor 2.0: {w_plan}")
    log(f"windows plan for n_shard={gs_shard}, {gs_d} windows of {gs_cap}: "
        f"{[(p.n_seg, p.t_seg, p.k, p.s) for p in w_plan.passes]} "
        f"leaf {msd.leaf_tiles(w_plan)}")
    wspec = w_plan.passes[0]
    w_t = wspec.n_seg * wspec.t_seg
    # each window a sorted run of unique keys, its valid prefix about
    # n_shard / d long, a random tail
    w_counts = torch.randint(gs_shard // gs_d - 4096, gs_shard // gs_d + 4097,
                             (gs_d,), dtype=torch.int64, device=dev,
                             generator=gen)
    w_keys = (torch.sort(unique_i32(gs_d * gs_cap).reshape(gs_d, gs_cap)
                         ^ dtypes.INT32_MIN, dim=1).values ^ dtypes.INT32_MIN)
    w_pos = torch.arange(gs_cap, device=dev)[None, :]
    w_keys = torch.where(w_pos < w_counts[:, None], w_keys,
                         random_i32(gs_d * gs_cap).reshape(gs_d, gs_cap))
    w_val = random_i32(gs_d * gs_cap)
    c0 = (w_counts[:, None] - torch.arange(gs_cap // 16384, device=dev)
          * 16384).clamp(0, 16384).to(torch.int32).reshape(w_t, 1)
    n_valid = int(w_counts.sum())
    for name, vals_ in (("K1 emit-only keys", []),
                        ("K1 emit-only key+value", [w_val.reshape(w_t, -1)])):
        tiles = [w_keys.reshape(w_t, 16384)]
        kw0 = dict(q_in=16384, r=wspec.r, s=wspec.s, lo_bit=wspec.lo_bit,
                   width=wspec.width, t_seg=wspec.t_seg)

        def kernel():
            return partition_pass_fused(tiles, vals_, c0, sorted_run=16384,
                                        unstable=True, **kw0)

        def plain():
            return partition_pass_fused_plain(tiles, vals_, c0, n=None,
                                              **kw0)

        (k_out, k_cnt), c, modes = drive(kernel)
        check(modes == {("K1", 1, len(vals_), "emit-only"): 1},
              f"{name}: not one emit-only K1 launch: {modes}")
        p_out, p_cnt = plain()
        check(torch.equal(k_cnt, p_cnt), f"{name}: counts differ")
        check(int(k_cnt.sum()) == n_valid, f"{name}: counts != valid slots")
        m = valid_slots(k_cnt, wspec)
        err = 0
        for k, p in zip(k_out, p_out):
            check(same_bits(k[m], p[m]), f"{name}: valid slots differ")
            err = max(err, max_abs_err(k[m], p[m]))
        del k_out, p_out, m
        tk, tp, tl = time_alt(
            kernel, plain,
            lambda: partition_library(tiles, vals_, c0,
                                      dict(kw0, n=None)))
        n_ops = 1 + len(vals_)
        results[name] = (err, tk, tp,
                         2 * n_valid * n_ops + w_t + w_t * wspec.r, n_valid,
                         tl)
        log(f"phase 27 ok: {name} == plain at ({w_t}, 16384), S={wspec.s}, "
            f"q_in=16384, sorted_run=16384; max_abs_err {err}")
    del w_keys, w_val, w_pos, c0

    # ---- phase 28: the global sort over 8 in-process shards at 2^28 ------
    def check_pairs(name, keys, ko, vo, want):
        ki = keys.view(torch.int32)
        check(same_bits(ko, want), f"{name}: keys differ from the reference")
        check(same_bits(ki[vo.view(torch.int32).long()], ko.view(torch.int32))
              and same_bits(torch.sort(vo.view(torch.int32)).values,
                            vals.view(torch.int32)),
              f"{name}: values are not a permutation riding with their keys")

    x_ref = reference_sort(x)
    gs_cases = {}          # name -> (sorter, call), timed in phase 17

    def gs_case(name, sorter, call, expect):
        """Run one global sort with the counters at 0; ``expect(c,
        modes)`` says what its route must have launched."""
        out, c, modes = drive(lambda: call(sorter))
        print(f"route: global_sort {name}: {c} {modes}", flush=True)
        check(expect(c, modes), f"global_sort {name}: unexpected route: "
              f"{c} {modes}")
        gs_cases[name] = (sorter, call)
        return out, c, modes

    def emit_only(modes):
        return sum(v for m, v in modes.items() if m[-1] == "emit-only")

    comm8 = InProcessComm(gs_d, dev)
    s_col = make_global_sort(comm8, finish="collapse")
    got, _, modes = gs_case(
        "collective + collapse, keys", s_col, lambda s: s(x),
        lambda c, m: c["k4_launches"] == gs_d and c["k7_launches"] == 0
        and c["exchange_fallbacks"] == 0 and c["overflow_fallbacks"] == 0
        and emit_only(m) == 0)
    check(same_bits(got, x_ref), "global_sort collapse: keys differ")
    col_cap = max(g[-1] for g in s_col._shard_fns)
    launches[f"K4c ({gs_d}, {col_cap}) 1 operand"] = modes.get(("K4", 0, 1),
                                                              0)
    log("phase 28 ok: global_sort 2^28 over 8 shards, collective exchange, "
        f"collapse finish (K4 at ({gs_d}, {col_cap})) == reference")
    # at 2^28 a window holds 2^22 keys, 256 tiles: each tile of pass 0 is a
    # slice of one sorted run and falls into a few digits, so the windows
    # finish overflows and every shard compacts and sorts exactly (counted)
    s_rdma = make_global_sort(comm8, finish="windows", exchange="rdma",
                              capacity_factor=2.0)
    got, c, modes = gs_case(
        "rdma + windows (factor 2.0), keys", s_rdma, lambda s: s(x),
        lambda c, m: c["k7_launches"] == gs_d
        and c["exchange_fallbacks"] == 0 and emit_only(m) == gs_d)
    print(f"windows finish at 2^28 / {gs_d} shards: {c['overflow_fallbacks']}"
          f" of {gs_d} shards overflowed and took the exact sort", flush=True)
    check(same_bits(got, x_ref), "global_sort rdma + windows: keys differ")
    check(max(g[-1] for g in s_rdma._shard_fns) == gs_cap,
          f"rdma + windows: capacity {list(s_rdma._shard_fns)}")
    launches[f"K7 ({gs_d}, {gs_cap}) x {gs_d} shards"] = \
        modes.get(("K7", 0, 1), 0)
    launches["K1 emit-only keys"] = modes.get(("K1", 1, 0, "emit-only"), 0)
    log("phase 28 ok: global_sort rdma + windows == reference: K7 once a "
        "shard, K1 emit-only once a shard")
    (ko, vo), _, modes = gs_case(
        "rdma + windows (factor 2.0), unstable u32 + u32 pairs", s_rdma,
        lambda s: s(x, vals),
        lambda c, m: c["k7_launches"] == 2 * gs_d
        and c["exchange_fallbacks"] == 0 and emit_only(m) == gs_d)
    check_pairs("global_sort rdma pairs", x, ko, vo, x_ref)
    launches["K1 emit-only key+value"] = modes.get(("K1", 1, 1, "emit-only"),
                                                   0)
    del ko, vo
    log("phase 28 ok: global_sort rdma + windows pairs: keys exact, values "
        "a permutation riding with their keys")
    s_auto = make_global_sort(comm8)
    got, _, _ = gs_case(
        "default (collective, auto -> collapse), Zipf 1.1", s_auto,
        lambda s: s(zu),
        lambda c, m: c["exchange_fallbacks"] == 0
        and c["k4_launches"] == gs_d)
    check(same_bits(got, reference_sort(zu)), "global_sort Zipf: differs")
    log("phase 28 ok: global_sort of 2^28 Zipf 1.1 keys == reference")
    # where a window fits one tile (2^20 keys: 2^14 a window) "auto" takes
    # the windows finish, and it runs without overflow
    xs20 = x[:1 << 20]
    got, _, modes = gs_case(
        "default (auto -> windows), 2^20 keys", s_auto, lambda s: s(xs20),
        lambda c, m: c["exchange_fallbacks"] == 0 and c["k4_launches"] == 0
        and c["overflow_fallbacks"] == 0 and emit_only(m) == gs_d)
    check(same_bits(got, reference_sort(xs20)),
          "global_sort 2^20 windows: differs")
    log("phase 28 ok: global_sort of 2^20 keys through the windows finish "
        "with no overflow == reference")
    s_pre = make_global_sort(comm8, capacity_factor=1.0)
    got, _, _ = gs_case(
        "presorted, factor 1.0 (the gathered fallback)", s_pre,
        lambda s: s(presorted),
        lambda c, m: c["exchange_fallbacks"] == 1 and c["k7_launches"] == 0
        and c["k4_launches"] == 0)
    check(same_bits(got, presorted), "global_sort presorted: differs")
    log("phase 28 ok: presorted keys at factor 1.0 overflowed the exchange "
        "and the gathered exact sort took over")
    s_ad = make_global_sort(InProcessComm(gs_d, dev), capacity_factor=1.0,
                            adaptive=True)
    got, c1, _ = drive(lambda: s_ad(x))
    check(same_bits(got, x_ref) and c1["exchange_fallbacks"] == 1,
          f"adaptive: the first call at factor 1.0 did not overflow: {c1}")
    got, _, _ = gs_case(
        "adaptive, after one overflow", s_ad, lambda s: s(x),
        lambda c, m: c["exchange_fallbacks"] == 0)
    check(same_bits(got, x_ref), "global_sort adaptive: differs")
    log(f"phase 28 ok: adaptive: the factor doubled ({s_ad._factors}), the "
        "second call took no fallback")
    s_u64 = make_global_sort_planes(comm8, key_dtype="uint64")
    u64_planes = tuple(p.view(torch.uint32) for p in
                       dtypes.split64(x64.view(torch.uint64)))
    (ohi, olo), _, _ = gs_case(
        "make_global_sort_planes u64 2^27", s_u64, lambda s: s(u64_planes),
        lambda c, m: c["exchange_fallbacks"] == 0
        and c["k4_launches"] == gs_d)
    want_hi, want_lo = dtypes.split64(reference_sort(x64.view(torch.uint64)))
    check(same_bits(ohi.view(torch.int32), want_hi)
          and same_bits(olo.view(torch.int32), want_lo),
          "global_sort u64 planes: differs from the reference")
    del got, ohi, olo, want_hi, want_lo
    log("phase 28 ok: make_global_sort_planes of 2^27 uint64 keys == "
        "reference")

    # K4 at the collapse finish's shape: the received (d, capacity) runs
    col_segs = [random_i32(gs_d * col_cap).reshape(gs_d, col_cap)]
    col_counts = torch.full((gs_d,), gs_shard // gs_d, dtype=torch.int32,
                            device=dev) + torch.randint(
        -4096, 4097, (gs_d,), dtype=torch.int32, device=dev, generator=gen)
    col_counts[-1] = gs_shard - int(col_counts[:-1].sum())
    k_dense = collapse_segments(col_segs, col_counts, gs_shard)
    p_dense = collapse_segments_plain(col_segs, col_counts, gs_shard)
    check(same_bits(k_dense[0], p_dense[0]),
          f"K4 at ({gs_d}, {col_cap}): differs from plain")
    t4c = time_alt(
        lambda: collapse_segments(col_segs, col_counts, gs_shard),
        lambda: collapse_segments_plain(col_segs, col_counts, gs_shard),
        lambda: k4_library(col_segs, col_counts))
    results[f"K4c ({gs_d}, {col_cap}) 1 operand"] = (
        max_abs_err(k_dense[0], p_dense[0]), *t4c[:2], 2 * gs_shard + gs_d,
        0, t4c[2])
    dev_ms, kernels = device_ms(
        lambda: collapse_segments(col_segs, col_counts, gs_shard))
    print(f"trace: K4c at the collapse finish ({gs_d}, {col_cap}): "
          f"CUDA-event median {statistics.median(t4c[0]):.3f} ms, device "
          f"{dev_ms:.3f} ms ({kernels}) on {card}", flush=True)
    del col_segs, k_dense, p_dense
    log(f"phase 28 ok: K4 == plain at the collapse finish's ({gs_d}, "
        f"{col_cap})")

    # ---- phase 17: timings --------------------------------------------
    xi = x.view(torch.int32)
    sort_times, torch_times = time_pair(lambda: tpusort_torch.sort(x),
                                        lambda: torch.sort(xi))
    sort_ms = statistics.median(sort_times)
    torch_ms = statistics.median(torch_times)
    print(f"time: tpusort_torch.sort 2^28 uint32 {fmt(sort_times)} "
          f"({MAIN_N / sort_ms / 1e6:.3f} G keys/s) vs torch.sort of the "
          f"same keys as int32 {fmt(torch_times)} "
          f"({MAIN_N / torch_ms / 1e6:.3f} G keys/s) on {card}", flush=True)
    xs = (xi ^ dtypes.INT32_MIN)          # unsigned order as int32 order

    def torch_pairs():
        s = torch.sort(xs, stable=True)
        return s.values, vals.view(torch.int32)[s.indices]

    pair_times, tpair_times = time_pair(
        lambda: tpusort_torch.sort_pairs(x, vals), torch_pairs)
    print(f"time: tpusort_torch.sort_pairs 2^28 uint32 + uint32 "
          f"{fmt(pair_times)} ({MAIN_N / statistics.median(pair_times) / 1e6:.3f}"
          f" G pairs/s) vs torch.sort(stable=True) + values[idx] "
          f"{fmt(tpair_times)} "
          f"({MAIN_N / statistics.median(tpair_times) / 1e6:.3f} G pairs/s) "
          f"on {card}", flush=True)
    del xs
    x64s = x64 ^ (-(1 << 63))             # unsigned order as int64 order
    u64_times, tu64_times = time_pair(lambda: tpusort_torch.sort(u64),
                                      lambda: torch.sort(x64s))
    print(f"time: tpusort_torch.sort 2^27 uint64 {fmt(u64_times)} "
          f"({U64_N / statistics.median(u64_times) / 1e6:.3f} G keys/s) vs "
          f"torch.sort of the keys as int64, sign bit flipped "
          f"{fmt(tu64_times)} "
          f"({U64_N / statistics.median(tu64_times) / 1e6:.3f} G keys/s) "
          f"on {card}", flush=True)
    vi = vals.view(torch.int32)

    def torch_range_pairs():
        s = torch.sort(xi & 0xFFFFFF, stable=True)
        return xi[s.indices], vi[s.indices]

    r24_times, tr24_times = time_pair(
        lambda: tpusort_torch.sort_pairs(x, vals, end_bit=24),
        torch_range_pairs)
    print(f"time: tpusort_torch.sort_pairs(end_bit=24) 2^28 uint32 + uint32 "
          f"{fmt(r24_times)} "
          f"({MAIN_N / statistics.median(r24_times) / 1e6:.3f} G pairs/s) vs "
          f"torch.sort(stable=True) of the masked keys + keys[idx] + "
          f"values[idx] {fmt(tr24_times)} "
          f"({MAIN_N / statistics.median(tr24_times) / 1e6:.3f} G pairs/s) "
          f"on {card}", flush=True)

    def torch_u64_pairs():
        s = torch.sort(x64s, stable=True)
        return x64[s.indices], v64[s.indices]

    u64p_times, tu64p_times = time_pair(
        lambda: tpusort_torch.sort_pairs(u64, v64), torch_u64_pairs)
    print(f"time: tpusort_torch.sort_pairs 2^27 uint64 + int64 (stable) "
          f"{fmt(u64p_times)} "
          f"({U64_N / statistics.median(u64p_times) / 1e6:.3f} G pairs/s) vs "
          f"torch.sort(stable=True) of the keys as int64, sign bit flipped, "
          f"+ keys[idx] + values[idx] {fmt(tu64p_times)} "
          f"({U64_N / statistics.median(tu64p_times) / 1e6:.3f} G pairs/s) "
          f"on {card}", flush=True)
    for name, keys in (("Zipf 1.1", zu), ("entropy-3", e3),
                       ("presorted", presorted)):
        ki = keys.view(torch.int32)
        t_tier, t_forced, t_torch = time_alt(
            lambda: tpusort_torch.sort(keys),
            lambda: tapi._ENGINES["msd"]((ki,), (), config=cfg, **bits32),
            lambda: torch.sort(ki))
        print(f"time: tpusort_torch.sort {name} 2^28 uint32 "
              f"{fmt(t_tier)} ({MAIN_N / statistics.median(t_tier) / 1e6:.3f}"
              f" G keys/s) vs radix then exact (the registered msd engine) "
              f"{fmt(t_forced)} vs torch.sort of the same keys as int32 "
              f"{fmt(t_torch)} on {card}", flush=True)
    bku = bk.view(torch.uint32).reshape(1 << 17, 2048)
    bkf = (bk ^ dtypes.INT32_MIN).reshape(1 << 17, 2048)
    t_b, t_t = time_pair(lambda: tpusort_torch.sort_batched(bku),
                         lambda: torch.sort(bkf, dim=1))
    print(f"time: tpusort_torch.sort_batched (2^17, 2048) uint32 {fmt(t_b)} "
          f"vs torch.sort(dim=1) of the same rows {fmt(t_t)} on {card}",
          flush=True)
    bku = bk.view(torch.uint32).reshape(1 << 14, 1 << 14)
    bkf = bkf.reshape(1 << 14, 1 << 14)
    bv = rows_v.reshape(1 << 14, 1 << 14)

    def torch_batched_pairs():
        s_ = torch.sort(bkf, dim=1)
        return s_.values, torch.gather(bv, 1, s_.indices)

    t_b, t_t = time_pair(lambda: tpusort_torch.sort_batched(bku, bv),
                         torch_batched_pairs)
    print(f"time: tpusort_torch.sort_batched (2^14, 16384) uint32 + int32 "
          f"{fmt(t_b)} vs torch.sort(dim=1) + gather {fmt(t_t)} on {card}",
          flush=True)
    del bku, bkf, bv
    for batch, keys, offs, _ in seg_cases:
        sid = seg_ids(offs).long()
        plane = dtypes.twiddle_in(keys)[0][0]
        kv = keys.view(torch.int32)   # torch indexes no uint32 on a card

        def torch_segmented(pairs):
            s_ = torch.sort((sid << 32) | (plane.long() & 0xFFFFFFFF),
                            stable=True)
            return (kv[s_.indices], svals[s_.indices]) if pairs \
                else kv[s_.indices]

        for (mode, vals_, stable_), kind in zip(
                (("keys only", None, True), ("unstable pairs", svals, False),
                 ("stable pairs", svals, True)), seg_routes[batch]):
            t_s, t_t = time_pair(
                lambda: tpusort_torch.segmented_sort(keys, offs, vals_,
                                                     stable=stable_),
                lambda: torch_segmented(vals_ is not None))
            print(f"time: tpusort_torch.segmented_sort 2^26, {batch}, "
                  f"{mode} ({kind}) {fmt(t_s)} vs torch.sort(stable=True) "
                  f"of the (segment, key) int64 composite + gathers "
                  f"{fmt(t_t)} on {card}", flush=True)
            if kind == "gated":
                planner.PLANNER_MIN_N = 1 << 62
                (t_off,) = time_alt(
                    lambda: tpusort_torch.segmented_sort(
                        keys, offs, vals_, stable=stable_))
                planner.PLANNER_MIN_N = gate_min_n
                print(f"time: tpusort_torch.segmented_sort 2^26, {batch}, "
                      f"{mode}, sample gate off (the engine, its overflow, "
                      f"then the exact sort) {fmt(t_off)} on {card}",
                      flush=True)
        del sid, plane, kv
    for name, (sorter, call) in gs_cases.items():
        whole = {"make_global_sort_planes u64 2^27": x64s}.get(name, None)
        if whole is None:
            keys_ = zu if "Zipf" in name else (
                presorted if "presorted" in name else (
                    xs20 if "2^20" in name else x))
            whole = keys_.view(torch.int32) ^ dtypes.INT32_MIN
        t_g, t_t = time_pair(lambda: call(sorter), lambda: torch.sort(whole))
        print(f"time: global_sort over {gs_d} in-process shards, {name} "
              f"{fmt(t_g)} vs torch.sort of the whole tensor {fmt(t_t)} on "
              f"{card}", flush=True)
    log("phase 17 ok")

    # ---- phase 29: K8 and the per-phase engine (the profiler's path) -----
    # after phase 17, whose global sort timings need the memory as the
    # phases before left it; the kernel times of every phase print below
    torch.cuda.empty_cache()
    def k8_vs_plain(name, ops, run_counts, s_prev, spec, nplanes):
        """K8 kernel vs plain at one pass of the per-phase engine, fed as
        ``_partition_pass`` feeds it (every operand a data operand);
        returns (max abs err, kernel times, plain times, words, operations,
        library times).  The sortkey is unique, so the valid slots compare
        bit for bit.  The library call sorts the sortkey with torch.sort,
        gathers its indices at the run positions (computed beforehand from
        the starts) and gathers each data operand there."""
        t = spec.n_seg * spec.t_seg
        tiled = [o.reshape(t, spec.k) for o in ops]
        sortkey, starts, counts = msd.pass_sortkey(tiled[:nplanes],
                                                   run_counts, s_prev, spec)
        k8_ops = [sortkey, *tiled]
        got = partition_tiles(k8_ops, starts, r=spec.r, s=spec.s)
        want = partition_tiles_plain(k8_ops, starts, r=spec.r, s=spec.s)
        cl = counts.clamp(max=spec.s)
        m = (torch.arange(spec.s, device=dev) < cl[..., None]) \
            .reshape(t, spec.r * spec.s)
        err = 0
        for g, w in zip(got, want):
            check(same_bits(g[m], w[m]), f"K8 {name}: valid slots differ")
            err = max(err, max_abs_err(g[m], w[m]))
        n_valid = int(m.sum())
        del got, want, m
        pos = (starts.long()[:, :, None]
               + torch.arange(spec.s, device=dev)).clamp(0, spec.k - 1) \
            .reshape(t, spec.r * spec.s)

        def library():
            src = torch.gather(torch.sort(sortkey, dim=1).indices, 1, pos)
            return [torch.gather(o, 1, src) for o in tiled]

        times = time_alt(
            lambda: partition_tiles(k8_ops, starts, r=spec.r, s=spec.s),
            lambda: partition_tiles_plain(k8_ops, starts, r=spec.r,
                                          s=spec.s), library)
        del pos
        log(f"K8 {name} == plain at ({t}, {spec.k}), R={spec.r}, "
            f"S={spec.s}, {len(tiled)} data operand(s); max_abs_err {err}")
        # the whole sortkey read once, the starts, and each data operand's
        # valid words read once and written once (the slots past a run's
        # count repeat clamped slots of the tile: no caller needs them)
        return (err, *times[:2],
                t * spec.k + starts.numel() + 2 * n_valid * len(tiled),
                n_valid * log2(spec.k), times[2])

    x_ops, x_np, x_plan = msd_phase_inputs(x)
    check([(p.k, p.s) for p in x_plan.passes]
          == [(16384, 768), (16384, 512), (16384, 512)]
          and x_plan.seg == 12288 and not msd.leaf_is_wide(x_plan)
          and msd.key_from_sortkey(x_plan, 1),
          f"the per-phase plan at 2^28: {x_plan}")
    sp0 = x_plan.passes[0]
    rc0 = msd.initial_run_counts(MAIN_N, x_plan, dev)
    for name, data in (("keys", []), ("key+value", [vals.view(torch.int32)])):
        ops0 = [*x_ops, *(torch.nn.functional.pad(v, (0, x_plan.m1 - MAIN_N))
                          for v in data)]
        results[f"K8 pass 0 {name}"] = k8_vs_plain(
            f"pass 0 {name}", ops0, rc0, sp0.k, sp0, x_np)
        ops1, rc1, ovf = msd._partition_pass(ops0, slice(0, 1), rc0, sp0.k,
                                             sp0)
        check(not bool(ovf), f"K8 pass 0 {name}: uniform keys overflowed")
        del ops0
        results[f"K8 pass 1 {name}"] = k8_vs_plain(
            f"pass 1 {name}", ops1, rc1, sp0.s, x_plan.passes[1], x_np)
        del ops1, rc1
    del x_ops, rc0
    log("phase 29 ok: K8 == plain at the 2^28 plan's pass 0 and pass 1, "
        "keys and key + value")

    for name, pairs in (("keys", False), ("pairs", True)):
        ops, nplanes, plan_ = msd_phase_inputs(x, pairs)
        (outs, ovf), c, modes = drive(
            lambda: run_msd_phases(ops, nplanes, MAIN_N, plan_))
        del ops
        print(f"route: per-phase engine 2^28 {name}: {c} {modes}",
              flush=True)
        check(not bool(ovf), f"per-phase 2^28 {name}: overflow")
        check(c == dict(quiet, k8_launches=3, k3_launches=1, k4_launches=1),
              f"per-phase 2^28 {name}: not K8 x 3, K3, K4: {c}")
        check(same_bits(outs[0].view(torch.uint32), x_ref),
              f"per-phase 2^28 {name}: keys differ from the reference")
        if pairs:
            _, (order,) = reference_sort(x, (vals.view(torch.int32),))
            check(same_bits(outs[1], order),
                  "per-phase 2^28 pairs: values differ from the stable "
                  "reference")
            del order
        for mode in ("pass 0", "pass 1"):
            launches[f"K8 {mode} {'key+value' if pairs else 'keys'}"] = \
                modes.get(("K8", 1, 1 + pairs), 0)
        del outs
        log(f"phase 29 ok: the per-phase chain at 2^28 {name} == stable "
            "reference: K8 x 3, K3 (the key rebuilt), K4")

    ops, nplanes, plan64 = msd_phase_inputs(u64)
    check(msd.leaf_is_wide(plan64) and nplanes == 2,
          f"the per-phase plan at 2^27 uint64: {plan64}")
    (outs, ovf), c, modes = drive(
        lambda: run_msd_phases(ops, nplanes, U64_N, plan64))
    print(f"route: per-phase engine 2^27 uint64: {c} {modes}", flush=True)
    check(not bool(ovf) and c == dict(quiet, k8_launches=3, k9_launches=1,
                                      k4_launches=1),
          f"per-phase 2^27 uint64: not K8 x 3, K9, K4 without overflow: {c}")
    check(same_bits(dtypes.twiddle_out(tuple(outs),
                                       dtypes.traits_for(torch.uint64)),
                    reference_sort(u64)),
          "per-phase 2^27 uint64: differs from the reference")
    del outs
    # K9 at the wide leaf's shape: the masked planes and the position as
    # keys, the two key planes riding
    rc = msd.initial_run_counts(U64_N, plan64, dev)
    s_prev = plan64.passes[0].k
    for spec in plan64.passes:
        ops, rc, _ = msd._partition_pass(ops, slice(0, 2), rc, s_prev, spec)
        s_prev = spec.s
    ctable, q = msd.counts_table(rc, s_prev)
    wide_ops, ct = msd.wide_leaf_operands(ops, 2, ctable, q, plan64)
    del ops, ctable
    got = sort_tiles_counts(wide_ops, ct, q, num_keys=3)
    want = sort_tiles_counts_plain(wide_ops, ct, q, 3)
    head = torch.arange(plan64.seg, device=dev)[None, :] \
        < ct.sum(dim=1)[:, None]
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        check(same_bits(g, w) if i < 3 else same_bits(g[head], w[head]),
              f"K9 wide leaf: operand {i} differs from plain")
        err = max(err, max_abs_err(g, w) if i < 3
                  else max_abs_err(g[head], w[head]))
    del got, want
    w_mode = (f"K9 wide leaf ({plan64.n_segments}, {plan64.seg}) 3 planes "
              "+ 2 values")
    # the library call: the third plane is the slot position, so the order
    # is the stable order of the two masked planes' int64 composite
    w_valid = (torch.arange(plan64.seg, device=dev) % q)[None, :] \
        < ct.repeat_interleave(q, dim=1)
    w_comp = composite64(wide_ops[0], wide_ops[1])

    def wide_library():
        order = torch.sort(torch.where(w_valid, w_comp, INT64_MAX), dim=1,
                           stable=True).indices
        return [torch.gather(o, 1, order) for o in wide_ops[2:]]

    tk, tp, tl = time_alt(
        lambda: sort_tiles_counts(wide_ops, ct, q, num_keys=3),
        lambda: sort_tiles_counts_plain(wide_ops, ct, q, 3), wide_library)
    n_valid = int(ct.sum())
    results[w_mode] = (err, tk, tp, n_valid * 5 + head.numel() * 3
                       + n_valid * 2 + ct.numel(),
                       n_valid * log2(plan64.seg), tl)
    del w_valid, w_comp
    launches[w_mode] = modes.get(("K9", 3, 2), 0)
    del wide_ops, ct, head
    log(f"phase 29 ok: the per-phase chain at 2^27 uint64 == reference (K8 "
        f"x 3, K9, K4); {w_mode} == plain, max_abs_err {err}")

    for pairs in (False, True):
        prof = profile_msd_phases(MAIN_N, pairs=pairs)
        print(prof.table(), flush=True)
        m = prof.runs[0]
        check(len(m.arrays.get("partition_ms", [])) == 3
              and all(m.metrics.get(k, 0) > 0
                      for k in ("leaf_ms", "collapse_ms", "fused_total_ms"))
              and m.metrics["overflow"] is False,
              f"profile_msd_phases(2^28, pairs={pairs}): {m}")
        print(f"profile: {prof.json_lines()} on {card}", flush=True)
    del prof
    log("phase 29 ok: profile_msd_phases at 2^28, keys and pairs; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")

    # ---- phase 30: K3, K9 and K10 vs plain at the edge shapes -----------
    torch.cuda.empty_cache()
    instances = ptxas_spills(
        _build.BUILD_DIR / "build.log",
        lambda f: "sort_tiles_kernel" in f or "sort_tiles_valid_kernel" in f,
        lambda f: "sort_tiles.cu")
    # the packed leaf's runs body (sort_tiles_kernel<NK>, whose parameters
    # begin with an Operands): one instance for 1 and 2 key planes
    runs_inst = {k: v for k, v in instances.items() if "8Operands" in k}
    for k in runs_inst:
        del instances[k]
    # every (planes, payloads, slots a thread) whose slots fit 64 registers
    # (csrc/reg_sort.cuh: fits_registers): K3 has one plane, K9/K10 1-3
    n_inst = sum(e * (nk + idx) <= 64 for e in (4, 8, 16, 32)
                 for idx in (0, 1) for nk in (1, 1, 2, 3))
    check(len(instances) == n_inst and len(runs_inst) == 2,
          f"sort_tiles.cu: {len(instances)} row instances and "
          f"{len(runs_inst)} of the runs body in the build log, expected "
          f"{n_inst} and 2")
    check(not any(sum(v) for v in (*instances.values(),
                                   *runs_inst.values())),
          "sort_tiles.cu: an instance spills: "
          f"{[k for k, v in {**instances, **runs_inst}.items() if sum(v)]}")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def rows_to_fill(p_: int) -> int:
        """Rows enough to give every SM 16 CTAs of 128-slot rows, or two
        of 32,768 (2^16 slots an SM, 2^23 words an operand)."""
        return n_sm * max(2, (1 << 16) // p_)

    def edge_keys(t, k):
        """16 distinct words over the range and a block of 0xFFFFFFFF."""
        x = torch.randint(0, 16, (t, k), device=dev, generator=gen) \
            .to(torch.int32) * 0x10EF0F01
        x[:, k // 4: k // 4 + max(k // 8, 1)] = -1
        return x

    def off16(x: torch.Tensor) -> torch.Tensor:
        """The same words in a view that starts 4 bytes past a 16-byte
        boundary (what the vector path must not take)."""
        buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=dev)
        v = buf[1:1 + x.numel()].view(x.shape)
        v.copy_(x)
        return v

    n_edge = 0
    for lp in range(7, 16):
        p_ = 1 << lp
        for k in (p_, p_ - 128):
            if k == 0:
                continue
            for nv in (0, 1, 8):
                for t, shift in ((1, False), (rows_to_fill(p_), True)):
                    ops = [edge_keys(t, k)] + \
                        [random_i32(t * k).reshape(t, k) for _ in range(nv)]
                    if shift:
                        ops = [off16(o) for o in ops]
                        check(ops[0].data_ptr() % 16 == 4,
                              "phase 30: the shifted view is aligned")
                    got, want = sort_tiles(ops), sort_tiles_plain(ops)
                    check(all(same_bits(g, w) for g, w in zip(got, want)),
                          f"phase 30: K3 ({t}, {k}) + {nv} values "
                          f"(shifted {shift}) differs from plain")
                    n_edge += 1
                    del ops, got, want
    log(f"phase 30 ok: K3 == plain bit for bit (payloads too: index ties "
        f"make it stable) at every P from 128 to 32768, K = P and P - 128, "
        f"0, 1 and 8 payloads, T = 1 and enough rows to fill the "
        f"{n_sm} SMs (off 16 bytes): {n_edge} calls")
    n_edge = 0
    for nk in (1, 2, 3):
        for lp in range(7, 16):
            p_ = 1 << lp
            for k in (p_, p_ - 128):
                if k == 0:
                    continue
                runs = [0] + [1 << r for r in range(7, lp + 1)
                              if k % (1 << r) == 0 and (p_ - k) % (1 << r) == 0]
                for i, run in enumerate(runs):
                    nv = (0, 1, 8)[i % 3]
                    if tile_smem_bytes(p_, nk, nv > 0) > SMEM_MAX:
                        continue
                    t, shift = ((1, False), (rows_to_fill(p_), True))[i % 2]
                    q_ = run or 128
                    planes = [edge_keys(t, k) for _ in range(nk)]
                    vals_ = [random_i32(t * k).reshape(t, k)
                             for _ in range(nv)]
                    cnts = torch.randint(0, q_ + 1, (t, k // q_),
                                         dtype=torch.int32, device=dev,
                                         generator=gen)
                    valid = (torch.arange(k, device=dev) % q_)[None, :] \
                        < cnts.repeat_interleave(q_, dim=1)
                    if run:      # each run's valid prefix sorted
                        sp, sv = sort_rows_lex(
                            [torch.where(valid, pl, -1).reshape(-1, q_)
                             for pl in planes],
                            [v.reshape(-1, q_) for v in vals_])
                        planes = [torch.where(valid, a.reshape(t, k), pl)
                                  for a, pl in zip(sp, planes)]
                        vals_ = [a.reshape(t, k) for a in sv]
                    ops = planes + vals_
                    if shift:
                        ops = [off16(o) for o in ops]
                    mask = torch.rand(t, k, device=dev, generator=gen) < 0.6
                    for kid, got, want, vmask in (
                            ("K9", sort_tiles_counts(ops, cnts, q_,
                                                     sorted_run=run,
                                                     num_keys=nk),
                             sort_tiles_counts_plain(ops, cnts, q_, nk),
                             valid),
                            ("K10", sort_tiles_masked(ops, mask, num_keys=nk),
                             sort_tiles_masked_plain(ops, mask, nk), mask)):
                        head = torch.arange(k, device=dev)[None, :] \
                            < vmask.sum(dim=1)[:, None]
                        check(all(same_bits(g, w) for g, w in
                                  zip(got[:nk], want[:nk]))
                              and all(same_bits(g[head], w[head]) for g, w
                                      in zip(got[nk:], want[nk:])),
                              f"phase 30: {kid} ({t}, {k}) {nk} planes + "
                              f"{nv} values, sorted_run {run} (shifted "
                              f"{shift}) differs from plain")
                        n_edge += 1
                    del ops, planes, vals_, cnts, valid, mask, got, want
    log(f"phase 30 ok: K9 and K10 == plain (key planes over the tile, "
        f"payloads over the valid prefix) with 1-3 planes at every P from "
        f"128 to the shared-memory limit, K = P and P - 128, every "
        f"sorted_run from 128 to K: {n_edge} calls")

    # ---- phase 31: partition.cu and scanhist.cu at their edges ----------
    torch.cuda.empty_cache()
    spills = ptxas_spills(
        _build.BUILD_DIR / "build.log",
        lambda f: any(k in f for k in ("partition_raw_kernel",
                                       "scan_lookback_kernel",
                                       "digit_histogram_kernel")),
        lambda f: "partition.cu" if "partition_raw" in f else "scanhist.cu")
    # partition.cu: (planes, payloads, slots a thread) whose slots fit 64
    # registers, K1 and K1b each, the merge body's (planes, payloads), K1
    # and K1b each, and the runs body's (1-2 planes, payloads), K1 and K1b
    # each; scanhist.cu: K5 x (uint32, float32) x (aligned, not), and K6 x
    # (register fields, per-warp shared bins)
    n_k1 = 2 * sum(e * (nk + idx) <= 64 for e in (4, 8, 16, 32)
                   for idx in (0, 1) for nk in (1, 2, 3)) + 2 * 6 + 2 * 4
    n_k1_seen = sum("partition_raw_kernel" in k for k in spills)
    n_k6_seen = sum("digit_histogram_kernel" in k for k in spills)
    check(n_k1_seen == n_k1 and n_k6_seen == 2
          and len(spills) == n_k1 + 6,
          f"partition.cu / scanhist.cu: {n_k1_seen} K1 instances, "
          f"{n_k6_seen} K6 and {len(spills) - n_k1_seen - n_k6_seen} others "
          f"in the build log, expected {n_k1}, 2 and 4")
    check(not any(sum(v) for v in spills.values()),
          "partition.cu / scanhist.cu: an instance spills: "
          f"{[k for k, v in spills.items() if sum(v)]}")

    def lex_chunks(planes_, vals_, q_, cnts):
        """Each q_-chunk's valid prefix sorted, payloads carried."""
        t_, k_ = planes_[0].shape
        valid = (torch.arange(k_, device=dev) % q_)[None, :] \
            < cnts.repeat_interleave(q_, dim=1)
        sp, sv = sort_rows_lex(
            [torch.where(valid, pl, -1).reshape(-1, q_) for pl in planes_],
            [v.reshape(-1, q_) for v in vals_])
        return ([torch.where(valid, a.reshape(t_, k_), pl)
                 for a, pl in zip(sp, planes_)],
                [torch.where(valid, a.reshape(t_, k_), v)
                 for a, v in zip(sv, vals_)])

    def edge_vs_plain(what, planes_, vals_, cin, run, kw, spl=None):
        if spl is None:
            got, cnt = partition_pass_fused(planes_, vals_, cin,
                                            sorted_run=run, unstable=True,
                                            **kw)
            want, pcnt = partition_pass_fused_plain(planes_, vals_, cin, **kw)
        else:
            words_, f_ = spl
            got, cnt = partition_pass_fused(
                planes_, vals_, cin, sorted_run=run, unstable=True,
                splitters=words_, splitter_fracs=f_, lo_bit=0, width=1, **kw)
            want, pcnt = partition_pass_splitter_plain(
                planes_, vals_, cin, splitters=words_, splitter_fracs=f_,
                **kw)
        spec = type("Spec", (), dict(s=kw["s"], r=kw["r"],
                                     t_seg=kw["t_seg"],
                                     n_seg=cnt.shape[0] // kw["t_seg"]))
        check(torch.equal(cnt, pcnt), f"phase 31: {what}: counts differ")
        m = valid_slots(cnt, spec)
        check(all(same_bits(g[m], w[m]) for g, w in zip(got, want)),
              f"phase 31: {what}: valid slots differ")

    n_edge, e_t, e_r = 0, 4, 16
    for lk in range(9, 15):
        k = 1 << lk
        e_s = max(128, (3 * k // (2 * e_r)) // 128 * 128)
        for nk in (1, 2, 3):
            for nv in (0, 1, 2, 8):
                for run in [None] + [1 << lr for lr in range(7, lk + 1)]:
                    planes_ = [(torch.randint(0, 16, (e_t, k), device=dev,
                                              generator=gen)
                                .to(torch.int32) * 0x10EF0F01)
                               for _ in range(nk)]
                    planes_[0][:, k // 4: k // 4 + k // 8] = -1
                    vals_ = [random_i32(e_t * k).reshape(e_t, k)
                             for _ in range(nv)]
                    kw = dict(r=e_r, s=e_s, lo_bit=32 * nk - 4, width=4,
                              t_seg=2, q_in=None, n=e_t * k - 999)
                    cin = None
                    if run:
                        cin = torch.randint(0, run + 1, (e_t, k // run),
                                            dtype=torch.int32, device=dev,
                                            generator=gen)
                        planes_, vals_ = lex_chunks(planes_, vals_, run, cin)
                        kw.update(q_in=run, n=None)
                    edge_vs_plain(f"K1 ({e_t}, {k}) {nk} planes + {nv} "
                                  f"values, sorted_run {run}", planes_,
                                  vals_, cin, run, kw)
                    n_edge += 1
    log(f"phase 31 ok: no spill in the {n_k1} instances of partition.cu "
        f"nor the 6 of scanhist.cu; K1 == plain bit for bit (payloads "
        f"too: ties keep their slot order) at K = 2^9 .. 2^14, 1-3 planes, "
        f"0, 1, 2 and 8 payloads, every sorted_run, tied keys with a block "
        f"of 0xFFFFFFFF: {n_edge} calls")
    n_edge = 0
    for lk in range(9, 15):
        k = 1 << lk
        e_s = max(128, (3 * k // (2 * e_r)) // 128 * 128)
        for nk in (1, 2):
            for nv in (0, 1):
                zk = zipf_keys_torch(gen, e_t * k).reshape(e_t, k)
                planes_ = [zk] + [random_i32(e_t * k).reshape(e_t, k)
                                  for _ in range(nk - 1)]
                vals_ = [random_i32(e_t * k).reshape(e_t, k)
                         for _ in range(nv)]
                qs = torch.sort(zk.reshape(-1) ^ dtypes.INT32_MIN).values
                at = (torch.arange(1, e_r, device=dev) * (e_t * k)) // e_r
                words_ = [(qs[at] ^ dtypes.INT32_MIN).expand(
                    e_t, e_r - 1).contiguous()]
                words_ += [torch.zeros(e_t, e_r - 1, dtype=torch.int32,
                                       device=dev) for _ in range(nk - 1)]
                f_ = torch.randint(0, 65537, (e_t, e_r - 1),
                                   dtype=torch.int32, device=dev,
                                   generator=gen)
                for run in (None, 256):
                    kp, kv, cin = planes_, vals_, None
                    kw = dict(r=e_r, s=e_s, t_seg=2, q_in=None,
                              n=e_t * k - 5)
                    if run:
                        cin = torch.randint(run // 2, run + 1,
                                            (e_t, k // run),
                                            dtype=torch.int32, device=dev,
                                            generator=gen)
                        kp, kv = lex_chunks(planes_, vals_, run, cin)
                        kw.update(q_in=run, n=None)
                    edge_vs_plain(f"K1b Zipf ({e_t}, {k}) {nk} planes + "
                                  f"{nv} values, sorted_run {run}", kp, kv,
                                  cin, run, kw, spl=(words_, f_))
                    n_edge += 1
    log(f"phase 31 ok: K1b == plain on Zipf 1.1 keys cut at their "
        f"quantiles, K = 2^9 .. 2^14, 1-2 planes, 0 and 1 payloads, with "
        f"and without a sorted_run: {n_edge} calls")

    # ---- phase 32: bitonic.cu and partition_general.cu at their edges ----
    torch.cuda.empty_cache()
    spills = ptxas_spills(
        _build.BUILD_DIR / "build.log",
        lambda f: ("leaf_collapse_kernel" in f
                   or "partition_general_kernel" in f),
        lambda f: "bitonic.cu" if "leaf_collapse" in f
        else "partition_general.cu")
    # bitonic.cu: the network body's (planes, payloads, slots a thread)
    # whose slots fit 64 registers, as sort_tiles.cu's validity template,
    # and the merge body's (planes, payloads), its slots fixed by the
    # planes (csrc/merge_runs.cuh: merge_slots); one K1c kernel
    n_k2 = sum(e * (nk + idx) <= 64 for e in (4, 8, 16, 32)
               for idx in (0, 1) for nk in (1, 2, 3)) + 3 * 2
    n_k2_seen = sum("leaf_collapse_kernel" in k for k in spills)
    check(n_k2_seen == n_k2 and len(spills) == n_k2 + 1,
          f"bitonic.cu / partition_general.cu: {n_k2_seen} K2 instances and "
          f"{len(spills) - n_k2_seen} others in the build log, expected "
          f"{n_k2} and 1")
    check(not any(sum(v) for v in spills.values()),
          "bitonic.cu / partition_general.cu: an instance spills: "
          f"{[k for k, v in spills.items() if sum(v)]}")

    n_edge = 0
    for nk in (1, 2, 3):
        for lp in range(7, 16):
            p_ = 1 << lp
            for k in (p_, p_ - 128):
                if k == 0 or tile_smem_bytes(p_, nk, True) > SMEM_MAX:
                    continue
                runs = [0] + [1 << r for r in range(7, lp + 1)
                              if k % (1 << r) == 0 and (p_ - k) % (1 << r) == 0]
                for i, run in enumerate(runs):
                    nv, t, q_ = (0, 1, 8)[i % 3], 5, run or 128
                    planes = [edge_keys(t, k) for _ in range(nk)]
                    vals_ = [random_i32(t * k).reshape(t, k)
                             for _ in range(nv)]
                    cnts = torch.randint(0, q_ + 1, (t, k // q_),
                                         dtype=torch.int32, device=dev,
                                         generator=gen)
                    cnts[1] = 0                     # no valid slot
                    cnts[2, 0] = q_ - 3             # offsets off 16 bytes
                    if run:
                        planes, vals_ = lex_chunks(planes, vals_, q_, cnts)
                    total = int(cnts.sum())
                    for n_out in (total, max(0, total - 1
                                             - int(cnts[4].sum()) // 2)):
                        got = sort_tiles_counts_collapsed(
                            planes + vals_, cnts, q_, n_out, sorted_run=run,
                            num_keys=nk)
                        want = sort_tiles_counts_collapsed_plain(
                            planes + vals_, cnts, q_, n_out, nk)
                        check(all(same_bits(g, w) for g, w in zip(got, want)),
                              f"phase 32: K2 ({t}, {k}) {nk} planes + {nv} "
                              f"values, sorted_run {run}, n_out {n_out} "
                              f"differs from plain")
                        n_edge += 1
                    del planes, vals_, cnts, got, want
    log(f"phase 32 ok: no spill in the {n_k2} instances of bitonic.cu nor "
        f"in partition_general.cu; K2 == plain bit for bit, key planes and "
        f"payloads (ties keep their slot order), at K = P and P - 128 for "
        f"every P from 128 to the shared-memory limit, 1-3 planes, 0, 1 and "
        f"8 payloads, every sorted_run from none through 128 .. K, a tile "
        f"with no valid slot, n_out cutting the last tiles, dense offsets "
        f"off 16 bytes, tied keys with 0xFFFFFFFF: {n_edge} calls (at the "
        f"path shapes: phases 3, 8, 8b, 15 and 25)")

    n_edge = 0
    for k in (128, 2048, 16384, 32768):
        for r_, s_, nk, nv, lo, q_, use_digit, t_seg in (
                (1, 128, 1, 0, 31, None, False, 1),
                (2, 512, 1, 2, 31, 256, False, 2),
                (32, 128, 2, 1, 30, None, False, 4),
                (32, 1024, 2, 2, 59, 512, False, 2),
                (256, 128, 1, 1, 24, None, True, 2),
                (256, 256, 3, 0, 88, 128, False, 1),
                (16, 512, 4, 12, 120, 1024, False, 2)):
            t = 2 * t_seg
            ops = [random_i32(t * k).reshape(t, k) for _ in range(nk + nv)]
            kw = dict(r=r_, s=s_, lo_bit=lo, width=max(r_.bit_length() - 1, 1),
                      t_seg=t_seg)
            cin = None
            if q_ and q_ <= k:
                cin = torch.randint(0, q_ + 1, (t, k // q_), dtype=torch.int32,
                                    device=dev, generator=gen)
                kw.update(q_in=q_, n=None)
            else:
                kw.update(q_in=None, n=t * k - min(999, k // 2))
            dig = None if not use_digit else torch.randint(
                0, r_ + 3, (t, k), dtype=torch.int32, device=dev,
                generator=gen)
            # R = 1 takes the kernel's wrapper: partition_pass_fused asks
            # for 2^width <= R
            call = _partition_pass_general_cuda if r_ == 1 else \
                functools.partial(partition_pass_fused, general=True)
            got, cnt = call(ops[:nk], ops[nk:], cin, digit=dig, **kw)
            want, pcnt = partition_pass_general_plain(ops[:nk], ops[nk:],
                                                      cin, digit=dig, **kw)
            what = (f"K1c ({t}, {k}) R {r_} S {s_} {nk} planes + {nv} "
                    f"values, lo_bit {lo}, q_in {kw['q_in']}, digit plane "
                    f"{use_digit}, t_seg {t_seg}")
            check(torch.equal(cnt, pcnt), f"phase 32: {what}: counts differ")
            spec = type("Spec", (), dict(s=s_, r=r_, t_seg=t_seg,
                                         n_seg=t // t_seg))
            m = valid_slots(cnt, spec)
            check(all(same_bits(g[m], w[m]) for g, w in zip(got, want)),
                  f"phase 32: {what}: valid slots differ")
            n_edge += 1
            del ops, got, want, m
    log(f"phase 32 ok: K1c == plain bit for bit on the counts and every "
        f"valid slot at K = 128 .. 32768, R = 1, 2, 16, 32 and 256, S below "
        f"and above the counts, a digit straddling two planes, the digit "
        f"plane, 16 operands, pass 0 and later passes, t_seg 1-4: {n_edge} "
        f"calls")

    # ---- phase 33: partition_tiles.cu and collapse.cu at their edges ----
    torch.cuda.empty_cache()
    ours = re.compile(r"\d(partition_tiles_kernel|collapse_kernel|"
                      r"collapse_offsets_kernel)")
    spills = ptxas_spills(
        _build.BUILD_DIR / "build.log", ours.search,
        lambda f: "partition_tiles.cu" if "partition_tiles" in f
        else "collapse.cu")
    # K8; K4 and its offsets kernel for int32 and for int64 counts
    check(len(spills) == 4,
          f"partition_tiles.cu / collapse.cu: {sorted(spills)} in the build "
          "log, expected 4 kernels")
    check(not any(sum(v) for v in spills.values()),
          "partition_tiles.cu / collapse.cu: a kernel spills: "
          f"{[k for k, v in spills.items() if sum(v)]}")

    def k8_edge(t, k, r_, s_, n_data, keys, past_k):
        """K8's inputs: the engine's sortkey (digit or r) << log2(k) |
        slot with the exclusive cumsum of the digit counts as starts, or
        tied words ("ties": 8 distinct, the order stable), the digit over
        a permutation of the slots ("vote": the kernel's vote fails), any
        words ("random") or one word ("constant"); with ``past_k`` random
        starts in [0, k + s_)."""
        digit = torch.randint(0, r_ + 1, (t, k), device=dev, generator=gen)
        low = torch.arange(k, device=dev).expand(t, k)
        if keys == "vote":
            low = torch.argsort(torch.rand(t, k, device=dev, generator=gen),
                                1)
        sk = ((digit << log2(k)) | low).to(torch.int32)
        if keys == "ties":
            sk = (torch.randint(0, 8, (t, k), device=dev, generator=gen)
                  * 0x20202020 - (1 << 31)).to(torch.int32)
        elif keys == "random":
            sk = random_i32(t * k).reshape(t, k)
        elif keys == "constant":
            sk = torch.full((t, k), -559038737, dtype=torch.int32,
                            device=dev)
        cnt = torch.zeros(t, r_ + 1, dtype=torch.int32, device=dev) \
            .scatter_add_(1, digit, torch.ones_like(digit,
                                                    dtype=torch.int32))[:, :r_]
        starts = (torch.cumsum(cnt, 1, dtype=torch.int32) - cnt).contiguous()
        if past_k:
            starts = torch.randint(0, k + s_, (t, r_), dtype=torch.int32,
                                   device=dev, generator=gen)
        return [sk, *(random_i32(t * k).reshape(t, k)
                      for _ in range(n_data))], starts

    n_edge = 0
    for k in (128, 2048, 16384, 32768):
        for r_, s_, n_data, keys, past_k, shift in (
                (1, 128, 1, "engine", False, False),
                (8, 384, 2, "ties", True, False),
                (32, 768, 8, "vote", False, False),
                (128, 128, 1, "random", True, False),
                (64, 256, 2, "constant", True, False),
                (128, 256, 2, "engine", True, False),
                (32, 512, 1, "ties", False, False),
                (32, 768, 2, "engine", False, True),
                (8, 384, 2, "vote", True, True)):
            # one tile, and (at K = 16384) enough to fill every SM twice
            for t in ((1, 300) if k == 16384 and keys == "engine"
                      and not shift else (3,)):
                ops, starts = k8_edge(t, k, r_, s_, n_data, keys, past_k)
                if shift:        # the sortkey's and the data's scalar loads
                    ops = [off16(o) for o in ops]
                    check(ops[0].data_ptr() % 16 == 4,
                          "phase 33: the shifted view is aligned")
                got = partition_tiles(ops, starts, r=r_, s=s_)
                want = partition_tiles_plain(ops, starts, r=r_, s=s_)
                check(all(same_bits(g, w) for g, w in zip(got, want)),
                      f"phase 33: K8 ({t}, {k}) R {r_} S {s_} {n_data} data "
                      f"operand(s), {keys} sortkeys, past_k {past_k}, "
                      f"shifted {shift}: differs from plain")
                n_edge += 1
                del ops, starts, got, want
    log(f"phase 33 ok: no spill in partition_tiles.cu nor collapse.cu; K8 "
        f"== plain bit for bit on every slot (the clamped ones too) at K = "
        f"128 .. 32768, R = 1 .. 128, 1, 2 and 8 data operands, the "
        f"engine's sortkeys, tied ones (stable), ones on which the vote "
        f"fails, random and constant words, the engine's and vote-failing "
        f"ones 4 bytes off a 16-byte boundary: {n_edge} calls")

    n_edge = 0
    for nseg, seg, n_ops, cut, kind in (
            (1, 1 << 22, 1, 0, "one segment, many chunks"),
            (1 << 16, 128, 1, 0, "tiny segments"),
            (4096, 256, 2, 0, "mostly zero counts"),
            (64, 1 << 16, 2, 12345, "n_out mid-segment"),
            (999, 2048, 1, 0, "sum == n_out"),
            (33, 4096, 16, 3, "16 operands"),
            (257, 6144, 2, 0, "int64 counts past seg and below 0"),
            (17, 1024, 1, -1000, "n_out past the sum")):
        segs = [random_i32(nseg * seg).reshape(nseg, seg)
                for _ in range(n_ops)]
        cnts = torch.randint(0, seg + 1, (nseg,), dtype=torch.int32,
                             device=dev, generator=gen)
        if kind == "one segment, many chunks":
            cnts[0] = seg - 5
        elif kind == "tiny segments":
            cnts = torch.randint(0, 3, (nseg,), dtype=torch.int32,
                                 device=dev, generator=gen)
        elif kind == "mostly zero counts":
            cnts[torch.rand(nseg, device=dev, generator=gen) < 0.9] = 0
        elif kind.startswith("int64"):
            cnts = cnts.long()
            cnts[::5] = seg + 99
            cnts[1::7] = -3
        n_out = int(cnts.clamp(0, seg).sum()) - cut
        got = collapse_segments(segs, cnts, n_out)
        want = collapse_segments_plain(segs, cnts, n_out)
        check(all(same_bits(g, w) for g, w in zip(got, want)),
              f"phase 33: K4 ({nseg}, {seg}) {n_ops} operand(s), {kind}: "
              "differs from plain")
        n_edge += 1
        del segs, cnts, got, want
    log(f"phase 33 ok: K4 == plain bit for bit with nseg 1 .. 2^16: one "
        f"segment over many chunks, tiny and empty segments, n_out cutting "
        f"a segment, sum == n_out, 16 operands, int64 counts clamped in the "
        f"kernel, n_out past the sum (zeros): {n_edge} calls")

    # ---- phases 34-35: K1's and K1b's merge and runs bodies on their ----
    # ---- paths' inputs ---------------------------------------------------
    torch.cuda.empty_cache()

    def pass_inputs(fn, n_):
        """(fn's output, the (planes, values, counts_in, keyword
        arguments) of each K1 and K1b call that the engines' partition
        passes make in it, the sort's own (not the skew tier's sample
        sort's))."""
        seen, real = [], msd.partition_pass_fused

        def spy(planes_, values_, cin_, **kw):
            if planes_[0].numel() >= n_:
                seen.append((planes_, values_, cin_, kw))
            return real(planes_, values_, cin_, **kw)

        msd.partition_pass_fused = equidepth.partition_pass_fused = spy
        try:
            out = fn()
        finally:
            msd.partition_pass_fused = equidepth.partition_pass_fused = real
        return out, seen

    xu = random_i32(MAIN_N).view(torch.uint32)
    eu = (random_i32(MAIN_N) & random_i32(MAIN_N)
          & random_i32(MAIN_N)).view(torch.uint32)
    ids = torch.arange(MAIN_N, dtype=torch.int32, device=dev) \
        .view(torch.uint32)
    u64k = torch.stack([random_i32(U64_N), random_i32(U64_N)], 1) \
        .view(torch.int64)[:, 0].view(torch.uint64)
    for mode, name, keys_, vals_, kid, nk, nv in (
            ("keys", "sort 2^28", xu, None, "K1", 1, 0),
            ("key+value", "sort_pairs 2^28", xu, ids, "K1", 1, 1),
            ("keys", "sort entropy-3 2^28", eu, None, "K1b", 1, 0),
            ("composite+value", "sort_pairs entropy-3 2^28", eu, ids, "K1b",
             2, 1),
            ("2 planes", "sort u64 2^27", u64k, None, "K1", 2, 0)):
        tapi._TIER_CACHE.clear()       # classify this input, cold
        call = (lambda: tpusort_torch.sort(keys_)) if vals_ is None else \
            (lambda: tpusort_torch.sort_pairs(keys_, vals_))
        (out, seen), c, modes = drive(
            lambda: pass_inputs(call, keys_.numel()))
        if vals_ is None:
            check(same_bits(out, reference_sort(keys_)),
                  f"phase 34: {name} differs from the reference")
        else:
            wk, (wv,) = reference_sort(keys_, (vals_.view(torch.int32),))
            check(same_bits(out[0], wk) and same_bits(out[1], wv),
                  f"phase 34: {name}: keys or values differ from the "
                  "stable reference")
            del wk, wv
        del out
        check(c["overflow_fallbacks"] == 0
              and c["equidepth_runs"] == int(kid == "K1b"),
              f"phase 34: {name} did not take its tier cleanly: {c}")
        k1_modes = {m: v for m, v in modes.items() if m[0] == kid}
        check(k1_modes == {(kid, nk, nv, "runs"): 1,
                           (kid, nk, nv, "merge"): 2} and len(seen) == 3,
              f"phase 34: {name}: not one {kid} on the runs body and two "
              f"merged: {k1_modes} ({len(seen)} passes)")
        for j in (0, 1, 2):
            # each pass's inputs dropped after its check: at 2^28 a pass of
            # composite + value holds 4.8 GB, and plain takes several times
            # that
            pl, va, cin, kw = seen.pop(0)
            torch.cuda.empty_cache()
            T, K = pl[0].shape
            keep = ("q_in", "n", "r", "s", "t_seg")
            if kid == "K1b":
                pkw = dict({k: kw.get(k) for k in keep},
                           splitters=kw["splitters"],
                           splitter_fracs=kw["splitter_fracs"])
                plain_fn = partition_pass_splitter_plain
            else:
                pkw = dict({k: kw.get(k) for k in keep}, lo_bit=kw["lo_bit"],
                           width=kw["width"])
                plain_fn = partition_pass_fused_plain
            body = "runs" if j == 0 else "merge"
            phase = 35 if j == 0 else 34
            geo = partition_runs_geometry(K, kw.get("sorted_run"), nk, nv) \
                if j == 0 else partition_merge_geometry(
                    K, kw["q_in"], kw["sorted_run"], nk, nv)
            check(geo is not None, f"phase {phase}: {name} pass {j}: no "
                  f"{body} geometry for ({K}, q {kw.get('q_in')}, "
                  f"sorted_run {kw.get('sorted_run')})")

            def kernel(pl=pl, va=va, cin=cin, kw=kw):
                return partition_pass_fused(pl, va, cin, **kw)

            def plain(pl=pl, va=va, cin=cin, pkw=pkw, fn=plain_fn):
                return fn(pl, va, cin, **pkw)

            msd.reset_counters()
            k_out, k_cnt = kernel()
            check(msd.mode_counters() == {(kid, nk, nv, body): 1},
                  f"phase {phase}: {name} pass {j}: {msd.mode_counters()}")
            p_out, p_cnt = plain()
            spec = SimpleNamespace(s=kw["s"], r=kw["r"], t_seg=kw["t_seg"],
                                   n_seg=T // kw["t_seg"])
            check(torch.equal(k_cnt, p_cnt),
                  f"phase {phase}: {kid} {name} pass {j}: counts differ")
            m = valid_slots(k_cnt, spec)
            err = 0
            for a, b_ in zip(k_out, p_out):
                check(same_bits(a[m], b_[m]),
                      f"phase {phase}: {kid} {name} pass {j}: slots differ")
                err = max(err, max_abs_err(a[m], b_[m]))
            n_ops = len(pl) + len(va)
            row = f"{kid} {mode} ({body}, pass {j})"
            del k_out, p_out, m
            tk, tp = time_alt(kernel, plain)
            nvalid = int(k_cnt.sum())
            results[row] = (err, tk, tp,
                            2 * nvalid * n_ops + (0 if cin is None
                                                  else cin.numel())
                            + T * kw["r"], nvalid * log2(K))
            launches[row] = modes.get((kid, nk, nv, body), 0)
            log(f"{row}: ({T}, {K}) q {kw.get('q_in')} run {geo.run}, "
                f"{geo.threads} threads: kernel {fmt(tk)} vs plain "
                f"{fmt(tp)}, bound {bound(*results[row][3:5])[0]:.3f} ms")
            del k_cnt, p_cnt, pl, va, cin, kw, pkw, kernel, plain
        torch.cuda.empty_cache()
    del xu, eu, ids, u64k
    log("phase 34 ok: K1's and K1b's merge body == plain bit for bit on "
        "passes 1 and 2 of the 2^28 keys, pairs, entropy-3 keys and "
        "entropy-3 pairs calls and the 2^27 u64 keys call, each call exact "
        "with one runs-body launch and two merged")
    log("phase 35 ok: K1's and K1b's runs body == plain bit for bit on pass "
        "0 of the same five calls")

    for name, (err, tk, tp, words, ops, *lib) in results.items():
        extra = f" vs library {fmt(lib[0])}" if lib else ""
        print(f"time: {name} kernel {fmt(tk)} vs plain {fmt(tp)}{extra}, "
              f"bound {bound(words, ops)[0]:.3f} ms on {card}", flush=True)

    where = {
        "K1": ("partition_pass_fused", "tpusort_torch/csrc/partition.cu",
               "tpusort/kernels/partition.py:500"),
        "K2": ("sort_tiles_counts_collapsed", "tpusort_torch/csrc/bitonic.cu",
               "tpusort/kernels/bitonic.py:805"),
        "K3": ("sort_tiles", "tpusort_torch/csrc/sort_tiles.cu",
               "tpusort/kernels/bitonic.py:928"),
        "K1c": ("partition_pass_fused (general)",
                "tpusort_torch/csrc/partition_general.cu",
                "tpusort/kernels/partition.py:500"),
        "K4": ("collapse_segments", "tpusort_torch/csrc/collapse.cu",
               "tpusort/kernels/collapse.py:242"),
        "K4c": ("collapse_segments", "tpusort_torch/csrc/collapse.cu",
                "tpusort/kernels/collapse.py:189"),
        "K1b": ("partition_pass_fused (splitters)",
                "tpusort_torch/csrc/partition.cu",
                "tpusort/kernels/partition.py:500"),
        "K5": ("prefix_sum_tiles", "tpusort_torch/csrc/scanhist.cu",
               "tpusort/kernels/scanhist.py:103"),
        "K6": ("digit_histogram_tiles", "tpusort_torch/csrc/scanhist.cu",
               "tpusort/kernels/scanhist.py:154"),
        "K9": ("sort_tiles_counts", "tpusort_torch/csrc/sort_tiles.cu",
               "tpusort/kernels/bitonic.py:639"),
        "K10": ("sort_tiles_masked", "tpusort_torch/csrc/sort_tiles.cu",
                "tpusort/kernels/bitonic.py:868"),
        "K7": ("ring_all_to_all", "tpusort_torch/csrc/ring.cu",
               "tpusort/parallel/ring.py:89"),
        "K8": ("partition_tiles", "tpusort_torch/csrc/partition_tiles.cu",
               "tpusort/kernels/partition.py:605"),
    }
    kernels = []
    for mode, (err, tk, tp, words, ops, *lib) in results.items():
        kid = mode.split()[0]
        name, source, replaces = where[kid]
        bound_ms, bound_by = bound(words, ops)
        kernels.append(dict(
            name=f"{name} [{mode}]", route="cuda", source=source,
            replaces=replaces, launches=launches.get(mode, 0),
            max_abs_err=err, ms=statistics.median(tk),
            plain_ms=statistics.median(tp), bound_ms=bound_ms,
            bound_by=bound_by,
            library_ms=statistics.median(lib[0]) if lib else None,
            note=notes.get(mode) or (
                NO_LIBRARY_96 if not lib and "3 planes" in mode
                and kid in ("K1", "K1b", "K1c", "K2") else None)))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
