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
3. K2 (``sort_tiles_counts_collapsed``) keys-only vs plain at the leaf;
4. ``tpusort_torch.sort`` of 2^28 uniform uint32 keys: bit-identical to the
   reference sort, one K1 launch per pass, one K2 launch, no reference
   route and no fallback;
5. int32, float32 descending with NaN, -0.0 and +0.0 planted, and uint32
   with a block of 0xFFFFFFFF (which ties the invalid-slot sentinel), at
   2^24: bit-identical to the reference, through the kernels;
6. constant keys at 2^24: the overflow fallback fires, the output is exact;
7. K1 with payloads vs plain at the pairs 2^28 plan's pass 0 and pass 1
   shapes, for the composite (key, position) planes + a value and for one
   unique key plane + a value;
8. K2 with payloads vs plain at the stable pairs leaf (2 planes + a value)
   and the unstable pairs leaf (a unique key plane + a value); then K1 and
   K2 with 2 key planes vs plain at the 2^27 uint64 plan's shapes, and
   with 2 planes + 2 value words at the 2^24 int64 pairs plan's shapes;
9. K3 (``sort_tiles``) vs plain at (1, 16384), (1, 16384 - 128 k) (the
   virtual pad) and (8192, 2048), keys and keys + a value;
10. ``sort_pairs`` of 2^28 uniform uint32 keys with ``values = arange``:
    keys and values bit-identical to the stable reference, K1 x passes,
    K2 x 1, no reference route and no fallback;
11. ``unstable_sort_pairs`` at 2^28: keys exact, the values a permutation
    with keys_in[values_out] == keys_out;
12. 2^27 uint64 keys; at 2^24 float64 descending with NaN and +-0
    planted, int64 keys with int64 values (unstable), argsort against
    ``torch.sort(stable=True).indices``, unstable pairs with a block of
    0xFFFFFFFF keys (the exact fallback); the single-tile path (through
    K3) for keys at n = 16384 and n = 1000, and for unstable pairs at
    n = 16384 and n = 15616 with a block of 0xFFFFFFFF keys;
13. timings, median of 5 CUDA-event runs, alternating: the 2^28 sort
    against ``torch.sort``, the 2^28 pairs sort against ``torch.sort``
    (stable) plus the values gather, 2^27 uint64 keys against
    ``torch.sort`` of the keys as int64 with the sign bit flipped, and each
    kernel mode against its plain version.

The line before the last is a JSON summary of the kernels: each template
mode compared, with its launches in the run of the path that drives it at
that shape (counters set to 0 just before), or 0 where no path does; the
last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

MAIN_N = 1 << 28
RAGGED_N = MAIN_N - 12345
SMALL_N = 1 << 24
U64_N = 1 << 27
REPS = 5
SEED = 20261016


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "card and has no CPU run")

    import tpusort_torch
    from tpusort_torch import dtypes
    from tpusort_torch.configs import get_config
    from tpusort_torch.kernels import _build
    from tpusort_torch.kernels.bitonic import (
        sort_tiles, sort_tiles_counts_collapsed,
        sort_tiles_counts_collapsed_plain, sort_tiles_plain)
    from tpusort_torch.kernels.partition import (
        partition_pass_fused, partition_pass_fused_plain)
    from tpusort_torch.ops import msd
    from tpusort_torch.ops.reference import sort_twiddled_reference

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
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

    def time_pair(kernel_fn, plain_fn):
        """REPS CUDA-event times (ms) of each, alternating plain, kernel,
        kernel, plain after one warm-up of each."""
        kernel_fn()
        plain_fn()
        tk, tp = [], []
        for i in range(REPS):
            order = [(plain_fn, tp), (kernel_fn, tk)]
            for fn, acc in (order if i % 2 == 0 else order[::-1]):
                acc.append(sync_ms(fn))
        return tk, tp

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

    def reference_sort(keys: torch.Tensor, values=(), descending=False):
        """The stable reference sort (torch.sort, plane by plane)."""
        planes, traits = dtypes.twiddle_in(keys, descending=descending)
        sp, sv = sort_twiddled_reference(planes, values, begin_bit=0,
                                         end_bit=traits.bits,
                                         total_bits=traits.bits)
        out = dtypes.twiddle_out(sp, traits, descending=descending)
        return (out, sv) if values else out

    def valid_slots(counts: torch.Tensor, spec) -> torch.Tensor:
        """(T*R*S,) bool: the exchanged-run slots the counts mark valid."""
        c = counts.clamp(0, spec.s).reshape(
            spec.n_seg, spec.t_seg, spec.r).transpose(1, 2)
        s_idx = torch.arange(spec.s, device=counts.device)
        return (s_idx < c[..., None]).reshape(-1)

    def plan_for(n: int, end_bit: int, cfg):
        kw = cfg.plan_kwargs()
        kw.pop("min_n")
        return msd.plan_msd(n, 0, end_bit, leaf_profile="raw", **kw)

    def k1_vs_plain(name, planes, values, plan, n):
        """K1 kernel vs plain on pass 0 (validity from n) and pass 1 (from
        pass 0's counts table); returns (max abs err, kernel times, plain
        times) with the times of pass 0."""
        sp0, sp1 = plan.passes[0], plan.passes[1]
        t0 = sp0.n_seg * sp0.t_seg
        ops = [o.reshape(t0, sp0.k) for o in (*planes, *values)]
        np_ = len(planes)
        arg0 = dict(r=sp0.r, s=sp0.s, lo_bit=sp0.lo_bit, width=sp0.width,
                    n=n, t_seg=sp0.t_seg)
        k_out, k_cnt = partition_pass_fused(ops[:np_], ops[np_:], None,
                                            unstable=True, **arg0)
        p_out, p_cnt = partition_pass_fused_plain(ops[:np_], ops[np_:], None,
                                                  q_in=None, **arg0)
        check(torch.equal(k_cnt, p_cnt), f"K1 {name} pass 0: counts differ")
        check(int(k_cnt.sum()) == n, f"K1 {name} pass 0: counts != n")
        m = valid_slots(k_cnt, sp0)
        err = 0
        for k, p in zip(k_out, p_out):
            check(same_bits(k[m], p[m]), f"K1 {name} pass 0: slots differ")
            err = max(err, max_abs_err(k[m], p[m]))
        times = time_pair(
            lambda: partition_pass_fused(ops[:np_], ops[np_:], None,
                                         unstable=True, **arg0),
            lambda: partition_pass_fused_plain(ops[:np_], ops[np_:], None,
                                               q_in=None, **arg0))
        del p_out, m, ops
        ctable, q = msd.next_counts_table(k_cnt, sp0)
        t1 = sp1.n_seg * sp1.t_seg
        ops = [o.reshape(t1, sp1.k) for o in k_out]
        cin = ctable.reshape(t1, sp1.k // q)
        arg1 = dict(r=sp1.r, s=sp1.s, lo_bit=sp1.lo_bit, width=sp1.width,
                    n=None, t_seg=sp1.t_seg, q_in=q)
        k_out1, k_cnt1 = partition_pass_fused(
            ops[:np_], ops[np_:], cin, sorted_run=sp0.s & -sp0.s,
            unstable=True, **arg1)
        p_out1, p_cnt1 = partition_pass_fused_plain(ops[:np_], ops[np_:],
                                                    cin, **arg1)
        check(torch.equal(k_cnt1, p_cnt1), f"K1 {name} pass 1: counts differ")
        m = valid_slots(k_cnt1, sp1)
        for k, p in zip(k_out1, p_out1):
            check(same_bits(k[m], p[m]), f"K1 {name} pass 1: slots differ")
            err = max(err, max_abs_err(k[m], p[m]))
        log(f"K1 {name} == plain on pass 0 ({t0} x {sp0.k}, n={n}) and "
            f"pass 1 ({t1} x {sp1.k}, q_in={q}, sorted_run="
            f"{sp0.s & -sp0.s}); max_abs_err {err}")
        return (err, *times)

    def k2_vs_plain(name, planes, values, plan, n):
        """K2 kernel vs plain at the leaf ``plan`` reaches after its K1
        passes over the operands (each plan.m1 long); returns ((max abs
        err, kernel times, plain times), the kernel's dense outputs)."""
        np_ = len(planes)
        data, (ctable, q_fin), overflow = msd.run_passes(
            [*planes, *values], np_, n, plan, unstable=bool(values))
        check(not bool(overflow), f"K2 {name}: uniform keys overflowed")
        nt, tile = msd.leaf_tiles(plan, np_, bool(values))
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
        times = time_pair(kernel, plain)
        log(f"K2 {name} == plain at ({nt}, {tile}) q={q_fin} "
            f"sorted_run={run}; max_abs_err {err}")
        return (err, *times), k_dense

    def drive(fn):
        """Run one path with every counter set to 0 just before; returns
        (its output, route counters, launches by (kernel, planes, payload
        words))."""
        torch.cuda.synchronize()
        msd.reset_counters()
        out = fn()
        torch.cuda.synchronize()
        return out, msd.counters(), msd.mode_counters()

    results = {}     # kernel mode -> (max_abs_err, kernel times, plain times)
    # kernel mode -> launches of that template mode in the run of the path
    # that gives it the shape it was compared at; a mode compared at a shape
    # no path runs reports 0
    launches = {}

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
    k1_times, k1_plain_times = time_pair(
        lambda: partition_pass_fused([tiles0], [], None, **arg0),
        lambda: partition_pass_fused_plain([tiles0], [], None, q_in=None,
                                           **arg0))
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
    results["K1 keys"] = (k1_err, k1_times, k1_plain_times)
    log(f"phase 2 ok: K1 == plain on pass 0 ({t0_tiles} x {sp0.k}, "
        f"n={RAGGED_N}) and pass 1 ({t1_tiles} x {sp1.k}, q_in={q}, "
        f"sorted_run={sp0.s & -sp0.s}); max_abs_err {k1_err}")
    del keys, tiles0, k_out0, k_cnt0, p_cnt0, tiles1, cin1, ctable
    del k_out1, k_cnt1, p_out1, p_cnt1, m1

    # ---- phase 3: K2 kernel vs plain at the leaf shape ----------------
    keys = random_i32(plan.m1)
    nt, tile = msd.leaf_tiles(plan)
    check(tile == 24576, f"leaf tile {tile}, expected 24576")
    results["K2 keys"], (k_dense,) = k2_vs_plain("keys", [keys], [], plan,
                                                 RAGGED_N)
    want = reference_sort(keys[:RAGGED_N].view(torch.uint32))
    check(same_bits(k_dense, want.view(torch.int32)),
          "K2 output is not the sorted input")
    log("phase 3 ok: K2 equals the reference sort of the ragged input")
    del keys, k_dense, want

    # ---- phase 4: the main path at 2^28 -------------------------------
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
    check(main_counts == dict(k1_launches=len(main_plan.passes),
                              k2_launches=1, k3_launches=0,
                              reference_routes=0, overflow_fallbacks=0),
          f"main path did not run K1 x{len(main_plan.passes)} + K2 "
          f"without overflow: {main_counts}")
    launches["K1 keys"] = modes.get(("K1", 1, 0), 0)
    launches["K2 keys"] = modes.get(("K2", 1, 0), 0)
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

    # ---- phase 6: constant keys take the exact fallback ---------------
    zeros = torch.zeros(SMALL_N, dtype=torch.uint32, device=dev)
    msd.reset_counters()
    got = tpusort_torch.sort(zeros)
    c = msd.counters()
    check(c["overflow_fallbacks"] == 1, f"constant keys: no fallback: {c}")
    check(same_bits(got, zeros), "constant keys: output differs")
    log("phase 6 ok: constant keys raised overflow and the fallback is exact")
    del zeros, got

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
        results[name] = (err, *time_pair(lambda: sort_tiles(ops),
                                         lambda: sort_tiles_plain(ops)))
        log(f"phase 9 ok: {name} == plain, max_abs_err {err}")
    del ops, got, want

    # ---- phase 10: sort_pairs at 2^28 ----------------------------------
    vals = torch.arange(MAIN_N, dtype=torch.int32, device=dev) \
        .view(torch.uint32)
    pairs_main = plan_for(MAIN_N, 64, pcfg)
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
    check(pairs_counts == dict(k1_launches=len(pairs_main.passes),
                               k2_launches=1, k3_launches=0,
                               reference_routes=0, overflow_fallbacks=0),
          f"sort_pairs did not run K1 x{len(pairs_main.passes)} + K2 "
          f"without overflow: {pairs_counts}")
    launches["K1 composite+value"] = modes.get(("K1", 2, 1), 0)
    launches["K2 composite+value"] = modes.get(("K2", 2, 1), 0)
    log("phase 10 ok: 2^28 sort_pairs == stable reference, keys and values")
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
    launches["K1 key+value"] = modes.get(("K1", 1, 1), 0)
    launches["K2 key+value"] = modes.get(("K2", 1, 1), 0)
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
    launches["K1 2 planes"] = modes.get(("K1", 2, 0), 0)
    launches["K2 2 planes"] = modes.get(("K2", 2, 0), 0)
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
    launches["K1 2 planes+2 values"] = modes.get(("K1", 2, 2), 0)
    launches["K2 2 planes+2 values"] = modes.get(("K2", 2, 2), 0)
    log("phase 12 ok: int64 keys with int64 values (unstable) at 2^24")
    del ko, vo, order, src
    a32 = random_i32(SMALL_N)
    got, _ = through_kernels("argsort", lambda: tpusort_torch.argsort(a32))
    check(torch.equal(got, torch.sort(a32, stable=True).indices),
          "argsort differs from torch.sort(stable=True).indices")
    log("phase 12 ok: argsort at 2^24 == torch.sort(stable=True).indices")
    ff = random_i32(SMALL_N)
    ff[5_000_000:5_000_128] = -1
    ffv = torch.arange(SMALL_N, dtype=torch.int32, device=dev)
    msd.reset_counters()
    ko, vo = tpusort_torch.unstable_sort_pairs(ff.view(torch.uint32), ffv)
    c = msd.counters()
    check(c["overflow_fallbacks"] == 1,
          f"0xFFFFFFFF pairs did not take the fallback: {c}")
    wk, (wv,) = reference_sort(ff.view(torch.uint32), (ffv,))
    check(same_bits(ko, wk) and same_bits(vo, wv),
          "0xFFFFFFFF pairs: the fallback is not exact")
    log("phase 12 ok: unstable pairs with 0xFFFFFFFF keys took the exact "
        "fallback")
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

    # ---- phase 13: timings --------------------------------------------
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
    u64 = x64.view(torch.uint64)
    x64s = x64 ^ (-(1 << 63))             # unsigned order as int64 order
    u64_times, tu64_times = time_pair(lambda: tpusort_torch.sort(u64),
                                      lambda: torch.sort(x64s))
    print(f"time: tpusort_torch.sort 2^27 uint64 {fmt(u64_times)} "
          f"({U64_N / statistics.median(u64_times) / 1e6:.3f} G keys/s) vs "
          f"torch.sort of the keys as int64, sign bit flipped "
          f"{fmt(tu64_times)} "
          f"({U64_N / statistics.median(tu64_times) / 1e6:.3f} G keys/s) "
          f"on {card}", flush=True)
    for name, (err, tk, tp) in results.items():
        print(f"time: {name} kernel {fmt(tk)} vs plain {fmt(tp)} on {card}",
              flush=True)
    log("phase 13 ok")

    where = {
        "K1": ("partition_pass_fused", "tpusort_torch/csrc/partition.cu",
               "tpusort/kernels/partition.py:500"),
        "K2": ("sort_tiles_counts_collapsed", "tpusort_torch/csrc/bitonic.cu",
               "tpusort/kernels/bitonic.py:805"),
        "K3": ("sort_tiles", "tpusort_torch/csrc/sort_tiles.cu",
               "tpusort/kernels/bitonic.py:928"),
    }
    kernels = []
    for mode, (err, tk, tp) in results.items():
        kid = mode.split()[0]
        name, source, replaces = where[kid]
        kernels.append(dict(
            name=f"{name} [{mode}]", route="cuda", source=source,
            replaces=replaces, launches=launches.get(mode, 0),
            max_abs_err=err, ms=statistics.median(tk),
            plain_ms=statistics.median(tp)))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
