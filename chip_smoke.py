#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root:  python3 chip_smoke.py

It builds the hand-written kernels from ``tpusort_torch/csrc`` (nvcc,
sm_90a) and runs these phases; any failure exits non-zero:

1. build the kernels and report the card (name, power limit);
2. K1 (``partition_pass_fused``) kernel vs its plain PyTorch version at the
   2^28 plan's shapes: pass 0 with a ragged n, and pass 1 with the counts
   table pass 0 gives;
3. K2 (``sort_tiles_counts_collapsed``) kernel vs plain at the leaf shape;
4. ``tpusort_torch.sort`` of 2^28 uniform uint32 keys: bit-identical to the
   reference sort, no overflow, one K1 launch per pass, one K2 launch, no
   reference route and no fallback;
5. int32, float32 descending with NaN, -0.0 and +0.0 planted, and uint32
   with a block of 0xFFFFFFFF (which ties the garbage sentinel), at 2^24:
   bit-identical to the reference, through the kernels;
6. constant keys at 2^24: the overflow fallback fires and the output is
   exact;
7. timings, median of 5 CUDA-event runs: the 2^28 sort against torch.sort,
   and each kernel against its plain version.

The line before the last is a JSON summary of the kernels; the last line is
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
        sort_tiles_counts_collapsed, sort_tiles_counts_collapsed_plain)
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
        return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))

    def reference_sort(keys: torch.Tensor, descending=False) -> torch.Tensor:
        planes, traits = dtypes.twiddle_in(keys, descending=descending)
        sp, _ = sort_twiddled_reference(planes, (), begin_bit=0, end_bit=32,
                                        total_bits=32)
        return dtypes.twiddle_out(sp, traits, descending=descending)

    def valid_slots(counts: torch.Tensor, spec) -> torch.Tensor:
        """(T*R*S,) bool: the exchanged-run slots the counts mark valid."""
        c = counts.clamp(0, spec.s).reshape(
            spec.n_seg, spec.t_seg, spec.r).transpose(1, 2)
        s_idx = torch.arange(spec.s, device=counts.device)
        return (s_idx < c[..., None]).reshape(-1)

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
    plan_kw = cfg.plan_kwargs()
    plan_kw.pop("min_n")
    plan = msd.plan_msd(RAGGED_N, 0, 32, leaf_profile="raw", **plan_kw)
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
    p_out0, p_cnt0 = partition_pass_fused_plain(tiles0, None, q_in=None,
                                                **arg0)
    check(torch.equal(k_cnt0, p_cnt0), "K1 pass 0: counts differ")
    m0 = valid_slots(k_cnt0, sp0)
    check(same_bits(k_out0[m0], p_out0[m0]), "K1 pass 0: valid slots differ")
    k1_err = max_abs_err(k_out0[m0], p_out0[m0])
    check(int(k_cnt0.sum()) == RAGGED_N, "K1 pass 0: counts do not sum to n")
    k1_times, k1_plain_times = time_pair(
        lambda: partition_pass_fused([tiles0], [], None, **arg0),
        lambda: partition_pass_fused_plain(tiles0, None, q_in=None, **arg0))
    del p_out0, m0

    ctable, q = msd.next_counts_table(k_cnt0, sp0)
    t1_tiles = sp1.n_seg * sp1.t_seg
    tiles1 = k_out0.reshape(t1_tiles, sp1.k)
    cin1 = ctable.reshape(t1_tiles, sp1.k // q)
    arg1 = dict(r=sp1.r, s=sp1.s, lo_bit=sp1.lo_bit, width=sp1.width,
                n=None, t_seg=sp1.t_seg, q_in=q)
    (k_out1,), k_cnt1 = partition_pass_fused(
        [tiles1], [], cin1, sorted_run=sp0.s & -sp0.s, **arg1)
    p_out1, p_cnt1 = partition_pass_fused_plain(tiles1, cin1, **arg1)
    check(torch.equal(k_cnt1, p_cnt1), "K1 pass 1: counts differ")
    m1 = valid_slots(k_cnt1, sp1)
    check(same_bits(k_out1[m1], p_out1[m1]), "K1 pass 1: valid slots differ")
    k1_err = max(k1_err, max_abs_err(k_out1[m1], p_out1[m1]))
    log(f"phase 2 ok: K1 == plain on pass 0 ({t0_tiles} x {sp0.k}, "
        f"n={RAGGED_N}) and pass 1 ({t1_tiles} x {sp1.k}, q_in={q}, "
        f"sorted_run={sp0.s & -sp0.s}); max_abs_err {k1_err}")
    del keys, tiles0, k_out0, k_cnt0, p_cnt0, tiles1, cin1, ctable
    del k_out1, k_cnt1, p_out1, p_cnt1, m1

    # ---- phase 3: K2 kernel vs plain at the leaf shape ----------------
    keys = random_i32(plan.m1)
    data, (ctable, q_fin), overflow = msd.run_passes(keys, RAGGED_N, plan)
    check(not bool(overflow), "uniform keys overflowed a run")
    nt, tile = msd.leaf_tiles(plan)
    check(tile == 24576 and q_fin == 512,
          f"leaf tile {tile} q {q_fin}, expected 24576 and 512")
    leaf = data.reshape(nt, tile)
    ct = ctable.reshape(nt, tile // q_fin)
    run = plan.passes[-1].s & -plan.passes[-1].s
    k_dense = sort_tiles_counts_collapsed(leaf, ct, q_fin, RAGGED_N,
                                          sorted_run=run)
    p_dense = sort_tiles_counts_collapsed_plain(leaf, ct, q_fin, RAGGED_N)
    check(same_bits(k_dense, p_dense), "K2: dense outputs differ")
    k2_err = max_abs_err(k_dense, p_dense)
    want = reference_sort(keys[:RAGGED_N].view(torch.uint32))
    check(same_bits(k_dense, want), "K2 output is not the sorted input")
    k2_times, k2_plain_times = time_pair(
        lambda: sort_tiles_counts_collapsed(leaf, ct, q_fin, RAGGED_N,
                                            sorted_run=run),
        lambda: sort_tiles_counts_collapsed_plain(leaf, ct, q_fin, RAGGED_N))
    log(f"phase 3 ok: K2 == plain at ({nt}, {tile}) q={q_fin} "
        f"sorted_run={run}; equals the reference sort of the ragged input")
    del keys, data, ctable, leaf, ct, k_dense, p_dense, want

    # ---- phase 4: the main path at 2^28 -------------------------------
    x = random_i32(MAIN_N).view(torch.uint32)
    main_plan = msd.plan_msd(MAIN_N, 0, 32, leaf_profile="raw", **plan_kw)
    torch.cuda.synchronize()
    msd.reset_counters()
    t0 = time.perf_counter()
    out = tpusort_torch.sort(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_counts = msd.counters()
    log(f"main path counters: {main_counts} (first call, {wall:.3f} s)")
    check(out.dtype == torch.uint32 and out.shape == x.shape
          and out.device == x.device, "main path: wrong dtype/shape/device")
    check(same_bits(out, reference_sort(x)),
          "main path: 2^28 sort differs from the reference")
    check(main_counts == dict(k1_launches=len(main_plan.passes),
                              k2_launches=1, reference_routes=0,
                              overflow_fallbacks=0),
          f"main path did not run K1 x{len(main_plan.passes)} + K2 "
          f"without overflow: {main_counts}")
    log("phase 4 ok: 2^28 uint32 sort == reference, overflow False, "
        f"K1 x{main_counts['k1_launches']}, K2 x{main_counts['k2_launches']}")

    # ---- phase 5: other dtypes and inputs at 2^24 ---------------------
    small_plan = msd.plan_msd(SMALL_N, 0, 32, leaf_profile="raw", **plan_kw)
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

    # ---- phase 7: timings ---------------------------------------------
    xi = x.view(torch.int32)
    sort_times, torch_times = time_pair(lambda: tpusort_torch.sort(x),
                                        lambda: torch.sort(xi))
    sort_ms = statistics.median(sort_times)
    torch_ms = statistics.median(torch_times)
    print(f"time: tpusort_torch.sort 2^28 uint32 {fmt(sort_times)} "
          f"({MAIN_N / sort_ms / 1e6:.3f} G keys/s) vs torch.sort of the "
          f"same keys as int32 {fmt(torch_times)} "
          f"({MAIN_N / torch_ms / 1e6:.3f} G keys/s) on {card}", flush=True)
    print(f"time: K1 pass 0 ({t0_tiles} x {sp0.k}) kernel {fmt(k1_times)} "
          f"vs plain {fmt(k1_plain_times)} on {card}", flush=True)
    print(f"time: K2 leaf ({nt} x {tile}) kernel {fmt(k2_times)} vs plain "
          f"{fmt(k2_plain_times)} on {card}", flush=True)
    log("phase 7 ok")

    kernels = [
        dict(name="partition_pass_fused", route="cuda",
             source="tpusort_torch/csrc/partition.cu",
             replaces="tpusort/kernels/partition.py:500",
             launches=main_counts["k1_launches"], max_abs_err=k1_err,
             ms=statistics.median(k1_times),
             plain_ms=statistics.median(k1_plain_times)),
        dict(name="sort_tiles_counts_collapsed", route="cuda",
             source="tpusort_torch/csrc/bitonic.cu",
             replaces="tpusort/kernels/bitonic.py:805",
             launches=main_counts["k2_launches"], max_abs_err=k2_err,
             ms=statistics.median(k2_times),
             plain_ms=statistics.median(k2_plain_times)),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
