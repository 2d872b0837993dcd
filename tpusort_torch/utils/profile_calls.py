"""Where the time of the port's sort calls goes, on one CUDA card.

Run from the repository root:

    python3 -m tpusort_torch.utils.profile_calls [part of a name ...]

For each call of the paths the port has (uniform keys through the raw
and the general path; Zipf, entropy-3 and presorted keys through the
host tiering; the 2^28 prefix sums and digit histogram; ``sort_batched``,
``segmented_sort`` and the global sort over 8 in-process shards), or each
whose name contains an argument, it
makes the inputs on the card from a seed, runs the call twice to warm it
(kernel build, plan cache, tier cache), times five calls with the host
clock, each ending in a ``torch.cuda.synchronize()`` (the median is
"wall"), then traces one more, with its ``synchronize()``, inside the span
``profile_calls.call`` and prints, all of that one traced call: its
window (the span), the device's busy time (the union of its operations'
intervals) and the share of the window the card was idle; the device
time of every kernel and copy, summed by name, the 14 largest first; the
card's idle time summed by the innermost host operation or program span
(``tpusort.*``, ``utils/log.py``) running when each gap began; then the 6
host operations with the most host time of their own.  The card's name
and power limit head the output.  It fails without a CUDA card.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Tuple

import torch

MAIN_N = 1 << 28
U64_N = 1 << 27
SEG_N = 1 << 26
SMALL_N = 1 << 24
SEED = 20261016
SPAN = "profile_calls.call"


def _calls(dev: torch.device) -> Dict[str, Callable]:
    import numpy as np

    import tpusort_torch
    from tpusort_torch.ops import histogram, scan
    from tpusort_torch.parallel import InProcessComm, make_global_sort
    from tpusort_torch.utils.datagen import segment_offsets, zipf_keys_torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand(n):
        return torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                             device=dev, generator=gen)

    uni = rand(MAIN_N).view(torch.uint32)
    zipf = zipf_keys_torch(gen, MAIN_N).view(torch.uint32)
    e3 = (rand(MAIN_N) & rand(MAIN_N) & rand(MAIN_N)).view(torch.uint32)
    presorted = tpusort_torch.sort(uni)
    vals = torch.arange(MAIN_N, dtype=torch.int32, device=dev)
    u64 = torch.stack([rand(U64_N), rand(U64_N)], 1).view(torch.uint64)[:, 0]
    v64 = torch.stack([rand(U64_N), rand(U64_N)], 1).view(torch.int64)[:, 0]
    z64 = zipf_keys_torch(gen, U64_N, dtype=torch.uint64)
    i64 = v64[:SMALL_N]
    small = torch.randint(0, 1 << 20, (MAIN_N,), dtype=torch.int32,
                          device=dev, generator=gen)
    f32 = torch.rand(MAIN_N, device=dev, generator=gen)
    seg_keys, seg_vals = uni[:SEG_N], vals[:SEG_N]
    normal = torch.randn(SEG_N, device=dev, generator=gen)
    equal = np.arange((1 << 16) + 1, dtype=np.int64) * (SEG_N >> 16)
    ragged = segment_offsets(np.random.default_rng(SEED), SEG_N, 1 << 16)
    comm = InProcessComm(8, dev)
    gs_collapse = make_global_sort(comm, finish="collapse")
    gs_rdma = make_global_sort(comm, finish="windows", exchange="rdma",
                               capacity_factor=2.0)
    gs_auto = make_global_sort(comm)
    return {
        "sort uniform u32 2^28": lambda: tpusort_torch.sort(uni),
        "sort_pairs uniform u32 + u32 2^28 (stable)":
            lambda: tpusort_torch.sort_pairs(uni, vals),
        "unstable_sort_pairs uniform u32 + u32 2^28":
            lambda: tpusort_torch.unstable_sort_pairs(uni, vals),
        "argsort uniform i32 2^28":
            lambda: tpusort_torch.argsort(uni.view(torch.int32)),
        "sort uniform u64 2^27": lambda: tpusort_torch.sort(u64),
        "unstable_sort_pairs uniform u64 + i64 2^27":
            lambda: tpusort_torch.unstable_sort_pairs(u64, v64),
        "sort_pairs(end_bit=24) uniform u32 + u32 2^28":
            lambda: tpusort_torch.sort_pairs(uni, vals, end_bit=24),
        "sort(begin_bit=8) uniform u32 2^28":
            lambda: tpusort_torch.sort(uni, begin_bit=8),
        "sort_pairs uniform u64 + i64 2^27 (stable)":
            lambda: tpusort_torch.sort_pairs(u64, v64),
        "argsort uniform i64 2^24": lambda: tpusort_torch.argsort(i64),
        "sort Zipf 1.1 u32 2^28": lambda: tpusort_torch.sort(zipf),
        "sort entropy-3 u32 2^28": lambda: tpusort_torch.sort(e3),
        "sort presorted u32 2^28": lambda: tpusort_torch.sort(presorted),
        "sort_pairs Zipf 1.1 u32 + u32 2^28 (stable)":
            lambda: tpusort_torch.sort_pairs(zipf, vals),
        "unstable_sort_pairs Zipf 1.1 u32 + u32 2^28":
            lambda: tpusort_torch.unstable_sort_pairs(zipf, vals),
        "sort Zipf 1.1 u64 2^27": lambda: tpusort_torch.sort(z64),
        "inclusive_sum i32 2^28": lambda: scan.inclusive_sum(small),
        "exclusive_sum f32 2^28": lambda: scan.exclusive_sum(f32),
        "digit_histogram (24, 8) uniform u32 2^28":
            lambda: histogram.digit_histogram(uni, 24, 8),
        "sort_batched (2^17, 2048) u32":
            lambda: tpusort_torch.sort_batched(uni.reshape(1 << 17, 2048)),
        "sort_batched (2^14, 16384) u32 + i32":
            lambda: tpusort_torch.sort_batched(
                uni.reshape(1 << 14, 1 << 14), vals.reshape(1 << 14, 1 << 14)),
        "segmented_sort keys 2^26, 2^16 equal segments":
            lambda: tpusort_torch.segmented_sort(seg_keys, equal),
        "segmented_sort unstable pairs 2^26, 2^16 equal segments":
            lambda: tpusort_torch.segmented_sort(seg_keys, equal, seg_vals,
                                                 stable=False),
        "segmented_sort stable pairs 2^26, 2^16 equal segments":
            lambda: tpusort_torch.segmented_sort(seg_keys, equal, seg_vals),
        "segmented_sort stable pairs 2^26, 2^16 ragged segments":
            lambda: tpusort_torch.segmented_sort(seg_keys, ragged, seg_vals),
        "segmented_sort stable pairs 2^26, float32 normal variates, 2^16 "
        "ragged segments (the sample gate's exact sort)":
            lambda: tpusort_torch.segmented_sort(normal, ragged, seg_vals),
        "global_sort u32 2^28, 8 in-process shards, collective + collapse":
            lambda: gs_collapse(uni),
        "global_sort u32 2^28, 8 in-process shards, rdma + windows (2.0)":
            lambda: gs_rdma(uni),
        "global_sort u32 2^20, 8 in-process shards, auto (windows)":
            lambda: gs_auto(uni[:1 << 20]),
    }


def _device_ms_by_name(prof) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time", None)
        if us is None:
            us = e.cuda_time
        out[e.name] = out.get(e.name, 0.0) + us / 1e3
    return out


def _window_busy_idle(events, span: str
                      ) -> Tuple[float, float, List[Tuple[str, float]]]:
    """The window ms of the host span named ``span`` among a profile's
    ``events``, the device's busy ms inside it (the union of the device
    operations' intervals), and its idle ms summed by the innermost host
    operation or span running when each gap began ("caller" where none
    was), the largest first.  User annotations are left out."""
    host, dev, window = [], [], None
    for e in events:
        a, b = e.time_range.start / 1e3, e.time_range.end / 1e3
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type != torch.autograd.DeviceType.CPU:
            dev.append((a, b))
        elif e.name == span:
            window = (a, b)
        else:
            host.append((e.name, a, b))
    if window is None:
        raise RuntimeError(f"the profile holds no span {span!r}")
    t0, t1 = window
    busy: List[List[float]] = []
    for a, b in sorted(dev):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    idle: Dict[str, float] = {}
    t = t0
    for a, b in busy + [[t1, t1]]:
        if a > t:
            running = [(hb - ha, name) for name, ha, hb in host
                       if ha <= t < hb]
            label = min(running)[1] if running else "caller"
            idle[label] = idle.get(label, 0.0) + (a - t)
        t = max(t, b)
    return (t1 - t0, sum(b - a for a, b in busy),
            sorted(idle.items(), key=lambda kv: -kv[1]))


def main(argv) -> None:
    from tpusort_torch.utils.log import span

    if not torch.cuda.is_available():
        raise SystemExit("profile_calls: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    calls = _calls(dev)
    for name, fn in calls.items():
        if argv and not any(a in name for a in argv):
            continue
        fn()
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with span(SPAN):
                fn()
                torch.cuda.synchronize()
        window, busy, idle = _window_busy_idle(prof.events(), SPAN)
        wall = statistics.median(walls)
        print(f"== {name}: wall {wall:.3f} ms (5 calls "
              f"{min(walls):.3f}..{max(walls):.3f}); traced call {window:.3f}"
              f" ms, device busy {busy:.3f} ms, idle share "
              f"{1 - busy / window:.3f} on {card}", flush=True)
        by_name = _device_ms_by_name(prof)
        for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:14]:
            print(f"   {ms:9.3f} ms  {k[:110]}", flush=True)
        print("   idle: " + "; ".join(
            f"{k[:50]} {ms:.3f} ms" for k, ms in idle[:8]), flush=True)
        host = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)[:6]
        print("   host: " + "; ".join(
            f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.3f} ms x{e.count}"
            for e in host), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
