"""K2's two bodies on the CPU: the wrapper's choice between the merge body
(``csrc/merge_runs.cuh``) and the network body, and the precondition the
merge body rests on, for K2 and for K1's and K1b's merge body (the choice
of theirs is in ``test_torch_partition_merge.py``).

The choice, :func:`tpusort_torch.kernels.bitonic.leaf_merge_geometry`, is
a pure function of the call's shape (K, q, sorted_run, key planes, payload
words) that picks the network wherever ``sorted_run`` is 0; its limits
must be the C side's.  The merge body merges each q-run's valid prefix as
it stands, so every caller that passes ``sorted_run`` > 0 must hand K2
runs whose valid prefixes ascend lexicographically over the planes, and,
where the result is to be stable, whose equal keys lie in input order
when read in slot order (the merge takes the earlier run's first, as the
network's (key, slot) order does).  The callers run here on the plain
kernels at the CPU geometry, with K2 spied on: ``msd.sort_twiddled_msd``
(keys, 64-bit keys, stable and unstable pairs), the equi-depth tier, the
segmented engine route and the global sort's windows finish.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusort_torch import api as tapi
from tpusort_torch import dtypes as tdt
from tpusort_torch.configs import get_config
from tpusort_torch.kernels import bitonic as tb
from tpusort_torch.kernels import partition as tp
from tpusort_torch.kernels.partition import SMEM_MAX
from tpusort_torch.ops import equidepth as teq
from tpusort_torch.ops import msd as tm
from tpusort_torch.ops import segmented as tseg
from tpusort_torch.utils.datagen import entropy_keys, segment_offsets

# the registered engines: each, then the exact sort where its flag is set
MSD = tapi._ENGINES["msd"]
EQUIDEPTH = tapi._ENGINES["msd_equidepth"]

CSRC = Path(tb.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("K,q,run,nk,nv,want", [
    # the 2^28 paths' leaves, one final segment a tile (24 runs of 512):
    # keys, key + value, composite + value, 2 planes, 2 planes + 2 values
    (12288, 512, 512, 1, 0, (512, 384, 32)),
    (12288, 512, 512, 1, 1, (512, 384, 32)),
    (12288, 512, 512, 2, 1, (512, 512, 24)),
    (12288, 512, 512, 2, 0, (512, 512, 24)),
    (12288, 512, 512, 2, 2, (512, 512, 24)),
    (12288, 512, 512, 3, 1, (512, 768, 16)),
    # two segments a tile, as the network packs them
    (24576, 512, 512, 1, 0, (512, 768, 32)),
    (24576, 512, 512, 1, 1, (512, 768, 32)),
    # the skew tier's leaves: runs of 640 cut into q = 128
    (15360, 128, 128, 1, 0, (128, 480, 32)),
    (15360, 128, 128, 2, 1, (128, 640, 24)),
    # q not a power of two: runs of its largest power-of-two divisor
    (12288, 768, 256, 1, 1, (256, 384, 32)),
    (3072, 384, 512, 1, 0, (128, 96, 32)),
    (2048, 128, 128, 3, 8, (128, 128, 16)),
    # the wide leaf after K1c's unsorted runs, and no sorted_run at all
    (12288, 512, 0, 3, 4, None),
    (12288, 512, 0, 1, 0, None),
    # runs below 128 slots, more than 256 runs, registers or shared
    # memory a CTA does not have
    (2048, 128, 64, 1, 0, None),
    (32768, 128, 64, 1, 0, None),
    (32768, 512, 512, 1, 1, None),
    (32768, 128, 128, 1, 0, None),
    (16384, 512, 512, 3, 0, None),
    (24576, 512, 512, 3, 0, None),
])
def test_leaf_body_choice(K, q, run, nk, nv, want):
    """The body K2's wrapper picks, from the call's shape alone."""
    geo = tb.leaf_merge_geometry(K, q, run, nk, nv)
    got = None if geo is None else (geo.run, geo.threads, geo.slots)
    assert got == want
    # pure: the same answer uncached, and the same again
    assert tb.leaf_merge_geometry.__wrapped__(K, q, run, nk, nv) == geo
    if geo is not None:
        runs = K // geo.run
        assert geo.smem_bytes == tb.merge_smem_bytes(K, nk, nv > 0, runs)


@pytest.mark.parametrize("nk,nv", [(1, 0), (1, 1), (2, 1), (3, 1)])
@pytest.mark.parametrize("q", [None, 64, 128, 256, 512])
def test_leaf_tiles_follow_the_wrappers_choice(nk, nv, q):
    """``msd.leaf_tiles`` and K2's wrapper read the same shape: where the
    wrapper merges the raw leaf's tile (its counts table's q given), the
    tiles are one final segment each; where it takes the network and the
    network could pack segments, they are packed."""
    plan = tm.plan_msd(1 << 28, 0, 32, k=16384, r=32)
    run = plan.passes[-1].s & -plan.passes[-1].s
    nt, tile = tm.leaf_tiles(plan, nk, nv > 0, q)
    merge = tb.leaf_merge_geometry(tile, q or run, run, nk, nv)
    if merge is not None:
        assert (nt, tile) == (plan.n_segments, plan.seg)
    elif min(1 << 15, tb.leaf_tile_cap(nk, nv > 0)) >= 2 * plan.seg:
        assert tile > plan.seg
    assert nt * tile == plan.n_segments * plan.seg
    # the path's own q is the default, and it merges
    if q in (None, run):
        assert merge is not None


def _leaf_shapes():
    out = []
    for nk in (1, 2, 3):
        for nv in (0, 1, 2, 8):
            for K in (384, 1536, 6144, 12288, 16384, 24576, 32768):
                for q in (128, 256, 512, 768):
                    if K % q == 0:
                        out.append((nk, nv, K, q))
    return out


@pytest.mark.parametrize("nk", [1, 2, 3])
def test_leaf_body_choice_geometry_holds(nk):
    """Every merge geometry the choice gives is one the C entry point
    takes: the slots its planes' instance holds, the fewest threads (a
    multiple of 32, at most 768) that cover K with them, runs of a power
    of two from 128 dividing q and sorted_run, at most 256 runs, the
    buffer within a CTA; and sorted_run 0 never merges."""
    for nk_, nv, K, q in _leaf_shapes():
        if nk_ != nk:
            continue
        assert tb.leaf_merge_geometry(K, q, 0, nk, nv) is None
        for run in (128, 256, 512, 1024, K):
            if run & (run - 1):
                continue
            geo = tb.leaf_merge_geometry(K, q, run, nk, nv)
            if geo is None:
                continue
            assert geo.run & (geo.run - 1) == 0 and geo.run >= 128
            assert q % geo.run == 0 and run % geo.run == 0
            assert K // geo.run <= tb.MERGE_MAX_RUNS
            assert geo.threads % 32 == 0 and geo.threads * geo.slots >= K
            assert geo.slots == {1: 32, 2: 24, 3: 16}[nk]
            assert geo.slots * nk <= 48
            assert geo.threads <= 768
            assert geo.threads == -(-K // (32 * geo.slots)) * 32
            assert geo.smem_bytes <= SMEM_MAX


def test_leaf_merge_limits_match_csrc():
    """The Python limits are the C side's (``csrc/merge_runs.cuh``)."""
    src = (CSRC / "merge_runs.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMergeMinRun") == tb.MERGE_MIN_RUN
    assert const("kMergeMaxRuns") == tb.MERGE_MAX_RUNS
    assert const("kMergeThreads") == tb.MERGE_THREADS
    # merge_slots(nk): the slots a thread for one, two or three planes
    slots = re.search(r"return nk == 1 \? (\d+) : nk == 2 \? (\d+) : "
                      r"(\d+);", src).groups()
    assert dict(zip((1, 2, 3), map(int, slots))) == tb.MERGE_SLOTS
    # the buffer: merge_word(K) = K + K / 32 words a plane, as in Python
    assert "s + (s >> 5)" in src
    assert tb.merge_smem_bytes(128, 1, False, 1) == (128 + 4) * 4 + 12
    assert tb.merge_smem_bytes(128, 2, True, 1) == (128 + 4) * 12 + 12


# ---- the precondition, caller by caller ---------------------------------


def _spy(monkeypatch):
    """Record every K2 call of the raw and general leaves (``ops.msd``'s
    name, which ``raw_leaf`` and ``_leaf_sort`` call)."""
    calls = []
    real = tm.sort_tiles_counts_collapsed

    def spy(op, counts, q, n_out, *, sorted_run=0, num_keys=1):
        ops = list(op) if isinstance(op, (list, tuple)) else [op]
        calls.append(([o.clone() for o in ops], counts.clone(), q,
                      sorted_run, num_keys))
        return real(op, counts, q, n_out, sorted_run=sorted_run,
                    num_keys=num_keys)

    monkeypatch.setattr(tm, "sort_tiles_counts_collapsed", spy)
    return calls


def _check_runs(ops, counts, q, sorted_run, num_keys, stable_word=None):
    """Each merge run's valid prefix ascends lexicographically over the
    planes; with ``stable_word`` (the operand holding each element's input
    index), equal keys read in slot order come in input order."""
    T, K = ops[0].shape
    L = min(sorted_run, q & -q)
    runs = K // L
    first = torch.arange(runs) * L
    n = (counts[:, first // q].to(torch.int64) - (first % q)[None, :]) \
        .clamp(0, L)                                          # (T, runs)
    planes = [(o.to(torch.int64) & 0xFFFFFFFF).reshape(T, runs, L)
              for o in ops[:num_keys]]
    pos = torch.arange(1, L)
    both = pos[None, None, :] < n[..., None]       # slots s - 1 and s valid
    le = planes[-1][..., :-1] <= planes[-1][..., 1:]
    for p in reversed(planes[:-1]):
        a, b = p[..., :-1], p[..., 1:]
        le = (a < b) | ((a == b) & le)
    assert bool(le[both].all()), "a run's valid prefix does not ascend"
    if stable_word is None:
        return
    slot = torch.arange(L)[None, None, :] < n[..., None]
    for t in range(T):
        valid = slot[t].reshape(-1)
        key = [p[t].reshape(-1)[valid] for p in planes]
        idx = (ops[stable_word][t][valid].to(torch.int64) & 0xFFFFFFFF)
        order = torch.arange(idx.numel())
        for k in reversed(key):                # lexicographic, stable
            order = order[torch.sort(k[order], stable=True).indices]
        ks = [k[order] for k in key]
        same = torch.ones(order.numel() - 1, dtype=torch.bool)
        for k in ks:
            same &= k[1:] == k[:-1]
        ix = idx[order]
        assert bool((ix[1:][same] > ix[:-1][same]).all()), \
            "equal keys in slot order are not in input order"


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _ties(rng, n):
    """uint32 keys with about twelve copies of each value, spread over the
    range: ties across the runs of a final segment."""
    pool = rng.integers(0, 1 << 32, n // 12 + 1, dtype=np.uint64)
    return pool[rng.integers(0, pool.size, n)].astype(np.uint32)


def _msd_keys(rng, n=60_000):
    x = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    (sp,), _ = MSD(
        (_i32(x),), (), begin_bit=0, end_bit=32, total_bits=32,
        config=get_config(32, False, "cpu"))
    return np.array_equal(sp.numpy().view(np.uint32), np.sort(x)), None


def _msd_u64(rng, n=40_000):
    x = rng.integers(0, 1 << 63, n, dtype=np.int64)
    planes, traits = tdt.twiddle_in(torch.from_numpy(x))
    sp, _ = MSD(
        planes, (), begin_bit=0, end_bit=64, total_bits=64,
        config=get_config(64, False, "cpu"))
    got = tdt.twiddle_out(sp, traits).numpy()
    return np.array_equal(got, np.sort(x)), None


def _msd_pairs(rng, stable, n=60_000):
    x = _ties(rng, n)
    v = np.arange(x.size, dtype=np.uint32)
    (sk,), (sv,) = MSD(
        (_i32(x),), (_i32(v),), begin_bit=0, end_bit=32, total_bits=32,
        config=get_config(32, True, "cpu"), stable=stable)
    keys = sk.numpy().view(np.uint32)
    vals = sv.numpy().view(np.uint32)
    ok = np.array_equal(keys, np.sort(x)) and np.array_equal(x[vals], keys)
    if stable:
        ok = ok and np.array_equal(vals, np.argsort(x, kind="stable"))
    # operand 1, the value word, is the input index on the contiguous feed
    return ok, (1 if stable else None)


def _equidepth(rng):
    x = entropy_keys(rng, 60_000, 2)
    (sp,), _ = EQUIDEPTH(
        (_i32(x),), (), begin_bit=0, end_bit=32, total_bits=32,
        plan_kwargs=dict(k=2048, r=8, s1=384, s=256, leaf_max=4096,
                         min_n=1, sample_log2=15))
    return np.array_equal(sp.numpy().view(np.uint32), np.sort(x)), None


def _segmented(rng, n=20_000):
    keys = _ties(rng, n)
    offs = segment_offsets(rng, n, 40)
    (plane,), _ = tdt.twiddle_in(torch.from_numpy(keys))
    seg = torch.from_numpy(np.searchsorted(offs[1:], np.arange(n),
                                           side="right").astype(np.int32))
    vals = torch.arange(n, dtype=torch.int32)
    tm.reset_counters()
    _, (sv,) = tseg._sort_on_engine(np.asarray(offs, np.int64), seg, plane,
                                    [vals], stable=True)
    c = tm.counters()                # the engine's output, not the exact way
    assert c["overflow_fallbacks"] == c["reference_routes"] == 0
    order = np.lexsort((np.arange(n), keys, seg.numpy()))
    return np.array_equal(sv.numpy(), order), None


def _windows(rng, d=8, window=2048, lo=700):
    counts = rng.integers(lo, window // 2 + 1, d).astype(np.int32)
    keys = np.full((d, window), 0xDEADBEEF, np.uint32)
    for w, c in enumerate(counts):
        keys[w, :c] = np.sort(rng.integers(0, 1 << 32, c, dtype=np.uint64)
                              .astype(np.uint32))
    n = int(counts.sum())
    res = tm.sort_windows_msd(
        (_i32(keys.reshape(-1)),), (), window_counts=torch.from_numpy(counts),
        window=window, n=n, total_bits=32,
        plan_kwargs=dict(k=2048, r=16, s1=256, min_n=4096))
    assert res is not None
    (tk,), ovf = res
    want = np.sort(np.concatenate([keys[w, :c] for w, c in enumerate(counts)]))
    return not bool(ovf) and np.array_equal(tk.numpy().view(np.uint32),
                                            want), None


CALLERS = {
    "msd_keys": _msd_keys,
    "msd_u64_keys": _msd_u64,
    "msd_stable_pairs": lambda rng, **kw: _msd_pairs(rng, True, **kw),
    "msd_unstable_pairs": lambda rng, **kw: _msd_pairs(rng, False, **kw),
    "equidepth": _equidepth,
    "segmented": _segmented,
    "windows": _windows,
}


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_sorted_run_callers_hand_k2_ascending_runs(monkeypatch, caller):
    """Each caller that passes K2 a sorted_run runs on the plain kernels
    with K2 spied on: its output is exact, it called K2 with sorted_run >
    0, and every merge run it handed over ascends over its valid prefix
    (and, on the stable route, holds equal keys in input order)."""
    calls = _spy(monkeypatch)
    ok, stable_word = CALLERS[caller](np.random.default_rng(2100))
    assert ok
    runs = [c for c in calls if c[3] > 0]
    assert runs, f"{caller} handed K2 no sorted runs"
    for ops, counts, q, sorted_run, num_keys in runs:
        _check_runs(ops, counts, q, sorted_run, num_keys, stable_word)


# ---- K1 and K1b: the same precondition for their merge body -------------

# sizes at which each caller runs a second partition pass on the CPU
# geometry (K1 merges from pass 1 on; the equi-depth plan already has two)
K1_SIZES = {"msd_keys": dict(n=300_000), "msd_u64_keys": dict(n=300_000),
            "msd_stable_pairs": dict(n=300_000),
            "msd_unstable_pairs": dict(n=300_000),
            "segmented": dict(n=300_000),
            "windows": dict(d=128, window=4096, lo=1500)}


def _spy_k1(monkeypatch):
    """Record every K1 and K1b call of the engines' partition passes
    (``ops.msd.run_passes``, the equi-depth pipeline) on a shape whose
    sorted runs the merge body takes."""
    calls = []
    real = tp.partition_pass_fused

    def spy(planes, values, counts_in, **kw):
        if counts_in is not None and not kw.get("general") and \
                tp.partition_merge_geometry(planes[0].shape[1], kw["q_in"],
                                            kw.get("sorted_run"),
                                            len(planes), len(values)):
            calls.append(([p.clone() for p in planes], counts_in.clone(),
                          kw["q_in"], kw["sorted_run"]))
        return real(planes, values, counts_in, **kw)

    monkeypatch.setattr(tm, "partition_pass_fused", spy)
    monkeypatch.setattr(teq, "partition_pass_fused", spy)
    return calls


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_sorted_run_callers_hand_k1_ascending_runs(monkeypatch, caller):
    """Each caller that passes K1 or K1b a sorted_run runs on the plain
    kernels with K1 spied on, at a size that gives it a second pass: its
    output is exact, it called K1 on a shape the merge body takes
    (``partition_merge_geometry``), and every merge run it handed over
    ascends over its valid prefix."""
    calls = _spy_k1(monkeypatch)
    ok, _ = CALLERS[caller](np.random.default_rng(2300),
                            **K1_SIZES.get(caller, {}))
    assert ok
    assert calls, f"{caller} handed K1 no runs the merge body takes"
    for planes, counts, q, sorted_run in calls:
        _check_runs(planes, counts, q, sorted_run, len(planes))
