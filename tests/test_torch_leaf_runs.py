"""K3's runs body for the general path's packed leaf on the CPU: the
leaf's choice between the runs body and the rows, its limits against
``csrc/sort_tiles.cu`` and ``csrc/merge_runs.cuh``, a numpy model of the
body against the rows' plain composite, and its launch through a stand-in
library.

The choice, :func:`tpusort_torch.kernels.bitonic.leaf_runs_geometry`, is a
pure function of the segment's shape (``seg``, the counts table's ``q``,
key planes, operands): the runs body where ``seg`` is a multiple of the
warp run (1,024 slots) and at most 16,384, ``q`` a multiple of the 32
slots a thread sorts, and the key one or two planes; else the rows (the
row build, K3's network over the padded rows, K4).

The body runs only on a card.  What can be checked without one is the
arithmetic it is made of, written here as the ``.cu`` file writes it: each
chunk's clamped count scanned into its compact start, each valid slot's
word (its remainder, the compact index under it) at its compact place,
runs of 1,024 compact slots sorted with all-ones pads, pairwise merges of
the runs, then each operand staged compact and gathered by the sorted
words' indices to the segment's dense offset, zeros past the valid
total.  The model must give
the rows' plain composite (``ops.msd.packed_leaf_plain``) bit for bit:
the compact index rises with input order as the rows' position does.
The card holds the kernel to the same composite
(``tests/test_torch_cuda.py``: ``test_packed_leaf_runs_body``).
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpusort_torch.configs import get_config
from tpusort_torch.kernels import _build
from tpusort_torch.kernels import bitonic as tb
from tpusort_torch.ops import msd as tm

CSRC = Path(tb.__file__).resolve().parent.parent / "csrc"
RUN = 32 * tb.LEAF_RUNS_SLOTS             # a warp's run: 1,024 slots
PAD = 0xFFFFFFFF                           # an all-ones slot


@pytest.mark.parametrize("seg,q,nk,n_ops,takes", [
    (12288, 512, 1, 2, True),     # the 2^28 [0, 24) pairs (the cell)
    (12288, 512, 1, 1, True),     # the 2^28 [8, 32) keys
    (6144, 512, 1, 2, True),      # 2^22 and 2^27 pairs
    (3072, 512, 1, 3, True),      # 2^20 pairs with two value words
    (2048, 128, 1, 2, True),      # q below the warp run
    (2048, 256, 2, 3, True),      # a 64-bit key's two planes
    (16384, 512, 1, 16, True),    # the largest segment, 16 operands
    (1024, 512, 2, 2, True),      # one warp run
    (8192, 32, 1, 2, True),       # 256 chunks, one warp's scan
    (24576, 512, 1, 1, False),    # the 2^24 keys: over 16,384 slots
    (768, 256, 1, 2, False),      # the 2^24 pairs: not a warp run's multiple
    (1536, 512, 1, 2, False),     # nor 1,536
    (12800 + 128, 128, 1, 2, False),
    (32768, 512, 1, 2, False),
    (12288, 512, 3, 4, False),    # three planes
    (12288, 48, 1, 2, False),     # q not a multiple of 32 slots
    (16384, 32, 1, 2, False),     # 512 chunks, past one warp's scan
    (12288, 512, 1, 17, False),   # past the 16 operands
])
def test_runs_body_choice(seg, q, nk, n_ops, takes):
    geo = tb.leaf_runs_geometry(seg, q, nk, n_ops)
    assert (geo is not None) == takes
    if takes:
        assert geo.run == RUN and geo.slots == tb.MERGE_SLOTS[1]
        assert geo.threads % 32 == 0 and geo.threads * geo.slots == seg
        assert geo.smem_bytes == \
            tb.merge_smem_bytes(seg, 1, False, seg // RUN) + 2 * seg


def test_the_cells_leaf_takes_the_runs_body():
    """The 2^28 bit-range pairs' plan: 32,768 segments of 12,288 under q
    512, one plane: 384 threads of 32 sort slots and 32 merge outputs,
    75,320 bytes."""
    kw = get_config(32, True, "cuda").plan_kwargs()
    kw.pop("min_n")
    plan = tm.plan_msd(1 << 28, 0, 24, leaf_profile="packed", **kw)
    q = plan.passes[-1].s & -plan.passes[-1].s
    assert (plan.n_segments, plan.seg, q) == (32768, 12288, 512)
    assert not tm.leaf_is_wide(plan)
    assert tb.leaf_runs_geometry(plan.seg, q, 1, 2) == tb.MergeGeometry(
        1024, 384, 32, 75320)


def test_limits_match_the_c_side():
    """The Python limits are the C constants: the slots a thread sorts
    (runs_slots(1, false)), the largest tile, the most chunks one warp
    scans, a merge thread's outputs for one plane, the shared memory."""
    cuh = (CSRC / "merge_runs.cuh").read_text()
    cu = (CSRC / "sort_tiles.cu").read_text()
    assert re.search(r"return nk \+ \(idx \? 1 : 0\) == 1 \? 32 : 16;", cuh)
    assert tb.LEAF_RUNS_SLOTS == 32
    assert int(re.search(r"kRunsMaxTile = (\d+);", cuh).group(1)) == \
        tb.RUNS_MAX_TILE
    assert int(re.search(r"kMergeMaxRuns = (\d+);", cuh).group(1)) == \
        tb.MERGE_MAX_RUNS
    assert re.search(r"nk == 1 \? (\d+)", cuh).group(1) == \
        str(tb.MERGE_SLOTS[1])
    assert "kLeafSlots = runs_slots(1, false)" in cu
    assert "merge_slots(1) == kLeafSlots" in cu
    assert "threads == K / kLeafSlots && smem == leaf_smem_bytes(K)" in cu
    assert re.search(r"MergeTile<1, false>::bytes\(K, K / kLeafRun\) \+\s+"
                     r"\(size_t\)K \* sizeof\(uint16_t\)", cu)


def _remainder(words, lo, width):
    """Bits [lo, lo + width) of the key, plane 0 the most significant
    (digit_of)."""
    nk = len(words)
    r = np.zeros(words[0].shape, dtype=np.uint64)
    for p, w in enumerate(words):
        base = 32 * (nk - 1 - p)
        a, b = max(lo, base), min(lo + width, base + 32)
        if b > a:
            r |= ((w.astype(np.uint64) >> np.uint64(a - base))
                  & np.uint64((1 << (b - a)) - 1)) << np.uint64(a - lo)
    return r


def runs_body_model(ops, nk, ct, q, seg, rem_lo, rem_width, n_out):
    """The body as ``csrc/sort_tiles.cu`` runs it, one segment a CTA, on
    uint32 numpy words; returns one (n_out,) array per operand."""
    nseg = ct.shape[0]
    c = np.clip(ct.astype(np.int64), 0, q)
    totals = c.sum(axis=1)
    off = np.concatenate([[0], np.cumsum(totals)])      # the offsets
    outs = [np.zeros(n_out, dtype=np.uint32) for _ in ops]
    i = np.arange(seg)
    for s in range(nseg):
        cs = np.concatenate([[0], np.cumsum(c[s])])       # scan_starts
        nv = int(cs[-1])
        valid = i % q < c[s, i // q]
        place = (cs[i // q] + i % q)[valid]                # load_valid
        rows = [o[s * seg:(s + 1) * seg] for o in ops]
        ib = (seg - 1).bit_length()                       # under the remainder
        elems = np.zeros(nv, dtype=np.uint64)
        elems[place] = _remainder([r[valid] for r in rows[:nk]], rem_lo,
                                  rem_width) << np.uint64(ib) \
            | place.astype(np.uint64)
        assert elems.max(initial=0) < 2**31                # the top bit clear
        runs = []
        for b in range(0, nv, RUN):                        # sort_leaf_runs
            run = np.full(RUN, PAD, dtype=np.uint64)
            run[:min(RUN, nv - b)] = elems[b:b + RUN]
            runs.append(np.sort(run)[:min(RUN, nv - b)])
        while len(runs) > 1:                               # merge_levels
            # the words are distinct: a merge of two sorted runs is their
            # sorted union
            runs = [np.sort(np.concatenate(runs[j:j + 2]))
                    for j in range(0, len(runs), 2)]
        idx = (runs[0] & np.uint64((1 << ib) - 1)).astype(np.int64) if runs \
            else np.zeros(0, dtype=np.int64)
        o = int(off[s])
        cnt = max(0, min(nv, n_out - o))
        for k, r in enumerate(rows):                       # the epilogue
            staged = np.zeros(nv, dtype=np.uint32)
            staged[place] = r[valid]
            outs[k][o:o + cnt] = staged[idx][:cnt]
    return outs


def _table(rng, nseg, seg, q, kind):
    ct = rng.integers(0, q + 1, (nseg, seg // q))
    if kind == "empty_full":
        ct[0::3] = 0
        ct[1::3] = q
    elif kind == "alternating":
        ct[:, 0::2] = 0
        ct[:, 1::2] = q
    return ct.astype(np.int32)


# (key planes, payload words, rem_lo, rem_width, seg, q, kind): keys only,
# one and two payload words, a remainder above bit 0 (begin_bit 8), a
# remainder across two planes, empty and full segments and chunks, equal
# remainders (ties in input order), the widest remainder the packed leaf
# leaves (the word's top bit its last clear one)
MODEL = {
    "keys": (1, 0, 0, 9, 3072, 512, "uniform"),
    "one_value": (1, 1, 0, 14, 3072, 512, "uniform"),
    "two_values": (1, 2, 0, 14, 2048, 256, "uniform"),
    "begin_bit_8": (1, 1, 8, 14, 3072, 512, "uniform"),
    "two_planes": (2, 1, 26, 12, 1024, 128, "uniform"),
    "two_planes_keys": (2, 0, 20, 14, 1024, 512, "empty_full"),
    "empty_full": (1, 1, 0, 12, 3072, 512, "empty_full"),
    "alternating": (1, 1, 4, 10, 2048, 128, "alternating"),
    "ties": (1, 1, 0, 9, 3072, 512, "ties"),
    "widest": (1, 1, 0, 20, 1024, 32, "uniform"),
    "ties_two_planes": (2, 2, 28, 8, 1024, 256, "ties"),
    "cell_shape": (1, 1, 0, 9, 12288, 512, "uniform"),
}


@pytest.mark.parametrize("name", sorted(MODEL))
@pytest.mark.parametrize("cut", [0, 1000, -37])
def test_runs_body_model_matches_the_rows(name, cut):
    """The model against the rows' plain composite on CPU tensors, every
    output word, with n_out the valid total, cut short, or past it."""
    nk, nv, rem_lo, rem_width, seg, q, kind = MODEL[name]
    nseg = 2 if seg > 4096 else 6
    rng = np.random.default_rng(hash(name) % 2**32)
    ct = _table(rng, nseg, seg, q, kind)
    words = [rng.integers(0, 2**32, nseg * seg, dtype=np.uint64)
             .astype(np.uint32) for _ in range(nk + nv)]
    if kind == "ties":
        rem = _remainder(words[:nk], rem_lo, rem_width)
        for p in range(nk):            # clear the range's bits: all equal
            base = 32 * (nk - 1 - p)
            a = max(rem_lo, base) - base
            b = min(rem_lo + rem_width, base + 32) - base
            if b > a:
                m = np.uint32(((1 << (b - a)) - 1) << a)
                words[p] = words[p] & ~m
        assert rem.any()
        assert not _remainder(words[:nk], rem_lo, rem_width).any()
    plan = tm.MsdPlan(m1=nseg * seg, passes=(), seg=seg, n_segments=nseg,
                      m_final=nseg * seg, rem_lo=rem_lo, rem_width=rem_width)
    assert not tm.leaf_is_wide(plan)
    assert tb.leaf_runs_geometry(seg, q, nk, nk + nv) is not None
    n_out = max(int(ct.sum()) - cut, 0)
    ops = [torch.from_numpy(w.view(np.int32).copy()) for w in words]
    want = tm.packed_leaf_plain(ops, nk, torch.from_numpy(ct).reshape(-1),
                                q, plan, n_out)
    got = runs_body_model(words, nk, ct, q, seg, rem_lo, rem_width, n_out)
    for g, w in zip(got, want):
        assert np.array_equal(g.view(np.int32), w.numpy())


def test_cpu_leaf_stays_on_the_rows(monkeypatch):
    """On CPU tensors ``packed_leaf`` is the rows' composite through the
    K3 and K4 wrappers (their plain versions), whatever the shape."""
    def no_runs(*a, **k):
        raise AssertionError("the runs body launched on the CPU")

    monkeypatch.setattr(tm, "sort_leaf_runs", no_runs)
    nseg, seg, q = 4, 3072, 512
    rng = np.random.default_rng(5)
    ct = torch.from_numpy(_table(rng, nseg, seg, q, "uniform")).reshape(-1)
    ops = [torch.from_numpy(rng.integers(-2**31, 2**31, nseg * seg)
                            .astype(np.int32)) for _ in range(2)]
    plan = tm.MsdPlan(m1=nseg * seg, passes=(), seg=seg, n_segments=nseg,
                      m_final=nseg * seg, rem_lo=0, rem_width=14)
    n = int(ct.sum())
    tm.reset_counters()
    got = tm.packed_leaf(list(ops), 1, ct, q, plan, n)
    want = tm.packed_leaf_plain(ops, 1, ct, q, plan, n)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tm.mode_counters() == {}


@pytest.mark.parametrize("nk,nv", [(1, 1), (1, 0), (2, 2)])
def test_runs_body_launch(monkeypatch, nk, nv):
    """The wrapper's two launches through a stand-in library: the offsets
    over the rows' valid counts, then the body with the geometry of
    :func:`leaf_runs_geometry`; one K3 launch tagged "runs", no K4."""
    calls = []

    def offsets(*a):
        calls.append(("offsets", a))
        return 0

    def body(*a):
        calls.append(("body", a))
        return 0

    stub = SimpleNamespace(tpusort_collapse_offsets=offsets,
                           tpusort_sort_leaf_runs=body)
    monkeypatch.setattr(_build, "library", lambda: stub)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    nseg, seg, q = 8, 12288, 512
    ops = [torch.zeros(nseg, seg, dtype=torch.int32) for _ in range(nk + nv)]
    ct = torch.full((nseg, seg // q), 300, dtype=torch.int32)
    geo = tb.leaf_runs_geometry(seg, q, nk, nk + nv)
    tm.reset_counters()
    outs = tb._sort_leaf_runs_cuda(ops, ct, q, 57000, nk, 8, 14, geo)
    assert [o.shape for o in outs] == [(57000,)] * (nk + nv)
    assert [c[0] for c in calls] == ["offsets", "body"]
    a = calls[1][1]
    assert (a[2], a[3], a[5], a[7], a[8], a[9], a[10], a[11]) == \
        (nk + nv, nk, q, 57000, nseg, seg, 8, 14)
    assert (a[12], a[13], a[14]) == (1024, 384, 75320)
    assert calls[0][1][3:5] == (nseg, seg)
    assert tm.mode_counters() == {("K3", nk, nv, "runs"): 1}
    assert tm.counters()["k4_launches"] == 0


def test_runs_body_refuses_what_it_does_not_take():
    x = [torch.zeros(4, 768, dtype=torch.int32)] * 2
    with pytest.raises(ValueError):
        tb.sort_leaf_runs(x, torch.zeros(4, 3, dtype=torch.int32), 256, 10,
                          num_keys=1, rem_lo=0, rem_width=9)
    x = [torch.zeros(4, 3072, dtype=torch.int32)] * 2
    with pytest.raises(ValueError):      # a CPU tensor: no kernel
        tb.sort_leaf_runs(x, torch.zeros(4, 6, dtype=torch.int32), 512, 10,
                          num_keys=1, rem_lo=0, rem_width=9)
