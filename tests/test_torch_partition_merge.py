"""K1's and K1b's two bodies on the CPU: the wrappers' choice between the
merge body (``csrc/partition.cu: partition_sorted`` on
``csrc/merge_runs.cuh``) and the network body.

The choice, :func:`tpusort_torch.kernels.partition.partition_merge_geometry`,
is a pure function of the call's shape (K, q_in, sorted_run, key planes,
payload words): the merge wherever a later pass's tile arrives as sorted
runs under a counts table and K2's merge geometry fits beside K1's static
arrays; the network for pass 0, the emit-only mode and three planes at
16,384 slots.  Its limits must be the C side's.  The precondition the
merge body rests on, caller by caller, is held in
``test_torch_leaf_merge.py`` beside K2's.
"""

import re
from pathlib import Path

import pytest

from tpusort_torch.configs import get_config
from tpusort_torch.kernels import bitonic as tb
from tpusort_torch.kernels import partition as tp
from tpusort_torch.ops import equidepth as teq
from tpusort_torch.ops import msd as tm

CSRC = Path(tp.__file__).resolve().parent.parent / "csrc"
N28 = 1 << 28


@pytest.mark.parametrize("K,q,run,nk,nv,want", [
    # the 2^28 plans' passes 1 and 2 (runs of 768 read as 256, then 512):
    # keys, key + value, composite + value (the skew tier's stable pairs)
    (16384, 256, 256, 1, 0, (256, 512, 32)),
    (16384, 512, 512, 1, 0, (512, 512, 32)),
    (16384, 256, 256, 1, 1, (256, 512, 32)),
    (16384, 512, 512, 1, 1, (512, 512, 32)),
    (16384, 256, 256, 2, 1, (256, 704, 24)),
    (16384, 512, 512, 2, 1, (512, 704, 24)),
    (16384, 256, 256, 2, 0, (256, 704, 24)),
    # a small tile of three planes: few threads at 16 slots
    (2048, 128, 128, 3, 1, (128, 128, 16)),
    # pass 0 (no counts table, or the strided feed's with no sorted run)
    (16384, None, None, 1, 0, None),
    (16384, 128, None, 1, 1, None),
    (16384, 128, None, 2, 1, None),
    # the emit-only mode (the windows finish's pass 0)
    (16384, 16384, 16384, 1, 0, None),
    (16384, 16384, 16384, 1, 1, None),
    # three planes at 16,384 (1,024 threads), runs under 128, too many
    # threads at 32,768
    (16384, 256, 256, 3, 0, None),
    (16384, 512, 512, 3, 1, None),
    (16384, 128, 64, 1, 0, None),
    (32768, 128, 128, 1, 0, None),
])
def test_partition_body_choice(K, q, run, nk, nv, want):
    """The body K1's and K1b's wrappers pick, from the call's shape."""
    geo = tp.partition_merge_geometry(K, q, run, nk, nv)
    got = None if geo is None else (geo.run, geo.threads, geo.slots)
    assert got == want
    assert tp.partition_merge_geometry.__wrapped__(K, q, run, nk, nv) == geo
    if geo is not None:
        assert geo.smem_bytes == tb.merge_smem_bytes(K, nk, nv > 0,
                                                     K // geo.run)
        assert geo.smem_bytes + tp.K1_STATIC_SMEM <= tp.SMEM_MAX


def _plans():
    """(route, planes, payloads, first q, the sorted_run a pass hands on,
    plan) of the four 32-bit cells' 2^28 calls: the radix tier's keys and
    stable pairs, the skew tier's keys and composite + value."""
    out = []
    for pairs in (False, True):
        kw = get_config(32, pairs, "cuda").plan_kwargs()
        kw.pop("min_n", None)
        out.append((f"radix {'pairs' if pairs else 'keys'}", 1, int(pairs),
                    None, lambda s: s & -s, tm.plan_msd(N28, 0, 32, **kw)))
    for pairs, nk in ((False, 1), (True, 2)):
        kw, _, _, m, lmax = teq._prepare(
            N28, get_config(32, pairs, "cuda").plan_kwargs())
        plan = teq._widen_last(tm.plan_msd(N28, 0, 32 * nk, **kw), N28, m,
                               lmax)
        out.append((f"skew {'pairs' if pairs else 'keys'}", nk, int(pairs),
                    128, lambda s: s & -s, plan))
    return out


@pytest.mark.parametrize("route,nk,nv,q0,run_of,plan", _plans(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_partition_body_on_the_2p28_plans(route, nk, nv, q0, run_of, plan):
    """At 2^28 each 32-bit route's pass 0 takes the network and passes 1
    and 2 the merge body, on runs of 256 then 512 (as the engines hand K1
    its counts table's q and the last pass's run)."""
    assert len(plan.passes) == 3
    q, prev, runs = q0, None, []
    for spec in plan.passes:
        geo = tp.partition_merge_geometry(
            spec.k, q, None if prev is None else run_of(prev), nk, nv)
        runs.append(None if geo is None else geo.run)
        q, prev = spec.s & -spec.s, spec.s
    assert runs == [None, 256, 512], route


@pytest.mark.parametrize("nk,nv", [(nk, nv) for nk in (1, 2, 3)
                                   for nv in (0, 1, 2, 8)])
def test_partition_merge_geometry_holds(nk, nv):
    """Every merge geometry the choice gives is one the C entry point
    takes (``merge_geometry_ok``): runs of a power of two from 128
    dividing q and the sorted run, at most 256 a tile, the planes' slots,
    the fewest warps that cover K, at most 768 threads, and the buffer
    beside K1's static arrays within a CTA; no sorted run, no counts
    table, or a sorted run of the whole tile never merges."""
    for K in (1 << lk for lk in range(7, 16)):
        for q in (128, 256, 512, 1024):
            if K % q:
                continue
            assert tp.partition_merge_geometry(K, q, None, nk, nv) is None
            assert tp.partition_merge_geometry(K, None, 128, nk, nv) is None
            assert tp.partition_merge_geometry(K, q, K, nk, nv) is None
            for run in (1 << lr for lr in range(7, K.bit_length() - 1)):
                geo = tp.partition_merge_geometry(K, q, run, nk, nv)
                if geo is None:
                    continue
                assert geo.run == min(run, q & -q) >= 128
                assert K // geo.run <= tb.MERGE_MAX_RUNS
                assert geo.slots == tb.MERGE_SLOTS[nk]
                assert geo.threads == -(-K // (32 * geo.slots)) * 32 <= 768
                assert geo.smem_bytes + tp.K1_STATIC_SMEM <= tp.SMEM_MAX


def test_partition_merge_limits_match_csrc():
    """The Python limits are the C side's: the static shared memory as
    ``csrc/partition.cu`` states it, and the merge geometry's check shared
    with K2 (``csrc/merge_runs.cuh: merge_geometry_ok``), which both entry
    points call, K1's with its static arrays."""
    part = (CSRC / "partition.cu").read_text()
    runs = (CSRC / "merge_runs.cuh").read_text()
    leaf = (CSRC / "bitonic.cu").read_text()
    static = int(re.search(r"constexpr int kStaticSmem = (\d+);",
                           part).group(1))
    assert static == tp.K1_STATIC_SMEM
    radix = int(re.search(r"constexpr int kMaxRadix = (\d+);",
                          part).group(1))
    assert radix == tp.MAX_RADIX
    assert "inline bool merge_geometry_ok(" in runs
    assert re.search(r"merge_geometry_ok\([^;]*kStaticSmem\)", part)
    assert re.search(r"merge_geometry_ok\([^;]*, 0\)", leaf)
    # one merge body: K1's and K2's both run merge_tile
    assert "merge_tile<E, NK, IDX>(" in part
    assert "merge_tile<E, NK, IDX>(" in runs
