"""K1's and K1b's runs body on the CPU: the wrappers' choice of body for a
pass whose tile does not arrive as sorted runs, and its limits against
``csrc/partition.cu``.

The choice, :func:`tpusort_torch.kernels.partition.partition_runs_geometry`,
is a pure function of the call's shape (K, sorted_run, key planes, payload
words): the runs body (``csrc/partition.cu: sort_runs``: each warp's slots
sorted in registers and on shuffles, then merged by ``csrc/merge_runs.cuh``)
wherever no sorted run arrives and the tile fits it; the merge body where
a later pass's runs arrive sorted; the network for the emit-only mode and
three planes.  The card holds the body to plain bit for bit
(``tests/test_torch_cuda.py``: ``test_partition_runs_body``).
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
N28, N27 = 1 << 28, 1 << 27


def _body(K, q, run, nk, nv):
    """The body a K1 or K1b launch of this shape takes, as the wrappers
    choose it: "runs", "merge" or "network"."""
    if tp.partition_runs_geometry(K, run, nk, nv) is not None:
        return "runs"
    if tp.partition_merge_geometry(K, q, run, nk, nv) is not None:
        return "merge"
    return "network"


@pytest.mark.parametrize("K,q,run,nk,nv,want", [
    # pass 0 at 2^28 and 2^27 (no counts table): keys sort 32 slots a
    # thread; key + value, two planes (u64 keys) and two planes + value 16
    (16384, None, None, 1, 0, (1024, 512, 32)),
    (16384, None, None, 1, 1, (512, 1024, 16)),
    (16384, None, None, 2, 0, (512, 1024, 16)),
    (16384, None, None, 2, 1, (512, 1024, 16)),
    # the skew tier's strided feed (q_in 128, no sorted run)
    (16384, 128, None, 1, 0, (1024, 512, 32)),
    (16384, 128, 0, 2, 1, (512, 1024, 16)),
    # more payload words ride the same geometry
    (16384, None, None, 1, 8, (512, 1024, 16)),
    # small tiles: fewer threads; a tile of one warp run
    (2048, None, None, 1, 0, (1024, 64, 32)),
    (1024, None, None, 1, 0, (1024, 32, 32)),
    (512, None, None, 2, 1, (512, 32, 16)),
    # no runs body: a sorted run arrives (merge or emit-only), three
    # planes, a tile past 16,384 slots, a tile shorter than a warp's run
    (16384, 256, 256, 1, 0, None),
    (16384, 16384, 16384, 1, 0, None),
    (16384, None, None, 3, 0, None),
    (16384, None, None, 3, 1, None),
    (32768, None, None, 1, 0, None),
    (32768, None, None, 2, 1, None),
    (512, None, None, 1, 0, None),
    (256, None, None, 1, 1, None),
])
def test_partition_runs_body_choice(K, q, run, nk, nv, want):
    """The runs body's geometry, from the call's shape alone."""
    geo = tp.partition_runs_geometry(K, run, nk, nv)
    got = None if geo is None else (geo.run, geo.threads, geo.slots)
    assert got == want
    assert tp.partition_runs_geometry.__wrapped__(K, run, nk, nv) == geo
    if geo is not None:
        assert geo.smem_bytes == tb.merge_smem_bytes(K, nk, nv > 0,
                                                     K // geo.run)
        assert geo.smem_bytes + tp.K1_STATIC_SMEM <= tp.SMEM_MAX


def _plans():
    """(route, key planes, payload words, the first pass's q, plan) of the
    benchmark's K1 and K1b calls: the radix tier's 2^28 keys and stable
    pairs, its 2^27 u64 keys, and the skew tier's 2^28 keys and composite
    + value."""
    out = []
    for bits, pairs, n in ((32, False, N28), (32, True, N28),
                           (64, False, N27)):
        kw = get_config(bits, pairs, "cuda").plan_kwargs()
        kw.pop("min_n", None)
        out.append((f"radix {bits}-bit {'pairs' if pairs else 'keys'}",
                    bits // 32, int(pairs), None,
                    tm.plan_msd(n, 0, bits, **kw)))
    for pairs, nk in ((False, 1), (True, 2)):
        kw, _, _, m, lmax = teq._prepare(
            N28, get_config(32, pairs, "cuda").plan_kwargs())
        plan = teq._widen_last(tm.plan_msd(N28, 0, 32 * nk, **kw), N28, m,
                               lmax)
        out.append((f"skew {'pairs' if pairs else 'keys'}", nk, int(pairs),
                    128, plan))
    return out


@pytest.mark.parametrize("route,nk,nv,q0,plan", _plans(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_partition_bodies_on_the_plans(route, nk, nv, q0, plan):
    """Each K1 and K1b route of the benchmark's cells takes the runs body
    at pass 0 and the merge body at passes 1 and 2 (the engines hand K1
    the last pass's run, s & -s, and its counts table's q)."""
    assert len(plan.passes) == 3
    q, prev, bodies = q0, None, []
    for spec in plan.passes:
        bodies.append(_body(spec.k, q, None if prev is None else prev & -prev,
                            nk, nv))
        q, prev = spec.s & -spec.s, spec.s
    assert bodies == ["runs", "merge", "merge"], route


@pytest.mark.parametrize("K,q,run,nk,nv,want", [
    (16384, None, None, 1, 0, "runs"),
    (16384, 128, None, 2, 1, "runs"),
    (16384, 512, 512, 2, 1, "merge"),
    (16384, 16384, 16384, 1, 1, "network"),     # emit-only
    (16384, None, None, 3, 1, "network"),       # three planes + value
    (16384, None, 256, 1, 0, "network"),        # sorted runs, no counts
])
def test_partition_body_of_a_shape(K, q, run, nk, nv, want):
    """One body a shape: the runs body where no sorted run arrives, the
    merge body where runs arrive under a counts table, else the network."""
    assert _body(K, q, run, nk, nv) == want
    runs, merge, geo = tp._bodies(K, q, run, nk, nv)
    assert (runs is not None, merge is not None) == (want == "runs",
                                                     want == "merge")
    assert geo == (runs or merge or tb.tile_sort_geometry(K, nk, nv))


@pytest.mark.parametrize("nk", [1, 2, 3])
@pytest.mark.parametrize("nv", [0, 1, 2, 8])
def test_partition_runs_geometry_holds(nk, nv):
    """Every runs geometry the choice gives is one the C entry point takes
    (``runs_geometry_ok``): one or two planes, 32 slots a thread where a
    slot is one register word, else 16, warp runs of 32 of them, K /
    slots threads from a warp up, K at most 16,384, at most 256 runs, and
    the buffer beside K1's static arrays within a CTA; a sorted run never
    takes it."""
    for K in (1 << lk for lk in range(7, 16)):
        assert tp.partition_runs_geometry(K, 128, nk, nv) is None
        assert tp.partition_runs_geometry(K, K, nk, nv) is None
        geo = tp.partition_runs_geometry(K, None, nk, nv)
        slots = 32 if nk + (1 if nv else 0) == 1 else 16
        fits = nk <= 2 and 32 * slots <= K <= tp.RUNS_MAX_TILE
        assert (geo is not None) == fits, K
        if geo is None:
            continue
        assert geo.slots == slots
        assert geo.run == 32 * geo.slots and K % geo.run == 0
        assert K // geo.run <= tb.MERGE_MAX_RUNS
        assert geo.threads * geo.slots == K and geo.threads % 32 == 0
        assert geo.threads <= (512 if slots == 32 else 1024)
        assert geo.smem_bytes + tp.K1_STATIC_SMEM <= tp.SMEM_MAX
        assert tp.partition_runs_geometry(K, 0, nk, nv) == geo


def test_partition_runs_limits_match_csrc():
    """The Python limits are the C side's: the runs body's largest tile,
    its slots a thread, the check the entry points make, and one body
    each: the runs body sorts with ``reg_sort.cuh``'s warp tier, then
    runs ``merge_runs.cuh``'s chain and levels, and both it and the merge
    body end in the same steps 3-4."""
    part = (CSRC / "partition.cu").read_text()
    reg = (CSRC / "reg_sort.cuh").read_text()
    # the tile and the slots, shared with the packed leaf's runs body
    merge = (CSRC / "merge_runs.cuh").read_text()
    tile = int(re.search(r"constexpr int kRunsMaxTile = (\d+);",
                         merge).group(1))
    assert tile == tp.RUNS_MAX_TILE
    assert re.search(r"return nk \+ \(idx \? 1 : 0\) == 1 \? 32 : 16;",
                     merge)
    assert "inline bool runs_geometry_ok(" in part
    assert re.search(r"n_planes > 2", part)
    assert re.search(r"K / warp_run > kMergeMaxRuns", part)
    assert re.search(r"threads \* slots != K", part)
    assert "__device__ __forceinline__ void warp_sort(" in reg
    body = part[part.index("__device__ __noinline__ int sort_runs("):]
    body = body[:body.index("\n}\n")]
    assert "warp_sort<E>(" in body and "reg_block_sort" not in body
    kernel = part[part.index("partition_raw_kernel(Planes"):]
    assert "m = merge_levels<E>(m, chain_runs(m, runs, nv), nv, K);" in kernel
    assert part.count("partition_sorted<") == 1
    # the MERGE flag stays the kernel's last template argument, so the
    # runs body's launches (RUNS true, MERGE false) never read as merges
    assert re.search(r"template <int NK, bool IDX, bool SPL, int E, bool "
                     r"RUNS, bool MERGE>\n__global__", part)
