"""The port's MSD engine against ``tpusort.ops.msd``: the same plans, and
the same passes, counts chain and leaf output on one small keys-only slice
and one stable-pairs slice run in Pallas interpret mode.  Inputs
are numpy arrays from a seed; keys compare bit for bit, and stable payloads
exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusort.kernels.bitonic import sort_tiles_counts_collapsed as j_leaf
from tpusort.ops import msd as jm
from tpusort_torch.configs import SortConfig
from tpusort_torch.kernels import _build
from tpusort_torch.kernels.bitonic import sort_tiles_counts_collapsed
from tpusort_torch.ops import msd as tm
from tpusort_torch.ops.reference import sort_twiddled_reference
from tpusort_torch.ops.tiers import first_clear
from tpusort_torch.utils.datagen import entropy_keys, random_keys

CPU_ROW = dict(k=2048, r=16, s1=256)
CUDA_ROW = dict(k=16384, r=32)
SMALL = dict(k=2048, r=8, s1=384, s=256, leaf_max=2048)


@pytest.mark.parametrize("geometry,n", [
    (CPU_ROW, 4096), (CPU_ROW, 6000), (CPU_ROW, 100_000), (CPU_ROW, 300_000),
    (CPU_ROW, 655_360), (SMALL, 6000), (SMALL, 50_000),
    (CUDA_ROW, 1 << 16), (CUDA_ROW, (1 << 20) + 7), (CUDA_ROW, 1 << 24),
    (CUDA_ROW, 1 << 26), (CUDA_ROW, 1 << 28), (CUDA_ROW, (1 << 28) - 12345),
])
@pytest.mark.parametrize("leaf_profile", ["raw", "packed"])
def test_plan_matches_jax(geometry, n, leaf_profile):
    want = jm.plan_msd(n, 0, 32, leaf_profile=leaf_profile, **geometry)
    got = tm.plan_msd(n, 0, 32, leaf_profile=leaf_profile, **geometry)
    assert (got is None) == (want is None)
    if want is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_cuda_plan_at_2_28():
    plan = tm.plan_msd(1 << 28, 0, 32, **CUDA_ROW)
    assert [(p.k, p.s) for p in plan.passes] == [
        (16384, 768), (16384, 512), (16384, 512)]
    assert plan.seg == 12288
    # K2 merges each segment from the last pass's runs (its merge body),
    # one segment a tile, with or without payloads and planes
    for nplanes in (1, 2, 3):
        for has_values in (False, True):
            assert tm.leaf_tiles(plan, nplanes, has_values) == (32768, 12288)
    # without the merge body (no sorted runs of 128 slots or more) the
    # network packs two segments of one plane into 32,768 slots, a 2-byte
    # index too, and keeps one a tile with two or three planes
    flat = dataclasses.replace(plan, passes=plan.passes[:-1] + (
        dataclasses.replace(plan.passes[-1], s=64 * 3),))
    assert tm.leaf_tiles(flat) == (16384, 24576)
    assert tm.leaf_tiles(flat, 1, True) == (16384, 24576)
    for nplanes in (2, 3):
        assert tm.leaf_tiles(flat, nplanes, False) == (32768, 12288)


@pytest.mark.parametrize("end_bit", [64, 96])
@pytest.mark.parametrize("n", [1 << 16, (1 << 20) + 7, 1 << 24, 1 << 27,
                               1 << 28])
def test_multi_plane_cuda_plans(n, end_bit):
    """The multi-plane CUDA rows (leaf_max 16384) plan at these sizes, and
    every leaf tile fits K2 with two or three key planes and payloads."""
    plan = tm.plan_msd(n, 0, end_bit, leaf_max=16384, **CUDA_ROW)
    assert plan is not None and plan.seg <= 16384
    _, tile = tm.leaf_tiles(plan, end_bit // 32, True)
    assert tile <= 16384


@pytest.fixture(scope="module")
def small_slice():
    """The keys-only slice at n=6000 under SMALL (2 passes, 64 final
    segments of 768 keys, one a leaf tile: K2 merges each from its runs),
    through both packages."""
    n = 6000
    x = random_keys(np.random.default_rng(21), n)
    plan = jm.plan_msd(n, 0, 32, **SMALL)
    ops = [jnp.pad(jnp.asarray(x), (0, plan.m1 - n))]
    (jdata,), (jct, jq), jovf = jm._run_passes_pallas(ops, 1, n, plan)
    tplan = tm.plan_msd(n, 0, 32, **SMALL)
    keys = torch.nn.functional.pad(torch.from_numpy(x.view(np.int32)),
                                   (0, plan.m1 - n))
    (tdata,), (tct, tq), tovf = tm.run_passes([keys], 1, n, tplan)
    nt, tile = tm.leaf_tiles(tplan)
    run = plan.passes[-1].s & -plan.passes[-1].s
    jout = j_leaf(jdata.reshape(nt, tile), jct.reshape(nt, tile // jq), jq,
                  n, sorted_run=run, interpret=True)
    tout = sort_tiles_counts_collapsed(
        tdata.reshape(nt, tile), tct.reshape(nt, tile // tq), tq, n,
        sorted_run=run)
    return dict(x=x, plan=plan, jdata=np.asarray(jdata), jct=np.asarray(jct),
                jq=jq, jovf=bool(jovf), jout=np.asarray(jout),
                tdata=tdata.numpy().view(np.uint32), tct=tct.numpy(), tq=tq,
                tovf=bool(tovf), tout=tout.numpy().view(np.uint32),
                leaf=(nt, tile))


def test_run_passes_counts_chain(small_slice):
    s = small_slice
    assert len(s["plan"].passes) == 2
    assert s["leaf"] == (64, 768)
    assert s["tq"] == s["jq"]
    assert s["tovf"] == s["jovf"] is False
    np.testing.assert_array_equal(s["tct"], s["jct"])
    assert int(s["tct"].sum()) == 6000


def test_run_passes_valid_slots(small_slice):
    s = small_slice
    q = s["tq"]
    valid = (np.arange(q)[None, :] < s["jct"].reshape(-1, 1)).reshape(-1)
    np.testing.assert_array_equal(s["tdata"][valid], s["jdata"][valid])


def test_slice_leaf_output(small_slice):
    s = small_slice
    np.testing.assert_array_equal(s["tout"], s["jout"])
    np.testing.assert_array_equal(s["tout"], np.sort(s["x"]))


def _twiddled_sort(x: np.ndarray, config: SortConfig) -> np.ndarray:
    """The engine, then the exact sort where its flag is set."""
    planes = (torch.from_numpy(x.view(np.int32)),)
    bits = dict(begin_bit=0, end_bit=32, total_bits=32)
    (out,), _ = first_clear(
        [lambda: tm.sort_twiddled_msd(planes, config=config, **bits),
         lambda: (*sort_twiddled_reference(planes, (), **bits), None)],
        "msd_flag")
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("level", [1, 2, 4, 8, 0])
def test_engine_matches_jax_engine(level):
    """Twiddled uint32 planes through both engines (the JAX one on its XLA
    path, flag mode) at a size that plans 2 passes under the CPU row: the
    same overflow decision, and the same keys where it did not overflow."""
    n = 300_000
    x = entropy_keys(np.random.default_rng(100 + level), n, level)
    assert len(tm.plan_msd(n, 0, 32, **CPU_ROW).passes) == 2
    (want,), _, overflow = jm.sort_twiddled_msd(
        (jnp.asarray(x),), (), begin_bit=0, end_bit=32, total_bits=32,
        use_pallas=False, plan_kwargs=dict(CPU_ROW, min_n=4096),
        on_overflow="flag")
    tm.reset_counters()
    got = _twiddled_sort(x, SortConfig(tile_elems=2048, radix=16, s1=256,
                                       min_n=4096))
    np.testing.assert_array_equal(got, np.sort(x))
    routes = tm.counters()
    assert routes["reference_routes"] == 0
    assert routes["overflow_fallbacks"] == int(bool(overflow))
    if not overflow:
        np.testing.assert_array_equal(got, np.asarray(want))
    if level in (0, 1):
        assert bool(overflow) == (level == 0)


@pytest.mark.parametrize("level", [1, 8, 0])
def test_flag_mode_matches_jax(level):
    """The engine returns the overflow flag on the device with no
    fallback taken (its caller's chain reads it): the same flag as JAX's
    flag mode, and the same keys where it is clear."""
    n = 300_000
    x = entropy_keys(np.random.default_rng(200 + level), n, level)
    (want,), _, jovf = jm.sort_twiddled_msd(
        (jnp.asarray(x),), (), begin_bit=0, end_bit=32, total_bits=32,
        use_pallas=False, plan_kwargs=dict(CPU_ROW, min_n=4096),
        on_overflow="flag")
    tm.reset_counters()
    (got,), vals, ovf = tm.sort_twiddled_msd(
        (torch.from_numpy(x.view(np.int32)),), begin_bit=0, end_bit=32,
        total_bits=32,
        config=SortConfig(tile_elems=2048, radix=16, s1=256, min_n=4096))
    assert vals == () and ovf.dtype == torch.bool and ovf.dim() == 0
    assert bool(ovf) == bool(jovf)
    if level in (0, 1):
        assert bool(ovf) == (level == 0)
    assert tm.counters()["overflow_fallbacks"] == 0
    if not bool(ovf):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))


def test_plan_is_planned_once_per_size():
    cfg = SortConfig(tile_elems=2048, radix=16, s1=256, min_n=4096)
    x = random_keys(np.random.default_rng(4), 7000)
    want = tm.plan_msd(7000, 0, 32, k=2048, r=16, s1=256)
    np.testing.assert_array_equal(_twiddled_sort(x, cfg), np.sort(x))
    hits = tm._plan_cached.cache_info().hits
    np.testing.assert_array_equal(_twiddled_sort(x, cfg), np.sort(x))
    assert tm._plan_cached.cache_info().hits == hits + 1
    kw = (("k", 2048), ("r", 16), ("s1", 256))
    assert tm._plan_cached(7000, 0, 32, "raw", kw) == want
    # the bit range and the leaf profile key the cache too
    assert tm._plan_cached(7000, 8, 32, "raw", kw) == \
        tm.plan_msd(7000, 8, 32, k=2048, r=16, s1=256)
    assert tm._plan_cached(7000, 0, 32, "packed", kw) == \
        tm.plan_msd(7000, 0, 32, k=2048, r=16, s1=256, leaf_profile="packed")


def test_reference_route_below_min_n():
    """Below min_n and above the single-tile threshold (the CPU row's
    2048): the reference sort, counted as such."""
    x = random_keys(np.random.default_rng(5), 3000)
    tm.reset_counters()
    got = _twiddled_sort(x, SortConfig(tile_elems=2048, radix=16, s1=256,
                                       min_n=4096, small_n_threshold=2048))
    np.testing.assert_array_equal(got, np.sort(x))
    assert tm.counters() == dict(k1_launches=0, k1b_launches=0,
                                 k1c_launches=0, k2_launches=0,
                                 k3_launches=0, k4_launches=0,
                                 k5_launches=0, k6_launches=0,
                                 k9_launches=0, k10_launches=0,
                                 k7_launches=0, k8_launches=0,
                                 reference_routes=1, overflow_fallbacks=0,
                                 radix_tiers=0, equidepth_runs=0,
                                 sample_fallbacks=0, identity_routes=0,
                                 exchange_fallbacks=0, host_reads=0,
                                 split_join_bytes=0, merge_bytes=0)


def test_mode_counters():
    """A CPU sort counts no launch; a launch counts on its kernel's total
    and on its (planes, payload words) mode, and reset clears both."""
    x = random_keys(np.random.default_rng(6), 7000)
    tm.reset_counters()
    _twiddled_sort(x, SortConfig(tile_elems=2048, radix=16, s1=256,
                                 min_n=4096))
    assert tm.mode_counters() == {}
    _build.count_launch(tm.sort_tiles, 1, 2)
    _build.count_launch(tm.partition_pass_fused, 2, 0)
    _build.count_launch(tm.partition_pass_fused, 2, 0)
    _build.count_launch(tm._partition_pass_general_cuda, 1, 1)
    _build.count_launch(tm.collapse_segments, 0, 2)
    assert tm.mode_counters() == {("K1", 2, 0): 2, ("K3", 1, 2): 1,
                                  ("K1c", 1, 1): 1, ("K4", 0, 2): 1}
    assert tm.counters()["k1_launches"] == 2
    assert tm.counters()["k1c_launches"] == 1
    assert tm.counters()["k3_launches"] == 1
    assert tm.counters()["k4_launches"] == 1
    tm.reset_counters()
    assert tm.mode_counters() == {} and tm.counters()["k1_launches"] == 0


@pytest.mark.parametrize("n,nv,stable,k3", [
    (3000, 0, True, True),      # keys: one tile (padded to 3072)
    (2944, 1, False, True),     # unstable pairs, n a multiple of 128
    (3000, 1, False, False),    # unstable pairs needing pad slots
    (2944, 1, True, False),     # stable pairs never take the tile
])
def test_single_tile_route_below_min_n(n, nv, stable, k3):
    """Below min_n and within the default threshold (2^14), the engine
    routes to the single-tile path where ``ops/small.py`` takes it; K3 runs
    its plain version here, so only the reference route is counted."""
    rng = np.random.default_rng(n + nv)
    x = random_keys(rng, n)
    vals = [torch.from_numpy(np.arange(n, dtype=np.int32))] * nv
    tm.reset_counters()
    (got,), gv, ovf = tm.sort_twiddled_msd(
        (torch.from_numpy(x.view(np.int32)),), vals, begin_bit=0, end_bit=32,
        total_bits=32, stable=stable,
        config=SortConfig(tile_elems=2048, radix=16, s1=256, min_n=4096))
    assert ovf is None                   # exact: nothing to read
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.sort(x))
    if nv:
        np.testing.assert_array_equal(x[gv[0].numpy()], np.sort(x))
    assert tm.counters()["reference_routes"] == int(not k3)


def test_composite_pairs_slice_matches_pallas():
    """Stable 32-bit pairs at n = 6000 under SMALL through K1 and K2 in
    both packages (JAX in Pallas interpret mode, flag mode, on the
    composite (key, position) planes; the port on the key plane alone,
    its ties kept in slot order), keys and values exact."""
    n = 6000
    rng = np.random.default_rng(31)
    # 2048 distinct keys spread over the top bits, each ~3 times: ties
    x = (rng.integers(0, 2048, n) << 21).astype(np.uint32)
    v = rng.integers(0, 2**32, n, dtype=np.uint32)
    (jk,), (jv,), jovf = jm.sort_twiddled_msd(
        (jnp.asarray(x),), (jnp.asarray(v),), begin_bit=0, end_bit=32,
        total_bits=32, use_pallas=True, plan_kwargs=dict(SMALL, min_n=4096),
        on_overflow="flag")
    assert not bool(jovf)
    cfg = SortConfig(tile_elems=2048, radix=8, s1=384, leaf_max=2048,
                     min_n=4096)
    tm.reset_counters()
    (tk,), (tv,), ovf = tm.sort_twiddled_msd(
        (torch.from_numpy(x.view(np.int32)),),
        (torch.from_numpy(v.view(np.int32)),), begin_bit=0, end_bit=32,
        total_bits=32, config=cfg)
    assert not bool(ovf) and tm.counters()["overflow_fallbacks"] == 0
    np.testing.assert_array_equal(tk.numpy().view(np.uint32), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32), np.asarray(jv))
    perm = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(np.asarray(jv), v[perm])


def test_reference_is_stable_and_masks_bits():
    """The oracle: stable by the masked bits, planes and values carried."""
    rng = np.random.default_rng(8)
    hi = rng.integers(0, 4, 500).astype(np.uint32)
    lo = rng.integers(0, 2**32, 500, dtype=np.uint32)
    val = np.arange(500, dtype=np.int32)
    (shi, slo), (sval,) = sort_twiddled_reference(
        (torch.from_numpy(hi.view(np.int32)),
         torch.from_numpy(lo.view(np.int32))),
        (torch.from_numpy(val),), begin_bit=16, end_bit=40, total_bits=64)
    key = ((hi.astype(np.uint64) << np.uint64(32)) | lo) & np.uint64(
        ((1 << 40) - 1) & ~((1 << 16) - 1))
    perm = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(sval.numpy(), val[perm])
    np.testing.assert_array_equal(shi.numpy().view(np.uint32), hi[perm])
    np.testing.assert_array_equal(slo.numpy().view(np.uint32), lo[perm])
