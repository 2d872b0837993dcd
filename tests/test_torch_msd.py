"""The port's MSD engine against ``tpusort.ops.msd``: the same plans, and
the same passes, counts chain and leaf output on one small slice run in
Pallas interpret mode.  Inputs are numpy arrays from a seed; keys compare
bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusort.kernels.bitonic import sort_tiles_counts_collapsed as j_leaf
from tpusort.ops import msd as jm
from tpusort_torch.configs import SortConfig
from tpusort_torch.kernels.bitonic import sort_tiles_counts_collapsed
from tpusort_torch.ops import msd as tm
from tpusort_torch.ops.reference import sort_twiddled_reference
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
    assert tm.leaf_tiles(plan) == (16384, 24576)


@pytest.fixture(scope="module")
def small_slice():
    """The keys-only slice at n=6000 under SMALL (2 passes, one 24,576-key
    leaf tile pair), through both packages."""
    n = 6000
    x = random_keys(np.random.default_rng(21), n)
    plan = jm.plan_msd(n, 0, 32, **SMALL)
    ops = [jnp.pad(jnp.asarray(x), (0, plan.m1 - n))]
    (jdata,), (jct, jq), jovf = jm._run_passes_pallas(ops, 1, n, plan)
    tplan = tm.plan_msd(n, 0, 32, **SMALL)
    keys = torch.nn.functional.pad(torch.from_numpy(x.view(np.int32)),
                                   (0, plan.m1 - n))
    tdata, (tct, tq), tovf = tm.run_passes(keys, n, tplan)
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
    assert s["leaf"] == (2, 24576)
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
    (out,) = tm.sort_twiddled_msd(
        (torch.from_numpy(x.view(np.int32)),), begin_bit=0, end_bit=32,
        total_bits=32, config=config)
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


def test_plan_is_planned_once_per_size():
    cfg = SortConfig(tile_elems=2048, radix=16, s1=256, min_n=4096)
    x = random_keys(np.random.default_rng(4), 7000)
    want = tm.plan_msd(7000, 0, 32, k=2048, r=16, s1=256)
    np.testing.assert_array_equal(_twiddled_sort(x, cfg), np.sort(x))
    hits = tm._plan_cached.cache_info().hits
    np.testing.assert_array_equal(_twiddled_sort(x, cfg), np.sort(x))
    assert tm._plan_cached.cache_info().hits == hits + 1
    assert tm._plan_cached(7000, (("k", 2048), ("r", 16), ("s1", 256))) == want


def test_reference_route_below_min_n():
    x = random_keys(np.random.default_rng(5), 3000)
    tm.reset_counters()
    got = _twiddled_sort(x, SortConfig(tile_elems=2048, radix=16, s1=256,
                                       min_n=4096))
    np.testing.assert_array_equal(got, np.sort(x))
    assert tm.counters() == dict(k1_launches=0, k2_launches=0,
                                 reference_routes=1, overflow_fallbacks=0)


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
