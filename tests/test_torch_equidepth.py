"""The port's equi-depth engine (``tpusort_torch.ops.equidepth``) against
``tpusort.ops.equidepth`` and the numpy oracle.

Against JAX, exactly: the plans after ``_prepare`` and ``_widen_last``, the
quantile tables and the per-pass splitters and tie fractions, and one whole
pipeline run in Pallas interpret mode at the TINY geometry (output and
overflow flag).  Against the oracle, on the port alone (its CPU path runs
the kernels' plain versions): the inputs of JAX's slow equi-depth tests,
the overflow flag staying clear where JAX's no-false-fallback tests say it
must, flag mode, delegation and the all-ones sentinel check for pairs.
Inputs are numpy arrays from a seed; keys compare bit for bit, stable
payloads exactly, unstable payloads as a permutation carried with its key.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import np_sort_oracle
from tpusort.ops import equidepth as je
from tpusort.ops import msd as jm
from tpusort_torch import dtypes as td
from tpusort_torch.configs import get_config
from tpusort_torch.ops import equidepth as te
from tpusort_torch.ops import msd as tm
from tpusort_torch.ops.reference import sort_twiddled_reference
from tpusort_torch.ops.tiers import first_clear
from tpusort_torch.utils.datagen import (
    entropy_keys, enumerated_values, random_keys, zipf_keys)

SMALL = dict(k=2048, r=8, s1=384, s=256, leaf_max=4096, min_n=1,
             sample_log2=15)
TINY = dict(k=1024, r=8, s1=256, s=128, leaf_max=2048, min_n=1,
            sample_log2=13)
CUDA_KEYS = get_config(32, False, "cuda").plan_kwargs()
CUDA_MULTI = get_config(32, True, "cuda").plan_kwargs()


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _plans(pkg_eq, pkg_msd, n, geometry, end_bit):
    kwargs, min_n, sample_log2, m, leaf_max = pkg_eq._prepare(
        n, dict(geometry))
    plan = pkg_msd.plan_msd(n, 0, end_bit, **kwargs)
    widened = None if plan is None else pkg_eq._widen_last(plan, n, m,
                                                           leaf_max)
    return (kwargs, min_n, sample_log2, m, leaf_max), widened


@pytest.mark.parametrize("geometry,end_bit", [
    (SMALL, 32), (TINY, 32), (CUDA_KEYS, 32), (CUDA_MULTI, 64),
    (CUDA_MULTI, 32)])
@pytest.mark.parametrize("log2n", [24, 25, 26, 27, 28, 29, 30])
def test_prepare_and_widen_match_jax(geometry, end_bit, log2n):
    n = 1 << log2n
    got_prep, got = _plans(te, tm, n, geometry, end_bit)
    want_prep, want = _plans(je, jm, n, geometry, end_bit)
    assert got_prep == want_prep
    assert (got is None) == (want is None)
    if want is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("geometry,end_bit,log2n,seg", [
    (CUDA_KEYS, 32, 28, 15360), (CUDA_MULTI, 64, 28, 15360),
    (get_config(64, False, "cuda").plan_kwargs(), 64, 27, 7680)])
def test_cuda_plans(geometry, end_bit, log2n, seg):
    """The ``"cuda"`` rows' equi-depth plans: 3 passes, a 2^22 sample, the
    last run widened 512 -> 640, and a leaf segment K2 holds."""
    (_, _, _, m, _), plan = _plans(te, tm, 1 << log2n, geometry, end_bit)
    assert m == 1 << 22
    assert [(p.k, p.s, p.r) for p in plan.passes] == [
        (16384, 768, 32), (16384, 512, 32), (16384, 640, 32)]
    assert plan.seg == seg
    nplanes = end_bit // 32
    _, tile = tm.leaf_tiles(plan, nplanes, geometry is CUDA_MULTI)
    assert tile >= seg


def _inputs(kind: str, n: int):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "uniform":
        return [random_keys(rng, n)]
    if kind.startswith("entropy"):
        return [entropy_keys(rng, n, int(kind[-1]))]
    if kind.startswith("zipf"):
        return [zipf_keys(rng, n, alpha=float(kind[4:]), dtype=np.uint32)]
    if kind == "constant":
        return [np.full(n, 7, np.uint32)]
    if kind == "presorted":
        return [np.sort(random_keys(rng, n))]
    assert kind == "u64"
    return [rng.integers(0, 4, n).astype(np.uint32), random_keys(rng, n)]


@pytest.mark.parametrize("kind", ["uniform", "entropy2", "entropy3",
                                  "zipf1.1", "zipf1.2", "constant",
                                  "presorted", "u64"])
def test_quantile_table_and_splitters_match_jax(kind):
    """Quantile table (q, lo, hi, ranks) and every pass's splitters and
    tie fractions, exactly, for a TINY 3-pass plan (sample below 2^18, so
    JAX sorts it with lax.sort and the port with its reference sort)."""
    n = 20_000
    planes = _inputs(kind, n)
    nq = 8 ** 3 - 1
    jt = je._quantile_table([jnp.asarray(p) for p in planes], n, nq,
                            sample_log2=13)
    tt = te._quantile_table(tuple(_i32(p) for p in planes), n, nq,
                            sample_log2=13)
    assert tt.m == jt.m
    np.testing.assert_array_equal(tt.ranks, jt.ranks)
    for a, b in zip(tt.q, jt.q):
        np.testing.assert_array_equal(_u32(a), np.asarray(b))
    np.testing.assert_array_equal(tt.lo.numpy(), np.asarray(jt.lo))
    np.testing.assert_array_equal(tt.hi.numpy(), np.asarray(jt.hi))
    for j, t_seg in enumerate((5, 3, 2)):
        tspl, tfrac = te._pass_splitters(tt, 3, j, 8, t_seg)
        jspl, jfrac = je._pass_splitters(jt, 3, j, 8, t_seg)
        for a, b in zip(tspl, jspl):
            np.testing.assert_array_equal(_u32(a), np.asarray(b))
        np.testing.assert_array_equal(_u32(tfrac), np.asarray(jfrac))


def _pipeline(pkg, planes, n, geometry):
    prep, plan = _plans(te if pkg == "torch" else je,
                        tm if pkg == "torch" else jm, n, geometry,
                        32 * len(planes))
    nq = plan.passes[0].r ** len(plan.passes) - 1
    if pkg == "torch":
        q = te._quantile_table(planes, n, nq, sample_log2=prep[2])
        return te._run_pipeline(planes, (), n, plan, q)
    q = je._quantile_table(planes, n, nq, sample_log2=prep[2])
    return je._run_pipeline(planes, (), n, plan, q, True)


def test_run_pipeline_matches_jax_tiny():
    """The whole pipeline (strided feed, K1b passes, K2 leaf) at TINY on
    entropy-2 keys: the Pallas kernels in interpret mode and the port's
    plain versions give the same output and overflow flag."""
    n = 20_000
    x = entropy_keys(np.random.default_rng(9), n, 2)
    (tout,), tovf = _pipeline("torch", (_i32(x),), n, TINY)
    (jout,), jovf = _pipeline("jax", (jnp.asarray(x),), n, TINY)
    assert bool(tovf) == bool(jovf)
    np.testing.assert_array_equal(_u32(tout), np.asarray(jout))
    np.testing.assert_array_equal(_u32(tout), np.sort(x))


def _eq_chain(x: np.ndarray, geometry=SMALL, values=(), stable=False):
    """(traits, [the engine, the exact sort]): the engine's attempts."""
    planes, traits = td.twiddle_in(torch.from_numpy(x))
    vals = tuple(_i32(v) for v in values)
    bits = dict(begin_bit=0, end_bit=traits.bits, total_bits=traits.bits)
    return traits, [
        lambda: te.sort_twiddled_equidepth(
            planes, vals, plan_kwargs=dict(geometry), stable=stable, **bits),
        lambda: (*sort_twiddled_reference(planes, vals, **bits), None)]


def _eq_sort(x: np.ndarray, geometry=SMALL, values=(), stable=False):
    """The engine, then the exact sort where its flag is set."""
    traits, chain = _eq_chain(x, geometry, values, stable)
    sp, sv = first_clear(chain, "equidepth_flag")
    return td.twiddle_out(sp, traits), (sv,)


@pytest.mark.parametrize("kind", ["entropy1", "entropy2", "entropy4",
                                  "entropy0", "zipf1.2", "presorted",
                                  "float"])
def test_equidepth_sorts_exactly(kind):
    """JAX's slow equi-depth inputs at n = 60,000 under SMALL."""
    n = 60_000
    if kind == "float":
        x = np.random.default_rng(8).standard_normal(n).astype(
            np.float32) ** 3
    else:
        x = _inputs(kind, n)[0]
    got, _ = _eq_sort(x)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np_sort_oracle(x).view(np.uint32))


@pytest.mark.parametrize("kind", ["entropy1", "entropy2", "entropy0",
                                  "presorted", "zipf1.2"])
def test_no_false_fallback(kind):
    """Where JAX's tests require its pipeline to run clean, the port's
    overflow flag stays clear too (SMALL, n = 60,000)."""
    n = 60_000
    x = _inputs(kind, n)[0]
    _, ovf = _pipeline("torch", (_i32(x),), n, SMALL)
    assert not bool(ovf)


def test_unstable_pairs_zipf():
    n = 20_000
    rng = np.random.default_rng(60)
    x = zipf_keys(rng, n, alpha=1.2, dtype=np.uint32)
    v = enumerated_values(n)
    got, (sv,) = _eq_sort(x, TINY, values=(v,))
    np.testing.assert_array_equal(got.numpy(), np.sort(x))
    perm = sv[0].numpy().view(np.uint32)
    np.testing.assert_array_equal(np.sort(perm), v)
    np.testing.assert_array_equal(x[perm], got.numpy())


def test_u64_planes_skewed_hi():
    n = 20_000
    hi, lo = _inputs("u64", n)
    x = ((hi.astype(np.uint64) << np.uint64(32)) | lo).view(np.uint64)
    got, _ = _eq_sort(x, TINY)
    np.testing.assert_array_equal(got.numpy(), np.sort(x))


def test_stable_pairs_composite():
    """Stable pairs through the composite (key, position) planes: equal
    Zipf keys keep their input order."""
    n = 20_000
    x = zipf_keys(np.random.default_rng(62), n, alpha=1.2, dtype=np.uint32)
    v = enumerated_values(n)
    got, (sv,) = _eq_sort(x, TINY, values=(v,), stable=True)
    wk, wv = np_sort_oracle(x, v)
    np.testing.assert_array_equal(got.numpy(), wk)
    np.testing.assert_array_equal(sv[0].numpy().view(np.uint32), wv)


def test_flag_mode_and_delegation():
    """The engine returns (planes, values, overflow) and takes no
    fallback; a size below min_n and a bit range are delegated to the
    reference sort, whose flag is None."""
    n = 2_000
    x = random_keys(np.random.default_rng(63), n)
    planes = (_i32(x),)
    tm.reset_counters()
    sp, sv, ovf = te.sort_twiddled_equidepth(
        planes, (), begin_bit=0, end_bit=32, total_bits=32,
        plan_kwargs=dict(min_n=1 << 20))
    assert ovf is None and sv == ()
    np.testing.assert_array_equal(_u32(sp[0]), np.sort(x))
    sp, _, ovf = te.sort_twiddled_equidepth(
        planes, (), begin_bit=8, end_bit=32, total_bits=32,
        plan_kwargs=dict(TINY))
    assert ovf is None
    assert tm.counters()["reference_routes"] == 2
    assert tm.counters()["equidepth_runs"] == 0
    sp, _, ovf = te.sort_twiddled_equidepth(
        (_i32(np.tile(x, 10)),), (), begin_bit=0, end_bit=32,
        total_bits=32, plan_kwargs=dict(TINY))
    assert ovf.dtype == torch.bool and ovf.dim() == 0
    assert not bool(ovf) and tm.counters()["equidepth_runs"] == 1
    np.testing.assert_array_equal(_u32(sp[0]), np.sort(np.tile(x, 10)))


def test_sentinel_keys_with_pairs():
    """Pairs ride unstably past the invalid-slot sentinel, so a block of
    valid 0xFFFFFFFF keys raises the flag; the chain's exact sort then
    returns the (stable) reference order."""
    n = 20_000
    rng = np.random.default_rng(64)
    x = random_keys(rng, n)
    x[5000:5200] = 0xFFFFFFFF
    v = enumerated_values(n)
    *_, ovf = _eq_chain(x, TINY, values=(v,))[1][0]()
    assert bool(ovf)
    tm.reset_counters()
    got, (sv,) = _eq_sort(x, TINY, values=(v,))
    assert tm.counters()["overflow_fallbacks"] == 1
    wk, wv = np_sort_oracle(x, v)
    np.testing.assert_array_equal(got.numpy(), wk)
    np.testing.assert_array_equal(sv[0].numpy().view(np.uint32), wv)

