"""Key-value sorts, ``argsort``, ``sort_planes`` and 64-bit keys of the port
on CPU tensors, against ``tests/oracle.py`` over the entropy ladder
{1..11, 0} and against the JAX engine (``tpusort.ops.msd`` on its XLA
path, flag mode) on a few rungs.

The size plans 2 passes under the CPU row for 32-, 64- and 96-bit keys.
Keys compare bit for bit; stable payloads exactly; unstable payloads as a
permutation within each run of equal keys (the reference's own rule,
``tpusort/parallel/global_sort.py:41-43``).  Inputs are numpy arrays from a
seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusort_torch
from oracle import np_sort_oracle
from tpusort.ops import msd as jm
from tpusort_torch.ops import msd as tm
from tpusort_torch.utils.datagen import (entropy_keys, enumerated_values,
                                         random_keys)

N = 300_000
LEVELS = list(range(1, 12)) + [0]
CPU_PLAN = dict(k=2048, r=16, s1=256, min_n=4096)
# the registered engine: radix, then the exact sort where its flag is set
MSD = tpusort_torch.api._ENGINES["msd"]


def _keys(level, dtype, salt=0):
    rng = np.random.default_rng(1000 * level + np.dtype(dtype).num + salt)
    if level == 1:
        return random_keys(rng, N, dtype)
    return entropy_keys(rng, N, level, dtype)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint64 if a.dtype.itemsize == 8 else np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_unstable_pairs(keys_in, keys_out, vals_out):
    """keys exact; the values (an enumeration) a permutation that maps
    every output slot to an input key equal to the output key there."""
    np.testing.assert_array_equal(_bits(keys_out),
                                  _bits(np_sort_oracle(keys_in)))
    np.testing.assert_array_equal(np.sort(vals_out), np.arange(len(keys_in)))
    np.testing.assert_array_equal(_bits(keys_in[vals_out]), _bits(keys_out))


def test_plans_two_passes():
    for bits in (32, 64, 96):
        assert len(tm.plan_msd(N, 0, bits, k=2048, r=16, s1=256).passes) == 2


@pytest.mark.parametrize("level", LEVELS)
def test_sort_pairs_entropy_ladder(level):
    """Stable pairs (the raw key plane, ties in slot order), ascending and
    descending, and unstable pairs (raw key + payload), uint32 keys."""
    x = _keys(level, np.uint32)
    v = enumerated_values(N)
    for descending in (False, True):
        ko, vo = tpusort_torch.sort_pairs(_t(x), _t(v), descending=descending)
        wk, wv = np_sort_oracle(x, v, descending=descending)
        np.testing.assert_array_equal(_bits(ko.numpy()), _bits(wk))
        np.testing.assert_array_equal(vo.numpy(), wv)
    ko, vo = tpusort_torch.unstable_sort_pairs(_t(x), _t(v))
    _assert_unstable_pairs(x, ko.numpy(), vo.numpy())


@pytest.mark.parametrize("level", LEVELS)
def test_argsort_entropy_ladder(level):
    """argsort: the (twiddled key, index) planes, keys only."""
    for dtype, descending in ((np.uint32, False), (np.float32, True),
                              (np.int32, False)):
        x = _keys(level, dtype)
        got = tpusort_torch.argsort(_t(x), descending=descending)
        assert got.dtype == torch.int64
        t = np.arange(N, dtype=np.int64)
        _, want = np_sort_oracle(x, t, descending=descending)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("dtype", [np.uint64, np.int64, np.float64])
def test_sort64_entropy_ladder(level, dtype):
    """64-bit keys as two planes, ascending and descending."""
    x = _keys(level, dtype)
    for descending in (False, True):
        got = tpusort_torch.sort(_t(x), descending=descending)
        assert got.dtype == _t(x).dtype
        np.testing.assert_array_equal(
            _bits(got.numpy()), _bits(np_sort_oracle(x, descending=descending)))


@pytest.mark.parametrize("level", [1, 3, 6, 0])
def test_sort64_pairs(level):
    """int64 keys with int64 values, unstable (2 key planes + 2 words),
    and uint32 keys with float64 values, stable (key + 2 words)."""
    x = _keys(level, np.int64)
    v = enumerated_values(N, np.int64)
    ko, vo = tpusort_torch.unstable_sort_pairs(_t(x), _t(v))
    assert vo.dtype == torch.int64
    _assert_unstable_pairs(x, ko.numpy(), vo.numpy())
    k32 = _keys(level, np.uint32, salt=5)
    f = np.random.default_rng(level).standard_normal(N)
    ko, vo = tpusort_torch.sort_pairs(_t(k32), _t(f))
    wk, wv = np_sort_oracle(k32, f)
    np.testing.assert_array_equal(ko.numpy(), wk)
    np.testing.assert_array_equal(_bits(vo.numpy()), _bits(wv))


def test_sort_planes_and_tuple_values():
    """sort_planes on (hi, lo) words equals sort on the 64-bit keys, and
    a tuple of values comes back as a tuple."""
    x = _keys(2, np.uint64)
    words = x.view(np.uint32).reshape(-1, 2)
    hi, lo = _t(words[:, 1]), _t(words[:, 0])
    v1 = enumerated_values(N)
    v2 = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    (shi, slo), (o1, o2) = tpusort_torch.sort_planes(
        (hi, lo), (_t(v1), _t(v2)), key_dtype="uint64", stable=False)
    assert shi.dtype == slo.dtype == torch.uint32
    joined = (shi.numpy().astype(np.uint64) << np.uint64(32)) | slo.numpy()
    np.testing.assert_array_equal(joined, np.sort(x))
    _assert_unstable_pairs(x, joined, o1.numpy())
    np.testing.assert_array_equal(o2.numpy(), v2[o1.numpy()])


@pytest.mark.parametrize("level", [1, 4, 8, 0])
def test_pairs_match_jax_engine(level):
    """Stable and unstable uint32 pairs through both engines (the JAX one
    on its XLA path, flag mode): the same overflow decision, and the same
    keys and stable values."""
    x = _keys(level, np.uint32)
    v = enumerated_values(N)
    for stable in (True, False):
        (wk,), (wv,), overflow = jm.sort_twiddled_msd(
            (jnp.asarray(x),), (jnp.asarray(v),), begin_bit=0, end_bit=32,
            total_bits=32, use_pallas=False, plan_kwargs=CPU_PLAN,
            stable=stable, on_overflow="flag")
        tm.reset_counters()
        (tk,), (tv,) = MSD(
            (_t(x.view(np.int32)),), (_t(v.view(np.int32)),), begin_bit=0,
            end_bit=32, total_bits=32, stable=stable,
            config=tpusort_torch.get_config(32, True, "cpu"))
        c = tm.counters()
        assert c["reference_routes"] == 0
        tk, tv = tk.numpy().view(np.uint32), tv.numpy().view(np.uint32)
        np.testing.assert_array_equal(tk, np.sort(x))
        if not bool(overflow):
            np.testing.assert_array_equal(tk, np.asarray(wk))
            if stable:
                np.testing.assert_array_equal(tv, np.asarray(wv))
            else:
                _assert_unstable_pairs(x, np.asarray(wk), np.asarray(wv))
        _assert_unstable_pairs(x, tk, tv)
        if level == 1:
            assert not bool(overflow) and c["overflow_fallbacks"] == 0
        if level == 0:
            assert bool(overflow) and c["overflow_fallbacks"] == 1


@pytest.mark.parametrize("level", [1, 4, 0])
def test_sort64_matches_jax_engine(level):
    """uint64 keys as (hi, lo) planes through both engines."""
    x = _keys(level, np.uint64)
    words = x.view(np.uint32).reshape(-1, 2)
    hi, lo = np.ascontiguousarray(words[:, 1]), np.ascontiguousarray(words[:, 0])
    (whi, wlo), _, overflow = jm.sort_twiddled_msd(
        (jnp.asarray(hi), jnp.asarray(lo)), (), begin_bit=0, end_bit=64,
        total_bits=64, use_pallas=False, plan_kwargs=CPU_PLAN,
        on_overflow="flag")
    tm.reset_counters()
    (thi, tlo), _ = MSD(
        (_t(hi.view(np.int32)), _t(lo.view(np.int32))), (), begin_bit=0,
        end_bit=64, total_bits=64,
        config=tpusort_torch.get_config(64, False, "cpu"))
    assert tm.counters()["overflow_fallbacks"] == int(bool(overflow))
    got = (thi.numpy().view(np.uint32), tlo.numpy().view(np.uint32))
    joined = (got[0].astype(np.uint64) << np.uint64(32)) | got[1]
    np.testing.assert_array_equal(joined, np.sort(x))
    if not bool(overflow):       # flag mode leaves garbage when it overflows
        np.testing.assert_array_equal(got[0], np.asarray(whi))
        np.testing.assert_array_equal(got[1], np.asarray(wlo))
    if level == 1:
        assert not bool(overflow)


def test_sentinel_keys_take_the_fallback():
    """Pairs whose keys include 0xFFFFFFFF, the invalid slots' key: an
    invalid slot ranks after a valid all-ones key in K1 and K2, so neither
    unstable nor stable pairs take the fallback, and the output is
    exact."""
    x = random_keys(np.random.default_rng(9), N)
    x[1000::20000] = 0xFFFFFFFF          # 15 of them, spread over the tiles
    v = enumerated_values(N)
    tm.reset_counters()
    ko, vo = tpusort_torch.unstable_sort_pairs(_t(x), _t(v))
    assert tm.counters()["overflow_fallbacks"] == 0
    _assert_unstable_pairs(x, ko.numpy(), vo.numpy())
    tm.reset_counters()
    ko, vo = tpusort_torch.sort_pairs(_t(x), _t(v))
    assert tm.counters()["overflow_fallbacks"] == 0
    np.testing.assert_array_equal(ko.numpy(), np.sort(x))
    np.testing.assert_array_equal(vo.numpy(), np.argsort(x, kind="stable"))
