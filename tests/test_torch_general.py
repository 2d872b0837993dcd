"""The port's general (digit, idx) path on CPU tensors: bit-range sorts,
stable pairs of 64-bit keys, sub-range and 64-bit ``argsort`` and
``sort_pairs_lsb_in_value``.

The slice (``ops.msd.sort_twiddled_msd``) is held against
``tpusort.ops.msd.sort_twiddled_msd(use_pallas=True, on_overflow="flag")``
in Pallas interpret mode at a small geometry (K 1024, R 8: n = 3000 plans
one or two passes).  Keys-only bit-range sorts are held against the numpy
oracle and the JAX engine's XLA path instead: the Pallas engine sends them
to its raw-key branch and loses input order within the range (ROADMAP
Queue 3).  The API is held against ``tests/oracle.py`` for all six key
dtypes.  Keys and stable payloads compare bit for bit; inputs are numpy
arrays from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusort
import tpusort_torch
from oracle import np_sort_oracle
from tpusort.ops import msd as jm
from tpusort_torch.configs import SortConfig
from tpusort_torch.ops import msd as tm
from tpusort_torch.utils.datagen import entropy_keys, random_keys

# the registered engine: radix, then the exact sort where its flag is set
MSD = tpusort_torch.api._ENGINES["msd"]

N = 3000
G = dict(k=1024, r=8, s1=256, s=128, leaf_max=1024)
G_CFG = SortConfig(tile_elems=1024, radix=8, s1=256, leaf_max=1024,
                   min_n=2048)
DTYPES = [np.uint32, np.int32, np.float32, np.uint64, np.int64, np.float64]


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint64 if a.dtype.itemsize == 8 else np.uint32)


def _jax_engine(planes, values, begin_bit, end_bit, total_bits):
    return jm.sort_twiddled_msd(
        tuple(jnp.asarray(p) for p in planes),
        tuple(jnp.asarray(v) for v in values), begin_bit=begin_bit,
        end_bit=end_bit, total_bits=total_bits, use_pallas=True,
        plan_kwargs=dict(G, min_n=2048), on_overflow="flag", skew_tier=False)


def _port_engine(planes, values, begin_bit, end_bit, total_bits):
    tm.reset_counters()
    sp, sv = MSD(
        tuple(_i32(p) for p in planes), tuple(_i32(v) for v in values),
        begin_bit=begin_bit, end_bit=end_bit, total_bits=total_bits,
        config=G_CFG)
    return [_u32(p) for p in sp], [_u32(v) for v in sv], tm.counters()


def _window_ties(rng, n, begin_bit, end_bit):
    """uint32 keys whose bits [begin_bit, end_bit) take 1000 values spread
    over the range, about 3 keys each, the other bits random: ties in the
    window between different keys."""
    width = end_bit - begin_bit
    window = rng.choice(1 << width, 1000, replace=False).astype(np.uint64)
    w = window[rng.integers(0, 1000, n)] << np.uint64(begin_bit)
    mask = ((1 << width) - 1) << begin_bit
    rest = rng.integers(0, 2**32, n, dtype=np.uint64) & np.uint64(
        0xFFFFFFFF ^ mask)
    return ((w | rest) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


@pytest.mark.parametrize("begin_bit,end_bit", [(8, 24), (0, 24)])
def test_pairs_slice_matches_pallas(begin_bit, end_bit):
    """Stable u32 pairs over a bit range, with a random value and the
    position as payloads: K1c passes and the packed leaf (K3 + K4) against
    the Pallas general path.  The position payload is the sub-range
    argsort, which the API's ``argsort`` must return too."""
    rng = np.random.default_rng(400 + begin_bit)
    key = _window_ties(rng, N, begin_bit, end_bit)
    val = rng.integers(0, 2**32, N, dtype=np.uint32)
    pos = np.arange(N, dtype=np.uint32)
    (jk,), (jv, jpos), jovf = _jax_engine((key,), (val, pos), begin_bit,
                                          end_bit, 32)
    assert not bool(jovf)
    (tk,), (tv, tpos), c = _port_engine((key,), (val, pos), begin_bit,
                                        end_bit, 32)
    assert c["overflow_fallbacks"] == 0 and c["reference_routes"] == 0
    np.testing.assert_array_equal(tk, np.asarray(jk))
    np.testing.assert_array_equal(tv, np.asarray(jv))
    np.testing.assert_array_equal(tpos, np.asarray(jpos))
    want_k, want_pos = np_sort_oracle(key, pos, begin_bit=begin_bit,
                                      end_bit=end_bit)
    np.testing.assert_array_equal(tk, want_k)
    np.testing.assert_array_equal(tpos, want_pos)
    perm = tpusort_torch.argsort(torch.from_numpy(key), begin_bit=begin_bit,
                                 end_bit=end_bit)
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), want_pos)


def test_stable_u64_pairs_slice_matches_pallas():
    """Stable pairs of 64-bit keys with a 64-bit value: the remainder is too
    wide for one packed word, so the leaf is K2 on the masked planes plus
    the segment position, against the Pallas path's multikey leaf."""
    rng = np.random.default_rng(410)
    distinct = rng.integers(0, 2**32, (1000, 2), dtype=np.uint32)
    hi, lo = distinct[rng.integers(0, 1000, N)].T            # equal keys
    vhi, vlo = (rng.integers(0, 2**32, N, dtype=np.uint32) for _ in range(2))
    plan = tm.plan_msd(N, 0, 64, leaf_profile="packed", **G)
    assert plan.rem_width + plan.seg.bit_length() + 1 > 32   # wide leaf
    (jhi, jlo), (jvhi, jvlo), jovf = _jax_engine((hi, lo), (vhi, vlo), 0, 64,
                                                 64)
    assert not bool(jovf)
    (thi, tlo), (tvhi, tvlo), c = _port_engine((hi, lo), (vhi, vlo), 0, 64,
                                               64)
    assert c["overflow_fallbacks"] == 0 and c["reference_routes"] == 0
    for t_, j_ in ((thi, jhi), (tlo, jlo), (tvhi, jvhi), (tvlo, jvlo)):
        np.testing.assert_array_equal(t_, np.asarray(j_))
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo
    perm = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(tvhi, vhi[perm])
    np.testing.assert_array_equal(tvlo, vlo[perm])


def test_constant_keys_take_the_fallback_as_pallas_flags():
    """Entropy 0 over [8, 24): one digit takes every slot, both engines
    raise the overflow flag, and the port's exact fallback is stable."""
    key = np.full(N, 0x12345678, dtype=np.uint32)
    pos = np.arange(N, dtype=np.uint32)
    _, _, jovf = _jax_engine((key,), (pos,), 8, 24, 32)
    assert bool(jovf)
    (tk,), (tpos,), c = _port_engine((key,), (pos,), 8, 24, 32)
    assert c["overflow_fallbacks"] == 1 and c["reference_routes"] == 0
    np.testing.assert_array_equal(tk, key)
    np.testing.assert_array_equal(tpos, pos)


@pytest.mark.parametrize("begin_bit,end_bit", [(8, 32), (0, 24), (8, 24),
                                               (3, 29)])
def test_keys_only_bit_range(begin_bit, end_bit):
    """Keys only over a bit range: against the oracle and the JAX engine's
    XLA path, both stable.  The keys tie in the window, so the order of
    equal-window keys is checked."""
    rng = np.random.default_rng(420 + begin_bit + end_bit)
    key = _window_ties(rng, N, begin_bit, end_bit)
    (tk,), _, c = _port_engine((key,), (), begin_bit, end_bit, 32)
    assert c["overflow_fallbacks"] == 0 and c["reference_routes"] == 0
    np.testing.assert_array_equal(
        tk, np_sort_oracle(key, begin_bit=begin_bit, end_bit=end_bit))
    (jk,), _, jovf = jm.sort_twiddled_msd(
        (jnp.asarray(key),), (), begin_bit=begin_bit, end_bit=end_bit,
        total_bits=32, use_pallas=False, plan_kwargs=dict(G, min_n=2048),
        on_overflow="flag")
    assert not bool(jovf)
    np.testing.assert_array_equal(tk, np.asarray(jk))


def test_keys_only_window_ties_keep_input_order():
    """Pins the reference defect the port does not copy: over [8, 32) a
    raw-key partition would order keys with equal window bits by their low
    byte; the stable sort keeps them in input order."""
    rng = np.random.default_rng(430)
    key = _window_ties(rng, N, 8, 32)
    (tk,), _, _ = _port_engine((key,), (), 8, 32, 32)
    want = key[np.argsort(key >> np.uint32(8), kind="stable")]
    np.testing.assert_array_equal(tk, want)
    assert not np.array_equal(tk, np.sort(key))


@pytest.mark.parametrize("nplanes,begin_bit,end_bit", [
    (1, 8, 24), (1, 0, 31), (1, 1, 32), (2, 0, 40), (2, 16, 64), (2, 33, 47),
    (2, 31, 33), (3, 50, 90),
])
def test_mask_plane_bits_matches_jax(nplanes, begin_bit, end_bit):
    """The reference's range mask, which the wide leaf's key planes use,
    gives ``tpusort.ops.reference._mask_plane_bits``'s words."""
    from tpusort.ops.reference import _mask_plane_bits as jax_mask
    from tpusort_torch.ops.reference import _mask_plane_bits as port_mask
    rng = np.random.default_rng(480 + nplanes + begin_bit)
    planes = [rng.integers(0, 2**32, 257, dtype=np.uint32)
              for _ in range(nplanes)]
    args = (begin_bit, end_bit, 32 * nplanes)
    want = jax_mask(tuple(jnp.asarray(p) for p in planes), *args)
    got = port_mask(tuple(_i32(p) for p in planes), *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u32(g), np.asarray(w))


# ---- the public API on the CPU row (K 2048, R 16) ----------------------

API_N = 20_000


@pytest.mark.parametrize("dtype", DTYPES)
def test_api_bit_range_sorts(dtype):
    rng = np.random.default_rng(440 + np.dtype(dtype).num)
    bits = np.dtype(dtype).itemsize * 8
    x = random_keys(rng, API_N, dtype)
    v = np.arange(API_N, dtype=np.int64)        # a 64-bit value: 2 words
    for begin_bit, end_bit in ((4, bits - 4), (bits // 2, bits), (0, 20)):
        for descending in (False, True):
            kw = dict(descending=descending, begin_bit=begin_bit,
                      end_bit=end_bit)
            tm.reset_counters()
            got = tpusort_torch.sort(torch.from_numpy(x), **kw)
            np.testing.assert_array_equal(_bits(got.numpy()),
                                          _bits(np_sort_oracle(x, **kw)))
            gk, gv = tpusort_torch.sort_pairs(torch.from_numpy(x),
                                              torch.from_numpy(v), **kw)
            wk, wv = np_sort_oracle(x, v, **kw)
            np.testing.assert_array_equal(_bits(gk.numpy()), _bits(wk))
            np.testing.assert_array_equal(gv.numpy(), wv)
            assert tm.counters()["reference_routes"] == 0


@pytest.mark.parametrize("dtype", [np.int64, np.uint64, np.float64])
def test_api_argsort_64bit(dtype):
    rng = np.random.default_rng(450 + np.dtype(dtype).num)
    x = random_keys(rng, API_N, dtype)
    x[1::3] = x[::3][: len(x[1::3])]             # equal keys
    for descending in (False, True):
        got = tpusort_torch.argsort(torch.from_numpy(x),
                                    descending=descending)
        _, want = np_sort_oracle(x, np.arange(API_N), descending=descending)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    got = tpusort_torch.argsort(torch.from_numpy(x), begin_bit=40)
    _, want = np_sort_oracle(x, np.arange(API_N), begin_bit=40)
    np.testing.assert_array_equal(got.numpy(), want)


def test_api_stable_64bit_pairs_entropy():
    """Stable u64 pairs on low-entropy keys (many equal keys): exact,
    through the engine or through the fallback (always at entropy 0)."""
    for level in (2, 0):
        x = entropy_keys(np.random.default_rng(460 + level), API_N, level,
                         np.uint64)
        v = np.arange(API_N, dtype=np.uint32)
        tm.reset_counters()
        gk, gv = tpusort_torch.sort_pairs(torch.from_numpy(x),
                                          torch.from_numpy(v))
        wk, wv = np_sort_oracle(x, v)
        np.testing.assert_array_equal(gk.numpy(), wk)
        np.testing.assert_array_equal(gv.numpy(), wv)
        if level == 0:
            assert tm.counters()["overflow_fallbacks"] == 1


@pytest.mark.parametrize("num_lsb_bytes", [1, 2, 3, 4])
def test_sort_pairs_lsb_in_value_matches_jax(num_lsb_bytes):
    """Against ``tpusort.sort_pairs_lsb_in_value``.  Keys repeat; the low
    value bytes are distinct within each key, so the composite key is
    unique and the unstable result has one right answer."""
    rng = np.random.default_rng(470 + num_lsb_bytes)
    key = random_keys(rng, 500, np.int32)[rng.integers(0, 500, API_N)]
    rank = np.zeros(API_N, dtype=np.uint64)
    for k in np.unique(key):
        at = np.flatnonzero(key == k)
        rank[at] = rng.permutation(len(at))
    shift = np.uint64(8 * num_lsb_bytes)
    high = rng.integers(0, 2**32, API_N, dtype=np.uint64)
    val = rank if num_lsb_bytes == 4 else (high << shift) | rank
    val = (val & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.float32)
    for descending in (False, True):
        jk, jv = tpusort.sort_pairs_lsb_in_value(
            jnp.asarray(key), jnp.asarray(val), num_lsb_bytes,
            descending=descending)
        tk, tv = tpusort_torch.sort_pairs_lsb_in_value(
            torch.from_numpy(key), torch.from_numpy(val), num_lsb_bytes,
            descending=descending)
        assert tk.dtype == torch.int32 and tv.dtype == torch.float32
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(_bits(tv.numpy()), _bits(np.asarray(jv)))


def test_sort_pairs_lsb_in_value_checks():
    k = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="1..4"):
        tpusort_torch.sort_pairs_lsb_in_value(k, k, 5)
    with pytest.raises(ValueError, match="32-bit"):
        tpusort_torch.sort_pairs_lsb_in_value(k, k.long())
    with pytest.raises(NotImplementedError, match="32-bit key"):
        tpusort_torch.sort_pairs_lsb_in_value(k.long(), k)
