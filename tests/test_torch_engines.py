"""The engine registry and ``algorithm=`` of ``tpusort_torch`` against
``tpusort``: the same numpy inputs through both packages' ``sort``,
``argsort`` and ``sort_planes`` with each registered engine (the
``algorithm=`` cases of ``tests/test_sort_api.py``).  Keys compare bit for
bit; stable engines' payloads exactly, unstable ones' as a permutation
that rides with its keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusort
import tpusort_torch
from oracle import np_sort_oracle
from tpusort_torch import api as tapi
from tpusort_torch.ops.reference import sort_twiddled_reference
from tpusort_torch.utils.datagen import entropy_keys, random_keys

# engines whose keys come out exact on every input (JAX's KEYS_ALGORITHMS,
# with the aliases "xla" and "lsd"); msd_equidepth has its own case below
KEYS_ALGORITHMS = ["reference", "xla", "msd", "msd_unstable", "lsd",
                   "bitonic"]
STABLE_ALGORITHMS = ["reference", "xla", "msd", "lsd"]


def _keys(dtype, n, entropy, seed=0):
    rng = np.random.default_rng(seed)
    if entropy == 1:
        return random_keys(rng, n, dtype)
    return entropy_keys(rng, n, entropy, dtype)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint64 if a.itemsize == 8 else np.uint32)


def test_available_engines_match_tpusort():
    assert tpusort_torch.available_engines() == tpusort.available_engines()
    assert len(tpusort_torch.available_engines()) == 7


@pytest.mark.parametrize("algorithm", KEYS_ALGORITHMS)
@pytest.mark.parametrize("dtype", [np.uint32, np.float32, np.int64])
@pytest.mark.parametrize("entropy", [1, 4, 0])
def test_sort_keys(algorithm, dtype, entropy):
    x = _keys(dtype, 10000, entropy, seed=entropy)
    want = np.asarray(tpusort.sort(jnp.asarray(x), algorithm=algorithm))
    got = tpusort_torch.sort(torch.from_numpy(x), algorithm=algorithm)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(want), _bits(np_sort_oracle(x)))


@pytest.mark.parametrize("algorithm", KEYS_ALGORITHMS)
def test_sort_descending_and_small(algorithm):
    """Descending keys, and a single tile (bitonic sorts it on K3's plain
    version instead of delegating)."""
    for n, desc in ((8192, True), (1000, False)):
        x = _keys(np.uint32, n, 2, seed=n)
        want = np.asarray(tpusort.sort(jnp.asarray(x), descending=desc,
                                       algorithm=algorithm))
        got = tpusort_torch.sort(torch.from_numpy(x), descending=desc,
                                 algorithm=algorithm)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("algorithm", STABLE_ALGORITHMS)
@pytest.mark.parametrize("dtype,begin,end", [
    (np.uint32, 8, 24), (np.uint64, 16, 48), (np.float32, 0, 32)])
def test_sort_pairs_stable(algorithm, dtype, begin, end):
    x = _keys(dtype, 5000, 3, seed=begin)
    v = np.arange(x.shape[0], dtype=np.uint32)
    wk, wv = tpusort.sort(jnp.asarray(x), jnp.asarray(v), begin_bit=begin,
                          end_bit=end, algorithm=algorithm)
    gk, gv = tpusort_torch.sort(torch.from_numpy(x), torch.from_numpy(v),
                                begin_bit=begin, end_bit=end,
                                algorithm=algorithm)
    np.testing.assert_array_equal(_bits(gk.numpy()), _bits(np.asarray(wk)))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("algorithm", ["msd_unstable", "bitonic"])
@pytest.mark.parametrize("n", [16384, 30000])
def test_sort_pairs_unstable(algorithm, n):
    """Unstable engines: keys as JAX's, values a permutation that rides
    with its keys (the reference's own pair check)."""
    x = _keys(np.uint32, n, 2, seed=n)
    v = np.arange(n, dtype=np.uint32)
    wk, _ = tpusort.sort(jnp.asarray(x), jnp.asarray(v), algorithm=algorithm)
    gk, gv = tpusort_torch.sort(torch.from_numpy(x), torch.from_numpy(v),
                                algorithm=algorithm)
    gk, gv = gk.numpy(), gv.numpy().astype(np.int64)
    np.testing.assert_array_equal(gk, np.asarray(wk))
    np.testing.assert_array_equal(x[gv], gk)
    np.testing.assert_array_equal(np.sort(gv), np.arange(n))


def test_stable_false_maps_to_msd_unstable(monkeypatch):
    """``stable=False`` with "auto", "msd" or "lsd" runs msd_unstable, as
    JAX's ``_sort_impl`` maps it, where the config's default engine is not
    a radix engine (else the tiering takes it)."""
    calls = []
    real = tapi._ENGINES["msd_unstable"]

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setitem(tapi._ENGINES, "msd_unstable", spy)
    x = _keys(np.uint32, 6000, 1, seed=3)
    v = np.arange(6000, dtype=np.uint32)
    for algo in ("msd", "lsd"):
        tpusort_torch.sort(torch.from_numpy(x), torch.from_numpy(v),
                           algorithm=algo, stable=False)
    assert calls == []          # the radix names take the host tiering
    cfg = tapi._configs.SortConfig(tile_elems=2048, radix=16, s1=256,
                                   min_n=4096, small_n_threshold=2048,
                                   default_algorithm="bitonic")
    monkeypatch.setattr(tapi._configs, "get_config", lambda *a: cfg)
    gk, gv = tpusort_torch.sort(torch.from_numpy(x), torch.from_numpy(v),
                                stable=False)
    assert calls == [1]
    np.testing.assert_array_equal(gk.numpy(), np.sort(x))
    np.testing.assert_array_equal(x[gv.numpy().astype(np.int64)], gk.numpy())


@pytest.mark.parametrize("algorithm", ["msd", "reference", "lsd"])
@pytest.mark.parametrize("dtype", [np.uint32, np.int64])
def test_argsort(algorithm, dtype):
    x = _keys(dtype, 6000, 2, seed=5)
    want = np.asarray(tpusort.argsort(jnp.asarray(x), algorithm=algorithm))
    got = tpusort_torch.argsort(torch.from_numpy(x), algorithm=algorithm)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("algorithm", ["msd", "msd_unstable", "reference"])
def test_sort_planes(algorithm):
    rng = np.random.default_rng(11)
    hi = rng.integers(0, 4, 7000).astype(np.uint32)
    lo = random_keys(rng, 7000)
    want = tpusort.sort_planes((jnp.asarray(hi), jnp.asarray(lo)),
                               key_dtype="uint64", algorithm=algorithm)
    got = tpusort_torch.sort_planes((torch.from_numpy(hi),
                                     torch.from_numpy(lo)),
                                    key_dtype="uint64", algorithm=algorithm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_msd_equidepth_keys():
    """The equi-depth engine called by name (keys only; JAX's runs Pallas
    in interpret mode, so the oracle stands for it here)."""
    x = _keys(np.uint32, 20000, 3, seed=7)
    got = tpusort_torch.sort(torch.from_numpy(x), algorithm="msd_equidepth")
    np.testing.assert_array_equal(got.numpy(), np_sort_oracle(x))


def test_unknown_algorithm_raises():
    x = torch.from_numpy(_keys(np.uint32, 300, 1))
    for fn in (lambda: tpusort_torch.sort(x, algorithm="nope"),
               lambda: tpusort_torch.argsort(x, algorithm="nope"),
               lambda: tpusort_torch.sort_planes((x, x), algorithm="nope")):
        with pytest.raises(ValueError, match="available"):
            fn()
    with pytest.raises(ValueError, match="unknown algorithm"):
        tpusort.sort(jnp.asarray(x.numpy()), algorithm="nope")


def test_registered_engine_without_config():
    """An engine written against the contract without ``config=`` works,
    and ``auto`` falls back to the reference when the config names an
    engine that is not registered."""

    def legacy(planes, values, *, begin_bit, end_bit, total_bits):
        return sort_twiddled_reference(planes, values, begin_bit=begin_bit,
                                       end_bit=end_bit, total_bits=total_bits)

    tpusort_torch.register_engine("_legacy_test", legacy)
    try:
        x = _keys(np.uint32, 2048, 3, seed=9)
        got = tpusort_torch.sort(torch.from_numpy(x),
                                 algorithm="_legacy_test")
        np.testing.assert_array_equal(got.numpy(), np_sort_oracle(x))
        assert "_legacy_test" in tpusort_torch.available_engines()
    finally:
        tapi._ENGINES.pop("_legacy_test", None)
    cfg = tapi._configs.SortConfig(default_algorithm="not-registered")
    assert tapi._resolve_engine("auto", cfg) is tapi._ENGINES["reference"]
