"""The port's host tiering (``tpusort_torch.api``): the tier chain radix ->
equi-depth -> exact, the host planner's radix skip, the presorted identity
short-circuit and the tier-decision cache, ported from
``tests/test_tiering.py``.

The port runs with a CPU config that turns the equi-depth tier on
(``skew_tier=True``; on the CPU it is off by default, as JAX's is off the
TPU), and the planner's size floor is lowered so that test sizes are
classified.  Every output equals ``tpusort.sort`` (the JAX API on its CPU
path) on the same numpy input and the numpy oracle; the route counters
show which tiers ran.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusort
import tpusort_torch
from oracle import np_sort_oracle
from tpusort import configs as jcfg
from tpusort_torch import api as tapi
from tpusort_torch import planner as tpl
from tpusort_torch.configs import SortConfig, get_config, register_config
from tpusort_torch.ops import msd as tm
from tpusort_torch.ops import tiers as ttiers
from tpusort_torch.utils.datagen import (
    entropy_keys, enumerated_values, random_keys, zipf_keys)

N = 20_000
SKEW = SortConfig(tile_elems=2048, radix=16, s1=256, min_n=4096,
                  skew_tier=True, skew_sample_log2=13)
NO_SKEW = SortConfig(tile_elems=2048, radix=16, s1=256, min_n=4096,
                     skew_tier=False)
J_CFG = jcfg.SortConfig(tile_elems=2048, radix=16, s1=256, min_n=4096)


@pytest.fixture
def tiering():
    """Register ``SKEW`` for the port's 32- and 64-bit CPU rows, clear the
    tier cache and the counters; returns a setter for another config."""
    saved = {(b, v): get_config(b, v, "cpu") for b in (32, 64)
             for v in (False, True)}

    def use(cfg):
        for b, v in saved:
            register_config(b, v, "cpu", cfg)

    use(SKEW)
    tapi._TIER_CACHE.clear()
    tm.reset_counters()
    yield use
    for (b, v), cfg in saved.items():
        register_config(b, v, "cpu", cfg)
    tapi._TIER_CACHE.clear()


@pytest.fixture
def classify(monkeypatch):
    """Classify from 1024 keys up (both packages), and spy on the port's
    tier chain: the list of calls is returned."""
    from tpusort import planner as jpl

    monkeypatch.setattr(tpl, "PLANNER_MIN_N", 1 << 10)
    monkeypatch.setattr(jpl, "PLANNER_MIN_N", 1 << 10)
    calls = []
    orig = tapi._run_tier_chain

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(tapi, "_run_tier_chain", spy)
    return calls


def _jax_sort(x, v=None, **kw):
    """tpusort.sort on its CPU msd path (radix, then exact)."""
    platform = jax.default_backend()
    saved = jcfg.get_config(32, False), jcfg.get_config(32, True)
    jcfg.register_config(32, False, platform, J_CFG)
    jcfg.register_config(32, True, platform, J_CFG)
    try:
        out = tpusort.sort(jnp.asarray(x), None if v is None
                           else jnp.asarray(v), algorithm="msd", **kw)
    finally:
        jcfg.register_config(32, False, platform, saved[0])
        jcfg.register_config(32, True, platform, saved[1])
    if v is None:
        return np.asarray(out)
    return np.asarray(out[0]), np.asarray(out[1])


def _sort(x, v=None, **kw):
    out = tpusort_torch.sort(torch.from_numpy(x), None if v is None
                             else torch.from_numpy(v), **kw)
    if v is None:
        return out.numpy()
    return out[0].numpy(), out[1].numpy()


@pytest.mark.parametrize("cfg,exact", [(NO_SKEW, 1), (SKEW, 0)])
def test_overflow_routes_down_the_chain(tiering, cfg, exact):
    """Constant keys overflow the radix runs.  Without the skew tier the
    chain lands on the exact tier; with it, the equi-depth tier absorbs
    them."""
    tiering(cfg)
    x = np.full(N, 7, np.uint32)
    got = _sort(x)
    c = tm.counters()
    assert c["radix_tiers"] == 1
    assert c["overflow_fallbacks"] == exact
    assert c["equidepth_runs"] == 1 - exact
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(got, _jax_sort(x))


def test_clean_input_single_dispatch(tiering):
    x = random_keys(np.random.default_rng(3), N)
    got = _sort(x)
    c = tm.counters()
    assert (c["radix_tiers"], c["equidepth_runs"],
            c["overflow_fallbacks"]) == (1, 0, 0)
    np.testing.assert_array_equal(got, np_sort_oracle(x))
    np.testing.assert_array_equal(got, _jax_sort(x))


@pytest.mark.parametrize("level", [0, 4])
def test_stable_pairs_on_skew(tiering, level):
    """Stable pairs through the chain on skewed keys stay stable."""
    x = entropy_keys(np.random.default_rng(4), N, level)
    v = enumerated_values(N)
    gk, gv = _sort(x, v)
    wk, wv = np_sort_oracle(x, v)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)
    jk, jv = _jax_sort(x, v)
    np.testing.assert_array_equal(gk, jk)
    np.testing.assert_array_equal(gv, jv)


@pytest.mark.parametrize("stable", [True, False])
def test_equidepth_engaged_on_zipf(tiering, classify, stable):
    """The planner reads the sample, predicts a radix overflow on Zipf keys
    and the chain starts at the equi-depth tier, which sorts them with no
    fallback."""
    x = zipf_keys(np.random.default_rng(6), N, alpha=1.2, dtype=np.uint32)
    got = _sort(x, stable=stable)
    c = tm.counters()
    assert (c["radix_tiers"], c["equidepth_runs"],
            c["overflow_fallbacks"]) == (0, 1, 0)
    np.testing.assert_array_equal(got, np_sort_oracle(x))
    np.testing.assert_array_equal(got, _jax_sort(x, stable=stable))


def test_skew_sample_log2_sets_the_sample(tiering, monkeypatch):
    """``SortConfig.skew_sample_log2`` sizes the equi-depth tier's sample
    (2^13 of 20,000 keys: every second key), as JAX's config does."""
    from tpusort_torch.ops import equidepth

    seen = []
    orig = equidepth._quantile_table

    def spy(planes, n, nq, sample_log2=None):
        table = orig(planes, n, nq, sample_log2=sample_log2)
        seen.append((sample_log2, table.m))
        return table

    monkeypatch.setattr(equidepth, "_quantile_table", spy)
    x = np.full(N, 7, np.uint32)
    np.testing.assert_array_equal(_sort(x), x)
    assert seen == [(13, N // 2)]


_MAKERS = {
    "sorted": lambda n: np.sort(random_keys(np.random.default_rng(0), n)),
    "constant": lambda n: np.full(n, 7, np.uint32),
    "zero_floats": lambda n: np.zeros(n, np.float32),
}


@pytest.mark.parametrize("make", sorted(_MAKERS))
def test_identity(tiering, classify, make):
    x = _MAKERS[make](1 << 12)
    t = torch.from_numpy(x)
    out = tpusort_torch.sort(t)
    assert not classify, "the short-circuit must bypass the tier chain"
    assert tm.counters()["identity_routes"] == 1
    assert out.data_ptr() != t.data_ptr()
    np.testing.assert_array_equal(out.numpy(), x)
    np.testing.assert_array_equal(out.numpy(), _jax_sort(x))


def test_identity_pairs(tiering, classify):
    n = 1 << 12
    x = np.sort(np.random.default_rng(1).integers(0, 1000, n)
                .astype(np.int32))
    v = enumerated_values(n)
    ok, ov = _sort(x, v)
    assert not classify
    np.testing.assert_array_equal(ok, x)
    np.testing.assert_array_equal(ov, v)
    jk, jv = _jax_sort(x, v)
    np.testing.assert_array_equal(ok, jk)
    np.testing.assert_array_equal(ov, jv)


def test_descending_presorted(tiering, classify):
    x = _MAKERS["sorted"](1 << 12)[::-1].copy()
    got = _sort(x, descending=True)
    assert not classify
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(got, _jax_sort(x, descending=True))


def test_misleading_sample_falls_through(tiering, classify):
    """A sorted sample of an input that is not sorted: the device check
    rejects it and the chain sorts."""
    n = 1 << 17
    stride = max(1, n // tpl.SAMPLE_TARGET)
    assert stride > 1
    base = np.sort(random_keys(np.random.default_rng(3), n) >> 1)
    base[1] = base[-1] + 1          # not sampled; breaks the order
    got = _sort(base)
    assert classify and tm.counters()["identity_routes"] == 0
    np.testing.assert_array_equal(got, np.sort(base))
    np.testing.assert_array_equal(got, _jax_sort(base))


def test_sorted_planes_short_circuit(tiering, classify):
    n = 1 << 12
    rng = np.random.default_rng(4)
    v64 = np.sort(rng.integers(0, 1 << 63, n, dtype=np.uint64))
    hi = (v64 >> np.uint64(32)).astype(np.uint32)
    lo = (v64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out = tpusort_torch.sort_planes((torch.from_numpy(hi),
                                     torch.from_numpy(lo)),
                                    key_dtype="uint64")
    assert not classify and tm.counters()["identity_routes"] == 1
    assert all(o.dtype == torch.uint32 for o in out)
    np.testing.assert_array_equal(out[0].numpy(), hi)
    np.testing.assert_array_equal(out[1].numpy(), lo)
    want = tpusort.sort_planes((jnp.asarray(hi), jnp.asarray(lo)),
                               key_dtype="uint64", algorithm="msd")
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(want[1]))


def test_warm_cache_distribution_switch(tiering, classify):
    """Two uniform sorts warm the cache with the radix tier; constant keys
    of the same shape then run radix first and are caught by the chain;
    the refreshed entry says presorted, so the next constant call is the
    identity; Zipf keys after it are classified afresh (cold path, since
    the entry says presorted) and start at the equi-depth tier."""
    uni = random_keys(np.random.default_rng(11), N)
    for _ in range(2):
        np.testing.assert_array_equal(_sort(uni), np_sort_oracle(uni))
    assert [v for v in tapi._TIER_CACHE.values()] == [
        {"presorted": False, "tier": "radix"}]
    const = np.full(N, 3, np.uint32)
    tm.reset_counters()
    np.testing.assert_array_equal(_sort(const), const)
    assert tm.counters()["radix_tiers"] == 1
    assert [v["presorted"] for v in tapi._TIER_CACHE.values()] == [True]
    tm.reset_counters()
    np.testing.assert_array_equal(_sort(const), const)
    assert tm.counters()["identity_routes"] == 1
    z = zipf_keys(np.random.default_rng(12), N, alpha=1.2, dtype=np.uint32)
    tm.reset_counters()
    got = _sort(z)
    c = tm.counters()
    assert (c["radix_tiers"], c["equidepth_runs"]) == (0, 1)
    np.testing.assert_array_equal(got, np_sort_oracle(z))
    np.testing.assert_array_equal(got, _jax_sort(z))


def test_cache_key_separates_shapes(tiering, classify):
    a = random_keys(np.random.default_rng(12), 4096)
    b = random_keys(np.random.default_rng(13), 8192)
    np.testing.assert_array_equal(_sort(a), np_sort_oracle(a))
    np.testing.assert_array_equal(_sort(b), np_sort_oracle(b))
    assert len({k[1] for k in tapi._TIER_CACHE}) == 2


def test_tier_chain_default_by_device():
    """``skew_tier=None`` puts the equi-depth tier in the chain on a card
    and leaves it out on the CPU."""
    cfg = SortConfig()
    assert tapi._tier_chain(cfg, torch.device("cpu")) == ("radix", "exact")
    assert tapi._tier_chain(cfg, torch.device("cuda", 0)) == (
        "radix", "equidepth", "exact")
    assert tapi._tier_chain(SKEW, torch.device("cpu")) == (
        "radix", "equidepth", "exact")


class _Flag:
    """An overflow flag whose host reads are logged."""

    def __init__(self, log, name, value):
        self.log, self.name, self.value = log, name, value

    def __bool__(self):
        self.log.append("read " + self.name)
        return self.value


def _attempts(log, flags):
    """One attempt a flag (True set, False clear, None exact), named a, b,
    c...; each logs its run and returns its name as its planes."""
    def attempt(name, value):
        def run():
            log.append(name)
            return (name,), (), (None if value is None
                                 else _Flag(log, name, value))
        return run
    return [attempt("abc"[i], v) for i, v in enumerate(flags)]


# (flags, route, first_sync, the log, the winner)
CHAINS = {
    "first_clear_wins": ((False, True, None), "overflow_fallbacks", False,
                         ["a", "read a"], "a"),
    "last_never_read": ((True, True), "overflow_fallbacks", False,
                        ["a", "read a", "b"], "b"),
    "first_sync_before_read": ((True, False, None), "overflow_fallbacks",
                               True, ["a", "sync", "read a", "b", "read b"],
                               "b"),
    "sample_route": ((True, None), "sample_fallbacks", False,
                     ["a", "read a", "b"], "b"),
    "exact_first_never_read": ((None, None), "overflow_fallbacks", True,
                               ["a", "sync"], "a"),
}


@pytest.mark.parametrize("case", sorted(CHAINS))
def test_first_clear_runs_the_chain(case, monkeypatch):
    """``ops.tiers.first_clear``: the first attempt whose flag is clear
    wins and later attempts never run; the last attempt's flag and a None
    flag are never read; ``first_sync`` runs after the first dispatch and
    before its read; each read is a ``host_read`` at the caller's site,
    and the last attempt, run after a flag, counts the caller's route."""
    flags, route, sync, want_log, winner = CHAINS[case]
    log, sites = [], []
    real = ttiers.host_read

    def spy(site):
        sites.append(site)
        return real(site)

    monkeypatch.setattr(ttiers, "host_read", spy)
    tm.reset_counters()
    got = ttiers.first_clear(
        _attempts(log, flags), "chain_flag", route=route,
        first_sync=(lambda: log.append("sync")) if sync else None)
    assert got == ((winner,), ())
    assert log == want_log
    reads = [e for e in log if e.startswith("read ")]
    assert sites == ["chain_flag"] * len(reads)
    c = tm.counters()
    assert c["host_reads"] == len(reads)
    fell = winner == "abc"[len(flags) - 1] and len(flags) > 1
    assert c[route] == int(fell)
    other = {"overflow_fallbacks": "sample_fallbacks",
             "sample_fallbacks": "overflow_fallbacks"}[route]
    assert c[other] == 0
