"""Stable ``sort_pairs`` of uint64 keys with int64 row ids on CPU tensors,
through the public call: the general path (K1c passes, in their plain
versions here) and the wide leaf, held bit for bit against the benchmark's
plain reference (``portbench/reference.py``, a stable ``torch.sort``); and
the bytes the 64-bit split and join count in ``split_join_bytes``.

At n = 12,345 the CPU config plans two passes of 4 bits over a tile of
2,048 and a 56-bit remainder, too wide for one packed word with the
segment position: the wide leaf, as the card's 2^27 plan (49 bits).
"""

import numpy as np
import pytest
import torch

import tpusort_torch
from portbench import reference
from tpusort_torch import api as tapi
from tpusort_torch.configs import get_config
from tpusort_torch.ops import msd as tm

N = 12345
ONES = np.uint64(0xFFFF_FFFF_FFFF_FFFF)


def _uniform(rng, n=N):
    return rng.integers(0, 2**64, n, dtype=np.uint64, endpoint=False)


def _ties(rng):
    """4,000 distinct keys drawn again and again (about three of each),
    and 20 runs of 16 equal keys planted at random places: no final
    segment of the plan's 128 slots overflows (at most 117 keys)."""
    keys = _uniform(rng, 4000)[rng.integers(0, 4000, N)]
    for start in rng.choice(N - 16, 20, replace=False):
        keys[start:start + 16] = keys[start]
    return keys


def _all_ones(rng):
    """Uniform keys with all-ones keys scattered and a block of them last:
    equal to the largest key and ranked against the pads of the last
    tile."""
    keys = _uniform(rng)
    keys[rng.choice(N, 40, replace=False)] = ONES
    keys[-24:] = ONES
    return keys


KEYS = {"uniform": _uniform, "ties": _ties, "all_ones": _all_ones}


def _pairs(kind, seed=64):
    keys = KEYS[kind](np.random.default_rng(seed))
    return (torch.from_numpy(keys.view(np.int64)).view(torch.uint64),
            torch.arange(N, dtype=torch.int64))


@pytest.fixture
def wide_leaf(monkeypatch):
    """The calls of ``msd.wide_leaf_operands`` (the wide leaf's planes),
    with zeroed counters and an empty tier cache."""
    seen = []
    orig = tm.wide_leaf_operands

    def spy(*args, **kwargs):
        seen.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(tm, "wide_leaf_operands", spy)
    tapi._TIER_CACHE.clear()
    tm.reset_counters()
    return seen


def test_the_cpu_plan_is_the_general_path_with_a_wide_leaf():
    kw = get_config(64, True, "cpu").plan_kwargs()
    kw.pop("min_n")
    plan = tm._plan_cached(N, 0, 64, "packed", tuple(sorted(kw.items())))
    assert len(plan.passes) == 2 and plan.rem_width == 56
    assert tm.leaf_is_wide(plan)


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_stable_u64_i64_pairs_match_the_reference(wide_leaf, kind):
    keys, values = _pairs(kind)
    got_k, got_v = tpusort_torch.sort_pairs(keys, values, stable=True)
    c = tm.counters()
    assert (c["radix_tiers"], c["overflow_fallbacks"],
            c["reference_routes"]) == (1, 0, 0)
    assert len(wide_leaf) == 1
    want_k, want_v = reference.stable_sort(keys, values)
    assert got_k.dtype == torch.uint64 and got_v.dtype == torch.int64
    assert torch.equal(got_k.view(torch.int64), want_k.view(torch.int64))
    assert torch.equal(got_v, want_v)
    if kind == "all_ones":
        assert (got_k.view(torch.int64)[-64:] == -1).all()


def _u32(n):
    return torch.from_numpy(np.random.default_rng(7).integers(
        0, 2**32, n, dtype=np.uint64).astype(np.uint32)).view(torch.uint32)


CALLS = {
    "u64+i64": (lambda: tpusort_torch.sort_pairs(*_pairs("uniform")), 64),
    "u64": (lambda: tpusort_torch.sort(_pairs("uniform")[0]), 32),
    "u32": (lambda: tpusort_torch.sort(_u32(N)), 0),
    "u32+u32": (lambda: tpusort_torch.sort_pairs(
        _u32(N), torch.arange(N, dtype=torch.int32).view(torch.uint32)), 0),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_split_join_bytes_a_key(call):
    """16 B a key for each 64-bit split and join (the elements each copy
    reads and writes); nothing for a 32-bit operand, which is a view."""
    fn, per_key = CALLS[call]
    tapi._TIER_CACHE.clear()
    tm.reset_counters()
    fn()
    assert tm.counters()["split_join_bytes"] == per_key * N
    tm.reset_counters()
    assert tm.counters()["split_join_bytes"] == 0
