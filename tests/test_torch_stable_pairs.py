"""Stable 32-bit pairs on the raw K1/K2 route, which carries the key plane
alone: ties keep input order through multi-pass plans, and an invalid slot
ranks after a valid all-ones key in K1, K1b, K2 and K9, so no pad's
payload reaches a valid prefix and no input takes the fallback.  Held
against the JAX engine (``tpusort.ops.msd`` on its XLA path, flag mode,
which sorts the composite (key, position) planes) and the stable numpy
order.
"""

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusort_torch
from tpusort.ops import msd as jm
from tpusort_torch.configs import SortConfig
from tpusort_torch.kernels import bitonic as tb
from tpusort_torch.kernels import partition as tp
from tpusort_torch.ops import msd as tm
from tpusort_torch.utils.datagen import enumerated_values, random_keys

# the registered engine: radix, then the exact sort where its flag is set
MSD = tpusort_torch.api._ENGINES["msd"]


@dataclasses.dataclass(frozen=True)
class _Config(SortConfig):
    """A config that also pins the later passes' run capacity ``s``."""
    s: Optional[int] = None

    def plan_kwargs(self) -> dict:
        kw = super().plan_kwargs()
        if self.s is not None:
            kw["s"] = self.s
        return kw


# Any radix plan sends a tile's copies of one key to one run, which the CPU
# row's 256 slots cannot hold when a tile has few distinct keys.  Here a
# pass-0 run holds a whole tile and a pass-1 run 3/4 of one: 2 passes at
# n = 2000, and the leaf packs 4 runs of pass 1.
WIDE = _Config(tile_elems=512, radix=4, s1=512, s=384, leaf_max=1536,
               min_n=1024)
N_WIDE = 2000
ONES = np.uint32(0xFFFFFFFF)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _wide_keys(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("distinct"):
        # d values spread over the range, the largest all-ones
        d = int(case[len("distinct"):])
        words = (np.arange(1, d + 1, dtype=np.uint64) * (2**32 // d) - 1)
        return words.astype(np.uint32)[rng.integers(0, d, N_WIDE)]
    x = random_keys(rng, N_WIDE)
    if case == "ones_blocked":
        x[640:896] = ONES                       # inside pass-0 tile 1
    else:                                       # "pad_before_ones"
        x[::512] = ONES                         # slot 0 of every tile
    return x


def _pad_before_ones(x, cfg):
    """Whether a leaf tile of the engine's plan for ``x`` holds an invalid
    slot ahead of a valid all-ones key (the case the pad index decides)."""
    kw = cfg.plan_kwargs()
    kw.pop("min_n")
    n = x.shape[0]
    plan = tm.plan_msd(n, 0, 32, **kw)
    ops = [torch.nn.functional.pad(_i32(x), (0, plan.m1 - n))]
    (data,), (ctable, q), _ = tm.run_passes(ops, 1, n, plan)
    nt, tile = tm.leaf_tiles(plan, 1, True)
    valid = tp._valid(data.reshape(nt, tile), ctable.reshape(nt, -1), q,
                      None)
    ones = valid & (data.reshape(nt, tile) == -1)
    first_pad = torch.where(~valid, torch.arange(tile), tile).min(dim=1)
    last_one = torch.where(ones, torch.arange(tile), -1).max(dim=1)
    return bool((first_pad.values < last_one.values).any())


def _stable_pairs(x, cfg, plan_kwargs):
    """The port's engine and the JAX engine on stable pairs (x, 0..n-1):
    (port keys, port values, JAX keys, JAX values, JAX overflow)."""
    v = enumerated_values(x.shape[0])
    tm.reset_counters()
    (tk,), (tv,) = MSD(
        (_i32(x),), (_i32(v),), begin_bit=0, end_bit=32, total_bits=32,
        config=cfg)
    assert tm.counters()["overflow_fallbacks"] == 0
    assert tm.counters()["reference_routes"] == 0
    (wk,), (wv,), jovf = jm.sort_twiddled_msd(
        (jnp.asarray(x),), (jnp.asarray(v),), begin_bit=0, end_bit=32,
        total_bits=32, use_pallas=False, plan_kwargs=plan_kwargs,
        on_overflow="flag")
    return (tk.numpy().view(np.uint32), tv.numpy().view(np.uint32),
            np.asarray(wk), np.asarray(wv), bool(jovf))


@pytest.mark.parametrize("case", ["distinct2", "distinct4", "distinct16",
                                  "ones_blocked", "pad_before_ones"])
def test_stable_pairs_with_ties_on_a_multi_pass_plan(case):
    """Few distinct keys, or all-ones keys, through 2 passes and the leaf:
    keys sorted, values the stable permutation, no fallback, and both
    equal to the JAX engine's."""
    x = _wide_keys(case)
    assert len(tm.plan_msd(N_WIDE, 0, 32, **{
        k: v for k, v in WIDE.plan_kwargs().items() if k != "min_n"})
        .passes) == 2
    if case in ("distinct2", "pad_before_ones"):
        assert _pad_before_ones(x, WIDE)
    tk, tv, wk, wv, jovf = _stable_pairs(
        x, WIDE, dict(k=512, r=4, s1=512, s=384, leaf_max=1536, min_n=1024))
    perm = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(tk, x[perm])
    np.testing.assert_array_equal(tv, perm)
    assert not jovf
    np.testing.assert_array_equal(tk, wk)
    np.testing.assert_array_equal(tv, wv)


def test_stable_pairs_on_the_strided_feed_take_the_general_path():
    """The strided feed breaks input order across tiles, so stable pairs
    with ``strided=True`` take K1c and the general leaf: still stable."""
    x = _wide_keys("distinct16")
    v = enumerated_values(N_WIDE)
    tm.reset_counters()
    (tk,), (tv,) = MSD(
        (_i32(x),), (_i32(v),), begin_bit=0, end_bit=32, total_bits=32,
        config=WIDE, strided=True)
    assert tm.counters()["overflow_fallbacks"] == 0
    perm = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(tk.numpy().view(np.uint32), x[perm])
    np.testing.assert_array_equal(tv.numpy(), perm)


def test_sort_pairs_scattered_ones_on_the_cpu_row():
    """The API's stable ``sort_pairs`` on the CPU row (2 passes at
    300,000 keys) with an all-ones key in every pass-0 tile, so every
    pass-1 tile of the top segment holds pads ahead of valid all-ones
    keys: no fallback, and the stable permutation.  The JAX engine flags
    this input (its XLA path's packed leaf ties all-ones keys with its
    sentinel) and takes its exact fallback, whose result is the same."""
    n = 300_000
    x = random_keys(np.random.default_rng(18), n)
    x[::997] = ONES
    cfg = tpusort_torch.get_config(32, True, "cpu")
    assert len(tm.plan_msd(n, 0, 32, k=2048, r=16, s1=256).passes) == 2
    v = enumerated_values(n)
    tm.reset_counters()
    ko, vo = tpusort_torch.sort_pairs(torch.from_numpy(x),
                                      torch.from_numpy(v))
    assert tm.counters()["overflow_fallbacks"] == 0
    perm = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(ko.numpy(), x[perm])
    np.testing.assert_array_equal(vo.numpy(), perm)
    *_, jovf = _stable_pairs(x, cfg, dict(k=2048, r=16, s1=256,
                                          min_n=4096))
    assert jovf


# ---- the plain versions: a pad never reaches a valid prefix -------------

T, K, Q = 4, 512, 128


def _tiles():
    """(T, K) keys of 16 distinct words, all-ones among them, and a
    (T, K / Q) counts table that leaves pads in every chunk but the last,
    so pads lie ahead of valid all-ones keys in every tile; payloads the
    slots' global ids."""
    rng = np.random.default_rng(4)
    words = (np.arange(1, 17, dtype=np.uint64) * (2**32 // 16) - 1) \
        .astype(np.uint32)
    x = words[rng.integers(0, 16, (T, K))]
    counts = rng.integers(Q // 2, Q, (T, K // Q)).astype(np.int32)
    counts[:, -1] = Q
    ids = np.arange(T * K, dtype=np.uint32).reshape(T, K)
    valid = np.arange(K)[None, :] % Q < np.repeat(counts, Q, axis=1)
    return x, ids, counts, valid


def _runs_prefix(out, counts, r):
    """Each tile's runs (tile-major, R runs of S = K) concatenated by
    their counts: the tile's sorted valid prefix."""
    out = out.reshape(T, r, K).numpy().view(np.uint32)
    return [np.concatenate([out[t, d, :counts[t, d]] for d in range(r)])
            for t in range(T)]


@pytest.mark.parametrize("kernel", ["k1", "k1b", "k2", "k9"])
def test_plain_kernels_rank_pads_after_valid_all_ones(kernel):
    """K1, K1b, K2 and K9's plain versions (what the card holds the
    kernels to bit for bit) on tiles whose pads lie ahead of valid
    all-ones keys: each tile's valid prefix holds its valid slots' own
    payloads, in the stable order."""
    x, ids, counts, valid = _tiles()
    want = []
    for t in range(T):
        o = np.argsort(np.where(valid[t], x[t], ONES), kind="stable")
        want.append(ids[t][o[valid[t][o]]])
    slot = np.arange(K)
    for t in range(T):                          # the case this pins
        assert slot[~valid[t]].min() < slot[valid[t] & (x[t] == ONES)].max()
    planes, vals, cin = [_i32(x)], [_i32(ids)], torch.from_numpy(counts)
    if kernel in ("k1", "k1b"):
        r = 16
        kw = dict(r=r, s=K, q_in=Q, t_seg=None)
        if kernel == "k1":
            kw.update(lo_bit=28, width=4)
        else:
            qs = np.sort(x.reshape(-1))[(np.arange(1, r) * T * K) // r]
            kw.update(lo_bit=0, width=1,
                      splitters=_i32(np.tile(qs, (T, 1))),
                      splitter_fracs=torch.full((T, r - 1), 1 << 15,
                                                dtype=torch.int32))
        (_, out), got_counts = tp.partition_pass_fused(
            planes, vals, cin, unstable=True, **kw)
        assert int(got_counts.max()) <= K
        got = _runs_prefix(out, got_counts.numpy(), r)
    elif kernel == "k2":
        n_out = int(counts.sum())
        _, out = tb.sort_tiles_counts_collapsed(planes + vals, cin, Q, n_out)
        got = np.split(out.numpy().view(np.uint32),
                       np.cumsum(counts.sum(axis=1))[:-1])
    else:
        _, out = tb.sort_tiles_counts(planes + vals, cin, Q)
        out = out.numpy().view(np.uint32)
        got = [out[t, :counts[t].sum()] for t in range(T)]
    for t in range(T):
        np.testing.assert_array_equal(got[t], want[t])
