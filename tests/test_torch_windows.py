"""The sorted-window finish of the port against ``tpusort``: K1 with
``sorted_run == K`` (pass 0 of the finish, which only emits: every tile is
one sorted run) against the Pallas kernel in interpret mode, and
``ops.msd.sort_windows_msd`` against JAX's at the geometry of
``tests/test_distributed.py::test_windows_engine_direct`` (8 windows of
2048, K 2048, R 16, S1 256), plus the geometries that have no plan.
Inputs are numpy arrays from a seed; K1 is compared on its counts and the
slots they mark valid, the finish on its dense output (keys bit for bit,
unstable payloads riding with their keys).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusort.kernels import partition as jp
from tpusort.ops import msd as jm
from tpusort_torch.kernels import partition as tp
from tpusort_torch.ops import msd as tm

D, WINDOW, K, R, S1 = 8, 2048, 2048, 16, 256
PLAN_KW = {"k": K, "r": R, "s1": S1}


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _unique(rng, n):
    """n distinct uint32 keys spread over the whole range."""
    x = rng.permutation(n).astype(np.uint64) * np.uint64(0x9E3779B1)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _windows(seed, unique=False, lo=700, hi=1025):
    """D windows of WINDOW slots: a sorted valid prefix of 700-1024 keys,
    then garbage (0xDEADBEEF); payloads number the valid slots.  Returns
    (keys, values, counts)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(lo, hi, D).astype(np.int32)
    pool = _unique(rng, int(counts.sum())) if unique else \
        rng.integers(0, 1 << 32, int(counts.sum()), dtype=np.uint64) \
        .astype(np.uint32)
    keys = np.full((D, WINDOW), 0xDEADBEEF, np.uint32)
    vals = np.zeros((D, WINDOW), np.uint32)
    at = 0
    for w, c in enumerate(counts):
        keys[w, :c] = np.sort(pool[at:at + c])
        vals[w, :c] = np.arange(at, at + c, dtype=np.uint32)
        at += c
    return keys, vals, counts


def _windows_plan(n):
    plan = tm.plan_msd(n, 0, 32, t1_force=D * WINDOW // K, **PLAN_KW)
    assert plan is not None and plan.m1 == D * WINDOW
    return plan


def _valid(counts, spec):
    c = np.minimum(counts, spec.s).reshape(
        spec.n_seg, spec.t_seg, spec.r).transpose(0, 2, 1)
    return (np.arange(spec.s) < c[..., None]).reshape(-1)


@pytest.mark.parametrize("with_value", [False, True])
def test_k1_emit_only_matches_pallas(with_value):
    """K1 at the windows finish's pass 0: validity from one count a tile
    (q_in = K), the tile one sorted run (sorted_run = K), so the network is
    skipped and the kernel only cuts and emits."""
    keys, vals, counts = _windows(1, unique=True)
    spec = _windows_plan(int(counts.sum())).passes[0]
    T = D * WINDOW // K
    cin = counts.reshape(T, 1)
    kw = dict(r=spec.r, s=spec.s, lo_bit=spec.lo_bit, width=spec.width,
              q_in=K, sorted_run=K, t_seg=spec.t_seg,
              unstable=with_value)
    jv = [jnp.asarray(vals.reshape(T, K))] if with_value else []
    j_out, j_cnt = jp.partition_pass_fused(
        [jnp.asarray(keys.reshape(T, K))], jv, jnp.asarray(cin),
        interpret=True, **kw)
    tv = [_i32(vals.reshape(T, K))] if with_value else []
    t_out, t_cnt = tp.partition_pass_fused(
        [_i32(keys.reshape(T, K))], tv, torch.from_numpy(cin), **kw)
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))
    assert int(t_cnt.sum()) == int(counts.sum())
    m = _valid(t_cnt.numpy(), spec)
    for t, j in zip(t_out, j_out):
        np.testing.assert_array_equal(t.numpy().view(np.uint32)[m],
                                      np.asarray(j)[m])


def test_sort_windows_msd_matches_tpusort():
    keys, vals, counts = _windows(30)
    n = int(counts.sum())
    res = jm.sort_windows_msd(
        (jnp.asarray(keys.reshape(-1)),), (jnp.asarray(vals.reshape(-1)),),
        window_counts=jnp.asarray(counts), window=WINDOW, n=n,
        total_bits=32, plan_kwargs=PLAN_KW)
    assert res is not None
    (jk, jv), jovf = res
    got = tm.sort_windows_msd(
        (_i32(keys.reshape(-1)),), (_i32(vals.reshape(-1)),),
        window_counts=torch.from_numpy(counts), window=WINDOW, n=n,
        total_bits=32, plan_kwargs=PLAN_KW)
    assert got is not None
    (tk, tv), tovf = got
    assert not bool(tovf) and not bool(np.asarray(jovf))
    tk, tv = tk.numpy().view(np.uint32), tv.numpy().view(np.uint32)
    np.testing.assert_array_equal(tk, np.asarray(jk))
    all_k = np.concatenate([keys[w, :c] for w, c in enumerate(counts)])
    np.testing.assert_array_equal(tk, np.sort(all_k))
    # unstable payloads: a permutation of the valid ones, each with its key
    np.testing.assert_array_equal(np.sort(tv), np.arange(n))
    np.testing.assert_array_equal(all_k[tv.astype(np.int64)], tk)
    np.testing.assert_array_equal(np.sort(np.asarray(jv)), np.arange(n))


def test_sort_windows_msd_keys_only_through_emit_only_pass():
    """Keys only, with windows that end in all-ones keys (which tie the
    invalid-slot sentinel): exact, and pass 0 ran with sorted_run = K."""
    keys, _, counts = _windows(31)
    keys[3, counts[3] - 5:counts[3]] = 0xFFFFFFFF
    n = int(counts.sum())
    seen = []
    real = tm.partition_pass_fused

    def spy(*a, **kw):
        seen.append(kw.get("sorted_run"))
        return real(*a, **kw)

    tm.partition_pass_fused = spy
    try:
        (tk,), tovf = tm.sort_windows_msd(
            (_i32(keys.reshape(-1)),), (),
            window_counts=torch.from_numpy(counts), window=WINDOW, n=n,
            total_bits=32, plan_kwargs=dict(PLAN_KW, min_n=4096))
    finally:
        tm.partition_pass_fused = real
    plan = _windows_plan(n)
    assert seen == [K] + [p.s & -p.s for p in plan.passes[:-1]]
    assert not bool(tovf)
    all_k = np.concatenate([keys[w, :c] for w, c in enumerate(counts)])
    np.testing.assert_array_equal(tk.numpy().view(np.uint32), np.sort(all_k))


def test_sort_windows_msd_no_plan():
    """None where the geometry admits no windows plan, as JAX's
    (``tpusort/ops/msd.py:954-960``)."""
    keys, _, counts = _windows(32)
    flat = _i32(keys.reshape(-1))
    wc = torch.from_numpy(counts)
    n = int(counts.sum())
    kw = dict(window_counts=wc, n=n, plan_kwargs=PLAN_KW)
    # two planes whose total_bits is not 64
    assert tm.sort_windows_msd((flat, flat), (), window=WINDOW,
                               total_bits=32, **kw) is None
    # a window that is not a whole number of tiles
    assert tm.sort_windows_msd((flat[:D * 1920],), (), window=1920,
                               total_bits=32, **kw) is None
    # a layout shorter than one window
    assert tm.sort_windows_msd((flat[:K],), (), window=2 * K,
                               total_bits=32, **kw) is None
    # and JAX's agrees on each
    for planes, window in (((keys.reshape(-1),) * 2, WINDOW),
                           ((keys.reshape(-1)[:D * 1920],), 1920),
                           ((keys.reshape(-1)[:K],), 2 * K)):
        assert jm.sort_windows_msd(
            tuple(jnp.asarray(p) for p in planes), (),
            window_counts=jnp.asarray(counts), window=window, n=n,
            total_bits=32, plan_kwargs=PLAN_KW) is None
