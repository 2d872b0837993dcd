"""The global sort of ``tpusort_torch.parallel`` on ``InProcessComm(8,
"cpu")`` against ``tpusort.parallel.global_sort`` on the 8-device CPU mesh,
same numpy inputs: pairs (unstable across shards, so payloads compare as
a permutation within equal keys, ``tpusort/parallel/global_sort.py:41-43``),
the chunked exchange, 64-bit keys as a dtype and as planes, the adaptive
capacity, and one shard.  The JAX outputs are computed once, in a module
fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusort.parallel import global_sort as jgs
from tpusort_torch.parallel import (
    InProcessComm, make_global_sort, make_global_sort_planes)
from tpusort_torch.utils.datagen import entropy_keys, random_keys, zipf_keys

D = 8


def _comm(d=D):
    return InProcessComm(d, "cpu", timeout=60)


def _inputs():
    rng = np.random.default_rng(60)
    n = 1 << 14
    v = np.arange(n, dtype=np.uint32)
    return {
        "pairs": (entropy_keys(rng, n, 2), v, {}),
        "chunks4": (entropy_keys(rng, n, 2), None, {"chunks": 4}),
        "chunked_pairs": (zipf_keys(rng, n, alpha=1.2, dtype=np.uint32), v,
                          {"chunks": 2}),
        "u64": (random_keys(rng, n, np.uint64), None, {}),
    }


def _plane_inputs():
    rng = np.random.default_rng(61)
    n = 1 << 14
    i64 = rng.integers(-(1 << 62), 1 << 62, n // 2, dtype=np.int64)
    return {
        "u64_planes": (rng.integers(0, 3, n).astype(np.uint32),
                       random_keys(rng, n), None, "uint64", False),
        "i64_planes_desc": ((i64.view(np.uint64) >> np.uint64(32))
                            .astype(np.uint32),
                            i64.view(np.uint32)[0::2].copy(), None, "int64",
                            True),
        "u64_pairs": (rng.integers(0, 5, n // 2).astype(np.uint32),
                      rng.integers(0, 1 << 16, n // 2).astype(np.uint32),
                      np.arange(n // 2, dtype=np.uint32), "uint64", False),
    }


INPUTS = _inputs()
PLANES = _plane_inputs()


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((D,), ("x",))


@pytest.fixture(scope="module")
def jax_out(mesh):
    out = {}
    for name, (x, v, kw) in INPUTS.items():
        s = jgs.make_global_sort(mesh, **kw)
        res = s(jnp.asarray(x)) if v is None else \
            s(jnp.asarray(x), jnp.asarray(v))
        out[name] = jax.tree.map(np.asarray, res)
    for name, (hi, lo, v, kd, desc) in PLANES.items():
        s = jgs.make_global_sort_planes(mesh, key_dtype=kd)
        ps = (jnp.asarray(hi), jnp.asarray(lo))
        res = s(ps, descending=desc) if v is None else \
            s(ps, jnp.asarray(v), descending=desc)
        out[name] = jax.tree.map(np.asarray, res)
    return out


def _same_pairs(gk, gv, jk, jv):
    """Keys equal; payloads a permutation of JAX's within each run of
    equal keys."""
    np.testing.assert_array_equal(gk, jk)
    og, oj = np.lexsort((gv, gk)), np.lexsort((jv, jk))
    np.testing.assert_array_equal(gv[og], jv[oj])


@pytest.mark.parametrize("name", list(INPUTS))
def test_keys_and_pairs_match_tpusort(name, jax_out):
    x, v, kw = INPUTS[name]
    sorter = make_global_sort(_comm(), **kw)
    if v is None:
        got = sorter(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), jax_out[name])
        return
    gk, gv = sorter(torch.from_numpy(x), torch.from_numpy(v))
    jk, jv = jax_out[name]
    _same_pairs(gk.numpy(), gv.numpy(), jk, jv)
    np.testing.assert_array_equal(x[gv.numpy().astype(np.int64)], gk.numpy())


@pytest.mark.parametrize("name", list(PLANES))
def test_planes_match_tpusort(name, jax_out):
    hi, lo, v, kd, desc = PLANES[name]
    sorter = make_global_sort_planes(_comm(), key_dtype=kd)
    ps = (torch.from_numpy(hi), torch.from_numpy(lo))
    if v is None:
        got, want = sorter(ps, descending=desc), jax_out[name]
    else:
        got, gv = sorter(ps, torch.from_numpy(v), descending=desc)
        want, jv = jax_out[name]
    assert all(p.dtype == torch.uint32 for p in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if v is not None:
        key = (got[0].numpy().astype(np.uint64) << np.uint64(32)) \
            | got[1].numpy()
        jkey = (want[0].astype(np.uint64) << np.uint64(32)) | want[1]
        _same_pairs(key, gv.numpy(), jkey, jv)


def test_64bit_values_ride():
    """64-bit payloads travel as two words (JAX's sorter takes 32-bit
    payloads only): keys exact, each value with its key."""
    rng = np.random.default_rng(62)
    x = entropy_keys(rng, 1 << 14, 3)
    v = rng.integers(-(1 << 62), 1 << 62, 1 << 14, dtype=np.int64)
    gk, gv = make_global_sort(_comm())(torch.from_numpy(x),
                                       torch.from_numpy(v))
    assert gv.dtype == torch.int64
    _same_pairs(gk.numpy(), gv.numpy(), *map(
        np.asarray, (x[np.argsort(x, kind="stable")],
                     v[np.argsort(x, kind="stable")])))


def test_adaptive_capacity_matches_tpusort(mesh):
    """Presorted keys at capacity factor 1.0 overflow every call until
    the doubled factor saturates the capacity at n_shard; the capacities
    the two packages choose call by call are the same, and every call is
    exact."""
    n = 1 << 13
    keys = np.arange(n, dtype=np.uint32)
    js = jgs.make_global_sort(mesh, capacity_factor=1.0, adaptive=True)
    ts = make_global_sort(_comm(), capacity_factor=1.0, adaptive=True)
    jcaps, tcaps = [], []
    for _ in range(4):
        np.testing.assert_array_equal(np.asarray(js(jnp.asarray(keys))),
                                      keys)
        np.testing.assert_array_equal(ts(torch.from_numpy(keys)).numpy(),
                                      keys)
        jcaps.append(max(g[-1] for g in js._shard_fns))
        tcaps.append(max(g[-1] for g in ts._shard_fns))
    assert tcaps == jcaps and tcaps[-1] == n // D, tcaps
    assert ts._factors == js._factors
    n_fns = len(ts._shard_fns)
    ts(torch.from_numpy(keys))
    assert len(ts._shard_fns) == n_fns
    # the planes sorter adapts alike
    ps = make_global_sort_planes(_comm(), key_dtype="uint64",
                                 capacity_factor=1.0, adaptive=True)
    ohi, olo = ps((torch.zeros(n, dtype=torch.int32).view(torch.uint32),
                   torch.from_numpy(keys)))
    np.testing.assert_array_equal(olo.numpy(), keys)
    assert int(ohi.view(torch.int32).abs().sum()) == 0 and ps._factors


def test_one_shard_is_the_local_sort():
    """d == 1 sorts locally (JAX: a one-device mesh)."""
    rng = np.random.default_rng(7)
    hi, lo = random_keys(rng, 4096), random_keys(rng, 4096)
    mesh1 = jax.make_mesh((1,), ("x",))
    jhi, jlo = jgs.make_global_sort_planes(mesh1, key_dtype="uint64")(
        (jnp.asarray(hi), jnp.asarray(lo)))
    thi, tlo = make_global_sort_planes(_comm(1), key_dtype="uint64")(
        (torch.from_numpy(hi), torch.from_numpy(lo)))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    x = random_keys(rng, 5000)
    v = np.arange(5000, dtype=np.uint32)
    gk, gv = make_global_sort(_comm(1))(torch.from_numpy(x),
                                        torch.from_numpy(v))
    np.testing.assert_array_equal(gk.numpy(), np.sort(x))
    np.testing.assert_array_equal(x[gv.numpy().astype(np.int64)], gk.numpy())


def test_bad_arguments():
    with pytest.raises(ValueError, match="exchange"):
        make_global_sort(_comm(), exchange="nccl")
    with pytest.raises(ValueError, match="finish"):
        make_global_sort(_comm(), finish="merge")
    with pytest.raises(ValueError, match="divisible"):
        make_global_sort(_comm())(torch.arange(1001, dtype=torch.int32))
    with pytest.raises(ValueError, match="planes"):
        make_global_sort_planes(_comm())((torch.zeros(16, dtype=torch.int32),))
