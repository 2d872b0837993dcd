"""``tpusort_torch.parallel``'s global sort on ``InProcessComm(8, "cpu")``
against ``tpusort.parallel.global_sort`` on the 8-device CPU mesh
(``tests/conftest.py``), with the same numpy inputs: 32-bit keys
(uniform, int32, float32, descending, entropy 4 and 0, Zipf, presorted at
capacity factor 1.0, which overflows the exchange), the splitter selection
and the runs' destinations under ``shard_map``, the windows finish and the
K7 exchange end to end, and the communicator's failure modes.  Keys
compare bit for bit.  The JAX outputs are computed once, in a module
fixture.  64-bit keys, pairs, chunks and the adaptive capacity are in
``test_torch_global_sort_planes.py``.
"""

import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpusort.parallel import global_sort as jgs
from tpusort_torch.ops import msd as tm
from tpusort_torch.parallel import InProcessComm, make_global_sort
from tpusort_torch.utils.datagen import entropy_keys, random_keys, zipf_keys

# the module (the package's name ``global_sort`` is the function)
tgs = importlib.import_module("tpusort_torch.parallel.global_sort")
D = 8


def _inputs():
    rng = np.random.default_rng(40)
    return {
        "uniform": (random_keys(rng, 1 << 16), {}),
        "int32": (random_keys(rng, 1 << 14, np.int32), {}),
        "float32": (random_keys(rng, 1 << 14, np.float32), {}),
        "descending": (random_keys(rng, 1 << 14),
                       {"descending": True}),
        "entropy4": (entropy_keys(rng, 1 << 15, 4), {}),
        "entropy0": (entropy_keys(rng, 1 << 15, 0), {}),
        "zipf": (zipf_keys(rng, 1 << 14, alpha=1.2, dtype=np.uint32), {}),
        "presorted": (np.sort(random_keys(rng, 1 << 14)),
                      {"capacity_factor": 1.0}),
    }


INPUTS = _inputs()


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((D,), ("x",))


@pytest.fixture(scope="module")
def jax_out(mesh):
    """Every case through the JAX package, one sorter per capacity factor
    so cases of one geometry share a compiled shard body."""
    sorters = {}
    out = {}
    for name, (x, kw) in INPUTS.items():
        kw = dict(kw)
        desc = kw.pop("descending", False)
        f = kw.get("capacity_factor", 4.0)
        if f not in sorters:
            sorters[f] = jgs.make_global_sort(mesh, capacity_factor=f)
        out[name] = np.asarray(sorters[f](jnp.asarray(x), descending=desc))
    return out


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("name", list(INPUTS))
def test_keys_match_tpusort(name, jax_out):
    x, kw = INPUTS[name]
    kw = dict(kw)
    desc = kw.pop("descending", False)
    tm.reset_counters()
    got = make_global_sort(InProcessComm(D, "cpu", timeout=60), **kw)(
        torch.from_numpy(x), descending=desc)
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == x.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(jax_out[name]))
    # presorted keys, and constant keys (every shard's copies stay on it,
    # by their tie quotas), overflow the exchange's windows
    assert tm.counters()["exchange_fallbacks"] == int(
        name in ("presorted", "entropy0"))


@pytest.mark.parametrize("kw", [
    dict(finish="windows"),
    dict(finish="windows", exchange="rdma"),
    dict(finish="collapse", exchange="rdma"),
    dict(finish="windows", capacity_factor=2.0, chunks=2),
], ids=["windows", "windows-rdma", "collapse-rdma", "windows-2.0-chunks2"])
def test_windows_and_rdma(kw, jax_out):
    """The sorted-window finish and the K7 exchange at a geometry that
    plans (2^16 keys, 8192 a shard, the CPU row's K 2048), keys only and
    with payloads, against JAX's collapse finish of the same keys.
    ``finish="windows"`` raises where it has no plan, so passing proves the
    finish ran."""
    x = INPUTS["uniform"][0]
    sorter = make_global_sort(InProcessComm(D, "cpu", timeout=60), **kw)
    got = sorter(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), jax_out["uniform"])
    v = np.arange(x.shape[0], dtype=np.uint32)
    gk, gv = sorter(torch.from_numpy(x), torch.from_numpy(v))
    gk, gv = gk.numpy(), gv.numpy().astype(np.int64)
    np.testing.assert_array_equal(gk, jax_out["uniform"])
    np.testing.assert_array_equal(x[gv], gk)
    np.testing.assert_array_equal(np.sort(gv), np.arange(x.shape[0]))
    geoms = list(sorter._shard_fns)
    if kw.get("finish") == "windows":
        # the capacity is a whole number of engine tiles
        assert all(g[-1] % 2048 == 0 for g in geoms), geoms


def test_windows_without_plan_raises():
    x = random_keys(np.random.default_rng(26), 1 << 12)
    sorter = make_global_sort(InProcessComm(D, "cpu", timeout=60),
                              finish="windows")
    with pytest.raises(ValueError, match="sorted-window"):
        sorter(torch.from_numpy(x))
    # "auto" on the CPU takes the collapse finish
    got = make_global_sort(InProcessComm(D, "cpu", timeout=60))(
        torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.sort(x))


@pytest.mark.parametrize("nplanes,entropy", [(1, 1), (1, 3), (2, 2)])
def test_splitters_and_destinations_match_tpusort(mesh, nplanes, entropy):
    """The exact splitters, the keys below them, and each shard's run
    starts and lengths, from the same locally sorted shards."""
    n_shard = 1 << 11
    rng = np.random.default_rng(50 + entropy)
    planes = [entropy_keys(rng, D * n_shard, entropy)
              for _ in range(nplanes)]
    if nplanes == 2:
        planes[0] &= np.uint32(3)           # a skewed high word
    shards = []
    for r in range(D):
        sl = slice(r * n_shard, (r + 1) * n_shard)
        order = np.lexsort([p[sl] for p in planes][::-1])
        shards.append([p[sl][order] for p in planes])
    sorted_planes = [np.concatenate([s[i] for s in shards])
                     for i in range(nplanes)]

    def body(*ps):
        spl, below = jgs._select_splitters(ps, n_shard, D, "x")
        starts, counts = jgs._destinations_sorted(ps, spl, below, n_shard,
                                                  D, "x")
        return (*[s[None] for s in spl], below[None], starts[None],
                counts[None])

    f = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=tuple(P("x") for _ in planes),
        out_specs=tuple(P("x") for _ in range(nplanes + 3)),
        check_vma=False))
    *j_spl, j_below, j_starts, j_counts = [
        np.asarray(o) for o in f(*map(jnp.asarray, sorted_planes))]

    def port(comm, ps):
        comp = tgs._composite([tgs._u32(p) for p in ps])
        spl, below = tgs._select_splitters(comm, comp, nplanes, n_shard)
        starts, counts = tgs._destinations_sorted(comm, comp, spl, below,
                                                  n_shard)
        return spl, below, starts, counts

    res = InProcessComm(D, "cpu", timeout=60).run(
        port, [([torch.from_numpy(p.view(np.int32)) for p in s],)
               for s in shards])
    for r, (spl, below, starts, counts) in enumerate(res):
        for i in range(nplanes):
            np.testing.assert_array_equal(spl[i].numpy().view(np.uint32),
                                          j_spl[i][r])
        np.testing.assert_array_equal(below.numpy(), j_below[r])
        np.testing.assert_array_equal(starts.numpy(), j_starts[r])
        np.testing.assert_array_equal(counts.numpy(), j_counts[r])
        assert int(counts.sum()) == n_shard


def test_in_process_comm_shard_error_aborts_the_others():
    """One shard raising breaks the barrier: the others stop waiting, and
    run raises that shard's own exception at once."""
    comm = InProcessComm(4, "cpu", timeout=30)

    def body(c, x):
        c.all_reduce_sum(x)
        if c.rank == 2:
            raise KeyError("shard 2")
        return c.all_reduce_sum(x)

    with pytest.raises(KeyError, match="shard 2"):
        comm.run(body, [(torch.ones(3),)] * 4)


def test_in_process_comm_barrier_timeout():
    """A shard that never reaches the collective: the barrier's timeout
    breaks it for the others, and run gives up on the stuck shard after
    the same timeout instead of waiting for it."""
    comm = InProcessComm(3, "cpu", timeout=0.5)
    never = threading.Event()

    def body(c, x):
        if c.rank == 0:
            never.wait(5)
            return x
        return c.all_gather(x)

    with pytest.raises((threading.BrokenBarrierError, TimeoutError)):
        comm.run(body, [(torch.ones(2),)] * 3)
    never.set()


def test_collectives():
    comm = InProcessComm(3, "cpu", timeout=30)

    def body(c, x):
        return (c.all_reduce_sum(x), c.all_reduce_max(x), c.all_gather(x),
                c.all_to_all(torch.arange(3) * 10 + c.rank))

    res = comm.run(body, [(torch.tensor([r, -r]),) for r in range(3)])
    for r, (s, m, g, a) in enumerate(res):
        assert s.tolist() == [3, -3] and m.tolist() == [2, 0]
        assert g.tolist() == [[0, 0], [1, -1], [2, -2]]
        assert a.tolist() == [10 * r, 10 * r + 1, 10 * r + 2]


@pytest.mark.parametrize("base,top", [
    (0, 0xFFFFFFFF), (0x12345678, 0x12345678), (7, 8), (0, 1 << 29),
    ((1 << 29) - 5, 1 << 30), (0x80000000, 0x80000000 + (1 << 29) + 1),
    (0xFFFFFF00, 0xFFFFFFFF)])
def test_range_normalisation(base, top):
    """The finish's key map: monotone and one to one on [base, top], undone
    exactly, and its image spans nearly the whole 32-bit domain (JAX's
    shift alone leaves half of it empty where the width lies just above a
    power of two)."""
    rng = np.random.default_rng(base % 1000)
    k = np.unique(np.concatenate([
        rng.integers(base, top + 1, 5000, dtype=np.uint64),
        [base, top, min(base + 1, top), max(top - 1, base)]]))
    k = torch.from_numpy(k.astype(np.uint32).view(np.int32))
    norm = tgs._norm_params([base, top], 1, 3)
    kn = tgs._u32(tgs._normalise(k, *norm))
    assert bool((kn[1:] > kn[:-1]).all())
    assert torch.equal(tgs._denormalise(tgs._i32(kn), *norm), k)
    if top - base >= 1 << 16:
        assert int(kn[-1]) >= 0xFFFF0000 * (top - base) // (top - base + 1)
