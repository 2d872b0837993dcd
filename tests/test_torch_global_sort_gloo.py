"""The global sort over ``ProcessGroupComm``: 8 processes, one shard each,
joined by ``torch.distributed`` over gloo on the CPU, against
``tpusort.parallel.global_sort`` on the 8-device CPU mesh with the same
numpy inputs.  The ranks are spawned once for the module and run every
case; each writes its output shards, and the tests compare them.
``exchange="rdma"`` must raise on a process group.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusort.parallel import global_sort as jgs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 8
DEADLINE = 240           # seconds for all ranks: spawn, cases, teardown

# inputs, made alike in the parent and in every rank from one seed
_INPUTS = """
import numpy as np

def inputs():
    rng = np.random.default_rng(70)
    n = 1 << 14
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    low = np.bitwise_and(keys, rng.integers(0, 1 << 32, n, dtype=np.uint64)
                         .astype(np.uint32))
    return {
        "uniform": (keys, None, {}),
        "pairs_chunks2": (low, np.arange(n, dtype=np.uint32), {"chunks": 2}),
        "presorted": (np.sort(keys), None, {"capacity_factor": 1.0}),
        "u64_planes": ((rng.integers(0, 3, n).astype(np.uint32), keys),
                       None, {}),
    }
"""

_WORKER = _INPUTS + """
import sys
from datetime import timedelta

import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=120))
from tpusort_torch.parallel import (
    ProcessGroupComm, make_global_sort, make_global_sort_planes)

comm = ProcessGroupComm()
res = {}
for name, (x, v, kw) in inputs().items():
    if isinstance(x, tuple):
        n_shard = x[0].shape[0] // world
        sl = slice(rank * n_shard, (rank + 1) * n_shard)
        out_planes = make_global_sort_planes(comm, **kw)(
            tuple(torch.from_numpy(p[sl].copy()) for p in x))
        for i, p in enumerate(out_planes):
            res[f"{name}.{i}"] = p.numpy()
        continue
    n_shard = x.shape[0] // world
    sl = slice(rank * n_shard, (rank + 1) * n_shard)
    sorter = make_global_sort(comm, **kw)
    if v is None:
        res[name] = sorter(torch.from_numpy(x[sl].copy())).numpy()
    else:
        k, w = sorter(torch.from_numpy(x[sl].copy()),
                      torch.from_numpy(v[sl].copy()))
        res[name], res[name + ".v"] = k.numpy(), w.numpy()
try:
    make_global_sort(comm, exchange="rdma")
    res["rdma_raised"] = np.array(False)
except NotImplementedError:
    res["rdma_raised"] = np.array(True)
t = torch.tensor([rank, -rank], dtype=torch.int64)
res["sum"] = comm.all_reduce_sum(t).numpy()
res["max"] = comm.all_reduce_max(t).numpy()
res["gather"] = comm.all_gather(t).numpy()
res["a2a"] = comm.all_to_all(torch.arange(world) * 100 + rank).numpy()
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""

ns = {}
exec(_INPUTS, ns)
INPUTS = ns["inputs"]()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the 8 ranks once; return each rank's outputs."""
    out = tmp_path_factory.mktemp("gloo")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(D), str(port), str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(D)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DEADLINE)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-2000:]) for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(D)]


@pytest.fixture(scope="module")
def jax_out():
    mesh = jax.make_mesh((D,), ("x",))
    out = {}
    for name, (x, v, kw) in INPUTS.items():
        if isinstance(x, tuple):
            res = jgs.make_global_sort_planes(mesh, **kw)(
                tuple(jnp.asarray(p) for p in x))
        else:
            s = jgs.make_global_sort(mesh, **kw)
            res = s(jnp.asarray(x)) if v is None else \
                s(jnp.asarray(x), jnp.asarray(v))
        out[name] = jax.tree.map(np.asarray, res)
    return out


def _joined(ranks, key):
    return np.concatenate([r[key] for r in ranks])


@pytest.mark.parametrize("name", ["uniform", "presorted"])
def test_keys(ranks, jax_out, name):
    np.testing.assert_array_equal(_joined(ranks, name), jax_out[name])


def test_pairs_chunked(ranks, jax_out):
    x, _, _ = INPUTS["pairs_chunks2"]
    gk = _joined(ranks, "pairs_chunks2")
    gv = _joined(ranks, "pairs_chunks2.v")
    jk, jv = jax_out["pairs_chunks2"]
    np.testing.assert_array_equal(gk, jk)
    # unstable: a permutation of JAX's payloads within each key run
    np.testing.assert_array_equal(gv[np.lexsort((gv, gk))],
                                  jv[np.lexsort((jv, jk))])
    np.testing.assert_array_equal(x[gv.astype(np.int64)], gk)


def test_u64_planes(ranks, jax_out):
    for i in range(2):
        np.testing.assert_array_equal(_joined(ranks, f"u64_planes.{i}"),
                                      jax_out["u64_planes"][i])


def test_collectives_and_rdma(ranks):
    for r, res in enumerate(ranks):
        assert bool(res["rdma_raised"])
        assert res["sum"].tolist() == [28, -28]
        assert res["max"].tolist() == [7, 0]
        assert res["gather"].tolist() == [[s, -s] for s in range(D)]
        assert res["a2a"].tolist() == [s + 100 * r for s in range(D)]
