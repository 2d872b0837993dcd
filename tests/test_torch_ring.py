"""K7, ``parallel.ring.ring_all_to_all`` (its plain version, which CPU
tensors take), against the contract of ``tpusort``'s remote-DMA kernel:
on shard r, row s is the window shard s sent to r, ``out[r][s] ==
in[s][r]`` (``tests/test_distributed.py::test_rdma_unit_permutation``, d 8,
window 256), and against ``jax.lax.all_to_all`` of the same windows under
``shard_map`` on the 8-device CPU mesh.  The in-process communicator's
``ring_all_to_all`` and ``all_to_all`` give the same rows.  The CUDA kernel
is checked on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpusort_torch.parallel.comm import InProcessComm
from tpusort_torch.parallel.ring import ring_all_to_all, ring_all_to_all_plain

D, WINDOW = 8, 256


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(32)
    return rng.integers(0, 1 << 32, (D, D, WINDOW), dtype=np.uint64) \
        .astype(np.uint32)


def _sends(data):
    return [torch.from_numpy(data[s].view(np.int32)) for s in range(D)]


def test_plain_is_the_transpose(data):
    sends = _sends(data)
    got = np.stack([ring_all_to_all(sends, r).numpy().view(np.uint32)
                    for r in range(D)])
    np.testing.assert_array_equal(got, np.transpose(data, (1, 0, 2)))
    assert ring_all_to_all.launches == 0      # no kernel on the CPU


def test_matches_jax_all_to_all(data):
    mesh = jax.make_mesh((D,), ("x",))

    def body(x):
        return jax.lax.all_to_all(x[0], "x", 0, 0, tiled=True)[None]

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("x"),
                              out_specs=P("x"), check_vma=False))
    want = np.asarray(f(jnp.asarray(data)))
    sends = _sends(data)
    got = np.stack([ring_all_to_all(sends, r).numpy().view(np.uint32)
                    for r in range(D)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ["ring_all_to_all", "all_to_all"])
def test_in_process_comm_exchange(data, route):
    """Each shard thread hands its send buffer over and gets its rows."""
    comm = InProcessComm(D, "cpu", timeout=60)
    sends = _sends(data)
    got = comm.run(lambda c, x: getattr(c, route)(x),
                   [(s,) for s in sends])
    got = np.stack([g.numpy().view(np.uint32) for g in got])
    np.testing.assert_array_equal(got, np.transpose(data, (1, 0, 2)))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_small_d(d):
    rng = np.random.default_rng(d)
    x = rng.integers(-(1 << 31), 1 << 31, (d, d, 384)).astype(np.int32)
    sends = [torch.from_numpy(x[s]) for s in range(d)]
    for r in range(d):
        np.testing.assert_array_equal(ring_all_to_all(sends, r).numpy(),
                                      x[:, r])
        np.testing.assert_array_equal(
            ring_all_to_all_plain(sends, r).numpy(), x[:, r])


def test_rejects_bad_windows(data):
    sends = _sends(data)
    with pytest.raises(ValueError, match="multiple of 128"):
        ring_all_to_all([s[:, :200].contiguous() for s in sends], 0)
    with pytest.raises(ValueError, match="rank"):
        ring_all_to_all(sends, D)
    with pytest.raises(ValueError, match="int32"):
        ring_all_to_all([s.float() for s in sends], 0)
    with pytest.raises(ValueError, match="int32"):
        ring_all_to_all(sends[:-1], 0)
