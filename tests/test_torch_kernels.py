"""The port's K1 and K2 (their plain PyTorch versions, which CPU tensors
take) against the Pallas kernels in interpret mode, bit for bit.

K1 is compared on its counts and on every slot the counts mark valid (pad
slots are unspecified); K2 on its dense output.  Inputs are numpy arrays
from a seed.  The CUDA kernels themselves are checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusort.kernels import bitonic as jb
from tpusort.kernels import partition as jp
from tpusort_torch.kernels import bitonic as tb
from tpusort_torch.kernels import partition as tp


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _sorted_chunks(rng, T, K, q):
    """(T, K) keys whose chunks of q hold a sorted valid prefix of
    counts[t, i] keys followed by garbage, and those (T, K // q) counts."""
    x = rng.integers(0, 2**32, (T, K), dtype=np.uint32)
    counts = rng.integers(0, q + 1, (T, K // q)).astype(np.int32)
    for t in range(T):
        for i in range(K // q):
            c = counts[t, i]
            x[t, i * q: i * q + c] = np.sort(x[t, i * q: i * q + c])
    return x, counts


def _valid_slots(counts, T, r, s, t_seg):
    """Valid-slot mask of the runs, in the layout the pass wrote."""
    c = np.minimum(counts, s)
    if t_seg is not None:
        c = c.reshape(T // t_seg, t_seg, r).transpose(0, 2, 1)
    return (np.arange(s) < c[..., None]).reshape(-1)


@pytest.mark.parametrize("t_seg", [None, 2])
def test_partition_pass0_matches_pallas(t_seg):
    rng = np.random.default_rng(6)
    T, K, R, S = 2, 512, 8, 256
    x = rng.integers(0, 2**32, (T, K), dtype=np.uint32)
    n = T * K - 333
    kw = dict(r=R, s=S, lo_bit=29, width=3, n=n, t_seg=t_seg)
    (jdata,), jcounts = jp.partition_pass_fused(
        [jnp.asarray(x)], [], None, interpret=True, **kw)
    (tdata,), tcounts = tp.partition_pass_fused([_i32(x)], [], None, **kw)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert int(tcounts.sum()) == n
    m = _valid_slots(np.asarray(jcounts), T, R, S, t_seg)
    np.testing.assert_array_equal(
        tdata.numpy().reshape(-1).view(np.uint32)[m],
        np.asarray(jdata).reshape(-1)[m])


def test_partition_counts_chain_matches_pallas():
    """A later pass: validity from counts_in/q_in, tile made of sorted
    subruns (sorted_run), exchanged output."""
    rng = np.random.default_rng(9)
    T, K, R, S, q = 4, 512, 8, 128, 128
    x, cin = _sorted_chunks(rng, T, K, q)
    kw = dict(r=R, s=S, lo_bit=20, width=3, q_in=q, sorted_run=q, t_seg=2)
    (jdata,), jcounts = jp.partition_pass_fused(
        [jnp.asarray(x)], [], jnp.asarray(cin), interpret=True, **kw)
    (tdata,), tcounts = tp.partition_pass_fused(
        [_i32(x)], [], torch.from_numpy(cin), **kw)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert int(tcounts.sum()) == int(cin.sum())
    m = _valid_slots(np.asarray(jcounts), T, R, S, 2)
    np.testing.assert_array_equal(
        tdata.numpy().view(np.uint32)[m], np.asarray(jdata)[m])


@pytest.mark.parametrize("K,q,sorted_run", [
    (256, 128, 0),          # as tests/test_kernels.py
    (384, 128, 128),        # 3 * 2^7: the Pallas staged f*2^a merge
])
def test_leaf_collapse_matches_pallas(K, q, sorted_run):
    rng = np.random.default_rng(13 + K)
    T = 2
    x, counts = _sorted_chunks(rng, T, K, q)
    n_out = int(counts.sum())
    want = jb.sort_tiles_counts_collapsed(
        jnp.asarray(x), jnp.asarray(counts), q, n_out,
        sorted_run=sorted_run, interpret=True)
    got = tb.sort_tiles_counts_collapsed(
        _i32(x), torch.from_numpy(counts), q, n_out, sorted_run=sorted_run)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def test_leaf_collapse_list_form():
    rng = np.random.default_rng(3)
    x, counts = _sorted_chunks(rng, 3, 256, 128)
    n_out = int(counts.sum())
    (got,) = tb.sort_tiles_counts_collapsed(
        [_i32(x)], torch.from_numpy(counts), 128, n_out)
    single = tb.sort_tiles_counts_collapsed(
        _i32(x), torch.from_numpy(counts), 128, n_out)
    assert torch.equal(got, single)


@pytest.mark.parametrize("k", [256, 384, 640, 1536, 2048, 3072, 24576,
                               5120, 40960, 1000])
def test_merge_staged_factor_matches(k):
    assert tb.merge_staged_factor(k) == jb.merge_staged_factor(k)


def test_unported_modes_raise():
    x = torch.zeros(2, 512, dtype=torch.int32)
    kw = dict(r=8, s=256, lo_bit=29, width=3, n=1024)
    with pytest.raises(NotImplementedError, match="item 5"):
        tp.partition_pass_fused([x], [], None, digit=x, **kw)
    with pytest.raises(NotImplementedError, match="item 7"):
        tp.partition_pass_fused([x], [], None, splitters=x, **kw)
    with pytest.raises(NotImplementedError, match="item 4"):
        tp.partition_pass_fused([x], [x], None, unstable=True, **kw)
    with pytest.raises(NotImplementedError, match="item 4"):
        tp.partition_pass_fused([x, x], [], None, **kw)
    c = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 4"):
        tb.sort_tiles_counts_collapsed([x, x], c, 128, 10)


def test_bad_geometry_raises():
    x = torch.zeros(2, 384, dtype=torch.int32)
    with pytest.raises(ValueError):
        tp.partition_pass_fused([x], [], None, r=8, s=128, lo_bit=29,
                                width=3, n=10)
    with pytest.raises(ValueError):
        tp.partition_pass_fused([x.view(torch.uint32)], [], None, r=8,
                                s=128, lo_bit=29, width=3, n=10)
    x = torch.zeros(2, 512, dtype=torch.int32)
    for lo_bit, width in ((29, 4), (30, 3), (0, 0)):   # digit past R or key
        with pytest.raises(ValueError, match="digit bits"):
            tp.partition_pass_fused([x], [], None, r=8, s=128,
                                    lo_bit=lo_bit, width=width, n=10)
    with pytest.raises(ValueError):
        tb.sort_tiles_counts_collapsed(x, torch.zeros(2, 1, dtype=torch.int32),
                                       0, 10)


def test_no_plain_route_off_the_cpu():
    """Only CPU tensors take the plain versions; any other device launches
    a kernel or raises, and the CPU route counts no launch."""
    x = torch.zeros(2, 512, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        tp.partition_pass_fused([x], [], None, r=8, s=256, lo_bit=29,
                                width=3, n=1024)
    c = torch.zeros(2, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        tb.sort_tiles_counts_collapsed(x, c, 128, 10)
    before = (tp.partition_pass_fused.launches,
              tb.sort_tiles_counts_collapsed.launches)
    x, c = torch.zeros_like(x, device="cpu"), torch.zeros_like(c, device="cpu")
    tp.partition_pass_fused([x], [], None, r=8, s=256, lo_bit=29, width=3,
                            n=1024)
    tb.sort_tiles_counts_collapsed(x, c, 128, 10)
    assert before == (tp.partition_pass_fused.launches,
                      tb.sort_tiles_counts_collapsed.launches)
