"""The port's K1c, the general branch of ``partition_pass_fused`` (its plain
PyTorch version, which CPU tensors take), against the Pallas kernel's
general branch in interpret mode, bit for bit.

Both compare on the counts and on every operand at every slot the counts
mark valid, payloads included: the partition is stable, so each run holds
its digit's slots in input order and there is one right answer.  Inputs
are numpy arrays from a seed.  The CUDA kernel is held against the plain
version on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusort.kernels import partition as jp
from tpusort_torch.kernels import partition as tp

T, K, R, S, Q = 4, 512, 8, 128, 128


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _valid_slots(counts, t_seg):
    """Valid-slot mask of the exchanged runs the pass wrote."""
    c = np.minimum(counts, S).reshape(T // t_seg, t_seg, R).transpose(0, 2, 1)
    return (np.arange(S) < c[..., None]).reshape(-1)


def _compare(tdata, tcounts, jdata, jcounts, t_seg=2):
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    m = _valid_slots(np.asarray(jcounts), t_seg)
    for t_, j_ in zip(tdata, jdata):
        np.testing.assert_array_equal(t_.numpy().view(np.uint32)[m],
                                      np.asarray(j_)[m])


@pytest.mark.parametrize("nk,nv,lo_bit,chain,digit,skew", [
    (1, 1, 29, False, False, False),  # pass 0, n mid-tile
    (1, 2, 20, True, False, False),   # a later pass: validity from counts_in
    (2, 1, 30, True, False, False),   # two planes, the digit straddles them
    (2, 3, 40, False, False, True),   # a digit's count exceeds S
    (1, 4, 0, True, True, False),     # the caller's digit plane, 4 values
])
def test_general_branch_matches_pallas(nk, nv, lo_bit, chain, digit, skew):
    rng = np.random.default_rng(200 + 10 * nk + nv)
    ops = [rng.integers(0, 2**32, (T, K), dtype=np.uint32)
           for _ in range(nk + nv)]
    if skew:     # half of each tile in digit 0: its runs overflow S
        ops[nk - 1 - lo_bit // 32][:, ::2] &= np.uint32(
            ~(7 << (lo_bit % 32)) & 0xFFFFFFFF)
    kw = dict(r=R, s=S, lo_bit=lo_bit, width=3, t_seg=2)
    jcin = tcin = None
    if chain:
        cin = rng.integers(0, Q + 1, (T, K // Q)).astype(np.int32)
        jcin, tcin = jnp.asarray(cin), torch.from_numpy(cin)
        kw["q_in"] = Q
    else:
        kw["n"] = T * K - 300
    dig = rng.integers(0, R, (T, K)).astype(np.uint32) if digit else None
    jdata, jcounts = jp.partition_pass_fused(
        [jnp.asarray(o) for o in ops[:nk]], [jnp.asarray(o) for o in ops[nk:]],
        jcin, unstable=False, interpret=True,
        digit=None if dig is None else jnp.asarray(dig), **kw)
    tdata, tcounts = tp.partition_pass_fused(
        [_i32(o) for o in ops[:nk]], [_i32(o) for o in ops[nk:]], tcin,
        digit=None if dig is None else _i32(dig), **kw)
    assert len(tdata) == len(jdata) == nk + nv
    _compare(tdata, tcounts, jdata, jcounts)
    if skew:
        assert int(tcounts.max()) > S
    if not chain:
        assert int(tcounts.sum()) == T * K - 300


def test_keys_only_switch_matches_pallas_general_branch():
    """``general=True`` with no payloads: the planes' runs equal the
    Pallas general branch's, which takes that branch only with a payload,
    so it carries a dummy position payload that is dropped here."""
    rng = np.random.default_rng(231)
    hi, lo = (rng.integers(0, 2**32, (T, K), dtype=np.uint32)
              for _ in range(2))
    hi &= np.uint32(0xF000000F)        # ties in the digit (bits 28-31)
    cin = rng.integers(0, Q + 1, (T, K // Q)).astype(np.int32)
    kw = dict(r=R, s=S, lo_bit=60, width=3, t_seg=2, q_in=Q)
    pos = np.broadcast_to(np.arange(K, dtype=np.uint32), (T, K))
    jdata, jcounts = jp.partition_pass_fused(
        [jnp.asarray(hi), jnp.asarray(lo)], [jnp.asarray(pos)],
        jnp.asarray(cin), unstable=False, interpret=True, **kw)
    tdata, tcounts = tp.partition_pass_fused(
        [_i32(hi), _i32(lo)], [], torch.from_numpy(cin), general=True, **kw)
    assert len(tdata) == 2
    _compare(tdata, tcounts, jdata[:2], jcounts)
    # the raw branch sorts by the whole key instead: the same counts, but
    # not the same order within a digit
    rdata, rcounts = tp.partition_pass_fused(
        [_i32(hi), _i32(lo)], [], torch.from_numpy(cin), **kw)
    assert torch.equal(rcounts, tcounts)
    m = _valid_slots(tcounts.numpy(), 2)
    assert not np.array_equal(rdata[1].numpy()[m], tdata[1].numpy()[m])


def test_general_plain_is_a_stable_partition():
    """Four planes (past the raw branch's three) and a value: each run
    holds its digit's valid slots in input order, padded to S."""
    rng = np.random.default_rng(232)
    ops = [rng.integers(0, 2**32, (T, K), dtype=np.uint32) for _ in range(5)]
    n = T * K - 1000
    (*planes, val), counts = tp.partition_pass_fused(
        [_i32(o) for o in ops[:4]], [_i32(ops[4])], None, r=R, s=S,
        lo_bit=98, width=3, n=n, t_seg=1)
    runs = val.numpy().view(np.uint32).reshape(T, R, S)
    for t in range(T):
        first = t * K
        ok = np.arange(first, first + K) < n
        digit = (ops[0][t] >> 2) & 7               # bits 98-100, plane 0
        for d in range(R):
            want = ops[4][t][ok & (digit == d)]
            c = int(counts[t, d])
            assert c == len(want)
            np.testing.assert_array_equal(runs[t, d, :min(c, S)],
                                          want[:S])


def test_general_branch_checks():
    x = torch.zeros(2, 512, dtype=torch.int32)
    kw = dict(r=8, s=128, lo_bit=29, width=3, n=1024)
    with pytest.raises(ValueError, match="digit"):
        tp.partition_pass_fused([x], [], None, digit=x[:, :256], **kw)
    with pytest.raises(ValueError, match="digit"):
        tp.partition_pass_fused([x], [], None, digit=x.float(), **kw)
    # (R + 1) << log2(K) must fit 32 bits, as in the Pallas general branch
    big = torch.empty(1, 1 << 24, dtype=torch.int32)
    with pytest.raises(ValueError, match="sortkey overflow"):
        tp.partition_pass_fused([big], [big], None, r=256, s=1 << 16,
                                lo_bit=24, width=8, n=10)
