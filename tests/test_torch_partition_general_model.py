"""A numpy model of K1c (``tpusort_torch/csrc/partition_general.cu``), the
general branch of ``partition_pass_fused``, against its plain PyTorch
version, on the CPU.

The kernel runs only on a card.  What can be checked without one is the
arithmetic it is made of, written here as the ``.cu`` file writes it: the
blocked rank (each walking warp owns a contiguous span of the tile, lane
l's step r takes slot span_start + 32 r + l; the lanes of a step grouped by
digit with one ballot a bit of the digits 0 .. R; the group leader's
per-warp count plus the group's lanes below), the digit-major scan of the
per-warp counts, each slot's staging word (the run's offset, rounded up to
4 words, plus its rank within the digit, or none from S on), and the
staged stores (pieces of 128 words, a warp's lane l storing 16 bytes at
4 l of its piece, the scalar tail of a run).  The model must give the
plain version's counts and every valid slot bit for bit, and write each
slot of a run below its count exactly once and nothing else.  The card
holds the kernel itself to the plain version (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phases 13 and 32).
"""

import numpy as np
import pytest
import torch

from tpusort_torch.kernels.partition import partition_pass_general_plain

WARPS = 16          # csrc/partition_general.cu: kGenWarps
PIECE = 128         # kGenPiece: the words a warp stores at once
NONE = 0xFFFF       # kNoSlot


def _ballot_match(lanes, bits):
    """match_digit: each lane's mask of the lanes with its digit, from one
    ballot per bit of the digits."""
    peers = np.full(32, 0xFFFFFFFF, dtype=np.int64)
    for b in range(bits):
        on_lanes = (lanes >> b) & 1
        ballot = int(np.sum(on_lanes << np.arange(32)))
        peers &= np.where(on_lanes == 1, ballot, ~ballot & 0xFFFFFFFF)
    return peers


def _digits(planes, digit, valid, t, R, lo, width):
    """Each slot's digit (R where invalid or not below R), as key_digit and
    the walk compute it."""
    K = planes[0].shape[1]
    if digit is not None:
        d = digit[t].astype(np.int64) & 0xFFFFFFFF
    else:
        d = np.zeros(K, dtype=np.int64)
        nk = len(planes)
        for p in range(nk):
            base = 32 * (nk - 1 - p)
            ov_lo, ov_hi = max(lo, base), min(lo + width, base + 32)
            if ov_hi > ov_lo:
                m = (1 << (ov_hi - ov_lo)) - 1
                d |= ((planes[p][t].astype(np.int64) >> (ov_lo - base)) & m) \
                    << (ov_lo - lo)
    return np.where(valid & (d < R), d, R)


def k1c_model(planes, values, counts_in, q_in, n, R, S, lo, width, t_seg,
              digit=None):
    """K1c on numpy uint32 (T, K) tiles.  Returns (flat runs per operand,
    filled with 0xDEADBEEF where nothing is written, counts (T, R), the
    number of stores to each run slot)."""
    ops = [*planes, *values]
    T, K = planes[0].shape
    outs = [np.full(T * R * S, 0xDEADBEEF, dtype=np.uint32) for _ in ops]
    stores = np.zeros(T * R * S, dtype=np.int64)
    counts = np.zeros((T, R), dtype=np.int64)
    bits = R.bit_length()                 # 32 - __clz(R): digits 0 .. R
    walkers = min(WARPS, K // 32)
    span = K // walkers
    for t in range(T):
        slot = np.arange(K)
        if counts_in is None:
            valid = t * K + slot < n
        else:
            valid = slot % q_in < np.repeat(counts_in[t], q_in)
        d = _digits(planes, digit, valid, t, R, lo, width)
        # 1. the rank: (r, lane) is slot order within a warp's span
        wcount = np.zeros((WARPS, R + 1), dtype=np.int64)
        local_rank = np.zeros(K, dtype=np.int64)
        for w in range(walkers):
            for r0 in range(w * span, (w + 1) * span, 32):
                lanes = d[r0:r0 + 32]
                peers = _ballot_match(lanes, bits)
                assert np.array_equal(
                    peers, [int(np.sum((lanes == x) << np.arange(32)))
                            for x in lanes])
                lower = (1 << np.arange(32)) - 1
                below = np.array([bin(int(p) & int(lw)).count("1")
                                  for p, lw in zip(peers, lower)])
                local_rank[r0:r0 + 32] = wcount[w, lanes] + below
                for x in np.unique(lanes):      # each group's leader adds
                    wcount[w, x] += np.sum(lanes == x)
        # 2. the scan: digit-major over (digit, warp)
        hist = wcount.sum(axis=0)
        woff = np.cumsum(wcount, axis=0) - wcount
        counts[t] = hist[:R]
        m = np.minimum(hist[:R], S)
        local = np.concatenate([[0], np.cumsum((m + 3) & ~3)])
        piece = np.concatenate([[0], np.cumsum((m + PIECE - 1) // PIECE)])
        assert local[R] <= K + 3 * R and (local % 4 == 0).all()
        # 3. each slot's staging word
        dest = np.full(K, NONE, dtype=np.int64)
        for i in range(K):
            if d[i] < R:
                j = woff[i // span, d[i]] + local_rank[i]
                if j < S:
                    dest[i] = local[d[i]] + j
        kept = dest != NONE
        assert len(set(dest[kept])) == kept.sum()       # no two collide
        # 4. each operand: staged by destination, stored piece by piece
        seg, tj = divmod(t, t_seg)
        for o, out in zip(ops, outs):
            stage = np.full(K + 4 * R, 0xA5A5A5A5, dtype=np.uint32)
            stage[dest[kept]] = o[t][kept]
            dd = 0
            for pc in range(piece[R]):          # warp pc % 16 takes it
                while piece[dd + 1] <= pc:
                    dd += 1
                base = ((seg * R + dd) * t_seg + tj) * S
                for lane in range(32):
                    j = (pc - piece[dd]) * PIECE + 4 * lane
                    width_ = 4 if j + 4 <= m[dd] else max(0, min(4, m[dd] - j))
                    if width_ == 4:
                        assert (base + j) % 4 == 0   # a 16-byte store
                    for kk in range(width_):
                        out[base + j + kk] = stage[local[dd] + j + kk]
                        if out is outs[0]:
                            stores[base + j + kk] += 1
    return outs, counts, stores


def _valid_slots(counts, R, S, t_seg):
    T = counts.shape[0]
    c = np.clip(counts, 0, S).reshape(T // t_seg, t_seg, R).transpose(0, 2, 1)
    return (np.arange(S) < c[..., None]).reshape(-1)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("nk,nv,K,R,S,t_seg,lo,q,digit,skew,ties", [
    (1, 1, 512, 8, 128, 2, 29, None, False, False, True),    # pass 0
    (1, 2, 1024, 32, 128, 2, 20, 128, False, False, False),  # counts_in
    (2, 1, 512, 32, 128, 4, 30, 256, False, False, True),    # straddles
    (2, 0, 2048, 16, 128, 1, 40, None, False, True, False),  # over S
    (1, 3, 1024, 8, 256, 2, 0, 128, True, False, False),     # digit plane
    (1, 1, 128, 2, 128, 2, 31, None, False, False, True),    # one walker
    (3, 2, 2048, 256, 128, 2, 88, 512, False, False, True),  # R = 256
])
def test_k1c_model_matches_plain(nk, nv, K, R, S, t_seg, lo, q, digit, skew,
                                 ties):
    """Counts bit for bit, every valid slot of every operand bit for bit,
    and each slot below a run's count written once (nothing past it):
    ties (equal digits keep input order), invalid slots and digits past R
    (dropped), counts above S, a digit straddling two planes, the digit
    plane, t_seg > 1, one walking warp of 32 slots a step (K = 128) and
    sixteen of 128 (K = 2048)."""
    rng = np.random.default_rng(K + 31 * R + nk + nv)
    T = 2 * t_seg
    width = R.bit_length() - 1
    planes = [rng.integers(0, 1 << 32, (T, K), dtype=np.uint64)
              .astype(np.uint32) for _ in range(nk)]
    values = [rng.integers(0, 1 << 32, (T, K), dtype=np.uint64)
              .astype(np.uint32) for _ in range(nv)]
    p_lo = nk - 1 - lo // 32
    if ties:         # few digit values: long runs of equal digits
        planes[p_lo] &= np.uint32(~(((1 << width) - 1) >> 1 << (lo % 32))
                                  & 0xFFFFFFFF)
    if skew:         # half of each tile in digit 0: its runs overflow S
        planes[p_lo][:, ::2] &= np.uint32(~(((1 << width) - 1) << (lo % 32))
                                          & 0xFFFFFFFF)
    cin = None if q is None else rng.integers(0, q + 1, (T, K // q))
    n = T * K - 77
    dig = rng.integers(0, R + 3, (T, K)).astype(np.int32) if digit else None
    got, counts, stores = k1c_model(planes, values, cin, q, n, R, S, lo,
                                    width, t_seg, dig)
    want, pcounts = partition_pass_general_plain(
        [_i32(p) for p in planes], [_i32(v) for v in values],
        None if cin is None else torch.from_numpy(cin.astype(np.int32)),
        q_in=q, n=None if q else n, r=R, s=S, lo_bit=lo, width=width,
        t_seg=t_seg, digit=None if dig is None else torch.from_numpy(dig))
    np.testing.assert_array_equal(counts, pcounts.numpy())
    m = _valid_slots(counts, R, S, t_seg)
    np.testing.assert_array_equal(stores, m.astype(np.int64))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[m], w.numpy().view(np.uint32)[m])
    if skew:
        assert counts.max() > S
    if digit:
        assert (dig >= R).any()
