"""The row tile sorts' geometry and index arithmetic, on the CPU.

K3, K9 and K10 (``tpusort_torch/csrc/sort_tiles.cu`` on
``csrc/reg_sort.cuh``) run only on a card.  What can be checked without
one is checked here: the geometry ``kernels/bitonic.py:tile_sort_geometry``
hands the C entry points, and a numpy model of the kernel's tiers written
as the ``.cu`` file writes them (the register steps inside a thread's E
slots, the shuffles inside a warp's 32 E slots with the mirror's partner
at ``lane ^ m`` and the reversed register ``E - 1 - r``, the shared-memory
steps over the whole row, chunk by chunk where a row is longer than the
CTA's registers, and the swizzled shared-memory word of each slot).  The
model must run every step of ``block_sort``'s network exactly once, in
order, and sort rows with ties, with and without ``sorted_run``.
"""

import numpy as np
import pytest
import torch

from tpusort_torch.kernels.bitonic import TileGeometry, tile_sort_geometry
from tpusort_torch.kernels.partition import (
    MAX_TILE, SMEM_MAX, check_fits, partition_pass_fused_plain,
    partition_pass_splitter_plain, tile_smem_bytes)

REG_WORDS = 32      # csrc/reg_sort.cuh: kRegWords (1024 threads; 2x at 512)


def _fits(p, num_keys, n_vals):
    try:
        check_fits("sort_tiles", p, num_keys, n_vals)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("num_keys", [1, 2, 3])
@pytest.mark.parametrize("n_vals", range(9))
def test_geometry_covers_every_accepted_shape(num_keys, n_vals):
    """Every K (a multiple of 128 up to 32,768) that check_fits accepts:
    threads x slots x chunks = P, a whole number of warps up to 1,024 (512
    where a thread's slots take over 32 registers), slots 4-32 within the
    64 registers an instance is built for, more than one chunk only at the
    most threads, and the shared memory within the CTA's."""
    seen = 0
    for k in range(128, MAX_TILE + 1, 128):
        p = 1 << (k - 1).bit_length()
        if not _fits(p, num_keys, n_vals):
            continue
        seen += 1
        g = tile_sort_geometry(k, num_keys, n_vals)
        assert isinstance(g, TileGeometry)
        assert g.threads * g.slots * g.chunks == p, (k, g)
        words = g.slots * (num_keys + (n_vals > 0))
        cap = 1024 if words <= REG_WORDS else 512
        assert g.threads % 32 == 0 and 32 <= g.threads <= cap, (k, g)
        assert g.slots in (4, 8, 16, 32), (k, g)
        assert words <= 2 * REG_WORDS, (k, g)
        assert g.chunks & (g.chunks - 1) == 0, (k, g)
        assert g.chunks == 1 or g.threads == cap, (k, g)
        assert g.smem_bytes == tile_smem_bytes(p, num_keys, n_vals > 0)
        assert g.smem_bytes <= SMEM_MAX
    assert seen >= 128          # every K up to 16,384 fits any mode


@pytest.mark.parametrize("k,num_keys,n_vals,want", [
    (16384, 1, 0, (512, 32, 1)), (16384, 1, 1, (512, 32, 1)),
    (2048, 1, 1, (64, 32, 1)), (2048, 1, 0, (64, 32, 1)),
    (12288, 1, 2, (512, 32, 1)), (6144, 3, 2, (512, 16, 1)),
    (16384, 3, 1, (512, 16, 2)), (32768, 1, 1, (512, 32, 2)),
    (32768, 1, 0, (1024, 32, 1)), (128, 1, 0, (32, 4, 1)),
    (256, 2, 1, (32, 8, 1)), (4096, 2, 0, (128, 32, 1)),
    (2048, 2, 1, (128, 16, 1)),
])
def test_geometry_of_the_path_shapes(k, num_keys, n_vals, want):
    """The single tile, sort_batched's rows, the packed and wide leaves
    and the edges."""
    assert tuple(tile_sort_geometry(k, num_keys, n_vals))[:3] == want


# ---- the numpy model of csrc/reg_sort.cuh ---------------------------------

def swz(s):
    """The shared-memory word of slot s."""
    return s ^ ((s >> 5) & 31)


def _reference_steps(log_p, log_run):
    """block_sort's steps, in order: (level, -1) for the mirror, (level,
    lj) for the half-cleaner at distance 2^lj; each with its pairs."""
    half = 1 << (log_p - 1)
    p = np.arange(half)
    steps = []
    for lk in range(log_run + 1, log_p + 1):
        base = (p >> (lk - 1)) << lk
        off = p & ((1 << (lk - 1)) - 1)
        steps.append(((lk, -1), base + off, base + (1 << lk) - 1 - off))
        for lj in range(lk - 2, -1, -1):
            i = ((p >> lj) << (lj + 1)) + (p & ((1 << lj) - 1))
            steps.append(((lk, lj), i, i + (1 << lj)))
    return steps


class Model:
    """One CTA sorting one row, as reg_block_sort does it.  ``trace``
    gets (step, chunk or None for a shared-memory step, low slots, high
    slots) for every compare-exchange step executed."""

    def __init__(self, values, log_p, threads, slots, chunks):
        assert threads * slots * chunks == 1 << log_p
        self.p, self.log_p = 1 << log_p, log_p
        self.threads, self.e, self.chunks = threads, slots, chunks
        self.log_e = slots.bit_length() - 1
        self.log_w = self.log_e + 5
        self.smem = np.empty(self.p, dtype=np.int64)
        self.smem[swz(np.arange(self.p))] = values
        self.trace = []

    # shared memory tier: one compare-exchange a pair, on swizzled words
    def _smem_step(self, step, i, j):
        a, b = self.smem[swz(i)], self.smem[swz(j)]
        self.smem[swz(i)], self.smem[swz(j)] = np.minimum(a, b), \
            np.maximum(a, b)
        self.trace.append((step, None, i, j))

    # register tier: v is (threads, E); pairs (r, r2) inside each thread
    def _reg_step(self, v, step, slot, pairs):
        for r, r2 in pairs:
            a, b = v[:, r].copy(), v[:, r2].copy()
            v[:, r], v[:, r2] = np.minimum(a, b), np.maximum(a, b)
        self.trace.append((step, self.chunk,
                           np.concatenate([slot[:, r] for r, _ in pairs]),
                           np.concatenate([slot[:, r2] for _, r2 in pairs])))

    def _reg_levels(self, v, slot, lo, hi):
        e = self.e
        for lk in range(1, self.log_e + 1):
            b = 1 << lk
            if lo <= lk <= hi:
                self._reg_step(v, (lk, -1), slot,
                               [(r, r ^ (b - 1)) for r in range(e)
                                if not r & (b // 2)])
                d = b // 4
                while d >= 1:
                    self._reg_step(v, (lk, d.bit_length() - 1), slot,
                                   [(r, r + d) for r in range(e)
                                    if not r & d])
                    d //= 2

    def _reg_cleaners(self, v, slot, lk):
        d = self.e // 2
        while d >= 1:
            self._reg_step(v, (lk, d.bit_length() - 1), slot,
                           [(r, r + d) for r in range(self.e) if not r & d])
            d //= 2

    # warp tier: partner thread (t & ~31) | (lane ^ mask)
    def _partner(self, mask):
        t = np.arange(self.threads)
        return (t & ~31) | ((t & 31) ^ mask)

    def _warp_mirror(self, v, slot, lk, m):
        e, t = self.e, np.arange(self.threads)
        partner = self._partner(m)
        lower = ((t & 31) & ((m + 1) >> 1)) == 0
        lo_slots, hi_slots = [], []
        for r in range(e // 2):
            a = v[partner, e - 1 - r].copy()     # shfl_xor(v[E-1-r], m)
            b = v[partner, r].copy()             # shfl_xor(v[r], m)
            v[:, r] = np.where(lower, np.minimum(v[:, r], a),
                               np.maximum(v[:, r], a))
            v[:, e - 1 - r] = np.where(lower, np.minimum(v[:, e - 1 - r], b),
                                       np.maximum(v[:, e - 1 - r], b))
            lo_slots += [slot[lower, r], slot[lower, e - 1 - r]]
            hi_slots += [slot[partner[lower], e - 1 - r],
                         slot[partner[lower], r]]
        self.trace.append(((lk, -1), self.chunk, np.concatenate(lo_slots),
                           np.concatenate(hi_slots)))

    def _warp_clean(self, v, slot, lk, lj, dm):
        t = np.arange(self.threads)
        partner = self._partner(dm)
        lower = ((t & 31) & dm) == 0
        other = v[partner].copy()                # shfl_xor(v[r], dm)
        v[:] = np.where(lower[:, None], np.minimum(v, other),
                        np.maximum(v, other))
        self.trace.append(((lk, lj), self.chunk, slot[lower].ravel(),
                           slot[partner[lower]].ravel()))

    def _local_levels(self, v, slot, lo, hi):
        if lo <= self.log_e:
            self._reg_levels(v, slot, lo, min(hi, self.log_e))
            lo = self.log_e + 1
        for lk in range(lo, hi + 1):
            if lk <= self.log_w:
                self._warp_mirror(v, slot, lk, (1 << (lk - self.log_e)) - 1)
            for lj in range(min(lk - 2, self.log_w - 1), self.log_e - 1, -1):
                self._warp_clean(v, slot, lk, lj, 1 << (lj - self.log_e))
            self._reg_cleaners(v, slot, lk)

    def sort(self, log_run):
        half = self.p // 2
        p = np.arange(half)
        lk = log_run + 1
        while lk <= self.log_p:
            hi = lk
            if lk > self.log_w:
                base = (p >> (lk - 1)) << lk
                off = p & ((1 << (lk - 1)) - 1)
                self._smem_step((lk, -1), base + off,
                                base + (1 << lk) - 1 - off)
                for lj in range(lk - 2, self.log_w - 1, -1):
                    i = ((p >> lj) << (lj + 1)) + (p & ((1 << lj) - 1))
                    self._smem_step((lk, lj), i, i + (1 << lj))
            else:
                hi = min(self.log_p, self.log_w)
            c_slots = self.threads * self.e
            for c in range(self.chunks):
                self.chunk = c
                slot = c * c_slots + np.arange(self.threads)[:, None] \
                    * self.e + np.arange(self.e)[None, :]
                v = self.smem[swz(slot)]
                self._local_levels(v, slot, lk, hi)
                self.smem[swz(slot)] = v
            lk = hi + 1
        return self.smem[swz(np.arange(self.p))]


def _geometries(max_p):
    """Every (P, threads, slots, 1) the kernels take up to max_p with one
    chunk, for each slot count the C side builds (the wrappers pick among
    them), and every geometry the wrappers pick."""
    out = set()
    for lp in range(7, max_p.bit_length()):
        p = 1 << lp
        for e in (4, 8, 16, 32):
            if p // e >= 32:
                out.add((p, p // e, e, 1))
        for nk in (1, 2, 3):
            for nv in (0, 1):
                if _fits(p, nk, nv):
                    out.add((p, *tile_sort_geometry(p, nk, nv)[:3]))
    return sorted(out)


SMALL = _geometries(4096)
CHUNKED = [(2048, 32, 32, 2), (4096, 64, 8, 8)]


@pytest.mark.parametrize("p,threads,slots,chunks", SMALL + CHUNKED)
@pytest.mark.parametrize("log_run", [0, 7])
def test_model_runs_every_step_once(p, threads, slots, chunks, log_run):
    """Each step of block_sort's network runs exactly once on every pair
    it owns, in the network's order within each chunk, at the tier its
    span allows."""
    log_p = p.bit_length() - 1
    m = Model(np.arange(p)[::-1].copy(), log_p, threads, slots, chunks)
    m.sort(log_run)
    ref = _reference_steps(log_p, log_run)
    order = [s for s, _, _ in ref]
    for c in range(chunks):
        seen = [s for s, ch, _, _ in m.trace if ch in (None, c)]
        assert seen == order, (c, seen[:5], order[:5])
    for step, i, j in ref:
        got_i = np.concatenate([a for s, _, a, _ in m.trace if s == step])
        got_j = np.concatenate([b for s, _, _, b in m.trace if s == step])
        want = np.stack([i, j], axis=1)
        got = np.stack([got_i, got_j], axis=1)
        assert got.shape == want.shape, step
        assert np.array_equal(got[np.lexsort(got.T[::-1])],
                              want[np.lexsort(want.T[::-1])]), step
    e_log = slots.bit_length() - 1
    smem_steps = {s for s, ch, _, _ in m.trace if ch is None}
    # a step touches shared memory exactly when its span exceeds a warp's
    assert smem_steps == {s for s, _, _ in ref
                          if (s[0] if s[1] < 0 else s[1] + 1) > e_log + 5}


@pytest.mark.parametrize("p,threads,slots,chunks", SMALL + CHUNKED)
@pytest.mark.parametrize("ties", ["index", "none"])
@pytest.mark.parametrize("log_run", [0, 7, "all"])
def test_model_sorts_rows_with_ties(p, threads, slots, chunks, ties,
                                    log_run):
    """Random rows of 16 distinct keys and a block of all-ones: with the
    slot index packed under the key (K3, K9 and K10 with payloads) the
    result is the stable order; without it the keys come out sorted.  With
    ``sorted_run`` the row is given as ascending runs of that length."""
    rng = np.random.default_rng(p * 31 + slots)
    log_p = p.bit_length() - 1
    keys = rng.integers(0, 16, p).astype(np.int64) * 0x10EF0F01
    keys[p // 4: p // 4 + p // 8] = 0xFFFFFFFF
    run = 1 << (log_p if log_run == "all" else log_run)
    if run > 1:
        keys = np.sort(keys.reshape(-1, run), axis=1, kind="stable") \
            .ravel()
    words = keys << 16 | np.arange(p) if ties == "index" else keys
    m = Model(words, log_p, threads, slots, chunks)
    out = m.sort(run.bit_length() - 1)
    if ties == "index":
        order = np.argsort(keys, kind="stable")
        assert np.array_equal(out & 0xFFFF, order)
        assert np.array_equal(out >> 16, keys[order])
    else:
        assert np.array_equal(out, np.sort(keys))


@pytest.mark.parametrize("slots", [4, 8, 16, 32])
def test_swizzle_keeps_a_warps_accesses_off_shared_bank_conflicts(slots):
    """A warp's blocked reads (lane l, register r: slot 32 E w + E l + r)
    and its striped ones (slot 32 w + l) hit 32 distinct banks, and the
    swizzle is a permutation of every 32-slot group."""
    lanes = np.arange(32)
    for w in range(64):
        for r in range(slots):
            assert len(set(swz(32 * slots * w + slots * lanes + r) % 32)) \
                == 32
        assert len(set(swz(32 * w + lanes) % 32)) == 32
        assert sorted(swz(32 * w + lanes)) == list(32 * w + lanes)


# ---- K1 and K1b (csrc/partition.cu) on the same network --------------------

K1_MODES = [(nk, nv) for nk in (1, 2, 3) for nv in (0, 1)]


@pytest.mark.parametrize("num_keys,n_vals", K1_MODES)
def test_k1_geometry_keeps_payload_tiles_at_512_threads(num_keys, n_vals):
    """The partition pass takes K3's geometry; its instances with payloads
    are built for at most 512 threads (csrc/partition.cu:
    partition_threads), which every K it accepts respects."""
    for k in (1 << lk for lk in range(7, 16)):
        if not _fits(k, num_keys, n_vals):
            continue
        g = tile_sort_geometry(k, num_keys, n_vals)
        assert g.threads * g.slots * g.chunks == k
        if n_vals:
            assert g.threads <= 512, (k, g)


def _k1_cases():
    for lk in range(11, 15):
        for nk, nv in K1_MODES:
            for log_run in range(lk + 1):
                yield lk, nk, nv, log_run


@pytest.mark.parametrize("log_k,num_keys,n_vals,log_run", _k1_cases())
def test_model_sorts_k1_tiles(log_k, num_keys, n_vals, log_run):
    """A K1 tile at the geometry it is launched with (K = 2^11 .. 2^14,
    1-3 key planes, with and without the slot index, every sorted_run):
    keys of 16 distinct words per plane and a block of all-ones, given as
    ascending runs of 2^log_run.  The model sorts the slots' lexicographic
    ranks; with the index the result is the stable order."""
    k = 1 << log_k
    g = tile_sort_geometry(k, num_keys, n_vals)
    rng = np.random.default_rng(log_k * 131 + num_keys * 7 + n_vals)
    planes = rng.integers(0, 16, (num_keys, k)).astype(np.int64) * 0x10EF0F01
    planes[:, k // 4: k // 4 + k // 8] = 0xFFFFFFFF
    run = 1 << log_run
    if run > 1:                 # each run sorted, ties in slot order
        for r0 in range(0, k, run):
            o = np.lexsort(planes[::-1, r0:r0 + run])
            planes[:, r0:r0 + run] = planes[:, r0:r0 + run][:, o]
    index = np.arange(k)
    keys = [*planes, index] if n_vals else list(planes)
    order = np.lexsort(keys[::-1])
    rank = np.empty(k, dtype=np.int64)
    rank[order] = np.arange(k)
    if not n_vals:              # equal keys share a rank
        tup = planes[:, order]
        new = np.concatenate([[True], (tup[:, 1:] != tup[:, :-1]).any(0)])
        rank[order] = np.cumsum(new) - 1
    m = Model(rank, log_k, g.threads, g.slots, g.chunks)
    out = m.sort(log_run)
    if n_vals:
        assert np.array_equal(out, np.arange(k))
        assert np.array_equal(index[order], np.argsort(rank))
    else:
        assert np.array_equal(out, np.sort(rank))


# ---- K1's epilogue over the swizzled tile (csrc/partition.cu) ------------

def _k1_epilogue_model(planes, values, counts_in, q_in, n, r, s, t_seg,
                       lo_bit=0, width=1, splitters=None, fracs=None):
    """K1 (or K1b with ``splitters``) as partition.cu computes it on numpy
    uint32 (T, K) tiles: the sorted tile stored at the swizzled words
    swz(slot), with the slot index riding under the last plane; the digit
    histogram, K1b's binary searches and the run emission all read slot s
    at word swz(s).  Returns (flat runs per operand, counts (T, R))."""
    nk = len(planes)
    T, K = planes[0].shape
    sw = swz(np.arange(K))
    outs = [np.zeros(T * r * s, dtype=np.uint32) for _ in (*planes, *values)]
    counts = np.zeros((T, r), dtype=np.int64)
    for t in range(T):
        slot = np.arange(K)
        if counts_in is None:
            valid = t * K + slot < n
        else:
            valid = slot % q_in < np.repeat(counts_in[t], q_in)
        keys = [np.where(valid, p[t], np.uint32(0xFFFFFFFF)) for p in planes]
        order = np.lexsort([slot, *keys[::-1]])       # stable, plane 0 first
        word = [np.empty(K, dtype=np.uint32) for _ in range(nk)]
        idx = np.empty(K, dtype=np.int64)
        for p in range(nk):
            word[p][sw] = keys[p][order]
        idx[sw] = order
        n_valid = int(valid.sum())

        def key_at(pos):
            return [w[swz(pos)] for w in word]

        if splitters is None:
            sorted_keys = key_at(np.arange(K))
            digit = np.zeros(K, dtype=np.int64)
            for p in range(nk):
                base = 32 * (nk - 1 - p)
                ov_lo, ov_hi = max(lo_bit, base), min(lo_bit + width, base + 32)
                if ov_hi > ov_lo:
                    m = (1 << (ov_hi - ov_lo)) - 1
                    digit |= ((sorted_keys[p].astype(np.int64) >> (ov_lo - base))
                              & m) << (ov_lo - lo_bit)
            hist = np.bincount(digit, minlength=r)[:r]
            start = np.concatenate([[0], np.cumsum(hist)[:-1]])
            cnt = hist.copy()
            cnt[r - 1] = n_valid - start[r - 1]
        else:
            def rank_of(sv, or_equal):
                lo, hi = 0, K
                while lo < hi:
                    mid = (lo + hi) >> 1
                    c = 0
                    for x, y in zip(key_at(mid), sv):
                        if c == 0:
                            c = (int(x) > int(y)) - (int(x) < int(y))
                    if c < 0 or (or_equal and c == 0):
                        lo = mid + 1
                    else:
                        hi = mid
                return lo

            a_ = [0] * r
            b_ = [0] * r
            for d in range(1, r):
                sv = [int(w[t, d - 1]) & 0xFFFFFFFF for w in splitters]
                a_[d], b_[d] = rank_of(sv, False), rank_of(sv, True)
            flag, prev = False, 0
            cut = [0] * r
            for d in range(1, r):
                a, b = a_[d], b_[d]
                lo, hi = max(a, prev), prev + s
                flag |= lo > hi
                u = (((t * 0x9E3779B9) + ((d * 0x85EBCA6B) & 0x7FFFFFFF))
                     & 0xFFFFFFFF) >> 15 & 0xFFFF
                fd = int(fracs[t, d - 1]) & 0xFFFFFFFF
                prod = ((min(fd, 0xFFFF) * (b - a) + u) & 0xFFFFFFFF) >> 16
                tgt = b if fd >= 0x10000 else a + prod
                prev = min(min(max(tgt, lo), hi), n_valid)
                cut[d] = prev
            nxt = n_valid
            for d in range(r - 1, 0, -1):
                nxt = max(cut[d], min(nxt - s, b_[d]))
                cut[d] = nxt
            flag |= n_valid - cut[r - 1] > s
            start = np.array(cut)
            cnt = np.array(cut[1:] + [n_valid]) - start
            if flag:
                cnt[0] = K + 1
        counts[t] = cnt
        seg, j = divmod(t, t_seg)
        for d in range(r):
            i = np.arange(min(max(cnt[d], 0), s))
            o = ((seg * r + d) * t_seg + j) * s + i
            pos = start[d] + i
            for p in range(nk):
                outs[p][o] = word[p][swz(pos)]
            for v, vals in enumerate(values):
                buf = vals[t]                 # the staged payload tile
                outs[nk + v][o] = buf[idx[swz(pos)]]
    return outs, counts


def _k1_valid(counts, r, s, t_seg):
    T = counts.shape[0]
    c = np.clip(counts, 0, s).reshape(T // t_seg, t_seg, r).transpose(0, 2, 1)
    return (np.arange(s) < c[..., None]).reshape(-1)


def _as_i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("nk,nv,K,r,q,ties", [
    (1, 0, 256, 4, None, False), (1, 1, 512, 8, 128, True),
    (2, 1, 512, 4, None, True), (3, 2, 256, 4, 128, True),
    (2, 0, 1024, 16, 256, False), (1, 8, 256, 4, None, True),
])
def test_k1_epilogue_model_matches_plain(nk, nv, K, r, q, ties):
    """The swizzled epilogue against partition_pass_fused_plain: counts
    exactly and every valid slot, payloads included (both orders of equal
    keys are the stable one)."""
    rng = np.random.default_rng(K + nk * 10 + nv)
    T, t_seg, s = 4, 2, 3 * K // (2 * r) // 128 * 128 or 128
    planes = [rng.integers(0, 1 << 32, (T, K), dtype=np.uint64)
              .astype(np.uint32) for _ in range(nk)]
    if ties:
        planes[0] &= np.uint32(0xF000000F)
        planes[0][:, K // 4: K // 2] = 0xFFFFFFFF
    values = [rng.integers(0, 1 << 32, (T, K), dtype=np.uint64)
              .astype(np.uint32) for _ in range(nv)]
    width = r.bit_length() - 1
    lo_bit = 32 * nk - width
    cin = None if q is None else rng.integers(0, q + 1, (T, K // q)) \
        .astype(np.int32)
    n = T * K - 77
    got, counts = _k1_epilogue_model(planes, values, cin, q, n, r, s, t_seg,
                                     lo_bit=lo_bit, width=width)
    want, pcounts = partition_pass_fused_plain(
        [_as_i32(p) for p in planes], [_as_i32(v) for v in values],
        None if cin is None else torch.from_numpy(cin), q_in=q,
        n=None if q else n, r=r, s=s, lo_bit=lo_bit, width=width,
        t_seg=t_seg)
    np.testing.assert_array_equal(counts, pcounts.numpy())
    m = _k1_valid(counts, r, s, t_seg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[m], w.numpy().view(np.uint32)[m])


@pytest.mark.parametrize("nk,nv,K,r,fracs,q", [
    (1, 0, 512, 8, None, None), (1, 1, 256, 4, 0, 128),
    (2, 1, 512, 4, 65536, None), (3, 0, 256, 8, None, 128),
])
def test_k1b_epilogue_model_matches_plain(nk, nv, K, r, fracs, q):
    """K1b's binary searches on the swizzled words and thread 0's cut walk
    against partition_pass_splitter_plain: counts bit for bit, poisoned
    tiles included, and every valid slot."""
    rng = np.random.default_rng(K * 3 + nk + nv)
    T, t_seg, s = 4, 2, 256
    planes = [rng.integers(0, 1 << 32, (T, K), dtype=np.uint64)
              .astype(np.uint32) for _ in range(nk)]
    planes[0] &= np.uint32(0x7000000F)              # ties across tiles
    values = [rng.integers(0, 1 << 32, (T, K), dtype=np.uint64)
              .astype(np.uint32) for _ in range(nv)]
    srt = np.sort(planes[0], axis=1)
    at = (np.arange(1, r) * K) // r
    splitters = [srt[:, at]] + [np.full((T, r - 1), 0x80000000, np.uint32)
                                for _ in range(nk - 1)]
    splitters[0][0] = 0x0000000F          # tile 0: every key above, poisoned
    f = rng.integers(0, 65537, (T, r - 1)).astype(np.int64) \
        if fracs is None else np.full((T, r - 1), fracs, np.int64)
    cin = None if q is None else rng.integers(q // 2, q + 1, (T, K // q)) \
        .astype(np.int32)
    n = T * K - 33
    got, counts = _k1_epilogue_model(planes, values, cin, q, n, r, s, t_seg,
                                     splitters=splitters, fracs=f)
    want, pcounts = partition_pass_splitter_plain(
        [_as_i32(p) for p in planes], [_as_i32(v) for v in values],
        None if cin is None else torch.from_numpy(cin),
        splitters=[_as_i32(w) for w in splitters],
        splitter_fracs=torch.from_numpy(f.astype(np.int32)), q_in=q,
        n=None if q else n, r=r, s=s, t_seg=t_seg)
    np.testing.assert_array_equal(counts, pcounts.numpy())
    m = _k1_valid(counts, r, s, t_seg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[m], w.numpy().view(np.uint32)[m])
