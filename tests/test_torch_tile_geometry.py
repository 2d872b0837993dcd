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

from tpusort_torch.kernels.bitonic import TileGeometry, tile_sort_geometry
from tpusort_torch.kernels.partition import (
    MAX_TILE, SMEM_MAX, check_fits, tile_smem_bytes)

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
