"""A numpy model of K6's digit histogram (``csrc/scanhist.cu``), on the CPU.

The kernel runs only on a card.  What its arithmetic promises is checked
here on a model written as the ``.cu`` file writes it, with the kernel's
constants read from that file and the grid passed in small:

* the split of the work: the keys before the first 16-byte boundary (the
  head), full chunks of 4 x 32 vectors, warp w of the grid taking chunks
  w, w + W, ... (lane l: vectors 32 k + l, each vector's 4 keys in order),
  and the rest (the head and what follows the last chunk) on the grid's
  last warp, one key a lane a step;
* up to 8 bins: 8-bit register fields (bins 0-3 in one word, 4-7 in the
  other), flushed every 15 chunks and at the end by warp sums of two
  fields in 16-bit halves into lane b's total of bin b; the model asserts
  that no field ever passes 255;
* more bins: each thread's two (digit, run) pairs, a run added to the
  warp's own bins when a key matches neither pair, and at the end;
* the merge: each CTA's warp copies summed, then added to the output.

Each case is held against ``np.bincount`` and the wrapper's plain version,
and some against the Pallas kernel in interpret mode.
``tests/test_torch_cuda.py`` holds the kernel itself to the plain version
on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusort.kernels import scanhist as js
from tpusort_torch.kernels import scanhist as ts

SRC = Path(ts.__file__).resolve().parent.parent / "csrc" / "scanhist.cu"


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SRC.read_text())
    assert m, name
    return int(m.group(1))


WARPS = _const("kHistWarps")
MAX_BINS = _const("kHistMaxBins")
REG_BINS = _const("kHistRegBins")
LOADS = _const("kHistLoads")
CHUNK_VECS = 32 * LOADS
CHUNK_KEYS = 4 * CHUNK_VECS
LANE_KEYS = 4 * LOADS                  # a lane's keys a chunk
FLUSH_EVERY = 255 // LANE_KEYS         # chunks between register flushes


def test_model_constants_match_the_kernel():
    src = SRC.read_text()
    assert (WARPS, MAX_BINS, REG_BINS, LOADS) == (16, 256, 8, 4)
    assert "kHistThreads = 32 * kHistWarps" in src
    assert "kHistFlushEvery = 255 / kHistChunkKeysLane" in src
    assert 1 << ts.MAX_DIGIT_BITS == MAX_BINS


class RegCounts:
    """8-bit fields in two words a lane, ``shadow`` the exact counts since
    the last flush (to prove no field carries), ``total`` lane b's bin b."""

    def __init__(self, nwarps):
        self.lo = np.zeros((nwarps, 32), np.uint32)
        self.hi = np.zeros((nwarps, 32), np.uint32)
        self.total = np.zeros((nwarps, 32), np.uint32)
        self.shadow = np.zeros((nwarps, 32, REG_BINS), np.int64)
        self.lifetime = np.zeros((nwarps, 32, REG_BINS), np.int64)
        self.flushes = 0

    def add(self, w, d, ok):
        """Lanes ``ok`` of warps ``w`` count digit d (each (len(w), 32))."""
        d = d.astype(np.uint32)
        inc = np.where(ok, np.uint32(1) << ((d & 3) << 3), 0) \
            .astype(np.uint32)
        self.lo[w] += np.where(d < 4, inc, 0).astype(np.uint32)
        self.hi[w] += np.where(d < 4, 0, inc).astype(np.uint32)
        hit = (np.arange(REG_BINS) == d[..., None]) & ok[..., None]
        self.shadow[w] += hit
        self.lifetime[w] += hit
        assert self.shadow.max() <= 255, "an 8-bit field passed 255"

    def flush(self, w):
        """Warps ``w`` (all their lanes) fold the fields into the totals."""
        lo, hi = self.lo[w], self.hi[w]
        fields = np.stack([(word >> (8 * f)) & 0xFF
                           for word in (lo, hi) for f in range(4)], -1)
        np.testing.assert_array_equal(fields, self.shadow[w])   # no carry

        def warp_sum(v):          # __reduce_add_sync over the 32 lanes
            s = v.astype(np.uint64).sum(axis=1, keepdims=True)
            return np.broadcast_to(s.astype(np.uint32), v.shape)

        m = np.uint32(0x00FF00FF)
        e0, o0 = warp_sum(lo & m), warp_sum((lo >> 8) & m)
        e1, o1 = warp_sum(hi & m), warp_sum((hi >> 8) & m)
        lane = np.arange(32, dtype=np.uint32)
        word = np.where(lane & 4, np.where(lane & 1, o1, e1),
                        np.where(lane & 1, o0, e0))
        self.total[w] += (word >> ((lane & 2) << 3)) & 0xFFFF
        self.lo[w] = self.hi[w] = 0
        self.shadow[w] = 0
        self.flushes += 1

    def finish(self, wbins):
        all_w = np.arange(self.lo.shape[0])
        self.flush(all_w)
        wbins[:, :REG_BINS] = self.total[:, :REG_BINS]


class RunCounts:
    """Each lane's two (digit, run) pairs; ``wbins`` the warps' copies."""

    def __init__(self, nwarps, wbins):
        shape = (nwarps, 32)
        self.c0, self.c1 = np.zeros(shape, np.int64), np.ones(shape, np.int64)
        self.r0, self.r1 = np.zeros(shape, np.int64), np.zeros(shape, np.int64)
        self.wbins = wbins
        self.atomics = 0

    def _atomic(self, w, c, r, where):
        ww = np.broadcast_to(w[:, None], c.shape)[where]
        np.add.at(self.wbins, (ww, c[where]), r[where])
        self.atomics += int(where.sum())

    def add(self, w, d, ok):
        c0, c1, r0, r1 = self.c0[w], self.c1[w], self.r0[w], self.r1[w]
        assert not (c0 == c1).any()
        miss = ok & (d != c0) & (d != c1)
        self._atomic(w, c1, r1, miss & (r1 != 0))
        c1 = np.where(miss, c0, c1)
        r1 = np.where(miss, r0, r1)
        c0 = np.where(miss, d, c0)
        r0 = np.where(miss, 0, r0)
        r0 = r0 + (ok & (d == c0))
        r1 = r1 + (ok & (d == c1))
        self.c0[w], self.c1[w], self.r0[w], self.r1[w] = c0, c1, r0, r1

    def finish(self, wbins):
        w = np.arange(self.c0.shape[0])
        self._atomic(w, self.c0, self.r0, self.r0 != 0)
        self._atomic(w, self.c1, self.r1, self.r1 != 0)


def k6_model(keys, shift, bits, *, offset=0, resident=4):
    """The kernel's counts of ``keys`` (uint32) whose first key lies
    ``offset`` words past a 16-byte boundary, on a card that holds
    ``resident`` CTAs at once.  Returns (counts, the counter state)."""
    n = keys.shape[0]
    nbins = 1 << bits
    digits = ((keys.astype(np.uint32) >> shift) & (nbins - 1)).astype(np.int64)
    head = min(((16 - 4 * offset) & 15) // 4, n)
    full = (n - head) // CHUNK_KEYS
    blocks = min(max(-(-full // WARPS), 1), resident)
    nwarps = blocks * WARPS
    regs = nbins <= REG_BINS
    wbins = np.zeros((nwarps, REG_BINS if regs else MAX_BINS), np.int64)
    c = RegCounts(nwarps) if regs else RunCounts(nwarps, wbins)

    # chunk, load k, lane, word -> chunk, lane, the lane's keys in order
    seq = digits[head:head + full * CHUNK_KEYS] \
        .reshape(full, LOADS, 32, 4).transpose(0, 2, 1, 3) \
        .reshape(full, 32, LANE_KEYS)
    since = np.zeros(nwarps, np.int64)
    for first in range(0, full, nwarps):          # one chunk a warp a round
        ch = first + np.arange(nwarps)
        w = np.flatnonzero(ch < full)
        ok = np.ones((w.size, 32), bool)
        for j in range(LANE_KEYS):
            c.add(w, seq[ch[w], :, j], ok)
        if regs:
            since[w] += 1
            due = w[since[w] == FLUSH_EVERY]
            if due.size:
                c.flush(due)
                since[due] = 0

    # the rest, on the grid's last warp: lane l takes key l, l + 32, ...
    tail = head + full * CHUNK_KEYS
    rest = head + (n - tail)
    assert rest <= 3 + CHUNK_KEYS - 1
    last = np.array([nwarps - 1])
    for base in range(0, rest, 32):
        i = base + np.arange(32)
        ok = i < rest
        src = np.where(i < head, i, tail + (i - head))
        d = np.where(ok, digits[np.minimum(src, n - 1)], 0)
        c.add(last, d[None, :], ok[None, :])
    c.finish(wbins)

    # the merge: a CTA's warp copies summed, then added to the output
    out = np.zeros(nbins, np.int64)
    for b in range(blocks):
        out += wbins[b * WARPS:(b + 1) * WARPS, :nbins].sum(axis=0)
    return out.astype(np.int32), c


def _keys(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def _check(keys, shift, bits, **kw):
    got, state = k6_model(keys, shift, bits, **kw)
    want = np.bincount((keys >> shift) & ((1 << bits) - 1),
                       minlength=1 << bits)
    np.testing.assert_array_equal(got, want)
    plain = ts.digit_histogram_tiles_plain(
        torch.from_numpy(keys.view(np.int32)), shift, bits)
    np.testing.assert_array_equal(got, plain.numpy())
    return got, state


@pytest.mark.parametrize("shift,bits", [(0, 3), (24, 8)])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 3, 5, 1000, (1 << 17) + 7])
def test_model_splits_any_length_at_any_offset(n, offset, shift, bits):
    """The head, the grid-stride chunks and the rest cover every key once,
    at every 4-byte alignment; 2^17 + 7 keys take several rounds of a grid
    of 3 CTAs, uneven across warps."""
    rng = np.random.default_rng(n * 4 + offset)
    _check(_keys(rng, n), shift, bits, offset=offset, resident=3)


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("where", ["low", "mid", "top"])
def test_model_every_width_at_several_shifts(bits, where):
    shift = {"low": 0, "mid": 13, "top": 32 - bits}[where]
    rng = np.random.default_rng(100 + bits)
    _check(_keys(rng, 3 * CHUNK_KEYS * WARPS + 77), shift, bits, offset=1,
           resident=2)


@pytest.mark.parametrize("shift,bits", [(24, 8), (0, 3), (31, 1), (4, 5)])
@pytest.mark.parametrize("kind", ["constant", "two alternating"])
def test_model_constant_and_alternating_keys(kind, shift, bits):
    """A lane takes 33 chunks, 528 keys: past an 8-bit field for one bin
    (constant) or two (alternating), so flushes have to come between; the
    run pairs take these keys with no atomic until the end."""
    n = WARPS * 33 * CHUNK_KEYS + 5
    mask = (1 << bits) - 1
    a, b = 0x5A5A5A5A, 0x5A5A5A5A ^ (1 << shift)
    keys = np.full(n, a, np.uint32)
    if kind == "two alternating":
        keys[1::2] = b
    got, state = _check(keys, shift, bits, offset=2, resident=1)
    assert got[(a >> shift) & mask] == (n if kind == "constant"
                                        else (n + 1) // 2)
    if isinstance(state, RegCounts):
        assert state.lifetime.max() > 255
        assert state.flushes >= 3
    else:
        assert state.atomics <= 2 * WARPS * 32    # the finish's, no more


def test_model_runs_on_uniform_and_presorted_keys():
    """Uniform 8-bit digits miss both pairs almost every key; presorted
    keys at a high shift add a run only where a lane's digit changes: at
    most 3 digits in a chunk's 512 keys here, so a few of a lane's 16."""
    rng = np.random.default_rng(5)
    keys = _keys(rng, 8 * CHUNK_KEYS * WARPS)
    _, uni = _check(keys, 24, 8, resident=2)
    assert uni.atomics > 0.95 * keys.size
    _, pre = _check(np.sort(keys), 24, 8, resident=2)
    assert pre.atomics < keys.size // 4


@pytest.mark.parametrize("shift,bits,kind", [
    (31, 1, "uniform"), (0, 3, "constant"), (27, 5, "uniform"),
    (4, 4, "two alternating")])
def test_model_matches_pallas(shift, bits, kind):
    """The model against the Pallas kernel in interpret mode, as
    ``tests/test_torch_scanhist.py`` runs it (a length its tile divides)."""
    rng = np.random.default_rng(17 + bits)
    n = 128 * 8 * 4
    keys = _keys(rng, n)
    if kind == "constant":
        keys[:] = keys[0]
    elif kind == "two alternating":
        keys[1::2] = keys[0] ^ (1 << shift)
        keys[0::2] = keys[0]
    want = np.asarray(js.digit_histogram_tiles(
        jnp.asarray(keys), shift, bits, tile_rows=8, interpret=True))
    got, _ = k6_model(keys, shift, bits, offset=3, resident=1)
    np.testing.assert_array_equal(got, want)
