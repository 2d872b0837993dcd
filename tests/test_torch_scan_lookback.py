"""A numpy model of K5's single-pass scan (``csrc/scanhist.cu``), on the
CPU.

The kernel runs only on a card.  What its arithmetic promises is checked
here on a model written as the ``.cu`` file writes it:

* a tile of 8,192 elements: each of 512 threads sums its 16 consecutive
  elements in order, then the block's exclusive scan of the thread sums
  (warp-shuffle Hillis-Steele scans of the lanes, then of the 16 warp
  sums), which also gives the tile's aggregate;
* the look-back: tiles in groups of 128; tile b's exclusive prefix is its
  group's anchor A(g), the sum of the tiles before the group, plus the
  group's aggregates below b, 4 a lane summed in order, then the lanes'
  sums by butterfly; the group's last tile publishes A(g + 1) = A(g) + (its
  sum + its aggregate), the two low mantissa bits of a float64 anchor
  cleared for the status word;
* the scan: element j of a thread is (float32(prefix) + the sum below the
  thread) + the thread's own running sum; exclusive = inclusive - element.

The look-back is run under random schedules (tiles start in id order; each
publishes its aggregate and looks back when the schedule says so, and a
look-back completes only once everything it reads is published): every
schedule finishes, and gives the same prefixes, bit for bit, as the
schedule-free formula.  float32 prefixes stay within 1e-6 of the float64
running sum; int32 and uint32 prefixes equal ``np.cumsum`` with wrapping.
``tests/test_torch_cuda.py`` holds the kernel to :func:`k5_model` bit for
bit on the card.
"""

import numpy as np
import pytest
import torch

# uint32 sums wrap by design
pytestmark = pytest.mark.filterwarnings("ignore:overflow encountered")

from tpusort_torch.kernels import scanhist as ts

THREADS, ITEMS = 512, 16
TILE = THREADS * ITEMS
GROUP, SLOTS = 128, 4          # tiles a group, descriptors a look-back lane


def test_model_constants_match_the_wrapper():
    assert ts.SCAN_TILE == TILE and ts.SCAN_GROUP == GROUP == 32 * SLOTS


def _carry(dtype):
    """The look-back's sum type: float64 for float32, else the words."""
    return np.float64 if dtype == np.float32 else np.uint32


def _anchor_word(c, dtype):
    """What a published anchor holds: float64 with its two lowest mantissa
    bits cleared (they carry the status); uint32 as it is."""
    if dtype != np.float32:
        return c
    return (np.asarray(c, np.float64).view(np.uint64)
            & ~np.uint64(3)).view(np.float64)


def _warp_inclusive(v):
    """Hillis-Steele inclusive scan along the last axis (32 lanes), as
    warp_inclusive adds with __shfl_up_sync."""
    lane = np.arange(32)
    for d in (1, 2, 4, 8, 16):
        up = np.zeros_like(v)
        up[..., d:] = v[..., :-d]
        v = np.where(lane >= d, v + up, v)
    return v


def _tiles(x):
    """(nb, 512, 16) elements of each tile, zero past n; the thread sums in
    order; the sum below each thread and the tile aggregates
    (block_exclusive)."""
    n = x.shape[0]
    nb = -(-n // TILE)
    v = np.zeros(nb * TILE, dtype=x.dtype)
    v[:n] = x
    v = v.reshape(nb, THREADS, ITEMS)
    s = v[:, :, 0].copy()
    for j in range(1, ITEMS):
        s = s + v[:, :, j]
    inc = _warp_inclusive(s.reshape(nb, THREADS // 32, 32))
    excl = np.zeros_like(inc)
    excl[..., 1:] = inc[..., :-1]
    w = np.zeros((nb, 32), dtype=x.dtype)
    w[:, :THREADS // 32] = inc[..., 31]
    winc = _warp_inclusive(w)
    wexcl = np.zeros_like(winc)
    wexcl[:, 1:] = winc[:, :-1]
    below = (wexcl[:, :THREADS // 32, None] + excl).reshape(nb, THREADS)
    return v, below, winc[:, 31]


def _group_sum(aggs, first, r, dtype):
    """The look-back's fixed tree over the group's aggregates at slots
    [0, r): each lane its 4 slots in order, then a butterfly."""
    c = _carry(dtype)
    lanes = np.zeros(32, dtype=c)
    for lane in range(32):
        for k in range(SLOTS):
            i = lane * SLOTS + k
            if i < r:
                lanes[lane] = lanes[lane] + c(aggs[first + i])
    for d in (1, 2, 4, 8, 16):
        lanes = lanes + lanes[np.arange(32) ^ d]
    assert (lanes == lanes[0]).all()      # every lane the same bits
    return lanes[0]


def prefixes(aggs, dtype):
    """Each tile's exclusive prefix, schedule-free: the group's anchor plus
    the group's tree sum below the tile."""
    c = _carry(dtype)
    nb = aggs.shape[0]
    out, anchor = [], c(0)
    for b in range(nb):
        g, r = divmod(b, GROUP)
        s = _group_sum(aggs, g * GROUP, r, dtype)
        out.append(anchor + s)
        if r == GROUP - 1 and b + 1 < nb:
            anchor = _anchor_word(anchor + (s + c(aggs[b])), dtype)
    return np.array(out, dtype=c)


def simulate(aggs, dtype, rng, resident):
    """The look-back under one random schedule: up to ``resident`` tiles in
    flight, each started in id order; a tile publishes its aggregate, then
    its look-back completes once the group's aggregates below it and its
    anchor are published (the group's last tile then publishes the next
    anchor).  Returns the prefixes the tiles computed."""
    c = _carry(dtype)
    nb = aggs.shape[0]
    published = np.zeros(nb, dtype=bool)
    anchors = {0: c(0)}
    got = [None] * nb
    started, active = 0, []
    while started < nb or active:
        moves = []
        if started < nb and len(active) < resident:
            moves.append(("start", None))
        for b in active:
            moves.append(("publish" if not published[b] else "look", b))
        assert moves, "deadlock"
        kind, b = moves[rng.integers(len(moves))]
        if kind == "start":
            active.append(started)
            started += 1
        elif kind == "publish":
            published[b] = True
        else:
            g, r = divmod(b, GROUP)
            if not published[g * GROUP:b].all() or g not in anchors:
                continue               # spins: try again later
            s = _group_sum(aggs, g * GROUP, r, dtype)
            got[b] = anchors[g] + s
            if r == GROUP - 1 and b + 1 < nb:
                anchors[g + 1] = _anchor_word(
                    anchors[g] + (s + c(aggs[b])), dtype)
            active.remove(b)
    return np.array(got, dtype=c)


def k5_model(x, exclusive=False):
    """K5's output for a 1-D int32, uint32 or float32 numpy array, bit for
    bit as the kernel computes it."""
    dtype = x.dtype
    words = x.view(np.uint32) if dtype == np.int32 else x
    v, below, aggs = _tiles(words)
    pre = prefixes(aggs, words.dtype)
    head = pre.astype(words.dtype)[:, None] + below
    run = np.zeros_like(below)
    out = np.empty_like(v)
    for j in range(ITEMS):
        run = run + v[:, :, j]
        inc = head + run
        out[:, :, j] = inc - v[:, :, j] if exclusive else inc
    return out.reshape(-1)[: x.shape[0]].view(dtype)


def _aggregates(nb, dtype, rng):
    if dtype == np.float32:
        return rng.random(nb).astype(np.float32) * np.float32(8192)
    return rng.integers(0, 1 << 32, nb, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("dtype", [np.float32, np.uint32])
@pytest.mark.parametrize("nb", [1, 2, 31, 32, 33, 127, 128, 129, 257, 1000,
                                8 * GROUP + 1])
def test_every_schedule_gives_the_same_prefixes(dtype, nb):
    rng = np.random.default_rng(nb * 17 + (dtype == np.float32))
    aggs = _aggregates(nb, dtype, rng)
    want = prefixes(aggs, dtype)
    for seed in range(4):
        srng = np.random.default_rng(seed)
        resident = int(srng.integers(1, 400))
        got = simulate(aggs, dtype, srng, resident)
        assert got.tobytes() == want.tobytes(), (seed, resident)
    if dtype == np.float32:
        exact = np.concatenate([[0.0], np.cumsum(aggs.astype(np.float64))])
        np.testing.assert_allclose(want, exact[:-1], rtol=1e-12, atol=1e-6)
    else:
        exact = np.concatenate([[0], np.cumsum(aggs, dtype=np.uint32)])
        np.testing.assert_array_equal(want, exact[:-1])


@pytest.mark.parametrize("dtype", [np.int32, np.uint32])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 3 * TILE + 77,
                               GROUP * TILE + 5])
def test_integer_model_is_cumsum(dtype, exclusive, n):
    """int32 and uint32 outputs equal np.cumsum with wrapping, and the
    port's plain version."""
    rng = np.random.default_rng(n)
    x = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32) \
        .view(dtype)
    got = k5_model(x, exclusive)
    want = np.cumsum(x, dtype=dtype)
    if exclusive:
        want = want - x
    np.testing.assert_array_equal(got, want)
    plain = ts.prefix_sum_tiles(torch.from_numpy(x), exclusive=exclusive)
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("exclusive", [False, True])
def test_float_model_within_tolerance(exclusive):
    """float32 over 300 tiles (3 groups): within 1e-6 of the float64
    running sum, and zeros and ones exactly (every partial sum below
    2^24)."""
    rng = np.random.default_rng(5)
    n = 300 * TILE + 11
    x = rng.random(n).astype(np.float32)
    got = k5_model(x, exclusive).astype(np.float64)
    exact = np.cumsum(x.astype(np.float64))
    if exclusive:
        exact = exact - x
    np.testing.assert_allclose(got[1:], exact[1:], rtol=1e-6)
    bits = (rng.random(n) < 0.5).astype(np.float32)
    want = np.cumsum(bits, dtype=np.float64) - (bits if exclusive else 0)
    np.testing.assert_array_equal(k5_model(bits, exclusive), want)
