"""A numpy model of K4 (``tpusort_torch/csrc/collapse.cu``), the collapse of
segments' valid prefixes into dense outputs, against its plain PyTorch
version and the Pallas ``collapse_segments`` in interpret mode, on the CPU.

The kernel runs only on a card.  What can be checked without one is the
arithmetic it is made of, written here as the ``.cu`` file writes it: the
offsets (each count clamped to [0, seg], their exclusive cumsum, by one
CTA in rounds of 8 counts a thread and a scan over the threads); the chunk
map (CTA c owns the output words [8192 c, min(n_out, 8192 (c + 1)))); the
binary searches for the segments of a chunk's first and last word; the
piece-by-piece copy where fewer than 16 segments meet the chunk (a scalar
head to a 16-byte boundary, 16-byte stores, a scalar tail), and else each
thread's walk over its words t + 256 r, on from its previous word's
segment.  The model must give the plain version's output bit for bit and
write each output word of each operand exactly once.  The card holds the kernel itself to
the plain version (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases
14, 28 and 33).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusort.kernels import collapse as jc
from tpusort_torch.kernels.collapse import collapse_segments_plain

THREADS, CHUNK = 256, 8192          # csrc/collapse.cu
GROUPS, PIECES = 4, 16              # kCollapseGroups, kCollapsePieces
OFFSET_THREADS, OFFSET_PER = 1024, 8


def _offsets(counts, seg):
    """collapse_offsets_kernel: in rounds of 1024 x 8 counts, thread t sums
    the clamped counts of its 8, an exclusive scan of the sums over the
    threads, then each thread writes its 8 offsets; off[nseg] last."""
    nseg = len(counts)
    c = np.clip(counts.astype(np.int64), 0, seg)
    off = np.full(nseg + 1, -1, dtype=np.int64)
    base = 0
    for r0 in range(0, nseg, OFFSET_THREADS * OFFSET_PER):
        blk = np.zeros(OFFSET_THREADS * OFFSET_PER, dtype=np.int64)
        part = c[r0:r0 + len(blk)]
        blk[:len(part)] = part
        blk = blk.reshape(OFFSET_THREADS, OFFSET_PER)
        sums = blk.sum(axis=1)
        run = base + np.cumsum(sums) - sums
        for t in range(OFFSET_THREADS):
            r = run[t]
            for j in range(OFFSET_PER):
                if r0 + t * OFFSET_PER + j < nseg:
                    off[r0 + t * OFFSET_PER + j] = r
                r += blk[t, j]
        base += sums.sum()
    off[nseg] = base
    assert (off >= 0).all()
    return off


def _segment_of(off, o, a, b):
    """The largest s in [a, b] with off[s] <= o (off[a] <= o)."""
    assert off[a] <= o
    while a < b:
        m = (a + b + 1) >> 1
        if off[m] <= o:
            a = m
        else:
            b = m - 1
    return a


def _copy_piece(src, out, a, n, stores):
    """copy_piece: output words [a, a + n) from src (None: zeros), a
    scalar head to a 4-word boundary, 16-byte stores of 4 words (thread t's
    at head + 4 t + 1024 u), a scalar tail."""
    head = min(n, (4 - a % 4) % 4)
    end = head + ((n - head) & ~3)
    word = (lambda i: 0) if src is None else (lambda i: src[i])
    idx = list(range(head))
    for q0 in range(head, end, 4 * THREADS * GROUPS):
        for t in range(THREADS):
            for u in range(GROUPS):
                q = q0 + 4 * t + 4 * THREADS * u
                if q < end:
                    assert (a + q) % 4 == 0            # a 16-byte store
                    idx.extend(range(q, q + 4))
    idx.extend(range(end, n))
    for i in idx:
        out[a + i] = word(i)
        stores[a + i] += 1


def k4_model(ops, counts, n_out):
    """K4 on numpy uint32 (nseg, seg) operands: (dense outputs, (n_out,)
    number of stores to each output word of each operand, the number of
    CTAs, how many took the piece-by-piece path)."""
    nseg, seg = ops[0].shape
    off = _offsets(counts, seg)
    outs = [np.full(n_out, 0xDEADBEEF, dtype=np.uint32) for _ in ops]
    stores = np.zeros((len(ops), n_out), dtype=np.int64)
    blocks = -(-n_out // CHUNK)
    by_piece = 0
    for c in range(blocks):
        o0 = c * CHUNK
        o1 = min(o0 + CHUNK, n_out)
        s_first = _segment_of(off, o0, 0, nseg)
        s_last = _segment_of(off, o1 - 1, 0, nseg)
        if s_last - s_first < PIECES:
            by_piece += 1
            for s in range(s_first, s_last + 1):
                a = max(o0, off[s])
                b = min(o1, off[s + 1]) if s < nseg else o1
                if a >= b:
                    continue
                for k, (op, out) in enumerate(zip(ops, outs)):
                    src = op[s, a - off[s]:] if s < nseg else None
                    assert s == nseg or b - off[s] <= seg
                    _copy_piece(src, out, a, b - a, stores[k])
            continue
        for k, (op, out) in enumerate(zip(ops, outs)):
            for tid in range(THREADS):
                s = s_first
                start = off[s]
                end = off[s + 1] if s < nseg else np.iinfo(np.int64).max
                for o in range(o0 + tid, o1, THREADS):
                    if s < s_last and o >= end:
                        s = _segment_of(off, o, s + 1, s_last)
                        start = off[s]
                        end = (off[s + 1] if s < nseg
                               else np.iinfo(np.int64).max)
                    assert s == nseg or (start <= o < end
                                         and o - start < seg)
                    out[o] = op[s, o - start] if s < nseg else 0
                    stores[k, o] += 1
    return outs, stores, blocks, by_piece


def _case(rng, name):
    nseg, seg, n_ops = {
        "zeros": (40, 256, 1), "one_segment": (1, 40960, 2),
        "tiny": (3000, 128, 1), "cut_mid": (6, 4096, 2), "sum": (9, 1024, 1),
        "ops16": (5, 1024, 16), "empty": (7, 128, 1), "clamped": (12, 512, 2),
    }[name]
    ops = [rng.integers(0, 1 << 32, (nseg, seg), dtype=np.uint32)
           for _ in range(n_ops)]
    counts = rng.integers(0, seg + 1, nseg)
    if name == "zeros":
        counts[rng.random(nseg) < 0.8] = 0
    elif name == "one_segment":
        counts[0] = seg - 3
    elif name == "tiny":
        counts = rng.integers(0, 4, nseg)
    elif name == "empty":
        counts[:] = 0
    elif name == "clamped":
        counts[::3] = seg + 50
        counts[1::4] = -7
    total = int(np.clip(counts, 0, seg).sum())
    n_out = {"cut_mid": total - 1234, "ops16": total - 3}.get(name, total)
    return ops, counts.astype(np.int32), n_out


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("name", ["zeros", "one_segment", "tiny", "cut_mid",
                                  "sum", "ops16", "empty", "clamped"])
def test_k4_model_matches_plain(name):
    """Zero counts, one segment over several chunks, many tiny segments in
    one chunk, n_out cutting a segment, sum == n_out, 16 operands, no valid
    word, counts past seg and below 0: bit for bit against
    ``collapse_segments_plain``, each output word stored once."""
    rng = np.random.default_rng(len(name) * 31 + 5)
    ops, counts, n_out = _case(rng, name)
    want = collapse_segments_plain([_i32(o) for o in ops],
                                   torch.from_numpy(counts), n_out)
    outs, stores, blocks, by_piece = k4_model(ops, counts, n_out)
    assert blocks == -(-n_out // CHUNK)
    # 16 segments or more meet a chunk of tiny or mostly empty segments
    assert by_piece == (0 if name in ("tiny", "zeros") else blocks)
    assert (stores == 1).all()
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o, w.numpy().view(np.uint32))


def test_k4_model_matches_pallas():
    """Segments of several sizes, zero counts and n_out below the sum,
    against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(8)
    nseg, seg = 12, 1024
    ops = [rng.integers(0, 1 << 32, (nseg, seg), dtype=np.uint32)
           for _ in range(2)]
    counts = rng.integers(0, seg + 1, nseg).astype(np.int32)
    counts[[2, 5]] = 0
    n_out = int(counts.sum()) - 100
    want = jc.collapse_segments([jnp.asarray(o) for o in ops],
                                jnp.asarray(counts), n_out, interpret=True)
    outs, _, _, _ = k4_model(ops, counts, n_out)
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o, np.asarray(w))
