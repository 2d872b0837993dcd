"""A numpy model of K8 (``tpusort_torch/csrc/partition_tiles.cu``), the tile
partition by a sortkey, against its plain PyTorch version and the Pallas
``partition_tiles`` in interpret mode, on the CPU.

The kernel runs only on a card.  What can be checked without one is the
arithmetic it is made of, written here as the ``.cu`` file writes it: the
AND and OR of the sortkey and the vote (every slot's low log2(K) bits equal
to the slot), which give the bits a pass must rank; the LSD passes of at
most 8 bits, each the blocked rank of ``csrc/block_rank.cuh`` (warps over
contiguous spans, one ballot a digit bit a step, the group leader's count
plus the group's lanes below, then the digit-major scan) over the tile in
its current order, the order kept as slot indices in the three 2-byte
arrays the kernel rotates; the staging at each slot's final position; and
the stores, pieces of 128 words whose lane l reads its 4 clamped words in
an order rotated by l / 8 (32 banks a step) and stores them as 16 bytes.
The model must give the plain version's output on every slot, those past
a run's count too, and store each output word exactly once.  The card
holds the kernel itself to the plain version (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phases 29 and 33).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusort.kernels.partition import partition_tiles as j_partition_tiles
from tpusort_torch.kernels.partition import partition_tiles_plain
from tpusort_torch.ops import msd as tm

WARPS = 16          # csrc/block_rank.cuh: kRankWarps
PIECE = 128         # csrc/partition_tiles.cu: kTilePiece
LANES = np.arange(32)


def _ranks(d, K, bits):
    """rank_walk and scan_warp_counts over the digits ``d`` of the K
    positions in their current order: each position's new place (the
    digit's base, its warp's offset in the digit, its warp-local rank),
    and the warp-local ranks."""
    walkers = min(WARPS, K // 32)
    span = K // walkers
    bins = 1 << bits
    steps = d.reshape(walkers, span // 32, 32)
    # one ballot a bit: each lane's mask of the lanes with its digit
    peers = np.full(steps.shape, 0xFFFFFFFF, dtype=np.int64)
    for b in range(bits):
        on = (steps >> b) & 1
        ballot = (on << LANES).sum(axis=2, keepdims=True)
        peers &= np.where(on == 1, ballot, ~ballot & 0xFFFFFFFF)
    same = steps[..., :, None] == steps[..., None, :]
    assert np.array_equal(peers, (same * (1 << LANES)).sum(axis=3))
    below = np.bitwise_count(peers & ((1 << LANES) - 1))
    # the leader's count before the step: the digit's lanes in earlier
    # steps of the warp
    onehot = np.zeros((walkers, span // 32, bins), dtype=np.int64)
    np.add.at(onehot, (np.arange(walkers)[:, None, None],
                       np.arange(span // 32)[None, :, None], steps), 1)
    before = np.cumsum(onehot, axis=1) - onehot
    local = np.take_along_axis(before, steps, axis=2) + below
    wcount = onehot.sum(axis=1)                       # (warps, bins)
    hist = wcount.sum(axis=0)
    woff = np.cumsum(wcount, axis=0) - wcount         # digit-major scan
    base = np.cumsum(hist) - hist
    warp = np.repeat(np.arange(walkers), span)
    local = local.reshape(-1)
    return base[d] + woff[warp, d] + local, local


def k8_model(sortkey, data, starts, R, S):
    """K8 on one numpy uint32 tile: (outputs, (R*S,) number of stores to
    each output word, the number of passes)."""
    K = sortkey.shape[0]
    key = sortkey.astype(np.int64)
    low = K - 1
    # 1. AND, OR, and the vote
    all_ = int(np.bitwise_and.reduce(key))
    any_ = int(np.bitwise_or.reduce(key))
    in_order = bool(((key & low) == np.arange(K)).all())
    varying = all_ ^ any_
    if in_order:
        varying &= ~low
    lo = (varying & -varying).bit_length() - 1 if varying else 32
    hi = varying.bit_length()
    passes = max(0, (hi - lo + 7) // 8)
    # 2. the passes: x0 and x1 share the staging buffer, dest apart
    mem = {"x0": None, "x1": None, "dest": np.arange(K)}
    perm = None
    for p in range(passes):
        width = min(8, hi - lo)
        last = p == passes - 1
        out = "dest" if last else ("x0" if (passes - 1 - p) & 1 else "x1")
        rank = next(a for a in ("dest", "x1", "x0") if a not in (out, perm))
        assert out != perm
        slot = np.arange(K) if perm is None else mem[perm]
        d = (key[slot] >> lo) & ((1 << width) - 1)
        pos, local = _ranks(d, K, width)
        mem[rank] = local          # the walk's ranks, over that array
        # the destinations: the order re-read after the walk
        slot = np.arange(K) if perm is None else mem[perm]
        assert np.array_equal((key[slot] >> lo) & ((1 << width) - 1), d)
        new = np.empty(K, dtype=np.int64)
        if last:
            new[slot] = pos        # dest by slot
        else:
            new[pos] = slot        # the order by position
        mem[out] = new
        perm = out
        lo += width
    dest = mem["dest"]
    assert np.array_equal(np.sort(dest), np.arange(K))
    # 3. staged by final position, stored in pieces from clamped positions
    outs, stores = [], np.zeros(R * S, dtype=np.int64)
    rot = LANES >> 3
    for v in data:
        stage = np.empty(K, dtype=np.uint32)
        stage[dest] = v
        out = np.full(R * S, 0xDEADBEEF, dtype=np.uint32)
        for pc in range(R * S // PIECE):
            o = pc * PIECE + 4 * LANES
            dd = o // S
            assert (dd == dd[0]).all()                  # one run a piece
            at = starts[dd] + (o - dd * S)
            got = np.empty((32, 4), dtype=np.uint32)
            for kk in range(4):                         # t[kk]: word kk+rot
                w = (kk + rot) & 3
                a = np.clip(at + w, 0, K - 1)
                if (at >= 0).all() and (at + 3 < K).all():
                    assert len(set((a % 32).tolist())) == 32   # no conflict
                got[LANES, w] = stage[a]
            assert (o % 4 == 0).all()                   # 16-byte stores
            out[o[:, None] + np.arange(4)] = got
            if v is data[0]:
                np.add.at(stores, o[:, None] + np.arange(4), 1)
        outs.append(out)
    return outs, stores, passes


def _engine_sortkey(rng, T, K, R, S):
    """The per-phase engine's K8 inputs from ``pass_sortkey``: a pass over
    one key plane valid where a previous pass's runs of S say."""
    spec = tm.PassSpec(n_seg=1, t_seg=T, k=K, r=R, s=S, lo_bit=7,
                       width=max(1, R.bit_length() - 1))
    plane = torch.from_numpy(rng.integers(0, 1 << 32, (T, K),
                                          dtype=np.uint32).view(np.int32))
    run_counts = torch.from_numpy(
        rng.integers(0, 129, T * K // 128).astype(np.int32))
    sortkey, starts, _ = tm.pass_sortkey([plane], run_counts, 128, spec)
    return sortkey.numpy().view(np.uint32), starts.numpy()


def _case(rng, T, K, R, S, keys):
    if keys == "engine":
        return _engine_sortkey(rng, T, K, R, S)
    lk = K.bit_length() - 1
    if keys == "ties":             # few words, the top bit among them
        sk = (rng.integers(0, 6, (T, K)) * 0x2AAAAAAB) & 0xFFFFFFFF
    elif keys == "vote":           # the digit over a permutation of slots
        sk = (rng.integers(0, R + 1, (T, K)) << lk) \
            | np.stack([rng.permutation(K) for _ in range(T)])
    elif keys == "constant":
        sk = np.full((T, K), 0x9E3779B9)
    else:
        sk = rng.integers(0, 1 << 32, (T, K))
    starts = np.sort(rng.integers(-3, K + S, (T, R)), axis=1)
    return sk.astype(np.uint32), starts.astype(np.int32)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("K,R,S,nd,keys,passes", [
    (128, 1, 128, 1, "engine", 1), (2048, 8, 384, 2, "engine", 1),
    (16384, 32, 768, 1, "engine", 1), (2048, 128, 128, 8, "engine", 1),
    (128, 8, 256, 2, "ties", 4), (2048, 8, 128, 1, "ties", 4),
    (2048, 32, 256, 2, "vote", 3), (16384, 128, 128, 1, "vote", 3),
    (2048, 1, 128, 1, "constant", 0), (2048, 8, 512, 8, "random", 4),
])
def test_k8_model_matches_plain(K, R, S, nd, keys, passes):
    """Every slot, the clamped ones too, against ``partition_tiles_plain``;
    each output word stored once; the engine's sortkey ranked in one pass
    (the vote holds), tied and vote-failing sortkeys in several."""
    rng = np.random.default_rng(K + 7 * R + S + nd + len(keys))
    sortkey, starts = _case(rng, 1, K, R, S, keys)
    data = [rng.integers(0, 1 << 32, (1, K), dtype=np.uint32)
            for _ in range(nd)]
    want = partition_tiles_plain([_i32(sortkey), *map(_i32, data)],
                                 _i32(starts), r=R, s=S)
    outs, stores, n_passes = k8_model(sortkey[0], [d[0] for d in data],
                                      starts[0], R, S)
    assert n_passes == passes
    assert (stores == 1).all()
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o, w.numpy()[0].view(np.uint32))


@pytest.mark.parametrize("K,R,S", [(512, 8, 256)])
def test_k8_model_matches_pallas(K, R, S):
    """Unique sortkeys (the engine's) against the Pallas kernel in
    interpret mode, on the slots its counts mark valid (it leaves the
    others garbage)."""
    rng = np.random.default_rng(11)
    sortkey, starts = _engine_sortkey(rng, 1, K, R, S)
    data = rng.integers(0, 1 << 32, (1, K), dtype=np.uint32)
    (want,) = j_partition_tiles([jnp.asarray(sortkey), jnp.asarray(data)],
                                jnp.asarray(starts), r=R, s=S,
                                interpret=True)
    digit = sortkey[0] >> np.uint32(K.bit_length() - 1)
    counts = np.bincount(digit, minlength=R + 1)[:R]
    valid = (np.arange(S) < np.minimum(counts, S)[:, None]).reshape(-1)
    (out,), _, _ = k8_model(sortkey[0], [data[0]], starts[0], R, S)
    np.testing.assert_array_equal(out[valid], np.asarray(want)[0][valid])
