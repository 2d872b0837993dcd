"""The port's K4 (``kernels.collapse.collapse_segments``) and the general
path's packed leaf (``ops.msd._leaf_sort``: K3 then K4), on CPU tensors,
against ``tpusort`` in Pallas interpret mode, bit for bit.

K4 is held against both Pallas kernels: the grouped one, and the chunked
one that segments over the VMEM budget take (forced here by a smaller
budget, as ``tests/test_kernels.py`` does).  Inputs are numpy arrays from a
seed.  The CUDA kernels are held against their plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusort.kernels import collapse as jc
from tpusort.ops import msd as jm
from tpusort_torch.kernels import collapse as tc
from tpusort_torch.ops import msd as tm

G = dict(k=1024, r=8, s1=256, s=128, leaf_max=1024)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("mode", ["grouped", "chunked"])
def test_collapse_matches_pallas(monkeypatch, mode):
    """Zero counts, full segments, and sum(seg_counts) above n_out (the
    data past n_out is dropped)."""
    rng = np.random.default_rng(300 + len(mode))
    if mode == "chunked":
        nseg, seg = 4, 1280
        monkeypatch.setattr(jc, "_VMEM_BUDGET", 3 * 128 * 4)   # 8-row chunks
    else:
        nseg, seg = 16, 256
    ops = [rng.integers(0, 2**32, (nseg, seg), dtype=np.uint32)
           for _ in range(2)]
    counts = rng.integers(0, seg + 1, nseg).astype(np.int32)
    counts[1] = 0
    counts[2] = seg
    counts[-1] = 0
    n_out = int(counts.sum()) - 300
    want = jc.collapse_segments([jnp.asarray(o) for o in ops],
                                jnp.asarray(counts), n_out, interpret=True)
    got = tc.collapse_segments([_i32(o) for o in ops],
                               torch.from_numpy(counts), n_out)
    for g, w, o in zip(got, want, ops):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))
        dense = np.concatenate([o[s, :counts[s]] for s in range(nseg)])
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      dense[:n_out])


def test_collapse_checks():
    x = torch.zeros(4, 256, dtype=torch.int32)
    c = torch.full((4,), 10, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 128"):
        tc.collapse_segments([x[:, :100]], c, 10)
    with pytest.raises(ValueError, match="seg_counts"):
        tc.collapse_segments([x], c[:3], 10)
    with pytest.raises(ValueError, match="share"):
        tc.collapse_segments([x, x[:2]], c, 10)
    with pytest.raises(ValueError, match="device"):
        tc.collapse_segments([x.to("meta")], c.to("meta"), 10)
    # counts past the segment clip to it; slots past the sum are zero
    big = torch.tensor([300, -5, 0, 1], dtype=torch.int32)
    (out,) = tc.collapse_segments([x + 7], big, 300)
    assert torch.equal(out[:257], torch.full((257,), 7, dtype=torch.int32))
    assert torch.equal(out[257:], torch.zeros(43, dtype=torch.int32))


@pytest.mark.parametrize("begin_bit,end_bit", [(0, 24), (4, 20)])
def test_packed_leaf_matches_pallas(begin_bit, end_bit):
    """The last K1c pass's runs of n = 3000 pairs through both leaves: the
    port's K3 + K4 against ``tpusort.ops.msd._leaf_sort`` (K3 in interpret
    mode) and ``collapse_segments``.  At [0, 24) two passes leave 64
    segments of 128, which pack into one K3 row with a 6-bit segment id,
    so the last segment's invalid slots carry the all-ones word; [4, 20)
    takes one pass and packs its 8 segments of 1024 into one row."""
    n = 3000
    rng = np.random.default_rng(310 + begin_bit)
    key = rng.integers(0, 2**32, n, dtype=np.uint32)
    val = rng.integers(0, 2**32, n, dtype=np.uint32)
    plan = jm.plan_msd(n, begin_bit, end_bit, leaf_profile="packed", **G)
    tplan = tm.plan_msd(n, begin_bit, end_bit, leaf_profile="packed", **G)
    idx_bits = plan.seg.bit_length()        # seg is a power of two here
    assert plan.rem_width + idx_bits + 1 <= 32                   # narrow
    ops = [torch.nn.functional.pad(_i32(a), (0, plan.m1 - n))
           for a in (key, val)]
    data, (ct, q), overflow = tm.run_passes(ops, 1, n, tplan, general=True)
    assert not bool(overflow)
    flat = [jnp.asarray(d.numpy().view(np.uint32)) for d in data]
    valid = (np.arange(q)[None, None, :] < ct.numpy().reshape(
        plan.n_segments, plan.seg // q, 1)).reshape(plan.n_segments,
                                                    plan.seg)
    jops, seg_counts = jm._leaf_sort(flat, slice(0, 1), jnp.asarray(valid),
                                     plan, use_pallas=True)
    want = jc.collapse_segments(
        [o.reshape(plan.n_segments, plan.seg) for o in jops], seg_counts, n,
        interpret=True)
    got = tm._leaf_sort(list(data), 1, ct, q, tplan, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))
    mask = ((1 << end_bit) - 1) & ~((1 << begin_bit) - 1)
    perm = np.argsort(key & np.uint32(mask), kind="stable")
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), key[perm])
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32), val[perm])
