"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  This file
imports neither jax nor ``tpusort``, so it runs where only PyTorch and the
CUDA toolkit are installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Keys compare bit for bit: K1 and K1c on their counts and the slots they
mark valid, K2, K3, K4 and the sorts on their whole output.  K1c is stable,
so its payloads compare bit for bit too.  K2's payloads ride unstably,
so its multi-operand cases make plane 0 unique (a scrambled permutation),
where any correct sort gives one payload order; K1 and K3 break ties by
slot index, as their plain versions do, which the edge cases rely on.
"""

import numpy as np
import pytest
import torch

import tpusort_torch
from tpusort_torch import dtypes
from tpusort_torch.kernels import bitonic as tb
from tpusort_torch.kernels import collapse as tc
from tpusort_torch.kernels import partition as tp
from tpusort_torch.kernels import scanhist as tsh
from tpusort_torch.ops import histogram as th
from tpusort_torch.ops import scan as tsc
from tpusort_torch.ops import msd as tm
from tpusort_torch.ops.reference import (
    _mask_plane_bits, sort_rows_lex, sort_twiddled_reference)
from tpusort_torch.utils.datagen import segment_offsets, zipf_keys

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    return g


def _rand(gen, *shape):
    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                         device="cuda", generator=gen)


def _unique(gen, *shape):
    """int32 words that are all distinct: a random permutation times an odd
    constant (a bijection mod 2^32), spread over the whole range."""
    n = 1
    for d in shape:
        n *= d
    perm = torch.randperm(n, device="cuda", generator=gen)
    x = (perm * 0x9E3779B1) & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32).reshape(shape)


def _lex_chunks(planes, values, q, counts):
    """Sort each q-chunk's valid prefix lexicographically by the planes,
    the values carried (what an earlier pass leaves)."""
    T, K = planes[0].shape
    valid = (torch.arange(K, device="cuda") % q)[None, :] < \
        counts.repeat_interleave(q, dim=1)
    kp = [torch.where(valid, p, -1).reshape(-1, q) for p in planes]
    sp, sv = sort_rows_lex(kp, [v.reshape(-1, q) for v in values])
    return ([torch.where(valid, a.reshape(T, K), p) for a, p in zip(sp, planes)],
            [torch.where(valid, a.reshape(T, K), v) for a, v in zip(sv, values)])


def _sorted_chunks(gen, T, K, q):
    x = _rand(gen, T, K)
    counts = torch.randint(0, q + 1, (T, K // q), dtype=torch.int32,
                           device="cuda", generator=gen)
    valid = (torch.arange(K, device="cuda") % q)[None, :] < \
        counts.repeat_interleave(q, dim=1)
    key = torch.where(valid, x, -1).reshape(T, K // q, q)
    srt = (torch.sort(key ^ dtypes.INT32_MIN, dim=2).values
           ^ dtypes.INT32_MIN).reshape(T, K)
    return torch.where(valid, srt, x), counts


def _valid_slots(counts, r, s, t_seg):
    T = counts.shape[0]
    c = counts.clamp(0, s).reshape(T // t_seg, t_seg, r).transpose(1, 2)
    return (torch.arange(s, device=counts.device) < c[..., None]).reshape(-1)


@pytest.mark.parametrize("T,K,R,S,t_seg,lo_bit", [
    (4, 2048, 16, 256, 4, 28),
    (6, 16384, 32, 768, 3, 27),
    (2, 32768, 32, 1536, 1, 27),
])
def test_partition_pass0(gen, T, K, R, S, t_seg, lo_bit):
    x = _rand(gen, T, K)
    kw = dict(r=R, s=S, lo_bit=lo_bit, width=R.bit_length() - 1,
              n=T * K - 999, t_seg=t_seg)
    (out,), counts = tp.partition_pass_fused([x], [], None, **kw)
    (pout,), pcounts = tp.partition_pass_fused_plain([x], [], None,
                                                     q_in=None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(counts, pcounts)
    m = _valid_slots(counts, R, S, t_seg)
    assert torch.equal(out[m], pout[m])


@pytest.mark.parametrize("K,q,run", [(2048, 128, 128), (16384, 256, 256),
                                     (16384, 512, 512), (16384, 512, None)])
def test_partition_counts_chain(gen, K, q, run):
    T, R, S, t_seg = 4, 32, 512, 2
    x, cin = _sorted_chunks(gen, T, K, q)
    kw = dict(r=R, s=S, lo_bit=17, width=5, q_in=q, t_seg=t_seg, n=None)
    (out,), counts = tp.partition_pass_fused([x], [], cin, sorted_run=run,
                                             **kw)
    (pout,), pcounts = tp.partition_pass_fused_plain([x], [], cin, **kw)
    assert torch.equal(counts, pcounts)
    m = _valid_slots(counts, R, S, t_seg)
    assert torch.equal(out[m], pout[m])


@pytest.mark.parametrize("T,K,q,run", [
    (3, 2048, 128, 0), (5, 24576, 512, 512), (2, 12288, 256, 256),
    (2, 32768, 512, 512), (4, 384, 128, 128),
])
def test_leaf_collapse(gen, T, K, q, run):
    x, counts = _sorted_chunks(gen, T, K, q)
    n_out = int(counts.sum())
    got = tb.sort_tiles_counts_collapsed(x, counts, q, n_out, sorted_run=run)
    (want,) = tb.sort_tiles_counts_collapsed_plain([x], counts, q, n_out)
    assert torch.equal(got, want)


@pytest.mark.parametrize("nk,nv,T,K,R,S,t_seg,lo_bit,chain", [
    (1, 1, 4, 2048, 16, 256, 4, 28, False),
    (2, 1, 6, 16384, 32, 768, 3, 30, False),    # digit straddles planes
    (2, 2, 4, 16384, 32, 512, 2, 59, True),
    (3, 1, 2, 16384, 32, 512, 1, 91, True),     # 224 KB: the largest mode
    (3, 0, 3, 8192, 32, 256, 3, 91, False),
    (2, 8, 2, 4096, 16, 512, 2, 60, True),      # the most payload words
])
def test_partition_planes_payloads(gen, nk, nv, T, K, R, S, t_seg, lo_bit,
                                   chain):
    planes = [_unique(gen, T, K)] + [_rand(gen, T, K) for _ in range(nk - 1)]
    vals = [_rand(gen, T, K) for _ in range(nv)]
    kw = dict(r=R, s=S, lo_bit=lo_bit, width=R.bit_length() - 1,
              t_seg=t_seg)
    cin, q, run = None, None, None
    if chain:
        q = 256
        cin = torch.randint(0, q + 1, (T, K // q), dtype=torch.int32,
                            device="cuda", generator=gen)
        planes, vals = _lex_chunks(planes, vals, q, cin)
        kw.update(q_in=q, n=None)
        run = q
    else:
        kw.update(q_in=None, n=T * K - 999)
    got, counts = tp.partition_pass_fused(planes, vals, cin, sorted_run=run,
                                          unstable=True, **kw)
    want, pcounts = tp.partition_pass_fused_plain(planes, vals, cin, **kw)
    torch.cuda.synchronize()
    assert torch.equal(counts, pcounts)
    m = _valid_slots(counts, R, S, t_seg)
    for g, w in zip(got, want):
        assert torch.equal(g[m], w[m])


@pytest.mark.parametrize("nk,nv,T,K,q,run", [
    (1, 1, 3, 24576, 512, 512), (2, 1, 5, 12288, 512, 512),
    (2, 2, 2, 16384, 256, 256), (3, 1, 4, 12288, 512, 512),
    (3, 0, 2, 6144, 128, 0), (2, 1, 7, 1536, 128, 128),
])
def test_leaf_collapse_planes_payloads(gen, nk, nv, T, K, q, run):
    planes = [_unique(gen, T, K)] + [_rand(gen, T, K) for _ in range(nk - 1)]
    vals = [_rand(gen, T, K) for _ in range(nv)]
    counts = torch.randint(0, q + 1, (T, K // q), dtype=torch.int32,
                           device="cuda", generator=gen)
    if run:
        planes, vals = _lex_chunks(planes, vals, q, counts)
    n_out = int(counts.sum())
    got = tb.sort_tiles_counts_collapsed(planes + vals, counts, q, n_out,
                                         sorted_run=run, num_keys=nk)
    want = tb.sort_tiles_counts_collapsed_plain(planes + vals, counts, q,
                                                n_out, nk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("T,K,nv", [
    (1, 16384, 0), (1, 16384, 1), (1, 16000 - 128 * 3, 1), (3, 128, 2),
    (100, 384, 0), (8192, 2048, 1), (2, 32768, 1),
])
def test_sort_tiles(gen, T, K, nv):
    ops = [_unique(gen, T, K)] + [_rand(gen, T, K) for _ in range(nv)]
    got = tb.sort_tiles(ops)
    want = tb.sort_tiles_plain(ops)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("T,K", [(1, 1280), (3, 15616), (4, 384)])
def test_sort_tiles_virtual_pad_loses_ties(gen, T, K):
    """Rows of many genuine 0xFFFFFFFF keys, padded virtually to a power of
    two: the payloads must stay a permutation of the row's own."""
    keys = torch.where(_rand(gen, T, K) > 0, -1, _rand(gen, T, K))
    pos = torch.arange(K, dtype=torch.int32, device="cuda").repeat(T, 1)
    k_out, v_out = tb.sort_tiles([keys, pos])
    (want,) = tb.sort_tiles_plain([keys])
    assert torch.equal(k_out, want)
    assert torch.equal(torch.sort(v_out, dim=1).values, pos)
    assert torch.equal(torch.gather(keys, 1, v_out.long()), k_out)


@pytest.mark.parametrize("dtype,top", [(torch.uint32, -1),
                                       (torch.int32, (1 << 31) - 1)])
def test_single_tile_pairs_with_max_keys(gen, dtype, top):
    """Unstable pairs through K3 where a block of keys is the dtype's
    maximum, which twiddles to the all-ones virtual pad key."""
    n = 1280
    x = _rand(gen, n)
    x[100:900] = top
    x = x.view(dtype)
    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    tm.reset_counters()
    ko, vo = tpusort_torch.unstable_sort_pairs(x, idx)
    c = tm.counters()
    assert c["k3_launches"] == 1 and c["reference_routes"] == 0
    assert torch.equal(torch.sort(vo).values, idx)
    assert torch.equal(x.view(torch.int32)[vo.long()], ko.view(torch.int32))
    planes, traits = dtypes.twiddle_in(x)
    ref, _ = sort_twiddled_reference(planes, (), begin_bit=0, end_bit=32,
                                     total_bits=32)
    assert torch.equal(ko.view(torch.int32),
                       dtypes.twiddle_out(ref, traits).view(torch.int32))


def test_shapes_over_shared_memory_raise(gen):
    x = _rand(gen, 2, 32768)
    with pytest.raises(ValueError, match="shared memory"):
        tp.partition_pass_fused([x, x], [], None, r=32, s=1536, lo_bit=59,
                                width=5, n=100)
    c = torch.full((2, 64), 512, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        tb.sort_tiles_counts_collapsed([x, x], c, 512, 100, num_keys=2)
    with pytest.raises(ValueError, match="shared memory"):
        tb.sort_tiles([_rand(gen, 1, 65536)])


@pytest.mark.parametrize("n,nv,stable", [(16384, 0, True), (1000, 0, True),
                                         (4096, 1, False)])
def test_single_tile_path_on_card(gen, n, nv, stable):
    x = _unique(gen, n).view(torch.uint32)
    v = [torch.arange(n, dtype=torch.int32, device="cuda")] * nv
    tm.reset_counters()
    got = tpusort_torch.sort(x, v[0] if nv else None, stable=stable)
    c = tm.counters()
    assert c["k3_launches"] == 1 and c["reference_routes"] == 0
    keys = got[0] if nv else got
    want = torch.sort(x.view(torch.int32) ^ dtypes.INT32_MIN).values
    assert torch.equal(keys.view(torch.int32), want ^ dtypes.INT32_MIN)
    if nv:
        assert torch.equal(x.view(torch.int32)[got[1].long()],
                           keys.view(torch.int32))


@pytest.mark.parametrize("call", ["pairs", "pairs_desc", "unstable", "u64",
                                  "f64_desc", "i64_pairs", "argsort"])
def test_pair_and_64bit_sorts_on_card(gen, call):
    n = (1 << 20) + 4321
    x32 = _rand(gen, n)
    x64 = torch.stack([_rand(gen, n), _rand(gen, n)], 1).view(torch.int64)[:, 0]
    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    tm.reset_counters()
    if call in ("pairs", "pairs_desc", "unstable"):
        keys = x32.view(torch.uint32)
        desc = call == "pairs_desc"
        ko, vo = tpusort_torch.sort(keys, idx, descending=desc,
                                    stable=call != "unstable")
        planes, traits = dtypes.twiddle_in(keys, descending=desc)
        (ref,), (rv,) = sort_twiddled_reference(planes, (idx,), begin_bit=0,
                                                end_bit=32, total_bits=32)
        assert torch.equal(ko.view(torch.int32), dtypes.twiddle_out(
            (ref,), traits, descending=desc).view(torch.int32))
        if call == "unstable":
            assert torch.equal(x32[vo.long()], ko.view(torch.int32))
            assert torch.equal(torch.sort(vo).values, idx)
        else:
            assert torch.equal(vo, rv)
    elif call == "argsort":
        got = tpusort_torch.argsort(x32)
        assert torch.equal(got, torch.sort(x32, stable=True).indices)
    else:
        dt = {"u64": torch.uint64, "f64_desc": torch.float64,
              "i64_pairs": torch.int64}[call]
        keys = x64.view(dt)
        desc = call == "f64_desc"
        if call == "i64_pairs":
            ko, vo = tpusort_torch.unstable_sort_pairs(keys, x64)
            assert torch.equal(vo, ko)
        else:
            ko = tpusort_torch.sort(keys, descending=desc)
        planes, traits = dtypes.twiddle_in(keys, descending=desc)
        ref, _ = sort_twiddled_reference(planes, (), begin_bit=0, end_bit=64,
                                         total_bits=64)
        want = dtypes.twiddle_out(ref, traits, descending=desc)
        assert torch.equal(ko.view(torch.int64), want.view(torch.int64))
    c = tm.counters()
    assert c["k1_launches"] >= 1 and c["k2_launches"] == 1
    assert c["overflow_fallbacks"] == 0 and c["reference_routes"] == 0


@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.float32])
@pytest.mark.parametrize("descending", [False, True])
def test_sort_on_card(gen, dtype, descending):
    x = _rand(gen, (1 << 20) + 4321).view(dtype)
    tm.reset_counters()
    got = tpusort_torch.sort(x, descending=descending)
    c = tm.counters()
    planes, traits = dtypes.twiddle_in(x, descending=descending)
    (ref,), _ = sort_twiddled_reference(planes, (), begin_bit=0, end_bit=32,
                                        total_bits=32)
    want = dtypes.twiddle_out((ref,), traits, descending=descending)
    assert got.device == x.device
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert c["k1_launches"] >= 1 and c["k2_launches"] == 1
    assert c["overflow_fallbacks"] == 0 and c["reference_routes"] == 0


@pytest.mark.parametrize("nk,nv,T,K,R,S,t_seg,lo_bit,q,digit,skew", [
    (1, 1, 4, 16384, 32, 768, 2, 19, None, False, False),   # pass 0
    (1, 0, 6, 2048, 8, 384, 3, 29, 128, False, False),      # keys only
    (2, 2, 4, 16384, 32, 640, 2, 30, 512, False, False),    # straddles
    (2, 4, 2, 8192, 32, 256, 1, 40, 256, False, True),      # counts > S
    (1, 3, 3, 4096, 8, 512, 3, 0, 1024, True, False),       # digit plane
    (2, 0, 5, 32768, 32, 1536, 5, 59, None, False, False),
    (4, 4, 2, 1024, 16, 128, 2, 120, 128, False, False),    # 4 planes
])
def test_partition_general(gen, nk, nv, T, K, R, S, t_seg, lo_bit, q, digit,
                           skew):
    """K1c (the general branch) against its plain version: stable, so every
    valid slot of every operand compares bit for bit."""
    ops = [_rand(gen, T, K) for _ in range(nk + nv)]
    width = R.bit_length() - 1
    if skew:     # half of each tile in digit 0: its runs overflow S
        p = nk - 1 - lo_bit // 32
        ops[p][:, ::2] &= ~(((1 << width) - 1) << (lo_bit % 32))
    kw = dict(r=R, s=S, lo_bit=lo_bit, width=width, t_seg=t_seg)
    cin = None
    if q:
        cin = torch.randint(0, q + 1, (T, K // q), dtype=torch.int32,
                            device="cuda", generator=gen)
        kw.update(q_in=q, n=None)
    else:
        kw.update(q_in=None, n=T * K - 999)
    dig = None
    if digit:
        dig = torch.randint(0, R + 3, (T, K), dtype=torch.int32,
                            device="cuda", generator=gen)
    tm.reset_counters()
    got, counts = tp.partition_pass_fused(ops[:nk], ops[nk:], cin, digit=dig,
                                          general=True, **kw)
    assert tm.mode_counters() == {("K1c", nk, nv): 1}
    want, pcounts = tp.partition_pass_general_plain(ops[:nk], ops[nk:], cin,
                                                    digit=dig, **kw)
    torch.cuda.synchronize()
    assert torch.equal(counts, pcounts)
    if skew:
        assert int(counts.max()) > S
    m = _valid_slots(counts, R, S, t_seg)
    for g, w in zip(got, want):
        assert torch.equal(g[m], w[m])


@pytest.mark.parametrize("nseg,seg,n_ops,cut", [
    (64, 128, 1, 0), (1000, 12288, 2, 0), (257, 6144, 3, 5000),
    (3, (1 << 20) + 1024, 2, 77),      # segments over 2^20 slots (K4c)
])
def test_collapse(gen, nseg, seg, n_ops, cut):
    ops = [_rand(gen, nseg, seg) for _ in range(n_ops)]
    counts = torch.randint(0, seg + 1, (nseg,), dtype=torch.int32,
                           device="cuda", generator=gen)
    counts[::7] = 0
    counts[1::5] = seg
    n_out = int(counts.sum()) - cut          # data past n_out is dropped
    got = tc.collapse_segments(ops, counts, n_out)
    want = tc.collapse_segments_plain(ops, counts, n_out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_sort_tiles_packed_leaf_sentinel(gen):
    """The packed leaf's rows: two segments of 6144 a row, so the last
    segment's invalid slots carry the word 0xFFFFFFFF, and the row is
    padded virtually from 12288 to 16384 slots of the same word.  The
    valid slots must come out in order, and the payloads must stay the
    row's own."""
    T, seg, idx_bits, rem_width = 8, 6144, 13, 18
    rem = torch.randint(0, 1 << rem_width, (T, 2, seg), device="cuda",
                        generator=gen)
    valid = torch.rand(T, 2, seg, device="cuda", generator=gen) < 0.7
    pos = torch.arange(seg, device="cuda")
    field = rem_width + idx_bits
    key = torch.where(valid, (rem << idx_bits) | pos, (1 << field) - 1)
    key |= torch.arange(2, device="cuda")[None, :, None] << field
    assert int(key.max()) == 0xFFFFFFFF
    key = (key - ((key >> 31) << 32)).to(torch.int32).reshape(T, 2 * seg)
    slot = torch.arange(2 * seg, dtype=torch.int32, device="cuda").repeat(T, 1)
    k_out, v_out = tb.sort_tiles([key, slot])
    (want,) = tb.sort_tiles_plain([key])
    assert torch.equal(k_out, want)
    assert torch.equal(torch.sort(v_out, dim=1).values, slot)
    assert torch.equal(torch.gather(key, 1, v_out.long()), k_out)


@pytest.mark.parametrize("call", ["keys_8_32", "pairs_0_24", "u64_pairs",
                                  "i64_argsort", "f64_range_desc",
                                  "lsb_in_value"])
def test_general_path_on_card(gen, call):
    """The general (digit, idx) path end to end: K1c passes, then the
    packed leaf (K3 + K4) or the wide leaf (K2), against the stable
    reference sort."""
    n = (1 << 20) + 4321
    x32 = _rand(gen, n)
    x64 = torch.stack([_rand(gen, n), _rand(gen, n)], 1).view(torch.int64)[:, 0]
    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    tm.reset_counters()
    if call == "lsb_in_value":
        ko, vo = tpusort_torch.sort_pairs_lsb_in_value(x32, idx, 2)
        comp = (x32.long() << 16) | (idx.long() & 0xFFFF)
        assert torch.equal(ko, x32[torch.sort(comp).indices])
        assert torch.equal(x32[vo.long()], ko)
        c = tm.counters()
        assert c["k1_launches"] >= 1 and c["k2_launches"] == 1
        return
    if call == "keys_8_32":
        keys, desc, bits, vals = x32.view(torch.uint32), False, (8, 32), ()
    elif call == "pairs_0_24":
        keys, desc, bits, vals = x32.view(torch.uint32), False, (0, 24), (idx,)
    elif call == "u64_pairs":
        keys, desc, bits, vals = x64.view(torch.uint64), False, (0, 64), (x64,)
    elif call == "f64_range_desc":
        keys, desc, bits, vals = x64.view(torch.float64), True, (20, 60), ()
    else:
        keys, desc, bits, vals = x64, False, (0, 64), ()
    if call == "i64_argsort":
        got = tpusort_torch.argsort(keys)
        assert torch.equal(got, torch.sort(keys, stable=True).indices)
    else:
        got = tpusort_torch.sort(keys, vals[0] if vals else None,
                                 descending=desc, begin_bit=bits[0],
                                 end_bit=bits[1])
        planes, traits = dtypes.twiddle_in(keys, descending=desc)
        words = [w for v in vals for w in (dtypes.split64(v)
                                           if v.element_size() == 8 else (v,))]
        ref, rv = sort_twiddled_reference(planes, words, begin_bit=bits[0],
                                          end_bit=bits[1],
                                          total_bits=traits.bits)
        want = dtypes.twiddle_out(ref, traits, descending=desc)
        ko = got[0] if vals else got
        w = torch.int64 if keys.element_size() == 8 else torch.int32
        assert torch.equal(ko.view(w), want.view(w))
        if vals:
            vo = got[1]
            if vo.element_size() == 8:
                assert torch.equal(vo, dtypes.join64(*rv, vo.dtype))
            else:
                assert torch.equal(vo, rv[0])
    c = tm.counters()
    assert c["k1c_launches"] >= 1 and c["k1_launches"] == 0
    assert c["k2_launches"] + c["k4_launches"] == 1
    assert c["overflow_fallbacks"] == 0 and c["reference_routes"] == 0


def _splitters(gen, planes, R, fracs):
    """(T, R-1) splitter words per plane: R-1 lexicographic quantiles of
    each tile's own keys, shifted a little between tiles; and fractions,
    a constant or drawn from [0, 65536]."""
    T, K = planes[0].shape
    sp, _ = sort_rows_lex(planes)
    at = (torch.arange(1, R, device="cuda") * K) // R
    shift = torch.randint(-K // (4 * R), K // (4 * R), (T, 1), device="cuda",
                          generator=gen)
    idx = (at[None, :] + shift).clamp(0, K - 1)
    words = [torch.gather(p, 1, idx) for p in sp]
    if fracs is None:
        f = torch.randint(0, 65537, (T, R - 1), dtype=torch.int32,
                          device="cuda", generator=gen)
    else:
        f = torch.full((T, R - 1), fracs, dtype=torch.int32, device="cuda")
    return words, f


@pytest.mark.parametrize("nk,nv,T,K,R,S,t_seg,q,fracs,keys", [
    (1, 0, 4, 2048, 8, 384, 2, None, None, "random"),      # pass 0, n
    (1, 0, 6, 16384, 32, 768, 3, 128, None, "ties"),       # q = 128 chain
    (1, 0, 5, 16384, 32, 640, 5, 256, 65536, "ties"),      # merge, greedy
    (1, 1, 3, 8192, 16, 768, 3, None, 0, "unique"),
    (2, 0, 4, 16384, 32, 768, 2, 512, None, "hi_ties"),    # u64
    (2, 1, 2, 16384, 32, 640, 2, 128, None, "composite"),  # stable pairs
    (3, 1, 2, 16384, 32, 512, 1, None, None, "unique"),    # 224 KB
    (1, 0, 7, 1024, 4, 384, 7, None, 32768, "random"),     # odd T, R = 4
])
def test_partition_splitters(gen, nk, nv, T, K, R, S, t_seg, q, fracs,
                             keys):
    """K1b against its plain version: counts exactly, every valid slot."""
    if keys == "unique":
        planes = [_unique(gen, T, K)]
    elif keys == "ties":
        planes = [_rand(gen, T, K) & 0x7000000F]
    elif keys == "hi_ties":
        planes = [_rand(gen, T, K) & 3]
    elif keys == "composite":
        planes = [_rand(gen, T, K) & 0x70000000,
                  torch.randperm(T * K, device="cuda", generator=gen)
                  .to(torch.int32).reshape(T, K)]
    else:
        planes = [_rand(gen, T, K)]
    planes += [_rand(gen, T, K) for _ in range(nk - len(planes))]
    vals = [_rand(gen, T, K) for _ in range(nv)]
    kw = dict(r=R, s=S, lo_bit=32 * nk - 2, width=2, t_seg=t_seg)
    cin, run = None, None
    if q:
        cin = torch.randint(q // 2, q + 1, (T, K // q), dtype=torch.int32,
                            device="cuda", generator=gen)
        planes, vals = _lex_chunks(planes, vals, q, cin)
        kw.update(q_in=q, n=None)
        run = q
    else:
        kw.update(q_in=None, n=T * K - 333)
    words, f = _splitters(gen, planes, R, fracs)
    if keys == "ties":
        words[0][0, -1] = -1                  # the all-ones splitter
    got, counts = tp.partition_pass_fused(
        planes, vals, cin, sorted_run=run, unstable=True, splitters=words,
        splitter_fracs=f, **kw)
    want, pcounts = tp.partition_pass_splitter_plain(
        planes, vals, cin, splitters=words, splitter_fracs=f,
        **{k: kw[k] for k in ("q_in", "n", "r", "s", "t_seg")})
    torch.cuda.synchronize()
    assert torch.equal(counts, pcounts)
    m = _valid_slots(counts, R, S, t_seg)
    for g, w in zip(got, want):
        assert torch.equal(g[m], w[m])


def test_partition_splitters_poisoned_tile(gen):
    """A tile whose keys all lie below its first splitter, far over S,
    reports count 0 = K + 1 from the kernel as from the plain version."""
    T, K, R, S = 4, 4096, 16, 512
    x = _rand(gen, T, K) & 0x0FFFFFFF
    words = [torch.full((T, R - 1), 0x7FFFFFFF, dtype=torch.int32,
                        device="cuda")]
    words[0][1:] = torch.sort(_rand(gen, T - 1, R - 1), dim=1).values
    kw = dict(r=R, s=S, lo_bit=28, width=4, t_seg=1, q_in=None, n=T * K)
    _, counts = tp.partition_pass_fused([x], [], None, splitters=words,
                                        **kw)
    _, pcounts = tp.partition_pass_splitter_plain(
        [x], [], None, splitters=words,
        splitter_fracs=torch.full((T, R - 1), 65536, dtype=torch.int32,
                                  device="cuda"),
        **{k: kw[k] for k in ("q_in", "n", "r", "s", "t_seg")})
    assert counts[0, 0] == K + 1
    assert torch.equal(counts, pcounts)


@pytest.mark.parametrize("call", ["zipf", "entropy3", "zipf_stable_pairs",
                                  "zipf_unstable_pairs", "u64_zipf",
                                  "presorted"])
def test_equidepth_tier_on_card(gen, call):
    """The host tier chain on the card at 2^24 (the planner's floor):
    skewed keys skip the radix tier and sort on K1b passes and K2 with no
    fallback; a presorted input comes back as it was, with no sort."""
    n = 1 << 24
    rng = np.random.default_rng(24)
    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    vals = ()
    if call == "entropy3":
        keys = (_rand(gen, n) & _rand(gen, n) & _rand(gen, n)).view(
            torch.uint32)
    elif call == "u64_zipf":
        keys = torch.from_numpy(zipf_keys(rng, n, dtype=np.uint64)).cuda()
    elif call == "presorted":
        keys = torch.sort(_rand(gen, n)).values
    else:
        keys = torch.from_numpy(zipf_keys(rng, n, dtype=np.uint32)).cuda()
        if call != "zipf":
            vals = (idx,)
    tm.reset_counters()
    got = tpusort_torch.sort(keys, vals[0] if vals else None,
                             stable=call != "zipf_unstable_pairs")
    c = tm.counters()
    ko = got[0] if vals else got
    planes, traits = dtypes.twiddle_in(keys)
    ref, rv = sort_twiddled_reference(planes, vals, begin_bit=0,
                                      end_bit=traits.bits,
                                      total_bits=traits.bits)
    want = dtypes.twiddle_out(ref, traits)
    w = torch.int64 if keys.element_size() == 8 else torch.int32
    assert torch.equal(ko.view(w), want.view(w))
    if call == "zipf_unstable_pairs":
        assert torch.equal(keys.view(torch.int32)[got[1].long()],
                           ko.view(torch.int32))
    elif vals:
        assert torch.equal(got[1], rv[0])
    if call == "presorted":
        assert c["identity_routes"] == 1
        assert c["k1_launches"] == c["k1b_launches"] == c["k2_launches"] == 0
        return
    assert c["radix_tiers"] == 0 and c["equidepth_runs"] == 1, c
    assert c["k1b_launches"] >= 2 and c["k2_launches"] >= 1, c
    assert c["overflow_fallbacks"] == 0, c


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.float32])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("n", [1, 77, 8192, 8193, (1 << 20) + 4321,
                               (1 << 26) + 5 * 8192 + 3])
def test_prefix_sum(gen, dtype, exclusive, n):
    """K5 against its plain version: integers bit for bit (values up to
    2^20, so long inputs wrap); float32 of zeros and ones, one in eight,
    exactly too (every partial sum is below 2^24)."""
    if dtype == torch.float32:
        x = (torch.randint(0, 8, (n,), device="cuda", generator=gen)
             == 0).float()
    else:
        x = torch.randint(0, 1 << 20, (n,), dtype=torch.int32,
                          device="cuda", generator=gen).view(dtype)
    tm.reset_counters()
    got = tsh.prefix_sum_tiles(x, exclusive=exclusive)
    assert tm.mode_counters() == {("K5", 0, 1): 1}
    want = tsh.prefix_sum_tiles_plain(x, exclusive=exclusive)
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_prefix_sum_unaligned_and_f32(gen):
    """A view that starts off a 16-byte boundary takes the scalar loads;
    float32 values that round agree with a float64 sum within 1e-6 of the
    running sum's magnitude, and two runs give the same bits."""
    base = torch.randint(0, 1 << 20, ((1 << 18) + 7,), dtype=torch.int32,
                         device="cuda", generator=gen)
    for off in (1, 2, 3):
        x = base[off:]
        assert torch.equal(tsh.prefix_sum_tiles(x),
                           tsh.prefix_sum_tiles_plain(x))
    f = torch.rand(1 << 22, device="cuda", generator=gen)
    a, b = tsh.prefix_sum_tiles(f), tsh.prefix_sum_tiles(f)
    assert torch.equal(a, b)
    exact = torch.cumsum(f.double(), 0)
    assert float(((a.double() - exact).abs() / exact).max()) < 1e-6


_K5_TILE = tsh.SCAN_TILE


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.float32])
@pytest.mark.parametrize("n", [1, _K5_TILE - 1, _K5_TILE, _K5_TILE + 1,
                               (1 << 20) + 3, (1 << 28) - 12345])
def test_prefix_sum_lengths_and_views(gen, dtype, n):
    """The one-pass K5 at the tile's edges, past a group of tiles and at the
    largest ragged length, on views 0, 4 and 12 bytes past a 16-byte
    boundary, inclusive and exclusive: integers bit for bit against plain;
    float32 uniforms within 1e-5 of the float64 running sum, and, past 2^20,
    zeros and ones (one in 32, so every partial sum stays below 2^24)
    exactly."""
    base = torch.randint(0, 1 << 20, (n + 3,), dtype=torch.int32,
                         device="cuda", generator=gen)
    if dtype == torch.float32:
        base = (base % 32 == 0).float() if n > (1 << 20) else \
            torch.rand(n + 3, device="cuda", generator=gen)
    for off in (0, 1, 3):
        x = base[off:off + n]
        x = x if dtype == torch.float32 else x.view(dtype)
        assert (x.data_ptr() % 16 == 0) == (off == 0)
        for exclusive in (False, True):
            got = tsh.prefix_sum_tiles(x, exclusive=exclusive)
            if dtype != torch.float32:
                want = tsh.prefix_sum_tiles_plain(x, exclusive=exclusive)
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))
                continue
            exact = torch.cumsum(x.double(), 0)
            if exclusive:
                exact = exact - x.double()
            if n > (1 << 20):
                assert torch.equal(got.double(), exact)
            elif n > 1:
                err = (got.double() - exact).abs()[1:] / exact[1:]
                assert float(err.max()) < 1e-5
            del got


def test_prefix_sum_f32_reproducible_and_modelled(gen):
    """Ten runs of one float32 input give the same bits, equal to the numpy
    model of the kernel (tests/test_torch_scan_lookback.py) at 2^20 + 3."""
    from test_torch_scan_lookback import k5_model
    x = torch.rand((1 << 20) + 3, device="cuda", generator=gen)
    runs = [tsh.prefix_sum_tiles(x) for _ in range(10)]
    assert all(torch.equal(r.view(torch.int32), runs[0].view(torch.int32))
               for r in runs)
    want = k5_model(x.cpu().numpy())
    assert runs[0].cpu().numpy().tobytes() == want.tobytes()
    ex = tsh.prefix_sum_tiles(x, exclusive=True).cpu().numpy()
    assert ex.tobytes() == k5_model(x.cpu().numpy(), exclusive=True).tobytes()


def _k1_edge_inputs(gen, T, K, nk, nv, run):
    """Key planes of 16 distinct words with a block of all-ones, payloads,
    and, with ``run``, a counts table of q = run whose chunks' valid
    prefixes are sorted (what an earlier pass leaves)."""
    planes = [(torch.randint(0, 16, (T, K), device="cuda", generator=gen)
               .to(torch.int32) * 0x10EF0F01) for _ in range(nk)]
    planes[0][:, K // 4: K // 4 + K // 8] = -1
    vals = [_rand(gen, T, K) for _ in range(nv)]
    if not run:
        return planes, vals, None
    cin = torch.randint(0, run + 1, (T, K // run), dtype=torch.int32,
                        device="cuda", generator=gen)
    planes, vals = _lex_chunks(planes, vals, run, cin)
    return planes, vals, cin


@pytest.mark.parametrize("nv", [0, 1, 2, 8])
@pytest.mark.parametrize("nk", [1, 2, 3])
@pytest.mark.parametrize("K", [1 << lk for lk in range(11, 15)])
def test_partition_k1_edges(gen, K, nk, nv):
    """K1 on the register network against its plain version, bit for bit on
    the counts and every valid slot, payloads included (ties keep their
    slot order in both): every sorted_run from none through 128 .. K (the
    emit-only mode), keys with ties and a block of 0xFFFFFFFF."""
    T, R = 4, 16
    S = max(128, (3 * K // (2 * R)) // 128 * 128)
    for run in [None] + [1 << lr for lr in range(7, K.bit_length())]:
        planes, vals, cin = _k1_edge_inputs(gen, T, K, nk, nv, run)
        kw = dict(r=R, s=S, lo_bit=32 * nk - 4, width=4, t_seg=2)
        kw.update(q_in=run, n=None) if run else \
            kw.update(q_in=None, n=T * K - 999)
        got, counts = tp.partition_pass_fused(planes, vals, cin,
                                              sorted_run=run, unstable=True,
                                              **kw)
        want, pcounts = tp.partition_pass_fused_plain(planes, vals, cin, **kw)
        assert torch.equal(counts, pcounts), run
        m = _valid_slots(counts, R, S, 2)
        for g, w in zip(got, want):
            assert torch.equal(g[m], w[m]), run


@pytest.mark.parametrize("nv", [0, 1])
@pytest.mark.parametrize("nk", [1, 2])
@pytest.mark.parametrize("K", [1 << lk for lk in range(11, 15)])
def test_partition_k1b_zipf_edges(gen, K, nk, nv):
    """K1b against its plain version on Zipf 1.1 keys cut at the keys' own
    quantiles (the same splitters in every tile, random tie fractions),
    with and without a sorted_run: counts bit for bit, every valid slot."""
    T, R = 4, 16
    S = max(128, (3 * K // (2 * R)) // 128 * 128)
    rng = np.random.default_rng(K + nk)
    keys = torch.from_numpy(zipf_keys(rng, T * K, dtype=np.uint32)
                            .view(np.int32)).cuda().reshape(T, K)
    planes = [keys] + [_rand(gen, T, K) for _ in range(nk - 1)]
    vals = [_rand(gen, T, K) for _ in range(nv)]
    qs = torch.sort(keys.reshape(-1) ^ dtypes.INT32_MIN).values
    at = (torch.arange(1, R, device="cuda") * (T * K)) // R
    words = [(qs[at] ^ dtypes.INT32_MIN).expand(T, R - 1).contiguous()]
    words += [torch.zeros(T, R - 1, dtype=torch.int32, device="cuda")
              for _ in range(nk - 1)]
    f = torch.randint(0, 65537, (T, R - 1), dtype=torch.int32, device="cuda",
                      generator=gen)
    for run in (None, 256):
        kp, kv, cin = planes, vals, None
        kw = dict(r=R, s=S, t_seg=2, q_in=None, n=T * K - 5)
        if run:
            cin = torch.randint(run // 2, run + 1, (T, K // run),
                                dtype=torch.int32, device="cuda",
                                generator=gen)
            kp, kv = _lex_chunks(planes, vals, run, cin)
            kw.update(q_in=run, n=None)
        got, counts = tp.partition_pass_fused(
            kp, kv, cin, sorted_run=run, unstable=True, splitters=words,
            splitter_fracs=f, lo_bit=0, width=1, **kw)
        want, pcounts = tp.partition_pass_splitter_plain(
            kp, kv, cin, splitters=words, splitter_fracs=f, **kw)
        assert torch.equal(counts, pcounts), run
        m = _valid_slots(counts, R, S, 2)
        for g, w in zip(got, want):
            assert torch.equal(g[m], w[m]), run


@pytest.mark.parametrize("n", [0, 1, 5, 1000, (1 << 20) + 4321])
@pytest.mark.parametrize("shift,bits", [(24, 8), (27, 5), (0, 3), (13, 1)])
def test_digit_histogram(gen, n, shift, bits):
    x = _rand(gen, n + 3)[3:] if n % 2 else _rand(gen, n)  # off alignment too
    got = tsh.digit_histogram_tiles(x.view(torch.uint32), shift, bits)
    want = tsh.digit_histogram_tiles_plain(x, shift, bits)
    assert torch.equal(got, want) and int(got.sum()) == n


def test_digit_histogram_skew(gen):
    """All keys in one bin, and runs of equal keys, serialise the shared
    atomics or take the warp's one add; the counts stay exact."""
    n = (1 << 22) + 99
    const = torch.full((n,), 0x5A5A5A5A, dtype=torch.int32, device="cuda")
    got = tsh.digit_histogram_tiles(const, 24, 8)
    assert int(got[0x5A]) == n and int(got.sum()) == n
    ramp = torch.arange(n, dtype=torch.int32, device="cuda") >> 3
    assert torch.equal(tsh.digit_histogram_tiles(ramp, 2, 8),
                       tsh.digit_histogram_tiles_plain(ramp, 2, 8))


def test_scan_and_histogram_routes(gen):
    """The public routes launch K5 and K6 once each for CUDA tensors."""
    x = torch.randint(0, 100, (1 << 16,), dtype=torch.int32, device="cuda",
                      generator=gen)
    tm.reset_counters()
    inc, exc = tsc.inclusive_sum(x), tsc.exclusive_sum(x)
    assert tm.counters()["k5_launches"] == 2
    assert torch.equal(inc, torch.cumsum(x, 0, dtype=torch.int32))
    assert torch.equal(exc, inc - x)
    tsc.inclusive_sum(x[:1000])            # below 2^16: torch.cumsum
    tsc.inclusive_sum(x, use_kernel=False)
    assert tm.counters()["k5_launches"] == 2
    h = th.digit_histogram(x.view(torch.uint32), 0, 7)
    assert tm.counters()["k6_launches"] == 1 and h.shape == (1, 128)
    assert torch.equal(h[0], tsh.digit_histogram_tiles_plain(x, 0, 7))
    th.digit_histogram(x.view(torch.uint32), 0, 7, tiles=4)
    assert tm.counters()["k6_launches"] == 1


@pytest.mark.parametrize("nk,nv,T,K,q,run", [
    (1, 0, 5, 2048, 128, 0), (1, 1, 3, 12288, 512, 512),
    (2, 1, 4, 4096, 256, 256), (3, 1, 2, 16384, 512, 0),   # 224 KB
    (1, 0, 100, 384, 128, 128), (2, 2, 7, 1536, 128, 0),
])
def test_sort_tiles_counts(gen, nk, nv, T, K, q, run):
    """K9 against its plain version: the key planes over the whole tile,
    the payloads (unique keys) over the valid prefix."""
    planes = [_unique(gen, T, K)] + [_rand(gen, T, K) for _ in range(nk - 1)]
    vals = [_rand(gen, T, K) for _ in range(nv)]
    counts = torch.randint(0, q + 1, (T, K // q), dtype=torch.int32,
                           device="cuda", generator=gen)
    if run:
        planes, vals = _lex_chunks(planes, vals, q, counts)
    tm.reset_counters()
    got = tb.sort_tiles_counts(planes + vals, counts, q, sorted_run=run,
                               num_keys=nk)
    assert tm.mode_counters() == {("K9", nk, nv): 1}
    want = tb.sort_tiles_counts_plain(planes + vals, counts, q, nk)
    head = torch.arange(K, device="cuda")[None, :] < \
        counts.sum(dim=1)[:, None]
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w) if i < nk else torch.equal(g[head], w[head])
    assert bool((got[0][~head] == -1).all())


@pytest.mark.parametrize("nk,nv,T,K,as_bool", [
    (1, 0, 5, 2048, True), (1, 1, 3, 12288, False), (2, 1, 4, 640, True),
    (3, 2, 2, 16384, False),
])
def test_sort_tiles_masked(gen, nk, nv, T, K, as_bool):
    planes = [_unique(gen, T, K)] + [_rand(gen, T, K) for _ in range(nk - 1)]
    vals = [_rand(gen, T, K) for _ in range(nv)]
    mask = torch.rand(T, K, device="cuda", generator=gen) < 0.7
    mask[0] = False
    if not as_bool:
        mask = mask.to(torch.int32) * 7
    tm.reset_counters()
    got = tb.sort_tiles_masked(planes + vals, mask, num_keys=nk)
    assert tm.mode_counters() == {("K10", nk, nv): 1}
    want = tb.sort_tiles_masked_plain(planes + vals, mask, nk)
    head = torch.arange(K, device="cuda")[None, :] < \
        (mask != 0).sum(dim=1)[:, None]
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w) if i < nk else torch.equal(g[head], w[head])


def _edge_keys(gen, T, K):
    """16 distinct words spread over the range and a block of 0xFFFFFFFF
    (the pad's key)."""
    x = torch.randint(0, 16, (T, K), device="cuda", generator=gen) \
        .to(torch.int32) * 0x10EF0F01
    x[:, K // 4: K // 4 + max(K // 8, 1)] = -1
    return x


def _off16(x):
    """The same words in a view 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    v = buf[1:1 + x.numel()].view(x.shape)
    v.copy_(x)
    assert v.data_ptr() % 16 == 4
    return v


def _rows_to_fill(K):
    """Rows enough to give every SM 16 CTAs of 128-slot rows, or 2 of
    32,768 slots."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * max(2, (1 << 16) // (1 << (K - 1).bit_length()))


@pytest.mark.parametrize("rows", ["one", "fill_unaligned"])
@pytest.mark.parametrize("nv", [0, 1, 8])
@pytest.mark.parametrize("K", [(1 << lp) - pad for lp in range(7, 16)
                               for pad in (0, 128) if (1 << lp) > pad])
def test_sort_tiles_edges(gen, K, nv, rows):
    """K3 at every P its geometry covers (128 to 32,768 slots: 4-32 slots a
    thread, 1 or 2 chunks), K = P and P - 128 (the virtual pad), on keys
    with many ties: the payloads too are bit-equal to the stable plain
    sort, because equal keys compare by slot index."""
    T = 1 if rows == "one" else _rows_to_fill(K)
    ops = [_edge_keys(gen, T, K)] + [_rand(gen, T, K) for _ in range(nv)]
    if rows != "one":
        ops = [_off16(o) for o in ops]
    tm.reset_counters()
    got = tb.sort_tiles(ops)
    assert tm.mode_counters() == {("K3", 1, nv): 1}
    want = tb.sort_tiles_plain(ops)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _valid_edge_cases():
    out = []
    for nk in (1, 2, 3):
        for log_p in range(7, 16):
            for pad in (0, 128):
                p = 1 << log_p
                if p - pad and tp.tile_smem_bytes(p, nk, True) \
                        <= tp.SMEM_MAX:
                    out.append((nk, log_p, pad))
    return out


@pytest.mark.parametrize("nk,log_p,pad", _valid_edge_cases())
def test_sort_tiles_valid_edges(gen, nk, log_p, pad):
    """K9 at every sorted_run from 128 to K (the runs' valid prefixes
    sorted, the counts table in chunks of the run) and K10, with 1-3
    planes of tied keys, 0, 1 or 8 payloads in turn, one row or rows to
    fill every SM 4 bytes off a 16-byte boundary in turn: the key planes
    equal plain's over the tile, the payloads over the valid prefix."""
    P = 1 << log_p
    K = P - pad
    runs = [0] + [1 << r for r in range(7, log_p + 1)
                  if K % (1 << r) == 0 and (P - K) % (1 << r) == 0]
    for i, run in enumerate(runs):
        nv = (0, 1, 8)[i % 3]
        T = _rows_to_fill(K) if i % 2 else 1
        q = run or 128
        planes = [_edge_keys(gen, T, K) for _ in range(nk)]
        vals = [_rand(gen, T, K) for _ in range(nv)]
        counts = torch.randint(0, q + 1, (T, K // q), dtype=torch.int32,
                               device="cuda", generator=gen)
        if run:
            planes, vals = _lex_chunks(planes, vals, q, counts)
        ops = planes + vals
        if i % 2:
            ops = [_off16(o) for o in ops]
        mask = torch.rand(T, K, device="cuda", generator=gen) < 0.6
        valid = (torch.arange(K, device="cuda") % q)[None, :] < \
            counts.repeat_interleave(q, dim=1)
        tm.reset_counters()
        got9 = tb.sort_tiles_counts(ops, counts, q, sorted_run=run,
                                    num_keys=nk)
        got10 = tb.sort_tiles_masked(ops, mask, num_keys=nk)
        assert tm.mode_counters() == {("K9", nk, nv): 1, ("K10", nk, nv): 1}
        for got, want, v in (
                (got9, tb.sort_tiles_counts_plain(ops, counts, q, nk), valid),
                (got10, tb.sort_tiles_masked_plain(ops, mask, nk), mask)):
            head = torch.arange(K, device="cuda")[None, :] < \
                v.sum(dim=1)[:, None]
            for j, (g, w) in enumerate(zip(got, want)):
                assert torch.equal(g, w) if j < nk else \
                    torch.equal(g[head], w[head]), (run, j)


def test_tile_sort_refuses_a_geometry_it_was_not_built_for(gen):
    """The C entry points take only threads x slots x chunks = P with a
    slot count the registers hold, and 16-byte aligned outputs; anything
    else is cudaErrorInvalidValue and no launch."""
    from tpusort_torch.kernels import _build
    x = _rand(gen, 2, 2048)
    out = torch.empty_like(x)
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for threads, slots, smem in ((128, 8, 4096), (64, 32, 4096),
                                 (96, 32, 8192), (64, 64, 8192)):
        err = lib.tpusort_sort_tiles(x.data_ptr(), out.data_ptr(),
                                     _build.pointers([]), _build.pointers([]),
                                     0, 2, 2048, 2048, threads, slots, smem,
                                     stream)
        assert err != 0, (threads, slots, smem)
    # an output 4 bytes off a 16-byte boundary (the kernel stores 16 bytes)
    err = lib.tpusort_sort_tiles(x.data_ptr(), out.data_ptr() + 4,
                                 _build.pointers([]), _build.pointers([]),
                                 0, 1, 2048, 2048, 64, 32, 8192, stream)
    assert err != 0
    # 32 slots of two words (a key and its index) need 128 registers a
    # thread: that instance takes at most 512 threads
    y = _rand(gen, 1, 32768)
    v, yo, vo = _rand(gen, 1, 32768), torch.empty_like(y), torch.empty_like(y)
    err = lib.tpusort_sort_tiles(y.data_ptr(), yo.data_ptr(),
                                 _build.pointers([v]), _build.pointers([vo]),
                                 1, 1, 32768, 32768, 1024, 32, 196608, stream)
    assert err != 0
    # 32 slots of four words (3 planes and the index) would spill: not built
    z = [_rand(gen, 1, 4096) for _ in range(4)]
    zo = [torch.empty_like(t) for t in z]
    counts = torch.full((1, 32), 128, dtype=torch.int32, device="cuda")
    err = lib.tpusort_sort_tiles_valid(
        _build.pointers(z[:3]), _build.pointers(zo[:3]), 3,
        _build.pointers(z[3:]), _build.pointers(zo[3:]), 1,
        counts.data_ptr(), 128, None, 1, 4096, 4096, 0, 128, 32, 4096 * 14,
        stream)
    assert err != 0


@pytest.mark.parametrize("case", ["keys", "pairs", "pairs_pad", "f32_desc",
                                  "stable", "bit_range", "u64"])
def test_sort_batched_on_card(gen, case):
    """Full-range unstable rows of 32-bit keys run K3, once; the others the
    exact row sort."""
    b, k = 300, {"pairs_pad": 12288, "keys": 2048}.get(case, 1024)
    x = _rand(gen, b, k)
    kw, vals, k3 = {}, None, True
    keys = x.view(torch.uint32)
    if case in ("pairs", "pairs_pad"):
        x[:, 5:200] = -1                  # ties the virtual pad's key
        vals = torch.arange(b * k, dtype=torch.int32,
                            device="cuda").reshape(b, k)
    elif case == "f32_desc":
        keys, kw = x.view(torch.float32), dict(descending=True)
    elif case == "stable":
        vals, kw, k3 = x.clone(), dict(stable=True), False
    elif case == "bit_range":
        kw, k3 = dict(begin_bit=4, end_bit=20), False
    elif case == "u64":
        keys, k3 = torch.stack([x, x.flip(1)], 2).view(torch.uint64)[..., 0], \
            False
    tm.reset_counters()
    got = tpusort_torch.sort_batched(keys, vals, **kw)
    assert tm.counters()["k3_launches"] == int(k3)
    ko = got[0] if vals is not None else got
    planes, traits = dtypes.twiddle_in(keys.reshape(-1), **{
        k_: v for k_, v in kw.items() if k_ == "descending"})
    bits = (kw.get("begin_bit", 0), kw.get("end_bit", traits.bits))
    cmp = _mask_plane_bits(planes, *bits, traits.bits)
    _, carried = sort_rows_lex([p.reshape(b, k) for p in cmp],
                               [p.reshape(b, k) for p in planes])
    want = dtypes.twiddle_out(tuple(p.reshape(-1) for p in carried), traits,
                              **{k_: v for k_, v in kw.items()
                                 if k_ == "descending"})
    w = torch.int64 if keys.element_size() == 8 else torch.int32
    assert torch.equal(ko.reshape(-1).view(w), want.view(w))
    if case in ("pairs", "pairs_pad"):
        vo = got[1]
        assert torch.equal(torch.sort(vo, dim=1).values, vals)
        assert torch.equal(x.reshape(-1)[vo.reshape(-1).long()],
                           ko.view(torch.int32).reshape(-1))


@pytest.mark.parametrize("mode", ["keys", "unstable", "stable", "stable_i64"])
@pytest.mark.parametrize("shape", ["equal", "ragged", "few", "one"])
def test_segmented_sort_on_card(gen, mode, shape):
    """The engine route at 2^20: K1 passes and one K2, no fallback, and the
    stable reference's answer."""
    n = (1 << 20) + 4321
    rng = np.random.default_rng(31)
    nseg = {"equal": 4096, "ragged": 3000, "few": 3, "one": 1}[shape]
    offs = segment_offsets(rng, n, nseg) if shape == "ragged" \
        else np.linspace(0, n, nseg + 1).astype(np.int64)
    x = _rand(gen, n)
    if mode != "keys":
        x[::3] &= -(1 << 14)          # ties, a few copies a value
    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    vals = {"keys": None, "stable_i64": idx.long() << 20}.get(mode, idx)
    tm.reset_counters()
    got = tpusort_torch.segmented_sort(x.view(torch.uint32), offs, vals,
                                       stable=mode != "unstable")
    c = tm.counters()
    assert c["k1_launches"] >= 1 and c["k2_launches"] == 1, c
    assert c["overflow_fallbacks"] == 0 and c["reference_routes"] == 0, c
    seg = torch.searchsorted(torch.from_numpy(offs[1:]).cuda(), idx.long(),
                             right=True).to(torch.int32)
    (_, wk), (wi,) = sort_twiddled_reference((seg, x), (idx,), begin_bit=0,
                                             end_bit=64, total_bits=64)
    ko = got if vals is None else got[0]
    assert torch.equal(ko.view(torch.int32), wk)
    if mode == "stable":
        assert torch.equal(got[1], wi)
    elif mode == "stable_i64":
        assert torch.equal(got[1], wi.long() << 20)
    elif mode == "unstable":
        assert torch.equal(x[got[1].long()], wk)
        assert torch.equal(torch.sort(got[1]).values, idx)


def test_segmented_sort_fallback_on_card(gen):
    """A large segment of one repeated key overflows its run: the exact
    sort answers, and the fallback is counted."""
    n = 1 << 20
    x = _rand(gen, n)
    x[: n // 2] = 12345
    offs = np.concatenate([[0], np.arange(n // 2, n + 1, 64)])
    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    tm.reset_counters()
    ko, vo = tpusort_torch.segmented_sort(x, torch.from_numpy(offs).cuda(),
                                          idx)
    assert tm.counters()["overflow_fallbacks"] == 1
    seg = torch.searchsorted(torch.from_numpy(offs[1:]).cuda(), idx.long(),
                             right=True).to(torch.int32)
    (_, wk), (wi,) = sort_twiddled_reference(
        (seg, x ^ dtypes.INT32_MIN), (idx,), begin_bit=0, end_bit=64,
        total_bits=64)
    assert torch.equal(ko, wk ^ dtypes.INT32_MIN) and torch.equal(vo, wi)


@pytest.mark.parametrize("keys_kind", ["uniform", "normal", "duplicates"])
def test_segmented_sort_sample_gate_on_card(gen, keys_kind):
    """At planner.PLANNER_MIN_N keys the sample gate decides before the
    engine runs: uniform keys take the engine; normal variates and heavy
    duplicates in segments longer than a run take the exact sort with no
    K1 launch; either way the stable reference's answer."""
    n = 1 << 24
    offs = np.linspace(0, n, 9).astype(np.int64)
    if keys_kind == "uniform":
        keys = _rand(gen, n).view(torch.uint32)
    elif keys_kind == "normal":
        keys = torch.randn(n, device="cuda", generator=gen)
    else:
        keys = (torch.randint(0, 8, (n,), dtype=torch.int32, device="cuda",
                              generator=gen) * 0x10203041).view(torch.uint32)
    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    tm.reset_counters()
    ko, vo = tpusort_torch.segmented_sort(keys, offs, idx)
    c = tm.counters()
    if keys_kind == "uniform":
        assert c["k1_launches"] >= 1 and c["k2_launches"] == 1, c
        assert c["reference_routes"] == 0 and c["overflow_fallbacks"] == 0, c
    else:
        assert c["k1_launches"] == 0 and c["reference_routes"] == 1, c
        assert c["overflow_fallbacks"] == 0, c
    (plane,), traits = dtypes.twiddle_in(keys)
    seg = torch.searchsorted(torch.from_numpy(offs[1:]).cuda(), idx.long(),
                             right=True).to(torch.int32)
    (_, wk), (wi,) = sort_twiddled_reference((seg, plane), (idx,),
                                             begin_bit=0, end_bit=64,
                                             total_bits=64)
    assert torch.equal(ko.view(torch.int32),
                       dtypes.twiddle_out((wk,), traits).view(torch.int32))
    assert torch.equal(vo, wi)


def test_scan_and_histogram_at_the_largest_length(gen):
    """n = 2^31 - 1, the most K5 and K6 take (64-bit offsets inside the
    kernels; 8 GiB of keys), against torch.cumsum and torch.bincount over
    chunks of 2^28 with the carry wrapped in 32 bits."""
    n = (1 << 31) - 1
    step = 1 << 28
    x = torch.randint(0, 1 << 20, (n,), dtype=torch.int32, device="cuda",
                      generator=gen)
    got = tsh.prefix_sum_tiles(x, exclusive=True)
    hist = tsh.digit_histogram_tiles(x, 12, 8)
    carry = torch.zeros((), dtype=torch.int32, device="cuda")
    want_hist = torch.zeros(256, dtype=torch.int64, device="cuda")
    for a in range(0, n, step):
        chunk = x[a:a + step]
        inc = torch.cumsum(chunk, 0, dtype=torch.int32) + carry
        assert torch.equal(got[a:a + step], inc - chunk)
        carry = inc[-1].clone()
        want_hist += torch.bincount((chunk >> 12) & 0xFF, minlength=256)
        del inc
    assert torch.equal(hist.long(), want_hist) and int(hist.sum()) == n


@pytest.mark.parametrize("d,window", [(2, 128), (3, 384), (3, 1152),
                                      (8, 1152), (8, 1 << 16)])
def test_ring_all_to_all(gen, d, window):
    """K7 vs its plain version, bit for bit, at odd window counts (in
    units of 128) and shard counts; one launch a shard."""
    from tpusort_torch.parallel import ring

    sends = [_rand(gen, d, window) for _ in range(d)]
    tm.reset_counters()
    for r in range(d):
        assert torch.equal(ring.ring_all_to_all(sends, r),
                           ring.ring_all_to_all_plain(sends, r))
    assert tm.mode_counters() == {("K7", 0, 1): d}


def test_ring_all_to_all_rejects_misaligned(gen):
    """The kernel moves 16-byte words: a send buffer off a 16-byte
    boundary is refused, not read wrongly."""
    from tpusort_torch.parallel import ring

    flat = _rand(gen, 2 * 256 + 1)
    sends = [flat[1:].reshape(2, 256), _rand(gen, 2, 256)]
    with pytest.raises(RuntimeError, match="ring_all_to_all"):
        ring.ring_all_to_all(sends, 0)


@pytest.mark.parametrize("nv", [0, 1])
def test_partition_emit_only(gen, nv):
    """K1 with sorted_run == K (the windows finish's pass 0): each tile is
    one sorted run with a valid prefix from one count a tile, so K1 only
    cuts and emits; counts and valid slots equal the plain version's, and
    the launch counts in the "emit-only" mode."""
    T, K, R, S = 32, 16384, 32, 768
    counts = torch.randint(0, K + 1, (T, 1), dtype=torch.int32,
                           device="cuda", generator=gen)
    counts[0] = K
    counts[1] = 0
    keys, vals = _lex_chunks([_unique(gen, T, K)], [_rand(gen, T, K)] * nv,
                             K, counts)
    kw = dict(q_in=K, r=R, s=S, lo_bit=27, width=5, t_seg=T)
    tm.reset_counters()
    k_out, k_cnt = tp.partition_pass_fused(keys, vals, counts, sorted_run=K,
                                           unstable=True, **kw)
    assert tm.mode_counters() == {("K1", 1, nv, "emit-only"): 1}
    p_out, p_cnt = tp.partition_pass_fused_plain(keys, vals, counts, n=None,
                                                 **kw)
    assert torch.equal(k_cnt, p_cnt)
    c = p_cnt.clamp(max=S).reshape(1, T, R).transpose(1, 2)
    m = (torch.arange(S, device="cuda") < c[..., None]).reshape(-1)
    for k, p in zip(k_out, p_out):
        assert torch.equal(k[m], p[m])


@pytest.mark.parametrize("kw", [
    dict(),
    dict(finish="collapse"),
    dict(finish="windows", exchange="rdma", capacity_factor=2.0),
    dict(exchange="rdma", chunks=2),
], ids=["auto", "collapse", "windows-rdma", "rdma-chunks2"])
def test_global_sort_on_card(gen, kw):
    """The global sort over four in-process shards on the card: keys equal
    torch.sort's, pairs ride with their keys, and the route's kernels
    launched (K4 for the collapse, K7 once a shard and operand for rdma,
    K1's emit-only pass for the windows finish, which "auto" takes here:
    a window of n / d^2 = 2^14 keys fits one tile), with no fallback."""
    from tpusort_torch.parallel import InProcessComm, make_global_sort

    n, d = 1 << 18, 4
    keys = _rand(gen, n)
    sorter = make_global_sort(InProcessComm(d, "cuda"), **kw)
    want = (torch.sort(keys ^ dtypes.INT32_MIN).values
            ^ dtypes.INT32_MIN).view(torch.uint32)
    for pairs in (False, True):
        vals = torch.arange(n, dtype=torch.int32, device="cuda")
        tm.reset_counters()
        if pairs:
            ko, vo = sorter(keys.view(torch.uint32), vals)
            assert torch.equal(keys[vo.long()], ko.view(torch.int32))
            assert torch.equal(torch.sort(vo).values, vals)
        else:
            ko = sorter(keys.view(torch.uint32))
        torch.cuda.synchronize()
        assert torch.equal(ko.view(torch.int32), want.view(torch.int32))
        c, modes = tm.counters(), tm.mode_counters()
        assert c["exchange_fallbacks"] == c["overflow_fallbacks"] == 0, c
        windows = kw.get("finish", "windows") == "windows"
        assert (c["k4_launches"] > 0) == (not windows), c
        assert c["k7_launches"] == (d * (1 + pairs)
                                    if kw.get("exchange") == "rdma" else 0)
        emit = sum(v for m, v in modes.items() if m[-1] == "emit-only")
        assert (emit > 0) == windows, modes


def _k8_case(gen, T, K, r, s, n_data, past_k):
    """K8's inputs as the per-phase engine builds them: digits below r or r
    (invalid), the unique sortkey digit << log2(K) | slot, the exclusive
    cumsum of each tile's digit counts as starts; with ``past_k`` random
    starts in [0, K + S), so runs reach past the tile's end."""
    digit = torch.randint(0, r + 1, (T, K), device="cuda", generator=gen)
    sortkey = ((digit << (K.bit_length() - 1))
               | torch.arange(K, device="cuda")).to(torch.int32)
    counts = torch.zeros(T, r + 1, dtype=torch.int32, device="cuda") \
        .scatter_add_(1, digit, torch.ones_like(digit, dtype=torch.int32))
    counts = counts[:, :r]
    starts = (torch.cumsum(counts, 1, dtype=torch.int32) - counts) \
        .contiguous()
    if past_k:
        starts = torch.randint(0, K + s, (T, r), dtype=torch.int32,
                               device="cuda", generator=gen)
    return [sortkey] + [_rand(gen, T, K) for _ in range(n_data)], starts


@pytest.mark.parametrize("T,K,r,s,n_data,past_k", [
    (3, 128, 1, 128, 1, False), (5, 256, 4, 128, 8, True),
    (2, 2048, 8, 384, 2, False), (9, 1024, 16, 256, 5, True),
    (7, 4096, 128, 128, 3, True), (4, 16384, 32, 768, 1, False),
    (3, 16384, 32, 512, 2, True), (2, 32768, 128, 384, 8, True),
    (1, 32768, 32, 1536, 2, False),
])
def test_partition_tiles(gen, T, K, r, s, n_data, past_k):
    """K8 against its plain version at odd geometries: the sortkey is
    unique, so every slot compares, the clamped ones past the tile too;
    one launch in the mode (1, data operands)."""
    ops, starts = _k8_case(gen, T, K, r, s, n_data, past_k)
    tm.reset_counters()
    got = tp.partition_tiles(ops, starts, r=r, s=s)
    assert tm.mode_counters() == {("K8", 1, n_data): 1}
    want = tp.partition_tiles_plain(ops, starts, r=r, s=s)
    assert len(got) == n_data
    for g, w in zip(got, want):
        assert g.shape == (T, r * s) and torch.equal(g, w)


def test_partition_tiles_rejects_what_the_kernel_cannot_take(gen):
    ops, starts = _k8_case(gen, 1, 2048, 8, 256, 9, False)
    with pytest.raises(ValueError, match="data operand"):
        tp.partition_tiles(ops, starts, r=8, s=256)
    big = [_rand(gen, 1, 65536), _rand(gen, 1, 65536)]
    with pytest.raises(ValueError, match="slots"):
        tp.partition_tiles(big, starts, r=8, s=256)
    wide = torch.zeros(1, 129, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="R=129"):
        tp.partition_tiles(ops[:2], wide, r=129, s=256)
    with pytest.raises(ValueError, match="geometry"):
        tp.partition_tiles([o[:, :1536] for o in ops[:2]], starts, r=8,
                           s=256)
    assert tm.mode_counters().get(("K8", 1, 1), 0) == 0


@pytest.mark.parametrize("dtype,pairs", [(torch.uint32, False),
                                         (torch.uint32, True),
                                         (torch.uint64, False)])
def test_msd_phases_on_card(gen, dtype, pairs):
    """The per-phase engine at 2^20 keys: K8 once a pass, the packed leaf
    (K3) or the wide one (K9), K4; the dense result is the stable sort."""
    from tpusort_torch.utils.profiling import (
        msd_phase_inputs, run_msd_phases)

    n = 1 << 20
    words = 2 if dtype == torch.uint64 else 1
    keys = _rand(gen, n * words).view(dtype)
    ops, nplanes, plan = msd_phase_inputs(keys, pairs)
    tm.reset_counters()
    outs, overflow = run_msd_phases(ops, nplanes, n, plan)
    torch.cuda.synchronize()
    c = tm.counters()
    assert not bool(overflow)
    leaf = "k9_launches" if tm.leaf_is_wide(plan) else "k3_launches"
    assert c["k8_launches"] == len(plan.passes) and c[leaf] == 1 \
        and c["k4_launches"] == 1, c
    planes, traits = dtypes.twiddle_in(keys)
    want, (order,) = sort_twiddled_reference(
        planes, (torch.arange(n, dtype=torch.int32, device="cuda"),),
        begin_bit=0, end_bit=32 * words, total_bits=32 * words)
    for g, w in zip(outs[:nplanes], want):
        assert torch.equal(g, w)
    if pairs:
        assert torch.equal(outs[-1], order)


def test_profile_msd_phases_on_card(gen):
    from tpusort_torch.utils.profiling import profile_msd_phases

    m = profile_msd_phases(1 << 20, pairs=True).runs[0]
    assert m.metrics["device"].startswith("cuda")
    assert m.metrics["overflow"] is False
    assert len(m.arrays["partition_ms"]) == m.metrics["passes"]
    for name in ("leaf_ms", "collapse_ms", "fused_total_ms"):
        assert m.metrics[name] > 0
