"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  This file
imports neither jax nor ``tpusort``, so it runs where only PyTorch and the
CUDA toolkit are installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Keys compare bit for bit: K1 on its counts and the slots they mark valid,
K2, K3 and the sorts on their whole output.  Payloads ride unstably, so
the multi-operand kernel cases make plane 0 unique (a scrambled
permutation), where any correct sort gives one payload order.
"""

import pytest
import torch

import tpusort_torch
from tpusort_torch import dtypes
from tpusort_torch.kernels import bitonic as tb
from tpusort_torch.kernels import partition as tp
from tpusort_torch.ops import msd as tm
from tpusort_torch.ops.reference import sort_rows_lex, sort_twiddled_reference

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
