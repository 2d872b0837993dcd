"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  This file
imports neither jax nor ``tpusort``, so it runs where only PyTorch and the
CUDA toolkit are installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Keys compare bit for bit: K1 on its counts and the slots they mark valid,
K2 and the sort on their whole output.
"""

import pytest
import torch

import tpusort_torch
from tpusort_torch import dtypes
from tpusort_torch.kernels import bitonic as tb
from tpusort_torch.kernels import partition as tp
from tpusort_torch.ops import msd as tm
from tpusort_torch.ops.reference import sort_twiddled_reference

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
    pout, pcounts = tp.partition_pass_fused_plain(x, None, q_in=None, **kw)
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
    pout, pcounts = tp.partition_pass_fused_plain(x, cin, **kw)
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
    want = tb.sort_tiles_counts_collapsed_plain(x, counts, q, n_out)
    assert torch.equal(got, want)


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
