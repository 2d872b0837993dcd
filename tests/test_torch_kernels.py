"""The port's K1, K2 and K3 (their plain PyTorch versions, which CPU tensors
take) against the Pallas kernels in interpret mode, bit for bit.

K1 is compared on its counts and on every slot the counts mark valid (pad
slots are unspecified); K2 on its dense output; K3 on its whole output.
Payloads ride unstably in both packages, so the multi-operand cases use
keys that are unique (plane 0 a scrambled permutation), where any correct
sort gives the same payload order.  Inputs are numpy arrays from a seed.
The CUDA kernels themselves are checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusort.kernels import bitonic as jb
from tpusort.kernels import partition as jp
from tpusort.ops import small as js
from tpusort_torch.kernels import bitonic as tb
from tpusort_torch.kernels import partition as tp
from tpusort_torch.ops import small as ts


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _sorted_chunks(rng, T, K, q):
    """(T, K) keys whose chunks of q hold a sorted valid prefix of
    counts[t, i] keys followed by garbage, and those (T, K // q) counts."""
    x = rng.integers(0, 2**32, (T, K), dtype=np.uint32)
    counts = rng.integers(0, q + 1, (T, K // q)).astype(np.int32)
    for t in range(T):
        for i in range(K // q):
            c = counts[t, i]
            x[t, i * q: i * q + c] = np.sort(x[t, i * q: i * q + c])
    return x, counts


def _unique(rng, shape):
    """uint32 keys that are all distinct: a permutation times an odd
    constant (a bijection mod 2^32), spread over the whole range."""
    n = int(np.prod(shape))
    x = rng.permutation(n).astype(np.uint64) * np.uint64(0x9E3779B1)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)


def _operands(rng, T, K, nk, nv):
    """nk key planes (plane 0 unique, so the keys are) and nv payloads."""
    return ([_unique(rng, (T, K))]
            + [rng.integers(0, 2**32, (T, K), dtype=np.uint32)
               for _ in range(nk - 1 + nv)])


def _sorted_chunks_lex(ops, nk, q, counts):
    """Sort each q-chunk's valid prefix lexicographically by the nk key
    planes (payloads carried), as an earlier pass would have left it."""
    T, K = ops[0].shape
    out = [o.copy() for o in ops]
    for t in range(T):
        for i in range(K // q):
            c = counts[t, i]
            sl = slice(i * q, i * q + c)
            order = np.lexsort([o[t, sl] for o in ops[:nk]][::-1])
            for o, src in zip(out, ops):
                o[t, sl] = src[t, sl][order]
    return out


def _valid_slots(counts, T, r, s, t_seg):
    """Valid-slot mask of the runs, in the layout the pass wrote."""
    c = np.minimum(counts, s)
    if t_seg is not None:
        c = c.reshape(T // t_seg, t_seg, r).transpose(0, 2, 1)
    return (np.arange(s) < c[..., None]).reshape(-1)


@pytest.mark.parametrize("t_seg", [None, 2])
def test_partition_pass0_matches_pallas(t_seg):
    rng = np.random.default_rng(6)
    T, K, R, S = 2, 512, 8, 256
    x = rng.integers(0, 2**32, (T, K), dtype=np.uint32)
    n = T * K - 333
    kw = dict(r=R, s=S, lo_bit=29, width=3, n=n, t_seg=t_seg)
    (jdata,), jcounts = jp.partition_pass_fused(
        [jnp.asarray(x)], [], None, interpret=True, **kw)
    (tdata,), tcounts = tp.partition_pass_fused([_i32(x)], [], None, **kw)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert int(tcounts.sum()) == n
    m = _valid_slots(np.asarray(jcounts), T, R, S, t_seg)
    np.testing.assert_array_equal(
        tdata.numpy().reshape(-1).view(np.uint32)[m],
        np.asarray(jdata).reshape(-1)[m])


def test_partition_counts_chain_matches_pallas():
    """A later pass: validity from counts_in/q_in, tile made of sorted
    subruns (sorted_run), exchanged output."""
    rng = np.random.default_rng(9)
    T, K, R, S, q = 4, 512, 8, 128, 128
    x, cin = _sorted_chunks(rng, T, K, q)
    kw = dict(r=R, s=S, lo_bit=20, width=3, q_in=q, sorted_run=q, t_seg=2)
    (jdata,), jcounts = jp.partition_pass_fused(
        [jnp.asarray(x)], [], jnp.asarray(cin), interpret=True, **kw)
    (tdata,), tcounts = tp.partition_pass_fused(
        [_i32(x)], [], torch.from_numpy(cin), **kw)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert int(tcounts.sum()) == int(cin.sum())
    m = _valid_slots(np.asarray(jcounts), T, R, S, 2)
    np.testing.assert_array_equal(
        tdata.numpy().view(np.uint32)[m], np.asarray(jdata)[m])


@pytest.mark.parametrize("K,q,sorted_run", [
    (256, 128, 0),          # as tests/test_kernels.py
    (384, 128, 128),        # 3 * 2^7: the Pallas staged f*2^a merge
])
def test_leaf_collapse_matches_pallas(K, q, sorted_run):
    rng = np.random.default_rng(13 + K)
    T = 2
    x, counts = _sorted_chunks(rng, T, K, q)
    n_out = int(counts.sum())
    want = jb.sort_tiles_counts_collapsed(
        jnp.asarray(x), jnp.asarray(counts), q, n_out,
        sorted_run=sorted_run, interpret=True)
    got = tb.sort_tiles_counts_collapsed(
        _i32(x), torch.from_numpy(counts), q, n_out, sorted_run=sorted_run)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def test_leaf_collapse_list_form():
    rng = np.random.default_rng(3)
    x, counts = _sorted_chunks(rng, 3, 256, 128)
    n_out = int(counts.sum())
    (got,) = tb.sort_tiles_counts_collapsed(
        [_i32(x)], torch.from_numpy(counts), 128, n_out)
    single = tb.sort_tiles_counts_collapsed(
        _i32(x), torch.from_numpy(counts), 128, n_out)
    assert torch.equal(got, single)


@pytest.mark.parametrize("k", [256, 384, 640, 1536, 2048, 3072, 24576,
                               5120, 40960, 1000])
def test_merge_staged_factor_matches(k):
    assert tb.merge_staged_factor(k) == jb.merge_staged_factor(k)


@pytest.mark.parametrize("nk,nv,lo_bit,chain", [
    (1, 1, 28, False),   # unstable 32-bit pairs, pass 0
    (2, 1, 30, True),    # composite (key, position) + value; digit straddles
    (3, 1, 92, False),   # three planes + a value (the largest CUDA mode)
    (2, 2, 60, True),    # 64-bit keys + a 64-bit value
])
def test_partition_planes_payloads_match_pallas(nk, nv, lo_bit, chain):
    """K1's raw-key branch with several key planes and payloads at
    K = 2048: pass 0 (validity from n) or a later pass (validity from a
    counts table, sorted subruns)."""
    rng = np.random.default_rng(40 + 7 * nk + nv)
    T, K, R, S, q = 2, 2048, 16, 256, 128
    ops = _operands(rng, T, K, nk, nv)
    kw = dict(r=R, s=S, lo_bit=lo_bit, width=4, unstable=True, t_seg=2)
    cin = None
    if chain:
        cin = rng.integers(0, q + 1, (T, K // q)).astype(np.int32)
        ops = _sorted_chunks_lex(ops, nk, q, cin)
        kw.update(q_in=q, sorted_run=q)
    else:
        kw.update(n=T * K - 777)
    jdata, jcounts = jp.partition_pass_fused(
        [jnp.asarray(o) for o in ops[:nk]], [jnp.asarray(o) for o in ops[nk:]],
        None if cin is None else jnp.asarray(cin), interpret=True, **kw)
    tdata, tcounts = tp.partition_pass_fused(
        [_i32(o) for o in ops[:nk]], [_i32(o) for o in ops[nk:]],
        None if cin is None else torch.from_numpy(cin), **kw)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    m = _valid_slots(np.asarray(jcounts), T, R, S, 2)
    assert len(tdata) == len(jdata) == nk + nv
    for t_, j_ in zip(tdata, jdata):
        np.testing.assert_array_equal(t_.numpy().view(np.uint32)[m],
                                      np.asarray(j_)[m])


@pytest.mark.parametrize("nk,nv,K", [(2, 1, 2048), (3, 1, 2048),
                                     (2, 2, 1536)])
def test_leaf_collapse_planes_payloads_match_pallas(nk, nv, K):
    """K2 with num_keys 2-3 and payloads, from sorted 128-runs (1536 is
    the Pallas staged 3 * 2^9 merge; K2 pads it virtually)."""
    rng = np.random.default_rng(70 + K + nk + nv)
    T, q = 3, 128
    counts = rng.integers(0, q + 1, (T, K // q)).astype(np.int32)
    ops = _sorted_chunks_lex(_operands(rng, T, K, nk, nv), nk, q, counts)
    n_out = int(counts.sum())
    want = jb.sort_tiles_counts_collapsed(
        [jnp.asarray(o) for o in ops], jnp.asarray(counts), q, n_out,
        sorted_run=q, num_keys=nk, interpret=True)
    got = tb.sort_tiles_counts_collapsed(
        [_i32(o) for o in ops], torch.from_numpy(counts), q, n_out,
        sorted_run=q, num_keys=nk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))


@pytest.mark.parametrize("T,K,nv", [(1, 2048, 0), (1, 2048, 2),
                                    (1, 1920, 1), (4, 384, 1),
                                    (2, 640, 0)])
def test_sort_tiles_matches_pallas(T, K, nv):
    """K3: rows sorted by operand 0, payloads along; K not a power of two
    takes the virtual pad."""
    rng = np.random.default_rng(90 + K + nv)
    ops = _operands(rng, T, K, 1, nv)
    want = jb.sort_tiles([jnp.asarray(o) for o in ops], interpret=True)
    got = tb.sort_tiles([_i32(o) for o in ops])
    assert len(got) == len(want) == 1 + nv
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))


@pytest.mark.parametrize("n,nv", [(2048, 0), (2048, 1), (1000, 0),
                                  (1, 0), (1280, 1), (1000, 1)])
def test_single_tile_path_matches_jax(n, nv):
    """ops/small.py against ``tpusort.ops.small.sort_twiddled_bitonic``:
    K3 where it applies (keys, or pairs with n a multiple of 128), the
    reference sort otherwise (1000 pairs would need pad slots)."""
    rng = np.random.default_rng(110 + n + nv)
    key = _unique(rng, (n,)) if nv else \
        rng.integers(0, 2**32, n, dtype=np.uint32)
    vals = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(nv)]
    bits = dict(begin_bit=0, end_bit=32, total_bits=32)
    (jk,), jv = js.sort_twiddled_bitonic(
        (jnp.asarray(key),), [jnp.asarray(v) for v in vals], **bits)
    (tk,), tv = ts.sort_twiddled_bitonic(
        (_i32(key),), [_i32(v) for v in vals], **bits)
    np.testing.assert_array_equal(tk.numpy().view(np.uint32), np.asarray(jk))
    for t_, j_ in zip(tv, jv):
        np.testing.assert_array_equal(t_.numpy().view(np.uint32),
                                      np.asarray(j_))
    applies = ts.single_tile_ok((_i32(key),), [_i32(v) for v in vals],
                                **bits)
    assert applies == (nv == 0 or n % 128 == 0)


def test_unported_modes_raise():
    """The splitter mode (K1b) is ported now, and raises as JAX's does off
    the raw-key path: with stable payloads or a digit plane it is a
    ValueError (``tpusort/kernels/partition.py:426-427``), as are
    fractions without splitters.  The general branch (K1c: digit=, stable
    payloads, more than 3 key planes), which raised before it was ported,
    runs."""
    x = torch.zeros(2, 512, dtype=torch.int32)
    kw = dict(r=8, s=256, lo_bit=29, width=3, n=1024)
    spl = torch.zeros(2, 7, dtype=torch.int32)
    with pytest.raises(ValueError, match="raw-key path"):
        tp.partition_pass_fused([x], [x], None, splitters=[spl], **kw)
    with pytest.raises(ValueError, match="raw-key path"):
        tp.partition_pass_fused([x], [], None, digit=x, splitters=spl, **kw)
    with pytest.raises(ValueError, match="needs splitters"):
        tp.partition_pass_fused([x], [x], None, splitter_fracs=spl,
                                unstable=True, **kw)
    (a,), counts = tp.partition_pass_fused([x], [], None, splitters=spl,
                                           **kw)
    assert a.shape == (2, 8 * 256)
    assert counts[:, 0].tolist() == [256, 256]   # greedy fill to S
    (a,), counts = tp.partition_pass_fused([x], [], None, digit=x, **kw)
    assert a.shape == (2, 8 * 256)
    assert counts[:, 0].tolist() == [512, 512]   # every slot in digit 0
    (a, b), _ = tp.partition_pass_fused([x], [x], None, unstable=False, **kw)
    assert a.shape == b.shape == (2, 8 * 256)
    outs, _ = tp.partition_pass_fused([x] * 4, [], None, **kw)
    assert len(outs) == 4
    # the raw modes that used to raise now run
    (a, b), _ = tp.partition_pass_fused([x], [x], None, unstable=True, **kw)
    assert a.shape == b.shape == (2, 8 * 256)
    c = torch.full((2, 4), 128, dtype=torch.int32)
    outs = tb.sort_tiles_counts_collapsed([x, x, x], c, 128, 1024,
                                          num_keys=2)
    assert len(outs) == 3 and all(o.shape == (1024,) for o in outs)


def test_bad_geometry_raises():
    x = torch.zeros(2, 384, dtype=torch.int32)
    with pytest.raises(ValueError):
        tp.partition_pass_fused([x], [], None, r=8, s=128, lo_bit=29,
                                width=3, n=10)
    with pytest.raises(ValueError):
        tp.partition_pass_fused([x.view(torch.uint32)], [], None, r=8,
                                s=128, lo_bit=29, width=3, n=10)
    x = torch.zeros(2, 512, dtype=torch.int32)
    for lo_bit, width in ((29, 4), (30, 3), (0, 0)):   # digit past R or key
        with pytest.raises(ValueError, match="digit bits"):
            tp.partition_pass_fused([x], [], None, r=8, s=128,
                                    lo_bit=lo_bit, width=width, n=10)
    with pytest.raises(ValueError):
        tb.sort_tiles_counts_collapsed(x, torch.zeros(2, 1, dtype=torch.int32),
                                       0, 10)
    with pytest.raises(ValueError, match="num_keys"):
        tb.sort_tiles_counts_collapsed([x], torch.zeros(2, 4, dtype=torch.int32),
                                       128, 10, num_keys=2)
    with pytest.raises(ValueError):          # K not a multiple of 128
        tb.sort_tiles([torch.zeros(2, 100, dtype=torch.int32)])
    with pytest.raises(ValueError, match="digit bits"):   # past 64 bits
        tp.partition_pass_fused([x, x], [], None, r=8, s=128, lo_bit=62,
                                width=3, n=10)


def test_no_plain_route_off_the_cpu():
    """Only CPU tensors take the plain versions; any other device launches
    a kernel or raises, and the CPU route counts no launch."""
    x = torch.zeros(2, 512, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        tp.partition_pass_fused([x], [], None, r=8, s=256, lo_bit=29,
                                width=3, n=1024)
    c = torch.zeros(2, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        tb.sort_tiles_counts_collapsed(x, c, 128, 10)
    with pytest.raises(ValueError, match="device"):
        tb.sort_tiles([x, x])
    before = (tp.partition_pass_fused.launches,
              tb.sort_tiles_counts_collapsed.launches, tb.sort_tiles.launches)
    x, c = torch.zeros_like(x, device="cpu"), torch.zeros_like(c, device="cpu")
    tp.partition_pass_fused([x], [x], None, r=8, s=256, lo_bit=29, width=3,
                            n=1024, unstable=True)
    tb.sort_tiles_counts_collapsed([x, x], c, 128, 10)
    tb.sort_tiles([x, x])
    assert before == (tp.partition_pass_fused.launches,
                      tb.sort_tiles_counts_collapsed.launches,
                      tb.sort_tiles.launches)


def _valid_prefix(valid):
    """(T, K) mask of each row's first #valid slots: where the sorted valid
    elements lie."""
    return np.arange(valid.shape[1])[None, :] < valid.sum(axis=1)[:, None]


@pytest.mark.parametrize("K,q,nk,nv,sorted_run", [
    (512, 128, 1, 0, 0),         # as tests/test_kernels.py
    (384, 128, 1, 1, 128),       # virtual pad, merge from sorted 128-runs
    (1024, 256, 2, 1, 0),
    (768, 128, 3, 2, 128),
])
def test_sort_tiles_counts_matches_pallas(K, q, nk, nv, sorted_run):
    """K9: every key plane over the whole tile (the valid keys sorted, then
    all-ones), the payloads over the valid prefix."""
    rng = np.random.default_rng(130 + K + nk)
    T = 3
    ops = _operands(rng, T, K, nk, nv)
    counts = rng.integers(0, q + 1, (T, K // q)).astype(np.int32)
    if sorted_run:
        ops = _sorted_chunks_lex(ops, nk, q, counts)
    want = jb.sort_tiles_counts(
        [jnp.asarray(o) for o in ops], jnp.asarray(counts), q,
        sorted_run=sorted_run, num_keys=nk, interpret=True)
    got = tb.sort_tiles_counts(
        [_i32(o) for o in ops], torch.from_numpy(counts), q,
        sorted_run=sorted_run, num_keys=nk)
    valid = (np.arange(K) % q)[None, :] < np.repeat(counts, q, axis=1)
    head = _valid_prefix(valid)
    assert len(got) == len(want) == nk + nv
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy().view(np.uint32), np.asarray(w)
        if i < nk:
            np.testing.assert_array_equal(g, w)
            assert (g[~head] == 0xFFFFFFFF).all()
        else:
            np.testing.assert_array_equal(g[head], w[head])


@pytest.mark.parametrize("K,nk,nv", [(256, 1, 0), (640, 1, 1), (512, 2, 1),
                                     (384, 3, 0)])
def test_sort_tiles_masked_matches_pallas(K, nk, nv):
    """K10: validity from a per-element mask, any integer dtype or bool."""
    rng = np.random.default_rng(150 + K + nk)
    T = 2
    ops = _operands(rng, T, K, nk, nv)
    mask = (rng.random((T, K)) < 0.6).astype(np.int32)
    mask[1, :] = 0                                   # a tile with no key
    want = jb.sort_tiles_masked([jnp.asarray(o) for o in ops],
                                jnp.asarray(mask), num_keys=nk,
                                interpret=True)
    got = tb.sort_tiles_masked([_i32(o) for o in ops],
                               torch.from_numpy(mask), num_keys=nk)
    as_bool = tb.sort_tiles_masked([_i32(o) for o in ops],
                                   torch.from_numpy(mask != 0), num_keys=nk)
    head = _valid_prefix(mask != 0)
    for i, (g, b, w) in enumerate(zip(got, as_bool, want)):
        g, w = g.numpy().view(np.uint32), np.asarray(w)
        assert torch.equal(got[i], b)
        if i < nk:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_array_equal(g[head], w[head])
    assert (got[0].numpy()[1] == -1).all()


def test_valid_tile_sorts_single_form_and_checks():
    """One tensor in, one tensor out; bad geometry, a device without a
    kernel and a CPU call that counts no launch."""
    rng = np.random.default_rng(170)
    x = rng.integers(0, 2**32 - 1, (2, 512), dtype=np.uint32)
    counts = rng.integers(0, 129, (2, 4)).astype(np.int32)
    got = tb.sort_tiles_counts(_i32(x), torch.from_numpy(counts), 128)
    want = np.asarray(jb.sort_tiles_counts(jnp.asarray(x),
                                           jnp.asarray(counts), 128,
                                           interpret=True))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    mask = torch.from_numpy(x & 1)
    assert tb.sort_tiles_masked(_i32(x), mask).shape == (2, 512)
    z = torch.zeros(2, 512, dtype=torch.int32)
    c = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="geometry"):
        tb.sort_tiles_counts(z, c, 100)
    with pytest.raises(ValueError, match="counts must be"):
        tb.sort_tiles_counts(z, c[:, :2], 128)
    with pytest.raises(ValueError, match="num_keys"):
        tb.sort_tiles_counts([z], c, 128, num_keys=2)
    with pytest.raises(ValueError, match="power of two"):
        tb.sort_tiles_counts(z, c, 128, sorted_run=96)
    with pytest.raises(ValueError, match="mask must be"):
        tb.sort_tiles_masked(z, c)
    with pytest.raises(ValueError, match="multiple"):
        tb.sort_tiles_masked(z[:, :100], z[:, :100])
    with pytest.raises(ValueError, match="device"):
        tb.sort_tiles_counts(z.to("meta"), c.to("meta"), 128)
    with pytest.raises(ValueError, match="device"):
        tb.sort_tiles_masked(z.to("meta"), z.to("meta"))
    before = (tb.sort_tiles_counts.launches, tb.sort_tiles_masked.launches)
    tb.sort_tiles_counts(z, c, 128)
    tb.sort_tiles_masked(z, z)
    assert before == (tb.sort_tiles_counts.launches,
                      tb.sort_tiles_masked.launches)
