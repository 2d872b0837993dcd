"""``tpusort_torch.sort_batched`` and ``segmented_sort`` against
``tpusort.sort_batched`` and ``tpusort.segmented_sort`` on the same numpy
inputs: keys and stable values bit for bit, unstable values as permutations
within equal (segment, key).

On CPU tensors both public calls take the exact reference sort, as the JAX
package does off the TPU.  The engine route of ``segmented_sort`` (K1
passes and the K2 leaf over the strided, packed composite), which the
public call takes for CUDA tensors only, is driven here through its private
helper on CPU tensors, where the kernels' plain versions run, and held to
the same outputs with its overflow counter asserted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusort
import tpusort_torch
from tpusort_torch import dtypes as tdt
from tpusort_torch.configs import get_config
from tpusort_torch.ops import msd as tm
from tpusort_torch.ops import segmented as tseg
from tpusort_torch.utils.datagen import random_keys, segment_offsets


def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("dtype,b,k,stable,desc", [
    (np.uint32, 16, 512, True, False),
    (np.uint32, 16, 512, False, False),
    (np.int32, 5, 384, True, True),
    (np.float32, 8, 256, False, True),
    (np.uint64, 4, 200, True, False),
    (np.float64, 3, 128, True, True),
])
def test_sort_batched_matches_jax(dtype, b, k, stable, desc):
    rng = np.random.default_rng(4 + k)
    keys = random_keys(rng, b * k, dtype).reshape(b, k)
    if np.dtype(dtype).kind == "f":
        keys.reshape(-1)[::37] = np.nan
        keys.reshape(-1)[5::41] = -0.0
    vals = np.arange(b * k, dtype=np.uint32).reshape(b, k)
    jk, jv = tpusort.sort_batched(jnp.asarray(keys), jnp.asarray(vals),
                                  stable=stable, descending=desc)
    tk, tv = tpusort_torch.sort_batched(
        torch.from_numpy(keys), torch.from_numpy(vals), stable=stable,
        descending=desc)
    assert tk.shape == (b, k) and tk.dtype == torch.from_numpy(keys).dtype
    _same(tk, jk)
    if stable:
        _same(tv, jv)
    else:       # values ride with their keys, each row a permutation
        tv = tv.numpy()
        np.testing.assert_array_equal(np.sort(tv, axis=1), vals)
        np.testing.assert_array_equal(
            _bits(keys).reshape(-1)[tv.reshape(-1)],
            _bits(tk.numpy()).reshape(-1))
    only = tpusort_torch.sort_batched(torch.from_numpy(keys),
                                      descending=desc)
    _same(only, jk)


def test_sort_batched_float_desc_with_nan():
    rng = np.random.default_rng(5)
    keys = rng.standard_normal((8, 256)).astype(np.float32)
    keys[:, ::50] = np.nan
    want = tpusort.sort_batched(jnp.asarray(keys), descending=True)
    got = tpusort_torch.sort_batched(torch.from_numpy(keys), descending=True)
    _same(got, want)
    assert np.isnan(got.numpy()[:, 0]).all()      # NaN sorts above +inf


@pytest.mark.parametrize("dtype,bits", [(np.uint32, (4, 20)),
                                        (np.uint64, (20, 50)),
                                        (np.float32, (8, 32))])
def test_sort_batched_bit_range(dtype, bits):
    rng = np.random.default_rng(19)
    keys = random_keys(rng, 8 * 384, dtype).reshape(8, 384)
    vals = np.arange(8 * 384, dtype=np.uint32).reshape(8, 384)
    jk, jv = tpusort.sort_batched(jnp.asarray(keys), jnp.asarray(vals),
                                  begin_bit=bits[0], end_bit=bits[1])
    tk, tv = tpusort_torch.sort_batched(
        torch.from_numpy(keys), torch.from_numpy(vals), begin_bit=bits[0],
        end_bit=bits[1])
    _same(tk, jk)
    _same(tv, jv)                    # a bit window sorts stably
    # 64-bit values, which JAX's sort_batched does not take, the exact way
    wide = vals.astype(np.uint64) * np.uint64(0x100000001)
    tk, tw = tpusort_torch.sort_batched(
        torch.from_numpy(keys), torch.from_numpy(wide), begin_bit=bits[0],
        end_bit=bits[1])
    _same(tk, jk)
    assert tw.dtype == torch.uint64
    np.testing.assert_array_equal(
        tw.numpy(), np.asarray(jv).astype(np.uint64) * np.uint64(0x100000001))
    with pytest.raises(ValueError, match="bit range"):
        tpusort_torch.sort_batched(torch.from_numpy(keys), begin_bit=9,
                                   end_bit=9)


def test_sort_batched_tuple_values_and_checks():
    rng = np.random.default_rng(20)
    keys = random_keys(rng, 4 * 256, np.int32).reshape(4, 256)
    v1 = rng.random((4, 256)).astype(np.float32)
    v2 = rng.integers(-9, 9, (4, 256)).astype(np.int32)
    jk, (j1, j2) = tpusort.sort_batched(
        jnp.asarray(keys), (jnp.asarray(v1), jnp.asarray(v2)), stable=True)
    tk, (t1, t2) = tpusort_torch.sort_batched(
        torch.from_numpy(keys), (torch.from_numpy(v1), torch.from_numpy(v2)),
        stable=True)
    _same(tk, jk)
    _same(t1, j1)
    _same(t2, j2)
    assert t1.dtype == torch.float32 and t2.dtype == torch.int32
    with pytest.raises(ValueError):
        tpusort_torch.sort_batched(torch.from_numpy(keys).reshape(-1))
    with pytest.raises(ValueError, match="values"):
        tpusort_torch.sort_batched(torch.from_numpy(keys),
                                   torch.from_numpy(v1)[:2])


def test_sort_batched_tile_route():
    """The K3 gate (the card in the TPU's place), and the route's reshaping
    on CPU tensors, where ``sort_tiles`` runs its plain version."""
    v32 = [torch.zeros(2, 2, dtype=torch.int32)]
    v64 = [torch.zeros(2, 2, dtype=torch.int64)]
    ok = tseg._tile_route_ok
    assert ok("cuda", 1, True, False, 2048, ())
    assert ok("cuda", 1, True, False, 1 << 14, v32)
    assert ok("cuda", 1, True, False, 12288, v32)    # not a power of two
    assert not ok("cpu", 1, True, False, 2048, ())
    assert not ok("cuda", 2, True, False, 2048, ())  # 64-bit keys
    assert not ok("cuda", 1, False, False, 2048, ()) # a bit window
    assert not ok("cuda", 1, True, True, 2048, ())   # stable
    assert not ok("cuda", 1, True, False, 1000, ())
    assert not ok("cuda", 1, True, False, 1 << 15, ())
    assert not ok("cuda", 1, True, False, 2048, v64)
    rng = np.random.default_rng(21)
    keys = random_keys(rng, 6 * 384, np.float32).reshape(6, 384)
    vals = np.arange(6 * 384, dtype=np.int32).reshape(6, 384)
    orig = tseg._tile_route_ok
    tseg._tile_route_ok = lambda dev, *a: orig("cuda", *a)
    try:
        tk, tv = tpusort_torch.sort_batched(
            torch.from_numpy(keys), torch.from_numpy(vals), descending=True)
    finally:
        tseg._tile_route_ok = orig
    want = tpusort.sort_batched(jnp.asarray(keys), descending=True)
    _same(tk, want)
    np.testing.assert_array_equal(
        _bits(keys).reshape(-1)[tv.numpy().reshape(-1)],
        _bits(tk.numpy()).reshape(-1))


def _check_segments(keys, vals, offs, gk, gv, *, stable=True, key_fn=None):
    """Each segment of (gk, gv) is the stable sort of its input by
    key_fn(keys) (or, unstable, sorted keys with their own values)."""
    order_key = keys if key_fn is None else key_fn(keys)
    for s in range(len(offs) - 1):
        lo, hi = offs[s], offs[s + 1]
        order = np.argsort(order_key[lo:hi], kind="stable")
        np.testing.assert_array_equal(gk[lo:hi], keys[lo:hi][order])
        if stable:
            np.testing.assert_array_equal(gv[lo:hi], vals[lo:hi][order])
        else:
            np.testing.assert_array_equal(keys[gv[lo:hi]], gk[lo:hi])
            np.testing.assert_array_equal(np.sort(gv[lo:hi]),
                                          np.arange(lo, hi))


@pytest.mark.parametrize("case", ["ragged", "bit_range", "unstable",
                                  "descending", "one_segment",
                                  "empty_segments", "u64_keys",
                                  "i64_values", "keys_only"])
def test_segmented_sort_matches_jax(case):
    rng = np.random.default_rng(6)
    n = 5000
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    offs = np.array([0, 17, 17, 1000, 2500, n])
    kw = {}
    if case == "bit_range":
        kw = dict(begin_bit=8, end_bit=24)
    elif case == "unstable":
        keys = rng.integers(0, 256, n, dtype=np.uint32)      # heavy ties
        kw = dict(stable=False)
    elif case == "descending":
        keys = rng.standard_normal(n).astype(np.float32)
        kw = dict(descending=True)
    elif case == "one_segment":
        offs = np.array([0, n])
    elif case == "empty_segments":
        offs = np.array([0, 0, 0, 900, 900, 4000, n, n])
    elif case == "u64_keys":
        keys = random_keys(rng, n, np.uint64)
    elif case == "i64_values":
        vals = rng.integers(-2**62, 2**62, n)
    jargs = (jnp.asarray(keys), jnp.asarray(offs))
    targs = (torch.from_numpy(keys), torch.from_numpy(offs))
    if case == "keys_only":
        want = tpusort.segmented_sort(*jargs)
        _same(tpusort_torch.segmented_sort(*targs), want)
        _same(tpusort_torch.segmented_sort(targs[0], offs), want)  # numpy
        return
    jk, jv = tpusort.segmented_sort(*jargs, jnp.asarray(vals), **kw)
    tk, tv = tpusort_torch.segmented_sort(*targs, torch.from_numpy(vals),
                                          **kw)
    assert tk.dtype == targs[0].dtype
    assert tv.dtype == torch.from_numpy(vals).dtype
    _same(tk, jk)
    if case == "unstable":
        _check_segments(keys, vals, offs, tk.numpy(), tv.numpy(),
                        stable=False)
    else:
        _same(tv, jv)


def test_segmented_sort_rejects_noncovering_offsets():
    keys = torch.arange(1024, dtype=torch.int32).flip(0).view(torch.uint32)
    for bad in ([0, 256, 512], [16, 256, 1024], [0, 700, 600, 1024], [0],
                [[0, 1024]]):
        with pytest.raises(ValueError, match="segment_offsets"):
            tpusort_torch.segmented_sort(keys, torch.tensor(bad))
        with pytest.raises(ValueError):
            tpusort.segmented_sort(jnp.asarray(keys.numpy()),
                                   jnp.asarray(np.array(bad)))
    with pytest.raises(ValueError, match="bit range"):
        tpusort_torch.segmented_sort(keys, [0, 1024], begin_bit=30,
                                     end_bit=33)


def test_spread_plane_orders_as_segment_then_key():
    """The engine route's leading plane rises with (segment, key), is never
    all-ones, and on uniform keys fills the 32-bit range evenly however
    ragged the batch."""
    rng = np.random.default_rng(8)
    n = 1 << 16
    key = rng.integers(0, 2**32, n, dtype=np.uint32)
    for offs in (np.array([0, n]), np.array([0, 0, 1, 1, n - 7, n]),
                 segment_offsets(rng, n, 3), segment_offsets(rng, n, 5000)):
        seg = np.searchsorted(offs[1:], np.arange(n), side="right")
        plane = tseg._spread_plane(
            offs.astype(np.int64), torch.from_numpy(seg.astype(np.int32)),
            torch.from_numpy(key).view(torch.int32), n).numpy().view(np.uint32)
        order = np.lexsort((key, seg))
        assert (np.diff(plane[order].astype(np.int64)) >= 0).all()
        starts = plane[order][np.searchsorted(seg[order], np.unique(seg))]
        assert (np.diff(starts.astype(np.int64)) > 0).all()
        assert plane.max() < 0xFFFFFFFF
        hist = np.bincount(plane >> 27, minlength=32)
        assert hist.max() < 1.15 * n / 32 and hist.min() > 0.85 * n / 32


def _engine(keys, offs, vals=None, *, stable=True, desc=False):
    """The private engine route on CPU tensors (the plain K1 and K2), as
    ``segmented_sort`` calls it for CUDA tensors."""
    n = keys.shape[0]
    (plane,), traits = tdt.twiddle_in(torch.from_numpy(keys),
                                      descending=desc)
    seg = torch.from_numpy(np.searchsorted(offs[1:], np.arange(n),
                                           side="right").astype(np.int32))
    words = [] if vals is None else [torch.from_numpy(vals).view(torch.int32)]
    (kp,), sw = tseg._sort_on_engine(np.asarray(offs, np.int64), seg, plane,
                                     words, stable=stable)
    out = tdt.twiddle_out((kp,), traits, descending=desc).numpy()
    return out, (sw[0].numpy().view(vals.dtype) if words else None)


@pytest.mark.parametrize("nseg,equal", [(1, True), (3, True), (4, True),
                                        (64, True), (8192, True),
                                        (40, False), (3000, False)])
@pytest.mark.parametrize("mode", ["keys", "unstable", "stable"])
def test_engine_route_matches_jax(nseg, equal, mode):
    """The engine route on a batch of equal or ragged segments: no
    overflow, and the public JAX call's output."""
    rng = np.random.default_rng(100 + nseg)
    n = 20000 if nseg < 8192 else 49152
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    if mode != "keys":
        keys[: n // 2] &= 0xFF000000          # ties within every segment
    vals = np.arange(n, dtype=np.uint32)
    offs = np.linspace(0, n, nseg + 1).astype(np.int64) if equal \
        else segment_offsets(rng, n, nseg)
    tm.reset_counters()
    got = _engine(keys, offs, None if mode == "keys" else vals,
                  stable=mode == "stable")
    assert tm.counters()["overflow_fallbacks"] == 0
    assert tm.counters()["reference_routes"] == 0
    want = tpusort.segmented_sort(
        jnp.asarray(keys), jnp.asarray(offs),
        None if mode == "keys" else jnp.asarray(vals),
        stable=mode == "stable")
    if mode == "keys":
        np.testing.assert_array_equal(got[0], np.asarray(want))
    elif mode == "stable":
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    else:
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        _check_segments(keys, vals, offs, got[0], got[1], stable=False)


def test_engine_route_descending_float_pairs():
    rng = np.random.default_rng(18)
    n = 9000
    # uniform bit patterns (NaNs of both signs among them): normal
    # variates crowd a few exponents, and would overflow like any skew
    keys = rng.integers(0, 2**32, n, dtype=np.uint32).view(np.float32)
    keys[::100] = np.nan
    vals = np.arange(n, dtype=np.int32)
    offs = np.array([0, 500, 1700, 1700, n])
    got = _engine(keys, offs, vals, desc=True)
    jk, jv = tpusort.segmented_sort(jnp.asarray(keys), jnp.asarray(offs),
                                    jnp.asarray(vals), descending=True)
    np.testing.assert_array_equal(_bits(got[0]), _bits(jk))
    np.testing.assert_array_equal(got[1], np.asarray(jv))


def test_engine_route_overflow_is_counted():
    """A large segment of one repeated key, among many small ones: its
    elements share one place, their run overflows, the flag is read and
    the fallback counted, and the exact way answers, as the public call's
    does."""
    rng = np.random.default_rng(9)
    n = 40000
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    keys[:30000] = 0x12345678
    offs = np.concatenate([[0], np.arange(30000, n + 1, 10)]).astype(np.int64)
    tm.reset_counters()
    got, _ = _engine(keys, offs)
    assert tm.counters()["overflow_fallbacks"] == 1
    want = tpusort.segmented_sort(jnp.asarray(keys), jnp.asarray(offs))
    np.testing.assert_array_equal(got, np.asarray(want))
    _same(tpusort_torch.segmented_sort(torch.from_numpy(keys), offs), want)


def _skewed_batch(case, rng, n):
    """(keys, offsets) of a batch whose keys crowd inside segments larger
    than a run."""
    if case == "constant_segment":
        keys = rng.integers(0, 2**32, n, dtype=np.uint32)
        keys[:30000] = 0x12345678
        return keys, np.concatenate([[0], np.arange(30000, n + 1, 10)])
    if case == "normal_floats":
        return (rng.standard_normal(n).astype(np.float32),
                np.array([0, 9000, 9000, 25000, n]))
    keys = rng.integers(0, 4, n, dtype=np.uint32) * np.uint32(0x31415927)
    return keys, np.array([0, 12000, n])            # duplicates


@pytest.mark.parametrize("case", ["constant_segment", "normal_floats",
                                  "duplicates"])
def test_engine_gate_sends_skewed_batches_to_the_exact_sort(case,
                                                            monkeypatch):
    """From ``planner.PLANNER_MIN_N`` keys on, a sample of the leading
    plane is checked before the engine runs: these batches overflow it
    (gate off), and with the gate on they are counted as reference routes
    with no engine run; either way, and in the public call, the output is
    JAX's."""
    rng = np.random.default_rng(21)
    n = 40000
    keys, offs = _skewed_batch(case, rng, n)
    offs = offs.astype(np.int64)
    want = tpusort.segmented_sort(jnp.asarray(keys), jnp.asarray(offs))
    tm.reset_counters()
    got, _ = _engine(keys, offs)
    assert tm.counters()["overflow_fallbacks"] == 1
    np.testing.assert_array_equal(_bits(got), _bits(want))
    monkeypatch.setattr(tseg._planner, "PLANNER_MIN_N", 1 << 12)
    tm.reset_counters()
    got, _ = _engine(keys, offs)
    c = tm.counters()
    assert c["reference_routes"] == 1 and c["overflow_fallbacks"] == 0
    np.testing.assert_array_equal(_bits(got), _bits(want))
    _same(tpusort_torch.segmented_sort(torch.from_numpy(keys), offs), want)


@pytest.mark.parametrize("nseg,equal", [(1, True), (64, True), (8192, True),
                                        (40, False), (3000, False)])
def test_engine_gate_lets_uniform_batches_through(nseg, equal, monkeypatch):
    monkeypatch.setattr(tseg._planner, "PLANNER_MIN_N", 1 << 12)
    rng = np.random.default_rng(300 + nseg)
    n = 49152
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    offs = np.linspace(0, n, nseg + 1).astype(np.int64) if equal \
        else segment_offsets(rng, n, nseg)
    tm.reset_counters()
    got = _engine(keys, offs, vals)
    c = tm.counters()
    assert c["reference_routes"] == 0 and c["overflow_fallbacks"] == 0
    jk, jv = tpusort.segmented_sort(jnp.asarray(keys), jnp.asarray(offs),
                                    jnp.asarray(vals))
    np.testing.assert_array_equal(got[0], np.asarray(jk))
    np.testing.assert_array_equal(got[1], np.asarray(jv))


@pytest.mark.parametrize("n,nseg", [(20000, 4), (30000, 64), (49152, 8192)])
def test_jax_feed_overflows_on_the_port_engine(n, nseg):
    """The defect this module does not copy: the planes JAX's engine route
    builds, (segment id << shift, key) in input order, overflow pass 0 on
    every batch, since a contiguous tile holds one segment digit."""
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)) \
        .view(torch.int32)
    offs = np.linspace(0, n, nseg + 1).astype(np.int64)
    seg = np.searchsorted(offs[1:], np.arange(n), side="right")
    shift = 32 - max((nseg - 1).bit_length(), 1)
    p0 = torch.from_numpy(((seg.astype(np.uint64) << shift) & 0xFFFFFFFF)
                          .astype(np.uint32)).view(torch.int32)
    *_, ovf = tm.sort_twiddled_msd(
        (p0, keys), (), begin_bit=0, end_bit=64, total_bits=64,
        config=get_config(64, False, "cpu"))
    assert bool(ovf)
