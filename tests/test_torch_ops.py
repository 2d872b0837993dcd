"""``tpusort_torch.ops.scan`` and ``ops.histogram`` against
``tpusort.ops.scan`` and ``tpusort.ops.histogram`` on the same numpy inputs
(mirrors ``tests/test_ops.py``).  Integer results compare exactly; float32
sums within ``rtol=1e-5``, the tolerance the JAX test states for its own
segmented sums (the two packages add in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusort.ops import histogram as jh
from tpusort.ops import scan as jsc
from tpusort_torch.ops import histogram as th
from tpusort_torch.ops import scan as tsc


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.uint32,
                                   np.float32])
def test_inclusive_exclusive_sum(dtype):
    x = np.random.default_rng(0).integers(0, 100, 1000).astype(dtype)
    for jf, tf in ((jsc.inclusive_sum, tsc.inclusive_sum),
                   (jsc.exclusive_sum, tsc.exclusive_sum)):
        want = np.asarray(jf(jnp.asarray(x)))
        got = tf(torch.from_numpy(x))
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_sums_along_an_axis():
    x = np.random.default_rng(1).integers(0, 100, (6, 40)).astype(np.int32)
    for axis in (0, 1, -1):
        np.testing.assert_array_equal(
            tsc.inclusive_sum(torch.from_numpy(x), axis).numpy(),
            np.asarray(jsc.inclusive_sum(jnp.asarray(x), axis)))
        np.testing.assert_array_equal(
            tsc.exclusive_sum(torch.from_numpy(x), axis).numpy(),
            np.asarray(jsc.exclusive_sum(jnp.asarray(x), axis)))
    u = x.astype(np.uint32)
    np.testing.assert_array_equal(
        tsc.exclusive_sum(torch.from_numpy(u), 0).numpy(),
        np.asarray(jsc.exclusive_sum(jnp.asarray(u), 0)))


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
def test_scan_ops_kernel_route(dtype):
    """``use_kernel=True`` plays ``use_pallas=True``: the kernel's contract
    (its plain version on a CPU tensor) against the Pallas kernel."""
    x = (np.arange(128 * 8 * 2) % 1000).astype(dtype)
    for jf, tf in ((jsc.inclusive_sum, tsc.inclusive_sum),
                   (jsc.exclusive_sum, tsc.exclusive_sum)):
        want = np.asarray(jf(jnp.asarray(x), use_pallas=True))
        got = tf(torch.from_numpy(x), use_kernel=True)
        np.testing.assert_array_equal(got.numpy(), want)   # sums < 2^24


def test_scan_routing():
    """The route: 1-D, last axis, a kernel dtype, and the caller's word or,
    by default, a CUDA tensor of at least 2^16 elements."""
    x = torch.zeros(1 << 16, dtype=torch.int32)
    assert tsc._kernel_route(x, -1, True) and tsc._kernel_route(x, 0, True)
    assert not tsc._kernel_route(x, -1, False)
    assert not tsc._kernel_route(x, -1, None)          # a CPU tensor
    assert tsc._kernel_route(x.to("meta"), -1, True)
    assert not tsc._kernel_route(x.long(), -1, True)
    assert not tsc._kernel_route(x.reshape(2, -1), -1, True)
    assert not tsc._kernel_route(x, 1, True)

    class OnCard:            # the default route asks the tensor where it is
        dtype, shape, is_cuda = torch.float32, (1 << 16,), True

        def dim(self):
            return 1
    assert tsc._kernel_route(OnCard(), -1, None)
    OnCard.shape = ((1 << 16) - 1,)
    assert not tsc._kernel_route(OnCard(), -1, None)


def test_generic_scans():
    x = np.random.default_rng(1).integers(0, 1000, 512)
    got = tsc.inclusive_scan(torch.from_numpy(x), torch.maximum)
    want = jsc.inclusive_scan(jnp.asarray(x), jnp.maximum)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tsc.exclusive_scan(torch.from_numpy(x), torch.maximum, identity=0)
    want = jsc.exclusive_scan(jnp.asarray(x), jnp.maximum, identity=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 2, 3, 100, 513])
def test_generic_scan_lengths_and_axes(n):
    """Lengths that are no power of two, axis 0 of a 2-D tensor, and an
    operator that does not commute: the composition of affine maps,
    (a, b) then (c, d) = (a*c, b*c + d)."""
    rng = np.random.default_rng(n)
    x = rng.integers(-3, 4, (n, 5))
    got = tsc.inclusive_scan(torch.from_numpy(x), torch.minimum, axis=0)
    np.testing.assert_array_equal(got.numpy(),
                                  np.minimum.accumulate(x, axis=0))
    a = rng.choice([-1, 1, 2], n, p=[0.45, 0.45, 0.1])
    b = rng.integers(0, 5, n)

    def compose(e, l):
        return torch.stack([e[0] * l[0], e[1] * l[0] + l[1]])

    got = tsc.inclusive_scan(torch.from_numpy(np.stack([a, b])), compose,
                             axis=1).numpy()
    ca, cb = 1, 0
    for i in range(n):
        ca, cb = ca * a[i], cb * a[i] + b[i]
        assert (got[0, i], got[1, i]) == (ca, cb)


def test_segmented_sum():
    rng = np.random.default_rng(2)
    x = rng.random(2000).astype(np.float32)
    ids = rng.integers(0, 16, 2000)
    want = np.asarray(jsc.segmented_sum(jnp.asarray(x), jnp.asarray(ids), 16))
    got = tsc.segmented_sum(torch.from_numpy(x), torch.from_numpy(ids), 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    xi = rng.integers(0, 1000, 2000).astype(np.int32)
    ids[::7] = 99                  # ids outside [0, 16) are dropped
    ids[3::11] = -1
    want = np.asarray(jsc.segmented_sum(jnp.asarray(xi), jnp.asarray(ids),
                                        16))
    got = tsc.segmented_sum(torch.from_numpy(xi), torch.from_numpy(ids), 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_histogram_even():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1000, 5000).astype(np.int32)
    x2 = np.concatenate([x, np.array([-5, 1000, 2000], np.int32)])
    for arr in (x, x2):                # out-of-range values are dropped
        want = np.asarray(jh.histogram_even(jnp.asarray(arr), 10, 0, 1000))
        got = th.histogram_even(torch.from_numpy(arr), 10, 0, 1000)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_histogram_even_wide_range_exact():
    """Full-range uint32 binning is exact at every edge, as JAX's."""
    lo, hi, bins = 0, 1 << 32, 7
    edges = [-(-(j * (1 << 32)) // bins) for j in range(bins + 1)]
    vals = []
    for e in edges[1:bins]:
        vals += [e - 1, e, e + 1]
    vals += [0, (1 << 32) - 1, (1 << 31), (1 << 24) + 1, (1 << 24) - 1]
    x = np.array(vals, np.uint32)
    want = np.asarray(jh.histogram_even(jnp.asarray(x), bins, lo, hi))
    got = th.histogram_even(torch.from_numpy(x), bins, lo, hi)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == len(vals)
    # a uint32 range that ends inside the dtype
    want = np.asarray(jh.histogram_even(jnp.asarray(x), 5, 1 << 20, 1 << 31))
    got = th.histogram_even(torch.from_numpy(x), 5, 1 << 20, 1 << 31)
    np.testing.assert_array_equal(got.numpy(), want)
    # int32 negative range + non-representable float edges
    xi = np.array([-100, -1, 0, 1, 99, 100, 101], np.int32)
    want = np.asarray(jh.histogram_even(jnp.asarray(xi), 3, -100, 101))
    got = th.histogram_even(torch.from_numpy(xi), 3, -100, 101)
    np.testing.assert_array_equal(got.numpy(), want)
    # float32 keys with a fractional edge
    xf = np.array([0.0, 0.5, 1.0 / 3, 2.0 / 3, 0.999], np.float32)
    want = np.asarray(jh.histogram_even(jnp.asarray(xf), 3, 0.0, 1.0))
    got = th.histogram_even(torch.from_numpy(xf), 3, 0.0, 1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        th.histogram_even(torch.from_numpy(xf), 0, 0.0, 1.0)


@pytest.mark.parametrize("tiles,shift,bits", [(4, 8, 8), (1, 8, 8),
                                              (2, 20, 12), (8, 0, 4)])
def test_digit_histogram(tiles, shift, bits):
    keys = np.random.default_rng(0).integers(
        0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jh.digit_histogram(jnp.asarray(keys), shift=shift,
                                         bits=bits, tiles=tiles))
    got = th.digit_histogram(torch.from_numpy(keys), shift=shift, bits=bits,
                             tiles=tiles)
    assert got.shape == (tiles, 1 << bits) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_digit_histogram_kernel_route():
    """``use_kernel=True`` plays ``use_pallas=True``: the global form
    through K6's contract, against the Pallas kernel (its 512 x 128 tile)
    and, at a length the TPU kernel refuses, against the plain route."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 32, 512 * 128, dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(jh.digit_histogram(jnp.asarray(keys), 27, 5,
                                         use_pallas=True))
    got = th.digit_histogram(torch.from_numpy(keys), 27, 5, use_kernel=True)
    assert got.shape == (1, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    odd = torch.from_numpy(keys[:-77])
    np.testing.assert_array_equal(
        th.digit_histogram(odd, 3, 7, use_kernel=True).numpy(),
        th.digit_histogram(odd, 3, 7, use_kernel=False).numpy())
    # wide digits, other count dtypes and per-tile forms stay plain
    got = th.digit_histogram(odd, 0, 10, use_kernel=True)
    assert got.shape == (1, 1024) and int(got.sum()) == odd.shape[0]
    got = th.digit_histogram(odd, 0, 4, dtype=torch.int64, use_kernel=True)
    assert got.dtype == torch.int64
