"""The port's K5 and K6 (their plain PyTorch versions, which CPU tensors
take) against the Pallas kernels of ``tpusort.kernels.scanhist`` in
interpret mode.

Integer prefix sums (which wrap in 32 bits) and histograms compare exactly.
float32 prefix sums add in another order in the two packages, so they
compare within ``rtol=1e-6`` of the running sum: the inputs are integers
below 2^10 at lengths whose sums stay under 2^24, where float32 is exact,
so the tolerance is never used up; it is stated for inputs that do round.
Inputs are numpy arrays from a seed.  The CUDA kernels themselves are
checked on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusort.kernels import scanhist as js
from tpusort_torch.kernels import scanhist as ts

F32_RTOL = 1e-6


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("n", [1, 128 * 8, 128 * 8 * 3 + 77])
def test_prefix_sum_matches_pallas(dtype, exclusive, n):
    rng = np.random.default_rng(7 + n)
    if dtype == np.float32:
        x = rng.integers(0, 1 << 10, n).astype(np.float32)
    else:
        x = rng.integers(0, 1 << 20, n).astype(dtype)
    want = np.asarray(js.prefix_sum_tiles(
        jnp.asarray(x), exclusive=exclusive, tile_rows=8, interpret=True))
    got = ts.prefix_sum_tiles(torch.from_numpy(x), exclusive=exclusive)
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == (n,)
    if dtype == np.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.int32, np.uint32])
def test_prefix_sum_wraps_in_32_bits(dtype):
    """Sums past 2^32 wrap, as jnp.cumsum's do (torch.cumsum would widen
    int32 to int64 unless told otherwise)."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 31, 5000).astype(dtype)
    want = np.asarray(js.prefix_sum_tiles(jnp.asarray(x), tile_rows=8,
                                          interpret=True))
    got = ts.prefix_sum_tiles(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.cumsum(x, dtype=dtype))
    assert int(x.astype(np.int64).sum()) > 1 << 32


def test_prefix_sum_f32_rounding_within_tolerance():
    """float32 values that do round: the two packages add in different
    orders and agree within the stated tolerance of the float64 sum."""
    rng = np.random.default_rng(12)
    x = rng.random(128 * 8 * 2 + 5).astype(np.float32)
    want = np.asarray(js.prefix_sum_tiles(jnp.asarray(x), tile_rows=8,
                                          interpret=True))
    got = ts.prefix_sum_tiles(torch.from_numpy(x)).numpy()
    exact = np.cumsum(x.astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=2e-6)
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_prefix_sum_edges():
    empty = torch.zeros(0, dtype=torch.float32)
    assert ts.prefix_sum_tiles(empty).shape == (0,)
    with pytest.raises(ValueError, match="1-D"):
        ts.prefix_sum_tiles(torch.zeros(2, 2, dtype=torch.int32))
    with pytest.raises(TypeError):
        ts.prefix_sum_tiles(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="device"):
        ts.prefix_sum_tiles(torch.zeros(4, dtype=torch.int32, device="meta"))
    before = ts.prefix_sum_tiles.launches
    ts.prefix_sum_tiles(torch.ones(4, dtype=torch.int32))
    assert ts.prefix_sum_tiles.launches == before      # CPU: no launch


@pytest.mark.parametrize("shift,bits", [(27, 5), (0, 3), (24, 8), (13, 1)])
def test_digit_histogram_matches_pallas(shift, bits):
    rng = np.random.default_rng(11)
    n = 128 * 8 * 4
    x = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    if bits <= 5:        # the 256-bin Pallas kernel is a slow interpret run
        want = np.asarray(js.digit_histogram_tiles(
            jnp.asarray(x), shift, bits, tile_rows=8, interpret=True))
    else:
        want = np.bincount((x >> shift) & ((1 << bits) - 1),
                           minlength=1 << bits).astype(np.int32)
    got = ts.digit_histogram_tiles(torch.from_numpy(x), shift, bits)
    assert got.dtype == torch.int32 and got.shape == (1 << bits,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 1000, 128 * 8 * 4 - 3])
def test_digit_histogram_any_length(n):
    """A length that is no tile multiple, which the TPU kernel refuses,
    against numpy; int32 bit patterns count like uint32."""
    rng = np.random.default_rng(13 + n)
    x = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    want = np.bincount((x >> 26) & 0x3F, minlength=64)
    got = ts.digit_histogram_tiles(torch.from_numpy(x), 26, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    got = ts.digit_histogram_tiles(torch.from_numpy(x.view(np.int32)), 26, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_digit_histogram_constant_keys():
    x = torch.full((5000,), 0xDEADBEEF - (1 << 32), dtype=torch.int32)
    got = ts.digit_histogram_tiles(x.view(torch.uint32), 24, 8)
    assert int(got[0xDE]) == 5000 and int(got.sum()) == 5000


def test_digit_histogram_edges():
    x = torch.zeros(16, dtype=torch.uint32)
    for shift, bits in ((0, 9), (28, 5), (0, 0), (-1, 4)):
        with pytest.raises(ValueError):
            ts.digit_histogram_tiles(x, shift, bits)
    with pytest.raises(ValueError):
        ts.digit_histogram_tiles(x.view(torch.float32), 0, 4)
    with pytest.raises(ValueError, match="device"):
        ts.digit_histogram_tiles(x.to("meta"), 0, 4)
    before = ts.digit_histogram_tiles.launches
    ts.digit_histogram_tiles(x, 0, 4)
    assert ts.digit_histogram_tiles.launches == before  # CPU: no launch
