"""``tpusort_torch.sort`` on CPU tensors against ``tpusort`` and the numpy
oracle, over the entropy ladder {1..11, 0}, for uint32/int32/float32,
ascending and descending, at a size that plans 2 passes under the CPU row.
Keys compare bit for bit (keys-only output is unique).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusort_torch
from oracle import np_sort_oracle
from tpusort.ops import msd as jm
from tpusort_torch.ops import msd as tm
from tpusort_torch.utils.datagen import entropy_keys, random_keys

N = 300_000           # 2 passes under the CPU row (K 2048, R 16, s1 256)
LEVELS = list(range(1, 12)) + [0]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _keys(level, dtype):
    rng = np.random.default_rng(1000 * level + np.dtype(dtype).num)
    if level == 1:
        return random_keys(rng, N, dtype)
    return entropy_keys(rng, N, level, dtype)


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
@pytest.mark.parametrize("level", LEVELS)
def test_sort_entropy_ladder(level, dtype):
    x = _keys(level, dtype)
    for descending in (False, True):
        got = tpusort_torch.sort(torch.from_numpy(x), descending=descending)
        assert got.dtype == torch.from_numpy(x).dtype
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(
            _bits(got.numpy()), _bits(np_sort_oracle(x, descending=descending)))


@pytest.mark.parametrize("level", LEVELS)
def test_sort_matches_tpusort_engine(level):
    """The same uint32 keys through the JAX MSD engine (XLA path)."""
    x = _keys(level, np.uint32)
    (want,), _ = jm.sort_twiddled_msd(
        (jnp.asarray(x),), (), begin_bit=0, end_bit=32, total_bits=32,
        use_pallas=False, plan_kwargs=dict(k=2048, r=16, s1=256, min_n=4096))
    got = tpusort_torch.sort(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got.numpy()), np.asarray(want))


def test_overflow_takes_the_fallback():
    x = entropy_keys(np.random.default_rng(0), N, 0, np.float32)
    tm.reset_counters()
    got = tpusort_torch.sort_keys_descending(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(x))
    c = tm.counters()
    assert c["overflow_fallbacks"] == 1 and c["reference_routes"] == 0


def test_uniform_runs_the_engine():
    # uniform bit patterns (floats uniform in [0, 1) share their top bits
    # and overflow one run)
    x = random_keys(np.random.default_rng(1), N).view(np.float32)
    x[::1000] = np.float32("nan")
    x[1::1000] = np.float32(-0.0)
    tm.reset_counters()
    got = tpusort_torch.sort(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(np_sort_oracle(x)))
    assert tm.counters()["overflow_fallbacks"] == 0


@pytest.mark.parametrize("n", [0, 1, 127, 4095, 4096, 5000])
def test_small_and_edge_sizes(n):
    x = random_keys(np.random.default_rng(n), n, np.int32)
    got = tpusort_torch.sort(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np_sort_oracle(x))


def test_wrappers():
    x = torch.from_numpy(random_keys(np.random.default_rng(2), 9000))
    asc = tpusort_torch.sort(x)
    assert torch.equal(tpusort_torch.sort_keys(x).view(torch.int32),
                       asc.view(torch.int32))
    assert torch.equal(tpusort_torch.unstable_sort_keys(x).view(torch.int32),
                       asc.view(torch.int32))
    assert torch.equal(
        tpusort_torch.sort_keys_descending(x).view(torch.int32),
        tpusort_torch.sort(x, descending=True).view(torch.int32))


def test_unsupported_arguments_raise():
    """Bad arguments raise; the calls that raised before the general path
    was ported (bit ranges, sub-range argsort, stable pairs and argsort of
    64-bit keys) now run, here through the reference route."""
    x = torch.zeros(10, dtype=torch.uint32)
    v = torch.zeros(10, dtype=torch.int32)
    for kw in (dict(begin_bit=4, end_bit=4), dict(end_bit=33),
               dict(begin_bit=-1)):
        with pytest.raises(ValueError, match="bit range"):
            tpusort_torch.sort(x, **kw)
    assert tpusort_torch.sort(x, begin_bit=4).dtype == torch.uint32
    assert tpusort_torch.sort(x, end_bit=16).dtype == torch.uint32
    assert tpusort_torch.sort_pairs(x, v, end_bit=16)[1].dtype == torch.int32
    assert torch.equal(tpusort_torch.argsort(x, begin_bit=8),
                       torch.arange(10))
    for dt in (torch.int64, torch.uint64, torch.float64):
        k = torch.zeros(10, dtype=dt)
        assert tpusort_torch.sort_pairs(k, v)[1].dtype == v.dtype
        assert torch.equal(tpusort_torch.argsort(k), torch.arange(10))
        assert tpusort_torch.sort(k, begin_bit=1).dtype == dt
        with pytest.raises(ValueError, match="bit range"):
            tpusort_torch.sort(k, end_bit=65)
        assert tpusort_torch.sort(k).dtype == dt
        assert tpusort_torch.unstable_sort_pairs(k, v)[1].dtype == v.dtype
    assert tpusort_torch.sort_pairs(x, v)[1].dtype == torch.int32
    with pytest.raises(ValueError):
        tpusort_torch.sort(x, torch.zeros(9, dtype=torch.int32))
    with pytest.raises(TypeError, match="32- or 64-bit"):
        tpusort_torch.sort(x, torch.zeros(10, dtype=torch.int16))
    with pytest.raises(ValueError):
        tpusort_torch.sort_planes((x,), key_dtype="uint64")
    with pytest.raises(NotImplementedError):
        tpusort_torch.sort(torch.zeros(2, 5, dtype=torch.int32))
    with pytest.raises(ValueError):
        tpusort_torch.sort(x, end_bit=33)
    with pytest.raises(TypeError):
        tpusort_torch.sort(torch.zeros(10, dtype=torch.int16))


def test_port_imports_no_jax():
    code = (
        "import sys, tpusort_torch, tpusort_torch.ops.msd, "
        "tpusort_torch.ops.small, tpusort_torch.ops.reference, "
        "tpusort_torch.kernels.partition, tpusort_torch.kernels.bitonic, "
        "tpusort_torch.kernels._build, tpusort_torch.utils.datagen, "
        "tpusort_torch.api, tpusort_torch.dtypes, tpusort_torch.configs\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'tpusort' or m.startswith('tpusort.') "
        "for m in sys.modules)\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
