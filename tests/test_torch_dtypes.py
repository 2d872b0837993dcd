"""The port's twiddles, 64-bit splits and configs against ``tpusort.dtypes``
and ``tpusort.configs``, bit for bit.

Inputs are numpy arrays from a seed (the ``tests/test_twiddle.py`` cases:
random bit patterns plus NaN with and without payloads, -0.0, +0.0,
infinities and the integer extremes), handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_twiddle import _special_values
from tpusort import configs as jcfg
from tpusort import dtypes as jd
from tpusort_torch import configs as tcfg
from tpusort_torch import dtypes as td

DTYPES32 = ["uint32", "int32", "float32"]
DTYPES64 = ["uint64", "int64", "float64"]


def _keys(dtype, seed):
    words = 4000 * (np.dtype(dtype).itemsize // 4)
    raw = np.random.default_rng(seed).integers(0, 2**32, words, dtype=np.uint32)
    return np.concatenate([raw.view(dtype), _special_values(dtype)])


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", DTYPES32)
def test_twiddle_matches_jax(dtype, descending):
    keys = _keys(dtype, 7)
    (jp,), jtraits = jd.twiddle_in(jnp.asarray(keys), descending=descending)
    (tp,), ttraits = td.twiddle_in(torch.from_numpy(keys),
                                   descending=descending)
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy().view(np.uint32), np.asarray(jp))
    assert (ttraits.name, ttraits.bits, ttraits.planes, ttraits.is_float,
            ttraits.is_signed) == (jtraits.name, jtraits.bits, jtraits.planes,
                                   jtraits.is_float, jtraits.is_signed)
    back = td.twiddle_out((tp,), ttraits, descending=descending)
    assert back.dtype == getattr(torch, dtype)
    # bitwise roundtrip: NaN payloads and -0.0 survive
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  keys.view(np.uint32))


def test_float_total_order():
    """-NaN < -inf < negatives < -0.0 < +0.0 < positives < +inf < +NaN."""
    ordered = np.array(
        [0xFFFFFFFF, 0xFF800000, 0xC47A0000, 0xBF800000, 0x80800000,
         0x80000000, 0x00000000, 0x00800000, 0x3F800000, 0x447A0000,
         0x7F800000, 0x7FFFFFFF], dtype=np.uint32).view(np.float32)
    (t,), _ = td.twiddle_in(torch.from_numpy(ordered))
    u = t.numpy().view(np.uint32).astype(np.int64)
    assert np.all(np.diff(u) > 0), u


@pytest.mark.parametrize("name,bits", [
    ("uint32", 32), ("int32", 32), ("float32", 32),
    ("uint64", 64), ("int64", 64), ("float64", 64),
])
def test_key_bits(name, bits):
    assert td.key_bits(getattr(torch, name)) == bits
    assert td.key_bits(getattr(torch, name)) == jd.key_bits(name)


@pytest.mark.parametrize("dtype", DTYPES64)
def test_split_join64_matches_host_boundary(dtype):
    """split64/join64 by device views give the words of the JAX package's
    numpy host boundary, NaN payloads and -0.0/+0.0 included."""
    keys = _keys(dtype, 11)
    if dtype == "float64":
        keys[:6] = np.array([0x7FF8000000000000, 0x7FF8000000000005,
                             0xFFF8000000000001, 0x8000000000000000, 0,
                             0xFFFFFFFFFFFFFFFF], dtype=np.uint64).view(dtype)
    jhi, jlo = jd.split64_host(keys)
    thi, tlo = td.split64(torch.from_numpy(keys))
    assert thi.dtype == tlo.dtype == torch.int32
    np.testing.assert_array_equal(_u32(thi), jhi)
    np.testing.assert_array_equal(_u32(tlo), jlo)
    back = td.join64(thi, tlo, getattr(torch, dtype))
    np.testing.assert_array_equal(back.numpy().view(np.uint64),
                                  jd.join64_host(jhi, jlo, dtype).view(np.uint64))
    np.testing.assert_array_equal(back.numpy().view(np.uint64),
                                  keys.view(np.uint64))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", DTYPES64)
def test_twiddle64_matches_jax(dtype, descending):
    """twiddle_planes_in/out and twiddle_in/out on 64-bit keys against
    ``tpusort.dtypes`` (x64 on: the JAX twiddle splits on the device)."""
    keys = _keys(dtype, 12)
    traits = td.traits_for(getattr(torch, dtype))
    jplanes = jd.twiddle_planes_in(
        tuple(jnp.asarray(p) for p in jd.split64_host(keys)),
        jd.traits_for(dtype), descending=descending)
    tplanes = td.twiddle_planes_in(td.split64(torch.from_numpy(keys)),
                                   traits, descending=descending)
    (tin_hi, tin_lo), _ = td.twiddle_in(torch.from_numpy(keys),
                                        descending=descending)
    for j, t, t2 in zip(jplanes, tplanes, (tin_hi, tin_lo)):
        np.testing.assert_array_equal(_u32(t), np.asarray(j))
        assert torch.equal(t, t2)
    jout = jd.twiddle_planes_out(jplanes, jd.traits_for(dtype),
                                 descending=descending)
    tout = td.twiddle_planes_out(tplanes, traits, descending=descending)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(_u32(t), np.asarray(j))
    back = td.twiddle_out(tplanes, traits, descending=descending)
    assert back.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(back.numpy().view(np.uint64),
                                  keys.view(np.uint64))


def test_float64_total_order():
    """-NaN < -inf < negatives < -0.0 < +0.0 < positives < +inf < +NaN,
    lexicographically over the (hi, lo) planes."""
    ordered = np.array(
        [0xFFFFFFFFFFFFFFFF, 0xFFF0000000000000, 0xC08F400000000000,
         0xBFF0000000000000, 0x8000000000000001, 0x8000000000000000, 0,
         1, 0x3FF0000000000000, 0x7FF0000000000000, 0x7FFFFFFFFFFFFFFF],
        dtype=np.uint64).view(np.float64)
    hi, lo = td.twiddle_in(torch.from_numpy(ordered))[0]
    u = (_u32(hi).astype(np.uint64) << np.uint64(32)) | _u32(lo)
    assert np.all(np.diff(u.astype(object)) > 0), u


def test_unsupported_dtypes_raise():
    with pytest.raises(TypeError):
        td.traits_for(torch.int16)
    with pytest.raises(TypeError):
        td.twiddle_in(torch.zeros(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="64-bit"):
        td.split64(torch.zeros(4, dtype=torch.int32))


def test_cpu_config_matches_jax():
    for bits in (32, 64):
        for hv in (False, True):
            j = jcfg.get_config(bits, hv, "cpu")
            t = tcfg.get_config(bits, hv, "cpu")
            assert t.plan_kwargs() == j.plan_kwargs()
            assert t.small_n_threshold == j.small_n_threshold == 2048
    assert tcfg.SortConfig().small_n_threshold == \
        jcfg.SortConfig().small_n_threshold == 1 << 14


def test_cuda_config_row():
    cfg = tcfg.get_config(32, False, "cuda")
    assert cfg.plan_kwargs() == dict(k=16384, r=32, min_n=1 << 16)
    assert cfg.default_algorithm == "msd"
    # pairs and 64-bit keys cap the leaf at 16,384 slots (K2's shared
    # memory with two or three key planes)
    for bits, hv in ((32, True), (64, False), (64, True)):
        multi = tcfg.get_config(bits, hv, "cuda")
        assert multi.plan_kwargs() == dict(k=16384, r=32, min_n=1 << 16,
                                           leaf_max=16384)
        assert multi.default_algorithm == "msd"
    # unregistered platforms get the defaults
    assert tcfg.get_config(64, True, "mps") == tcfg.SortConfig()
