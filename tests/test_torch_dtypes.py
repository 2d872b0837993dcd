"""The port's twiddles and configs against ``tpusort.dtypes`` and
``tpusort.configs``, bit for bit.

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


def _keys(dtype, seed):
    raw = np.random.default_rng(seed).integers(0, 2**32, 4000, dtype=np.uint32)
    return np.concatenate([raw.view(dtype), _special_values(dtype)])


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


def test_unsupported_dtypes_raise():
    with pytest.raises(TypeError):
        td.traits_for(torch.int16)
    with pytest.raises(NotImplementedError, match="item 4"):
        td.twiddle_in(torch.zeros(4, dtype=torch.int64))


def test_cpu_config_matches_jax():
    for bits in (32, 64):
        for hv in (False, True):
            j = jcfg.get_config(bits, hv, "cpu")
            t = tcfg.get_config(bits, hv, "cpu")
            assert t.plan_kwargs() == j.plan_kwargs()


def test_cuda_config_row():
    cfg = tcfg.get_config(32, False, "cuda")
    assert cfg.plan_kwargs() == dict(k=16384, r=32, min_n=1 << 16)
    assert cfg.default_algorithm == "msd"
    # unregistered shapes get the defaults
    assert tcfg.get_config(64, True, "cuda") == tcfg.SortConfig()
