"""K1b, the splitter mode of the port's partition pass (its plain PyTorch
version, which CPU tensors take), against the Pallas kernel's splitter mode
in interpret mode, bit for bit.

Each case compares the (T, R) counts exactly and every slot the counts
mark valid (pad slots are unspecified).  Payloads ride unstably in both
packages, so the cases with payloads use unique keys, where any correct
sort gives one payload order; keys-only cases may tie freely.  Inputs are
numpy arrays from a seed.  The CUDA kernel is checked against the same
plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusort.kernels import partition as jp
from tpusort_torch.kernels import partition as tp
from tpusort_torch.utils.datagen import entropy_keys, random_keys, zipf_keys

T, K, R, S = 4, 1024, 8, 256


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _unique(rng, shape):
    """Distinct uint32 words spread over the whole range."""
    n = int(np.prod(shape))
    x = rng.permutation(n).astype(np.uint64) * np.uint64(0x9E3779B1)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)


def _quantile_splitters(planes, rng):
    """(T, R-1) splitter words per plane: R-1 lexicographic quantiles of
    all the keys (the same for every tile), and random tie fractions of 0,
    a middling value or 65536 (the greedy fill)."""
    flat = [p.reshape(-1) for p in planes]
    order = np.lexsort(flat[::-1])
    at = (np.arange(1, R) * order.size) // R
    words = [np.tile(f[order][at], (T, 1)) for f in flat]
    fracs = rng.choice(np.array([0, 1, 20000, 32768, 51234, 65535, 65536],
                                np.uint32), (T, R - 1))
    return words, fracs


def _valid_slots(counts, t_seg):
    c = np.minimum(counts, S).reshape(T // t_seg, t_seg, R).transpose(0, 2, 1)
    return (np.arange(S) < c[..., None]).reshape(-1)


def _compare(planes, values, words, fracs, *, cin=None, q_in=None, n=None,
             sorted_run=None, t_seg=1):
    """Both packages on the same inputs.  With ``t_seg`` 2 the Pallas
    kernel takes two tiles a grid step, so its tile index (and with it
    the dither) comes from the step and the tile within it."""
    nk = len(planes)
    kw = dict(r=R, s=S, lo_bit=32 * nk - 3, width=3, q_in=q_in, n=n,
              t_seg=t_seg, sorted_run=sorted_run)
    jdata, jcounts = jp.partition_pass_fused(
        [jnp.asarray(p) for p in planes], [jnp.asarray(v) for v in values],
        None if cin is None else jnp.asarray(cin),
        splitters=[jnp.asarray(w) for w in words],
        splitter_fracs=jnp.asarray(fracs), unstable=True, interpret=True,
        **kw)
    tdata, tcounts = tp.partition_pass_fused(
        [_i32(p) for p in planes], [_i32(v) for v in values],
        None if cin is None else torch.from_numpy(cin),
        splitters=[_i32(w) for w in words], splitter_fracs=_i32(fracs),
        unstable=True, **kw)
    jcounts = np.asarray(jcounts)
    np.testing.assert_array_equal(tcounts.numpy(), jcounts)
    m = _valid_slots(jcounts, t_seg)
    for t_, j_ in zip(tdata, jdata):
        np.testing.assert_array_equal(t_.numpy().view(np.uint32)[m],
                                      np.asarray(j_)[m])
    return jcounts


def _strided_counts(rng, n_total):
    """Pass 0's (T, K // 128) counts table as the equi-depth feed makes
    it: tile t holds a valid prefix of ceil((n - t) / T) slots."""
    thr = (n_total - np.arange(T) + T - 1) // T
    return np.clip(thr[:, None] - np.arange(K // 128)[None, :] * 128,
                   0, 128).astype(np.int32)


def test_pass0_keys_q128():
    """One plane, keys only, pass 0 with a q = 128 counts table (ragged
    tile ends), uniform keys."""
    rng = np.random.default_rng(1)
    x = random_keys(rng, T * K).reshape(T, K)
    words, fracs = _quantile_splitters([x], rng)
    counts = _compare([x], [], words, fracs,
                      cin=_strided_counts(rng, T * K - 1500), q_in=128,
                      t_seg=2)
    assert counts[:, 0].max() <= K


def test_pass1_keys_sorted_run():
    """One plane, keys only, a later pass: sorted 256-slot subruns with
    random valid prefixes, merged from sorted_run."""
    rng = np.random.default_rng(2)
    x = random_keys(rng, T * K).reshape(T, K)
    cin = rng.integers(64, 257, (T, K // 256)).astype(np.int32)
    for t in range(T):
        for i in range(K // 256):
            sl = slice(i * 256, i * 256 + cin[t, i])
            x[t, sl] = np.sort(x[t, sl])
    words, fracs = _quantile_splitters([x], rng)
    _compare([x], [], words, fracs, cin=cin, q_in=256, sorted_run=256)


def test_two_planes_u64_skewed_hi():
    """Two planes (u64): four hi words, so every boundary ties on plane 0
    and the lexicographic count decides on plane 1."""
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 4, (T, K)).astype(np.uint32)
    lo = random_keys(rng, T * K).reshape(T, K)
    words, fracs = _quantile_splitters([hi, lo], rng)
    _compare([hi, lo], [], words, fracs, n=T * K - 777)


def test_composite_planes_with_value():
    """The stable-pairs composite: (Zipf key, unique position) planes plus
    a value word, as the equi-depth engine feeds them."""
    rng = np.random.default_rng(4)
    key = zipf_keys(rng, T * K, alpha=1.2, dtype=np.uint32).reshape(T, K)
    pos = rng.permutation(T * K).astype(np.uint32).reshape(T, K)
    val = random_keys(rng, T * K).reshape(T, K)
    words, fracs = _quantile_splitters([key, pos], rng)
    _compare([key, pos], [val], words, fracs,
             cin=_strided_counts(rng, T * K - 300), q_in=128)


def test_key_with_value_unique():
    rng = np.random.default_rng(5)
    key = _unique(rng, (T, K))
    val = random_keys(rng, T * K).reshape(T, K)
    words, fracs = _quantile_splitters([key], rng)
    _compare([key], [val], words, fracs, n=T * K)


@pytest.mark.parametrize("kind", ["entropy3", "zipf"])
def test_heavy_ties_across_boundaries(kind):
    """Heavy duplicates: one value spans several quantile boundaries, so
    equal splitters repeat and the tie fractions and the dither decide."""
    rng = np.random.default_rng(6)
    if kind == "entropy3":
        x = entropy_keys(rng, T * K, 3) & np.uint32(0xF000000F)
    else:
        x = zipf_keys(rng, T * K, alpha=1.5, universe=64, dtype=np.uint32)
    x = x.reshape(T, K)
    words, fracs = _quantile_splitters([x], rng)
    assert (np.diff(words[0][0].astype(np.int64)) == 0).any()
    _compare([x], [], words, fracs, n=T * K - 100, t_seg=2)


def test_all_ones_splitter_and_poisoned_tile():
    """A splitter equal to all-ones counts the invalid slots' sentinels
    (then cut off at n_valid), and splitters that leave a tile no legal
    cut poison its count 0 to K + 1."""
    rng = np.random.default_rng(7)
    x = random_keys(rng, T * K).reshape(T, K)
    x[0, :200] = 0xFFFFFFFF                      # valid keys on the sentinel
    words, fracs = _quantile_splitters([x], rng)
    words[0][:, -1] = 0xFFFFFFFF
    # tile 1 (all valid): every key lies below the first splitter, far
    # over S
    words[0][1] = 0xFFFFFFF0
    counts = _compare([x], [], words, fracs, n=T * K - 900)
    assert counts[1, 0] == K + 1
    assert (np.delete(counts[:, 0], 1) <= K).all()
