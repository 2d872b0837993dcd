"""``sort`` of 64-bit keys alone on CPU tensors, through the public call:
the split into two int32 planes, the raw route's K1 passes and K2 leaf on
two key planes with no payload (their plain versions here), and the join,
held bit for bit against the benchmark's plain reference
(``portbench/reference.py``, a stable ``torch.sort`` of the keys' order).

The CPU row plans one pass at this size; a smaller row (tiles of 2,048,
8 runs) plans two, so the second pass takes its tiles as the sorted runs
of the first, as passes 1 and 2 of the card's 2^27 plan do.  The same
twiddled two-plane keys also go through the JAX package's engine
(``tpusort.ops.msd.sort_twiddled_msd``, Pallas in interpret mode) at that
plan, and its planes are held against the port's output.  Last, the
``merge_bytes`` count of the merge-body launches, which only a card
makes, through the launch wrappers with a stand-in library.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusort_torch
from portbench import reference
from tpusort.ops import msd as jm
from tpusort_torch import api as tapi
from tpusort_torch import dtypes as tdt
from tpusort_torch.configs import SortConfig, get_config, register_config
from tpusort_torch.kernels import _build
from tpusort_torch.kernels import bitonic as tb
from tpusort_torch.kernels import partition as tp
from tpusort_torch.ops import msd as tm

N = 12345
TWO_PASSES = SortConfig(tile_elems=2048, radix=8, s1=384, leaf_max=2048,
                        min_n=4096)
DTYPES = {"uint64": torch.uint64, "int64": torch.int64,
          "float64": torch.float64}


def _uniform(rng, n=N):
    return rng.integers(0, 2**64, n, dtype=np.uint64, endpoint=False)


def _ties(rng):
    """3,000 distinct bit patterns drawn again and again (about four of
    each), and 20 runs of 16 equal keys planted at random places."""
    keys = _uniform(rng, 3000)[rng.integers(0, 3000, N)]
    for start in rng.choice(N - 16, 20, replace=False):
        keys[start:start + 16] = keys[start]
    return keys


# float64 bit patterns the order has to place: NaNs of both signs with
# several payloads (quiet and signalling), the infinities, +0 and -0, the
# smallest subnormals and the largest finite values
SPECIALS = np.array([
    0x7FF8000000000000, 0x7FF0000000000001, 0x7FFFFFFFFFFFFFFF,
    0x7FF4000000000123, 0xFFF8000000000000, 0xFFF0000000000001,
    0xFFFFFFFFFFFFFFFF, 0x7FF0000000000000, 0xFFF0000000000000,
    0x0000000000000000, 0x8000000000000000, 0x0000000000000001,
    0x8000000000000001, 0x7FEFFFFFFFFFFFFF, 0xFFEFFFFFFFFFFFFF,
], dtype=np.uint64)


def _with_specials(rng):
    """Uniform bit patterns with each special planted 3 times (the six
    largest share their top six bits once twiddled, a digit of both
    passes: 8 copies each overflow a run of 256 here, and the exact
    fallback would sort them)."""
    keys = _uniform(rng)
    at = rng.choice(N, 3 * len(SPECIALS), replace=False)
    keys[at] = np.repeat(SPECIALS, 3)
    return keys


KINDS = {"uniform": _uniform, "ties": _ties, "specials": _with_specials}


@pytest.fixture
def two_passes(monkeypatch):
    """The 64-bit keys-only CPU row set to :data:`TWO_PASSES`, an empty
    tier cache and zeroed counters; yields the calls of K1 (the raw
    branch) as (key planes, payload words, sorted run, general) and of
    the raw leaf."""
    saved = get_config(64, False, "cpu")
    register_config(64, False, "cpu", TWO_PASSES)
    seen = {"k1": [], "leaf": 0}
    k1, leaf = tm.partition_pass_fused, tm.raw_leaf

    def k1_spy(planes, values, *args, **kwargs):
        seen["k1"].append((len(planes), len(values), kwargs["sorted_run"],
                           kwargs["general"]))
        return k1(planes, values, *args, **kwargs)

    def leaf_spy(*args, **kwargs):
        seen["leaf"] += 1
        return leaf(*args, **kwargs)

    monkeypatch.setattr(tm, "partition_pass_fused", k1_spy)
    monkeypatch.setattr(tm, "raw_leaf", leaf_spy)
    tapi._TIER_CACHE.clear()
    tm.reset_counters()
    yield seen
    register_config(64, False, "cpu", saved)
    tapi._TIER_CACHE.clear()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sort_of_64_bit_keys_matches_the_reference(two_passes, dtype, kind):
    bits = KINDS[kind](np.random.default_rng(64 + len(kind)))
    keys = torch.from_numpy(bits.view(np.int64)).view(DTYPES[dtype])
    got = tpusort_torch.sort(keys)
    want = reference.stable_sort(keys)
    assert got.dtype == keys.dtype and got.shape == keys.shape
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    c = tm.counters()
    assert (c["radix_tiers"], c["overflow_fallbacks"], c["reference_routes"],
            c["equidepth_runs"]) == (1, 0, 0, 0), c
    assert c["split_join_bytes"] == 32 * N
    # two raw passes on the two planes, the second on the first's runs of
    # 128 (384's largest power-of-two part), then the raw leaf
    assert two_passes["k1"] == [(2, 0, None, False), (2, 0, 128, False)]
    assert two_passes["leaf"] == 1


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sort_of_64_bit_keys_matches_the_jax_engine(two_passes, kind):
    """The twiddled (hi, lo) planes of the keys through the JAX package's
    MSD engine at the :data:`TWO_PASSES` plan: no overflow, and its sorted
    planes, twiddled back, are the port's output bit for bit."""
    bits = KINDS[kind](np.random.default_rng(64 + len(kind)))
    keys = torch.from_numpy(bits.view(np.int64)).view(torch.float64)
    planes, traits = tdt.twiddle_in(keys)
    jplanes, _, jovf = jm.sort_twiddled_msd(
        tuple(jnp.asarray(p.numpy().view(np.uint32)) for p in planes), (),
        begin_bit=0, end_bit=64, total_bits=64, use_pallas=True,
        plan_kwargs=TWO_PASSES.plan_kwargs(), on_overflow="flag",
        skew_tier=False)
    assert not bool(jovf)
    want = tdt.twiddle_out(tuple(
        torch.from_numpy(np.array(p).view(np.int32)) for p in jplanes),
        traits)
    got = tpusort_torch.sort(keys)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert two_passes["k1"] == [(2, 0, None, False), (2, 0, 128, False)]


# K1 and K2 launches on (2, 2048) tiles holding 3,000 valid keys: on the
# merge body where the tiles arrive as sorted runs of 128 with a counts
# table, on K1's runs body where no sorted run arrives (one or two
# planes), else on the network; as (wrapper, key planes, payload words,
# keyword arguments, the mode's tag, merge bytes counted)
T, K, Q, NV = 2, 2048, 128, 3000
LAUNCHES = {
    "k1_merge": ("k1", 2, 0, dict(sorted_run=128), "merge", 8 * NV * 2),
    "k1_network": ("k1", 3, 0, dict(counts_in=None, sorted_run=None), None,
                   0),
    "k1_runs": ("k1", 2, 0, dict(counts_in=None, sorted_run=None), "runs",
                0),
    "k1b_runs": ("k1b", 2, 1, dict(sorted_run=None), "runs", 0),
    "k1_emit_only": ("k1", 2, 0, dict(sorted_run=K), "emit-only", 0),
    "k1_merge_no_n": ("k1", 2, 0, dict(sorted_run=128, n=None), "merge", 0),
    "k1b_merge": ("k1b", 2, 1, dict(sorted_run=128), "merge", 8 * NV * 3),
    "k2_merge": ("k2", 2, 0, dict(sorted_run=128), "merge", 8 * NV * 2),
    "k2_network": ("k2", 3, 4, dict(sorted_run=0), None, 0),
}


@pytest.mark.parametrize("case", sorted(LAUNCHES))
def test_merge_bytes_are_counted_at_the_launch(monkeypatch, case):
    """A merge-body launch of K1, K1b or K2 adds 8 B for each of its valid
    keys and each operand word to ``merge_bytes``, counted by the wrapper
    from its arguments; a network, runs or emit-only launch adds
    nothing, nor does a K1 launch whose caller names no valid count.  The
    kernels are stood in for by a library that launches nothing."""
    which, nk, nv, kw, tag, want = LAUNCHES[case]
    stub = SimpleNamespace(**{f: lambda *a: 0 for f in (
        "tpusort_partition_raw", "tpusort_partition_splitter",
        "tpusort_leaf_collapse")})
    monkeypatch.setattr(_build, "library", lambda: stub)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    ops = [torch.zeros(T, K, dtype=torch.int32) for _ in range(nk + nv)]
    counts = torch.full((T, K // Q), NV // (T * K // Q), dtype=torch.int32)
    tm.reset_counters()
    if which == "k2":
        tb._sort_tiles_counts_collapsed_cuda(ops, counts, Q, NV,
                                             num_keys=nk, **kw)
    else:
        args = dict(counts_in=counts, q_in=Q, n=NV, r=8, s=512, t_seg=1)
        args.update(kw)
        cin = args.pop("counts_in")
        if which == "k1":
            tp._partition_pass_cuda(ops[:nk], ops[nk:], cin, lo_bit=61,
                                    width=3, **args)
        else:
            spl = [torch.zeros(T, 7, dtype=torch.int32) for _ in range(nk)]
            tp._partition_pass_splitter_cuda(
                ops[:nk], ops[nk:], cin, splitters=spl,
                splitter_fracs=torch.zeros(T, 7, dtype=torch.int32), **args)
    assert tm.counters()["merge_bytes"] == want
    (mode,) = tm.mode_counters()
    assert mode == ("K" + which[1:], nk, nv, *((tag,) if tag else ()))
    tm.reset_counters()
    assert tm.counters()["merge_bytes"] == 0
