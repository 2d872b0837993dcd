"""The per-phase MSD engine and its profiler against ``tpusort``: K8's
plain version against the Pallas ``partition_tiles`` in interpret mode,
``_partition_pass`` pass by pass against JAX's (its XLA path and K8 in
interpret mode), the leaf with the ``key_from_sortkey`` rebuild and the
wide leaf, and the collapse, against JAX's ``_leaf_sort`` and
``_compact_xla``; the profile tables, ``profile_msd_phases`` on the CPU,
and the timing and log utilities.  Inputs are numpy arrays from a seed;
counts and overflow compare exactly, and the slots the counts mark valid
bit for bit.
"""

import dataclasses
import io
import logging
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusort import dtypes as jd
from tpusort.kernels.partition import partition_tiles as j_partition_tiles
from tpusort.ops import msd as jm
from tpusort_torch import dtypes as td
from tpusort_torch.kernels import partition as tp
from tpusort_torch.kernels.collapse import collapse_segments
from tpusort_torch.ops import msd as tm
from tpusort_torch.utils import log as tlog
from tpusort_torch.utils import profile_calls as tpc
from tpusort_torch.utils import timing as ttiming
from tpusort_torch.utils.datagen import random_keys
from tpusort_torch.utils.profiling import (
    Profile, msd_phase_inputs, profile_msd_phases, run_msd_phases)

# the JAX package's CPU test geometry (tests/test_msd.py)
SMALL = dict(k=2048, r=8, s1=384, s=256, leaf_max=2048)
# two passes of 5 bits leave 22 bits and 384-slot segments: the packed
# word fits (22 + 9 + 1 = 32 bits) and the key plane is rebuilt from it
PACKED = dict(k=4096, r=32, s1=384, s=128, leaf_max=512)


def _t(a) -> torch.Tensor:
    """A JAX or numpy uint32 array as an int32 torch tensor (same bits)."""
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


def _np(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def _run_valid(counts: np.ndarray, s: int) -> np.ndarray:
    """(runs * S,) bool: slot j of run i is valid iff j < counts[i]."""
    return (np.arange(s)[None, :] < np.asarray(counts).reshape(-1, 1)) \
        .reshape(-1)


# ---------------------------------------------------------------------------
# Profile and Run (tests/test_profiling.py's cases on the port)
# ---------------------------------------------------------------------------


def test_profile_table_and_csv():
    p = Profile("demo")
    for i in range(3):
        with p.run(num_keys=1000 * (i + 1), entropy=i) as r:
            r.set_metric("sort_ms", 1.5 * (i + 1))
            r.push("partition_ms", 0.5 * (i + 1))
            r.push("partition_ms", 0.25 * (i + 1))
    t = p.table()
    assert "demo" in t and "sort_ms" in t and "partition_ms[1]" in t
    assert "(min)" in t and "(avg)" in t
    c = p.csv().splitlines()
    assert c[0].startswith("num_keys,entropy,sort_ms")
    assert len(c) == 4
    j = p.json_lines().splitlines()
    assert len(j) == 3


def test_profile_empty():
    p = Profile("empty")
    assert "empty" in p.table()
    assert p.csv().strip() == ""


@pytest.mark.parametrize("pairs", [False, True])
def test_profile_msd_phases_cpu(pairs):
    """The profiler drives the real engine helpers, one partition time a
    pass, on the CPU only when asked for."""
    p = profile_msd_phases(1 << 14, pairs=pairs, fused_total=False,
                           device="cpu")
    assert len(p.runs) == 1
    m = p.runs[0]
    assert m.metrics["leaf_ms"] > 0 and m.metrics["collapse_ms"] > 0
    assert len(m.arrays["partition_ms"]) == m.metrics["passes"] >= 1
    assert m.metrics["device"] == "cpu" and m.metrics["overflow"] is False
    assert "fused_total_ms" not in m.metrics


def test_profile_msd_phases_fused_total_cpu():
    m = profile_msd_phases(1 << 14, device="cpu").runs[0]
    assert m.metrics["fused_total_ms"] > 0
    assert m.metrics["keys_per_s"] == pytest.approx(
        (1 << 14) / (m.metrics["fused_total_ms"] / 1e3))


# ---------------------------------------------------------------------------
# K8: partition_tiles
# ---------------------------------------------------------------------------


def _k8_inputs(rng, T, K, r, n_data):
    """Tiles as the engine builds them: digits below r, about a tenth of
    the slots invalid (digit r), sortkey (digit or r) << log2(K) | slot;
    the counts of each digit and their exclusive cumsum (the starts)."""
    digit = rng.integers(0, r, (T, K)).astype(np.uint32)
    digit[rng.random((T, K)) < 0.1] = r
    sortkey = (digit << np.uint32(K.bit_length() - 1)) \
        | np.arange(K, dtype=np.uint32)
    counts = np.stack([np.bincount(row, minlength=r + 1)[:r]
                       for row in digit]).astype(np.int32)
    starts = (np.cumsum(counts, axis=1) - counts).astype(np.int32)
    data = [rng.integers(0, 1 << 32, (T, K), dtype=np.uint32)
            for _ in range(n_data)]
    return sortkey, data, counts, starts


# each interpret-mode call traces the kernel anew (about 5 s), so the two
# run capacities and the two operand counts share two cases
@pytest.mark.parametrize("s,n_data", [(256, 1), (384, 2)])
def test_partition_tiles_plain_matches_pallas(s, n_data):
    T, K, r = 2, 2048, 8
    sortkey, data, counts, starts = _k8_inputs(
        np.random.default_rng(10 * s + n_data), T, K, r, n_data)
    want = j_partition_tiles([jnp.asarray(a) for a in (sortkey, *data)],
                             jnp.asarray(starts), r=r, s=s, interpret=True)
    got = tp.partition_tiles([_t(a) for a in (sortkey, *data)],
                             _t(starts), r=r, s=s)
    assert len(got) == n_data
    valid = _run_valid(np.minimum(counts, s), s).reshape(T, r * s)
    for g, w in zip(got, want):
        assert g.shape == (T, r * s) and g.dtype == torch.int32
        np.testing.assert_array_equal(_np(g)[valid], np.asarray(w)[valid])
    # every emitted slot is a word of its own tile, whatever the count
    for g, d in zip(got, data):
        for t in range(T):
            assert np.isin(_np(g)[t], d[t]).all()


def test_partition_tiles_plain_clamps_inside_the_tile():
    """Runs that start near the tile's end repeat its last sorted slot:
    no word past the tile is read."""
    K, r, s = 128, 2, 128
    sortkey = _t(np.arange(K, dtype=np.uint32)[::-1].copy()[None, :])
    data = torch.arange(K, dtype=torch.int32)[None, :]
    starts = torch.tensor([[0, K - 5]], dtype=torch.int32)
    (out,) = tp.partition_tiles([sortkey, data], starts, r=r, s=s)
    np.testing.assert_array_equal(out[0, :s].numpy(), np.arange(K)[::-1])
    np.testing.assert_array_equal(out[0, s:s + 5].numpy(), [4, 3, 2, 1, 0])
    assert (out[0, s + 5:] == 0).all()


@pytest.mark.parametrize("bad", ["no_data", "k_pow2", "s_mult", "r_big",
                                 "starts_shape", "starts_dtype", "dtype"])
def test_partition_tiles_rejects_bad_geometry(bad):
    T, K, r, s = 2, 256, 4, 128
    ops = [torch.zeros(T, K, dtype=torch.int32) for _ in range(2)]
    starts = torch.zeros(T, r, dtype=torch.int32)
    if bad == "no_data":
        ops = ops[:1]
    elif bad == "k_pow2":
        ops = [torch.zeros(T, 384, dtype=torch.int32) for _ in range(2)]
    elif bad == "s_mult":
        s = 100
    elif bad == "r_big":
        r = 129
        starts = torch.zeros(T, r, dtype=torch.int32)
    elif bad == "starts_shape":
        starts = torch.zeros(T, r + 1, dtype=torch.int32)
    elif bad == "starts_dtype":
        starts = starts.long()
    else:
        ops[1] = ops[1].long()
    with pytest.raises(ValueError):
        tp.partition_tiles(ops, starts, r=r, s=s)


# ---------------------------------------------------------------------------
# _partition_pass, pass by pass
# ---------------------------------------------------------------------------


def _chain_start(n, plan):
    """Pass 0's run counts (numpy) and run size: as JAX's profiler makes
    them (``tpusort/utils/profiling.py:183-185``)."""
    k0 = plan.passes[0].k
    rc = np.clip(n - np.arange(plan.m1 // k0) * k0, 0, k0).astype(np.int32)
    np.testing.assert_array_equal(tm.initial_run_counts(n, plan).numpy(), rc)
    return rc, k0


@pytest.mark.parametrize("dtype,pairs,use_pallas", [
    (np.uint32, False, True), (np.uint32, True, False),
    (np.uint64, False, False)])
def test_partition_pass_matches_jax(dtype, pairs, use_pallas):
    n = 20_000
    keys = random_keys(np.random.default_rng(3), n, dtype)
    nplanes = np.dtype(dtype).itemsize // 4
    plan = jm.plan_msd(n, 0, 32 * nplanes, **SMALL)
    assert dataclasses.asdict(plan) == dataclasses.asdict(
        tm.plan_msd(n, 0, 32 * nplanes, **SMALL))
    j_planes, _ = jd.twiddle_in(jnp.asarray(keys))
    t_planes, _ = td.twiddle_in(torch.from_numpy(keys))
    j_ops = [jnp.pad(p, (0, plan.m1 - n)) for p in j_planes]
    t_ops = [torch.nn.functional.pad(p, (0, plan.m1 - n)) for p in t_planes]
    if pairs:
        j_ops.append(jnp.pad(jnp.arange(n, dtype=jnp.uint32),
                             (0, plan.m1 - n)))
        t_ops.append(torch.nn.functional.pad(
            torch.arange(n, dtype=torch.int32), (0, plan.m1 - n)))
    rc, s_prev = _chain_start(n, plan)
    j_rc, t_rc = jnp.asarray(rc), torch.from_numpy(rc)
    planes = slice(0, nplanes)
    for spec in plan.passes:
        j_ops, j_rc, j_ovf = jm._partition_pass(j_ops, planes, j_rc, s_prev,
                                                spec, use_pallas)
        t_ops, t_rc, t_ovf = tm._partition_pass(t_ops, planes, t_rc, s_prev,
                                                spec)
        np.testing.assert_array_equal(t_rc.numpy(), np.asarray(j_rc))
        assert bool(t_ovf) == bool(j_ovf) is False
        assert t_ovf.dim() == 0 and t_rc.dtype == torch.int32
        valid = _run_valid(np.asarray(j_rc), spec.s)
        assert int(valid.sum()) == n
        for t_o, j_o in zip(t_ops, j_ops):
            np.testing.assert_array_equal(_np(t_o)[valid],
                                          np.asarray(j_o)[valid])
        s_prev = spec.s


def test_partition_pass_flags_overflow():
    """Constant keys fill one digit: the pass reports the overflow and
    clips the counts to S, as JAX's does."""
    n = 20_000
    plan = tm.plan_msd(n, 0, 32, **SMALL)
    spec = plan.passes[0]
    keys = np.full(n, 0x12345678, dtype=np.uint32)
    rc, s_prev = _chain_start(n, plan)
    t_ops = [torch.nn.functional.pad(_t(keys), (0, plan.m1 - n))]
    j_ops = [jnp.pad(jnp.asarray(keys), (0, plan.m1 - n))]
    _, t_rc, t_ovf = tm._partition_pass(t_ops, slice(0, 1),
                                        torch.from_numpy(rc), s_prev, spec)
    _, j_rc, j_ovf = jm._partition_pass(j_ops, slice(0, 1), jnp.asarray(rc),
                                        s_prev, spec, False)
    assert bool(t_ovf) and bool(j_ovf)
    np.testing.assert_array_equal(t_rc.numpy(), np.asarray(j_rc))
    assert int(t_rc.max()) == spec.s


# ---------------------------------------------------------------------------
# The leaf and the collapse, and the chain as a whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["packed_keys", "packed_pairs",
                                  "wide_u32_keys", "wide_u64_keys",
                                  "wide_u64_pairs"])
def test_leaf_and_collapse_match_jax(case):
    dtype = np.uint64 if "u64" in case else np.uint32
    geometry = PACKED if case.startswith("packed") else SMALL
    pairs = case.endswith("pairs")
    n = 50_000 if case.startswith("packed") else 20_000
    keys = random_keys(np.random.default_rng(len(case)), n, dtype)
    nplanes = np.dtype(dtype).itemsize // 4
    plan = tm.plan_msd(n, 0, 32 * nplanes, **geometry)
    assert dataclasses.asdict(plan) == dataclasses.asdict(
        jm.plan_msd(n, 0, 32 * nplanes, **geometry))
    assert tm.leaf_is_wide(plan) == case.startswith("wide")
    assert tm.key_from_sortkey(plan, nplanes) == (nplanes == 1)
    j_planes, _ = jd.twiddle_in(jnp.asarray(keys))
    ops = [jnp.pad(p, (0, plan.m1 - n)) for p in j_planes]
    if pairs:
        ops.append(jnp.pad(jnp.arange(n, dtype=jnp.uint32),
                           (0, plan.m1 - n)))
    rc, s_prev = _chain_start(n, plan)
    rc = jnp.asarray(rc)
    for spec in plan.passes:
        ops, rc, ovf = jm._partition_pass(ops, slice(0, nplanes), rc,
                                          s_prev, spec, False)
        assert not bool(ovf)
        s_prev = spec.s
    # both leaves read the same runs
    nseg, seg = plan.n_segments, plan.seg
    valid = jm._valid_mask(rc, s_prev, nseg, seg)
    np.testing.assert_array_equal(
        tm._valid_mask(_t(rc), s_prev, nseg, seg).numpy(), np.asarray(valid))
    j_sorted, j_counts = jm._leaf_sort(ops, slice(0, nplanes), valid, plan,
                                       False)
    ctable, q = tm.counts_table(_t(rc), s_prev)
    t_sorted, t_counts = tm.sort_segments([_t(o) for o in ops], nplanes,
                                          ctable, q, plan)
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    head = np.arange(seg)[None, :] < np.asarray(j_counts)[:, None]
    assert len(t_sorted) == len(j_sorted) == len(ops)
    for t_o, j_o in zip(t_sorted, j_sorted):
        assert t_o.shape == (nseg, seg)
        np.testing.assert_array_equal(
            _np(t_o)[head], np.asarray(j_o).reshape(nseg, seg)[head])
    t_dense = collapse_segments(t_sorted, t_counts, n)
    j_dense = jm._compact_xla(j_sorted, j_counts, seg, n)
    for t_o, j_o in zip(t_dense, j_dense):
        np.testing.assert_array_equal(_np(t_o), np.asarray(j_o))
    # the chain run by the port alone gives the same dense result, the
    # stable sort of the input
    t_ops, t_np, t_plan = msd_phase_inputs(torch.from_numpy(keys), pairs)
    if geometry is PACKED:
        t_plan = plan
        t_ops = [torch.nn.functional.pad(o[:n], (0, plan.m1 - n))
                 for o in t_ops]
    outs, overflow = run_msd_phases(t_ops, t_np, n, t_plan)
    assert not bool(overflow)
    for t_o, j_o in zip(outs, j_dense):
        np.testing.assert_array_equal(_np(t_o), np.asarray(j_o))
    planes_out = td.twiddle_out(tuple(outs[:nplanes]),
                                td.traits_for(torch.from_numpy(keys).dtype))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(planes_out.numpy(), keys[order])
    if pairs:
        np.testing.assert_array_equal(outs[-1].numpy(), order)


def test_sort_segments_empties_its_operand_list():
    n = 20_000
    keys = random_keys(np.random.default_rng(9), n)
    ops, nplanes, _ = msd_phase_inputs(torch.from_numpy(keys))
    plan = tm.plan_msd(n, 0, 32, **SMALL)
    rc, s_prev = _chain_start(n, plan)
    rc = torch.from_numpy(rc)
    ops = [torch.nn.functional.pad(o[:n], (0, plan.m1 - n)) for o in ops]
    for spec in plan.passes:
        ops, rc, _ = tm._partition_pass(ops, slice(0, 1), rc, s_prev, spec)
        s_prev = spec.s
    ctable, q = tm.counts_table(rc, s_prev)
    segs, counts = tm.sort_segments(ops, nplanes, ctable, q, plan)
    assert ops == [] and int(counts.sum()) == n


# ---------------------------------------------------------------------------
# timing and log
# ---------------------------------------------------------------------------


def test_timing_on_the_cpu():
    calls = []

    def work(x):
        calls.append(1)
        time.sleep(0.01)
        return x + 1

    x = torch.zeros(4)
    dt = ttiming.measure(work, x, iters=2, warmup=1)
    assert len(calls) == 3 and 0.009 < dt < 1.0
    assert ttiming.measure_eager(work, x, iters=1, warmup=0,
                                 subtract_overhead=False) >= 0.01
    assert len(calls) == 4
    assert 0 <= ttiming.measure_overhead() < 0.01
    assert ttiming.measure_overhead("cpu") < 0.01
    ttiming.sync([x, (x,)])                      # nothing to wait for
    assert ttiming._device_of([1, (x,)]) == torch.device("cpu")


def test_log_levels_and_timed():
    """``span`` logs its block's host ms at TRACE and nothing above it."""
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    old = tlog.logger.level
    tlog.logger.addHandler(handler)
    try:
        assert tlog.logger.name == "tpusort_torch"
        tlog.set_level("TRACE")
        assert tlog.logger.level == tlog.TRACE == 5
        with tlog.span("tpusort.phase"):
            pass
        assert "tpusort.phase: " in buf.getvalue() and " ms" in buf.getvalue()
        tlog.set_level("warning")
        with tlog.span("tpusort.hidden"):
            pass
        assert "hidden" not in buf.getvalue()
        tlog.set_level(logging.INFO)
        assert tlog.logger.level == logging.INFO
    finally:
        tlog.logger.removeHandler(handler)
        tlog.logger.setLevel(old)


def _event(name, a, b, device=False, annotation=False):
    """A profiler event of ``name`` from ``a`` to ``b`` microseconds."""
    dt = torch.autograd.DeviceType
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type=dt.CUDA if device else dt.CPU,
        is_user_annotation=annotation)


def test_profile_calls_reads_one_traced_call():
    """``profile_calls``' window, busy time and idle gaps of the one traced
    call: device work clipped to the call's span and merged where it
    overlaps, each gap charged to the innermost host span running as it
    began, user annotations left out."""
    ev = [_event("profile_calls.call", 1000, 11000),
          _event("tpusort.api.sort", 1000, 9000),
          _event("tpusort.plan", 1000, 3000),
          _event("tpusort.read.tier_flag", 8000, 8500),
          _event("annotated", 1000, 11000, annotation=True),
          _event("k1", 0, 2000, device=True),          # cut at the span
          _event("k1", 4000, 6000, device=True),
          _event("k2", 5000, 8200, device=True),       # overlaps k1
          _event("k2", 9500, 10500, device=True),
          _event("gpu ann", 6000, 10000, device=True, annotation=True)]
    window, busy, idle = tpc._window_busy_idle(ev, "profile_calls.call")
    assert window == 10.0
    assert busy == pytest.approx(1.0 + 4.2 + 1.0)
    assert dict(idle) == pytest.approx(
        {"tpusort.plan": 2.0, "tpusort.read.tier_flag": 1.3, "caller": 0.5})
    assert [k for k, _ in idle][0] == "tpusort.plan"
    with pytest.raises(RuntimeError):
        tpc._window_busy_idle(ev[1:], "profile_calls.call")
