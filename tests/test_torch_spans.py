"""The port's host spans and host-read count (``tpusort_torch/utils/log.py``).

Under ``torch.profiler`` a public call's spans nest as entry > tier > pass
and leaf, each place where the host waits for a device value is a
``tpusort.read.<site>`` span counted in ``host_reads``, and no span is a
user annotation (the benchmark's trace drops those).  Without a profiler
a call gives the same outputs and counts.  The tiered flow runs with a CPU
config that turns the equi-depth tier on and a lowered
``planner.PLANNER_MIN_N``, so that these sizes take it; 2^18 keys with a
sample of 2^18 make the equi-depth tier sort its sample on the radix
engine and read that sort's flag, as the 2^28 calls on a card do.  A
64-bit key or value adds a ``tpusort.planes.split`` and a
``tpusort.planes.join`` span; a 32-bit call has neither.
"""

import importlib
import logging

import numpy as np
import pytest
import torch

import tpusort_torch
from tpusort_torch import api as tapi
from tpusort_torch import dtypes as tdt
from tpusort_torch import planner as tpl
from tpusort_torch.configs import SortConfig, get_config, register_config
from tpusort_torch.ops import msd as tm
from tpusort_torch.ops import segmented as tseg
from tpusort_torch.ops import tiers as ttiers
from tpusort_torch.parallel import InProcessComm, make_global_sort
from tpusort_torch.utils import log as tlog

tgs = importlib.import_module("tpusort_torch.parallel.global_sort")

N = 1 << 18
SKEW = SortConfig(tile_elems=2048, radix=16, s1=256, min_n=4096,
                  skew_tier=True, skew_sample_log2=18)
API = "tpusort.api."


def _keys(kind: str, n: int = N) -> torch.Tensor:
    rng = np.random.default_rng(17)
    draws = 3 if kind == "equidepth" else 1
    x = rng.integers(0, 2**32, n, dtype=np.uint64)
    for _ in range(draws - 1):
        x &= rng.integers(0, 2**32, n, dtype=np.uint64)
    return torch.from_numpy(x.astype(np.uint32))


CALLS = {
    "sort": lambda k: tpusort_torch.sort(k),
    "sort_pairs": lambda k: tpusort_torch.sort_pairs(
        k, torch.arange(k.shape[0], dtype=torch.int32)),
    "argsort": lambda k: tpusort_torch.argsort(k),
}
# the entry span of each call: sort_pairs is sort with values
ENTRY = {"sort": "sort", "sort_pairs": "sort", "argsort": "argsort"}
CASES = [("sort", "radix"), ("sort_pairs", "radix"), ("argsort", "radix"),
         ("sort", "equidepth"), ("sort_pairs", "equidepth")]
IDS = [f"{c}-{t}" for c, t in CASES]
# (span, its nearest tpusort.* ancestor), "api" for the entry's span
TREES = {
    "radix": {("api", None), ("tier.radix", "api"), ("pass", "tier.radix"),
              ("leaf", "tier.radix"), ("plan", "api"),
              ("read.sample", "plan"), ("read.tier_flag", "api")},
    "equidepth": {("api", None), ("tier.equidepth", "api"),
                  ("equidepth.sample", "tier.equidepth"),
                  ("pass", "equidepth.sample"), ("leaf", "equidepth.sample"),
                  ("read.sample_flag", "equidepth.sample"),
                  ("feed", "tier.equidepth"), ("pass", "tier.equidepth"),
                  ("equidepth.splitters", "pass"),
                  ("leaf", "tier.equidepth"), ("plan", "api"),
                  ("read.sample", "plan"), ("read.tier_flag", "api")},
}
READS = {"radix": 2, "equidepth": 3}


@pytest.fixture
def tiered(monkeypatch):
    """``SKEW`` on the port's CPU rows, the planner from 1024 keys, an
    empty tier cache and zeroed counters."""
    saved = {(b, v): get_config(b, v, "cpu") for b in (32, 64)
             for v in (False, True)}
    for b, v in saved:
        register_config(b, v, "cpu", SKEW)
    monkeypatch.setattr(tpl, "PLANNER_MIN_N", 1 << 10)
    tapi._TIER_CACHE.clear()
    tm.reset_counters()
    yield
    for (b, v), cfg in saved.items():
        register_config(b, v, "cpu", cfg)
    tapi._TIER_CACHE.clear()


def _profiled(fn):
    """(fn's output, the profile's events, the counters' deltas)."""
    before = tm.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        out = fn()
    after = tm.counters()
    return out, list(prof.events()), {k: after[k] - before[k] for k in after}


def _ours(events):
    return [e for e in events if e.name.startswith("tpusort.")]


def _short(name: str, entry: str) -> str:
    name = name[len("tpusort."):]
    return "api" if name == "api." + entry else name


def _ancestor(e, prefix: str = "tpusort."):
    """The nearest ancestor of ``e`` whose name starts with ``prefix``."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith(prefix):
        p = p.cpu_parent
    return p


def _in_entry(e) -> bool:
    return _ancestor(e, API) is not None


def _tree(events, entry: str):
    """{(span, nearest tpusort.* ancestor)} of the profile's spans, an
    entry inside the outer entry (``argsort`` calls ``sort_planes``) left
    out and its children hung on the outer one."""
    out = set()
    for e in _ours(events):
        if e.name.startswith(API) and _in_entry(e):
            continue
        p = _ancestor(e)
        if p is not None and p.name.startswith(API):
            p = _ancestor(p, API) or p
        out.add((_short(e.name, entry),
                 None if p is None else _short(p.name, entry)))
    return out


def _warm_call(call: str, tier: str):
    keys = _keys(tier)
    CALLS[call](keys)                    # cold: fills the tier cache
    return _profiled(lambda: CALLS[call](keys))


@pytest.mark.parametrize("call,tier", CASES, ids=IDS)
def test_span_tree_of_a_warm_call(tiered, call, tier):
    """Entry > tier > pass and leaf; the planner's sample read inside the
    plan (the cache refresh, after the first tier is queued), the tier's
    flag read under the entry, the equi-depth sample's flag inside its
    sample."""
    _, events, _ = _warm_call(call, tier)
    assert _tree(events, ENTRY[call]) == TREES[tier]
    spans = {_short(e.name, ENTRY[call]): e for e in _ours(events)}
    assert spans[f"tier.{tier}"].time_range.end <= \
        spans["plan"].time_range.start


@pytest.mark.parametrize("call,tier", CASES, ids=IDS)
def test_spans_are_not_user_annotations(tiered, call, tier):
    _, events, _ = _warm_call(call, tier)
    ours = _ours(events)
    assert len(ours) >= 7
    assert not any(e.is_user_annotation for e in ours)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in ours)


@pytest.mark.parametrize("call,tier", CASES, ids=IDS)
def test_host_reads_count_the_read_spans(tiered, call, tier):
    """The ``host_reads`` delta is the number of read spans: two for a
    radix-tier call (the planner's sample, the tier's flag), three on the
    equi-depth tier (and its sample sort's flag)."""
    _, events, moved = _warm_call(call, tier)
    reads = [e for e in events if e.name.startswith("tpusort.read.")]
    assert moved["host_reads"] == len(reads) == READS[tier]
    outer = [e for e in events if e.name.startswith(API)
             and not _in_entry(e)]
    assert [e.name for e in outer] == [API + ENTRY[call]]


@pytest.mark.parametrize("call,tier", CASES, ids=IDS)
def test_profiler_off_gives_the_same_outputs_and_counts(tiered, call, tier):
    keys = _keys(tier)
    CALLS[call](keys)
    traced, _, moved = _profiled(lambda: CALLS[call](keys))
    before = tm.counters()
    plain = CALLS[call](keys)
    after = tm.counters()
    assert {k: after[k] - before[k] for k in after} == moved
    traced = traced if isinstance(traced, tuple) else (traced,)
    plain = plain if isinstance(plain, tuple) else (plain,)
    assert all(torch.equal(a, b) for a, b in zip(traced, plain))


@pytest.fixture
def sites(monkeypatch):
    """The sites of every host read, in order, spied in each module that
    reads."""
    seen = []
    orig = tlog.host_read

    def spy(site):
        seen.append(site)
        return orig(site)

    for mod in (tapi, ttiers, tseg, tgs):
        monkeypatch.setattr(mod, "host_read", spy)
    tm.reset_counters()
    return seen


def _engine_route():
    """``segmented_sort``'s engine route on CPU tensors (a CUDA tensor
    takes it in the public call), gated as from ``PLANNER_MIN_N``."""
    n = 49152
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    offs = np.linspace(0, n, 65).astype(np.int64)
    (plane,), traits = tdt.twiddle_in(torch.from_numpy(keys))
    seg = torch.from_numpy(np.searchsorted(offs[1:], np.arange(n),
                                           side="right").astype(np.int32))
    got, _ = tseg._sort_on_engine(offs, seg, plane, [], stable=True)
    want = np.concatenate([np.sort(keys[a:b])
                           for a, b in zip(offs[:-1], offs[1:])])
    np.testing.assert_array_equal(tdt.twiddle_out(got, traits).numpy(), want)


def _segmented():
    n = 1 << 12
    tpusort_torch.segmented_sort(_keys("radix", n),
                                 torch.tensor([0, 1000, 1000, n]))


def _global(finish):
    def run():
        sorter = make_global_sort(InProcessComm(8, "cpu", timeout=60),
                                  finish=finish)
        keys = _keys("radix", 1 << 16)
        out = sorter(keys)
        np.testing.assert_array_equal(out.numpy(), np.sort(keys.numpy()))
    return run


@pytest.mark.parametrize("run,want", [
    (_segmented, {"segment_offsets": 1}),
    (_engine_route, {"segment_levels": 1, "segmented_flag": 1}),
    (_global("collapse"), {"global_counts": 8, "msd_flag": 16}),
    (_global("windows"), {"global_counts": 8, "msd_flag": 8,
                          "global_flag": 8}),
], ids=["segmented_sort", "engine_route", "global_collapse",
        "global_windows"])
def test_segmented_and_global_read_sites(sites, monkeypatch, run, want):
    """The offsets' read, the engine route's gate and flag, and the global
    sort's count matrix (one read a shard), its shards' local sorts' flags
    and the windows finish's flag: each counted in ``host_reads``."""
    monkeypatch.setattr(tseg._planner, "PLANNER_MIN_N", 1 << 12)
    run()
    got = {}
    for s in sites:
        got[s] = got.get(s, 0) + 1
    assert got == want
    assert tm.counters()["host_reads"] == len(sites)


def test_nested_entries_nest_their_spans(tiered):
    """``argsort`` calls ``sort_planes``: its entry span holds the inner
    one; ``sort_pairs`` calls ``sort``, which alone has a span; two calls in
    turn give two outer entry spans in turn."""
    keys = _keys("radix", 1 << 12)
    _, events, _ = _profiled(lambda: (tpusort_torch.argsort(keys),
                                      tpusort_torch.sort_pairs(keys, keys)))
    apis = sorted((e for e in events if e.name.startswith(API)),
                  key=lambda e: e.time_range.start)
    assert [e.name for e in apis] == [API + "argsort", API + "sort_planes",
                                      API + "sort"]
    assert [_in_entry(e) for e in apis] == [False, True, False]
    assert _ancestor(apis[1]).name == API + "argsort"


def _u64(n: int = 1 << 13) -> torch.Tensor:
    x = np.random.default_rng(23).integers(0, 2**64, n, dtype=np.uint64)
    return torch.from_numpy(x.view(np.int64)).view(torch.uint64)


PLANES_CALLS = {
    "u64+i64": lambda: tpusort_torch.sort_pairs(
        _u64(), torch.arange(1 << 13, dtype=torch.int64)),
    "u64": lambda: tpusort_torch.sort(_u64()),
    "u32": lambda: tpusort_torch.sort(_keys("radix", 1 << 13)),
    "u32+u32": lambda: CALLS["sort_pairs"](_keys("radix", 1 << 13)),
}
# the split and join spans of each call: one a 64-bit operand
PLANES_SPANS = {"u64+i64": 2, "u64": 1, "u32": 0, "u32+u32": 0}


@pytest.fixture
def trace_log():
    """The logger at TRACE (``TPUSORT_LOG=TRACE``), its messages kept."""
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    handler, level = Keep(), tlog.logger.level
    tlog.logger.addHandler(handler)
    tlog.set_level("TRACE")
    yield seen
    tlog.logger.removeHandler(handler)
    tlog.set_level(level)


@pytest.mark.parametrize("call", sorted(PLANES_SPANS))
def test_planes_spans_only_where_a_64_bit_operand_is(trace_log, call):
    """``tpusort.planes.split`` under the entry and ``tpusort.planes.join``
    under the tier that sorted, once for each 64-bit key or value, logged
    at TRACE; a 32-bit call has neither."""
    tapi._TIER_CACHE.clear()
    _, events, _ = _profiled(PLANES_CALLS[call])
    want = PLANES_SPANS[call]
    for name, parent in (("tpusort.planes.split", API + "sort"),
                         ("tpusort.planes.join", "tpusort.tier.radix")):
        spans = [e for e in events if e.name == name]
        assert len(spans) == want
        assert all(_ancestor(e).name == parent for e in spans)
        assert not any(e.is_user_annotation for e in spans)
        assert len([m for m in trace_log if m.startswith(name + ":")]) == \
            want
