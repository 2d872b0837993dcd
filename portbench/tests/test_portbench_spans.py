"""The readers of the program's host spans and host-read count
(``api.host_reads``, ``api.enqueue_ms``, ``device.idle_program_ms``) on
synthetic timelines, and their span prefixes against what
``tpusort_torch`` emits."""

import ast
import time
from pathlib import Path

import pytest
import torch

from portbench import harness, spans, trace

ROOT = Path(__file__).resolve().parents[2]
READERS = ("api.host_reads", "api.enqueue_ms", "device.idle_program_ms")
K1 = "void partition_raw_kernel<1, 0, 16>(Planes, Values, Splitters)"


def _run(device_ops=(), host_ops=(), t0=0.0, t1=1.0, calls=1,
         counters=None):
    tr = trace.Trace(device_ops=list(device_ops), host_ops=list(host_ops),
                     t0=t0, t1=t1, calls=calls, counters=counters or {})
    w = harness.Window(call_s=[1.0], keys=1, seconds=1.0, setup_s=1.0,
                       scratch_bytes=None, n=1)
    return harness.Run(window=w, trace=tr, job_bytes=0,
                       port_kernels=frozenset(["partition_raw_kernel"]),
                       device_name="NVIDIA H100 80GB HBM3")


def _read(name, run):
    return harness.metric_reader(name)(run)


def test_host_reads_a_call_from_the_counter():
    run = _run(host_ops=[("tpusort.api.sort", 0.1, 0.4),
                         ("tpusort.api.sort", 0.5, 0.9)],
               calls=2, counters={"host_reads": 6})
    assert _read("api.host_reads", run) == 3.0
    # a program without the counter, or without entry spans
    assert _read("api.host_reads", _run(
        host_ops=[("tpusort.api.sort", 0.1, 0.4)])) is None
    assert _read("api.host_reads", _run(
        host_ops=[("aten::sort", 0.1, 0.4)],
        counters={"host_reads": 2})) is None


def test_enqueue_is_the_entries_less_their_reads():
    """Back-to-back and nested entry spans count once; a read at an
    entry's end, one across two entries' seam, and one outside every
    entry (not the program's) are taken off only where they overlap."""
    host = [("tpusort.api.sort", 0.1, 0.3),
            ("tpusort.api.argsort", 0.3, 0.5),
            ("tpusort.api.sort", 0.35, 0.45),          # nested
            ("tpusort.tier.radix", 0.12, 0.2),
            ("tpusort.read.tier_flag", 0.25, 0.3),     # at the entry's end
            ("tpusort.read.sample", 0.28, 0.32),       # across the seam
            ("tpusort.read.msd_flag", 0.6, 0.7),       # outside
            ("cudaStreamSynchronize", 0.26, 0.29)]
    got = _read("api.enqueue_ms", _run(host_ops=host, calls=2))
    assert got == pytest.approx((0.4 - 0.07) * 1e3 / 2)


def test_enqueue_cuts_entries_to_the_stretch():
    host = [("tpusort.api.sort", -0.5, 0.2), ("tpusort.api.sort", 0.9, 1.5)]
    assert _read("api.enqueue_ms", _run(host_ops=host)) == \
        pytest.approx(300.0)


def test_idle_inside_the_entries():
    """Idle that straddles an entry's edge counts only inside it; idle
    outside every entry is the caller's."""
    dev = [(K1, 0.0, 0.05), (K1, 0.2, 0.4), ("Memcpy DtoH", 0.45, 0.9)]
    host = [("tpusort.api.sort", 0.1, 0.5), ("portbench.call", 0.0, 1.0)]
    run = _run(device_ops=dev, host_ops=host)
    # idle [0.05, 0.2], [0.4, 0.45], [0.9, 1.0]; inside [0.1, 0.5]:
    # [0.1, 0.2] and [0.4, 0.45]
    got = _read("device.idle_program_ms", run)
    assert got == pytest.approx(150.0)
    idle_ms = _read("device.idle_pct", run) / 100 * 1e3
    assert 0 <= got <= idle_ms == pytest.approx(300.0)


def test_idle_with_overlapping_device_work_and_nested_entries():
    dev = [(K1, 0.1, 0.3), ("glue", 0.2, 0.35), (K1, 0.6, 0.7)]
    host = [("tpusort.api.global_sort", 0.0, 0.8),
            ("tpusort.api.sort", 0.05, 0.5)]
    got = _read("device.idle_program_ms", _run(device_ops=dev,
                                               host_ops=host, calls=2))
    # idle in [0, 0.8]: [0, 0.1], [0.35, 0.6], [0.7, 0.8]
    assert got == pytest.approx(0.45 * 1e3 / 2)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_entry_spans(name):
    """The parent program, with no spans: the metric is left out."""
    run = _run(device_ops=[(K1, 0.0, 0.5)],
               host_ops=[("aten::copy_", 0.1, 0.2),
                         ("cudaStreamSynchronize", 0.5, 0.9)],
               counters={"radix_tiers": 1})
    assert _read(name, run) is None
    run.trace = None
    assert _read(name, run) is None


def test_idle_program_needs_device_operations():
    run = _run(host_ops=[("tpusort.api.sort", 0.1, 0.5)])
    assert _read("device.idle_program_ms", run) is None


def test_interval_helpers():
    assert spans.intersect([(0, 2), (3, 5)], [(1, 4)]) == [(1, 2), (3, 4)]
    assert spans.intersect([(0, 1)], [(1, 2)]) == []
    tr = trace.Trace(device_ops=[(K1, 0.2, 0.3), (K1, 0.25, 0.5)],
                     host_ops=[], t0=0.0, t1=1.0, calls=1)
    assert spans.idle(tr) == [(0.0, 0.2), (0.5, 1.0)]


def _literals(path: Path):
    return [n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.value.startswith("tpusort.")]


def test_span_prefixes_are_names_the_program_emits(monkeypatch):
    """``spans.API`` and ``spans.READ``, and any ``tpusort.`` name in a
    reader, begin names that a traced ``tpusort_torch`` call records."""
    import tpusort_torch
    from tpusort_torch import planner

    monkeypatch.setattr(planner, "PLANNER_MIN_N", 1 << 10)
    keys = torch.randint(-2**31, 2**31, (1 << 13,), dtype=torch.int32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tpusort_torch.sort(keys.view(torch.uint32))
    names = {e.name for e in prof.events() if e.name.startswith("tpusort.")}
    prefixes = [spans.API, spans.READ]
    for name in READERS:
        prefixes += _literals(ROOT / "portbench" / "metrics" / f"{name}.py")
    for p in prefixes:
        assert any(n.startswith(p) for n in names), (p, sorted(names))
    assert "tpusort.api.sort" in names and "tpusort.read.sample" in names


def test_a_traced_cpu_run_reports_the_host_metrics(small_root):
    res, _ = harness.run_cell(
        "keys32.entropy3", 2**31 + 99, 0.05, True,
        device=torch.device("cpu"), t_start=time.perf_counter(),
        root=small_root)
    m = res["metrics"]
    assert res["correct"] is True
    # on the CPU: the tier chain's flag, a call; no device, no idle
    assert m["api.host_reads"]["value"] >= 1.0
    assert m["api.enqueue_ms"]["value"] > 0
    assert "device.idle_program_ms" not in m
