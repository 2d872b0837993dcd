"""The arithmetic of the end-to-end metrics."""

import statistics
import time

import pytest
import torch

from portbench import harness, stats


def _run(call_s, keys, seconds, scratch=None, n=1):
    w = harness.Window(call_s=call_s, keys=keys, seconds=seconds,
                       setup_s=1.5, scratch_bytes=scratch, n=n)
    return harness.Run(window=w, trace=None, job_bytes=8 * n,
                       port_kernels=frozenset(), device_name="cpu")


def test_rate_is_over_the_whole_window_with_a_stall():
    # 99 calls of 10 ms and one stalled call of 1 s: the rate is the keys
    # over all 1.99 s, not over the typical call
    run = _run([0.01] * 99 + [1.0], keys=100 * 1000, seconds=1.99)
    rate = harness.metric_reader("keys_per_s")(run)
    assert rate == pytest.approx(100 * 1000 / 1.99)
    assert rate < 0.6 * 1000 / 0.01


def test_window_rate_counts_an_injected_stall(small_root):
    calls = []

    def stalled(inp):
        calls.append(1)
        if len(calls) == 12:              # a call of the window
            time.sleep(0.3)
        return torch.sort(inp["keys"])[0]

    res, _ = harness.run_cell("keys32.uniform", 5, 0.2, False,
                              device=torch.device("cpu"),
                              t_start=time.perf_counter(), root=small_root,
                              call=stalled)
    m = res["metrics"]
    window_s = res["attempted"] * (1 << 12) / m["keys_per_s"]["value"]
    assert window_s >= 0.3


def test_p95_is_nearest_rank_over_all_calls():
    assert stats.percentile([1.0] * 94 + [10.0] * 6, 95) == 10.0
    assert stats.percentile([1.0] * 95 + [10.0] * 5, 95) == 1.0
    assert stats.percentile([3.0], 95) == 3.0
    run = _run([0.001] * 90 + [0.05] * 10, keys=100, seconds=1.0)
    assert harness.metric_reader("call_ms_p95")(run) == pytest.approx(50.0)


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def test_scratch_and_setup_readers():
    run = _run([0.1], keys=1, seconds=0.1, scratch=64 * 1024, n=1024)
    assert harness.metric_reader("scratch_b_per_key")(run) == 64.0
    assert harness.metric_reader("setup_s")(run) == 1.5
    assert harness.metric_reader("scratch_b_per_key")(
        _run([0.1], keys=1, seconds=0.1)) is None
