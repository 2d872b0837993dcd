"""The per-layer arithmetic on synthetic timelines."""

import pytest

from portbench import harness, trace


def _trace(device_ops, host_ops=(), t0=0.0, t1=1.0, calls=2, counters=None):
    return trace.Trace(device_ops=list(device_ops), host_ops=list(host_ops),
                       t0=t0, t1=t1, calls=calls, counters=counters or {})


def _run(tr, job_bytes=0, device="NVIDIA H100 80GB HBM3",
         kernels=("partition_raw_kernel", "leaf_collapse_kernel")):
    w = harness.Window(call_s=[1.0], keys=1, seconds=1.0, setup_s=1.0,
                       scratch_bytes=None, n=1)
    return harness.Run(window=w, trace=tr, job_bytes=job_bytes,
                       port_kernels=frozenset(kernels), device_name=device)


K1 = "void partition_raw_kernel<1, 0, 16>(Planes, Values, Splitters)"
K2 = "_Z20leaf_collapse_kernelILi1ELb0EEv6Planes"
GLUE = "void at::native::vectorized_elementwise_kernel<4>(int)"


def test_idle_pct_from_a_timeline_with_overlaps():
    tr = _trace([(K1, 0.1, 0.3), (GLUE, 0.2, 0.4), (K2, 0.6, 0.7),
                 (GLUE, 0.95, 1.2)])
    # busy: [0.1, 0.4], [0.6, 0.7], [0.95, 1.0] cut to the window
    assert tr.busy_s() == pytest.approx(0.45)
    assert harness.metric_reader("device.idle_pct")(_run(tr)) == \
        pytest.approx(55.0)


def test_idle_pct_reads_nothing_without_device_operations():
    assert harness.metric_reader("device.idle_pct")(_run(_trace([]))) is None


def test_idle_gaps_are_named_by_the_innermost_host_operation():
    tr = _trace([(K1, 0.2, 0.5), (K2, 0.8, 1.0)],
                host_ops=[("portbench.call", 0.0, 1.0),
                          ("cudaStreamSynchronize", 0.5, 0.75),
                          ("aten::item", 0.45, 0.8)])
    gaps = dict(tr.idle_gaps())
    assert gaps == pytest.approx({"portbench.call": 0.2,
                                  "cudaStreamSynchronize": 0.3})


def test_kernel_ms_by_name_demangled_and_mangled():
    tr = _trace([(K1, 0.0, 0.010), (K2, 0.1, 0.104), (GLUE, 0.2, 0.201),
                 ("void collapse_kernel<2>(Operands)", 0.3, 0.302)])
    assert tr.kernel_ms(["partition_raw_kernel"]) == pytest.approx(5.0)
    assert tr.kernel_ms(["leaf_collapse_kernel"]) == pytest.approx(2.0)
    # collapse_kernel is not the end of leaf_collapse_kernel
    assert tr.kernel_ms(["collapse_kernel"]) == pytest.approx(1.0)
    assert tr.kernel_ms(["sort_tiles_kernel"]) is None


def test_layer_metrics_read_null_for_a_renamed_kernel():
    tr = _trace([("void partition_raw_kernel_v2<1>()", 0.0, 0.01)])
    tr.device_ops[0] = ("void renamed_partition<1>()", 0.0, 0.01)
    run = _run(tr)
    assert harness.metric_reader("kernels.partition_ms")(run) is None
    assert harness.metric_reader("kernels.leaf_ms")(run) is None


def test_glue_is_every_device_operation_but_the_ports_kernels():
    tr = _trace([(K1, 0.0, 0.010), (GLUE, 0.1, 0.103),
                 ("Memcpy DtoH (Device -> Pinned)", 0.2, 0.201)])
    run = _run(tr)
    assert harness.metric_reader("ops.glue_ms")(run) == pytest.approx(2.0)
    assert harness.metric_reader("kernels.partition_ms")(run) == \
        pytest.approx(5.0)


def test_roofline_is_the_jobs_bytes_over_the_ports_kernel_time():
    tr = _trace([(K1, 0.0, 0.010), (K2, 0.1, 0.110), (GLUE, 0.2, 0.5)],
                calls=1)
    run = _run(tr, job_bytes=int(3.35e12 * 0.001))    # 1 ms at the peak
    assert harness.metric_reader("kernels_roofline")(run) == \
        pytest.approx(5.0)
    assert harness.metric_reader("kernels_roofline")(
        _run(tr, job_bytes=1, device="some other card")) is None


def test_tier_retries_from_counter_deltas():
    base = {"radix_tiers": 4, "equidepth_runs": 0, "overflow_fallbacks": 0,
            "identity_routes": 0, "reference_routes": 0}
    read = harness.metric_reader("api.tier_retries")
    assert read(_run(_trace([], calls=4, counters=base))) == 0.0
    over = dict(base, equidepth_runs=2)
    assert read(_run(_trace([], calls=4, counters=over))) == 0.5
    skipped = dict(base, radix_tiers=0, equidepth_runs=4)
    assert read(_run(_trace([], calls=4, counters=skipped))) == 0.0
    assert read(_run(_trace([], calls=4,
                            counters=dict(base, reference_routes=1)))) is None
    assert read(_run(None)) is None
