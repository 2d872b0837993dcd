"""The cell ``keys64.uniform`` at a CPU size: its configuration drops in,
the ``sort64`` entry's bytes, check and controls, a traced run's 64-bit
split and join, and ``kernels.merge_roofline`` read from a synthetic
trace."""

import time

import pytest
import torch

from conftest import make_root
from portbench import harness, peaks, reference, trace

CELL = "keys64.uniform"
H100 = "NVIDIA H100 80GB HBM3"
MERGE_CELLS = ["keys32.uniform", "pairs32.uniform", "keys32.entropy3",
               "pairs32.entropy3", "keys64.uniform"]


def _run(root, call=None, traced=False, seed=2**31 + 23):
    return harness.run_cell(CELL, seed, 0.02, traced,
                            device=torch.device("cpu"),
                            t_start=time.perf_counter(), root=root,
                            call=call)


def test_the_cell_loads_its_configuration():
    c = harness.load_cell(CELL)
    assert (c.cfg["entry"], c.cfg["key_dtype"], c.cfg["stable"]) == \
        ("sort64", "uint64", True)
    assert c.n == 1 << 27 and c.chips == 1 and c.cfg["reduced"] == []
    assert c.entry.job_bytes(c.cfg, c.n) == 16 * (1 << 27)
    names = [m["name"] for m in c.per_layer]
    assert {"ops.split_join_b_per_key", "kernels.merge_roofline",
            "kernels_roofline", "ops.glue_ms"} <= set(names)


@pytest.mark.parametrize("cell", sorted(
    w["name"] for w in harness.load_spec()["workloads"]))
def test_merge_roofline_is_reported_where_a_merge_body_runs(cell):
    """Every cell but ``pairs64.uniform`` (K1c and K2's network body)."""
    names = [m["name"] for m in harness.load_cell(cell).per_layer]
    assert ("kernels.merge_roofline" in names) == (cell in MERGE_CELLS)


def test_check_reads_zero_on_the_references_output(small_root):
    c = harness.load_cell(CELL, small_root)
    inp = c.entry.pool_input(c.cfg, c.traffic, c.n, 5, 0,
                             torch.device("cpu"))
    assert inp["keys"].dtype == torch.uint64 and set(inp) == {"keys"}
    out = reference.stable_sort(inp["keys"])
    assert c.entry.check(c.cfg, inp, out) == {"key_mismatches": 0}
    assert c.entry.check(c.cfg, inp, inp["keys"])["key_mismatches"] > 0


def test_a_traced_run_reads_32_bytes_a_key(small_root):
    """The program's sort of u64 keys on CPU tensors: correct, a split and
    a join of one 64-bit operand, no tier retried; no HBM peak on the CPU,
    so no roofline share."""
    res, checks = _run(small_root, traced=True)
    assert res["correct"] is True, checks
    m = res["metrics"]
    assert m["ops.split_join_b_per_key"] == {"value": 32.0, "unit": "B/key"}
    assert m["api.tier_retries"]["value"] == 0.0
    assert "kernels.merge_roofline" not in m


@pytest.fixture(scope="module")
def root_2p20(tmp_path_factory):
    # 2^20 uniform keys share a high word in about 2^7 pairs (2^16 keys in
    # about half a pair)
    return make_root(tmp_path_factory.mktemp("pb"), 1 << 20)


# the controls of the entry: ``low_bit`` is left out, as it gives the
# reference's answer on uniform 64-bit keys
CONTROLS = ["high_word"]


@pytest.mark.parametrize("name", CONTROLS)
def test_every_control_comes_out_not_correct(root_2p20, name):
    c = harness.load_cell(CELL, root_2p20)
    controls = c.entry.controls(c.cfg)
    assert sorted(controls) == CONTROLS
    fn = controls[name]
    res, checks = _run(root_2p20, call=lambda inp: fn(c.cfg, inp))
    assert res["correct"] is False, checks
    assert checks["key_mismatches"]["value"] > 0, checks


# as the card's trace names them
PART = "void tpusort::partition_raw_kernel<2, false, false, {}, {}>" \
       "(tpusort::Planes, tpusort::Values, tpusort::Splitters, int const*)"
LEAF = "void tpusort::leaf_collapse_kernel<2, false, 24, {}>" \
       "(tpusort::Planes, tpusort::Values, int const*, int)"
NAMES = {
    PART.format(32, "false"): False,
    PART.format(24, "true"): True,
    LEAF.format("true"): True,
    LEAF.format("false"): False,
    "void tpusort::partition_general_kernel<true>(tpusort::Operands)": False,
    "void at::native::elementwise_kernel<128, 2, true>(int)": False,
}


def _merge_share(counters, ops, n=1 << 27, calls=8, device=H100):
    w = harness.Window(call_s=[1.0], keys=1, seconds=1.0, setup_s=1.0,
                       scratch_bytes=None, n=n)
    tr = None if counters is None else trace.Trace(
        device_ops=ops, host_ops=[], t0=0.0, t1=1.0, calls=calls,
        counters=counters)
    run = harness.Run(window=w, trace=tr, job_bytes=0,
                      port_kernels=frozenset(), device_name=device)
    return harness.metric_reader("kernels.merge_roofline")(run)


# 8 calls of 6 operand words (two K1 merge passes and K2 on two planes) of
# 2^27 keys, 8 B a key and word
BYTES = 8 * 48 * (1 << 27)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_merge_roofline_times_the_merge_launches_alone(name):
    """Each name alone in the trace beside a merge launch of 10 ms: the
    share counts its time only where its ``MERGE`` flag is true."""
    ops = [(LEAF.format("true"), 0.0, 0.010), (name, 0.1, 0.11)]
    s = 0.020 if NAMES[name] else 0.010
    want = 100.0 * BYTES / peaks.hbm_bytes_per_s(H100) / s
    assert _merge_share({"merge_bytes": BYTES}, ops) == pytest.approx(want)


@pytest.mark.parametrize("n", [1 << 22, 1 << 27, 1 << 28])
def test_merge_roofline_reads_the_counted_bytes_not_the_cells_n(n):
    """The bytes are the launches' own, as counted where they are made, so
    the share is the same whatever the cell's n: the skew tier's sample
    sort merges 2^22 keys in a cell of 2^28.  51.5 GB in 8 x 4 ms at
    3.35 TB/s is 48.1%."""
    got = _merge_share({"merge_bytes": BYTES},
                       [(PART.format(24, "true"), 0.004 * k, 0.004 * (k + 1))
                        for k in range(8)], n=n)
    assert got == pytest.approx(100 * BYTES / 3.35e12 / 0.032)


def test_merge_roofline_reads_nothing_without_the_counter():
    """The parent's program has no ``merge_bytes``; an untraced run, a
    stretch with no merge launch, or a card without a known peak read
    nothing."""
    ops = [(PART.format(24, "true"), 0.0, 0.004)]
    assert _merge_share({"host_reads": 16}, ops) is None
    assert _merge_share(None, ops) is None
    assert _merge_share({"merge_bytes": 0}, ops) is None
    assert _merge_share({"merge_bytes": BYTES},
                        [(PART.format(32, "false"), 0.0, 0.004)]) is None
    assert _merge_share({"merge_bytes": BYTES}, ops, device="cpu") is None
