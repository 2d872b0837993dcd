"""The cell ``pairs64.uniform`` at a CPU size: its configuration drops in,
a traced run reads ``ops.split_join_b_per_key``, and the comparison that
decides ``correct`` holds 64-bit keys and int64 values to both guarantees.

Uniform 64-bit keys almost never tie: an input of 2^27 holds about 5e-4
pairs of equal keys, and as many pairs that differ in the lowest bit
alone.  So on the cell's own traffic ``low_bit`` and ``reversed_ties``
give the reference's answer, and ``high_word`` (the keys' high 32 bits
alone) is the control that comes out not correct there; a mix with ties
shows that the comparison sees what each control breaks."""

import json
import time

import pytest
import torch

from conftest import make_root
from portbench import harness, trace

CELL = "pairs64.uniform"


def _run(root, cell=CELL, call=None, traced=False, seed=2**31 + 11):
    return harness.run_cell(cell, seed, 0.02, traced,
                            device=torch.device("cpu"),
                            t_start=time.perf_counter(), root=root,
                            call=call)


def test_the_cell_loads_its_configuration():
    c = harness.load_cell(CELL)
    assert (c.cfg["key_dtype"], c.cfg["value_dtype"], c.cfg["stable"]) == \
        ("uint64", "int64", True)
    assert c.n == 1 << 27 and c.chips == 1
    assert c.entry.job_bytes(c.cfg, c.n) == 2 * 16 * (1 << 27)
    assert "ops.split_join_b_per_key" in [m["name"] for m in c.per_layer]
    # the 32-bit cells do not report it
    assert "ops.split_join_b_per_key" not in [
        m["name"] for m in harness.load_cell("pairs32.uniform").per_layer]


def test_a_traced_run_reads_64_bytes_a_key(small_root):
    res, checks = _run(small_root, traced=True)
    assert res["correct"] is True, checks
    assert res["metrics"]["ops.split_join_b_per_key"] == \
        {"value": 64.0, "unit": "B/key"}
    assert res["metrics"]["api.tier_retries"]["value"] == 0.0


def _counted(counters, n=1 << 12, calls=8):
    w = harness.Window(call_s=[1.0], keys=1, seconds=1.0, setup_s=1.0,
                       scratch_bytes=None, n=n)
    tr = None if counters is None else trace.Trace(
        device_ops=[], host_ops=[], t0=0.0, t1=1.0, calls=calls,
        counters=counters)
    run = harness.Run(window=w, trace=tr, job_bytes=0,
                      port_kernels=frozenset(), device_name="cpu")
    return harness.metric_reader("ops.split_join_b_per_key")(run)


def test_the_reader_reads_nothing_without_the_counter():
    """A program without ``split_join_bytes`` (the parent's), or an
    untraced run, reads nothing; with it, bytes over calls and n."""
    assert _counted({"host_reads": 16}) is None
    assert _counted(None) is None
    assert _counted({"split_join_bytes": 8 * 64 << 12}) == 64.0
    assert _counted({"split_join_bytes": 0}) == 0.0


@pytest.fixture(scope="module")
def root_2p20(tmp_path_factory):
    # 2^20 uniform keys share a high word in about 2^7 pairs
    return make_root(tmp_path_factory.mktemp("pb"), 1 << 20)


# whether each control gives the reference's answer on uniform 64-bit keys
ON_UNIFORM = {"high_word": False, "low_bit": True, "reversed_ties": True}


@pytest.mark.parametrize("name", sorted(ON_UNIFORM))
def test_on_uniform_keys_only_high_word_is_not_correct(root_2p20, name):
    """Where no two keys tie, only the 32-bit precision changes the
    answer, and it changes the keys' order."""
    c = harness.load_cell(CELL, root_2p20)
    fn = c.entry.controls(c.cfg)[name]
    res, checks = _run(root_2p20, call=lambda inp: fn(c.cfg, inp))
    assert res["correct"] is ON_UNIFORM[name], checks
    if name == "high_word":
        assert checks["key_mismatches"]["value"] > 0, checks


@pytest.fixture
def tied_root(small_root):
    """The cell's configuration under a mix whose 64-bit keys tie: each
    bit set with probability 2^-6, so about a third of the keys are 0 and
    some are 1, which differs from 0 in the lowest bit alone."""
    (small_root / "portbench" / "traffic" / "sparse64.json").write_text(
        json.dumps({"keys": {"rule": "entropy_and", "level": 6},
                    "pool": 2, "loop": {"kind": "closed", "callers": 1}}))
    spec = json.loads((small_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "pairs64.sparse",
                              "config": "u64-i64-pairs-2p27-stable",
                              "traffic": "sparse64", "chips": 1,
                              "why": "a test"})
    (small_root / "BENCHMARK.json").write_text(json.dumps(spec))
    return small_root


def test_controls_come_out_not_correct_where_64_bit_keys_tie(tied_root):
    res, checks = _run(tied_root, "pairs64.sparse")
    assert res["correct"] is True, checks
    c = harness.load_cell("pairs64.sparse", tied_root)
    controls = c.entry.controls(c.cfg)
    assert set(controls) == set(ON_UNIFORM)
    for name, fn in controls.items():
        res, checks = _run(tied_root, "pairs64.sparse",
                           call=lambda inp, fn=fn: fn(c.cfg, inp))
        assert res["correct"] is False, (name, checks)
        want = "value_mismatches" if name == "reversed_ties" \
            else "key_mismatches"
        assert checks[want]["value"] > 0, (name, checks)
