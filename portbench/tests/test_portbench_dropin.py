"""A configuration, a traffic mix and a metric dropped in as new files
are found by the names ``BENCHMARK.json`` gives, with no file of the
harness edited."""

import json
import time

import torch

from portbench import harness

METRIC = '''
def read(run):
    return float(run.window.n)
'''


def test_new_files_are_found_by_name(small_root):
    pb = small_root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = {"name": "u32-keys-small", "entry": "sort", "key_dtype": "uint32",
           "n": 3000, "stable": True, "source": "a test", "reduced": []}
    (pb / "configs" / "u32-keys-small.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "zipf-mix.json").write_text(json.dumps({
        "keys": [{"rule": "zipf", "alpha": 1.1, "universe": 64},
                 {"rule": "entropy_and", "level": 0},
                 {"rule": "uniform", "presorted": True}],
        "pool": 3, "loop": {"kind": "closed", "callers": 1}}))
    (pb / "metrics" / "keys_seen.py").write_text(METRIC)
    spec = json.loads((small_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "u32-keys-small", "source": "a test",
                            "file": "portbench/configs/u32-keys-small.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "keys.mix", "config": "u32-keys-small",
                              "traffic": "zipf-mix", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "keys_seen", "unit": "keys",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["keys.mix"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell("keys.mix", small_root)
    assert cell.n == 3000 and cell.traffic["pool"] == 3
    res, checks = harness.run_cell(
        "keys.mix", 77, 0.05, False, device=torch.device("cpu"),
        t_start=time.perf_counter(), root=small_root)
    assert res["correct"] is True, checks
    assert res["metrics"]["keys_seen"] == {"value": 3000.0, "unit": "keys"}
    # the old cells do not report the new metric
    assert "keys_seen" not in [m["name"] for m in
                               harness.load_cell("keys32.uniform",
                                                 small_root).end_to_end]
    for p, data in before.items():
        assert p.read_bytes() == data, p
