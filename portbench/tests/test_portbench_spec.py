"""``BENCHMARK.json`` against the contract's names, units and files, the
kernel names against the program's sources, and the result line."""

import ast
import json
import re
import time
from pathlib import Path

import pytest
import torch

from portbench import harness, trace

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
TEXT = re.compile(r"[^\t\n\r]{1,200}")


def _metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def test_names_units_and_text_fields():
    names = [m["name"] for m in _metrics()]
    names += [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [w["config"] for w in SPEC["workloads"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.fullmatch(name), name
    for m in _metrics():
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in SPEC["workloads"]] +
                 [c["why"] for c in SPEC["configs"]] +
                 [c["source"] for c in SPEC["configs"]] +
                 [m["layer"] for m in SPEC["per_layer"]] +
                 SPEC["command"]):
        assert TEXT.fullmatch(text), text
    for group in ("end_to_end", "per_layer", "configs", "workloads"):
        got = [x["name"] for x in SPEC[group]]
        assert len(got) == len(set(got)), group
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_keys_bounds_and_sources():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)


def test_every_named_file_is_there():
    for p in SPEC["paths"]:
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    for c in SPEC["configs"]:
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert (ROOT / "portbench" / "entries" / f"{cfg['entry']}.py").is_file()
    for w in SPEC["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        harness.load_cell(w["name"])
    for m in _metrics():
        assert callable(harness.metric_reader(m["name"]))


def _kernel_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                any(getattr(t, "id", None) == "KERNELS" for t in node.targets):
            return ast.literal_eval(node.value)
    return ()


def test_metric_kernel_names_are_globals_of_the_ports_csrc():
    names = trace.global_names(ROOT / "tpusort_torch" / "csrc")
    assert {"partition_raw_kernel", "leaf_collapse_kernel",
            "collapse_kernel"} <= names
    seen = 0
    for path in sorted((ROOT / "portbench" / "metrics").glob("*.py")):
        for k in _kernel_names(path):
            assert k in names, (path.name, k)
            seen += 1
    assert seen >= 7


def test_result_line_keys(small_root):
    res, checks = harness.run_cell(
        "pairs32.uniform", 2**31 + 17, 0.05, False,
        device=torch.device("cpu"), t_start=time.perf_counter(),
        root=small_root)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["metrics"]) == {"keys_per_s", "call_ms_p95", "setup_s"}
    assert set(checks) == {"key_mismatches", "value_mismatches",
                           "failed_calls"}
    assert all(set(c) == {"value", "limit"} for c in checks.values())
    json.dumps(res)
    traced, _ = harness.run_cell(
        "keys32.uniform", 3, 0.05, True, device=torch.device("cpu"),
        t_start=time.perf_counter(), root=small_root)
    assert list(traced)[-2:] == ["breakdown", "checks"]
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(traced["device"])


def test_run_exits_without_a_card_and_prints_nothing(capsys, monkeypatch):
    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "keys32.uniform", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("job", [("u32-keys-2p28", 2 * 4),
                                 ("u32-pairs-2p28-stable", 4 * 4)])
def test_job_bytes_per_configuration(job):
    name, per_key = job
    conf = {c["name"]: c for c in SPEC["configs"]}[name]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    entry = harness.load_file_module(
        ROOT / "portbench" / "entries" / f"{cfg['entry']}.py", "entry")
    assert entry.job_bytes(cfg, cfg["n"]) == per_key * (1 << 28)
