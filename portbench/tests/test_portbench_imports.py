"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "tpusort"}

_PROBE = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from pathlib import Path
from portbench import harness, reference, run, sets, readings
for m in Path(sys.argv[1], "portbench", "metrics").glob("*.py"):
    harness.metric_reader(m.stem)
for w in harness.load_spec()["workloads"]:
    harness.load_cell(w["name"])
keys = torch.randint(-2**31, 2**31, (1000,), dtype=torch.int32).view(torch.uint32)
reference.stable_sort(keys, torch.arange(1000, dtype=torch.int32))
ref_only = "tpusort_torch" in sys.modules
res, _ = harness.run_cell("pairs32.entropy3", 9, 0.05, True,
                          device=torch.device("cpu"),
                          t_start=time.perf_counter(), root=sys.argv[2])
print(json.dumps({"ref_only_program": ref_only, "correct": res["correct"],
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_the_harness_and_a_run_load_no_jax_and_no_tpusort(small_root):
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT), str(small_root)],
        capture_output=True, text=True, timeout=300, cwd=small_root,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["correct"] is True
    # the whole top-level name: tpusort_torch is the program, tpusort is not
    assert "tpusort_torch" in rec["modules"]
    assert not FORBIDDEN & set(rec["modules"])
    assert rec["ref_only_program"] is False


def test_reference_and_generators_import_nothing_of_the_program():
    for name in ("reference.py", "datagen.py"):
        tree = ast.parse((ROOT / "portbench" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN | {"tpusort_torch"}, \
                    (name, m)
