"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at a
size a test run holds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def make_root(tmp: Path, n: int) -> Path:
    """``BENCHMARK.json`` and ``portbench/`` copied under ``tmp``, every
    configuration cut to ``n`` keys."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (tmp / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["n"] = n
        f.write_text(json.dumps(cfg))
    return tmp


@pytest.fixture
def small_root(tmp_path):
    return make_root(tmp_path, 1 << 12)
