"""Run one cell of ``BENCHMARK.json`` once on the CUDA card(s) of this
machine and print its result as the last line of standard output.

    python3 portbench/run.py --workload keys32.uniform --seed 7 \\
        --seconds 10 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a traced stretch of whole calls before the
window (``portbench/harness.py``).  The numbers that decide ``correct``
come last on standard error, each beside its limit, and last in the
result line under ``checks``.  Exits with 2, printing no result, without
enough CUDA cards, and with 3 if the process holds ``jax``, ``jaxlib``,
``flax`` or the JAX package ``tpusort`` once the window has closed.
Builds of the program go to ``build/`` inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

FORBIDDEN = ("jax", "jaxlib", "flax", "tpusort")


def forbidden_modules():
    """The modules loaded whose top-level name is one of FORBIDDEN, the
    name compared whole (``tpusort_torch`` is not ``tpusort``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ") or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a cache the program or PyTorch may write stays inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")

    from portbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, checks = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        device=torch.device("cuda", 0), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad}", file=sys.stderr)
        return 3
    print(f"card (name, power limit): {_power_limit()}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
