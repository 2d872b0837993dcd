"""Read the numbers that decide ``correct`` over many seeds in one
process: the program's, and each control's in the program's place.

    python3 portbench/readings.py --workload keys32.uniform \\
        --seeds 1,2,3,4,5,6,7,8,9,10,11,12 --control-seeds 1,2,3 \\
        --seconds 2 --out build/readings/keys32.uniform.jsonl

Each seed is one whole run of the cell (``harness.run_cell``: its pool,
warm-up, a window of ``--seconds``, the check), with the program's entry
or with a control of the entry (``controls(cfg)``: the reference breaking
one guarantee of the configuration) standing in for it.  The lower
reading of a number is the largest the program gives, the upper the
smallest a control gives.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    runs = [("program", None, int(s)) for s in args.seeds.split(",")]
    for name, fn in cell.entry.controls(cell.cfg).items():
        runs += [(name, fn, int(s)) for s in args.control_seeds.split(",")
                 if s]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    readings = {}
    with out.open("a") as f:
        for who, fn, seed in runs:
            call = None if fn is None else \
                (lambda inp, fn=fn: fn(cell.cfg, inp))
            res, checks = harness.run_cell(
                args.workload, seed, args.seconds, False, device=dev,
                t_start=time.perf_counter(), call=call)
            nums = {k: c["value"] for k, c in checks.items()}
            rec = {"workload": args.workload, "who": who, "seed": seed,
                   "correct": res["correct"], "attempted": res["attempted"],
                   "checks": nums}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            print(json.dumps(rec), flush=True)
            for k, v in nums.items():
                readings.setdefault((who, k), []).append(v)
            torch.cuda.empty_cache()
    for (who, k), v in sorted(readings.items()):
        side = "largest" if who == "program" else "smallest"
        pick = max(v) if who == "program" else min(v)
        print(f"{who} {k}: {side} {pick} over {len(v)} seeds: {v}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
