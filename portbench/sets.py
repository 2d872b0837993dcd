"""Run a cell in sets of runs and read their spread, as the bounds are set.

    python3 portbench/sets.py --workload pairs32.uniform \\
        --seeds 11,12,13,14,15,16 --sets 2 --seconds 20 --trace 0 \\
        --out build/sets/pairs32.uniform.jsonl

Each run is ``portbench/run.py`` in a process of its own, one after
another, every set with the same seeds.  Each run's result line (or its
failure, with the end of its standard error) goes to ``--out`` as a JSON
line; then, for each set and metric, the median and the spread (the
distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` over the median), ``setup_s`` also
without the first run of the call, and the bound five times the wider
spread would give.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _run(workload: str, seed: int, seconds: float, trace: int,
         timeout: float) -> dict:
    cmd = [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired as exc:
        return {"seed": seed, "rc": "timeout", "wall_s": timeout,
                "stderr": str(exc.stderr or "")[-3000:]}
    rec = {"seed": seed, "rc": p.returncode,
           "wall_s": time.perf_counter() - t0,
           "stderr": p.stderr[-3000:]}
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    return rec


def _summary(label: str, recs) -> dict:
    from portbench import stats

    vals = {}
    for r in recs:
        for name, m in r.get("result", {}).get("metrics", {}).items():
            vals.setdefault(name, []).append(m["value"])
    out = {}
    for name, v in sorted(vals.items()):
        row = {"n": len(v), "median": statistics.median(v),
               "min": min(v), "max": max(v)}
        if len(v) >= 2 and statistics.median(v):
            row["spread"] = stats.spread(v)
        out[name] = row
        print(f"{label} {name}: " + ", ".join(
            f"{k} {x:.6g}" if isinstance(x, float) else f"{k} {x}"
            for k, x in row.items()), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    sets = []
    with out.open("a") as f:
        for s in range(args.sets):
            recs = []
            for seed in seeds:
                rec = _run(args.workload, seed, args.seconds, args.trace,
                           args.timeout)
                rec.update(workload=args.workload, set=s)
                f.write(json.dumps(rec) + "\n")
                f.flush()
                res = rec.get("result", {})
                checks = res.get("checks", {})
                print(f"set {s} seed {seed}: rc {rec['rc']} wall "
                      f"{rec['wall_s']:.1f} s correct {res.get('correct')} "
                      f"attempted {res.get('attempted')} " + json.dumps(
                          {k: v["value"] for k, v in
                           res.get("metrics", {}).items()}) +
                      f" checks {json.dumps(checks)}", flush=True)
                if "result" not in rec:
                    print(rec["stderr"][-1500:], flush=True)
                recs.append(rec)
            sets.append(recs)
    spreads = {}
    for s, recs in enumerate(sets):
        summ = _summary(f"set {s}", recs)
        for name, row in summ.items():
            if "spread" in row:
                spreads.setdefault(name, []).append(row["spread"])
    later = [r for recs in sets for r in recs][1:]
    _summary("all runs but the call's first", later)
    for name, sp in spreads.items():
        print(f"bound at 5x the wider spread, {name}: {5 * max(sp):.4f} "
              f"(spreads {', '.join(f'{x:.5f}' for x in sp)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
