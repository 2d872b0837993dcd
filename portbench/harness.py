"""One run of one cell: set-up, warm-up, the window, the check.

:func:`run_cell` makes the cell's pool of inputs on the device from the
seed, calls the program on each of them twice (the library build, the
plan and tier caches), and in a traced run (``trace=True``) traces one
stretch of two calls an input.  Then the window: a closed loop of one
caller, each call the next input of the pool, timed on the host clock from
the call to a ``synchronize()`` after it, until ``seconds`` have passed
and every input has been called.  For each input one of the window's
outputs is kept, drawn from the seed as the window goes (a reservoir of
one), so the check sees a call of the window for every input while the
memory held stays the same from call to call.  Once the window has closed
and the peak memory has been read, the pool is freed, each input is made
again from the seed, and the entry's check compares the kept output with
the plain reference (``reference.py``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import random
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

import torch

from portbench import trace as _trace

ROOT = Path(__file__).resolve().parent.parent
WARM_PASSES = 2          # calls of each pool input before the window
TRACED_PASSES = 2        # calls of each pool input in the traced stretch
SPAN = "portbench.stretch"
_NAME_CHARS = frozenset("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                        "0123456789_.-")


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    cfg: dict
    traffic: dict
    n: int
    entry: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class Window:
    """What the timed window saw."""
    call_s: List[float]
    keys: int
    seconds: float
    setup_s: float
    scratch_bytes: Optional[int]
    n: int


@dataclass
class Run:
    """What a metric reads: the window, and in a traced run the trace."""
    window: Window
    trace: Optional[_trace.Trace]
    job_bytes: int
    port_kernels: frozenset
    device_name: str


def _check_name(name: str) -> str:
    if not name or len(name) > 64 or not set(name) <= _NAME_CHARS or \
            name[0] in ".-":
        raise ValueError(f"bad name {name!r}")
    return name


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_file_module(path: Path, tag: str) -> ModuleType:
    """Import the Python file ``path`` as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        f"_portbench_{tag}_{abs(hash(str(path)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """The ``read(run)`` of ``portbench/metrics/<name>.py``."""
    return load_file_module(
        Path(root) / "portbench" / "metrics" / f"{_check_name(name)}.py",
        "metric").read


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``: its
    configuration's file, its traffic mix ``portbench/traffic/<mix>.json``,
    its entry ``portbench/entries/<entry>.py`` and the metrics it
    reports."""
    root = Path(root)
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" /
                          f"{_check_name(w['traffic'])}.json").read_text())
    entry = load_file_module(
        root / "portbench" / "entries" / f"{_check_name(cfg['entry'])}.py",
        "entry")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(name=workload, chips=int(w["chips"]), cfg=cfg,
                traffic=traffic, n=int(traffic.get("n", cfg["n"])),
                entry=entry,
                end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                per_layer=[m for m in spec["per_layer"] if mine(m)])


def _counters(program) -> Dict[str, int]:
    ops = getattr(program, "ops", None)
    msd = getattr(ops, "msd", None)
    fn = getattr(msd, "counters", None)
    return dict(fn()) if fn is not None else {}


def _port_kernels(program) -> frozenset:
    path = getattr(program, "__file__", None)
    if path is None:
        return frozenset()
    return _trace.global_names(Path(path).resolve().parent / "csrc")


def _traced_stretch(call, pool, sync, device, program) -> _trace.Trace:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    calls = TRACED_PASSES * len(pool)
    before = _counters(program)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN):
            for k in range(calls):
                out = call(pool[k % len(pool)])
                sync()
                del out
    after = _counters(program)
    moved = {k: after[k] - before.get(k, 0) for k in after}
    return _trace.from_profiler(prof, SPAN, calls, moved)


def _window(call, pool, kept, sync, seconds, seed, log):
    """The timed closed loop: calls in turn over the pool until
    ``seconds`` have passed and every input has been called.  Each
    input's slot of ``kept`` ends with one of its window's outputs, drawn
    from the seed.  Returns (each call's seconds, the calls that raised)."""
    pick = random.Random(seed)
    seen = [0] * len(pool)
    times: List[float] = []
    failed = 0
    start = time.perf_counter()
    while True:
        k = len(times)
        i = k % len(pool)
        t0 = time.perf_counter()
        try:
            out = call(pool[i])
            sync()
        except Exception as exc:      # counted as failed, the loop goes on
            out = None
            failed += 1
            log(f"call {k} failed: {exc!r}")
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if pick.randrange(seen[i] + 1) == 0:
            kept[i] = (k, out)
        seen[i] += 1
        del out
        if t1 - start >= seconds and len(times) >= len(pool):
            return times, failed


def _check_kept(cell: Cell, seed: int, device, kept, sync, log) -> dict:
    """Each kept output against the reference, its input made again from
    the seed: {name: {"value": summed over the inputs, "limit": l}}, with
    ``failed_calls`` counting the inputs that kept no output."""
    entry, cfg = cell.entry, cell.cfg
    totals: Dict[str, int] = {}
    missing = 0
    ref_s = 0.0
    for i in range(len(kept)):
        call_k, out = kept[i]
        kept[i] = None
        inp = entry.pool_input(cfg, cell.traffic, cell.n, seed, i, device)
        t0 = time.perf_counter()
        if out is None or call_k < 0:
            missing += 1
        else:
            for name, v in entry.check(cfg, inp, out).items():
                totals[name] = totals.get(name, 0) + v
        sync()
        ref_s += time.perf_counter() - t0
        del inp, out
    log(f"reference (stable torch.sort of int64 order keys, the gathers and "
        f"the comparison): {ref_s / len(kept) * 1e3:.3f} ms an input, "
        f"{len(kept)} inputs")
    checks = {name: {"value": v, "limit": entry.LIMITS[name]}
              for name, v in totals.items()}
    checks["failed_calls"] = {"value": missing, "limit": 0}
    return checks


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             device: torch.device, t_start: float, root: Path = ROOT,
             program=None, call: Optional[Callable] = None,
             log=lambda s: print(s, file=sys.stderr, flush=True)):
    """Run one cell once.  Returns (result dict, checks): the result's
    ``correct``, ``attempted``, ``failed``, ``metrics`` and ``device``
    (and in a traced run ``breakdown``), and each number compared as
    {name: {"value": v, "limit": l}}.  ``call(inp)`` stands in for the
    program's entry where given (the controls, the fault tests);
    ``t_start`` is the host clock at the process's start, from which
    ``setup_s`` counts."""
    cell = load_cell(workload, root)
    if program is None:
        program = importlib.import_module("tpusort_torch")
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    entry, cfg = cell.entry, cell.cfg
    if call is None:
        def call(inp):
            return entry.call(program, cfg, inp)
    loop = cell.traffic.get("loop", {"kind": "closed", "callers": 1})
    if loop != {"kind": "closed", "callers": 1}:
        raise ValueError(f"unsupported loop {loop!r}")
    pool_n = int(cell.traffic.get("pool", 4))

    pool = [entry.pool_input(cfg, cell.traffic, cell.n, seed, i, device)
            for i in range(pool_n)]
    kept: List[Optional[tuple]] = [None] * pool_n
    for _ in range(WARM_PASSES):
        for i, inp in enumerate(pool):
            kept[i] = (-1, call(inp))
            sync()
    tr = _traced_stretch(call, pool, sync, device, program) if traced else None
    gc.collect()

    if on_card:
        sync()
        peak_setup = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    start = time.perf_counter()
    times, failed = _window(call, pool, kept, sync, seconds, seed, log)
    window_s = time.perf_counter() - start
    scratch = peak = None
    if on_card:
        peak_window = torch.cuda.max_memory_allocated()
        scratch = peak_window - held
        peak = max(peak_setup, peak_window)
    k = len(times)
    window = Window(call_s=times, keys=(k - failed) * cell.n,
                    seconds=window_s, setup_s=start - t_start,
                    scratch_bytes=scratch, n=cell.n)

    del pool
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = _check_kept(cell, seed, device, kept, sync, log)
    checks["failed_calls"]["value"] += failed
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    device_name = torch.cuda.get_device_name(device) if on_card else "cpu"
    run = Run(window=window, trace=tr,
              job_bytes=entry.job_bytes(cfg, cell.n),
              port_kernels=_port_kernels(program), device_name=device_name)
    specs = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in specs:
        v = metric_reader(m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": device_name,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": k, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = {
            "device_ops": [[n[:120], s] for n, s in tr.by_name()[:10]],
            "idle_gaps": [[n[:120], s] for n, s in tr.idle_gaps()[:10]]}
        _log_accounting(run, log)
    result["checks"] = checks
    return result, checks


def _log_accounting(run: Run, log) -> None:
    """Whether the kernels the layer metrics name and the glue account for
    the device's busy time of a call."""
    tr = run.trace
    busy = tr.busy_s() * 1e3 / tr.calls
    ops = tr.device_s(lambda name: True) or 0.0
    log(f"trace: {tr.calls} calls in {tr.window_s:.6f} s; device busy "
        f"{busy:.6f} ms a call, operations {ops * 1e3 / tr.calls:.6f} ms a "
        f"call; counters moved: "
        f"{ {k: v for k, v in tr.counters.items() if v} }")
