"""Benchmark and profiling harness: tables of runs, and the MSD engine
timed one phase at a time.

Port of ``tpusort/utils/profiling.py``, the re-design of the reference's
benchmark framework (``msb/external/benchmark/benchmark.h:1-736``):
profiles are tables, runs are rows, metrics are columns
(``benchmark.h:11-29``), with typed data points, per-pass metric arrays
(``:666-727``, used as histo/pfx_sum/scatter/local_sort[pass] in
``gpu_radix_sort.h:266-269``), and table/CSV writers with min/max/avg
summaries (``:364-605``).  ``Run`` and ``Profile`` use no framework; they
are copied, not imported, so that the port stays apart from the JAX
package.

On the card the phases are timed with CUDA events
(:mod:`tpusort_torch.utils.timing`).  Run from the repository root:

    python3 -c "from tpusort_torch.utils.profiling import \\
        profile_msd_phases as p; print(p(1 << 28).table())"
"""

from __future__ import annotations

import csv
import io
import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpusort_torch.utils import timing

__all__ = ["Profile", "Run", "profile_msd_phases", "msd_phase_inputs",
           "run_msd_phases"]


@dataclass
class Run:
    """One row: a dict of metric -> value, plus per-pass metric arrays."""

    metrics: Dict[str, Any] = field(default_factory=dict)
    arrays: Dict[str, List[float]] = field(default_factory=dict)

    def set_metric(self, name: str, value) -> None:
        self.metrics[name] = value

    def push(self, name: str, value: float) -> None:
        """Append to a per-pass metric array (histo/scatter/... per pass)."""
        self.arrays.setdefault(name, []).append(value)

    @contextmanager
    def time_metric(self, name: str, *, per_pass: bool = False):
        """Host time of the block in ms (on a card: the time to enqueue
        it, unless the block synchronises)."""
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        if per_pass:
            self.push(name, dt * 1e3)
        else:
            self.metrics[name] = dt * 1e3


class Profile:
    """A named table of runs (BM_OPEN_PROFILE/BM_CLOSE_PROFILE analog)."""

    def __init__(self, name: str):
        self.name = name
        self.runs: List[Run] = []

    @contextmanager
    def run(self, **metrics):
        r = Run(dict(metrics))
        self.runs.append(r)
        yield r

    # ----- output (table/CSV/JSON writers + summaries) -----

    def _columns(self) -> List[str]:
        cols: List[str] = []
        for r in self.runs:
            for k in list(r.metrics) + [
                f"{a}[{i}]" for a, v in r.arrays.items() for i in range(len(v))
            ]:
                if k not in cols:
                    cols.append(k)
        return cols

    def _cell(self, r: Run, col: str):
        if col in r.metrics:
            return r.metrics[col]
        if "[" in col:
            a, i = col[:-1].split("[")
            vals = r.arrays.get(a, [])
            return vals[int(i)] if int(i) < len(vals) else ""
        return ""

    def table(self) -> str:
        cols = self._columns()
        rows = [[_fmt(self._cell(r, c)) for c in cols] for r in self.runs]
        summary = _summaries(self, cols)
        widths = [
            max(len(c), *(len(row[i]) for row in rows + summary))
            for i, c in enumerate(cols)
        ] if rows else [len(c) for c in cols]
        out = [f"== {self.name} =="]
        out.append(" | ".join(c.ljust(w) for c, w in zip(cols, widths)))
        out.append("-+-".join("-" * w for w in widths))
        for row in rows:
            out.append(" | ".join(v.ljust(w) for v, w in zip(row, widths)))
        if len(rows) > 1:
            out.append("-+-".join("-" * w for w in widths))
            for row in summary:
                out.append(" | ".join(v.ljust(w) for v, w in zip(row, widths)))
        return "\n".join(out)

    def csv(self) -> str:
        cols = self._columns()
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(cols)
        for r in self.runs:
            w.writerow([self._cell(r, c) for c in cols])
        return buf.getvalue()

    def json_lines(self) -> str:
        out = []
        for r in self.runs:
            d = dict(r.metrics)
            d.update({a: v for a, v in r.arrays.items()})
            out.append(json.dumps(d, default=str))
        return "\n".join(out)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)


def _summaries(p: Profile, cols: List[str]) -> List[List[str]]:
    rows = []
    for agg_name, agg in (("min", min), ("max", max),
                          ("avg", lambda v: sum(v) / len(v))):
        row = []
        for c in cols:
            vals = [
                p._cell(r, c) for r in p.runs
                if isinstance(p._cell(r, c), (int, float))
            ]
            row.append(_fmt(agg(vals)) + f" ({agg_name})" if vals else "")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Per-phase MSD profiling (the per-pass metric-array analog)
# ---------------------------------------------------------------------------


def msd_phase_inputs(keys: torch.Tensor, pairs: bool = False):
    """The per-phase engine's operands for 1-D ``keys``: the twiddled key
    planes and, with ``pairs``, the positions 0..n-1 as one value word,
    each padded to the plan's m1; the plan is ``plan_msd(n, 0, bits)`` at
    the JAX package's defaults (K 2^14, R 32).  Returns (operands, number
    of key planes, plan)."""
    from tpusort_torch import dtypes
    from tpusort_torch.ops import msd

    n = keys.shape[0]
    planes, traits = dtypes.twiddle_in(keys)
    plan = msd.plan_msd(n, 0, traits.bits)
    if plan is None:
        raise ValueError(f"no msd plan for n={n}")
    ops = list(planes)
    if pairs:
        ops.append(torch.arange(n, dtype=torch.int32, device=keys.device))
    return ([torch.nn.functional.pad(o, (0, plan.m1 - n)) for o in ops],
            len(planes), plan)


def run_msd_phases(
    ops: List[torch.Tensor], nplanes: int, n: int, plan,
    phase: Optional[Callable[[str, Callable], Any]] = None,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The MSD engine one phase at a time on :func:`msd_phase_inputs`'s
    operands (valid below ``n``): a ``_partition_pass`` a pass (the
    histogram, starts and sortkey, K8, the exchange), the leaf
    (``sort_segments``: K3 or K9) and the collapse (K4).  ``phase(name,
    fn)`` runs each phase's ``fn()`` and returns its result; the profiler
    times it there (``name``: "partition_ms", "leaf_ms" or
    "collapse_ms").  Returns (the dense (n,) outputs, one per operand, and
    the 0-d bool overflow flag on the device; with it set the outputs are
    not the sort)."""
    from tpusort_torch.kernels.collapse import collapse_segments
    from tpusort_torch.ops import msd

    if phase is None:
        def phase(name, fn):
            return fn()
    dev = ops[0].device
    run_counts = msd.initial_run_counts(n, plan, dev)
    s_prev = plan.passes[0].k
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for spec in plan.passes:
        ops, run_counts, ovf = phase(
            "partition_ms",
            lambda o=ops, rc=run_counts, sp=s_prev, spec=spec:
            msd._partition_pass(o, slice(0, nplanes), rc, sp, spec))
        overflow |= ovf
        s_prev = spec.s
    ctable, q = msd.counts_table(run_counts, s_prev)
    segs, seg_counts = phase(
        "leaf_ms", lambda: msd.sort_segments(list(ops), nplanes, ctable, q,
                                             plan))
    del ops, ctable
    outs = phase("collapse_ms",
                 lambda: collapse_segments(segs, seg_counts, n))
    return outs, overflow


def _device_name(dev: torch.device) -> str:
    return (f"{dev} {torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
            else str(dev))


def profile_msd_phases(n: int, *, dtype="uint32", pairs: bool = False,
                       seed: int = 0, fused_total: bool = True,
                       device=None) -> Profile:
    """Time each MSD engine phase apart on ``device`` (default the CUDA
    card; the CPU only when asked for): per pass the partition (histogram,
    starts and sortkey in plain PyTorch, K8, the exchange copy), then the
    leaf and the collapse.  The keys are ``random_keys`` of a numpy
    generator seeded with ``seed``; ``pairs`` adds their positions as a
    value.  Each phase is the best of 3 timed runs after a warm-up.

    The production path (``tpusort_torch.sort``) fuses what these phases
    keep apart (no sortkey or exchange copy), so treat them as an upper
    bound per phase: the tool for finding which pass to optimize, as the
    reference used its per-pass arrays (gpu_radix_sort.h:266-269).
    ``fused_total`` also times ``tpusort_torch.sort(keys,
    algorithm="msd")`` on the same device.  The run's metrics name the
    device and whether a run overflowed its capacity (the phases' output
    is then not the sort).
    """
    import tpusort_torch
    from tpusort_torch.utils import datagen

    dev = torch.device("cuda" if device is None else device)
    prof = Profile(f"msd_phases_n{n}_{dtype}{'_pairs' if pairs else ''}")
    keys = torch.from_numpy(
        datagen.random_keys(np.random.default_rng(seed), n, dtype)).to(dev)
    ops, nplanes, plan = msd_phase_inputs(keys, pairs)
    with prof.run(n=n, dtype=dtype, pairs=pairs, passes=len(plan.passes),
                  seg=plan.seg, device=_device_name(dev)) as r:

        def timed(name, fn):
            dt = timing.measure(fn, device=dev) * 1e3
            if name == "partition_ms":
                r.push(name, dt)
            else:
                r.set_metric(name, dt)
            return fn()

        _, overflow = run_msd_phases(ops, nplanes, n, plan, timed)
        del ops
        r.set_metric("overflow", bool(overflow))
        if fused_total:
            dt = timing.measure(
                lambda: tpusort_torch.sort(keys, algorithm="msd"),
                device=dev)
            r.set_metric("fused_total_ms", dt * 1e3)
            r.set_metric("keys_per_s", n / dt)
    return prof
