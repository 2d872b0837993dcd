"""What a traced stretch of whole calls holds, and the arithmetic the
per-layer metrics read from it.

``torch.profiler`` records every device operation (kernels, copies,
fills) and every host operation in one time base.  :func:`from_profiler`
keeps the operations inside the harness's span around the stretch;
:class:`Trace` sums device time by kernel name, merges the device's busy
intervals, and names each idle gap by the innermost host operation that
was running when it began.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

Op = Tuple[str, float, float]          # (name, start s, end s)

_GLOBAL_RE = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?"
    r"([A-Za-z_]\w*)\s*\(")


def global_names(csrc: Path) -> frozenset:
    """The ``__global__`` function names of the ``.cu`` files in ``csrc``."""
    names = set()
    for p in sorted(Path(csrc).glob("*.cu")):
        names.update(_GLOBAL_RE.findall(p.read_text()))
    return frozenset(names)


def name_matcher(kernels: Iterable[str]):
    """A predicate on trace names: whether one holds the name of one of
    ``kernels``, demangled (``void k<1>(...)``) or mangled
    (``_Z1kILi1E...``), not as the end of a longer name
    (``collapse_kernel`` does not match ``leaf_collapse_kernel``)."""
    kernels = sorted(kernels)
    if not kernels:
        return lambda name: False
    rx = re.compile(r"(?<![A-Za-z_])(?:%s)" % "|".join(map(re.escape, kernels)))
    return lambda name: rx.search(name) is not None


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class Trace:
    """A traced stretch of ``calls`` whole calls from ``t0`` to ``t1``
    (seconds), with the program's counters moved over it."""
    device_ops: List[Op]
    host_ops: List[Op]
    t0: float
    t1: float
    calls: int
    counters: Dict[str, int] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> List[Tuple[float, float]]:
        """The device's busy intervals, merged and cut to the window."""
        return [(max(a, self.t0), min(b, self.t1))
                for a, b in merge((a, b) for _, a, b in self.device_ops)
                if b > self.t0 and a < self.t1]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def device_s(self, pred) -> Optional[float]:
        """Summed device seconds of the operations whose name ``pred``
        accepts; None where it accepts none."""
        hit = [b - a for name, a, b in self.device_ops if pred(name)]
        return sum(hit) if hit else None

    def kernel_ms(self, kernels: Sequence[str]) -> Optional[float]:
        """Device ms per call of the kernels named ``kernels``; None where
        the trace holds none of them."""
        s = self.device_s(name_matcher(kernels))
        return None if s is None else s * 1e3 / self.calls

    def by_name(self) -> List[Tuple[str, float]]:
        """Device seconds summed by operation name, the largest first."""
        out: Dict[str, float] = {}
        for name, a, b in self.device_ops:
            out[name] = out.get(name, 0.0) + (b - a)
        return sorted(out.items(), key=lambda kv: -kv[1])

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle seconds of the window summed by what the host was doing
        when each gap began (the innermost host operation then running,
        or "harness" outside every one), the largest first."""
        edges = [self.t0]
        for a, b in self.busy():
            edges += [a, b]
        edges.append(self.t1)
        out: Dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            label = _innermost(self.host_ops, a)
            out[label] = out.get(label, 0.0) + (b - a)
        return sorted(out.items(), key=lambda kv: -kv[1])


def _innermost(host_ops: Sequence[Op], t: float) -> str:
    best = None
    for name, a, b in host_ops:
        if a <= t < b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return "harness" if best is None else best[0]


def from_profiler(prof, span: str, calls: int,
                  counters: Optional[Dict[str, int]] = None) -> Trace:
    """The :class:`Trace` of a ``torch.profiler`` run whose stretch the
    host span named ``span`` encloses.  Device operations are the events
    the profiler puts on the device (kernels, copies, fills), without
    user annotations; times become seconds."""
    device_ops, host_ops, window = [], [], None
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        on_device = e.device_type != torch.autograd.DeviceType.CPU
        if getattr(e, "is_user_annotation", False) or e.name == span:
            if not on_device and e.name == span:
                window = (a, b)
            continue
        (device_ops if on_device else host_ops).append((e.name, a, b))
    if window is None:
        raise RuntimeError(f"the trace holds no span {span!r}")
    return Trace(device_ops=device_ops, host_ops=host_ops, t0=window[0],
                 t1=window[1], calls=calls, counters=dict(counters or {}))
