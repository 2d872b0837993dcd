"""Time the same calls in two trees of this repository against each other,
in turns, in one process on one CUDA card.

    python3 tools/ab.py OTHER THIS [CASE ...]

OTHER and THIS are repository roots, for example the parent commit
(``git archive`` unpacked under ``build/``, which git ignores) and ``.``.
Each tree's own ``tpusort_torch`` is imported from its root and builds its
kernels under its own ``build/``.  While a tree's call runs, its modules
are the ones in ``sys.modules``, so the imports its functions make at call
time find its own.  Nothing of either tree is copied here: a case calls
each tree's public wrapper, whose contract both trees share, on inputs
that THIS makes once.

Cases (all of them by default; name some to run only those):

- ``k1``: K1 and K1b (``partition_pass_fused``) on the inputs of every
  pass (pass 0, on the runs body, and passes 1 and 2, which arrive as
  sorted runs) that THIS tree's ``sort`` and stable ``sort_pairs`` of
  2^28 uniform and entropy-3 keys and ``sort`` of 2^27 uniform uint64
  keys make (the benchmark's five K1 and K1b cells), a traced call's
  device time and each tree's mode tags beside each;
- ``k2``: K2 (``sort_tiles_counts_collapsed``) on the leaf inputs that
  THIS tree's ``sort`` and stable ``sort_pairs`` of 2^28 uniform and
  entropy-3 keys hand ``msd.raw_leaf`` (the benchmark's four 32-bit
  cells): each tree's ``raw_leaf``, then K2 at each tree's leaf tiles,
  a traced call's device time beside each;
- ``k8``: K8 (``partition_tiles``) at the 2^28 per-phase plan's passes 0
  and 1, keys and key + value;
- ``k1c``: K1c (``partition_pass_fused``, general) at pass 0 of the 2^28
  general plans of ``sort_pairs(end_bit=24)`` and ``sort(begin_bit=8)``;
- ``k6``: K6 (``digit_histogram_tiles``) at 2^28 in ``chip_smoke.py``'s
  ten modes (uniform, constant, presorted, alternating and Zipf 1.1 keys
  at several digit widths): one call, 20 calls back to back, and each
  tree in turns with plain and ``torch.bincount`` with a traced call;
- ``k4``: K4 (``collapse_segments``) at those plans' packed leaves (2^28 -
  12345 keys), at the global sort's collapse finish ((8, capacity)
  segments holding 2^25 words) and at (64, 2^21);
- ``leaf``: the general path's narrow leaf (``msd._leaf_sort``) on the
  last K1c pass's runs of those plans: each tree's leaf (the parent's
  rows, K3 and K4, or K3's runs body), a traced call's device time by
  kernel and each tree's mode tags beside it;
- ``walls``: the host walls of ``sort_pairs(end_bit=24)`` at 2^28 and of
  the 2^28 global sort over 8 in-process shards with the collapse finish;
- ``phases``: ``profile_msd_phases(2^28)``, once a tree in the order
  OTHER, THIS, THIS, OTHER.

A kernel row is the median of 5 CUDA-event times of the wrapper call, in
turns whose order reverses every round (OTHER, THIS, THIS, OTHER), after
one warm-up each.  A K4 or K6 row adds, for each tree, the same call
timed in turns with its plain version and its PyTorch call, as
``chip_smoke.py`` times it, and the device time by kernel of one traced
call (traced again, up to three times, if the trace caught no kernel); a
K6 row also 20 calls queued between two events.  A wall row
is the median of 9 host walls, each ending in a synchronize.  The card's
name and power limit head the output.  It fails without a CUDA card.
"""

from __future__ import annotations

import contextlib
import importlib
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

PKG = "tpusort_torch"
CASES = ("k1", "k2", "k8", "k1c", "k6", "k4", "leaf", "walls", "phases")
REPS = 5
WALL_REPS = 9            # host walls spread more than CUDA-event times
BATCH = 20               # calls queued between two events (short calls)
SEED = 20261016
MAIN_N = 1 << 28
RAGGED_N = MAIN_N - 12345
U64_N = 1 << 27          # the keys64.uniform cell's call


def _take_package() -> dict:
    """Remove the package's modules from ``sys.modules``; return them."""
    names = [k for k in sys.modules if k == PKG or k.startswith(PKG + ".")]
    return {k: sys.modules.pop(k) for k in names}


class Tree:
    """One tree's ``tpusort_torch``, imported from the tree's root."""

    def __init__(self, root: str, label: str):
        self.root, self.label = Path(root).resolve(), label
        outside = _take_package()
        sys.path.insert(0, str(self.root))
        importlib.invalidate_caches()
        try:
            pkg = importlib.import_module(PKG)
            if self.root not in Path(pkg.__file__).resolve().parents:
                raise SystemExit(f"ab: {root} holds no {PKG}")
        finally:
            sys.path.remove(str(self.root))
            self._modules = _take_package()
            sys.modules.update(outside)

    @contextlib.contextmanager
    def active(self):
        """This tree's modules in ``sys.modules`` for the block."""
        outside = _take_package()
        sys.modules.update(self._modules)
        try:
            yield self
        finally:
            self._modules = _take_package()   # with what the block imported
            sys.modules.update(outside)

    def mod(self, name: str):
        """The tree's ``tpusort_torch.<name>``; call it inside active()."""
        return importlib.import_module(f"{PKG}.{name}")


def _event_ms(fn) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _batch_ms(fn) -> float:
    """CUDA-event ms a call of ``BATCH`` calls queued back to back: the
    card does not wait on the host between them, as it does before a
    single call."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(BATCH):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / BATCH


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _fmt(ts) -> str:
    return f"{statistics.median(ts):.3f} [{min(ts):.3f}..{max(ts):.3f}]"


class Bench:
    """The two trees, the card's name, and the ways to time a call.  A
    call is given as ``make(tree)``, which returns the tree's thunk."""

    def __init__(self, other: Tree, this: Tree, card: str):
        self.trees, self.other, self.this, self.card = \
            (other, this), other, this, card
        with this.active():
            self.device_ms_by_name = \
                this.mod("utils.profile_calls")._device_ms_by_name

    def print(self, line: str) -> None:
        print(f"{line} on {self.card}", flush=True)

    def alternate(self, make, clock, reps: int = REPS) -> dict:
        """{label: times}: one warm-up each, then ``reps`` rounds in turns
        whose order reverses every round."""
        acc = {t.label: [] for t in self.trees}
        for t in self.trees:
            with t.active():
                make(t)()
        for i in range(reps):
            for t in (self.trees if i % 2 == 0 else self.trees[::-1]):
                with t.active():
                    fn = make(t)
                    acc[t.label].append(clock(fn))
        return acc

    def row(self, name: str, make, clock=_event_ms, reps: int = REPS):
        try:
            acc = self.alternate(make, clock, reps)
        except RuntimeError as e:        # report it, and go on to the next
            print(f"ab: {name}: failed: {e}", flush=True)
            return
        o, t = acc[self.other.label], acc[self.this.label]
        self.print(f"ab: {name}: other {_fmt(o)} ms, this {_fmt(t)} ms, "
                   f"this / other "
                   f"{statistics.median(t) / statistics.median(o):.3f}")

    def with_plain(self, name: str, make, plain, library) -> None:
        """Each tree's call timed in turns with its plain version and the
        library call (``make(tree)`` and ``plain(tree)`` give thunks), in
        ``chip_smoke.py``'s order, then one traced call's device time by
        kernel."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        for t in self.trees:
            with t.active():
                fns = [make(t), plain(t), library]
                for fn in fns:
                    fn()
                acc = [[] for _ in fns]
                for i in range(REPS):
                    order = list(zip(fns, acc))[::-1]
                    for fn, a in (order if i % 2 == 0 else order[::-1]):
                        a.append(_event_ms(fn))
                fn = fns[0]
                torch.cuda.synchronize()
                for _ in range(3):     # again if the trace lost the kernels
                    with torch.profiler.profile(activities=acts) as prof:
                        fn()
                        torch.cuda.synchronize()
                    by_name = sorted(self.device_ms_by_name(prof).items(),
                                     key=lambda kv: -kv[1])
                    if by_name:
                        break
            self.print(
                f"ab: {name} {t.label}, in turns with plain and library: "
                f"{_fmt(acc[0])} ms (plain {_fmt(acc[1])}); traced: device "
                f"{sum(ms for _, ms in by_name):.3f} ms: "
                + "; ".join(f"{k[:60]} {ms:.3f}" for k, ms in by_name))


def _rand(n: int, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                         device=gen.device, generator=gen)


def _leaf_inputs(this: Tree, call) -> list:
    """The arguments of every ``msd.raw_leaf`` call ``call`` makes in
    THIS tree (its public entry runs the passes before the leaf)."""
    seen = []
    msd = this.mod("ops.msd")
    real = msd.raw_leaf

    def spy(*args):
        seen.append(args)
        return real(*args)

    msd.raw_leaf = spy
    try:
        call()
    finally:
        msd.raw_leaf = real
    return seen


def _pass_inputs(this: Tree, call) -> list:
    """(planes, values, counts_in, keyword arguments) of every K1 and K1b
    call that ``call`` makes in THIS tree through the engines' partition
    passes (``ops.msd.run_passes``, the equi-depth pipeline)."""
    seen = []
    mods = [this.mod("ops.msd"), this.mod("ops.equidepth")]
    real = mods[0].partition_pass_fused

    def spy(planes, values, counts_in, **kw):
        seen.append((planes, values, counts_in, kw))
        return real(planes, values, counts_in, **kw)

    for m in mods:
        m.partition_pass_fused = spy
    try:
        call()
    finally:
        for m in mods:
            m.partition_pass_fused = real
    return seen


def _device_row(b: Bench, row: str, make) -> None:
    """Each tree's traced device ms of one call (its largest kernel) and
    the mode tags of its launches."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for t in b.trees:
        with t.active():
            fn = make(t)
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            by_name = b.device_ms_by_name(prof)
            modes = t.mod("ops.msd")
            modes.reset_counters()
            fn()
            tags = modes.mode_counters()
        b.print(f"ab: {row} {t.label}: traced device "
                + "; ".join(f"{k[:70]} {ms:.3f}"
                            for k, ms in sorted(by_name.items(),
                                                key=lambda kv: -kv[1])[:1])
                + f"; modes {tags}")


def case_k1(b: Bench, gen: torch.Generator) -> None:
    x = _rand(MAIN_N, gen)
    e3 = x & _rand(MAIN_N, gen) & _rand(MAIN_N, gen)
    ids = torch.arange(MAIN_N, dtype=torch.int32, device=gen.device)
    u64 = x[:U64_N * 2].view(torch.uint64)
    for name, keys, vals in (("keys uniform", x, None),
                             ("pairs uniform", x, ids),
                             ("keys entropy-3", e3, None),
                             ("pairs entropy-3", e3, ids),
                             ("u64 keys uniform", u64, None)):
        with b.this.active():
            api = b.this.mod("api")
            u = keys if keys.dtype == torch.uint64 else keys.view(
                torch.uint32)
            call = (lambda: api.sort(u)) if vals is None else \
                (lambda: api.sort_pairs(u, vals))
            call()                           # the tier cache, warm
            # the sort's own passes (not the skew tier's sample sort)
            seen = [a for a in _pass_inputs(b.this, call)
                    if a[0][0].numel() >= u.numel()]
        for j, (planes, values, cin, kw) in enumerate(seen):
            T, K = planes[0].shape
            what = "K1b" if kw.get("splitters") is not None else "K1"
            row = (f"{what} {name} pass {j} {len(planes)} planes + "
                   f"{len(values)} values ({T}, {K}) q {kw['q_in']} "
                   f"sorted_run {kw['sorted_run']} S {kw['s']}")

            def make(tr, planes=planes, values=values, cin=cin, kw=kw):
                fn = tr.mod("kernels.partition").partition_pass_fused
                return lambda: fn(planes, values, cin, **kw)

            b.row(row, make)
            _device_row(b, row, make)
        del seen
        torch.cuda.empty_cache()


def case_k2(b: Bench, gen: torch.Generator) -> None:
    acts = [torch.profiler.ProfilerActivity.CUDA]
    x = _rand(MAIN_N, gen)
    e3 = x & _rand(MAIN_N, gen) & _rand(MAIN_N, gen)
    ids = torch.arange(MAIN_N, dtype=torch.int32, device=gen.device)
    for name, keys, vals in (("keys uniform", x, None),
                             ("pairs uniform", x, ids),
                             ("keys entropy-3", e3, None),
                             ("pairs entropy-3", e3, ids)):
        with b.this.active():
            api = b.this.mod("api")
            u = keys.view(torch.uint32)
            call = (lambda: api.sort(u)) if vals is None else \
                (lambda: api.sort_pairs(u, vals))
            call()                           # the tier cache, warm
            # the sort's own leaf (the skew tier's sample sort has one too)
            args = max(_leaf_inputs(b.this, call), key=lambda a: a[5])
        data, ctable, q, plan, nk, n = args
        nv = len(data) - nk
        run = plan.passes[-1].s & -plan.passes[-1].s
        b.row(f"raw_leaf {name} 2^28 (each tree's tiles)",
              lambda tr: lambda: tr.mod("ops.msd").raw_leaf(
                  data, ctable, q, plan, nk, n))
        shapes = set()
        for t in b.trees:
            with t.active():
                shapes.add(t.mod("ops.msd").leaf_tiles(plan, nk, nv > 0))
        for nt, tile in sorted(shapes):
            tiles = [o.reshape(nt, tile) for o in data]
            ct = ctable.reshape(nt, tile // q)
            row = (f"K2 {name} {nk} planes + {nv} values ({nt}, {tile}) q "
                   f"{q} sorted_run {run}")

            def make(tr):
                fn = tr.mod("kernels.bitonic").sort_tiles_counts_collapsed
                return lambda: fn(tiles, ct, q, n, sorted_run=run,
                                  num_keys=nk)

            b.row(row, make)
            for t in b.trees:
                with t.active():
                    fn = make(t)
                    fn()
                    torch.cuda.synchronize()
                    with torch.profiler.profile(activities=acts) as prof:
                        fn()
                        torch.cuda.synchronize()
                    by_name = b.device_ms_by_name(prof)
                    modes = t.mod("ops.msd")
                    modes.reset_counters()
                    fn()
                    tags = modes.mode_counters()
                b.print(f"ab: {row} {t.label}: traced device "
                        + "; ".join(f"{k[:70]} {ms:.3f}"
                                    for k, ms in sorted(by_name.items(),
                                                        key=lambda kv: -kv[1])
                                    [:1])
                        + f"; modes {tags}")
            del tiles, ct
        del data, ctable, args
        torch.cuda.empty_cache()


def case_k8(b: Bench, gen: torch.Generator) -> None:
    this = b.this
    with this.active():
        msd = this.mod("ops.msd")
        x = _rand(MAIN_N, gen).view(torch.uint32)
        vals = _rand(MAIN_N, gen)
        x_ops, x_np, plan = this.mod("utils.profiling").msd_phase_inputs(x)
        sp0 = plan.passes[0]
        rc0 = msd.initial_run_counts(MAIN_N, plan, gen.device)
    for name, data in (("keys", []), ("key+value", [vals])):
        with this.active():
            ops0 = [*x_ops, *(torch.nn.functional.pad(d, (0, plan.m1 - MAIN_N))
                              for d in data)]
            ops1, rc1, _ = msd._partition_pass(ops0, slice(0, 1), rc0, sp0.k,
                                               sp0)
        for label, ops_, rc, s_prev, spec in (
                ("pass 0", ops0, rc0, sp0.k, sp0),
                ("pass 1", ops1, rc1, sp0.s, plan.passes[1])):
            t = spec.n_seg * spec.t_seg
            tiled = [o.reshape(t, spec.k) for o in ops_]
            with this.active():
                sortkey, starts, _ = msd.pass_sortkey(tiled[:x_np], rc,
                                                      s_prev, spec)
            b.row(f"K8 {label} {name} ({t}, {spec.k}) S {spec.s}",
                  lambda tr: lambda: tr.mod("kernels.partition")
                  .partition_tiles([sortkey, *tiled], starts, r=spec.r,
                                   s=spec.s))
            del tiled, sortkey, starts
        del ops0, ops1, rc1


def _general_plan(this: Tree, cfg_row, begin_bit: int, end_bit: int):
    kw = this.mod("configs").get_config(*cfg_row, "cuda").plan_kwargs()
    kw.pop("min_n")
    return this.mod("ops.msd").plan_msd(RAGGED_N, begin_bit, end_bit,
                                        leaf_profile="packed", **kw)


GENERAL = (("key+value", (32, True), (0, 24), 1),
           ("key", (32, False), (8, 32), 0))


def case_k1c(b: Bench, gen: torch.Generator) -> None:
    for name, cfg_row, bits, nv in GENERAL:
        with b.this.active():
            gp = _general_plan(b.this, cfg_row, *bits)
        s0 = gp.passes[0]
        t0 = s0.n_seg * s0.t_seg
        tiles = [_rand(gp.m1, gen).reshape(t0, s0.k) for _ in range(1 + nv)]
        kw = dict(r=s0.r, s=s0.s, lo_bit=s0.lo_bit, width=s0.width,
                  n=RAGGED_N, q_in=None, t_seg=s0.t_seg)
        b.row(f"K1c pass 0 {name} ({t0}, {s0.k}) S {s0.s}",
              lambda tr: lambda: tr.mod("kernels.partition")
              .partition_pass_fused(tiles[:1], tiles[1:], None, general=True,
                                    **kw))
        del tiles


def case_k6(b: Bench, gen: torch.Generator) -> None:
    dev = gen.device
    x = _rand(MAIN_N, gen)
    sign = -(1 << 31)
    word = torch.tensor(0x3C5A96F0, dtype=torch.int32, device=dev)
    with b.this.active():
        zipf = b.this.mod("utils.datagen").zipf_keys_torch(gen, MAIN_N)
    keys = {"uniform": x,
            "constant": torch.full_like(x, 0x12345678),
            "presorted": torch.sort(x ^ sign).values ^ sign,
            "alternating": torch.where(
                torch.arange(MAIN_N, device=dev) % 2 == 1, ~word, word),
            "Zipf 1.1": zipf}
    for name, shift, bits in (
            ("uniform", 24, 8), ("constant", 24, 8), ("uniform", 27, 5),
            ("uniform", 0, 3), ("uniform", 31, 1), ("constant", 0, 3),
            ("presorted", 24, 8), ("presorted", 0, 8),
            ("alternating", 24, 8), ("Zipf 1.1", 0, 8)):
        k = keys[name].view(torch.uint32)
        row = f"K6 {name} ({shift}, {bits}) 2^28"

        def make(tr):
            fn = tr.mod("kernels.scanhist").digit_histogram_tiles
            return lambda: fn(k, shift, bits)

        def plain(tr):
            fn = tr.mod("kernels.scanhist").digit_histogram_tiles_plain
            return lambda: fn(k, shift, bits)

        ki = keys[name]
        b.row(row, make)
        b.row(f"{row}, {BATCH} calls back to back, a call", make, _batch_ms)
        b.with_plain(row, make, plain,
                     lambda: torch.bincount((ki >> shift) & ((1 << bits) - 1),
                                            minlength=1 << bits))
    del keys, x, zipf


def _k4_rows(b: Bench, name: str, segs, counts, n_out: int) -> None:
    def make(tr):
        fn = tr.mod("kernels.collapse").collapse_segments
        return lambda: fn(segs, counts, n_out)

    def plain(tr):
        fn = tr.mod("kernels.collapse").collapse_segments_plain
        return lambda: fn(segs, counts, n_out)

    def library():
        keep = torch.arange(segs[0].shape[1], device=counts.device)[None, :] \
            < counts[:, None]
        return [o[keep] for o in segs]

    b.row(name, make)
    b.with_plain(name, make, plain, library)


def case_k4(b: Bench, gen: torch.Generator) -> None:
    dev = gen.device
    for name, cfg_row, bits, nv in GENERAL:
        with b.this.active():
            msd = b.this.mod("ops.msd")
            gp = _general_plan(b.this, cfg_row, *bits)
            ops = [_rand(gp.m1, gen) for _ in range(1 + nv)]
            data, (ctable, q), _ = msd.run_passes(ops, 1, RAGGED_N, gp,
                                                  general=True)
            del ops
            rows, seg_counts = msd.packed_leaf_rows(data, 1, ctable, q, gp)
            segs = [o.reshape(gp.n_segments, gp.seg) for o in rows[1:]]
            del data, rows
        _k4_rows(b, f"K4 {len(segs)} operand(s) ({gp.n_segments}, {gp.seg})",
                 segs, seg_counts, RAGGED_N)
        del segs, seg_counts
    d, shard = 8, MAIN_N // 8
    with b.this.active():
        par = b.this.mod("parallel")
        gs = par.make_global_sort(par.InProcessComm(d, dev), finish="collapse")
        gs(_rand(MAIN_N, gen).view(torch.uint32))
        cap = max(g[-1] for g in gs._shard_fns)
        del gs
    segs = [_rand(d * cap, gen).reshape(d, cap)]
    counts = torch.full((d,), shard // d, dtype=torch.int32, device=dev) \
        + torch.randint(-4096, 4097, (d,), dtype=torch.int32, device=dev,
                        generator=gen)
    counts[-1] = shard - int(counts[:-1].sum())
    _k4_rows(b, f"K4c ({d}, {cap}) 1 operand", segs, counts, shard)
    segs = [_rand(64 << 21, gen).reshape(64, 1 << 21) for _ in range(2)]
    counts = torch.randint(0, (1 << 21) + 1, (64,), dtype=torch.int32,
                           device=dev, generator=gen)
    _k4_rows(b, "K4c (64, 2^21) 2 operands", segs, counts,
             int(counts.sum()) - 1000)


def case_leaf(b: Bench, gen: torch.Generator) -> None:
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for name, cfg_row, bits, nv in GENERAL:
        with b.this.active():
            msd = b.this.mod("ops.msd")
            gp = _general_plan(b.this, cfg_row, *bits)
            ops = [_rand(gp.m1, gen) for _ in range(1 + nv)]
            data, (ctable, q), _ = msd.run_passes(ops, 1, RAGGED_N, gp,
                                                  general=True)
            del ops
        row = (f"general leaf {name} ({gp.n_segments}, {gp.seg}) q {q}, "
               f"bits {bits}")

        def make(tr):
            fn = tr.mod("ops.msd")._leaf_sort
            return lambda: fn(list(data), 1, ctable, q, gp, RAGGED_N)

        b.row(row, make)
        for t in b.trees:
            with t.active():
                fn = make(t)
                fn()
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=acts) as prof:
                    fn()
                    torch.cuda.synchronize()
                by_name = sorted(b.device_ms_by_name(prof).items(),
                                 key=lambda kv: -kv[1])
                modes = t.mod("ops.msd")
                modes.reset_counters()
                fn()
                tags = modes.mode_counters()
            b.print(f"ab: {row} {t.label}: traced device "
                    f"{sum(ms for _, ms in by_name):.3f} ms: "
                    + "; ".join(f"{k[:60]} {ms:.3f}" for k, ms in by_name)
                    + f"; modes {tags}")
        del data, ctable
        torch.cuda.empty_cache()


def case_walls(b: Bench, gen: torch.Generator) -> None:
    dev = gen.device
    x = _rand(MAIN_N, gen).view(torch.uint32)
    vals = _rand(MAIN_N, gen).view(torch.uint32)
    sorts = {}
    for t in b.trees:
        with t.active():
            par = t.mod("parallel")
            sorts[t.label] = par.make_global_sort(par.InProcessComm(8, dev),
                                                  finish="collapse")
    b.row("global_sort u32 2^28, 8 in-process shards, collective + collapse "
          "(wall)", lambda tr: lambda: sorts[tr.label](x), _wall_ms,
          WALL_REPS)
    del sorts
    b.row("sort_pairs(end_bit=24) u32 + u32 2^28 (wall)",
          lambda tr: lambda: tr.mod("api").sort_pairs(x, vals, end_bit=24),
          _wall_ms, WALL_REPS)


def case_phases(b: Bench, gen: torch.Generator) -> None:
    torch.cuda.empty_cache()
    for t in (b.other, b.this, b.this, b.other):
        with t.active():
            m = t.mod("utils.profiling").profile_msd_phases(MAIN_N).runs[0]
        b.print(f"ab: profile_msd_phases(2^28) {t.label}: partition_ms "
                f"{[round(v, 3) for v in m.arrays['partition_ms']]}, leaf_ms "
                f"{m.metrics['leaf_ms']:.3f}, collapse_ms "
                f"{m.metrics['collapse_ms']:.3f}, fused_total_ms "
                f"{m.metrics['fused_total_ms']:.3f}")


def main(argv) -> None:
    if not torch.cuda.is_available() or len(argv) < 2 \
            or any(c not in CASES for c in argv[2:]):
        raise SystemExit(f"usage: python3 tools/ab.py OTHER THIS "
                         f"[{' '.join(CASES)}] (needs a CUDA card)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    b = Bench(Tree(argv[0], "other"), Tree(argv[1], "this"), card)
    gen = torch.Generator(device=torch.device("cuda", 0))
    gen.manual_seed(SEED)
    for name in argv[2:] or CASES:
        globals()[f"case_{name}"](b, gen)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
