"""Distributed global sort: d shards, exact splitters, one exchange.

PyTorch port of ``tpusort/parallel/global_sort.py``.  Each shard sorts its
keys locally, the shards agree on the d - 1 exact global order statistics
at ranks b * n_shard (one bit of the key a round: a count, summed across
shards), every shard cuts its sorted keys at them (keys equal to a
splitter are spread over shards by their global tie rank, so even one
repeated value balances exactly), the runs travel all-to-all in windows
padded to a fixed capacity, and each shard finishes its received runs into
its n_shard sorted keys.  Shard r of d then holds global ranks
[r * n_shard, (r + 1) * n_shard).

The shard body is written against a communicator (``parallel.comm``):
:class:`~tpusort_torch.parallel.comm.InProcessComm` runs d shards on one
device in one process (the sorter takes and returns the whole (n,) tensor,
as JAX's sharded array), :class:`~tpusort_torch.parallel.comm.ProcessGroupComm`
one shard a process of a ``torch.distributed`` group (the sorter takes and
returns this process's shard).  Where JAX branches inside the graph
(``lax.cond``), the host reads: the (d, d) count matrix once, after it is
gathered, gives every shard the same overflow decision and the slice
offsets of the exchange, and a windows finish reads its own overflow flag.

* ``exchange="collective"``: the communicator's all-to-all, in ``chunks``
  pieces along the capacity axis.  ``exchange="rdma"``: K7
  (``parallel.ring``), the port of the TPU's remote-DMA kernel, in-process
  only.
* ``finish="collapse"``: the received runs are compacted (K4, at the
  chunked collapse K4c's shape) and sorted by the engine, which reads them
  in strided tiles (JAX's reads contiguous tiles of the d ascending runs,
  which fall into a few digits each: its finish overflows and takes its
  exact fallback).  ``finish="windows"``: the received runs are sorted
  already, so they feed the engine's passes directly
  (``ops.msd.sort_windows_msd``: pass 0 emits only, the leaf writes the
  dense shard); a window longer than one engine tile overflows that pass
  for the same reason, and the shard then compacts and sorts exactly.
  ``"auto"`` takes windows on a card where a plan exists and the expected
  window (n_shard / d keys) fits one tile, else collapse; on the CPU
  collapse, as JAX resolves it off the TPU.
* The finish spreads the shard's key range over the whole 32-bit domain
  first (plane 0 of 64-bit keys), so its leading digits are uniform.
* A pair count above the capacity (presorted input at a small
  ``capacity_factor``) skips the exchange: every shard gathers the sorted
  shards and sorts the runs destined to it exactly (JAX gathers and sorts
  all n keys on every shard and keeps its slice: the same keys).
  ``adaptive=True`` then doubles the geometry's factor for later calls.

Keys are 32-bit (one plane) or 64-bit (two planes); payloads 32- or
64-bit.  Pairs are unstable across shards: keys bit-exact, payloads a
permutation within equal keys (``tpusort/parallel/global_sort.py:41-43``).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tpusort_torch import configs as _configs
from tpusort_torch import dtypes as _dtypes
from tpusort_torch.kernels.collapse import collapse_segments
from tpusort_torch.ops import msd as _msd
from tpusort_torch.ops.reference import sort_twiddled_reference
from tpusort_torch.ops.tiers import first_clear
from tpusort_torch.parallel.comm import InProcessComm, ProcessGroupComm
from tpusort_torch.utils.log import host_read, spanned

__all__ = ["global_sort", "make_global_sort", "make_global_sort_planes"]

_HI = 1 << 31


def _u32(p: torch.Tensor) -> torch.Tensor:
    """An int32 bit-pattern plane as its unsigned values, int64."""
    return p.to(torch.int64) & 0xFFFFFFFF


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 bit patterns."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _composite(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """One int64 whose order is the unsigned lexicographic order of 1 or 2
    words (unsigned values as int64): w0, or (w0 - 2^31) * 2^32 + w1."""
    if len(words) == 1:
        return words[0]
    w0, w1 = words
    return ((w0 - _HI) << 32) | w1


def _select_splitters(comm, comp: torch.Tensor, nplanes: int,
                      n_shard: int) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The exact order statistics at global ranks b * n_shard (b = 1..d-1)
    of every shard's keys, and how many keys lie strictly below each.

    ``comp``: this shard's keys, sorted, as :func:`_composite` of their
    planes.  A radix selection, one plane at a time, most significant
    first, 16 bits a round: each round counts, for each boundary, the keys
    whose finished planes and bits equal the boundary's and whose next 16
    bits take each of their 2^16 values, sums the counts across shards, and
    takes the value in whose bucket the boundary's rank falls.  JAX takes
    one bit a round (32 a plane), each counted with an (n, d-1) compare and
    a match mask; on a sorted shard each bucket is one interval, so a round
    is one binary search of its edges, and 2 rounds a plane keep the
    meetings of the shards few (each costs the host more than the search
    costs the card).  Returns (splitter words a plane, each (d-1,) int32;
    below, (d-1,) int64)."""
    d = comm.size
    dev = comp.device
    rank = torch.arange(1, d, dtype=torch.int64, device=dev)[:, None] \
        * n_shard
    below = torch.zeros((d - 1, 1), dtype=torch.int64, device=dev)
    digit = torch.arange(1 << 16, dtype=torch.int64, device=dev)
    words: List[torch.Tensor] = []
    for p in range(nplanes):
        prefix = torch.zeros((d - 1, 1), dtype=torch.int64, device=dev)
        rest = nplanes - 1 - p
        for shift in (16, 0):
            # bucket c starts at the composite of the finished words,
            # (prefix << 16 | c) << shift and zeros; the last ends at the
            # last key of bucket 2^16 - 1
            w = ((prefix << 16) | digit) << shift
            start = _composite([*(x.expand_as(w) for x in words), w,
                                *[torch.zeros_like(w)] * rest])
            end = _composite([*words, (((prefix << 16) | 0xFFFF) << shift)
                              | ((1 << shift) - 1),
                              *[torch.full_like(prefix, 0xFFFFFFFF)] * rest])
            at = torch.cat([torch.searchsorted(comp, start.reshape(-1))
                            .reshape(d - 1, 1 << 16),
                            torch.searchsorted(comp, end, right=True)], 1)
            counts = comm.all_reduce_sum(at[:, 1:] - at[:, :-1])
            upto = torch.cumsum(counts, 1)
            c = (upto <= rank - below).sum(1, keepdim=True)
            below = below + upto.gather(1, c) - counts.gather(1, c)
            prefix = (prefix << 16) | c
        words.append(prefix)
    return [_i32(w[:, 0]) for w in words], below[:, 0]


def _destinations_sorted(comm, comp: torch.Tensor,
                         splitters: Sequence[torch.Tensor],
                         below: torch.Tensor, n_shard: int):
    """The start and length of the run this sorted shard sends to each
    shard, with the tie quotas of ``tpusort``: a key between splitters goes
    to the shard of its interval, and the j-th local copy of a splitter's
    value to shard (below + copies on lower shards + j) // n_shard.

    Destinations rise with position, so run b starts where the keys below
    splitter b-1 end, plus the copies of its value that go to a lower
    shard.  JAX computes every key's destination (a cummax finds its tie
    rank); here each splitter's local copies are found by binary search,
    and their destinations follow from their count.  Returns (starts,
    counts), (d,) int64 each."""
    d, r = comm.size, comm.rank
    dev = comp.device
    spl = _composite([_u32(w) for w in splitters])
    lo = torch.searchsorted(comp, spl)
    hi = torch.searchsorted(comp, spl, right=True)
    t_all = comm.all_gather(hi - lo)                       # (d, d-1)
    p_r = t_all[:r].sum(0)
    b = torch.arange(1, d, dtype=torch.int64, device=dev)
    cut = lo + torch.minimum((b * n_shard - below - p_r).clamp(min=0),
                             hi - lo)
    n = comp.shape[0]
    edges = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), cut,
                       torch.full((1,), n, dtype=torch.int64, device=dev)])
    return edges[:-1], edges[1:] - edges[:-1]


def _local_engine_sort(planes, values, total_bits: int,
                       strided: bool = False):
    """The engine's unstable sort of one shard's twiddled planes and
    payload words, then the exact sort where its flag is set; ``strided``
    for the finish, whose input is d ascending runs."""
    cfg = _configs.get_config(total_bits, bool(values), planes[0].device.type)
    bits = dict(begin_bit=0, end_bit=total_bits, total_bits=total_bits)
    return first_clear(
        [lambda: _msd.sort_twiddled_msd(
            tuple(planes), tuple(values), config=cfg, stable=False,
            strided=strided, **bits),
         lambda: (*sort_twiddled_reference(planes, values, **bits), None)],
        "msd_flag")


def _norm_params(spl0: Sequence[int], r: int, d: int) -> Tuple[int, ...]:
    """Shard r's keys lie in [splitter r-1, splitter r]: (base, shift,
    scale) of the map that spreads that range over the whole 32-bit
    domain, so the engine's leading digits spread the shard's keys instead
    of crowding a few runs.  JAX's map is (k - base) << clz(width): it puts
    the width's top bit at bit 31, so a shard whose width lies just above
    a power of two covers only half the domain, and its finish overflows
    (with uniform keys, about half the shards of a power-of-two d).  Here a
    scale m / 2^16 in [1, 2) follows the shift and stretches the range to
    the whole domain."""
    base = spl0[r - 1] if r > 0 else 0
    top = spl0[r] if r < d - 1 else 0xFFFFFFFF
    width = max(top - base, 1)
    sh = min(32 - width.bit_length(), 31)
    return base, sh, (1 << 48) // ((width << sh) + 1)


def _normalise(k: torch.Tensor, base: int, sh: int, m: int) -> torch.Tensor:
    """(((k - base) << sh) * m) >> 16: monotone, and one to one because
    m >= 2^16.  In int64: torch has no clz, and CPU uint32 lacks the
    shifts."""
    v = ((_u32(k) - base) << sh) & 0xFFFFFFFF
    return _i32(((v * m) >> 16) & 0xFFFFFFFF)


def _denormalise(k: torch.Tensor, base: int, sh: int, m: int) -> torch.Tensor:
    """The inverse of :func:`_normalise` on its image: the shifted key is
    the one integer in [k * 2^16 / m, (k + 1) * 2^16 / m), an interval no
    longer than 1, so it is the ceiling of the lower end."""
    v = torch.div((_u32(k) << 16) + (m - 1), m, rounding_mode="floor")
    return _i32(((v >> sh) + base) & 0xFFFFFFFF)


def _finish_windows(recv, seg_counts, norm, *, n_shard, capacity,
                    plan_kwargs):
    """The sorted-window finish of one 32-bit shard: the received (d,
    capacity) runs, normalised, through ``sort_windows_msd``, or the exact
    sort of the compacted runs if its flag is set.  None where no plan
    exists."""
    d = recv[0].shape[0]
    kn = _normalise(recv[0], *norm)
    res = _msd.sort_windows_msd(
        (kn.reshape(-1),), tuple(x.reshape(-1) for x in recv[1:]),
        window_counts=seg_counts, window=capacity, n=n_shard, total_bits=32,
        plan_kwargs=plan_kwargs)
    if res is None:
        return None
    outs, overflow = res
    if len(recv) > 1:
        # pairs ride the raw path: a valid normalised key equal to the
        # invalid-slot sentinel could trade payloads with a pad slot
        valid = torch.arange(capacity, device=kn.device)[None, :] \
            < seg_counts[:, None]
        overflow = overflow | ((kn == -1) & valid).any()
    del kn

    def exact():
        compacted = collapse_segments(list(recv), seg_counts, n_shard)
        return (*sort_twiddled_reference(
            compacted[:1], compacted[1:], begin_bit=0, end_bit=32,
            total_bits=32), None)

    sp, sv = first_clear(
        [lambda: ((_denormalise(outs[0], *norm),), outs[1:], overflow),
         exact], "global_flag")
    return [*sp, *sv]


def _global_sort_shard(comm, ops: Sequence[torch.Tensor], *, nplanes: int,
                       n_shard: int, capacity: int, chunks: int,
                       plan_kwargs: dict, exchange: str, finish_mode: str):
    """One shard's body: ``ops`` are its n_shard twiddled key planes then
    payload words (int32).  Returns (its n_shard sorted operands, whether
    the exchange would have overflowed and every shard took the gathered
    exact sort instead)."""
    d, r = comm.size, comm.rank
    dev = ops[0].device
    planes, values = list(ops[:nplanes]), list(ops[nplanes:])
    # sort first: the splitter counts and the tie ranks become binary
    # searches, and each destination's keys one contiguous run
    sp, sv = _local_engine_sort(planes, values, 32 * nplanes)
    sorted_ops = [*sp, *sv]
    comp = _composite([_u32(p) for p in sp])
    splitters, below = _select_splitters(comm, comp, nplanes, n_shard)
    starts, counts = _destinations_sorted(comm, comp, splitters, below,
                                          n_shard)
    del comp, starts
    cmat = comm.all_gather(counts)                         # (d src, d dst)
    # the one host read of the shard: every shard sees the same matrix, so
    # all take the same branch, and it gives every run's offset
    host = torch.cat([cmat.reshape(-1), _u32(splitters[0])])
    with host_read("global_counts"):
        host = host.tolist()
    cm = np.asarray(host[:d * d], dtype=np.int64).reshape(d, d)
    spl0 = host[d * d:]
    offs = np.cumsum(cm, axis=1) - cm                    # run starts
    if int(cm.max()) > capacity:
        # gather every shard's sorted operands and sort this shard's
        # global ranks exactly: the runs destined here (JAX sorts all n
        # keys on every shard and keeps its slice)
        mine = []
        for o in sorted_ops:
            full = comm.all_gather(o)
            mine.append(torch.cat([full[s, offs[s, r]:offs[s, r] + cm[s, r]]
                                   for s in range(d)]))
            del full
        fp, fv = sort_twiddled_reference(
            mine[:nplanes], mine[nplanes:], begin_bit=0,
            end_bit=32 * nplanes, total_bits=32 * nplanes)
        return [*fp, *fv], True

    recv = []
    for o in sorted_ops:
        # run b at the front of window b; slots past its count are never
        # read as valid
        send = torch.empty((d, capacity), dtype=torch.int32, device=dev)
        for b in range(d):
            send[b, :cm[r, b]] = o[offs[r, b]:offs[r, b] + cm[r, b]]
        if exchange == "rdma":
            recv.append(comm.ring_all_to_all(send))
        elif chunks == 1:
            recv.append(comm.all_to_all(send))
        else:
            cap_c = capacity // chunks
            recv.append(torch.cat(
                [comm.all_to_all(send[:, j * cap_c:(j + 1) * cap_c])
                 for j in range(chunks)], dim=1))
        del send
    del sorted_ops, sp, sv
    seg_counts = _msd.to_device(cm[:, r].astype(np.int32), dev)
    norm = _norm_params(spl0, r, d)
    if finish_mode != "collapse" and nplanes == 1:
        out = _finish_windows(recv, seg_counts, norm, n_shard=n_shard,
                              capacity=capacity, plan_kwargs=plan_kwargs)
        if out is not None:
            return out, False
        if finish_mode == "windows":
            raise ValueError(
                f"no sorted-window finish plan for capacity={capacity} "
                "(needs capacity % tile == 0 and a feasible t1)")
    # the compacted shard is d ascending runs: contiguous tiles would each
    # fall into a few digits and overflow (JAX's finish does, and takes its
    # exact fallback), so the engine reads strided tiles; plane 0 is
    # normalised for 64-bit keys too (JAX leaves them as they are)
    compacted = collapse_segments(recv, seg_counts, n_shard)
    del recv
    sp2, sv2 = _local_engine_sort(
        [_normalise(compacted[0], *norm), *compacted[1:nplanes]],
        compacted[nplanes:], 32 * nplanes, strided=True)
    return [_denormalise(sp2[0], *norm), *sp2[1:], *sv2], False


def _capacity_for(n_shard: int, d: int, capacity_factor: float,
                  chunks: int, quantum: int = 128) -> int:
    cap = min(
        n_shard,
        int(capacity_factor * max(n_shard // d, 1) + 127) // 128 * 128,
    )
    # chunked exchange slices the capacity axis evenly; the sorted-window
    # finish additionally needs whole engine tiles per window
    q = max(128 * chunks, quantum)
    cap = max(q, (cap + q - 1) // q * q)
    return cap


def _values_tuple(values) -> tuple:
    if values is None:
        return ()
    return tuple(values) if isinstance(values, (tuple, list)) else (values,)


def _pack_values(values, out_vals):
    """The sorted values in the form the caller gave them."""
    return tuple(out_vals) if isinstance(values, (tuple, list)) \
        else out_vals[0]


def _make_sorter(comm, *, capacity_factor, chunks, adaptive, finish,
                 exchange, finish_for):
    """The sorter machinery shared by :func:`make_global_sort` and
    :func:`make_global_sort_planes`: ``sort_ops(ops, nplanes, n_local)``
    runs the shard body on twiddled operands (global ones for an
    in-process communicator, this shard's for a process group) and returns
    the sorted operands.  ``finish_for(device, nplanes)`` gives the finish
    and its plan arguments."""
    if exchange not in ("collective", "rdma"):
        raise ValueError(f"exchange must be 'collective' or 'rdma', got "
                         f"{exchange!r}")
    if finish not in ("auto", "collapse", "windows"):
        raise ValueError(f"finish must be 'auto', 'collapse' or 'windows', "
                         f"got {finish!r}")
    if exchange == "rdma" and isinstance(comm, ProcessGroupComm):
        raise NotImplementedError(
            "exchange='rdma' on a process group needs CUDA IPC handles of "
            "the peers' send buffers (ROADMAP item 14)")
    in_process = isinstance(comm, InProcessComm)
    d = comm.size
    shard_fns = {}   # geometry -> the shard body bound to it
    factors = {}     # base geometry -> adapted capacity_factor

    def sort_ops(ops: List[torch.Tensor], nplanes: int, n_local: int):
        dev = ops[0].device
        if in_process:
            if dev != comm.device:
                raise ValueError(f"keys on {dev}, the communicator's "
                                 f"shards on {comm.device}")
            if n_local % d:
                raise ValueError(f"n={n_local} must be divisible by the "
                                 f"number of shards {d}")
            n_shard = n_local // d
        else:
            n_shard = n_local
        fin_mode, fin_kwargs = finish_for(dev, nplanes, len(ops) > nplanes,
                                          n_shard)
        base = (nplanes, len(ops) - nplanes, n_shard)
        factor = factors.get(base, capacity_factor)
        capacity = _capacity_for(n_shard, d, factor, chunks)
        if fin_mode != "collapse" and nplanes == 1:
            # whole engine tiles a window, unless that would blow the
            # padding up (tiny shards, where the collapse is the tool)
            cap_w = _capacity_for(n_shard, d, factor, chunks,
                                  quantum=fin_kwargs.get("k", 1 << 16))
            if cap_w <= 2 * capacity and cap_w <= n_shard:
                capacity = cap_w
        geom = base + (capacity,)
        fn = shard_fns.get(geom)
        if fn is None:
            fn = shard_fns[geom] = functools.partial(
                _global_sort_shard, nplanes=nplanes, n_shard=n_shard,
                capacity=capacity, chunks=chunks, plan_kwargs=fin_kwargs,
                exchange=exchange)
        if in_process:
            res = comm.run(fn, [([o[r * n_shard:(r + 1) * n_shard]
                                  for o in ops],) for r in range(d)],
                           finish_mode=fin_mode)
            outs = [torch.cat([x[0][i] for x in res])
                    for i in range(len(ops))]
            overflow = res[0][1]
        else:
            outs, overflow = fn(comm, ops, finish_mode=fin_mode)
        if overflow:
            _msd.count_route("exchange_fallbacks")
            if adaptive and capacity < n_shard:
                factors[base] = factor * 2.0
        return outs

    return sort_ops, shard_fns, factors


def make_global_sort(comm, *, capacity_factor: float = 4.0, chunks: int = 1,
                     adaptive: bool = False, finish: str = "auto",
                     exchange: str = "collective"):
    """A sorter over the shards of ``comm`` (``parallel.comm``): returns
    fn(keys[, values], *, descending=False).

    With an :class:`~tpusort_torch.parallel.comm.InProcessComm` of d
    shards, ``keys`` is the whole 1-D tensor (n divisible by d, on the
    communicator's device) and so is the output; with a
    :class:`~tpusort_torch.parallel.comm.ProcessGroupComm`, each process
    passes and gets back its own shard (all shards of one length).  Keys
    are uint32/int32/float32 or uint64/int64/float64, ``values`` one
    tensor or a tuple of 32- or 64-bit tensors; pairs come back unstable
    (keys exact, payloads a permutation within equal keys).  One shard
    (d == 1) is ``tpusort_torch.sort(..., stable=False)``.

    ``capacity_factor`` sizes each (source, destination) window at that
    multiple of n_shard / d; ``chunks`` splits the collective all-to-all
    into that many pieces along it.  ``exchange`` is "collective" (the
    communicator's all-to-all) or "rdma" (K7; in-process only, a process
    group raises NotImplementedError).  ``finish`` is "collapse",
    "windows" (raises ValueError where the geometry has no plan) or "auto"
    (windows on a CUDA tensor where a plan exists and n_shard / d keys fit
    one engine tile, else collapse; see the module docstring).
    ``adaptive=True`` doubles a geometry's capacity factor after a call
    whose exchange would have overflowed (that call is still exact), until
    the capacity reaches n_shard.  ``fn._factors`` and ``fn._shard_fns``
    (geometry -> bound shard body; a geometry ends with its capacity) show
    the adaptation.
    """
    def finish_for(dev, nplanes, has_values, n_shard):
        cfg = _configs.get_config(32, has_values, dev.type)
        kwargs = {k: v for k, v in cfg.plan_kwargs().items() if k != "min_n"}
        fin_mode = finish
        if finish == "auto":
            # a window longer than a tile overflows the windows finish's
            # pass 0 (its tiles are slices of one sorted run, so each falls
            # into a few digits)
            fits = n_shard // comm.size <= kwargs["k"]
            fin_mode = "windows" if dev.type == "cuda" and fits \
                else "collapse"
        return fin_mode, kwargs

    sort_ops, shard_fns, factors = _make_sorter(
        comm, capacity_factor=capacity_factor, chunks=chunks,
        adaptive=adaptive, finish=finish, exchange=exchange,
        finish_for=finish_for)

    @spanned("tpusort.api.global_sort")
    def sorter(keys: torch.Tensor, values=None, *, descending: bool = False):
        if not isinstance(keys, torch.Tensor) or keys.dim() != 1:
            raise NotImplementedError("the global sort takes 1-D tensors")
        vt = _values_tuple(values)
        if comm.size == 1:
            from tpusort_torch.api import sort as _local_sort

            return _local_sort(keys, values, descending=descending,
                               stable=False)
        planes, traits = _dtypes.twiddle_in(keys.contiguous(),
                                            descending=descending)
        words, spec = _dtypes.value_words(vt, keys.shape[0], keys.device)
        outs = sort_ops([*planes, *words], len(planes), keys.shape[0])
        out_keys = _dtypes.twiddle_out(tuple(outs[:len(planes)]), traits,
                                       descending=descending)
        if values is None:
            return out_keys
        return out_keys, _pack_values(
            values, _dtypes.join_values(outs[len(planes):], spec))

    sorter._factors = factors
    sorter._shard_fns = shard_fns
    return sorter


def make_global_sort_planes(comm, *, key_dtype: str = "uint64",
                            capacity_factor: float = 4.0, chunks: int = 1,
                            adaptive: bool = False):
    """A sorter over the shards of ``comm`` for keys given as 32-bit
    bit-pattern planes (plane 0 the most significant word; two for a
    64-bit ``key_dtype``): returns fn(planes[, values], *,
    descending=False) -> sorted planes as uint32 tensors (and values).
    Tensors are whole or per shard as in :func:`make_global_sort`; the
    finish is the collapse.  ``adaptive`` as there."""
    traits = _dtypes.traits_for(getattr(torch, key_dtype, None))
    sort_ops, shard_fns, factors = _make_sorter(
        comm, capacity_factor=capacity_factor, chunks=chunks,
        adaptive=adaptive, finish="collapse", exchange="collective",
        finish_for=lambda *_: ("collapse", {}))

    @spanned("tpusort.api.global_sort_planes")
    def sorter(planes, values=None, *, descending: bool = False):
        planes = tuple(planes)
        if len(planes) != traits.planes:
            raise ValueError(f"{key_dtype} expects {traits.planes} planes, "
                             f"got {len(planes)}")
        if comm.size == 1:
            from tpusort_torch.api import sort_planes as _local_sort_planes

            return _local_sort_planes(planes, values, key_dtype=key_dtype,
                                      descending=descending, stable=False)
        raw = tuple(p.contiguous().view(torch.int32) for p in planes)
        tw = _dtypes.twiddle_planes_in(raw, traits, descending=descending)
        vt = _values_tuple(values)
        words, spec = _dtypes.value_words(vt, raw[0].shape[0], raw[0].device)
        outs = sort_ops([*tw, *words], len(tw), raw[0].shape[0])
        out_planes = tuple(p.view(torch.uint32) for p in
                           _dtypes.twiddle_planes_out(
                               tuple(outs[:len(tw)]), traits,
                               descending=descending))
        if values is None:
            return out_planes
        return out_planes, _pack_values(
            values, _dtypes.join_values(outs[len(tw):], spec))

    sorter._factors = factors
    sorter._shard_fns = shard_fns
    return sorter


def default_comm(device: torch.device):
    """The communicator :func:`global_sort` takes when given none: the
    default process group where one is initialised with more than one
    rank, else one in-process shard per visible card on the keys' device
    (one shard on the CPU or on one card)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return ProcessGroupComm()
    d = torch.cuda.device_count() if device.type == "cuda" else 1
    return InProcessComm(max(d, 1), device)


def global_sort(keys: torch.Tensor, values=None, *, comm=None,
                descending: bool = False, capacity_factor: float = 4.0,
                chunks: int = 1):
    """One distributed global sort over ``comm`` (:func:`default_comm`
    when None); see :func:`make_global_sort`."""
    if comm is None:
        comm = default_comm(keys.device)
    return make_global_sort(comm, capacity_factor=capacity_factor,
                            chunks=chunks)(keys, values,
                                           descending=descending)
