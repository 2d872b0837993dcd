"""Communicators for the global sort: d shards and the collectives between
them.

The shard body (``parallel.global_sort``) is written once, against a small
interface that both communicators give it:

* ``rank`` and ``size``;
* ``all_reduce_sum(t)`` and ``all_reduce_max(t)``: the elementwise sum or
  maximum of every shard's ``t``;
* ``all_gather(t)``: a (size, *t.shape) tensor, row s shard s's ``t``;
* ``all_to_all(t)``: ``t`` is (size, ...), row b for shard b; returns a
  tensor of the same shape whose row s is the row shard s sent here;
* ``ring_all_to_all(t)``: the same for (size, window) int32 windows,
  through K7 (``parallel.ring``).

:class:`InProcessComm` runs d shard bodies in one process on one device,
one thread each; this is how d shards share one card, where NCCL refuses
two ranks.  :class:`ProcessGroupComm` wraps a ``torch.distributed`` process
group, one shard a process.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, List, Optional, Sequence

import torch

from tpusort_torch.parallel.ring import ring_all_to_all as _ring_pull

__all__ = ["InProcessComm", "ProcessGroupComm"]


class _Meeting:
    """What the threads of one :meth:`InProcessComm.run` share: a barrier
    with a timeout, and two rows of one slot a shard, used by turns, with
    the result of a collective whose result every shard shares."""

    def __init__(self, d: int, timeout: float):
        self.slots: List[List[Any]] = [[None] * d, [None] * d]
        self.shared: List[Optional[Callable[[list], Any]]] = [None, None]
        self.result: List[Any] = [None, None]
        self.turn = 0
        self.barrier = threading.Barrier(d, action=self._meet,
                                         timeout=timeout)

    def _meet(self) -> None:
        # run by one thread once every shard has arrived, before any leaves
        t = self.turn
        f = self.shared[t]
        self.result[t] = None if f is None else f(list(self.slots[t]))
        self.turn ^= 1

    def close(self) -> None:
        """Drop the last two collectives' tensors.  The barrier's action
        refers back to the meeting, so without this they would live until
        the cyclic garbage collector ran: gigabytes a call at 2^28 keys."""
        self.slots = [[None] * len(row) for row in self.slots]
        self.shared = [None, None]
        self.result = [None, None]


class _Shard:
    """Shard ``rank``'s view of an :class:`InProcessComm` run.

    A collective puts this shard's tensor in its slot and meets the others
    at the barrier once.  A result every shard shares (a sum, a gather) is
    computed once, by the last shard to arrive; a result of its own (an
    all-to-all) each shard computes after the meeting.  Collectives use the
    two rows of slots by turns: a shard writes a row again only after the
    next collective's meeting, which every shard reaches after it has read
    that row, and the slot keeps the tensor alive until then.  On a card
    every shard queues on the one stream of the run, so the order of the
    launches is the only synchronisation the device needs: a peer's tensor
    was queued before the meeting, and its memory cannot be reused before
    every read of it has been queued."""

    def __init__(self, meeting: _Meeting, rank: int, size: int):
        self._m = meeting
        self._turn = 0
        self.rank = rank
        self.size = size

    def _exchange(self, obj, shared=None, own=None):
        m, t = self._m, self._turn
        self._turn ^= 1
        m.slots[t][self.rank] = obj
        m.shared[t] = shared
        m.barrier.wait()
        return m.result[t] if own is None else own(list(m.slots[t]))

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._exchange(t, shared=lambda ts: torch.stack(ts).sum(0))

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        return self._exchange(t, shared=lambda ts: torch.stack(ts).amax(0))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return self._exchange(t, shared=torch.stack)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        r = self.rank
        return self._exchange(t, own=lambda ts: torch.stack([x[r] for x in ts]))

    def ring_all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        r = self.rank
        return self._exchange(t.contiguous(), own=lambda ts: _ring_pull(ts, r))


class InProcessComm:
    """``d`` shards on one device in one process, one thread a shard.

    :meth:`run` calls a shard body once per shard, each in its own thread
    with its own communicator view (rank r of d), and returns their
    results in rank order.  Threads, not a lockstep loop: the body is the
    same code that runs one shard a process, and a thread waits at a
    collective where a process would; a lockstep loop would have to cut the
    body at every collective.  On a card every thread queues its kernels on
    the stream that was current when :meth:`run` was called.

    Every meeting at the barrier waits at most ``timeout`` seconds.  A
    shard that raises aborts the barrier, so the others raise instead of
    waiting, and :meth:`run` raises the first shard's own exception.
    """

    def __init__(self, d: int, device="cuda", timeout: float = 600.0):
        if d < 1:
            raise ValueError(f"d={d} must be >= 1")
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.size = d
        self.device = dev
        self.timeout = timeout

    def run(self, body: Callable, per_rank: Sequence[Sequence],
            **kwargs) -> list:
        """``[body(view_r, *per_rank[r], **kwargs) for r in range(d)]``,
        the d calls running at once in d threads."""
        d = self.size
        if len(per_rank) != d:
            raise ValueError(f"{len(per_rank)} argument lists for {d} shards")
        meeting = _Meeting(d, self.timeout)
        results: List[Any] = [None] * d
        errors: List[Optional[BaseException]] = [None] * d
        stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None

        def work(r: int) -> None:
            try:
                ctx = torch.cuda.stream(stream) if stream is not None \
                    else contextlib.nullcontext()
                with ctx:
                    results[r] = body(_Shard(meeting, r, d), *per_rank[r],
                                      **kwargs)
            except BaseException as e:  # noqa: BLE001 - re-raised by run
                errors[r] = e
                meeting.barrier.abort()

        threads = [threading.Thread(target=work, args=(r,), daemon=True,
                                    name=f"tpusort-shard-{r}")
                   for r in range(d)]
        for t in threads:
            t.start()
        try:
            for t in threads:
                t.join(self.timeout)
                if t.is_alive():
                    meeting.barrier.abort()
                    raise TimeoutError(f"{t.name} still running after "
                                       f"{self.timeout} s")
        finally:
            meeting.close()
        raised = [e for e in errors if e is not None]
        if raised:
            # a broken barrier is the echo of another shard's exception
            own = [e for e in raised
                   if not isinstance(e, threading.BrokenBarrierError)]
            raise (own or raised)[0]
        return results


class ProcessGroupComm:
    """One shard a process: this process's rank in a ``torch.distributed``
    process group (the default group if ``group`` is None), which must be
    initialised.  Integer counts travel as int64.  ``exchange="rdma"`` has
    no route here: K7 would need the peers' send buffers mapped into this
    process (CUDA IPC handles, ROADMAP item 14), so
    :meth:`ring_all_to_all` raises."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("ProcessGroupComm needs an initialised "
                               "torch.distributed process group")
        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        out = t.clone()
        self._dist.all_reduce(out, op=op, group=self.group)
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, self._dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, self._dist.ReduceOp.MAX)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        self._dist.all_gather(parts, t, group=self.group)
        return torch.stack(parts)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        out = torch.empty_like(t)
        self._dist.all_to_all_single(out, t, group=self.group)
        return out

    def ring_all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "exchange='rdma' across processes needs CUDA IPC handles of the "
            "peers' send buffers (ROADMAP item 14); use "
            "exchange='collective' on a process group")
