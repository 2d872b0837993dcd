"""K1: the fused MSD partition pass, raw-key keys-only mode.

PyTorch port of ``tpusort/kernels/partition.py:partition_pass_fused`` (the
raw-key branch of ``_fused_kernel``).  On a CUDA tensor the wrapper launches
the hand-written kernel in ``csrc/partition.cu`` (one CTA per tile; see that
file for the design and what bounds it).  On a CPU tensor it runs
:func:`partition_pass_fused_plain`, the plain PyTorch version of the same
contract, which the tests hold against the Pallas kernel and the card holds
the CUDA kernel against.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from tpusort_torch.kernels import _build
from tpusort_torch.ops.reference import sort_rows_unsigned

MAX_TILE = 1 << 15     # 128 KB of keys: the largest pow2 tile a CTA holds
MAX_RADIX = 256        # the kernel's shared-memory histogram


def _valid(keys: torch.Tensor, counts_in: Optional[torch.Tensor],
           q_in: Optional[int], n: Optional[int]) -> torch.Tensor:
    """(T, K) validity: from the global index vs n (pass 0) or from the
    counts table (subrun i of q_in slots holds counts_in[t, i] valid
    slots as a prefix)."""
    T, K = keys.shape
    if counts_in is None:
        return (torch.arange(T * K, device=keys.device) < n).reshape(T, K)
    sub = torch.arange(K, device=keys.device) % q_in
    return sub[None, :] < counts_in.repeat_interleave(q_in, dim=1)


def partition_pass_fused_plain(
    keys: torch.Tensor,
    counts_in: Optional[torch.Tensor],
    *,
    q_in: Optional[int],
    n: Optional[int],
    r: int,
    s: int,
    lo_bit: int,
    width: int,
    t_seg: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1 on (T, K) int32 keys: returns (flat exchanged runs
    (T*R*S,), counts (T, R) int32).  Slots past a run's count hold
    unspecified keys, as in the kernel."""
    T, K = keys.shape
    dev = keys.device
    valid = _valid(keys, counts_in, q_in, n)
    tile = sort_rows_unsigned(torch.where(valid, keys, -1))
    n_valid = valid.sum(dim=1, dtype=torch.int32)
    digit = ((tile >> lo_bit) & ((1 << width) - 1)).long()
    hist = torch.zeros(T, r, dtype=torch.int32, device=dev).scatter_add_(
        1, digit, torch.ones_like(digit, dtype=torch.int32))
    start = torch.cumsum(hist, dim=1, dtype=torch.int32) - hist
    counts = hist.clone()
    counts[:, r - 1] = n_valid - start[:, r - 1]
    idx = (start[:, :, None] + torch.arange(s, device=dev, dtype=torch.int32))
    runs = torch.gather(tile, 1, idx.clamp(max=K - 1).reshape(T, r * s).long())
    n_seg = T // t_seg
    out = runs.reshape(n_seg, t_seg, r, s).transpose(1, 2).reshape(-1)
    return out, counts


def _partition_pass_cuda(
    keys: torch.Tensor,
    counts_in: Optional[torch.Tensor],
    *,
    q_in: Optional[int],
    n: Optional[int],
    r: int,
    s: int,
    lo_bit: int,
    width: int,
    t_seg: int,
    sorted_run: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    T, K = keys.shape
    if K > MAX_TILE or r > MAX_RADIX:
        raise ValueError(f"K={K} or R={r} exceeds the kernel's shared memory")
    if counts_in is not None:
        counts_in = counts_in.to(torch.int32).contiguous()
    lib = _build.library()
    out = torch.empty(T * r * s, dtype=torch.int32, device=keys.device)
    counts = torch.empty(T, r, dtype=torch.int32, device=keys.device)
    err = lib.tpusort_partition_raw(
        keys.data_ptr(),
        None if counts_in is None else counts_in.data_ptr(),
        q_in or 0, -1 if n is None else n, T, K, r, s, lo_bit, width,
        t_seg, sorted_run or 0, out.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(keys.device).cuda_stream,
    )
    _build.check(err, "partition_pass_fused")
    partition_pass_fused.launches += 1
    return out, counts


def partition_pass_fused(
    planes: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    counts_in: Optional[torch.Tensor],
    *,
    r: int,
    s: int,
    lo_bit: int,
    width: int,
    q_in: Optional[int] = None,
    n: Optional[int] = None,
    sorted_run: Optional[int] = None,
    unstable: bool = False,
    t_seg: Optional[int] = None,
    digit: Optional[torch.Tensor] = None,
    splitters: Optional[torch.Tensor] = None,
    splitter_fracs: Optional[torch.Tensor] = None,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One fused MSD partition pass over (T, K) int32 bit-pattern tiles.

    Validity comes from ``counts_in`` ((T, K // q_in) int32: subrun i of
    ``q_in`` slots holds counts_in[t, i] valid slots as a prefix), or, for
    pass 0 (``counts_in`` None), from the global slot index vs ``n``.
    ``sorted_run``: the tile already consists of ascending runs of that
    power-of-two length once invalid slots are 0xFFFFFFFF (the kernel then
    only merges).  With ``t_seg`` (tiles per digit segment) run d of tile
    (seg, j) goes to out[seg, d, j] and the runs come back flat
    (T*R*S,); without it, tile-major (T, R*S).  Returns (runs, counts
    (T, R) int32); counts may exceed ``s``, and the caller checks overflow.

    Only the raw-key keys-only mode is ported (``unstable`` matters only
    with values); the TPU-only ``batch`` and ``interpret`` arguments are
    gone.
    """
    if digit is not None:
        raise NotImplementedError(
            "digit= (the general (digit, idx) branch, K1c) is not ported "
            "yet: ROADMAP Queue 1 item 5")
    if splitters is not None or splitter_fracs is not None:
        raise NotImplementedError(
            "splitters= (equi-depth splitter mode, K1b) is not ported yet: "
            "ROADMAP Queue 1 item 7")
    if values or len(planes) != 1:
        raise NotImplementedError(
            "values and multi-plane keys are not ported yet: ROADMAP Queue 1 "
            "item 4")
    (keys,) = planes
    if keys.dtype != torch.int32 or keys.dim() != 2:
        raise ValueError("keys must be a (T, K) int32 bit-pattern tensor")
    keys = keys.contiguous()
    T, K = keys.shape
    if K % 128 or K & (K - 1) or s <= 0 or s % 128:
        raise ValueError(f"bad tile geometry K={K} S={s}")
    if width <= 0 or (1 << width) > r or not 0 <= lo_bit <= 32 - width:
        raise ValueError(f"digit bits [{lo_bit}, {lo_bit + width}) do not "
                         f"fit 32-bit keys and R={r}")
    if counts_in is not None:
        if q_in is None or q_in <= 0 or q_in % 128 or K % q_in:
            raise ValueError(f"bad validity granularity q_in={q_in}")
        if tuple(counts_in.shape) != (T, K // q_in):
            raise ValueError(f"counts_in must be ({T}, {K // q_in})")
        if counts_in.device != keys.device:
            raise ValueError("counts_in must be on the keys' device")
    elif n is None:
        raise ValueError("pass 0 (no counts_in) needs n")
    if sorted_run and (sorted_run & (sorted_run - 1) or K % sorted_run):
        raise ValueError(f"sorted_run={sorted_run} must be a power of two "
                         f"dividing K={K}")
    seg_tiles = 1 if t_seg is None else t_seg
    if T % seg_tiles:
        raise ValueError(f"T={T} is not a multiple of t_seg={t_seg}")
    kw = dict(q_in=q_in, n=n, r=r, s=s, lo_bit=lo_bit, width=width,
              t_seg=seg_tiles)
    if keys.device.type == "cpu":
        out, counts = partition_pass_fused_plain(keys, counts_in, **kw)
    elif keys.device.type == "cuda":
        out, counts = _partition_pass_cuda(keys, counts_in,
                                           sorted_run=sorted_run, **kw)
    else:
        raise ValueError(f"no K1 for device {keys.device}")
    return [out if t_seg is not None else out.reshape(T, r * s)], counts


partition_pass_fused.launches = 0
