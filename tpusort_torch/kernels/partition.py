"""K1: the fused MSD partition pass, raw-key mode.

PyTorch port of ``tpusort/kernels/partition.py:partition_pass_fused`` (the
raw-key branch of ``_fused_kernel``): 1-3 key planes, and payload words
that ride unstably.  On a CUDA tensor the wrapper launches the hand-written
kernel in ``csrc/partition.cu`` (one CTA per tile; see that file for the
design and what bounds it).  On a CPU tensor it runs
:func:`partition_pass_fused_plain`, the plain PyTorch version of the same
contract, which the tests hold against the Pallas kernel and the card holds
the CUDA kernel against.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence, Tuple

import torch

from tpusort_torch.kernels import _build
from tpusort_torch.ops.reference import sort_rows_lex

MAX_TILE = 1 << 15     # the slot index is 16-bit; 128 KB a key plane
MAX_RADIX = 256        # the kernel's shared-memory histogram
MAX_PLANES = 3         # key planes the kernels compare
MAX_VALUES = 8         # payload words per launch
SMEM_MAX = 232_448     # dynamic + static shared memory of one CTA (sm_90)
_K1_STATIC_SMEM = (2 * MAX_RADIX + 1) * 4


def tile_smem_bytes(slots: int, num_keys: int, has_values: bool) -> int:
    """Dynamic shared memory of a kernel tile: 4 bytes a slot for each key
    plane, plus a 2-byte slot index when payloads ride."""
    return slots * (4 * num_keys + (2 if has_values else 0))


def check_fits(what: str, slots: int, num_keys: int, n_values: int,
               static_smem: int = 0) -> None:
    """Raise ValueError unless a CUDA kernel's tile of ``slots`` slots with
    ``num_keys`` key planes and ``n_values`` payload words fits one CTA."""
    smem = tile_smem_bytes(slots, num_keys, n_values > 0) + static_smem
    if slots > MAX_TILE or num_keys > MAX_PLANES or n_values > MAX_VALUES \
            or smem > SMEM_MAX:
        raise ValueError(
            f"{what}: a tile of {slots} slots with {num_keys} key plane(s) "
            f"and {n_values} payload word(s) exceeds the kernel's shared "
            f"memory ({smem} of {SMEM_MAX} bytes) or operand limits")


def extract_bits(planes: Sequence[torch.Tensor], lo: int,
                 width: int) -> torch.Tensor:
    """Bits [lo, lo + width) of the multi-plane int32 key (plane 0 = most
    significant 32 bits), as int64 (port of ``_extract_bits_arrays``)."""
    nplanes = len(planes)
    out = torch.zeros(planes[0].shape, dtype=torch.int64,
                      device=planes[0].device)
    for i, p in enumerate(planes):
        base = 32 * (nplanes - 1 - i)
        ov_lo, ov_hi = max(lo, base), min(lo + width, base + 32)
        if ov_hi > ov_lo:
            chunk = ((p.to(torch.int64) & 0xFFFFFFFF) >> (ov_lo - base)) \
                & ((1 << (ov_hi - ov_lo)) - 1)
            out |= chunk << (ov_lo - lo)
    return out


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
    planes: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    counts_in: Optional[torch.Tensor],
    *,
    q_in: Optional[int],
    n: Optional[int],
    r: int,
    s: int,
    lo_bit: int,
    width: int,
    t_seg: int,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch K1 on (T, K) int32 planes and values: returns (flat
    exchanged runs (T*R*S,) per operand, counts (T, R) int32).  Slots past
    a run's count hold unspecified words, as in the kernel; ties keep
    their input order (any order is legal)."""
    T, K = planes[0].shape
    dev = planes[0].device
    valid = _valid(planes[0], counts_in, q_in, n)
    sp, sv = sort_rows_lex([torch.where(valid, p, -1) for p in planes],
                           values)
    n_valid = valid.sum(dim=1, dtype=torch.int32)
    digit = extract_bits(sp, lo_bit, width)
    hist = torch.zeros(T, r, dtype=torch.int32, device=dev).scatter_add_(
        1, digit, torch.ones_like(digit, dtype=torch.int32))
    start = torch.cumsum(hist, dim=1, dtype=torch.int32) - hist
    counts = hist.clone()
    counts[:, r - 1] = n_valid - start[:, r - 1]
    idx = (start[:, :, None] + torch.arange(s, device=dev, dtype=torch.int32))
    idx = idx.clamp(max=K - 1).reshape(T, r * s).long()
    n_seg = T // t_seg
    outs = [torch.gather(o, 1, idx).reshape(n_seg, t_seg, r, s)
            .transpose(1, 2).reshape(-1) for o in (*sp, *sv)]
    return outs, counts


def _partition_pass_cuda(
    planes: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
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
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    T, K = planes[0].shape
    check_fits("partition_pass_fused", K, len(planes), len(values),
               _K1_STATIC_SMEM)
    if r > MAX_RADIX:
        raise ValueError(f"R={r} exceeds the kernel's {MAX_RADIX} digits")
    if counts_in is not None:
        counts_in = counts_in.to(torch.int32).contiguous()
    dev = planes[0].device
    outs = [torch.empty(T * r * s, dtype=torch.int32, device=dev)
            for _ in range(len(planes) + len(values))]
    counts = torch.empty(T, r, dtype=torch.int32, device=dev)
    np_ = len(planes)
    err = _build.library().tpusort_partition_raw(
        _build.pointers(planes), _build.pointers(outs[:np_]), np_,
        _build.pointers(values), _build.pointers(outs[np_:]), len(values),
        None if counts_in is None else counts_in.data_ptr(),
        q_in or 0, -1 if n is None else n, T, K, r, s, lo_bit, width,
        t_seg, sorted_run or 0, counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "partition_pass_fused")
    _build.count_launch(partition_pass_fused, np_, len(values))
    return outs, counts


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
    """One fused MSD partition pass over (T, K) int32 bit-pattern tiles of
    1-3 key planes (plane 0 most significant) and payload words.

    Validity comes from ``counts_in`` ((T, K // q_in) int32: subrun i of
    ``q_in`` slots holds counts_in[t, i] valid slots as a prefix), or, for
    pass 0 (``counts_in`` None), from the global slot index vs ``n``.
    Invalid slots become 0xFFFFFFFF in every key plane.  ``sorted_run``:
    the tile already consists of ascending runs of that power-of-two length
    once invalid slots are rewritten (the kernel then only merges).  The
    digit is bits [lo_bit, lo_bit + width) of the whole multi-plane key.
    With ``t_seg`` (tiles per digit segment) run d of tile (seg, j) goes to
    out[seg, d, j] and the runs come back flat (T*R*S,); without it,
    tile-major (T, R*S).  Returns (runs of every plane then every value,
    counts (T, R) int32); counts may exceed ``s``, and the caller checks
    overflow.

    Payloads need ``unstable`` (they ride the raw-key sort, so equal keys
    may reorder them); stable payloads and more than 3 planes take the
    general branch (K1c), which is not ported.  The TPU-only ``batch`` and
    ``interpret`` arguments are gone.
    """
    if digit is not None or len(planes) > MAX_PLANES or \
            (values and not unstable):
        raise NotImplementedError(
            "digit=, stable payloads and more than 3 key planes take the "
            "general (digit, idx) branch (K1c), which is not ported yet: "
            "ROADMAP Queue 1 item 5")
    if splitters is not None or splitter_fracs is not None:
        raise NotImplementedError(
            "splitters= (equi-depth splitter mode, K1b) is not ported yet: "
            "ROADMAP Queue 1 item 7")
    ops = list(planes) + list(values)
    if not planes or any(o.dtype != torch.int32 or o.dim() != 2
                         for o in ops):
        raise ValueError("planes and values must be (T, K) int32 "
                         "bit-pattern tensors")
    ops = [o.contiguous() for o in ops]
    T, K = ops[0].shape
    dev = ops[0].device
    if any(o.shape != ops[0].shape or o.device != dev for o in ops):
        raise ValueError("every operand must have the same shape and device")
    if K % 128 or K & (K - 1) or s <= 0 or s % 128:
        raise ValueError(f"bad tile geometry K={K} S={s}")
    total = 32 * len(planes)
    if width <= 0 or (1 << width) > r or not 0 <= lo_bit <= total - width:
        raise ValueError(f"digit bits [{lo_bit}, {lo_bit + width}) do not "
                         f"fit {total}-bit keys and R={r}")
    if counts_in is not None:
        if q_in is None or q_in <= 0 or q_in % 128 or K % q_in:
            raise ValueError(f"bad validity granularity q_in={q_in}")
        if tuple(counts_in.shape) != (T, K // q_in):
            raise ValueError(f"counts_in must be ({T}, {K // q_in})")
        if counts_in.device != dev:
            raise ValueError("counts_in must be on the keys' device")
    elif n is None:
        raise ValueError("pass 0 (no counts_in) needs n")
    if sorted_run and (sorted_run & (sorted_run - 1) or K % sorted_run):
        raise ValueError(f"sorted_run={sorted_run} must be a power of two "
                         f"dividing K={K}")
    seg_tiles = 1 if t_seg is None else t_seg
    if T % seg_tiles:
        raise ValueError(f"T={T} is not a multiple of t_seg={t_seg}")
    kp, kv = ops[:len(planes)], ops[len(planes):]
    kw = dict(q_in=q_in, n=n, r=r, s=s, lo_bit=lo_bit, width=width,
              t_seg=seg_tiles)
    if dev.type == "cpu":
        outs, counts = partition_pass_fused_plain(kp, kv, counts_in, **kw)
    elif dev.type == "cuda":
        outs, counts = _partition_pass_cuda(kp, kv, counts_in,
                                            sorted_run=sorted_run, **kw)
    else:
        raise ValueError(f"no K1 for device {dev}")
    if t_seg is None:
        outs = [o.reshape(T, r * s) for o in outs]
    return outs, counts


partition_pass_fused.launches = 0
partition_pass_fused.modes = collections.Counter()
