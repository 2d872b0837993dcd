"""K4: drop the invalid tail of every segment into one dense array.

PyTorch port of ``tpusort/kernels/collapse.py:collapse_segments``, the last
step of the MSD engine's general path: the leaf leaves (nseg, seg) segments
whose first seg_counts[s] slots are valid, and this concatenates those
prefixes, in segment order, into dense (n_out,) arrays.  On a CUDA tensor
the wrapper launches the hand-written kernel in ``csrc/collapse.cu`` (one
kernel for the Pallas grouped and chunked kernels; see that file for the
design and what bounds it).  On a CPU tensor it runs
:func:`collapse_segments_plain`, the plain PyTorch version of the same
contract.  The TPU-only ``group`` and ``interpret`` arguments and the VMEM
budget are gone.
"""

from __future__ import annotations

import collections
from typing import List, Sequence

import torch

from tpusort_torch.kernels import _build
from tpusort_torch.kernels.partition import MAX_OPERANDS


def collapse_segments_plain(ops: Sequence[torch.Tensor],
                            seg_counts: torch.Tensor,
                            n_out: int) -> List[torch.Tensor]:
    """Plain PyTorch K4: the valid prefixes of the (nseg, seg) int32
    operands' rows, concatenated and cut at n_out; slots past
    sum(seg_counts) are zero."""
    seg = ops[0].shape[1]
    keep = torch.arange(seg, device=ops[0].device)[None, :] < \
        seg_counts.to(torch.int64)[:, None]
    outs = []
    for o in ops:
        dense = o[keep][:n_out]
        out = torch.zeros(n_out, dtype=torch.int32, device=o.device)
        out[: dense.numel()] = dense
        outs.append(out)
    return outs


def _collapse_segments_cuda(ops: Sequence[torch.Tensor],
                            seg_counts: torch.Tensor,
                            n_out: int) -> List[torch.Tensor]:
    if len(ops) > MAX_OPERANDS:
        raise ValueError(f"collapse_segments: {len(ops)} operands exceed the "
                         f"kernel's {MAX_OPERANDS}")
    nseg, seg = ops[0].shape
    dev = ops[0].device
    # the kernel clamps the counts to [0, seg] and scans them itself
    if seg_counts.dtype not in (torch.int32, torch.int64):
        seg_counts = seg_counts.to(torch.int32)
    counts = seg_counts.contiguous()
    offsets = torch.empty(nseg + 1, dtype=torch.int64, device=dev)
    outs = [torch.empty(n_out, dtype=torch.int32, device=dev) for _ in ops]
    err = _build.library().tpusort_collapse(
        _build.pointers(ops), _build.pointers(outs), len(ops),
        counts.data_ptr(), int(counts.dtype == torch.int64),
        offsets.data_ptr(), n_out, nseg, seg,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "collapse_segments")
    # K4 compares no keys: its mode counts every operand as a payload word
    _build.count_launch(collapse_segments, 0, len(ops))
    return outs


def collapse_segments(ops: Sequence[torch.Tensor], seg_counts: torch.Tensor,
                      n_out: int) -> List[torch.Tensor]:
    """Concatenate per-segment valid prefixes into dense (n_out,) arrays.

    ops: (nseg, seg) int32 bit-pattern tensors (seg a multiple of 128);
    seg_counts: (nseg,) integer valid prefix lengths (clipped to
    [0, seg]), with sum >= n_out (data past n_out is dropped; slots past
    the sum are zero).  Returns one (n_out,) int32 tensor per operand.
    """
    ops = [o.contiguous() for o in ops]
    if not ops or any(o.dtype != torch.int32 or o.dim() != 2 for o in ops):
        raise ValueError("collapse_segments operands must be (nseg, seg) "
                         "int32 bit-pattern tensors")
    nseg, seg = ops[0].shape
    dev = ops[0].device
    if any(o.shape != ops[0].shape or o.device != dev for o in ops):
        raise ValueError("collapse_segments operands must share shape and "
                         "device")
    if seg % 128:
        raise ValueError("segment size must be a multiple of 128")
    if tuple(seg_counts.shape) != (nseg,) or seg_counts.device != dev:
        raise ValueError(f"seg_counts must be ({nseg},) on the operands' "
                         "device")
    if n_out < 0:
        raise ValueError(f"n_out={n_out} must be >= 0")
    if dev.type == "cpu":
        return collapse_segments_plain(ops, seg_counts, n_out)
    if dev.type == "cuda":
        return _collapse_segments_cuda(ops, seg_counts, n_out)
    raise ValueError(f"no K4 for device {dev}")


collapse_segments.launches = 0
collapse_segments.modes = collections.Counter()
