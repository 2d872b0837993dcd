"""Prefix-scan ops.

PyTorch port of ``tpusort/ops/scan.py``.  1-D sums of int32, uint32 and
float32 tensors go through K5 (``kernels.scanhist.prefix_sum_tiles``: the
hand-written kernel on a CUDA tensor, its plain version on a CPU tensor);
other axes, dtypes and operators stay plain PyTorch, as they are XLA scans
in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpusort_torch.kernels.scanhist import SCAN_DTYPES, prefix_sum_tiles

__all__ = ["inclusive_sum", "exclusive_sum", "inclusive_scan",
           "exclusive_scan", "segmented_sum"]

_KERNEL_MIN_N = 1 << 16


def _kernel_route(x: torch.Tensor, axis: int,
                  use_kernel: Optional[bool]) -> bool:
    """Whether the sum goes through K5 (port of ``_pallas_route``):
    ``use_kernel`` True takes it wherever the shape allows, on any device;
    False never; None takes it for CUDA tensors of at least 2^16
    elements."""
    ok = x.dim() == 1 and axis in (-1, 0) and x.dtype in SCAN_DTYPES
    if use_kernel is not None:
        return ok and use_kernel
    return ok and x.shape[0] >= _KERNEL_MIN_N and x.is_cuda


def _cumsum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``torch.cumsum`` in the input's own dtype, as ``jnp.cumsum`` (torch
    would widen integers to int64); uint32 through its int32 view."""
    if x.dtype == torch.bool:
        return torch.cumsum(x, dim=axis)
    w = x.view(torch.int32) if x.dtype == torch.uint32 else x
    return torch.cumsum(w, dim=axis, dtype=w.dtype).view(x.dtype)


def inclusive_sum(x: torch.Tensor, axis: int = -1, *,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    if _kernel_route(x, axis, use_kernel):
        return prefix_sum_tiles(x)
    return _cumsum(x, axis)


def exclusive_sum(x: torch.Tensor, axis: int = -1, *,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    if _kernel_route(x, axis, use_kernel):
        return prefix_sum_tiles(x, exclusive=True)
    w = x.view(torch.int32) if x.dtype == torch.uint32 else x
    return (_cumsum(w, axis) - w).view(x.dtype)


def inclusive_scan(x: torch.Tensor, op: Callable, axis: int = -1
                   ) -> torch.Tensor:
    """Inclusive scan along ``axis`` with any associative ``op(earlier,
    later)`` on tensors (``torch.maximum``, ...): log2(n) steps, each one
    ``op`` over the whole tensor (Hillis-Steele)."""
    n = x.shape[axis]
    d = 1
    while d < n:
        x = torch.cat([x.narrow(axis, 0, d),
                       op(x.narrow(axis, 0, n - d), x.narrow(axis, d, n - d))],
                      dim=axis)
        d *= 2
    return x


def exclusive_scan(x: torch.Tensor, op: Callable, identity, axis: int = -1
                   ) -> torch.Tensor:
    out = torch.roll(inclusive_scan(x, op, axis), 1, dims=axis)
    out.narrow(axis, 0, min(1, x.shape[axis])).fill_(identity)
    return out


def segmented_sum(x: torch.Tensor, segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """(num_segments,) sums of ``x`` by segment id; ids outside
    [0, num_segments) are dropped, as JAX's one-hot product drops them.
    (``index_add_`` in place of the product: the same sums, float32 within
    rounding.)"""
    ids = segment_ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = torch.zeros(num_segments + 1, dtype=x.dtype, device=x.device)
    return out.index_add_(0, ids, x)[:num_segments]
