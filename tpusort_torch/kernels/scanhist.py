"""K5 (the prefix sum of a 1-D array) and K6 (the global digit histogram).

PyTorch port of ``tpusort/kernels/scanhist.py``: ``prefix_sum_tiles``
(``_scan_kernel``) and ``digit_histogram_tiles`` (``_hist_kernel``).  On a
CUDA tensor each wrapper launches its hand-written kernel
(``csrc/scanhist.cu``: a single-pass scan with decoupled look-back, and
a histogram counted in registers or in per-warp shared-memory copies,
merged by atomics; see that file for the designs and what bounds them).  On a CPU tensor it runs the plain PyTorch version of
the same contract (``*_plain``: ``torch.cumsum`` and ``torch.bincount``).

uint32 tensors are worked on through their int32 views (PyTorch's CPU
``uint32`` has no arithmetic); the result has the input's dtype.  The TPU
layout arguments (``tile_rows``, ``interpret``) and helpers
(``cumsum_lanes``, ``cumsum_sublanes``) have no counterpart.
"""

from __future__ import annotations

import collections

import torch

from tpusort_torch.kernels import _build

__all__ = ["prefix_sum_tiles", "prefix_sum_tiles_plain",
           "digit_histogram_tiles", "digit_histogram_tiles_plain"]

SCAN_DTYPES = (torch.int32, torch.uint32, torch.float32)
SCAN_TILE = 8192           # elements a CTA of K5 scans (csrc/scanhist.cu)
SCAN_GROUP = 128           # tiles under one anchor of K5's look-back
MAX_DIGIT_BITS = 8         # K6's per-warp bins hold 256 counts


def _words(x: torch.Tensor) -> torch.Tensor:
    """uint32 as its int32 view (two's complement sums wrap alike)."""
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def prefix_sum_tiles_plain(x: torch.Tensor, *,
                           exclusive: bool = False) -> torch.Tensor:
    """Plain PyTorch K5: ``torch.cumsum`` in the input's own width (32-bit
    integers wrap; float32 accumulates in float32); the exclusive scan is
    the inclusive one minus the element."""
    w = _words(x)
    inc = torch.cumsum(w, dim=0, dtype=w.dtype)
    return ((inc - w) if exclusive else inc).view(x.dtype)


def _prefix_sum_cuda(x: torch.Tensor, exclusive: bool) -> torch.Tensor:
    n = x.shape[0]
    out = torch.empty_like(x)
    # an aggregate a tile, an anchor a group of tiles, the tile counter:
    # the kernel's one launch needs them zeroed
    tiles = -(-n // SCAN_TILE)
    scratch = torch.zeros(tiles + -(-tiles // SCAN_GROUP) + 1,
                          dtype=torch.int64, device=x.device)
    err = _build.library().tpusort_prefix_sum(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n,
        int(x.dtype == torch.float32), int(exclusive),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "prefix_sum_tiles")
    _build.count_launch(prefix_sum_tiles, 0, 1)
    return out


def prefix_sum_tiles(x: torch.Tensor, *,
                     exclusive: bool = False) -> torch.Tensor:
    """Inclusive (or ``exclusive``) prefix sum of a 1-D int32, uint32 or
    float32 tensor, of any length.  Integer sums wrap in 32 bits; float32
    sums add in an order fixed by the index alone (in float32 within a
    tile of the kernel, in float64 across tiles), so the same input gives
    the same bits on every run (the order differs from ``torch.cumsum``'s,
    so the two agree within rounding only).  An empty tensor comes back
    empty, with no launch."""
    if x.dim() != 1:
        raise ValueError("prefix_sum_tiles expects a 1-D tensor")
    if x.dtype not in SCAN_DTYPES:
        raise TypeError(f"prefix_sum_tiles takes int32, uint32 or float32, "
                        f"got {x.dtype}")
    if x.shape[0] == 0:
        return x.clone()
    x = x.contiguous()
    if x.device.type == "cpu":
        return prefix_sum_tiles_plain(x, exclusive=exclusive)
    if x.device.type == "cuda":
        return _prefix_sum_cuda(x, exclusive)
    raise ValueError(f"no K5 for device {x.device}")


prefix_sum_tiles.launches = 0
prefix_sum_tiles.modes = collections.Counter()


def digit_of(keys: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    """The ``bits``-wide digit at ``shift`` of 32-bit keys (any shape), as
    int32: one arithmetic shift and a mask, which also drops the shifted-in
    sign bits."""
    if not 0 <= shift or not 1 <= bits or shift + bits > 32 or bits > 31:
        raise ValueError(f"digit bits [{shift}, {shift + bits}) do not fit "
                         "a 32-bit key")
    return (keys.view(torch.int32) >> shift) & ((1 << bits) - 1)


def digit_histogram_tiles_plain(keys: torch.Tensor, shift: int,
                                bits: int) -> torch.Tensor:
    """Plain PyTorch K6: ``torch.bincount`` of the digit."""
    return torch.bincount(digit_of(keys, shift, bits),
                          minlength=1 << bits).to(torch.int32)


def _digit_histogram_cuda(keys: torch.Tensor, shift: int,
                          bits: int) -> torch.Tensor:
    out = torch.zeros(1 << bits, dtype=torch.int32, device=keys.device)
    if keys.shape[0]:
        err = _build.library().tpusort_digit_histogram(
            keys.data_ptr(), keys.shape[0], shift, bits, out.data_ptr(),
            torch.cuda.current_stream(keys.device).cuda_stream)
        _build.check(err, "digit_histogram_tiles")
        _build.count_launch(digit_histogram_tiles, 1, 0)
    return out


def digit_histogram_tiles(keys: torch.Tensor, shift: int,
                          bits: int) -> torch.Tensor:
    """Global counts of the ``bits``-wide digit at ``shift`` over a 1-D
    uint32 (or int32 bit-pattern) tensor of any length: (2**bits,) int32,
    exact.  ``bits`` <= 8.  (The TPU kernel needs a length that divides its
    tile; that is its tiling, not the contract.)"""
    if keys.dim() != 1 or keys.dtype not in (torch.uint32, torch.int32):
        raise ValueError("digit_histogram_tiles expects a 1-D uint32 or "
                         "int32 tensor")
    if not 1 <= bits <= MAX_DIGIT_BITS or shift < 0 or shift + bits > 32:
        raise ValueError(f"digit bits [{shift}, {shift + bits}) with "
                         f"bits={bits}: need 1 <= bits <= {MAX_DIGIT_BITS} "
                         "inside a 32-bit key")
    keys = keys.contiguous()
    if keys.device.type == "cpu":
        return digit_histogram_tiles_plain(keys, shift, bits)
    if keys.device.type == "cuda":
        return _digit_histogram_cuda(keys, shift, bits)
    raise ValueError(f"no K6 for device {keys.device}")


digit_histogram_tiles.launches = 0
digit_histogram_tiles.modes = collections.Counter()
