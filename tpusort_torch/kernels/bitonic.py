"""K2: the fused raw-key leaf sort + dense collapse.

PyTorch port of ``tpusort/kernels/bitonic.py:sort_tiles_counts_collapsed``
(``_counts_sort_collapse_kernel``).  On a CUDA tensor the wrapper launches
the hand-written kernel in ``csrc/bitonic.cu`` (one CTA per leaf tile; see
that file for the design and what bounds it).  On a CPU tensor it runs
:func:`sort_tiles_counts_collapsed_plain`, the plain PyTorch version of the
same contract.
"""

from __future__ import annotations

import torch

from tpusort_torch.kernels import _build
from tpusort_torch.kernels.partition import MAX_TILE, _valid
from tpusort_torch.ops.reference import sort_rows_unsigned

LANES = 128


def merge_staged_factor(k_real: int) -> int:
    """The odd block factor f for which the staged f*2^a merge applies
    (f in {3, 5}), or 0.  The planner's leaf cost model reads it."""
    for f in (3, 5):
        blk = k_real // f
        if f * blk == k_real and blk >= LANES and (blk & (blk - 1)) == 0:
            return f
    return 0


def sort_tiles_counts_collapsed_plain(
    keys: torch.Tensor, counts: torch.Tensor, q: int, n_out: int
) -> torch.Tensor:
    """Plain PyTorch K2 on (T, K) int32 keys: each tile's valid slots
    sorted, and the tiles' valid prefixes concatenated in tile order into
    (n_out,).  Slots past the total valid count are zero."""
    valid = _valid(keys, counts, q, None)
    tile = sort_rows_unsigned(torch.where(valid, keys, -1))
    K = keys.shape[1]
    tile_counts = counts.sum(dim=1)
    keep = torch.arange(K, device=keys.device)[None, :] < tile_counts[:, None]
    dense = tile[keep][:n_out]
    out = torch.zeros(n_out, dtype=torch.int32, device=keys.device)
    out[: dense.numel()] = dense
    return out


def _sort_tiles_counts_collapsed_cuda(
    keys: torch.Tensor, counts: torch.Tensor, q: int, n_out: int,
    sorted_run: int,
) -> torch.Tensor:
    T, K = keys.shape
    p = 1 << (K - 1).bit_length()          # virtual power-of-two pad
    if p > MAX_TILE:
        raise ValueError(f"leaf tile K={K} exceeds the kernel's shared memory")
    if sorted_run and (K % sorted_run or (p - K) % sorted_run):
        sorted_run = 0
    counts = counts.to(torch.int32).contiguous()
    # dense offset of each tile: exclusive cumsum of the valid counts
    offsets = torch.zeros(T + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(counts.sum(dim=1, dtype=torch.int64), dim=0, out=offsets[1:])
    out = torch.empty(n_out, dtype=torch.int32, device=keys.device)
    err = _build.library().tpusort_leaf_collapse(
        keys.data_ptr(), counts.data_ptr(), q, offsets.data_ptr(), n_out, T,
        K, p, sorted_run, out.data_ptr(),
        torch.cuda.current_stream(keys.device).cuda_stream,
    )
    _build.check(err, "sort_tiles_counts_collapsed")
    sort_tiles_counts_collapsed.launches += 1
    return out


def sort_tiles_counts_collapsed(
    op,
    counts: torch.Tensor,
    q: int,
    n_out: int,
    *,
    sorted_run: int = 0,
    num_keys: int = 1,
):
    """Sort each (T, K) int32 tile by its valid slots (slot i valid iff
    i % q < counts[t, i // q]) and write each tile's valid prefix to the
    dense (n_out,) output at the exclusive cumsum of the tiles' valid
    counts.  ``sorted_run``: the tile already consists of ascending runs
    of that power-of-two length once invalid slots are 0xFFFFFFFF.

    ``op`` is one tensor (returns one) or a one-element list (returns a
    list), as in the JAX wrapper; payload operands are not ported yet.
    """
    single = not isinstance(op, (list, tuple))
    ops = [op] if single else list(op)
    if len(ops) != 1 or num_keys != 1:
        raise NotImplementedError(
            "payload operands and multi-plane keys are not ported yet: "
            "ROADMAP Queue 1 item 4")
    keys = ops[0]
    if keys.dtype != torch.int32 or keys.dim() != 2:
        raise ValueError("keys must be a (T, K) int32 bit-pattern tensor")
    keys = keys.contiguous()
    T, K = keys.shape
    if K % LANES or q <= 0 or q % LANES or K % q or n_out < 0:
        raise ValueError(f"bad tile geometry K={K} q={q} n_out={n_out}")
    if tuple(counts.shape) != (T, K // q):
        raise ValueError(f"counts must be ({T}, {K // q})")
    if counts.device != keys.device:
        raise ValueError("counts must be on the keys' device")
    if sorted_run & (sorted_run - 1):
        raise ValueError(f"sorted_run={sorted_run} must be a power of two")
    if keys.device.type == "cpu":
        out = sort_tiles_counts_collapsed_plain(keys, counts, q, n_out)
    elif keys.device.type == "cuda":
        out = _sort_tiles_counts_collapsed_cuda(keys, counts, q, n_out,
                                                sorted_run)
    else:
        raise ValueError(f"no K2 for device {keys.device}")
    return out if single else [out]


sort_tiles_counts_collapsed.launches = 0
