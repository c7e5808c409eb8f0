"""Ordered f32 scatter-add: the vote scatter of ``ops/fused.py`` and
``ops/pileup.py:accumulate``.

``scatter_add_ordered(target, idx, w, keep)`` adds ``w[k]`` into
``target[idx[k]]`` for every ``k`` with ``keep[k]`` and ``idx[k]`` in
``[0, target.numel())`` (the reference's ``mode="drop"``), each cell's
contributions one at a time in increasing ``k``: the order of XLA's CPU
scatter, so fractional (qual-weighted) votes sum to the reference's bits.
``target`` is a flat f32 view, updated in place.

CUDA tensors go through the kernel ``csrc/scatter.cu`` (no atomics: a
thread a sorted segment), with no host sync: every entry is keyed as int32
by its cell, or by ``n`` where it is dropped, and stable-sorted once; the
kernel skips the keys ``n``. CPU tensors go through the plain version: stable sort by
cell, then round r adds each cell's r-th entry with one ``index_add_``
whose indices are unique, so no two adds collide and the result is the
same on any device. ``torch.index_add_`` on the card adds with atomics in
no order; it is not used here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from proovread_tpu_torch import kernels
from proovread_tpu_torch.obs.profile import attributed


def _sorted_segments(target: torch.Tensor, idx: torch.Tensor,
                     keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cells i64 [M], entries i64 [M]) of the kept in-range entries,
    sorted by cell and, within a cell, by entry index (the plain
    version's; ``torch.nonzero`` reads its count on the host)."""
    n = target.numel()
    idx = idx.reshape(-1)
    live = keep.reshape(-1) & (idx >= 0) & (idx < n)
    pos = torch.nonzero(live).squeeze(1)
    cells, perm = torch.sort(idx[pos], stable=True)
    return cells, pos[perm]


def _check(target, idx, w, keep) -> None:
    req = kernels.require
    req(target.dtype == torch.float32 and target.dim() == 1
        and target.is_contiguous(),
        "scatter_add_ordered: target must be a contiguous flat f32 tensor")
    req(idx.dtype == torch.int64 and w.dtype == torch.float32
        and keep.dtype == torch.bool,
        "scatter_add_ordered: idx int64, w float32, keep bool")
    req(idx.shape == w.shape == keep.shape,
        "scatter_add_ordered: idx, w and keep must have one shape")
    req(len({t.device for t in (target, idx, w, keep)}) == 1,
        "scatter_add_ordered: tensors on mixed devices")
    req(target.numel() < (1 << 31) - 1 and idx.numel() < (1 << 31),
        "scatter_add_ordered: target or entries past 2^31")


@attributed("scatter_add_ordered")
def scatter_add_ordered(target: torch.Tensor, idx: torch.Tensor,
                        w: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``target[idx[k]] += w[k]`` where ``keep[k]`` and ``idx[k]`` is in
    range, in increasing ``k`` per cell; in place, returns ``target``. CPU
    tensors take the plain version, CUDA tensors the kernel."""
    _check(target, idx, w, keep)
    if target.device.type == "cpu":
        return scatter_add_ordered_plain(target, idx, w, keep)
    if target.device.type != "cuda":
        raise ValueError(
            f"scatter_add_ordered: unsupported device {target.device}")
    return _scatter_cuda(target, idx, w, keep)


scatter_add_ordered.launches = 0


def _scatter_cuda(target, idx, w, keep) -> torch.Tensor:
    """Every entry keyed by its cell (int32; ``n`` where dropped or out of
    range: the checks bound ``n`` and the entry count from the shapes),
    one stable sort, one launch over all entries. No host sync."""
    n, M = target.numel(), idx.numel()
    if M == 0:
        return target
    flat = idx.reshape(-1)
    live = keep.reshape(-1) & (flat >= 0) & (flat < n)
    keys, order = torch.sort(torch.where(live, flat.to(torch.int32), n),
                             stable=True)
    w = w.reshape(-1).contiguous()
    rc = kernels.lib().pt_scatter_add_ordered(
        target.data_ptr(), keys.data_ptr(), order.data_ptr(), w.data_ptr(),
        M, n, kernels.stream_of(target))
    kernels.check(rc, "scatter_add_ordered")
    kernels.count_launch(scatter_add_ordered)
    return target


def scatter_add_ordered_plain(target, idx, w, keep) -> torch.Tensor:
    """Plain version: each cell's r-th kept entry (in index order) is added
    in round r, by one ``index_add_`` of unique indices."""
    cells, order = _sorted_segments(target, idx, keep)
    M = cells.numel()
    if M == 0:
        return target
    w = w.reshape(-1)
    s = torch.arange(M, device=cells.device)
    head = torch.ones(M, dtype=torch.bool, device=cells.device)
    head[1:] = cells[1:] != cells[:-1]
    rank = s - torch.cummax(torch.where(head, s, 0), 0).values
    by_rank = torch.argsort(rank, stable=True)
    start = 0
    for count in torch.bincount(rank).tolist():
        sl = by_rank[start:start + count]
        target.index_add_(0, cells[sl], w[order[sl]])
        start += count
    return target
