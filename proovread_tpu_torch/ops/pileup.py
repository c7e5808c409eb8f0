"""Pileup tensors of a batch of long reads (port of the ``Pileup`` tuple of
``proovread_tpu/ops/pileup.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim as a left fold, ``((x0 + x1) + x2) + ...``: the
    order the CPU-compiled reference reduces in. ``Tensor.sum`` adds in
    another order, which changes the f32 result for fractional
    (qual-weighted) votes."""
    out = x[..., 0]
    for k in range(1, x.shape[-1]):
        out = out + x[..., k]
    return out


class Pileup(NamedTuple):
    """Accumulated vote tensors for B long reads of padded length L.

    counts:         f32 [B, L, S]    per-state vote weight
    ins_mbase:      f32 [B, L, S]    per-state weight of reads that carry an
                                     insertion after the column
    ins_len_votes:  f32 [B, L, K]    insertion length votes (bucket k =
                                     length k+1)
    ins_base_votes: f32 [B, L, K, 5] inserted base votes per offset
    """

    counts: torch.Tensor
    ins_mbase: torch.Tensor
    ins_len_votes: torch.Tensor
    ins_base_votes: torch.Tensor

    @property
    def coverage(self) -> torch.Tensor:
        return lane_sum(self.counts)
