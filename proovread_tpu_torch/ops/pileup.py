"""Pileup tensors of a batch of long reads (port of the ``Pileup`` tuple of
``proovread_tpu/ops/pileup.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


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
        return self.counts.sum(-1)
