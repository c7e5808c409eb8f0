"""Pileup tensors of a batch of long reads (port of the ``Pileup`` tuple and
``init_pileup`` of ``proovread_tpu/ops/pileup.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from proovread_tpu_torch.ops.encode import N_STATES


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


def init_pileup(batch: int, length: int, ins_cap: int = 6,
                device=None) -> Pileup:
    """A zero pileup for ``batch`` reads of padded length ``length``."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return Pileup(counts=z(batch, length, N_STATES),
                  ins_mbase=z(batch, length, N_STATES),
                  ins_len_votes=z(batch, length, ins_cap),
                  ins_base_votes=z(batch, length, ins_cap, 5))
