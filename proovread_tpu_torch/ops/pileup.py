"""Pileup tensors of a batch of long reads, and the scatter of alignment
column windows into them (port of ``proovread_tpu/ops/pileup.py``: the
``Pileup`` tuple, ``init_pileup`` and ``accumulate``).

The reference's per-column Perl hash increments (``Sam/Seq.pm:436-462``)
become flat scatter-adds; insertion voting uses three side tensors
(inserting-read weight per base, insertion-length votes, per-offset
inserted-base votes). The scatters go through
``ops/scatter.py:scatter_add_ordered``, which adds each cell's votes in the
reference's order on every device."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from proovread_tpu_torch.ops.encode import N_STATES
from proovread_tpu_torch.ops.scatter import scatter_add_ordered


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


def accumulate(
    pile: Pileup,
    read_idx: torch.Tensor,   # i32 [R]    target long read per alignment
    rpos: torch.Tensor,       # i32 [R]    0-based ref start of the window
    state: torch.Tensor,      # i8  [R, W] column state codes, -1 pad
    freq: torch.Tensor,       # f32 [R, W] vote weight
    ins_len: torch.Tensor,    # i16 [R, W] inserted bases after column
    ins_bases: torch.Tensor,  # i8  [R, W, K] inserted base codes
    valid: torch.Tensor,      # bool [R]
    ignore_mask: Optional[torch.Tensor] = None,  # bool [B, L] skip col
) -> Pileup:
    """Add one chunk of R alignment windows to the pileup (in place; the
    same tensors are returned), each tensor's votes in row-major order of
    the chunk, as the reference's four scatters add them."""
    B, L, S = pile.counts.shape
    K = pile.ins_len_votes.shape[-1]
    R, W = state.shape
    dev = state.device
    i64 = torch.int64

    cols = rpos.to(i64)[:, None] + torch.arange(W, device=dev)[None, :]
    ok = valid[:, None] & (state >= 0) & (cols >= 0) & (cols < L)
    flat = read_idx.to(i64)[:, None] * L + cols.clamp(0, L - 1)
    if ignore_mask is not None:
        ok &= ~ignore_mask.reshape(-1)[flat]
    w = torch.where(ok, freq, 0.0)
    st = state.to(i64).clamp(0, S - 1)
    scatter_add_ordered(pile.counts.view(-1), flat * S + st, w, ok)

    il = ins_len.to(i64)
    has_ins = ok & (il > 0)
    scatter_add_ordered(pile.ins_mbase.view(-1), flat * S + st, w, has_ins)
    lbucket = (il - 1).clamp(0, K - 1)
    scatter_add_ordered(pile.ins_len_votes.view(-1), flat * K + lbucket, w,
                        has_ins)
    # per-offset base votes: only offsets < the stored insertion length
    k = torch.arange(K, device=dev)[None, None, :]
    ins_ok = has_ins[:, :, None] & (k < il[:, :, None])
    ib = ins_bases.to(i64).clamp(0, 4)
    scatter_add_ordered(pile.ins_base_votes.view(-1),
                        (flat[:, :, None] * K + k) * 5 + ib,
                        w[:, :, None].expand(R, W, K), ins_ok)
    return pile
