"""Consensus call: per-column majority vote over the pileup tensors.

Port of ``proovread_tpu/ops/consensus_call.py``. A column's candidates are
the six plain states plus one insertion pseudo-state; ties go to the first
index (``torch.argmax``, like ``jnp.argmax``), keeping the plain-before-
insertion candidate order. Emitted per column: whether a base is emitted
(gap-majority columns are dropped), the base, up to K inserted bases, the
winning vote weight, its phred (sqrt(freq*120) capped at 40) and coverage.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from proovread_tpu_torch.consensus.params import MAX_PHRED, PROOVREAD_CONSTANT
from proovread_tpu_torch.obs.profile import attributed
from proovread_tpu_torch.ops.encode import GAP
from proovread_tpu_torch.ops.pileup import Pileup, lane_sum


class ConsensusCall(NamedTuple):
    emitted: torch.Tensor    # bool [B, L] column emits a base
    base: torch.Tensor       # i8   [B, L] emitted base (ref base if uncovered)
    ins_len: torch.Tensor    # i32  [B, L] inserted bases emitted after column
    ins_bases: torch.Tensor  # i8   [B, L, K] the inserted base codes
    freq: torch.Tensor       # f32  [B, L] winning vote weight
    phred: torch.Tensor      # i32  [B, L] phred of emitted base
    coverage: torch.Tensor   # f32  [B, L] total column coverage


def freqs_to_phreds(freq: torch.Tensor) -> torch.Tensor:
    p = torch.floor(torch.sqrt(torch.clamp(freq, min=0.0)
                               * PROOVREAD_CONSTANT) + 0.5)
    return torch.clamp(p, max=MAX_PHRED).to(torch.int32)


@attributed("call_consensus")
def call_consensus(pile: Pileup, ref_codes: torch.Tensor,
                   max_ins_length: int = 0) -> ConsensusCall:
    counts, ins_mbase = pile.counts, pile.ins_mbase
    S = counts.shape[-1]
    K = pile.ins_len_votes.shape[-1]

    plain = counts - ins_mbase
    ins_w = lane_sum(ins_mbase)
    maj_len = torch.where(ins_w > 0, torch.argmax(pile.ins_len_votes, -1) + 1,
                          0)
    ins_allowed = ins_w > 0
    if max_ins_length:
        ins_allowed &= (1 + maj_len) <= max_ins_length
    ins_cand = torch.where(ins_allowed, ins_w, 0.0)

    cand = torch.cat([plain, ins_cand[:, :, None]], -1)      # [B, L, S+1]
    winner = torch.argmax(cand, -1)
    max_freq = cand.max(-1).values

    covered = max_freq > 0.0
    is_ins = covered & (winner == S)
    is_gap = covered & (winner == GAP)

    ins_base = torch.argmax(ins_mbase, -1)
    base = torch.where(is_ins, ins_base, winner).to(torch.int8)
    base = torch.where(covered, base, ref_codes.to(torch.int8))
    emitted = ~covered | ~is_gap

    emit_ins = torch.where(is_ins, torch.clamp(maj_len, max=K), 0).to(
        torch.int32)
    ins_bases = torch.argmax(pile.ins_base_votes, -1).to(torch.int8)
    freq = torch.where(covered, torch.where(is_ins, ins_w, max_freq), 0.0)
    return ConsensusCall(emitted=emitted, base=base, ins_len=emit_ins,
                         ins_bases=ins_bases, freq=freq,
                         phred=freqs_to_phreds(freq),
                         coverage=pile.coverage)
