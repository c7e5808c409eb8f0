"""Vote building: expanded alignments -> vote slabs or packed vote words.

Port of ``proovread_tpu/ops/votes.py``: ``build_votes`` (dense f32 vote
slabs, uniform or phred-weighted), ``encode_votes_packed_bases`` (one i32
word per window column, the unweighted path), ``word_to_bits`` (the word as
two i32 bit planes over the 64 vote lanes) and ``unpack_pileup``. JAX runs
with x64 off, so the taboo ``floor(aln_len * frac + 0.5)`` and the ``0.7 *
aln_len`` compare are f32 here too.

Vote lane layout (PACK_LANES wide):
    [0:6)    per-state column votes            (Pileup.counts)
    [8:14)   per-state has-insertion markers   (Pileup.ins_mbase)
    [16:22)  insertion length-bucket votes     (Pileup.ins_len_votes, K=6)
    [24:54)  inserted-base votes, offset-major (Pileup.ins_base_votes, K*5)

Packed word layout:
    bits 0-2:  plain-state field: 0 = no vote, else state+1 (1..6)
    bit  3:    has-insertion marker (lane 8+state)
    bits 4-6:  insertion length field: 0 = none, else min(eff_len, K)
    bits 7-24: six 3-bit inserted-base codes (offsets 0..5; 5 = none)
"""

from __future__ import annotations

import torch

from proovread_tpu_torch.ops.encode import GAP, N_STATES
from proovread_tpu_torch.ops.fused import phred2freq
from proovread_tpu_torch.ops.pileup import Pileup

PACK_LANES = 64
INS_CAP = 6


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _kept_region(q_start, q_end, taboo_frac: float, taboo_abs: int,
                 min_aln_length: int):
    """(kept_lo, kept_hi, ok): the InDelTaboo-trimmed query rows that vote
    and whether the alignment votes at all, in the reference's f32."""
    aln_len = q_end - q_start
    if taboo_abs:
        taboo = torch.full_like(aln_len, taboo_abs)
    else:
        taboo = torch.floor(aln_len.to(torch.float32) * taboo_frac
                            + 0.5).to(torch.int32)
    kept_lo = q_start + taboo
    kept_hi = q_end - taboo
    kept = kept_hi - kept_lo
    ok = ((aln_len > min_aln_length) & (kept >= min_aln_length)
          & (kept.to(torch.float32) >= aln_len.to(torch.float32) * 0.7))
    return kept_lo, kept_hi, ok


def build_votes(state, qrow, ins_len, q, qual, q_start, q_end, keep,
                ignore_cols=None, in_bounds=None, qual_weighted: bool = False,
                taboo_frac: float = 0.1, taboo_abs: int = 0,
                min_aln_length: int = 50) -> torch.Tensor:
    """Dense vote slabs f32 [R, n, PACK_LANES] for admitted (``keep``)
    candidates: the gates of ``encode_votes_packed_bases`` with each vote
    weighted by ``phred2freq`` of its query phred when ``qual_weighted``
    (a deletion by the lower phred of its two flanking query rows).

    q, qual: [R, m] strand-oriented query codes and phreds. Every lane gets
    at most one nonzero term, so the slab does not depend on add order."""
    R, n = state.shape
    m = q.shape[1]
    K = INS_CAP
    i32, f32 = torch.int32, torch.float32
    state, qrow, ins_len = state.to(i32), qrow.to(i32), ins_len.to(i32)
    q = q.to(torch.int64)
    qualf = qual.to(torch.int64)
    kept_lo, kept_hi, ok = _kept_region(q_start, q_end, taboo_frac,
                                        taboo_abs, min_aln_length)
    ok = ok & keep

    def at(x, rows):
        return torch.gather(x, 1, torch.clamp(rows, 0, m - 1).to(torch.int64))

    # 1D1I quirk (Sam/Seq.pm:413-419): a deletion column carrying an
    # insertion run becomes an M of the run's first base
    gapins = (state == GAP) & (ins_len > 0)
    qrow = torch.where(gapins, qrow + 1, qrow)
    state = torch.where(gapins, at(q, qrow).to(i32), state)
    ins_len = torch.where(gapins, ins_len - 1, ins_len)

    has_state = state >= 0
    in_keep = (qrow >= kept_lo[:, None]) & (qrow < kept_hi[:, None])
    col_ok = ok[:, None]
    if ignore_cols is not None:
        col_ok = col_ok & ~ignore_cols
    if in_bounds is not None:
        col_ok = col_ok & in_bounds
    live = has_state & in_keep & col_ok

    ones = torch.ones((R, n), dtype=f32, device=state.device)
    qq = at(qualf, qrow)
    if qual_weighted:
        w_m = phred2freq(qq)
        w_d = phred2freq(torch.minimum(qq, at(qualf, qrow + 1)))
    else:
        w_m = w_d = ones
    is_d = state == GAP
    weight = torch.where(live, torch.where(is_d, w_d, w_m), 0.0)

    st = torch.clamp(state, 0, N_STATES - 1)
    lanes = torch.arange(PACK_LANES, dtype=i32, device=state.device)

    def onehot(lane, w):
        return (lanes == lane[:, :, None]).to(f32) * w[:, :, None]

    packed = onehot(st, weight)

    # insertion votes, taboo-gated per inserted base: base k (forward
    # offset) was consumed at query row qrow+1+k; masked prefix steps shift
    # the run start (k0), masked suffix steps shorten it
    first_qi = qrow + 1
    k0 = torch.clamp(kept_lo[:, None] - first_qi, 0, 1 << 20)
    kept_len = torch.minimum(ins_len, kept_hi[:, None] - first_qi)
    eff_len = torch.clamp(kept_len - k0, 0, 1 << 20)
    eff_live = col_ok & (ins_len > 0) & (eff_len > 0)

    # length-bucket vote, weighted by the last kept inserted base
    w_last = (phred2freq(at(qualf, first_qi + k0 + eff_len - 1))
              if qual_weighted else ones)
    lbucket = torch.clamp(eff_len - 1, 0, K - 1)
    packed = packed + onehot(16 + lbucket, torch.where(eff_live, w_last, 0.0))

    # has-insertion marker: the run's original first step must be kept
    mb = live & ~is_d & eff_live & (k0 == 0)
    packed = packed + onehot(8 + st, torch.where(mb, weight, 0.0))

    for k in range(K):
        qi_k = first_qi + k0 + k
        b_k = at(q, qi_k).to(i32)
        w_k = phred2freq(at(qualf, qi_k)) if qual_weighted else ones
        v_k = torch.where(eff_live & (k < eff_len), w_k, 0.0)
        packed = packed + onehot(24 + 5 * k + torch.clamp(b_k, 0, 4), v_k)
    return packed


def encode_votes_packed_bases(state, qrow, ins_len, ins_b0, ins_b1,
                              q_start, q_end, ignore_cols=None,
                              taboo_frac: float = 0.1, taboo_abs: int = 0,
                              min_aln_length: int = 50) -> torch.Tensor:
    """Packed i32 vote words [R, n] from the kernel's expanded columns and
    packed inserted-base words. Admission is NOT applied here."""
    i32 = torch.int32
    K = INS_CAP
    state, qrow, ins_len = state.to(i32), qrow.to(i32), ins_len.to(i32)
    kept_lo, kept_hi, ok = _kept_region(q_start, q_end, taboo_frac,
                                        taboo_abs, min_aln_length)

    # 1D1I quirk rewrite: the run's first base becomes the column's M base;
    # the packed words shift right one base (arithmetic >> then a mask)
    gapins = (state == GAP) & (ins_len > 0)
    qrow = torch.where(gapins, qrow + 1, qrow)
    state = torch.where(gapins, ins_b0 & 7, state)
    ins_len = torch.where(gapins, ins_len - 1, ins_len)
    ins_b0_n = ((ins_b0 >> 3) & 0x07FFFFFF) | ((ins_b1 & 7) << 27)
    ins_b0 = torch.where(gapins, ins_b0_n, ins_b0)
    ins_b1 = torch.where(gapins, ins_b1 >> 3, ins_b1)

    has_state = state >= 0
    in_keep = (qrow >= kept_lo[:, None]) & (qrow < kept_hi[:, None])
    col_ok = ok[:, None]
    if ignore_cols is not None:
        col_ok = col_ok & ~ignore_cols
    live = has_state & in_keep & col_ok

    st = torch.clamp(state, 0, N_STATES - 1)
    word = torch.where(live, st + 1, 0).to(i32)

    first_qi = qrow + 1
    k0 = torch.clamp(kept_lo[:, None] - first_qi, 0, 1 << 20)
    kept_len = torch.minimum(ins_len, kept_hi[:, None] - first_qi)
    eff_len = torch.clamp(kept_len - k0, 0, 1 << 20)
    eff_live = col_ok & (ins_len > 0) & (eff_len > 0)

    word |= torch.where(live & (state != GAP) & eff_live & (k0 == 0),
                        8, 0).to(i32)
    word |= torch.where(eff_live, torch.clamp(eff_len, max=K), 0).to(i32) << 4

    for k in range(K):
        j = k0 + k                                     # forward base offset
        lo = (ins_b0 >> torch.clamp(3 * j, 0, 31)) & 7
        hi = (ins_b1 >> torch.clamp(3 * (j - 10), 0, 31)) & 7
        b_k = torch.where(j < 10, lo, hi)
        b_field = torch.where(eff_live & (k < eff_len) & (j < 20),
                              torch.clamp(b_k, 0, 4), 5).to(i32)
        word |= b_field << (7 + 3 * k)
    return word


def word_to_bits(word: torch.Tensor):
    """Packed i32 vote words [R, n] -> two i32 bit planes (vote lanes 0-31
    and 32-63): bit g set <=> lane g gets a +1 vote. Shifts run in int64
    and wrap to int32 (lane 31 sets the sign bit)."""
    w = word.to(torch.int64)
    st_f = w & 7
    len_f = (w >> 4) & 7
    one = torch.ones_like(w)
    zero = torch.zeros_like(w)
    st_on = st_f > 0
    b0 = torch.where(st_on, one << torch.clamp(st_f - 1, min=0), zero)
    b0 |= torch.where(st_on & (((w >> 3) & 1) > 0),
                      one << torch.clamp(8 + st_f - 1, min=0), zero)
    b0 |= torch.where(len_f > 0, one << torch.clamp(16 + len_f - 1, min=0),
                      zero)
    b1 = zero
    for k in range(INS_CAP):
        b_f = (w >> (7 + 3 * k)) & 7                  # 5 = none
        g = 24 + 5 * k + b_f
        live = (b_f < 5) & (len_f > 0)
        bit = one << (g & 31)
        b0 = b0 | torch.where(live & (g < 32), bit, zero)
        b1 = b1 | torch.where(live & (g >= 32), bit, zero)
    return _wrap32(b0), _wrap32(b1)


def unpack_pileup(pileup_packed: torch.Tensor, pad: int, length: int
                  ) -> Pileup:
    """Packed [B, pad + L + pad, PACK_LANES] -> Pileup tensors (f32)."""
    core = pileup_packed[:, pad:pad + length, :].to(torch.float32)
    K = INS_CAP
    B, L = core.shape[0], core.shape[1]
    return Pileup(core[:, :, 0:N_STATES], core[:, :, 8:8 + N_STATES],
                  core[:, :, 16:16 + K],
                  core[:, :, 24:24 + 5 * K].reshape(B, L, K, 5))
