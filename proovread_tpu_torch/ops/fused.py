"""Vote extraction for the scan engine: SW traceback steps -> pileup votes,
and the reference read's own votes (port of
``proovread_tpu/ops/fused.py``: ``fused_accumulate`` and ``add_ref_votes``).

``fused_accumulate`` turns each candidate's traceback stream (op, DP row,
DP column per step, end to start) into pileup votes and adds them into the
``Pileup`` tensors where the tensors lie, with the reference's rules: the
bowtie2/bwa "1D1I" rewrite, positional InDelTaboo trimming, the kept-region
admission (>= min_aln_length and >= 70% kept), MCR ignore columns and
insertion-run votes attached to the column before the run. Its four
scatters go through ``ops/scatter.py:scatter_add_ordered`` (the kernel
``csrc/scatter.cu`` on the card), which adds each cell's votes in index
order, the order of XLA's CPU scatter: fractional (qual-weighted) votes sum
to the reference's bits on every device.
"""

from __future__ import annotations

from typing import Optional

import torch

from proovread_tpu_torch.align.sw import OP_D, OP_I, OP_M, OP_NONE
from proovread_tpu_torch.ops.encode import GAP
from proovread_tpu_torch.ops.pileup import Pileup
from proovread_tpu_torch.obs.profile import attributed
from proovread_tpu_torch.ops.scatter import scatter_add_ordered


# round((phred^2/120)*100)/100 (Sam/Seq.pm:151-156) as XLA compiles the
# reference's f32 expression: both divisions become multiplications by
# constant reciprocals and the two scalings fold into one constant
_P2F_SCALE = torch.tensor(1.0 / 120.0, dtype=torch.float32) * 100.0
_P2F_UNIT = torch.tensor(0.01, dtype=torch.float32)


def phred2freq(p: torch.Tensor) -> torch.Tensor:
    """Phred -> vote weight in f32, rounding half to even."""
    pf = p.to(torch.float32)
    return (torch.round(pf * pf * _P2F_SCALE.to(pf.device))
            * _P2F_UNIT.to(pf.device))


@attributed("add_ref_votes")
def add_ref_votes(pile: Pileup, ref_codes: torch.Tensor,
                  ref_qual: torch.Tensor, length_mask: torch.Tensor
                  ) -> Pileup:
    """use_ref_qual: the long read's own bases vote with phred->freq weight
    (Sam/Seq.pm:255-266)."""
    S = pile.counts.shape[-1]
    w = phred2freq(ref_qual) * length_mask
    lanes = torch.arange(S, device=ref_codes.device)
    onehot = ((ref_codes.to(torch.int64)[:, :, None] == lanes)
              .to(torch.float32) * w[:, :, None])
    return pile._replace(counts=pile.counts + onehot)


@attributed("fused_accumulate")
def fused_accumulate(
    pile: Pileup,
    ops_rev: torch.Tensor,    # i8  [R, T] traceback ops (end->start)
    step_i: torch.Tensor,     # i16 [R, T] DP row per op (1-based)
    step_j: torch.Tensor,     # i16 [R, T] DP col per op (1-based)
    q: torch.Tensor,          # i8  [R, m] query codes (strand-oriented)
    qual: torch.Tensor,       # u8  [R, m] query phreds (strand-oriented)
    q_start: torch.Tensor,    # i32 [R] aligned query start
    q_end: torch.Tensor,      # i32 [R]
    read_idx: torch.Tensor,   # i32 [R] target long read
    win_start: torch.Tensor,  # i32 [R] window offset in the long read
    admitted: torch.Tensor,   # bool [R] passed threshold + bin admission
    ignore_mask: Optional[torch.Tensor] = None,  # bool [B, L] MCR columns
    qual_weighted: bool = False,
    taboo_frac: float = 0.1,
    taboo_abs: int = 0,
    min_aln_length: int = 50,
) -> Pileup:
    """Add one chunk's admitted alignments into ``pile`` (in place; the
    same tensors are returned)."""
    B, L, S = pile.counts.shape
    K = pile.ins_len_votes.shape[-1]
    R, T = ops_rev.shape
    dev = pile.counts.device
    i32 = torch.int32

    aln_len = q_end - q_start
    if taboo_abs:
        taboo = torch.full((R,), taboo_abs, dtype=i32, device=dev)
    else:
        taboo = torch.floor(aln_len.to(torch.float32) * taboo_frac
                            + 0.5).to(i32)
    kept_lo = q_start + taboo        # first kept query index
    kept_hi = q_end - taboo          # one past last kept
    kept = kept_hi - kept_lo
    ok = (admitted & (aln_len > min_aln_length)
          & (kept >= min_aln_length)
          & (kept.to(torch.float32) >= aln_len.to(torch.float32) * 0.7))

    op = ops_rev.to(i32)
    # "1D1I" (Sam/Seq.pm:413-419): an insertion run whose forward
    # predecessor is a deletion is a mismatch. In the reversed stream the
    # pair is (I at s, D at s+1) on one reference column: the I becomes an
    # M (keeping its query base) and the D dies.
    none_col = torch.full((R, 1), OP_NONE, dtype=i32, device=dev)
    next_op = torch.cat([op[:, 1:], none_col], 1)
    quirk = (op == OP_I) & (next_op != OP_I) & (next_op == OP_D)
    op = torch.where(quirk, OP_M, op)
    false_col = torch.zeros((R, 1), dtype=torch.bool, device=dev)
    d_dead = torch.cat([false_col, quirk[:, :-1]], 1)
    op = torch.where(d_dead, OP_NONE, op)

    live = (op != OP_NONE) & ok[:, None]
    qi = step_i.to(i32) - 1            # consumed query index (M/I)
    col = step_j.to(i32) - 1 + win_start[:, None]
    # taboo masking by query position (D uses its left neighbour q[i-1])
    live = live & (qi >= kept_lo[:, None]) & (qi < kept_hi[:, None])
    is_m = live & (op == OP_M)
    is_i = live & (op == OP_I)
    is_d = live & (op == OP_D)

    m = q.shape[1]
    qix = qi.clamp(0, m - 1).to(torch.int64)
    qbase = torch.gather(q, 1, qix).to(i32)
    qq = torch.gather(qual, 1, qix)
    qq_next = torch.gather(qual, 1, (qi + 1).clamp(0, m - 1).to(torch.int64))
    if qual_weighted:
        w_m = phred2freq(qq)
        w_d = phred2freq(torch.minimum(qq, qq_next))
    else:
        w_m = torch.ones(qq.shape, dtype=torch.float32, device=dev)
        w_d = w_m

    state = torch.where(is_d, GAP, qbase)
    weight = torch.where(is_d, w_d, w_m)
    plain = is_m | is_d
    flat = (read_idx.to(torch.int64)[:, None] * L
            + col.clamp(0, L - 1).to(torch.int64))
    if ignore_mask is not None:
        ig = ignore_mask.reshape(-1)[flat]
        plain = plain & ~ig
        is_i = is_i & ~ig
        is_m = is_m & plain
    in_bounds = (col >= 0) & (col < L)
    plain = plain & in_bounds
    is_i = is_i & in_bounds
    is_m = is_m & in_bounds

    # insertion runs (contiguous in s): with M[s] = min{s' >= s : not I},
    # the forward offset within the run is M[s] - 1 - s
    s_idx = torch.arange(T, dtype=i32, device=dev)[None, :]
    non_i_at = torch.where(is_i, T, s_idx)
    run_min = torch.flip(torch.cummin(torch.flip(non_i_at, [1]), 1).values,
                         [1])
    ins_off = (run_min - 1 - s_idx).clamp_min(0)
    prev_is_i = torch.cat([false_col, is_i[:, :-1]], 1)
    run_end = is_i & ~prev_is_i          # forward end of an insertion run
    m_has_ins = is_m & prev_is_i         # M whose forward successor is I

    st = state.clamp(0, S - 1).to(torch.int64)
    add = scatter_add_ordered
    add(pile.counts.view(-1), flat * S + st, weight, plain)
    add(pile.ins_mbase.view(-1), flat * S + st, weight, m_has_ins)
    # insertion votes attach to the column before the run: at step s that
    # is this step's column (I steps share the M's j)
    # (a run's length is its forward end's offset + 1, voted at bucket
    # length - 1)
    w_i = torch.where(is_i, w_m, 0.0)
    kk = ins_off.clamp(0, K - 1).to(torch.int64)
    add(pile.ins_len_votes.view(-1), flat * K + kk, w_i, run_end)
    ib = qbase.clamp(0, 4).to(torch.int64)
    add(pile.ins_base_votes.view(-1), (flat * K + kk) * 5 + ib, w_i,
        is_i & (ins_off < K))
    return pile
