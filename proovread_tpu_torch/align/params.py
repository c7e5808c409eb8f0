"""Alignment scoring parameters — the bwa-proovread PacBio scheme.

The reference drives its bwa fork with ``-A 5 -B 11 -O 2,1 -E 4,3 -L 30,30``
and per-task seed/band/threshold schedules (``proovread.cfg:320-333``,
``:344-366``); the same scheme appears in shrimp options
(``proovread.cfg:308-312``) and dazz2sam's rescoring (``bin/dazz2sam:22-29``).
``-T`` is a *per-base* output threshold in the fork (``proovread.cfg:325``
"per-base-score !!").

bwa convention: ``-O o_del,o_ins -E e_del,e_ins``; a deletion (gap in the
read) of length k costs ``o_del + k*e_del``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class AlignParams:
    match: int = 5            # -A
    mismatch: int = 11        # -B (penalty, positive)
    o_del: int = 2            # -O[0]
    e_del: int = 4            # -E[0]
    o_ins: int = 1            # -O[1]
    e_ins: int = 3            # -E[1]
    n_penalty: int = 1        # ambiguous-base penalty (bwa scores N as -1)
    clip: int = 30            # -L head/tail soft-clip penalty
    min_seed_len: int = 12    # -k
    band_width: int = 40      # -w
    min_out_score: float = 2.5  # -T
    score_per_base: bool = True  # bwa-proovread's per-base -T semantics
    max_occ: int = 500        # -c: skip seeds occurring more often
    max_candidates: int = 8   # extension windows kept per read+strand

    @property
    def threshold(self):
        """Output score threshold for a query of length qlen."""
        if self.score_per_base:
            return lambda qlen: self.min_out_score * qlen
        return lambda qlen: self.min_out_score


# per-task schedules mirroring proovread.cfg:320-366
BWA_SR = AlignParams()
BWA_SR_FINISH = replace(
    AlignParams(), mismatch=13, o_del=15, e_del=3, o_ins=19, e_ins=3,
    min_seed_len=17, band_width=30, min_out_score=4.0,
)
BWA_MR_1 = replace(AlignParams(), min_out_score=2.5)
BWA_MR = replace(AlignParams(), min_seed_len=13, min_out_score=3.0)
BWA_MR_FINISH = replace(
    AlignParams(), mismatch=13, o_del=15, e_del=3, o_ins=19, e_ins=3,
    min_seed_len=19, band_width=30, min_out_score=4.0,
)
CCS = replace(AlignParams(), band_width=40)  # ccseq self-mapping (bin/ccseq:378-383)

TASK_PARAMS = {
    "bwa-sr": BWA_SR,
    "bwa-sr-finish": BWA_SR_FINISH,
    "bwa-mr-1": BWA_MR_1,
    "bwa-mr": BWA_MR,
    "bwa-mr-finish": BWA_MR_FINISH,
}

