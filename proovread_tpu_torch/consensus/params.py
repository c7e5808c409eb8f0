"""Engine knobs, defaults matching the reference's class attributes
(``Sam/Seq.pm:113-128``) and core config (``proovread.cfg:188-302``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

PROOVREAD_CONSTANT = 120.0   # freq<->phred scale (Sam/Seq.pm:20-33)
NCSCORE_CONSTANT = 40.0      # short-aln penalty (Sam/Alignment.pm:245-247)
MAX_PHRED = 40


@dataclass(frozen=True)
class ConsensusParams:
    bin_size: int = 20                      # BinSize
    max_coverage: int = 50                  # MaxCoverage
    indel_taboo: float = 0.1                # InDelTaboo (fraction of read)
    indel_taboo_length: Optional[int] = None  # absolute override (sr-indel-taboo-length=7)
    trim: bool = True                       # Trim (head/tail indel-taboo trimming)
    min_aln_length: int = 50                # StateMatrixMinAlnLength
    max_ins_length: int = 0                 # MaxInsLength, 0 = unlimited
    fallback_phred: int = 1                 # FallbackPhred
    rep_coverage: int = 0                   # RepCoverage, 0 = filter off
    min_score: Optional[float] = None
    min_nscore: Optional[float] = None
    min_ncscore: Optional[float] = None
    phred_offset: int = 33
    qual_weighted: bool = False
    use_ref_qual: bool = False
    invert_scores: bool = False             # blasr-style descending scores
    ins_cap: int = 6                        # device-side insertion vote cap (bases per column)

    @property
    def bin_max_bases(self) -> int:
        return self.bin_size * self.max_coverage

    def taboo_len(self, read_len: int) -> int:
        if self.indel_taboo_length:
            return self.indel_taboo_length
        return int(read_len * self.indel_taboo + 0.5)
