"""High-confidence-region (HCR) masking between iterations.

Reimplements the load-bearing semantics of ``SeqFilter --phred-mask
p1,p2,mask-min-len,unmask-min-len,mask-reduce,mask-end-ratio``
(``proovread.cfg:230-242``, invoked ``bin/proovread:1702-1714``). The
SeqFilter submodule source is absent upstream (``.gitmodules:1-3``), so these
semantics are re-derived from the parameter names, the driver's usage and the
README's description ("masked regions ... minus some edge fraction, which
remains unmasked in order to serve as seeds", ``README.org:205-210``) and
locked down by our own golden tests:

1. find maximal runs of consensus phred within [p1, p2] (well-supported
   corrected bases; p2=41 covers the 40 cap);
2. keep runs >= mask_min_len (scaled to the effective short-read length by
   the driver, ``bin/proovread:1703-1704``);
3. merge kept runs separated by unmasked gaps < unmask_min_len — a gap
   shorter than a short read cannot anchor new alignments anyway;
4. shrink every interval by mask_reduce at interior boundaries so the HCR
   edges stay unmasked as alignment seeds; boundaries touching a read end
   shrink by mask_reduce * end_ratio instead (less seed margin needed where
   alignments can run off the end);
5. drop intervals that shrink away.

The resulting intervals serve double duty, as in the reference: N-masking of
the next iteration's mapping target, and MCR ignore-coords for the next
consensus call (``bin/bam2cns:382-391``). The port computes them on the
device (``ops/assemble_kernel.py:hcr_mask_rows``); this module keeps the
parameters.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MaskParams:
    phred_min: int = 20
    phred_max: int = 41
    mask_min_len: int = 80      # at 100bp short reads; driver scales by sr_len/100
    unmask_min_len: int = 130   # likewise scaled
    mask_reduce: int = 60
    end_ratio: float = 0.7

    @classmethod
    def from_cfg_string(cls, s: str) -> "MaskParams":
        p = s.split(",")
        return cls(int(p[0]), int(p[1]), int(p[2]), int(p[3]), int(p[4]),
                   float(p[5]))

    def scaled(self, sr_len: int) -> "MaskParams":
        """Scale the length knobs to the effective short-read length
        (bin/proovread:1703-1704)."""
        return MaskParams(
            self.phred_min, self.phred_max,
            int(self.mask_min_len * sr_len / 100 + 0.5),
            int(self.unmask_min_len * sr_len / 100 + 0.5),
            self.mask_reduce, self.end_ratio,
        )

