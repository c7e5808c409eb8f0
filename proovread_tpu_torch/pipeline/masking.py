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
consensus call (``bin/bam2cns:382-391``). The device engine computes them
on the card (``ops/assemble_kernel.py:hcr_mask_rows``); ``mask_batch`` here
is the scan engine's host twin, in numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from proovread_tpu_torch.ops.encode import N


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


def _runs(mask: np.ndarray) -> List[Tuple[int, int]]:
    """[(start, end)) of True runs."""
    if mask.size == 0:
        return []
    d = np.diff(mask.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if mask[0]:
        starts = np.concatenate([[0], starts])
    if mask[-1]:
        ends = np.concatenate([ends, [len(mask)]])
    return list(zip(starts.tolist(), ends.tolist()))


def hcr_intervals(qual: np.ndarray, length: int, p: MaskParams) -> List[Tuple[int, int]]:
    """Final mask intervals [(offset, len)] for one read's consensus quals."""
    q = qual[:length]
    inq = (q >= p.phred_min) & (q <= p.phred_max)
    runs = [(s, e) for s, e in _runs(inq) if e - s >= p.mask_min_len]
    if not runs:
        return []

    # merge across short unmasked gaps
    merged = [list(runs[0])]
    for s, e in runs[1:]:
        if s - merged[-1][1] < p.unmask_min_len:
            merged[-1][1] = e
        else:
            merged.append([s, e])

    out = []
    red = p.mask_reduce
    end_red = int(round(p.mask_reduce * p.end_ratio))
    for s, e in merged:
        s2 = s + (end_red if s == 0 else red)
        e2 = e - (end_red if e == length else red)
        if e2 - s2 > 0:
            out.append((s2, e2 - s2))
    return out


def mask_batch(
    codes: np.ndarray,        # int8 [B, L] current consensus codes
    quals: Sequence[np.ndarray],  # per-read consensus phreds (true lengths)
    lengths: np.ndarray,
    p: MaskParams,
) -> Tuple[np.ndarray, List[List[Tuple[int, int]]], float]:
    """Apply HCR masking to a packed batch.

    Returns (masked codes copy, per-read MCR interval lists, masked_frac —
    the driver's "Masked : xx.x%" KPI, bin/proovread:1716-1718)."""
    masked = codes.copy()
    mcrs: List[List[Tuple[int, int]]] = []
    n_masked = 0
    total = int(np.sum(lengths))
    for i in range(codes.shape[0]):
        iv = hcr_intervals(np.asarray(quals[i]), int(lengths[i]), p)
        mcrs.append(iv)
        for off, ln in iv:
            masked[i, off:off + ln] = N
            n_masked += ln
    frac = n_masked / total if total else 0.0
    return masked, mcrs, frac
