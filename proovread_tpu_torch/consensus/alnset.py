"""Alignment records grouped per long read, and score-binned admission: the
part of ``proovread_tpu/consensus/alnset.py`` that the host mapper,
siamaera and the scan engine use.

``Alignment`` is the minimal record the engine needs (the role of
``lib/Sam/Alignment.pm``); ``AlnSet`` groups the alignments of one long read.
``admit_mask`` is the host admission of the scan engine (f64 sums, the
oracle the device admission is held against): alignments are ranked by
ncscore per bin and admitted while the bin's base budget lasts, the parallel
reformulation of ``Sam::Seq::add_aln_by_score`` (``Sam/Seq.pm:582-614``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from proovread_tpu_torch.consensus.cigar import ref_span
from proovread_tpu_torch.consensus.params import (NCSCORE_CONSTANT,
                                                  ConsensusParams)


@dataclass
class Alignment:
    """One short-read (or unitig) alignment onto a long read."""

    qname: str
    pos0: int                       # 0-based reference position
    seq_codes: np.ndarray           # int8 query codes incl. soft-clipped bases
    ops: np.ndarray                 # CIGAR op codes (cigar.M/I/D/S/H)
    lens: np.ndarray                # CIGAR op lengths
    qual: Optional[np.ndarray] = None  # uint8 phreds or None
    score: Optional[float] = None   # AS tag
    flag: int = 0
    _span: Optional[int] = None

    @property
    def span(self) -> int:
        """Reference span (M+D) — the 'length' used for bins, coverage and
        nscore (Sam/Alignment.pm soft-clip branch :393-431)."""
        if self._span is None:
            self._span = ref_span(self.ops, self.lens)
        return self._span


def admit_mask(
    read_idx: np.ndarray,    # i32 [R] target long read per alignment
    pos0: np.ndarray,        # i32 [R] 0-based ref position
    span: np.ndarray,        # i32 [R] reference span (M+D)
    score: np.ndarray,       # f32 [R] alignment score (AS)
    ref_lens: np.ndarray,    # i32 [B] long-read lengths
    params: ConsensusParams,
    valid: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Vectorized score-binned admission over flat candidate arrays — the
    array-level twin of :meth:`AlnSet.admit` (``Sam/Seq.pm:582-614``) used by
    the fused device path. Returns a bool keep-mask."""
    R = len(read_idx)
    keep = np.ones(R, bool) if valid is None else valid.copy()
    keep &= span > 0
    eff = -score if params.invert_scores else score
    ncscore = np.where(span > 0, eff / (NCSCORE_CONSTANT + span), -np.inf)
    if params.min_score is not None:
        keep &= eff >= params.min_score
    if params.min_nscore is not None:
        keep &= np.where(span > 0, eff / np.maximum(span, 1), -np.inf) >= params.min_nscore
    if params.min_ncscore is not None:
        keep &= ncscore >= params.min_ncscore
    if not keep.any():
        return keep

    bs = params.bin_size
    n_bins = ref_lens.astype(np.int64) // bs + 1
    bin_of = ((pos0 + 1 + span / 2) / bs).astype(np.int64)
    bin_of = np.clip(bin_of, 0, n_bins[read_idx] - 1)
    gbin = read_idx.astype(np.int64) * int(n_bins.max()) + bin_of

    idx = np.flatnonzero(keep)
    order = idx[np.lexsort((idx, -ncscore[idx], gbin[idx]))]
    sbins = gbin[order]
    sspans = span[order].astype(np.float64)
    cum = np.cumsum(sspans)
    first = np.searchsorted(sbins, sbins)
    before_bin = np.where(first > 0, cum[first - 1], 0.0)
    cum_before = cum - sspans - before_bin
    admit = cum_before <= params.bin_max_bases
    out = np.zeros(R, bool)
    out[order[admit]] = True
    return out


def _is_in_range(c: Sequence[int], ranges: Sequence[Sequence[int]]) -> bool:
    """True iff [offset, length) range ``c`` lies fully inside any of
    ``ranges`` (Sam/Seq.pm:2063-2086)."""
    c1, c2 = c[0], c[0] + c[1] - 1
    for r in ranges:
        if r[0] <= c1 < r[0] + r[1] and r[0] <= c2 < r[0] + r[1]:
            return True
    return False


@dataclass
class AlnSet:
    """Alignments of one long read."""

    ref_id: str
    ref_len: int
    alns: List[Alignment] = field(default_factory=list)
