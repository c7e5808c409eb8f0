"""Alignment records and the per-bin admission policy (port of
``proovread_tpu/consensus/alnset.py``).

``Alignment`` is the minimal record the engine needs (the role of
``lib/Sam/Alignment.pm``); ``AlnSet`` groups the alignments of one long read
and applies score filters, the coverage and utg filters, and score-binned
coverage-capped admission: the parallel reformulation of
``Sam::Seq::add_aln_by_score`` (``Sam/Seq.pm:582-614``), alignments ranked by
ncscore per bin and admitted while the bin's base budget lasts.
``admit_mask`` is its array twin, the scan engine's host admission (f64
sums, the oracle the device admission is held against).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from proovread_tpu_torch.consensus.cigar import I, M, parse_cigar, ref_span
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

    @classmethod
    def from_cigar_str(cls, qname, pos0, seq_codes, cigar, **kw
                       ) -> "Alignment":
        ops, lens = parse_cigar(cigar)
        return cls(qname=qname, pos0=pos0,
                   seq_codes=np.asarray(seq_codes, np.int8), ops=ops,
                   lens=lens, **kw)

    @property
    def span(self) -> int:
        """Reference span (M+D) — the 'length' used for bins, coverage and
        nscore (Sam/Alignment.pm soft-clip branch :393-431)."""
        if self._span is None:
            self._span = ref_span(self.ops, self.lens)
        return self._span

    @property
    def q_len(self) -> int:
        """Aligned query length (M+I), what ``Sam::Alignment::length``
        returns for un-clipped records; the contained and rep-region
        filters range-test with it (Sam/Seq.pm:995,1008)."""
        keep = (self.ops == M) | (self.ops == I)
        return int(self.lens[keep].sum())

    def effective_score(self, invert: bool) -> Optional[float]:
        if self.score is None:
            return None
        return -self.score if invert else self.score

    def nscore(self, invert: bool) -> Optional[float]:
        s = self.effective_score(invert)
        if s is None or self.span == 0:
            return None
        return s / self.span

    def ncscore(self, invert: bool) -> Optional[float]:
        ns = self.nscore(invert)
        if ns is None:
            return None
        return ns * (self.span / (NCSCORE_CONSTANT + self.span))


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
    """Alignments of one long read, plus admission bookkeeping."""

    ref_id: str
    ref_len: int
    alns: List[Alignment] = field(default_factory=list)
    params: ConsensusParams = field(default_factory=ConsensusParams)
    # filled by admit():
    bin_bases: Optional[np.ndarray] = None   # float per bin, admitted bases
    aln_bins: Optional[np.ndarray] = None    # bin of each admitted aln

    @property
    def n_bins(self) -> int:
        return self.ref_len // self.params.bin_size + 1

    def bins_of(self, alns: Sequence[Alignment]) -> np.ndarray:
        """bin = floor((pos_1based + span/2)/bin_size) (Sam/Seq.pm:1354-1357)."""
        if not alns:
            return np.zeros(0, np.int32)
        pos1 = np.array([a.pos0 + 1 for a in alns], np.float64)
        spans = np.array([a.span for a in alns], np.float64)
        b = ((pos1 + spans / 2) / self.params.bin_size).astype(np.int32)
        return np.clip(b, 0, self.n_bins - 1)

    def filter_by_scores(self) -> None:
        """min_score / min_nscore / min_ncscore cutoffs (Sam/Seq.pm:899-927).
        Alignments with no score are dropped when a cutoff is set."""
        p = self.params
        inv = p.invert_scores

        def keep(a: Alignment) -> bool:
            for cut, score in ((p.min_score, a.effective_score),
                               (p.min_nscore, a.nscore),
                               (p.min_ncscore, a.ncscore)):
                if cut is not None:
                    s = score(inv)
                    if s is None or s < cut:
                        return False
            return True

        self.alns = [a for a in self.alns if keep(a)]

    # -- coverage + utg filters (Sam/Seq.pm:746-764,949-1084) ------------
    def coverage(self) -> np.ndarray:
        """Per-position alignment coverage from untrimmed reference spans
        (the reference sums taboo-trimmed state-matrix columns,
        ``Sam/Seq.pm:746-764``; span counting differs only at the few
        trimmed edge bases and needs no matrix build)."""
        cov = np.zeros(self.ref_len, np.int32)
        for a in self.alns:
            lo = max(0, a.pos0)
            hi = min(self.ref_len, a.pos0 + a.span)
            cov[lo:hi] += 1
        return cov

    def high_coverage_windows(self, cmax: float) -> List[Tuple[int, int]]:
        """[offset, length] runs where coverage >= cmax (the rep-region /
        utg overlap-window scan, Sam/Seq.pm:957-974, bam2cns:402-422)."""
        cov = self.coverage()
        high = np.flatnonzero(cov >= cmax)
        if high.size == 0:
            return []
        breaks = np.flatnonzero(np.diff(high) > 1)
        starts = np.concatenate([[high[0]], high[breaks + 1]])
        ends = np.concatenate([high[breaks], [high[-1]]]) + 1
        return [(int(s), int(e - s)) for s, e in zip(starts, ends)]

    def _rebin(self) -> None:
        spans = np.array([a.span for a in self.alns], np.float64)
        self.bin_bases = np.bincount(self.aln_bins, weights=spans,
                                     minlength=self.n_bins)

    def filter_rep_region_alns(self, rep_coverage: Optional[float] = None
                               ) -> None:
        """Drop alignments fully contained in repeat windows: coverage >=
        RepCoverage runs, extended by 150bp each side and clipped to the
        read (Sam/Seq.pm:949-999)."""
        cmax = (rep_coverage if rep_coverage is not None
                else self.params.rep_coverage)
        if not cmax:
            return
        rwin = []
        for s, ln in self.high_coverage_windows(cmax):
            lo = max(0, s - 150)
            rwin.append([lo, min(s + ln + 150, self.ref_len) - lo])
        if not rwin:
            return
        keep = np.array([not _is_in_range((a.pos0, a.q_len), rwin)
                         for a in self.alns], bool)
        self.alns = [a for a, k in zip(self.alns, keep) if k]
        if self.aln_bins is not None:       # keep admission bookkeeping
            self.aln_bins = self.aln_bins[keep]
            self._rebin()

    def filter_contained_alns(self) -> None:
        """Drop alignments contained (after edge shrink: hits <21bp collapse
        to their center, longer hits lose 10% per side) within a longer
        alignment's span; near-identical-length pairs keep the higher score
        (Sam/Seq.pm:1001-1047)."""
        inv = self.params.invert_scores
        alns = list(self.alns)
        # queue sorted by aligned query length descending; pop shortest
        # from the tail (the reference ranges on Sam::Alignment::length)
        order = sorted(range(len(alns)), key=lambda i: -alns[i].q_len)
        iids = list(order)
        coords = [[alns[i].pos0, alns[i].q_len] for i in order]
        scores = [alns[i].effective_score(inv) or 0.0 for i in order]
        removed = set()
        while len(iids) > 1:
            iid = iids.pop()
            coo = coords.pop()
            if coo[1] < 21:
                coo = [coo[0] + coo[1] // 2, 1]
            else:
                ad = int(coo[1] * 0.1)
                coo = [coo[0] + ad, coo[1] - 2 * ad]
            if _is_in_range(coo, coords):
                if coo[1] > coords[-1][1] - 40:
                    # near-identical length: keep the better-scoring one
                    i = len(coords)
                    if scores[i] > scores[i - 1]:
                        iid_restore = iid
                        iid = iids.pop()
                        coords.pop()
                        iids.append(iid_restore)
                        coords.append(coo)
                removed.add(iid)
        self.alns = [a for j, a in enumerate(alns) if j not in removed]

    def filter_by_coverage(self, cov: float) -> None:
        """Tighten the per-bin base budget to ``cov`` x bin_size and evict
        the lowest-ranked admitted alignments of each over-full bin
        (Sam/Seq.pm:1059-1084). Requires a prior :meth:`admit`."""
        if cov >= self.params.max_coverage or self.aln_bins is None:
            return
        budget = cov * self.params.bin_size
        inv = self.params.invert_scores
        keep = np.ones(len(self.alns), bool)
        for b in np.unique(self.aln_bins):
            mine = np.flatnonzero(self.aln_bins == b)
            if mine.size < 2:
                continue
            spans = np.array([self.alns[i].span for i in mine], np.float64)
            scores = np.array(
                [s if (s := self.alns[i].ncscore(inv)) is not None
                 else -np.inf for i in mine])
            order = mine[np.lexsort((mine, -scores))]
            ospans = np.array([self.alns[i].span for i in order],
                              np.float64)
            total = spans.sum()
            drop = 0
            while total > budget and mine.size - drop >= 2:
                drop += 1
                total -= ospans[-drop]
            if drop:
                keep[order[len(order) - drop:]] = False
        idx = np.flatnonzero(keep)
        self.alns = [self.alns[i] for i in idx]
        self.aln_bins = self.aln_bins[idx]
        self._rebin()

    def admit(self, cap_coverage: bool = True) -> None:
        """Score-binned admission: per bin, rank by ncscore (desc) and admit
        while the cumulative admitted bases *before* an alignment stay within
        bin_max_bases (the reference admits the crossing alignment too:
        Sam/Seq.pm:591). With ``cap_coverage`` False (utg mode's plain
        add_aln, which needs no score) all alignments are kept."""
        p = self.params
        alns = (list(self.alns) if not cap_coverage else
                [a for a in self.alns
                 if a.ncscore(p.invert_scores) is not None])
        if not alns:
            self.alns = []
            self.aln_bins = np.zeros(0, np.int32)
            self.bin_bases = np.zeros(self.n_bins, np.float64)
            return
        bins = self.bins_of(alns)
        spans = np.array([a.span for a in alns], np.float64)
        if not cap_coverage:
            self.alns = alns
            self.aln_bins = bins
            self.bin_bases = np.bincount(bins, weights=spans,
                                         minlength=self.n_bins)
            return
        scores = np.array([a.ncscore(p.invert_scores) for a in alns],
                          np.float64)
        # stable sort by (bin asc, score desc, original order asc)
        order = np.lexsort((np.arange(len(alns)), -scores, bins))
        sbins = bins[order]
        sspans = spans[order]
        # cumulative bases before each aln within its bin
        cum = np.cumsum(sspans)
        bin_start = np.searchsorted(sbins, sbins)
        bases_before_bin = np.where(bin_start > 0, cum[bin_start - 1], 0.0)
        cum_before = cum - sspans - bases_before_bin
        admit = cum_before <= p.bin_max_bases
        keep_idx = np.sort(order[admit])
        self.alns = [alns[i] for i in keep_idx]
        self.aln_bins = bins[keep_idx]
        self.bin_bases = np.bincount(
            self.aln_bins, weights=spans[keep_idx], minlength=self.n_bins)
