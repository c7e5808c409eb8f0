"""Consensus results and the chimera entropy detector (port of the subset of
``proovread_tpu/consensus/engine.py`` the device finish path uses:
``ConsensusResult``, ``chimera_runs``, ``chimera_score`` and
``emit_prefix``; host numpy, ``Sam/Seq.pm:774-888``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from proovread_tpu_torch.io.records import SeqRecord


@dataclass
class ConsensusResult:
    record: SeqRecord                 # corrected read (id, seq, phred qual)
    freqs: np.ndarray                 # winning vote weight per consensus base
    coverage: np.ndarray              # total column coverage per ref column
    cigar: str                        # consensus->reference cigar (M/I/D)
    chimera: List[Tuple[int, int, float]] = field(default_factory=list)
    # (from, to, score) in corrected-sequence coords
    # per-ref-column emitted base count (1 + ins_len, 0 for dropped cols);
    # when present, emit_prefix derives coordinates from it directly — the
    # device finish path fills this instead of building a cigar string
    emit_counts: Optional[np.ndarray] = None

    @property
    def masked_frac(self) -> float:
        """Fraction of bases at phred 0 (uncorrected)."""
        if self.record.qual is None or len(self.record.qual) == 0:
            return 0.0
        return float((self.record.qual == 0).mean())


def chimera_runs(bin_bases, L, params, cover) -> List[Tuple[int, ...]]:
    """Geometry stage of the chimera scan (Sam/Seq.pm:774-812): runs of 1-4
    low-fill bins away from the 5 terminal bins, fully covered, with their
    window/flank coordinates. Returns (mat_from, mat_to, fl, tl, fr, tr)
    per candidate breakpoint region."""
    p = params
    if bin_bases is None or len(bin_bases) <= 20:
        return []
    thr = p.bin_max_bases / 5 + 1

    raw = []
    lcov = 0
    for i in range(5, len(bin_bases) - 5):
        if bin_bases[i] <= thr:
            lcov += 1
        else:
            if 1 <= lcov < 5:
                raw.append((i - lcov, i - 1))
            lcov = 0

    bs = p.bin_size
    out = []
    for (r0, r1) in raw:
        mat_from = (r0 - 1) * bs
        mat_to = (r1 + 2) * bs - 1
        if mat_from < 0 or mat_to >= L:
            continue
        if np.any(cover[mat_from: mat_to + 1] == 0):
            continue
        fl, tr = r0 - 4, r1 + 5
        delta = (tr - fl - 1) // 2
        out.append((mat_from, mat_to, fl, fl + delta, tr - delta, tr))
    return out


def chimera_score(runs, counts_fn, res, L, params
                  ) -> List[Tuple[int, int, float]]:
    """Entropy stage (Sam/Seq.pm:844-888): per run, per-column entropy of
    the combined window minus the max flank entropy; score = fraction of
    columns with delta > 0.7. ``counts_fn(mat_from, Wn, fl, tl, fr, tr)``
    returns the ([Wn, S+1], [Wn, S+1]) left/right state-count matrices."""
    emit_counts_prefix = None
    out = []
    bs = params.bin_size
    for (mat_from, mat_to, fl, tl, fr, tr) in runs:
        Wn = mat_to + 1 - mat_from
        cl, cr = counts_fn(mat_from, Wn, fl, tl, fr, tr)
        hx_delta = []
        for c in range(Wn):
            lcol, rcol = cl[c], cr[c]
            if lcol.sum() == 0 or rcol.sum() == 0:
                continue
            hx_delta.append(_hx(lcol + rcol) - max(_hx(lcol), _hx(rcol)))
        if not hx_delta:
            continue
        score = float(np.mean(np.array(hx_delta) > 0.7))
        f, t = mat_from + bs, mat_to - bs
        if emit_counts_prefix is None:
            emit_counts_prefix = emit_prefix(res, L)
        out.append((int(emit_counts_prefix[f]), int(emit_counts_prefix[t]), score))
    return out


def emit_prefix(res: ConsensusResult, L: int) -> np.ndarray:
    """corrected-coordinate of each reference column (prefix sum of emitted
    base counts), recovered from the consensus cigar — or directly from
    ``emit_counts`` when the result carries it (device finish path)."""
    import re as _re

    ec = getattr(res, "emit_counts", None)
    if ec is not None:
        emit = np.zeros(L + 1, np.int64)
        n = min(len(ec), L)
        emit[1:n + 1] = np.cumsum(ec[:n])
        emit[n + 1:] = emit[n]
        return emit

    emit = np.zeros(L + 1, np.int64)
    col = 0
    pos_corr = 0
    for m in _re.finditer(r"(\d+)([MID])", res.cigar):
        ln, op = int(m.group(1)), m.group(2)
        if op == "M":
            for _ in range(ln):
                emit[col] = pos_corr
                pos_corr += 1
                col += 1
        elif op == "I":
            for _ in range(ln):
                emit[col] = pos_corr
                col += 1
        else:  # D: extra consensus bases, no ref column consumed
            pos_corr += ln
    emit[col:] = pos_corr
    return emit


def _hx(col: np.ndarray) -> float:
    """Shannon entropy over nonzero counts (Sam/Seq.pm:188-197)."""
    nz = col[col > 0]
    if nz.size == 0:
        return 0.0
    p = nz / nz.sum()
    return float(-(p * np.log2(p)).sum())
