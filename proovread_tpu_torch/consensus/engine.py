"""Consensus results, host assembly and the chimera entropy detector (port of
the part of ``proovread_tpu/consensus/engine.py`` that the device finish
path and the scan engine use: ``ConsensusResult``, ``assemble_consensus``,
``chimera_runs``, ``chimera_score``, ``chimera_scan``, ``window_counts``
and ``emit_prefix``; host numpy, ``Sam/Seq.pm:774-888``). The batched
``ConsensusEngine`` over alignment sets comes with the modes that use it."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from proovread_tpu_torch.consensus.cigar import ColumnStates
from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.ops.encode import N_STATES, decode_codes


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


def assemble_consensus(
    rid, emitted, base, ins_len, ins_bases, freq, phred, coverage
) -> ConsensusResult:
    """Host assembly of one read's consensus call: emitted columns + inserted
    bases -> sequence/qual/freq arrays and the trace cigar (M per emitted
    column, +D per inserted base, I per dropped column — Sam::Seq trace
    semantics, Sam/Seq.pm:1625-1635)."""
    n = len(emitted)
    emit_counts = np.where(emitted, 1 + ins_len, 0)
    total = int(emit_counts.sum())
    seq = np.zeros(total, np.int8)
    quals = np.zeros(total, np.uint8)
    freqs = np.zeros(total, np.float32)
    # target offset of each column's first emitted base
    offs = np.concatenate([[0], np.cumsum(emit_counts)[:-1]])
    em = emitted.astype(bool)
    seq[offs[em]] = base[em]
    quals[offs[em]] = phred[em]
    freqs[offs[em]] = freq[em]
    ins_cols = np.flatnonzero(em & (ins_len > 0))
    for c in ins_cols:
        k = int(ins_len[c])
        o = int(offs[c]) + 1
        seq[o : o + k] = ins_bases[c, :k]
        quals[o : o + k] = phred[c]
        freqs[o : o + k] = freq[c]

    cigar_parts = []
    run_char, run_len = None, 0
    for c in range(n):
        chars = "I" if not em[c] else ("M" + "D" * int(ins_len[c]))
        for ch in chars:
            if ch == run_char:
                run_len += 1
            else:
                if run_char is not None:
                    cigar_parts.append(f"{run_len}{run_char}")
                run_char, run_len = ch, 1
    if run_char is not None:
        cigar_parts.append(f"{run_len}{run_char}")

    rec = SeqRecord(id=rid, seq=decode_codes(seq), qual=quals)
    return ConsensusResult(
        record=rec,
        freqs=freqs,
        coverage=coverage,
        cigar="".join(cigar_parts),
    )


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


def chimera_scan(bin_bases, L, params, res, cover, select) -> List[Tuple[int, int, float]]:
    """Chimera core (Sam/Seq.pm:774-888) in terms of the two stages above.

    ``select(fl, tl, fr, tr)`` returns (left, right) lists of
    :class:`ColumnStates` for alignments whose bin falls in those ranges."""
    runs = chimera_runs(bin_bases, L, params, cover)
    if not runs:
        return []

    def counts_fn(mat_from, Wn, fl, tl, fr, tr):
        sel_l, sel_r = select(fl, tl, fr, tr)
        return (window_counts(sel_l, mat_from, Wn),
                window_counts(sel_r, mat_from, Wn))

    return chimera_score(runs, counts_fn, res, L, params)


def window_counts(sel: Sequence[ColumnStates], mat_from: int, Wn: int) -> np.ndarray:
    """[Wn, S+1] plain state counts + merged-insertion pseudo-state."""
    counts = np.zeros((Wn, N_STATES + 1), np.float64)
    for cs in sel:
        lo = max(cs.rpos, mat_from)
        hi = min(cs.rpos + cs.span, mat_from + Wn)
        if lo >= hi:
            continue
        w0, w1 = lo - cs.rpos, hi - cs.rpos
        cols = np.arange(lo - mat_from, hi - mat_from)
        st = cs.state[w0:w1].astype(np.int64)
        has_ins = cs.ins_len[w0:w1] > 0
        np.add.at(counts, (cols[~has_ins], st[~has_ins]), 1.0)
        np.add.at(counts, (cols[has_ins], np.full(has_ins.sum(), N_STATES)), 1.0)
    return counts


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
