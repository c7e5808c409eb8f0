"""Final output trimming (port of ``proovread_tpu/pipeline/trim.py``):
quality-window trimming, min-length filter, and chimera breakpoint
splitting, with each read's trim funnel recorded while a QC recorder is
installed.

Covers the reference's final-output path (``bin/proovread:904-956``):
``ChimeraToSeqFilter.pl`` (chim.tsv -> substr coordinates, ``--min-score
0.2 --trim-length 20``, ``proovread.cfg:145-149``) piped into ``SeqFilter
--trim-win 12,5 --min-length 500 --substr``. SeqFilter's source is absent
upstream; trim-win is re-derived as sliding-window quality trimming (window
mean >= mean-min AND window min >= abs-min, scanning in from both ends) and
locked by our golden tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.obs import qc as obs_qc


@dataclass(frozen=True)
class TrimParams:
    win_mean_min: float = 12.0   # --trim-win arg 1 (proovread.cfg:152-155)
    win_abs_min: float = 5.0     # --trim-win arg 2
    win_size: int = 10
    min_length: int = 500        # --min-length
    chim_min_score: float = 0.2  # chimera-filter --min-score
    chim_trim_len: int = 20      # chimera-filter --trim-length


def split_chimera(rec: SeqRecord,
                  breakpoints: Sequence[Tuple[int, int, float]],
                  p: TrimParams) -> List[SeqRecord]:
    """Split a read at chimera junctions (ChimeraToSeqFilter.pl:171-203):
    breakpoints scoring >= min-score cut the read; trim-length bases on each
    side of the junction are dropped. Sub-reads are suffixed .1/.2/... via
    the SUBSTR annotation convention of Fastq::Seq (Fastq/Seq.pm:813-876)."""
    cuts = [(f, t) for (f, t, s) in breakpoints if s >= p.chim_min_score]
    if not cuts:
        return [rec]
    cuts.sort()
    n = len(rec)
    segments = []
    prev = 0
    for f, t in cuts:
        mid_f = max(prev, f - p.chim_trim_len)
        segments.append((prev, mid_f))
        prev = min(n, t + p.chim_trim_len)
    segments.append((prev, n))
    out = []
    for k, (a, b) in enumerate(segments):
        if b - a <= 0:
            continue
        out.append(SeqRecord(
            id=f"{rec.id}.{k + 1}",
            seq=rec.seq[a:b],
            qual=None if rec.qual is None else rec.qual[a:b],
            desc=(rec.desc + " " if rec.desc else "") + f"SUBSTR:{a},{b - a}",
        ))
    return out


def pieces_of(records: Sequence[SeqRecord], ids) -> List[SeqRecord]:
    """The records, in order, that are reads of ``ids`` or pieces
    ``split_chimera`` cut from them (``<id>.N``): a batch run's output cut
    back to one job's reads."""
    out = []
    for r in records:
        stem, _, sfx = r.id.rpartition(".")
        if r.id in ids or (sfx.isdigit() and stem in ids):
            out.append(r)
    return out


def trim_window(rec: SeqRecord, p: TrimParams) -> Optional[SeqRecord]:
    """Sliding-window quality trim from both ends; None if nothing survives."""
    if rec.qual is None or len(rec) == 0:
        return rec if len(rec) >= p.min_length else None
    q = rec.qual.astype(np.float32)
    n = len(q)
    w = min(p.win_size, n)
    if w == 0:
        return None
    c = np.concatenate([[0.0], np.cumsum(q)])
    means = (c[w:] - c[:-w]) / w                     # [n-w+1]
    from numpy.lib.stride_tricks import sliding_window_view
    mins = sliding_window_view(q, w).min(axis=1)
    ok = (means >= p.win_mean_min) & (mins >= p.win_abs_min)
    good = np.flatnonzero(ok)
    if good.size == 0:
        return None
    start = int(good[0])
    end = int(good[-1]) + w
    if end - start < p.min_length:
        return None
    return SeqRecord(id=rec.id, seq=rec.seq[start:end],
                     qual=rec.qual[start:end], desc=rec.desc)


def trim_records(
    results: Sequence,     # ConsensusResult list
    p: Optional[TrimParams] = None,
) -> List[SeqRecord]:
    """chimera-split + window-trim + min-length over consensus results.

    With a QC recorder installed (obs/qc.py), each read's trim funnel
    (chimera-split piece count, bases lost to the split margins, bases
    lost to the quality window and the min-length filter, dropped pieces
    counted whole, surviving bases) lands on its record."""
    p = p or TrimParams()
    rec = obs_qc.current()
    out: List[SeqRecord] = []
    for res in results:
        pieces = split_chimera(res.record, res.chimera, p)
        kept: List[SeqRecord] = []
        trim_lost = 0
        dropped = 0
        for piece in pieces:
            t = trim_window(piece, p)  # enforces min_length on all paths
            if t is None:
                dropped += 1
                trim_lost += len(piece)
            else:
                trim_lost += len(piece) - len(t)
                kept.append(t)
        if rec is not None:
            rec.record_trim(
                res.record.id, n_pieces=len(pieces),
                chimera_bases_lost=(len(res.record)
                                    - sum(len(pc) for pc in pieces)),
                trim_bases_lost=trim_lost, pieces_dropped=dropped,
                bases_out=sum(len(t) for t in kept))
        out.extend(kept)
    return out
