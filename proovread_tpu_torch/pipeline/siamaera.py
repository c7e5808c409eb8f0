"""Siamaera filter: trim reverse-complement self-chimeras.

Unsplit PacBio subreads read through the hairpin adapter and come out as
``----R---> --J-- <--R.rc--`` palindromes ("siamaera"). The reference
(``bin/siamaera``) detects them with a minus-strand blastn self-alignment
(``:490-534``) and trims to the longest non-chimeric arm; reads with >2 HSPs
are dropped as inconclusive. Defaults: seq_min_len 150, aln_min_idy 97.5,
term_ignore_len 10, trim 5 (``bin/siamaera:123-134``).

Rebuild: the minus-strand self-alignment is our own SW of read windows
against the read's reverse complement (one batched mapper call for the whole
read set); window hits merge by diagonal into HSPs. Identity >= 97.5% maps
to a per-base score cutoff under the PacBio scheme
(5*idy - 16*(1-idy): 97.5% ~ 4.48/bp).

Port of ``proovread_tpu/pipeline/siamaera.py``: the same windows, merge
rules and trims, mapped through ``TorchMapper`` (the ``csrc/sw.cu`` kernel
on the card). Each trim or drop lands on the read's QC record while a
recorder is installed (``obs/qc.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from proovread_tpu_torch.align.mapper import TorchMapper
from proovread_tpu_torch.align.params import AlignParams
from proovread_tpu_torch.io.batch import pack_reads
from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.obs import qc as obs_qc
from proovread_tpu_torch.ops.encode import (decode_codes, encode_ascii,
                                            revcomp_codes)


@dataclass(frozen=True)
class SiamaeraParams:
    seq_min_len: int = 150       # bin/siamaera:123-134
    min_idy: float = 97.5
    term_ignore_len: int = 10
    trim: int = 5
    window: int = 256
    overlap: int = 32
    merge_band: int = 80         # diagonal tolerance when merging window hits
    # max query gap bridged when merging same-diagonal hits: windows that
    # straddle the junction align through the rc'd junction (local SW has no
    # x-drop) and fail the identity cutoff, so a joined palindrome's arms
    # arrive with a junction-sized hole between them — but they share one
    # diagonal, which is the siamaera signature
    merge_gap: int = 512
    sym_tol: int = 100           # symmetry tolerance of HSP pairs
    min_hsp_len: int = 100

    @property
    def min_per_base_score(self) -> float:
        f = self.min_idy / 100.0
        return 5.0 * f - 16.0 * (1.0 - f)


@dataclass
class SiamaeraStats:
    checked: int = 0
    trimmed: int = 0
    dropped: int = 0


def _hsps_for_read(alns, n: int, p: SiamaeraParams) -> List[Tuple[int, int, int, int]]:
    """Merge window alignments on the read's revcomp into HSPs
    (q_start, q_end, s_start, s_end) in (read, rc-read) coordinates."""
    hits = []
    for a in alns:
        # window ids are "{read_id}|w:{start}"; the suffix is the window's
        # offset into the read (= query offset of the window's base 0)
        q_off = int(a.qname.rsplit(":", 1)[1]) if "|w:" in a.qname else 0
        span = a.span
        qlen = len(a.seq_codes)
        # soft-clip head length = query offset of aligned part
        head = int(a.lens[0]) if len(a.ops) and a.ops[0] == 3 else 0
        tail = int(a.lens[-1]) if len(a.ops) and a.ops[-1] == 3 else 0
        alen = qlen - head - tail
        if alen < 32 or a.score is None:
            continue
        if a.score / max(alen, 1) < p.min_per_base_score:
            continue
        if a.flag & 16:
            continue  # rc window on rc read = plus-strand self-match; skip
        qs = q_off + head
        qe = q_off + qlen - tail
        ss, se = a.pos0, a.pos0 + span
        hits.append((qs, qe, ss, se))
    if not hits:
        return []
    hits.sort(key=lambda h: h[2] - h[0])
    merged: List[List[int]] = []
    for qs, qe, ss, se in hits:
        d = ss - qs
        if merged and abs((merged[-1][2] - merged[-1][0]) - d) <= p.merge_band \
                and qs <= merged[-1][1] + p.merge_gap:
            merged[-1][0] = min(merged[-1][0], qs)
            merged[-1][1] = max(merged[-1][1], qe)
            merged[-1][2] = min(merged[-1][2], ss)
            merged[-1][3] = max(merged[-1][3], se)
        else:
            merged.append([qs, qe, ss, se])
    out = []
    for qs, qe, ss, se in merged:
        if qe - qs < p.min_hsp_len:
            continue
        # terminal artifacts: fully within term_ignore_len of either end
        if qe <= p.term_ignore_len or qs >= n - p.term_ignore_len:
            continue
        out.append((qs, qe, ss, se))
    return out


def siamaera_filter(
    records: List[SeqRecord],
    params: Optional[SiamaeraParams] = None,
    drop_inconclusive: bool = True,
    device: str = "cuda",
) -> Tuple[List[SeqRecord], SiamaeraStats]:
    """Detect and trim rc-self-chimeric reads. Returns (records, stats).
    The self-alignments run on ``device``."""
    p = params or SiamaeraParams()
    stats = SiamaeraStats()

    big = [i for i, r in enumerate(records) if len(r) >= p.seq_min_len]
    if not big:
        return list(records), stats
    stats.checked = len(big)

    rc_recs = []
    win_recs = []
    win_read = []
    for bi, i in enumerate(big):
        r = records[i]
        rc_recs.append(SeqRecord(
            id=f"rc|{r.id}", seq=decode_codes(revcomp_codes(encode_ascii(r.seq)))))
        n = len(r)
        step = p.window - p.overlap
        for start in range(0, max(n - p.overlap, 1), step):
            end = min(start + p.window, n)
            win_recs.append(SeqRecord(id=f"{r.id}|w:{start}",
                                      seq=r.seq[start:end]))
            win_read.append(bi)
            if end == n:
                break

    refs = pack_reads(rc_recs)
    queries = pack_reads(win_recs, pad_len=((p.window + 127) // 128) * 128)
    wr = np.asarray(win_read, np.int32)

    mapper = TorchMapper(AlignParams(min_out_score=0.0, score_per_base=False),
                         device=device)
    res = mapper.map_batch(refs, queries,
                           candidate_filter=lambda c: wr[c.sread] == c.lread)

    out: List[Optional[SeqRecord]] = list(records)
    for bi, i in enumerate(big):
        r = records[i]
        n = len(r)
        hsps = _hsps_for_read(res.alnsets[bi].alns, n, p)
        # a clean read matches its revcomp nowhere (beyond chance seeds)
        if not hsps:
            continue
        if len(hsps) > 2 and drop_inconclusive:
            out[i] = None
            stats.dropped += 1
            if (qrec := obs_qc.current()) is not None:
                qrec.record_siamaera(r.id, "dropped")
            continue
        # junction estimate: HSP (qs,qe)~rc(ss,se) mirrors to read interval
        # (n-se, n-ss). Joined case: one HSP overlapping its own mirror,
        # junction at the common center. Split case: arm and mirrored arm
        # are disjoint, junction in the gap between them.
        qs, qe, ss, se = max(hsps, key=lambda h: h[1] - h[0])
        mqs, mqe = n - se, n - ss
        arm_cov = (qe - qs) + (mqe - mqs)
        if arm_cov < 0.6 * n:
            # small inverted repeat, not a siamaera — leave the read alone
            continue
        if qe <= mqs:
            center = (qe + mqs) // 2
        elif mqe <= qs:
            center = (mqe + qs) // 2
        else:
            center = int(round((qs + qe + mqs + mqe) / 4.0))
        center = max(0, min(n, center))
        head_len, tail_len = center, n - center
        if head_len >= tail_len:
            a, b = 0, max(0, center - p.trim)
        else:
            a, b = min(n, center + p.trim), n
        piece = SeqRecord(
            id=r.id, seq=r.seq[a:b],
            qual=None if r.qual is None else r.qual[a:b],
            desc=(r.desc + " " if r.desc else "") + f"SIAMAERA:{a},{b - a}")
        out[i] = piece
        stats.trimmed += 1
        if (qrec := obs_qc.current()) is not None:
            qrec.record_siamaera(r.id, "trimmed", a, b - a)

    return [r for r in out if r is not None], stats
