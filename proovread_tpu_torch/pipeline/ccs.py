"""Subread circular consensus (the ``ccs-1`` task), port of
``proovread_tpu/pipeline/ccs.py`` (``bin/ccseq`` rebuilt).

PacBio CLR cells read the same molecule several times (subreads sharing a
ZMW id ``m.../<hole>/<start_stop>``, ``bin/ccseq:238``). Before any
short-read mapping, each multi-subread ZMW collapses to one consensus: pick
a reference subread (the longer of 2, else the second of >2,
``bin/ccseq:356-366``), map all of the ZMW's subreads onto it (uncapped
admission, ``:378-383``), and call ``consensus(use_ref_qual,
qual_weighted)`` with ``InDelTaboo(0.001)`` (``:214-217``). Lone subreads
pass through unchanged; non-reference subreads of multi-groups are dropped.

The subreads are cut into fixed windows that seed and align independently
(the reference's windowing), through ``pipeline/correct.py:FastCorrector``
with a same-ZMW candidate filter: host seeding, the ``csrc/sw.cu`` kernel at
m = 512, and qual-weighted votes through the ordered scatter kernel
``csrc/scatter.cu`` on the card. The seeder tries both strands, so
subreads of either orientation vote without being re-oriented here.
``zmw_of`` and ``is_subread_set`` also choose the command line's mode
(``bin/proovread:1512-1517``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from proovread_tpu_torch.align.params import AlignParams
from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.io.batch import pack_reads
from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.obs import qc as obs_qc
from proovread_tpu_torch.pipeline.correct import FastCorrector

ZMW_RE = re.compile(r"^(m[^/]+/\d+)/(\d+_\d+)")

CCS_ALIGN = AlignParams(min_out_score=1.0)  # permissive: same-molecule copies
CCS_CNS = ConsensusParams(
    trim=True, indel_taboo=0.001,           # ccseq:214-217
    use_ref_qual=True, qual_weighted=True,  # ccseq:264-271
    bin_size=100, max_coverage=10_000,      # -b 100 -l 1000000: uncapped
)


def zmw_of(read_id: str) -> Optional[str]:
    m = ZMW_RE.match(read_id)
    return m.group(1) if m else None


def is_subread_set(records) -> bool:
    """Mode auto-detection: all ids must parse as PacBio subreads, else the
    driver falls back to -noccs (bin/proovread:1512-1517)."""
    return bool(records) and all(zmw_of(r.id) is not None for r in records)


@dataclass
class CcsStats:
    primary: int = 0
    single: int = 0
    secondary: int = 0


def _window_records(rec: SeqRecord, zmw_idx: int, win: int, overlap: int
                    ) -> List[Tuple[SeqRecord, int]]:
    """Cut one subread into (window record, zmw index) pieces."""
    out = []
    n = len(rec)
    step = win - overlap
    for k, start in enumerate(range(0, max(n - overlap, 1), step)):
        end = min(start + win, n)
        out.append((SeqRecord(
            id=f"{rec.id}|w{k}",
            seq=rec.seq[start:end],
            qual=None if rec.qual is None else rec.qual[start:end],
        ), zmw_idx))
        if end == n:
            break
    return out


def ccs_correct(
    records: List[SeqRecord],
    align_params: AlignParams = CCS_ALIGN,
    cns_params: ConsensusParams = CCS_CNS,
    window: int = 512,
    overlap: int = 64,
    batch_refs: int = 256,
    min_subreads: int = 2,
    device: str = "cuda",
) -> Tuple[List[SeqRecord], CcsStats]:
    """Collapse multi-subread ZMWs to consensus reads, in input order.
    Groups with fewer than ``min_subreads`` members pass through unconsensed
    (ccs --min-subreads, proovread.cfg ``ccs`` block). Raises ValueError on
    an id that is not a PacBio subread's."""
    stats = CcsStats()

    groups: Dict[str, List[int]] = {}
    order: List[str] = []
    for i, r in enumerate(records):
        z = zmw_of(r.id)
        if z is None:
            raise ValueError(f"not a PacBio subread id: {r.id!r}")
        if z not in groups:
            order.append(z)
        groups.setdefault(z, []).append(i)

    # reference subread per multi-group (ccseq:356-366)
    ref_idx: List[int] = []
    members: List[List[int]] = []
    ref_of: Dict[str, int] = {}
    for z in order:
        g = groups[z]
        if len(g) < max(min_subreads, 2):
            continue
        if len(g) == 2:
            ref = g[0] if len(records[g[0]]) > len(records[g[1]]) else g[1]
        else:
            ref = g[1]
        ref_idx.append(ref)
        members.append(g)
        ref_of[z] = ref

    out_map: Dict[int, SeqRecord] = {}
    fc = FastCorrector(align_params=align_params, cns_params=cns_params,
                       device=device)
    for start in range(0, len(ref_idx), batch_refs):
        sel = list(range(start, min(start + batch_refs, len(ref_idx))))
        refs = pack_reads([records[ref_idx[j]] for j in sel])
        win_recs: List[SeqRecord] = []
        win_zmw: List[int] = []
        for bj, j in enumerate(sel):
            for gi in members[j]:
                for wrec, _ in _window_records(records[gi], bj, window,
                                               overlap):
                    win_recs.append(wrec)
                    win_zmw.append(bj)
        if not win_recs:
            continue
        queries = pack_reads(win_recs, pad_len=((window + 127) // 128) * 128)
        wz = np.asarray(win_zmw, np.int32)

        def same_zmw(cand, wz=wz):
            return wz[cand.sread] == cand.lread

        results, _ = fc.correct_batch(refs, queries, candidate_filter=same_zmw)
        for bj, j in enumerate(sel):
            rec = results[bj].record
            out_map[ref_idx[j]] = SeqRecord(id=rec.id, seq=rec.seq,
                                            qual=rec.qual, desc="CCS:primary")

    out: List[SeqRecord] = []
    qrec = obs_qc.current()
    for z in order:
        g = groups[z]
        if z not in ref_of:
            # singleton, or a multi-group below min_subreads: every member
            # passes through unconsensed
            stats.single += len(g)
            out.extend(records[i] for i in g)
            if qrec is not None:
                for i in g:
                    qrec.record_ccs(records[i].id, "single", len(g))
        else:
            stats.primary += 1
            stats.secondary += len(g) - 1
            # a ZMW whose consensus never ran (an empty window batch)
            # passes its raw reference subread through
            rec = out_map.get(ref_of[z], records[ref_of[z]])
            out.append(rec)
            if qrec is not None:
                # QC provenance: this output read is the ZMW's circular
                # consensus over len(g) subreads
                qrec.record_ccs(rec.id, "primary", len(g))
    return out, stats
