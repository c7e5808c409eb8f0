"""Unitig-assisted pre-correction (the ``utg`` task), port of
``proovread_tpu/pipeline/utg.py``: the role of the ``blasr-utg`` /
``dazzler-utg`` task (``bin/proovread:789-833,1107-1136``) and its
``bam2cns --utg-mode`` consensus knobs (``:1536-1586``,
``proovread.cfg:277-297``).

Unitigs are long (kb-scale) assembly fragments: near-perfect sequence, ~1-2x
coverage. The reference maps them with BLASR and votes them qual-weighted
with FallbackPhred 30, no score-binned admission, contained-alignment
filtering, and rep-coverage overlap windows excluded from voting. Here, as
in the JAX package, unitigs are cut into overlapping windows (``utg-window``,
``utg-overlap``) and each window votes on its own: ``align/mapper.py``
(host seeding, the ``csrc/sw.cu`` kernel at m = 512), the contained and
rep-region filters on the windows' spans, then ``ConsensusEngine`` (votes
through the ordered scatter kernel ``csrc/scatter.cu`` on the card).
"""

from __future__ import annotations

from typing import List, Tuple

from proovread_tpu_torch.align.mapper import TorchMapper
from proovread_tpu_torch.align.params import AlignParams
from proovread_tpu_torch.config import Config
from proovread_tpu_torch.consensus.engine import ConsensusEngine
from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.io.batch import pack_reads
from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.pipeline.driver import TaskReport


def _utg_windows(utgs: List[SeqRecord], window: int,
                 overlap: int) -> List[SeqRecord]:
    out = []
    step = window - overlap
    for r in utgs:
        n = len(r)
        for start in range(0, max(n - overlap, 1), step):
            end = min(start + window, n)
            out.append(SeqRecord(id=f"{r.id}|w:{start}",
                                 seq=r.seq[start:end]))
            if end == n:
                break
    return out


def utg_params(cfg: Config) -> Tuple[AlignParams, ConsensusParams]:
    ap = AlignParams(
        min_out_score=1.0,          # long accurate windows: permissive -T
        score_per_base=True,
        max_candidates=4,           # ~1-2x unitig coverage
    )
    cns = ConsensusParams(
        qual_weighted=True,
        use_ref_qual=True,
        fallback_phred=int(cfg.get("fallback-phred", "utg")),
        min_ncscore=cfg.get("min-ncscore", "utg"),
        max_ins_length=int(cfg.get("max-ins-length", "utg")),
        rep_coverage=int(cfg.get("rep-coverage", "utg") or 0),
        indel_taboo_length=int(cfg.get("sr-indel-taboo-length")),
        bin_size=int(cfg.get("bin-size", "utg")),
        max_coverage=int(cfg.get("max-coverage", "utg")),
    )
    return ap, cns


def utg_correct(cfg: Config, longs: List[SeqRecord],
                utgs: List[SeqRecord], batch_reads: int = 128,
                device: str = "cuda",
                ) -> Tuple[List[SeqRecord], TaskReport]:
    """One unitig consensus pass over the long reads. Returns the corrected
    records (consensus quals encode unitig support) and a task report."""
    ap, cns = utg_params(cfg)
    window = int(cfg.get("utg-window"))
    overlap = int(cfg.get("utg-overlap"))
    windows = _utg_windows(utgs, window, overlap)
    pad = ((window + 127) // 128) * 128
    # qual-less unitigs vote with the utg FallbackPhred (30 — assembly
    # accuracy), not the global fallback of 1 (bin/proovread:1561-1586)
    queries = pack_reads(windows, pad_len=pad,
                         fallback_phred=cns.fallback_phred)
    mapper = TorchMapper(ap, device=device)
    engine = ConsensusEngine(params=cns, device=device)

    out: List[SeqRecord] = []
    n_cand = n_adm = 0
    supported = total = 0
    for start in range(0, len(longs), batch_reads):
        refs = pack_reads(longs[start:start + batch_reads])
        mr = mapper.map_batch(refs, queries, cns_params=cns)
        n_cand += mr.n_candidates

        ignore: List[List[Tuple[int, int]]] = []
        for aset in mr.alnsets:
            aset.filter_by_scores()
            if cns.rep_coverage:
                aset.filter_rep_region_alns()
            aset.filter_contained_alns()
            coords = (aset.high_coverage_windows(cns.rep_coverage)
                      if cns.rep_coverage else [])
            aset.admit(cap_coverage=False)   # utg mode: no binned admission
            n_adm += len(aset.alns)
            ignore.append(coords)

        for res in engine.consensus_batch(refs, mr.alnsets,
                                          ignore_coords=ignore):
            out.append(res.record)
            q = res.record.qual
            if q is not None and len(q):
                supported += int((q >= 20).sum())
                total += len(q)

    frac = supported / total if total else 0.0
    return out, TaskReport("utg", frac, n_cand, n_adm)
