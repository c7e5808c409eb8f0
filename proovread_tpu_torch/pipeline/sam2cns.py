"""External-mapping consensus entry (port of
``proovread_tpu/pipeline/sam2cns.py``) — the role of ``bin/bam2cns`` /
``bin/sam2cns``: correct long reads from an externally produced SAM/BAM
mapping instead of the built-in mapper. This is the reference's designed
resume boundary (``proovread.cfg:130-132`` sam/bam modes,
``bin/proovread:718-736``) and the interop point with the Perl pipeline.

Flow (``bin/bam2cns:332-455``, ``bin/sam2cns:554-632``): group alignments by
reference long read, restore secondary-alignment seq/qual from the primary,
apply score filters + binned admission (or plain add in utg mode), parse MCR
masks from the reference read description, call consensus (emitting refs
without alignments too), optionally detect chimera. The consensus and the
variant tables run on ``device`` through :class:`ConsensusEngine` (the
ordered scatter kernel on the card); the parsing and filters are host code.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from proovread_tpu_torch.consensus.alnset import AlnSet
from proovread_tpu_torch.consensus.engine import ConsensusEngine, ConsensusResult
from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.io.batch import pack_reads
from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.io.sam import SamAlignment, SamReader, restore_secondary

log = logging.getLogger("proovread_tpu_torch")

_MCR_RE = re.compile(r"MCR\d+:(\d+),(\d+)")
# NB: the reference also scans HPL:\d+ annotations (bin/bam2cns:388) but —
# like bam2cns itself — never consumes them; not parsed here.


@dataclass
class Sam2CnsConfig:
    params: ConsensusParams = field(default_factory=ConsensusParams)
    utg_mode: bool = False            # plain add + contained filter + owin
    detect_chimera: bool = False
    ignore_mcr: bool = False          # --ignore-mcr / --ignore-hcr
    max_ref_seqs: int = 100           # refs per consensus batch
    haplo_coverage: Optional[float] = None   # filter_by_coverage cutoff


def parse_mcrs(desc: str) -> List[Tuple[int, int]]:
    """MCR annotations from a reference-read description
    (``bin/bam2cns:382-391``)."""
    return [(int(a), int(b)) for a, b in _MCR_RE.findall(desc or "")]


def _collect_blocks(alns_in: Iterable[SamAlignment], wanted: Dict[str, int],
                    invert_scores: bool) -> Dict[int, list]:
    """Group the stream into per-reference engine :class:`Alignment` lists.
    Records convert to compact numpy form (int8 codes + cigar-op arrays) as
    they stream, so peak memory is O(total aligned bases), not O(SAM text)
    (the reference streams one rname-block of a sorted SAM at a time,
    ``bin/sam2cns:554-632``). Secondary records whose primary has not
    streamed yet ('*' seq, legal in coordinate-sorted input) are dropped
    with a warning — the reference aborts on them (``bin/bam2cns:348``)."""
    out: Dict[int, list] = {}
    n_unresolved = 0
    for rec in restore_secondary(alns_in):
        if rec.is_supplementary or rec.cigar in ("*", ""):
            continue
        if rec.seq == "*":
            n_unresolved += 1
            continue
        ri = wanted.get(rec.rname)
        if ri is not None:
            out.setdefault(ri, []).append(rec.to_alignment(invert_scores))
    if n_unresolved:
        log.warning(
            "%d secondary alignments dropped (primary seq not yet seen; "
            "sort or samfilter the input to keep them)", n_unresolved)
    return out


def _open_alns(source: Union[str, Iterable[SamAlignment]],
               wanted: Dict[str, int]) -> Iterable[SamAlignment]:
    """Alignment stream for a source. When the source is an INDEXED BAM
    (``.bai`` present) and the wanted refs are a subset of the header's,
    fetch each wanted reference's region instead of streaming the whole
    file — the reference's region access (``Sam/Parser.pm:386-417``) for
    re-entry on a read subset of a multi-GB mapping."""
    if not isinstance(source, str):
        return source
    reader = SamReader(source)
    from proovread_tpu_torch.io.sam import _find_bai
    if (getattr(reader, "_bam", False) and _find_bai(source)
            and len(wanted) < len(reader.header.refs)):
        def gen():
            for rname in wanted:
                if rname in reader.header.refs:
                    yield from reader.fetch(rname)
        log.info("sam2cns: .bai region fetch for %d of %d refs",
                 len(wanted), len(reader.header.refs))
        return gen()
    return iter(reader)


def sam2cns(
    source: Union[str, Iterable[SamAlignment]],
    refs: Sequence[SeqRecord],
    config: Optional[Sam2CnsConfig] = None,
    device: str = "cuda",
) -> Iterator[ConsensusResult]:
    """Consensus-correct ``refs`` using the alignments in ``source`` (path to
    SAM/BAM, or an iterable of records). Yields one :class:`ConsensusResult`
    per reference read, in input order — including refs no alignment maps to
    (``bin/sam2cns:567-577``). All alignments are held simultaneously, but
    in compact engine form (int8 codes + cigar arrays): peak memory is
    O(total aligned bases) plus one ``max_ref_seqs`` batch of expanded
    pileup columns; chunk ``refs`` externally (the reference's byte-offset
    chunking, ``bin/proovread:1547-1606``) to bound the former."""
    cfg = config or Sam2CnsConfig()
    wanted = {r.id: i for i, r in enumerate(refs)}
    alns_in = _open_alns(source, wanted)
    by_ref = _collect_blocks(alns_in, wanted, cfg.params.invert_scores)

    engine = ConsensusEngine(params=cfg.params, device=device)
    for start in range(0, len(refs), cfg.max_ref_seqs):
        group = refs[start:start + cfg.max_ref_seqs]
        batch = pack_reads(group)
        alnsets: List[AlnSet] = []
        ignore: List[List[Tuple[int, int]]] = []
        for j, ref in enumerate(group):
            aset = AlnSet(ref_id=ref.id, ref_len=len(ref), params=cfg.params)
            aset.alns.extend(by_ref.pop(start + j, ()))
            coords = ([] if cfg.ignore_mcr else parse_mcrs(ref.desc))

            aset.filter_by_scores()
            if cfg.utg_mode:
                # rep-region filter sees uncapped coverage in utg mode
                # (reference utg path adds alignments without binning
                # before bam2cns:395 runs)
                if cfg.params.rep_coverage:
                    aset.filter_rep_region_alns()
                aset.filter_contained_alns()
                # high-coverage overlap windows vote nothing
                # (bin/bam2cns:398-422)
                if cfg.params.rep_coverage:
                    coords = coords + aset.high_coverage_windows(
                        cfg.params.rep_coverage)
                aset.admit(cap_coverage=False)
            else:
                # admission first: the reference's filter runs after the
                # add_aln_by_score stream loop, so it sees coverage-capped
                # alignments (bin/bam2cns:345-354 then :395)
                aset.admit()
                if cfg.params.rep_coverage:
                    aset.filter_rep_region_alns()
                if cfg.haplo_coverage is not None:
                    aset.filter_by_coverage(cfg.haplo_coverage)
            alnsets.append(aset)
            ignore.append(coords)

        results = engine.consensus_batch(
            batch, alnsets, ignore_coords=ignore,
            detect_chimera=cfg.detect_chimera)
        yield from results


def sam2cns_variants(
    source: Union[str, Iterable[SamAlignment]],
    refs: Sequence[SeqRecord],
    config: Optional[Sam2CnsConfig] = None,
    min_freq: float = 4.0,
    min_prob: float = 0.0,
    or_min: bool = False,
    stabilize: bool = False,
    device: str = "cuda",
):
    """Per-column variant tables instead of consensus — the
    ``call_variants`` entry (Sam/Seq.pm:1666-1734; upstream's
    --haplo-coverage branch computes exactly this before dying at
    'haploc_consensus??', bin/bam2cns:426-432). Yields
    (group_read_records, VariantTable) per ``max_ref_seqs`` batch; render
    with ``ops.variants.variants_tsv``. Alignment-set filters are identical
    to the consensus path; column-level ignore coords (MCRs, utg overlap
    windows) do NOT apply — upstream ``call_variants`` re-inits the state
    matrix without them (Sam/Seq.pm:1676-1677)."""
    cfg = config or Sam2CnsConfig()
    wanted = {r.id: i for i, r in enumerate(refs)}
    alns_in = _open_alns(source, wanted)
    by_ref = _collect_blocks(alns_in, wanted, cfg.params.invert_scores)

    engine = ConsensusEngine(params=cfg.params, device=device)
    for start in range(0, len(refs), cfg.max_ref_seqs):
        group = refs[start:start + cfg.max_ref_seqs]
        batch = pack_reads(group)
        alnsets: List[AlnSet] = []
        for j, ref in enumerate(group):
            aset = AlnSet(ref_id=ref.id, ref_len=len(ref), params=cfg.params)
            aset.alns.extend(by_ref.pop(start + j, ()))
            # identical filter order to sam2cns() above, so the variant
            # table is computed over exactly the consensus admission set
            aset.filter_by_scores()
            if cfg.utg_mode:
                if cfg.params.rep_coverage:
                    aset.filter_rep_region_alns()
                aset.filter_contained_alns()
                aset.admit(cap_coverage=False)
            else:
                aset.admit()
                if cfg.params.rep_coverage:
                    aset.filter_rep_region_alns()
                if cfg.haplo_coverage is not None:
                    aset.filter_by_coverage(cfg.haplo_coverage)
            alnsets.append(aset)
        table = engine.variant_table(
            batch, alnsets, min_freq=min_freq, min_prob=min_prob,
            or_min=or_min)
        if stabilize:
            # fix noise at SNPs with close indels (Sam/Seq.pm:1791:
            # default min_freq 2, var_dist 4)
            from proovread_tpu_torch.ops.variants import stabilize_variants
            stabilize_variants(table, alnsets, [r.seq for r in group])
        yield group, table


def sam2cns_records(
    source, refs: Sequence[SeqRecord],
    config: Optional[Sam2CnsConfig] = None,
    device: str = "cuda",
) -> Tuple[List[SeqRecord], List[Tuple[str, int, int, float]]]:
    """Convenience wrapper: corrected records + flat chimera list."""
    out, chim = [], []
    for res in sam2cns(source, refs, config, device=device):
        out.append(res.record)
        chim.extend((res.record.id, f, t, s) for f, t, s in res.chimera)
    return out, chim
