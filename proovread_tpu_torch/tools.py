"""Standalone worker tools mirroring the reference's ``bin/`` scripts (port
of ``proovread_tpu/tools.py``).

- ``samfilter``: ``bin/samfilter`` (drop unmapped records, restore
  secondary-alignment seq/qual from the primary — incl. revcomp — default
  qual '?' when absent, ``bin/samfilter:41-72``). An output path ending in
  ``.bam`` is written as BGZF BAM (``io/sam.py:BamWriter``), any other as
  SAM text.
- ``sam2cns``: ``bin/sam2cns``/``bin/bam2cns`` (consensus-correct long
  reads from an external SAM/BAM mapping; ``--variants`` writes the
  per-column variant table, ``--stabilize`` re-calls close-variant
  groups).
- ``ccseq``: ``bin/ccseq`` (collapse PacBio subread ZMWs to circular
  consensus reads).
- ``siamaera``: ``bin/siamaera`` (trim reverse-complement self-chimeras).
- ``dazz2sam``: ``bin/dazz2sam`` (LAshow ``-a`` text to SAM).
- ``bamindex``: the ``samtools index`` role (writes the ``.bai`` that
  region fetches read).

Run as ``python -m proovread_tpu_torch.tools <tool> ...``. The tools that
reach the card (``sam2cns``, ``ccseq``, ``siamaera``) take ``--device
{cuda,cpu}`` (default ``cuda``; no fallback to the CPU).
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

PROG = "python -m proovread_tpu_torch.tools"


def _device_arg(argv: List[str]) -> Tuple[List[str], Optional[str]]:
    """``argv`` without its ``--device X`` / ``--device=X``, and X
    (default ``cuda``); None when the value is missing or unknown."""
    out, dev = [], "cuda"
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--device" or a.startswith("--device="):
            if "=" in a:
                dev = a.split("=", 1)[1]
            elif i + 1 < len(argv):
                dev = argv[i + 1]
                i += 1
            else:
                dev = None
            i += 1
            continue
        out.append(a)
        i += 1
    if dev not in ("cuda", "cpu"):
        print(f"error: --device must be cuda or cpu, not {dev!r}",
              file=sys.stderr)
        return out, None
    return out, dev


def samfilter(argv: List[str]) -> int:
    from proovread_tpu_torch.io.sam import (BamWriter, SamReader, SamWriter,
                                            restore_secondary)

    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: {PROG} samfilter <in.sam|in.bam> [out.sam|out.bam]",
              file=sys.stderr)
        return 2
    reader = SamReader(argv[0])
    dest = argv[1] if len(argv) > 1 else None
    out = (BamWriter(dest, reader.header)
           if dest is not None and dest.endswith(".bam")
           else SamWriter(dest if dest is not None else sys.stdout,
                          header=reader.header))
    n = 0
    for rec in restore_secondary(iter(reader)):
        out.write(rec)
        n += 1
    out.close()
    print(f"samfilter: {n} records", file=sys.stderr)
    return 0


def _read_any(path: str):
    from proovread_tpu_torch.io import fasta, fastq
    import gzip
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as fh:
        first = fh.read(1)
    rd = fastq.FastqReader(path) if first == b"@" else \
        fasta.FastaReader(path)
    return list(rd)


def _write_fq(records, dest: Optional[str]) -> None:
    from proovread_tpu_torch.io.fastq import FastqWriter
    fh = open(dest, "wb") if dest else sys.stdout.buffer
    w = FastqWriter(fh)
    for r in records:
        w.write(r)
    if dest:
        fh.close()


def sam2cns_tool(argv: List[str]) -> int:
    """bin/sam2cns role: ``sam2cns [--variants [--stabilize]] [--device D]
    <in.sam|in.bam> <ref.fq> [out.fq|out.tsv]``. ``--variants`` emits the
    per-column variant table (Sam::Seq::call_variants, Sam/Seq.pm:
    1666-1734) instead of consensus; ``--stabilize`` re-calls close-variant
    groups (stabilize_variants, :1777-1958)."""
    argv, device = _device_arg(argv)
    if device is None:
        return 2
    variants = stabilize = False
    while argv and argv[0] in ("--variants", "--stabilize"):
        if argv[0] == "--variants":
            variants = True
        else:
            stabilize = True
        argv = argv[1:]
    if stabilize and not variants:
        print("sam2cns: --stabilize requires --variants", file=sys.stderr)
        return 2
    if len(argv) < 2:
        print(f"usage: {PROG} sam2cns [--variants [--stabilize]] "
              "[--device cuda|cpu] <in.sam|in.bam> <ref.fq|fa> "
              "[out.fq|out.tsv]", file=sys.stderr)
        return 2
    from proovread_tpu_torch.consensus.params import ConsensusParams
    from proovread_tpu_torch.pipeline.sam2cns import (Sam2CnsConfig,
                                                      sam2cns_records,
                                                      sam2cns_variants)
    refs = _read_any(argv[1])
    cfg = Sam2CnsConfig(params=ConsensusParams(
        indel_taboo_length=7, use_ref_qual=True))
    if variants:
        from proovread_tpu_torch.ops.variants import variants_tsv
        fh = open(argv[2], "w") if len(argv) > 2 else sys.stdout
        n_cols = 0
        for group, table in sam2cns_variants(argv[0], refs, cfg,
                                             stabilize=stabilize,
                                             device=device):
            text = variants_tsv(table, [r.id for r in group],
                                [len(r) for r in group])
            fh.write(text)
            n_cols += text.count("\n")
        if len(argv) > 2:
            fh.close()
        print(f"sam2cns: variant table for {len(refs)} reads "
              f"({n_cols} columns)", file=sys.stderr)
        return 0
    out, chim = sam2cns_records(argv[0], refs, cfg, device=device)
    _write_fq(out, argv[2] if len(argv) > 2 else None)
    print(f"sam2cns: {len(out)} reads corrected, {len(chim)} chimera "
          "breakpoints", file=sys.stderr)
    return 0


def ccseq_tool(argv: List[str]) -> int:
    """bin/ccseq role: ``ccseq [--device D] <subreads.fq> [out.fq]``."""
    argv, device = _device_arg(argv)
    if device is None:
        return 2
    if not argv:
        print(f"usage: {PROG} ccseq [--device cuda|cpu] <subreads.fq> "
              "[out.fq]", file=sys.stderr)
        return 2
    from proovread_tpu_torch.pipeline.ccs import ccs_correct
    out, st = ccs_correct(_read_any(argv[0]), device=device)
    _write_fq(out, argv[1] if len(argv) > 1 else None)
    print(f"ccseq: {st.primary} primary, {st.single} single, "
          f"{st.secondary} secondary dropped", file=sys.stderr)
    return 0


def siamaera_tool(argv: List[str]) -> int:
    """bin/siamaera role: ``siamaera [--device D] <in.fq> [out.fq]``."""
    argv, device = _device_arg(argv)
    if device is None:
        return 2
    if not argv:
        print(f"usage: {PROG} siamaera [--device cuda|cpu] <in.fq|fa> "
              "[out.fq]", file=sys.stderr)
        return 2
    from proovread_tpu_torch.pipeline.siamaera import siamaera_filter
    out, st = siamaera_filter(_read_any(argv[0]), device=device)
    _write_fq(out, argv[1] if len(argv) > 1 else None)
    print(f"siamaera: {st.checked} checked, {st.trimmed} trimmed, "
          f"{st.dropped} dropped", file=sys.stderr)
    return 0


def dazz2sam_tool(argv: List[str]) -> int:
    """bin/dazz2sam role: ``dazz2sam <lashow.txt> [--ref ref.fa]
    [--qry qry.fa] [--add-scores] [out.sam]`` — consumes ``LAshow -a``
    textual output (see pipeline/dazz2sam.py for the documented
    deviation)."""
    from proovread_tpu_torch.pipeline.dazz2sam import (
        las2sam, names_and_lengths_from_fasta, parse_lashow)

    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: {PROG} dazz2sam <lashow.txt> [--ref ref.fa] "
              "[--qry qry.fa] [--add-scores] [out.sam]", file=sys.stderr)
        return 2
    las_path = argv[0]
    rest = argv[1:]
    ref_names = qry_names = qry_lengths = ref_lengths = None
    add_scores = False
    out_path = None
    i = 0
    while i < len(rest):
        if rest[i] in ("--ref", "--qry"):
            if i + 1 >= len(rest):
                print(f"error: {rest[i]} needs a FASTA path",
                      file=sys.stderr)
                return 2
            names, lengths = names_and_lengths_from_fasta(rest[i + 1])
            if rest[i] == "--ref":
                ref_names, ref_lengths = names, lengths
            else:
                qry_names, qry_lengths = names, lengths
            i += 2
        elif rest[i] in ("--add-scores", "-S"):
            add_scores = True
            i += 1
        elif rest[i].startswith("-"):
            print(f"error: unknown option {rest[i]!r}", file=sys.stderr)
            return 2
        else:
            out_path = rest[i]
            i += 1
    with open(las_path) as fh:
        alns = parse_lashow(fh)
    out = open(out_path, "w") if out_path else sys.stdout
    n = las2sam(alns, out, ref_names=ref_names, qry_names=qry_names,
                qry_lengths=qry_lengths, ref_lengths=ref_lengths,
                add_scores=add_scores)
    if out_path:
        out.close()
    print(f"dazz2sam: {n} alignments converted", file=sys.stderr)
    return 0


def bamindex_tool(argv: List[str]) -> int:
    """``samtools index`` role: ``bamindex <in.bam> [out.bai]`` (native
    .bai builder; Sam/Parser.pm:386-417 region access needs one)."""
    if not argv:
        print(f"usage: {PROG} bamindex <in.bam> [out.bai]", file=sys.stderr)
        return 2
    from proovread_tpu_torch.io.sam import build_bai
    out = build_bai(argv[0], argv[1] if len(argv) > 1 else None)
    print(f"bamindex: wrote {out}", file=sys.stderr)
    return 0


_TOOLS = {
    "samfilter": samfilter,
    "sam2cns": sam2cns_tool,
    "ccseq": ccseq_tool,
    "siamaera": siamaera_tool,
    "dazz2sam": dazz2sam_tool,
    "bamindex": bamindex_tool,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(f"usage: {PROG} <{'|'.join(sorted(_TOOLS))}> ...",
              file=sys.stderr)
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd in _TOOLS:
        return _TOOLS[cmd](rest)
    print(f"unknown tool {cmd!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
