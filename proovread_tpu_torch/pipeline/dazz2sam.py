"""dazz2sam — DAZZLER ``LAshow -a`` pretty alignments -> SAM (port of
``proovread_tpu/pipeline/dazz2sam.py``; host code).

Role parity with proovread's ``bin/dazz2sam``: reconstruct a CIGAR from
the gapped alignment rows (``aln2cigar``, ``bin/dazz2sam:322-341``), add
hard clips from the query interval, optionally rescore with the proovread
PacBio scheme (MA 5 / MM -11 / ref gap -2,-4 / query gap -1,-3 —
``bin/dazz2sam:22-29,344-367``), and emit one SAM record per alignment
(``las2sam``, ``bin/dazz2sam:281-315``): flag 0x10 for complemented hits,
0x100 for repeats of a query id, MAPQ 255, qual ``*``.

Deviation (documented): the reference shells out to ``LAshow``/``DBshow``
over the binary ``.las``/``.db`` files; the DAZZLER suite is not shipped
with this package, so this tool consumes LAshow's *textual* ``-a`` output
directly and takes ref/qry FASTA (or name/length tables) for the id->name
and query-length lookups DBshow provided.

LAshow -a record layout (as consumed by ``bin/dazz2sam:230-270``)::

    <riid> <qiid> <n|c> [<rs>..<re>] x [<qs>..<qe>] ...
    <blank>
    <pos> REF-chunk
          diff-chunk
    <pos> QRY-chunk
    <blank>
    ...
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, TextIO, Tuple

# proovread bwa scoring (bin/dazz2sam:22-29)
MA, MM = 5, -11
RGO, RGE = -2, -4
QGO, QGE = -1, -3

_HEAD_RE = re.compile(
    r"^\s*([\d,]+)\s+([\d,]+)\s+(\w)\s+\[\s*([\d,]+)\.\.\s*([\d,]+)\]"
    r" x \[\s*([\d,]+)\.\.\s*([\d,]+)\]")
_ROW_RE = re.compile(r"^\s*[\d,]*\s+(\S+)\s*$")


def _n(s: str) -> int:
    return int(s.replace(",", ""))


@dataclass
class LasAlignment:
    riid: int
    qiid: int
    comp: bool
    rstart: int          # 0-based (SAM pos = rstart + 1, bin/dazz2sam:297)
    rend: int
    qstart: int          # clip head = qstart - 1 (bin/dazz2sam:335)
    qend: int
    rseq: str            # gapped rows, '-' = gap
    qseq: str


def parse_lashow(fh: Iterable[str]) -> List[LasAlignment]:
    """Parse LAshow -a text: a header line starts each record; its gapped
    rows follow as (ref, diff, qry) triplets separated by blanks."""
    out: List[LasAlignment] = []
    cur: Optional[LasAlignment] = None
    rows: List[str] = []

    def flush():
        nonlocal cur
        if cur is None:
            return
        ref = "".join(rows[0::3])
        qry = "".join(rows[2::3])
        if len(ref) != len(qry):
            raise ValueError(
                f"query and reference sequence differ in length for "
                f"alignment {cur.riid} x {cur.qiid}")
        cur.rseq, cur.qseq = ref, qry
        out.append(cur)
        cur = None

    for line in fh:
        m = _HEAD_RE.match(line)
        if m:
            flush()
            rows.clear()
            cur = LasAlignment(
                riid=_n(m.group(1)), qiid=_n(m.group(2)),
                comp=m.group(3) == "c",
                rstart=_n(m.group(4)), rend=_n(m.group(5)),
                qstart=_n(m.group(6)), qend=_n(m.group(7)),
                rseq="", qseq="")
            continue
        if cur is None:
            continue
        # explicit slot tracking: after a header the rows cycle
        # ref (0) -> diff (1) -> qry (2), with blank lines legal only
        # BETWEEN triplets — except that a fully matching chunk renders
        # its diff row with no markers at all, which must still occupy
        # the diff slot or every following qry row parses as a ref row
        slot = len(rows) % 3
        if not line.strip():
            if slot == 1:
                rows.append("")      # whitespace-only diff row
            continue
        if slot == 1:
            rows.append("")          # diff row (any content)
            continue
        rm = _ROW_RE.match(line)
        # unparseable content where a sequence row is expected keeps the
        # phase (flush() still length-checks ref vs qry)
        rows.append(rm.group(1) if rm else "")
    flush()
    return out


def aln2cigar(rseq: str, qseq: str, qstart: int, qend: int,
              qlen: Optional[int]) -> str:
    """Gapped rows -> CIGAR with hard clips (bin/dazz2sam:322-341)."""
    ops = []
    for rc, qc in zip(rseq, qseq):
        if qc == "-":
            ops.append("D")
        elif rc == "-":
            ops.append("I")
        else:
            ops.append("M")
    cig = _compress(ops)
    if qstart > 1:
        cig = f"{qstart - 1}H" + cig
    if qlen is not None and qlen - qend > 0:
        cig += f"{qlen - qend}H"
    return cig


def _compress(ops: List[str]) -> str:
    out = []
    i = 0
    while i < len(ops):
        j = i
        while j < len(ops) and ops[j] == ops[i]:
            j += 1
        out.append(f"{j - i}{ops[i]}")
        i = j
    return "".join(out)


def aln2score(rseq: str, qseq: str) -> int:
    """proovread-scheme rescoring (bin/dazz2sam:344-367): gap opens vs
    extensions counted per row, mismatches from the non-gap diff count."""
    def gaps(s: str) -> Tuple[int, int]:
        total = s.count("-")
        opens = len(re.findall(r"-+", s))
        return opens, total - opens
    rgo, rge = gaps(rseq)
    qgo, qge = gaps(qseq)
    rg, qg = rgo + rge, qgo + qge
    diff = sum(a != b for a, b in zip(rseq, qseq))
    mm = diff - (rg + qg)
    ma = len(rseq) - (rg + qg + mm)
    return MA * ma + MM * mm + RGO * rgo + RGE * rge + QGO * qgo + QGE * qge


def las2sam(
    alignments: Iterable[LasAlignment],
    out: TextIO,
    ref_names: Optional[Dict[int, str]] = None,
    qry_names: Optional[Dict[int, str]] = None,
    qry_lengths: Optional[Dict[str, int]] = None,
    ref_lengths: Optional[Dict[str, int]] = None,
    add_scores: bool = False,
) -> int:
    """Write SAM records with the reference's header block
    (@HD/@SQ per reference sequence/@PG, bin/dazz2sam:222-228); @SQ lines
    need ``ref_lengths`` (from --ref). DAZZ_DB iids are 1-based; unknown
    names fall back to the iid."""
    out.write("@HD\tVN:unknown\tSO:coordinate\n")
    for iid in sorted(ref_names or {}):
        name = ref_names[iid]
        ln = (ref_lengths or {}).get(name, 0)
        out.write(f"@SQ\tSN:{name}\tLN:{ln}\n")
    out.write("@PG\tID:dazz2sam\tVN:proovread_tpu\n")
    seen: Dict[int, int] = {}
    n = 0
    for a in alignments:
        qname = (qry_names or {}).get(a.qiid, str(a.qiid))
        rname = (ref_names or {}).get(a.riid, str(a.riid))
        flag = (0x10 if a.comp else 0) | (0x100 if seen.get(a.qiid) else 0)
        seen[a.qiid] = seen.get(a.qiid, 0) + 1
        qlen = (qry_lengths or {}).get(qname)
        cigar = aln2cigar(a.rseq, a.qseq, a.qstart, a.qend, qlen)
        seq = a.qseq.replace("-", "")
        fields = [qname, str(flag), rname, str(a.rstart + 1), "255", cigar,
                  "*", "0", "0", seq, "*"]
        if add_scores:
            fields.append(f"AS:i:{aln2score(a.rseq, a.qseq)}")
        out.write("\t".join(fields) + "\n")
        n += 1
    return n


def names_and_lengths_from_fasta(path: str):
    """(iid->name, name->length) from a FASTA in DAZZ_DB order (iids are
    the 1-based record positions DBshow reports)."""
    from proovread_tpu_torch.io.fasta import FastaReader

    names: Dict[int, str] = {}
    lengths: Dict[str, int] = {}
    for i, rec in enumerate(FastaReader(path), start=1):
        names[i] = rec.id
        lengths[rec.id] = len(rec)
    return names, lengths
