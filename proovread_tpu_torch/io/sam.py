"""SAM/BAM reader-writer and the SAM alignment record model (port of
``proovread_tpu/io/sam.py``; host code on ``zlib`` and ``struct``, whose BAM
bytes equal the JAX package's).

The roles of ``lib/Sam/Alignment.pm`` (record object: field accessors, flag
tests, optional-tag access, cigar-derived lengths, score accessors,
``Sam/Alignment.pm:125-148,232-262,341-431,525-546``) and ``lib/Sam/Parser.pm``
(SAM/BAM reader-writer, ``Sam/Parser.pm:256-344``). Where the reference
shells out to ``samtools view`` for BAM (``Sam/Parser.pm:386-417``), this
module decodes/encodes BAM natively: BGZF is a chain of gzip members (which
:mod:`gzip` reads transparently) and is written block-wise with the BC extra
field + EOF marker so external samtools can read our output.

All positions are stored 0-based internally; SAM text I/O converts.
"""

from __future__ import annotations

import gzip
import io as _io
import re
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from proovread_tpu_torch.consensus.alnset import Alignment
from proovread_tpu_torch.consensus.cigar import parse_cigar
from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.ops.encode import encode_ascii

# SAM flag bits (Sam/Alignment.pm:232-262)
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST = 0x40
FLAG_LAST = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800

_CIGAR_OPS = "MIDNSHP=X"
_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")
# BAM 4-bit base codes -> ASCII
_SEQ16 = "=ACMGRSVTWYHKDBN"
_SEQ16_CODE = {c: i for i, c in enumerate(_SEQ16)}

_COMPLEMENT = str.maketrans("ACGTUNacgtunRYSWKMBDHV", "TGCAANtgcaanYRSWMKVHDB")


@dataclass
class SamAlignment:
    """One SAM record. ``pos`` is 0-based (-1 = unmapped/unknown)."""

    qname: str
    flag: int = 0
    rname: str = "*"
    pos: int = -1
    mapq: int = 0
    cigar: str = "*"
    rnext: str = "*"
    pnext: int = -1
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"                      # phred+33 string, '*' if absent
    tags: Dict[str, Tuple[str, object]] = field(default_factory=dict)
    # tags: name -> (type char, value)

    # -- flag tests (Sam/Alignment.pm:232-262) ---------------------------
    @property
    def is_paired(self) -> bool:
        return bool(self.flag & FLAG_PAIRED)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FLAG_SECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    @property
    def is_duplicate(self) -> bool:
        return bool(self.flag & FLAG_DUP)

    # -- tags (Sam/Alignment.pm:341-382) ---------------------------------
    def opt(self, tag: str, default=None):
        t = self.tags.get(tag)
        return t[1] if t is not None else default

    def set_opt(self, tag: str, type_char: str, value) -> None:
        self.tags[tag] = (type_char, value)

    @property
    def score(self) -> Optional[float]:
        """AS tag (Sam/Alignment.pm:525-530)."""
        v = self.opt("AS")
        return None if v is None else float(v)

    # -- cigar-derived geometry (Sam/Alignment.pm:393-431) ---------------
    def cigar_ops(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.cigar in ("*", ""):
            return np.zeros(0, np.int8), np.zeros(0, np.int32)
        return parse_cigar(self.cigar)

    @property
    def ref_span(self) -> int:
        """Reference bases consumed (M/D/N/=/X)."""
        span = 0
        for n, op in _CIGAR_RE.findall(self.cigar):
            if op in "MDN=X":
                span += int(n)
        return span

    @property
    def length(self) -> int:
        """Aligned query length (M/I/=/X) — soft clips excluded."""
        ln = 0
        for n, op in _CIGAR_RE.findall(self.cigar):
            if op in "MI=X":
                ln += int(n)
        return ln

    @property
    def full_length(self) -> int:
        """Query length incl. soft AND hard clips."""
        ln = 0
        for n, op in _CIGAR_RE.findall(self.cigar):
            if op in "MISH=X":
                ln += int(n)
        return ln

    # -- conversions ------------------------------------------------------
    def phreds(self, offset: int = 33) -> Optional[np.ndarray]:
        if self.qual in ("*", ""):
            return None
        q = np.frombuffer(self.qual.encode("ascii"), np.uint8).astype(np.int16)
        return (q - offset).clip(0).astype(np.uint8)

    def to_alignment(self, invert_scores: bool = False) -> Alignment:
        """Engine :class:`Alignment` view of this record (seq already in
        reference orientation per SAM convention). ``=``/``X``/``N`` ops are
        normalized to ``M``/``D``."""
        ops, lens = self.cigar_ops()
        return Alignment(
            qname=self.qname,
            pos0=self.pos,
            seq_codes=encode_ascii(self.seq if self.seq != "*" else ""),
            ops=ops,
            lens=lens,
            qual=self.phreds(),
            score=self.score,
            flag=self.flag,
        )

    @classmethod
    def from_alignment(cls, a: Alignment, rname: str,
                       seq: str, qual: str = "*",
                       mapq: int = 60) -> "SamAlignment":
        from proovread_tpu_torch.consensus.cigar import M, I, D, S, H  # noqa: N811

        sym = {M: "M", I: "I", D: "D", S: "S", H: "H"}
        cig = "".join(f"{int(n)}{sym[int(o)]}"
                      for o, n in zip(a.ops, a.lens)) or "*"
        rec = cls(qname=a.qname, flag=a.flag, rname=rname, pos=a.pos0,
                  mapq=mapq, cigar=cig, seq=seq, qual=qual)
        if a.score is not None:
            rec.set_opt("AS", "i", int(a.score))
        return rec

    # -- SAM text ---------------------------------------------------------
    def to_sam_line(self) -> str:
        fields = [
            self.qname, str(self.flag), self.rname, str(self.pos + 1),
            str(self.mapq), self.cigar, self.rnext,
            str(self.pnext + 1), str(self.tlen), self.seq, self.qual,
        ]
        for tag, (tc, val) in self.tags.items():
            if tc == "B":
                sub, arr = val
                body = ",".join(str(x) for x in arr)
                fields.append(f"{tag}:B:{sub},{body}")
            else:
                fields.append(f"{tag}:{tc}:{val}")
        return "\t".join(fields)

    @classmethod
    def from_sam_line(cls, line: str) -> "SamAlignment":
        parts = line.rstrip("\n").split("\t")
        if len(parts) < 11:
            raise ValueError(f"malformed SAM line ({len(parts)} fields): "
                             f"{line[:80]!r}")
        rec = cls(
            qname=parts[0], flag=int(parts[1]), rname=parts[2],
            pos=int(parts[3]) - 1, mapq=int(parts[4]), cigar=parts[5],
            rnext=parts[6], pnext=int(parts[7]) - 1, tlen=int(parts[8]),
            seq=parts[9], qual=parts[10],
        )
        for f in parts[11:]:
            tag, tc, val = f.split(":", 2)
            if tc in "iI":
                rec.tags[tag] = ("i", int(val))
            elif tc == "f":
                rec.tags[tag] = ("f", float(val))
            elif tc == "B":
                sub = val[0]
                conv = float if sub == "f" else int
                rec.tags[tag] = ("B", (sub, [conv(x)
                                             for x in val[2:].split(",")]))
            else:
                rec.tags[tag] = (tc, val)
        return rec


@dataclass
class SamHeader:
    lines: List[str] = field(default_factory=list)   # full @-lines
    refs: Dict[str, int] = field(default_factory=dict)  # SQ name -> length

    def add_ref(self, name: str, length: int) -> None:
        if name not in self.refs:
            self.refs[name] = length
            self.lines.append(f"@SQ\tSN:{name}\tLN:{length}")

    @classmethod
    def from_lines(cls, lines: Iterable[str]) -> "SamHeader":
        h = cls()
        for ln in lines:
            ln = ln.rstrip("\n")
            h.lines.append(ln)
            if ln.startswith("@SQ"):
                name, length = None, None
                for f in ln.split("\t")[1:]:
                    if f.startswith("SN:"):
                        name = f[3:]
                    elif f.startswith("LN:"):
                        length = int(f[3:])
                if name is not None:
                    h.refs[name] = length or 0
        return h

    def text(self) -> str:
        return "".join(ln + "\n" for ln in self.lines)


# --------------------------------------------------------------------------
# readers
# --------------------------------------------------------------------------

def _is_bam(path: str) -> bool:
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic[:2] == b"\x1f\x8b":
        with gzip.open(path, "rb") as gz:
            return gz.read(4) == b"BAM\x01"
    return False


class SamReader:
    """Streaming SAM/BAM reader. Accepts a path (plain SAM, gzipped SAM, or
    BAM — sniffed) or a text file object."""

    def __init__(self, source: Union[str, _io.IOBase]):
        self._bam = False
        self._path = source if isinstance(source, str) else None
        if isinstance(source, str):
            if _is_bam(source):
                self._bam = True
                self._fh = gzip.open(source, "rb")
            else:
                opener = gzip.open if _gzipped(source) else open
                self._fh = opener(source, "rt")
        else:
            self._fh = source
        self.header = self._read_header()

    def _read_header(self) -> SamHeader:
        if self._bam:
            return self._read_bam_header()
        lines = []
        self._pending: Optional[str] = None
        while True:
            ln = self._fh.readline()
            if not ln:
                break
            if ln.startswith("@"):
                lines.append(ln)
            else:
                # buffer instead of seek(): keeps pipes/stdin working
                self._pending = ln
                break
        return SamHeader.from_lines(lines)

    def __iter__(self) -> Iterator[SamAlignment]:
        if self._bam:
            yield from self._iter_bam()
            return
        if getattr(self, "_pending", None):
            ln, self._pending = self._pending, None
            if ln.strip():
                yield SamAlignment.from_sam_line(ln)
        for ln in self._fh:
            if not ln.strip() or ln.startswith("@"):
                continue
            yield SamAlignment.from_sam_line(ln)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- BAM decode -------------------------------------------------------
    def _read_bam_header(self) -> SamHeader:
        fh = self._fh
        magic = fh.read(4)
        if magic != b"BAM\x01":
            raise ValueError("not a BAM stream")
        (l_text,) = struct.unpack("<i", fh.read(4))
        text = fh.read(l_text).rstrip(b"\x00").decode()
        (n_ref,) = struct.unpack("<i", fh.read(4))
        self._bam_refs: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", fh.read(4))
            name = fh.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", fh.read(4))
            self._bam_refs.append((name, l_ref))
        hdr = SamHeader.from_lines(
            ln for ln in text.split("\n") if ln.startswith("@"))
        for name, ln in self._bam_refs:
            hdr.add_ref(name, ln)
        return hdr

    def _iter_bam(self) -> Iterator[SamAlignment]:
        fh = self._fh
        refs = self._bam_refs
        while True:
            raw = fh.read(4)
            if len(raw) < 4:
                return
            (block_size,) = struct.unpack("<i", raw)
            data = fh.read(block_size)
            yield _decode_bam_record(data, refs)

    # -- indexed region access (the role of Sam/Parser.pm:386-417, which
    # shells out to `samtools view <region>`) ----------------------------
    def fetch(self, rname: str, start: int = 0,
              end: Optional[int] = None) -> Iterator[SamAlignment]:
        """Alignments overlapping ``rname:[start, end)`` via the ``.bai``
        index (built by :func:`build_bai` or samtools index). BAM paths
        only; raises if no index file is found."""
        if not self._bam or not isinstance(self._path, str):
            raise ValueError("fetch() needs a BAM file path")
        bai = _find_bai(self._path)
        if bai is None:
            raise FileNotFoundError(
                f"no .bai index for {self._path!r} (run build_bai() or "
                "samtools index)")
        refs = self._bam_refs
        try:
            ref_id = next(i for i, (n, _) in enumerate(refs) if n == rname)
        except StopIteration:
            return
        if end is None:
            end = refs[ref_id][1] or 1 << 29
        if end <= start:
            return
        # cache the parsed index on the reader: region re-entry fetches
        # once per wanted ref, and the .bai covers ALL refs
        cache = getattr(self, "_bai_cache", None)
        if cache is None or cache[0] != bai:
            cache = (bai, _parse_bai(bai))
            self._bai_cache = cache
        bins, ioff = cache[1][ref_id]
        min_off = 0
        w = start >> 14
        if ioff:
            min_off = ioff[min(w, len(ioff) - 1)]
        chunks = []
        for b in _reg2bins(start, end):
            for beg, cend in bins.get(b, ()):
                if cend > min_off:
                    chunks.append((max(beg, min_off), cend))
        if not chunks:
            return
        chunks.sort()
        merged = [list(chunks[0])]
        for beg, cend in chunks[1:]:
            if beg <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], cend)
            else:
                merged.append([beg, cend])
        bz = BgzfReader(self._path)
        try:
            for beg, cend in merged:
                bz.seek_virtual(beg)
                while bz.tell_virtual() < cend:
                    raw = bz.read(4)
                    if len(raw) < 4:
                        break
                    (block_size,) = struct.unpack("<i", raw)
                    data = bz.read(block_size)
                    (r_id, pos) = struct.unpack_from("<ii", data, 0)
                    if r_id != ref_id or pos >= end:
                        if r_id > ref_id or (r_id == ref_id and pos >= end):
                            break
                        continue
                    rec = _decode_bam_record(data, refs)
                    if rec.pos + max(rec.ref_span, 1) > start:
                        yield rec
        finally:
            bz.close()

    @staticmethod
    def _parse_bam_tags(data: bytes, off: int, rec: SamAlignment) -> None:
        end = len(data)
        ints = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
                "I": "<I"}
        while off < end - 2:
            tag = data[off:off + 2].decode()
            tc = chr(data[off + 2])
            off += 3
            if tc in ints:
                (v,) = struct.unpack_from(ints[tc], data, off)
                off += struct.calcsize(ints[tc])
                rec.tags[tag] = ("i", int(v))
            elif tc == "f":
                (v,) = struct.unpack_from("<f", data, off)
                off += 4
                rec.tags[tag] = ("f", float(v))
            elif tc == "A":
                rec.tags[tag] = ("A", chr(data[off]))
                off += 1
            elif tc in "ZH":
                z = data.index(b"\x00", off)
                rec.tags[tag] = (tc, data[off:z].decode())
                off = z + 1
            elif tc == "B":
                sub = chr(data[off])
                (cnt,) = struct.unpack_from("<i", data, off + 1)
                off += 5
                fmt = ints.get(sub, "<f")
                w = struct.calcsize(fmt)
                vals = [struct.unpack_from(fmt, data, off + i * w)[0]
                        for i in range(cnt)]
                off += cnt * w
                rec.tags[tag] = ("B", (sub, vals))
            else:
                raise ValueError(f"unknown BAM tag type {tc!r}")


def _decode_bam_record(data: bytes,
                       refs: List[Tuple[str, int]]) -> SamAlignment:
    """One BAM alignment body (after the block_size field) -> record."""
    (ref_id, pos, l_qname, mapq, _bin, n_cigar, flag, l_seq,
     next_ref, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", data, 0)
    off = 32
    qname = data[off:off + l_qname - 1].decode()
    off += l_qname
    cig_parts = []
    for _ in range(n_cigar):
        (w,) = struct.unpack_from("<I", data, off)
        off += 4
        cig_parts.append(f"{w >> 4}{_CIGAR_OPS[w & 0xF]}")
    cigar = "".join(cig_parts) or "*"
    nb = (l_seq + 1) // 2
    seq_b = data[off:off + nb]
    off += nb
    seq = "".join(
        _SEQ16[(seq_b[i // 2] >> (4 if i % 2 == 0 else 0)) & 0xF]
        for i in range(l_seq)) or "*"
    qual_b = data[off:off + l_seq]
    off += l_seq
    if l_seq and qual_b[0] != 0xFF:
        qual = bytes(q + 33 for q in qual_b).decode("ascii")
    else:
        qual = "*"
    rec = SamAlignment(
        qname=qname, flag=flag,
        rname=refs[ref_id][0] if ref_id >= 0 else "*",
        pos=pos, mapq=mapq, cigar=cigar,
        rnext=(refs[next_ref][0] if next_ref >= 0 else "*"),
        pnext=next_pos, tlen=tlen, seq=seq, qual=qual,
    )
    SamReader._parse_bam_tags(data, off, rec)
    return rec


class BgzfReader:
    """Random-access BGZF reader with htslib virtual offsets
    (``(compressed_block_start << 16) | offset_within_block``)."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        self._coff = 0          # file offset of the loaded block
        self._next = 0          # file offset of the following block
        self._buf = b""
        self._pos = 0

    def _load_block(self, coff: int) -> bool:
        fh = self._fh
        fh.seek(coff)
        hdr = fh.read(12)
        if len(hdr) < 12:
            self._coff, self._next = coff, coff
            self._buf, self._pos = b"", 0
            return False
        if hdr[:2] != b"\x1f\x8b":
            raise ValueError(f"not a BGZF block at offset {coff}")
        (xlen,) = struct.unpack_from("<H", hdr, 10)
        extra = fh.read(xlen)
        bsize = None
        o = 0
        while o + 4 <= len(extra):
            si1, si2, slen = extra[o], extra[o + 1], \
                struct.unpack_from("<H", extra, o + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, o + 4)[0]
            o += 4 + slen
        if bsize is None:
            raise ValueError(f"missing BGZF BC subfield at offset {coff}")
        comp = fh.read(bsize + 1 - 12 - xlen - 8)
        fh.read(8)                                   # crc32 + isize
        self._buf = zlib.decompressobj(-15).decompress(comp)
        self._coff = coff
        self._next = coff + bsize + 1
        self._pos = 0
        return True

    def _advance(self) -> bool:
        """Load the next block when the current one is exhausted; False at
        EOF (or the 28-byte empty EOF block, whose payload is empty)."""
        while self._pos >= len(self._buf):
            if not self._load_block(self._next):
                return False
        return True

    def seek_virtual(self, voff: int) -> None:
        self._load_block(voff >> 16)
        self._pos = voff & 0xFFFF

    def tell_virtual(self) -> int:
        if self._pos >= len(self._buf):
            if not self._advance():
                return self._coff << 16
        return (self._coff << 16) | self._pos

    def read(self, n: int) -> bytes:
        out = b""
        while n > 0:
            if not self._advance():
                break
            take = self._buf[self._pos:self._pos + n]
            self._pos += len(take)
            n -= len(take)
            out += take
        return out

    def close(self) -> None:
        self._fh.close()


def _reg2bins(beg: int, end: int):
    """All UCSC-binning bins overlapping [beg, end) (SAM spec 5.1.1)."""
    end -= 1
    yield 0
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        for k in range(off + (beg >> shift), off + (end >> shift) + 1):
            yield k


def _find_bai(path: str) -> Optional[str]:
    import os
    for cand in (path + ".bai", re.sub(r"\.bam$", ".bai", path)):
        if os.path.exists(cand):
            return cand
    return None


def _parse_bai(path: str):
    """[.bai] -> per-ref (bins: {bin: [(voff_beg, voff_end)]}, ioffsets)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"BAI\x01":
        raise ValueError(f"{path!r} is not a BAI index")
    (n_ref,) = struct.unpack_from("<i", data, 4)
    off = 8
    out = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bins: Dict[int, list] = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                beg, cend = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((beg, cend))
            if b != 37450:                           # metadata pseudo-bin
                bins[b] = chunks
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        ioff = list(struct.unpack_from(f"<{n_intv}Q", data, off))
        off += 8 * n_intv
        out.append((bins, ioff))
    return out


def build_bai(bam_path: str, out_path: Optional[str] = None) -> str:
    """Build a standard ``.bai`` index for a coordinate-sorted BAM — the
    native stand-in for ``samtools index`` (the reference's region access,
    ``Sam/Parser.pm:386-417``, assumes an indexed BAM)."""
    bz = BgzfReader(bam_path)
    if bz.read(4) != b"BAM\x01":
        bz.close()
        raise ValueError(f"{bam_path!r} is not a BAM file")
    (l_text,) = struct.unpack("<i", bz.read(4))
    bz.read(l_text)
    (n_ref,) = struct.unpack("<i", bz.read(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", bz.read(4))
        bz.read(l_name + 4)

    bins = [dict() for _ in range(n_ref)]            # bin -> [beg, end] list
    ioffs = [dict() for _ in range(n_ref)]           # window -> min voff
    prev_ref, prev_pos = -1, -1
    while True:
        voff = bz.tell_virtual()
        raw = bz.read(4)
        if len(raw) < 4:
            break
        (block_size,) = struct.unpack("<i", raw)
        data = bz.read(block_size)
        vend = bz.tell_virtual()
        (ref_id, pos, l_qname, _mapq, _bin, n_cigar) = \
            struct.unpack_from("<iiBBHH", data, 0)
        if ref_id < 0:
            continue
        if ref_id < prev_ref or (ref_id == prev_ref and pos < prev_pos):
            bz.close()
            raise ValueError("BAM is not coordinate-sorted; cannot index")
        prev_ref, prev_pos = ref_id, pos
        span = 0
        o = 32 + l_qname
        for _ in range(n_cigar):
            (w,) = struct.unpack_from("<I", data, o)
            o += 4
            if _CIGAR_OPS[w & 0xF] in "MDN=X":
                span += w >> 4
        end = pos + max(span, 1)
        b = _reg2bin(pos, end)
        blist = bins[ref_id].setdefault(b, [])
        if blist and blist[-1][1] == voff:
            blist[-1][1] = vend                      # coalesce adjacent
        else:
            blist.append([voff, vend])
        for w in range(pos >> 14, ((end - 1) >> 14) + 1):
            cur = ioffs[ref_id].get(w)
            if cur is None or voff < cur:
                ioffs[ref_id][w] = voff
    bz.close()

    out_path = out_path or bam_path + ".bai"
    with open(out_path, "wb") as fh:
        fh.write(b"BAI\x01" + struct.pack("<i", n_ref))
        for r in range(n_ref):
            fh.write(struct.pack("<i", len(bins[r])))
            for b in sorted(bins[r]):
                chunks = bins[r][b]
                fh.write(struct.pack("<Ii", b, len(chunks)))
                for beg, cend in chunks:
                    fh.write(struct.pack("<QQ", beg, cend))
            n_intv = (max(ioffs[r]) + 1) if ioffs[r] else 0
            fh.write(struct.pack("<i", n_intv))
            filled = 0
            for w in range(n_intv):
                filled = ioffs[r].get(w, filled)
                fh.write(struct.pack("<Q", filled))
    return out_path


def _gzipped(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(2) == b"\x1f\x8b"


# --------------------------------------------------------------------------
# writers
# --------------------------------------------------------------------------

class SamWriter:
    """SAM text writer."""

    def __init__(self, dest: Union[str, _io.IOBase],
                 header: Optional[SamHeader] = None):
        self._own = isinstance(dest, str)
        self._fh = open(dest, "w") if self._own else dest
        if header is not None and header.lines:
            self._fh.write(header.text())

    def write(self, rec: SamAlignment) -> None:
        self._fh.write(rec.to_sam_line() + "\n")

    def close(self) -> None:
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


class BamWriter:
    """BAM writer with proper BGZF framing (BC extra field + EOF marker) so
    external samtools can consume the output."""

    def __init__(self, path: str, header: SamHeader):
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._refs = list(header.refs.items())
        self._ref_idx = {n: i for i, (n, _) in enumerate(self._refs)}
        text = header.text().encode()
        out = bytearray(b"BAM\x01")
        out += struct.pack("<i", len(text)) + text
        out += struct.pack("<i", len(self._refs))
        for name, ln in self._refs:
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        self._raw(bytes(out))

    def _raw(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= 0xFF00:
            self._flush_block(self._buf[:0xFF00])
            del self._buf[:0xFF00]

    def _flush_block(self, chunk: bytes) -> None:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(bytes(chunk)) + co.flush()
        # BSIZE = total block length - 1 (BGZF spec; cf. the EOF marker's
        # 0x1b for its 28-byte block): 12B gzip header + 6B BC subfield +
        # deflate payload + 8B crc/isize
        bsize = len(comp) + 25
        block = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                 + struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, bsize)
                 + comp
                 + struct.pack("<II", zlib.crc32(bytes(chunk)) & 0xFFFFFFFF,
                               len(chunk)))
        self._fh.write(block)

    def write(self, rec: SamAlignment) -> None:
        ref_id = self._ref_idx.get(rec.rname, -1)
        next_ref = (ref_id if rec.rnext == "=" else
                    self._ref_idx.get(rec.rnext, -1))
        qname_b = rec.qname.encode() + b"\x00"
        cig = b""
        n_cigar = 0
        if rec.cigar not in ("*", ""):
            for n, op in _CIGAR_RE.findall(rec.cigar):
                cig += struct.pack("<I", (int(n) << 4) | _CIGAR_OPS.index(op))
                n_cigar += 1
        seq = rec.seq if rec.seq != "*" else ""
        l_seq = len(seq)
        sb = bytearray((l_seq + 1) // 2)
        for i, c in enumerate(seq):
            code = _SEQ16_CODE.get(c.upper(), 15)
            sb[i // 2] |= code << (4 if i % 2 == 0 else 0)
        if rec.qual not in ("*", "") and l_seq:
            qb = bytes((ord(c) - 33) for c in rec.qual)
        else:
            qb = b"\xff" * l_seq
        tags = b""
        for tag, (tc, val) in rec.tags.items():
            tb = tag.encode()
            if tc == "i":
                tags += tb + b"i" + struct.pack("<i", int(val))
            elif tc == "f":
                tags += tb + b"f" + struct.pack("<f", float(val))
            elif tc == "A":
                tags += tb + b"A" + str(val).encode()[:1]
            elif tc in "ZH":
                tags += tb + tc.encode() + str(val).encode() + b"\x00"
            elif tc == "B":
                sub, vals = val
                fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H",
                       "i": "<i", "I": "<I"}.get(sub, "<f")
                tags += (tb + b"B" + sub.encode()
                         + struct.pack("<i", len(vals))
                         + b"".join(struct.pack(fmt, v) for v in vals))
        body = struct.pack(
            "<iiBBHHHiiii", ref_id, rec.pos, len(qname_b), rec.mapq,
            _reg2bin(rec.pos, rec.pos + max(rec.ref_span, 1)), n_cigar,
            rec.flag, l_seq, next_ref, rec.pnext, rec.tlen,
        ) + qname_b + cig + bytes(sb) + qb + tags
        self._raw(struct.pack("<i", len(body)) + body)

    def close(self) -> None:
        if self._buf:
            self._flush_block(self._buf)
            self._buf = bytearray()
        self._fh.write(_BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _reg2bin(beg: int, end: int) -> int:
    """UCSC binning (SAM spec section 5.3)."""
    end -= 1
    if beg < 0:
        return 0
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


# --------------------------------------------------------------------------
# secondary-alignment seq/qual restore (bin/samfilter:41-72,
# bin/sam2cns:593-607)
# --------------------------------------------------------------------------

def restore_secondary(records: Iterable[SamAlignment],
                      drop_unmapped: bool = True,
                      default_qual: str = "?") -> Iterator[SamAlignment]:
    """Stream filter: drop unmapped records, restore '*' seq/qual of
    secondary alignments from the primary of the same qname (revcomp when
    strands differ), default qual when the primary has none.

    Only the MOST RECENT primary is cached (the reference caches exactly one
    record, ``bin/samfilter:47-49``) — memory stays O(1) and secondaries are
    restorable when they follow their primary, the shape mapper output and
    name-grouped streams have. Supplementary records (hard-clipped partial
    seq that would mismatch a secondary's CIGAR) never enter the cache."""
    prim_qname: Optional[str] = None
    prim: Tuple[str, str, int] = ("", "", 0)
    for rec in records:
        if rec.is_unmapped:
            if drop_unmapped:
                continue
            yield rec
            continue
        if (not rec.is_secondary and not rec.is_supplementary
                and rec.seq != "*"):
            prim_qname = rec.qname
            prim = (rec.seq, rec.qual, rec.flag)
        elif rec.seq == "*" and rec.qname == prim_qname:
            seq, qual, pflag = prim
            if (rec.flag ^ pflag) & FLAG_REVERSE:
                seq = seq.translate(_COMPLEMENT)[::-1]
                qual = qual[::-1] if qual != "*" else qual
            rec.seq = seq
            rec.qual = qual
        if rec.seq != "*" and rec.qual == "*":
            rec.qual = default_qual * len(rec.seq)
        yield rec
