"""Sequence record model.

One record class covers what the reference splits across ``lib/Fasta/Seq.pm``
and ``lib/Fastq/Seq.pm`` (object model with seq/qual/desc accessors, revcomp,
substr, phred transforms and masks; reference ``Fastq/Seq.pm:709-766``,
``Fasta/Seq.pm:117-189``). Sequences are held as Python ``str`` at the record
level; tensor encodings live in :mod:`proovread_tpu_torch.io.batch`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from typing import Iterable, List, Optional, Tuple

import numpy as np

_COMPLEMENT = str.maketrans(
    "ACGTUNacgtunRYSWKMBDHVryswkmbdhv",
    "TGCAANtgcaanYRSWMKVHDByrswmkvhdb",
)

# PacBio CLR subread id: m<movie>/<hole>/<start>_<stop>  (reference bin/ccseq:238)
_PACBIO_RE = re.compile(r"^(?P<movie>m[^/]*)/(?P<hole>\d+)(?:/(?P<start>\d+)_(?P<stop>\d+))?")


@dataclass
class SeqRecord:
    """A FASTA/FASTQ record: id, optional description, sequence, optional qual.

    ``qual`` is stored as a numpy uint8 array of *phred scores* (offset
    already removed), or ``None`` for FASTA records.
    """

    id: str
    seq: str
    qual: Optional[np.ndarray] = None
    desc: str = ""

    def __post_init__(self) -> None:
        if self.qual is not None:
            self.qual = np.asarray(self.qual, dtype=np.uint8)
            if len(self.qual) != len(self.seq):
                raise ValueError(
                    f"{self.id}: qual length {len(self.qual)} != seq length {len(self.seq)}"
                )

    def __len__(self) -> int:
        return len(self.seq)

    # -- accessors -------------------------------------------------------
    @property
    def full_id(self) -> str:
        return f"{self.id} {self.desc}" if self.desc else self.id

    def qual_str(self, offset: int = 33) -> str:
        if self.qual is None:
            raise ValueError(f"{self.id}: record has no qualities")
        return (self.qual + offset).tobytes().decode("ascii")

    @classmethod
    def from_qual_str(
        cls, id: str, seq: str, qual_str: str, offset: int = 33, desc: str = ""
    ) -> "SeqRecord":
        q = np.frombuffer(qual_str.encode("ascii"), dtype=np.uint8).astype(np.int16) - offset
        if len(q) and (q.min() < 0 or q.max() > 93):
            raise ValueError(f"{id}: phred out of range for offset {offset}")
        return cls(id=id, seq=seq, qual=q.astype(np.uint8), desc=desc)

    # -- transforms ------------------------------------------------------
    def reverse_complement(self) -> "SeqRecord":
        qual = self.qual[::-1].copy() if self.qual is not None else None
        return replace(self, seq=self.seq.translate(_COMPLEMENT)[::-1], qual=qual)

    def upper_acgtn(self) -> "SeqRecord":
        """Uppercase and replace non-ACGTN by N (reference bin/proovread:1420)."""
        s = self.seq.upper()
        s = re.sub("[^ACGTN]", "N", s)
        return replace(self, seq=s)

    def substr(self, offset: int, length: Optional[int] = None, annotate: bool = True) -> "SeqRecord":
        """Subrange record. Appends a ``SUBSTR:off,len`` description annotation
        like the reference's multi-slice substr (``Fastq/Seq.pm:813-876``) so
        coordinates remain traceable back to the source read."""
        if length is None:
            length = len(self.seq) - offset
        seq = self.seq[offset : offset + length]
        qual = self.qual[offset : offset + length].copy() if self.qual is not None else None
        desc = self.desc
        if annotate:
            tag = f"SUBSTR:{offset},{len(seq)}"
            desc = f"{desc} {tag}".strip()
        return replace(self, seq=seq, qual=qual, desc=desc)

    def substr_batch(self, coords: Iterable[Tuple[int, int]]) -> List["SeqRecord"]:
        """Multiple subranges; ids get ``.1 .2 …`` suffixes when >1 slice."""
        coords = list(coords)
        out = []
        for i, (off, ln) in enumerate(coords):
            r = self.substr(off, ln)
            if len(coords) > 1:
                r = replace(r, id=f"{self.id}.{i + 1}", qual=r.qual, desc=r.desc)
            out.append(r)
        return out

    # -- masking / quality machinery ------------------------------------
    def mask_seq(self, regions: Iterable[Tuple[int, int]], char: str = "N") -> "SeqRecord":
        """N-mask [offset, length] regions (reference ``Fastq/Seq.pm:745-750``)."""
        s = np.frombuffer(self.seq.encode("ascii"), dtype="S1").copy()
        for off, ln in regions:
            s[off : off + ln] = char.encode("ascii")
        return replace(self, seq=s.tobytes().decode("ascii"), qual=self.qual)

    def qual_runs(self, phred_min: int, phred_max: int, min_len: int = 1) -> List[Tuple[int, int]]:
        """Maximal runs of positions with phred in [phred_min, phred_max],
        of at least ``min_len`` — the regex-run detection of the reference's
        ``qual_lcs``/``qual_low`` (``Fastq/Seq.pm:709-735``) as a vector op.
        Returns [(offset, length), ...]."""
        if self.qual is None:
            return []
        inside = (self.qual >= phred_min) & (self.qual <= phred_max)
        return runs_from_bool(inside, min_len)

    def pacbio_meta(self) -> Optional[dict]:
        """Parse PacBio movie/hole/span from the id (reference bin/ccseq:238)."""
        m = _PACBIO_RE.match(self.id)
        if not m:
            return None
        d = m.groupdict()
        return {
            "movie": d["movie"],
            "hole": int(d["hole"]),
            "span": (int(d["start"]), int(d["stop"])) if d["start"] is not None else None,
        }


def runs_from_bool(mask: np.ndarray, min_len: int = 1) -> List[Tuple[int, int]]:
    """[(offset, length)] of maximal True-runs of length >= min_len."""
    mask = np.asarray(mask, dtype=bool)
    if mask.size == 0:
        return []
    padded = np.concatenate([[False], mask, [False]])
    diff = np.diff(padded.astype(np.int8))
    starts = np.flatnonzero(diff == 1)
    ends = np.flatnonzero(diff == -1)
    return [(int(s), int(e - s)) for s, e in zip(starts, ends) if e - s >= min_len]
