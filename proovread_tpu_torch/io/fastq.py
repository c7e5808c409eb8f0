"""Streaming FASTQ codec (reference ``lib/Fastq/Parser.pm``); the port's
own copy of ``proovread_tpu/io/fastq.py``, byte for byte the same output.

Feature parity: iteration, gzip (``Fastq/Parser.pm:226-231``), byte seek with
record resync (``:278-332``), random sampling (``:477-547``), phred-offset /
read-length / count guessing (``:559-660``), append+tell offset indexing
(``:445-462``).
"""

from __future__ import annotations

import os
from typing import IO, Iterator, List, Optional, Tuple, Union

import numpy as np

from proovread_tpu_torch.io.fasta import _open_maybe_gzip, _sample_seekable, _split_header
from proovread_tpu_torch.io.records import SeqRecord


class FastqReader:
    def __init__(self, path_or_handle: Union[str, IO[bytes]], phred_offset: Optional[int] = None):
        self._fh = _open_maybe_gzip(path_or_handle)
        self._pending: Optional[bytes] = None
        self.phred_offset = phred_offset

    def _offset(self) -> int:
        if self.phred_offset is None:
            self.phred_offset = self.guess_phred_offset()
        return self.phred_offset

    def __iter__(self) -> Iterator[SeqRecord]:
        return self

    def __next__(self) -> SeqRecord:
        header = self._pending
        self._pending = None
        if header is None:
            header = self._fh.readline()
            while header in (b"\n", b"\r\n"):
                header = self._fh.readline()
        if not header:
            raise StopIteration
        if not header.startswith(b"@"):
            raise ValueError(f"malformed FASTQ header: {header[:60]!r}")
        seq = self._fh.readline().strip()
        plus = self._fh.readline()
        if not plus.startswith(b"+"):
            raise ValueError(f"malformed FASTQ separator for {header[:60]!r}")
        qual = self._fh.readline().strip()
        if len(qual) != len(seq):
            raise ValueError(f"seq/qual length mismatch for {header[:60]!r}")
        ident, desc = _split_header(header[1:].decode("ascii", "replace"))
        return SeqRecord.from_qual_str(
            ident, seq.decode("ascii"), qual.decode("ascii"), offset=self._offset(), desc=desc
        )

    # -- random access ---------------------------------------------------
    def tell(self) -> int:
        return self._fh.tell()

    def seek(self, offset: int, find_record: bool = True) -> None:
        """Seek to byte offset; with ``find_record`` resync to the next record
        start (reference ``next_seq(find_record=>1)``, ``Fastq/Parser.pm:278-332``).
        '@' alone is ambiguous (quality strings may start with '@'), so a
        4-line window is validated before accepting a candidate header."""
        self._fh.seek(offset)
        self._pending = None
        if not find_record or offset == 0:
            return
        # Keep the line at the seek point: offsets recorded by
        # FastqWriter.write / tell() land exactly on a record start, and the
        # 4-line window validation rejects a partial line in all but
        # pathological cases (a mid-line suffix that happens to start with
        # '@' AND is followed by seq/+/qual with matching lengths).
        lines: List[bytes] = []
        positions: List[int] = []
        for _ in range(9):
            positions.append(self._fh.tell())
            line = self._fh.readline()
            if not line:
                break
            lines.append(line)
        for i, line in enumerate(lines):
            if (
                line.startswith(b"@")
                and i + 2 < len(lines)
                and lines[i + 2].startswith(b"+")
                and i + 3 < len(lines)
                and len(lines[i + 3].strip()) == len(lines[i + 1].strip())
            ):
                self._fh.seek(positions[i])
                return
        # fall through: leave positioned at EOF-ish point
        self._fh.seek(positions[-1] if positions else offset)

    def sample(self, n: int, seed: int = 0) -> List[SeqRecord]:
        return _sample_seekable(self, n, seed)

    # -- guessing (reference Fastq/Parser.pm:559-660) --------------------
    def guess_phred_offset(self, probe: int = 1000) -> int:
        """33 vs 64 from observed quality chars; chars <'@'(64) force 33.
        Non-seekable streams (pipes) can't be probed without losing records,
        so they default to 33 — pass ``phred_offset`` explicitly for
        offset-64 piped input."""
        try:
            if not self._fh.seekable():
                return 33
        except (AttributeError, ValueError):
            return 33
        pos = self._fh.tell()
        self._fh.seek(0)
        lo = 255
        try:
            for _ in range(probe):
                header = self._fh.readline()
                while header in (b"\n", b"\r\n"):  # blank lines, as in __next__
                    header = self._fh.readline()
                if not header:
                    break
                self._fh.readline()
                self._fh.readline()
                qual = self._fh.readline().strip()
                if qual:
                    arr = np.frombuffer(qual, dtype=np.uint8)
                    lo = min(lo, int(arr.min()))
        finally:
            self._fh.seek(pos)
        if lo == 255:
            return 33
        if lo < 64:
            return 33
        # all chars >= '@': ambiguous below 'B'(66); >= 66 is solid offset-64
        return 64 if lo >= 66 else 33

    def guess_seq_length(self, probe: int = 1000, seed: int = 0) -> Tuple[float, float]:
        """(mean, stddev) of sampled read lengths."""
        recs = self.sample(probe, seed=seed)
        if not recs:
            return (0.0, 0.0)
        lens = np.array([len(r) for r in recs], dtype=np.float64)
        return (float(lens.mean()), float(lens.std()))

    def estimate_count(self, probe_bytes: int = 1 << 20) -> int:
        """Record-count estimate from mean sampled record byte size."""
        from proovread_tpu_torch.io.fasta import _count_all, _stream_size

        size = _stream_size(self._fh)
        if size is None:
            return _count_all(self)
        recs = self.sample(200)
        if not recs:
            return 0
        mean_bytes = np.mean(
            [len(r.seq) * 2 + len(r.id) + len(r.desc) + 7 for r in recs]
        )
        return max(len(recs), int(round(size / mean_bytes)))

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FastqWriter:
    """FASTQ writer; ``write`` returns the record's start byte offset so
    callers can build offset indexes (reference append+tell,
    ``Fastq/Parser.pm:445-462``, used by the driver's chunk index
    ``bin/proovread:1493-1501``)."""

    def __init__(self, path_or_handle: Union[str, IO[bytes]], phred_offset: int = 33):
        if hasattr(path_or_handle, "write"):
            self._fh = path_or_handle
        else:
            self._fh = open(os.fspath(path_or_handle), "wb")
        self.phred_offset = phred_offset

    def write(self, rec: SeqRecord) -> int:
        off = self._fh.tell() if self._fh.seekable() else -1
        if rec.qual is not None:
            qual = rec.qual_str(self.phred_offset)
        else:
            qual = chr(40 + self.phred_offset) * len(rec.seq)  # phred 40 in this offset
        self._fh.write(
            f"@{rec.full_id}\n{rec.seq}\n+\n{qual}\n".encode("ascii")
        )
        return off

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def check_format(path: str) -> str:
    """'fastq' | 'fasta' by first non-blank byte (reference check_format).

    Takes a real file path only: sniffing opens (and closes) its own handle,
    which would consume and close stdin or a caller-supplied stream."""
    if hasattr(path, "read") or os.fspath(path) == "-":
        raise TypeError("check_format needs a file path; cannot sniff streams/stdin")
    with _open_maybe_gzip(path) as fh:
        b = fh.read(1)
        while b and b in b"\r\n":
            b = fh.read(1)
    if b == b"@":
        return "fastq"
    if b == b">":
        return "fasta"
    raise ValueError(f"{path}: unrecognized sequence format (starts with {b!r})")


def open_seqfile(path: str, phred_offset: Optional[int] = None):
    """Open FASTA or FASTQ transparently based on content sniffing."""
    from proovread_tpu_torch.io.fasta import FastaReader

    fmt = check_format(path)
    if fmt == "fastq":
        return FastqReader(path, phred_offset=phred_offset)
    return FastaReader(path)
