"""Streaming FASTA codec (reference ``lib/Fasta/Parser.pm``); the port's
own copy of ``proovread_tpu/io/fasta.py``, byte for byte the same output.

Feature parity: iteration, gzip input, byte-offset ``tell``/``seek`` with
record resync, random sampling (``Fasta/Parser.pm:185-234``) and count
estimation (``:276-290``) — implemented over buffered binary streams rather
than the reference's line-wise Perl IO.
"""

from __future__ import annotations

import gzip
import io
import os
import random
import sys
from typing import IO, Iterator, List, Optional, Union

from proovread_tpu_torch.io.records import SeqRecord


def _open_maybe_gzip(path_or_handle, mode: str = "rb") -> IO[bytes]:
    if hasattr(path_or_handle, "read"):
        return path_or_handle
    path = os.fspath(path_or_handle)
    if path == "-":
        return sys.stdin.buffer if "r" in mode else sys.stdout.buffer
    f = open(path, mode)
    if "r" in mode:
        magic = f.read(2)
        f.seek(0)
        if magic == b"\x1f\x8b":
            return gzip.open(f, mode)
    return f


def _split_header(line: str):
    parts = line.split(None, 1)
    ident = parts[0] if parts else ""
    desc = parts[1].rstrip() if len(parts) > 1 else ""
    return ident, desc


class FastaReader:
    """Iterate :class:`SeqRecord` s from a FASTA file/handle (gzip-aware)."""

    def __init__(self, path_or_handle: Union[str, IO[bytes]]):
        self._fh = _open_maybe_gzip(path_or_handle)
        self._pending: Optional[bytes] = None  # buffered '>' header line

    def __iter__(self) -> Iterator[SeqRecord]:
        return self

    def __next__(self) -> SeqRecord:
        header = self._pending
        self._pending = None
        if header is None:
            for line in self._fh:
                if line.startswith(b">"):
                    header = line
                    break
            if header is None:
                raise StopIteration
        chunks: List[bytes] = []
        for line in self._fh:
            if line.startswith(b">"):
                self._pending = line
                break
            chunks.append(line.strip())
        ident, desc = _split_header(header[1:].decode("ascii", "replace"))
        return SeqRecord(id=ident, seq=b"".join(chunks).decode("ascii"), desc=desc)

    # -- random access ---------------------------------------------------
    def tell(self) -> int:
        return self._fh.tell()

    def seek(self, offset: int) -> None:
        """Seek to a byte offset and resync to the next record start."""
        self._fh.seek(offset)
        self._pending = None
        for line in self._fh:
            if line.startswith(b">"):
                self._pending = line
                return

    def sample(self, n: int, seed: int = 0) -> List[SeqRecord]:
        """Sample ~n records: full read for small files, random seeks for
        large ones (reference ``Fasta/Parser.pm:185-234``)."""
        return _sample_seekable(self, n, seed)

    def estimate_count(self, probe_bytes: int = 1 << 20) -> int:
        return _estimate_count(self, marker=b">", probe_bytes=probe_bytes)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FastaWriter:
    def __init__(self, path_or_handle: Union[str, IO[bytes]], line_width: int = 0):
        if hasattr(path_or_handle, "write"):
            self._fh = path_or_handle
        else:
            self._fh = open(os.fspath(path_or_handle), "wb")
        self.line_width = line_width

    def write(self, rec: SeqRecord) -> int:
        """Write one record; returns the byte offset it started at."""
        off = self._fh.tell() if self._fh.seekable() else -1
        head = f">{rec.full_id}\n".encode("ascii")
        if self.line_width:
            body = b"\n".join(
                rec.seq[i : i + self.line_width].encode("ascii")
                for i in range(0, len(rec.seq), self.line_width)
            ) + b"\n"
        else:
            body = rec.seq.encode("ascii") + b"\n"
        self._fh.write(head + body)
        return off

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- shared helpers (used by fastq.py too) ------------------------------

def _stream_size(fh) -> Optional[int]:
    """On-disk byte size in the same coordinate system as fh.tell()/seek(),
    or None for gzip (compressed fstat size != decompressed offsets),
    in-memory, and non-seekable handles."""
    if isinstance(fh, gzip.GzipFile):
        return None
    try:
        if not fh.seekable():
            return None
        return os.fstat(fh.fileno()).st_size
    except (OSError, AttributeError, io.UnsupportedOperation):
        try:
            pos = fh.tell()
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(pos)
            return size
        except (OSError, io.UnsupportedOperation):
            return None


def _sample_seekable(reader, n: int, seed: int) -> List[SeqRecord]:
    fh = reader._fh
    size = _stream_size(fh)
    SMALL = 10 << 20  # full-shuffle threshold, as in the reference (10 MB)
    rng = random.Random(seed)
    if size is None or size < SMALL:
        seekable = False
        try:
            seekable = fh.seekable()
        except (AttributeError, ValueError):
            pass
        pos = fh.tell() if seekable else None
        pending = reader._pending
        if seekable:
            fh.seek(0)
            reader._pending = None
        recs = list(reader)
        if seekable and pos is not None:
            fh.seek(pos)
        reader._pending = pending
        if len(recs) <= n:
            return recs
        return rng.sample(recs, n)
    pos, pending = fh.tell(), reader._pending
    out: List[SeqRecord] = []
    seen_ids = set()
    attempts = 0
    try:
        while len(out) < n and attempts < n * 20:
            attempts += 1
            reader.seek(rng.randrange(size))
            try:
                rec = next(reader)
            except StopIteration:
                continue
            if rec.id not in seen_ids:
                seen_ids.add(rec.id)
                out.append(rec)
    finally:
        fh.seek(pos)
        reader._pending = pending
    return out


def _count_all(reader) -> int:
    """Record count by full iteration from the start, restoring the stream."""
    fh = reader._fh
    pos = None
    pending = reader._pending
    try:
        pos = fh.tell()
        fh.seek(0)
    except (OSError, io.UnsupportedOperation):
        pass
    reader._pending = None
    count = sum(1 for _ in reader)
    if pos is not None:
        fh.seek(pos)
    reader._pending = pending
    return count


def _estimate_count(reader, marker: bytes, probe_bytes: int) -> int:
    fh = reader._fh
    size = _stream_size(fh)
    if size is None:
        # gzip / in-memory: no byte-size heuristics possible
        return _count_all(reader)
    pos = fh.tell()
    fh.seek(0)
    chunk = fh.read(min(probe_bytes, size))
    fh.seek(pos)
    if not chunk:
        return 0
    hits = chunk.count(b"\n" + marker) + (1 if chunk.startswith(marker) else 0)
    if len(chunk) >= size:
        return hits
    return max(1, int(round(hits * size / len(chunk))))
