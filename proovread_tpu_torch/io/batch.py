"""Padded/bucketed read batches — the host→device boundary.

Reads become dense tensors: codes int8 [B, L], qual uint8 [B, L], lengths
int32 [B]. Bucketing by length keeps XLA shapes static (a handful of compiled
programs) while bounding padding waste; this replaces the reference's
byte-offset file chunking (``bin/proovread:1493-1501``) as the unit of work
distribution.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.ops.encode import N, decode_codes, encode_ascii

DEFAULT_FALLBACK_PHRED = 1  # reference Sam::Seq FallbackPhred (Sam/Seq.pm:113-128)


@dataclass
class ReadBatch:
    """A fixed-shape batch of reads."""

    ids: List[str]
    codes: np.ndarray      # int8  [B, L]
    qual: np.ndarray       # uint8 [B, L]
    lengths: np.ndarray    # int32 [B]
    descs: List[str] = field(default_factory=list)

    @property
    def batch_size(self) -> int:
        return self.codes.shape[0]

    @property
    def pad_len(self) -> int:
        return self.codes.shape[1]

    def position_mask(self) -> np.ndarray:
        """bool [B, L]: True at valid (non-padding) positions."""
        return np.arange(self.pad_len)[None, :] < self.lengths[:, None]

    def record(self, i: int) -> SeqRecord:
        L = int(self.lengths[i])
        return SeqRecord(
            id=self.ids[i],
            seq=decode_codes(self.codes[i, :L]),
            qual=self.qual[i, :L].copy(),
            desc=self.descs[i] if self.descs else "",
        )

    def to_records(self) -> List[SeqRecord]:
        return [self.record(i) for i in range(self.batch_size)]


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pack_reads(
    records: Sequence[SeqRecord],
    pad_len: Optional[int] = None,
    pad_multiple: int = 128,
    fallback_phred: int = DEFAULT_FALLBACK_PHRED,
) -> ReadBatch:
    """Pack records into one padded batch.

    ``pad_len`` defaults to max length rounded up to ``pad_multiple``. FASTA records get ``fallback_phred`` quals,
    matching the reference's FallbackPhred for qual-less input."""
    B = len(records)
    maxlen = max((len(r) for r in records), default=0)
    L = pad_len if pad_len is not None else max(pad_multiple, _round_up(maxlen, pad_multiple))
    if maxlen > L:
        raise ValueError(f"pad_len {L} < longest read {maxlen}")
    codes = np.full((B, L), N, dtype=np.int8)
    qual = np.zeros((B, L), dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for i, r in enumerate(records):
        n = len(r)
        codes[i, :n] = encode_ascii(r.seq)
        qual[i, :n] = r.qual if r.qual is not None else fallback_phred
        lengths[i] = n
    return ReadBatch(
        ids=[r.id for r in records],
        codes=codes,
        qual=qual,
        lengths=lengths,
        descs=[r.desc for r in records],
    )

