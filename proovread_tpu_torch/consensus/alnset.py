"""Alignment records grouped per long read: the part of
``proovread_tpu/consensus/alnset.py`` that the host mapper and siamaera use.

``Alignment`` is the minimal record the engine needs (the role of
``lib/Sam/Alignment.pm``); ``AlnSet`` groups the alignments of one long read.
Score filters and score-binned admission belong to the host scan engine and
come with it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from proovread_tpu_torch.consensus.cigar import ref_span


@dataclass
class Alignment:
    """One short-read (or unitig) alignment onto a long read."""

    qname: str
    pos0: int                       # 0-based reference position
    seq_codes: np.ndarray           # int8 query codes incl. soft-clipped bases
    ops: np.ndarray                 # CIGAR op codes (cigar.M/I/D/S/H)
    lens: np.ndarray                # CIGAR op lengths
    qual: Optional[np.ndarray] = None  # uint8 phreds or None
    score: Optional[float] = None   # AS tag
    flag: int = 0
    _span: Optional[int] = None

    @property
    def span(self) -> int:
        """Reference span (M+D) — the 'length' used for bins, coverage and
        nscore (Sam/Alignment.pm soft-clip branch :393-431)."""
        if self._span is None:
            self._span = ref_span(self.ops, self.lens)
        return self._span


@dataclass
class AlnSet:
    """Alignments of one long read."""

    ref_id: str
    ref_len: int
    alns: List[Alignment] = field(default_factory=list)
