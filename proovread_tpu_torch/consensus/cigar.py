"""CIGAR parsing: the part of ``proovread_tpu/consensus/cigar.py`` that the
alignment records need (op codes, ``parse_cigar``, ``ref_span``).

``expand_alignment`` and ``ColumnStates``, the host scan engine's column
expansion, come with that engine.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

# op codes
M, I, D, S, H = 0, 1, 2, 3, 4
_OP_CODE = {"M": M, "=": M, "X": M, "I": I, "D": D, "S": S, "H": H}
_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def parse_cigar(cigar: str) -> Tuple[np.ndarray, np.ndarray]:
    """CIGAR string -> (ops uint8, lens int32). '*' -> empty. N/P unsupported
    (the reference dies on them too: Sam/Seq.pm:348)."""
    if cigar == "*":
        return np.empty(0, np.uint8), np.empty(0, np.int32)
    ops, lens = [], []
    pos = 0
    for m in _CIGAR_RE.finditer(cigar):
        if m.start() != pos:
            raise ValueError(f"malformed CIGAR: {cigar!r}")
        pos = m.end()
        op = m.group(2)
        if op not in _OP_CODE:
            raise ValueError(f"unsupported CIGAR op {op!r} in {cigar!r}")
        ops.append(_OP_CODE[op])
        lens.append(int(m.group(1)))
    if pos != len(cigar):
        raise ValueError(f"malformed CIGAR: {cigar!r}")
    return np.array(ops, np.uint8), np.array(lens, np.int32)


def ref_span(ops: np.ndarray, lens: np.ndarray) -> int:
    """Reference bases consumed (M+D) — the aln 'length' the reference uses
    for bins/coverage (Sam/Alignment.pm:393-431, soft-clip branch)."""
    return int(lens[(ops == M) | (ops == D)].sum())
