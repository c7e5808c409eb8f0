"""Base encoding shared by host packing and device kernels.

Code space: A=0 C=1 G=2 T=3 N=4, plus GAP=5 as a pileup state. Fixed small
state alphabet is what lets the consensus state matrix (reference
``lib/Sam/Seq.pm:232-467``, a Perl hash-of-hashes over dynamic states) become
a dense [L, S] tensor the TPU can scatter-add into.
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N, GAP = 0, 1, 2, 3, 4, 5
N_BASES = 5          # A C G T N
N_STATES = 6         # + gap ('-' deletion state)

# host lookup: ascii byte -> code; everything unrecognized -> N
_LUT = np.full(256, N, dtype=np.int8)
for i, chars in enumerate(["Aa", "Cc", "Gg", "Tt"]):
    for ch in chars:
        _LUT[ord(ch)] = i
_LUT[ord("U")] = T
_LUT[ord("u")] = T

_DECODE = np.frombuffer(b"ACGTN-", dtype=np.uint8)

# complement in code space: A<->T, C<->G, N->N, GAP->GAP
_COMP = np.array([T, G, C, A, N, GAP], dtype=np.int8)


def encode_ascii(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> int8 codes (host, vectorized)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_codes(codes: np.ndarray) -> str:
    codes = np.asarray(codes)
    return _DECODE[codes].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space (works for numpy; for jax arrays use
    ``jnp.flip(jnp.take(COMP, codes))`` with :data:`COMP_TABLE`)."""
    return _COMP[np.asarray(codes)][::-1]


COMP_TABLE = _COMP.copy()
