"""Short-read subsampling to a target coverage — the tensor-level equivalent
of the SeqChunker striding the driver prepends to the mapper
(``bin/proovread:1292-1300``, params computed by ``cov2seqchunker``
``:2085-2102``): the read set is cut into ``chunk_number`` contiguous chunks;
every ``chunk_step`` chunks, ``chunks_per_step`` are taken, starting at a
``first_chunk`` that rotates between iterations so successive passes see
different read subsets."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CoverageSampler:
    chunk_number: int = 1000     # sr-chunk-number
    chunk_step: int = 20         # sr-chunk-step
    first_chunk: int = 1         # rotating global (bin/proovread:546)

    def plan(self, coverage: float, target: float):
        """Returns chunks_per_step (0 = no sampling) and advances the
        rotation, mirroring cov2seqchunker exactly."""
        if coverage * 0.8 < target:
            return 0
        # clamp to 1: at very deep coverage int(+.5) rounds to 0, which would
        # silently select an empty read set
        cps = max(1, int(self.chunk_step * (target / coverage) + 0.5))
        first = self.first_chunk
        self.first_chunk += cps
        if self.first_chunk > self.chunk_step:
            self.first_chunk -= self.chunk_step
        return first, cps

    def select(self, n_reads: int, coverage: float, target: float) -> np.ndarray:
        """Index array of the sampled reads (sorted). Full set when sampling
        is off."""
        p = self.plan(coverage, target)
        if p == 0:
            return np.arange(n_reads)
        first, cps = p
        chunk_of = (np.arange(n_reads) * self.chunk_number) // max(n_reads, 1)
        # chunks are 1-based in SeqChunker; chunk c is taken when
        # (c - first) mod chunk_step < chunks_per_step
        rel = (chunk_of + 1 - first) % self.chunk_step
        return np.flatnonzero(rel < cps)
