"""Vectorized read simulators for benchmarks and scaled tests (numpy; a
copy of the subset of ``proovread_tpu/io/simulate.py`` the port's runs use).

Scaled workloads are simulated from a random genome with the error profiles
the reference's docs describe: CLR subreads at ~85% identity dominated by
insertions, Illumina short reads at ~0.5% substitutions. The same seeds give
the same records as the JAX package's simulators.
"""

from __future__ import annotations

from typing import List

import numpy as np

from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.ops.encode import decode_codes, revcomp_codes


def random_genome(size: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 4, size).astype(np.int8)


def _apply_errors(src: np.ndarray, rng, sub: float, ins: float, dele: float,
                  ) -> np.ndarray:
    """One concatenated code array -> error-mutated copy (codes)."""
    L = len(src)
    r = rng.random(L)
    counts = np.ones(L, np.int64)
    counts[r < dele] = 0                       # deletion: emit nothing
    is_ins = r >= 1.0 - ins                    # insertion(s) after the base
    # geometric-ish run lengths: mostly 1, occasionally 2
    counts[is_ins] += 1 + (rng.random(int(is_ins.sum())) < 0.15)
    out_idx = np.repeat(np.arange(L), counts)
    out = src[out_idx].copy()
    start = np.repeat(np.cumsum(counts) - counts, counts)
    pos_in_group = np.arange(len(out)) - start
    ins_pos = pos_in_group > 0
    out[ins_pos] = rng.integers(0, 4, int(ins_pos.sum()))
    subs = (rng.random(len(out)) < sub) & ~ins_pos
    out[subs] = (out[subs] + 1 + rng.integers(0, 3, int(subs.sum()))) % 4
    return out


def simulate_long_reads(
    genome: np.ndarray,
    total_bases: int,
    mean_len: int = 7000,
    min_len: int = 500,
    sub: float = 0.02,
    ins: float = 0.08,
    dele: float = 0.05,
    qual: int = 10,
    seed: int = 1,
    id_prefix: str = "lr",
    chimera_frac: float = 0.0,
    with_breakpoints: bool = False,
):
    """CLR-profile long reads totalling ~``total_bases``.

    Returns (records, truth) where truth[i] is the error-free source codes
    of record i (oriented as the read), for identity scoring.

    ``chimera_frac`` > 0 turns that fraction of reads into artificial
    chimeras (a second, independently-located segment spliced on — the
    library-prep artifact proovread's chimera detection hunts): the
    read's truth becomes the concatenation and the junction coordinate
    is recorded. All chimera draws come from a SEPARATE rng stream so
    the default (chimera_frac=0) output stays byte-identical to earlier
    rounds. ``with_breakpoints=True`` additionally returns the per-read
    truth-junction list: (records, truth, breakpoints)."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    lens, starts = [], []
    tot = 0
    while tot < total_bases:
        ln = int(np.clip(rng.lognormal(np.log(mean_len), 0.55), min_len,
                         G - 1))
        lens.append(ln)
        starts.append(int(rng.integers(0, G - ln)))
        tot += ln
    # build one concatenated source array, mutate once, then split
    srcs = [genome[s:s + ln] for s, ln in zip(starts, lens)]
    flat = np.concatenate(srcs)
    bounds = np.cumsum([0] + lens)
    rng_chim = np.random.default_rng(seed + 7919) if chimera_frac else None
    records, truth, breakpoints = [], [], []
    for i, (s, ln) in enumerate(zip(starts, lens)):
        src = flat[bounds[i]:bounds[i + 1]]
        mut = _apply_errors(src, rng, sub, ins, dele)
        if rng.random() < 0.5:
            mut = revcomp_codes(mut)
            src = revcomp_codes(src)
        bps: List[int] = []
        if rng_chim is not None and rng_chim.random() < chimera_frac:
            ln2 = int(np.clip(rng_chim.lognormal(np.log(mean_len), 0.55),
                              min_len, G - 1))
            s2 = int(rng_chim.integers(0, G - ln2))
            src2 = genome[s2:s2 + ln2]
            mut2 = _apply_errors(src2, rng_chim, sub, ins, dele)
            if rng_chim.random() < 0.5:
                mut2 = revcomp_codes(mut2)
                src2 = revcomp_codes(src2)
            bps = [len(mut)]               # junction, read coordinates
            mut = np.concatenate([mut, mut2])
            src = np.concatenate([src, src2])
        records.append(SeqRecord(
            f"{id_prefix}_{i}", decode_codes(mut),
            qual=np.full(len(mut), qual, np.uint8)))
        truth.append(src)
        breakpoints.append(bps)
    if with_breakpoints:
        return records, truth, breakpoints
    return records, truth


def simulate_short_reads(
    genome: np.ndarray,
    coverage: float,
    read_len: int = 100,
    sub: float = 0.005,
    qual: int = 30,
    seed: int = 2,
    id_prefix: str = "sr",
) -> List[SeqRecord]:
    """Illumina-profile short reads at ``coverage`` x of the genome."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    n = int(coverage * G / read_len)
    starts = rng.integers(0, G - read_len, n)
    idx = starts[:, None] + np.arange(read_len)[None, :]
    reads = genome[idx]
    mut = rng.random((n, read_len)) < sub
    reads[mut] = (reads[mut] + 1 + rng.integers(0, 3, int(mut.sum()))) % 4
    flip = rng.random(n) < 0.5
    reads[flip] = np.ascontiguousarray(reads[flip, ::-1])
    reads[flip] = np.where(reads[flip] < 4, 3 - reads[flip], reads[flip])
    q = np.full(read_len, qual, np.uint8)
    return [SeqRecord(f"{id_prefix}{i}", decode_codes(reads[i]), qual=q)
            for i in range(n)]

