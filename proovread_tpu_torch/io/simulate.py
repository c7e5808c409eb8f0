"""Vectorized read simulators for benchmarks and scaled tests (numpy; a
copy of ``proovread_tpu/io/simulate.py``, ``simulate_job_stream`` of the
serving layer included).

Scaled workloads are simulated from a random genome with the error profiles
the reference's docs describe: CLR subreads at ~85% identity dominated by
insertions, Illumina short reads at ~0.5% substitutions. The same seeds give
the same records as the JAX package's simulators.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

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


def _ont_errors(src: np.ndarray, rng, sub: float, ins: float,
                dele: float, hp_compress: float) -> np.ndarray:
    """ONT error engine: homopolymer-compression deletions first (each
    base equal to its predecessor is dropped with prob ``hp_compress`` —
    the nanopore dwell-time ambiguity that systematically shortens
    homopolymer runs), then the generic indel/sub engine on the
    compressed sequence. The caller's truth stays the UNcompressed
    source — the compression is an error to be corrected, not a feature
    of the molecule."""
    if hp_compress > 0.0 and len(src) > 1:
        same = np.zeros(len(src), bool)
        same[1:] = src[1:] == src[:-1]
        drop = same & (rng.random(len(src)) < hp_compress)
        src = src[~drop]
    return _apply_errors(src, rng, sub, ins, dele)


def simulate_ont_reads(
    genome: np.ndarray,
    total_bases: int,
    mean_len: int = 6000,
    min_len: int = 500,
    sub: float = 0.012,
    ins: float = 0.025,
    dele: float = 0.045,
    hp_compress: float = 0.2,
    qual: int = 12,
    seed: int = 5,
    id_prefix: str = "ont",
):
    """ONT-profile long reads totalling ~``total_bases``.

    Same contract as :func:`simulate_long_reads` — returns ``(records,
    truth)`` with truth[i] the error-free source codes oriented as the
    read, so ``write_truth_sidecar`` and standalone ``--truth`` runs
    work unchanged — but with the nanopore error profile instead of the
    CLR one: **indel-dominated** (deletions dominate every other class
    and indels together far outweigh substitutions — the R9/R10
    systematics) plus **homopolymer-compression** deletions
    on top (``hp_compress`` per repeated base; on a random genome ~25%
    of positions repeat their predecessor, so the default adds ~5%
    deletion load concentrated in runs)."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    records, truth = [], []
    tot = 0
    i = 0
    while tot < total_bases:
        ln = int(np.clip(rng.lognormal(np.log(mean_len), 0.55), min_len,
                         G - 1))
        a = int(rng.integers(0, G - ln))
        src = genome[a:a + ln]
        mut = _ont_errors(src, rng, sub, ins, dele, hp_compress)
        if rng.random() < 0.5:
            mut = revcomp_codes(mut)
            src = revcomp_codes(src)
        records.append(SeqRecord(
            f"{id_prefix}_{i}", decode_codes(mut),
            qual=np.full(len(mut), qual, np.uint8)))
        truth.append(src)
        tot += ln
        i += 1
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


# --------------------------------------------------------------------------
# mixed-traffic job stream (correction as a service, ``serve/``)
# --------------------------------------------------------------------------

@dataclass
class SimJob:
    """One simulated correction job for the serving layer: a tenant
    submits a small batch of long-read records of one traffic class
    (proovread task modes, PAPER.md):

    ``clr``     raw CLR subreads, ~85% identity, insertion-dominated
    ``ccs``     multi-subread ZMWs (PacBio subread ids) — the server's
                ccs pre-consensus path collapses them before correction
    ``unitig``  assembler unitigs: long, near-clean (mr-mode correction)
    """

    job_id: str
    tenant: str
    mode: str                        # clr | ccs | unitig
    arrival_s: float                 # offset from stream start
    records: List[SeqRecord] = field(default_factory=list)
    deadline_s: Optional[float] = None

    @property
    def n_bases(self) -> int:
        return sum(len(r) for r in self.records)


def simulate_job_stream(
    seed: int = 0,
    n_jobs: int = 9,
    genome: Optional[np.ndarray] = None,
    genome_size: int = 3000,
    modes: Sequence[str] = ("clr", "ccs", "unitig"),
    tenants: Sequence[str] = ("t-alice", "t-bob"),
    reads_per_job: Tuple[int, int] = (2, 4),
    mean_len: int = 700,
    min_len: int = 400,
    mean_gap_s: float = 0.02,
) -> Tuple[np.ndarray, List[SimJob]]:
    """Deterministic interleaved CLR + CCS + unitig job stream over ONE
    genome (so every job's reads correct against the same short-read set,
    the serving model). Returns ``(genome_codes, jobs)`` with jobs in
    arrival order; modes and tenants round-robin so traffic interleaves,
    arrival gaps are exponential with mean ``mean_gap_s``. Everything is
    keyed off ``seed`` — the fault drills and ``serve/smoke.py`` replay
    the exact same stream.

    Read ids are namespaced by job (``<job>/...``; CCS subread ids keep
    the PacBio grammar with a per-job movie name) so any subset of jobs
    can share one continuous-batching wave without id collisions."""
    rng = np.random.default_rng(seed)
    if genome is None:
        genome = random_genome(genome_size, seed=seed + 1)
    G = len(genome)
    jobs: List[SimJob] = []
    t = 0.0
    for j in range(n_jobs):
        mode = modes[j % len(modes)]
        tenant = tenants[j % len(tenants)]
        n_reads = int(rng.integers(reads_per_job[0],
                                   reads_per_job[1] + 1))
        job_id = f"job-{seed}-{j:03d}"
        records: List[SeqRecord] = []
        for i in range(n_reads):
            ln = int(np.clip(rng.lognormal(np.log(mean_len), 0.3),
                             min_len, G - 1))
            a = int(rng.integers(0, G - ln))
            src = genome[a:a + ln]
            if mode == "ccs":
                # one ZMW with 2-3 subreads over the same molecule,
                # independent CLR-profile errors; ids follow the PacBio
                # subread grammar (pipeline/ccs.py ZMW_RE)
                hole = 100 + j * 16 + i
                n_sub = int(rng.integers(2, 4))
                pos = 0
                for s in range(n_sub):
                    mut = _apply_errors(src, rng, sub=0.02, ins=0.08,
                                        dele=0.05)
                    records.append(SeqRecord(
                        f"m{seed}_{j:03d}/{hole}/{pos}_{pos + len(mut)}",
                        decode_codes(mut),
                        qual=np.full(len(mut), 10, np.uint8)))
                    pos += len(mut) + 32
            elif mode == "unitig":
                mut = _apply_errors(src, rng, sub=0.003, ins=0.001,
                                    dele=0.001)
                records.append(SeqRecord(
                    f"{job_id}/utg{i}", decode_codes(mut),
                    qual=np.full(len(mut), 28, np.uint8)))
            else:                                   # clr
                mut = _apply_errors(src, rng, sub=0.02, ins=0.08,
                                    dele=0.05)
                if rng.random() < 0.5:
                    mut = revcomp_codes(mut)
                records.append(SeqRecord(
                    f"{job_id}/lr{i}", decode_codes(mut),
                    qual=np.full(len(mut), 10, np.uint8)))
        jobs.append(SimJob(job_id=job_id, tenant=tenant, mode=mode,
                           arrival_s=round(t, 6), records=records))
        t += float(rng.exponential(mean_gap_s))
    return genome, jobs


def simulate_independent_segments(
    seed: int = 0,
    n_long: int = 12,
    read_len: int = 300,
    sr_per: int = 6,
    lr_err: float = 0.08,
    with_truth: bool = False,
):
    """Long + short reads where every long read owns its own genome
    segment, so no short read can seed against more than one long read.

    Under this workload family sharded execution is exact: a shard's
    local seed selection picks the candidates a global one would.

    ``with_truth=True`` additionally returns each long read's error-free
    source segment (oriented as the read): ``(longs, srs, truths)``, the
    accuracy scoreboard's ground truth."""
    rng = np.random.default_rng(seed)
    longs, srs, truths = [], [], []
    si = 0
    for i in range(n_long):
        genome = rng.integers(0, 4, read_len).astype(np.int8)
        truths.append(genome)
        noisy = []
        for base in genome:
            u = rng.random()
            if u < lr_err * 0.5:            # insertion before the base
                noisy.append(int(rng.integers(0, 4)))
                noisy.append(int(base))
            elif u < lr_err * 0.75:         # deletion
                continue
            elif u < lr_err:                # substitution
                noisy.append(int((base + 1) % 4))
            else:
                noisy.append(int(base))
        longs.append(SeqRecord(
            f"r{i}", decode_codes(np.array(noisy, np.int8))))
        for _ in range(sr_per):
            st = int(rng.integers(0, read_len - 100))
            sseq = genome[st:st + 100].copy()
            if rng.random() < 0.5:
                sseq = revcomp_codes(sseq)
            srs.append(SeqRecord(f"s{si}", decode_codes(sseq),
                                 qual=np.full(100, 30, np.uint8)))
            si += 1
    if with_truth:
        return longs, srs, truths
    return longs, srs


# --------------------------------------------------------------------------
# truth sidecar (the accuracy scoreboard's ground truth, obs/accuracy.py)
# --------------------------------------------------------------------------

def fantasticus_truth(longs, orig_fq_path: str):
    """id -> error-free source codes for the reference sample's
    ``long_error`` reads (`long_error_N_M` pairs with `long_orig_N` by
    the third id field)."""
    from proovread_tpu_torch.io import fastq
    from proovread_tpu_torch.ops.encode import encode_ascii
    origs = {r.id.split("_")[2]: encode_ascii(r.seq)
             for r in fastq.FastqReader(orig_fq_path)}
    truth = {}
    for rec in longs:
        key = (rec.id.split("_")[2]
               if rec.id.startswith("long_error_") else None)
        if key and key in origs:
            truth[rec.id] = origs[key]
    return truth


def write_truth_sidecar(path: str, records, truths,
                        breakpoints=None) -> None:
    """Emit the truth sidecar next to the simulated FASTQs: one JSONL
    meta line (``{"truth_schema": 1, "n_reads": N}``) then one record
    per read — id, the error-free source sequence oriented as the read,
    and the true chimera-junction coordinates (empty list when the read
    is not chimeric). This is what lets CLI *subprocess* runs be scored
    (``--truth``, ``obs/accuracy.py``) — the simulator's in-memory truth
    arrays survive the process boundary. The schema is the reference's
    (``proovread_tpu/obs/validate.py:TRUTH_RECORD_FIELDS``); ``records``
    may be SeqRecords or bare id strings."""
    import json
    rows = []
    for i, rec in enumerate(records):
        bps = list(breakpoints[i]) if breakpoints is not None else []
        rows.append({"id": str(getattr(rec, "id", rec)),
                     "seq": decode_codes(np.asarray(truths[i], np.int8)),
                     "breakpoints": [int(b) for b in bps]})
    with open(path, "w") as fh:
        fh.write(json.dumps({"truth_schema": 1,
                             "n_reads": len(rows)}) + "\n")
        for row in rows:
            fh.write(json.dumps(row) + "\n")
