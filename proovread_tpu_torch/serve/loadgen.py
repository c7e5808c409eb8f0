"""Seeded adversarial traffic generator for the fleet load harness (port
of ``proovread_tpu/serve/loadgen.py``: the same seed gives the same
traffic, byte for byte).

``io/simulate.py:simulate_job_stream`` proves the serving path works on
friendly traffic: round-robin modes, exponential gaps, every payload
well-formed. A fleet serving many users has
to survive the traffic real multi-tenant services actually see, so this
module extends the stream along four adversarial axes — all seeded, so
the load smoke (``obs/load.py``) and the fault drills replay byte-identical traffic:

* **Many tenants** (``n_tenants``) with skewed popularity: tenant draws
  follow a Zipf-ish weighting, so one hot tenant hammers its quota while
  the tail stays sparse — per-tenant admission isolation is only
  testable when tenants are NOT uniform.
* **Heavy-tailed (Pareto) job sizes**: reads-per-job is ``1 +
  floor(Pareto(alpha))`` capped at ``max_reads_per_job`` — most jobs are
  small, the occasional whale fills a wave on its own, which is what
  exercises the length-class latency SLO and quota-bases backpressure.
* **Poisson + burst arrivals**: gaps are exponential with mean
  ``mean_gap_s``; every ``burst_every``-th job opens a burst of
  ``burst_len`` jobs whose gaps shrink by ``burst_factor`` — the
  overload probe that must produce bounded admission rejections, not
  collapse.
* **Malformed/poison jobs** (``malformed_frac``): a rotating set of
  broken submissions (unknown mode, empty reads, duplicate job id, an
  unparseable payload) each mapping to ONE expected reason in the
  closed ``REJECT_REASONS`` vocabulary — the harness asserts they are
  rejected-with-reason, never crash a replica, and never enter the
  accounting identity as accepted jobs.

Traffic families double as scenario axes:
``clr`` / ``ccs`` / ``unitig`` reuse the simulate_job_stream profiles;
``ont`` is the new nanopore family (``simulate_ont_reads`` error
engine: indel-dominated + homopolymer compression) riding the same sr
correction mode. Every scorable family carries per-read truth codes on
the job (``LoadJob.truth``) and can be exported as FASTQ + truth
sidecar (:func:`write_family_workload`) so both the fleet scoreboard
(``obs/load.py``) and standalone ``--truth`` CLI runs score it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.io.simulate import (_apply_errors, _ont_errors,
                                       random_genome, write_truth_sidecar)
from proovread_tpu_torch.ops.encode import decode_codes, revcomp_codes
from proovread_tpu_torch.serve.protocol import encode_records

# family -> serving mode (protocol MODES): the family is the error
# PROFILE, the mode is the correction PATH — ont reads are raw long
# reads and correct exactly like clr traffic (sr mode)
FAMILY_MODE = {"clr": "clr", "ccs": "ccs", "unitig": "unitig",
               "ont": "clr"}
# families whose corrected output ids match their submitted read ids,
# so per-read truth scoring is well-defined (ccs collapses subreads
# into per-ZMW consensus reads — different ids, scored elsewhere)
SCORED_FAMILIES = ("clr", "unitig", "ont")

POISON_KINDS = ("bad-mode", "empty-reads", "duplicate-job",
                "garbage-reads")
# poison kind -> the ONE closed-vocabulary reason the server must answer
# with (serve/admission.py REJECT_REASONS); asserted by the harness
POISON_REASON = {"bad-mode": "bad-request",
                 "empty-reads": "bad-request",
                 "duplicate-job": "duplicate-job",
                 "garbage-reads": "parse-error"}


@dataclass
class LoadJob:
    """One generated job. ``wire`` is the exact request object the
    dispatcher puts on the socket — for poison jobs it is deliberately
    broken and ``expect_reject`` names the reason the server must
    answer with; for well-formed jobs it is the standard submit op."""

    job_id: str
    tenant: str
    family: str                       # clr | ccs | unitig | ont | poison
    mode: str                         # serving mode on the wire
    arrival_s: float
    records: List[SeqRecord] = field(default_factory=list)
    truth: Dict[str, np.ndarray] = field(default_factory=dict)
    wire: Dict[str, Any] = field(default_factory=dict)
    expect_reject: Optional[str] = None
    deadline_s: Optional[float] = None
    burst: bool = False

    @property
    def n_bases(self) -> int:
        return sum(len(r) for r in self.records)


@dataclass
class LoadScenario:
    """A named, fully-seeded traffic mix: the ``scenario`` of a LOAD
    row (``obs/load.py``)."""

    name: str
    seed: int = 18
    n_jobs: int = 24
    n_tenants: int = 5
    genome_size: int = 3000
    families: Sequence[str] = ("clr", "ccs", "unitig", "ont")
    pareto_alpha: float = 1.3
    max_reads_per_job: int = 4
    mean_len: int = 480
    min_len: int = 320
    mean_gap_s: float = 0.02
    burst_every: int = 0              # 0 = no bursts
    burst_len: int = 0
    burst_factor: float = 8.0
    malformed_frac: float = 0.0
    deadline_s: Optional[float] = None


# the smoke's two scenarios: `slam` is the
# recorded headline mix — every family incl. ont, bursts, poison jobs —
# and `overload` is a tight-quota burst wall that must answer with
# bounded rejections rather than collapse
SCENARIOS = {
    "slam": LoadScenario(
        name="slam", seed=18, n_jobs=20, n_tenants=4,
        families=("clr", "ont", "ccs", "unitig", "ont"),
        burst_every=6, burst_len=3, malformed_frac=0.18),
    "overload": LoadScenario(
        name="overload", seed=19, n_jobs=16, n_tenants=2,
        families=("clr", "ont"), mean_gap_s=0.001,
        burst_every=4, burst_len=4, burst_factor=20.0),
}


def _job_records(fam: str, rng, genome: np.ndarray, job_id: str,
                 n_reads: int, mean_len: int, min_len: int, seed: int,
                 j: int) -> Tuple[List[SeqRecord], Dict[str, np.ndarray]]:
    """Generate one job's reads + per-read truth for ``fam`` (the
    simulate_job_stream per-mode profiles, plus the ont family)."""
    G = len(genome)
    records: List[SeqRecord] = []
    truth: Dict[str, np.ndarray] = {}
    for i in range(n_reads):
        ln = int(np.clip(rng.lognormal(np.log(mean_len), 0.3),
                         min_len, G - 1))
        a = int(rng.integers(0, G - ln))
        src = genome[a:a + ln]
        if fam == "ccs":
            hole = 100 + j * 16 + i
            n_sub = int(rng.integers(2, 4))
            pos = 0
            for _ in range(n_sub):
                mut = _apply_errors(src, rng, sub=0.02, ins=0.08,
                                    dele=0.05)
                records.append(SeqRecord(
                    f"m{seed}_{j:03d}/{hole}/{pos}_{pos + len(mut)}",
                    decode_codes(mut),
                    qual=np.full(len(mut), 10, np.uint8)))
                pos += len(mut) + 32
        elif fam == "unitig":
            mut = _apply_errors(src, rng, sub=0.003, ins=0.001,
                                dele=0.001)
            rid = f"{job_id}/utg{i}"
            records.append(SeqRecord(rid, decode_codes(mut),
                                     qual=np.full(len(mut), 28,
                                                  np.uint8)))
            truth[rid] = src
        elif fam == "ont":
            mut = _ont_errors(src, rng, sub=0.012, ins=0.025,
                              dele=0.045, hp_compress=0.2)
            tr = src
            if rng.random() < 0.5:
                mut = revcomp_codes(mut)
                tr = revcomp_codes(src)
            rid = f"{job_id}/ont{i}"
            records.append(SeqRecord(rid, decode_codes(mut),
                                     qual=np.full(len(mut), 12,
                                                  np.uint8)))
            truth[rid] = tr
        else:                                       # clr
            mut = _apply_errors(src, rng, sub=0.02, ins=0.08, dele=0.05)
            tr = src
            if rng.random() < 0.5:
                mut = revcomp_codes(mut)
                tr = revcomp_codes(src)
            rid = f"{job_id}/lr{i}"
            records.append(SeqRecord(rid, decode_codes(mut),
                                     qual=np.full(len(mut), 10,
                                                  np.uint8)))
            truth[rid] = tr
    return records, truth


def _poison(kind: str, job_id: str, tenant: str,
            victim: Optional["LoadJob"]) -> Dict[str, Any]:
    """The broken wire payload for one poison kind. ``duplicate-job``
    replays a previously-submitted job's id (the victim), which is the
    only poison that needs context."""
    if kind == "bad-mode":
        return {"op": "submit", "job_id": job_id, "tenant": tenant,
                "mode": "frankenstein",
                "reads": [{"id": "p0", "seq": "ACGT", "qual": None}]}
    if kind == "empty-reads":
        return {"op": "submit", "job_id": job_id, "tenant": tenant,
                "mode": "clr", "reads": []}
    if kind == "duplicate-job":
        dup = victim.job_id if victim is not None else job_id
        return {"op": "submit", "job_id": dup, "tenant": tenant,
                "mode": "clr",
                "reads": [{"id": f"{job_id}/d0", "seq": "ACGTACGT",
                           "qual": None}]}
    if kind == "garbage-reads":
        return {"op": "submit", "job_id": job_id, "tenant": tenant,
                "mode": "clr", "reads": [{"id": 7, "seq": ["not",
                                                           "a-str"]}]}
    raise ValueError(f"unknown poison kind {kind!r}")


def generate_traffic(scenario: LoadScenario,
                     genome: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, List[LoadJob]]:
    """The generator: ``(genome_codes, jobs)`` in arrival order, fully
    determined by the scenario (seed included). Families round-robin
    over ``scenario.families``; tenants draw from a Zipf-ish weighting;
    sizes are Pareto; arrivals are Poisson with burst windows; a
    ``malformed_frac`` slice of the stream is replaced by poison
    submissions cycling through :data:`POISON_KINDS`."""
    sc = scenario
    rng = np.random.default_rng(sc.seed)
    if genome is None:
        genome = random_genome(sc.genome_size, seed=sc.seed + 1)
    tenants = [f"t{t:02d}" for t in range(sc.n_tenants)]
    # Zipf-ish tenant popularity: weight 1/(rank+1), normalized
    w = np.array([1.0 / (t + 1) for t in range(sc.n_tenants)])
    w /= w.sum()

    jobs: List[LoadJob] = []
    well_formed: List[LoadJob] = []
    t = 0.0
    burst_left = 0
    n_poison = 0
    for j in range(sc.n_jobs):
        if sc.burst_every and j and j % sc.burst_every == 0:
            burst_left = sc.burst_len
        gap = float(rng.exponential(sc.mean_gap_s))
        if burst_left > 0:
            gap /= sc.burst_factor
            burst_left -= 1
        t += gap
        tenant = tenants[int(rng.choice(sc.n_tenants, p=w))]
        job_id = f"{sc.name}-{sc.seed}-{j:03d}"
        poison = (sc.malformed_frac > 0.0
                  and rng.random() < sc.malformed_frac
                  and well_formed)              # need a dup victim first
        if poison:
            kind = POISON_KINDS[n_poison % len(POISON_KINDS)]
            n_poison += 1
            victim = well_formed[int(rng.integers(len(well_formed)))]
            job = LoadJob(
                job_id=job_id, tenant=tenant, family="poison",
                mode="clr", arrival_s=round(t, 6),
                wire=_poison(kind, job_id, tenant, victim),
                expect_reject=POISON_REASON[kind],
                burst=burst_left > 0)
            jobs.append(job)
            continue
        fam = sc.families[j % len(sc.families)]
        n_reads = 1 + int(rng.pareto(sc.pareto_alpha))
        n_reads = min(n_reads, sc.max_reads_per_job)
        records, truth = _job_records(
            fam, rng, genome, job_id, n_reads, sc.mean_len, sc.min_len,
            sc.seed, j)
        job = LoadJob(
            job_id=job_id, tenant=tenant, family=fam,
            mode=FAMILY_MODE[fam], arrival_s=round(t, 6),
            records=records, truth=truth,
            wire={"op": "submit", "job_id": job_id, "tenant": tenant,
                  "mode": FAMILY_MODE[fam],
                  "reads": encode_records(records),
                  **({"deadline_s": sc.deadline_s}
                     if sc.deadline_s is not None else {})},
            deadline_s=sc.deadline_s, burst=burst_left > 0)
        jobs.append(job)
        well_formed.append(job)
    return genome, jobs


def family_truth(jobs: Sequence[LoadJob]
                 ) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-family id->truth maps over the scorable families present in
    ``jobs`` (the scoreboard's accuracy input)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for job in jobs:
        if job.family in SCORED_FAMILIES and job.truth:
            out.setdefault(job.family, {}).update(job.truth)
    return out


def write_family_workload(jobs: Sequence[LoadJob], out_dir: str
                          ) -> Dict[str, Tuple[str, str]]:
    """Export each scorable family as ``<fam>.fq`` + ``<fam>.truth.jsonl``
    (``write_truth_sidecar`` schema) so the SAME traffic is scorable by
    a standalone ``--truth`` CLI run — the loadgen doubles as a workload
    opener, not just a serving fuzzer. Returns family -> (fastq_path,
    sidecar_path)."""
    import os

    from proovread_tpu_torch.io.fastq import FastqWriter
    out: Dict[str, Tuple[str, str]] = {}
    for fam, truth in sorted(family_truth(jobs).items()):
        recs = [r for job in jobs if job.family == fam
                for r in job.records]
        fq = os.path.join(out_dir, f"{fam}.fq")
        sc = os.path.join(out_dir, f"{fam}.truth.jsonl")
        with FastqWriter(fq) as w:
            for r in recs:
                w.write(r)
        write_truth_sidecar(sc, [r.id for r in recs],
                            [truth[r.id] for r in recs])
        out[fam] = (fq, sc)
    return out
