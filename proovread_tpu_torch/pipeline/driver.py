"""The iterative correction pipeline (port of
``proovread_tpu/pipeline/driver.py``).

``Pipeline.run(long_records, short_records)`` runs, per bucket of long
reads, the correction passes, the strict finish pass against the unmasked
reads with chimera detection, and finally ``trim_records``. Two engines:

- ``engine="device"`` (the default): the stubby filter and length buckets;
  pass 1 eagerly (its candidate count sizes the later passes' candidate
  cap); passes 2..N in ``fused_iterations`` with the on-device mask
  shortcut, or eagerly a pass at a time where a per-iteration
  ``align_schedule`` asks for it; the finish pass. Flex mode
  (``haplo_coverage``, the ``proovread-flex`` role) runs every pass
  eagerly, twice: uncapped for the read's own-haplotype coverage estimate
  (``dcorrect.estimate_haplo_coverage``), then with each read's admission
  budget cut to the running minimum of the estimates (and to
  ``haplo_coverage`` itself when it is positive); the finish refreshes the
  estimate the same way. Every bucket runs under
  the resilience ladder (``pipeline/resilience.py``): a device fault
  retries it at the next-cheaper rung, ``fused`` -> ``eager`` ->
  ``chunk-halved`` -> ``host-scan``, each demotion reported.
- ``engine="scan"`` (and any engine but ``"device"``, as the
  reference's): buckets of ``batch_reads`` reads in input order, each
  pass a ``FastCorrector.correct_batch`` (``pipeline/correct.py``): host
  seeding and admission, Smith-Waterman on the device, torch votes. It is
  also the ladder's last rung.

With ``checkpoint_dir`` set, each finished bucket is written to the
checkpoint journal, and ``resume`` replays the buckets it holds. Fault
injection (``fault_spec`` or ``PROOVREAD_FAULT``, ``testing/faults.py``)
fires at the device engine's bucket entry, each pass and the fused span.

Every mode runs by its prefix, as the reference's: a mode that starts
with ``sr`` takes the sr task schedule, any other the mr schedule
(``BWA_MR_1`` for pass 1, ``BWA_MR`` for passes 2..N, ``BWA_MR_FINISH`` for
the finish), and the span and task names carry ``mode[:2]``. Every engine
but ``"device"`` runs as the scan engine. Flex on or off, one device or a
mesh, at any coverage (past ``2*max_coverage+2 > 256`` votes per lane the
passes take the f32 packed-word pileup kernel). The short-read set is
resident on the device within ``sr_device_budget`` and streamed above it
(``_SrDevice``: a host slice and one slab upload a pass, passes 2..N
eager), with the same bits. ``debug_dir`` writes each bucket's admitted
finish alignments as SAM (``dcorrect.dump_admitted_sam``).

A mesh (``mesh_shards`` >= 2, ``parallel/dmesh.py``) runs where this
process is a rank of a ``torch.distributed`` group (``parallel/launch.py``
or ``torchrun``): every rank runs the same ``run`` on the same inputs, and
each bucket's passes 1..N run sharded over the ranks under the ladder's
mesh rungs, the finish on every rank over the gathered bucket. Only rank 0
writes (the journal, ``debug_dir``); without a group the mesh clamps to
one device with a warning.

Serving (``serve/``) drives two hooks, both ``None`` on the batch path:
``_bucket_gate(gi, n_groups, records) -> records`` runs before each
bucket's key and ``Lp`` are derived, may drop reads (a cancelled job's, a
breached deadline's), return ``[]`` to skip the bucket or raise to stop the
run at a bucket boundary (a drain); ``_bucket_done(gi, results, chimeras,
replayed)`` runs after each bucket, so a job whose reads are all corrected
completes while later buckets compute. ``prepare_short_reads`` packs (and,
for the device engine, puts on the device) one short-read set once for
many runs over the same list object.

Observability (``obs``): every run fills ``PipelineResult.metrics`` (the
reference's KPI catalog, declared whole so a dump always has its schema),
and fills ``PipelineResult.qc`` while a QC recorder is installed, from
per-read reductions that run only then. Buckets, ladder attempts and
passes open spans that a tracer records.
"""

from __future__ import annotations

import gc
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from proovread_tpu_torch import obs
from proovread_tpu_torch.align.params import (AlignParams, BWA_MR,
                                              BWA_MR_1, BWA_MR_FINISH,
                                              BWA_SR, BWA_SR_FINISH)
from proovread_tpu_torch.consensus.engine import ConsensusResult
from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.device import resolve
from proovread_tpu_torch.io.batch import ReadBatch, pack_reads
from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.ops.assemble_kernel import mask_params_vec
from proovread_tpu_torch.ops.encode import decode_codes
from proovread_tpu_torch.parallel.dmesh import (build_sharded_step,
                                                clear_step_cache,
                                                make_dp_mesh, world)
from proovread_tpu_torch.parallel.plan import (balance_placement,
                                               moved_reads, shard_of_rows)
from proovread_tpu_torch.pipeline.dcorrect import (DeviceCorrector,
                                                   _bucket_chunks,
                                                   detect_chimera_device,
                                                   device_assemble,
                                                   device_hcr_mask,
                                                   device_revcomp,
                                                   dump_admitted_sam,
                                                   fused_iterations)
from proovread_tpu_torch.pipeline.correct import FastCorrector
from proovread_tpu_torch.pipeline.masking import MaskParams, mask_batch
from proovread_tpu_torch.pipeline.resilience import (LADDER,
                                                     CheckpointJournal,
                                                     bucket_key,
                                                     classify_fault,
                                                     classify_mesh_fault,
                                                     mesh_level,
                                                     run_fingerprint,
                                                     soft_deadline)
from proovread_tpu_torch.pipeline.sampling import CoverageSampler
from proovread_tpu_torch.pipeline.trim import TrimParams, trim_records
from proovread_tpu_torch.testing.faults import (FaultPlan, MeshCapExceeded,
                                                ShardStraggler)

log = logging.getLogger("proovread_tpu_torch")


def natural_key(s: str):
    """Digit runs compare numerically (``read_2`` before ``read_10``)."""
    import re
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", s)]


@dataclass
class PipelineConfig:
    """The reference's PipelineConfig fields, plus ``device``."""
    mode: str = "sr"
    n_iterations: int = 6
    sr_coverage: float = 15.0
    finish_coverage: float = 30.0
    coverage: Optional[float] = None
    mask_shortcut_frac: float = 0.92
    mask_min_gain_frac: float = 0.03
    hcr_mask: MaskParams = field(default_factory=MaskParams)
    hcr_mask_late: MaskParams = field(
        default_factory=lambda: MaskParams(end_ratio=0.3))
    lr_min_length: Optional[int] = None
    sampling: bool = True
    sr_chunk_number: int = 1000
    sr_chunk_step: int = 20
    sr_trim: bool = True
    align_schedule: Optional[Dict[str, AlignParams]] = None
    trim: TrimParams = field(default_factory=TrimParams)
    batch_reads: int = 256
    indel_taboo_length: int = 7
    coverage_scale: float = 0.75
    engine: str = "device"
    haplo_coverage: Optional[float] = None
    device_chunk: int = 8192
    host_chunk_rows: int = 4096
    seed_stride: int = 8
    length_slack: float = 0.2
    sr_device_budget: int = 2 << 30
    debug_dir: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    bucket_timeout: Optional[float] = None
    ladder: bool = True
    fault_spec: Optional[str] = None
    mesh_shards: Optional[int] = None
    mesh_chunks_per_shard: int = 2
    mesh_pass_timeout: Optional[float] = None
    device: str = "cuda"


@dataclass
class TaskReport:
    task: str
    masked_frac: float
    n_candidates: int
    n_admitted: int
    n_dropped_cap: int = 0
    n_dropped_cov: int = 0
    note: str = ""


@dataclass
class PipelineResult:
    untrimmed: List[SeqRecord]
    trimmed: List[SeqRecord]
    ignored: List[Tuple[str, str]]            # (read id, reason)
    chimera: List[Tuple[str, int, int, float]]
    reports: List[TaskReport] = field(default_factory=list)
    # the run's typed-metrics dump (obs.metrics schema); always filled
    metrics: Optional[Dict[str, Any]] = None
    # the aggregate QC report (obs/qc.py); filled while a QC recorder is
    # installed (CLI --qc-out / --truth)
    qc: Optional[Dict[str, Any]] = None
    # the compile ledger's census (obs/compilecache.py: entries called,
    # kernel-library build windows, hit rates); filled while a ledger is
    # installed (CLI --compile-ledger, serving)
    compile_census: Optional[Dict[str, Any]] = None


def _record_report(reports: List[TaskReport], rep: TaskReport) -> None:
    """Append a pass report and fold its KPIs into the metrics
    registry."""
    reports.append(rep)
    m = obs.metrics
    m.counter("task_runs", unit="passes").inc(1, task=rep.task)
    if rep.n_candidates:
        m.counter("candidates_total", unit="candidates").inc(
            rep.n_candidates)
    if rep.n_admitted:
        m.counter("admitted_total", unit="candidates").inc(rep.n_admitted)
    if rep.n_dropped_cap:
        m.counter("admission_dropped_cap", unit="candidates").inc(
            rep.n_dropped_cap)
    if rep.n_dropped_cov:
        m.counter("admission_dropped_cov", unit="candidates").inc(
            rep.n_dropped_cov)


def _bucket_metrics(tb0: float, batch_recs) -> None:
    """A bucket's wall time into the latency histogram, its reads and
    bases into the throughput counters."""
    obs.metrics.histogram("bucket_seconds", unit="s").observe(
        time.monotonic() - tb0)
    obs.metrics.counter("reads_processed", unit="reads").inc(
        len(batch_recs))
    obs.metrics.counter("bases_processed", unit="bases").inc(
        sum(len(r) for r in batch_recs))


def _declare_metrics(reg) -> None:
    """Declare the reference's whole KPI catalog, so zero-valued series
    still appear in the dump. The compile gauges are the compile
    ledger's census where one is installed; ``jax_retraces`` stays 0
    (nothing retraces)."""
    from proovread_tpu_torch.obs.qc import FUNNEL_KEYS
    c = reg.counter
    c("candidates_total", "candidates", "seed candidates probed by SW")
    c("admitted_total", "candidates", "alignments admitted to vote")
    c("admission_dropped_cap", "candidates",
      "candidates truncated by the fused loop's static chunk cap")
    c("admission_dropped_cov", "candidates",
      "threshold-passed candidates evicted by max-coverage admission")
    c("task_runs", "passes", "correction passes executed, by task")
    c("mask_shortcut_hits", "events",
      "mask shortcut firings (skip to finish)")
    c("resilience_demotions", "demotions",
      "degradation-ladder demotions, by destination rung")
    c("device_faults", "faults",
      "device faults absorbed by the ladder, by kind")
    c("checkpoint_journal_writes", "buckets",
      "buckets persisted to the checkpoint journal")
    c("checkpoint_journal_replays", "buckets",
      "buckets replayed from the checkpoint journal (--resume)")
    c("reads_processed", "reads", "long reads corrected")
    c("bases_processed", "bases", "long-read bases corrected")
    c("jax_retraces", "traces",
      "Python retraces of jitted pipeline functions")
    c("mesh_passes", "passes",
      "iteration passes executed through the sharded mesh step")
    c("mesh_faults", "faults",
      "mesh-rung faults, by kind and implicated shard")
    c("mesh_demotions", "demotions",
      "mesh-ladder demotions, by destination rung")
    reg.gauge("mesh_shards_configured", "shards",
              "dp shards the run was configured with")
    reg.gauge("mesh_shards_active", "shards",
              "dp shards alive after mesh-ladder exclusions")
    reg.gauge("mesh_rebalanced_reads", "reads",
              "reads moved between shards by the last rebalance")
    reg.histogram("bucket_seconds", "s", "wall time per length bucket")
    reg.gauge("compile_programs", "programs",
              "distinct (entry point, shape-signature) programs traced")
    reg.gauge("compile_backend_compiles", "compiles",
              "XLA backend-compile events (persistent-cache hits incl.)")
    reg.gauge("compile_backend_s", "s", "total backend-compile seconds")
    reg.gauge("compile_retraces", "traces",
              "tracing-cache misses across wrapped entry points")
    reg.gauge("cache_tracing_hit_rate", "frac",
              "wrapped-entry calls served by the in-process jit cache")
    reg.gauge("cache_persistent_hit_rate", "frac",
              "backend compiles served from the persistent XLA cache")
    for key in FUNNEL_KEYS:
        reg.gauge(f"qc_{key}", "", f"QC funnel: {key}")
    reg.gauge("qc_masked_frac_final_mean", "frac",
              "mean final HCR-masked fraction across reads")
    reg.gauge("qc_mean_support_mean", "x",
              "mean finish-pass support depth across reads")
    reg.gauge("accuracy_reads_scored", "reads",
              "reads scored against a ground-truth sidecar")
    reg.gauge("accuracy_identity_before_mean", "frac",
              "mean input-read identity vs truth (LCS/max-len)")
    reg.gauge("accuracy_identity_after_mean", "frac",
              "mean corrected-read identity vs truth (LCS/max-len)")
    reg.gauge("accuracy_errors_introduced_total", "errors",
              "sub+ins+del errors introduced by correction "
              "(classified sample)")


def batch_rows(n: int, batch_reads: int) -> int:
    """Device batch rows for ``n`` reads: a multiple of 32, at most
    ``batch_reads``."""
    return min(batch_reads, max(32, -(-n // 32) * 32))


def bucket_lp(pad: int, length_slack: float) -> int:
    """Padded bucket length: slack for consensus growth, then the
    {2^k, 3*2^(k-1)} ladder x 512."""
    want = int(pad * (1 + length_slack)) + 128
    return 512 * _bucket_chunks(max(1, -(-want // 512)))


def iteration_consensus_params(cfg: PipelineConfig,
                               coverage: float) -> ConsensusParams:
    max_cov = max(int(min(coverage, cfg.sr_coverage)
                      * cfg.coverage_scale + 0.5), 1)
    return ConsensusParams(
        qual_weighted=False, use_ref_qual=True,
        indel_taboo_length=cfg.indel_taboo_length,
        max_coverage=max_cov, trim=cfg.sr_trim)


def finish_consensus_params(cfg: PipelineConfig,
                            coverage: float) -> ConsensusParams:
    """Strict finish params, no ref-qual recycling."""
    return ConsensusParams(
        qual_weighted=False, use_ref_qual=False,
        indel_taboo_length=cfg.indel_taboo_length,
        max_coverage=max(int(min(coverage, cfg.finish_coverage)
                             * cfg.coverage_scale + 0.5), 1),
        trim=cfg.sr_trim)


def _align_params(mode: str, iteration: Optional[int]) -> AlignParams:
    """Built-in task schedule (cfg task-counter suffix semantics,
    bin/proovread:1989-2024): iteration None = finish."""
    if mode.startswith("sr"):
        return BWA_SR_FINISH if iteration is None else BWA_SR
    if iteration is None:
        return BWA_MR_FINISH
    return BWA_MR_1 if iteration == 1 else BWA_MR


def _align_params_cfg(cfg: PipelineConfig,
                      iteration: Optional[int]) -> AlignParams:
    """Task schedule (iteration None = finish), honoring
    ``cfg.align_schedule``."""
    s = cfg.align_schedule
    if s:
        if iteration is None:
            return s["finish"]
        k = str(iteration)
        if k in s:
            return s[k]
        return s["first"] if iteration == 1 else s["rest"]
    return _align_params(cfg.mode, iteration)


def _uniform_rest(cfg: PipelineConfig) -> bool:
    """Passes 2..N share one parameter set (else they run eagerly: the
    fused loop bakes in one)."""
    ap_rest = _align_params_cfg(cfg, 2)
    return all(_align_params_cfg(cfg, i) == ap_rest
               for i in range(2, cfg.n_iterations + 1))


class _SrDevice:
    """The short-read set (+ revcomp) with a zero-length pad row, so
    per-pass sampling keeps padded shapes (pad rows seed nothing).

    ``resident=True`` keeps the whole set on the device and samples with
    device row gathers. ``resident=False`` is the streaming regime for sets
    over ``sr_device_budget``: the set stays in host memory and each pass
    slices its sampled rows on the host and uploads that one slab, so the
    device holds O(slab), whatever the set's size. Both take the same rows
    (the pad row stays last), so the two regimes are bit-equal."""

    def __init__(self, sr_all: ReadBatch, dev: torch.device,
                 resident: bool = True):
        m = sr_all.codes.shape[1]
        self._codes_np = np.concatenate(
            [sr_all.codes, np.full((1, m), 4, np.int8)])
        self._qual_np = np.concatenate(
            [sr_all.qual, np.zeros((1, m), np.uint8)])
        self._lengths_np = np.concatenate(
            [sr_all.lengths, np.zeros(1, np.int32)])
        self.pad_idx = len(sr_all.lengths)
        self.resident = resident
        self.dev = dev
        # the set's bytes as the budget counts them
        self.set_bytes = 3 * sr_all.codes.nbytes + sr_all.lengths.nbytes
        # streaming caches: the uploaded full set (a full-set take would
        # upload the same bytes every pass) and the pad-row index tails
        self._full_cache = None
        self._pad_tails: Dict[int, np.ndarray] = {}
        # the largest slab a streaming pass uploaded (bytes counted as
        # the budget counts them)
        self.max_slab_bytes = 0
        if resident:
            self._full_cache = self._upload(self._codes_np, self._qual_np,
                                            self._lengths_np)

    @property
    def width(self) -> int:
        return self._codes_np.shape[1]

    def _upload(self, codes, qual, lengths):
        if not self.resident:
            self.max_slab_bytes = max(self.max_slab_bytes,
                                      3 * codes.nbytes + lengths.nbytes)
        c, q, ln = (torch.as_tensor(a, device=self.dev)
                    for a in (codes, qual, lengths))
        return c, device_revcomp(c, ln), q, ln

    def _pad_tail(self, n_pad: int) -> np.ndarray:
        t = self._pad_tails.get(n_pad)
        if t is None:
            t = self._pad_tails[n_pad] = np.full(n_pad, self.pad_idx,
                                                 np.int64)
        return t

    def full(self):
        """The whole set on the device (codes, revcomp, qual, lengths):
        resident, or uploaded once and cached when streaming."""
        if self._full_cache is None:
            self._full_cache = self._upload(self._codes_np, self._qual_np,
                                            self._lengths_np)
        return self._full_cache

    def stats(self) -> dict:
        """The regime of a run: resident or streamed, the set's bytes,
        whether the whole set went to the device, and the largest
        streamed slab's bytes."""
        return dict(resident=self.resident, set_bytes=self.set_bytes,
                    full_set_on_device=self._full_cache is not None,
                    max_slab_bytes=self.max_slab_bytes)

    def take(self, sel: np.ndarray, pad_multiple: int = 512):
        """Rows ``sel`` padded with the pad row to a multiple of
        ``pad_multiple``: a device gather when resident, a host slice and
        one slab upload when streaming."""
        n = len(sel)
        if n == self.pad_idx:
            return self.full()
        target = max(pad_multiple, -(-n // pad_multiple) * pad_multiple)
        idx = np.concatenate([sel.astype(np.int64, copy=False),
                              self._pad_tail(target - n)])
        if self.resident:
            i = torch.as_tensor(idx, device=self.dev)
            return tuple(t[i] for t in self._full_cache)
        return self._upload(self._codes_np[idx], self._qual_np[idx],
                            self._lengths_np[idx])


class Pipeline:
    def __init__(self, config: Optional[PipelineConfig] = None):
        self.config = config or PipelineConfig()
        self._faults: Optional[FaultPlan] = None   # set per run
        self._dcs: Dict[int, DeviceCorrector] = {}  # by device chunk
        self._sr_scan = None      # (short-read list, its scan packing)
        self._sr_prep = None      # (short-read list, its _SrDevice)
        self.sr_stats: Optional[dict] = None   # _SrDevice.stats() of a run
        # serving hooks (module docstring); None on the batch path
        self._bucket_gate = None
        self._bucket_done = None
        # this process's rank and world size (set per run), the mesh rungs'
        # gloo group (made at the first mesh attempt, dropped after a
        # failed one) and the groups dropped so (kept referenced: a group
        # with a collective still pending in gloo's threads must not be
        # destroyed mid-run)
        self._rank, self._world = 0, 1
        self._mesh_group = None
        self._retired_groups: list = []

    def prepare_short_reads(self, short_records: Sequence[SeqRecord]
                            ) -> None:
        """Pack, and for the device engine put on the device, the
        short-read set once for repeated ``run`` calls over the same list
        object (a server keeps one set on the card across waves). Cached
        by list identity; ``run`` packs per call for another list."""
        if self.config.engine == "device":
            dev = resolve(self.config.device)
            self._sr_prep = (short_records, self._make_sr_device(
                pack_reads(short_records, pad_multiple=16), dev))
        else:
            self._scan_sr_all(short_records)

    def read_long(self, records: Sequence[SeqRecord], min_sr_len: int
                  ) -> Tuple[List[SeqRecord], List[Tuple[str, str]]]:
        cfg = self.config
        stubby = (cfg.lr_min_length if cfg.lr_min_length is not None
                  else 2 * min_sr_len)
        kept, ignored = [], []
        seen = set()
        for r in records:
            if r.id in seen:
                raise ValueError(f"duplicate long-read id {r.id!r}")
            seen.add(r.id)
            if len(r) < stubby:
                ignored.append((r.id, "too short"))
                continue
            kept.append(r)
        kept.sort(key=lambda r: natural_key(r.id))
        return kept, ignored

    def run(self, long_records: Sequence[SeqRecord],
            short_records: Sequence[SeqRecord]) -> PipelineResult:
        """The run inside its metrics scope: the registry the CLI
        installed, or a fresh one, so ``result.metrics`` is always
        filled."""
        with obs.metrics.scope() as reg:
            _declare_metrics(reg)
            with obs.span("pipeline", cat="task", mode=self.config.mode,
                          engine=self.config.engine):
                result = self._run(long_records, short_records)
            qc_rec = obs.qc.current()
            if qc_rec is not None:
                result.qc = qc_rec.aggregate()
                qc_rec.to_metrics(result.qc)
            led = obs.compilecache.current()
            if led is not None:
                # the census and its compile_* / cache_* gauges
                result.compile_census = led.census()
                led.to_metrics(result.compile_census)
            result.metrics = reg.as_dict()
            return result

    def _run(self, long_records: Sequence[SeqRecord],
             short_records: Sequence[SeqRecord]) -> PipelineResult:
        cfg = self.config
        dev = resolve(cfg.device)
        self._rank, self._world = world()
        # per-bucket mesh placement of the previous attempt (rebalance
        # accounting), scoped to one run
        self._mesh_prev_shard: Dict[int, np.ndarray] = {}
        sr_lens = np.array([len(r) for r in short_records])
        min_sr_len = int(np.median(sr_lens)) if len(sr_lens) else 100

        kept, ignored = self.read_long(long_records, min_sr_len)
        if cfg.debug_dir:
            self._sr_ids = [r.id for r in short_records]
            self._sr_lens = np.asarray([len(r) for r in short_records])
        reports: List[TaskReport] = []
        if not kept:
            return PipelineResult([], [], ignored, [], reports)
        total_lr = sum(len(r) for r in kept)
        coverage = cfg.coverage
        if coverage is None:
            coverage = sum(len(r) for r in short_records) / max(total_lr, 1)
        sampler = CoverageSampler(chunk_number=cfg.sr_chunk_number,
                                  chunk_step=cfg.sr_chunk_step)

        # -- resilience setup (pipeline/resilience.py) --------------------
        self._faults = FaultPlan.from_spec(
            cfg.fault_spec if cfg.fault_spec is not None
            else os.environ.get("PROOVREAD_FAULT"))
        if self._faults.active:
            log.warning("fault injection active: %d rule(s)",
                        len(self._faults.rules))
        journal = None
        if cfg.checkpoint_dir:
            journal = self._open_journal(
                run_fingerprint(cfg, [r.id for r in kept],
                                len(short_records)))
            if cfg.resume:
                log.info("resume: checkpoint journal at %s holds %d "
                         "completed bucket(s)", cfg.checkpoint_dir,
                         len(journal.entries))
        qc_rec = obs.qc.current()

        def replay(key, gi, n_groups, span_id):
            """Journal hit: splice the bucket's stored results, reports
            and (QC on) per-read QC records back in, restore the sampler
            rotation, and report the replay. With QC on, an entry written
            without QC records is a miss: the bucket recomputes."""
            hit = (journal.get(key, require_qc=qc_rec is not None)
                   if journal is not None else None)
            if hit is None:
                return None
            res_batch, chim, rep_h, sampler_fc, qc_payload = hit
            if qc_rec is not None and qc_payload is not None:
                qc_rec.splice(qc_payload, span_id=span_id)
            reports.extend(rep_h)
            sampler.first_chunk = sampler_fc
            note = (f"bucket {gi} replayed from checkpoint journal "
                    f"({len(res_batch)} reads; journal hit "
                    f"{journal.hits}/{n_groups})")
            reports.append(TaskReport(f"resume-b{gi}", 0.0, 0, 0,
                                      note=note))
            log.info("resume: %s", note)
            return res_batch, chim

        def run_bucket(gi, batch_recs, n_groups, compute, **span_args):
            """One bucket: replayed from the journal, or computed and
            journaled. Returns (results, chimeras, replayed)."""
            key = bucket_key(batch_recs)
            tb0 = time.monotonic()
            # the compile ledger labels this bucket's rows
            obs.compilecache.set_bucket(gi)
            with obs.span("bucket", cat="bucket", bucket=gi,
                          reads=len(batch_recs),
                          bases=sum(len(r) for r in batch_recs),
                          **span_args) as bsp:
                hit = replay(key, gi, n_groups, bsp.span_id)
                if hit is not None:
                    bsp.set(replayed=True)
                    obs.compilecache.set_bucket(None)
                    return (*hit, True)
                if qc_rec is not None:
                    qc_rec.start_bucket(gi, batch_recs, span_id=bsp.span_id)
                n_rep0 = len(reports)
                res_batch, chim = compute()
                if journal is not None:
                    journal.put(
                        key, gi, res_batch, chim, reports[n_rep0:],
                        sampler.first_chunk,
                        qc_records=(qc_rec.bucket_payload(
                            [r.id for r in batch_recs])
                            if qc_rec is not None else None))
            obs.compilecache.set_bucket(None)
            # computed buckets only: a replay re-runs no admission
            _bucket_metrics(tb0, batch_recs)
            return res_batch, chim, False

        gate, done_cb = self._bucket_gate, self._bucket_done
        results: List[ConsensusResult] = []
        all_chim: List[Tuple[str, int, int, float]] = []
        if cfg.engine == "device":
            prep = self._sr_prep
            if (prep is not None and prep[0] is short_records
                    and prep[1].dev == dev):
                sr_dev = prep[1]        # prepare_short_reads' set
            else:
                # 16-row query padding keeps the bsw DP short (one step
                # per row)
                sr_dev = self._make_sr_device(
                    pack_reads(short_records, pad_multiple=16), dev)
            groups = _bucket_records(kept, cfg.batch_reads)
            obs.metrics.gauge("n_buckets", unit="buckets").set(len(groups))
            for gi, (pad, batch_recs) in enumerate(groups):
                if gate is not None:
                    # drop the gate's reads before the bucket's key and Lp
                    # derive from its content; it may raise to drain
                    batch_recs = gate(gi, len(groups), batch_recs)
                    if not batch_recs:
                        continue
                    pad = max(len(r) for r in batch_recs)
                Lp = bucket_lp(pad, cfg.length_slack)
                res_batch, chim, replayed = run_bucket(
                    gi, batch_recs, len(groups),
                    lambda: self._run_bucket_resilient(
                        gi, batch_recs, sr_dev, short_records, sampler,
                        coverage, min_sr_len, reports, Lp, dev), Lp=Lp)
                results.extend(res_batch)
                all_chim.extend(chim)
                if done_cb is not None:
                    done_cb(gi, res_batch, chim, replayed)
                log.info("bucket %d done (%d reads, Lp %d)", gi,
                         len(batch_recs), Lp)
            # restore read_long's natural output order across buckets
            results.sort(key=lambda r: natural_key(r.record.id))
            self.sr_stats = sr_dev.stats()
        else:
            sr_all = self._scan_sr_all(short_records)
            starts = list(range(0, len(kept), cfg.batch_reads))
            obs.metrics.gauge("n_buckets", unit="buckets").set(len(starts))
            for bi, start in enumerate(starts):
                batch_recs = kept[start:start + cfg.batch_reads]
                if gate is not None:
                    batch_recs = gate(bi, len(starts), batch_recs)
                    if not batch_recs:
                        continue
                res_batch, chim, replayed = run_bucket(
                    bi, batch_recs, len(starts),
                    lambda: self._run_batch(
                        batch_recs, sr_all, short_records, sampler,
                        coverage, min_sr_len, reports, dev))
                results.extend(res_batch)
                all_chim.extend(chim)
                if done_cb is not None:
                    done_cb(bi, res_batch, chim, replayed)
        if journal is not None and cfg.resume:
            log.info("resume: %d journal hit(s); journal now holds %d "
                     "completed bucket(s)", journal.hits,
                     len(journal.entries))
        untrimmed = [r.record for r in results]
        trimmed = trim_records(results, cfg.trim)
        return PipelineResult(untrimmed, trimmed, ignored, all_chim, reports)

    def _open_journal(self, fingerprint: str) -> CheckpointJournal:
        """The checkpoint journal. In a group of ranks only rank 0 writes
        it; the others open it read-only once rank 0 has (a barrier), so
        they replay the same buckets and keep in step."""
        cfg = self.config

        def open_(writer):
            return CheckpointJournal(cfg.checkpoint_dir, fingerprint,
                                     resume=cfg.resume, writer=writer)
        if self._world == 1:
            return open_(True)
        import torch.distributed as dist
        journal = open_(True) if self._rank == 0 else None
        dist.barrier()
        return journal if journal is not None else open_(False)

    def _make_sr_device(self, sr_all: ReadBatch, dev) -> _SrDevice:
        """The short-read set on the device: resident within
        ``sr_device_budget``, streamed a slab a pass above it."""
        cfg = self.config
        sr_bytes = 3 * sr_all.codes.nbytes + sr_all.lengths.nbytes
        resident = sr_bytes <= cfg.sr_device_budget
        if not resident:
            log.info(
                "short-read set %.1f GB exceeds sr-device-budget "
                "%.1f GB: streaming slab regime (per-pass upload)",
                sr_bytes / 2**30, cfg.sr_device_budget / 2**30)
        return _SrDevice(sr_all, dev, resident=resident)

    def _get_dc(self, chunk: int) -> DeviceCorrector:
        """DeviceCorrector per chunk size (the chunk-halved rung needs its
        own)."""
        if chunk not in self._dcs:
            self._dcs[chunk] = DeviceCorrector(chunk=chunk)
        return self._dcs[chunk]

    def _level_chunk(self, level) -> int:
        """Device chunk at a ladder rung: the configured value at the top
        rungs, the divided chunk rounded to the 128-row floor below."""
        cfg = self.config
        if level.chunk_div == 1:
            return cfg.device_chunk
        return max(128, (cfg.device_chunk // level.chunk_div // 128) * 128)

    def _scan_sr_all(self, short_records) -> ReadBatch:
        """The short reads packed for the scan engine (the SW windows
        round to 128-lane multiples); built once per short-read list."""
        if self._sr_scan is None or self._sr_scan[0] is not short_records:
            self._sr_scan = (short_records,
                             pack_reads(short_records, pad_multiple=128))
        return self._sr_scan[1]

    def _mesh_shards_effective(self) -> int:
        """Configured mesh width, clamped to the ranks of this process's
        group (1 without one). Flex mode stays single-device: its per-pass
        haplo budget refresh cannot ride the sharded step."""
        cfg = self.config
        n = int(cfg.mesh_shards or 0)
        if n < 2:
            return 0
        if cfg.haplo_coverage is not None:
            log.warning("mesh: flex mode (haplo-coverage) runs "
                        "single-device; ignoring mesh_shards=%d", n)
            return 0
        if self._world < n:
            log.warning("mesh: only %d device(s) visible; clamping "
                        "mesh_shards %d -> %d", self._world, n, self._world)
            n = self._world
        return n if n >= 2 else 0

    def _retire_mesh_group(self) -> None:
        """After a failed mesh attempt (on every rank: its faults fire on
        every rank, and a real one makes the others' collectives time
        out) no later attempt reuses its group; the next makes a new one."""
        if self._mesh_group is not None:
            self._retired_groups.append(self._mesh_group)
            self._mesh_group = None
            clear_step_cache()

    def _run_bucket_resilient(self, gi, batch_recs, sr_dev, short_records,
                              sampler, coverage, min_sr_len, reports, Lp,
                              dev):
        """One length bucket under the fault boundary: on a device fault
        (``resilience.classify_fault``), retry the bucket at the
        next-cheaper ladder rung, recording the demotion in the report
        stream and the counters. Other exceptions propagate. Each attempt
        restarts the bucket from its records with the sampler rotation,
        the KPI counters and the QC records rewound, so a retried bucket
        equals a fresh run at that rung.

        With a mesh (``cfg.mesh_shards``), the mesh rung tops the walk:
        ``mesh-dpN`` -> on an attributable ``device_lost`` or
        ``straggler``, the same rung re-entered at ``mesh-dp(N-1)`` with
        the failed shard excluded and its reads rebalanced onto the
        survivors, while at least 2 shards survive; every other mesh fault
        (``shard_oom``, ``collective_timeout``, a cap overflow, a straggler
        no shard can be blamed for) retreats to the single-device rungs."""
        cfg = self.config
        levels = list(LADDER) if cfg.ladder else [LADDER[0]]
        if cfg.ladder:
            # drop rungs that would re-run an identical regime: with a
            # per-iteration schedule or in flex mode the top rung already
            # runs the eager loop; at device_chunk 128 the halved chunk
            # clamps back to it
            if (not _uniform_rest(cfg) or cfg.haplo_coverage is not None
                    or not sr_dev.resident):
                levels = [lv for lv in levels if lv.name != "fused"]
            levels = [lv for lv in levels
                      if (lv.host or lv.chunk_div == 1
                          or self._level_chunk(lv) != cfg.device_chunk)]
        mesh_n = self._mesh_shards_effective()
        if mesh_n >= 2:
            # the mesh rung tops the walk; with the ladder off it IS the
            # walk (fail fast on the first mesh fault, like every rung)
            levels = ([mesh_level(mesh_n)] + levels if cfg.ladder
                      else [mesh_level(mesh_n)])
        # ORIGINAL shard ordinals the mesh ladder has excluded for this
        # bucket; the shrunken rung's ranks are derived from it
        mesh_failed: List[int] = []
        reg = obs.metrics.current()
        qc_rec = obs.qc.current()
        qc_ids = [r.id for r in batch_recs] if qc_rec is not None else []
        li = 0
        while li < len(levels):
            level = levels[li]
            n_rep0 = len(reports)
            sampler_fc0 = sampler.first_chunk
            m_snap = reg.snapshot() if reg is not None else None
            qc_snap = (qc_rec.snapshot(qc_ids)
                       if qc_rec is not None else None)
            try:
                with obs.span("attempt", cat="attempt", rung=level.name,
                              bucket=gi), \
                        soft_deadline(cfg.bucket_timeout,
                                      what=f"bucket {gi}"):
                    if level.host:
                        return self._run_batch(
                            batch_recs, self._scan_sr_all(short_records),
                            short_records, sampler, coverage, min_sr_len,
                            reports, dev)
                    return self._run_batch_device(
                        batch_recs, sr_dev, len(short_records), sampler,
                        coverage, min_sr_len, reports, Lp, dev, gi=gi,
                        level=level, mesh_failed=mesh_failed,
                        mesh_n0=mesh_n)
            except Exception as e:                      # noqa: BLE001
                if level.mesh >= 2:
                    self._retire_mesh_group()
                mesh_kind = classify_mesh_fault(e)
                kind = mesh_kind[0] if mesh_kind else classify_fault(e)
                # an attributable chip loss or straggler with >= 2
                # survivors re-enters the mesh rung shrunken by the failed
                # shard; this consumes no rung, and it ends: each shrink
                # excludes one original shard for good
                shard = mesh_kind[1] if mesh_kind else None
                shrink = (cfg.ladder and level.mesh >= 2
                          and mesh_kind is not None
                          and mesh_kind[0] in ("device_lost", "straggler")
                          and shard is not None and 0 <= shard < mesh_n
                          and shard not in mesh_failed
                          and level.mesh - 1 >= 2)
                if kind is None or not cfg.ladder or (
                        li == len(levels) - 1 and not shrink):
                    raise
                head = (str(e).splitlines() or [""])[0][:160]
            # the failed attempt is over and its exception dropped: its
            # tensors are released before the next rung allocates
            if kind == "oom":
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            # drop its partial pass reports and rewind the sampler, the KPI
            # counters and the per-read QC trajectories
            del reports[n_rep0:]
            sampler.first_chunk = sampler_fc0
            if m_snap is not None:
                reg.restore(m_snap)
            if qc_rec is not None:
                qc_rec.restore(qc_ids, qc_snap)
            if shrink:
                mesh_failed.append(shard)
                nxt = levels[li] = mesh_level(level.mesh - 1)
            else:
                li += 1
                nxt = levels[li]
            obs.metrics.counter("device_faults", unit="faults").inc(
                1, kind=kind)
            obs.metrics.counter("resilience_demotions",
                                unit="demotions").inc(1, to_rung=nxt.name)
            if mesh_n >= 2 and (mesh_kind is not None or level.mesh >= 2):
                # shard-attributed mesh accounting (obs/validate.py
                # MESH_COUNTERS): which shard, which fault, where the
                # bucket landed
                obs.metrics.counter("mesh_faults", unit="faults").inc(
                    1, kind=kind,
                    shard=(str(shard) if shard is not None else "?"))
                obs.metrics.counter("mesh_demotions", unit="demotions").inc(
                    1, to_rung=nxt.name)
            at = (f"shard {shard} of rung '{level.name}'"
                  if shard is not None else f"rung '{level.name}'")
            note = (f"{kind} fault at {at}: demoted "
                    f"bucket {gi} to '{nxt.name}' — {head}")
            reports.append(TaskReport(f"demote-b{gi}", 0.0, 0, 0, note=note))
            log.warning("bucket %d: %s fault at %s — retrying at %r (%s)",
                        gi, kind, at, nxt.name, head)
        raise AssertionError("unreachable: ladder exhausted without raise")

    def _run_batch_device(self, batch_recs, sr_dev, n_short, sampler,
                          coverage, min_sr_len, reports, Lp, dev, gi=0,
                          level=None, mesh_failed=(), mesh_n0=0):
        """The device engine on one bucket at a ladder rung (``level``,
        default the top 'fused' one): pass 1 eager, passes 2..N fused or
        eager (all eager in flex mode), the finish pass. At a mesh rung
        (``level.mesh >= 2``) passes 1..N run sharded over the ``mesh_n0``
        original shards but the ``mesh_failed`` ones (``_mesh_passes``)."""
        from proovread_tpu_torch.pipeline.dcorrect import (
            qc_finish_support, qc_pass_row_stats, qc_row_mask_counts)
        cfg = self.config
        if level is None:
            level = LADDER[0]
        faults = self._faults
        if faults is not None and faults.active:
            faults.check(gi)                    # bucket-entry site
        B0 = len(batch_recs)
        rows = max(batch_rows(B0, cfg.batch_reads), B0)
        if level.mesh >= 2:
            # every shard carries rows/mesh reads; the 8-base pad
            # sentinels seed nothing, so they are near-zero placement load
            rows = -(-rows // level.mesh) * level.mesh
        pad_recs = [SeqRecord(f"_pad{i}", "A" * 8) for i in range(rows - B0)]
        lr = pack_reads(list(batch_recs) + pad_recs, pad_len=Lp)
        dc = self._get_dc(self._level_chunk(level))
        codes = torch.as_tensor(lr.codes, device=dev)
        qual = torch.as_tensor(lr.qual, device=dev)
        lengths = torch.as_tensor(lr.lengths, device=dev)
        masked_frac = -cfg.mask_min_gain_frac
        # correction QC (obs/qc.py): its per-read reductions run only while
        # a recorder is installed
        qc_rec = obs.qc.current()
        qc_on = qc_rec is not None
        qc_ids = lr.ids[:B0]

        def mask_p(it):
            return (cfg.hcr_mask if it < 4
                    else cfg.hcr_mask_late).scaled(min_sr_len)

        def select(target):
            return (sampler.select(n_short, coverage, target)
                    if cfg.sampling else np.arange(n_short))

        def inj(pass_):
            # fault-injection site (testing/faults.py): device passes only
            if faults is not None and faults.active:
                faults.check(gi, pass_)

        def shortcut():
            obs.metrics.counter("mask_shortcut_hits", unit="events").inc()

        cns = iteration_consensus_params(cfg, coverage)
        task = f"bwa-{cfg.mode[:2]}"

        def eager_pass(it, codes, qual, lengths, mask_cols, budget_of=None,
                       sel=None, **span_args):
            """One iteration pass through ``correct_pass`` on the sample
            ``sel`` (drawn here when None), its report and QC rows. In flex
            mode (``budget_of``, from the pass's estimate to its admission
            budget) the pass runs twice on the same sample: uncapped for
            the estimate, whose consensus is dropped, then under the
            budget. Returns the new read state, masked fraction and the
            pass's candidate count."""
            with obs.span(f"{task}-{it}", cat="pass", bucket=gi,
                          **span_args):
                inj(it)
                qc, rcq, qq, qlen = sr_dev.take(
                    select(cfg.sr_coverage) if sel is None else sel)
                ap_i = _align_params_cfg(cfg, it)
                budget = None
                if budget_of is not None:
                    _, _, hpl = dc.correct_pass(
                        codes, qual, lengths, mask_cols, qc, rcq, qq, qlen,
                        ap_i, cns, seed_stride=cfg.seed_stride, haplo=True)
                    budget = budget_of(hpl)
                call, stats = dc.correct_pass(
                    codes, qual, lengths, mask_cols, qc, rcq, qq, qlen,
                    ap_i, cns, seed_stride=cfg.seed_stride, budget_r=budget)
                if qc_on:
                    ed, up = qc_pass_row_stats(call, codes, qual, lengths)
                codes, qual, lengths = device_assemble(call, lengths, Lp)
                mask_cols, frac = device_hcr_mask(qual, lengths, mask_p(it))
                new_frac = float(frac)
                n_adm, n_el = int(stats.n_admitted), int(stats.n_eligible)
                if qc_on:
                    mrow, nlen, ed, up = (t.cpu().numpy() for t in (
                        qc_row_mask_counts(mask_cols), lengths, ed, up))
                    qc_rec.record_pass(qc_ids, mrow[:B0], nlen[:B0])
                    qc_rec.record_edits(qc_ids, ed[:B0], up[:B0])
                _record_report(reports, TaskReport(
                    f"{task}-{it}", new_frac, int(stats.n_candidates), n_adm,
                    n_dropped_cov=max(0, n_el - n_adm)))
            return codes, qual, lengths, mask_cols, new_frac, \
                int(stats.n_candidates)

        def stop(new_frac, prev_frac):
            return (new_frac > cfg.mask_shortcut_frac
                    or new_frac - prev_frac < cfg.mask_min_gain_frac)

        flex_budget = None
        if level.mesh >= 2:
            codes, qual, lengths, masked_frac = self._mesh_passes(
                gi, lr, B0, codes, qual, lengths, dc, cns, sr_dev, select,
                inj, mask_p, reports, mesh_failed, mesh_n0)
            first_fused = cfg.n_iterations + 1       # no fused passes
        elif cfg.haplo_coverage is not None:
            # -- flex mode (proovread-flex): every pass eager, each pass's
            # estimate tightening its own admission budget, as a running
            # minimum over the passes (once masking hides the variant
            # columns the estimate degenerates to +inf, but the early one
            # still applies), under an explicit cutoff when one is given
            if cfg.haplo_coverage > 0:
                flex_budget = torch.full(
                    (codes.shape[0],), cfg.haplo_coverage * cns.bin_size,
                    dtype=torch.float32, device=dev)
            fixed = flex_budget

            def budget_of(hpl):
                nonlocal flex_budget
                new_b = hpl * cns.bin_size
                flex_budget = (new_b if flex_budget is None
                               else torch.minimum(flex_budget, new_b))
                if fixed is not None:
                    flex_budget = torch.minimum(flex_budget, fixed)
                return flex_budget

            mask_cols = None
            for it in range(1, cfg.n_iterations + 1):
                codes, qual, lengths, mask_cols, new_frac, _ = eager_pass(
                    it, codes, qual, lengths, mask_cols,
                    budget_of=budget_of, flex=True)
                done = stop(new_frac, masked_frac)
                masked_frac = new_frac
                if done:
                    shortcut()
                    break
            first_fused = cfg.n_iterations + 1       # no fused passes
        else:
            # -- pass 1: eager; its candidate count sizes the later
            # passes' cap
            codes, qual, lengths, mask_cols, new_frac, n_cand_seen = \
                eager_pass(1, codes, qual, lengths, None)
            first_fused = 2
            if stop(new_frac, masked_frac):
                shortcut()
                first_fused = cfg.n_iterations + 1
            masked_frac = new_frac

        # -- passes 2..N eagerly: a streaming short-read set (the fused
        # loop gathers from the resident set), a per-iteration schedule
        # (the fused loop bakes in one parameter set) and the ladder's
        # demoted rungs
        if ((not sr_dev.resident or not _uniform_rest(cfg)
             or not level.fused)
                and first_fused <= cfg.n_iterations):
            # a streamed set at the top of its walk stands in for the fused
            # loop, so it draws the fused loop's samples, every pass's up
            # front: the sampler's rotation after a shortcut, and with it
            # the finish's sample, is then the resident run's
            sels = None
            if (not sr_dev.resident and _uniform_rest(cfg)
                    and level.chunk_div == 1 and not level.host):
                sels = [select(cfg.sr_coverage)
                        for _ in range(first_fused, cfg.n_iterations + 1)]
            for k, it in enumerate(range(first_fused,
                                         cfg.n_iterations + 1)):
                codes, qual, lengths, mask_cols, new_frac, _ = eager_pass(
                    it, codes, qual, lengths, mask_cols,
                    sel=None if sels is None else sels[k], eager=True)
                done = stop(new_frac, masked_frac)
                masked_frac = new_frac
                if done:
                    shortcut()
                    break
            first_fused = cfg.n_iterations + 1

        # -- passes 2..N fused --------------------------------------------
        ap_rest = _align_params_cfg(cfg, 2)
        n_fused = cfg.n_iterations - first_fused + 1
        if n_fused > 0:
            # the fused loop covers its whole pass span, so a fault
            # addressed to any covered pass takes the whole span down
            if faults is not None and faults.active:
                faults.check_span(gi, first_fused, cfg.n_iterations)
            sels_l = [select(cfg.sr_coverage) for _ in range(n_fused)]
            full_set = all(len(s) == n_short for s in sels_l)
            Rsel = max(max(len(s) for s in sels_l), 512)
            Rsel = -(-Rsel // 512) * 512
            sels = None
            if not full_set:
                sels = np.full((n_fused, Rsel), sr_dev.pad_idx, np.int32)
                for k, s in enumerate(sels_l):
                    sels[k, :len(s)] = s[:Rsel]
            pvs = np.stack([mask_params_vec(mask_p(first_fused + k)).numpy()
                            for k in range(n_fused)])
            # candidate cap: pass 1's count with 1.5x slack, bounded by
            # ~2 candidates per sampled read
            cap = max(1, -(-2 * Rsel // dc.chunk))
            need = max(1, -(-int(n_cand_seen * 1.5) // dc.chunk))
            static_chunks = _bucket_chunks(min(cap, need))
            from proovread_tpu_torch.align.bsw import band_lanes
            with obs.span(f"{task}-fused", cat="pass", bucket=gi,
                          first=first_fused, last=cfg.n_iterations) as fsp:
                out = fused_iterations(
                    codes, qual, lengths, mask_cols, masked_frac,
                    *sr_dev.full(), sels, pvs, m=sr_dev.width,
                    W=band_lanes(ap_rest), CH=dc.chunk,
                    n_chunks=static_chunks, ap=ap_rest, cns=cns,
                    n_rest=n_fused, Lp=Lp, seed_stride=cfg.seed_stride,
                    seed_min_votes=2, shortcut_frac=cfg.mask_shortcut_frac,
                    min_gain=cfg.mask_min_gain_frac, collect_qc=qc_on)
                codes, qual, lengths = out.codes, out.qual, out.lengths
                if qc_on:
                    f_m, f_l, f_e, f_u = (t.cpu().numpy() for t in (
                        out.qc_masked, out.qc_lengths, out.qc_edits,
                        out.qc_uplift))
                    qc_rec.record_edits(qc_ids, f_e[:B0], f_u[:B0])
                fsp.set(passes_run=len(out.fracs))
            for k in range(len(out.fracs)):
                if qc_on:
                    qc_rec.record_pass(qc_ids, f_m[k][:B0], f_l[k][:B0])
                _record_report(reports, TaskReport(
                    f"{task}-{first_fused + k}", out.fracs[k],
                    out.ncands[k], out.nadms[k],
                    n_dropped_cap=out.ndrops[k],
                    n_dropped_cov=max(0, out.neligs[k] - out.nadms[k])))
            if out.shortcut:
                shortcut()

        # -- finish: strict params, unmasked reads, no ref-qual votes,
        # chimera detection; the injection harness addresses it as pass
        # n_iterations + 1
        with obs.span(f"{task}-finish", cat="pass", bucket=gi):
            inj(cfg.n_iterations + 1)
            ap = _align_params_cfg(cfg, None)
            cns = finish_consensus_params(cfg, coverage)
            fin_sel = select(cfg.finish_coverage)
            qc, rcq, qq, qlen = sr_dev.take(fin_sel)
            if cfg.haplo_coverage is not None:
                # the finish maps the unmasked reads, so its own estimate
                # holds again: refresh the running-minimum budget first
                _, _, hpl = dc.correct_pass(
                    codes, qual, lengths, None, qc, rcq, qq, qlen, ap, cns,
                    seed_stride=cfg.seed_stride, haplo=True)
                new_b = hpl * cns.bin_size
                flex_budget = (new_b if flex_budget is None
                               else torch.minimum(flex_budget, new_b))
            call, stats, aln = dc.correct_pass(
                codes, qual, lengths, None, qc, rcq, qq, qlen, ap, cns,
                seed_stride=cfg.seed_stride, collect_aln=True,
                budget_r=flex_budget)
            with obs.span("finish-fetch", cat="kernel"):
                new_codes, new_qual, new_len = device_assemble(call, lengths,
                                                               Lp)
                pos = torch.arange(Lp, device=dev)[None, :]
                ec = torch.where((pos < lengths[:, None]) & call.emitted,
                                 1 + call.ins_len, 0).to(torch.uint8)
                if qc_on:
                    # the finish pass's QC rows ride the same fetch
                    qf_ed, qf_up, qf_sup = (t.cpu().numpy() for t in (
                        *qc_pass_row_stats(call, codes, qual, lengths),
                        qc_finish_support(call, lengths)))
                codes_h, qual_h, nlen_h, ec_h, lens_h = (
                    t.cpu().numpy() for t in (new_codes, new_qual, new_len,
                                              ec, lengths))
            with obs.span("finish-assemble", cat="host"):
                empty = np.zeros(0, np.float32)
                out_res = []
                for i in range(B0):
                    nn = int(nlen_h[i])
                    rec = SeqRecord(id=lr.ids[i],
                                    seq=decode_codes(codes_h[i, :nn]),
                                    qual=qual_h[i, :nn].copy())
                    out_res.append(ConsensusResult(
                        record=rec, freqs=empty, coverage=empty, cigar="",
                        emit_counts=ec_h[i, :int(lens_h[i])]))
            with obs.span("finish-chimera", cat="host"):
                detect_chimera_device(out_res, lens_h, aln)
            if qc_on:
                # admitted alignments a read, from the chimera scan's host
                # scalars; support divided on the host
                adm_pr = np.bincount(
                    aln.lread[np.asarray(aln.admitted, bool)],
                    minlength=lr.codes.shape[0])
                qc_rec.record_edits(qc_ids, qf_ed[:B0], qf_up[:B0])
                qc_rec.record_finish(qc_ids, nlen_h[:B0], adm_pr[:B0],
                                     qf_sup[:B0], lens_h[:B0])
                for o in out_res:
                    if o.chimera:
                        qc_rec.record_chimera(o.record.id, o.chimera)
            if cfg.debug_dir and self._rank == 0:
                self._dump_finish(aln, lr.ids[:B0], lens_h[:B0], fin_sel)
            frac_phred0 = (float(np.mean([o.masked_frac for o in out_res]))
                           if out_res else 0.0)
            fin_adm, fin_el = int(stats.n_admitted), int(stats.n_eligible)
            _record_report(reports, TaskReport(
                f"{task}-finish", 1.0 - frac_phred0, stats.n_candidates,
                fin_adm, n_dropped_cov=max(0, fin_el - fin_adm)))
        chim = [(o.record.id, f, t, s) for o in out_res
                for (f, t, s) in o.chimera]
        return out_res, chim

    def _mesh_passes(self, gi, lr, B0, codes, qual, lengths, dc, cns, sr_dev,
                     select, inj, mask_p, reports, mesh_failed, mesh_n0):
        """Passes 1..N of one bucket through the sharded step
        (``parallel/dmesh.py``) over the alive shards: the reads placed
        candidate-balanced (``balance_placement``), this rank's shard
        corrected on its device, each pass's sums all-reduced. The fused
        loop never runs here: each pass is its own step, and its QC rows
        come back with its sums. Returns the whole bucket's state, gathered
        from the shards back into natural row order on every rank (the
        finish pass stays single-device), and the last masked fraction."""
        cfg = self.config
        faults = self._faults
        dev = codes.device
        qc_rec = obs.qc.current()
        alive = [s for s in range(mesh_n0) if s not in mesh_failed]
        if self._mesh_group is None:
            self._mesh_group = make_dp_mesh(ranks=alive).group
        mesh = make_dp_mesh(ranks=alive, group=self._mesh_group)
        # the state lives in placement order for the whole loop and is
        # un-permuted once at the end: per-read results are exact under
        # any placement, so it may change between attempts (that change IS
        # the rebalance)
        order = balance_placement(lr.lengths, len(alive))
        qc_sel = np.flatnonzero(order < B0)
        qc_row_ids = [lr.ids[int(order[j])] for j in qc_sel]
        # rows the single-device run would also carry (its base pads
        # included): only these enter the masked-fraction sums
        row_valid = order < max(batch_rows(B0, cfg.batch_reads), B0)
        cur_shard = shard_of_rows(order, len(alive))
        moved = moved_reads(self._mesh_prev_shard.get(gi), cur_shard, B0)
        self._mesh_prev_shard[gi] = cur_shard
        m = obs.metrics
        m.gauge("mesh_shards_configured", unit="shards").set(mesh_n0)
        m.gauge("mesh_shards_active", unit="shards").set(len(alive))
        m.gauge("mesh_rebalanced_reads", unit="reads").set(moved)
        log.info("mesh: bucket %d over %d shard(s)%s — %d read(s) "
                 "rebalanced", gi, len(alive),
                 f" (lost: {sorted(mesh_failed)})" if mesh_failed else "",
                 moved)
        S = len(order) // len(alive)
        k = mesh.shard
        mask_cols = None
        if k is None:
            codes = qual = lengths = None
        else:
            mine = torch.as_tensor(order[k * S:(k + 1) * S], device=dev)
            codes, qual, lengths = codes[mine], qual[mine], lengths[mine]
            mask_cols = torch.zeros(codes.shape, dtype=torch.bool,
                                    device=dev)
        masked_frac = -cfg.mask_min_gain_frac
        task = f"bwa-{cfg.mode[:2]}"
        # the samples of passes 2..N, drawn up front after pass 1 as the
        # single-device run's fused loop draws them (and with a uniform
        # schedule its other top rungs): the sampler's rotation after a
        # shortcut, and with it the finish's sample and the next buckets',
        # is then one device's
        sels = None
        for it in range(1, cfg.n_iterations + 1):
            if it == 2 and _uniform_rest(cfg):
                sels = [select(cfg.sr_coverage)
                        for _ in range(2, cfg.n_iterations + 1)]
            step = build_sharded_step(
                mesh, _align_params_cfg(cfg, it), cns,
                chunks_per_shard=cfg.mesh_chunks_per_shard, chunk=dc.chunk,
                seed_stride=cfg.seed_stride, collect_qc=qc_rec is not None)
            with obs.span(f"{task}-{it}", cat="pass", bucket=gi,
                          mesh=len(alive)):
                inj(it)
                if faults is not None and faults.active:
                    for s in alive:     # dropped shards never refire
                        faults.check_mesh(s, it)
                qcq, rcq, qq, qlen = sr_dev.take(
                    select(cfg.sr_coverage) if sels is None else sels[it - 2])
                pvec = mask_params_vec(mask_p(it))
                # the all-reduce parks every rank until the slowest shard
                # is done: the pass deadline turns a straggler into a
                # classified mesh fault instead of an unbounded wait
                with soft_deadline(cfg.mesh_pass_timeout,
                                   what=f"bucket {gi} pass {it} (mesh)",
                                   exc=ShardStraggler):
                    state, sums, stats = step(codes, qual, lengths,
                                              mask_cols, row_valid, order,
                                              qcq, rcq, qq, qlen, pvec)
                if state is not None:
                    codes, qual, lengths, mask_cols = state
                masked_i, total_i, n_adm, n_elig, n_cand, n_drop = (
                    int(v) for v in sums)
                if n_drop > 0:
                    # truncated output would depend on the mesh's shape:
                    # retreat to the single-device rung (dynamic chunks)
                    raise MeshCapExceeded(
                        f"sharded pass {it} would drop {n_drop} "
                        f"candidate(s) at the per-shard cap "
                        f"({cfg.mesh_chunks_per_shard} x {dc.chunk} rows) "
                        "— raise mesh_chunks_per_shard or device_chunk")
                if qc_rec is not None:
                    mrow, nlen, ed, up = stats
                    qc_rec.record_pass(qc_row_ids, mrow[qc_sel],
                                       nlen[qc_sel])
                    qc_rec.record_edits(qc_row_ids, ed[qc_sel], up[qc_sel])
                # the fraction divides the summed integers on the host, in
                # f32 like every rung: the shortcut is mesh-shape-invariant
                new_frac = float(np.float32(masked_i)
                                 / np.float32(max(total_i, 1)))
                gain = new_frac - masked_frac
                masked_frac = new_frac
                _record_report(reports, TaskReport(
                    f"{task}-{it}", masked_frac, n_cand, n_adm,
                    n_dropped_cov=max(0, n_elig - n_adm)))
                m.counter("mesh_passes", unit="passes").inc()
                log.info("%s-%d: masked %.1f%% (mesh:%d)", task, it,
                         masked_frac * 100, len(alive))
            if (masked_frac > cfg.mask_shortcut_frac
                    or gain < cfg.mask_min_gain_frac):
                m.counter("mask_shortcut_hits", unit="events").inc()
                break
        Lp = lr.codes.shape[1]
        like = [((S, Lp), torch.int8), ((S, Lp), torch.uint8),
                ((S,), torch.int32)]
        full = mesh.gather_shards(
            None if k is None else [t.cpu() for t in (codes, qual, lengths)],
            like)
        inv = torch.as_tensor(np.argsort(order))
        codes, qual, lengths = (t[inv].to(dev) for t in full)
        return codes, qual, lengths, masked_frac

    def _dump_finish(self, aln, lr_ids, lr_lens, sel) -> None:
        """``debug_dir``: the finish pass's admitted alignments of a bucket
        as ``admitted.<first read id>.sam``."""
        import re
        # PacBio ids hold '/': keep the dump name one path component
        tag = re.sub(r"[^A-Za-z0-9._-]", "_", lr_ids[0])[:80]
        path = os.path.join(self.config.debug_dir, f"admitted.{tag}.sam")
        nrec = dump_admitted_sam(aln, path, lr_ids, lr_lens, self._sr_ids,
                                 self._sr_lens, sel)
        log.info("debug: %d admitted finish alignments -> %s", nrec, path)

    def _run_batch(self, batch_recs, sr_all, short_records, sampler,
                   coverage, min_sr_len, reports, dev):
        """The scan engine on one bucket (``FastCorrector`` a pass, host
        HCR masking between passes), the ladder's host-scan rung. Its QC
        records are the device engine's, from the same integer counts."""
        cfg = self.config
        lr = pack_reads(batch_recs)
        B, L = lr.codes.shape
        qc_rec = obs.qc.current()
        qc_on = qc_rec is not None
        qc_ids = list(lr.ids)

        cur_codes = lr.codes.copy()
        cur_quals: List[np.ndarray] = [lr.qual[i] for i in range(B)]
        cur_lengths = lr.lengths.copy()
        cur_ids = list(lr.ids)
        mask_codes = None
        mcrs: Optional[List[List[Tuple[int, int]]]] = None
        # seeded so the min-gain shortcut never fires on iteration 1
        # (bin/proovread:2026-2047)
        masked_frac = -cfg.mask_min_gain_frac

        def select(target):
            return (sampler.select(len(short_records), coverage, target)
                    if cfg.sampling else np.arange(len(short_records)))

        def corrector(ap, cns):
            return FastCorrector(align_params=ap, cns_params=cns,
                                 chunk_rows=cfg.host_chunk_rows, device=dev)

        it = 1
        while it <= cfg.n_iterations:
            task = f"bwa-{cfg.mode[:2]}-{it}"
            with obs.span(task, cat="pass", engine="scan"):
                # the reference's scan engine takes the built-in schedule
                # for its iterations (and the configured one at the finish)
                fc = corrector(_align_params(cfg.mode, it),
                               iteration_consensus_params(cfg, coverage))
                sr = _take_batch(sr_all, select(cfg.sr_coverage))
                cur_batch = ReadBatch(ids=cur_ids, codes=cur_codes,
                                      qual=_stack_quals(cur_quals, L),
                                      lengths=cur_lengths)
                out, stats = fc.correct_batch(
                    cur_batch, sr, ignore_coords=mcrs,
                    mask_codes=mask_codes)
                # next iteration state: corrected reads (new coordinates)
                nb = pack_reads([o.record for o in out], pad_len=None)
                cur_codes, cur_lengths = nb.codes, nb.lengths
                cur_ids = list(nb.ids)
                cur_quals = [nb.qual[i] for i in range(nb.batch_size)]
                L = nb.pad_len
                mp = (cfg.hcr_mask if it < 4
                      else cfg.hcr_mask_late).scaled(min_sr_len)
                mask_codes, mcrs, new_frac = mask_batch(
                    cur_codes, cur_quals, cur_lengths, mp)
                if qc_on:
                    qc_rec.record_pass(
                        qc_ids, [sum(ln for (_off, ln) in mcrs[i])
                                 for i in range(B)], cur_lengths)
                    qc_rec.record_edits(qc_ids, stats.qc_rows["edits"],
                                        stats.qc_rows["uplift"])
                gain = new_frac - masked_frac
                masked_frac = new_frac
                _record_report(reports, TaskReport(
                    task, masked_frac, stats.n_candidates,
                    stats.n_admitted, n_dropped_cov=stats.n_dropped_cov))
            it += 1
            if it <= cfg.n_iterations and (
                    masked_frac > cfg.mask_shortcut_frac
                    or gain < cfg.mask_min_gain_frac):
                obs.metrics.counter("mask_shortcut_hits",
                                    unit="events").inc()
                break

        # finish: strict params, unmasked reads, no ref-qual votes, no MCR,
        # chimera detection (bin/proovread:1573-1579)
        with obs.span(f"bwa-{cfg.mode[:2]}-finish", cat="pass",
                      engine="scan"):
            fc = corrector(_align_params_cfg(cfg, None),
                           finish_consensus_params(cfg, coverage))
            sr = _take_batch(sr_all, select(cfg.finish_coverage))
            cur_batch = ReadBatch(ids=cur_ids, codes=cur_codes,
                                  qual=_stack_quals(cur_quals, L),
                                  lengths=cur_lengths)
            out, stats = fc.correct_batch(cur_batch, sr, detect_chimera=True)
            if qc_on:
                qr = stats.qc_rows
                qc_rec.record_edits(qc_ids, qr["edits"], qr["uplift"])
                qc_rec.record_finish(
                    qc_ids, [len(o.record) for o in out], qr["admitted"],
                    qr["support_sum"], cur_lengths)
                for o in out:
                    if o.chimera:
                        qc_rec.record_chimera(o.record.id, o.chimera)
            frac_phred0 = (float(np.mean([o.masked_frac for o in out]))
                           if out else 0.0)
            _record_report(reports, TaskReport(
                f"bwa-{cfg.mode[:2]}-finish", 1.0 - frac_phred0,
                stats.n_candidates, stats.n_admitted,
                n_dropped_cov=stats.n_dropped_cov))
        chim = [(o.record.id, f, t, s) for o in out for (f, t, s) in o.chimera]
        return out, chim


# batch-rows x padded-length budget of one device batch
CELL_BUDGET = 128 * 16384


def _bucket_records(kept, batch_size: int,
                    bounds=(512, 1024, 2048, 4096, 8192, 16384, 32768)):
    """[(group_max_len, records)] batches grouped by length bucket; groups
    smaller than a quarter batch merge into the next larger bucket, and
    rows are capped so rows x length stays within CELL_BUDGET."""
    import bisect
    groups: Dict[int, List[SeqRecord]] = {}
    for r in kept:
        i = bisect.bisect_left(bounds, len(r))
        pad = bounds[i] if i < len(bounds) else \
            -(-len(r) // bounds[-1]) * bounds[-1]
        groups.setdefault(pad, []).append(r)

    merged: List[List[SeqRecord]] = []
    pending: List[SeqRecord] = []
    for pad in sorted(groups):
        pending.extend(groups[pad])
        if len(pending) >= max(1, batch_size // 4):
            merged.append(pending)
            pending = []
    if pending:
        if merged and max(len(r) for r in pending) <= \
                2 * max(len(r) for r in merged[-1]):
            merged[-1].extend(pending)
        else:
            merged.append(pending)

    out = []
    for recs in merged:
        gmax = max(len(r) for r in recs)
        eff = max(8, min(batch_size, CELL_BUDGET // max(gmax, 1)))
        if len(recs) % eff and len(recs) % eff < min(8, len(recs)):
            eff = -(-len(recs) // (-(-len(recs) // eff)))
        for j in range(0, len(recs), eff):
            group = recs[j:j + eff]
            out.append((max(len(r) for r in group), group))
    return out


def _take_batch(batch: ReadBatch, idx: np.ndarray) -> ReadBatch:
    return ReadBatch(ids=[batch.ids[i] for i in idx], codes=batch.codes[idx],
                     qual=batch.qual[idx], lengths=batch.lengths[idx])


def _stack_quals(quals: List[np.ndarray], L: int) -> np.ndarray:
    out = np.zeros((len(quals), L), np.uint8)
    for i, q in enumerate(quals):
        out[i, :len(q)] = q[:L]
    return out
