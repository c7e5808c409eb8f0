"""The iterative correction pipeline on the card (port of the device-engine
branch of ``proovread_tpu/pipeline/driver.py``).

``Pipeline.run(long_records, short_records)`` runs, per length bucket: the
stubby filter and bucketing, pass 1 eagerly (its candidate count sizes the
later passes' candidate cap), passes 2..N with the on-device mask shortcut,
the strict finish pass against the unmasked reads with chimera detection,
and finally ``trim_records``.

Supported: ``engine="device"``, ``mode="sr"`` and ``mode="mr"`` (the mr
task schedule: ``BWA_MR_1`` for pass 1, ``BWA_MR`` for passes 2..N,
``BWA_MR_FINISH`` for the finish), one device, flex off and the
short-read set resident, at any coverage (past ``2*max_coverage+2 > 256``
votes per lane the passes take the f32 packed-word pileup kernel). Every
other setting raises ``NotImplementedError`` naming it.

Observability (``obs``): every run fills ``PipelineResult.metrics`` (the
reference's KPI catalog, declared whole so a dump always has its schema),
and fills ``PipelineResult.qc`` while a QC recorder is installed, from
per-read reductions that run only then. Buckets and passes open spans
that a tracer records. The resilience ladder, checkpoint journal, fault
injection and serving are not ported: ``ladder=True`` changes nothing
when no fault occurs, and a device fault raises.
"""

from __future__ import annotations

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
from proovread_tpu_torch.pipeline.dcorrect import (DeviceCorrector,
                                                   _bucket_chunks,
                                                   detect_chimera_device,
                                                   device_assemble,
                                                   device_hcr_mask,
                                                   device_revcomp,
                                                   fused_iterations)
from proovread_tpu_torch.pipeline.masking import MaskParams
from proovread_tpu_torch.pipeline.sampling import CoverageSampler
from proovread_tpu_torch.pipeline.trim import TrimParams, trim_records

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
    still appear in the dump. The mesh, fault, journal, compile and retrace
    entries stay 0: the port has no mesh, ladder or journal yet, and
    compiles nothing mid-run."""
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


def _unsupported(cfg: PipelineConfig) -> Optional[str]:
    """Name of the first setting the port does not run, or None."""
    env_fault = os.environ.get("PROOVREAD_FAULT")
    checks = (
        (cfg.engine != "device", f"engine={cfg.engine!r}"),
        (cfg.mode not in ("sr", "mr"), f"mode={cfg.mode!r}"),
        ((cfg.mesh_shards or 0) > 1, f"mesh_shards={cfg.mesh_shards}"),
        (cfg.haplo_coverage is not None,
         f"haplo_coverage={cfg.haplo_coverage}"),
        (bool(cfg.checkpoint_dir), "checkpoint_dir"),
        (cfg.resume, "resume"),
        (bool(cfg.debug_dir), "debug_dir"),
        (cfg.bucket_timeout is not None, "bucket_timeout"),
        (cfg.fault_spec is not None or bool(env_fault),
         "fault injection (fault_spec / PROOVREAD_FAULT)"),
    )
    for bad, name in checks:
        if bad:
            return name
    ap_rest = _align_params_cfg(cfg, 2)
    if not all(_align_params_cfg(cfg, i) == ap_rest
               for i in range(2, cfg.n_iterations + 1)):
        return "align_schedule with per-iteration parameters"
    return None


class _SrDevice:
    """The resident short-read set (+ revcomp) with a zero-length pad row,
    so per-pass sampling keeps padded shapes (pad rows seed nothing)."""

    def __init__(self, sr_all: ReadBatch, dev: torch.device):
        m = sr_all.codes.shape[1]
        codes = np.concatenate([sr_all.codes, np.full((1, m), 4, np.int8)])
        qual = np.concatenate([sr_all.qual, np.zeros((1, m), np.uint8)])
        lengths = np.concatenate([sr_all.lengths, np.zeros(1, np.int32)])
        self.pad_idx = len(sr_all.lengths)
        self.codes = torch.as_tensor(codes, device=dev)
        self.qual = torch.as_tensor(qual, device=dev)
        self.lengths = torch.as_tensor(lengths, device=dev)
        self.rc = device_revcomp(self.codes, self.lengths)

    def take(self, sel: np.ndarray, pad_multiple: int = 512):
        n = len(sel)
        if n == self.pad_idx:
            return self.codes, self.rc, self.qual, self.lengths
        target = max(pad_multiple, -(-n // pad_multiple) * pad_multiple)
        idx = np.concatenate([sel.astype(np.int64),
                              np.full(target - n, self.pad_idx, np.int64)])
        i = torch.as_tensor(idx, device=self.codes.device)
        return self.codes[i], self.rc[i], self.qual[i], self.lengths[i]


class Pipeline:
    def __init__(self, config: Optional[PipelineConfig] = None):
        self.config = config or PipelineConfig()

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
        bad = _unsupported(self.config)
        if bad is not None:
            raise NotImplementedError(
                f"{bad} is not supported by the PyTorch port yet")
        with obs.metrics.scope() as reg:
            _declare_metrics(reg)
            with obs.span("pipeline", cat="task", mode=self.config.mode,
                          engine=self.config.engine):
                result = self._run(long_records, short_records)
            qc_rec = obs.qc.current()
            if qc_rec is not None:
                result.qc = qc_rec.aggregate()
                qc_rec.to_metrics(result.qc)
            result.metrics = reg.as_dict()
            return result

    def _run(self, long_records: Sequence[SeqRecord],
             short_records: Sequence[SeqRecord]) -> PipelineResult:
        cfg = self.config
        dev = resolve(cfg.device)
        sr_lens = np.array([len(r) for r in short_records])
        min_sr_len = int(np.median(sr_lens)) if len(sr_lens) else 100

        kept, ignored = self.read_long(long_records, min_sr_len)
        reports: List[TaskReport] = []
        if not kept:
            return PipelineResult([], [], ignored, [], reports)
        total_lr = sum(len(r) for r in kept)
        coverage = cfg.coverage
        if coverage is None:
            coverage = sum(len(r) for r in short_records) / max(total_lr, 1)
        sampler = CoverageSampler(chunk_number=cfg.sr_chunk_number,
                                  chunk_step=cfg.sr_chunk_step)
        # 16-row query padding keeps the bsw DP short (one step per row)
        sr_all = pack_reads(short_records, pad_multiple=16)
        sr_bytes = 3 * sr_all.codes.nbytes + sr_all.lengths.nbytes
        if sr_bytes > cfg.sr_device_budget:
            raise NotImplementedError(
                f"short-read set of {sr_bytes} bytes over sr_device_budget "
                f"({cfg.sr_device_budget}): the streaming regime is not "
                "ported yet")
        sr_dev = _SrDevice(sr_all, dev)
        qc_rec = obs.qc.current()

        results: List[ConsensusResult] = []
        all_chim: List[Tuple[str, int, int, float]] = []
        groups = _bucket_records(kept, cfg.batch_reads)
        obs.metrics.gauge("n_buckets", unit="buckets").set(len(groups))
        for gi, (pad, batch_recs) in enumerate(groups):
            Lp = bucket_lp(pad, cfg.length_slack)
            tb0 = time.monotonic()
            with obs.span("bucket", cat="bucket", bucket=gi, Lp=Lp,
                          reads=len(batch_recs),
                          bases=sum(len(r) for r in batch_recs)) as bsp:
                if qc_rec is not None:
                    qc_rec.start_bucket(gi, batch_recs, span_id=bsp.span_id)
                res_batch, chim = self._run_batch_device(
                    batch_recs, sr_dev, len(short_records), sampler,
                    coverage, min_sr_len, reports, Lp, dev, gi)
            _bucket_metrics(tb0, batch_recs)
            results.extend(res_batch)
            all_chim.extend(chim)
            log.info("bucket %d done (%d reads, Lp %d)", gi, len(batch_recs),
                     Lp)
        results.sort(key=lambda r: natural_key(r.record.id))
        untrimmed = [r.record for r in results]
        trimmed = trim_records(results, cfg.trim)
        return PipelineResult(untrimmed, trimmed, ignored, all_chim, reports)

    def _run_batch_device(self, batch_recs, sr_dev, n_short, sampler,
                          coverage, min_sr_len, reports, Lp, dev, gi=0):
        from proovread_tpu_torch.pipeline.dcorrect import (
            qc_finish_support, qc_pass_row_stats, qc_row_mask_counts)
        cfg = self.config
        B0 = len(batch_recs)
        rows = batch_rows(B0, cfg.batch_reads)
        pad_recs = [SeqRecord(f"_pad{i}", "A" * 8) for i in range(rows - B0)]
        lr = pack_reads(list(batch_recs) + pad_recs, pad_len=Lp)
        dc = DeviceCorrector(chunk=cfg.device_chunk)
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

        def shortcut():
            obs.metrics.counter("mask_shortcut_hits", unit="events").inc()

        cns = iteration_consensus_params(cfg, coverage)
        ap_rest = _align_params_cfg(cfg, 2)
        task = f"bwa-{cfg.mode[:2]}"

        # -- pass 1: eager; its candidate count sizes the later passes' cap
        with obs.span(f"{task}-1", cat="pass", bucket=gi):
            qc, rcq, qq, qlen = sr_dev.take(select(cfg.sr_coverage))
            call, stats = dc.correct_pass(
                codes, qual, lengths, None, qc, rcq, qq, qlen,
                _align_params_cfg(cfg, 1), cns, seed_stride=cfg.seed_stride)
            if qc_on:
                ed, up = qc_pass_row_stats(call, codes, qual, lengths)
            codes, qual, lengths = device_assemble(call, lengths, Lp)
            mask_cols, frac = device_hcr_mask(qual, lengths, mask_p(1))
            n_cand_seen = int(stats.n_candidates)
            new_frac = float(frac)
            n_adm, n_el = int(stats.n_admitted), int(stats.n_eligible)
            if qc_on:
                mrow, nlen, ed, up = (t.cpu().numpy() for t in (
                    qc_row_mask_counts(mask_cols), lengths, ed, up))
                qc_rec.record_pass(qc_ids, mrow[:B0], nlen[:B0])
                qc_rec.record_edits(qc_ids, ed[:B0], up[:B0])
            _record_report(reports, TaskReport(
                f"{task}-1", new_frac, n_cand_seen, n_adm,
                n_dropped_cov=max(0, n_el - n_adm)))
        gain = new_frac - masked_frac
        masked_frac = new_frac
        first_fused = 2
        if (masked_frac > cfg.mask_shortcut_frac
                or gain < cfg.mask_min_gain_frac):
            shortcut()
            first_fused = cfg.n_iterations + 1

        # -- passes 2..N -------------------------------------------------
        n_fused = cfg.n_iterations - first_fused + 1
        if n_fused > 0:
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
                    sr_dev.codes, sr_dev.rc, sr_dev.qual, sr_dev.lengths,
                    sels, pvs, m=sr_dev.codes.shape[1],
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
        # chimera detection
        with obs.span(f"{task}-finish", cat="pass", bucket=gi):
            ap = _align_params_cfg(cfg, None)
            cns = finish_consensus_params(cfg, coverage)
            qc, rcq, qq, qlen = sr_dev.take(select(cfg.finish_coverage))
            call, stats, aln = dc.correct_pass(
                codes, qual, lengths, None, qc, rcq, qq, qlen, ap, cns,
                seed_stride=cfg.seed_stride, collect_aln=True)
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
            frac_phred0 = (float(np.mean([o.masked_frac for o in out_res]))
                           if out_res else 0.0)
            fin_adm, fin_el = int(stats.n_admitted), int(stats.n_eligible)
            _record_report(reports, TaskReport(
                f"{task}-finish", 1.0 - frac_phred0, stats.n_candidates,
                fin_adm, n_dropped_cov=max(0, fin_el - fin_adm)))
        chim = [(o.record.id, f, t, s) for o in out_res
                for (f, t, s) in o.chimera]
        return out_res, chim


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
