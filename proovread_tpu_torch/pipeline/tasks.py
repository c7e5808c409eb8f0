"""Config-driven task orchestration — the role of ``bin/proovread``'s task
state machine (``:705-900``) above the device pipeline.

Port of ``proovread_tpu/pipeline/tasks.py:run_tasks``: ``read-long``, the
optional ``ccs-1`` subread pre-consensus (``:871-895``,
``pipeline/ccs.py``), the optional ``utg`` unitig pass
(``pipeline/utg.py``), the iterated ``bwa-{sr,mr}-N`` + finish passes
(delegated to :class:`Pipeline`, flex mode with ``haplo_coverage``), the
external-mapping re-entry (``read-sam`` / ``read-bam``: consensus from a
SAM/BAM mapping through ``pipeline/sam2cns.py``), the legacy ``shrimp-*``
schedule (the 2014 SHRiMP2 passes as a per-iteration ``align_schedule``
from the ``shrimp-opt`` key), the utg-only output, and the final trim +
siamaera output stage (``:904-956``). Siamaera runs under its
``siamaera`` span, and the aggregate QC report is embedded again after it
(``_embed_qc``), since its hits and the trim funnel land after
``Pipeline.run`` aggregated.
"""

from __future__ import annotations

import logging
import re
import time
from typing import List, Optional, Sequence

from proovread_tpu_torch import obs
from proovread_tpu_torch.align.params import (from_bwa_flags,
                                              from_shrimp_flags)
from proovread_tpu_torch.config import Config
from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.pipeline.ccs import ccs_correct, is_subread_set
from proovread_tpu_torch.pipeline.driver import (Pipeline, PipelineConfig,
                                                 PipelineResult, TaskReport,
                                                 _declare_metrics)
from proovread_tpu_torch.pipeline.masking import MaskParams
from proovread_tpu_torch.pipeline.trim import (TrimParams, trim_records,
                                               trim_window)

log = logging.getLogger("proovread_tpu_torch")


def _trim_params(cfg: Config) -> TrimParams:
    sf = cfg.get("seq-filter") or {}
    ch = cfg.get("chimera-filter") or {}
    win = str(sf.get("--trim-win", "12,5")).split(",")
    return TrimParams(
        win_mean_min=float(win[0]), win_abs_min=float(win[1]),
        min_length=int(sf.get("--min-length", 500)),
        chim_min_score=float(ch.get("--min-score", 0.2)),
        chim_trim_len=int(ch.get("--trim-length", 20)),
    )


def _align_schedule(cfg: Config, base: str):
    """task -> AlignParams from the "bwa-opt" config key (DEF merged with
    per-task overrides, -N counter stripping). The cfg IS the mapper
    schedule, as in the reference (proovread.cfg:305-460)."""
    bw = cfg.data.get("bwa-opt") or {}

    def for_task(task: str):
        flags = dict(bw.get("DEF", {}))
        t = task if task in bw else re.sub(r"-\d+$", "", task)
        flags.update(bw.get(t, {}))
        return from_bwa_flags(flags)

    return {
        "first": for_task(f"bwa-{base}-1"),
        "rest": for_task(f"bwa-{base}-2"),
        "finish": for_task(f"bwa-{base}-finish"),
    }


def _pipeline_config(cfg: Config, mode: str, tasks: Sequence[str],
                     coverage, lr_min_length, sampling, haplo=None,
                     device: str = "cuda") -> PipelineConfig:
    base = "mr" if mode.startswith("mr") else "sr"
    n_iter = sum(1 for t in tasks
                 if t.startswith(f"bwa-{base}-") and not t.endswith("finish"))
    it_task = f"bwa-{base}-1"
    fin_task = f"bwa-{base}-finish"
    late_task = f"bwa-{base}-5"
    return PipelineConfig(
        mode=base,
        n_iterations=max(n_iter, 1),
        sr_coverage=float(cfg.get("sr-coverage", it_task)),
        finish_coverage=float(cfg.get("sr-coverage", fin_task)),
        coverage=coverage,
        mask_shortcut_frac=float(cfg.get("mask-shortcut-frac")),
        mask_min_gain_frac=float(cfg.get("mask-min-gain-frac")),
        hcr_mask=MaskParams.from_cfg_string(cfg.get("hcr-mask", it_task)),
        hcr_mask_late=MaskParams.from_cfg_string(
            cfg.get("hcr-mask", late_task)),
        lr_min_length=lr_min_length,
        sampling=sampling,
        sr_chunk_number=int(cfg.get("sr-chunk-number")),
        sr_chunk_step=int(cfg.get("sr-chunk-step")),
        sr_trim=bool(int(cfg.get("sr-trim"))),
        align_schedule=_align_schedule(cfg, base),
        haplo_coverage=haplo,
        trim=_trim_params(cfg),
        indel_taboo_length=int(cfg.get("sr-indel-taboo-length")),
        coverage_scale=float(cfg.get("coverage-scale-factor")),
        engine=str(cfg.get("engine")),
        batch_reads=int(cfg.get("batch-reads")),
        device_chunk=int(cfg.get("device-chunk")),
        host_chunk_rows=int(cfg.get("host-chunk-rows") or 4096),
        seed_stride=int(cfg.get("seed-stride")),
        sr_device_budget=int(cfg.get("sr-device-budget")),
        debug_dir=cfg.get("debug-dir"),
        checkpoint_dir=cfg.get("checkpoint-dir"),
        resume=bool(int(cfg.get("resume") or 0)),
        bucket_timeout=(float(cfg.get("bucket-timeout"))
                        if cfg.get("bucket-timeout") else None),
        ladder=bool(int(1 if cfg.get("resilience-ladder") is None
                        else cfg.get("resilience-ladder"))),
        fault_spec=cfg.get("fault-spec"),
        mesh_shards=(int(cfg.get("mesh-shards"))
                     if cfg.get("mesh-shards") else None),
        mesh_chunks_per_shard=int(cfg.get("mesh-chunks-per-shard") or 2),
        mesh_pass_timeout=(float(cfg.get("mesh-pass-timeout"))
                           if cfg.get("mesh-pass-timeout") else None),
        device=device,
    )


def _embed_qc(result: PipelineResult) -> None:
    """(Re-)embed the aggregate QC report and its gauges (publishing the
    gauges again is idempotent)."""
    rec = obs.qc.current()
    if rec is not None:
        result.qc = rec.aggregate()
        rec.to_metrics(result.qc)


def _apply_siamaera(cfg: Config, result: PipelineResult,
                    device: str) -> None:
    """Final-output siamaera pass over the trimmed records
    (bin/proovread:923-933); ``"siamaera": null`` in the config
    deactivates it, like the reference's commented-out key."""
    if cfg.data.get("siamaera", {}) is None:
        return
    from proovread_tpu_torch.pipeline.siamaera import siamaera_filter
    t0 = time.monotonic()
    with obs.span("siamaera", cat="task"):
        trimmed, stats = siamaera_filter(result.trimmed, device=device)
    result.trimmed = trimmed
    log.info("siamaera: %d checked, %d trimmed, %d dropped (%.1fs)",
             stats.checked, stats.trimmed, stats.dropped,
             time.monotonic() - t0)


def run_tasks(
    cfg: Config,
    mode: str,
    tasks: Sequence[str],
    longs: List[SeqRecord],
    shorts: List[SeqRecord],
    utgs: Optional[List[SeqRecord]] = None,
    coverage: Optional[float] = None,
    lr_min_length: Optional[int] = None,
    sampling: bool = True,
    haplo_coverage: Optional[float] = None,
    device: str = "cuda",
    sam: Optional[str] = None,
    bam: Optional[str] = None,
) -> PipelineResult:
    """Run ``tasks`` of ``mode``; ``ccs-1``, ``utg``, the SAM/BAM
    consensus, the passes and siamaera run on ``device``. ``sam`` /
    ``bam`` name the external mapping of the re-entry modes."""
    reports: List[TaskReport] = []

    # -- read-long: input normalization for every mode
    # (bin/proovread:1368-1520; min_sr fallback 200 for utg-only modes,
    # bin/proovread:658) --------------------------------------------------
    sr_lens = sorted(len(r) for r in shorts)
    min_sr = sr_lens[len(sr_lens) // 2] if sr_lens else 200
    rl_pipe = Pipeline(PipelineConfig(lr_min_length=lr_min_length))
    longs, ignored0 = rl_pipe.read_long(longs, min_sr)

    # -- ccs-1: subread circular pre-consensus (bin/proovread:871-895) ----
    if "ccs-1" in tasks:
        if not is_subread_set(longs):
            log.info("ccs-1: ids are not PacBio subreads, skipping "
                     "(-noccs fallback, bin/proovread:1512-1517)")
        else:
            t0 = time.monotonic()
            ccs_cfg = cfg.get("ccs") or {}
            with obs.span("ccs-1", cat="task"):
                longs, st = ccs_correct(
                    longs,
                    min_subreads=int(ccs_cfg.get("--min-subreads", 2)),
                    window=int(ccs_cfg.get("--window", 512)),
                    overlap=int(ccs_cfg.get("--overlap", 64)),
                    batch_refs=int(ccs_cfg.get("--batch-refs", 256)),
                    device=device)
            reports.append(TaskReport("ccs-1", 0.0, 0, st.primary))
            log.info("ccs-1: %d primary, %d single, %d secondary dropped "
                     "(%.1fs)", st.primary, st.single, st.secondary,
                     time.monotonic() - t0)

    # -- external-mapping re-entry (read-sam/read-bam) --------------------
    if "read-sam" in tasks or "read-bam" in tasks:
        return _read_mapping(cfg, mode, tasks, longs, ignored0, reports,
                             sam if sam is not None else bam,
                             haplo_coverage, device)

    # -- utg pass ---------------------------------------------------------
    utg_corrected = False
    if any(t == "utg" or t.endswith("-utg") for t in tasks):
        if not utgs:
            raise ValueError(f"mode {mode!r} needs -u/--unitigs input")
        from proovread_tpu_torch.pipeline.utg import utg_correct
        t0 = time.monotonic()
        with obs.span("utg", cat="task"):
            longs, utg_rep = utg_correct(cfg, longs, utgs, device=device)
        reports.append(utg_rep)
        log.info("utg: masked %.1f%% (%.1fs)", utg_rep.masked_frac * 100,
                 time.monotonic() - t0)
        utg_corrected = True

    # -- legacy mode: the 2014 SHRiMP2 schedule on the built-in mapper
    # (proovread.cfg:140 task list; per-iteration params from "shrimp-opt")
    if any(t.startswith("shrimp-") for t in tasks):
        if not shorts:
            raise ValueError(f"mode {mode!r} needs -s/--short-reads input")
        so = cfg.data.get("shrimp-opt") or {}
        pre = [t for t in tasks if t.startswith("shrimp-pre-")]
        sched = {t.rsplit("-", 1)[1]: from_shrimp_flags(so.get(t, {}))
                 for t in pre}
        sched["finish"] = from_shrimp_flags(so.get("shrimp-finish", {}))
        sched["first"] = sched.get("1", sched["finish"])
        sched["rest"] = sched.get("2", sched["first"])
        pc = _pipeline_config(cfg, "sr", tasks, coverage, lr_min_length,
                              sampling, haplo=haplo_coverage, device=device)
        pc.n_iterations = max(len(pre), 1)
        pc.align_schedule = sched
        result = Pipeline(pc).run(longs, shorts)
        # task names in the legacy schedule's own vocabulary
        for rep in result.reports:
            rep.task = rep.task.replace("bwa-sr", "shrimp-pre") \
                .replace("shrimp-pre-finish", "shrimp-finish")
        result.reports = reports + result.reports
        result.ignored = ignored0 + result.ignored
        _apply_siamaera(cfg, result, device)
        _embed_qc(result)
        return result

    # -- iterated short-read correction ----------------------------------
    base = "mr" if mode.startswith("mr") else "sr"
    if any(t.startswith(f"bwa-{base}-") for t in tasks):
        if not shorts:
            raise ValueError(f"mode {mode!r} needs -s/--short-reads input")
        pc = _pipeline_config(cfg, mode, tasks, coverage, lr_min_length,
                              sampling, haplo=haplo_coverage, device=device)
        result = Pipeline(pc).run(longs, shorts)
        result.reports = reports + result.reports
        result.ignored = ignored0 + result.ignored
        _apply_siamaera(cfg, result, device)
        _embed_qc(result)
        return result

    if utg_corrected:
        # utg-only mode: the corrected reads come straight from the utg
        # pass; the trimmed output gets the quality-window + min-length
        # trim of every other mode (bin/proovread:923-933)
        with obs.metrics.scope() as reg:
            _declare_metrics(reg)
            trim = _trim_params(cfg)
            trimmed = [t for r in longs
                       if (t := trim_window(r, trim)) is not None]
            obs.metrics.counter("reads_processed", unit="reads").inc(
                len(longs))
            obs.metrics.counter("bases_processed", unit="bases").inc(
                sum(len(r) for r in longs))
            result = PipelineResult(
                untrimmed=longs, trimmed=trimmed,
                ignored=ignored0, chimera=[], reports=reports)
            _apply_siamaera(cfg, result, device)
            _embed_qc(result)
            result.metrics = reg.as_dict()
        return result

    raise ValueError(f"mode {mode!r}: no runnable tasks in {tasks}")


def _read_mapping(cfg: Config, mode: str, tasks: Sequence[str],
                  longs: List[SeqRecord], ignored0, reports, src,
                  haplo_coverage, device: str) -> PipelineResult:
    """``read-sam`` / ``read-bam``: consensus-correct the long reads from
    the external mapping ``src`` (``pipeline/sam2cns.py``), then the trim
    and siamaera stage. The KPI catalog is declared and filled as in
    ``Pipeline.run``."""
    from proovread_tpu_torch.consensus.params import ConsensusParams
    from proovread_tpu_torch.pipeline.sam2cns import Sam2CnsConfig, sam2cns
    task = "read-sam" if "read-sam" in tasks else "read-bam"
    if src is None:
        raise ValueError(f"mode {mode!r} needs --sam/--bam input")
    params = ConsensusParams(
        indel_taboo_length=int(cfg.get("sr-indel-taboo-length")),
        use_ref_qual=True,
        bin_size=int(cfg.get("bin-size", task)),
        max_coverage=int(cfg.get("max-coverage", task)),
        rep_coverage=int(cfg.get("rep-coverage", task) or 0),
    )
    if haplo_coverage is not None and haplo_coverage <= 0:
        # a bare --haplo-coverage asks for an estimate from the device
        # passes, which re-entry does not run; a negative cutoff must
        # never reach filter_by_coverage
        log.warning("%s: --haplo-coverage without a value has no effect in "
                    "sam/bam re-entry mode — give an explicit coverage "
                    "cutoff", task)
        haplo_coverage = None
    s2c = Sam2CnsConfig(
        params=params,
        detect_chimera=bool(cfg.get("detect-chimera", task)),
        max_ref_seqs=int(cfg.get("chunk-size")),
        haplo_coverage=haplo_coverage,
    )
    with obs.metrics.scope() as reg:
        _declare_metrics(reg)
        t0 = time.monotonic()
        with obs.span(task, cat="task"):
            results = list(sam2cns(src, longs, s2c, device=device))
        log.info("%s: %d reads corrected (%.1fs)", task, len(results),
                 time.monotonic() - t0)
        obs.metrics.counter("reads_processed", unit="reads").inc(
            len(results))
        obs.metrics.counter("bases_processed", unit="bases").inc(
            sum(len(r.record) for r in results))
        chim = [(r.record.id, f, t, s)
                for r in results for (f, t, s) in r.chimera]
        result = PipelineResult(
            untrimmed=[r.record for r in results],
            trimmed=trim_records(results, _trim_params(cfg)),
            ignored=ignored0, chimera=chim, reports=reports)
        _apply_siamaera(cfg, result, device)
        _embed_qc(result)
        result.metrics = reg.as_dict()
    return result
