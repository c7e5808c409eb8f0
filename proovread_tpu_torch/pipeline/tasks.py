"""Config-driven task orchestration — the role of ``bin/proovread``'s task
state machine (``:705-900``) above the device pipeline.

Port of ``proovread_tpu/pipeline/tasks.py:run_tasks`` for the modes that
run the iterated short-read correction: ``sr``, ``mr``, ``sr-noccs`` and
``mr-noccs``. ``read-long``, the ``bwa-{sr,mr}-N`` + finish passes
(delegated to :class:`Pipeline`) and the final trim + siamaera output stage
(``:904-956``) run as in the reference. A task the port does not run yet
raises ``NotImplementedError`` naming it: ``ccs-1`` on a PacBio subread
set, ``utg``, ``read-sam`` / ``read-bam`` and the legacy ``shrimp-*``
schedule. Siamaera runs under its ``siamaera`` span, and the aggregate QC
report is embedded again after it (``_embed_qc``), since its hits and the
trim funnel land after ``Pipeline.run`` aggregated.
"""

from __future__ import annotations

import logging
import re
import time
from typing import List, Optional, Sequence

from proovread_tpu_torch import obs
from proovread_tpu_torch.align.params import from_bwa_flags
from proovread_tpu_torch.config import Config
from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.pipeline.ccs import is_subread_set
from proovread_tpu_torch.pipeline.driver import (Pipeline, PipelineConfig,
                                                 PipelineResult)
from proovread_tpu_torch.pipeline.masking import MaskParams
from proovread_tpu_torch.pipeline.trim import TrimParams

log = logging.getLogger("proovread_tpu_torch")


def _unported_task(task: str) -> bool:
    return (task in ("utg", "read-sam", "read-bam") or task.endswith("-utg")
            or task.startswith("shrimp-"))


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
                     coverage, lr_min_length, sampling,
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
    coverage: Optional[float] = None,
    lr_min_length: Optional[int] = None,
    sampling: bool = True,
    device: str = "cuda",
) -> PipelineResult:
    """Run ``tasks`` of ``mode``; the passes and siamaera run on
    ``device``."""
    for t in tasks:
        if _unported_task(t):
            raise NotImplementedError(
                f"task {t!r} (mode {mode!r}) is not supported by the PyTorch "
                "port yet")

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
            raise NotImplementedError(
                "task 'ccs-1' (subread consensus of PacBio subread ids) is "
                "not supported by the PyTorch port yet; use mode "
                f"'{mode.split('-')[0]}-noccs'")

    # -- iterated short-read correction ----------------------------------
    base = "mr" if mode.startswith("mr") else "sr"
    if any(t.startswith(f"bwa-{base}-") for t in tasks):
        if not shorts:
            raise ValueError(f"mode {mode!r} needs -s/--short-reads input")
        pc = _pipeline_config(cfg, mode, tasks, coverage, lr_min_length,
                              sampling, device=device)
        result = Pipeline(pc).run(longs, shorts)
        result.ignored = ignored0 + result.ignored
        _apply_siamaera(cfg, result, device)
        _embed_qc(result)
        return result

    raise ValueError(f"mode {mode!r}: no runnable tasks in {tasks}")
