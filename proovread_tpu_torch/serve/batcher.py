"""Continuous batching: merge queued jobs into length-bucketed waves (port
of ``proovread_tpu/serve/batcher.py``).

One *wave* is one ``Pipeline.run`` over the union of several jobs' reads.
The driver's length bucketing (``_bucket_records``) then freely mixes
reads from different jobs into the same bucket, so the kernels run on full
buckets however small each job is; the pipelines themselves stay alive
across waves, with the short-read set on the card
(``Pipeline.prepare_short_reads``).

The wave loop attaches to the driver through the two serving hooks
(``Pipeline._bucket_gate`` / ``_bucket_done``):

* the **gate** runs before every bucket: it raises
  :class:`DrainRequested` at a drain (SIGTERM) so the in-flight bucket is
  the last one computed (everything computed so far is already in the
  wave's checkpoint journal), fires the injected ``worker`` fault site,
  and filters out the reads of jobs cancelled or deadline-breached since
  the previous bucket — a mid-bucket cancel/breach takes effect at the
  next bucket boundary, never corrupts a neighbor job;
* the **done** callback runs after every bucket: results are routed back
  to their owning jobs, and any job whose reads are all corrected is
  finalized immediately — a small job in an early bucket completes while
  later buckets still compute.

Jobs sharing one wave must share a *base correction mode*: ``clr`` and
``ccs`` traffic both correct in sr mode (ccs ZMWs are collapsed to
consensus references first, per job, deterministically, through
``pipeline/ccs.py:ccs_correct`` on the pipeline's device), ``unitig``
traffic corrects in mr mode.

Byte-identical retry/resume: a wave is fully determined by (config, job
read ids, short-read set), the checkpoint journal's ``run_fingerprint``,
so a retried or resumed wave reuses its wave directory, replays completed
buckets from the journal and recomputes only the rest.

The metrics and QC scopes a wave opens are thread-local
(``obs/metrics.py``, ``obs/qc.py``), so servers in one process (a fleet's
replicas) keep their own.
"""

from __future__ import annotations

import logging
import os
from contextlib import nullcontext
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Sequence

from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.obs import metrics as obs_metrics
from proovread_tpu_torch.obs import qc as obs_qc
from proovread_tpu_torch.pipeline.driver import (Pipeline, PipelineConfig,
                                                 natural_key)
from proovread_tpu_torch.pipeline.trim import trim_records
from proovread_tpu_torch.serve.jobs import Job
from proovread_tpu_torch.serve.protocol import encode_records

log = logging.getLogger("proovread_tpu_torch")

# traffic class -> base correction mode (proovread task modes, PAPER.md)
BASE_MODE = {"clr": "sr", "ccs": "sr", "unitig": "mr"}


class DrainRequested(Exception):
    """Raised by the bucket gate when a graceful drain is requested: the
    wave stops at the bucket boundary, completed buckets stay journaled,
    unfinished jobs stay in journaled state for ``--resume``."""


class WaveRunner:
    def __init__(
        self,
        short_records: Sequence[SeqRecord],
        waves_dir: str,
        base_config: PipelineConfig,
        min_sr_len: int,
        drain_event,
        faults=None,
        registry=None,
        qc_recorder=None,
        drain_after_buckets: Optional[int] = None,
    ):
        self.short_records = short_records
        self.waves_dir = waves_dir
        self.base_config = base_config
        self.min_sr_len = min_sr_len
        self.drain_event = drain_event
        self.faults = faults
        self.registry = registry
        self.qc_recorder = qc_recorder
        # testing knob: request a drain after N computed buckets — the
        # deterministic stand-in for an operator SIGTERM landing mid-wave
        self.drain_after_buckets = drain_after_buckets
        self._buckets_done_total = 0
        self._pipes: Dict[str, Pipeline] = {}
        os.makedirs(waves_dir, exist_ok=True)

    # -- pipelines stay hot across waves ----------------------------------
    def _pipe(self, base: str) -> Pipeline:
        pipe = self._pipes.get(base)
        if pipe is None:
            pipe = Pipeline(replace(self.base_config, mode=base))
            pipe.prepare_short_reads(self.short_records)
            self._pipes[base] = pipe
        return pipe

    def _collapse_ccs(self, job: Job) -> List[SeqRecord]:
        """Per-job CCS pre-consensus (deterministic, cached on the job so
        a retried wave reuses the identical collapsed reads)."""
        if job.ccs_records is None:
            from proovread_tpu_torch.pipeline.ccs import ccs_correct
            job.ccs_records, st = ccs_correct(
                job.records, device=self.base_config.device)
            log.info("serve: job %s ccs collapse: %d subreads -> %d "
                     "reads (%d primary / %d single)", job.job_id,
                     len(job.records), len(job.ccs_records), st.primary,
                     st.single)
        return job.ccs_records

    # -- the wave ----------------------------------------------------------
    def run_wave(self, wave_idx: int, jobs: List[Job],
                 finalize: Callable[[Job, str, str], None]) -> str:
        """Run one wave. Returns ``"ok"`` or ``"drained"``; any other
        exception (injected worker death, a genuine defect) propagates to
        the server's wave-death/retry handler. ``finalize(job, status,
        reason)`` is the server callback that journals a terminal job and
        releases its tenant's quota."""
        base = BASE_MODE[jobs[0].mode]
        pipe = self._pipe(base)
        cfg = replace(
            pipe.config,
            checkpoint_dir=os.path.join(self.waves_dir,
                                        f"wave_{wave_idx:05d}"),
            # always resume-capable: a fresh wave dir is a no-op, a
            # retried/restarted wave replays its completed buckets
            resume=True,
        )
        pipe.config = cfg

        qc_cm = (obs_qc.scope(self.qc_recorder)
                 if self.qc_recorder is not None else nullcontext())
        met_cm = (obs_metrics.scope(self.registry)
                  if self.registry is not None else nullcontext())
        with met_cm, qc_cm:
            owner: Dict[str, Job] = {}
            union: List[SeqRecord] = []
            for job in jobs:
                job.reset_wave_state()
                recs = (self._collapse_ccs(job) if job.mode == "ccs"
                        else job.records)
                for r in recs:
                    owner[r.id] = job
                union.extend(recs)
            kept, ignored = pipe.read_long(union, self.min_sr_len)
            for rid, why in ignored:
                owner[rid].ignored.append((rid, why))
            for r in kept:
                owner[r.id].live_ids.append(r.id)
            # all-ignored jobs complete right away (empty output, every
            # read attributably ignored) — nothing to correct
            for job in jobs:
                if not job.live_ids and not job.terminal:
                    self._complete(job, finalize)
            jobs_live = [j for j in jobs if not j.terminal]
            if not jobs_live:
                return "ok"

            def gate(gi: int, n_groups: int, recs):
                if self.drain_event.is_set():
                    raise DrainRequested()
                if self.faults is not None and self.faults.active:
                    for job in jobs_live:
                        if not job.terminal:
                            self.faults.check_job(job.seq, "worker")
                drop = set()
                for job in jobs_live:
                    if not job.terminal and job.cancel_requested:
                        finalize(job, "cancelled", "cancelled by client")
                    elif not job.terminal and job.deadline_breached():
                        finalize(job, "expired",
                                 f"deadline of {job.deadline_s:.3g}s "
                                 "breached")
                    if job.terminal and job.status != "completed":
                        drop.update(job.live_ids)
                if drop:
                    recs = [r for r in recs if r.id not in drop]
                return recs

            def done(gi: int, res_batch, chim, replayed: bool):
                self._buckets_done_total += 1
                for cr in res_batch:
                    job = owner.get(cr.record.id)
                    if job is not None and not job.terminal:
                        job.results[cr.record.id] = cr
                for job in jobs_live:
                    if (not job.terminal and job.live_ids
                            and all(i in job.results
                                    for i in job.live_ids)):
                        self._complete(job, finalize)
                if (self.drain_after_buckets is not None
                        and self._buckets_done_total
                        >= self.drain_after_buckets):
                    log.warning("serve: drain-after-buckets=%d reached — "
                                "requesting drain (test knob)",
                                self.drain_after_buckets)
                    self.drain_event.set()

            pipe._bucket_gate = gate
            pipe._bucket_done = done
            try:
                # the SAME list object every wave: that identity is what
                # finds the prepare_short_reads set
                pipe.run(union, self.short_records)
            except DrainRequested:
                return "drained"
            finally:
                pipe._bucket_gate = None
                pipe._bucket_done = None
            # a job can reach here non-terminal only if the driver never
            # produced results for some of its reads — that would be a
            # defect, and it must surface as a failed job, never silence
            for job in jobs_live:
                if not job.terminal:
                    finalize(job, "failed",
                             "wave completed without results for "
                             f"{sum(1 for i in job.live_ids if i not in job.results)}"
                             " read(s)")
        return "ok"

    def _complete(self, job: Job,
                  finalize: Callable[[Job, str, str], None]) -> None:
        """Assemble the job's terminal payload in the driver's natural
        output order (byte-identical to the batch CLI restricted to this
        job's reads) and hand it to the server's finalizer."""
        order = sorted(job.live_ids, key=natural_key)
        results = [job.results[i] for i in order]
        trimmed = trim_records(results, self.base_config.trim)
        qc_payload = None
        if self.qc_recorder is not None:
            qc_payload = self.qc_recorder.bucket_payload(order)
        job.result = {
            "untrimmed": encode_records([r.record for r in results]),
            "trimmed": encode_records(trimmed),
            "chimera": [[r.record.id, int(f), int(t), float(s)]
                        for r in results for (f, t, s) in r.chimera],
            "ignored": [[rid, why] for rid, why in job.ignored],
            "qc": qc_payload,
        }
        finalize(job, "completed", "")
