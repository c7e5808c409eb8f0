"""The long-lived correction server (port of
``proovread_tpu/serve/server.py``).

``CorrectionServer`` owns the job table, the per-tenant admission gate,
the wave batcher and the job journal, and exposes the JSONL protocol both
in-process (:meth:`handle`) and over an ``AF_UNIX`` socket
(:meth:`serve_forever` / :meth:`start`). The deliverable is robustness
under hostile conditions, not raw QPS:

* **Backpressure is bounded and observable** — tenant queues are hard
  bounds; over-quota submissions are rejected with a reason and a
  ``retry_after_s`` derived from the observed drain rate; the SLO
  artifact (:meth:`slo_snapshot` / ``obs/validate.py:validate_slo``)
  counts every rejection per reason.
* **No job is silently lost** — every submission ends
  rejected-with-reason, completed, failed-with-reason, cancelled,
  expired, or journaled for resume; ``validate_slo`` enforces the
  accounting identity.
* **Graceful drain** — SIGTERM (or the ``drain`` op) finishes the
  in-flight bucket, journals the rest, writes the SLO artifact and
  exits; a restart with ``resume=True`` requeues journaled jobs and
  replays their waves' completed buckets byte-identically from the
  checkpoint journal.
* **Job-level retry** — a dead worker (``worker`` fault site, or any
  escape from a wave) fails the wave, not the server: surviving jobs are
  requeued up to ``job_retries`` times and their retry waves replay the
  journaled buckets.

The waves run on the pipeline's ``device`` (``PipelineConfig.device``,
the card unless the caller asks for the CPU); a server asked for the card
on a machine without one raises at construction. The SLO artifact keeps
the reference's schema (``SLO_SCHEMA_VERSION`` 2, every key), so both
packages' ``validate_slo`` accept it. Its ``compile`` block reports the
kernel library of ``kernels.py``: ``n_programs`` the CUDA sources in the
loaded library (0 before the first launch, and on the CPU),
``backend_compiles`` / ``backend_compile_s`` the library's build windows
in this process and their seconds (the ``nvcc`` runs and the link, or
the load of a library found built: the windows, and seconds, a compile
ledger's census counts, ``obs/compilecache.py``), ``tracing_hits`` /
``tracing_misses`` 0 and ``tracing_hit_rate`` null (the server keeps no
ledger of its own: one left installed in a process would fill every
later run's compile gauges).

**Warm boot** (``ServeConfig.artifact_dir``): the kernel-build artifact
(``analysis/factory.py``) is verified before anything is written (a
refused artifact leaves no state behind), copied under the state dir
and verified again, the kernel build directory points at the copy and,
on the card, the library loads from it then: one BOOT row
(``obs/boot.py:artifact_boot``) lands in ``<state_dir>/boot.json``, its
build window a cache hit, ``nvcc`` never run.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from proovread_tpu_torch import kernels
from proovread_tpu_torch.device import resolve
from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.obs.metrics import MetricsRegistry
from proovread_tpu_torch.pipeline.driver import PipelineConfig
from proovread_tpu_torch.serve.admission import AdmissionController, TenantQuota
from proovread_tpu_torch.serve.batcher import BASE_MODE, WaveRunner
from proovread_tpu_torch.serve.jobs import Job, JobJournal
from proovread_tpu_torch.serve.protocol import MODES, decode_records, read_line
from proovread_tpu_torch.testing.faults import (
    FaultPlan, InjectedDeadlineBreach, InjectedParseError,
    InjectedQuotaExhausted)

log = logging.getLogger("proovread_tpu_torch")

# read-length classes for the p99 latency SLO: the driver's length-bucket
# bounds, so SLO classes and compute buckets speak the same unit
LENGTH_CLASSES = (512, 1024, 2048, 4096, 8192, 16384, 32768)


def length_class(n_bases: int) -> str:
    for b in LENGTH_CLASSES:
        if n_bases <= b:
            return str(b)
    return "huge"


@dataclass
class ServeConfig:
    state_dir: str
    socket_path: Optional[str] = None
    quota: TenantQuota = field(default_factory=TenantQuota)
    max_wave_jobs: int = 8           # jobs merged into one wave
    job_retries: int = 1             # wave-death requeues per job
    default_deadline_s: Optional[float] = None
    # fault-injection spec (testing/faults.py job sites); None reads the
    # PROOVREAD_FAULT env var — the same plan drives the pipeline's
    # device sites inside waves
    fault_spec: Optional[str] = None
    slo_path: Optional[str] = None
    qc: bool = False                 # per-read QC provenance per job
    resume: bool = False             # reload + requeue journaled jobs
    # testing knob: request a drain after N computed buckets (the
    # deterministic stand-in for SIGTERM landing mid-wave)
    drain_after_buckets: Optional[int] = None
    # stable identity on the ping probe — the fleet dispatcher assigns
    # "r0".."rN-1"; empty derives a per-process default
    replica_id: str = ""
    # the kernel-build artifact to warm-boot from (module docstring)
    artifact_dir: Optional[str] = None


class CorrectionServer:
    def __init__(self, short_records: Sequence[SeqRecord],
                 config: ServeConfig,
                 pipeline_config: Optional[PipelineConfig] = None):
        if config.artifact_dir:
            # refused before any state is written
            from proovread_tpu_torch.obs.boot import verify_artifact
            verify_artifact(config.artifact_dir)
        self.cfg = config
        self.short_records = list(short_records)
        self.pipeline_template = pipeline_config or PipelineConfig()
        # the card unless the caller asks for the CPU: fail now, not at
        # the first wave
        resolve(self.pipeline_template.device)
        os.makedirs(config.state_dir, exist_ok=True)

        spec = (config.fault_spec if config.fault_spec is not None
                else os.environ.get("PROOVREAD_FAULT"))
        self.faults = FaultPlan.from_spec(spec)
        if self.faults.active:
            log.warning("serve: fault injection active: %d rule(s)",
                        len(self.faults.rules))

        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._drain = threading.Event()
        self._drained = threading.Event()
        # ping-probe identity (serve/fleet.py): a monotonic
        # birth stamp plus the in-flight wave state — what lets the
        # dispatcher tell a replica hung in a wave (wave busy_s
        # growing, uptime high) from a healthy idle one (wave None)
        self.replica_id = config.replica_id or f"pid{os.getpid()}"
        self.boot_manifest = None
        if config.artifact_dir:
            from proovread_tpu_torch.obs.boot import artifact_boot
            self.boot_manifest, row = artifact_boot(
                config.state_dir, artifact_dir=config.artifact_dir,
                device=self.pipeline_template.device,
                replica=self.replica_id,
                fetch_to=os.path.join(config.state_dir, "artifact_cache"))
            log.info("serve: booted from artifact %s (%d build window(s), "
                     "%d violation(s))", self.boot_manifest["version"],
                     row["n_backend_compiles"], len(row["violations"]))
        self._born_mono = time.monotonic()
        self._wave_state: Optional[Dict[str, Any]] = None
        self._jobs: Dict[str, Job] = {}
        self._queue: List[str] = []          # job ids, submission order
        self._submit_seq = 0
        self._next_wave = 0
        self._rejections: Dict[str, int] = {}
        self._demotions: Dict[str, int] = {}  # tenant -> ladder demotions
        self._drain_clean = False

        self.admission = AdmissionController(config.quota)
        self.registry = MetricsRegistry()
        self._declare_serve_metrics()
        self.qc_recorder = None
        if config.qc:
            from proovread_tpu_torch.obs.qc import QcRecorder
            self.qc_recorder = QcRecorder()

        self.journal = JobJournal(os.path.join(config.state_dir, "jobs"),
                                  faults=self.faults)
        sr_lens = np.array([len(r) for r in self.short_records])
        min_sr_len = int(np.median(sr_lens)) if len(sr_lens) else 100
        # pipeline fault plan: waves see the same spec so device sites
        # (compile@bN, oom@*) drill the ladder inside the serving path;
        # job rules never match device sites (FaultRule.matches)
        tpl = self.pipeline_template
        if tpl.fault_spec is None and spec:
            from dataclasses import replace as _replace
            tpl = _replace(tpl, fault_spec=spec)
        self.waves = WaveRunner(
            self.short_records,
            os.path.join(config.state_dir, "waves"),
            tpl, min_sr_len, self._drain,
            faults=self.faults, registry=self.registry,
            qc_recorder=self.qc_recorder,
            drain_after_buckets=config.drain_after_buckets)

        self._threads: List[threading.Thread] = []
        self._listener: Optional[socket.socket] = None
        if config.resume:
            self._resume()

    # -- metrics -----------------------------------------------------------
    def _declare_serve_metrics(self) -> None:
        """Pre-declare the serving KPI catalog in the metrics registry so
        zero-valued series still appear (a stable schema)."""
        r = self.registry
        r.counter("serve_jobs_accepted", "jobs", "jobs admitted")
        r.counter("serve_jobs_rejected", "jobs",
                  "submissions rejected, by reason")
        r.counter("serve_jobs_completed", "jobs", "jobs completed")
        r.counter("serve_jobs_failed", "jobs", "jobs failed, with reason")
        r.counter("serve_jobs_cancelled", "jobs", "jobs cancelled")
        r.counter("serve_jobs_expired", "jobs", "jobs past deadline")
        r.counter("serve_waves", "waves", "continuous-batching waves run")
        r.counter("serve_wave_deaths", "waves",
                  "waves lost to a worker death (jobs requeued)")
        r.gauge("serve_queue_depth", "jobs", "held jobs, by tenant")
        r.gauge("serve_queue_depth_peak", "jobs", "peak held jobs")
        r.histogram("serve_job_seconds", "s",
                    "job latency, by read-length class")
        r.histogram("serve_retry_after_s", "s",
                    "backpressure retry-after hints issued")

    def _set_depth_gauges(self) -> None:
        g = self.registry.gauge("serve_queue_depth", "jobs")
        tenants = {j.tenant for j in self._jobs.values()}
        for t in tenants:
            g.set(self.admission.held_jobs(t), tenant=t)
        self.registry.gauge("serve_queue_depth_peak", "jobs").set(
            self.admission.depth_peak)

    # -- resume ------------------------------------------------------------
    def _resume(self) -> None:
        jobs, corrupt = self.journal.load()
        for job in jobs:
            self._jobs[job.job_id] = job
            self._submit_seq = max(self._submit_seq, job.seq + 1)
            if job.wave is not None:
                self._next_wave = max(self._next_wave, job.wave + 1)
            if job.terminal:
                continue
            # journaled (accepted/running) jobs requeue with their quota
            # re-charged — they were admitted once and never released
            self.admission.charge(job.tenant, job.n_bases)
            self._queue.append(job.job_id)
        for job_id, filename, seq in corrupt:
            self.journal.quarantine(filename)
            self._submit_seq = max(self._submit_seq, seq + 1)
            tomb = Job(job_id=job_id, tenant="(unknown)", mode="clr",
                       records=[], seq=seq, status="failed",
                       reason="journal-corrupt: entry unreadable at "
                              "resume (quarantined)")
            tomb.finished_mono = time.monotonic()
            self._jobs[job_id] = tomb
            self.journal.put(tomb)
            self.registry.counter("serve_jobs_failed", "jobs").inc(
                1, reason="journal-corrupt")
            log.warning("resume: job %r journal entry corrupt — job "
                        "FAILED with reason journal-corrupt (not lost)",
                        job_id)
        # running jobs' waves re-run first, in wave order, so their
        # completed buckets replay before new work compiles anything
        self._queue.sort(key=lambda jid: (
            self._jobs[jid].wave if self._jobs[jid].wave is not None
            else 1 << 30, self._jobs[jid].seq))
        log.info("resume: %d job(s) requeued, %d terminal kept, "
                 "%d corrupt entr(ies) surfaced as failed",
                 len(self._queue),
                 sum(1 for j in self._jobs.values() if j.terminal),
                 len(corrupt))

    # -- protocol dispatch -------------------------------------------------
    def handle(self, req: Any) -> Dict[str, Any]:
        if not isinstance(req, dict) or "op" not in req:
            return {"ok": False, "error": "bad-request: no op"}
        op = req["op"]
        if op == "submit":
            return self._op_submit(req)
        if op == "status":
            return self._op_status(req)
        if op == "result":
            return self._op_result(req)
        if op == "cancel":
            return self._op_cancel(req)
        if op == "stats":
            return {"ok": True, "slo": self.slo_snapshot()}
        if op == "drain":
            self.drain()
            return {"ok": True, "draining": True}
        if op == "ping":
            return self._op_ping()
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _op_ping(self) -> Dict[str, Any]:
        """Liveness/health probe: replica identity, monotonic uptime and
        the in-flight wave state. ``wave`` is None when idle; a busy
        replica reports which wave, how many jobs ride it, and how long
        it has been computing — so the dispatcher can distinguish
        hung in a wave (busy_s growing without bound) from healthy-idle
        (wave None) without touching the job table."""
        with self._lock:
            ws = dict(self._wave_state) if self._wave_state else None
        if ws is not None:
            ws["busy_s"] = round(time.monotonic() - ws.pop("t0"), 6)
        return {"ok": True, "draining": self._drain.is_set(),
                "replica_id": self.replica_id,
                "uptime_s": round(time.monotonic() - self._born_mono, 6),
                "wave": ws}

    def _reject(self, reason: str, retry_after_s: Optional[float] = None,
                detail: str = "") -> Dict[str, Any]:
        with self._lock:
            self._rejections[reason] = self._rejections.get(reason, 0) + 1
        self.registry.counter("serve_jobs_rejected", "jobs").inc(
            1, reason=reason)
        resp: Dict[str, Any] = {"ok": True, "status": "rejected",
                                "reason": reason}
        if detail:
            resp["detail"] = detail
        if retry_after_s is not None:
            resp["retry_after_s"] = round(retry_after_s, 3)
            self.registry.histogram("serve_retry_after_s", "s").observe(
                retry_after_s)
        log.info("serve: submission rejected (%s%s)%s", reason,
                 f": {detail}" if detail else "",
                 f" retry_after={retry_after_s:.1f}s"
                 if retry_after_s is not None else "")
        return resp

    def _op_submit(self, req: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            seq = self._submit_seq
            self._submit_seq += 1
        if self._drain.is_set():
            return self._reject("draining", retry_after_s=30.0)
        # -- parse (the 'parse' fault site stands in for a malformed
        # payload reaching this point) --------------------------------
        try:
            self.faults.check_job(seq, "parse")
            job_id = req["job_id"]
            tenant = req["tenant"]
            if not isinstance(job_id, str) or not isinstance(tenant, str) \
                    or not job_id or not tenant:
                raise ValueError("job_id and tenant must be non-empty "
                                 "strings")
            records = decode_records(req["reads"])
        except (InjectedParseError, ValueError, KeyError, TypeError) as e:
            return self._reject("parse-error", detail=str(e)[:200])
        # -- validate ---------------------------------------------------
        mode = req.get("mode", "clr")
        if mode not in MODES:
            return self._reject("bad-request",
                                detail=f"unknown mode {mode!r}")
        if not records:
            return self._reject("bad-request", detail="empty reads")
        ids = [r.id for r in records]
        if len(ids) != len(set(ids)):
            return self._reject("bad-request",
                                detail="duplicate read ids in job")
        if mode == "ccs":
            from proovread_tpu_torch.pipeline.ccs import is_subread_set
            if not is_subread_set(records):
                return self._reject(
                    "bad-request",
                    detail="mode ccs needs PacBio subread ids")
        with self._lock:
            if job_id in self._jobs:
                return self._reject("duplicate-job",
                                    detail=f"job {job_id!r} exists")
            active_ids = {rid for j in self._jobs.values()
                          if not j.terminal for rid in
                          (r.id for r in j.records)}
        if active_ids.intersection(ids):
            return self._reject(
                "bad-request",
                detail="read id collides with an active job")
        # -- admission (quota / backpressure; 'quota' fault site) --------
        n_bases = sum(len(r) for r in records)
        try:
            self.faults.check_job(seq, "quota")
            ok, reason, retry = self.admission.try_admit(tenant, n_bases)
        except InjectedQuotaExhausted:
            ok, reason, retry = (False, "quota-jobs",
                                 self.admission.retry_after_s(n_bases))
        if not ok:
            return self._reject(reason, retry_after_s=retry)
        # -- accept ------------------------------------------------------
        job = Job(job_id=job_id, tenant=tenant, mode=mode,
                  records=records, seq=seq,
                  deadline_s=req.get("deadline_s",
                                     self.cfg.default_deadline_s))
        job.arm_deadline()
        try:
            self.faults.check_job(seq, "deadline")
        except InjectedDeadlineBreach:
            job.deadline_s = job.deadline_s or 0.0
            job.deadline_mono = time.monotonic() - 1.0
        with self._lock:
            # re-check under the lock: two connection threads may race
            # the same job_id (or colliding read ids) past the unlocked
            # fast-path checks above; the loser must also hand back the
            # quota it charged in try_admit
            if job_id in self._jobs:
                self.admission.release(tenant, n_bases)
                return self._reject("duplicate-job",
                                    detail=f"job {job_id!r} exists")
            active_ids = {rid for j in self._jobs.values()
                          if not j.terminal for rid in
                          (r.id for r in j.records)}
            if active_ids.intersection(ids):
                self.admission.release(tenant, n_bases)
                return self._reject(
                    "bad-request",
                    detail="read id collides with an active job")
            self._jobs[job_id] = job
            self._queue.append(job_id)
            self.journal.put(job)
            self.registry.counter("serve_jobs_accepted", "jobs").inc()
            self._set_depth_gauges()
            self._wake.notify_all()
        log.info("serve: job %s accepted (tenant %s, mode %s, %d reads / "
                 "%d bases)", job_id, tenant, mode, len(records), n_bases)
        return {"ok": True, "status": "accepted", "job_id": job_id}

    def _op_status(self, req: Dict[str, Any]) -> Dict[str, Any]:
        job = self._jobs.get(req.get("job_id", ""))
        if job is None:
            return {"ok": False, "error": "unknown-job"}
        return {"ok": True, "status": job.status, "reason": job.reason,
                "terminal": job.terminal, "attempts": job.attempts,
                "wave": job.wave}

    def _op_result(self, req: Dict[str, Any]) -> Dict[str, Any]:
        job = self._jobs.get(req.get("job_id", ""))
        if job is None:
            return {"ok": False, "error": "unknown-job"}
        if job.status != "completed" or job.result is None:
            return {"ok": False, "error": "not-completed",
                    "status": job.status, "reason": job.reason}
        return {"ok": True, "status": "completed", **job.result}

    def _op_cancel(self, req: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            job = self._jobs.get(req.get("job_id", ""))
            if job is None:
                return {"ok": False, "error": "unknown-job"}
            if job.terminal:
                return {"ok": True, "status": job.status,
                        "note": "already terminal"}
            job.cancel_requested = True
            if job.status == "accepted" and job.job_id in self._queue:
                # still queued: cancel immediately; running jobs unwind
                # at the next bucket boundary (batcher gate)
                self._finalize(job, "cancelled", "cancelled by client")
        return {"ok": True, "status": job.status}

    # -- job lifecycle -----------------------------------------------------
    def _finalize(self, job: Job, status: str, reason: str = "") -> None:
        """The single exit point to a terminal state: journals the job,
        releases its tenant's quota, and feeds the SLO series. Idempotent
        per job (the gate may race a cancel with completion)."""
        with self._lock:
            if job.terminal:
                return
            job.status = status
            job.reason = reason
            job.finished_mono = time.monotonic()
            if status != "completed":
                job.result = None            # partials are never served
            if job.job_id in self._queue:
                self._queue.remove(job.job_id)
            self.journal.put(job)
            self.admission.release(job.tenant, job.n_bases)
            kw = {"reason": reason[:60]} if status == "failed" else {}
            self.registry.counter(f"serve_jobs_{status}", "jobs").inc(**kw)
            if status == "completed":
                lat = job.latency_s()
                cls = length_class(max((len(r) for r in job.records),
                                       default=0))
                if lat is not None:
                    self.registry.histogram(
                        "serve_job_seconds", "s").observe(lat, cls=cls)
            self._set_depth_gauges()
        log.info("serve: job %s -> %s%s", job.job_id, status,
                 f" ({reason})" if reason else "")

    # -- the worker --------------------------------------------------------
    def _next_wave_jobs(self) -> List[Job]:
        """Under the lock: pop the next wave's jobs — the queue head plus
        every queued job sharing its base mode (and, for a resumed or
        retried wave, its wave id), bounded by max_wave_jobs."""
        while self._queue:
            head = self._jobs[self._queue[0]]
            if head.cancel_requested:
                self._finalize(head, "cancelled", "cancelled by client")
                continue
            if head.deadline_breached():
                self._finalize(head, "expired",
                               f"deadline of {head.deadline_s:.3g}s "
                               "breached in queue")
                continue
            break
        if not self._queue:
            return []
        head = self._jobs[self._queue[0]]
        base = BASE_MODE[head.mode]
        picked: List[Job] = []
        for jid in list(self._queue):
            j = self._jobs[jid]
            if len(picked) >= self.cfg.max_wave_jobs:
                break
            if BASE_MODE[j.mode] != base:
                continue
            if j.wave != head.wave:
                continue                 # a resumed wave re-runs as-was;
                # fresh jobs (wave None) never splice into it, and vice
                # versa — the wave dir's fingerprint must keep matching
            picked.append(j)
        for j in picked:
            self._queue.remove(j.job_id)
        return picked

    def pump(self) -> bool:
        """Run ONE wave synchronously. Returns False when there was
        nothing to do. Tests drive this directly; the worker thread loops
        it."""
        with self._lock:
            batch = self._next_wave_jobs()
            if not batch:
                return False
            wave = batch[0].wave if batch[0].wave is not None \
                else self._next_wave
            self._next_wave = max(self._next_wave, wave + 1)
            for job in batch:
                job.status = "running"
                job.wave = wave
                job.attempts += 1
                self.journal.put(job)
        self.registry.counter("serve_waves", "waves").inc()
        log.info("serve: wave %d: %d job(s), %d reads", wave, len(batch),
                 sum(len(j.records) for j in batch))
        d0 = sum(self.registry.counter("resilience_demotions",
                                       "demotions").series.values())
        t0 = time.monotonic()
        with self._lock:
            self._wave_state = {"wave": wave, "jobs": len(batch),
                                "t0": t0}
        try:
            outcome = self.waves.run_wave(wave, batch, self._finalize)
        except Exception as e:                # noqa: BLE001 — wave death
            self._wave_died(batch, e)
            return True
        finally:
            with self._lock:
                self._wave_state = None
        dt = time.monotonic() - t0
        done_bases = sum(j.n_bases for j in batch if j.terminal)
        self.admission.observe_rate(done_bases, dt)
        d1 = sum(self.registry.counter("resilience_demotions",
                                       "demotions").series.values())
        if d1 > d0:
            with self._lock:
                for t in {j.tenant for j in batch}:
                    self._demotions[t] = (self._demotions.get(t, 0)
                                          + int(d1 - d0))
        if outcome == "drained":
            with self._lock:
                for job in batch:
                    if not job.terminal:
                        # journaled for --resume: status 'running' with
                        # its wave id; the restart re-runs the wave and
                        # replays its completed buckets
                        self.journal.put(job)
            log.info("serve: drain requested — wave %d stopped at a "
                     "bucket boundary; %d job(s) journaled for resume",
                     wave, sum(1 for j in batch if not j.terminal))
        return True

    def _wave_died(self, batch: List[Job], exc: BaseException) -> None:
        head = (str(exc).splitlines() or [""])[0][:160]
        self.registry.counter("serve_wave_deaths", "waves").inc()
        log.warning("serve: wave died (%s: %s) — retrying its jobs",
                    type(exc).__name__, head)
        with self._lock:
            for job in batch:
                if job.terminal:
                    continue                  # completed before the death
                if job.attempts > self.cfg.job_retries:
                    self._finalize(
                        job, "failed",
                        f"worker died and retries exhausted "
                        f"(attempts {job.attempts}): {head}")
                else:
                    job.status = "accepted"
                    self.journal.put(job)
                    self._queue.insert(0, job.job_id)
            self._wake.notify_all()

    def _worker_loop(self) -> None:
        try:
            while True:
                if self._drain.is_set():
                    break
                did = self.pump()
                if self._drain.is_set():
                    break
                if not did:
                    with self._wake:
                        if not self._queue and not self._drain.is_set():
                            self._wake.wait(timeout=0.1)
            self._drain_clean = True
        except Exception:                     # noqa: BLE001
            log.exception("serve: worker loop died")
            self._drain_clean = False
        finally:
            self._drained.set()

    # -- drain / lifecycle -------------------------------------------------
    def drain(self) -> None:
        """Request a graceful drain: the in-flight bucket finishes, the
        wave journals the rest, no new waves start, submissions reject
        with reason 'draining'."""
        self._drain.set()
        with self._wake:
            self._wake.notify_all()

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> graceful drain (main thread only)."""
        import signal

        def _h(signum, frame):
            log.warning("serve: signal %d — draining", signum)
            self.drain()
        signal.signal(signal.SIGTERM, _h)
        signal.signal(signal.SIGINT, _h)

    def start(self, worker: bool = True) -> None:
        """Background mode: (if configured) socket listener thread plus,
        with ``worker=True``, the correction worker thread. Tests and
        the smoke gate the worker (``worker=False`` + a later
        :meth:`start_worker`) so submissions queue deterministically.
        Use :meth:`join` to wait for drain."""
        if self.cfg.socket_path and self._listener is None:
            self._listen()
            t = threading.Thread(target=self._accept_loop,
                                 name="proovread-serve-listener",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        if worker:
            self.start_worker()

    def start_worker(self) -> None:
        t = threading.Thread(target=self._worker_loop,
                             name="proovread-serve-worker", daemon=True)
        t.start()
        self._threads.append(t)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait until the worker has drained; then close the listener, wait
        for the server's threads to end and write the SLO artifact.
        Returns drain cleanliness."""
        if not self._drained.wait(timeout):
            raise TimeoutError("server did not drain in time")
        self._close_listener()
        self.join_threads()
        if self.cfg.slo_path:
            self.write_slo(self.cfg.slo_path)
        return self._drain_clean

    def join_threads(self, timeout: float = 5.0) -> None:
        """Wait, up to ``timeout`` s each, for the listener and worker
        threads to end. A thread still running (the listener polls its
        socket every 0.2 s) holds the server, and with it its pipelines'
        short-read sets on the card, past a shutdown."""
        me = threading.current_thread()
        for t in self._threads:
            if t is not me:
                t.join(timeout)

    def serve_forever(self) -> bool:
        """Foreground mode (the CLI): listener thread + worker loop in
        the calling thread, so SIGTERM lands while the main thread runs
        Python and the drain is prompt."""
        if self.cfg.socket_path:
            self._listen()
            t = threading.Thread(target=self._accept_loop,
                                 name="proovread-serve-listener",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self._worker_loop()
        self._close_listener()
        if self.cfg.slo_path:
            self.write_slo(self.cfg.slo_path)
        return self._drain_clean

    # -- socket transport --------------------------------------------------
    def _listen(self) -> None:
        path = self.cfg.socket_path
        try:
            os.unlink(path)
        except OSError:
            pass
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(path)
        self._listener.listen(16)
        self._listener.settimeout(0.2)
        log.info("serve: listening on %s", path)

    def _close_listener(self) -> None:
        if self._listener is not None:
            try:
                self._listener.close()
            finally:
                self._listener = None
            try:
                os.unlink(self.cfg.socket_path)
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._drained.is_set():
            lst = self._listener
            if lst is None:
                return
            try:
                conn, _ = lst.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            fh = conn.makefile("rwb")
            while True:
                try:
                    line = read_line(fh)
                except ValueError as e:
                    fh.write(json.dumps(
                        {"ok": False, "error": str(e)}).encode() + b"\n")
                    fh.flush()
                    return
                if line is None:
                    return
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    # a garbage LINE is a wire-protocol error, not a
                    # rejected submission — it never identified itself as
                    # a submit op, so it must not move the SLO rejection
                    # counters (those count submissions only)
                    resp = {"ok": False, "error": f"bad JSON: {e}"}
                except Exception:             # noqa: BLE001
                    resp = {"ok": False, "error": "internal"}
                else:
                    try:
                        resp = self.handle(req)
                    except Exception as e:    # noqa: BLE001
                        log.exception("serve: handler error")
                        resp = {"ok": False,
                                "error": f"internal: {type(e).__name__}"}
                try:
                    fh.write(json.dumps(resp).encode() + b"\n")
                    fh.flush()
                except (BrokenPipeError, OSError):
                    return

    # -- SLO artifact ------------------------------------------------------
    def slo_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            jobs = list(self._jobs.values())
            rejections = dict(self._rejections)
            demotions = dict(self._demotions)
            depth_final = len(self._queue) + sum(
                1 for j in jobs if j.status == "running")
        counts = {s: sum(1 for j in jobs if j.status == s)
                  for s in ("completed", "failed", "cancelled", "expired")}
        journaled = sum(1 for j in jobs if not j.terminal)
        lat: Dict[str, List[float]] = {}
        for j in jobs:
            if j.status != "completed":
                continue
            v = j.latency_s()
            if v is None:
                continue
            lat.setdefault(
                length_class(max((len(r) for r in j.records), default=0)),
                []).append(v)
        latency = {
            cls: {"count": len(vs),
                  "p50_s": round(float(np.percentile(vs, 50)), 6),
                  "p99_s": round(float(np.percentile(vs, 99)), 6),
                  "max_s": round(float(max(vs)), 6)}
            for cls, vs in sorted(lat.items())}
        # the kernel library's build windows (module docstring): the cold
        # side of the serving lifetime; nothing is traced, so no warm side
        from proovread_tpu_torch.obs.validate import SLO_SCHEMA_VERSION
        c = kernels.census()
        return {
            "slo_schema": SLO_SCHEMA_VERSION,
            "jobs": {"accepted": len(jobs), "rejected":
                     sum(rejections.values()), "journaled": journaled,
                     **counts},
            "rejections": rejections,
            "queue": {"depth_peak": self.admission.depth_peak,
                      "depth_final": depth_final},
            "latency": latency,
            "demotions": demotions,
            "compile": {"n_programs": c["n_programs"],
                        "backend_compiles": kernels.build_windows,
                        "backend_compile_s": round(
                            kernels.build_window_seconds, 6),
                        "tracing_hits": 0, "tracing_misses": 0,
                        "tracing_hit_rate": None},
            "drain": {"requested": self._drain.is_set(),
                      "clean": self._drain_clean},
        }

    def write_slo(self, path: str) -> None:
        snap = self.slo_snapshot()
        with open(path + ".tmp", "w") as fh:
            json.dump(snap, fh, indent=2, sort_keys=True)
            fh.write("\n")
        os.replace(path + ".tmp", path)
        log.info("serve: SLO artifact -> %s", path)
