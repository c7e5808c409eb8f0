"""Job state + the job-level journal (port of
``proovread_tpu/serve/jobs.py``).

A job's lifecycle is a strict state machine — **no job is ever silently
lost** (the serving acceptance bar)::

    submit -> rejected (quota / backpressure / parse; never stored)
           -> accepted -> running -> completed
                                  -> failed     (retries exhausted, or
                                                 journal corruption)
                                  -> cancelled  (client cancel)
                                  -> expired    (per-job deadline breach)

``accepted`` and ``running`` are the *journaled* states: a SIGTERM or
kill leaves them on disk under ``<state>/jobs/`` (one atomic JSON file
per job, written to a temporary file and ``os.replace``d), and a restart with
``--resume`` re-queues them — ``running`` jobs keep their wave
assignment, so the rebuilt wave replays its completed buckets from the
wave's :class:`~proovread_tpu_torch.pipeline.resilience.CheckpointJournal`
byte-identically. A journal entry that fails to parse at load (simulated
by the ``journal`` fault site, ``testing/faults.py``) surfaces as a job
in state ``failed`` with reason ``journal-corrupt`` — detected, named,
never dropped.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.serve.protocol import decode_records, encode_records

log = logging.getLogger("proovread_tpu_torch")

TERMINAL_STATES = ("completed", "failed", "cancelled", "expired")
JOURNALED_STATES = ("accepted", "running")


@dataclass
class Job:
    job_id: str
    tenant: str
    mode: str                        # clr | ccs | unitig
    records: List[SeqRecord]
    seq: int                         # submission ordinal (fault addressing)
    submitted_mono: float = field(default_factory=time.monotonic)
    deadline_s: Optional[float] = None
    deadline_mono: Optional[float] = None   # armed at accept / re-armed at resume
    status: str = "accepted"
    reason: str = ""
    attempts: int = 0
    wave: Optional[int] = None
    cancel_requested: bool = False
    # -- wave-scoped bookkeeping (rebuilt per attempt, never persisted) --
    # read ids this job contributes to the wave (post-CCS-collapse,
    # post-stubby-filter) and the corrected results collected so far
    live_ids: List[str] = field(default_factory=list)
    ignored: List[Tuple[str, str]] = field(default_factory=list)
    results: Dict[str, Any] = field(default_factory=dict)
    ccs_records: Optional[List[SeqRecord]] = None
    # -- terminal payload -------------------------------------------------
    result: Optional[Dict[str, Any]] = None
    finished_mono: Optional[float] = None
    loaded_latency_s: Optional[float] = None    # from a previous lifetime

    @property
    def n_bases(self) -> int:
        return sum(len(r) for r in self.records)

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL_STATES

    def arm_deadline(self) -> None:
        if self.deadline_s is not None:
            self.deadline_mono = time.monotonic() + self.deadline_s

    def deadline_breached(self) -> bool:
        return (self.deadline_mono is not None
                and time.monotonic() > self.deadline_mono)

    def reset_wave_state(self) -> None:
        """A retried job recomputes everything wave-scoped from its
        original payload — partial results of a dead wave are discarded,
        the retry's bucket-journal replay rebuilds them byte-identically."""
        self.live_ids = []
        self.ignored = []
        self.results = {}

    def latency_s(self) -> Optional[float]:
        if self.finished_mono is not None:
            return self.finished_mono - self.submitted_mono
        return self.loaded_latency_s


def _san(job_id: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]", "_", job_id)[:80]


class JobJournal:
    """One atomic JSON file per job under ``dir`` — named by submission
    ordinal + sanitized id so load order is submission order. ``faults``
    (a ``FaultPlan``) drives the ``journal`` corruption site: after a
    matching job's non-terminal entry is written, the file is truncated
    mid-byte — the simulated torn sector the atomic rename cannot guard
    against. Load NEVER raises on a corrupt entry: it returns the job id
    in the ``corrupt`` list so the server can surface it as a failed job
    with an attributable reason."""

    def __init__(self, path: str, faults=None):
        self.path = path
        self.faults = faults
        os.makedirs(path, exist_ok=True)

    def _file(self, job: Job) -> str:
        return os.path.join(self.path,
                            f"job_{job.seq:06d}_{_san(job.job_id)}.json")

    def put(self, job: Job) -> None:
        entry = {
            "job_id": job.job_id, "tenant": job.tenant, "mode": job.mode,
            "seq": job.seq, "status": job.status, "reason": job.reason,
            "attempts": job.attempts, "wave": job.wave,
            "deadline_s": job.deadline_s,
            "records": encode_records(job.records),
            "result": job.result,
            "latency_s": job.latency_s(),
        }
        dst = self._file(job)
        with open(dst + ".tmp", "w") as fh:
            json.dump(entry, fh)
        os.replace(dst + ".tmp", dst)
        if (self.faults is not None and job.status in JOURNALED_STATES
                and self.faults.fires_job(job.seq, "journal")):
            # simulated disk corruption: chop the entry mid-object
            with open(dst, "r+b") as fh:
                fh.truncate(max(1, os.path.getsize(dst) // 2))
            log.warning("fault injection: journal entry for job %r "
                        "corrupted on disk", job.job_id)

    def load(self) -> Tuple[List[Job], List[Tuple[str, str, int]]]:
        """-> (jobs in submission order, corrupt entries as
        ``(job_id, filename, seq)``). Terminal jobs come back with their
        result payload (the ``result`` op keeps working across a
        restart); accepted/running jobs come back ready to requeue,
        deadlines re-armed from scratch (an operator restart grants the
        full budget again). Corrupt entries never
        raise: the server quarantines them and surfaces the job as
        failed/``journal-corrupt``."""
        jobs: List[Job] = []
        corrupt: List[Tuple[str, str, int]] = []
        for name in sorted(os.listdir(self.path)):
            m = re.match(r"^job_(\d+)_(.+)\.json$", name)
            if not m:
                continue
            try:
                with open(os.path.join(self.path, name)) as fh:
                    e = json.load(fh)
                job = Job(
                    job_id=e["job_id"], tenant=e["tenant"], mode=e["mode"],
                    records=decode_records(e["records"]), seq=e["seq"],
                    deadline_s=e.get("deadline_s"),
                    status=e["status"], reason=e.get("reason", ""),
                    attempts=e.get("attempts", 0), wave=e.get("wave"),
                    result=e.get("result"),
                )
                job.loaded_latency_s = e.get("latency_s")
            except (OSError, ValueError, KeyError, TypeError) as exc:
                log.warning("resume: job journal entry %s is corrupt "
                            "(%s) — surfacing the job as failed", name,
                            exc)
                corrupt.append((m.group(2), name, int(m.group(1))))
                continue
            if job.status in JOURNALED_STATES:
                job.arm_deadline()
            jobs.append(job)
        return jobs, corrupt

    def quarantine(self, filename: str) -> None:
        """Move a corrupt entry aside (kept for forensics, never
        reloaded) so the failed tombstone written in its place is what
        the next restart sees."""
        src = os.path.join(self.path, filename)
        try:
            os.replace(src, src + ".corrupt")
        except OSError:
            pass
