"""Per-tenant admission control: bounded queues, quotas, backpressure
(port of ``proovread_tpu/serve/admission.py``).

The reference's overload story was the SGE queue's problem; a long-lived
service must solve it itself, and the failure mode to design out is
*unbounded buffering* — accepting work faster than the corrector drains
it until the host OOMs. Admission here is a hard gate at submit time:

* every tenant has a quota (:class:`TenantQuota`): max jobs and max
  bases simultaneously *held* (queued + running, until terminal);
* a submission over quota is REJECTED explicitly with a reason and a
  ``retry_after_s`` hint derived from the corrector's observed drain
  rate — the client owns the retry, the server holds no backlog beyond
  the bounded queues;
* accounting is release-on-terminal, so a failed/cancelled/expired job
  frees its tenant's budget exactly once.

Rejection reasons are closed-vocabulary (:data:`REJECT_REASONS`) and
counted per reason in the SLO artifact (``obs/validate.py:validate_slo``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


REJECT_REASONS = (
    "quota-jobs",        # tenant holds max_jobs already
    "quota-bases",       # tenant holds max_bases already
    "queue-full",        # server-wide queued-job bound
    "parse-error",       # malformed submission (bad JSON shape / payload)
    "bad-request",       # well-formed but invalid (dup ids, bad mode, ...)
    "duplicate-job",     # job_id already known
    "draining",          # server is draining; resubmit after restart
)


@dataclass
class TenantQuota:
    max_jobs: int = 8                # jobs held (queued + running)
    max_bases: int = 4_000_000       # bases held across those jobs
    max_server_jobs: int = 64        # server-wide held-job bound


class AdmissionController:
    """Thread-safe held-work accounting. ``try_admit`` either charges the
    tenant and returns ``(True, "", 0.0)`` or returns
    ``(False, reason, retry_after_s)`` without side effects."""

    def __init__(self, quota: Optional[TenantQuota] = None):
        self.quota = quota or TenantQuota()
        self._lock = threading.Lock()
        self._jobs: Dict[str, int] = {}
        self._bases: Dict[str, int] = {}
        self.depth_peak = 0
        # drain-rate estimate (bases/s EMA) feeding retry_after hints;
        # updated by the server after each wave
        self._rate_bps = 0.0

    # -- rate / hints -----------------------------------------------------
    def observe_rate(self, bases: int, seconds: float) -> None:
        if seconds <= 0 or bases <= 0:
            return
        inst = bases / seconds
        with self._lock:
            self._rate_bps = (inst if self._rate_bps == 0.0
                              else 0.7 * self._rate_bps + 0.3 * inst)

    def retry_after_s(self, extra_bases: int = 0) -> float:
        """How long until the currently-held work (plus ``extra_bases``)
        should have drained — clamped to [0.5s, 60s] so the hint is
        always actionable even before any rate is observed."""
        with self._lock:
            held = sum(self._bases.values()) + extra_bases
            rate = self._rate_bps
        if rate <= 0:
            return 2.0
        return float(min(60.0, max(0.5, held / rate)))

    # -- admission --------------------------------------------------------
    def held_jobs(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is None:
                return sum(self._jobs.values())
            return self._jobs.get(tenant, 0)

    def held_bases(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is None:
                return sum(self._bases.values())
            return self._bases.get(tenant, 0)

    def try_admit(self, tenant: str, n_bases: int
                  ) -> Tuple[bool, str, float]:
        q = self.quota
        with self._lock:
            if sum(self._jobs.values()) >= q.max_server_jobs:
                reason = "queue-full"
            elif self._jobs.get(tenant, 0) >= q.max_jobs:
                reason = "quota-jobs"
            elif self._bases.get(tenant, 0) + n_bases > q.max_bases:
                reason = "quota-bases"
            else:
                self._jobs[tenant] = self._jobs.get(tenant, 0) + 1
                self._bases[tenant] = self._bases.get(tenant, 0) + n_bases
                self.depth_peak = max(self.depth_peak,
                                      sum(self._jobs.values()))
                return True, "", 0.0
        return False, reason, self.retry_after_s(extra_bases=n_bases)

    def charge(self, tenant: str, n_bases: int) -> None:
        """Unconditional charge, bypassing the quota gate: resume re-holds
        jobs that were admitted in a previous lifetime — rejecting them
        now would lose accepted work."""
        with self._lock:
            self._jobs[tenant] = self._jobs.get(tenant, 0) + 1
            self._bases[tenant] = self._bases.get(tenant, 0) + n_bases
            self.depth_peak = max(self.depth_peak,
                                  sum(self._jobs.values()))

    def release(self, tenant: str, n_bases: int) -> None:
        """Job reached a terminal state: free its tenant's budget."""
        with self._lock:
            self._jobs[tenant] = max(0, self._jobs.get(tenant, 0) - 1)
            self._bases[tenant] = max(0,
                                      self._bases.get(tenant, 0) - n_bases)
