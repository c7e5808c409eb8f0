"""Correction as a service: the long-lived serving layer (port of
``proovread_tpu/serve``).

``CorrectionServer`` accepts streaming FASTQ jobs over a local-socket
JSONL protocol, admits reads from *different* jobs into the driver's
length buckets (continuous batching: the short-read set stays on the card
across waves), and wraps every job in a robustness envelope: bounded
per-tenant queues with explicit backpressure, per-tenant quota
accounting, per-job deadlines and cancellation that unwind at bucket
boundaries, graceful drain on SIGTERM (finish the in-flight bucket,
journal the rest), and job-level retry/resume backed by the checkpoint
journal so a killed server restarted with ``--resume`` replays journaled
jobs byte-identically. ``FleetDispatcher`` runs several replicas in one
process, on one card.

The batch CLI imports NOTHING from this package
(``tests/test_torch_serve.py`` holds it) — serving costs nothing when not
serving.
"""

from proovread_tpu_torch.serve.admission import AdmissionController, TenantQuota
from proovread_tpu_torch.serve.jobs import Job, JobJournal, TERMINAL_STATES
from proovread_tpu_torch.serve.protocol import ServeClient
from proovread_tpu_torch.serve.server import CorrectionServer, ServeConfig

__all__ = [
    "AdmissionController", "TenantQuota",
    "Job", "JobJournal", "TERMINAL_STATES",
    "ServeClient",
    "CorrectionServer", "ServeConfig",
]
