"""Fault-isolated pipeline execution: the per-bucket degradation ladder and
the checkpoint/resume journal.

Port of ``proovread_tpu/pipeline/resilience.py``. The pipeline runs every
length bucket in one process, so without this module one device fault
(a CUDA out-of-memory, a fault injected at a pass) would kill the whole run
and throw away every finished bucket. It gives back the reference's two
properties at the length-bucket granularity:

**Degradation ladder** (:data:`LADDER`): a bucket that raises a *device*
fault (:func:`classify_fault`: out of memory, a fault of a rung's device
program, or a wall-clock timeout from :func:`soft_deadline`) is retried at
the next-cheaper regime instead of aborting the run:

    fused      the normal schedule (passes 2..N in ``fused_iterations``)
    eager      the per-pass loop (``DeviceCorrector.correct_pass`` a pass)
    chunk-halved
               the eager loop with ``device_chunk`` halved: every per-launch
               allocation halves. The reference also forces its VMEM-budget
               pileup variant here (``windowed``); that is TPU layout and
               changes no output, so the port keeps the field as a no-op
    host-scan  the ``engine="scan"`` path (``pipeline/correct.py``): host
               seeding and admission, the ``sw`` kernel and torch votes;
               fault injection never fires there, so it always completes

Every demotion is recorded in the ``TaskReport`` stream (``task`` =
``demote-b<i>``, reason in ``note``) and in the ``resilience_demotions`` and
``device_faults`` counters, so degraded output is attributable, never
silent. Non-device exceptions (a ``ValueError`` from a shape bug, a
``KeyboardInterrupt``), a failed kernel build and a kernel's CUDA error are
NOT absorbed: they propagate, because retrying would mask a real defect.

**Checkpoint/resume journal** (:class:`CheckpointJournal`): after each
bucket completes, its corrected records, per-bucket reports, QC records and
the coverage-sampler rotation are written to ``<out>/.proovread_ckpt/``
(one atomic JSON file per bucket, keyed by a hash of the bucket's read ids,
all under a config/input fingerprint), in the reference's format. A crashed
or killed run restarted with ``--resume`` replays completed buckets from the
journal; the sampler rotation restores, so later buckets draw the same
short-read subsets and the output is byte-identical to an uninterrupted run.

The mesh rungs (``mesh_level``, ``classify_mesh_fault``) come with the
multi-device mesh.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import signal
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.kernels import KernelBuildError, KernelLaunchError
from proovread_tpu_torch.obs import metrics as obs_metrics
from proovread_tpu_torch.testing.faults import (BucketTimeout, InjectedFault,
                                                InjectedMeshFault,
                                                WallClockExceeded)

log = logging.getLogger("proovread_tpu_torch")


# --------------------------------------------------------------------------
# fault classification
# --------------------------------------------------------------------------

# the reference's message marks, verbatim (the same message classifies the
# same way in both packages), keyed by the ladder's fault taxonomy
_OOM_MARKS = ("RESOURCE_EXHAUSTED", "Out of memory", "OOM",
              "Attempting to allocate", "vmem", "VMEM")
_COMPILE_MARKS = ("remote_compile", "XLA compilation", "Compilation failure",
                  "compile", "INTERNAL")
_KERNEL_MARKS = ("Mosaic", "Pallas", "mosaic")
_TIMEOUT_MARKS = ("DEADLINE_EXCEEDED",)
_DEVICE_LOST_MARKS = ("device lost", "Device lost", "device is gone",
                      "failed to query device")
_COLLECTIVE_MARKS = ("collective", "all-reduce", "AllReduce", "NCCL",
                     "cross-replica")
# a CUDA error reported by torch (``CUDA error: an illegal memory access
# was encountered ... Compile with TORCH_USE_CUDA_DSA``): it may be sticky
# and poison the context, so it is never absorbed, whatever marks it holds
_CUDA_ERROR_MARKS = ("CUDA error", "CUDA kernel errors",
                     "illegal memory access", "device-side assert")


def _torch_error(name: str):
    """``torch.<name>`` where this torch has it, else None (imported here:
    the package's import of this module stays light)."""
    import torch
    return getattr(torch, name, None)


def classify_fault(exc: BaseException) -> Optional[str]:
    """Map an exception to a ladder fault kind (``compile`` / ``oom`` /
    ``kernel`` / ``timeout``), or ``None`` for exceptions the ladder must
    NOT absorb.

    The reference's rules, plus the card's: ``torch.OutOfMemoryError`` is
    ``oom`` (the counterpart of RESOURCE_EXHAUSTED; its message carries
    none of the marks); a failed kernel build (``KernelBuildError``), a
    kernel's CUDA error return (``KernelLaunchError``), torch's
    ``AcceleratorError`` and any other ``CUDA error`` are ``None``. Only
    runtime-class exceptions are eligible: a ``ValueError`` from a real
    shape bug never matches."""
    if isinstance(exc, (KernelBuildError, KernelLaunchError)):
        return None
    if isinstance(exc, WallClockExceeded):
        return None     # run-level budget breach: abort the run, not demote
    if isinstance(exc, InjectedMeshFault):
        return exc.kind
    if isinstance(exc, BucketTimeout):
        return "timeout"
    if isinstance(exc, InjectedFault):
        msg = str(exc)
        for marks, kind in ((_OOM_MARKS, "oom"), (_KERNEL_MARKS, "kernel"),
                            (_COMPILE_MARKS, "compile")):
            if any(s in msg for s in marks):
                return kind
        return "compile"
    oom = _torch_error("OutOfMemoryError")
    if oom is not None and isinstance(exc, oom):
        return "oom"
    if not isinstance(exc, RuntimeError):
        return None
    accel = _torch_error("AcceleratorError")
    msg = str(exc)
    if ((accel is not None and isinstance(exc, accel))
            or any(s in msg for s in _CUDA_ERROR_MARKS)):
        return None
    for marks, kind in ((_DEVICE_LOST_MARKS, "device_lost"),
                        (_COLLECTIVE_MARKS, "collective_timeout"),
                        (_TIMEOUT_MARKS, "timeout"), (_OOM_MARKS, "oom"),
                        (_KERNEL_MARKS, "kernel"),
                        (_COMPILE_MARKS, "compile")):
        if any(s in msg for s in marks):
            return kind
    return None


# --------------------------------------------------------------------------
# per-bucket wall-clock budget
# --------------------------------------------------------------------------

@contextmanager
def soft_deadline(seconds: Optional[float], what: str = "bucket",
                  exc: type = BucketTimeout):
    """Best-effort wall-clock budget around a blocking region: raises
    ``exc`` (default :class:`BucketTimeout`) after ``seconds``. No-op when
    ``seconds`` is falsy.

    On the MAIN thread the mechanism is SIGALRM (including nested-timer
    re-arming). On any OTHER thread, where signals never deliver, a daemon
    timer thread injects ``exc`` into the armed thread via
    ``PyThreadState_SetAsyncExc`` (:func:`_thread_deadline`), so ladder
    rungs keep their wall-clock budget off the main thread too.

    Run-level budgets must pass
    ``exc=WallClockExceeded`` so the degradation ladder does not mistake
    the run deadline for a per-bucket one and demote instead of aborting.

    Best-effort in both regimes because the interrupt lands between
    Python bytecodes, not inside a blocked C call: a thread blocked in a
    CUDA sync (``.item()``, ``synchronize``) raises only when the sync
    returns. Nesting composes: the
    SIGALRM path arms the inner timer at ``min(inner budget, outer
    remaining)`` — if the OUTER deadline falls due inside the inner
    region, the outer handler fires there and then (it is not suspended
    until the bucket exits) — and re-arms the outer timer with elapsed
    time subtracted on exit; the thread path leaves every enclosing timer
    armed and keeps a per-thread registry so a region exit revokes only
    its OWN pending injection and re-delivers the nearest enclosing
    deadline that already fired (see :func:`_thread_deadline` —
    simultaneous firings share one pending slot, latest wins)."""
    if not seconds or seconds <= 0:
        yield
        return
    if threading.current_thread() is not threading.main_thread():
        with _thread_deadline(seconds, what=what, exc=exc):
            yield
        return

    # cancel the (possible) outer timer first so we learn its remaining
    # time; it is re-armed below and in the finally block
    prev_delay, _ = signal.setitimer(signal.ITIMER_REAL, 0)
    start = time.monotonic()

    def _handler(signum, frame):
        if time.monotonic() - start >= seconds - 0.01:
            raise exc(f"{what}: soft wall-clock deadline of "
                      f"{seconds:.0f}s exceeded")
        # the OUTER deadline came due first: defer to its handler
        if callable(prev_handler):
            prev_handler(signum, frame)
        raise exc(f"{what}: enclosing wall-clock deadline exceeded")

    prev_handler = signal.signal(signal.SIGALRM, _handler)
    signal.setitimer(signal.ITIMER_REAL,
                     min(seconds, prev_delay) if prev_delay else seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev_handler)
        if prev_delay:
            remaining = max(0.001,
                            prev_delay - (time.monotonic() - start))
            signal.setitimer(signal.ITIMER_REAL, remaining)


# per-thread stack of armed async deadlines + the state whose injection
# currently occupies the thread's single pending async-exc slot (CPython
# keeps ONE pending exception per thread — the latest SetAsyncExc wins)
_ASYNC_DEADLINES_LOCK = threading.Lock()
_ASYNC_DEADLINES: dict = {}      # tid -> [state, ...] (outermost first)
_ASYNC_PENDING: dict = {}        # tid -> state owning the pending slot


def _async_inject(tid: int, exc) -> None:
    import ctypes
    ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(tid),
        ctypes.py_object(exc) if exc is not None else None)


@contextmanager
def _thread_deadline(seconds: float, what: str, exc: type):
    """Thread-safe deadline for non-main threads: a daemon
    ``threading.Timer`` injects ``exc`` into the armed thread with
    ``PyThreadState_SetAsyncExc`` once the monotonic deadline passes.

    The injected exception is the CLASS (CPython's async-exc contract),
    so it carries no message — callers match on type, which is all
    :func:`classify_fault` needs.

    Nesting: a thread has ONE pending async-exc slot, so simultaneous
    firings cannot both be pending — the latest firing wins the slot
    (an outer deadline falling due inside an inner region therefore
    fires there and then, like the SIGALRM path). The bookkeeping under
    ``_ASYNC_DEADLINES_LOCK`` keeps exits honest: a region exit revokes
    the pending injection only when it is its OWN (never an enclosing
    timer's), and re-injects the nearest enclosing deadline that has
    already fired — so an outer timeout that fired while the inner
    region was winding down is delivered in the outer region instead of
    being silently lost."""
    tid = threading.get_ident()
    state = {"live": True, "fired": False, "exc": exc}

    def _fire():
        with _ASYNC_DEADLINES_LOCK:
            if not state["live"]:
                return
            state["fired"] = True
            log.warning("%s: soft wall-clock deadline of %.0fs exceeded "
                        "(worker thread %d)", what, seconds, tid)
            _async_inject(tid, exc)
            _ASYNC_PENDING[tid] = state

    with _ASYNC_DEADLINES_LOCK:
        _ASYNC_DEADLINES.setdefault(tid, []).append(state)
    timer = threading.Timer(seconds, _fire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()
        with _ASYNC_DEADLINES_LOCK:
            state["live"] = False
            stack = _ASYNC_DEADLINES.get(tid, [])
            if state in stack:
                stack.remove(state)
            if not stack:
                _ASYNC_DEADLINES.pop(tid, None)
            if _ASYNC_PENDING.get(tid) is state:
                # revoke OUR injection if it has not been delivered yet
                # (delivery lands between bytecodes; if it already
                # raised, the NULL injection is a harmless no-op and the
                # exception propagates); then hand the slot to the
                # nearest enclosing deadline that fired in the meantime
                _async_inject(tid, None)
                _ASYNC_PENDING.pop(tid, None)
                for outer in reversed(stack):
                    if outer["fired"] and outer["live"]:
                        _async_inject(tid, outer["exc"])
                        _ASYNC_PENDING[tid] = outer
                        break


# --------------------------------------------------------------------------
# degradation ladder
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class LadderLevel:
    name: str
    fused: bool = False        # passes 2..N in fused_iterations allowed
    chunk_div: int = 1         # device_chunk divisor
    # the reference's VMEM-budget pileup variant: TPU layout only, it
    # changes no output, so the port runs the same kernels at this rung
    windowed: bool = False
    host: bool = False         # the engine="scan" path


LADDER: Tuple[LadderLevel, ...] = (
    LadderLevel("fused", fused=True),
    LadderLevel("eager"),
    LadderLevel("chunk-halved", chunk_div=2, windowed=True),
    LadderLevel("host-scan", host=True),
)


# --------------------------------------------------------------------------
# checkpoint/resume journal
# --------------------------------------------------------------------------

def run_fingerprint(cfg, long_ids: Sequence[str], n_short: int) -> str:
    """Identity of a run for journal validity: the inputs (long-read ids +
    short-read count) and every config knob that changes corrected output.
    A mismatched fingerprint means the journal answers a different question
    — it is ignored (with a warning), never silently replayed.

    The mesh knobs (``mesh_shards``, ``mesh_chunks_per_shard``,
    ``mesh_pass_timeout``) are deliberately ABSENT: journal entries are
    keyed by read content (:func:`bucket_key`), never by shard slot, and
    per-shard execution is exact over reads — so a journal written at
    mesh=4 must replay byte-identically at mesh=2 or on a single chip
    (mesh-shape-invariant resume). The port's ``PipelineConfig.device``
    is absent too: a journal written on the card resumes on the CPU and
    the other way round, and equals the JAX package's for the same run."""
    knobs = {
        "mode": cfg.mode, "n_iterations": cfg.n_iterations,
        "sr_coverage": cfg.sr_coverage,
        "finish_coverage": cfg.finish_coverage,
        "coverage": cfg.coverage,
        "mask_shortcut_frac": cfg.mask_shortcut_frac,
        "mask_min_gain_frac": cfg.mask_min_gain_frac,
        "sampling": cfg.sampling,
        "sr_chunk_number": cfg.sr_chunk_number,
        "sr_chunk_step": cfg.sr_chunk_step,
        "sr_trim": cfg.sr_trim,
        "engine": cfg.engine,
        "batch_reads": cfg.batch_reads,
        "device_chunk": cfg.device_chunk,
        "host_chunk_rows": cfg.host_chunk_rows,
        "seed_stride": cfg.seed_stride,
        "haplo_coverage": cfg.haplo_coverage,
        "indel_taboo_length": cfg.indel_taboo_length,
        "coverage_scale": cfg.coverage_scale,
        # dataclass knobs go in by repr (stable field order): masking and
        # the mapper schedule both change consensus output directly
        "hcr_mask": repr(cfg.hcr_mask),
        "hcr_mask_late": repr(cfg.hcr_mask_late),
        "align_schedule": repr(sorted(
            (k, repr(v)) for k, v in (cfg.align_schedule or {}).items())),
        "n_long": len(long_ids), "n_short": n_short,
    }
    h = hashlib.sha256(json.dumps(knobs, sort_keys=True).encode())
    for rid in long_ids:
        h.update(rid.encode())
        h.update(b"\0")
    return h.hexdigest()[:32]


def bucket_key(records: Sequence[SeqRecord]) -> str:
    """Content key of one bucket: hash of its (ordered) read ids. Stable
    across runs of the same input; a changed bucket partition (different
    batch_reads, different inputs) simply misses."""
    h = hashlib.sha1()
    for r in records:
        h.update(r.id.encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def _encode_qual(qual: Optional[np.ndarray]) -> Optional[str]:
    if qual is None:
        return None
    return base64.b64encode(np.asarray(qual, np.uint8).tobytes()).decode()


def _decode_qual(s: Optional[str]) -> Optional[np.ndarray]:
    if s is None:
        return None
    return np.frombuffer(base64.b64decode(s), np.uint8).copy()


class CheckpointJournal:
    """Append-only per-bucket journal under ``<dir>/``.

    Layout: ``meta.json`` (run fingerprint) + one ``bucket_<key>.json`` per
    completed bucket, written atomically (tmp + ``os.replace``) so a kill
    mid-write leaves either the old state or the new state, never a torn
    file. A torn/unparseable entry is skipped at load, costing only that
    bucket's recompute.

    What is stored per record is exactly what the post-bucket-loop stages
    consume: id/seq/qual/desc (the untrimmed output + quality-window trim)
    and the chimera breakpoints (the trim split). The auxiliary
    ``ConsensusResult`` fields (freqs/coverage/cigar/emit_counts) are
    consumed *during* the bucket and are not persisted; replayed buckets
    carry empty ones."""

    META = "meta.json"

    def __init__(self, path: str, fingerprint: str, resume: bool):
        self.path = path
        self.fingerprint = fingerprint
        self.hits = 0
        self.entries = {}
        os.makedirs(path, exist_ok=True)
        meta_path = os.path.join(path, self.META)
        stale = False
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as fh:
                    meta = json.load(fh)
                stale = meta.get("fingerprint") != fingerprint
            except (OSError, json.JSONDecodeError):
                stale = True
        if stale:
            if resume:
                log.warning(
                    "resume: checkpoint journal at %s was written by a "
                    "different run (inputs or config changed) — ignoring "
                    "it and starting fresh", path)
            self._clear()
        with open(meta_path + ".tmp", "w") as fh:
            json.dump({"fingerprint": fingerprint,
                       "format": 1}, fh)
        os.replace(meta_path + ".tmp", meta_path)
        if resume and not stale:
            self._load()

    def _clear(self) -> None:
        for name in os.listdir(self.path):
            if name.startswith("bucket_") and name.endswith(".json"):
                try:
                    os.unlink(os.path.join(self.path, name))
                except OSError:
                    pass

    def _load(self) -> None:
        for name in sorted(os.listdir(self.path)):
            if not (name.startswith("bucket_") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.path, name)) as fh:
                    e = json.load(fh)
                self.entries[e["key"]] = e
            except (OSError, json.JSONDecodeError, KeyError):
                log.warning("resume: skipping torn journal entry %s", name)

    # -- write ------------------------------------------------------------
    def put(self, key: str, bucket: int, results: Sequence, chim: Sequence,
            reports: Sequence, sampler_first_chunk: int,
            qc_records: Optional[Sequence] = None) -> None:
        """``qc_records``: the bucket's per-read QC provenance records
        (obs/qc.py JSON-safe dicts), persisted so a ``--resume`` replay
        reproduces the ``--qc-out`` artifact byte-identically. ``None``
        (QC off) writes no ``qc`` key; a later QC-on resume then treats
        the entry as a miss (``get(require_qc=True)``) rather than
        replaying a bucket whose provenance was never recorded."""
        entry = {
            "key": key, "bucket": bucket,
            "sampler_first_chunk": int(sampler_first_chunk),
            "records": [{
                "id": r.record.id, "seq": r.record.seq,
                "desc": r.record.desc,
                "qual": _encode_qual(r.record.qual),
                "chimera": [[int(f), int(t), float(s)]
                            for (f, t, s) in r.chimera],
            } for r in results],
            "chim": [[rid, int(f), int(t), float(s)]
                     for (rid, f, t, s) in chim],
            "reports": [{
                "task": rep.task, "masked_frac": rep.masked_frac,
                "n_candidates": int(rep.n_candidates),
                "n_admitted": int(rep.n_admitted),
                "n_dropped_cap": int(rep.n_dropped_cap),
                "n_dropped_cov": int(rep.n_dropped_cov),
                "note": rep.note,
            } for rep in reports],
        }
        if qc_records is not None:
            entry["qc"] = list(qc_records)
        dst = os.path.join(self.path, f"bucket_{key}.json")
        with open(dst + ".tmp", "w") as fh:
            json.dump(entry, fh)
        os.replace(dst + ".tmp", dst)
        self.entries[key] = entry
        obs_metrics.counter("checkpoint_journal_writes",
                            unit="buckets").inc()

    # -- read -------------------------------------------------------------
    def get(self, key: str, require_qc: bool = False):
        """Returns (results, chim, reports, sampler_first_chunk,
        qc_records-or-None) or None. ``require_qc`` treats an entry
        without stored QC records as a miss (checked BEFORE the hit is
        counted, so a forced recompute never inflates the replay KPIs).
        The driver's types are imported here: the driver imports this
        module."""
        e = self.entries.get(key)
        if e is None:
            return None
        if require_qc and e.get("qc") is None:
            log.info("resume: journal entry for bucket %s has no QC "
                     "records (written by a QC-off run) — recomputing",
                     e.get("bucket"))
            return None
        from proovread_tpu_torch.consensus.engine import ConsensusResult
        from proovread_tpu_torch.pipeline.driver import TaskReport

        _empty = np.zeros(0, np.float32)
        results = [ConsensusResult(
            record=SeqRecord(id=r["id"], seq=r["seq"],
                             qual=_decode_qual(r["qual"]),
                             desc=r.get("desc", "")),
            freqs=_empty, coverage=_empty, cigar="",
            chimera=[(f, t, s) for (f, t, s) in r["chimera"]],
        ) for r in e["records"]]
        chim = [(rid, f, t, s) for (rid, f, t, s) in e["chim"]]
        reports = [TaskReport(
            task=rep["task"], masked_frac=rep["masked_frac"],
            n_candidates=rep["n_candidates"], n_admitted=rep["n_admitted"],
            n_dropped_cap=rep.get("n_dropped_cap", 0),
            n_dropped_cov=rep.get("n_dropped_cov", 0),
            note=rep.get("note", ""),
        ) for rep in e["reports"]]
        self.hits += 1
        obs_metrics.counter("checkpoint_journal_replays",
                            unit="buckets").inc()
        return (results, chim, reports, e["sampler_first_chunk"],
                e.get("qc"))
