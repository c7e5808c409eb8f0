"""Multi-replica fleet dispatcher (port of ``proovread_tpu/serve/fleet.py``).

``FleetDispatcher`` runs N in-process :class:`CorrectionServer` replicas
— each with its own ``AF_UNIX`` socket, state dir and worker thread —
and routes jobs to them over the SAME wire protocol every other client
uses (``serve/protocol.py``), never through an in-process shortcut. The
replicas share the process's one card: their worker threads launch the
kernels on their own current streams, and the kernel library is built
once (``kernels.lib``'s lock). With ``FleetConfig.artifact_dir`` the
fleet warm-boots from a kernel-build artifact (``analysis/factory.py``):
verified before any state is written, fetched and verified once into
``<state_dir>/artifact_cache``, the kernel build directory pointed at
the copy, and one BOOT row a replica in ``r<i>/boot.json``
(``obs/boot.py:artifact_boot``; on the card the first replica's row holds
the library's load, a cache hit).

Design decisions worth naming:

* **Placement is least-loaded by the `stats` verb** — the dispatcher
  asks each live replica for its SLO snapshot and routes to the
  smallest ``queue.depth_final`` (ties broken round-robin). No
  dispatcher-side shadow queue: the replicas' own admission gates stay
  the single source of backpressure truth, and an over-quota rejection
  is returned to the traffic source, not absorbed.
* **Health is probed, not assumed** — a heartbeat thread pings every
  replica (the extended ``ping``: replica id, monotonic uptime,
  in-flight wave state) and samples its SLO snapshot for the fleet
  scoreboard (``obs/load.py``). ``suspect_after`` consecutive probe
  failures declare the replica dead; a single timeout blip does not
  (the ``dispatch_timeout`` fault drill pins exactly that).
* **A dead replica's jobs are handed off, not lost** — its journal
  (the one-file-per-job :class:`JobJournal`) is read back from disk:
  terminal entries are adopted (completed results are recoverable from
  the journal payload), non-terminal entries are resubmitted to
  survivors with the original wire payload and the same job id. Every
  handoff is counted; a resubmission the survivors reject (quota,
  draining) becomes an explicit ``orphaned`` job — named, never
  dropped. ``obs/validate.py:validate_load`` pins the fleet-wide
  accounting identity across exactly these counters.
* **Replica death is simulated at the transport boundary** — ``kill``
  closes the listener socket (new connections fail immediately) and
  sets the drain flag, so the worker stops at the next bucket gate and
  journals in-flight jobs, exactly the on-disk state a SIGKILLed
  single-process server leaves behind. The dispatcher waits for the
  worker to stop before sweeping the journal, so a job can never be
  adopted as terminal AND resubmitted (no double count).

Fleet-scoped fault rules (``testing/faults.py`` grammar
``<kind>@r<replica>[.j<ordinal>]``) fire dispatcher-side:
``replica_death`` kills the replica at a dispatch ordinal (or at the
next heartbeat when unordinaled), ``stalled_drain`` makes ``drain_all``
pretend the drain request never landed (bounded wait, then kill +
journal sweep), ``dispatch_timeout`` fails a single heartbeat probe.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.pipeline.driver import PipelineConfig
from proovread_tpu_torch.serve.admission import TenantQuota
from proovread_tpu_torch.serve.jobs import JobJournal
from proovread_tpu_torch.serve.protocol import ServeClient
from proovread_tpu_torch.serve.server import (CorrectionServer, ServeConfig,
                                        length_class)
from proovread_tpu_torch.testing.faults import FaultPlan

log = logging.getLogger("proovread_tpu_torch")

# dispatcher-side disposition of one routed job; mirrors the server's
# terminal states plus the fleet-only 'orphaned' (handoff had no taker)
DISPATCH_TERMINAL = ("completed", "failed", "cancelled", "expired",
                     "orphaned")


@dataclass
class FleetConfig:
    state_dir: str
    n_replicas: int = 2
    quota: TenantQuota = field(default_factory=TenantQuota)
    max_wave_jobs: int = 4
    job_retries: int = 1
    heartbeat_s: float = 0.25        # probe + scoreboard sample period
    request_timeout_s: float = 30.0  # per wire request (submit/status)
    suspect_after: int = 2           # consecutive probe failures -> dead
    drain_timeout_s: float = 300.0   # graceful drain bound per replica
    stall_timeout_s: float = 2.0     # stalled drain -> kill escalation
    kill_wait_s: float = 120.0       # worker-stop bound after a kill
    handoff_attempts: int = 3        # resubmission tries per orphan risk
    # fleet-site fault spec (dispatcher-side; testing/faults.py). None
    # reads PROOVREAD_FLEET_FAULT so the smoke can be driven externally.
    fault_spec: Optional[str] = None
    # forwarded verbatim to every replica (job/device sites)
    replica_fault_spec: Optional[str] = None
    qc: bool = False
    # the kernel-build artifact every replica warm-boots from (module
    # docstring)
    artifact_dir: Optional[str] = None


class Replica:
    """One in-process server + its transport endpoints. The dispatcher
    talks to ``server`` ONLY via the socket while the replica is alive;
    in-process access is reserved for the coroner (post-mortem snapshot
    after the worker has provably stopped — the stand-in for reading a
    crashed process's state dir)."""

    def __init__(self, idx: int, state_dir: str, socket_path: str):
        self.idx = idx
        self.state_dir = state_dir
        self.socket_path = socket_path
        self.server: Optional[CorrectionServer] = None
        self.alive = False
        self.stalled = False
        self.fail_streak = 0
        self.dead_reason = ""
        self.final_slo: Optional[Dict[str, Any]] = None
        self.drain_clean: Optional[bool] = None

    @property
    def replica_id(self) -> str:
        return f"r{self.idx}"


class FleetDispatcher:
    def __init__(self, short_records: Sequence[SeqRecord],
                 config: FleetConfig,
                 pipeline_config: Optional[PipelineConfig] = None,
                 scoreboard: Any = None):
        if config.artifact_dir:
            # refused before any state is written
            from proovread_tpu_torch.obs.boot import verify_artifact
            verify_artifact(config.artifact_dir)
        self.cfg = config
        self.short_records = list(short_records)
        self.pipeline_config = pipeline_config
        # duck-typed: anything with .sample(t_mono, replica_idx, pong,
        # slo) — obs/load.FleetScoreboard; kept untyped to avoid an
        # obs -> serve -> obs import cycle
        self.scoreboard = scoreboard
        spec = (config.fault_spec if config.fault_spec is not None
                else os.environ.get("PROOVREAD_FLEET_FAULT"))
        self.faults = FaultPlan.from_spec(spec)
        if self.faults.active:
            log.warning("fleet: fault injection active: %d rule(s)",
                        len(self.faults.rules))

        os.makedirs(config.state_dir, exist_ok=True)
        self.replicas: List[Replica] = []
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._ordinal = 0            # fleet-wide dispatch ordinal
        self._rr = 0                 # placement tie-break rotation
        # books: one entry per routed (accepted-at-least-once) job —
        # the dispatcher's own ground truth for the unique-job identity
        self.books: Dict[str, Dict[str, Any]] = {}
        self.rejections: List[Dict[str, Any]] = []
        self.results: Dict[str, Dict[str, Any]] = {}
        self.handoffs = 0
        self.orphaned = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        manifest = None
        if self.cfg.artifact_dir:
            # the artifact is fetched and verified once for the fleet; the
            # kernel build directory points at the copy
            from proovread_tpu_torch.obs import boot as obs_boot
            from proovread_tpu_torch.obs import compilecache
            copy = os.path.join(self.cfg.state_dir, "artifact_cache")
            manifest = obs_boot.fetch_artifact(self.cfg.artifact_dir, copy)
            compilecache.enable_persistent_cache(copy)
            log.info("fleet: warm-boot artifact %s verified -> %s",
                     manifest["version"], copy)
        for i in range(self.cfg.n_replicas):
            rep = Replica(
                i, os.path.join(self.cfg.state_dir, f"r{i}"),
                os.path.join(self.cfg.state_dir, f"r{i}.sock"))
            scfg = ServeConfig(
                state_dir=rep.state_dir, socket_path=rep.socket_path,
                quota=self.cfg.quota,
                max_wave_jobs=self.cfg.max_wave_jobs,
                job_retries=self.cfg.job_retries,
                fault_spec=self.cfg.replica_fault_spec,
                qc=self.cfg.qc, replica_id=rep.replica_id)
            rep.server = CorrectionServer(self.short_records, scfg,
                                          self.pipeline_config)
            if manifest is not None:
                # one boot row a replica; the first loads the library
                _, row = obs_boot.artifact_boot(
                    rep.state_dir, artifact_dir=self.cfg.artifact_dir,
                    device=rep.server.pipeline_template.device,
                    replica=rep.replica_id, manifest=manifest)
                log.info("fleet: %s booted from artifact in %.3f s (%d "
                         "build window(s), %d violation(s))",
                         rep.replica_id, row["boot_wall_s"],
                         row["n_backend_compiles"], len(row["violations"]))
            rep.server.start(worker=True)
            rep.alive = True
            self.replicas.append(rep)
        log.info("fleet: %d replica(s) up under %s",
                 len(self.replicas), self.cfg.state_dir)
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="proovread-fleet-heartbeat",
            daemon=True)
        self._hb_thread.start()

    def close(self) -> None:
        """Stop the heartbeat and kill anything still alive (tests use
        this as a guard-rail teardown; normal shutdown is drain_all)."""
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
        for rep in self.replicas:
            if rep.alive:
                self._declare_dead(rep, "fleet closed", handoff=False)

    def _live(self) -> List[Replica]:
        return [r for r in self.replicas if r.alive]

    def _client(self, rep: Replica,
                timeout: Optional[float] = None) -> ServeClient:
        """Fresh connection per request: after a kill the listener
        socket is gone, so the very next connect raises — the dispatcher
        sees death at the transport, exactly like an out-of-process
        deployment would."""
        return ServeClient(rep.socket_path,
                           timeout=timeout or self.cfg.request_timeout_s)

    # -- health ------------------------------------------------------------
    def _probe_failed(self, rep: Replica, why: str) -> None:
        with self._lock:
            if not rep.alive:
                return
            rep.fail_streak += 1
            streak = rep.fail_streak
        log.warning("fleet: %s probe failure %d/%d (%s)",
                    rep.replica_id, streak, self.cfg.suspect_after, why)
        if streak >= self.cfg.suspect_after:
            self._declare_dead(
                rep, f"{streak} consecutive probe failures ({why})")

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            for rep in self._live():
                # unordinaled replica_death rules land on the next beat
                if self.faults.fires_fleet(rep.idx, "replica_death"):
                    self._declare_dead(
                        rep, "injected replica_death (heartbeat)")
                    continue
                if self.faults.fires_fleet(rep.idx, "dispatch_timeout"):
                    self._probe_failed(rep, "injected dispatch timeout")
                    continue
                try:
                    with self._client(rep, timeout=5.0) as c:
                        pong = c.ping()
                        slo = c.stats()["slo"]
                except (OSError, ValueError) as e:
                    self._probe_failed(rep, type(e).__name__)
                    continue
                with self._lock:
                    rep.fail_streak = 0
                if self.scoreboard is not None:
                    self.scoreboard.sample(now, rep.idx, pong, slo)
            self._stop.wait(self.cfg.heartbeat_s)

    # -- placement + dispatch ----------------------------------------------
    def _pick_replica(self) -> Optional[Replica]:
        """Least-loaded by the stats verb (queue.depth_final), ties
        rotated round-robin so an idle fleet still spreads work."""
        scored: List[Any] = []
        live = self._live()
        n = max(1, len(live))
        for rep in live:
            try:
                with self._client(rep, timeout=5.0) as c:
                    depth = c.stats()["slo"]["queue"]["depth_final"]
            except (OSError, ValueError) as e:
                self._probe_failed(rep, f"stats: {type(e).__name__}")
                continue
            scored.append((depth, (rep.idx - self._rr) % n, rep))
        if not scored:
            return None
        scored.sort(key=lambda t: (t[0], t[1]))
        self._rr += 1
        return scored[0][2]

    def dispatch(self, wire: Dict[str, Any], *, family: str = "clr",
                 expect_reject: Optional[str] = None) -> Dict[str, Any]:
        """Route one submission (the exact wire dict) to the
        least-loaded live replica. Returns the wire response augmented
        with ``replica``. Accepted jobs enter the books; rejections are
        recorded with their reason and whether the traffic source
        expected them (poison jobs do)."""
        with self._lock:
            jord = self._ordinal
            self._ordinal += 1
        # ordinaled replica_death rules fire at THIS dispatch, whatever
        # replica the job would have landed on — "the fleet dispatches
        # its Nth job and r1 drops dead mid-wave"
        for rep in self._live():
            if self.faults.fires_fleet(rep.idx, "replica_death",
                                       jord=jord):
                self._declare_dead(
                    rep, f"injected replica_death at dispatch "
                         f"ordinal {jord}")
        job_id = wire.get("job_id")
        # fleet-level duplicate detection: each replica only knows its
        # own job table, so a duplicate routed to a different replica
        # than the original would be accepted there — and would then
        # silently overwrite the original's book entry. The books ARE
        # the fleet-wide table; reject here, deterministically, before
        # routing.
        with self._lock:
            if job_id is not None and str(job_id) in self.books:
                self.rejections.append({
                    "job_id": str(job_id), "replica": None,
                    "family": family, "reason": "duplicate-job",
                    "expected": expect_reject is not None,
                    "expect_reject": expect_reject,
                })
                return {"ok": False, "reason": "duplicate-job",
                        "replica": None}
        last_err = "no live replica"
        for _ in range(max(1, len(self.replicas))):
            rep = self._pick_replica()
            if rep is None:
                break
            try:
                with self._client(rep) as c:
                    resp = c.request(wire)
            except (OSError, ValueError) as e:
                self._probe_failed(rep, f"submit: {type(e).__name__}")
                last_err = type(e).__name__
                continue
            return self._record_dispatch(rep, wire, resp, jord,
                                         family, expect_reject)
        log.error("fleet: dispatch of %r found no live replica (%s)",
                  job_id, last_err)
        return {"ok": False, "error": f"fleet-down: {last_err}",
                "replica": None}

    def _record_dispatch(self, rep: Replica, wire: Dict[str, Any],
                         resp: Dict[str, Any], jord: int, family: str,
                         expect_reject: Optional[str]) -> Dict[str, Any]:
        resp = dict(resp)
        resp["replica"] = rep.idx
        job_id = str(wire.get("job_id"))
        if resp.get("ok") and resp.get("status") == "accepted":
            reads = wire.get("reads") or []
            longest = max((len(r.get("seq") or "") for r in reads
                           if isinstance(r, dict)), default=0)
            n_bases = sum(len(r.get("seq") or "") for r in reads
                          if isinstance(r, dict))
            with self._lock:
                self.books[job_id] = {
                    "job_id": job_id, "tenant": wire.get("tenant"),
                    "family": family, "cls": length_class(longest),
                    "n_bases": n_bases, "replica": rep.idx,
                    "ordinal": jord, "wire": wire,
                    "submit_mono": time.monotonic(),
                    "finish_mono": None, "status": "accepted",
                    "reason": "", "handoffs": 0,
                }
        else:
            with self._lock:
                self.rejections.append({
                    "job_id": job_id, "replica": rep.idx,
                    "family": family,
                    "reason": resp.get("reason",
                                       resp.get("error", "unknown")),
                    "expected": expect_reject is not None,
                    "expect_reject": expect_reject,
                })
        return resp

    # -- completion tracking -----------------------------------------------
    def _outstanding(self) -> Dict[int, List[Dict[str, Any]]]:
        by_rep: Dict[int, List[Dict[str, Any]]] = {}
        with self._lock:
            for e in self.books.values():
                if e["status"] not in DISPATCH_TERMINAL:
                    by_rep.setdefault(e["replica"], []).append(e)
        return by_rep

    def poll_once(self) -> int:
        """One status sweep over every non-terminal booked job (one
        connection per replica). Completed scorable jobs fetch their
        result payload exactly once. Returns how many jobs are still
        outstanding afterwards."""
        for idx, entries in self._outstanding().items():
            rep = self.replicas[idx]
            if not rep.alive:
                continue                 # handoff owns these entries
            try:
                with self._client(rep) as c:
                    for e in entries:
                        st = c.status(e["job_id"])
                        if not st.get("ok") or not st.get("terminal"):
                            continue
                        payload = None
                        if st.get("status") == "completed":
                            payload = c.result(e["job_id"])
                        self._book_terminal(e, st.get("status"),
                                            st.get("reason", ""),
                                            payload)
            except (OSError, ValueError) as e2:
                self._probe_failed(rep, f"status: {type(e2).__name__}")
        return sum(len(v) for v in self._outstanding().values())

    def _book_terminal(self, entry: Dict[str, Any], status: str,
                       reason: str,
                       payload: Optional[Dict[str, Any]]) -> None:
        with self._lock:
            if entry["status"] in DISPATCH_TERMINAL:
                return
            entry["status"] = status
            entry["reason"] = reason
            entry["finish_mono"] = time.monotonic()
            if payload is not None and payload.get("ok"):
                self.results[entry["job_id"]] = payload

    def wait_all(self, timeout: float = 600.0,
                 poll_s: float = 0.1) -> None:
        """Poll until every booked job reaches a dispatcher-terminal
        state (including 'orphaned'). Raises on timeout — a hung fleet
        must fail loudly, not report a partial scoreboard."""
        t0 = time.monotonic()
        while True:
            left = self.poll_once()
            if left == 0:
                return
            if time.monotonic() - t0 > timeout:
                stuck = [e["job_id"] for v in
                         self._outstanding().values() for e in v]
                raise TimeoutError(
                    f"fleet: {left} job(s) not terminal after "
                    f"{timeout}s: {stuck[:8]}")
            time.sleep(poll_s)

    # -- death + handoff ---------------------------------------------------
    def kill_replica(self, idx: int, reason: str = "killed by test"
                     ) -> None:
        """Operator/test entry point: abrupt replica death now."""
        self._declare_dead(self.replicas[idx], reason)

    def _declare_dead(self, rep: Replica, reason: str,
                      handoff: bool = True) -> None:
        with self._lock:
            if not rep.alive:
                return
            rep.alive = False
            rep.dead_reason = reason
        log.warning("fleet: %s DEAD (%s)", rep.replica_id, reason)
        srv = rep.server
        # transport goes dark first (new connects fail), then the worker
        # is asked to stop at the bucket gate — the journal on disk ends
        # up exactly as a SIGKILL would leave it, minus torn bytes
        srv._close_listener()
        srv.drain()
        drained = srv._drained.wait(self.cfg.kill_wait_s)
        if not drained:
            log.error("fleet: %s worker did not stop within %.0fs — "
                      "sweeping the journal anyway", rep.replica_id,
                      self.cfg.kill_wait_s)
        rep.final_slo = srv.slo_snapshot()
        srv.write_slo(os.path.join(rep.state_dir, "slo.json"))
        if drained:
            srv.join_threads()
        if handoff:
            self._handoff(rep)

    def _handoff(self, dead: Replica) -> None:
        """Sweep the dead replica's job journal: adopt terminal entries
        (results ride in the journal payload), resubmit non-terminal
        ones to survivors under the same job id. Every swept job ends
        the sweep either adopted, handed off, or explicitly orphaned."""
        jobs, corrupt = JobJournal(
            os.path.join(dead.state_dir, "jobs")).load()
        for job_id, _fn, _seq in corrupt:
            self._orphan(self.books.get(job_id),
                         "journal entry corrupt at handoff")
        moved = adopted = 0
        for job in jobs:
            with self._lock:
                entry = self.books.get(job.job_id)
            if entry is None or entry["replica"] != dead.idx \
                    or entry["status"] in DISPATCH_TERMINAL:
                continue
            if job.terminal:
                payload = ({"ok": True, **job.result}
                           if job.status == "completed" and job.result
                           else None)
                self._book_terminal(entry, job.status, job.reason,
                                    payload)
                adopted += 1
                continue
            if self._resubmit(entry):
                moved += 1
        log.warning("fleet: handoff from %s: %d adopted terminal, "
                    "%d resubmitted, %d orphaned so far",
                    dead.replica_id, adopted, moved, self.orphaned)

    def _resubmit(self, entry: Dict[str, Any]) -> bool:
        for _ in range(self.cfg.handoff_attempts):
            rep = self._pick_replica()
            if rep is None:
                break
            try:
                with self._client(rep) as c:
                    resp = c.request(entry["wire"])
            except (OSError, ValueError) as e:
                self._probe_failed(rep, f"handoff: {type(e).__name__}")
                continue
            if resp.get("ok") and resp.get("status") == "accepted":
                with self._lock:
                    entry["replica"] = rep.idx
                    entry["status"] = "accepted"
                    entry["handoffs"] += 1
                    self.handoffs += 1
                log.info("fleet: job %s handed off to %s",
                         entry["job_id"], rep.replica_id)
                return True
            reason = resp.get("reason", resp.get("error", "unknown"))
            if reason not in ("queue-full", "quota-jobs", "quota-bases"):
                # non-transient rejection (draining, duplicate): no
                # amount of retrying places this job
                self._orphan(entry, f"handoff rejected: {reason}")
                return False
            time.sleep(0.05)
        self._orphan(entry, "handoff found no taker")
        return False

    def _orphan(self, entry: Optional[Dict[str, Any]],
                reason: str) -> None:
        if entry is None:
            return
        with self._lock:
            if entry["status"] in DISPATCH_TERMINAL:
                return
            entry["status"] = "orphaned"
            entry["reason"] = reason
            entry["finish_mono"] = time.monotonic()
            self.orphaned += 1
        log.error("fleet: job %s ORPHANED (%s) — counted, not dropped",
                  entry["job_id"], reason)

    # -- drain -------------------------------------------------------------
    def drain_all(self) -> None:
        """Graceful fleet shutdown: drain every live replica, wait for
        the workers, collect final SLO snapshots. A replica whose drain
        stalls (the ``stalled_drain`` fault, or a genuinely hung wave)
        is killed after a bounded wait and its journal swept."""
        live = self._live()
        for rep in live:
            if self.faults.fires_fleet(rep.idx, "stalled_drain"):
                rep.stalled = True
                log.warning("fleet: %s drain request injected-to-stall",
                            rep.replica_id)
                continue
            try:
                with self._client(rep) as c:
                    c.drain()
            except (OSError, ValueError) as e:
                self._probe_failed(rep, f"drain: {type(e).__name__}")
        for rep in live:
            if not rep.alive:
                continue
            wait_s = (self.cfg.stall_timeout_s if rep.stalled
                      else self.cfg.drain_timeout_s)
            if rep.server._drained.wait(wait_s):
                rep.drain_clean = rep.server.join(timeout=5.0)
                rep.final_slo = rep.server.slo_snapshot()
                rep.server.write_slo(
                    os.path.join(rep.state_dir, "slo.json"))
                with self._lock:
                    rep.alive = False
                    rep.dead_reason = "drained"
            else:
                self._declare_dead(
                    rep, "stalled drain escalated to kill "
                         f"(no stop within {wait_s:.3g}s)")
        self._stop.set()

    # -- summary -----------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """The dispatcher's side of the fleet books — obs/load.py joins
        this with the heartbeat time series to build the LOAD row."""
        with self._lock:
            books = {k: {kk: vv for kk, vv in v.items() if kk != "wire"}
                     for k, v in self.books.items()}
            rejections = list(self.rejections)
            handoffs, orphaned = self.handoffs, self.orphaned
        latency: Dict[str, List[float]] = {}
        dispo = {s: 0 for s in DISPATCH_TERMINAL}
        for e in books.values():
            if e["status"] in dispo:
                dispo[e["status"]] += 1
            if e["status"] == "completed" and e["finish_mono"]:
                latency.setdefault(e["cls"], []).append(
                    e["finish_mono"] - e["submit_mono"])
        reject_reasons: Dict[str, int] = {}
        for r in rejections:
            reject_reasons[r["reason"]] = \
                reject_reasons.get(r["reason"], 0) + 1
        return {
            "replicas": [
                {"idx": r.idx, "replica_id": r.replica_id,
                 "alive": r.alive, "dead_reason": r.dead_reason,
                 "drain_clean": r.drain_clean, "slo": r.final_slo}
                for r in self.replicas],
            "jobs": {"routed": len(books),
                     "rejected": len(rejections),
                     "rejected_fleet": sum(1 for r in rejections
                                           if r["replica"] is None),
                     "handoffs": handoffs, "orphaned": orphaned,
                     **{k: v for k, v in dispo.items()
                        if k != "orphaned"}},
            "rejections": reject_reasons,
            "latency_raw": latency,
            "books": books,
        }
