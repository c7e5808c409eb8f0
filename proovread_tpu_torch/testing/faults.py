"""Deterministic fault injection for the resilience ladder.

Port of ``proovread_tpu/testing/faults.py``, whole: the exception classes,
``make_fault``, ``FaultRule`` and ``FaultPlan`` with the same grammar, so a
spec is accepted or rejected exactly as the reference does. The pipeline
runs in one process, and its real failure modes on the card (a kernel
that fails to build, CUDA out of memory, a kernel fault, a wall-clock hang)
only occur on real hardware at scale. This module makes them reproducible
on the CPU: a :class:`FaultPlan` parsed from the ``PROOVREAD_FAULT`` env var
(or ``PipelineConfig.fault_spec``) raises a fault of the requested class
at an exact bucket/pass site inside ``pipeline/driver.py``, so the
degradation ladder and the checkpoint/resume journal
(``pipeline/resilience.py``) are testable on the CPU. The port's driver
calls the device sites (``check``, ``check_span``), the server
(``serve/``) the job sites and the fleet dispatcher the fleet sites; the
mesh sites belong to the multi-device mesh, which the port does not run
yet.

Spec grammar (semicolon- or comma-separated rules)::

    <kind>@b<bucket>[.p<pass>][x<count>]        device-site rules
    <kind>@j<job>[x<count>]                     job-site rules (serving)
    <kind>@d<shard>[.p<pass>][x<count>]         mesh-site rules (multi-chip)
    <kind>@r<replica>[.j<ordinal>][x<count>]    fleet-site rules (dispatcher)
    <kind>@*[.p<pass>][x<count>]

    kind    device sites: compile | oom | timeout | kernel
            job sites:    parse | worker | deadline | quota | journal
            mesh sites:   device_lost | shard_oom | straggler |
                          collective_timeout
            fleet sites:  replica_death | stalled_drain | dispatch_timeout
    bucket  0-based length-bucket index ('*' = any bucket)
    job     0-based job SUBMISSION ordinal within one server lifetime
            ('*' = any job); only valid for the job-site kinds
    shard   0-based shard ordinal in the ORIGINAL mesh ('*' = any alive
            shard); only valid for the mesh-site kinds. A shard the mesh
            ladder already dropped is never visited again, so an
            unlimited rule cannot loop the shrink rung forever.
    replica 0-based replica index in the fleet ('*' = any alive replica);
            only valid for the fleet-site kinds. A replica the dispatcher
            already declared dead is never probed again, mirroring the
            dropped-shard rule above.
    pass    1..n_iterations; n_iterations+1 addresses the finish pass.
            Omitted = the rule fires at ANY device site of the bucket,
            including the bucket-entry site. For mesh sites: the
            iteration whose sharded step the fault interrupts.
    ordinal 0-based DISPATCH ordinal within one fleet lifetime — the
            fleet fault fires when the dispatcher routes its
            ``ordinal``-th job at/through the addressed replica. Omitted
            = the rule fires at the replica's next probed fleet site.
            Only valid for the fleet-site kinds.
    count   max number of firings (default: unlimited — a rule keeps
            firing on every ladder retry, which is what walks a bucket
            down to the host-scan rung)

Examples: ``compile@b0.p2`` (compile failure at bucket 0, pass 2, every
device attempt), ``oom@b1`` (OOM on any device work in bucket 1),
``timeout@b2.p1x1`` (one single injected timeout), ``worker@j3x1`` (the
correction worker dies once while a wave containing job 3 is mid-flight),
``device_lost@d1.p2`` (shard 1's chip dies at iteration 2 of every mesh
attempt — the headline ``make dmesh-smoke`` scenario),
``replica_death@r1.j5`` (replica 1 is killed mid-wave when the
dispatcher routes its 5th job — the headline ``make load-smoke``
handoff scenario).

Device faults are only raised from device-path sites, so the
``engine="scan"`` rung and the scan engine itself always complete: the
injection models faults of the fused and eager device programs.

Job faults (``serve/``, docs/SERVING.md) address the serving envelope
instead of the device: ``parse`` rejects a job's submission as malformed,
``worker`` kills the correction worker mid-wave (the job-level
retry/resume path), ``deadline`` forces the job's deadline to breach,
``quota`` forces its tenant's quota to read as exhausted at admission,
and ``journal`` corrupts the job's journal entry after it is written (a
restart must detect it — never silently lose the job). They derive from
:class:`InjectedJobFault`, which is deliberately NOT a ``RuntimeError``:
``resilience.classify_fault`` returns ``None`` for them, so the
degradation ladder never absorbs a serving-layer fault as a device one.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field
from typing import List, Optional

log = logging.getLogger("proovread_tpu_torch")

KINDS = ("compile", "oom", "timeout", "kernel")
JOB_KINDS = ("parse", "worker", "deadline", "quota", "journal")
MESH_KINDS = ("device_lost", "shard_oom", "straggler",
              "collective_timeout")
FLEET_KINDS = ("replica_death", "stalled_drain", "dispatch_timeout")


class InjectedFault(RuntimeError):
    """Base class for injected device faults (classified by
    ``resilience.classify_fault`` exactly like their real twins)."""


class InjectedCompileError(InjectedFault):
    """Stands in for a failure to build the device program of a rung (the
    reference's XLA compile failure; the message is the reference's, so
    both packages classify and report it alike)."""


class InjectedOOM(InjectedFault):
    """Stands in for running out of device memory (``torch.OutOfMemoryError``
    on the card, RESOURCE_EXHAUSTED in the reference)."""


class InjectedKernelFault(InjectedFault):
    """Stands in for a recoverable kernel fault (the reference's Pallas /
    Mosaic lowering fault; the message is the reference's)."""


class BucketTimeout(RuntimeError):
    """A bucket exceeded its wall-clock budget. Raised by the injected
    ``timeout`` kind and by ``resilience.soft_deadline``'s SIGALRM handler."""


class ShardStraggler(BucketTimeout):
    """A sharded iteration step exceeded its per-pass soft deadline
    (``PipelineConfig.mesh_pass_timeout``) — the host-side wait on the
    step's KPI fetch is where a straggling chip parks the whole mesh.

    A REAL deadline firing cannot name the slow chip (the collective
    blocks on all of them), so ``shard`` is None and the mesh ladder
    retreats to single-device; the INJECTED ``straggler`` kind carries
    the shard it simulates, so the shrink rung can drop exactly that
    shard. Subclasses :class:`BucketTimeout` so a straggler that escapes
    the mesh rung still classifies as an ordinary ``timeout`` for the
    per-bucket ladder."""

    def __init__(self, *args, shard=None):
        super().__init__(*args)
        self.shard = shard


class InjectedMeshFault(InjectedFault):
    """Base class for injected MESH faults (``@d<shard>`` sites). A
    RuntimeError like the other device faults — the per-bucket ladder may
    absorb one that escapes the mesh rungs — but additionally carries the
    implicated ``shard`` and its ``kind``, which is what lets the mesh
    ladder drop the right chip and attribute the demotion
    (``resilience.classify_mesh_fault``)."""

    kind = "mesh"

    def __init__(self, *args, shard=None):
        super().__init__(*args)
        self.shard = shard


class InjectedDeviceLost(InjectedMeshFault):
    """Stands in for a chip dropping off the mesh mid-step (ICI link
    down, chip reset — the pod-slice analog of a killed chunk process)."""

    kind = "device_lost"


class InjectedShardOOM(InjectedMeshFault):
    """Stands in for ONE shard exhausting its HBM (skewed candidate load;
    the other shards were fine)."""

    kind = "shard_oom"


class InjectedStraggler(InjectedMeshFault):
    """Stands in for one chip running the step far slower than the rest
    (thermal throttling, preemption) — the psum makes everyone wait."""

    kind = "straggler"


class InjectedCollectiveTimeout(InjectedMeshFault):
    """Stands in for a hung cross-chip collective (interconnect fault,
    not attributable to a single chip)."""

    kind = "collective_timeout"


class MeshCapExceeded(InjectedMeshFault):
    """NOT injected, despite the base class: raised by the driver's mesh
    loop when a sharded pass reports ``n_dropped_cap > 0`` — the static
    per-shard candidate budget (``mesh_chunks_per_shard * chunk``) would
    have truncated candidates, and truncated output is mesh-shape-
    DEPENDENT (total capacity scales with shard count). Subclassing
    :class:`InjectedMeshFault` puts it on the mesh classification path:
    ``kind`` is outside the shrinkable set, so the bucket retreats to the
    single-device rung, whose dynamic chunk count never truncates — the
    mesh-shape-invariance guarantee holds unconditionally, and the knob
    can stay out of the checkpoint fingerprint."""

    kind = "cap_overflow"


class InjectedJobFault(Exception):
    """Base class for injected SERVING-layer faults (job sites). Not a
    RuntimeError on purpose: ``resilience.classify_fault`` must return
    ``None`` so the device degradation ladder never absorbs one."""


class InjectedParseError(InjectedJobFault):
    """Stands in for a malformed job submission (bad JSON, bad payload)."""


class InjectedWorkerDeath(InjectedJobFault):
    """Stands in for the correction worker dying mid-wave (the process
    analog is ``kill -9``); the server's job-level retry must requeue the
    wave's jobs and the bucket journal makes the retry cheap."""


class InjectedDeadlineBreach(InjectedJobFault):
    """Forces a job's deadline to read as already breached."""


class InjectedQuotaExhausted(InjectedJobFault):
    """Forces the submitting tenant's quota to read as exhausted."""


class InjectedJournalCorruption(InjectedJobFault):
    """Marks a job's journal entry for post-write corruption (simulated
    disk corruption; atomic writes cannot prevent it)."""


class InjectedFleetFault(InjectedJobFault):
    """Base class for injected FLEET faults (``@r<replica>`` sites).
    Subclasses :class:`InjectedJobFault` — NOT RuntimeError — for the
    same reason the job sites do: ``resilience.classify_fault`` returns
    ``None``, so the device degradation ladder inside a replica's wave
    can never absorb a dispatcher-layer fault. Carries the addressed
    ``replica`` and its ``kind`` so the dispatcher can attribute the
    effect (kill / stall / timeout) to the right replica."""

    kind = "fleet"

    def __init__(self, *args, replica=None):
        super().__init__(*args)
        self.replica = replica


class InjectedReplicaDeath(InjectedFleetFault):
    """Stands in for a replica process dying mid-wave (OOM-killer,
    ``kill -9``, kernel panic): the socket goes dark with jobs in
    flight. The dispatcher must detect the death at its next probe and
    hand the replica's journaled non-terminal jobs to survivors."""

    kind = "replica_death"


class InjectedStalledDrain(InjectedFleetFault):
    """Stands in for a replica whose graceful drain never finishes (a
    wave hung in a collective, a wedged worker thread): the dispatcher's
    bounded drain-wait must expire and escalate to a kill + handoff
    rather than wait forever."""

    kind = "stalled_drain"


class InjectedDispatchTimeout(InjectedFleetFault):
    """Stands in for one dispatcher-visible request timeout (transient
    socket stall, replica busy past the probe deadline) — the dispatcher
    must count it against the replica's health, not crash, and not
    declare death on a single blip."""

    kind = "dispatch_timeout"


class WallClockExceeded(Exception):
    """A RUN-level wall budget breach (``bench.py --wall-budget``).

    Deliberately NOT a RuntimeError and NOT a BucketTimeout: the
    degradation ladder must never absorb it — a run-level deadline firing
    mid-bucket has to abort the run (so the caller can record its partial
    result), not demote the bucket and keep going unbounded."""


def make_fault(kind: str, where: str, shard=None, replica=None) -> Exception:
    if kind == "replica_death":
        return InjectedReplicaDeath(
            f"replica {replica} died (injected at {where})",
            replica=replica)
    if kind == "stalled_drain":
        return InjectedStalledDrain(
            f"replica {replica} drain stalled (injected at {where})",
            replica=replica)
    if kind == "dispatch_timeout":
        return InjectedDispatchTimeout(
            f"request to replica {replica} timed out (injected at "
            f"{where})", replica=replica)
    if kind == "device_lost":
        return InjectedDeviceLost(
            f"device lost: shard {shard} dropped off the mesh "
            f"(injected at {where})", shard=shard)
    if kind == "shard_oom":
        return InjectedShardOOM(
            f"RESOURCE_EXHAUSTED on shard {shard} (injected at {where})",
            shard=shard)
    if kind == "straggler":
        return InjectedStraggler(
            f"shard {shard} straggling past the mesh pass deadline "
            f"(injected at {where})", shard=shard)
    if kind == "collective_timeout":
        return InjectedCollectiveTimeout(
            f"DEADLINE_EXCEEDED: cross-chip collective hung "
            f"(injected at {where})", shard=shard)
    if kind == "compile":
        return InjectedCompileError(
            f"XLA compilation failure (injected at {where})")
    if kind == "oom":
        return InjectedOOM(f"RESOURCE_EXHAUSTED: injected OOM at {where}")
    if kind == "kernel":
        return InjectedKernelFault(
            f"Mosaic kernel fault (injected at {where})")
    if kind == "timeout":
        return BucketTimeout(f"injected bucket timeout at {where}")
    if kind == "parse":
        return InjectedParseError(f"unparseable job payload (injected at "
                                  f"{where})")
    if kind == "worker":
        return InjectedWorkerDeath(f"correction worker died (injected at "
                                   f"{where})")
    if kind == "deadline":
        return InjectedDeadlineBreach(f"job deadline breached (injected "
                                      f"at {where})")
    if kind == "quota":
        return InjectedQuotaExhausted(f"tenant quota exhausted (injected "
                                      f"at {where})")
    if kind == "journal":
        return InjectedJournalCorruption(f"journal entry corrupted "
                                         f"(injected at {where})")
    raise ValueError(f"unknown fault kind {kind!r}")


_RULE_RE = re.compile(
    r"^(?P<kind>[a-z_]+)@(?:b(?P<bucket>\d+)|j(?P<job>\d+)"
    r"|d(?P<shard>\d+)|r(?P<replica>\d+)|(?P<any>\*))"
    r"(?:\.p(?P<pass>\d+)|\.j(?P<jord>\d+))?(?:x(?P<count>\d+))?$")


@dataclass
class FaultRule:
    kind: str
    bucket: Optional[int]        # None = any bucket
    pass_: Optional[int]         # None = any site of the bucket
    count: Optional[int]         # None = unlimited firings
    job: Optional[int] = None    # job-site rules: submission ordinal
    shard: Optional[int] = None  # mesh-site rules: original shard ordinal
    replica: Optional[int] = None  # fleet-site rules: replica index
    jord: Optional[int] = None   # fleet-site rules: dispatch ordinal
    fired: int = 0

    def matches(self, bucket: int, pass_: Optional[int]) -> bool:
        if (self.kind in JOB_KINDS or self.kind in MESH_KINDS
                or self.kind in FLEET_KINDS):
            return False
        if self.count is not None and self.fired >= self.count:
            return False
        if self.bucket is not None and self.bucket != bucket:
            return False
        if self.pass_ is not None and self.pass_ != pass_:
            return False
        return True

    def matches_job(self, job: int, site: str) -> bool:
        if self.kind != site:
            return False
        if self.count is not None and self.fired >= self.count:
            return False
        if self.job is not None and self.job != job:
            return False
        return True

    def matches_mesh(self, shard: int, pass_: Optional[int]) -> bool:
        if self.kind not in MESH_KINDS:
            return False
        if self.count is not None and self.fired >= self.count:
            return False
        if self.shard is not None and self.shard != shard:
            return False
        if self.pass_ is not None and self.pass_ != pass_:
            return False
        return True

    def matches_fleet(self, replica: int, jord: Optional[int],
                      site: str) -> bool:
        if self.kind != site or self.kind not in FLEET_KINDS:
            return False
        if self.count is not None and self.fired >= self.count:
            return False
        if self.replica is not None and self.replica != replica:
            return False
        if self.jord is not None and self.jord != jord:
            return False
        return True


@dataclass
class FaultPlan:
    """Parsed injection plan. Firing counts are per-plan instance, so each
    ``Pipeline.run`` gets a fresh plan and injection stays deterministic."""

    rules: List[FaultRule] = field(default_factory=list)

    @classmethod
    def from_spec(cls, spec: Optional[str]) -> "FaultPlan":
        rules: List[FaultRule] = []
        for part in re.split(r"[;,]", spec or ""):
            part = part.strip()
            if not part:
                continue
            m = _RULE_RE.match(part)
            if not m:
                raise ValueError(
                    f"bad PROOVREAD_FAULT rule {part!r} "
                    "(expected kind@bN[.pM][xK] / kind@*[.pM][xK] for "
                    "device kinds, kind@jN[xK] / kind@*[xK] for job "
                    "kinds)")
            kind = m.group("kind")
            if (kind not in KINDS and kind not in JOB_KINDS
                    and kind not in MESH_KINDS
                    and kind not in FLEET_KINDS):
                raise ValueError(
                    f"unknown fault kind {kind!r} in {part!r} "
                    f"(known: {', '.join(KINDS + JOB_KINDS + MESH_KINDS + FLEET_KINDS)})")
            if kind in JOB_KINDS and (m.group("bucket") or m.group("pass")
                                      or m.group("shard")
                                      or m.group("replica")
                                      or m.group("jord")):
                raise ValueError(
                    f"job-site kind {kind!r} takes @jN or @* addressing, "
                    f"not bucket/pass/shard/replica sites ({part!r})")
            if kind in KINDS and (m.group("job") or m.group("shard")
                                  or m.group("replica")
                                  or m.group("jord")):
                raise ValueError(
                    f"device-site kind {kind!r} takes @bN or @* "
                    f"addressing, not @j/@d/@r sites ({part!r})")
            if kind in MESH_KINDS and (m.group("bucket") or m.group("job")
                                       or m.group("replica")
                                       or m.group("jord")):
                raise ValueError(
                    f"mesh-site kind {kind!r} takes @dN or @* addressing, "
                    f"not @b/@j/@r sites ({part!r})")
            if kind in FLEET_KINDS and (m.group("bucket") or m.group("job")
                                        or m.group("shard")
                                        or m.group("pass")):
                raise ValueError(
                    f"fleet-site kind {kind!r} takes @rN[.jM] or @*[.jM] "
                    f"addressing, not @b/@j/@d or .p sites ({part!r})")
            rules.append(FaultRule(
                kind=kind,
                bucket=(int(m.group("bucket")) if m.group("bucket")
                        else None),
                job=int(m.group("job")) if m.group("job") else None,
                shard=int(m.group("shard")) if m.group("shard") else None,
                replica=(int(m.group("replica")) if m.group("replica")
                         else None),
                jord=int(m.group("jord")) if m.group("jord") else None,
                pass_=int(m.group("pass")) if m.group("pass") else None,
                count=int(m.group("count")) if m.group("count") else None))
        return cls(rules)

    @property
    def active(self) -> bool:
        return bool(self.rules)

    def check(self, bucket: int, pass_: Optional[int] = None) -> None:
        """Raise the injected fault if a rule matches this site. Called
        from the driver's device-path sites only."""
        for r in self.rules:
            if r.matches(bucket, pass_):
                r.fired += 1
                where = (f"bucket {bucket}" if pass_ is None
                         else f"bucket {bucket} pass {pass_}")
                log.warning("fault injection: %s at %s (rule fired %d%s)",
                            r.kind, where, r.fired,
                            f"/{r.count}" if r.count else "")
                raise make_fault(r.kind, where)

    def fires_job(self, job: int, site: str) -> bool:
        """Consume one firing of a job-site rule matching (``job``,
        ``site``) and return True — without raising. The ``journal``
        site uses this: its effect is corrupting a file after the write,
        not an exception at the call site."""
        for r in self.rules:
            if r.matches_job(job, site):
                r.fired += 1
                log.warning(
                    "fault injection: %s at job %d (rule fired %d%s)",
                    r.kind, job, r.fired,
                    f"/{r.count}" if r.count else "")
                return True
        return False

    def check_job(self, job: int, site: str) -> None:
        """Raise the injected job fault if a rule matches this serving
        site (``parse`` / ``worker`` / ``deadline`` / ``quota``).
        ``job`` is the submission ordinal within one server lifetime."""
        if self.fires_job(job, site):
            raise make_fault(site, f"job {job}")

    def check_mesh(self, shard: int, pass_: Optional[int] = None) -> None:
        """Raise the injected mesh fault if a rule matches this
        ``(shard, iteration)`` site. Called by the driver's mesh loop for
        each ALIVE shard before launching the sharded step — a shard the
        mesh ladder already dropped is never offered, which is what keeps
        unlimited ``@*`` rules from re-firing forever."""
        for r in self.rules:
            if r.matches_mesh(shard, pass_):
                r.fired += 1
                where = (f"shard {shard}" if pass_ is None
                         else f"shard {shard} iteration {pass_}")
                log.warning("fault injection: %s at %s (rule fired %d%s)",
                            r.kind, where, r.fired,
                            f"/{r.count}" if r.count else "")
                raise make_fault(r.kind, where, shard=shard)

    def fires_fleet(self, replica: int, site: str,
                    jord: Optional[int] = None) -> bool:
        """Consume one firing of a fleet-site rule matching ``(replica,
        jord, site)`` and return True — without raising. The dispatcher
        uses this form for effects that are actions, not exceptions
        (killing a replica, skipping a drain forward)."""
        for r in self.rules:
            if r.matches_fleet(replica, jord, site):
                r.fired += 1
                where = (f"replica {replica}" if jord is None
                         else f"replica {replica} dispatch ordinal {jord}")
                log.warning(
                    "fault injection: %s at %s (rule fired %d%s)",
                    r.kind, where, r.fired,
                    f"/{r.count}" if r.count else "")
                return True
        return False

    def check_fleet(self, replica: int, site: str,
                    jord: Optional[int] = None) -> None:
        """Raise the injected fleet fault if a rule matches this
        ``(replica, dispatch-ordinal)`` site. Called by the dispatcher
        for ALIVE replicas only — a replica already declared dead is
        never probed again, so an unlimited ``@*`` rule cannot loop the
        handoff path forever (the dropped-shard discipline)."""
        if self.fires_fleet(replica, site, jord=jord):
            where = (f"replica {replica}" if jord is None
                     else f"replica {replica} dispatch ordinal {jord}")
            raise make_fault(site, where, replica=replica)

    def check_span(self, bucket: int, pass_lo: int, pass_hi: int) -> None:
        """Raise if any pass index in ``[pass_lo, pass_hi]`` matches — the
        fused program covers its whole pass span in one compile/launch, so
        a fault addressed to any covered pass takes down the whole span."""
        for p in range(pass_lo, pass_hi + 1):
            self.check(bucket, p)
