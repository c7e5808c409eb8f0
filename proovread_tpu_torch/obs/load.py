"""Fleet load scoreboard: LOAD rows from a multi-replica fleet run (port
of ``proovread_tpu/obs/load.py``: the scoreboard, the row, the harness
and the smoke).

The serving claim this module makes checkable from artifacts: **a
multi-replica fleet under hostile traffic loses zero jobs and degrades
by bounded rejection, not collapse** — through tenant bursts, poison
submissions, an overload wall, and a mid-wave replica kill with journal
handoff. One smoke run produces one LOAD row per scenario:

- ``slam``: every traffic family (clr / ccs / unitig / ont), Poisson
  arrivals with bursts, poison jobs (each must bounce with its exact
  expected reason), and an injected ``replica_death`` mid-stream — the
  dead replica's journaled jobs hand off to survivors and the fleet-wide
  accounting identities (``obs/validate.py:validate_load``) still hold.
- ``overload``: a tight-quota burst wall — the fleet must answer with
  rejections from the closed vocabulary, every accepted job still
  completes, nothing dies.

Each row carries sustained fleet throughput, client-observed latency
percentiles per read-length class (measured at the dispatcher — merging
per-replica percentiles would be statistically wrong), queue depths,
per-reason rejections, per-tenant demotions, per-family accuracy (truth
rides the generated traffic, so the fleet path is *scored*, not just
exercised; on the card with the LCS and traceback kernels), the kernel
library's census and per-replica SLO slices. ``backend`` is the port's
device, ``"cuda"`` or ``"cpu"``. ``check`` is the reference's gate over
LOAD history: rows pool per (scenario, n_replicas, backend), so a row of
the card never pools with the JAX package's, and it trips on throughput
drop, p99 growth, accuracy drop, a broken accounting identity or any
orphaned job.

CLI::

    python -m proovread_tpu_torch.obs.load smoke [--out FILE]
        [--replicas N] [--device cuda|cpu]
    python -m proovread_tpu_torch.obs.load check [LOAD_*.json ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# one rolling-median implementation for every history gate
from proovread_tpu_torch.obs.regress import (_median, history_paths,
                                             json_values)

SCHEMA_VERSION = 1

# the gate's thresholds (the reference's), generous on purpose: they catch
# structural regressions (a build a wave, a routing pathology), not
# scheduler jitter
THROUGHPUT_DROP = 0.50      # allowed fractional bases/sec/fleet drop
P99_GROWTH = 1.00           # allowed fractional p99 growth per class...
P99_MIN_ABS_S = 2.0         # ...when the absolute growth also exceeds
IDENTITY_DROP = 0.005       # allowed absolute per-family identity drop
BASELINE_WINDOW = 3


def _log(msg: str) -> None:
    print(f"load: {msg}", file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# heartbeat time series
# --------------------------------------------------------------------------

class FleetScoreboard:
    """The dispatcher's heartbeat sink: one sample per (beat, replica)
    with the ping identity and the SLO snapshot's live counters. Kept as
    a plain time series — the LOAD row reduces it, tests can inspect the
    raw samples for liveness coverage."""

    def __init__(self):
        self.samples: List[Dict[str, Any]] = []

    def sample(self, t_mono: float, replica_idx: int,
               pong: Dict[str, Any], slo: Dict[str, Any]) -> None:
        wave = pong.get("wave")
        self.samples.append({
            "t_mono": t_mono,
            "replica": replica_idx,
            "replica_id": pong.get("replica_id"),
            "uptime_s": pong.get("uptime_s"),
            "draining": pong.get("draining"),
            "wave_busy_s": wave.get("busy_s") if wave else None,
            "queue_depth": slo["queue"]["depth_final"],
            "accepted": slo["jobs"]["accepted"],
            "completed": slo["jobs"]["completed"],
        })

    def summary(self) -> Dict[str, Any]:
        return {"samples": len(self.samples),
                "replicas_seen": sorted({s["replica_id"]
                                         for s in self.samples
                                         if s["replica_id"]})}


# --------------------------------------------------------------------------
# accuracy over the fleet path (truth sidecars ride the traffic)
# --------------------------------------------------------------------------

def score_fleet_accuracy(jobs: Sequence[Any],
                         results: Dict[str, Dict[str, Any]],
                         device: str = "cuda"
                         ) -> Dict[str, Dict[str, Any]]:
    """Per-family accuracy over every completed, scorable job: before =
    the submitted reads, after = the untrimmed corrected payload the
    dispatcher fetched over the wire, truth = the generator's sidecar
    maps; scored on ``device`` (the LCS and traceback kernels on the
    card). CCS stays unscored (collapse renames reads — the accuracy
    scoreboard's standing caveat)."""
    from proovread_tpu_torch.obs.accuracy import score_read_sets
    from proovread_tpu_torch.ops.encode import encode_ascii
    from proovread_tpu_torch.serve.loadgen import SCORED_FAMILIES

    by_fam: Dict[str, Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
                            Dict[str, np.ndarray]]] = {}
    for job in jobs:
        if job.family not in SCORED_FAMILIES or not job.truth:
            continue
        payload = results.get(job.job_id)
        if payload is None:
            continue
        before, after, truth = by_fam.setdefault(
            job.family, ({}, {}, {}))
        for r in job.records:
            before[r.id] = encode_ascii(r.seq)
        for d in payload.get("untrimmed") or []:
            after[d["id"]] = encode_ascii(d["seq"])
        truth.update(job.truth)
    out: Dict[str, Dict[str, Any]] = {}
    for fam, (before, after, truth) in sorted(by_fam.items()):
        _, summ = score_read_sets(before, after, truth,
                                  device=device)
        if not summ["n_scored"]:
            continue
        out[fam] = {
            "n_scored": summ["n_scored"],
            "identity_before": summ["identity_before"],
            "identity_after": summ["identity_after"],
            "identity_after_min": summ["identity_after_min"],
        }
    return out


# --------------------------------------------------------------------------
# LOAD row assembly
# --------------------------------------------------------------------------

def build_row(scenario: str, n_replicas: int, backend: str,
              wall_s: float, fleet: Dict[str, Any],
              scoreboard: FleetScoreboard,
              accuracy: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """One strict-schema LOAD row from a fleet run: the dispatcher's
    summary (``FleetDispatcher.summary()``), the heartbeat series and
    the per-family accuracy. Validates before returning — a row this
    module cannot validate is a bug here, not in the gate."""
    from proovread_tpu_torch.obs.validate import (LOAD_SCHEMA_VERSION,
                                                  validate_load)
    slos = [r["slo"] for r in fleet["replicas"]]
    if any(s is None for s in slos):
        raise RuntimeError("fleet run ended with a replica that has no "
                           "final SLO snapshot — drain_all not called?")
    sums = {k: sum(s["jobs"][k] for s in slos)
            for k in ("accepted", "completed", "failed", "cancelled",
                      "expired", "journaled")}
    demotions: Dict[str, int] = {}
    for s in slos:
        for tenant, n in s["demotions"].items():
            demotions[tenant] = demotions.get(tenant, 0) + n
    latency = {
        cls: {"count": len(vs),
              "p50_s": round(float(np.percentile(vs, 50)), 6),
              "p99_s": round(float(np.percentile(vs, 99)), 6),
              "max_s": round(float(max(vs)), 6)}
        for cls, vs in sorted(fleet["latency_raw"].items())}
    done_bases = sum(e["n_bases"] for e in fleet["books"].values()
                     if e["status"] == "completed")
    deaths = sum(1 for r in fleet["replicas"]
                 if r["dead_reason"] not in ("", "drained"))
    comp = slos[0]["compile"]
    row = {
        "load_schema": LOAD_SCHEMA_VERSION,
        "scenario": scenario,
        "n_replicas": n_replicas,
        "backend": backend,
        "wall_s": round(wall_s, 3),
        "bases_per_sec_fleet": round(done_bases / wall_s, 2),
        "jobs": {"routed": fleet["jobs"]["routed"],
                 "rejected": fleet["jobs"]["rejected"],
                 "rejected_fleet": fleet["jobs"]["rejected_fleet"],
                 "handoffs": fleet["jobs"]["handoffs"],
                 "orphaned": fleet["jobs"]["orphaned"],
                 **sums},
        "rejections": dict(fleet["rejections"]),
        "latency": latency,
        "queue": {"depth_peak": max(s["queue"]["depth_peak"]
                                    for s in slos),
                  "depth_final": sum(s["queue"]["depth_final"]
                                     for s in slos)},
        "demotions": demotions,
        "accuracy": accuracy,
        "handoff": {"deaths": deaths,
                    "handoffs": fleet["jobs"]["handoffs"],
                    "orphaned": fleet["jobs"]["orphaned"]},
        "heartbeat": scoreboard.summary(),
        "compile": {"n_programs": comp["n_programs"],
                    "backend_compiles": comp["backend_compiles"],
                    "tracing_hit_rate": comp["tracing_hit_rate"]},
        "replicas": [{"replica_id": r["replica_id"], "alive": r["alive"],
                      "dead_reason": r["dead_reason"],
                      "drain_clean": r["drain_clean"],
                      "jobs": s["jobs"]}
                     for r, s in zip(fleet["replicas"], slos)],
    }
    validate_load(row, where=f"LOAD row ({scenario})")
    return row


# --------------------------------------------------------------------------
# the harness: one scenario through a live fleet
# --------------------------------------------------------------------------

def run_fleet_scenario(scenario, *, n_replicas: int = 2,
                       state_dir: str, quota=None,
                       fault_spec: Optional[str] = None,
                       pipeline_config=None, time_scale: float = 1.0,
                       wait_timeout: float = 1800.0) -> Dict[str, Any]:
    """Drive one :class:`LoadScenario` through a fresh fleet on the
    pipeline config's device: generate the traffic, submit it on (scaled)
    arrival time, wait for every job to settle, drain, score, and return
    ``{"row", "fleet", "jobs", "scoreboard", "rejections"}``."""
    from proovread_tpu_torch.device import resolve
    from proovread_tpu_torch.io.simulate import simulate_short_reads
    from proovread_tpu_torch.pipeline.driver import PipelineConfig
    from proovread_tpu_torch.serve.fleet import FleetConfig, FleetDispatcher
    from proovread_tpu_torch.serve.loadgen import generate_traffic

    pcfg = pipeline_config or PipelineConfig()
    backend = resolve(pcfg.device).type
    genome, jobs = generate_traffic(scenario)
    shorts = simulate_short_reads(genome, 22.0, seed=scenario.seed + 1)
    n_bases = sum(len(r.seq) for j in jobs for r in j.records)
    _log(f"scenario {scenario.name}: {len(jobs)} submissions "
         f"({n_bases} bases), {len(shorts)} short reads, "
         f"{n_replicas} replica(s) on {backend}")
    scoreboard = FleetScoreboard()
    fc = FleetConfig(state_dir=state_dir, n_replicas=n_replicas,
                     fault_spec=fault_spec or "")
    if quota is not None:
        fc.quota = quota
    disp = FleetDispatcher(shorts, fc, pcfg, scoreboard=scoreboard)
    disp.start()
    t0 = time.monotonic()
    try:
        prev = 0.0
        for job in jobs:
            gap = (job.arrival_s - prev) * time_scale
            prev = job.arrival_s
            if gap > 0:
                time.sleep(min(gap, 1.0))
            disp.dispatch(job.wire, family=job.family,
                          expect_reject=job.expect_reject)
        disp.wait_all(timeout=wait_timeout)
        disp.drain_all()
        wall = time.monotonic() - t0
        fleet = disp.summary()
        rejections = list(disp.rejections)
        accuracy = score_fleet_accuracy(jobs, disp.results,
                                        device=pcfg.device)
    finally:
        disp.close()
    row = build_row(scenario.name, n_replicas, backend, wall, fleet,
                    scoreboard, accuracy)
    return {"row": row, "fleet": fleet, "jobs": jobs,
            "scoreboard": scoreboard, "rejections": rejections}


# --------------------------------------------------------------------------
# the smoke
# --------------------------------------------------------------------------

SMOKE_KILL = "replica_death@r1.j10"


def smoke_config(device: str = "cuda"):
    """The smoke's pipeline: one pass, no sampling, 8-read buckets."""
    from proovread_tpu_torch.pipeline.driver import PipelineConfig
    from proovread_tpu_torch.pipeline.trim import TrimParams
    return PipelineConfig(n_iterations=1, sampling=False,
                          batch_reads=8, host_chunk_rows=512,
                          device_chunk=128, trim=TrimParams(min_length=150),
                          device=device)


def _check(ok: bool, what: str) -> bool:
    _log(("OK:     " if ok else "FAILED: ") + what)
    return ok


def run_smoke(n_replicas: int = 2, pipeline_config=None,
              kill: str = SMOKE_KILL, overload: bool = True
              ) -> Tuple[bool, List[Dict[str, Any]]]:
    """The 2-replica fleet drill: the ``slam`` scenario with a
    mid-stream replica kill (``kill``; handoff verified, identities
    pinned), then (``overload``) the ``overload`` wall (bounded
    rejections, no collapse), LeakCheck at exit. Returns ``(ok, rows)``,
    one LOAD row per scenario run."""
    from proovread_tpu_torch.obs.memory import LeakCheck
    from proovread_tpu_torch.serve.loadgen import (POISON_KINDS, SCENARIOS,
                                                   SCORED_FAMILIES)

    pcfg = pipeline_config or smoke_config()
    ok = True
    rows: List[Dict[str, Any]] = []
    leak = LeakCheck()
    with tempfile.TemporaryDirectory(prefix="proovread_load_") as tmp:
        # -- scenario 1: slam + mid-stream replica death ---------------
        r = run_fleet_scenario(
            SCENARIOS["slam"], n_replicas=n_replicas,
            state_dir=os.path.join(tmp, "slam"), fault_spec=kill,
            pipeline_config=pcfg)
        row, jobs = r["row"], r["jobs"]
        rows.append(row)
        ok &= _check(row["handoff"]["deaths"] == 1,
                     f"slam: exactly one replica death "
                     f"(got {row['handoff']['deaths']})")
        ok &= _check(row["jobs"]["handoffs"] >= 1,
                     f"slam: journal handoff happened "
                     f"({row['jobs']['handoffs']} job(s))")
        ok &= _check(row["jobs"]["orphaned"] == 0
                     and row["jobs"]["failed"] == 0
                     and row["jobs"]["expired"] == 0,
                     "slam: zero jobs lost through the kill "
                     f"(orphaned {row['jobs']['orphaned']}, failed "
                     f"{row['jobs']['failed']}, expired "
                     f"{row['jobs']['expired']})")
        # every poison job bounced with its exact expected reason; the
        # duplicate-job poison reuses its VICTIM's job_id on the wire,
        # so match rejections by the wire id, not the generator's
        got = [(x["job_id"], x["reason"]) for x in r["rejections"]]
        poison = [j for j in jobs if j.expect_reject]
        wrong = [(j.job_id, j.expect_reject) for j in poison
                 if (str(j.wire.get("job_id")), j.expect_reject)
                 not in got]
        ok &= _check(len(poison) >= len(POISON_KINDS) and not wrong,
                     f"slam: all {len(poison)} poison jobs rejected "
                     f"with their expected reasons"
                     + (f" (mismatches: {wrong})" if wrong else ""))
        fams = {j.family for j in jobs if j.family in SCORED_FAMILIES}
        for fam in sorted(fams):
            a = row["accuracy"].get(fam)
            ok &= _check(
                a is not None
                and a["identity_after"] > a["identity_before"],
                f"slam: family {fam} scored over the fleet path with "
                "uplift"
                + (f" ({a['identity_before']:.4f} -> "
                   f"{a['identity_after']:.4f}, n={a['n_scored']})"
                   if a else " (no scored reads)"))
        ok &= _check(row["heartbeat"]["samples"] > 0
                     and len(row["heartbeat"]["replicas_seen"])
                     == n_replicas,
                     "slam: heartbeat sampled every replica "
                     f"({row['heartbeat']['samples']} sample(s))")
        _log(f"slam: {row['bases_per_sec_fleet']} bases/s/fleet over "
             f"{row['wall_s']}s, latency classes "
             f"{sorted(row['latency'])}")

        # -- scenario 2: overload wall ---------------------------------
        if overload:
            from proovread_tpu_torch.serve.admission import TenantQuota
            r2 = run_fleet_scenario(
                SCENARIOS["overload"], n_replicas=n_replicas,
                state_dir=os.path.join(tmp, "overload"),
                quota=TenantQuota(max_jobs=2, max_bases=6_000,
                                  max_server_jobs=3),
                pipeline_config=pcfg, time_scale=0.0)
            row2 = r2["row"]
            rows.append(row2)
            allowed = {"quota-jobs", "quota-bases", "queue-full"}
            ok &= _check(row2["jobs"]["rejected"] > 0
                         and set(row2["rejections"]) <= allowed,
                         "overload: burst answered by bounded rejections "
                         f"({row2['jobs']['rejected']} rejected: "
                         f"{row2['rejections']})")
            ok &= _check(row2["jobs"]["accepted"]
                         == row2["jobs"]["completed"]
                         and row2["handoff"]["deaths"] == 0,
                         "overload: every accepted job completed, no "
                         "replica died "
                         f"(accepted {row2['jobs']['accepted']}, "
                         f"completed {row2['jobs']['completed']})")
            q = row2["queue"]["depth_peak"]
            ok &= _check(q <= 3 * n_replicas,
                         f"overload: queue depth stayed bounded (peak "
                         f"{q})")

    rep = leak.report()
    ok &= _check(rep["leaked_bytes"] <= 1 << 20,
                 f"no CUDA tensor leak after fleet shutdown "
                 f"({rep['leaked_bytes']} bytes, {rep['n_leaked']} "
                 "tensor(s))")
    return bool(ok), rows


# --------------------------------------------------------------------------
# the gate over LOAD history
# --------------------------------------------------------------------------

def load_rows(paths: List[str]) -> List[Dict[str, Any]]:
    """LOAD history files as ``{"source", "row"}`` entries in file order
    (one JSON object a file, or JSON lines)."""
    out: List[Dict[str, Any]] = []
    for path in paths:
        for obj in json_values(path):
            if isinstance(obj, dict) and "load_schema" in obj:
                out.append({"source": path, "row": obj})
    return out


def _pool_key(row: Dict[str, Any]):
    """(scenario, fleet size, backend); a row without ``backend`` pools as
    ``"cpu"`` (the reference's default)."""
    return (str(row.get("scenario")), int(row.get("n_replicas") or 0),
            str(row.get("backend") or "cpu"))


def load_check(entries: List[Dict[str, Any]],
               throughput_drop: float = THROUGHPUT_DROP,
               p99_growth: float = P99_GROWTH,
               p99_min_abs_s: float = P99_MIN_ABS_S,
               identity_drop: float = IDENTITY_DROP,
               window: int = BASELINE_WINDOW) -> Dict[str, Any]:
    """The gate, as data. Per (scenario, n_replicas, backend) pool the
    newest row must validate (``validate_load``: schema and the three
    accounting identities), carry no orphaned job, show uplift in every
    family, and stay within the thresholds of the rolling-baseline median
    for fleet throughput, each class's p99 and each family's identity.
    Invalid baseline rows are non-fatal ``missing`` items. Verdict PASS /
    REGRESSION / NO-DATA."""
    from proovread_tpu_torch.obs.validate import (ValidationError,
                                                  validate_load)

    checks: List[Dict[str, Any]] = []
    pools: Dict[Any, List[Dict[str, Any]]] = {}
    for e in entries:
        pools.setdefault(_pool_key(e["row"]), []).append(e)
    if not pools:
        return {"schema": SCHEMA_VERSION, "verdict": "NO-DATA",
                "pools": [], "checks": checks}

    pool_names = []
    for key in sorted(pools):
        group = pools[key]
        name = f"{key[0]}/x{key[1]}/{key[2]}"
        pool_names.append(name)
        latest = group[-1]
        lrow = latest["row"]
        try:
            validate_load(lrow, where=latest["source"])
        except ValidationError as err:
            checks.append({"check": f"{name}:identity",
                           "status": "regressed",
                           "value": str(err)[:300],
                           "note": "newest row fails validation — "
                                   "schema drift or a broken "
                                   "accounting identity"})
            continue
        checks.append({"check": f"{name}:identity", "status": "ok",
                       "value": lrow["jobs"]["accepted"]})
        checks.append({
            "check": f"{name}:orphaned",
            "status": ("regressed" if lrow["jobs"]["orphaned"] > 0
                       else "ok"),
            "value": lrow["jobs"]["orphaned"],
            "note": "orphaned jobs are explicitly-counted losses — a "
                    "recorded row must have none"})
        for fam, a in sorted(lrow["accuracy"].items()):
            checks.append({
                "check": f"{name}:uplift:{fam}",
                "status": ("regressed"
                           if float(a["identity_after"])
                           < float(a["identity_before"])
                           else "ok"),
                "value": round(float(a["identity_after"]), 4),
                "baseline": round(float(a["identity_before"]), 4),
                "note": "correction must never lower identity"})
        base: List[Dict[str, Any]] = []
        for e in group[:-1]:
            try:
                validate_load(e["row"], where=e["source"])
                base.append(e["row"])
            except ValidationError as err:
                checks.append({"check": f"{name}:baseline-row",
                               "status": "missing",
                               "source": e["source"],
                               "note": str(err)[:200]})
        base = base[-window:]
        if not base:
            checks.append({"check": f"{name}:baseline",
                           "status": "skipped",
                           "note": "no prior valid rows in this pool — "
                                   "nothing to regress against"})
            continue

        bmed = _median([float(b["bases_per_sec_fleet"]) for b in base])
        lv = float(lrow["bases_per_sec_fleet"])
        if bmed > 0:
            delta = (lv - bmed) / bmed
            checks.append({
                "check": f"{name}:bases_per_sec_fleet",
                "status": ("regressed" if -delta > throughput_drop
                           else "ok"),
                "value": round(lv, 2), "baseline": round(bmed, 2),
                "delta_frac": round(delta, 4),
                "threshold": throughput_drop})
        base_p99: Dict[str, List[float]] = {}
        for b in base:
            for cls, lr in b["latency"].items():
                base_p99.setdefault(cls, []).append(float(lr["p99_s"]))
        for cls, vals in sorted(base_p99.items()):
            lr = lrow["latency"].get(cls)
            if lr is None:
                checks.append({"check": f"{name}:p99:{cls}",
                               "status": "missing",
                               "note": "baseline has this length "
                                       "class, latest row does not"})
                continue
            med = _median(vals)
            new = float(lr["p99_s"])
            regressed = (med > 0
                         and (new - med) / med > p99_growth
                         and new - med >= p99_min_abs_s)
            checks.append({
                "check": f"{name}:p99:{cls}",
                "status": "regressed" if regressed else "ok",
                "value": round(new, 3), "baseline": round(med, 3),
                "threshold": p99_growth})
        base_acc: Dict[str, List[float]] = {}
        for b in base:
            for fam, a in b["accuracy"].items():
                base_acc.setdefault(fam, []).append(
                    float(a["identity_after"]))
        for fam, a in sorted(lrow["accuracy"].items()):
            la = float(a["identity_after"])
            vals = base_acc.get(fam)
            if not vals:
                checks.append({"check": f"{name}:identity:{fam}",
                               "status": "skipped",
                               "note": "no baseline rows score this "
                                       "family yet"})
                continue
            med = _median(vals)
            checks.append({
                "check": f"{name}:identity:{fam}",
                "status": ("regressed" if la < med - identity_drop
                           else "ok"),
                "value": round(la, 4), "baseline": round(med, 4),
                "threshold": identity_drop})
        for fam in sorted(set(base_acc) - set(lrow["accuracy"])):
            checks.append({"check": f"{name}:identity:{fam}",
                           "status": "missing",
                           "note": "baseline rows score this family, "
                                   "latest row does not"})

    verdict = ("REGRESSION" if any(c["status"] == "regressed"
                                   for c in checks) else "PASS")
    return {"schema": SCHEMA_VERSION, "verdict": verdict,
            "pools": pool_names, "checks": checks}


def _resolve_paths(args_paths: List[str]) -> List[str]:
    """The files named, else ``LOAD_r<digits>*.json`` in order and every
    other ``LOAD_*.json`` after them."""
    return history_paths(args_paths, "LOAD", "r[0-9]*")


def check(args) -> int:
    """``check``: the gate over LOAD history; exit 1 on a regression."""
    paths = _resolve_paths(args.files)
    if not paths:
        print("load-check: no LOAD history files found", file=sys.stderr)
        return 0
    verdict = load_check(load_rows(paths),
                         throughput_drop=args.throughput_drop,
                         p99_growth=args.p99_growth,
                         p99_min_abs_s=args.p99_min_abs_s,
                         identity_drop=args.identity_drop,
                         window=args.window)
    for c in verdict["checks"]:
        if c["status"] == "regressed":
            print(f"LOAD-REGRESSION: {c['check']} = {c.get('value')}"
                  + (f" vs baseline {c['baseline']}" if "baseline" in c
                     else "")
                  + (f" (threshold {c['threshold']})" if "threshold" in c
                     else ""), file=sys.stderr)
        elif c["status"] == "missing":
            print(f"load-check: missing — {c.get('note', c)}",
                  file=sys.stderr)
    print(json.dumps(verdict, sort_keys=True))
    if verdict["verdict"] == "REGRESSION":
        return 1
    print(f"load-check: {verdict['verdict']} "
          f"({len(verdict['pools'])} pool(s))", file=sys.stderr)
    return 0


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="proovread-tpu-torch-load",
        description="Fleet load scoreboard: run the multi-replica load "
                    "smoke (one LOAD row per scenario) and gate the "
                    "history.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    smk = sub.add_parser("smoke",
                         help="2-replica fleet: slam traffic + mid-wave "
                              "replica kill + overload wall; prints one "
                              "LOAD row per scenario")
    smk.add_argument("--out", default=None, metavar="FILE",
                     help="append LOAD rows to this file (JSON-lines)")
    smk.add_argument("--replicas", type=int, default=2)
    smk.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="where the replicas' waves and the scoring run "
                          "(default: the card)")
    chk = sub.add_parser("check", help="gate: exit 1 on regression")
    chk.add_argument("files", nargs="*",
                     help="LOAD history files (default: LOAD_*.json)")
    chk.add_argument("--throughput-drop", type=float,
                     default=THROUGHPUT_DROP)
    chk.add_argument("--p99-growth", type=float, default=P99_GROWTH)
    chk.add_argument("--p99-min-abs-s", type=float,
                     default=P99_MIN_ABS_S)
    chk.add_argument("--identity-drop", type=float,
                     default=IDENTITY_DROP)
    chk.add_argument("--window", type=int, default=BASELINE_WINDOW)
    args = ap.parse_args(argv)
    if args.cmd == "check":
        return check(args)
    ok, rows = run_smoke(n_replicas=args.replicas,
                         pipeline_config=smoke_config(args.device))
    for row in rows:
        print(json.dumps(row, sort_keys=True))
    if args.out and rows:
        with open(args.out, "a") as fh:
            for row in rows:
                fh.write(json.dumps(row, sort_keys=True) + "\n")
        _log(f"{len(rows)} LOAD row(s) appended to {args.out}")
    _log("PASS" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
