"""Port parity: the fleet layer (``serve/fleet.py``, ``serve/loadgen.py``,
``obs/load.py``), the counterpart of the tier-1 cases of the JAX package's
``tests/test_fleet.py``.

Covered: the replica-scoped fault grammar; the seeded traffic generator,
equal to the JAX package's for the same scenario; the ONT error mix; live
dispatcher drills without waves (heartbeat identity, a single probe blip
that is not a death, an unordinaled kill, a fleet-level duplicate, a
stalled drain escalated to a kill); and, with real waves on the CPU
(scan engine, one pass, a 1,500-base genome), least-loaded placement, a
dead replica's journal handed off to the survivor, a handoff that finds
no taker counted as orphaned, and the LOAD row of such a run, which both
packages' ``validate_load`` accept. A replica's worker is held while the
test needs its jobs queued (``_held``), so the fleet's states are
deterministic. The whole ``slam`` drill is ``slow``, as in the JAX
package."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from proovread_tpu.obs.validate import validate_load as j_validate_load
from proovread_tpu.serve.loadgen import SCENARIOS as J_SCENARIOS
from proovread_tpu.serve.loadgen import generate_traffic as j_traffic

from proovread_tpu_torch.io.simulate import (random_genome,
                                             simulate_ont_reads,
                                             simulate_short_reads)
from proovread_tpu_torch.obs.accuracy import edit_alignment
from proovread_tpu_torch.obs.load import (FleetScoreboard, build_row,
                                          score_fleet_accuracy)
from proovread_tpu_torch.obs.validate import validate_load
from proovread_tpu_torch.pipeline.driver import PipelineConfig
from proovread_tpu_torch.pipeline.trim import TrimParams
from proovread_tpu_torch.serve import server as tserver
from proovread_tpu_torch.serve.admission import TenantQuota
from proovread_tpu_torch.serve.fleet import FleetConfig, FleetDispatcher
from proovread_tpu_torch.serve.loadgen import (POISON_KINDS, SCENARIOS,
                                               SCORED_FAMILIES, LoadScenario,
                                               family_truth,
                                               generate_traffic)
from proovread_tpu_torch.testing.faults import (FLEET_KINDS, FaultPlan,
                                                InjectedDispatchTimeout,
                                                InjectedFleetFault,
                                                InjectedReplicaDeath,
                                                InjectedStalledDrain)

pytestmark = pytest.mark.faults


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite's workers
    share a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# unit: replica-scoped fault grammar
# --------------------------------------------------------------------------

class TestFleetFaultGrammar:
    def test_parse_addresses_replica_and_ordinal(self):
        plan = FaultPlan.from_spec("replica_death@r1.j10")
        (r,) = plan.rules
        assert (r.kind, r.replica, r.jord) == ("replica_death", 1, 10)
        assert r.matches_fleet(1, 10, "replica_death")
        assert not r.matches_fleet(0, 10, "replica_death")
        assert not r.matches_fleet(1, 9, "replica_death")
        assert not r.matches_fleet(1, 10, "stalled_drain")

    def test_unordinaled_rule_fires_at_next_probe(self):
        plan = FaultPlan.from_spec("stalled_drain@r0")
        assert plan.rules[0].matches_fleet(0, None, "stalled_drain")
        assert not plan.rules[0].matches_fleet(1, None, "stalled_drain")

    def test_wildcard_replica(self):
        plan = FaultPlan.from_spec("dispatch_timeout@*")
        assert plan.fires_fleet(0, "dispatch_timeout")
        assert plan.fires_fleet(3, "dispatch_timeout")

    def test_count_bounds_firings(self):
        plan = FaultPlan.from_spec("dispatch_timeout@r0x2")
        assert plan.fires_fleet(0, "dispatch_timeout")
        assert plan.fires_fleet(0, "dispatch_timeout")
        assert not plan.fires_fleet(0, "dispatch_timeout")

    def test_check_fleet_raises_typed_attributed_faults(self):
        for kind, exc in (("replica_death", InjectedReplicaDeath),
                          ("stalled_drain", InjectedStalledDrain),
                          ("dispatch_timeout", InjectedDispatchTimeout)):
            plan = FaultPlan.from_spec(f"{kind}@r2")
            with pytest.raises(exc) as ei:
                plan.check_fleet(2, kind)
            assert isinstance(ei.value, InjectedFleetFault)
            assert ei.value.replica == 2
            assert ei.value.kind == kind

    def test_site_misaddressing_rejected(self):
        for bad in ("replica_death@b0", "replica_death@j3",
                    "replica_death@d1", "replica_death@r0.p2",
                    "compile_error@r0", "worker@r1"):
            with pytest.raises(ValueError):
                FaultPlan.from_spec(bad)

    def test_every_fleet_kind_parses(self):
        for kind in FLEET_KINDS:
            assert FaultPlan.from_spec(f"{kind}@r0").active


# --------------------------------------------------------------------------
# unit: seeded traffic generator
# --------------------------------------------------------------------------

class TestLoadGen:
    def test_deterministic_same_seed(self):
        _, a = generate_traffic(SCENARIOS["slam"])
        _, b = generate_traffic(SCENARIOS["slam"])
        assert [j.job_id for j in a] == [j.job_id for j in b]
        assert [j.arrival_s for j in a] == [j.arrival_s for j in b]
        assert (json.dumps([j.wire for j in a], sort_keys=True)
                == json.dumps([j.wire for j in b], sort_keys=True))

    @pytest.mark.parametrize("name", sorted(SCENARIOS))
    def test_traffic_equals_reference(self, name):
        """The same scenario gives the JAX package's genome, wire payloads,
        arrivals, families and truth."""
        assert SCENARIOS[name] == type(SCENARIOS[name])(
            **vars(J_SCENARIOS[name]))
        gt, tj = generate_traffic(SCENARIOS[name])
        gj, jj = j_traffic(J_SCENARIOS[name])
        np.testing.assert_array_equal(gt, gj)
        assert json.dumps([j.wire for j in tj], sort_keys=True) == \
            json.dumps([j.wire for j in jj], sort_keys=True)
        for x, y in zip(tj, jj):
            assert (x.job_id, x.tenant, x.family, x.mode, x.arrival_s,
                    x.expect_reject, x.burst) == \
                (y.job_id, y.tenant, y.family, y.mode, y.arrival_s,
                 y.expect_reject, y.burst)
            assert sorted(x.truth) == sorted(y.truth)
            for k in x.truth:
                np.testing.assert_array_equal(x.truth[k], y.truth[k])

    def test_poison_jobs_carry_expected_reasons(self):
        _, jobs = generate_traffic(SCENARIOS["slam"])
        poison = [j for j in jobs if j.family == "poison"]
        assert len(poison) >= len(POISON_KINDS)
        assert all(j.expect_reject for j in poison)
        assert all(not j.expect_reject for j in jobs
                   if j.family != "poison")

    def test_scorable_families_carry_truth(self):
        _, jobs = generate_traffic(SCENARIOS["slam"])
        fams = {j.family for j in jobs}
        assert {"clr", "ont", "ccs"} <= fams
        for j in jobs:
            if j.family in SCORED_FAMILIES:
                assert set(j.truth) == {r.id for r in j.records}
        truth = family_truth(jobs)
        assert "ccs" not in truth
        assert "ont" in truth and "clr" in truth

    def test_bursts_and_arrival_monotonic(self):
        _, jobs = generate_traffic(SCENARIOS["slam"])
        assert any(j.burst for j in jobs)
        arr = [j.arrival_s for j in jobs]
        assert arr == sorted(arr)


def test_ont_error_mix_indel_dominated():
    """Deletions dominate every other class and indels together far
    outweigh substitutions (the nanopore profile)."""
    genome = random_genome(3000, seed=7)
    reads, truth = simulate_ont_reads(genome, 4000, mean_len=400,
                                      min_len=200, seed=7)
    assert reads and len(reads) == len(truth)
    from proovread_tpu_torch.ops.encode import encode_ascii
    tot = {"sub": 0, "ins": 0, "del": 0}
    for rec, src in zip(reads, truth):
        cls = edit_alignment(encode_ascii(rec.seq), src)
        for k in tot:
            tot[k] += cls[k]
    assert tot["del"] > tot["ins"] > 0
    assert tot["del"] > tot["sub"]
    assert tot["ins"] + tot["del"] > 2 * tot["sub"]


# --------------------------------------------------------------------------
# live fleet drills (no waves)
# --------------------------------------------------------------------------

def _pcfg():
    return PipelineConfig(engine="scan", n_iterations=1, sampling=False,
                          batch_reads=8, host_chunk_rows=512,
                          trim=TrimParams(min_length=150), device="cpu")


def _fleet(tmp_path, shorts=None, **cfg_over):
    if shorts is None:
        genome = random_genome(400, seed=1)
        shorts = simulate_short_reads(genome, 5.0, seed=2)
    cfg = FleetConfig(state_dir=str(tmp_path / "fleet"), n_replicas=2,
                      heartbeat_s=0.05, suspect_after=2,
                      stall_timeout_s=0.5)
    for k, v in cfg_over.items():
        setattr(cfg, k, v)
    sb = FleetScoreboard()
    disp = FleetDispatcher(shorts, cfg, _pcfg(), scoreboard=sb)
    disp.start()
    return disp, sb


def _wait(cond, timeout=10.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "condition never held"
        time.sleep(0.02)


class TestFleetDrills:
    def test_heartbeat_probes_identity_of_every_replica(self, tmp_path):
        disp, sb = _fleet(tmp_path)
        try:
            _wait(lambda: len(sb.summary()["replicas_seen"]) == 2)
            assert sb.summary()["replicas_seen"] == ["r0", "r1"]
            last = sb.samples[-1]
            assert last["uptime_s"] >= 0.0
            assert last["draining"] is False
        finally:
            disp.close()

    def test_single_probe_blip_is_not_a_death(self, tmp_path):
        disp, sb = _fleet(tmp_path, fault_spec="dispatch_timeout@r0x1")
        try:
            time.sleep(0.6)  # many beats; the blip fires exactly once
            r0 = disp.replicas[0]
            assert r0.alive and r0.dead_reason == ""
            assert r0.fail_streak <= 1
        finally:
            disp.close()

    def test_unordinaled_kill_hands_off_empty_journal(self, tmp_path):
        disp, sb = _fleet(tmp_path, fault_spec="replica_death@r1")
        try:
            _wait(lambda: not disp.replicas[1].alive)
            r1 = disp.replicas[1]
            assert "replica_death" in r1.dead_reason
            assert r1.final_slo is not None
            assert disp.orphaned == 0 and disp.handoffs == 0
            assert disp.replicas[0].alive
        finally:
            disp.close()

    def test_fleet_level_duplicate_rejected_before_routing(self,
                                                           tmp_path):
        disp, sb = _fleet(tmp_path)
        try:
            disp.books["dup-1"] = {"job_id": "dup-1", "status":
                                   "accepted"}
            resp = disp.dispatch(
                {"op": "submit", "job_id": "dup-1", "tenant": "t0",
                 "mode": "clr", "reads": []},
                family="poison", expect_reject="duplicate-job")
            assert resp["ok"] is False
            assert resp["reason"] == "duplicate-job"
            rej = disp.rejections[-1]
            assert rej["job_id"] == "dup-1" and rej["expected"]
        finally:
            disp.close()

    def test_stalled_drain_escalates_to_kill(self, tmp_path):
        disp, sb = _fleet(tmp_path, fault_spec="stalled_drain@r0")
        disp.drain_all()
        try:
            r0, r1 = disp.replicas
            assert not r0.alive and not r0.drain_clean
            assert "stalled" in r0.dead_reason
            assert r1.drain_clean and r1.dead_reason == "drained"
            assert disp.orphaned == 0
        finally:
            disp.close()

    def test_shutdown_ends_every_replica_thread(self, tmp_path):
        """A killed replica and a drained one: once the fleet's shutdown
        returns, no server thread runs (a running listener held its
        server, and the server's short-read sets on the card, past the
        load smoke's leak check)."""
        disp, sb = _fleet(tmp_path, fault_spec="replica_death@r1")
        try:
            _wait(lambda: not disp.replicas[1].alive)
            disp.drain_all()
            threads = [t for rep in disp.replicas
                       for t in rep.server._threads]
            assert len(threads) == 4
            assert not any(t.is_alive() for t in threads)
        finally:
            disp.close()

    def test_artifact_boot_refused(self, tmp_path):
        """An artifact without a manifest is refused before any state;
        ``tests/test_torch_boot.py`` holds the boot from a real one."""
        with pytest.raises(FileNotFoundError, match="manifest.json"):
            FleetDispatcher([], FleetConfig(
                state_dir=str(tmp_path / "f"), artifact_dir="art"), _pcfg())
        assert not os.path.exists(tmp_path / "f")


# --------------------------------------------------------------------------
# fleets with real waves: placement, handoff, orphaning, the LOAD row
# --------------------------------------------------------------------------

TINY = LoadScenario(name="tiny", seed=3, n_jobs=4, n_tenants=2,
                    genome_size=1500, families=("clr",),
                    max_reads_per_job=2, mean_len=420, min_len=300)


@pytest.fixture
def _held(monkeypatch):
    """Replica ids whose worker runs no wave until it is drained or the
    id is released: their jobs stay queued (journaled ``accepted``)."""
    held = set()
    release = threading.Event()
    pump = tserver.CorrectionServer.pump

    def held_pump(self):
        while self.replica_id in held and not release.is_set():
            if self._drain.wait(0.02):
                return False
        return pump(self)

    monkeypatch.setattr(tserver.CorrectionServer, "pump", held_pump)
    yield held, release
    release.set()


def _tiny_fleet(tmp_path, **cfg_over):
    genome, jobs = generate_traffic(TINY)
    shorts = simulate_short_reads(genome, 12.0, seed=TINY.seed + 1)
    disp, sb = _fleet(tmp_path, shorts=shorts, **cfg_over)
    _wait(lambda: len(sb.summary()["replicas_seen"]) == 2)
    return disp, sb, jobs


def _row(disp, sb, jobs, t0):
    disp.wait_all(timeout=120)
    disp.drain_all()
    wall = time.monotonic() - t0
    fleet = disp.summary()
    acc = score_fleet_accuracy(jobs, disp.results, device="cpu")
    return build_row(TINY.name, 2, "cpu", wall, fleet, sb, acc)


@pytest.mark.heavy
def test_placement_least_loaded_then_handoff(tmp_path, _held):
    """Least-loaded placement (ties rotate); killing a replica whose jobs
    are queued hands them to the survivor under the same id; the LOAD row
    of the run passes both packages' ``validate_load``."""
    held, release = _held
    held.update({"r0", "r1"})
    disp, sb, jobs = _tiny_fleet(tmp_path)
    try:
        t0 = time.monotonic()
        placed = [disp.dispatch(j.wire, family=j.family)["replica"]
                  for j in jobs[:3]]
        assert placed == [0, 1, 0]
        disp.kill_replica(1)
        assert disp.handoffs == 1 and disp.orphaned == 0
        assert disp.books[jobs[1].job_id]["replica"] == 0
        assert disp.books[jobs[1].job_id]["handoffs"] == 1
        release.set()
        row = _row(disp, sb, jobs, t0)
    finally:
        disp.close()
    assert row["jobs"]["routed"] == 3 and row["jobs"]["completed"] == 3
    assert row["handoff"] == {"deaths": 1, "handoffs": 1, "orphaned": 0}
    assert row["backend"] == "cpu"
    assert set(row["accuracy"]) == {"clr"}
    assert row["accuracy"]["clr"]["n_scored"] == sum(
        len(j.records) for j in jobs[:3])
    assert j_validate_load(row) == validate_load(row)


@pytest.mark.heavy
def test_handoff_without_taker_is_orphaned(tmp_path, _held):
    """A dead replica's job that the survivor's quota cannot take is
    counted as orphaned — named, never dropped — and the identities of
    the LOAD row still hold in both validators."""
    held, release = _held
    held.update({"r0", "r1"})
    disp, sb, jobs = _tiny_fleet(tmp_path, quota=TenantQuota(max_jobs=1))
    try:
        t0 = time.monotonic()
        # two jobs of one tenant: the survivor's quota holds the first
        by_tenant = {}
        for j in jobs:
            by_tenant.setdefault(j.tenant, []).append(j)
        first, second = max(by_tenant.values(), key=len)[:2]
        a = disp.dispatch(first.wire, family="clr")
        b = disp.dispatch(second.wire, family="clr")
        assert {a["replica"], b["replica"]} == {0, 1}
        dead = b["replica"]
        victim = next(e for e in disp.books.values()
                      if e["replica"] == dead)
        disp.kill_replica(dead)
        assert disp.orphaned == 1 and disp.handoffs == 0
        assert victim["status"] == "orphaned"
        release.set()
        row = _row(disp, sb, jobs, t0)
    finally:
        disp.close()
    assert row["jobs"]["orphaned"] == 1 and row["jobs"]["completed"] == 1
    assert j_validate_load(row) == validate_load(row)


# --------------------------------------------------------------------------
# heavy: the whole slam drill through a real 2-replica fleet
# --------------------------------------------------------------------------

@pytest.mark.slow
def test_fleet_e2e_slam_with_midwave_kill(tmp_path):
    """The full load drill: slam traffic through 2 replicas, replica 1
    killed at dispatch ordinal 10, every identity pinned by
    validate_load, zero jobs lost, per-family accuracy uplift."""
    from proovread_tpu_torch.obs.load import run_fleet_scenario
    r = run_fleet_scenario(SCENARIOS["slam"], n_replicas=2,
                           state_dir=str(tmp_path / "fleet"),
                           fault_spec="replica_death@r1.j10",
                           pipeline_config=_pcfg(), time_scale=0.0)
    row = r["row"]
    assert row["handoff"]["deaths"] == 1
    assert row["jobs"]["handoffs"] >= 1
    assert row["jobs"]["orphaned"] == 0
    assert row["jobs"]["failed"] == 0
    for fam, acc in row["accuracy"].items():
        assert acc["identity_after"] > acc["identity_before"], fam
    assert row["heartbeat"]["replicas_seen"] == ["r0", "r1"]
    assert j_validate_load(row) == validate_load(row)
