"""Port parity: the resilience layer (``testing/faults.py``,
``pipeline/resilience.py`` and the driver's ladder, journal and fault
sites), held against the JAX package and against the reference's own
tests (``tests/test_resilience.py``) ported to the port, on the CPU.

Tolerance: exact. ``FaultPlan`` parses, accepts and rejects the same
specs and fires at the same sites with the same messages;
``classify_fault`` gives the same kind for the same exception, and ``None``
for the port's kernel build and launch errors and CUDA errors;
``run_fingerprint``, ``bucket_key`` and journal files are byte-equal to the
JAX package's; a faulted run equals an ``engine="scan"`` run record for
record; a resumed run writes the same bytes as an uninterrupted one, QC
records included."""

import dataclasses
import io
import json
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from proovread_tpu.pipeline import resilience as jres
from proovread_tpu.pipeline.driver import PipelineConfig as JConfig
from proovread_tpu.pipeline.trim import TrimParams as JTrim
from proovread_tpu.testing import faults as jfaults

from proovread_tpu_torch import kernels
from proovread_tpu_torch.consensus.engine import ConsensusResult
from proovread_tpu_torch.io.fastq import FastqWriter
from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.obs import metrics as obsm
from proovread_tpu_torch.obs import qc as tqc
from proovread_tpu_torch.pipeline import resilience as tres
from proovread_tpu_torch.pipeline.driver import (Pipeline, PipelineConfig,
                                                 TaskReport)
from proovread_tpu_torch.pipeline.trim import TrimParams
from proovread_tpu_torch.state import params_from_fields
from proovread_tpu_torch.testing import faults as tfaults
from proovread_tpu_torch.testing.faults import (BucketTimeout,
                                                InjectedCompileError,
                                                InjectedOOM,
                                                WallClockExceeded)

from test_torch_pipeline import (_compare, _port_records, _rec_key,
                                 _uniform_dataset, run_both)

pytestmark = pytest.mark.faults


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on a few cores, and torch's CPU kernels in each spreading over
    every core slow all of them down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# fault plans and classification, against the reference
# --------------------------------------------------------------------------

ACCEPTED = [None, "", "compile@b0.p2; oom@b1, timeout@*.p3x2", "kernel@b3x1",
            "oom@*", "compile@b2.p7x4", "timeout@*x1", "worker@j3x1",
            "parse@*", "journal@j0", "device_lost@d1.p2", "straggler@*x2",
            "shard_oom@d0", "collective_timeout@*.p1",
            "replica_death@r1.j5", "dispatch_timeout@*.j2",
            "stalled_drain@r0x1"]
REJECTED = ["compile@pass2", "boom@b1", "worker@b1", "compile@j1",
            "device_lost@b1", "replica_death@b0", "replica_death@r1.p2",
            "oom@b1.j2", "compile@d0", "oom@r0", "parse@d1", "oom@b",
            "quota@j1.p2", "compile@b1;;nope"]


def _plan_or_error(mod, spec):
    try:
        plan = mod.FaultPlan.from_spec(spec)
    except ValueError as e:
        return None, str(e)
    return [dataclasses.asdict(r) for r in plan.rules], None


@pytest.mark.parametrize("spec", ACCEPTED + REJECTED)
def test_fault_plan_grammar_matches_jax(spec):
    got, want = _plan_or_error(tfaults, spec), _plan_or_error(jfaults, spec)
    assert got == want
    assert (want[1] is None) == (spec not in REJECTED)


def _fire_log(mod, spec, sites):
    """What each (bucket, pass) site raises (class name, message), or None;
    a (bucket, lo, hi) triple probes ``check_span``."""
    plan = mod.FaultPlan.from_spec(spec)
    out = []
    for site in sites:
        try:
            if len(site) == 3:
                plan.check_span(*site)
            else:
                plan.check(*site)
            out.append(None)
        except Exception as e:                          # noqa: BLE001
            out.append((type(e).__name__, str(e)))
    return out


def test_fault_sites_match_jax():
    spec = "compile@b0.p2;oom@b1x2;timeout@*.p3x1;kernel@b2;oom@b5.p7x1"
    sites = [(0, None), (0, 1), (0, 2), (1, None), (1, 1), (1, 2), (2, 3),
             (2, None), (3, 3), (0, 2), (4, 1), (5, 2, 4), (5, 5, 8),
             (5, 5, 8), (0, 3, 6), (0, 1, 2), (6, 1, 9)]
    got = _fire_log(tfaults, spec, sites)
    assert got == _fire_log(jfaults, spec, sites)
    assert sum(x is not None for x in got) == 8


def _exceptions(mod):
    f = mod
    out = [f.make_fault(k, "bucket 1 pass 2")
           for k in f.KINDS + f.JOB_KINDS]
    out += [f.make_fault(k, "shard 1", shard=1) for k in f.MESH_KINDS]
    out += [f.make_fault(k, "replica 0", replica=0) for k in f.FLEET_KINDS]
    out += [f.BucketTimeout("x"), f.WallClockExceeded("run"),
            f.ShardStraggler("s", shard=2), f.MeshCapExceeded("cap"),
            f.InjectedFault("plain injected")]
    msgs = ["RESOURCE_EXHAUSTED: out of HBM",
            "INTERNAL: remote_compile: response body closed",
            "Mosaic lowering failed", "some logic error",
            "device lost: chip reset", "NCCL all-reduce hung",
            "DEADLINE_EXCEEDED: rpc", "vmem limit", "Attempting to allocate "
            "1.5G", "Compilation failure at line 3", "Pallas call"]
    out += [RuntimeError(m) for m in msgs]
    out += [ValueError("RESOURCE_EXHAUSTED"), KeyboardInterrupt(),
            TypeError("compile")]
    return out


def test_classify_fault_matches_jax():
    got = [tres.classify_fault(e) for e in _exceptions(tfaults)]
    want = [jres.classify_fault(e) for e in _exceptions(jfaults)]
    assert got == want
    assert {"compile", "oom", "kernel", "timeout", None} <= set(got)


def _cuda_errors():
    out = [kernels.KernelBuildError(
               "nvcc failed:\n--- sw.cu ---\nerror: cannot compile, "
               "INTERNAL assertion, out of memory (OOM)"),
           kernels.KernelBuildError("nvcc not found (set CUDA_HOME or PATH)"),
           kernels.KernelLaunchError(
               "sw_batch: CUDA error 700 (an illegal memory access was "
               "encountered)"),
           RuntimeError("CUDA error: an illegal memory access was "
                        "encountered\nCUDA kernel errors might be "
                        "asynchronously reported at some other API call, so "
                        "the stacktrace below might be incorrect.\nCompile "
                        "with `TORCH_USE_CUDA_DSA` to enable device-side "
                        "assertions."),
           RuntimeError("CUDA error: device-side assert triggered "
                        "(RESOURCE_EXHAUSTED)")]
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        try:
            out.append(accel("CUDA error: misaligned address (compile)"))
        except TypeError:
            pass
    return out


def test_classify_fault_card_errors():
    """The card's counterparts: CUDA out of memory demotes as ``oom``; a
    failed kernel build, a kernel's CUDA error return and torch's CUDA
    errors are never absorbed, whatever marks their messages hold."""
    oom = torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.18 GiB")
    assert tres.classify_fault(oom) == "oom"
    for e in _cuda_errors():
        assert tres.classify_fault(e) is None, e


# --------------------------------------------------------------------------
# soft deadline (the reference's tests, on the port's module)
# --------------------------------------------------------------------------

def _spin(seconds):
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        pass


def _in_thread(work):
    out = {}
    t = threading.Thread(target=lambda: out.update(r=work()))
    t.start()
    t.join(timeout=15)
    return out.get("r")


class TestSoftDeadline:
    def test_times_out_python_loop(self):
        with pytest.raises(BucketTimeout, match="deadline"):
            with tres.soft_deadline(0.05, what="test"):
                _spin(5)

    def test_no_op_without_budget(self):
        with tres.soft_deadline(None):
            pass
        with tres.soft_deadline(0):
            pass

    def test_times_out_in_worker_thread(self):
        def work():
            try:
                with tres.soft_deadline(0.05, what="worker-bucket"):
                    _spin(5)
                return "completed"
            except BucketTimeout:
                return "timeout"
        assert _in_thread(work) == "timeout"

    def test_worker_thread_no_late_injection(self):
        def work():
            try:
                with tres.soft_deadline(0.1, what="quick"):
                    pass
                time.sleep(0.3)
                return "clean"
            except BucketTimeout:
                return "late-injection"
        assert _in_thread(work) == "clean"

    def test_outer_deadline_fires_inside_inner_region(self):
        with pytest.raises(WallClockExceeded):
            with tres.soft_deadline(0.05, what="run", exc=WallClockExceeded):
                with tres.soft_deadline(5.0, what="bucket"):
                    _spin(5)

    def test_outer_deadline_wins_nested_in_worker_thread(self):
        def work():
            try:
                with tres.soft_deadline(0.1, what="run",
                                        exc=WallClockExceeded):
                    try:
                        with tres.soft_deadline(10.0, what="bucket"):
                            _spin(5)
                    except BucketTimeout:
                        return "ladder-absorbed"
                return "completed"
            except WallClockExceeded:
                return "outer"
        assert _in_thread(work) == "outer"


# --------------------------------------------------------------------------
# the journal
# --------------------------------------------------------------------------

def _mini_results():
    e = np.zeros(0, np.float32)
    return [ConsensusResult(
                record=SeqRecord("a", "ACGT",
                                 qual=np.array([1, 2, 3, 40], np.uint8)),
                freqs=e, coverage=e, cigar="", chimera=[(1, 2, 0.5)]),
            ConsensusResult(
                record=SeqRecord("b", "GGTT", qual=np.zeros(4, np.uint8),
                                 desc="d"),
                freqs=e, coverage=e, cigar="")]


def _mini_reports():
    return [TaskReport("bwa-sr-1", 0.5, 10, 8, n_dropped_cov=2),
            TaskReport("demote-b0", 0.0, 0, 0, note="oom fault")]


class TestJournal:
    def test_roundtrip(self, tmp_path):
        with obsm.scope() as reg:
            j = tres.CheckpointJournal(str(tmp_path / "ckpt"), "fp1",
                                       resume=False)
            j.put("k1", 0, _mini_results(), [("a", 1, 2, 0.5)],
                  _mini_reports(), 7)
            j2 = tres.CheckpointJournal(str(tmp_path / "ckpt"), "fp1",
                                        resume=True)
            hit = j2.get("k1")
            assert j2.get("k1", require_qc=True) is None
        assert reg.counter("checkpoint_journal_writes").value() == 1
        assert reg.counter("checkpoint_journal_replays").value() == 1
        results, chim, reports, fc, qc_payload = hit
        assert fc == 7 and qc_payload is None
        assert chim == [("a", 1, 2, 0.5)]
        assert [r.record.id for r in results] == ["a", "b"]
        assert results[0].record.seq == "ACGT"
        np.testing.assert_array_equal(
            results[0].record.qual, np.array([1, 2, 3, 40], np.uint8))
        assert results[1].record.desc == "d"
        assert results[0].chimera == [(1, 2, 0.5)]
        assert reports == _mini_reports()
        assert j2.hits == 1

    def test_fingerprint_mismatch_clears(self, tmp_path):
        j = tres.CheckpointJournal(str(tmp_path / "c"), "fp1", resume=False)
        j.put("k1", 0, _mini_results(), [], [], 1)
        j2 = tres.CheckpointJournal(str(tmp_path / "c"), "OTHER", resume=True)
        assert j2.get("k1") is None
        assert not j2.entries
        assert not list((tmp_path / "c").glob("bucket_*.json"))

    def test_torn_entry_skipped(self, tmp_path):
        j = tres.CheckpointJournal(str(tmp_path / "c"), "fp1", resume=False)
        j.put("k1", 0, _mini_results(), [], [], 1, qc_records=[{"id": "a"}])
        (tmp_path / "c" / "bucket_torn.json").write_text('{"key": "t..')
        j2 = tres.CheckpointJournal(str(tmp_path / "c"), "fp1", resume=True)
        hit = j2.get("k1", require_qc=True)
        assert hit is not None and hit[4] == [{"id": "a"}]
        assert j2.get("torn") is None

    def test_journal_files_match_jax(self, tmp_path):
        """The same entry written by both packages: the same bytes."""
        from proovread_tpu.consensus.engine import \
            ConsensusResult as JResult
        from proovread_tpu.io.records import SeqRecord as JRecord
        from proovread_tpu.pipeline.driver import TaskReport as JReport
        e = np.zeros(0, np.float32)
        jresults = [JResult(record=JRecord(r.record.id, r.record.seq,
                                           qual=r.record.qual,
                                           desc=r.record.desc),
                            freqs=e, coverage=e, cigar="",
                            chimera=r.chimera) for r in _mini_results()]
        jreports = [JReport(**dataclasses.asdict(r))
                    for r in _mini_reports()]
        qc = [{"id": "a", "masked_frac": [0.5, 0.75]}]
        for mod, res, reps, d in ((jres, jresults, jreports, "j"),
                                  (tres, _mini_results(), _mini_reports(),
                                   "t")):
            mod.CheckpointJournal(str(tmp_path / d), "fp1", False).put(
                "k1", 3, res, [("a", 1, 2, 0.5)], reps, 9, qc_records=qc)
        for name in ("meta.json", "bucket_k1.json"):
            assert ((tmp_path / "t" / name).read_bytes()
                    == (tmp_path / "j" / name).read_bytes())


def test_fingerprint_and_bucket_key_match_jax():
    from proovread_tpu.align.params import BWA_SR as J_BWA_SR
    from proovread_tpu.io.records import SeqRecord as JRecord
    ids = [f"read_{i}/{i * 7}" for i in range(40)]
    wide = dataclasses.replace(J_BWA_SR, band_width=50)
    for kw in (dict(), dict(mode="mr", n_iterations=3, coverage=12.5),
               dict(engine="scan", host_chunk_rows=512, sampling=False),
               dict(align_schedule={"first": J_BWA_SR, "rest": J_BWA_SR,
                                    "2": wide, "finish": J_BWA_SR}),
               dict(mesh_shards=4, ladder=False, bucket_timeout=3.0)):
        jcfg = JConfig(**kw)
        fields = dataclasses.asdict(jcfg)
        fps = {jres.run_fingerprint(jcfg, ids, 1234)}
        for device in ("cpu", "cuda"):
            tcfg = params_from_fields(PipelineConfig,
                                      {**fields, "device": device})
            fps.add(tres.run_fingerprint(tcfg, ids, 1234))
        assert len(fps) == 1, kw
    assert (tres.run_fingerprint(PipelineConfig(), ids, 5)
            != tres.run_fingerprint(PipelineConfig(), ids, 6))
    recs = [SeqRecord(i, "ACGT") for i in ids]
    jrecs = [JRecord(i, "ACGT") for i in ids]
    assert tres.bucket_key(recs) == jres.bucket_key(jrecs)
    assert tres.bucket_key(recs[:5]) == jres.bucket_key(jrecs[:5])


# --------------------------------------------------------------------------
# the ladder and the journal in Pipeline.run (the reference's tests)
# --------------------------------------------------------------------------

def _cfg(**kw):
    base = dict(mode="sr", n_iterations=2, sampling=False, engine="device",
                device_chunk=128, batch_reads=8, host_chunk_rows=512,
                trim=TrimParams(min_length=150), device="cpu")
    base.update(kw)
    return PipelineConfig(**base)


def _dataset(seed, **kw):
    longs, srs = _uniform_dataset(np.random.default_rng(seed), **kw)
    return _port_records(longs), _port_records(srs)


def _fastq_bytes(records):
    buf = io.BytesIO()
    w = FastqWriter(buf)
    for r in records:
        w.write(r)
    return buf.getvalue()


@pytest.mark.heavy
class TestLadder:
    def test_injected_faults_degrade_to_scan_parity(self):
        """compile at bucket 0 pass 2 and OOM at bucket 1: both buckets walk
        fused -> eager -> chunk-halved -> host-scan, every demotion is
        reported and counted, and the output equals an ``engine="scan"``
        run record for record."""
        longs, srs = _dataset(41, n_long=10)
        with obsm.scope() as reg:
            res_dev = Pipeline(_cfg(
                device_chunk=256,
                fault_spec="compile@b0.p2;oom@b1")).run(longs, srs)
        res_scan = Pipeline(_cfg(engine="scan")).run(longs, srs)
        assert _rec_key(res_dev.untrimmed) == _rec_key(res_scan.untrimmed)
        assert _rec_key(res_dev.trimmed) == _rec_key(res_scan.trimmed)
        assert res_dev.chimera == res_scan.chimera
        d0 = [r for r in res_dev.reports if r.task == "demote-b0"]
        d1 = [r for r in res_dev.reports if r.task == "demote-b1"]
        assert len(d0) == 3 and len(d1) == 3
        assert "compile" in d0[0].note and "oom" in d1[0].note
        assert "host-scan" in d0[-1].note and "host-scan" in d1[-1].note
        c = reg.counter("resilience_demotions")
        assert [c.value(to_rung=r) for r in
                ("eager", "chunk-halved", "host-scan")] == [2, 2, 2]
        f = reg.counter("device_faults")
        assert f.value(kind="compile") == 3 and f.value(kind="oom") == 3

    def test_ladder_off_fails_fast(self):
        longs, srs = _dataset(42, n_long=8)
        with pytest.raises(InjectedOOM):
            Pipeline(_cfg(ladder=False, fault_spec="oom@b0")).run(longs, srs)

    def test_non_device_fault_not_absorbed(self):
        longs, srs = _dataset(43, n_long=8)
        pipe = Pipeline(_cfg())

        def boom(*a, **k):
            raise ValueError("a real bug")
        pipe._run_batch_device = boom
        with pytest.raises(ValueError, match="a real bug"):
            pipe.run(longs, srs)

    @pytest.mark.parametrize("make", [
        lambda: kernels.KernelBuildError("nvcc failed: compile INTERNAL"),
        lambda: kernels.KernelLaunchError("bsw: CUDA error 700 (OOM)"),
        lambda: RuntimeError("CUDA error: an illegal memory access was "
                             "encountered\nCompile with TORCH_USE_CUDA_DSA")],
        ids=["build", "launch", "sticky"])
    def test_kernel_errors_propagate(self, make):
        """A kernel that does not build or reports a CUDA error is never
        demoted: the run fails at the first rung, with nothing counted."""
        longs, srs = _dataset(43, n_long=8)
        pipe = Pipeline(_cfg())
        calls = []

        def boom(*a, **k):
            calls.append(k.get("level"))
            raise make()
        pipe._run_batch_device = boom
        with obsm.scope() as reg:
            with pytest.raises(RuntimeError):
                pipe.run(longs, srs)
        assert len(calls) == 1 and calls[0].name == "fused"
        assert reg.counter("resilience_demotions").series == {}

    def test_failed_attempt_released_before_next_rung(self):
        """After an OOM the failed attempt's tensors are gone before the
        next rung runs: nothing holds the attempt's frames."""
        longs, srs = _dataset(44, n_long=8)
        pipe = Pipeline(_cfg())
        real = pipe._run_batch_device
        refs = []

        def attempt(*a, **k):
            if not refs:
                big = torch.zeros(1 << 20)
                refs.append(weakref.ref(big))
                raise tfaults.make_fault("oom", "bucket 0")
            assert refs[0]() is None, "the OOM'd attempt's tensor survived"
            return real(*a, **k)
        pipe._run_batch_device = attempt
        res = pipe.run(longs, srs)
        assert [r.task for r in res.reports].count("demote-b0") == 1

    def test_demotion_reports_carry_producing_rung(self):
        longs, srs = _dataset(59, n_long=8)
        with obsm.scope() as reg:
            res = Pipeline(_cfg(n_iterations=1,
                                fault_spec="compile@b0")).run(longs, srs)
        demos = [r for r in res.reports if r.task == "demote-b0"]
        # device_chunk 128 clamps chunk-halved back to the block floor:
        # the walk is fused -> eager -> host-scan
        assert [d.note.split("'")[3] for d in demos] == ["eager",
                                                         "host-scan"]
        assert len(res.untrimmed) == 8
        c = reg.counter("resilience_demotions")
        assert c.value(to_rung="eager") == 1
        assert c.value(to_rung="host-scan") == 1
        assert reg.counter("device_faults").value(kind="compile") == 2
        snap = {tuple(sorted(s["labels"].items())): s["value"]
                for s in res.metrics["counters"][
                    "resilience_demotions"]["series"]}
        assert snap == {(("to_rung", "eager"),): 1,
                        (("to_rung", "host-scan"),): 1}

    def test_demotion_rewinds_kpi_counters(self):
        longs, srs = _dataset(62, n_long=8)
        with obsm.scope() as reg, tqc.scope() as rec:
            res = Pipeline(_cfg(n_iterations=2,
                                fault_spec="oom@b0.p2")).run(longs, srs)
        per_task = {}
        for r in res.reports:
            if not r.note:
                per_task[r.task] = per_task.get(r.task, 0) + 1
        c = reg.counter("task_runs")
        for task, n in per_task.items():
            assert c.value(task=task) == n, (task, n, c.series)
        assert reg.counter("candidates_total").value() == \
            sum(r.n_candidates for r in res.reports if not r.note)
        assert reg.counter("admitted_total").value() == \
            sum(r.n_admitted for r in res.reports if not r.note)
        assert reg.counter("resilience_demotions").value(
            to_rung="eager") == 1
        # the QC trajectories rewound too: one entry a pass that remained
        n_pass = sum(1 for r in res.reports
                     if not r.note and r.task != "bwa-sr-finish")
        assert all(len(r["masked_frac"]) == n_pass
                   for r in rec.records.values())

    def test_timeout_fault_demotes(self):
        longs, srs = _dataset(50, n_long=8)
        res = Pipeline(_cfg(n_iterations=1,
                            fault_spec="timeout@b0x3")).run(longs, srs)
        demos = [r for r in res.reports if r.task == "demote-b0"]
        assert len(demos) == 2
        assert all("timeout" in d.note for d in demos)
        assert "host-scan" in demos[-1].note
        assert len(res.untrimmed) == 8

    @pytest.mark.parametrize("seed", [11, 12])
    def test_eager_rung_equals_fused(self, seed):
        """A fault at the fused span, fired once: the bucket reruns on the
        eager rung (the per-pass loop) and its records, chimeras, pass
        reports and QC records equal the unfaulted fused run's."""
        longs, srs = _dataset(seed)
        kw = dict(n_iterations=3, batch_reads=8,
                  trim=TrimParams(min_length=100))
        if seed == 11:
            kw.update(mask_shortcut_frac=2.0, mask_min_gain_frac=-1.0)
        out = []
        for spec in (None, "kernel@b0.p3x1"):
            with tqc.scope() as rec:
                res = Pipeline(_cfg(fault_spec=spec, **kw)).run(longs, srs)
            out.append((res, rec.records))
        (fused, frec), (eager, erec) = out
        assert [r.task for r in eager.reports].count("demote-b0") == 1
        assert "to 'eager'" in eager.reports[0].note
        assert _rec_key(eager.untrimmed) == _rec_key(fused.untrimmed)
        assert _rec_key(eager.trimmed) == _rec_key(fused.trimmed)
        assert eager.chimera == fused.chimera
        assert eager.reports[1:] == fused.reports
        assert erec == frec


@pytest.mark.heavy
def test_eager_loop_matches_jax():
    """A per-iteration ``align_schedule`` (pass 2 at its own band) runs
    passes 2..N eagerly in both packages: records, reports, metrics and
    QC records equal."""
    from proovread_tpu.align.params import BWA_SR as J_BWA_SR
    from proovread_tpu.align.params import BWA_SR_FINISH as J_FIN
    longs, srs = _uniform_dataset(np.random.default_rng(15))
    sched = {"first": J_BWA_SR, "rest": J_BWA_SR, "finish": J_FIN,
             "2": dataclasses.replace(J_BWA_SR, band_width=24)}
    jres_, tres_ = run_both(
        longs, srs, n_iterations=3, sampling=False, batch_reads=8,
        device_chunk=128, trim=JTrim(min_length=100), align_schedule=sched,
        mask_shortcut_frac=2.0, mask_min_gain_frac=-1.0)
    _compare(jres_, tres_)
    assert [r.task for r in tres_.reports] == [
        "bwa-sr-1", "bwa-sr-2", "bwa-sr-3", "bwa-sr-finish"]


@pytest.mark.heavy
def test_faulted_run_matches_jax():
    """The JAX twin of the faulted run: the same fault spec walks the same
    rungs in both packages, with equal records, reports (demotion notes
    included), metrics and QC records."""
    longs, srs = _uniform_dataset(np.random.default_rng(41), n_long=10)
    jres_, tres_ = run_both(
        longs, srs, n_iterations=2, sampling=False, batch_reads=8,
        device_chunk=128, host_chunk_rows=512, trim=JTrim(min_length=150),
        fault_spec="oom@b0;kernel@b1.p2x1")
    _compare(jres_, tres_)
    notes = [r.note for r in tres_.reports if r.task.startswith("demote")]
    assert [n.split("'")[3] for n in notes] == ["eager", "host-scan",
                                                "eager"]


# --------------------------------------------------------------------------
# checkpoint and resume
# --------------------------------------------------------------------------

def _bucketed_dataset(seed, n_sr=36):
    """Three length classes -> three device buckets (512/1024/2048)."""
    from proovread_tpu_torch.ops.encode import decode_codes, revcomp_codes
    rng = np.random.default_rng(seed)
    G = 2000
    genome = rng.integers(0, 4, G).astype(np.int8)
    longs = []
    k = 0
    for read_len, cnt in ((260, 3), (600, 3), (1400, 3)):
        for _ in range(cnt):
            a = int(rng.integers(0, G - read_len))
            longs.append(SeqRecord(f"r{k}",
                                   decode_codes(genome[a:a + read_len])))
            k += 1
    srs = []
    for i in range(n_sr):
        st = int(rng.integers(0, G - 100))
        seq = genome[st:st + 100].copy()
        if rng.random() < 0.5:
            seq = revcomp_codes(seq)
        srs.append(SeqRecord(f"s{i}", decode_codes(seq),
                             qual=np.full(100, 30, np.uint8)))
    return longs, srs


def _qc_bytes(rec, res):
    buf = io.StringIO()
    for rid in sorted(rec.records):
        buf.write(json.dumps(rec.records[rid], sort_keys=True) + "\n")
    return buf.getvalue() + json.dumps(res.qc, sort_keys=True)


@pytest.mark.heavy
class TestCheckpointResume:
    def test_kill_after_bucket_and_resume_byte_identical(self, tmp_path):
        """A run killed at bucket 2 of 3 (fail fast) and restarted with
        resume replays buckets 0-1 from the journal and writes the same
        FASTQ bytes and QC records as an uninterrupted run."""
        longs, srs = _bucketed_dataset(47)
        with tqc.scope() as rec0:
            ref = Pipeline(_cfg(n_iterations=1, checkpoint_dir=str(
                tmp_path / "ref_ckpt"))).run(longs, srs)
        ckpt = str(tmp_path / "ckpt")
        with tqc.scope(), pytest.raises(InjectedCompileError):
            Pipeline(_cfg(n_iterations=1, checkpoint_dir=ckpt, ladder=False,
                          fault_spec="compile@b2")).run(longs, srs)
        with obsm.scope() as reg, tqc.scope() as rec1:
            res = Pipeline(_cfg(n_iterations=1, checkpoint_dir=ckpt,
                                resume=True)).run(longs, srs)
        resumed = [r for r in res.reports if r.task.startswith("resume-b")]
        assert len(resumed) == 2
        assert all("journal" in r.note for r in resumed)
        assert reg.counter("checkpoint_journal_replays").value() == 2
        assert reg.counter("checkpoint_journal_writes").value() == 1
        assert _fastq_bytes(res.untrimmed) == _fastq_bytes(ref.untrimmed)
        assert _fastq_bytes(res.trimmed) == _fastq_bytes(ref.trimmed)
        assert res.chimera == ref.chimera
        assert _qc_bytes(rec1, res) == _qc_bytes(rec0, ref)
        assert [r for r in res.reports if not r.note] == ref.reports

    def test_resume_full_journal_recomputes_nothing(self, tmp_path):
        longs, srs = _bucketed_dataset(48)
        ckpt = str(tmp_path / "ckpt")
        res1 = Pipeline(_cfg(n_iterations=1,
                             checkpoint_dir=ckpt)).run(longs, srs)
        pipe = Pipeline(_cfg(n_iterations=1, checkpoint_dir=ckpt,
                             resume=True))

        def boom(*a, **k):
            raise AssertionError("a journaled bucket recomputed")
        pipe._run_bucket_resilient = boom
        res2 = pipe.run(longs, srs)
        resumed = [r for r in res2.reports if r.task.startswith("resume-b")]
        assert len(resumed) == 3
        assert _fastq_bytes(res2.untrimmed) == _fastq_bytes(res1.untrimmed)
        assert _fastq_bytes(res2.trimmed) == _fastq_bytes(res1.trimmed)
        assert res2.metrics["counters"]["reads_processed"]["series"] == []

    def test_scan_engine_checkpoints_too(self, tmp_path):
        longs, srs = _dataset(49, n_long=10)
        ckpt = str(tmp_path / "ckpt")
        kw = dict(engine="scan", n_iterations=1, batch_reads=4,
                  checkpoint_dir=ckpt)
        res1 = Pipeline(_cfg(**kw)).run(longs, srs)
        res2 = Pipeline(_cfg(resume=True, **kw)).run(longs, srs)
        assert [r.task for r in res2.reports
                if r.task.startswith("resume-b")] == [
            "resume-b0", "resume-b1", "resume-b2"]
        assert _fastq_bytes(res2.untrimmed) == _fastq_bytes(res1.untrimmed)

    def test_journal_matches_jax(self, tmp_path):
        """One scan-engine run per package with the journal on and QC
        recorders installed: the journal directories hold the same files,
        byte for byte."""
        from proovread_tpu.obs import qc as jqc
        from proovread_tpu.pipeline.driver import Pipeline as JPipeline
        longs, srs = _uniform_dataset(np.random.default_rng(52), n_long=6)
        kw = dict(mode="sr", engine="scan", n_iterations=1, sampling=False,
                  batch_reads=4, host_chunk_rows=512)
        jdir, tdir = tmp_path / "j", tmp_path / "t"
        with jqc.scope():
            JPipeline(JConfig(trim=JTrim(min_length=150),
                              checkpoint_dir=str(jdir), **kw)).run(longs, srs)
        with tqc.scope():
            Pipeline(PipelineConfig(
                trim=TrimParams(min_length=150), checkpoint_dir=str(tdir),
                device="cpu", **kw)).run(_port_records(longs),
                                         _port_records(srs))
        names = sorted(p.name for p in tdir.iterdir())
        assert names == sorted(p.name for p in jdir.iterdir())
        assert len(names) == 3                    # meta + two buckets
        for name in names:
            assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
