"""Port parity: the serving layer (``proovread_tpu_torch/serve``), the
counterpart of the JAX package's ``tests/test_serve.py``.

Covered: the JSONL codec, admission, the job journal and ``length_class``;
``simulate_job_stream`` equal to the JAX package's for the same seed; the
server drills (backpressure, bad submissions, cancel and deadline, worker
death retried and exhausted); the server's records equal to one batch
``Pipeline.run`` of the same reads with QC; a drain mid-wave and a resume
that replays byte for byte; the serve command line answering every verb
over its socket; the drill of ``serve/smoke.py``; and the batch CLI
never importing ``serve``. One twin: the port's ``CorrectionServer`` and
the JAX package's, on the same dataset with ``engine="scan"``, give the
same job results and the same SLO artifact but for its timings and its
``compile`` block (the port reports its kernel library there, the JAX
package its XLA compile ledger).

Everything runs on the CPU (``device="cpu"``) with one torch thread.
Datasets are ``tests/test_serve.py``'s (1,500-base genome, 4 jobs), with
1-2 reads a job and one correction pass instead of 2-4 and two, to keep
each wave to about a second of the plain kernels."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from proovread_tpu.io.records import SeqRecord as JRecord
from proovread_tpu.io.simulate import simulate_job_stream as j_job_stream
from proovread_tpu.obs.validate import validate_slo as j_validate_slo
from proovread_tpu.pipeline.driver import PipelineConfig as JConfig
from proovread_tpu.pipeline.trim import TrimParams as JTrim
from proovread_tpu.serve.admission import TenantQuota as JTenantQuota
from proovread_tpu.serve.server import CorrectionServer as JServer
from proovread_tpu.serve.server import ServeConfig as JServeConfig

from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.io.simulate import (simulate_job_stream,
                                             simulate_short_reads)
from proovread_tpu_torch.obs.validate import validate_slo
from proovread_tpu_torch.ops.encode import decode_codes, revcomp_codes
from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
from proovread_tpu_torch.pipeline.trim import TrimParams, pieces_of
from proovread_tpu_torch.serve.admission import (AdmissionController,
                                                 TenantQuota)
from proovread_tpu_torch.serve.jobs import Job, JobJournal
from proovread_tpu_torch.serve.protocol import (ServeClient, decode_record,
                                                decode_records,
                                                encode_record)
from proovread_tpu_torch.serve.server import (CorrectionServer, ServeConfig,
                                              length_class)
from proovread_tpu_torch.testing.faults import FaultPlan

pytestmark = pytest.mark.faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
# zero overhead when not serving
# --------------------------------------------------------------------------

def test_batch_cli_never_imports_serve(tmp_path):
    """The batch CLI path imports nothing from ``serve``."""
    code = (
        "import sys\n"
        "from proovread_tpu_torch import cli\n"
        f"rc = cli.main(['--create-cfg', {str(tmp_path / 'x.cfg')!r}])\n"
        "assert rc == 0\n"
        "bad = [m for m in sys.modules"
        " if m.startswith('proovread_tpu_torch.serve')]\n"
        "assert not bad, f'serve modules leaked into batch path: {bad}'\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)


# --------------------------------------------------------------------------
# unit: protocol codec, admission, journal
# --------------------------------------------------------------------------

class TestProtocolCodec:
    def test_record_roundtrip(self):
        r = SeqRecord("a/1", "ACGTN", qual=np.array([1, 2, 3, 4, 40],
                                                    np.uint8))
        d = encode_record(r)
        r2 = decode_record(json.loads(json.dumps(d)))
        assert r2.id == r.id and r2.seq == r.seq
        np.testing.assert_array_equal(r2.qual, r.qual)

    def test_qual_none_roundtrip(self):
        r2 = decode_record(encode_record(SeqRecord("x", "AC")))
        assert r2.qual is None

    def test_bad_payload_rejected(self):
        with pytest.raises(ValueError):
            decode_record({"id": 5, "seq": "AC"})
        with pytest.raises(ValueError):
            decode_records({"not": "a list"})

    def test_wire_format_is_the_reference(self):
        """The same record encodes to the same wire object in both
        packages, so a client of either server talks to both."""
        from proovread_tpu.serve.protocol import (
            encode_record as j_encode_record)
        q = np.array([0, 1, 2, 93], np.uint8)
        assert encode_record(SeqRecord("r/1", "ACGT", qual=q)) == \
            j_encode_record(JRecord("r/1", "ACGT", qual=q))


class TestAdmission:
    def test_quota_bounds_and_release(self):
        a = AdmissionController(TenantQuota(max_jobs=2, max_bases=1000,
                                            max_server_jobs=10))
        assert a.try_admit("t1", 400)[0]
        assert a.try_admit("t1", 400)[0]
        ok, reason, retry = a.try_admit("t1", 100)
        assert not ok and reason == "quota-jobs" and retry > 0
        ok, reason, _ = a.try_admit("t2", 1200)
        assert not ok and reason == "quota-bases"
        a.release("t1", 400)
        assert a.try_admit("t1", 100)[0]

    def test_server_wide_bound(self):
        a = AdmissionController(TenantQuota(max_jobs=99, max_bases=10**9,
                                            max_server_jobs=3))
        for i in range(3):
            assert a.try_admit(f"t{i}", 10)[0]
        ok, reason, _ = a.try_admit("t9", 10)
        assert not ok and reason == "queue-full"

    def test_retry_after_tracks_drain_rate(self):
        a = AdmissionController(TenantQuota(max_jobs=1))
        assert a.try_admit("t", 10_000)[0]
        a.observe_rate(10_000, 2.0)          # 5k bases/s
        ok, _, retry = a.try_admit("t", 10_000)
        assert not ok
        assert 0.5 <= retry <= 60.0 and retry == pytest.approx(4.0, rel=0.5)

    def test_charge_bypasses_gate(self):
        a = AdmissionController(TenantQuota(max_jobs=1))
        a.charge("t", 10)
        a.charge("t", 10)
        assert a.held_jobs("t") == 2


def _job(jid="j1", seq=0, **kw):
    recs = kw.pop("records", [SeqRecord("r1", "ACGT",
                                        qual=np.array([1, 2, 3, 4],
                                                      np.uint8))])
    return Job(job_id=jid, tenant="t", mode="clr", records=recs, seq=seq,
               **kw)


class TestJobJournal:
    def test_roundtrip(self, tmp_path):
        j = JobJournal(str(tmp_path / "jobs"))
        job = _job(status="running", wave=3, attempts=1)
        j.put(job)
        jobs, corrupt = JobJournal(str(tmp_path / "jobs")).load()
        assert not corrupt
        (j2,) = jobs
        assert (j2.job_id, j2.status, j2.wave, j2.attempts) == \
            ("j1", "running", 3, 1)
        assert j2.records[0].seq == "ACGT"
        np.testing.assert_array_equal(j2.records[0].qual,
                                      job.records[0].qual)

    def test_corrupt_entry_surfaces_not_raises(self, tmp_path):
        j = JobJournal(str(tmp_path / "jobs"))
        j.put(_job("good", seq=0))
        j.put(_job("bad", seq=1))
        victim = [n for n in os.listdir(j.path) if "bad" in n][0]
        with open(os.path.join(j.path, victim), "r+b") as fh:
            fh.truncate(20)
        jobs, corrupt = JobJournal(str(tmp_path / "jobs")).load()
        assert [jb.job_id for jb in jobs] == ["good"]
        assert [(c[0], c[2]) for c in corrupt] == [("bad", 1)]
        JobJournal(str(tmp_path / "jobs")).quarantine(corrupt[0][1])
        jobs, corrupt = JobJournal(str(tmp_path / "jobs")).load()
        assert [jb.job_id for jb in jobs] == ["good"] and not corrupt

    def test_journal_fault_site_corrupts_nonterminal_only(self, tmp_path):
        plan = FaultPlan.from_spec("journal@j7")
        j = JobJournal(str(tmp_path / "jobs"), faults=plan)
        j.put(_job("pending", seq=7, status="accepted"))
        _, corrupt = JobJournal(str(tmp_path / "jobs")).load()
        assert [c[0] for c in corrupt] == ["pending"]
        done = _job("done", seq=7, status="completed")
        j.put(done)
        jobs, _ = JobJournal(str(tmp_path / "jobs")).load()
        assert "done" in [jb.job_id for jb in jobs]

    def test_entry_bytes_are_the_reference(self, tmp_path):
        """A job's journal entry is the JAX package's byte for byte, so
        either server resumes the other's state dir."""
        from proovread_tpu.serve.jobs import Job as JJob
        from proovread_tpu.serve.jobs import JobJournal as JJournal
        q = np.array([5, 6, 7, 8], np.uint8)
        kw = dict(job_id="j/1", tenant="t", mode="ccs", seq=4,
                  status="running", wave=2, attempts=1, deadline_s=3.5)
        JobJournal(str(tmp_path / "t")).put(
            Job(records=[SeqRecord("r", "ACGT", qual=q)], **kw))
        JJournal(str(tmp_path / "j")).put(
            JJob(records=[JRecord("r", "ACGT", qual=q)], **kw))
        (name,) = os.listdir(tmp_path / "t")
        assert os.listdir(tmp_path / "j") == [name]
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


def test_length_class_buckets():
    from proovread_tpu.serve.server import length_class as j_length_class
    for n in (0, 10, 512, 513, 4096, 32768, 32769, 40_000):
        assert length_class(n) == j_length_class(n)
    assert length_class(10) == "512"
    assert length_class(40_000) == "huge"


def test_job_stream_deterministic_and_mixed():
    _, a = simulate_job_stream(seed=5, n_jobs=6)
    _, b = simulate_job_stream(seed=5, n_jobs=6)
    assert [j.job_id for j in a] == [j.job_id for j in b]
    assert all([r.seq for r in x.records] == [r.seq for r in y.records]
               for x, y in zip(a, b))
    assert {j.mode for j in a} == {"clr", "ccs", "unitig"}
    assert len({j.tenant for j in a}) > 1
    ids = [r.id for j in a for r in j.records]
    assert len(ids) == len(set(ids))
    from proovread_tpu_torch.pipeline.ccs import is_subread_set
    for j in a:
        if j.mode == "ccs":
            assert is_subread_set(j.records)


@pytest.mark.parametrize("kw", [
    dict(seed=5, n_jobs=6),
    dict(seed=31, n_jobs=4, genome_size=1500, modes=("clr",),
         mean_len=420, min_len=300, reads_per_job=(1, 2)),
    dict(seed=9, n_jobs=7, modes=("unitig", "ccs"), tenants=("a", "b", "c"),
         mean_gap_s=0.5)], ids=["mixed", "clr", "unitig-ccs"])
def test_job_stream_equals_reference(kw):
    """The same seed gives the JAX package's genome, jobs and records."""
    gt, tj = simulate_job_stream(**kw)
    gj, jj = j_job_stream(**kw)
    np.testing.assert_array_equal(gt, gj)
    assert len(tj) == len(jj)
    for x, y in zip(tj, jj):
        assert (x.job_id, x.tenant, x.mode, x.arrival_s, x.deadline_s) == \
            (y.job_id, y.tenant, y.mode, y.arrival_s, y.deadline_s)
        assert [(r.id, r.seq, r.qual.tobytes()) for r in x.records] == \
            [(r.id, r.seq, r.qual.tobytes()) for r in y.records]


# --------------------------------------------------------------------------
# server-level drills (in-process, scan engine, deterministic pump())
# --------------------------------------------------------------------------

def _dataset(seed=31, n_jobs=4, genome_size=1500, **kw):
    kw.setdefault("reads_per_job", (1, 2))
    genome, jobs = simulate_job_stream(
        seed=seed, n_jobs=n_jobs, genome_size=genome_size,
        modes=("clr",), mean_len=420, min_len=300, **kw)
    shorts = simulate_short_reads(genome, 22.0, seed=seed + 1)
    return genome, jobs, shorts


def _pcfg(**kw):
    base = dict(engine="scan", n_iterations=1, sampling=False,
                batch_reads=8, host_chunk_rows=512, device_chunk=128,
                trim=TrimParams(min_length=150), device="cpu")
    base.update(kw)
    return PipelineConfig(**base)


def _submit(srv, j, **extra):
    return srv.handle({"op": "submit", "job_id": j.job_id,
                       "tenant": j.tenant, "mode": j.mode,
                       "reads": [encode_record(r) for r in j.records],
                       **extra})


@pytest.mark.heavy
class TestServerDrills:
    def test_backpressure_bounded_and_observable(self, tmp_path):
        _, jobs, shorts = _dataset(n_jobs=4)
        srv = CorrectionServer(shorts, ServeConfig(
            state_dir=str(tmp_path / "s"),
            quota=TenantQuota(max_jobs=1, max_bases=10**9)), _pcfg())
        assert _submit(srv, jobs[0])["status"] == "accepted"
        r = _submit(srv, jobs[2])            # same tenant as jobs[0]
        assert r["status"] == "rejected" and r["reason"] == "quota-jobs"
        assert r["retry_after_s"] > 0
        assert _submit(srv, jobs[1])["status"] == "accepted"
        while srv.pump():
            pass
        assert _submit(srv, jobs[2])["status"] == "accepted"
        while srv.pump():
            pass
        snap = srv.slo_snapshot()
        assert snap["jobs"]["completed"] == 3
        assert snap["rejections"] == {"quota-jobs": 1}
        slo = tmp_path / "slo.json"
        srv.write_slo(str(slo))
        stats = validate_slo(str(slo))
        assert stats["jobs"]["accepted"] == 3
        assert j_validate_slo(str(slo)) == stats

    def test_bad_submissions_rejected_with_reason(self, tmp_path):
        _, jobs, shorts = _dataset(n_jobs=2)
        srv = CorrectionServer(shorts, ServeConfig(
            state_dir=str(tmp_path / "s")), _pcfg())
        r = srv.handle({"op": "submit", "job_id": "x", "tenant": "t"})
        assert r["status"] == "rejected" and r["reason"] == "parse-error"
        r = _submit(srv, jobs[0], mode="nope")
        assert r["status"] == "rejected" and r["reason"] == "bad-request"
        assert _submit(srv, jobs[0])["status"] == "accepted"
        r = _submit(srv, jobs[0])
        assert r["status"] == "rejected" and r["reason"] == "duplicate-job"
        assert srv.handle({"op": "bogus"})["ok"] is False

    def test_cancel_and_deadline_unwind_cleanly(self, tmp_path):
        _, jobs, shorts = _dataset(n_jobs=3)
        srv = CorrectionServer(shorts, ServeConfig(
            state_dir=str(tmp_path / "s")), _pcfg())
        _submit(srv, jobs[0])
        _submit(srv, jobs[1], deadline_s=0.0)    # breached before wave
        _submit(srv, jobs[2])
        assert srv.handle({"op": "cancel",
                           "job_id": jobs[2].job_id})["ok"]
        while srv.pump():
            pass
        sts = {j.job_id: srv.handle({"op": "status", "job_id": j.job_id})
               for j in jobs}
        assert sts[jobs[0].job_id]["status"] == "completed"
        assert sts[jobs[1].job_id]["status"] == "expired"
        assert sts[jobs[2].job_id]["status"] == "cancelled"
        assert srv.handle({"op": "result",
                           "job_id": jobs[0].job_id})["ok"]
        assert not srv.handle({"op": "result",
                               "job_id": jobs[1].job_id})["ok"]

    def test_worker_death_retries_then_completes(self, tmp_path):
        _, jobs, shorts = _dataset(n_jobs=2)
        srv = CorrectionServer(shorts, ServeConfig(
            state_dir=str(tmp_path / "s"), job_retries=1,
            fault_spec="worker@j0x1"), _pcfg())
        _submit(srv, jobs[0])
        _submit(srv, jobs[1])
        while srv.pump():
            pass
        for j in jobs:
            st = srv.handle({"op": "status", "job_id": j.job_id})
            assert st["status"] == "completed", st
            assert st["attempts"] == 2        # died once, retried once
        assert srv.registry.counter("serve_wave_deaths",
                                    "waves").value() == 1

    def test_worker_death_exhausts_retries_to_failed(self, tmp_path):
        _, jobs, shorts = _dataset(n_jobs=1)
        srv = CorrectionServer(shorts, ServeConfig(
            state_dir=str(tmp_path / "s"), job_retries=1,
            fault_spec="worker@j0"), _pcfg())     # unlimited firings
        _submit(srv, jobs[0])
        while srv.pump():
            pass
        st = srv.handle({"op": "status", "job_id": jobs[0].job_id})
        assert st["status"] == "failed"
        assert "worker died" in st["reason"]


def test_refusals_name_themselves(tmp_path):
    """The factory-artifact warm boot is refused by name, and a server
    asked for the card without one raises at construction."""
    _, _, shorts = _dataset(n_jobs=1)
    with pytest.raises(NotImplementedError, match="artifact_dir"):
        CorrectionServer(shorts, ServeConfig(
            state_dir=str(tmp_path / "a"), artifact_dir="art"), _pcfg())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            CorrectionServer(shorts, ServeConfig(
                state_dir=str(tmp_path / "b")), _pcfg(device="cuda"))


# --------------------------------------------------------------------------
# acceptance: server <-> batch parity, incl. kill + --resume
# --------------------------------------------------------------------------

def _records_equal(a, b):
    assert len(a) == len(b), (len(a), len(b))
    for x, y in zip(a, b):
        assert x.id == y.id
        assert x.seq == y.seq, x.id
        if x.qual is None or y.qual is None:
            assert x.qual is None and y.qual is None
        else:
            np.testing.assert_array_equal(x.qual, y.qual)


def _job_slice(records, job):
    """The batch run's records restricted to one job's reads."""
    return pieces_of(records, {r.id for r in job.records})


def _batch_reference(longs, shorts, cfg):
    """One batch run over the union, with QC recorded — the ground truth
    the server must reproduce byte-identically."""
    from proovread_tpu_torch import obs
    from proovread_tpu_torch.obs.qc import QcRecorder
    with obs.qc.scope(QcRecorder()):
        return Pipeline(cfg).run(longs, shorts)


def _server_qc_aggregate(jobs, srv):
    """Aggregate over the per-job QC payloads, as a client would
    reassemble provenance from job results."""
    from proovread_tpu_torch.obs.qc import QcRecorder
    rec = QcRecorder()
    for j in jobs:
        res = srv.handle({"op": "result", "job_id": j.job_id})
        assert res["ok"], res
        assert res["qc"] is not None
        rec.splice(res["qc"])
    return rec.aggregate()


def _hold_jobs(srv, jobs, ref):
    for j in jobs:
        res = srv.handle({"op": "result", "job_id": j.job_id})
        assert res["ok"], res
        _records_equal(decode_records(res["untrimmed"]),
                       [r for r in ref.untrimmed
                        if r.id in {x.id for x in j.records}])
        _records_equal(decode_records(res["trimmed"]),
                       _job_slice(ref.trimmed, j))
    assert _server_qc_aggregate(jobs, srv) == ref.qc


@pytest.mark.heavy
class TestServerBatchParity:
    def test_single_wave_matches_batch_with_qc(self, tmp_path):
        """Interleaved jobs submitted to the server vs ONE batch run of
        the same reads: identical corrected records, trimmed records and
        QC aggregate."""
        _, jobs, shorts = _dataset(seed=37, n_jobs=4)
        union = [r for j in jobs for r in j.records]
        ref = _batch_reference(union, shorts, _pcfg())
        srv = CorrectionServer(shorts, ServeConfig(
            state_dir=str(tmp_path / "s"), qc=True, max_wave_jobs=8),
            _pcfg())
        for j in jobs:
            assert _submit(srv, j)["status"] == "accepted"
        while srv.pump():
            pass
        _hold_jobs(srv, jobs, ref)

    def test_kill_and_resume_replays_byte_identically(self, tmp_path):
        """A drain mid-wave (the SIGTERM stand-in) journals the in-flight
        jobs; a NEW server with resume=True replays the completed bucket
        from the checkpoint journal and finishes the rest — outputs and QC
        aggregate byte-identical to an uninterrupted batch run. Device
        engine: every job spans two length buckets, so no job completes
        before the kill."""
        rng = np.random.default_rng(53)
        G = 2000
        genome = rng.integers(0, 4, G).astype(np.int8)

        def noisy(src):
            out = []
            for base in src:
                u = rng.random()
                if u < 0.04:
                    out.append(int(rng.integers(0, 4)))
                    out.append(int(base))
                elif u < 0.06:
                    continue
                elif u < 0.08:
                    out.append(int((base + 1) % 4))
                else:
                    out.append(int(base))
            return decode_codes(np.array(out, np.int8))

        class _J:
            def __init__(self, jid, tenant, records):
                self.job_id, self.tenant, self.mode = jid, tenant, "clr"
                self.records = records

        jobs = []
        for k in range(3):
            recs = []
            for li, ln in ((0, 300), (1, 900)):     # spans 2 buckets
                a = int(rng.integers(0, G - ln))
                recs.append(SeqRecord(f"j{k}/r{li}",
                                      noisy(genome[a:a + ln])))
            jobs.append(_J(f"job-{k}", f"t{k % 2}", recs))
        shorts = []
        for i in range(40):
            st = int(rng.integers(0, G - 100))
            seq = genome[st:st + 100].copy()
            if rng.random() < 0.5:
                seq = revcomp_codes(seq)
            shorts.append(SeqRecord(f"s{i}", decode_codes(seq),
                                    qual=np.full(100, 30, np.uint8)))

        cfg = _pcfg(engine="device", n_iterations=2)
        union = [r for j in jobs for r in j.records]
        ref = _batch_reference(union, shorts, cfg)

        state = str(tmp_path / "state")
        srv1 = CorrectionServer(shorts, ServeConfig(
            state_dir=state, qc=True, max_wave_jobs=8,
            drain_after_buckets=1), cfg)
        for j in jobs:
            assert _submit(srv1, j)["status"] == "accepted"
        while srv1.pump():
            pass
        snap = srv1.slo_snapshot()
        assert snap["jobs"]["journaled"] == 3, snap["jobs"]
        assert snap["drain"]["requested"]
        del srv1

        srv2 = CorrectionServer(shorts, ServeConfig(
            state_dir=state, qc=True, max_wave_jobs=8, resume=True), cfg)
        while srv2.pump():
            pass
        assert srv2.registry.counter("checkpoint_journal_replays",
                                     "buckets").value() >= 1
        _hold_jobs(srv2, jobs, ref)
        slo = tmp_path / "slo2.json"
        srv2.write_slo(str(slo))
        stats = validate_slo(str(slo))
        assert stats["jobs"]["completed"] == 3
        assert stats["jobs"]["journaled"] == 0


# --------------------------------------------------------------------------
# the twin: the port's server against the JAX package's
# --------------------------------------------------------------------------

def _j_records(records):
    return [JRecord(r.id, r.seq, qual=r.qual) for r in records]


@pytest.mark.heavy
def test_server_twin_matches_jax_server(tmp_path):
    """The port's and the JAX package's ``CorrectionServer`` on the same
    dataset (scan engine, QC on, one rejection and one cancel): every job's
    status and result payload equal, and the SLO artifacts equal but for
    their latency values and ``compile`` blocks; both pass both
    packages' ``validate_slo``."""
    _, jobs, shorts = _dataset(seed=41, n_jobs=4)
    kw = dict(n_iterations=1, sampling=False, batch_reads=8,
              host_chunk_rows=512)
    servers = {
        "port": CorrectionServer(shorts, ServeConfig(
            state_dir=str(tmp_path / "port"), qc=True,
            quota=TenantQuota(max_jobs=1)),
            PipelineConfig(engine="scan", trim=TrimParams(min_length=150),
                           device="cpu", **kw)),
        "jax": JServer(_j_records(shorts), JServeConfig(
            state_dir=str(tmp_path / "jax"), qc=True,
            quota=JTenantQuota(max_jobs=1)),
            JConfig(engine="scan", trim=JTrim(min_length=150), **kw)),
    }
    out = {}
    try:
        for name, srv in servers.items():
            # alice's and bob's second jobs bounce off the one-job quota
            resp = [_submit(srv, j) for j in jobs]
            resp.append(srv.handle({"op": "cancel",
                                    "job_id": jobs[1].job_id}))
            while srv.pump():
                pass
            resp.append(_submit(srv, jobs[2]))
            while srv.pump():
                pass
            sts = [srv.handle({"op": "status", "job_id": j.job_id})
                   for j in jobs]
            res = [srv.handle({"op": "result", "job_id": j.job_id})
                   for j in jobs]
            slo = str(tmp_path / f"{name}.slo.json")
            srv.write_slo(slo)
            out[name] = (resp, sts, res, slo)
    finally:
        servers["jax"]._release_ledger()
    (rp, sp, resp_p, slo_p), (rj, sj, resp_j, slo_j) = out["port"], \
        out["jax"]
    assert rp == rj and sp == sj
    assert sum(r["ok"] for r in resp_p) >= 2
    assert resp_p == resp_j
    snaps = []
    for slo in (slo_p, slo_j):
        assert validate_slo(slo) == j_validate_slo(slo)
        with open(slo) as fh:
            d = json.load(fh)
        d.pop("compile")
        for row in d["latency"].values():
            row.update(p50_s=None, p99_s=None, max_s=None)
        snaps.append(d)
    assert snaps[0] == snaps[1]
    with open(slo_p) as fh:
        comp = json.load(fh)["compile"]
    assert comp == {"n_programs": 0, "backend_compiles": 0,
                    "backend_compile_s": 0.0, "tracing_hits": 0,
                    "tracing_misses": 0, "tracing_hit_rate": None}


# --------------------------------------------------------------------------
# the command line and the smoke's drill
# --------------------------------------------------------------------------

def test_serve_cli_refusals(tmp_path, capsys):
    """``serve`` refuses the reference's XLA cache and artifact boot by
    name, and the card when there is none."""
    from proovread_tpu_torch.cli import main
    base = ["serve", "-s", "s.fq", "--socket", str(tmp_path / "s.sock"),
            "--state-dir", str(tmp_path / "st")]
    for flag in (["--compile-cache"], ["--boot-from-artifact", "art"]):
        assert main(base + flag) == 2
        assert flag[0] in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert main(base) == 2
        assert "is_available" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "st")


@pytest.mark.heavy
def test_serve_cli_answers_every_verb(tmp_path):
    """``python -m proovread_tpu_torch serve --device cpu`` answers ping,
    submit, status, result, cancel, stats and drain over its socket, then
    drains clean and writes an SLO artifact both validators accept."""
    from proovread_tpu_torch.io.fastq import FastqWriter
    _, jobs, shorts = _dataset(seed=43, n_jobs=2)
    sp = str(tmp_path / "short.fq")
    with FastqWriter(sp) as w:
        for r in shorts:
            w.write(r)
    sock = str(tmp_path / "serve.sock")
    slo = str(tmp_path / "slo.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "proovread_tpu_torch", "serve", "-s", sp,
         "--socket", sock, "--state-dir", str(tmp_path / "state"),
         "--slo-out", slo, "--engine", "scan", "--n-iterations", "1",
         "--no-sampling", "--batch-reads", "8", "--qc", "--device", "cpu",
         "-q"], cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stderr=subprocess.PIPE)
    try:
        t0 = time.monotonic()
        while not os.path.exists(sock):
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.monotonic() - t0 < 120, "server never listened"
            time.sleep(0.1)
        with ServeClient(sock) as c:
            pong = c.ping()
            assert pong["ok"] and pong["draining"] is False
            assert set(pong) == {"ok", "draining", "replica_id",
                                 "uptime_s", "wave"}
            j = jobs[0]
            assert c.submit(j.job_id, j.tenant, j.records)["status"] == \
                "accepted"
            st = c.wait(j.job_id, timeout=120)
            assert st["status"] == "completed", st
            res = c.result(j.job_id)
            assert res["ok"] and res["untrimmed"] and res["qc"]
            assert c.cancel(j.job_id)["note"] == "already terminal"
            assert c.cancel("nope")["error"] == "unknown-job"
            assert c.stats()["slo"]["jobs"]["completed"] == 1
            assert c.drain() == {"ok": True, "draining": True}
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stats = validate_slo(slo, require_drained=True)
    assert stats == j_validate_slo(slo, require_drained=True)
    assert stats["jobs"]["completed"] == 1


@pytest.mark.heavy
def test_smoke_envelope_holds(tmp_path):
    """``serve/smoke.py``'s drill on six tiny jobs: the two rejections,
    the expired, the retried, the journal-corrupt and the completed jobs,
    the drain and the resume, both SLOs valid."""
    from proovread_tpu_torch.serve import smoke
    genome, jobs = simulate_job_stream(seed=23, n_jobs=6, genome_size=1500,
                                       modes=("clr",), mean_len=420,
                                       min_len=300, reads_per_job=(1, 2))
    shorts = simulate_short_reads(genome, 22.0, seed=24)
    out = smoke.envelope(shorts, jobs, _pcfg(), str(tmp_path),
                         signals=False)
    assert out["status"] == {jobs[0].job_id: "completed",
                             jobs[3].job_id: "expired",
                             jobs[4].job_id: "completed",
                             jobs[5].job_id: "failed"}
    assert sorted(out["rejected"].values()) == ["parse-error", "quota-jobs"]
    assert out["slo2"]["drain"] == {"requested": True, "clean": True}
    assert out["slo1"]["jobs"]["journaled"] > 0
    assert set(out["results"]) == {jobs[0].job_id, jobs[4].job_id}
