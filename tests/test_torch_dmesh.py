"""Port parity: the data-parallel mesh (``parallel/{plan,dmesh,launch}.py``
and the driver's mesh loop), held against the JAX package on the CPU.

The JAX side runs in this process on conftest's 8 virtual devices. The
port side runs as 2 gloo ranks (``parallel/launch.py``, one torch thread
each) started once by the module's ``world2`` fixture, which runs every
scenario in turn and returns rank 0's results through the launcher's
result file; the ranks run while the JAX side computes (the fixture is a
future). ``tests/test_torch_dmesh_faults.py`` holds the mesh-2 and mesh-4
runs, the fault ladder and the resume with 4 ranks.

Tolerance: exact. ``balance_placement``, ``shard_of_rows`` and
``moved_reads`` equal the reference's bit for bit; ``mesh_level``,
``classify_mesh_fault`` and ``classify_fault`` give the reference's answer
for every mesh fault kind, and a real gloo timeout classifies as
``collective_timeout``; the port's ``sharded_iteration_step`` at mesh 2
equals the reference's on ``tests/test_dmesh.py``'s data (codes, qual,
lengths, mask and ``n_admitted`` bitwise, the fraction equal); a shard's
admission span sums (``ShardPrefix``) equal the whole batch's bit for bit
past 2^24 summed bases, where the shard's own sums round otherwise; on a
shared genome, where a shard's seeding may pick other candidates than a single
device's, a mesh-2 ``Pipeline.run`` equals the JAX package's own mesh-2
run (QC records, aggregate, output records, reports byte for byte). The
command line with ``--mesh-shards 2 --device cpu`` writes what the
single-device command writes; a rank that dies takes the others down and
the launch names it."""

import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from proovread_tpu.align.params import BWA_SR as JBWA_SR
from proovread_tpu.consensus.params import ConsensusParams as JCns
from proovread_tpu.io.simulate import simulate_independent_segments
from proovread_tpu.parallel import dmesh as jdmesh
from proovread_tpu.parallel import plan as jplan
from proovread_tpu.pipeline import resilience as jres
from proovread_tpu.pipeline.dcorrect import device_revcomp as jrevcomp
from proovread_tpu.pipeline.driver import PipelineConfig as JConfig
from proovread_tpu.pipeline.masking import MaskParams as JMask
from proovread_tpu.pipeline.trim import TrimParams as JTrim
from proovread_tpu.testing import faults as jfaults

from proovread_tpu_torch.parallel import plan as tplan
from proovread_tpu_torch.parallel.launch import RankFailed, launch
from proovread_tpu_torch.pipeline import resilience as tres
from proovread_tpu_torch.pipeline.driver import PipelineConfig
from proovread_tpu_torch.state import params_from_fields
from proovread_tpu_torch.testing import faults as tfaults

from test_dmesh import _data
from test_dmesh_faults import _qc_run
from test_torch_pipeline import (_no_jax_ledger, _port_records, _rec_key,
                                 _uniform_dataset)

ROOT = Path(__file__).resolve().parent.parent

# tests/test_dmesh_faults.py's e2e config (two buckets of at most 8 reads,
# 2 iterations, no sampling, one chunk a shard)
E2E = dict(mode="sr", n_iterations=2, sampling=False, device_chunk=128,
           batch_reads=8, host_chunk_rows=512, mesh_chunks_per_shard=1,
           trim=JTrim(min_length=150))


def port_config(**kw) -> PipelineConfig:
    """The port's config of the JAX package's ``JConfig(**E2E, **kw)``."""
    fields = dataclasses.asdict(JConfig(**{**E2E, **kw}))
    return params_from_fields(PipelineConfig, {**fields, "device": "cpu"})


def outcome(agg, recs, res) -> dict:
    """What two runs are held equal on (picklable)."""
    return {"agg": agg if isinstance(agg, str) else agg.decode(),
            "recs": recs, "untrimmed": _rec_key(res.untrimmed),
            "trimmed": _rec_key(res.trimmed), "chimera": res.chimera,
            "reports": [dataclasses.asdict(r) for r in res.reports],
            "metrics": res.metrics}


def jax_run(longs, srs, **kw) -> dict:
    """The JAX package's run of the e2e config, its compile ledger off."""
    with _no_jax_ledger():
        return outcome(*_qc_run(longs, srs, **kw))


def workload():
    """tests/test_dmesh_faults.py's shard-exact workload: (JAX records,
    port records)."""
    longs, srs = simulate_independent_segments(seed=11, n_long=12,
                                               read_len=300, sr_per=6)
    return (longs, srs), (_port_records(longs), _port_records(srs))


def shared_workload():
    """Six 300 bp reads off one 600 bp genome: a short read seeds against
    several long reads, so a shard's seed selection may differ from the
    whole batch's."""
    longs, srs = _uniform_dataset(np.random.default_rng(5))
    return (longs, srs), (_port_records(longs), _port_records(srs))


def mesh_metrics(m: dict) -> dict:
    return {sec: {k: v for k, v in m[sec].items() if k.startswith("mesh_")}
            for sec in ("counters", "gauges")}


# --------------------------------------------------------------------------
# the port's side: run on every rank (module-level functions pickle by
# name; rank 0's return value comes back)
# --------------------------------------------------------------------------

def _port_step(step_in) -> dict:
    """The port's ``sharded_iteration_step`` at mesh 2 on ``_data(2)``."""
    from proovread_tpu_torch.align.params import BWA_SR
    from proovread_tpu_torch.consensus.params import ConsensusParams
    from proovread_tpu_torch.parallel.dmesh import (make_dp_mesh,
                                                    sharded_iteration_step)
    from proovread_tpu_torch.pipeline.dcorrect import device_revcomp
    from proovread_tpu_torch.pipeline.masking import MaskParams
    codes, qual, lengths, qc, qq, qlen = (torch.as_tensor(a)
                                          for a in step_in)
    step = sharded_iteration_step(
        make_dp_mesh(2), BWA_SR,
        ConsensusParams(use_ref_qual=True, indel_taboo_length=7),
        MaskParams().scaled(100), Lp=codes.shape[1], m=qc.shape[1],
        chunks_per_shard=1, chunk=1024)
    nc, nq, nl, nm, frac, n_adm = step(
        codes, qual, lengths, torch.zeros(codes.shape, dtype=torch.bool),
        qc, device_revcomp(qc, qlen), qq, qlen)
    return {"out": [t.numpy() for t in (nc, nq, nl, nm)], "frac": frac,
            "n_adm": n_adm}


def _gloo_timeout_message():
    """Rank 0 all-reduces on a group with a 1 s timeout that rank 1 never
    joins; returns gloo's own error message."""
    import torch.distributed as dist
    from proovread_tpu_torch.parallel.dmesh import make_dp_mesh, world
    mesh = make_dp_mesh(timeout=1.0)
    msg = None
    if world()[0] == 0:
        try:
            mesh.all_reduce(np.zeros(6, np.int64))
        except RuntimeError as e:
            msg = str(e)
    dist.barrier()         # rank 1 stays up until rank 0 timed out
    return msg


def _admission_case(seed=0, rows=8, n_bins=4):
    """Sorted admission inputs of a batch whose span sums pass 2^24 (each
    row's kept candidates, by bin, then a tail of candidates not kept):
    per row its (bins, spans); the whole batch's (spans, bins, rows)."""
    rng = np.random.default_rng(seed)
    per_row = []
    for _ in range(rows):
        n = int(rng.integers(5, 40))
        per_row.append((np.sort(rng.integers(0, n_bins, n)),
                        rng.integers(1, 1 << 20, n).astype(np.float32)))
    return per_row


def _sorted_arrays(per_row, n_bins, tail=5):
    spans = np.concatenate([sp for _, sp in per_row] + [np.zeros(tail)])
    bins = np.concatenate([r * n_bins + b for r, (b, _) in
                           enumerate(per_row)] + [np.full(tail, 1 << 30)])
    rows = np.concatenate([np.full(len(b), r) for r, (b, _) in
                           enumerate(per_row)] + [np.zeros(tail)])
    return (torch.as_tensor(spans, dtype=torch.float32),
            torch.as_tensor(bins, dtype=torch.int64),
            torch.as_tensor(rows, dtype=torch.int64))


def _shard_prefix_check():
    """Each shard's ``ShardPrefix`` against the whole batch's
    ``admit_prefix``: (bitwise equal at every kept candidate, whether the
    shard summing alone would have differed)."""
    import torch.distributed as dist
    from proovread_tpu_torch.parallel.dmesh import ShardPrefix, make_dp_mesh
    from proovread_tpu_torch.pipeline.dcorrect import admit_prefix
    per_row = _admission_case()
    order = tplan.balance_placement(
        np.array([len(sp) for _, sp in per_row]), 2)
    mesh = make_dp_mesh(2)
    cum_g, before_g = admit_prefix(*_sorted_arrays(per_row, 4))
    S = len(order) // 2
    mine = order[mesh.shard * S:(mesh.shard + 1) * S]
    local = _sorted_arrays([per_row[r] for r in mine], 4)
    cum, before = ShardPrefix(mesh, order)(*local)
    starts = np.cumsum([0] + [len(sp) for _, sp in per_row])
    at = np.concatenate([np.arange(starts[r], starts[r + 1]) for r in mine])
    K = len(at)
    same = (torch.equal(cum[:K], cum_g[at])
            and torch.equal(before[:K], before_g[at]))
    alone = admit_prefix(*local)
    differs = not (torch.equal(alone[0][:K] - alone[1][:K],
                               cum_g[at] - before_g[at]))
    out = [None, None]
    dist.all_gather_object(out, (same, differs))
    return out


def _world2(step_in, shared, cfg) -> dict:
    from proovread_tpu_torch.parallel import smoke
    return {"step": _port_step(step_in),
            "prefix": _shard_prefix_check(),
            "shared2": outcome(*smoke.run(*shared, config=cfg)),
            "timeout": _gloo_timeout_message()}


def _fail_on_rank_1():
    """Rank 1 raises; rank 0 waits in a barrier it never leaves."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("boom on rank 1")
    dist.barrier()


@pytest.fixture(scope="module")
def world2():
    """The 2 ranks' results, as a future: tests compute their JAX side
    first, then wait."""
    lr, sr = _data(2)
    step_in = (lr.codes, lr.qual, lr.lengths, sr.codes, sr.qual,
               sr.lengths)
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(launch, 2, _world2, step_in, shared_workload()[1],
                          port_config(mesh_shards=2), device="cpu",
                          timeout=600)


# --------------------------------------------------------------------------
# placement and the ladder's mesh rungs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_plan_matches_reference(n_shards):
    rng = np.random.default_rng(n_shards)
    for rows in (12, 24, 36):
        lens = rng.integers(8, 30000, rows)
        lens[rng.random(rows) < 0.2] = 8          # pad sentinels
        order = tplan.balance_placement(lens, n_shards)
        np.testing.assert_array_equal(
            order, jplan.balance_placement(lens, n_shards))
        assert order.dtype == np.int32
        cur = tplan.shard_of_rows(order, n_shards)
        np.testing.assert_array_equal(
            cur, jplan.shard_of_rows(order, n_shards))
        prev = tplan.shard_of_rows(tplan.balance_placement(lens, 2), 2)
        assert tplan.moved_reads(prev, cur, rows - 2) \
            == jplan.moved_reads(prev, cur, rows - 2)
    assert tplan.moved_reads(None, cur, 3) == 0
    if n_shards > 1:
        with pytest.raises(ValueError, match="do not split"):
            tplan.balance_placement(np.ones(n_shards * 3 + 1), n_shards)


@pytest.mark.parametrize("kind", list(tfaults.MESH_KINDS)
                         + ["cap_overflow", "straggler_deadline"])
def test_mesh_rungs_and_classes_match_reference(kind):
    """Each mesh fault kind lands where the reference sends it: the same
    (kind, shard) from ``classify_mesh_fault``, the same ladder kind from
    ``classify_fault``; the mesh rungs and the ladder's top are the
    reference's."""
    if kind == "cap_overflow":
        pair = (tfaults.MeshCapExceeded("pass would drop 7"),
                jfaults.MeshCapExceeded("pass would drop 7"))
    elif kind == "straggler_deadline":
        pair = (tfaults.ShardStraggler(), jfaults.ShardStraggler())
    else:
        pair = (tfaults.make_fault(kind, "x", shard=2),
                jfaults.make_fault(kind, "x", shard=2))
    t, j = pair
    assert tres.classify_mesh_fault(t) == jres.classify_mesh_fault(j)
    assert tres.classify_fault(t) == jres.classify_fault(j)
    for msg in ("device lost: chip 3 unreachable",
                "collective all-reduce timed out", "plain boom"):
        assert tres.classify_mesh_fault(RuntimeError(msg)) \
            == jres.classify_mesh_fault(RuntimeError(msg))
    assert tres.classify_mesh_fault(ValueError("device lost")) is None
    for n in (2, 3, 4):
        lt, lj = tres.mesh_level(n), jres.mesh_level(n)
        assert (lt.name, lt.mesh, lt.fused, lt.chunk_div, lt.host) \
            == (lj.name, lj.mesh, lj.fused, lj.chunk_div, lj.host)
    assert [(lv.name, lv.mesh) for lv in tres.LADDER] \
        == [(lv.name, lv.mesh) for lv in jres.LADDER]


# --------------------------------------------------------------------------
# the sharded step and the mesh-2 pipeline against the JAX package
# --------------------------------------------------------------------------

def test_sharded_step_matches_reference(world2):
    import jax.numpy as jnp
    lr, sr = _data(2)
    qc, qlen = jnp.asarray(sr.codes), jnp.asarray(sr.lengths)
    step = jdmesh.sharded_iteration_step(
        jdmesh.make_dp_mesh(2), JBWA_SR,
        JCns(use_ref_qual=True, indel_taboo_length=7), JMask().scaled(100),
        Lp=lr.codes.shape[1], m=sr.codes.shape[1], chunks_per_shard=1,
        chunk=1024)
    codes = jnp.asarray(lr.codes)
    jout = step(codes, jnp.asarray(lr.qual), jnp.asarray(lr.lengths),
                jnp.zeros(codes.shape, bool), qc, jrevcomp(qc, qlen),
                jnp.asarray(sr.qual), qlen)
    port = world2.result()["step"]
    for t, j in zip(port["out"], jout[:4]):
        np.testing.assert_array_equal(t, np.asarray(j))
    assert port["n_adm"] == int(jout[5])
    assert port["frac"] == float(jout[4])


def test_step_without_mesh_is_the_single_device_pass():
    """``compile_step_with_plan`` without a mesh gives the plain step: on
    the whole batch it equals ``DeviceCorrector.correct_pass``, assembly
    and the HCR mask (the reference's single-device oracle of its sharded
    step), with the sums of the pass."""
    from proovread_tpu_torch.align.params import BWA_SR
    from proovread_tpu_torch.consensus.params import ConsensusParams
    from proovread_tpu_torch.ops.assemble_kernel import mask_params_vec
    from proovread_tpu_torch.parallel.dmesh import build_sharded_step
    from proovread_tpu_torch.pipeline.dcorrect import (DeviceCorrector,
                                                       device_assemble,
                                                       device_hcr_mask,
                                                       device_revcomp)
    from proovread_tpu_torch.pipeline.masking import MaskParams
    lr, sr = _data(2)
    codes, qual, lengths, qc, qq, qlen = (torch.as_tensor(a) for a in (
        lr.codes, lr.qual, lr.lengths, sr.codes, sr.qual, sr.lengths))
    rcq = device_revcomp(qc, qlen)
    cns = ConsensusParams(use_ref_qual=True, indel_taboo_length=7)
    mp = MaskParams().scaled(100)
    call, stats = DeviceCorrector(chunk=1024).correct_pass(
        codes, qual, lengths, None, qc, rcq, qq, qlen, BWA_SR, cns)
    c1, q1, l1 = device_assemble(call, lengths, codes.shape[1])
    m1, _ = device_hcr_mask(q1, l1, mp)
    B = codes.shape[0]
    step = build_sharded_step(None, BWA_SR, cns, chunks_per_shard=1,
                              chunk=1024, collect_qc=True)
    (c2, q2, l2, m2), sums, stats2 = step(
        codes, qual, lengths, torch.zeros(codes.shape, dtype=torch.bool),
        np.ones(B, bool), np.arange(B), qc, rcq, qq, qlen,
        mask_params_vec(mp))
    for a, b in ((c1, c2), (q1, q2), (l1, l2), (m1, m2)):
        assert torch.equal(a, b)
    assert sums.tolist() == [int(m1.sum()), int(l1.sum()),
                             int(stats.n_admitted), int(stats.n_eligible),
                             stats.n_candidates, 0]
    assert stats2.shape == (4, B)
    assert stats2[1].tolist() == l1.tolist()


def test_shard_admission_sums_as_one_device(world2):
    """Past 2^24 summed span bases, each shard's admission sums equal the
    whole batch's bit for bit (the gathered spans laid out in the
    batch's order), where a shard summing alone would round otherwise."""
    (same0, differs0), (same1, differs1) = world2.result()["prefix"]
    assert same0 and same1
    assert differs0 or differs1


def test_shared_genome_mesh2_matches_jax_mesh2(world2):
    (jl, js), _ = shared_workload()
    jmesh = jax_run(jl, js, mesh_shards=2)
    port = world2.result()["shared2"]
    for key in ("recs", "agg", "untrimmed", "trimmed", "chimera",
                "reports"):
        assert port[key] == jmesh[key], key
    assert mesh_metrics(port["metrics"]) == mesh_metrics(jmesh["metrics"])


def test_real_gloo_timeout_classifies_as_collective(world2):
    """gloo's own timeout message, raised by a real collective, is a
    ``collective_timeout`` with no shard named: the run retreats to the
    single-device rungs."""
    msg = world2.result()["timeout"]
    assert msg and "Timed out waiting" in msg
    assert tres.classify_mesh_fault(RuntimeError(msg)) \
        == ("collective_timeout", None)
    assert tres.classify_fault(RuntimeError(msg)) == "collective_timeout"




# --------------------------------------------------------------------------
# the launcher and the command line
# --------------------------------------------------------------------------

def test_dead_rank_takes_the_others_down():
    t0 = time.monotonic()
    with pytest.raises(RankFailed) as ei:
        launch(2, _fail_on_rank_1, device="cpu", timeout=120)
    assert ei.value.rank == 1 and ei.value.exitcode == 1
    assert "rank 1" in str(ei.value) and "boom on rank 1" in str(ei.value)
    assert time.monotonic() - t0 < 90
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith("proovread-rank")]


# how the command is started: alone, or by torchrun as 2 ranks
TORCHRUN = ("-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2")


def _cli(out, lp, sp, cfg, *extra, launcher=()):
    """The port's command line on the CPU, started at the lowest
    priority (it shares the machine with the suite's other workers)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        ["nice", "-n", "19", sys.executable, *launcher, "-m",
         "proovread_tpu_torch", "-l", lp, "-s", sp, "-p", out, "--device",
         "cpu", "-c", cfg, "--qc-out", out + ".qc.jsonl", *extra], cwd=ROOT,
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)


def test_cli_mesh_shards_writes_the_single_device_files(tmp_path):
    """``--mesh-shards 2 --device cpu`` starts two ranks and writes the
    single-device command's five files and QC artifact byte for byte
    (``parameter.log`` but ``argv`` and the mesh key); only rank 0
    writes, and no journal is left. Under ``torchrun --nproc-per-node 2``
    the command joins torchrun's group and writes the same."""
    from proovread_tpu_torch.io.fastq import FastqWriter
    _, (longs, srs) = workload()
    lp, sp = str(tmp_path / "l.fq"), str(tmp_path / "s.fq")
    for path, recs in ((lp, longs), (sp, srs)):
        with open(path, "wb") as fh:
            w = FastqWriter(fh)
            for r in recs:
                if r.qual is None:
                    r.qual = np.full(len(r), 10, np.uint8)
                w.write(r)
    cfg = tmp_path / "c.cfg"
    cfg.write_text(json.dumps({"batch-reads": 8, "device-chunk": 128,
                               "mesh-chunks-per-shard": 1}))
    mesh = ("--mesh-shards", "2")
    procs = {tag: _cli(str(tmp_path / tag), lp, sp, str(cfg), *extra,
                       launcher=launcher)
             for tag, extra, launcher in (("one", (), ()),
                                          ("mesh", mesh, ()),
                                          ("torchrun", mesh, TORCHRUN))}
    errs = {tag: p.communicate(timeout=600)[1] for tag, p in procs.items()}
    for tag, p in procs.items():
        assert p.returncode == 0, errs[tag][-3000:]
    for tag in ("mesh", "torchrun"):
        assert "mesh: bucket 0 over 2 shard(s)" in errs[tag]
        assert sorted(os.listdir(tmp_path / tag)) == sorted(
            f"{tag}.{f}" for f in ("untrimmed.fq", "trimmed.fq",
                                   "trimmed.fa", "ignored.tsv", "chim.tsv",
                                   "parameter.log"))
        for f in ("untrimmed.fq", "trimmed.fq", "trimmed.fa", "ignored.tsv",
                  "chim.tsv"):
            assert (tmp_path / "one" / f"one.{f}").read_bytes() \
                == (tmp_path / tag / f"{tag}.{f}").read_bytes(), (tag, f)
        assert (tmp_path / "one.qc.jsonl").read_bytes() \
            == (tmp_path / f"{tag}.qc.jsonl").read_bytes(), tag
    logs = [json.loads((tmp_path / t / f"{t}.parameter.log").read_text())
            for t in ("one", "mesh", "torchrun")]
    for lg in logs:
        lg.pop("argv")
        lg["config"].pop("checkpoint-dir")
    assert [lg["config"].pop("mesh-shards") for lg in logs] == [None, 2, 2]
    assert logs[0] == logs[1] == logs[2]
