"""End-to-end mesh fault-domain drill (port of
``proovread_tpu/parallel/smoke.py``).

``python -m proovread_tpu_torch.parallel.smoke [--device cpu|cuda]`` runs
the reference's five phases with 4 ranks (``parallel/launch.py``; on one
card the 4 ranks share it) on the shard-exact workload family
(``io/simulate.py:simulate_independent_segments``: every long read owns
its genome segment, so sharded execution is exact and "byte-identical" is
a meaningful assert):

1. **baseline**: a single-device run, QC on and scored against the
   workload's ground truth: the ``--qc-out`` aggregate, identity before
   and after included, that every later phase must reproduce byte for
   byte; then the same run traced and under a compile ledger (1b): the
   ledger strictly valid and reconciling with the span tree's compile
   split, the result carrying a census;
2. **headline**: ``device_lost@d1.p2``, shard 1 dies at iteration 2 of the
   4-way mesh; the run must complete at the shrunken rung ``mesh-dp3``,
   with the demotion attributed to shard 1 in ``mesh_faults`` and the
   aggregate identical to the baseline; under a compile ledger, whose
   census must count calls on every rank (nothing is compiled per mesh
   shape, so there are no ``dmesh:`` entries to look for);
3. **one fault per other mesh kind**: ``straggler`` (shrinks, like a chip
   loss), ``shard_oom`` and ``collective_timeout`` (retreat to the
   single-device rungs), each identical, each attributed;
4. **SIGTERM and a resume at another mesh shape**: a mesh-4 run with the
   journal whose rank 0 sends itself a real SIGTERM right after bucket 0
   is journaled (the launcher then takes the other ranks down); the same
   journal resumed at mesh 2 must replay and complete byte-identically;
5. **leak check**: no CUDA tensor left alive by the runs.

The kill runs in a launch of its own (its ranks die); phases 1-3, the
resume and the leak check run in turn in one launch of 4 ranks.

:func:`run` and :func:`pipeline_on_ranks` are the pieces ``chip_smoke.py``
reuses for its full-size mesh phase.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import sys
import tempfile
import time
from typing import Any, Dict, Optional, Sequence

SEED = 11
N_LONG, READ_LEN, SR_PER = 12, 300, 6
N_RANKS = 4
HEADLINE_FAULT = "device_lost@d1.p2"
# (fault, the rung the bucket must land on, the shard it must blame)
KIND_FAULTS = (("straggler@d3.p2x1", "mesh-dp3", "3"),
               ("shard_oom@d2.p1x1", "fused", "2"),
               ("collective_timeout@d0.p1x1", "fused", "0"))


class DrillFailed(AssertionError):
    """A phase of the drill did not hold; the message names what broke."""


def _log(msg: str) -> None:
    print(f"[dmesh-smoke] {msg}", file=sys.stderr, flush=True)


def workload(seed: int = SEED, n_long: int = N_LONG,
             read_len: int = READ_LEN, sr_per: int = SR_PER):
    """(longs, srs, truth map): the shard-exact workload and each long
    read's error-free source for the scoreboard."""
    from proovread_tpu_torch.io.simulate import simulate_independent_segments
    longs, srs, truths = simulate_independent_segments(
        seed=seed, n_long=n_long, read_len=read_len, sr_per=sr_per,
        with_truth=True)
    return longs, srs, {r.id: t for r, t in zip(longs, truths)}


def pcfg(**kw):
    """The drill's pipeline config (the reference smoke's): two buckets of
    at most 8 reads, 2 iterations, no sampling, one chunk a shard."""
    from proovread_tpu_torch.pipeline.driver import PipelineConfig
    from proovread_tpu_torch.pipeline.trim import TrimParams
    cfg = dict(mode="sr", n_iterations=2, sampling=False,
               device_chunk=128, batch_reads=8, host_chunk_rows=512,
               mesh_chunks_per_shard=1, trim=TrimParams(min_length=150))
    cfg.update(kw)
    return PipelineConfig(**cfg)


def run(longs, srs, truth=None, bucket_done=None, config=None, **kw):
    """One ``Pipeline.run`` under a QC scope (``config``, else
    :func:`pcfg` with ``kw``); returns (QC aggregate JSON bytes, per-read
    record dict, PipelineResult). With ``truth`` the run is scored before
    the aggregate is taken, on rank 0 of a group (the others only keep in
    step), so the byte-compares cover the identity numbers too."""
    from proovread_tpu_torch import obs
    from proovread_tpu_torch.parallel.dmesh import world
    from proovread_tpu_torch.pipeline.driver import Pipeline
    cfg = config if config is not None else pcfg(**kw)
    pipe = Pipeline(cfg)
    if bucket_done is not None:
        pipe._bucket_done = bucket_done
    with obs.qc.scope() as rec:
        res = pipe.run(longs, srs)
        if truth is not None and world()[0] == 0:
            obs.accuracy.apply_to_qc(rec, longs, res.untrimmed, truth,
                                     device=cfg.device)
        agg = json.dumps(rec.aggregate(), sort_keys=True).encode()
        recs = {r["id"]: r for r in rec.iter_records()}
    return agg, recs, res


def records_of(records) -> list:
    """(id, sequence, quality bytes) of each record: what two runs'
    outputs are held equal on."""
    return [(r.id, r.seq, None if r.qual is None else bytes(r.qual))
            for r in records]


def pipeline_on_ranks(longs, srs, truth, config, kernels: Sequence = ()):
    """Rank function (``launch(n, pipeline_on_ranks, ...)``): one
    :func:`run` on every rank, with each wrapper of ``kernels`` counted
    from 0 over the run. Returns, on rank 0, the QC aggregate and per-read
    QC records, the corrected and trimmed records, the run's wall seconds, its demotion
    notes, pass reports and metrics, and every rank's launch counts
    (gathered)."""
    import torch.distributed as dist
    for fn in kernels:
        fn.launches = 0
    t0 = time.monotonic()
    agg, recs, res = run(longs, srs, truth, config=config)
    wall = time.monotonic() - t0
    counts = {fn.__name__: fn.launches for fn in kernels}
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, counts)
    return {"agg": agg, "recs": recs, "untrimmed": records_of(res.untrimmed),
            "trimmed": records_of(res.trimmed), "wall": wall,
            "notes": [r.note for r in res.reports if r.note],
            "passes": [(r.task, r.masked_frac, r.n_candidates)
                       for r in res.reports],
            "metrics": res.metrics, "launches": per_rank}


def _counter(res, name) -> Dict[tuple, Any]:
    return {tuple(sorted(s["labels"].items())): s["value"]
            for s in res.metrics["counters"][name]["series"]}


def _demotions(res) -> list:
    return [r.note for r in res.reports if r.task.startswith("demote")]


def _killed(longs, srs, truth, ckpt: str, device: str) -> None:
    """Rank function of phase 4's first half: mesh 4 with the journal;
    rank 0 sends itself SIGTERM right after bucket 0 (the journal is
    written before ``_bucket_done`` runs, so the entry is on disk)."""
    from proovread_tpu_torch.parallel.dmesh import world

    def die_after_first(gi, results, chim, replayed):
        if gi == 0 and world()[0] == 0:
            os.kill(os.getpid(), signal.SIGTERM)

    run(longs, srs, truth, bucket_done=die_after_first, mesh_shards=4,
        checkpoint_dir=ckpt, device=device)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise DrillFailed(msg)


def _drill(longs, srs, truth, ckpt: str, device: str) -> list:
    """Rank function of phases 1-3, phase 4's resume and phase 5, in
    turn; returns rank 0's log lines. A phase that does not hold raises
    :class:`DrillFailed` on every rank (the runs are the same on every
    rank; rank 0 holds the scores)."""
    import torch
    import torch.distributed as dist
    from proovread_tpu_torch.obs.memory import LeakCheck
    from proovread_tpu_torch.obs.validate import validate_mesh_metrics
    from proovread_tpu_torch.parallel.dmesh import world
    rank0 = world()[0] == 0
    where = [None] * dist.get_world_size()
    dist.all_gather_object(where, (
        f"cuda:{torch.cuda.current_device()} "
        f"({torch.cuda.get_device_name()})" if device == "cuda" else "cpu"))
    lines = [f"ranks on {', '.join(where)}"]
    leak = LeakCheck()

    # -- 1: single-device baseline --------------------------------------
    agg0, recs0, _ = run(longs, srs, truth, device=device)
    if rank0:
        acc = json.loads(agg0).get("accuracy") or {}
        _check(acc.get("n_scored") == len(longs),
               f"baseline scored {acc.get('n_scored')} of {len(longs)} "
               "reads against truth")
        idb, ida = (acc["identity_before"]["mean"],
                    acc["identity_after"]["mean"])
        _check(ida >= idb, f"correction lowered identity ({idb:.4f} -> "
                           f"{ida:.4f})")
        lines.append(f"baseline: {len(recs0)} QC records, identity "
                     f"{idb:.4f} -> {ida:.4f}")

    # -- 1b: the baseline again, traced and under a compile ledger ------
    from proovread_tpu_torch import obs
    from proovread_tpu_torch.obs import compilecache
    from proovread_tpu_torch.obs.validate import (reconcile_compile_ledger,
                                                  validate_compile_ledger)
    with obs.tracing() as tr0, compilecache.scope(
            compilecache.Ledger(backend=device)) as led0:
        _, _, res0b = run(longs, srs, truth, device=device)
    with tempfile.TemporaryDirectory(prefix="proovread_dmesh_led_") as lt:
        tracep, ledp = os.path.join(lt, "t.jsonl"), os.path.join(lt, "l.jsonl")
        tr0.write_chrome(tracep)
        led0.write_jsonl(ledp)
        lstats = validate_compile_ledger(ledp)
        rstats = reconcile_compile_ledger(ledp, tracep)
    _check(res0b.compile_census is not None
           and res0b.compile_census["calls"] >= 1,
           "the traced rerun's PipelineResult carries no compile census")
    lines.append("compile-ledger OK: " + json.dumps(
        {k: v for k, v in lstats.items() if k != "census"})
        + f" reconciles {json.dumps(rstats)}")

    def same(tag, agg, recs):
        if rank0:
            _check(agg == agg0 and recs == recs0,
                   f"{tag}: output differs from the baseline")

    # -- 2: headline: a chip lost mid-iteration -------------------------
    with compilecache.scope(compilecache.Ledger(backend=device)) as led1:
        agg1, recs1, res1 = run(longs, srs, truth, mesh_shards=N_RANKS,
                                fault_spec=HEADLINE_FAULT, device=device)
    calls = [None] * dist.get_world_size()
    dist.all_gather_object(calls, led1.census()["calls"])
    _check(all(c >= 1 for c in calls),
           f"a rank's compile census counts no call: {calls}")
    lines.append(f"mesh run's compile census: calls by rank {calls}")
    _check(any("mesh-dp3" in n and "shard 1" in n for n in _demotions(res1)),
           f"{HEADLINE_FAULT} did not demote to mesh-dp3 "
           f"({_demotions(res1)})")
    same(HEADLINE_FAULT, agg1, recs1)
    stats = validate_mesh_metrics(res1.metrics)
    _check(_counter(res1, "mesh_faults").get(
        (("kind", "device_lost"), ("shard", "1"))) is not None,
        f"device_lost not attributed to shard 1: "
        f"{_counter(res1, 'mesh_faults')}")
    lines.append(f"headline OK: {HEADLINE_FAULT} -> mesh-dp3, "
                 f"byte-identical aggregate, {stats}")

    # -- 3: one fault per other kind ------------------------------------
    for spec, want, shard in KIND_FAULTS:
        kind = spec.split("@")[0]
        agg_k, recs_k, res_k = run(longs, srs, truth, mesh_shards=N_RANKS,
                                   fault_spec=spec, device=device)
        _check(any(f"'{want}'" in n for n in _demotions(res_k)),
               f"{spec} did not demote to {want}: {_demotions(res_k)}")
        _check(_counter(res_k, "mesh_faults").get(
            (("kind", kind), ("shard", shard))) is not None,
            f"{kind} not attributed to shard {shard}: "
            f"{_counter(res_k, 'mesh_faults')}")
        same(spec, agg_k, recs_k)
        lines.append(f"{spec} OK -> {want}, byte-identical aggregate")

    # -- 4 (second half): the mesh-4 journal resumed at mesh 2 ----------
    agg2, recs2, res2 = run(longs, srs, truth, mesh_shards=2,
                            checkpoint_dir=ckpt, resume=True, device=device)
    replays = sum(_counter(res2, "checkpoint_journal_replays").values())
    _check(replays >= 1, "resume at mesh 2 replayed nothing from the "
                         "mesh-4 journal")
    same("mesh-4 journal -> mesh-2 resume", agg2, recs2)
    lines.append(f"resume OK: {replays} bucket(s) replayed across mesh "
                 "shapes, byte-identical aggregate")

    # -- 5: leak check ---------------------------------------------------
    del res1, res2, res_k
    rep = leak.report()
    _check(rep["leaked_bytes"] <= 1 << 20, f"CUDA tensor leak: {rep}")
    lines.append(f"leak check OK: {json.dumps(rep)}")
    return lines


def drill(device: str = "cuda", workdir: Optional[str] = None,
          timeout: float = 1200.0) -> list:
    """The five phases on ``device``; returns the log lines, raises
    :class:`DrillFailed` (or the launcher's ``RankFailed``) when a phase
    does not hold."""
    from proovread_tpu_torch.parallel.launch import RankFailed, launch
    longs, srs, truth = workload()
    with tempfile.TemporaryDirectory(prefix="proovread_dmesh_",
                                     dir=workdir) as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        # -- 4 (first half): SIGTERM after bucket 0 at mesh 4 -----------
        try:
            launch(N_RANKS, _killed, longs, srs, truth, ckpt, device,
                   device=device, timeout=timeout)
            raise DrillFailed("the killed run ran to completion: SIGTERM "
                              "never fired")
        except RankFailed as e:
            _check(e.rank == 0 and e.exitcode == -signal.SIGTERM,
                   f"expected rank 0 killed by SIGTERM, got rank {e.rank} "
                   f"exit code {e.exitcode}")
        n_journaled = len(glob.glob(os.path.join(ckpt, "bucket_*.json")))
        _check(n_journaled >= 1, "the killed run journaled no bucket")
        lines = [f"SIGTERM to rank 0 after bucket 0: every rank down, "
                 f"{n_journaled} bucket(s) journaled"]
        lines += launch(N_RANKS, _drill, longs, srs, truth, ckpt, device,
                        device=device, timeout=timeout)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m proovread_tpu_torch.parallel.smoke",
        description="mesh fault-domain drill: 4 ranks, five phases")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from proovread_tpu_torch.device import resolve
    from proovread_tpu_torch.parallel.launch import RankFailed
    try:
        resolve(args.device)
    except RuntimeError as e:
        _log(f"FAILED: {e}")
        return 2
    t0 = time.monotonic()
    _log(f"workload: {N_LONG} long reads (disjoint segments), "
         f"{N_LONG * SR_PER} short reads, {N_RANKS} ranks on "
         f"{args.device}")
    try:
        for ln in drill(args.device):
            _log(ln)
    except (DrillFailed, RankFailed) as e:
        _log(f"FAILED: {e}")
        return 1
    _log(f"PASS in {time.monotonic() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
