"""End-to-end observability smoke (port of ``proovread_tpu/obs/smoke.py``).

Runs a small full command-line correction (``python -m
proovread_tpu_torch``) with ``--trace``, ``--metrics-out``, ``--qc-out``,
``--truth`` and ``--compile-ledger``, and validates every artifact with the
port's own validators (``obs/validate.py``): the trace must parse against
the Chrome trace-event schema with its root span >= 95% covered by
children and every bucket span carrying the compile/execute split and the
profiler's cost attribution (``flops``, ``bytes_accessed``,
``peak_bytes``: the kernel entries' cost models, ``obs/profile.py``) with
a nonzero total; the compile ledger must validate strictly, have seen
the kernel entries' calls, and reconcile with the trace's compile split;
the metrics JSON
must parse against the registry schema and contain the KPI counter
catalog; the per-read QC JSONL must validate strictly against
``QC_RECORD_FIELDS`` with one finished record per corrected read, each
linked to a bucket span present in the trace, and its aggregate must hold
the accuracy section with identity raised by the correction. The run is
wrapped in a CUDA tensor leak check (``obs.memory.LeakCheck``).

``--qc-only`` runs the same workload with only ``--qc-out`` and
``--truth`` and validates just the QC artifact.

The workload is always the synthetic one (a 3 kb genome, ~5 kb of CLR
reads, 30x short reads).

    python -m proovread_tpu_torch.obs.smoke [--qc-only] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional

REQUIRED_COUNTERS = (
    "admission_dropped_cov", "admission_dropped_cap",
    "resilience_demotions", "checkpoint_journal_writes",
    "mask_shortcut_hits", "reads_processed", "bases_processed",
)


def _log(msg: str) -> None:
    print(f"[trace-smoke] {msg}", file=sys.stderr, flush=True)


def _write_fastq(path: str, records) -> None:
    from proovread_tpu_torch.io.fastq import FastqWriter
    with FastqWriter(path) as w:
        for r in records:
            w.write(r)


def _workload(tmp: str):
    """(long_fq, short_fq, truth_sidecar) paths; tiny but multi-bucket,
    with each read's error-free source, so the smoke also exercises the
    accuracy scoreboard end to end (sidecar -> CLI --truth -> scored QC
    artifact)."""
    from proovread_tpu_torch.io.simulate import (random_genome,
                                                 simulate_long_reads,
                                                 simulate_short_reads,
                                                 write_truth_sidecar)
    tp = os.path.join(tmp, "truth.jsonl")
    genome = random_genome(3000, seed=5)
    longs, truths = simulate_long_reads(
        genome, total_bases=5000, mean_len=700, min_len=400, seed=6)
    write_truth_sidecar(tp, longs, truths)
    _log(f"synthetic workload: {len(longs)} simulated reads")
    srs = simulate_short_reads(genome, 30.0, seed=7)
    lp = os.path.join(tmp, "long.fq")
    sp = os.path.join(tmp, "short.fq")
    _write_fastq(lp, longs)
    _write_fastq(sp, srs)
    return lp, sp, tp


def _validate_qc_artifact(qcp: str, trace: Optional[str] = None) -> bool:
    """Validate the --qc-out artifact: strict per-record schema, at least
    one record, every record finished (out_len > 0, trajectory present),
    the aggregate's accuracy section scored with identity not lowered,
    and — when a trace was written — every non-null bucket_span resolves
    to a bucket span id actually present in the trace."""
    from proovread_tpu_torch.obs.validate import ValidationError, validate_qc

    try:
        qstats = validate_qc(qcp, min_reads=1)
    except ValidationError as e:
        _log(f"FAILED: {e}")
        return False
    acc = (qstats["aggregate"] or {}).get("accuracy")
    if not acc or acc.get("n_scored", 0) < 1:
        _log("FAILED: --truth run but the QC aggregate carries no "
             "accuracy section")
        return False
    idb = acc["identity_before"]["mean"]
    ida = acc["identity_after"]["mean"]
    if ida < idb:
        _log(f"FAILED: correction lowered identity ({idb:.4f} -> "
             f"{ida:.4f})")
        return False
    _log(f"accuracy OK: {acc['n_scored']} read(s) scored, identity "
         f"{idb:.4f} -> {ida:.4f}")
    unfinished = 0
    span_ids = set()
    if trace is not None:
        with open(trace) as fh:
            for line in fh:
                ev = json.loads(line)
                if ev.get("ph") == "X" and ev.get("cat") == "bucket":
                    span_ids.add(ev["args"].get("span_id"))
    with open(qcp) as fh:
        next(fh)                                # meta line
        for line in fh:
            rec = json.loads(line)
            if rec["out_len"] <= 0 or not rec["masked_frac"]:
                unfinished += 1
            if trace is not None and rec["bucket_span"] is not None \
                    and rec["bucket_span"] not in span_ids:
                _log(f"FAILED: record {rec['id']!r} links bucket_span "
                     f"{rec['bucket_span']} absent from the trace")
                return False
    if unfinished:
        _log(f"FAILED: {unfinished} QC record(s) lack a finish "
             "(out_len == 0 or empty trajectory)")
        return False
    _log("qc OK: " + json.dumps(
        {k: v for k, v in qstats.items() if k != "aggregate"}))
    return True


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="proovread-tpu-torch-obs-smoke",
        description="Run a small scored CLI correction and validate its "
                    "trace, metrics and QC artifacts.")
    ap.add_argument("--qc-only", action="store_true",
                    help="write and validate only the QC artifact")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the run goes (default: the card)")
    args = ap.parse_args(argv)

    from proovread_tpu_torch.cli import main as cli_main
    from proovread_tpu_torch.obs.memory import LeakCheck
    from proovread_tpu_torch.obs.validate import (ValidationError,
                                                  reconcile_compile_ledger,
                                                  validate_compile_ledger,
                                                  validate_metrics,
                                                  validate_trace)

    with tempfile.TemporaryDirectory(prefix="proovread_smoke_") as tmp:
        lp, sp, tp = _workload(tmp)
        cfgp = os.path.join(tmp, "smoke.cfg")
        with open(cfgp, "w") as fh:
            json.dump({"batch-reads": 8, "device-chunk": 128,
                       "seq-filter": {"--min-length": 150}}, fh)
        out = os.path.join(tmp, "out")
        trace = os.path.join(tmp, "run.trace.jsonl")
        mets = os.path.join(tmp, "run.metrics.json")
        qcp = os.path.join(tmp, "run.qc.jsonl")
        ledp = os.path.join(tmp, "run.ledger.jsonl")
        cli_args = ["-l", lp, "-s", sp, "-p", out, "-m", "sr-noccs",
                    "-c", cfgp, "--qc-out", qcp, "--truth", tp,
                    "--device", args.device]
        if args.qc_only:
            _log("running CLI with --qc-out + --truth (qc-smoke)")
        else:
            _log("running CLI with --trace/--metrics-out/--qc-out/"
                 "--compile-ledger (+ leak check)")
            cli_args += ["--trace", trace, "--metrics-out", mets,
                         "--compile-ledger", ledp]
        leak = LeakCheck()
        rc = cli_main(cli_args)
        if rc != 0:
            _log(f"CLI exited {rc}")
            return 1
        lrep = leak.report()
        if args.qc_only:
            if not _validate_qc_artifact(qcp):
                return 1
            _log("PASS")
            return 0
        try:
            tstats = validate_trace(trace, min_coverage=0.95,
                                    require_attribution=True)
            mstats = validate_metrics(mets, require=REQUIRED_COUNTERS)
            # the ledger's rows and the trace's compile split are fed by
            # the same build window: they must agree
            lstats = validate_compile_ledger(ledp)
            rstats = reconcile_compile_ledger(ledp, trace)
        except ValidationError as e:
            _log(f"FAILED: {e}")
            return 1
        if tstats["n_buckets"] < 1:
            _log("FAILED: no bucket spans in trace")
            return 1
        if tstats["bucket_flops"] <= 0 or tstats["bucket_bytes"] <= 0:
            _log("FAILED: bucket spans carry no cost attribution "
                 f"({json.dumps(tstats)}): the profiler did not run")
            return 1
        if lstats["census"]["calls"] < 1:
            _log("FAILED: compile ledger saw no kernel-entry calls "
                 f"({json.dumps(lstats['census'])})")
            return 1
        if not _validate_qc_artifact(qcp, trace=trace):
            return 1
        if lrep["leaked_bytes"] > 1 << 20:
            _log(f"FAILED: CUDA tensor leak after the run: {lrep}")
            return 1
        _log(f"trace OK: {json.dumps(tstats)}")
        _log(f"metrics OK: {json.dumps(mstats)}")
        _log("compile-ledger OK: "
             + json.dumps({k: v for k, v in lstats.items()
                           if k != 'census'})
             + f" reconciles {json.dumps(rstats)}")
        _log(f"leak check OK: {json.dumps(lrep)}")
        _log("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
