"""Port parity: the command line, ``python -m proovread_tpu_torch``.

``python -m proovread_tpu`` and ``python -m proovread_tpu_torch --device
cpu`` run on the same seeded inputs (``tests/test_cli.py:_mk_inputs``
sizes: 4 long reads of 900 bp with 8% substitutions, plus one siamaera
palindrome, over a 3 kb genome) with ``--no-checkpoint`` on both sides and
siamaera on (the default config). Tolerance: the five read and table files
byte-identical; ``parameter.log`` the same JSON except ``argv``, which
names each package's program and carries the port's ``--device`` flag.
The sr-noccs twin also writes ``--qc-out`` and ``--metrics-out`` and
scores ``--truth`` (a sidecar of the genome slices the long reads came
from): ``qc.jsonl`` byte-identical, ``metrics.json`` equal but for the
values of ``bucket_seconds`` (timings) and the ``jax_retraces`` series (0
in the port). A port-only ``--trace`` run passes the JAX package's trace,
QC and metrics validators, with each QC ``bucket_span`` in the trace.
The two runs are subprocesses at the lowest CPU priority: the
reference's side runs its kernels in interpret mode for a minute or more
and shares the machine with the suite's other workers. Also: every flag
the port does not run returns 2 naming itself, and PacBio subread ids in
``sr`` mode raise naming ``ccs-1``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from proovread_tpu.cli import main as jmain
from proovread_tpu.io import fastq as jfastq
from proovread_tpu.io.records import SeqRecord as JRecord
from proovread_tpu.obs.validate import (validate_metrics, validate_qc,
                                        validate_trace)

from proovread_tpu_torch.cli import main as tmain

from test_torch_pipeline import comparable_metrics

ROOT = Path(__file__).resolve().parent.parent
OUTPUTS = ("untrimmed.fq", "trimmed.fq", "trimmed.fa", "ignored.tsv",
           "chim.tsv")


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _inputs(tmp_path, sr_len, n_srs, ids=None, truth=False):
    """_mk_inputs' construction with ``sr_len`` short reads, and a fifth
    long read that is a palindrome (arm, junction, reverse-complemented
    arm) for siamaera to trim. With ``truth``, also a truth sidecar of the
    genome slices the long reads came from (the JAX package's writer)."""
    rng = np.random.default_rng(3)
    bases = "ACGT"
    genome = "".join(bases[i] for i in rng.integers(0, 4, 3000))
    seqs, sources = [], []
    for _ in range(4):
        st = int(rng.integers(0, len(genome) - 900))
        sources.append(genome[st:st + 900])
        seq = list(genome[st:st + 900])
        for mu in np.flatnonzero(rng.random(900) < 0.08):
            seq[mu] = bases[int(rng.integers(0, 4))]
        seqs.append("".join(seq))
    arm = genome[1000:1450]
    seqs.append(arm + genome[2000:2040] + _revcomp(arm))
    sources.append(seqs[-1])
    ids = ids or [f"lr{i}" for i in range(len(seqs))]
    longs = [JRecord(i, s, qual=np.full(len(s), 5, np.uint8))
             for i, s in zip(ids, seqs)]
    srs = []
    for i in range(n_srs):
        st = int(rng.integers(0, len(genome) - sr_len))
        srs.append(JRecord(f"s{i}", genome[st:st + sr_len],
                           qual=np.full(sr_len, 30, np.uint8)))
    paths = []
    for name, recs in (("long.fq", longs), ("short.fq", srs)):
        p = tmp_path / name
        with open(p, "wb") as fh:
            w = jfastq.FastqWriter(fh)
            for r in recs:
                w.write(r)
        paths.append(str(p))
    if truth:
        from proovread_tpu.io.simulate import write_truth_sidecar
        from proovread_tpu.ops.encode import encode_ascii
        paths.append(str(tmp_path / "truth.jsonl"))
        write_truth_sidecar(paths[-1], longs,
                            [encode_ascii(t) for t in sources])
    return paths


@pytest.mark.heavy
@pytest.mark.parametrize("mode,sr_len,n_srs", [("sr-noccs", 100, 400),
                                               ("mr-noccs", 250, 160)])
def test_cli_outputs_match_jax(tmp_path, mode, sr_len, n_srs):
    scored = mode == "sr-noccs"
    lp, sp, *truth = _inputs(tmp_path, sr_len, n_srs, truth=scored)
    args = ["-l", lp, "-s", sp, "--no-checkpoint", "-q"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jout, tout = str(tmp_path / "jax" / "res"), str(tmp_path / "port" / "res")

    def obs_args(side):
        if not scored:
            return []
        return ["--truth", truth[0],
                "--qc-out", str(tmp_path / side / "qc.jsonl"),
                "--metrics-out", str(tmp_path / side / "metrics.json")]
    for package, argv in (("proovread_tpu",
                           args + ["-p", jout] + obs_args("jax")),
                          ("proovread_tpu_torch",
                           args + ["-p", tout, "--device", "cpu"]
                           + obs_args("port"))):
        run = subprocess.run(
            ["nice", "-n", "19", sys.executable, "-m", package, *argv],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert run.returncode == 0, run.stderr[-3000:]
    for suf in OUTPUTS:
        with open(os.path.join(jout, f"res.{suf}"), "rb") as a, \
                open(os.path.join(tout, f"res.{suf}"), "rb") as b:
            assert a.read() == b.read(), suf
    jlog = json.load(open(os.path.join(jout, "res.parameter.log")))
    tlog = json.load(open(os.path.join(tout, "res.parameter.log")))
    assert tlog["mode"] == mode                    # auto-detected
    assert tlog.pop("argv")[1:] == (args + ["-p", tout, "--device", "cpu"]
                                    + obs_args("port"))
    assert jlog.pop("argv")[1:] == args + ["-p", jout] + obs_args("jax")
    assert tlog == jlog
    trimmed = open(os.path.join(tout, "res.trimmed.fq")).read()
    assert "SIAMAERA:" in trimmed                  # the palindrome was cut
    if scored:
        tqc, jqc = (tmp_path / side / "qc.jsonl" for side in ("port", "jax"))
        assert tqc.read_bytes() == jqc.read_bytes()
        stats = validate_qc(str(tqc), min_reads=5)
        acc = stats["aggregate"]["accuracy"]
        assert acc["n_scored"] == 5
        assert acc["identity_after"]["mean"] > acc["identity_before"]["mean"]
        tm, jm = (tmp_path / side / "metrics.json" for side in ("port", "jax"))
        validate_metrics(str(tm), require=["candidates_total"])
        assert comparable_metrics(json.loads(tm.read_text())) == \
            comparable_metrics(json.loads(jm.read_text()))


def test_cli_trace_qc_and_metrics_pass_the_validators(tmp_path):
    """A port-only run with ``--trace``, ``--metrics-out`` and the
    ``qc-out`` and ``truth-sidecar`` config keys: the span tree has the
    run, bucket, pass and score-accuracy spans and covers its root, and
    every QC record's ``bucket_span`` is a bucket span of the trace."""
    lp, sp, truth = _inputs(tmp_path, 100, 400, truth=True)
    cfg = tmp_path / "obs.cfg"
    cfg.write_text(json.dumps({"qc-out": str(tmp_path / "qc.jsonl"),
                               "truth-sidecar": truth}))
    trace, metrics = str(tmp_path / "t.jsonl"), str(tmp_path / "m.json")
    assert tmain(["-l", lp, "-s", sp, "-p", str(tmp_path / "out" / "res"),
                  "--no-checkpoint", "--device", "cpu", "-q", "-c",
                  str(cfg), "--trace", trace, "--metrics-out", metrics]) == 0
    stats = validate_trace(trace, min_coverage=0.95)
    assert stats["root"] == "run" and stats["n_buckets"] >= 1
    events = [json.loads(ln) for ln in open(trace)][1:]
    names = {e["name"] for e in events}
    assert {"run", "bucket", "bwa-sr-1", "bwa-sr-finish", "siamaera",
            "score-accuracy"} <= names
    bucket_ids = {e["args"]["span_id"] for e in events
                  if e["cat"] == "bucket"}
    qc = validate_qc(str(tmp_path / "qc.jsonl"), min_reads=5)
    assert qc["aggregate"]["accuracy"]["n_scored"] == 5
    records = [json.loads(ln) for ln in open(tmp_path / "qc.jsonl")][1:]
    assert {r["bucket_span"] for r in records} <= bucket_ids
    assert all(r["bucket_span"] is not None for r in records)
    m = json.load(open(metrics))
    validate_metrics(metrics, require=["reads_processed"])
    assert m["gauges"]["accuracy_reads_scored"]["series"][0]["value"] == 5
    assert m["gauges"]["peak_live_bytes"]["series"][0]["value"] == 0


@pytest.mark.parametrize("flag", [
    ["serve"], ["-u", "utg.fa"], ["--sam", "x.sam"], ["--bam", "x.bam"],
    ["--haplo-coverage"], ["--resume"], ["--mesh-shards", "2"],
    ["--mesh-pass-timeout", "5"], ["--bucket-timeout", "5"],
    ["--compile-ledger", "c.jsonl"], ["--compile-cache"],
    ["--xprof", "xp"], ["--debug"]], ids=lambda f: f[0])
def test_refused_flags_name_themselves(tmp_path, capsys, flag):
    out = str(tmp_path / "res")
    argv = flag if flag == ["serve"] else (
        ["-l", "l.fq", "-s", "s.fq", "-p", out, "--no-checkpoint"] + flag)
    assert tmain(argv) == 2
    assert flag[0] in capsys.readouterr().err
    assert not os.path.exists(out)


@pytest.mark.parametrize("key", ["compile-ledger", "compile-cache-dir"])
def test_refused_config_keys_name_themselves(tmp_path, capsys, key):
    lp, sp = _inputs(tmp_path, 100, 10)
    cfg = tmp_path / "c.cfg"
    cfg.write_text(json.dumps({key: "x"}))
    out = str(tmp_path / "res")
    assert tmain(["-l", lp, "-s", sp, "-p", out, "--no-checkpoint",
                  "--device", "cpu", "-c", str(cfg)]) == 2
    assert key in capsys.readouterr().err
    assert not os.path.exists(out)


def test_checkpoint_journal_needs_no_checkpoint(tmp_path, capsys):
    out = str(tmp_path / "res")
    assert tmain(["-l", "l.fq", "-s", "s.fq", "-p", out,
                  "--device", "cpu"]) == 2
    assert "--no-checkpoint" in capsys.readouterr().err
    assert not os.path.exists(out)


def test_argument_checks_match_jax(tmp_path):
    assert tmain(["-l", "x.fq"]) == jmain(["-l", "x.fq"]) == 2
    lp, sp = _inputs(tmp_path, 100, 10)
    out = str(tmp_path / "res2")
    os.makedirs(out)
    open(os.path.join(out, "existing"), "w").write("x")
    assert tmain(["-l", lp, "-s", sp, "-p", out, "--no-checkpoint",
                  "--device", "cpu"]) == 2
    p = str(tmp_path / "t.cfg")
    assert tmain(["--create-cfg", p]) == 0
    assert open(p).read() == _jax_template(tmp_path)


def _jax_template(tmp_path):
    from proovread_tpu.config import Config
    p = str(tmp_path / "j.cfg")
    Config.create_template(p)
    return open(p).read()


def test_subreads_in_sr_mode_name_ccs(tmp_path):
    ids = [f"m140_1/{h}/0_900" for h in range(5)]
    lp, sp = _inputs(tmp_path, 100, 40, ids=ids)
    with pytest.raises(NotImplementedError, match="ccs-1"):
        tmain(["-l", lp, "-s", sp, "-p", str(tmp_path / "res"),
               "--no-checkpoint", "--device", "cpu", "-q"])
