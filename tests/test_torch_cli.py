"""Port parity: the command line, ``python -m proovread_tpu_torch``.

``python -m proovread_tpu`` and ``python -m proovread_tpu_torch --device
cpu`` run on the same seeded inputs (``tests/test_cli.py:_mk_inputs``
sizes: 4 long reads of 900 bp with 8% substitutions, plus one siamaera
palindrome, over a 3 kb genome) with the default command on both sides
(the checkpoint journal on) and siamaera on (the default config).
Tolerance: the five read and table files byte-identical; ``parameter.log``
the same JSON except ``argv``, which names each package's program and
carries the port's ``--device`` flag, and the config's ``checkpoint-dir``,
which is each run's own ``<pre>/.proovread_ckpt``; no journal is left.
The sr-noccs twin also writes ``--qc-out`` and ``--metrics-out`` and
scores ``--truth`` (a sidecar of the genome slices the long reads came
from): ``qc.jsonl`` byte-identical, ``metrics.json`` equal but for the
values of ``bucket_seconds`` (timings) and the ``jax_retraces`` series (0
in the port). A port-only ``--trace`` run passes the JAX package's trace,
QC and metrics validators, with each QC ``bucket_span`` in the trace.
``tests/test_torch_cli_modes.py`` holds the same for the modes of
``ccs-1``, ``-u`` and ``--haplo-coverage``.
Port-only runs hold the journal: the default command writes what
``--no-checkpoint`` writes; a run killed by ``PROOVREAD_FAULT`` under
``--no-ladder`` and then ``--resume``d writes the uninterrupted run's bytes,
``qc.jsonl`` included.
The two runs are subprocesses at the lowest CPU priority: the
reference's side runs its kernels in interpret mode for a minute or more
and shares the machine with the suite's other workers. Also: every flag
the port does not run returns 2 naming itself, and the mesh flags run."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on a few cores, and torch's CPU kernels in each spreading over
    every core slow all of them down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _inputs(tmp_path, sr_len, n_srs, ids=None, truth=False, n_long=4):
    """_mk_inputs' construction with ``sr_len`` short reads, and a last
    long read that is a palindrome (arm, junction, reverse-complemented
    arm) for siamaera to trim. With ``truth``, also a truth sidecar of the
    genome slices the long reads came from (the JAX package's writer)."""
    rng = np.random.default_rng(3)
    bases = "ACGT"
    genome = "".join(bases[i] for i in rng.integers(0, 4, 3000))
    seqs, sources = [], []
    for _ in range(n_long):
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
    args = ["-l", lp, "-s", sp, "-q"]
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
    for log_, out in ((tlog, tout), (jlog, jout)):
        ckpt = os.path.join(out, ".proovread_ckpt")
        assert log_["config"].pop("checkpoint-dir") == ckpt
        assert not os.path.exists(ckpt)
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
    ["serve", "--compile-cache"], ["--compile-ledger", "c.jsonl"],
    ["--compile-cache"], ["--xprof", "xp"]], ids=lambda f: f[0])
def test_refused_flags_name_themselves(tmp_path, capsys, monkeypatch, flag):
    """The flags that were refused before the kernel build's account was
    ported now run (the name is kept from then): ``--compile-ledger``
    writes a ledger both packages' validator accepts, ``--compile-cache``
    (bare: the usual build directory) and ``--xprof`` (a torch.profiler
    trace in the dir) leave the outputs written, and ``serve
    --compile-cache DIR`` serves on the CPU and drains clean.
    ``tests/test_torch_compile.py`` holds the outputs byte-equal."""
    import signal
    import threading
    import time

    from proovread_tpu_torch import kernels
    from proovread_tpu_torch.obs import compilecache
    from proovread_tpu_torch.serve.protocol import ServeClient
    lp, sp = _inputs(tmp_path, 100, 10)
    if flag[0] == "serve":
        # the server keeps its library directory for the process: put
        # this process's back after the test
        monkeypatch.setattr(kernels, "_build_dir_override",
                            kernels._build_dir_override)
        monkeypatch.setattr(compilecache, "_cache_dir",
                            compilecache._cache_dir)
        sock, st = str(tmp_path / "s.sock"), str(tmp_path / "st")
        drained = []

        def drain():
            t0 = time.monotonic()
            while not os.path.exists(sock) and time.monotonic() - t0 < 60:
                time.sleep(0.05)
            with ServeClient(sock) as c:
                drained.append(c.ping()["ok"] and c.drain()["draining"])
        old = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                signal.SIGINT)}
        t = threading.Thread(target=drain, daemon=True)
        t.start()
        try:
            assert tmain(["serve", "-s", sp, "--socket", sock,
                          "--state-dir", st, "--device", "cpu", "-q",
                          "--compile-cache", str(tmp_path / "cache")]) == 0
        finally:
            for s, h in old.items():
                signal.signal(s, h)
        t.join(timeout=30)
        assert drained == [True]
        assert kernels.build_dir() == tmp_path / "cache"
        return
    out = str(tmp_path / "res")
    extra = [str(tmp_path / f) if f in ("c.jsonl", "xp") else f
             for f in flag]
    cfg = tmp_path / "c.cfg"
    cfg.write_text(json.dumps({"batch-reads": 8, "device-chunk": 128}))
    assert tmain(["-l", lp, "-s", sp, "-p", out, "--no-checkpoint",
                  "--device", "cpu", "-q", "-c", str(cfg)] + extra) == 0
    assert "error" not in capsys.readouterr().err
    assert sorted(os.listdir(out)) == sorted(
        f"res.{f}" for f in OUTPUTS + ("parameter.log",))
    if flag[0] == "--compile-ledger":
        from proovread_tpu.obs.validate import validate_compile_ledger
        assert validate_compile_ledger(extra[1])["census"]["calls"] > 0
    if flag[0] == "--xprof":
        assert os.listdir(extra[1]) == ["res.pt.trace.json"]


@pytest.mark.parametrize("flags", [
    ["--mesh-shards", "2"],
    ["--mesh-shards", "2", "--mesh-pass-timeout", "300"]],
    ids=["--mesh-shards", "--mesh-pass-timeout"])
def test_mesh_flags_run(tmp_path, capsys, flags):
    """The mesh flags run (they were refused before the mesh was ported):
    the command starts two ranks on the CPU, rank 0 writes the outputs,
    and a pass budget bounds each sharded pass's wait.
    ``tests/test_torch_dmesh.py`` holds the files equal to the
    single-device command's."""
    lp, sp = _inputs(tmp_path, 100, 10)
    cfg = tmp_path / "c.cfg"
    cfg.write_text(json.dumps({"batch-reads": 8, "device-chunk": 128}))
    out = str(tmp_path / "res")
    assert tmain(["-l", lp, "-s", sp, "-p", out, "--device", "cpu", "-q",
                  "-c", str(cfg), *flags]) == 0
    assert "error" not in capsys.readouterr().err
    assert sorted(os.listdir(out)) == sorted(
        f"res.{f}" for f in OUTPUTS + ("parameter.log",))
    logged = json.loads((tmp_path / "res" / "res.parameter.log").read_text())
    assert logged["config"]["mesh-shards"] == 2
    assert logged["config"]["mesh-pass-timeout"] == (
        300.0 if "--mesh-pass-timeout" in flags else None)


@pytest.mark.parametrize("key", ["compile-ledger", "compile-cache-dir"])
def test_refused_config_keys_name_themselves(tmp_path, capsys, key):
    """The config keys of the compile ledger and the library cache run
    (they were refused before; the name is kept from then)."""
    lp, sp = _inputs(tmp_path, 100, 10)
    cfg = tmp_path / "c.cfg"
    target = str(tmp_path / "x")
    cfg.write_text(json.dumps({key: target, "batch-reads": 8,
                               "device-chunk": 128}))
    out = str(tmp_path / "res")
    assert tmain(["-l", lp, "-s", sp, "-p", out, "--no-checkpoint",
                  "--device", "cpu", "-q", "-c", str(cfg)]) == 0
    assert "error" not in capsys.readouterr().err
    assert os.path.exists(os.path.join(out, "res.untrimmed.fq"))
    if key == "compile-ledger":
        from proovread_tpu.obs.validate import validate_compile_ledger
        assert validate_compile_ledger(target)["census"]["calls"] > 0


def test_checkpoint_journal_needs_no_checkpoint(tmp_path, capsys):
    """``--resume`` needs the journal: with ``--no-checkpoint`` it returns
    2 naming that flag, as the reference does."""
    out = str(tmp_path / "res")
    argv = ["-l", "l.fq", "-s", "s.fq", "-p", out, "--device", "cpu",
            "--resume", "--no-checkpoint"]
    assert tmain(argv) == 2 == jmain(argv[:6] + argv[8:])
    assert "--no-checkpoint" in capsys.readouterr().err
    assert not os.listdir(out)


def _outputs(out):
    """The five read and table files of output dir ``out``, and
    parameter.log without its ``argv`` and the config keys that name the
    run's journal."""
    pre = os.path.join(out, os.path.basename(out))
    files = {suf: open(f"{pre}.{suf}", "rb").read() for suf in OUTPUTS}
    plog = json.load(open(f"{pre}.parameter.log"))
    plog.pop("argv")
    for key in ("checkpoint-dir", "resume"):
        plog["config"].pop(key)
    return files, plog


def test_default_command_leaves_no_journal(tmp_path):
    """The default command (journal on) writes what ``--no-checkpoint``
    writes, and removes the journal once the outputs are written;
    ``--keep-temporary-files`` keeps it."""
    lp, sp = _inputs(tmp_path, 100, 400)
    cfg = tmp_path / "c.cfg"
    cfg.write_text(json.dumps({"device-chunk": 128}))
    outs = {}
    for name, extra in (("plain", ["--no-checkpoint"]), ("ckpt", []),
                        ("keep", ["--keep-temporary-files"])):
        out = str(tmp_path / name / "res")
        assert tmain(["-l", lp, "-s", sp, "-p", out, "--device", "cpu",
                      "-q", "-c", str(cfg), *extra]) == 0
        outs[name] = _outputs(out)
    assert outs["ckpt"] == outs["plain"] == outs["keep"]
    assert not os.path.exists(tmp_path / "ckpt" / "res" / ".proovread_ckpt")
    kept = tmp_path / "keep" / "res" / ".proovread_ckpt"
    assert (kept / "meta.json").exists()
    assert len(list(kept.glob("bucket_*.json"))) == 1


def test_fault_then_resume_writes_the_same_bytes(tmp_path, monkeypatch):
    """Two buckets of 9 reads. ``PROOVREAD_FAULT=compile@b1``
    with ``--no-ladder`` kills the run at bucket 1 with bucket 0
    journaled; ``--resume`` in the same output dir replays bucket 0 and
    writes the uninterrupted run's files and ``qc.jsonl`` byte for byte."""
    from proovread_tpu_torch.testing.faults import InjectedCompileError
    lp, sp = _inputs(tmp_path, 100, 400, n_long=8)
    cfg = tmp_path / "b.cfg"
    cfg.write_text(json.dumps({"batch-reads": 8, "device-chunk": 128}))

    def run(out, *extra):
        return tmain(["-l", lp, "-s", sp, "-p", str(out), "--device", "cpu",
                      "-q", "-c", str(cfg), "--qc-out",
                      str(out) + ".qc.jsonl", "--metrics-out",
                      str(out) + ".metrics.json", *extra])
    ref = tmp_path / "ref" / "res"
    assert run(ref) == 0
    out = tmp_path / "run" / "res"
    monkeypatch.setenv("PROOVREAD_FAULT", "compile@b1")
    with pytest.raises(InjectedCompileError):
        run(out, "--no-ladder")
    journal = tmp_path / "run" / "res" / ".proovread_ckpt"
    assert len(list(journal.glob("bucket_*.json"))) == 1
    monkeypatch.delenv("PROOVREAD_FAULT")
    assert run(out) == 2                       # not empty: needs --resume
    assert run(out, "--resume") == 0
    assert _outputs(str(out)) == _outputs(str(ref))
    assert ((tmp_path / "run" / "res.qc.jsonl").read_bytes()
            == (tmp_path / "ref" / "res.qc.jsonl").read_bytes())
    m = json.load(open(str(out) + ".metrics.json"))["counters"]
    assert m["checkpoint_journal_replays"]["series"][0]["value"] == 1
    assert m["checkpoint_journal_writes"]["series"][0]["value"] == 1
    assert m["resilience_demotions"]["series"] == []
    assert not journal.exists()


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
