"""Port parity: the command line, ``python -m proovread_tpu_torch``.

``python -m proovread_tpu`` and ``python -m proovread_tpu_torch --device
cpu`` run on the same seeded inputs (``tests/test_cli.py:_mk_inputs``
sizes: 4 long reads of 900 bp with 8% substitutions, plus one siamaera
palindrome, over a 3 kb genome) with ``--no-checkpoint`` on both sides and
siamaera on (the default config). Tolerance: the five read and table files
byte-identical; ``parameter.log`` the same JSON except ``argv``, which
names each package's program and carries the port's ``--device`` flag.
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

from proovread_tpu_torch.cli import main as tmain

ROOT = Path(__file__).resolve().parent.parent
OUTPUTS = ("untrimmed.fq", "trimmed.fq", "trimmed.fa", "ignored.tsv",
           "chim.tsv")


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _inputs(tmp_path, sr_len, n_srs, ids=None):
    """_mk_inputs' construction with ``sr_len`` short reads, and a fifth
    long read that is a palindrome (arm, junction, reverse-complemented
    arm) for siamaera to trim."""
    rng = np.random.default_rng(3)
    bases = "ACGT"
    genome = "".join(bases[i] for i in rng.integers(0, 4, 3000))
    seqs = []
    for _ in range(4):
        st = int(rng.integers(0, len(genome) - 900))
        seq = list(genome[st:st + 900])
        for mu in np.flatnonzero(rng.random(900) < 0.08):
            seq[mu] = bases[int(rng.integers(0, 4))]
        seqs.append("".join(seq))
    arm = genome[1000:1450]
    seqs.append(arm + genome[2000:2040] + _revcomp(arm))
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
    return paths


@pytest.mark.heavy
@pytest.mark.parametrize("mode,sr_len,n_srs", [("sr-noccs", 100, 400),
                                               ("mr-noccs", 250, 160)])
def test_cli_outputs_match_jax(tmp_path, mode, sr_len, n_srs):
    lp, sp = _inputs(tmp_path, sr_len, n_srs)
    args = ["-l", lp, "-s", sp, "--no-checkpoint", "-q"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jout, tout = str(tmp_path / "jax" / "res"), str(tmp_path / "port" / "res")
    for package, argv in (("proovread_tpu", args + ["-p", jout]),
                          ("proovread_tpu_torch",
                           args + ["-p", tout, "--device", "cpu"])):
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
    assert tlog.pop("argv")[1:] == args + ["-p", tout, "--device", "cpu"]
    assert jlog.pop("argv")[1:] == args + ["-p", jout]
    assert tlog == jlog
    trimmed = open(os.path.join(tout, "res.trimmed.fq")).read()
    assert "SIAMAERA:" in trimmed                  # the palindrome was cut


@pytest.mark.parametrize("flag", [
    ["serve"], ["-u", "utg.fa"], ["--sam", "x.sam"], ["--bam", "x.bam"],
    ["--haplo-coverage"], ["--resume"], ["--mesh-shards", "2"],
    ["--mesh-pass-timeout", "5"], ["--bucket-timeout", "5"],
    ["--trace", "t.jsonl"], ["--metrics-out", "m.json"],
    ["--qc-out", "q.jsonl"], ["--truth", "t.jsonl"],
    ["--compile-ledger", "c.jsonl"], ["--compile-cache"],
    ["--xprof", "xp"], ["--debug"]], ids=lambda f: f[0])
def test_refused_flags_name_themselves(tmp_path, capsys, flag):
    out = str(tmp_path / "res")
    argv = flag if flag == ["serve"] else (
        ["-l", "l.fq", "-s", "s.fq", "-p", out, "--no-checkpoint"] + flag)
    assert tmain(argv) == 2
    assert flag[0] in capsys.readouterr().err
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
