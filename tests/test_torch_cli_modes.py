"""Port parity: the command line in the modes of the subread consensus
(``ccs-1``), unitig correction (``-u``) and flex mode (``--haplo-coverage``).

The JAX package's command line and the port's (``--device cpu``) run,
one after the other, on the same seeded inputs, each mode
auto-detected from them as a user's run would be: ``sr`` and ``mr`` on
PacBio subread ids (ZMWs of one to three subreads of alternating strand
over a 3 kb genome; ``ccs-1``, then the passes), ``sr+utg-noccs`` and,
without short reads, ``utg-noccs`` with ``-u`` (unitigs tiling the genome,
0.1% substitutions, FASTA), and ``sr-noccs`` with a bare
``--haplo-coverage`` (two haplotypes, a SNP every 60 bases, 8x of A's and
30x of B's short reads). A config keeps the CPU cost down (``device-chunk``
128, ``ccs`` windows of 128 with an overlap of 32 so that the JAX side's
XLA ``sw_batch`` stays at m = 128, ``utg-window`` 256). Tolerance: the five
read and table files and ``qc.jsonl`` byte for byte, ``parameter.log`` the
same but its ``argv`` and journal path. Each package runs every case in
one subprocess at the lowest CPU priority (its kernels compile once), the
JAX one first."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from proovread_tpu.io import fastq as jfastq
from proovread_tpu.io.records import SeqRecord as JRecord

from test_torch_cli import ROOT, _outputs, _revcomp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_cli.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, recs, fq=True):
    from proovread_tpu.io import fasta as jfasta
    with open(path, "wb") as fh:
        w = jfastq.FastqWriter(fh) if fq else jfasta.FastaWriter(fh)
        for r in recs:
            w.write(r)
    return str(path)


def _noisy(rng, true: str, err: float) -> str:
    """CLR-like copy: insertions, deletions and substitutions at ``err``."""
    out = []
    for c in true:
        u = rng.random()
        if u < err * 0.3:
            continue
        if u < err * 0.5:
            out.append("ACGT"[int(rng.integers(0, 4))])
        out.append("ACGT"[int(rng.integers(0, 4))] if err * 0.8 < u < err
                   else c)
    return "".join(out)


def _case_inputs(tmp_path, case):
    """Long, short and unitig files of a new-mode case: PacBio subreads
    (ZMWs of one to three subreads of alternating strand over a 3 kb
    genome), 100 bp or 250 bp short reads, unitigs tiling the genome with
    0.1% substitutions (FASTA), or two haplotypes (B = A with a SNP every
    60 bases; long reads of both, short reads 8x of A and 30x of B)."""
    rng = np.random.default_rng(17)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
    hap_b = list(genome)
    for p in range(30, len(genome), 60):
        hap_b[p] = "ACGT"[("ACGT".index(genome[p]) + 1) % 4]
    hap_b = "".join(hap_b)
    longs, utgs = [], []
    if case in ("sr-subreads", "mr-subreads"):
        for hole, n_subs in ((3, 2), (4, 1), (5, 3), (6, 2)):
            st = int(rng.integers(0, len(genome) - 900))
            mol, pos = genome[st:st + 900], 0
            for k in range(n_subs):
                seq = _noisy(rng, mol if k % 2 == 0 else _revcomp(mol), 0.1)
                longs.append(JRecord(
                    f"m140_9/{hole}/{pos}_{pos + len(seq)}", seq,
                    qual=np.full(len(seq), 8, np.uint8)))
                pos += len(seq) + 40
    else:
        for i in range(4):
            src = hap_b if (case == "flex" and i % 2) else genome
            st = int(rng.integers(0, len(genome) - 900))
            seq = _noisy(rng, src[st:st + 900], 0.08)
            longs.append(JRecord(f"lr{i}", seq,
                                 qual=np.full(len(seq), 5, np.uint8)))
    if case in ("sr+utg-noccs", "utg-noccs"):
        for k in range(4):
            frag = list(genome[k * 650:k * 650 + 1000])
            for p in np.flatnonzero(rng.random(len(frag)) < 0.001):
                frag[p] = "ACGT"[("ACGT".index(frag[p]) + 1) % 4]
            utgs.append(JRecord(f"utg{k}", "".join(frag)))
    sr_len = 250 if case == "mr-subreads" else 100
    srs = []
    if case != "utg-noccs":
        srcs = ([(genome, 80), (hap_b, 300)] if case == "flex"
                else [(genome, 300 if sr_len == 100 else 120)])
        for src, n in srcs:
            for i in range(n):
                st = int(rng.integers(0, len(src) - sr_len))
                seq = src[st:st + sr_len]
                if rng.random() < 0.5:
                    seq = _revcomp(seq)
                srs.append(JRecord(f"s{len(srs)}", seq,
                                   qual=np.full(sr_len, 30, np.uint8)))
    argv = ["-l", _write(tmp_path / "long.fq", longs)]
    if srs:
        argv += ["-s", _write(tmp_path / "short.fq", srs)]
    if utgs:
        argv += ["-u", _write(tmp_path / "utg.fa", utgs, fq=False)]
    if case == "flex":
        argv.append("--haplo-coverage")
    return argv


# one process a side runs every case's command line in turn (the JAX
# side then compiles its kernels once, not once a case)
RUNS = """
import json, sys
main = __import__(sys.argv[1] + ".cli", fromlist=["main"]).main
for argv in json.load(open(sys.argv[2])):
    rc = main(argv)
    if rc:
        sys.exit(f"exit {rc}: {argv}")
"""

CASES = [("sr-subreads", "sr"), ("mr-subreads", "mr"),
         ("sr+utg-noccs", "sr+utg-noccs"), ("utg-noccs", "utg-noccs"),
         ("flex", "sr-noccs")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's inputs, then the JAX CLI on all of them in one
    process, then the port's (``--device cpu``, two torch threads)."""
    root = tmp_path_factory.mktemp("cli_modes")
    cfg = root / "c.cfg"
    cfg.write_text(json.dumps({
        "device-chunk": 128, "utg-window": 256, "utg-overlap": 32,
        "ccs": {"--min-subreads": 2, "--window": 128, "--overlap": 32,
                "--batch-refs": 256}}))
    argvs = {"jax": [], "port": []}
    for case, _ in CASES:
        d = root / case
        d.mkdir()
        args = _case_inputs(d, case) + ["-q", "-c", str(cfg)]
        for side, extra in (("jax", []), ("port", ["--device", "cpu"])):
            (d / side).mkdir()
            argvs[side].append(args + ["-p", str(d / side / "res"),
                                       "--qc-out", str(d / side / "qc.jsonl")]
                               + extra)
    for side, package, env in (("jax", "proovread_tpu", {}),
                               ("port", "proovread_tpu_torch",
                                {"OMP_NUM_THREADS": "2"})):
        spec = root / f"{side}.json"
        spec.write_text(json.dumps(argvs[side]))
        run = subprocess.run(
            ["nice", "-n", "19", sys.executable, "-c", RUNS, package,
             str(spec)], cwd=ROOT, capture_output=True, text=True,
            timeout=1200, env=dict(os.environ, **env))
        assert run.returncode == 0, (side, run.stderr[-3000:])
    return root


@pytest.mark.heavy
@pytest.mark.parametrize("case,mode", CASES)
def test_cli_mode_matches_jax(runs, case, mode):
    d = runs / case
    jfiles, jlog = _outputs(str(d / "jax" / "res"))
    tfiles, tlog = _outputs(str(d / "port" / "res"))
    assert tfiles == jfiles
    assert tlog == jlog and tlog["mode"] == mode
    assert ((d / "port" / "qc.jsonl").read_bytes()
            == (d / "jax" / "qc.jsonl").read_bytes())
    assert tfiles["untrimmed.fq"]
    if "subreads" in case:
        # one read a ZMW, of 8 subreads in 4 ZMWs
        assert len(tfiles["untrimmed.fq"].splitlines()) == 4 * 4
