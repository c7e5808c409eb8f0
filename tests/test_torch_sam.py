"""Port parity: SAM/BAM re-entry, variant calling, ``dazz2sam``, the tools
and the command line in the ``sam``, ``bam`` and ``legacy`` modes.

Every case runs the JAX package's function and the port's on the same
inputs: ``tests/test_sam.py``'s records (SAM line, SAM/BAM files, the
``.bai`` over a stream past one BGZF block, gzipped SAM, secondary
restore), ``tests/test_perl_parity.py``'s simulated mappings (the SAM the
vendored Perl engine ``tests/perl_cns.pl`` reads there) for ``sam2cns``
and ``sam2cns_variants`` (with ``stabilize``), and
``tests/test_dazz2sam.py``'s LAshow text. Tolerance: equality — SAM text,
BAM and ``.bai`` bytes, records, variant tables (f32 arrays bit for bit)
and tool outputs byte for byte; the port's consensus also meets the Perl
engine's 0.1% bar where ``tests/test_perl_parity.py`` sets it. The
command-line twin runs both CLIs (``--device cpu`` for the port) in
``-m sam --sam``, ``-m bam --bam`` (indexed, region fetch) and ``-m legacy
--debug``, each side in one ``nice`` subprocess: the five read and table
files, ``debug.tsv`` and the ``admitted.*.sam`` dumps byte for byte,
``parameter.log`` the same but its ``argv`` and the paths of the run's own
journal and debug dir."""

import gzip
import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_sam as jsam_tests
from proovread_tpu.consensus.params import ConsensusParams as JParams
from proovread_tpu.io import sam as jsam
from proovread_tpu.io.records import SeqRecord as JRecord

from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.io import sam as tsam
from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.pipeline import dazz2sam as tdazz
from proovread_tpu_torch.pipeline import sam2cns as ts2c

from test_dazz2sam import LASHOW
from test_perl_parity import (DRIVER, PERL, _identity, _run_perl, _simulate,
                              _two_hap_fixture)
from test_torch_cli import OUTPUTS, ROOT, _outputs
from test_torch_cli_modes import RUNS, _noisy, _revcomp, _write

# the JAX package's ``pipeline`` re-exports functions under these modules'
# names
jdazz = importlib.import_module("proovread_tpu.pipeline.dazz2sam")
js2c = importlib.import_module("proovread_tpu.pipeline.sam2cns")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_cli.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(rec: jsam.SamAlignment) -> tsam.SamAlignment:
    return tsam.SamAlignment(**{k: getattr(rec, k) for k in (
        "qname", "flag", "rname", "pos", "mapq", "cigar", "rnext", "pnext",
        "tlen", "seq", "qual")}, tags=dict(rec.tags))


def _fields(rec):
    return (rec.qname, rec.flag, rec.rname, rec.pos, rec.mapq, rec.cigar,
            rec.rnext, rec.pnext, rec.tlen, rec.seq, rec.qual, rec.tags)


# -- io/sam ---------------------------------------------------------------

def test_sam_line_parse_and_alignment():
    j = jsam.SamAlignment.from_sam_line(jsam_tests.SAM_LINE)
    t = tsam.SamAlignment.from_sam_line(jsam_tests.SAM_LINE)
    assert _fields(t) == _fields(j)
    assert t.to_sam_line() == j.to_sam_line()
    assert (t.ref_span, t.length, t.full_length, t.score, t.is_reverse) == (
        j.ref_span, j.length, j.full_length, j.score, j.is_reverse)
    assert t.phreds().tobytes() == j.phreds().tobytes()
    for inv in (False, True):
        ja, ta = j.to_alignment(inv), t.to_alignment(inv)
        assert (ta.qname, ta.pos0, ta.score, ta.flag, ta.span) == (
            ja.qname, ja.pos0, ja.score, ja.flag, ja.span)
        for f in ("seq_codes", "ops", "lens", "qual"):
            assert getattr(ta, f).tobytes() == getattr(ja, f).tobytes(), f


def _io_records():
    recs = jsam_tests.TestSamIO()._records()
    recs[2].rname = "lr2"
    recs[3].tags["XB"] = ("B", ("i", [1, -2, 3]))
    recs[4].tags["XF"] = ("f", 1.5)
    return recs


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_sam_bam_writers_match_bytes(tmp_path, fmt):
    """The same records through both packages' writers give the same
    bytes (BAM: BGZF blocks at zlib level 6), and each reader reads the
    other's file as its own."""
    out = {}
    for name, mod, conv in (("jax", jsam, lambda r: r), ("port", tsam, _port)):
        hdr = mod.SamHeader()
        hdr.add_ref("lr1", 500)
        hdr.add_ref("lr2", 300)
        p = str(tmp_path / f"{name}.{fmt}")
        w = (mod.BamWriter(p, hdr) if fmt == "bam"
             else mod.SamWriter(p, header=hdr))
        with w:
            for r in _io_records():
                w.write(conv(r))
        out[name] = p
    assert open(out["port"], "rb").read() == open(out["jax"], "rb").read()
    jr, tr = jsam.SamReader(out["port"]), tsam.SamReader(out["jax"])
    assert tr.header.refs == jr.header.refs == {"lr1": 500, "lr2": 300}
    assert tr.header.lines == jr.header.lines
    assert [_fields(r) for r in tr] == [_fields(r) for r in jr]


def test_bai_build_and_fetch_match(tmp_path):
    """``build_bai`` over a stream of 800 records (past one 64 KiB BGZF
    block): the same ``.bai`` bytes, and every window's ``fetch`` gives
    the JAX package's records."""
    rng = np.random.default_rng(11)
    hdr = tsam.SamHeader()
    hdr.add_ref("c1", 120000)
    hdr.add_ref("c2", 50000)
    recs = []
    for rname, rlen in (("c1", 120000), ("c2", 50000)):
        for k, pos in enumerate(np.sort(rng.integers(0, rlen - 600, 400))):
            ln = int(rng.integers(80, 600))
            recs.append(tsam.SamAlignment(
                qname=f"{rname}_{k}", rname=rname, pos=int(pos),
                cigar=f"{ln}M", seq="".join(
                    "ACGT"[i] for i in rng.integers(0, 4, ln)),
                qual="I" * ln))
    p = str(tmp_path / "big.bam")
    with tsam.BamWriter(p, hdr) as w:
        for r in recs:
            w.write(r)
    jbai = jsam.build_bai(p, str(tmp_path / "j.bai"))
    assert tsam.build_bai(p) == p + ".bai"
    assert open(p + ".bai", "rb").read() == open(jbai, "rb").read()
    jr, tr = jsam.SamReader(p), tsam.SamReader(p)
    for rname, start, end in (("c1", 0, 120000), ("c1", 30000, 31000),
                              ("c2", 0, 100), ("c2", 49000, 50000),
                              ("c1", 119000, 120000), ("nope", 0, 100)):
        got = [_fields(a) for a in tr.fetch(rname, start, end)]
        assert got == [_fields(a) for a in jr.fetch(rname, start, end)]
        if rname != "nope":
            assert got


def test_gzip_sam_and_restore_secondary(tmp_path):
    p = str(tmp_path / "x.sam.gz")
    with gzip.open(p, "wt") as fh:
        fh.write("@SQ\tSN:lr1\tLN:99\n")
        fh.write(jsam_tests.SAM_LINE + "\n")
    tr, jr = tsam.SamReader(p), jsam.SamReader(p)
    assert tr.header.refs == jr.header.refs == {"lr1": 99}
    assert [_fields(r) for r in tr] == [_fields(r) for r in jr]

    def recs(mod):
        return [mod.SamAlignment(qname="q", flag=0, rname="a", pos=0,
                                 cigar="8M", seq="ACGTACGT", qual="IIIIHHHH"),
                mod.SamAlignment(qname="q", flag=0x100, rname="a", pos=50,
                                 cigar="8M", seq="*", qual="*"),
                mod.SamAlignment(qname="q", flag=0x110, rname="a", pos=70,
                                 cigar="8M", seq="*", qual="*"),
                mod.SamAlignment(qname="u", flag=0x4),
                mod.SamAlignment(qname="p", flag=0, rname="a", pos=3,
                                 cigar="4M", seq="ACGT", qual="*")]
    got = [_fields(r) for r in tsam.restore_secondary(recs(tsam))]
    assert got == [_fields(r) for r in jsam.restore_secondary(recs(jsam))]
    assert len(got) == 4


# -- sam2cns and variants -------------------------------------------------

def _mapping(tmp_path, seed, **kw):
    """A ``tests/test_perl_parity.py`` mapping: the SAM file, the long
    read (phred 5) as a record of each package, and the truth."""
    truth, long_read, lines = _simulate(np.random.default_rng(seed), **kw)
    sam = tmp_path / f"in{seed}.sam"
    sam.write_text("".join(ln + "\n" for ln in lines))
    q = np.full(len(long_read), 5, np.uint8)
    return (str(sam), [JRecord("lr0", long_read, qual=q)],
            [SeqRecord("lr0", long_read, qual=q)], truth, long_read)


def _rec_key(recs):
    return [(r.id, r.seq, r.qual.tobytes(), r.desc) for r in recs]


@pytest.mark.parametrize("case", ["binned", "ref_qual", "utg", "chimera"])
def test_sam2cns_records_match_jax(tmp_path, case):
    """``sam2cns_records`` on the simulated mappings: binned admission,
    ref-qual votes, utg mode (plain add, contained filter, qual-weighted
    fractional votes through the ordered scatter) and chimera detection."""
    if case == "utg":
        sam, jrefs, trefs, _, _ = _mapping(tmp_path, 9, glen=1000, n_sr=80,
                                           sr_len=220)
        kw = dict(indel_taboo_length=7, use_ref_qual=True,
                  qual_weighted=True)
        ckw = dict(utg_mode=True)
    else:
        sam, jrefs, trefs, _, _ = _mapping(tmp_path, 0 if case == "binned"
                                           else 1)
        kw = dict(indel_taboo_length=7, max_coverage=50, bin_size=20,
                  use_ref_qual=case != "binned")
        ckw = dict(detect_chimera=case == "chimera")
    jout, jchim = js2c.sam2cns_records(
        sam, jrefs, js2c.Sam2CnsConfig(params=JParams(**kw), **ckw))
    tout, tchim = ts2c.sam2cns_records(
        sam, trefs, ts2c.Sam2CnsConfig(params=ConsensusParams(**kw), **ckw),
        device="cpu")
    assert _rec_key(tout) == _rec_key(jout)
    assert tchim == jchim
    assert tout[0].seq != trefs[0].seq


def test_sam2cns_meets_perl_bar(tmp_path):
    """The port's consensus against the Perl engine's on
    ``test_consensus_parity_vs_perl``'s seed-0 mapping: both near the
    truth and at most 0.1% apart."""
    if PERL is None:
        pytest.skip("perl not available")
    sam, _, trefs, truth, long_read = _mapping(tmp_path, 0)
    ref_path = tmp_path / "ref.fq"
    ref_path.write_text(f"@lr0\n{long_read}\n+\n{'&' * len(long_read)}\n")
    perl = _run_perl(sam, ref_path, indel_taboo_length=7, max_coverage=50,
                     bin_size=20, use_ref_qual=0, trim=1)["lr0"][0].upper()
    ours, _ = ts2c.sam2cns_records(sam, trefs, ts2c.Sam2CnsConfig(
        params=ConsensusParams(indel_taboo_length=7, max_coverage=50,
                               bin_size=20)), device="cpu")
    ours = ours[0].seq.upper()
    assert _identity(ours, truth) > 0.99 and _identity(perl, truth) > 0.99
    assert 1.0 - _identity(ours, perl) <= 0.001
    assert DRIVER.exists()


def _table_key(table):
    return (table.covs.tobytes(), table.order.tobytes(),
            table.freqs.tobytes(), table.n_kept.tobytes(),
            table.ins_strings,
            None if table.stabilized is None else [
                [(g.start, g.length, g.vars, g.freqs, g.cov) for g in grp]
                for grp in table.stabilized])


@pytest.mark.parametrize("min_freq,min_prob,or_min,stabilize", [
    (4, 0, False, False), (3, 0.2, True, False), (4, 0, False, True)],
    ids=["min_freq", "haplo_branch", "stabilize"])
def test_variant_tables_match_jax(tmp_path, min_freq, min_prob, or_min,
                                  stabilize):
    """``sam2cns_variants`` on ``test_variants_parity_vs_perl``'s mapping
    (seed 3) and, with ``stabilize``, on the two-haplotype fixture whose
    close-variant group the stabilizer re-calls; ``variants_tsv`` of the
    two tables is the same text."""
    from proovread_tpu.ops.variants import variants_tsv as jtsv
    from proovread_tpu_torch.ops.variants import variants_tsv as ttsv
    if stabilize:
        ref, lines = _two_hap_fixture(np.random.default_rng(8))
        sam = tmp_path / "hap.sam"
        sam.write_text("".join(ln + "\n" for ln in lines))
        sam = str(sam)
        q = np.full(len(ref), 5, np.uint8)
        jrefs, trefs = [JRecord("lr0", ref, qual=q)], [SeqRecord(
            "lr0", ref, qual=q)]
    else:
        sam, jrefs, trefs, _, _ = _mapping(tmp_path, 3)
    kw = dict(indel_taboo_length=7, max_coverage=50, bin_size=20)
    vkw = dict(min_freq=min_freq, min_prob=min_prob, or_min=or_min,
               stabilize=stabilize)
    (jg, jt), = js2c.sam2cns_variants(
        sam, jrefs, js2c.Sam2CnsConfig(params=JParams(**kw)), **vkw)
    (tg, tt), = ts2c.sam2cns_variants(
        sam, trefs, ts2c.Sam2CnsConfig(params=ConsensusParams(**kw)),
        device="cpu", **vkw)
    assert [r.id for r in tg] == [r.id for r in jg]
    assert _table_key(tt) == _table_key(jt)
    ids, lens = [r.id for r in tg], [len(r) for r in tg]
    assert ttsv(tt, ids, lens) == jtsv(jt, ids, lens)
    assert (tt.n_kept > 1).any()
    if stabilize:
        assert tt.stabilized[0] and tt.stabilized[0][0].start == 400


# -- dazz2sam -------------------------------------------------------------

@pytest.mark.parametrize("add_scores", [False, True])
def test_dazz2sam_matches_jax(add_scores):
    ja = jdazz.parse_lashow(io.StringIO(LASHOW))
    ta = tdazz.parse_lashow(io.StringIO(LASHOW))
    assert [vars(a) for a in ta] == [vars(a) for a in ja]
    kw = dict(ref_names={1: "r1", 2: "r2"}, qry_names={1: "q1", 2: "q2"},
              qry_lengths={"q1": 20, "q2": 91},
              ref_lengths={"r1": 50, "r2": 120}, add_scores=add_scores)
    jo, to = io.StringIO(), io.StringIO()
    assert tdazz.las2sam(ta, to, **kw) == jdazz.las2sam(ja, jo, **kw) == 3
    assert to.getvalue() == jo.getvalue()
    for a in ta:
        for qlen in (None, a.qend + 5):
            args = (a.rseq, a.qseq, a.qstart, a.qend, qlen)
            assert tdazz.aln2cigar(*args) == jdazz.aln2cigar(*args)
        assert tdazz.aln2score(a.rseq, a.qseq) == jdazz.aln2score(a.rseq,
                                                                  a.qseq)


# -- tools ----------------------------------------------------------------

def test_tools_match_jax(tmp_path, capsys):
    """``python -m …tools``: ``sam2cns`` (consensus, and ``--variants
    --stabilize``), ``samfilter`` (SAM out; ``.bam`` out equals the JAX
    package's ``BamWriter`` of the same records), ``bamindex`` and
    ``dazz2sam``, each tool's output file equal to the JAX tool's."""
    from proovread_tpu import tools as jtools
    from proovread_tpu_torch import tools as ttools
    ref, lines = _two_hap_fixture(np.random.default_rng(8))
    # coordinate-sorted, so that its BAM can be indexed
    lines.sort(key=lambda ln: int(ln.split("\t")[3]))
    sam = tmp_path / "hap.sam"
    sam.write_text("@SQ\tSN:lr0\tLN:%d\n" % len(ref)
                   + "".join(ln + "\n" for ln in lines))
    fq = tmp_path / "ref.fq"
    fq.write_text(f"@lr0\n{ref}\n+\n{'&' * len(ref)}\n")
    las = tmp_path / "las.txt"
    las.write_text(LASHOW)
    fa = tmp_path / "names.fa"
    fa.write_text(">r1\n" + "A" * 50 + "\n>r2\n" + "C" * 120 + "\n")
    runs = [("cns.fq", ["sam2cns", str(sam), str(fq)]),
            ("vars.tsv", ["sam2cns", "--variants", "--stabilize", str(sam),
                          str(fq)]),
            ("filt.sam", ["samfilter", str(sam)]),
            ("las.sam", ["dazz2sam", str(las), "--ref", str(fa), "--qry",
                         str(fa), "-S"])]
    for out, argv in runs:
        dev = ["--device", "cpu"] if argv[0] == "sam2cns" else []
        assert jtools.main(argv + [str(tmp_path / f"j.{out}")]) == 0
        assert ttools.main(argv[:1] + dev + argv[1:]
                           + [str(tmp_path / f"t.{out}")]) == 0
        got = (tmp_path / f"t.{out}").read_bytes()
        assert got and got == (tmp_path / f"j.{out}").read_bytes(), out
    # SAM -> BAM and its index with the port's tools
    bam = str(tmp_path / "t.bam")
    assert ttools.main(["samfilter", str(sam), bam]) == 0
    jbam = str(tmp_path / "j.bam")
    rd = jsam.SamReader(str(sam))
    with jsam.BamWriter(jbam, rd.header) as w:
        for r in jsam.restore_secondary(iter(rd)):
            w.write(r)
    assert open(bam, "rb").read() == open(jbam, "rb").read()
    assert ttools.main(["bamindex", bam]) == 0
    assert jtools.main(["bamindex", jbam]) == 0
    assert open(bam + ".bai", "rb").read() == open(jbam + ".bai",
                                                   "rb").read()
    assert ttools.main(["ccseq", "--device", "gpu", "x"]) == 2
    assert ttools.main(["nope"]) == 2
    capsys.readouterr()


# -- the command line -----------------------------------------------------

def _cli_inputs(root):
    """Inputs of the three command-line cases: two long reads with their
    simulated mappings (``-m sam``; the BAM of the same records with a
    ``.bai`` and a third header reference no read names, so ``-m bam``
    fetches regions), and for ``-m legacy`` two 8% CLR-like reads of a
    1.2 kb genome with 300 error-free 100 bp short reads (25x: the passes
    sample)."""
    lines, longs = [], []
    hdr = ["@HD\tVN:1.6\tSO:unsorted"]
    for k, seed in enumerate((0, 1)):
        _, long_read, sl = _simulate(np.random.default_rng(seed), glen=900,
                                     n_sr=150)
        longs.append(JRecord(f"lr{k}", long_read,
                             qual=np.full(len(long_read), 5, np.uint8)))
        hdr.append(f"@SQ\tSN:lr{k}\tLN:{len(long_read)}")
        lines += [ln.replace("\tlr0\t", f"\tlr{k}\t") for ln in sl]
    hdr.append("@SQ\tSN:lr9\tLN:1000")
    sam = root / "map.sam"
    sam.write_text("".join(ln + "\n" for ln in hdr + lines))
    rd = jsam.SamReader(str(sam))
    order = {n: i for i, n in enumerate(rd.header.refs)}
    with jsam.BamWriter(str(root / "map.bam"), rd.header) as w:
        for r in sorted(rd, key=lambda r: (order[r.rname], r.pos)):
            w.write(r)
    jsam.build_bai(str(root / "map.bam"))
    long_fq = _write(root / "long.fq", longs)

    rng = np.random.default_rng(23)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 1200))
    lg = []
    for i in range(2):
        st = int(rng.integers(0, len(genome) - 600))
        seq = _noisy(rng, genome[st:st + 600], 0.08)
        lg.append(JRecord(f"lg{i}", seq, qual=np.full(len(seq), 5, np.uint8)))
    srs = []
    for i in range(300):
        st = int(rng.integers(0, len(genome) - 100))
        seq = genome[st:st + 100]
        srs.append(JRecord(f"s{i}", _revcomp(seq) if i % 2 else seq,
                           qual=np.full(100, 30, np.uint8)))
    return {
        "sam": ["-l", long_fq, "--sam", str(sam), "-m", "sam"],
        "bam": ["-l", long_fq, "--bam", str(root / "map.bam"), "-m", "bam"],
        "legacy": ["-l", _write(root / "lg.fq", lg),
                   "-s", _write(root / "sr.fq", srs), "-m", "legacy",
                   "--debug"],
    }


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Each case through the JAX CLI in one process, then through the
    port's (``--device cpu``), at the lowest CPU priority."""
    root = tmp_path_factory.mktemp("cli_sam")
    cfg = root / "c.cfg"
    cfg.write_text(json.dumps({"device-chunk": 128}))
    cases = _cli_inputs(root)
    argvs = {"jax": [], "port": []}
    for case, args in cases.items():
        for side, extra in (("jax", []), ("port", ["--device", "cpu"])):
            argvs[side].append(args + ["-q", "-c", str(cfg), "-p",
                                       str(root / side / case)] + extra)
    for side, package, env in (("jax", "proovread_tpu", {}),
                               ("port", "proovread_tpu_torch",
                                {"OMP_NUM_THREADS": "2"})):
        spec = root / f"{side}.json"
        spec.write_text(json.dumps(argvs[side]))
        run = subprocess.run(
            ["nice", "-n", "19", sys.executable, "-c", RUNS, package,
             str(spec)], cwd=ROOT, capture_output=True, text=True,
            timeout=900, env=dict(os.environ, **env))
        assert run.returncode == 0, (side, run.stderr[-3000:])
    return root


@pytest.mark.parametrize("case", ["sam", "bam", "legacy"])
def test_cli_mode_matches_jax(cli_runs, case):
    jdir, tdir = cli_runs / "jax" / case, cli_runs / "port" / case
    jfiles, jlog = _outputs(str(jdir))
    tfiles, tlog = _outputs(str(tdir))
    for plog in (jlog, tlog):
        plog["config"].pop("debug-dir", None)
    assert tfiles == jfiles
    assert tlog == jlog and tlog["mode"] == case
    assert tfiles["untrimmed.fq"].count(b"\n@") + 1 == 2
    extra = sorted(p.name for p in jdir.iterdir()
                   if not any(p.name.endswith(s) for s in OUTPUTS)
                   and not p.name.endswith("parameter.log"))
    assert extra == sorted(p.name for p in tdir.iterdir()
                           if not any(p.name.endswith(s) for s in OUTPUTS)
                           and not p.name.endswith("parameter.log"))
    for name in extra:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    if case == "legacy":
        assert f"{case}.debug.tsv" in extra
        assert any(n.startswith("admitted.") for n in extra)
    else:
        assert extra == []
