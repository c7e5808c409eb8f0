"""Port parity: the accuracy scoreboard (``obs/accuracy.py``) and the
simulators and truth sidecar it scores against (``io/simulate.py``).

The same seeded inputs, made with numpy, go through
``proovread_tpu.obs.accuracy`` / ``proovread_tpu.io.simulate`` and the
port on the CPU. Tolerance: the LCS lengths (the plain PyTorch version of
the ``csrc/lcs.cu`` kernel) bitwise equal, including empty reads and
truths, truths of exact multiples of 64 and of a kernel lane's 2048
bases, reads longer than their truths and N on either side; edit
alignments, per-read accuracy records and summaries, simulated records
and truths equal; truth sidecars byte-identical."""

import numpy as np
import pytest
import torch

from proovread_tpu.io import simulate as jsim
from proovread_tpu.obs import accuracy as jacc
from proovread_tpu.obs import qc as jqc
from proovread_tpu.obs.regress import _median as jmedian
from proovread_tpu.obs.validate import validate_truth_sidecar

from proovread_tpu_torch.io import simulate as tsim
from proovread_tpu_torch.obs import accuracy as tacc
from proovread_tpu_torch.obs import qc as tqc


def _pairs(seed, lengths, err=0.12):
    """(read, truth) code pairs: each truth random, its read the truth
    with ``err`` substitutions (N among them) and ~4% deletions."""
    rng = np.random.default_rng(seed)
    pairs = []
    for n_t in lengths:
        tr = rng.integers(0, 4, int(n_t)).astype(np.int8)
        rd = tr.copy()
        sub = rng.random(len(rd)) < err
        rd[sub] = rng.integers(0, 5, int(sub.sum()))
        rd = np.delete(rd, np.flatnonzero(rng.random(len(rd)) < 0.04))
        pairs.append((rd, tr))
    return pairs


def _edge_pairs():
    pairs = _pairs(1, [0, 10, 64, 128, 63, 2048, 2049, 700, 130, 1, 5])
    rng = np.random.default_rng(2)
    pairs[1] = (pairs[1][0][:0], pairs[1][1])          # empty read
    pairs[7] = (np.concatenate([pairs[7][0], rng.integers(0, 4, 900)])
                .astype(np.int8), pairs[7][1])          # read past truth
    rd, tr = pairs[8]
    tr[::7] = 4                                         # N in the truth
    rd[::5] = 4                                         # N in the read
    pairs[9] = (pairs[9][1].copy(), pairs[9][1])        # identical, len 1
    pairs[10] = (pairs[10][0], pairs[10][1][:0])        # empty truth
    return pairs


def _n_run_pairs():
    """Truths with runs of N: words that never match stay all ones, so
    the carries of the multiword addition must propagate through them."""
    pairs = _pairs(8, [4096, 3000, 700])
    for rd, tr in pairs:
        tr[320:384] = 4
        tr[600:690] = 4
        tr[1000:1300] = 4
    return pairs


@pytest.mark.parametrize("case", ["edges", "short", "lanes", "mixed",
                                  "n_runs"])
def test_lcs_plain_matches_jax(case):
    pairs = {
        "edges": _edge_pairs,
        "short": lambda: _pairs(3, np.random.default_rng(3).integers(
            0, 300, 60)),
        "lanes": lambda: _pairs(4, [2047, 2048, 2049, 2111, 4095, 4097]),
        "mixed": lambda: _pairs(5, np.random.default_rng(5).integers(
            0, 3000, 20), err=0.3),
        "n_runs": _n_run_pairs,
    }[case]()
    want = jacc.lcs_lengths(pairs)
    got = tacc.lcs_lengths(*tacc.pack_pairs(pairs, "cpu"))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "edges":
        assert want[0] == want[1] == want[10] == 0 and want[9] == 1
        assert want[2] > 40 and want[5] > 1500


def test_lcs_takes_the_plain_version_only_on_the_cpu():
    pairs = _pairs(6, [100, 200])
    launches = tacc.lcs_lengths.launches
    tacc.lcs_lengths(*tacc.pack_pairs(pairs, "cpu"))
    assert tacc.lcs_lengths.launches == launches
    meta = [torch.empty_like(t, device="meta")
            for t in tacc.pack_pairs(pairs, "cpu")]
    with pytest.raises(ValueError, match="device"):
        tacc.lcs_lengths(*meta)


def test_lcs_checks_its_offsets():
    text, toff, pat, poff = tacc.pack_pairs(_pairs(7, [100, 200]), "cpu")
    with pytest.raises(ValueError, match="offsets"):
        tacc.lcs_lengths(text, toff.flip(0), pat, poff)
    with pytest.raises(ValueError, match="int8"):
        tacc.lcs_lengths(text.to(torch.int32), toff, pat, poff)
    with pytest.raises(ValueError, match="offsets"):
        tacc.lcs_lengths(text, toff[:-1], pat, poff)


@pytest.mark.parametrize("la,lb,band", [(300, 330, None), (500, 420, None),
                                        (0, 40, None), (250, 250, 8)])
def test_edit_alignment_matches_jax(la, lb, band):
    rng = np.random.default_rng(la + lb)
    b = rng.integers(0, 5, lb).astype(np.int8)
    a = b[:la].copy() if la <= lb else np.concatenate(
        [b, rng.integers(0, 4, la - lb)]).astype(np.int8)
    a[rng.random(len(a)) < 0.1] = 1
    assert (tacc.edit_alignment(a, b, band=band)
            == jacc.edit_alignment(a, b, band=band))


def _chimeric_sets(seed=11):
    """Simulated chimeric CLR reads with their truth and junctions
    (``chimera_frac`` > 0), a corrected set (the truth with 1% errors,
    two reads missing) and detected junctions around some true ones."""
    genome = jsim.random_genome(30_000, seed=seed)
    recs, truths, bps = jsim.simulate_long_reads(
        genome, 14_000, mean_len=800, chimera_frac=0.4, seed=seed,
        with_breakpoints=True)
    rng = np.random.default_rng(seed)
    from proovread_tpu.ops.encode import encode_ascii
    before = {r.id: encode_ascii(r.seq) for r in recs}
    truth = {r.id: t for r, t in zip(recs, truths)}
    after = {}
    for r, t in list(zip(recs, truths))[2:]:
        a = t.copy()
        a[rng.random(len(a)) < 0.01] = rng.integers(0, 4)
        after[r.id] = a
    det = {r.id: [(b - 50, b + 60)] for r, bp in zip(recs, bps)
           for b in bp[:1]}
    det[recs[3].id] = [(10, 40)]                       # a false call
    truth_bps = {r.id: list(bp) for r, bp in zip(recs, bps)}
    assert sum(map(len, bps)) >= 3
    return recs, before, after, truth, det, truth_bps


@pytest.mark.parametrize("classify_cap", [None, 5])
def test_score_read_sets_matches_jax(classify_cap):
    _, before, after, truth, det, truth_bps = _chimeric_sets()
    kw = dict(classify_cap=classify_cap, detected_chimera=det,
              truth_breakpoints=truth_bps)
    want = jacc.score_read_sets(before, after, truth, **kw)
    got = tacc.score_read_sets(before, after, truth, device="cpu", **kw)
    assert got == want
    per_read, summary = got
    assert summary["n_scored"] == len(after)
    assert summary["chimera"]["matched"] > 0
    assert summary["identity_after"] > summary["identity_before"]


def test_apply_to_qc_matches_jax():
    recs, before, after, truth, _, truth_bps = _chimeric_sets(12)
    from proovread_tpu.io.records import SeqRecord as JRecord
    from proovread_tpu.ops.encode import decode_codes
    from proovread_tpu_torch.io.records import SeqRecord
    corrected = [JRecord(rid, decode_codes(a)) for rid, a in after.items()]
    chim_id = next(rid for rid, bp in truth_bps.items() if bp)
    b0 = truth_bps[chim_id][0]
    out = {}
    for name, qc_mod, acc, rec_cls, kw in (
            ("jax", jqc, jacc, JRecord, {}),
            ("port", tqc, tacc, SeqRecord, {"device": "cpu"})):
        rec = qc_mod.QcRecorder()
        for r in recs:
            rec.start_bucket(0, [r])
        rec.record_chimera(chim_id, [(b0 - 20, b0 + 30, 0.5)])
        summary = acc.apply_to_qc(
            rec, [rec_cls(r.id, r.seq) for r in recs],
            [rec_cls(r.id, r.seq) for r in corrected], truth,
            truth_breakpoints=truth_bps, classify_cap=8, **kw)
        out[name] = (summary, rec.records, rec.aggregate())
    assert out["port"] == out["jax"]


def test_truth_sidecar_matches_jax(tmp_path):
    genome = jsim.random_genome(8000, seed=4)
    recs, truths, bps = jsim.simulate_long_reads(
        genome, 6000, mean_len=900, chimera_frac=0.5, seed=4,
        with_breakpoints=True)
    jp, tp = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jsim.write_truth_sidecar(jp, recs, truths, breakpoints=bps)
    tsim.write_truth_sidecar(tp, recs, truths, breakpoints=bps)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    jt, jb = jacc.load_truth_sidecar(jp)
    tt, tb = tacc.load_truth_sidecar(tp)
    assert jb == tb and jt.keys() == tt.keys()
    assert all(np.array_equal(jt[k], tt[k]) for k in jt)
    stats = validate_truth_sidecar(tp, min_reads=len(recs))
    assert stats["n_records"] == len(recs) and stats["n_chimeric"] > 0
    # bare ids and no breakpoints
    tsim.write_truth_sidecar(tp, [r.id for r in recs], truths)
    jsim.write_truth_sidecar(jp, [r.id for r in recs], truths)
    assert open(tp, "rb").read() == open(jp, "rb").read()


def test_load_truth_sidecar_refuses_what_jax_refuses(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"truth_schema": 7}\n')
    for acc in (jacc, tacc):
        with pytest.raises(ValueError, match="truth_schema"):
            acc.load_truth_sidecar(str(p))
    p.write_text("")
    for acc in (jacc, tacc):
        with pytest.raises(ValueError, match="empty"):
            acc.load_truth_sidecar(str(p))


def _records(recs):
    return [(r.id, r.seq, None if r.qual is None else r.qual.tobytes(),
             r.desc) for r in recs]


@pytest.mark.parametrize("kw", [{}, dict(mean_len=2000, sub=0.0,
                                         hp_compress=0.0, seed=9)])
def test_simulate_ont_reads_matches_jax(kw):
    genome = jsim.random_genome(20_000, seed=3)
    jr, jt = jsim.simulate_ont_reads(genome, 25_000, **kw)
    tr, tt = tsim.simulate_ont_reads(genome, 25_000, **kw)
    assert _records(tr) == _records(jr)
    assert all(np.array_equal(a, b) for a, b in zip(jt, tt))


@pytest.mark.parametrize("with_truth", [False, True])
def test_simulate_independent_segments_matches_jax(with_truth):
    j = jsim.simulate_independent_segments(seed=5, n_long=4,
                                           with_truth=with_truth)
    t = tsim.simulate_independent_segments(seed=5, n_long=4,
                                           with_truth=with_truth)
    assert len(j) == len(t) == (3 if with_truth else 2)
    assert _records(t[0]) == _records(j[0])
    assert _records(t[1]) == _records(j[1])
    if with_truth:
        assert all(np.array_equal(a, b) for a, b in zip(j[2], t[2]))


def test_fantasticus_truth_matches_jax(tmp_path):
    from proovread_tpu.io.fastq import FastqWriter
    from proovread_tpu.io.records import SeqRecord as JRecord
    rng = np.random.default_rng(0)
    seqs = ["".join("ACGT"[i] for i in rng.integers(0, 4, 50))
            for _ in range(3)]
    orig = tmp_path / "orig.fq"
    with open(orig, "wb") as fh:
        w = FastqWriter(fh)
        for i, s in enumerate(seqs):
            w.write(JRecord(f"long_orig_{i}", s,
                            qual=np.full(50, 30, np.uint8)))
    longs = [JRecord(f"long_error_{i}_{k}", seqs[i][:40])
             for i, k in ((0, 1), (2, 5))] + [JRecord("other_1_2", "ACGT")]
    want = jsim.fantasticus_truth(longs, str(orig))
    got = tsim.fantasticus_truth(longs, str(orig))
    assert want.keys() == got.keys() == {"long_error_0_1", "long_error_2_5"}
    assert all(np.array_equal(want[k], got[k]) for k in want)


@pytest.mark.parametrize("vals", [[3.0], [1.0, 9.0, 2.0], [4.0, 1.0, 2.5,
                                                          7.0]])
def test_median_matches_jax(vals):
    assert tacc._median(vals) == jmedian(vals)


@pytest.mark.parametrize("name", [
    "IDENTITY_FLOOR", "IDENTITY_DROP", "INTRODUCED_GROWTH",
    "INTRODUCED_MIN_ABS", "BASELINE_WINDOW", "CLASSIFY_CAP",
    "MAX_CLASSIFY_CELLS", "CHIMERA_TOL", "TRUTH_SCHEMA_VERSION"])
def test_constants_match_jax(name):
    assert getattr(tacc, name) == getattr(jacc, name)
