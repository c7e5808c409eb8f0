"""Port parity: alignment sets and the consensus engine over them
(``consensus/alnset.py``, ``consensus/engine.py:ConsensusEngine``).

The same seeded alignments (M/I/D runs between optional soft clips, random
query codes and phreds, some without a score) go into the JAX package's
``AlnSet`` and the port's: ``Alignment``'s derived scores,
``from_cigar_str``, and each ``AlnSet`` filter (``filter_by_scores``,
``coverage``, ``high_coverage_windows``, ``filter_rep_region_alns`` before
and after ``admit``, ``filter_contained_alns``, ``admit`` with and without
the coverage cap, ``filter_by_coverage``); then
``ConsensusEngine.consensus_batch`` on three reads with ``ignore_coords``,
``use_ref_qual`` on and off, qual-weighted and plain votes, and
``detect_chimera`` over reads with a sparse breakpoint region. Tolerance:
alignment lists, bins and bin bases equal; every ``ConsensusResult`` field
(record, freqs, coverage, cigar, chimera) bitwise."""

import numpy as np
import pytest
import torch

from proovread_tpu.consensus import alnset as jal
from proovread_tpu.consensus import engine as jengine
from proovread_tpu.consensus.params import ConsensusParams as JCns
from proovread_tpu.io.batch import pack_reads as jpack
from proovread_tpu.io.records import SeqRecord as JRecord

from proovread_tpu_torch.consensus import alnset as tal
from proovread_tpu_torch.consensus import engine as tengine
from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.io.batch import pack_reads as tpack

from test_torch_pipeline import _port_records

M, I, D, S = 0, 1, 2, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on a few cores, and torch's CPU kernels in each spreading over
    every core slow all of them down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cigar(rng, span_lo, span_hi):
    ops, lens = [], []
    if rng.random() < 0.3:
        ops.append(S)
        lens.append(int(rng.integers(1, 10)))
    target = int(rng.integers(span_lo, span_hi))
    ref = 0
    while ref < target:
        m = int(rng.integers(8, 40))
        ops.append(M)
        lens.append(m)
        ref += m
        u = rng.random()
        if u < 0.25 and ref < target:
            ops.append(I)
            lens.append(int(rng.integers(1, 8)))
        elif u < 0.45 and ref < target:
            ops.append(D)
            lens.append(int(rng.integers(1, 4)))
            ref += lens[-1]
    if rng.random() < 0.3:
        ops.append(S)
        lens.append(int(rng.integers(1, 10)))
    return np.array(ops, np.uint8), np.array(lens, np.int32)


def _alignments(rng, ref_len, n, span=(60, 160), gap=None, unscored=0.05):
    """``n`` alignments onto a read of ``ref_len``: (qname, pos0, ops,
    lens, seq, qual, score). With ``gap`` = (lo, hi), no alignment centres
    there (a sparse run of bins that longer alignments still cover)."""
    out = []
    while len(out) < n:
        ops, lens = _cigar(rng, *span)
        ref = int(lens[(ops == M) | (ops == D)].sum())
        pos0 = int(rng.integers(-10, ref_len - ref // 2))
        c = pos0 + ref / 2
        if gap is not None and gap[0] <= c <= gap[1]:
            continue
        qlen = int(lens[(ops == M) | (ops == I) | (ops == S)].sum())
        seq = rng.integers(0, 5, qlen).astype(np.int8)
        qual = (rng.integers(2, 41, qlen).astype(np.uint8)
                if rng.random() < 0.9 else None)
        score = (None if rng.random() < unscored
                 else float(rng.integers(20, 5 * ref)))
        out.append((f"q{len(out)}", pos0, ops, lens, seq, qual, score))
    return out


def _sets(raw, ref_id, ref_len, jc, tc):
    def alns(mod):
        return [mod.Alignment(qname=q, pos0=p, seq_codes=s.copy(),
                              ops=o.copy(), lens=ln.copy(),
                              qual=None if qu is None else qu.copy(),
                              score=sc)
                for q, p, o, ln, s, qu, sc in raw]
    return (jal.AlnSet(ref_id, ref_len, alns(jal), params=jc),
            tal.AlnSet(ref_id, ref_len, alns(tal), params=tc))


def _same_sets(js, ts):
    assert [(a.qname, a.pos0, a.score) for a in ts.alns] == \
        [(a.qname, a.pos0, a.score) for a in js.alns]
    for name in ("bin_bases", "aln_bins"):
        want, got = getattr(js, name), getattr(ts, name)
        assert (want is None) == (got is None)
        if want is not None:
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_alignment_scores_match_jax():
    rng = np.random.default_rng(41)
    for q, p, o, ln, s, qu, sc in _alignments(rng, 900, 60, unscored=0.2):
        ja = jal.Alignment(q, p, s, o, ln, qual=qu, score=sc)
        ta = tal.Alignment(q, p, s, o, ln, qual=qu, score=sc)
        assert (ta.span, ta.q_len) == (ja.span, ja.q_len)
        for inv in (False, True):
            assert ((ta.effective_score(inv), ta.nscore(inv),
                     ta.ncscore(inv)) == (ja.effective_score(inv),
                                          ja.nscore(inv), ja.ncscore(inv)))
    ja = jal.Alignment.from_cigar_str("x", 5, [0, 1, 2, 3, 0], "2S3M")
    ta = tal.Alignment.from_cigar_str("x", 5, [0, 1, 2, 3, 0], "2S3M")
    assert ta.ops.tobytes() == ja.ops.tobytes()
    assert ta.lens.tobytes() == ja.lens.tobytes()
    assert ta.seq_codes.dtype == ja.seq_codes.dtype == np.int8


@pytest.mark.parametrize("kw", [
    dict(min_ncscore=1.0, rep_coverage=6),
    dict(min_score=50.0, min_nscore=0.8, rep_coverage=4, max_coverage=5),
    dict(invert_scores=True, min_nscore=-4.0, max_coverage=3)])
def test_alnset_filters_match_jax(kw):
    rng = np.random.default_rng(42)
    jc, tc = JCns(**kw), ConsensusParams(**kw)
    raw = _alignments(rng, 1200, 140)
    # a repeat: many short hits inside one window
    raw += [(f"rep{i}", 600 + int(rng.integers(0, 30)), o, ln, s, qu, sc)
            for i, (_, _, o, ln, s, qu, sc) in enumerate(
                _alignments(rng, 1200, 12, span=(40, 60)))]
    js, ts = _sets(raw, "r0", 1200, jc, tc)
    assert ts.n_bins == js.n_bins
    assert ts.bins_of(ts.alns).tobytes() == js.bins_of(js.alns).tobytes()
    assert ts.coverage().tobytes() == js.coverage().tobytes()
    for cmax in (3, 6, 50):
        assert ts.high_coverage_windows(cmax) == js.high_coverage_windows(
            cmax)
    for step in ("filter_by_scores", "filter_rep_region_alns",
                 "filter_contained_alns", "admit", "filter_rep_region_alns"):
        getattr(js, step)()
        getattr(ts, step)()
        _same_sets(js, ts)
    js.filter_by_coverage(2.0)
    ts.filter_by_coverage(2.0)
    _same_sets(js, ts)
    js2, ts2 = _sets(raw, "r0", 1200, jc, tc)
    js2.admit(cap_coverage=False)
    ts2.admit(cap_coverage=False)
    _same_sets(js2, ts2)
    assert len(ts.alns) < len(ts2.alns)


def _batch(seed, jc, tc, chimera=False):
    rng = np.random.default_rng(seed)
    lens = (1000, 1100, 700)
    recs = [JRecord(f"lr{i}", "".join("ACGT"[c] for c in rng.integers(
        0, 4, L)), qual=rng.integers(0, 30, L).astype(np.uint8))
        for i, L in enumerate(lens)]
    jsets, tsets = [], []
    for i, L in enumerate(lens):
        gap = (470, 520) if chimera and i < 2 else None
        raw = _alignments(rng, L, 260 if chimera else 90,
                          span=(90, 200) if chimera else (60, 160), gap=gap)
        js, ts = _sets(raw, recs[i].id, L, jc, tc)
        jsets.append(js)
        tsets.append(ts)
    return recs, jsets, tsets


def _same_results(tres, jres):
    assert len(tres) == len(jres)
    for t, j in zip(tres, jres):
        assert (t.record.id, t.record.seq) == (j.record.id, j.record.seq)
        assert t.record.qual.tobytes() == j.record.qual.tobytes()
        for f in ("freqs", "coverage"):
            a, b = getattr(t, f), getattr(j, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert (t.cigar, t.chimera) == (j.cigar, j.chimera)


@pytest.mark.parametrize("kw,ignore", [
    (dict(qual_weighted=True, use_ref_qual=True, max_ins_length=10), True),
    (dict(use_ref_qual=False, indel_taboo_length=7), False),
    (dict(qual_weighted=True, use_ref_qual=True, min_ncscore=0.5), False)])
def test_consensus_batch_matches_jax(kw, ignore):
    jc, tc = JCns(**kw), ConsensusParams(**kw)
    recs, jsets, tsets = _batch(43, jc, tc)
    coords = ([[(100, 50), (600, 30)], [], [(-5, 20), (1090, 40)]]
              if ignore else None)
    jres = jengine.ConsensusEngine(jc).consensus_batch(
        jpack(recs), jsets, ignore_coords=coords)
    tres = tengine.ConsensusEngine(tc, device="cpu").consensus_batch(
        tpack(_port_records(recs)), tsets, ignore_coords=coords)
    _same_results(tres, jres)
    for js, ts in zip(jsets, tsets):
        _same_sets(js, ts)
    assert any(r.record.seq != rec.seq for r, rec in zip(tres, recs))


def test_consensus_batch_chimera_matches_jax():
    kw = dict(qual_weighted=True, use_ref_qual=True)
    jc, tc = JCns(**kw), ConsensusParams(**kw)
    recs, jsets, tsets = _batch(44, jc, tc, chimera=True)
    # a small cell budget: many chunks, the same sums
    jres = jengine.ConsensusEngine(jc).consensus_batch(
        jpack(recs), jsets, detect_chimera=True)
    tres = tengine.ConsensusEngine(tc, cell_budget=1 << 14,
                                   device="cpu").consensus_batch(
        tpack(_port_records(recs)), tsets, detect_chimera=True)
    _same_results(tres, jres)
    assert any(r.chimera for r in jres)
