"""Port parity: the scan engine (``engine="scan"``, the resilience ladder's
host-scan rung) and the host modules under it.

The same seeded numpy inputs go through the JAX package's function and the
port's on the CPU: ``admit_mask``, ``expand_alignment``,
``assemble_consensus``, ``chimera_scan``, ``mask_batch``,
``fused_accumulate`` (both ``qual_weighted`` values),
``FastCorrector.correct_batch`` with and without chimera detection, and
``Pipeline.run(engine="scan")``. Tolerance: exact everywhere: masks,
column states and pileup tensors bitwise, records, chimeras, reports,
``CorrectionStats`` and QC records equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proovread_tpu.align.params import BWA_SR as J_BWA_SR
from proovread_tpu.align.params import BWA_SR_FINISH as J_BWA_SR_FINISH
from proovread_tpu.align.sw import sw_batch as jsw_batch
from proovread_tpu.consensus import alnset as jalnset
from proovread_tpu.consensus import cigar as jcigar
from proovread_tpu.consensus import engine as jengine
from proovread_tpu.consensus.params import ConsensusParams as JCns
from proovread_tpu.io.batch import pack_reads as jpack
from proovread_tpu.io.records import SeqRecord as JRecord
from proovread_tpu.obs import qc as jqc
from proovread_tpu.ops import fused as jfused
from proovread_tpu.ops import pileup as jpileup
from proovread_tpu.ops.encode import decode_codes, revcomp_codes
from proovread_tpu.pipeline import correct as jcorrect
from proovread_tpu.pipeline import masking as jmasking
from proovread_tpu.pipeline.masking import MaskParams as JMask

from proovread_tpu_torch.align.params import AlignParams
from proovread_tpu_torch.consensus import alnset as talnset
from proovread_tpu_torch.consensus import cigar as tcigar
from proovread_tpu_torch.consensus import engine as tengine
from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.io.batch import pack_reads as tpack
from proovread_tpu_torch.obs import qc as tqc
from proovread_tpu_torch.ops import fused as tfused
from proovread_tpu_torch.ops import pileup as tpileup
from proovread_tpu_torch.pipeline import correct as tcorrect
from proovread_tpu_torch.pipeline import masking as tmasking
from proovread_tpu_torch.pipeline.masking import MaskParams

from test_torch_pipeline import (_compare, _port_records, _uniform_dataset,
                                 run_both)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on a few cores, and torch's CPU kernels in each spreading over
    every core slow all of them down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cns(**kw):
    return JCns(**kw), ConsensusParams(**kw)


def _equal_arrays(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_admit_mask_matches_jax():
    rng = np.random.default_rng(0)
    R, B = 600, 5
    ref_lens = rng.integers(300, 1500, B).astype(np.int32)
    read_idx = rng.integers(0, B, R).astype(np.int32)
    pos0 = (rng.random(R) * ref_lens[read_idx]).astype(np.int32) - 20
    span = rng.integers(-2, 110, R).astype(np.int32)
    score = (rng.random(R) * 500).astype(np.float32)
    valid = rng.random(R) < 0.8
    for kw in (dict(max_coverage=3), dict(max_coverage=50),
               dict(max_coverage=5, min_ncscore=2.0, min_score=100.0),
               dict(max_coverage=4, invert_scores=True, min_nscore=-4.0)):
        jc, tc = _cns(**kw)
        for v in (None, valid):
            want = jalnset.admit_mask(read_idx, pos0, span, score, ref_lens,
                                      jc, valid=v)
            got = talnset.admit_mask(read_idx, pos0, span, score, ref_lens,
                                     tc, valid=v)
            _equal_arrays(got, want)
            assert 0 < want.sum() < R


def _random_alignment(rng):
    """A CIGAR with optional soft and hard clips around M/I/D runs, and
    a query of matching length."""
    ops, lens = [], []
    if rng.random() < 0.4:
        ops.append(jcigar.H)
        lens.append(int(rng.integers(1, 5)))
    if rng.random() < 0.5:
        ops.append(jcigar.S)
        lens.append(int(rng.integers(1, 12)))
    if rng.random() < 0.1:
        ops.append(jcigar.I)               # leading insertion (trim off)
        lens.append(int(rng.integers(1, 3)))
    for k in range(int(rng.integers(1, 9))):
        ops.append(jcigar.M)
        lens.append(int(rng.integers(1, 40)))
        u = rng.random()
        if u < 0.3:
            ops.append(jcigar.I)
            lens.append(int(rng.integers(1, 9)))
        elif u < 0.6:
            ops.append(jcigar.D)
            lens.append(int(rng.integers(1, 4)))
        if u < 0.15:
            # the 1D1I pair the reference rewrites into a mismatch
            ops += [jcigar.D, jcigar.I, jcigar.M]
            lens += [1, 1, int(rng.integers(1, 20))]
    ops.append(jcigar.M)
    lens.append(int(rng.integers(1, 30)))
    if rng.random() < 0.5:
        ops.append(jcigar.S)
        lens.append(int(rng.integers(1, 12)))
    ops = np.array(ops, np.uint8)
    lens = np.array(lens, np.int32)
    qlen = int(lens[(ops == jcigar.M) | (ops == jcigar.I)
                    | (ops == jcigar.S)].sum())
    seq = rng.integers(0, 5, qlen).astype(np.int8)
    qual = (rng.integers(0, 42, qlen).astype(np.uint8)
            if rng.random() < 0.8 else None)
    return int(rng.integers(0, 300)), ops, lens, seq, qual


def _call(fn, *args):
    """(result, None), or (None, message) when ``fn`` raises ValueError
    (a clip inside a hard clip, as the reference refuses it)."""
    try:
        return fn(*args), None
    except ValueError as e:
        return None, str(e)


def _column_states_equal(got, want):
    if want is None:
        assert got is None
        return
    assert got.rpos == want.rpos
    for f in ("state", "freq", "ins_len", "ins_bases"):
        _equal_arrays(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("kw", [
    dict(), dict(trim=False), dict(qual_weighted=True),
    dict(indel_taboo_length=7, min_aln_length=20, qual_weighted=True),
    dict(trim=False, min_aln_length=10, ins_cap=3)])
def test_expand_alignment_matches_jax(kw):
    rng = np.random.default_rng(1)
    jc, tc = _cns(**kw)
    n_kept = n_err = 0
    for _ in range(300):
        args = _random_alignment(rng)
        want, werr = _call(jcigar.expand_alignment, *args, jc)
        got, gerr = _call(tcigar.expand_alignment, *args, tc)
        assert gerr == werr
        _column_states_equal(got, want)
        n_kept += want is not None
        n_err += werr is not None
    assert n_kept > 20 and n_err > 0
    f = np.array([0, 1, 7, 20, 33, 40, 93], np.float64)
    _equal_arrays(tcigar.phreds_to_freqs(f), jcigar.phreds_to_freqs(f))
    fr = np.array([-1.0, 0.0, 0.4, 3.3, 13.33, 40.0])
    _equal_arrays(tcigar.freqs_to_phreds(fr), jcigar.freqs_to_phreds(fr))


def test_assemble_consensus_matches_jax():
    rng = np.random.default_rng(2)
    for n in (0, 1, 37, 400):
        emitted = rng.random(n) < 0.85
        base = rng.integers(0, 5, n).astype(np.int8)
        ins_len = np.where(rng.random(n) < 0.15,
                           rng.integers(1, 7, n), 0).astype(np.int32)
        ins_bases = rng.integers(0, 5, (n, 6)).astype(np.int8)
        freq = (rng.random(n) * 30).astype(np.float32)
        phred = rng.integers(0, 41, n).astype(np.int32)
        cov = (rng.random(n) * 20).astype(np.float32)
        args = ("r", emitted, base, ins_len, ins_bases, freq, phred, cov)
        want = jengine.assemble_consensus(*args)
        got = tengine.assemble_consensus(*args)
        assert got.record.seq == want.record.seq
        _equal_arrays(got.record.qual, want.record.qual)
        _equal_arrays(got.freqs, want.freqs)
        _equal_arrays(got.coverage, want.coverage)
        assert got.cigar == want.cigar


def test_chimera_scan_matches_jax():
    """A 700-column read whose bins 16-18 are nearly empty: runs found,
    flanks expanded from random alignments, entropy scored."""
    rng = np.random.default_rng(3)
    jc, tc = _cns(indel_taboo_length=7, max_coverage=10)
    L = 700
    bb = np.full(L // 20 + 1, 400.0)
    bb[16:19] = 20.0
    cover = np.ones(L)
    alns = []
    while len(alns) < 60:
        _, ops, lens, seq, qual = _random_alignment(rng)
        pos0 = int(rng.integers(150, 450))
        cs_j, _ = _call(jcigar.expand_alignment, pos0, ops, lens, seq, qual,
                        jc)
        cs_t, _ = _call(tcigar.expand_alignment, pos0, ops, lens, seq, qual,
                        tc)
        if cs_j is not None:
            alns.append((cs_j, cs_t, int((pos0 + 1 + cs_j.span / 2) // 20)))
    emitted = rng.random(L) < 0.95
    args = ("r", emitted, rng.integers(0, 4, L).astype(np.int8),
            np.zeros(L, np.int32), np.zeros((L, 6), np.int8),
            np.ones(L, np.float32), np.full(L, 30, np.int32),
            np.ones(L, np.float32))
    out = []
    for k, eng in ((0, jengine), (1, tengine)):
        res = eng.assemble_consensus(*args)

        def select(fl, tl, fr, tr, k=k):
            return ([a[k] for a in alns if fl <= a[2] <= tl],
                    [a[k] for a in alns if fr <= a[2] <= tr])
        out.append(eng.chimera_scan(bb, L, (jc, tc)[k], res, cover, select))
    assert out[1] == out[0] and out[0]
    sel = [a[0] for a in alns[:20]]
    _equal_arrays(tengine.window_counts([a[1] for a in alns[:20]], 200, 90),
                  jengine.window_counts(sel, 200, 90))


def test_mask_batch_matches_jax():
    rng = np.random.default_rng(4)
    B, L = 7, 900
    lengths = rng.integers(0, L, B).astype(np.int32)
    lengths[0] = L
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    quals = []
    for i in range(B):
        q = np.zeros(int(lengths[i]), np.uint8)
        pos = 0
        while pos < len(q):
            run = int(rng.integers(5, 300))
            q[pos:pos + run] = rng.integers(0, 42) if rng.random() < 0.7 \
                else 40
            pos += run
        quals.append(q)
    for kw in (dict(), dict(end_ratio=0.3), dict(mask_min_len=40)):
        jp, tp = JMask(**kw).scaled(100), MaskParams(**kw).scaled(100)
        jm, jiv, jf = jmasking.mask_batch(codes, quals, lengths, jp)
        tm, tiv, tf = tmasking.mask_batch(codes, quals, lengths, tp)
        _equal_arrays(tm, jm)
        assert tiv == jiv and tf == jf
        assert any(jiv)
        for i in range(B):
            assert (tmasking.hcr_intervals(quals[i], int(lengths[i]), tp)
                    == jmasking.hcr_intervals(quals[i], int(lengths[i]), jp))


def _sw_streams(rng, R=160, m=128, n=256, B=3, L=1400):
    """Real traceback streams: error-containing substrings of B long reads
    aligned by the reference's ``sw_batch`` to their ref windows."""
    longs = rng.integers(0, 4, (B, L)).astype(np.int8)
    q = np.full((R, m), 4, np.int8)
    ql = np.zeros(R, np.int32)
    read_idx = rng.integers(0, B, R).astype(np.int32)
    win = rng.integers(-30, L - n + 30, R).astype(np.int32)
    r = np.full((R, n), 4, np.int8)
    for i in range(R):
        a = int(np.clip(win[i], 0, L - n))
        win[i] = a
        r[i] = longs[read_idx[i], a:a + n]
        st = int(rng.integers(20, 100))
        src = list(r[i, st:st + int(rng.integers(60, 110))])
        out = []
        for b in src:
            u = rng.random()
            if u < 0.03:
                continue
            if u < 0.06:
                out.append(int(rng.integers(0, 4)))
            out.append(int(b) if rng.random() > 0.03 else (b + 1) % 4)
        out = out[:m]
        q[i, :len(out)] = out
        ql[i] = len(out)
    res = jsw_batch(jnp.asarray(q), jnp.asarray(r), jnp.asarray(ql),
                    J_BWA_SR)
    qual = rng.integers(0, 42, (R, m)).astype(np.uint8)
    admitted = rng.random(R) < 0.85
    return (B, L, np.array(res.ops_rev), np.array(res.step_i),
            np.array(res.step_j), q, qual, np.array(res.q_start),
            np.array(res.q_end), read_idx, win, admitted)


@pytest.mark.parametrize("qual_weighted,taboo,ignore", [
    (False, dict(taboo_abs=7), True), (True, dict(taboo_abs=7), True),
    (False, dict(taboo_frac=0.1), False),
    (True, dict(taboo_frac=0.0, min_aln_length=20), True)])
def test_fused_accumulate_matches_jax(qual_weighted, taboo, ignore):
    rng = np.random.default_rng(5)
    B, L, *arrs = _sw_streams(rng)
    ig = rng.random((B, L)) < 0.2 if ignore else None
    kw = dict(qual_weighted=qual_weighted, **taboo)
    jp = jpileup.init_pileup(B, L, 6)
    tp = tpileup.init_pileup(B, L, 6)
    for lo, hi in ((0, 70), (70, 160)):          # two chunks, one pileup
        chunk = [a[lo:hi] for a in arrs]
        jp = jfused.fused_accumulate(
            jp, *(jnp.asarray(a) for a in chunk),
            ignore_mask=None if ig is None else jnp.asarray(ig), **kw)
        tp = tfused.fused_accumulate(
            tp, *(torch.as_tensor(a) for a in chunk),
            ignore_mask=None if ig is None else torch.as_tensor(ig), **kw)
    for f in jp._fields:
        _equal_arrays(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)))
    assert float(tp.counts.sum()) > 1000 and float(tp.ins_len_votes.sum()) > 0


def _chimeric_batch(pack):
    """One chimeric read (two distant 700-base genome segments joined) and
    one plain read, with 900 error-free 100 bp short reads on both
    strands: the finish pass flags the junction."""
    rng = np.random.default_rng(1)
    G = 3000
    g = rng.integers(0, 4, G).astype(np.int8)
    longs = [JRecord("c0", decode_codes(np.concatenate([g[0:700],
                                                        g[1800:2500]]))),
             JRecord("n1", decode_codes(g[900:1600]))]
    srs = []
    for i in range(900):
        st = int(rng.integers(0, G - 100))
        s = g[st:st + 100].copy()
        if rng.random() < 0.5:
            s = revcomp_codes(s)
        srs.append(JRecord(f"s{i}", decode_codes(s),
                           qual=np.full(100, 30, np.uint8)))
    return pack(longs), pack(srs)


@pytest.mark.heavy
@pytest.mark.parametrize("finish", [False, True])
def test_fast_corrector_matches_jax(finish):
    """``correct_batch`` on both packages, with a QC recorder installed:
    results (records, freqs, coverage, cigar, chimeras), the stats and
    the per-read QC rows equal. The finish pass (strict params, chimera
    detection) flags the chimeric read; the iteration pass recycles the
    reads' quals."""
    if finish:
        jap, tap = J_BWA_SR_FINISH, AlignParams(**dataclasses.asdict(
            J_BWA_SR_FINISH))
        kw = dict(max_coverage=22, indel_taboo_length=7)
    else:
        jap, tap = J_BWA_SR, AlignParams(**dataclasses.asdict(J_BWA_SR))
        kw = dict(max_coverage=11, indel_taboo_length=7, use_ref_qual=True)
    jc, tc = _cns(**kw)
    out = {}
    for name, mod, qcmod, ap, cns, pack in (
            ("jax", jcorrect, jqc, jap, jc, jpack),
            ("port", tcorrect, tqc, tap, tc, tpack)):
        lr, sr = _chimeric_batch(
            pack if name == "jax" else
            (lambda recs: tpack(_port_records(recs))))
        extra = {} if name == "jax" else {"device": "cpu"}
        fc = mod.FastCorrector(ap, cns, chunk_rows=512, **extra)
        with qcmod.scope():
            out[name] = fc.correct_batch(lr, sr, detect_chimera=finish)
    (jres, jst), (tres, tst) = out["jax"], out["port"]
    assert len(tres) == len(jres) == 2
    for a, b in zip(tres, jres):
        assert (a.record.id, a.record.seq) == (b.record.id, b.record.seq)
        _equal_arrays(a.record.qual, b.record.qual)
        _equal_arrays(a.freqs, b.freqs)
        _equal_arrays(a.coverage, b.coverage)
        assert a.cigar == b.cigar and a.chimera == b.chimera
    jq, tq = jst.qc_rows, tst.qc_rows
    fields = ("n_candidates", "n_admitted", "n_eligible", "n_dropped_cov")
    assert ([getattr(tst, f) for f in fields]
            == [getattr(jst, f) for f in fields])
    assert jq.keys() == tq.keys()
    for k in jq:
        _equal_arrays(tq[k], jq[k])
    assert bool(tres[0].chimera) == finish
    if finish:
        assert tres[0].chimera[0][2] > 0.5


@pytest.mark.heavy
@pytest.mark.parametrize("seed,kw", [
    (21, dict(n_iterations=2, batch_reads=8)),
    (22, dict(n_iterations=3, batch_reads=4, sampling=True,
              sr_chunk_number=8, sr_chunk_step=3, sr_coverage=4.0))])
def test_scan_pipeline_matches_jax(seed, kw):
    """``Pipeline.run(engine="scan")`` on both packages, each under a QC
    recorder: records, chimeras, reports, metrics and QC records equal.
    The second case samples short-read chunks per pass and runs three
    buckets of four reads."""
    longs, srs = _uniform_dataset(np.random.default_rng(seed), n_long=10)
    from proovread_tpu.pipeline.trim import TrimParams as JTrim
    base = dict(sampling=False, host_chunk_rows=512,
                trim=JTrim(min_length=150))
    base.update(kw)
    jres, tres = run_both(longs, srs, engine="scan", **base)
    _compare(jres, tres)
    assert [r.task for r in tres.reports][-1] == "bwa-sr-finish"
    assert sum(r.n_admitted for r in tres.reports) > 0


@pytest.mark.slow
def test_scan_pipeline_matches_jax_config4():
    """bench config 4's workload (10 kb genome, 40 kb of long reads, 30x
    short reads, 4 iterations) through the scan engine of both
    packages."""
    from proovread_tpu.io.simulate import (random_genome, simulate_long_reads,
                                           simulate_short_reads)
    genome = random_genome(10_000, seed=0)
    longs, _ = simulate_long_reads(genome, 40_000, seed=1)
    srs = simulate_short_reads(genome, 30.0, seed=2)
    jres, tres = run_both(longs, srs, engine="scan", n_iterations=4)
    _compare(jres, tres)
