"""Port parity: the accuracy scoreboard (``obs/accuracy.py``) and the
simulators and truth sidecar it scores against (``io/simulate.py``).

The same seeded inputs, made with numpy, go through
``proovread_tpu.obs.accuracy`` / ``proovread_tpu.io.simulate`` and the
port on the CPU. Tolerance: the LCS lengths (the plain PyTorch version of
the ``csrc/lcs.cu`` kernel) bitwise equal, including empty reads and
truths, truths of exact multiples of 64 and of a kernel warp's 2048 and
4096 bases, reads longer than their truths and N on either side; edit
alignments (the host numpy and the plain PyTorch version of the
``csrc/edit.cu`` kernel: swapped lengths, bands doubled, N on either side,
empty sides, ties at the band's edge), per-read accuracy records and
summaries, simulated records and truths equal; truth sidecars
byte-identical."""

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


@pytest.mark.parametrize("max_warps", [32, 3, 2, 0])
def test_lcs_plan_packs_every_pair_once(max_warps):
    """The LCS kernel's packing: every pair with both sides non-empty runs
    once, as K contiguous warps of one block (W = 1 word a lane when one
    warp holds the truth so, else 2), or from the global scratch past
    ``max_warps``; blocks come most tile steps first, each running its
    longest pair's steps."""
    rng = np.random.default_rng(max_warps)
    n = rng.integers(0, 60_000, 400)
    m = np.concatenate([rng.integers(0, 4_100, 200),
                        rng.integers(4_100, 140_000, 200)])
    n[:5] = 0
    m[5:10] = 0
    m[10:14] = [2048, 2049, 4096, 4097]
    plan = tacc.lcs_plan(n, m, max_warps)
    k = -(-m // 64)
    W = np.where(k <= 32, 1, 2)
    K = -(-k // (32 * W))
    C = plan["warps_per_block"]
    assert C >= 4 and C & (C - 1) == 0 and C <= 32
    slots = plan["slots"].reshape(plan["blocks"], C)
    seen = {}
    for blk, row in enumerate(slots):
        live = row[row >= 0]
        assert (row[len(live):] == -1).all()
        pairs = live // 64
        for p in np.unique(pairs):
            assert (live[pairs == p] % 32).tolist() == list(range(K[p]))
            assert ((live[pairs == p] >> 5) & 1 == W[p] - 1).all()
            assert p not in seen
            seen[p] = blk
        steps = -(-n[pairs] // 32) + K[pairs] - 1
        assert plan["steps"][blk] == steps.max()
    assert (np.diff(plan["steps"]) <= 0).all()
    live = (n > 0) & (m > 0)
    assert sorted(seen) == np.flatnonzero(live & (K <= max_warps)).tolist()
    assert plan["glob"].tolist() == np.flatnonzero(
        live & (K > max_warps)).tolist()
    assert plan["gw"].tolist() == (-(-k[plan["glob"]] // 32)).tolist()
    # 32 words: one warp at one word a lane; 33, 64 and 65 words: one,
    # one and two warps at two words a lane
    assert k[10] == 32 and k[11] == 33 and (K[10], W[10]) == (1, 1)
    assert (K[11], K[12], K[13]) == (1, 1, 2) and (W[11:14] == 2).all()


_KEYS = ("dist", "matches", "sub", "ins", "del")


def _edit_case(case):
    """(pairs, bands) of an edit-alignment case, made with numpy."""
    rng = np.random.default_rng(len(case))
    if case == "ties":
        # homopolymers and repeats (many equal-cost paths), bands exactly
        # at the distance (paths along the band's edge) and 0 (64)
        pairs, bands = [], []
        for rep in ([0] * 60, [0, 1] * 40, [2, 2, 3] * 30):
            b = np.asarray(rep, np.int8)
            for a in (b[7:], np.concatenate([b[:20], b[31:]]),
                      np.concatenate([b, [0, 0, 1]])):
                a = np.asarray(a, np.int8)
                dist = jacc.edit_alignment(a, b, band=len(b))["dist"]
                pairs += [(a, b), (b, a)]
                bands += [max(dist, 1), 0]
        return pairs, bands
    pairs = _pairs(len(case), rng.integers(1, 400, 24),
                   err={"errors": 0.15, "doubling": 0.3}.get(case, 0.08))
    bands = list(rng.integers(8, 40, len(pairs)))
    if case == "swapped":
        for i in range(0, len(pairs), 2):
            rd, tr = pairs[i]
            pairs[i] = (np.concatenate([rd, rng.integers(0, 4, 50)])
                        .astype(np.int8), tr)           # read past truth
    if case == "doubling":
        bands = list(rng.integers(1, 4, len(pairs)))    # far too small
    if case == "n_sides":
        for rd, tr in pairs:
            rd[::6] = 4                                 # N in the read
            tr[::9] = 4                                 # N in the truth
    if case == "empty":
        pairs[0] = (pairs[0][0][:0], pairs[0][1])
        pairs[1] = (pairs[1][0], pairs[1][1][:0])
        pairs[2] = (pairs[2][0][:0], pairs[2][1][:0])
        pairs[3] = (pairs[3][1][:1].copy(), pairs[3][1][:1])
    return pairs, bands


@pytest.mark.parametrize("case", ["errors", "swapped", "doubling",
                                  "n_sides", "empty", "ties"])
def test_edit_alignments_plain_matches_jax(case):
    """``edit_alignments_plain`` (the plain version of the traceback
    kernel ``csrc/edit.cu``) against the JAX package's ``edit_alignment``,
    pair by pair. Tolerance: bitwise (integers)."""
    pairs, bands = _edit_case(case)
    want = [[jacc.edit_alignment(a, b, band=int(w))[k] for k in _KEYS]
            for (a, b), w in zip(pairs, bands)]
    args = tacc.pack_pairs(pairs, "cpu")
    launches = tacc.edit_alignments.launches
    got = tacc.edit_alignments(*args, np.asarray(bands))
    assert tacc.edit_alignments.launches == launches
    assert got.dtype == torch.int64 and got.tolist() == want
    assert torch.equal(got, tacc.edit_alignments_plain(
        *args, torch.as_tensor(bands)))
    if case == "doubling":
        assert any(d > w for (d, *_), w in zip(want, bands))


def _band_edge_pairs(case):
    """(read, truth) pairs for the band-widening test. "edges": optimal
    paths that reach toward each edge of the band (a block of the truth
    missing at the read's start and extra bases at its end, so the path
    runs right and back, and the mirror), and repeats with many equal-cost
    paths; "errors": reads of 15% errors; "n_sides": N on either side."""
    rng = np.random.default_rng(17)
    if case == "edges":
        tr = rng.integers(0, 4, 160).astype(np.int8)
        pairs = []
        for k in (5, 20):
            extra = rng.integers(0, 4, k)
            pairs += [(np.concatenate([tr[k:], extra]).astype(np.int8), tr),
                      (np.concatenate([extra, tr[:-k]]).astype(np.int8), tr)]
        rep = np.asarray([0, 1, 1] * 50, np.int8)
        return pairs + [(rep[9:], rep), (np.concatenate(
            [rep[:40], rep[52:], [2, 2]]).astype(np.int8), rep)]
    pairs = _pairs(18, [150, 90, 200], err=0.15)
    if case == "n_sides":
        for rd, tr in pairs:
            rd[::7] = 4
            tr[::5] = 4
    return pairs + [(b, a) for a, b in pairs]


@pytest.mark.parametrize("case", ["edges", "errors", "n_sides"])
def test_edit_band_widening_keeps_the_result(case):
    """The exactness argument of ``csrc/edit.cu``: a banded pass whose
    distance is at most its band w gives (dist, matches, sub, ins, del)
    of the whole matrix, so widening the band past w, up to the whole
    matrix, changes nothing. Shown on the JAX package's ``_banded_tb``
    pass and ``edit_alignment``, and on the port's ``_banded_tb_plain``
    and ``edit_alignments_plain``, at bands at the distance (paths that
    reach toward both edges), one below it (doubled) and above it.
    Tolerance: bitwise (integers)."""
    pairs = _band_edge_pairs(case)
    runs, rows, bands, widened = [], [], [], 0
    for a, b in pairs:
        x, y = (a, b) if len(a) <= len(b) else (b, a)
        full = jacc._banded_tb(x, y, len(x))
        want = [full[k] for k in _KEYS]
        if len(a) > len(b):
            want[3], want[4] = want[4], want[3]
        dist = full["dist"]
        for w in sorted({max(dist - 1, 1), max(dist, 1), dist + 1,
                         2 * dist + 3, len(x)}):
            one = jacc._banded_tb(x, y, w)
            plain = tacc._banded_tb_plain(torch.as_tensor(x),
                                          torch.as_tensor(y), w)
            assert list(plain) == [one[k] for k in _KEYS]
            if one["dist"] <= w:
                widened += 1
                assert one == full, (len(x), len(y), w)
            else:
                assert w < dist
            assert [jacc.edit_alignment(a, b, band=w)[k]
                    for k in _KEYS] == want
            runs.append((a, b))
            rows.append(want)
            bands.append(w)
    assert widened >= 3 * len(pairs)
    got = tacc.edit_alignments_plain(*tacc.pack_pairs(runs, "cpu"),
                                     np.asarray(bands))
    assert got.tolist() == rows


def test_edit_kernel_wrapper_needs_a_card():
    """No plain fallback for a tensor that is not on the CPU: a tensor
    elsewhere raises, and scoring on "cuda" without a card raises."""
    pairs, bands = _edit_case("errors")
    meta = [torch.empty_like(t, device="meta")
            for t in tacc.pack_pairs(pairs[:2], "cpu")]
    with pytest.raises(ValueError, match="device"):
        tacc.edit_alignments(*meta, np.asarray(bands[:2]))
    with pytest.raises(ValueError, match="one band a pair"):
        tacc.edit_alignments(*tacc.pack_pairs(pairs[:2], "cpu"),
                             np.asarray(bands[:3]))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs")
    seqs = {f"r{i}": rd for i, (rd, _) in enumerate(pairs)}
    truth = {f"r{i}": tr for i, (_, tr) in enumerate(pairs)}
    launches = tacc.edit_alignments.launches
    with pytest.raises((RuntimeError, AssertionError)):
        tacc.score_read_sets(seqs, seqs, truth, device="cuda")
    assert tacc.edit_alignments.launches == launches


@pytest.mark.parametrize("reg_words", [0, 6, 16])
def test_edit_plan_keeps_windows_the_kernel_compiles(monkeypatch,
                                                     reg_words):
    """``edit_plan`` gives every pair a window of at least its S row words:
    in registers only at a size ``csrc/edit.cu`` compiles, whatever
    ``EDIT_REG_WORDS`` says, else in the global scratch; and the largest
    pair that scoring classifies stays in registers."""
    monkeypatch.setattr(tacc, "EDIT_REG_WORDS", reg_words)
    w = np.arange(1, 14000, 37)
    m = np.full(len(w), 30000)
    plan = tacc.edit_plan(m, m + 50, w)
    S, W = plan["S"], plan["W"]
    assert (32 * np.abs(W) >= S).all()
    reg = W > 0
    assert set(W[reg].tolist()) <= set(tacc._EDIT_REG_SIZES.tolist())
    assert (W[reg] <= reg_words).all()
    assert (plan["gst"] == np.where(reg, 0, 7 * 32 * np.abs(W))).all()
    assert (~reg).any() and (reg.any() == (reg_words > 0))
    # score(): (m + 1) x width under MAX_CLASSIFY_CELLS
    side = int(np.sqrt(tacc.MAX_CLASSIFY_CELLS))
    big = tacc.edit_plan(np.asarray([side]), np.asarray([side]),
                         np.asarray([side // 2]))
    assert (big["W"] > 0).all() == (reg_words >= 6), big


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
