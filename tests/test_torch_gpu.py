"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips, with the reason, where
``torch.cuda.is_available()`` is False (there is no CPU mode for a CUDA
kernel). On a card: ``python -m pytest tests/test_torch_gpu.py``. The same
checks run at the main path's shapes in ``chip_smoke.py``. Tolerance:
bitwise (integer outputs), exact (bsw score, pileup counts)."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _equal(a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def _bsw_args(cuda, ap, seed, R=256, m=112):
    from proovread_tpu_torch.align import bsw
    from proovread_tpu_torch.pipeline.dcorrect import device_revcomp
    rng = np.random.default_rng(seed)
    S, B, Lp = 64, 4, 2048
    W = bsw.band_lanes(ap)
    n = m + W
    genome = rng.integers(0, 4, (B, Lp)).astype(np.int8)
    qlen = rng.integers(m // 2 + 4, m - 11, S).astype(np.int32)
    qlen[0] = 0
    qf = np.full((S, m), 4, np.int8)
    for s in range(S):
        b, p = int(rng.integers(0, B)), int(rng.integers(0, Lp - m - 8))
        qf[s, :qlen[s]] = genome[b, p:p + qlen[s]]
    t = lambda x: torch.as_tensor(x, device=cuda)   # noqa: E731
    sread = rng.integers(0, S, R).astype(np.int32)
    diag = rng.integers(-2 * n, Lp + 2 * n, R).astype(np.int32)
    mp = bsw.build_map_pad(t(genome), t(rng.random((B, Lp)) < 0.1), n)
    _, w0p = bsw.window_starts(t(diag), W, Lp, n)
    return (t(qf), device_revcomp(t(qf), t(qlen)), mp,
            t(qlen)[t(sread).long()], t(sread),
            t(rng.integers(0, 2, R).astype(np.int32)),
            t(np.sort(rng.integers(0, B, R)).astype(np.int32)), w0p, ap)


@pytest.mark.parametrize("finish", [False, True])
def test_bsw_kernel_matches_plain(cuda, finish):
    from proovread_tpu_torch.align import bsw
    from proovread_tpu_torch.align.params import BWA_SR, BWA_SR_FINISH
    args = _bsw_args(cuda, BWA_SR_FINISH if finish else BWA_SR, finish)
    launches = bsw.bsw_expand_v2.launches
    got = bsw.bsw_expand_v2(*args)
    assert bsw.bsw_expand_v2.launches == launches + 1
    assert _equal(got, bsw.bsw_expand_v2_plain(*args))


@pytest.mark.parametrize("finish", [False, True])
def test_bsw_kernel_matches_plain_at_mr_shapes(cuda, finish):
    """250 bp short reads pad to m = 256: the mr passes' band (W=96) and
    the mr finish's (W=64)."""
    from proovread_tpu_torch.align import bsw
    from proovread_tpu_torch.align.params import BWA_MR, BWA_MR_FINISH
    args = _bsw_args(cuda, BWA_MR_FINISH if finish else BWA_MR, 7 + finish,
                     m=256)
    assert _equal(bsw.bsw_expand_v2(*args), bsw.bsw_expand_v2_plain(*args))


@pytest.mark.parametrize("m,n", [(32, 128), (256, 384), (512, 640)])
def test_sw_kernel_matches_plain(cuda, m, n):
    """Siamaera's Smith-Waterman: queries planted in their windows,
    chance pairs, short and empty queries, N codes; n = 640 is the ccs and
    utg shape (K = 20, walks of up to 512 steps)."""
    from proovread_tpu_torch.align import sw
    from proovread_tpu_torch.align.params import AlignParams, BWA_SR_FINISH
    rng = np.random.default_rng(n)
    R = 203
    r = rng.integers(0, 4, (R, n)).astype(np.int8)
    ql = rng.integers(1, m + 1, R).astype(np.int32)
    ql[:2] = [0, m]
    q = np.full((R, m), 4, np.int8)
    for i in range(R):
        src = (r[i, 40:40 + m] if i % 2 else
               rng.integers(0, 4, m).astype(np.int8))
        q[i, :ql[i]] = src[:ql[i]]
    q[rng.random((R, m)) < 0.01] = 4
    t = lambda x: torch.as_tensor(x, device=cuda)   # noqa: E731
    for ap in (AlignParams(min_out_score=0.0, score_per_base=False),
               BWA_SR_FINISH):
        launches = sw.sw_batch.launches
        got = sw.sw_batch(t(q), t(r), t(ql), ap)
        assert sw.sw_batch.launches == launches + 1
        want = sw.sw_batch_plain(t(q), t(r), t(ql), ap)
        assert _equal(got, want)
        assert int(want.n_ops.max()) >= m


def test_bsw_kernel_matches_plain_at_band_128(cuda):
    """W=128, four band lanes per warp lane (the widest band the kernel
    takes), and an R that leaves the last block partly empty."""
    import dataclasses
    from proovread_tpu_torch.align import bsw
    from proovread_tpu_torch.align.params import BWA_SR
    ap = dataclasses.replace(BWA_SR, band_width=64)
    assert bsw.band_lanes(ap) == 128
    args = _bsw_args(cuda, ap, 6, R=253)
    assert _equal(bsw.bsw_expand_v2(*args), bsw.bsw_expand_v2_plain(*args))


def test_pileup_kernel_matches_plain(cuda):
    from proovread_tpu_torch.ops import pileup_kernel as pk
    rng = np.random.default_rng(2)
    B, Lpile, R, n = 4, 1200, 256, 208
    t = lambda x: torch.as_tensor(x, device=cuda)   # noqa: E731
    b0 = t(rng.integers(-2**31, 2**31, (R, n)).astype(np.int32))
    b1 = t(rng.integers(0, 1 << 22, (R, n)).astype(np.int32))
    ro = t(np.sort(rng.integers(0, B, R)).astype(np.int32))
    w0 = t(rng.integers(0, Lpile - n, R).astype(np.int32))
    base = torch.zeros((B, Lpile, 64), device=cuda)
    got = pk.pileup_accumulate_bits(base.clone(), b0, b1, ro, w0)
    assert torch.equal(got, pk.pileup_accumulate_bits_plain(
        base.clone(), b0, b1, ro, w0))


def _wild_call(rng, B, L, device):
    """ConsensusCall fields with some outside the ranges the packing
    clamps: insertion length 7-9, phred 64-70, base -1 and 9, inserted
    base 7."""
    from proovread_tpu_torch.ops.consensus_call import ConsensusCall

    def wild(a, vals, frac):
        a = a.copy()
        sel = rng.random(a.shape) < frac
        a[sel] = rng.choice(vals, int(sel.sum()))
        return a

    f = dict(
        emitted=rng.random((B, L)) > 0.15,
        base=wild(rng.integers(0, 5, (B, L)), [-1, 9], 0.05).astype(np.int8),
        ins_len=wild(np.where(rng.random((B, L)) < 0.08,
                              rng.integers(1, 7, (B, L)), 0),
                     [7, 8, 9], 0.01).astype(np.int32),
        ins_bases=wild(rng.integers(0, 5, (B, L, 6)), [7], 0.05)
        .astype(np.int8),
        freq=np.zeros((B, L), np.float32),
        phred=wild(rng.integers(0, 41, (B, L)), [64, 67, 70], 0.05)
        .astype(np.int32),
        coverage=np.zeros((B, L), np.float32))
    return ConsensusCall(**{k: torch.as_tensor(v, device=device)
                            for k, v in f.items()})


def _assemble_card_plain_cpu(cuda, call, lengths, Lp):
    """assemble_rows on the card: one launch, equal to the plain version on
    the card and to the wrapper on CPU copies."""
    from proovread_tpu_torch.ops import assemble_kernel as ak
    launches = ak.assemble_rows.launches
    got = ak.assemble_rows(call, lengths, Lp)
    assert ak.assemble_rows.launches == launches + 1
    assert _equal(got, ak.assemble_rows_plain(call, lengths, Lp))
    want_cpu = ak.assemble_rows(type(call)(*(f.cpu() for f in call)),
                                lengths.cpu(), Lp)
    assert _equal(got, want_cpu)
    return want_cpu


def test_assemble_and_hcr_kernels_match_plain(cuda):
    from proovread_tpu_torch.ops import assemble_kernel as ak
    from proovread_tpu_torch.pipeline.masking import MaskParams
    rng = np.random.default_rng(3)
    B, L = 16, 3000
    t = lambda x: torch.as_tensor(x, device=cuda)   # noqa: E731
    lengths = t(rng.integers(0, L + 1, B).astype(np.int32))
    _assemble_card_plain_cpu(cuda, _wild_call(rng, B, L, cuda), lengths, L)
    qual = t(np.repeat(rng.integers(0, 41, (B, L // 50)), 50, axis=1)
             .astype(np.uint8))
    pvi = ak._int_params(ak.mask_params_vec(MaskParams().scaled(100)))
    assert _equal(ak.hcr_mask_cuda(qual, lengths, pvi),
                  ak.hcr_mask_plain(qual, lengths, pvi))


@pytest.mark.parametrize("finish", [False, True])
def test_bsw_v1_kernel_matches_plain_and_v2(cuda, finish):
    from proovread_tpu_torch.align import bsw
    from proovread_tpu_torch.align.params import BWA_SR, BWA_SR_FINISH
    from proovread_tpu_torch.pipeline.dcorrect import device_revcomp
    ap = BWA_SR_FINISH if finish else BWA_SR
    rng = np.random.default_rng(4 + finish)
    S, m, B, Lp, R = 64, 112, 4, 2048, 256
    W = bsw.band_lanes(ap)
    n = m + W
    genome = rng.integers(0, 4, (B, Lp)).astype(np.int8)
    qlen = rng.integers(60, 101, S).astype(np.int32)
    qf = np.full((S, m), 4, np.int8)
    for s in range(S):
        b, p = int(rng.integers(0, B)), int(rng.integers(0, Lp - 120))
        qf[s, :qlen[s]] = genome[b, p:p + qlen[s]]
    t = lambda x: torch.as_tensor(x, device=cuda)   # noqa: E731
    sread = t(rng.integers(0, S, R).astype(np.int32))
    strand = t(rng.integers(0, 2, R).astype(np.int32))
    lread = t(np.sort(rng.integers(0, B, R)).astype(np.int32))
    diag = t(rng.integers(-2 * n, Lp + 2 * n, R).astype(np.int32))
    q_t = t(qf)
    rc = device_revcomp(q_t, t(qlen))
    mp = bsw.build_map_pad(t(genome), None, n)
    _, w0p = bsw.window_starts(diag, W, Lp, n)
    qlen_c = t(qlen)[sread.long()]
    q1 = torch.where((strand == 0)[:, None], q_t[sread.long()],
                     rc[sread.long()])
    win1 = mp[lread.long()[:, None],
              w0p.long()[:, None] + torch.arange(n, device=cuda)[None, :]]
    launches = bsw.bsw_expand.launches
    got = bsw.bsw_expand(q1, win1, qlen_c, ap)
    assert bsw.bsw_expand.launches == launches + 1
    assert _equal(got, bsw.bsw_expand_plain(q1, win1, qlen_c, ap))
    assert _equal(got, bsw.bsw_expand_v2(q_t, rc, mp, qlen_c, sread, strand,
                                         lread, w0p, ap))


def test_packed_and_dense_pileup_kernels_match_plain(cuda):
    from proovread_tpu_torch.ops import pileup_kernel as pk
    from proovread_tpu_torch.ops.fused import phred2freq
    rng = np.random.default_rng(5)
    B, Lpile, R, n = 4, 1200, 256, 208
    t = lambda x: torch.as_tensor(x, device=cuda)   # noqa: E731
    words = rng.integers(0, 1 << 25, (R, n)).astype(np.int32)
    words[rng.random((R, n)) < 0.3] = 0
    ro = t(np.sort(rng.integers(0, B, R)).astype(np.int32))
    w0 = t(rng.integers(0, Lpile - n, R).astype(np.int32))
    base = torch.zeros((B, Lpile, 64), device=cuda)
    launches = pk.pileup_accumulate_packed.launches
    got = pk.pileup_accumulate_packed(base.clone(), t(words), ro, w0)
    assert pk.pileup_accumulate_packed.launches == launches + 1
    assert torch.equal(got, pk.pileup_accumulate_packed_plain(
        base.clone(), t(words), ro, w0))
    votes = phred2freq(t(rng.integers(0, 42, (R, n, 64))))
    votes = torch.where(t(rng.random((R, n, 64)) < 0.3), votes, 0.0)
    launches = pk.pileup_accumulate.launches
    got = pk.pileup_accumulate(base.clone(), votes, ro, w0)
    assert pk.pileup_accumulate.launches == launches + 1
    assert torch.equal(got, pk.pileup_accumulate_plain(base.clone(), votes,
                                                       ro, w0))
    assert torch.equal(got, pk.pileup_accumulate(base.clone(), votes, ro,
                                                 w0))


@pytest.mark.parametrize("seed,R,B,L,lo,hi,cov", [
    (0, 200_000, 64, 1000, 90, 110, 150),
    (1, 70_001, 16, 4000, 230, 290, 100)])
def test_admission_past_2_24_same_on_card_and_cpu(cuda, seed, R, B, L, lo,
                                                  hi, cov):
    """The passes of tests/test_torch_admit.py (summed spans past 2^24,
    where the f32 order of the adds decides admission): ``device_admit`` on
    the card gives the CPU's mask, and so the reference's."""
    from proovread_tpu_torch.consensus.params import ConsensusParams
    from proovread_tpu_torch.pipeline.dcorrect import device_admit
    rng = np.random.default_rng(seed)
    lread = np.sort(rng.integers(0, B, R)).astype(np.int32)
    span = rng.integers(lo, hi + 1, R).astype(np.int32)
    pos0 = rng.integers(0, L - hi, R).astype(np.int32)
    score = rng.integers(50, 201, R).astype(np.float32)
    passed = rng.random(R) < 0.95
    arrays = (lread, pos0, span, score, passed, np.full(B, L, np.int32))
    assert int(span[passed].sum()) > 1 << 24
    cp = ConsensusParams(max_coverage=cov)
    want = device_admit(*(torch.as_tensor(a) for a in arrays), cp)
    got = device_admit(*(torch.as_tensor(a, device=cuda) for a in arrays), cp)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    assert 0 < int(want.sum()) < int(passed.sum())


def test_ordered_pileup_on_clustered_candidates(cuda):
    """Sorted candidates clustered on a few reads (~250 a read, the shape of
    the qual-weighted pass's chunks): equal to the plain version, and equal
    again on a second run."""
    from proovread_tpu_torch.ops import pileup_kernel as pk
    from proovread_tpu_torch.ops.fused import phred2freq
    rng = np.random.default_rng(7)
    B, Lp, R, n = 6, 3072, 1024, 208
    t = lambda x: torch.as_tensor(x, device=cuda)   # noqa: E731
    ro = t(np.sort(rng.integers(0, 4, R)).astype(np.int32))
    w0 = t(rng.integers(0, Lp + n, R).astype(np.int32))
    votes = phred2freq(t(rng.integers(0, 42, (R, n, 64))))
    votes = torch.where(t(rng.random((R, n, 64)) < 0.3), votes, 0.0)
    base = torch.zeros((B, Lp + 2 * n, 64), device=cuda)
    got = pk.pileup_accumulate(base.clone(), votes, ro, w0)
    assert torch.equal(got, pk.pileup_accumulate_plain(base.clone(), votes,
                                                       ro, w0))
    assert torch.equal(got, pk.pileup_accumulate(base.clone(), votes, ro, w0))


def test_bits_pileup_on_clustered_candidates(cuda):
    """The main path's shape: sorted candidates of 3 reads, 16-aligned
    windows that overlap (many votes on one cell), planes from real vote
    words with dead rows, counts already in the buffer. The kernel equals
    the plain version on the card and the wrapper on CPU copies."""
    from proovread_tpu_torch.ops import pileup_kernel as pk
    from proovread_tpu_torch.ops.votes import word_to_bits
    rng = np.random.default_rng(8)
    B, Lp, R, n = 5, 3072, 2048, 208
    Lpile = Lp + 2 * n
    st = rng.integers(1, 7, (R, n))
    ln = np.where(rng.random((R, n)) < 0.2, rng.integers(1, 7, (R, n)), 0)
    words = st | (rng.integers(0, 2, (R, n)) << 3) | (ln << 4)
    for k in range(6):
        words |= np.where(k < ln, rng.integers(0, 5, (R, n)), 5) << (7 + 3 * k)
    words[rng.random((R, n)) < 0.3] = 0
    words[rng.random(R) < 0.1] = 0
    b0, b1 = word_to_bits(torch.as_tensor(words.astype(np.int32)))
    ro = np.sort(rng.choice([0, 2, 3], R)).astype(np.int32)
    w0 = (rng.integers(0, (Lp + n) // 16 + 1, R) * 16).astype(np.int32)
    base = torch.as_tensor(rng.integers(0, 9, (B, Lpile, 64))
                           .astype(np.float32))
    args = [torch.as_tensor(a) for a in (ro, w0)]
    want_cpu = pk.pileup_accumulate_bits(base.clone(), b0, b1, *args)
    c = [x.to(cuda) for x in (base, b0, b1, *args)]
    launches = pk.pileup_accumulate_bits.launches
    got = pk.pileup_accumulate_bits(c[0].clone(), *c[1:])
    assert pk.pileup_accumulate_bits.launches == launches + 1
    want = pk.pileup_accumulate_bits_plain(c[0].clone(), *c[1:])
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), want_cpu)
    assert float((want_cpu - base).max()) >= 16    # many votes on one cell


def test_hcr_kernel_at_the_longest_bucket(cuda):
    """HCR at B=32, L=49152 (the main path's longest bucket): equal to the
    plain version on the card and to the wrapper on CPU copies (mask and
    masked fraction)."""
    from proovread_tpu_torch.ops import assemble_kernel as ak
    from proovread_tpu_torch.pipeline.masking import MaskParams
    rng = np.random.default_rng(9)
    B, L = 32, 49152
    seg = np.repeat(rng.integers(0, 2, (B, L // 97 + 1)), 97, axis=1)[:, :L]
    qual = np.where(seg > 0, rng.integers(25, 41, (B, L)),
                    rng.integers(0, 10, (B, L))).astype(np.uint8)
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lengths[:3] = [0, 1, L]
    q, ln = torch.as_tensor(qual), torch.as_tensor(lengths)
    pv = ak.mask_params_vec(MaskParams().scaled(100))
    pvi = ak._int_params(pv)
    launches = ak.hcr_mask_rows.launches
    mask, frac = ak.hcr_mask_rows(q.to(cuda), ln.to(cuda), pv)
    assert ak.hcr_mask_rows.launches == launches + 1
    want = ak.hcr_mask_plain(q.to(cuda), ln.to(cuda), pvi)
    mask_cpu, frac_cpu = ak.hcr_mask_rows(q, ln, pv)
    assert torch.equal(mask, want[0])
    assert torch.equal(mask.cpu(), mask_cpu) and torch.equal(frac.cpu(),
                                                             frac_cpu)
    assert 0.0 < float(frac_cpu) < 1.0


@pytest.mark.parametrize("B,L,Lp", [(8, 2500, 2500), (8, 2500, 2000),
                                    (40, 49152, 49152)])
def test_assemble_kernel_on_tile_edges_and_the_longest_bucket(cuda, B, L,
                                                              Lp):
    """Lengths on the kernels' tile edges (ASM_TILE columns, L not a
    multiple of it), Lp at and below L, and the main path's longest bucket
    (40 rows at 49,152 columns), with fields out of range."""
    from proovread_tpu_torch.ops import assemble_kernel as ak
    rng = np.random.default_rng(10 + B + Lp)
    T = ak.ASM_TILE
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lengths[:6] = [0, T - 1, T, T + 1, L, 1]
    want = _assemble_card_plain_cpu(
        cuda, _wild_call(rng, B, L, cuda),
        torch.as_tensor(lengths, device=cuda), Lp)
    assert int(want[2].max()) == Lp and int(want[2][0]) == 0


def test_packed_pileup_on_clustered_candidates_and_bad_metadata(cuda):
    """The high-coverage path's shape: sorted candidates of 2 reads,
    16-aligned windows in the first 6,144 columns of each (about 140
    windows a column), real vote words with dead rows, counts already in
    the buffer: equal to the plain version and to the wrapper on CPU
    copies. Then a bad read_of or w0 raises with the flag word's message,
    and only the valid candidates' votes land."""
    from proovread_tpu_torch.ops import pileup_kernel as pk
    rng = np.random.default_rng(11)
    B, Lp, R, n = 4, 12288, 8192, 208
    Lpile = Lp + 2 * n
    st = np.where(rng.random((R, n)) < 0.8, 1, rng.integers(1, 7, (R, n)))
    ln = np.where(rng.random((R, n)) < 0.1, rng.integers(1, 7, (R, n)), 0)
    words = st | (rng.integers(0, 2, (R, n)) << 3) | (ln << 4)
    for k in range(6):
        words |= np.where(k < ln, rng.integers(0, 5, (R, n)), 5) << (7 + 3 * k)
    words[rng.random((R, n)) < 0.2] = 0
    words[rng.random(R) < 0.1] = 0
    ro = np.sort(rng.choice([1, 3], R)).astype(np.int32)
    w0 = (rng.integers(0, (6144 - n) // 16 + 1, R) * 16).astype(np.int32)
    base = rng.integers(0, 9, (B, Lpile, 64)).astype(np.float32)
    cpu = [torch.as_tensor(a) for a in (base, words.astype(np.int32), ro, w0)]
    c = [x.to(cuda) for x in cpu]
    want_cpu = pk.pileup_accumulate_packed(cpu[0].clone(), *cpu[1:])
    launches = pk.pileup_accumulate_packed.launches
    got = pk.pileup_accumulate_packed(c[0].clone(), *c[1:])
    assert pk.pileup_accumulate_packed.launches == launches + 1
    assert torch.equal(got, pk.pileup_accumulate_packed_plain(
        c[0].clone(), *c[1:]))
    assert torch.equal(got.cpu(), want_cpu)
    assert float((want_cpu - cpu[0]).max()) >= 100  # ~140 windows a column
    ok = np.ones(R, bool)
    ok[[5, 4000, 8000]] = False
    for bad_ro, bad_w0, msg in ((np.where(ok, ro, B), w0,
                                 f"read_of outside [0, {B - 1}]"),
                                (ro, np.where(ok, w0, Lpile - n + 1),
                                 f"w0 outside [0, {Lpile - n}]")):
        buf = c[0].clone()
        with pytest.raises(ValueError) as e:
            pk.pileup_accumulate_packed(buf, c[1], torch.as_tensor(
                bad_ro, device=cuda), torch.as_tensor(bad_w0, device=cuda))
        assert str(e.value) == "pileup_accumulate_packed: " + msg
        keep = torch.as_tensor(ok, device=cuda)
        assert torch.equal(buf, pk.pileup_accumulate_packed_plain(
            c[0].clone(), c[1][keep], c[2][keep], c[3][keep]))


@pytest.mark.parametrize("max_warps", [32, 0])
def test_lcs_kernel_matches_plain(cuda, monkeypatch, max_warps):
    """The accuracy scoreboard's LCS: empty reads and truths, truths of
    exactly 64, 2048 and 4096 bases, truths of several warps (9,000 and
    20,000 bases) beside short pairs, a read past its truth, N codes and
    runs of them across the warps' edges, ~12% errors; as the wavefront,
    and with ``max_warps`` 0 every pair from the global-memory scratch."""
    from proovread_tpu_torch.obs import accuracy as acc
    monkeypatch.setattr(acc, "WAVE_MAX_WARPS", max_warps)
    rng = np.random.default_rng(max_warps + 1)
    pairs = []
    for i, n_t in enumerate([0, 10, 64, 2048, 2049, 4096, 700, 130, 9000,
                             20_000] + list(rng.integers(1, 6000, 40))):
        tr = rng.integers(0, 4, int(n_t)).astype(np.int8)
        rd = tr.copy()
        err = rng.random(len(rd)) < 0.12
        rd[err] = rng.integers(0, 5, int(err.sum()))
        rd = np.delete(rd, np.flatnonzero(rng.random(len(rd)) < 0.04))
        if i == 1:
            rd = rd[:0]
        if i == 6:
            rd = np.concatenate([rd, rng.integers(0, 4, 900)]).astype(np.int8)
        if i == 7:
            tr[::7] = 4
            rd[::5] = 4
        if i == 8:
            tr[320:384] = 4                 # words that never match
            tr[4000:4200] = 4               # across warps 0 and 1
        if i == 9:
            tr[4096:8192] = 4               # all of warp 1
        pairs.append((rd, tr))
    args = acc.pack_pairs(pairs, cuda)
    launches = acc.lcs_lengths.launches
    got = acc.lcs_lengths(*args)
    assert acc.lcs_lengths.launches == launches + 1
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), acc.lcs_lengths_plain(
        *acc.pack_pairs(pairs, "cpu")))


@pytest.mark.parametrize("smem_bytes", [100 * 1024, 0])
def test_edit_kernel_matches_plain(cuda, monkeypatch, smem_bytes):
    """The scoreboard's banded traceback: pairs of 50 to 3,000 bases at
    ~15% and ~0.5% errors, reads longer and shorter than their truths, N
    on either side, empty sides, bands too small (doubled), bands past a
    block's 1024 threads; with ``smem_bytes`` 0 every pair's DP rows in
    the global scratch. Bitwise against the plain version and the host
    numpy."""
    from proovread_tpu_torch.obs import accuracy as acc
    monkeypatch.setattr(acc, "EDIT_SMEM_BYTES", smem_bytes)
    rng = np.random.default_rng(11)
    pairs, bands = [], []
    for i, n_t in enumerate(rng.integers(50, 3000, 24)):
        tr = rng.integers(0, 4, int(n_t)).astype(np.int8)
        rd = tr.copy()
        err = rng.random(len(rd)) < (0.15 if i % 2 else 0.005)
        rd[err] = rng.integers(0, 5, int(err.sum()))
        rd = np.delete(rd, np.flatnonzero(rng.random(len(rd)) < 0.03))
        if i % 5 == 1:
            rd = np.concatenate([rd, rng.integers(0, 4, 80)]).astype(np.int8)
        if i % 7 == 2:
            tr[::11] = 4
        pairs.append((rd, tr))
        bands.append([3, 700, 40, 16][i % 4])
    pairs += [(pairs[0][0][:0], pairs[0][1]), (pairs[1][0], pairs[1][1][:0])]
    bands += [8, 8]
    want = [[acc.edit_alignment(a, b, band=w)[k] for k in
             ("dist", "matches", "sub", "ins", "del")]
            for (a, b), w in zip(pairs, bands)]
    launches = acc.edit_alignments.launches
    got = acc.edit_alignments(*acc.pack_pairs(pairs, cuda), np.asarray(bands))
    torch.cuda.synchronize()
    assert acc.edit_alignments.launches >= launches + 2   # bands doubled
    assert got.cpu().tolist() == want
    assert torch.equal(got.cpu(), acc.edit_alignments_plain(
        *acc.pack_pairs(pairs, "cpu"), np.asarray(bands)))


@pytest.mark.parametrize("m,n,qmax", [(128, 256, 100), (256, 384, 250)],
                         ids=["sr", "mr"])
def test_sw_kernel_at_scan_engine_shapes(cuda, m, n, qmax):
    """The scan engine's chunks: 4096 candidates of 100 bp queries packed
    to m = 128 against n = 256 windows (sr), 250 bp queries at m = 256
    against n = 384 (mr); queries planted in their windows and chance
    pairs."""
    from proovread_tpu_torch.align import sw
    from proovread_tpu_torch.align.params import BWA_MR, BWA_SR
    rng = np.random.default_rng(m)
    R = 4096
    r = rng.integers(0, 4, (R, n)).astype(np.int8)
    ql = rng.integers(qmax // 2, qmax + 1, R).astype(np.int32)
    q = np.full((R, m), 4, np.int8)
    for i in range(R):
        src = (r[i, 40:40 + qmax].copy() if i % 2 else
               rng.integers(0, 4, qmax).astype(np.int8))
        err = rng.random(qmax) < 0.03
        src[err] = rng.integers(0, 5, int(err.sum()))
        q[i, :ql[i]] = src[:ql[i]]
    t = lambda x: torch.as_tensor(x, device=cuda)   # noqa: E731
    ap = BWA_SR if m == 128 else BWA_MR
    got = sw.sw_batch(t(q), t(r), t(ql), ap)
    want = sw.sw_batch_plain(t(q), t(r), t(ql), ap)
    assert _equal(got, want)
    assert int((want.n_ops >= qmax // 2).sum()) > R // 3


def _scan_dataset(seed, n_long=10, read_len=300, G=600, n_sr=45):
    """Uniform-length long reads with 8% CLR-like errors and error-free
    100 bp short reads on both strands."""
    from proovread_tpu_torch.io.records import SeqRecord
    from proovread_tpu_torch.ops.encode import decode_codes, revcomp_codes
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G).astype(np.int8)
    longs = []
    for i in range(n_long):
        a = int(rng.integers(0, G - read_len))
        src = genome[a:a + read_len]
        keep = rng.random(read_len) > 0.04
        noisy = np.where(rng.random(read_len) < 0.04,
                         (src + 1) % 4, src)[keep].astype(np.int8)
        longs.append(SeqRecord(f"r{i}", decode_codes(noisy)))
    srs = []
    for i in range(n_sr):
        st = int(rng.integers(0, G - 100))
        s = genome[st:st + 100].copy()
        if rng.random() < 0.5:
            s = revcomp_codes(s)
        srs.append(SeqRecord(f"s{i}", decode_codes(s),
                             qual=np.full(100, 30, np.uint8)))
    return longs, srs


@pytest.mark.parametrize("fault", [None, "compile@b0.p2;oom@b1"])
def test_scan_engine_same_on_card_and_cpu(cuda, fault):
    """``engine="scan"`` on the card equals it on the CPU (records, trimmed
    records, chimeras, reports), and so does the ladder's walk of two
    faulted buckets down to the host-scan rung; the card's sw kernel
    runs."""
    from proovread_tpu_torch.align import sw
    from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
    from proovread_tpu_torch.pipeline.trim import TrimParams
    longs, srs = _scan_dataset(3)
    kw = dict(n_iterations=2, sampling=False, batch_reads=8,
              host_chunk_rows=512, trim=TrimParams(min_length=150))
    if fault is None:
        kw["engine"] = "scan"
    else:
        kw.update(device_chunk=256, fault_spec=fault)

    def key(res):
        recs = lambda rs: [(r.id, r.seq, r.qual.tobytes())  # noqa: E731
                           for r in rs]
        return recs(res.untrimmed), recs(res.trimmed), res.chimera, \
            res.reports
    launches = sw.sw_batch.launches
    card = Pipeline(PipelineConfig(device="cuda", **kw)).run(longs, srs)
    assert sw.sw_batch.launches > launches
    cpu = Pipeline(PipelineConfig(device="cpu", **kw)).run(longs, srs)
    assert key(card) == key(cpu)
    assert sum(r.n_admitted for r in card.reports) > 0
    demos = [r for r in card.reports if r.task.startswith("demote")]
    assert len(demos) == (0 if fault is None else 6)


@pytest.mark.parametrize("M,N,n_hot,hot_frac", [
    (1, 7, 0, 0.9), (5000, 97, 0, 0.9), (300_000, 4096, 0, 0.9),
    (300_001, 1_000_000, 64, 0.5), (200_000, 50, 6, 1.0)],
    ids=["one", "small", "hot", "long-segments", "few-cells"])
def test_scatter_kernel_matches_plain_and_cpu(cuda, M, N, n_hot, hot_frac):
    """The ordered scatter on fractional weights onto few hot cells
    (segments of hundreds; "long-segments": a few segments of thousands
    that cross many thread blocks, beside single entries; "few-cells":
    segments of ~3000), indices past the target, twice: the kernel == its
    plain version on the card == ``index_add_`` on the CPU, bitwise."""
    from proovread_tpu_torch.ops import scatter as sc
    rng = np.random.default_rng(M)
    hot = rng.integers(0, N, n_hot or max(1, N // 8))
    idx = np.where(rng.random(M) < hot_frac, rng.choice(hot, M),
                   rng.integers(0, N + 3, M)).astype(np.int64)
    w = (rng.random(M) * rng.choice([0.01, 0.83, 37.0], M)).astype(
        np.float32)
    keep = rng.random(M) < 0.7
    base = (rng.random(N) * 3).astype(np.float32)
    t = lambda x: torch.as_tensor(x, device=cuda)   # noqa: E731
    launches = sc.scatter_add_ordered.launches
    got = sc.scatter_add_ordered(t(base), t(idx), t(w), t(keep))
    again = sc.scatter_add_ordered(t(base), t(idx), t(w), t(keep))
    assert sc.scatter_add_ordered.launches == launches + 2
    want = sc.scatter_add_ordered_plain(t(base), t(idx), t(w), t(keep))
    live = keep & (idx < N)
    cpu = torch.as_tensor(base).index_add_(0, torch.as_tensor(idx[live]),
                                           torch.as_tensor(w[live]))
    assert _equal([got, again, got], [want, want, cpu])
    if n_hot == 64:
        assert np.bincount(idx[live]).max() > 1000


@pytest.mark.parametrize("case", ["dropped", "one-cell"])
def test_scatter_kernel_all_dropped_or_one_cell(cuda, case):
    """Every entry dropped (the target unchanged), and every kept entry
    onto one cell (one segment across every warp's range)."""
    from proovread_tpu_torch.ops import scatter as sc
    rng = np.random.default_rng(5)
    M, N = 100_003, 333
    idx = (rng.integers(0, N, M) if case == "dropped"
           else np.full(M, 101)).astype(np.int64)
    keep = (np.zeros(M, bool) if case == "dropped" else rng.random(M) < 0.9)
    w = (rng.random(M) * 0.37).astype(np.float32)
    base = (rng.random(N) * 3).astype(np.float32)
    t = lambda x: torch.as_tensor(x, device=cuda)   # noqa: E731
    got = sc.scatter_add_ordered(t(base), t(idx), t(w), t(keep))
    want = sc.scatter_add_ordered_plain(t(base), t(idx), t(w), t(keep))
    cpu = torch.as_tensor(base).index_add_(0, torch.as_tensor(idx[keep]),
                                           torch.as_tensor(w[keep]))
    assert _equal([got, got], [want, cpu])
    if case == "dropped":
        assert _equal([got], [torch.as_tensor(base)])


def test_scatter_public_call_does_not_sync(cuda):
    """The public call keys, sorts and launches without reading anything
    back to the host: it passes under ``set_sync_debug_mode("error")``."""
    from proovread_tpu_torch.ops import scatter as sc
    rng = np.random.default_rng(11)
    M, N = 50_000, 4096
    t = lambda x: torch.as_tensor(x, device=cuda)   # noqa: E731
    idx = t(rng.integers(-5, N + 5, M).astype(np.int64))
    w = t(rng.random(M).astype(np.float32))
    keep = t(rng.random(M) < 0.6)
    base = t(np.zeros(N, np.float32))
    sc.scatter_add_ordered(base.clone(), idx, w, keep)   # builds, loads
    target = base.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sc.scatter_add_ordered(target, idx, w, keep)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = sc.scatter_add_ordered_plain(base.clone(), idx, w, keep)
    assert _equal([target], [want])


def test_accumulate_and_engine_same_on_card_and_cpu(cuda):
    """``ops/pileup.py:accumulate`` through the scatter kernel, and a
    qual-weighted ``ConsensusEngine.consensus_batch`` with ignore coords
    and ref-qual votes: the card's tensors and results equal the CPU's."""
    from proovread_tpu_torch.consensus.alnset import Alignment, AlnSet
    from proovread_tpu_torch.consensus.engine import ConsensusEngine
    from proovread_tpu_torch.consensus.params import ConsensusParams
    from proovread_tpu_torch.io.batch import pack_reads
    from proovread_tpu_torch.io.records import SeqRecord
    rng = np.random.default_rng(9)
    refs = [SeqRecord(f"r{i}", "".join("ACGT"[c] for c in rng.integers(
        0, 4, 900)), qual=rng.integers(0, 30, 900).astype(np.uint8))
        for i in range(3)]
    cns = ConsensusParams(qual_weighted=True, use_ref_qual=True)

    def sets():
        out = []
        r2 = np.random.default_rng(10)
        for rec in refs:
            alns = []
            for k in range(120):
                n = int(r2.integers(60, 140))
                pos = int(r2.integers(0, 900 - n))
                cig = f"{n // 2}M{int(r2.integers(1, 4))}I{n - n // 2}M"
                ql = n + int(cig.split("M")[1].split("I")[0])
                alns.append(Alignment.from_cigar_str(
                    f"q{k}", pos, r2.integers(0, 4, ql), cig,
                    qual=r2.integers(5, 41, ql).astype(np.uint8),
                    score=float(r2.integers(50, 400))))
            out.append(AlnSet(rec.id, len(rec), alns, params=cns))
        return out
    ign = [[(100, 40)], [], [(850, 80)]]
    res = {d: ConsensusEngine(cns, cell_budget=1 << 15,
                              device=d).consensus_batch(
        pack_reads(refs), sets(), ignore_coords=ign)
        for d in ("cuda", "cpu")}
    for a, b in zip(res["cuda"], res["cpu"]):
        assert (a.record.seq, a.cigar) == (b.record.seq, b.cigar)
        assert a.record.qual.tobytes() == b.record.qual.tobytes()
        assert a.freqs.tobytes() == b.freqs.tobytes()
        assert a.coverage.tobytes() == b.coverage.tobytes()


def test_ccs_and_flex_same_on_card_and_cpu(cuda):
    """``ccs_correct`` (qual-weighted scan-engine votes through the
    scatter kernel) and ``Pipeline.run`` in flex mode: the card's records
    equal the CPU's."""
    from proovread_tpu_torch.io.records import SeqRecord
    from proovread_tpu_torch.ops.encode import decode_codes, revcomp_codes
    from proovread_tpu_torch.ops import scatter as sc
    from proovread_tpu_torch.pipeline.ccs import ccs_correct
    from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
    rng = np.random.default_rng(12)
    subs = []
    for hole in range(4):
        mol = rng.integers(0, 4, 700).astype(np.int8)
        for k in range(3):
            src = mol if k % 2 == 0 else revcomp_codes(mol)
            keep = rng.random(len(src)) > 0.05
            noisy = np.where(rng.random(len(src)) < 0.05, (src + 1) % 4,
                             src)[keep].astype(np.int8)
            subs.append(SeqRecord(f"m1_2/{hole}/{k * 800}_{k * 800 + 700}",
                                  decode_codes(noisy),
                                  qual=np.full(len(noisy), 9, np.uint8)))
    launches = sc.scatter_add_ordered.launches
    card, st = ccs_correct(subs, window=128, overlap=32, device="cuda")
    assert sc.scatter_add_ordered.launches > launches
    cpu, st_cpu = ccs_correct(subs, window=128, overlap=32, device="cpu")
    assert vars(st) == vars(st_cpu) and st.primary == 4
    assert [(r.id, r.seq, r.qual.tobytes()) for r in card] == \
        [(r.id, r.seq, r.qual.tobytes()) for r in cpu]
    longs, srs = _scan_dataset(5)
    kw = dict(n_iterations=2, sampling=False, batch_reads=8,
              device_chunk=256, haplo_coverage=-1.0)
    flex = {d: Pipeline(PipelineConfig(device=d, **kw)).run(longs, srs)
            for d in ("cuda", "cpu")}
    assert [(r.id, r.seq, r.qual.tobytes()) for r in flex["cuda"].untrimmed] \
        == [(r.id, r.seq, r.qual.tobytes()) for r in flex["cpu"].untrimmed]
    assert flex["cuda"].reports == flex["cpu"].reports


def _serve_dataset(seed, n_jobs=2):
    from proovread_tpu_torch.io.simulate import (simulate_job_stream,
                                                 simulate_short_reads)
    genome, jobs = simulate_job_stream(
        seed=seed, n_jobs=n_jobs, genome_size=4000, modes=("clr",),
        mean_len=900, min_len=500, reads_per_job=(3, 4))
    return jobs, simulate_short_reads(genome, 25.0, seed=seed + 1)


def _serve_cfg(device):
    from proovread_tpu_torch.pipeline.driver import PipelineConfig
    from proovread_tpu_torch.pipeline.trim import TrimParams
    return PipelineConfig(n_iterations=2, sampling=False, batch_reads=8,
                          device_chunk=128, trim=TrimParams(min_length=150),
                          device=device)


def _serve_wave(tmp, jobs, shorts, cfg, name):
    """Every job through one server's wave: job id -> (untrimmed,
    trimmed) records as the wire returns them."""
    from proovread_tpu_torch.serve.protocol import encode_record
    from proovread_tpu_torch.serve.server import CorrectionServer, ServeConfig
    srv = CorrectionServer(shorts, ServeConfig(
        state_dir=str(tmp / name), max_wave_jobs=8, replica_id=name), cfg)
    for j in jobs:
        assert srv.handle({
            "op": "submit", "job_id": j.job_id, "tenant": j.tenant,
            "mode": j.mode, "reads": [encode_record(r) for r in j.records],
        })["status"] == "accepted"
    while srv.pump():
        pass
    out = {}
    for j in jobs:
        res = srv.handle({"op": "result", "job_id": j.job_id})
        assert res["ok"], res
        out[j.job_id] = (res["untrimmed"], res["trimmed"])
    return out


def _batch(jobs, shorts, cfg):
    """One batch run of the jobs' reads, cut back to each job as wire
    records (the server's payload)."""
    from proovread_tpu_torch.pipeline.driver import Pipeline
    from proovread_tpu_torch.pipeline.trim import pieces_of
    from proovread_tpu_torch.serve.protocol import encode_records
    res = Pipeline(cfg).run([r for j in jobs for r in j.records], shorts)
    out = {}
    for j in jobs:
        ids = {r.id for r in j.records}
        out[j.job_id] = (encode_records(pieces_of(res.untrimmed, ids)),
                         encode_records(pieces_of(res.trimmed, ids)))
    return out


def test_serve_wave_on_card_equals_batch(cuda, tmp_path):
    """A two-job wave of the server on the card gives each job the
    records of one batch ``Pipeline.run`` of both jobs' reads on the
    card, and those of the same wave on the CPU."""
    from proovread_tpu_torch.align import bsw
    jobs, shorts = _serve_dataset(61)
    launches = bsw.bsw_expand_v2.launches
    got = _serve_wave(tmp_path, jobs, shorts, _serve_cfg("cuda"), "card")
    assert bsw.bsw_expand_v2.launches > launches
    assert got == _batch(jobs, shorts, _serve_cfg("cuda"))
    assert got == _serve_wave(tmp_path, jobs, shorts, _serve_cfg("cpu"),
                              "cpu")


def test_two_replica_threads_on_one_card(cuda, tmp_path):
    """Two servers' waves run at the same time on two threads of one
    process (a fleet's replicas on one card): the kernel library is
    built once and each thread launches on its own current stream; both
    results equal their batch runs."""
    import threading
    sets = [_serve_dataset(71), _serve_dataset(73)]
    want = [_batch(jobs, shorts, _serve_cfg("cuda")) for jobs, shorts in sets]
    got, errors = [None, None], []
    start = threading.Barrier(2)

    def replica(i):
        try:
            start.wait(timeout=30)
            got[i] = _serve_wave(tmp_path, *sets[i], _serve_cfg("cuda"),
                                 f"r{i}")
        except Exception as e:                          # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=replica, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert got == want
