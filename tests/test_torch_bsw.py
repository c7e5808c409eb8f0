"""Port parity: banded Smith-Waterman with traceback (bsw_expand_v2 and
bsw_expand, v1).

The same seeded numpy batches go through the JAX kernels in interpret mode
and the port's plain PyTorch versions on the CPU. Tolerance: bitwise for
every integer output, exact for the score (integer-valued f32), and the
packed vote words built from both results must be equal. v1 runs on the
slabs the qual-weighted pass gathers (strand-oriented query rows, windows
with out-of-range columns as N) and equals v2 on the same candidates."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from proovread_tpu.align import bsw as jbsw
from proovread_tpu.align.params import AlignParams as JAlignParams
from proovread_tpu.align.params import BWA_SR_FINISH as J_FINISH
from proovread_tpu.ops.votes import encode_votes_packed_bases as j_encode
from proovread_tpu.pipeline.dcorrect import device_revcomp as j_revcomp

from proovread_tpu_torch.align import bsw as tbsw
from proovread_tpu_torch.align.params import AlignParams
from proovread_tpu_torch.ops.votes import encode_votes_packed_bases
from proovread_tpu_torch.pipeline.dcorrect import device_revcomp
from proovread_tpu_torch.state import params_from_fields

import dataclasses


def _scenario(seed, jparams, R=128, m=112, S=48, B=4, Lp=1024,
              with_ignore=True):
    """TestBswV2Equivalence-shaped batch: both strands, N-padded and empty
    queries, band-edge and fully out-of-range windows, ignore bits."""
    rng = np.random.default_rng(seed)
    W = jbsw.band_lanes(jparams)
    n = m + W
    qlen_set = rng.integers(60, m + 1, S).astype(np.int32)
    qlen_set[:2] = 0
    qf = np.full((S, m), 4, np.int8)
    for i in range(S):
        ln = int(qlen_set[i])
        qf[i, :ln] = rng.integers(0, 4, ln)
        if ln:
            qf[i, rng.integers(0, ln, 3)] = 4
    map2 = rng.integers(0, 5, (B, Lp)).astype(np.int8)
    ign2 = (rng.random((B, Lp)) < 0.15) if with_ignore else None
    sread = rng.integers(0, S, R).astype(np.int32)
    sread[:3] = 0
    strand = rng.integers(0, 2, R).astype(np.int32)
    lread = np.sort(rng.integers(0, B, R)).astype(np.int32)
    diag = rng.integers(0, Lp, R).astype(np.int32)
    k = R // 5
    diag[:k // 2] = rng.integers(-2 * n, 8, k // 2)
    diag[k // 2:k] = rng.integers(Lp - 8, Lp + 2 * n, k - k // 2)
    # plant real alignments in the rest so the traceback sees indels
    for i in range(k, R):
        ln = int(qlen_set[sread[i]])
        start = int(diag[i])
        if ln and 0 <= start and start + ln + 8 < Lp and strand[i] == 0:
            src = qf[sread[i], :ln].copy()
            src = np.insert(src, ln // 3, rng.integers(0, 4, 2))
            src = np.delete(src, 2 * ln // 3)
            map2[lread[i], start:start + len(src)] = src
    return W, n, qf, qlen_set, map2, ign2, sread, strand, lread, diag


def _run_both(jparams, W, n, qf, qlen_set, map2, ign2, sread, strand, lread,
              diag):
    Lp = map2.shape[1]
    rc = np.asarray(j_revcomp(jnp.asarray(qf), jnp.asarray(qlen_set)))
    qlen = qlen_set[sread]
    map_pad = jbsw.build_map_pad(
        jnp.asarray(map2), None if ign2 is None else jnp.asarray(ign2), n)
    _, w0p = jbsw.window_starts(jnp.asarray(diag), W, Lp, n)
    want = jbsw.bsw_expand_v2(
        jnp.asarray(qf), jnp.asarray(rc), map_pad, jnp.asarray(qlen),
        jnp.asarray(sread), jnp.asarray(strand), jnp.asarray(lread), w0p,
        jparams, interpret=True)

    tparams = params_from_fields(AlignParams, dataclasses.asdict(jparams))
    t = torch.as_tensor
    t_rc = device_revcomp(t(qf), t(qlen_set))
    np.testing.assert_array_equal(t_rc.numpy(), rc)
    t_map = tbsw.build_map_pad(t(map2), None if ign2 is None else t(ign2), n)
    np.testing.assert_array_equal(t_map.numpy(), np.asarray(map_pad))
    _, t_w0p = tbsw.window_starts(t(diag), W, Lp, n)
    np.testing.assert_array_equal(t_w0p.numpy(), np.asarray(w0p))
    got = tbsw.bsw_expand_v2(t(qf), t_rc, t_map, t(qlen), t(sread),
                             t(strand), t(lread), t_w0p, tparams)
    return want, got


@pytest.mark.parametrize("seed,with_ignore,finish", [
    (0, True, False), (1, False, False), (2, True, True), (3, False, True)])
def test_bsw_plain_bitwise_vs_jax_kernel(seed, with_ignore, finish):
    jparams = J_FINISH if finish else JAlignParams()
    assert jbsw.band_lanes(jparams) == (64 if finish else 96)
    sc = _scenario(seed, jparams, with_ignore=with_ignore)
    want, got = _run_both(jparams, *sc)
    assert int(np.asarray(want.valid).sum()) > 50
    for f in want._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(want, f)), getattr(got, f).numpy(),
            err_msg=f)
    assert int((np.asarray(want.ins_len) > 0).sum()) > 0


def test_packed_vote_words_match():
    jparams = JAlignParams()
    sc = _scenario(5, jparams, with_ignore=False)
    want, got = _run_both(jparams, *sc)
    for kw in (dict(taboo_abs=7), dict(taboo_frac=0.1)):
        w_j = j_encode(want.state, want.qrow, want.ins_len, want.ins_b0,
                       want.ins_b1, want.q_start, want.q_end, **kw)
        w_t = encode_votes_packed_bases(
            got.state, got.qrow, got.ins_len, got.ins_b0, got.ins_b1,
            got.q_start, got.q_end, **kw)
        np.testing.assert_array_equal(np.asarray(w_j), w_t.numpy())
        assert int((w_t.numpy() != 0).sum()) > 1000


def _v1_slabs(W, n, qf, qlen_set, map2, sread, strand, lread, diag):
    """The qual-weighted pass's gathered slabs (dcorrect._gather_and_align):
    strand-oriented queries, windows at the 16-aligned band start with
    out-of-range columns as N."""
    rc = np.asarray(j_revcomp(jnp.asarray(qf), jnp.asarray(qlen_set)))
    q = np.where(strand[:, None] == 0, qf[sread], rc[sread]).astype(np.int8)
    Lp = map2.shape[1]
    idx = ((diag - W // 2) & ~15)[:, None] + np.arange(n)[None, :]
    inb = (idx >= 0) & (idx < Lp)
    win = np.where(inb, map2[lread[:, None], np.clip(idx, 0, Lp - 1)],
                   4).astype(np.int8)
    return q, win, qlen_set[sread].astype(np.int32)


@pytest.mark.parametrize("seed,finish", [(6, False), (7, True)])
def test_bsw_v1_plain_bitwise_vs_jax_kernel(seed, finish):
    jparams = J_FINISH if finish else JAlignParams()
    W, n, qf, qlen_set, map2, _, sread, strand, lread, diag = _scenario(
        seed, jparams, with_ignore=False)
    q, win, qlen = _v1_slabs(W, n, qf, qlen_set, map2, sread, strand, lread,
                             diag)
    assert (q == 4).any() and (win == 4).any() and (strand == 1).any()
    want = jbsw.bsw_expand(jnp.asarray(q), jnp.asarray(win),
                           jnp.asarray(qlen), jparams, interpret=True)
    tparams = params_from_fields(AlignParams, dataclasses.asdict(jparams))
    t = torch.as_tensor
    got = tbsw.bsw_expand(t(q), t(win), t(qlen), tparams)
    assert int(np.asarray(want.valid).sum()) > 50
    for f in want._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(want, f)), getattr(got, f).numpy(),
            err_msg=f)
    # the same candidates through v2 (no ignore bits): equal
    _, v2 = _run_both(jparams, W, n, qf, qlen_set, map2, None, sread,
                      strand, lread, diag)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(v2, f)), f


def test_bsw_v1_checks_its_contract():
    p = AlignParams()
    W = tbsw.band_lanes(p)
    q = torch.zeros((100, 112), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 128"):
        tbsw.bsw_expand(q, torch.zeros((100, 112 + W), dtype=torch.int8),
                        torch.zeros(100, dtype=torch.int32), p)
    with pytest.raises(ValueError, match="win"):
        tbsw.bsw_expand(q[:0], torch.zeros((0, 112), dtype=torch.int8),
                        torch.zeros(0, dtype=torch.int32), p)
