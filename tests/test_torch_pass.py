"""Port parity: one correction pass and the passes-2..N loop.

Inputs are the JAX package's own device-path fixtures
(tests/test_device_path.py: TestDeviceCorrectorE2E and TestFusedIterations),
sent through the JAX pass (interpret-mode Pallas) and the port on the CPU.
Both vote paths run: unweighted (bsw v2, bit-plane or, past 256 votes per
lane, packed-word pileup) and qual-weighted (bsw v1, dense phred-weighted
slabs folded in candidate order). Tolerance: ConsensusCall fields, pass
counts, per-pass KPIs, the collected alignment data and the final
codes/qual/lengths/mask are bitwise equal; the masked fractions are equal
as f32."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from proovread_tpu.align import bsw as jbsw
from proovread_tpu.align.params import AlignParams as JAlign, BWA_SR
from proovread_tpu.align.params import BWA_SR_FINISH
from proovread_tpu.consensus.params import ConsensusParams as JCns
from proovread_tpu.io.batch import pack_reads
from proovread_tpu.io.records import SeqRecord
from proovread_tpu.ops.encode import decode_codes
from proovread_tpu.pipeline import dcorrect as jdc
from proovread_tpu.pipeline.masking import MaskParams as JMask

from proovread_tpu_torch.align.params import AlignParams
from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.pipeline import dcorrect as tdc
from proovread_tpu_torch.pipeline.masking import MaskParams
from proovread_tpu_torch.state import params_from_fields


def _port(cls, obj):
    return params_from_fields(cls, dataclasses.asdict(obj))


def _e2e_setup(seed=9, B=3, rl=600, n_sr=180, sub_rate=0.03):
    """TestDeviceCorrectorE2E._setup."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 2048).astype(np.int8)
    lrs, planted = [], []
    for i in range(B):
        p = int(rng.integers(0, len(genome) - rl))
        true = genome[p:p + rl].copy()
        noisy = true.copy()
        errs = rng.choice(np.arange(30, rl - 30), int(rl * sub_rate),
                          replace=False)
        for e in errs:
            noisy[e] = (noisy[e] + 1 + rng.integers(0, 3)) % 4
        lrs.append(SeqRecord(f"lr{i}", decode_codes(noisy),
                             qual=np.full(rl, 1, np.uint8)))
        planted.append(true)
    srs = []
    for i in range(n_sr):
        b = int(rng.integers(0, B))
        p = int(rng.integers(0, rl - 100))
        srs.append(SeqRecord(f"s{i}", decode_codes(planted[b][p:p + 100]),
                             qual=np.full(100, 35, np.uint8)))
    return pack_reads(lrs), pack_reads(srs, pad_multiple=16)


def _t(x):
    return torch.as_tensor(np.array(x))


def _assert_call_equal(jcall, tcall):
    for f in jcall._fields:
        a, b = np.asarray(getattr(jcall, f)), getattr(tcall, f).numpy()
        np.testing.assert_array_equal(b, a, err_msg=f)


def _assert_aln_equal(jaln, taln):
    for f in ("lread", "pos0", "span", "admitted", "vote_ok", "q_start",
              "q_end", "win_start", "r_start", "r_end", "sread", "strand",
              "score"):
        np.testing.assert_array_equal(getattr(taln, f),
                                      np.asarray(getattr(jaln, f)),
                                      err_msg=f)
    use = np.flatnonzero(taln.admitted & taln.vote_ok)
    assert use.size
    jaln.prefetch(use)
    taln.prefetch(use)
    for ci in use:
        for a, b in zip(jaln._rows[int(ci)], taln._rows[int(ci)]):
            np.testing.assert_array_equal(b, np.asarray(a))


_PASS_CASES = {
    "iteration": (JAlign(), JCns(use_ref_qual=True)),
    "finish": (BWA_SR_FINISH, JCns(indel_taboo_length=7, max_coverage=22)),
    # qual-weighted votes with reference-qual votes (bsw v1, dense slabs)
    "qual_weighted": (JAlign(), JCns(qual_weighted=True, use_ref_qual=True)),
    "qual_weighted_finish": (BWA_SR_FINISH, JCns(
        qual_weighted=True, indel_taboo_length=7, max_coverage=22)),
    # 2*150+2 > 256 votes per lane: the f32 packed-word pileup kernel
    "high_coverage": (JAlign(), JCns(use_ref_qual=True, max_coverage=150)),
}


@pytest.mark.parametrize("case", list(_PASS_CASES))
def test_correct_pass_matches_jax(case):
    finish = case.endswith("finish")
    jap, jcns = _PASS_CASES[case]
    lr, sr = _e2e_setup()
    if case.startswith("qual"):
        # varied short-read phreds, so the vote weights are fractional
        rng = np.random.default_rng(5)
        sr.qual[:] = rng.integers(2, 41, sr.qual.shape).astype(np.uint8)
        lr.qual[:] = rng.integers(0, 30, lr.qual.shape).astype(np.uint8)
    rc = jdc.device_revcomp(jnp.asarray(sr.codes), jnp.asarray(sr.lengths))
    jout = jdc.DeviceCorrector(chunk=128, interpret=True).correct_pass(
        jnp.asarray(lr.codes), jnp.asarray(lr.qual), jnp.asarray(lr.lengths),
        None, jnp.asarray(sr.codes), rc, jnp.asarray(sr.qual),
        jnp.asarray(sr.lengths), jap, jcns, seed_stride=4,
        collect_aln=finish)

    t_rc = tdc.device_revcomp(_t(sr.codes), _t(sr.lengths))
    np.testing.assert_array_equal(t_rc.numpy(), np.asarray(rc))
    tout = tdc.DeviceCorrector(chunk=128).correct_pass(
        _t(lr.codes), _t(lr.qual), _t(lr.lengths), None, _t(sr.codes), t_rc,
        _t(sr.qual), _t(sr.lengths), _port(AlignParams, jap),
        _port(ConsensusParams, jcns), seed_stride=4, collect_aln=finish)

    jstats, tstats = jout[1], tout[1]
    assert tstats.n_candidates == jstats.n_candidates > 128   # >= 2 chunks
    assert int(tstats.n_admitted) == int(jstats.n_admitted) > 0
    assert int(tstats.n_eligible) == int(jstats.n_eligible)
    _assert_call_equal(jout[0], tout[0])

    Lp = lr.codes.shape[1]
    ja = jdc.device_assemble_xla(jout[0], jnp.asarray(lr.qual),
                                 jnp.asarray(lr.lengths), Lp)
    ta = tdc.device_assemble(tout[0], _t(lr.lengths), Lp)
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    mp = JMask().scaled(100)
    jm, jf = jdc.device_hcr_mask_dyn_xla(ja[1], ja[2], jdc.mask_params_vec(mp))
    tm, tf = tdc.device_hcr_mask(ta[1], ta[2], _port(MaskParams, mp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert np.float32(tf.item()) == np.float32(jf)

    if finish:
        _assert_aln_equal(jout[2], tout[2])


def _fused_data(seed=31):
    """TestFusedIterations._data, plus the zero-length pad row the driver
    appends to the short-read set."""
    rng = np.random.default_rng(seed)
    B, Lp, m = 4, 512, 104
    bases = "ACGT"
    longs, srs = [], []
    for i in range(B):
        genome = "".join(bases[k] for k in rng.integers(0, 4, 400))
        seq = list(genome)
        for mu in np.flatnonzero(rng.random(400) < 0.04):
            seq[mu] = bases[int(rng.integers(0, 4))]
        longs.append(SeqRecord(f"lr{i}", "".join(seq),
                               qual=np.full(400, 5, np.uint8)))
        for p in rng.integers(0, 300, 24):
            srs.append(SeqRecord(f"s{i}_{p}", genome[p:p + 100],
                                 qual=np.full(100, 30, np.uint8)))
    srs.append(SeqRecord("pad", "A", qual=np.zeros(1, np.uint8)))
    lr = pack_reads(longs, pad_len=Lp)
    sr = pack_reads(srs, pad_len=m)
    sr.lengths[-1] = 0
    sr.codes[-1] = 4
    return lr, sr, Lp, m


@pytest.mark.parametrize("n_chunks,shortcut,qual_weighted", [
    (1, False, False), (2, True, False), (2, False, True)])
def test_fused_iterations_match_jax(n_chunks, shortcut, qual_weighted):
    lr, sr, Lp, m = _fused_data()
    CH = 128
    ap = BWA_SR
    cns = JCns(use_ref_qual=True, indel_taboo_length=7,
               qual_weighted=qual_weighted)
    if qual_weighted:
        rng = np.random.default_rng(8)
        sr.qual[:-1] = rng.integers(2, 41, sr.qual[:-1].shape)
        lr.qual[:] = rng.integers(0, 30, lr.qual.shape)
    # without the shortcut, mask nothing (phred_min above the cap) so the
    # later passes keep enough candidates to overflow a one-chunk cap
    mp = JMask(phred_min=50) if not shortcut else JMask().scaled(100)
    pad_idx = len(sr.lengths) - 1
    qc, qq, qlen = (jnp.asarray(a) for a in (sr.codes, sr.qual, sr.lengths))
    rcq = jdc.device_revcomp(qc, qlen)

    # pass 1 (eager) on the JAX side gives the loop's input state
    dc = jdc.DeviceCorrector(chunk=CH, interpret=True)
    call, _ = dc.correct_pass(jnp.asarray(lr.codes), jnp.asarray(lr.qual),
                              jnp.asarray(lr.lengths), None, qc, rcq, qq,
                              qlen, ap, cns)
    c1, q1, l1 = jdc.device_assemble(call, jnp.asarray(lr.lengths), Lp,
                                     interpret=True)
    mask1, frac1 = jdc.device_hcr_mask(q1, l1, mp)

    rng = np.random.default_rng(3)
    n_rest = 2
    # pass 2 probes every read twice (enough candidates to overflow a
    # one-chunk cap), pass 3 a random subset padded with the sentinel row
    sels = np.full((n_rest, 2 * pad_idx), pad_idx, np.int32)
    sels[0] = np.concatenate([np.arange(pad_idx)] * 2)
    sels[1, :72] = np.sort(rng.choice(pad_idx, 72, replace=False))
    pvs = np.stack([np.asarray(jdc.mask_params_vec(mp)),
                    np.asarray(jdc.mask_params_vec(
                        JMask(end_ratio=0.3).scaled(100)))])
    sc_frac, min_gain = (0.5, 0.03) if shortcut else (2.0, -1.0)
    # fused_iterations donates (deletes) its read-state inputs
    state0 = [np.asarray(a) for a in (c1, q1, l1, mask1)]
    jout = jdc.fused_iterations(
        c1, q1, l1, mask1, frac1, qc, rcq, qq, qlen, jnp.asarray(sels),
        jnp.asarray(pvs), m=m, W=jbsw.band_lanes(ap), CH=CH,
        n_chunks=n_chunks, ap=ap, cns=cns, interpret=True, n_rest=n_rest,
        Lp=Lp, seed_stride=8, seed_min_votes=2, shortcut_frac=sc_frac,
        min_gain=min_gain)
    (jc, jq, jl, jmask, j_it, jfracs, jncands, jnadms, jneligs, jndrops,
     jdone) = jout

    tout = tdc.fused_iterations(
        *map(_t, state0), float(frac1), _t(sr.codes),
        tdc.device_revcomp(_t(sr.codes), _t(sr.lengths)), _t(sr.qual),
        _t(sr.lengths), sels, pvs, m=m, W=jbsw.band_lanes(ap), CH=CH,
        n_chunks=n_chunks, ap=_port(AlignParams, ap),
        cns=_port(ConsensusParams, cns), n_rest=n_rest, Lp=Lp,
        seed_stride=8, seed_min_votes=2, shortcut_frac=sc_frac,
        min_gain=min_gain)

    n_done = int(j_it)
    assert len(tout.fracs) == n_done
    assert tout.shortcut == bool(jdone)
    if shortcut:
        assert n_done == 1 and tout.shortcut
    else:
        assert n_done == n_rest
    np.testing.assert_array_equal(np.float32(tout.fracs),
                                  np.asarray(jfracs)[:n_done])
    for name, got, want in (("ncands", tout.ncands, jncands),
                            ("nadms", tout.nadms, jnadms),
                            ("neligs", tout.neligs, jneligs),
                            ("ndrops", tout.ndrops, jndrops)):
        np.testing.assert_array_equal(got, np.asarray(want)[:n_done],
                                      err_msg=name)
    if n_chunks == 1:
        assert tout.ndrops[0] > 0          # the candidate cap truncated
    for a, b in ((jc, tout.codes), (jq, tout.qual), (jl, tout.lengths),
                 (jmask, tout.mask_cols)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
