"""Port parity: correction QC (``obs/qc.py`` and the pass reductions that
feed it, ``pipeline/dcorrect.py:qc_*``).

The same seeded inputs, made with numpy, go through the JAX package
(Pallas kernels in interpret mode) and the port on the CPU. Tolerance:
the three QC reductions bitwise equal (int32 counts, the f32 support sums
of integer-valued coverage); ``fused_iterations(collect_qc=True)``'s QC
rows bitwise equal to the JAX loop's and to the port's eager passes on
the same inputs; recorder records, aggregates, report lines and JSONL
bytes equal for the same call sequence. A guard: with no recorder and no
tracer installed, the pipeline runs no QC code and no trace fence."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from proovread_tpu.align import bsw as jbsw
from proovread_tpu.align.params import BWA_SR
from proovread_tpu.consensus.params import ConsensusParams as JCns
from proovread_tpu.obs import qc as jqc
from proovread_tpu.ops.consensus_call import ConsensusCall as JCall
from proovread_tpu.pipeline import dcorrect as jdc
from proovread_tpu.pipeline.masking import MaskParams as JMask

from proovread_tpu_torch import obs as tobs
from proovread_tpu_torch.align.params import AlignParams
from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.obs import qc as tqc
from proovread_tpu_torch.ops.consensus_call import ConsensusCall as TCall
from proovread_tpu_torch.pipeline import dcorrect as tdc

from test_torch_pass import _fused_data, _port, _t


def _random_call(seed, B=5, L=300, K=6):
    rng = np.random.default_rng(seed)
    f = dict(
        emitted=rng.random((B, L)) > 0.1,
        base=rng.integers(0, 5, (B, L)).astype(np.int8),
        ins_len=np.where(rng.random((B, L)) < 0.1,
                         rng.integers(1, 7, (B, L)), 0).astype(np.int32),
        ins_bases=rng.integers(0, 5, (B, L, K)).astype(np.int8),
        freq=rng.integers(0, 30, (B, L)).astype(np.float32),
        phred=rng.integers(0, 41, (B, L)).astype(np.int32),
        coverage=rng.integers(0, 60, (B, L)).astype(np.float32))
    codes = rng.integers(0, 5, (B, L)).astype(np.int8)
    qual = rng.integers(0, 41, (B, L)).astype(np.uint8)
    lengths = np.array([0, 1, L, L - 37, 120][:B], np.int32)
    mask = rng.random((B, L)) < 0.4
    return f, codes, qual, lengths, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_qc_reductions_match_jax(seed):
    f, codes, qual, lengths, mask = _random_call(seed)
    jcall = JCall(**{k: jnp.asarray(v) for k, v in f.items()})
    tcall = TCall(**{k: torch.as_tensor(v) for k, v in f.items()})
    want = jdc.qc_pass_row_stats(jcall, jnp.asarray(codes),
                                 jnp.asarray(qual), jnp.asarray(lengths))
    got = tdc.qc_pass_row_stats(tcall, _t(codes), _t(qual), _t(lengths))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    m = tdc.qc_row_mask_counts(_t(mask))
    assert m.dtype == torch.int32
    np.testing.assert_array_equal(
        m.numpy(), np.asarray(jdc.qc_row_mask_counts(jnp.asarray(mask))))
    s = tdc.qc_finish_support(tcall, _t(lengths))
    assert s.dtype == torch.float32
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(jdc.qc_finish_support(jcall,
                                                    jnp.asarray(lengths))))


@pytest.mark.parametrize("shortcut", [False, True])
def test_fused_iterations_collect_qc_matches_jax_and_eager(shortcut):
    """Passes 2..N with collect_qc: the QC rows of each run pass equal the
    JAX loop's, and the port's eager passes (correct_pass, assembly, HCR
    and the three reductions, one pass at a time) on the same inputs;
    collect_qc changes no other output."""
    lr, sr, Lp, m = _fused_data()
    CH, ap = 128, BWA_SR
    cns = JCns(use_ref_qual=True, indel_taboo_length=7)
    mp = JMask(phred_min=50) if not shortcut else JMask().scaled(100)
    pad_idx = len(sr.lengths) - 1
    qc, qq, qlen = (jnp.asarray(a) for a in (sr.codes, sr.qual, sr.lengths))
    rcq = jdc.device_revcomp(qc, qlen)
    dc = jdc.DeviceCorrector(chunk=CH, interpret=True)
    call, _ = dc.correct_pass(jnp.asarray(lr.codes), jnp.asarray(lr.qual),
                              jnp.asarray(lr.lengths), None, qc, rcq, qq,
                              qlen, ap, cns)
    c1, q1, l1 = jdc.device_assemble(call, jnp.asarray(lr.lengths), Lp,
                                     interpret=True)
    mask1, frac1 = jdc.device_hcr_mask(q1, l1, mp)
    n_rest = 2
    sels = np.full((n_rest, pad_idx), pad_idx, np.int32)
    sels[0] = np.arange(pad_idx)
    sels[1, :60] = np.sort(np.random.default_rng(4).choice(pad_idx, 60,
                                                           replace=False))
    pvs = np.stack([np.asarray(jdc.mask_params_vec(mp))] * n_rest)
    sc_frac, min_gain = (0.5, 0.03) if shortcut else (2.0, -1.0)
    state0 = [np.asarray(a) for a in (c1, q1, l1, mask1)]
    kw = dict(m=m, W=jbsw.band_lanes(ap), CH=CH, n_chunks=2, n_rest=n_rest,
              Lp=Lp, seed_stride=8, seed_min_votes=2, shortcut_frac=sc_frac,
              min_gain=min_gain)
    jout = jdc.fused_iterations(
        c1, q1, l1, mask1, frac1, qc, rcq, qq, qlen, jnp.asarray(sels),
        jnp.asarray(pvs), ap=ap, cns=cns, interpret=True, collect_qc=True,
        **kw)
    n_done = int(jout[4])
    j_m, j_l, j_e, j_u = (np.asarray(a) for a in jout[11:])

    tsr = (_t(sr.codes), tdc.device_revcomp(_t(sr.codes), _t(sr.lengths)),
           _t(sr.qual), _t(sr.lengths))
    tap, tcns = _port(AlignParams, ap), _port(ConsensusParams, cns)
    outs = [tdc.fused_iterations(*map(_t, state0), float(frac1), *tsr, sels,
                                 pvs, ap=tap, cns=tcns, collect_qc=qc_on,
                                 **kw) for qc_on in (True, False)]
    tout = outs[0]
    assert len(tout.fracs) == n_done and outs[1].qc_masked is None
    for a, b in zip((tout.codes, tout.qual, tout.lengths, tout.mask_cols,
                     tout.fracs), (outs[1].codes, outs[1].qual,
                                   outs[1].lengths, outs[1].mask_cols,
                                   outs[1].fracs)):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b)
    np.testing.assert_array_equal(tout.qc_masked.numpy(), j_m[:n_done])
    np.testing.assert_array_equal(tout.qc_lengths.numpy(), j_l[:n_done])
    np.testing.assert_array_equal(tout.qc_edits.numpy(), j_e)
    np.testing.assert_array_equal(tout.qc_uplift.numpy(), j_u)
    assert int(tout.qc_uplift.sum()) > 0

    # the same passes, eagerly
    codes, qual, lengths, mask = map(_t, state0)
    edits = torch.zeros(len(lr.lengths), dtype=torch.int32)
    uplift = torch.zeros_like(edits)
    corr = tdc.DeviceCorrector(chunk=CH)
    for k in range(n_done):
        sel = torch.as_tensor(sels[k], dtype=torch.int64)
        call, _ = corr.correct_pass(codes, qual, lengths, mask,
                                    *(t[sel] for t in tsr), tap, tcns)
        ed, up = tdc.qc_pass_row_stats(call, codes, qual, lengths)
        edits, uplift = edits + ed, uplift + up
        codes, qual, lengths = tdc.device_assemble(call, lengths, Lp)
        mask, _ = tdc.hcr_mask_rows(qual, lengths, pvs[k])
        assert torch.equal(tdc.qc_row_mask_counts(mask), tout.qc_masked[k])
        assert torch.equal(lengths, tout.qc_lengths[k])
    assert torch.equal(edits, tout.qc_edits)
    assert torch.equal(uplift, tout.qc_uplift)


def test_qc_zero_overhead_when_off(monkeypatch):
    """With no QC recorder and no tracer installed, a pipeline run never
    touches the recorder, the QC reductions or the trace fence: QC and
    tracing off add no device work and no synchronization."""
    from proovread_tpu_torch.io.records import SeqRecord
    from proovread_tpu_torch.obs import trace as ttrace
    from proovread_tpu_torch.ops.encode import decode_codes
    from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
    from proovread_tpu_torch.pipeline.trim import TrimParams

    def _boom(*a, **k):                                 # noqa: ANN001
        raise AssertionError("QC or trace machinery ran while disabled")

    for name in ("start_bucket", "record_pass", "record_edits",
                 "record_finish", "record_chimera", "record_siamaera",
                 "record_trim", "record_ccs", "record_accuracy", "snapshot",
                 "restore", "bucket_payload", "splice"):
        monkeypatch.setattr(tqc.QcRecorder, name, _boom)
    for name in ("qc_row_mask_counts", "qc_pass_row_stats",
                 "qc_finish_support"):
        monkeypatch.setattr(tdc, name, _boom)
    monkeypatch.setattr(ttrace, "_fence", _boom)
    monkeypatch.setattr(ttrace.Span, "__init__", _boom)

    assert tqc.current() is None and tobs.current_tracer() is None
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, 400).astype(np.int8)
    longs = [SeqRecord(f"r{i}", decode_codes(genome[s:s + 200]))
             for i, s in enumerate((0, 100))]
    srs = [SeqRecord(f"s{i}", decode_codes(genome[s:s + 100]),
                     qual=np.full(100, 30, np.uint8))
           for i, s in enumerate(rng.integers(0, 300, 30))]
    res = Pipeline(PipelineConfig(
        mode="sr", n_iterations=3, sampling=False, batch_reads=8,
        device_chunk=128, trim=TrimParams(min_length=100), device="cpu",
        mask_shortcut_frac=2.0, mask_min_gain_frac=-1.0)).run(longs, srs)
    assert len(res.untrimmed) == 2
    assert res.qc is None and res.metrics is not None
    assert [r.task for r in res.reports] == ["bwa-sr-1", "bwa-sr-2",
                                             "bwa-sr-3", "bwa-sr-finish"]


class _Rec:
    def __init__(self, rid, n):
        self.id = rid
        self.n = n

    def __len__(self):
        return self.n


def _drive(mod):
    """One call sequence of every recorder method."""
    rec = mod.QcRecorder()
    rec.start_bucket(0, [_Rec("a", 100), _Rec("b", 250), _Rec("c", 90)],
                     span_id=4)
    rec.record_pass(["a", "b", "c"], [30, 0, 90], [100, 260, 90])
    rec.record_edits(["a", "b", "c"], [3, 0, 7], [50, 2, 0])
    rec.record_pass(["a", "b", "c"], [77, 12, 90], [101, 258, 90])
    rec.record_finish(["a", "b", "c"], [104, 255, 0], [9, 3, 0],
                      np.float32([612.0, 1.0, 0.0]), [101, 258, 90])
    rec.record_chimera("b", [(100, 140, 0.73125), (200, 210, 0.25)])
    rec.record_siamaera("a.1", "trimmed", 10, 80)
    rec.record_siamaera("c", "dropped")
    rec.record_trim("a", 1, 0, 24, 0, 80)
    rec.record_trim("b", 3, 61, 30, 1, 160)
    rec.record_ccs("c", "primary", 3)
    rec.record_accuracy("a", {"identity_before": 0.85,
                              "identity_after": 0.99, "lcs_before": 85,
                              "lcs_after": 99, "truth_len": 100,
                              "classes": {"sub_before": 5, "sub_after": 1,
                                          "sub_introduced": 0,
                                          "ins_before": 2, "ins_after": 0,
                                          "ins_introduced": 0,
                                          "del_before": 8, "del_after": 0,
                                          "del_introduced": 0},
                              "chimera": None})
    snap = rec.snapshot(["a", "b"])
    rec.record_pass(["a"], [1], [1])
    rec.restore(["a", "b", "z"], snap)
    payload = rec.bucket_payload(["b", "c", "missing"])
    rec.splice(payload, span_id=9)
    return rec


def test_recorder_matches_jax(tmp_path):
    j, t = _drive(jqc), _drive(tqc)
    assert t.records == j.records
    agg = t.aggregate()
    assert agg == j.aggregate()
    assert t.report_lines() == j.report_lines()
    t.write_jsonl(str(tmp_path / "t.jsonl"))
    j.write_jsonl(str(tmp_path / "j.jsonl"))
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    from proovread_tpu.obs import metrics as jm
    from proovread_tpu_torch.obs import metrics as tm
    with jm.scope() as jreg, tm.scope() as treg:
        j.to_metrics()
        t.to_metrics(agg)
    assert json.dumps(treg.as_dict(), sort_keys=True) == \
        json.dumps(jreg.as_dict(), sort_keys=True)
    assert t.iter_records() == j.iter_records()
    assert tqc.FUNNEL_KEYS == jqc.FUNNEL_KEYS
    assert tqc.QC_SCHEMA_VERSION == jqc.QC_SCHEMA_VERSION == 2
    assert tqc.new_record("x") == jqc.new_record("x")


def test_recorder_install_and_scope():
    assert tqc.current() is None and not tqc.enabled()
    rec = tqc.install()
    try:
        assert tqc.current() is rec and tqc.enabled()
        with tqc.scope() as r:
            assert r is rec                     # reuses the installed one
    finally:
        tqc.uninstall()
    with tqc.scope() as r:
        assert tqc.current() is r
    assert tqc.current() is None
