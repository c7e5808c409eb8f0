"""Port parity: the data plane and constants.

``pack_reads`` at pad 16 (the device path) and 128, the simulators, the
coverage sampler's selection sequences, ``MaskParams.scaled``, the state
helpers and the trim / chimera host code, each against the JAX package on
the same seeded inputs. Tolerance: bitwise / exact equality."""

import dataclasses

import numpy as np
import pytest

from proovread_tpu.align import params as jparams
from proovread_tpu.consensus import engine as jengine
from proovread_tpu.consensus.params import ConsensusParams as JCns
from proovread_tpu.io import batch as jbatch
from proovread_tpu.io import simulate as jsim
from proovread_tpu.pipeline import driver as jdriver
from proovread_tpu.pipeline import trim as jtrim
from proovread_tpu.pipeline.masking import MaskParams as JMask
from proovread_tpu.pipeline.sampling import CoverageSampler as JSampler

from proovread_tpu_torch.align import params as tparams
from proovread_tpu_torch.align.bsw import band_lanes
from proovread_tpu_torch.consensus import engine as tengine
from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.io import batch as tbatch
from proovread_tpu_torch.io import simulate as tsim
from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.pipeline import driver as tdriver
from proovread_tpu_torch.pipeline import trim as ttrim
from proovread_tpu_torch.pipeline.masking import MaskParams
from proovread_tpu_torch.pipeline.sampling import CoverageSampler
from proovread_tpu_torch.state import batch_to_tensors, params_from_fields


def _recs(recs):
    return [(r.id, r.seq, None if r.qual is None else r.qual.tobytes(),
             r.desc) for r in recs]


def test_simulators_match():
    g_j = jsim.random_genome(20_000, seed=3)
    g_t = tsim.random_genome(20_000, seed=3)
    np.testing.assert_array_equal(g_j, g_t)
    lj, tj = jsim.simulate_long_reads(g_j, 60_000, seed=4)
    lt, tt = tsim.simulate_long_reads(g_t, 60_000, seed=4)
    assert _recs(lj) == _recs(lt)
    for a, b in zip(tj, tt):
        np.testing.assert_array_equal(a, b)
    assert (_recs(jsim.simulate_short_reads(g_j, 5.0, seed=5))
            == _recs(tsim.simulate_short_reads(g_t, 5.0, seed=5)))


@pytest.mark.parametrize("pad_multiple", [16, 128])
def test_pack_reads_byte_equal(pad_multiple):
    g = jsim.random_genome(5_000, seed=1)
    longs, _ = jsim.simulate_long_reads(g, 12_000, mean_len=900, seed=2)
    longs.append(type(longs[0])("fasta_read", "ACGTNNacgu"))   # qual None
    jb = jbatch.pack_reads(longs, pad_multiple=pad_multiple)
    tb = tbatch.pack_reads([SeqRecord(r.id, r.seq, r.qual, r.desc)
                            for r in longs], pad_multiple=pad_multiple)
    for f in ("codes", "qual", "lengths"):
        a, b = getattr(jb, f), getattr(tb, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert jb.ids == tb.ids and jb.codes.shape[1] % pad_multiple == 0
    assert _recs(jb.to_records()) == _recs(tb.to_records())
    back, tensors = batch_to_tensors(jb.ids, jb.codes, jb.qual, jb.lengths,
                                     device="cpu")
    assert tensors[0].numpy().tobytes() == jb.codes.tobytes()
    assert back.record(0).seq == jb.record(0).seq


def test_sampler_sequences_match():
    for cov, target in ((30.0, 15.0), (30.0, 30.0), (60.0, 15.0),
                        (3.0, 15.0)):
        js, ts = JSampler(), CoverageSampler()
        for _ in range(25):
            np.testing.assert_array_equal(js.select(10_007, cov, target),
                                          ts.select(10_007, cov, target))
        assert js.first_chunk == ts.first_chunk


def test_params_and_schedules_match():
    for mp in (JMask(), JMask(end_ratio=0.3), JMask(mask_min_len=10)):
        for sr_len in (100, 150, 250, 37):
            tmp = params_from_fields(MaskParams, dataclasses.asdict(mp))
            assert (dataclasses.asdict(tmp.scaled(sr_len))
                    == dataclasses.asdict(mp.scaled(sr_len)))
    for name, ap in jparams.TASK_PARAMS.items():
        assert (dataclasses.asdict(tparams.TASK_PARAMS[name])
                == dataclasses.asdict(ap))
    assert band_lanes(tparams.BWA_SR) == 96
    assert band_lanes(tparams.BWA_SR_FINISH) == 64
    jcfg = jdriver.PipelineConfig(n_iterations=4, sr_coverage=20.0)
    tcfg = params_from_fields(tdriver.PipelineConfig,
                              dataclasses.asdict(jcfg))
    assert tcfg.hcr_mask_late == MaskParams(end_ratio=0.3)
    for cov in (3.0, 14.0, 30.0, 77.7):
        for fn in ("iteration_consensus_params", "finish_consensus_params"):
            assert (dataclasses.asdict(getattr(tdriver, fn)(tcfg, cov))
                    == dataclasses.asdict(getattr(jdriver, fn)(jcfg, cov)))
    for n in (1, 31, 32, 33, 200, 300):
        assert tdriver.batch_rows(n, 256) == jdriver.batch_rows(n, 256)
    for pad in (500, 1000, 7000, 20000, 33000):
        assert tdriver.bucket_lp(pad, 0.2) == jdriver.bucket_lp(pad, 0.2)


def test_bucketing_and_trim_match():
    g = jsim.random_genome(200_000, seed=8)
    longs, _ = jsim.simulate_long_reads(g, 400_000, seed=9)
    jg = jdriver._bucket_records(longs, 64)
    tg = tdriver._bucket_records(longs, 64)
    assert [(p, [r.id for r in rs]) for p, rs in jg] == \
        [(p, [r.id for r in rs]) for p, rs in tg]
    rng = np.random.default_rng(0)
    jres, tres = [], []
    for r in longs[:20]:
        q = rng.integers(0, 41, len(r)).astype(np.uint8)
        q[:40] = 0
        chim = ([(len(r) // 2, len(r) // 2 + 30, 0.5)]
                if rng.random() < 0.5 else [])
        jr = jengine.ConsensusResult(
            record=type(r)(r.id, r.seq, qual=q), freqs=None, coverage=None,
            cigar="", chimera=chim)
        tr = tengine.ConsensusResult(
            record=SeqRecord(r.id, r.seq, qual=q), freqs=None, coverage=None,
            cigar="", chimera=chim)
        jres.append(jr)
        tres.append(tr)
    assert (_recs(ttrim.trim_records(tres, ttrim.TrimParams()))
            == _recs(jtrim.trim_records(jres, jtrim.TrimParams())))


def test_chimera_geometry_matches():
    rng = np.random.default_rng(1)
    jcns, tcns = JCns(), ConsensusParams()
    for trial in range(10):
        nb = int(rng.integers(25, 80))
        bb = rng.integers(0, 1500, nb).astype(np.float64)
        bb[rng.integers(6, nb - 6, 3)] = 10.0       # low-fill bins
        L = nb * 20
        cover = rng.integers(0, 3, L).astype(np.float64) + (trial % 2)
        assert (tengine.chimera_runs(bb, L, tcns, cover)
                == jengine.chimera_runs(bb, L, jcns, cover))
        ec = rng.integers(0, 3, L).astype(np.uint8)
        jr = jengine.ConsensusResult(record=None, freqs=None, coverage=None,
                                     cigar="", emit_counts=ec)
        tr = tengine.ConsensusResult(record=None, freqs=None, coverage=None,
                                     cigar="", emit_counts=ec)
        np.testing.assert_array_equal(tengine.emit_prefix(tr, L),
                                      jengine.emit_prefix(jr, L))
