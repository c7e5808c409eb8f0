"""Port parity: ``Pipeline.run`` end to end (device engine, sr mode).

The same seeded workload runs through the JAX package (``engine="device"``,
Pallas kernels in interpret mode) and the port on the CPU. Tolerance: the
untrimmed and trimmed records (id, sequence, qual, description), the
ignored and chimera lists and every TaskReport must be identical;
``result.metrics`` equal but for two fields (the values of
``bucket_seconds``, which are timings, and the ``jax_retraces`` series,
which the port never counts); and, with a QC recorder installed on both
sides, every per-read QC record and ``result.qc`` equal."""

import contextlib
import dataclasses

import numpy as np
import pytest

from proovread_tpu.obs import qc as jqc
from proovread_tpu.pipeline.driver import Pipeline as JPipeline
from proovread_tpu.pipeline.driver import PipelineConfig as JConfig
from proovread_tpu.pipeline.trim import TrimParams as JTrim

from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.obs import qc as tqc
from proovread_tpu_torch.obs.metrics import without_timings
from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
from proovread_tpu_torch.state import params_from_fields


def _uniform_dataset(rng, G=600, n_long=6, read_len=300, n_sr=45,
                     lr_err=0.08, sr_len=100):
    """tests/test_qc.py's construction: uniform read lengths, 8% CLR-like
    long-read errors, error-free ``sr_len`` bp short reads on both
    strands."""
    from proovread_tpu.io.records import SeqRecord as JRecord
    from proovread_tpu.ops.encode import decode_codes, revcomp_codes
    genome = rng.integers(0, 4, G).astype(np.int8)
    longs = []
    for i in range(n_long):
        a = int(rng.integers(0, G - read_len))
        noisy = []
        for base in genome[a:a + read_len]:
            u = rng.random()
            if u < lr_err * 0.5:
                noisy.append(int(rng.integers(0, 4)))
                noisy.append(int(base))
            elif u < lr_err * 0.75:
                continue
            elif u < lr_err:
                noisy.append(int((base + 1) % 4))
            else:
                noisy.append(int(base))
        longs.append(JRecord(f"r{i}", decode_codes(np.array(noisy, np.int8))))
    srs = []
    for i in range(n_sr):
        st = int(rng.integers(0, G - sr_len))
        seq = genome[st:st + sr_len].copy()
        if rng.random() < 0.5:
            seq = revcomp_codes(seq)
        srs.append(JRecord(f"s{i}", decode_codes(seq),
                           qual=np.full(sr_len, 30, np.uint8)))
    return longs, srs


def _port_records(recs):
    return [SeqRecord(r.id, r.seq, qual=r.qual, desc=r.desc) for r in recs]


def _rec_key(recs):
    return [(r.id, r.seq, None if r.qual is None else r.qual.tobytes(),
             r.desc) for r in recs]


def comparable_metrics(metrics):
    """A metrics dump without its two fields that may differ: the values
    of ``bucket_seconds`` (timings; their counts stay) and the
    ``jax_retraces`` series (0 in the port)."""
    m = without_timings(metrics)
    m["counters"]["jax_retraces"]["series"] = []
    return m


def _compare(jres, tres):
    assert _rec_key(tres.untrimmed) == _rec_key(jres.untrimmed)
    assert _rec_key(tres.trimmed) == _rec_key(jres.trimmed)
    assert tres.ignored == jres.ignored
    assert tres.chimera == jres.chimera
    assert ([dataclasses.asdict(r) for r in tres.reports]
            == [dataclasses.asdict(r) for r in jres.reports])
    assert comparable_metrics(tres.metrics) == comparable_metrics(
        jres.metrics)
    assert tres.qc == jres.qc


@contextlib.contextmanager
def _no_jax_ledger():
    """The JAX package's compile ledger off for the block. The port has
    none (its ``compile_*`` and ``cache_*`` gauges stay at 0), and a ledger
    that another test left installed in this process (a server that was
    never drained) would fill the JAX side's."""
    from proovread_tpu.obs import compilecache as jcc
    led = jcc.current()
    jcc.uninstall()
    try:
        yield
    finally:
        if led is not None:
            jcc.install(led)


def run_both(longs, srs, mode="sr", qc=True, **kw):
    """Both pipelines on the same inputs, each under its own QC recorder
    when ``qc``; returns (JAX result, port result), after holding the two
    recorders' per-read records equal."""
    jcfg = JConfig(mode=mode, engine="device", **kw)
    fields = dataclasses.asdict(jcfg)
    tcfg = params_from_fields(PipelineConfig, {**fields, "device": "cpu"})
    recs = {}
    for name, run, mod, args in (
            ("jax", JPipeline(jcfg).run, jqc, (longs, srs)),
            ("port", Pipeline(tcfg).run, tqc,
             (_port_records(longs), _port_records(srs)))):
        with (mod.scope() if qc else contextlib.nullcontext()) as rec, \
                _no_jax_ledger():
            recs[name] = (run(*args), rec)
    (jres, jrec), (tres, trec) = recs["jax"], recs["port"]
    if qc:
        assert trec.records == jrec.records
        assert tres.qc is not None and len(trec.records) == len(longs)
    else:
        assert tres.qc is None and jres.qc is None
    return jres, tres


@pytest.mark.parametrize("seed,shortcut", [(11, False), (12, True)])
def test_pipeline_matches_jax(seed, shortcut):
    longs, srs = _uniform_dataset(np.random.default_rng(seed))
    kw = dict(n_iterations=3, sampling=False, batch_reads=8,
              device_chunk=128, trim=JTrim(min_length=100))
    if not shortcut:
        # keep every pass running so pass 1, both fused passes and the
        # finish all execute
        kw.update(mask_shortcut_frac=2.0, mask_min_gain_frac=-1.0)
    jres, tres = run_both(longs, srs, **kw)
    _compare(jres, tres)
    tasks = [r.task for r in tres.reports]
    assert tasks[0] == "bwa-sr-1" and tasks[-1] == "bwa-sr-finish"
    if not shortcut:
        assert tasks == ["bwa-sr-1", "bwa-sr-2", "bwa-sr-3", "bwa-sr-finish"]
    assert sum(r.n_admitted for r in tres.reports) > 0


def test_pipeline_high_coverage_matches_jax(monkeypatch):
    """coverage 400: max_coverage 300 on every pass, so 2*300+2 > 256 votes
    per lane and every pass takes the f32 packed-word pileup kernel."""
    from proovread_tpu_torch.ops import pileup_kernel as tpk
    longs, srs = _uniform_dataset(np.random.default_rng(13))
    kw = dict(n_iterations=3, sampling=False, batch_reads=8,
              device_chunk=128, trim=JTrim(min_length=100), coverage=400.0,
              sr_coverage=400.0, finish_coverage=400.0,
              mask_shortcut_frac=2.0, mask_min_gain_frac=-1.0)
    calls = {"bits": 0, "packed": 0}

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped
    monkeypatch.setattr(tpk, "pileup_accumulate_bits_plain",
                        count("bits", tpk.pileup_accumulate_bits_plain))
    monkeypatch.setattr(tpk, "pileup_accumulate_packed_plain",
                        count("packed", tpk.pileup_accumulate_packed_plain))
    jres, tres = run_both(longs, srs, qc=False, **kw)
    _compare(jres, tres)
    assert [r.task for r in tres.reports] == [
        "bwa-sr-1", "bwa-sr-2", "bwa-sr-3", "bwa-sr-finish"]
    assert sum(r.n_admitted for r in tres.reports) > 0
    assert calls["packed"] >= 4 and calls["bits"] == 0


def test_pipeline_mr_matches_jax():
    """mode="mr" with 250 bp short reads: queries pad to m = 256, pass 1
    runs BWA_MR_1, passes 2..3 BWA_MR (k = 13) and the finish BWA_MR_FINISH
    (k = 19, wrapped to 32 bits)."""
    longs, srs = _uniform_dataset(np.random.default_rng(14), G=1500,
                                  n_long=4, read_len=700, n_sr=40,
                                  sr_len=250)
    jres, tres = run_both(longs, srs, mode="mr", n_iterations=3,
                          sampling=False, batch_reads=8, device_chunk=128,
                          trim=JTrim(min_length=100),
                          mask_shortcut_frac=2.0, mask_min_gain_frac=-1.0)
    _compare(jres, tres)
    assert [r.task for r in tres.reports] == [
        "bwa-mr-1", "bwa-mr-2", "bwa-mr-3", "bwa-mr-finish"]
    # pass 1 and the finish see unmasked reads; passes 2-3 seed only
    # what HCR masking left
    assert tres.reports[0].n_admitted > 0 and tres.reports[-1].n_admitted > 0
    assert sum(r.n_candidates for r in tres.reports[1:3]) > 0


@pytest.mark.slow
def test_pipeline_matches_jax_config4():
    """bench config 4's workload (10 kb genome, 40 kb of long reads, 30x
    short reads, 4 iterations)."""
    from proovread_tpu.io.simulate import (random_genome, simulate_long_reads,
                                           simulate_short_reads)
    genome = random_genome(10_000, seed=0)
    longs, _ = simulate_long_reads(genome, 40_000, seed=1)
    srs = simulate_short_reads(genome, 30.0, seed=2)
    jres, tres = run_both(longs, srs, n_iterations=4)
    _compare(jres, tres)
