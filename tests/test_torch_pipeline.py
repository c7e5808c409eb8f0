"""Port parity: ``Pipeline.run`` end to end (device engine, sr mode).

The same seeded workload runs through the JAX package (``engine="device"``,
Pallas kernels in interpret mode) and the port on the CPU. Tolerance: the
untrimmed and trimmed records (id, sequence, qual, description), the
ignored and chimera lists and every TaskReport must be identical."""

import dataclasses

import numpy as np
import pytest

from proovread_tpu.pipeline.driver import Pipeline as JPipeline
from proovread_tpu.pipeline.driver import PipelineConfig as JConfig
from proovread_tpu.pipeline.trim import TrimParams as JTrim

from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
from proovread_tpu_torch.state import params_from_fields


def _uniform_dataset(rng, G=600, n_long=6, read_len=300, n_sr=45,
                     lr_err=0.08):
    """tests/test_qc.py's construction: uniform read lengths, 8% CLR-like
    long-read errors, error-free 100 bp short reads on both strands."""
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
        st = int(rng.integers(0, G - 100))
        seq = genome[st:st + 100].copy()
        if rng.random() < 0.5:
            seq = revcomp_codes(seq)
        srs.append(JRecord(f"s{i}", decode_codes(seq),
                           qual=np.full(100, 30, np.uint8)))
    return longs, srs


def _port_records(recs):
    return [SeqRecord(r.id, r.seq, qual=r.qual, desc=r.desc) for r in recs]


def _rec_key(recs):
    return [(r.id, r.seq, None if r.qual is None else r.qual.tobytes(),
             r.desc) for r in recs]


def _compare(jres, tres):
    assert _rec_key(tres.untrimmed) == _rec_key(jres.untrimmed)
    assert _rec_key(tres.trimmed) == _rec_key(jres.trimmed)
    assert tres.ignored == jres.ignored
    assert tres.chimera == jres.chimera
    assert ([dataclasses.asdict(r) for r in tres.reports]
            == [dataclasses.asdict(r) for r in jres.reports])


def run_both(longs, srs, **kw):
    jcfg = JConfig(mode="sr", engine="device", **kw)
    jres = JPipeline(jcfg).run(longs, srs)
    fields = dataclasses.asdict(jcfg)
    tcfg = params_from_fields(PipelineConfig, {**fields, "device": "cpu"})
    tres = Pipeline(tcfg).run(_port_records(longs), _port_records(srs))
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
