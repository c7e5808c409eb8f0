"""Port parity: unitig correction (``pipeline/utg.py``, the ``utg`` task).

The same seeded inputs go through ``proovread_tpu.pipeline.utg`` and the
port's module on the CPU at the JAX test's ``small_cfg`` (``utg-window``
256, ``utg-overlap`` 32): three 10%-error long reads over a 2.4 kb genome,
unitigs tiling it with overlaps, 0.1% substitutions and one duplicated
(so contained alignments and the rep-coverage windows come into play).
``utg_correct``'s records and ``TaskReport``; ``run_tasks`` in
``utg-noccs`` (the utg-only output: untrimmed, trimmed, reports, metrics);
the missing-unitigs ``ValueError``. Tolerance: records, reports and
metrics equal (the metrics but for timings)."""

import dataclasses

import numpy as np
import pytest
import torch

from proovread_tpu.config import Config as JConfig
from proovread_tpu.io.records import SeqRecord as JRecord
from proovread_tpu.pipeline import tasks as jtasks
from proovread_tpu.pipeline import utg as jutg

from proovread_tpu_torch.config import Config
from proovread_tpu_torch.pipeline import tasks as ttasks
from proovread_tpu_torch.pipeline import utg as tutg

from test_torch_pipeline import _port_records, _rec_key, comparable_metrics

BASES = "ACGT"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on a few cores, and torch's CPU kernels in each spreading over
    every core slow all of them down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    small = {"utg-window": 256, "utg-overlap": 32}
    jc, tc = JConfig(), Config()
    jc.update(small)
    tc.update(small)
    return jc, tc


def _mk(rng, glen=2400, n_longs=3, err=0.10):
    """``tests/test_utg.py:_mk`` with assembly errors in the unitigs and
    the second unitig given twice."""
    genome = "".join(BASES[i] for i in rng.integers(0, 4, glen))
    longs = []
    for i in range(n_longs):
        st = int(rng.integers(0, glen - 1000))
        seq = []
        for c in genome[st:st + 1000]:
            u = rng.random()
            if u < err * 0.3:
                continue
            if u < err * 0.5:
                seq.append(BASES[int(rng.integers(0, 4))])
            seq.append(BASES[int(rng.integers(0, 4))] if u > err * 0.8
                       and u < err else c)
        longs.append(JRecord(f"lr{i}", "".join(seq),
                             qual=np.full(len(seq), 5, np.uint8)))
    utgs = []
    for k in range((glen - 300) // 700):
        frag = list(genome[k * 700: k * 700 + 1000])
        for p in np.flatnonzero(rng.random(len(frag)) < 0.001):
            frag[p] = BASES[(BASES.index(frag[p]) + 1) % 4]
        utgs.append(JRecord(f"utg{k}", "".join(frag)))
    utgs.append(JRecord("utg1dup", utgs[1].seq))
    return longs, utgs


def test_utg_correct_matches_jax():
    longs, utgs = _mk(np.random.default_rng(11))
    jc, tc = _cfgs()
    jout, jrep = jutg.utg_correct(jc, longs, utgs)
    tout, trep = tutg.utg_correct(tc, _port_records(longs),
                                  _port_records(utgs), device="cpu")
    assert _rec_key(tout) == _rec_key(jout)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert trep.n_candidates > trep.n_admitted > 0
    assert all(a.seq != b.seq for a, b in zip(tout, longs))


def test_utg_only_mode_matches_jax():
    longs, utgs = _mk(np.random.default_rng(13), n_longs=2)
    jc, tc = _cfgs()
    tasks = jc.tasks("utg-noccs")
    assert tasks == tc.tasks("utg-noccs") == ["read-long", "utg"]
    jres = jtasks.run_tasks(jc, "utg-noccs", tasks, longs, [], utgs)
    tres = ttasks.run_tasks(tc, "utg-noccs", tasks, _port_records(longs), [],
                            _port_records(utgs), device="cpu")
    assert _rec_key(tres.untrimmed) == _rec_key(jres.untrimmed)
    assert _rec_key(tres.trimmed) == _rec_key(jres.trimmed)
    assert tres.ignored == jres.ignored and tres.chimera == jres.chimera
    assert ([dataclasses.asdict(r) for r in tres.reports]
            == [dataclasses.asdict(r) for r in jres.reports])
    assert [r.task for r in tres.reports] == ["utg"]
    assert comparable_metrics(tres.metrics) == comparable_metrics(
        jres.metrics)


def test_utg_requires_unitigs():
    _, tc = _cfgs()
    with pytest.raises(ValueError, match="unitigs"):
        ttasks.run_tasks(tc, "utg-noccs", tc.tasks("utg-noccs"),
                         _port_records([JRecord("x", "ACGT" * 100)]), [], [],
                         device="cpu")
