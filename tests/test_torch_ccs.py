"""Port parity: the ``ccs-1`` subread consensus (``pipeline/ccs.py``).

The same seeded subread sets go through ``proovread_tpu.pipeline.ccs`` and
the port's module on the CPU: ``zmw_of`` and ``is_subread_set``; then
``ccs_correct`` on ZMWs of one to four subreads of alternating strand,
interleaved in input order (the reference subread of a pair is the longer,
of more the second), with the ``min_subreads`` gate at 2 and at 3, under a
QC recorder; and the raise on an id that is not a subread's. Windows of
128 with an overlap of 32 keep the JAX side's XLA ``sw_batch`` at m = 128.
Tolerance: records (id, sequence, phreds, description), ``CcsStats`` and
the QC records equal."""

import dataclasses

import numpy as np
import pytest
import torch

from proovread_tpu.io.records import SeqRecord as JRecord
from proovread_tpu.obs import qc as jqc
from proovread_tpu.pipeline import ccs as jccs

from proovread_tpu_torch.obs import qc as tqc
from proovread_tpu_torch.pipeline import ccs as tccs

from test_torch_pipeline import _port_records, _rec_key

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


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _noisy(rng, true: str, err: float) -> str:
    """CLR-like copy: insertions, deletions and substitutions at ``err``."""
    out = []
    for c in true:
        u = rng.random()
        if u < err * 0.3:
            continue
        if u < err * 0.5:
            out.append(BASES[int(rng.integers(0, 4))])
        out.append(BASES[int(rng.integers(0, 4))] if err * 0.8 < u < err
                   else c)
    return "".join(out)


def _subreads(seed=31):
    """ZMWs 10 (1 subread), 11 (2), 12 (3), 13 (4) and 14 (2), subreads
    alternating strand, records interleaved across ZMWs, phreds drawn
    per base."""
    rng = np.random.default_rng(seed)
    zmws = []
    for hole, n_subs, L in ((10, 1, 420), (11, 2, 520), (12, 3, 480),
                            (13, 4, 560), (14, 2, 300)):
        true = "".join(BASES[i] for i in rng.integers(0, 4, L))
        recs, pos = [], 0
        for k in range(n_subs):
            seq = _noisy(rng, true if k % 2 == 0 else _revcomp(true), 0.1)
            recs.append(JRecord(
                f"m140_7/{hole}/{pos}_{pos + len(seq)}", seq,
                qual=rng.integers(6, 16, len(seq)).astype(np.uint8)))
            pos += len(seq) + 40
        zmws.append(recs)
    out = []
    for k in range(4):
        out += [z[k] for z in zmws if k < len(z)]
    return out


def test_zmw_parsing_matches_jax():
    ids = ["m1305_2/4500/0_1000", "m1305_2/4500/1100_2000", "read_17",
           "m9/1", "m9/1/0_5/extra", "x/m9/1/0_5"]
    assert [tccs.zmw_of(i) for i in ids] == [jccs.zmw_of(i) for i in ids]
    subs = [JRecord("m1/1/0_5", "ACGTA"), JRecord("m1/2/0_5", "ACGTA")]
    for recs in (subs, subs + [JRecord("plain", "ACGT")], []):
        assert (tccs.is_subread_set(_port_records(recs))
                == jccs.is_subread_set(recs))


@pytest.mark.parametrize("min_subreads", [2, 3])
def test_ccs_correct_matches_jax(min_subreads):
    recs = _subreads()
    kw = dict(window=128, overlap=32, min_subreads=min_subreads)
    with jqc.scope() as jrec:
        jout, jst = jccs.ccs_correct(recs, **kw)
    with tqc.scope() as trec:
        tout, tst = tccs.ccs_correct(_port_records(recs), device="cpu", **kw)
    assert _rec_key(tout) == _rec_key(jout)
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert trec.records == jrec.records
    primary = [r for r in tout if r.desc == "CCS:primary"]
    if min_subreads == 2:
        assert (tst.primary, tst.single, tst.secondary) == (4, 1, 7)
        # the reference subread of a pair is the longer one, of more the
        # second; each consensus changed it
        by_id = {r.id: r for r in recs}
        assert [r.id.split("/")[1] for r in primary] == ["11", "12", "13",
                                                         "14"]
        for r in primary:
            assert r.seq != by_id[r.id].seq
        pair = [r for r in recs if r.id.startswith("m140_7/11/")]
        assert primary[0].id == max(pair, key=len).id
    else:
        assert (tst.primary, tst.single) == (2, 5)
        assert len(tout) == 7


def test_ccs_correct_raises_on_non_subread_ids():
    recs = _port_records(_subreads()[:3]) + _port_records(
        [JRecord("plain_read", "ACGT" * 40)])
    with pytest.raises(ValueError, match="not a PacBio subread id"):
        tccs.ccs_correct(recs, device="cpu")
