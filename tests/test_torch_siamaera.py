"""Port parity: ``pipeline/siamaera.py:siamaera_filter`` and the mapper it
runs on (``align/mapper.py:TorchMapper``, the counterpart of
``JaxMapper``).

The six constructions of ``tests/test_siamaera.py`` (a clean read, a joined
palindrome, a read under ``seq_min_len``, two inverted-repeat pairs, a
small terminal inverted repeat, a mixed batch with qualities) go through
both packages on the CPU. Tolerance: records (id, sequence, qual,
description) and ``SiamaeraStats`` equal, and the mapper's alignment
records equal field by field."""

import dataclasses

import numpy as np
import pytest
import torch

from proovread_tpu.io.records import SeqRecord as JRecord
from proovread_tpu.ops.encode import decode_codes, encode_ascii, revcomp_codes
from proovread_tpu.pipeline.siamaera import siamaera_filter as jfilter

from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.pipeline.siamaera import siamaera_filter


def _rand_seq(rng, n):
    return decode_codes(rng.integers(0, 4, n).astype(np.int8))


def _rc(seq: str) -> str:
    return decode_codes(revcomp_codes(encode_ascii(seq)))


def _clean():
    return [JRecord("clean", _rand_seq(np.random.default_rng(0), 800))]


def _joined():
    rng = np.random.default_rng(1)
    arm, junction = _rand_seq(rng, 500), _rand_seq(rng, 40)
    return [JRecord("siam", arm + junction + _rc(arm))]


def _short():
    arm = _rand_seq(np.random.default_rng(2), 60)
    return [JRecord("short", arm + _rc(arm))]


def _inconclusive():
    rng = np.random.default_rng(3)
    a, b = _rand_seq(rng, 400), _rand_seq(rng, 400)
    spacer = _rand_seq(rng, 120)
    return [JRecord("multi", a + _rc(a) + spacer + b + _rc(b))]


def _small_ir():
    rng = np.random.default_rng(4)
    body, hair = _rand_seq(rng, 900), _rand_seq(rng, 120)
    return [JRecord("ir", hair + body + _rc(hair))]


def _mixed():
    rng = np.random.default_rng(5)
    arm = _rand_seq(rng, 400)
    pal = arm + _rand_seq(rng, 30) + _rc(arm)
    clean = _rand_seq(rng, 700)
    q_pal = rng.integers(10, 40, len(pal)).astype(np.uint8)
    return [JRecord("c1", clean, qual=np.full(700, 30, np.uint8)),
            JRecord("p1", pal, qual=q_pal)]


def _key(recs):
    return [(r.id, r.seq, None if r.qual is None else r.qual.tobytes(),
             r.desc) for r in recs]


@pytest.mark.parametrize("make", [_clean, _joined, _short, _inconclusive,
                                  _small_ir, _mixed],
                         ids=lambda f: f.__name__.strip("_"))
def test_siamaera_matches_jax(make):
    recs = make()
    jout, jstats = jfilter(recs)
    tout, tstats = siamaera_filter(
        [SeqRecord(r.id, r.seq, qual=r.qual, desc=r.desc) for r in recs],
        device="cpu")
    assert _key(tout) == _key(jout)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)


def test_mapper_records_match_jax():
    """The mapper under siamaera on the joined palindrome and the mixed
    batch: read windows against the reads' reverse complements."""
    from proovread_tpu.align.mapper import JaxMapper
    from proovread_tpu.align.params import AlignParams as JParams
    from proovread_tpu.io.batch import pack_reads as jpack
    from proovread_tpu_torch.align.mapper import TorchMapper
    from proovread_tpu_torch.align.params import AlignParams
    from proovread_tpu_torch.io.batch import pack_reads

    recs = _joined() + _mixed()
    rcs = [JRecord(f"rc|{r.id}", _rc(r.seq)) for r in recs]
    wins = [JRecord(f"{r.id}|w:{s}", r.seq[s:s + 256])
            for r in recs for s in range(0, len(r) - 32, 224)]
    kw = dict(min_out_score=0.0, score_per_base=False)
    jres = JaxMapper(JParams(**kw), chunk_rows=8).map_batch(
        jpack(rcs), jpack(wins, pad_len=256))
    port = lambda rs: [SeqRecord(r.id, r.seq, qual=r.qual) for r in rs]  # noqa: E731
    tres = TorchMapper(AlignParams(**kw), chunk_rows=8, device="cpu"
                       ).map_batch(pack_reads(port(rcs)),
                                   pack_reads(port(wins), pad_len=256))
    assert (tres.n_candidates, tres.n_passed) == (jres.n_candidates,
                                                  jres.n_passed)
    assert tres.n_candidates > 16                  # several chunks
    for js, ts in zip(jres.alnsets, tres.alnsets):
        assert (js.ref_id, js.ref_len, len(js.alns)) == (
            ts.ref_id, ts.ref_len, len(ts.alns))
        for a, b in zip(js.alns, ts.alns):
            for f in ("qname", "pos0", "score", "flag", "span"):
                assert getattr(a, f) == getattr(b, f), f
            for f in ("seq_codes", "ops", "lens", "qual"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_siamaera_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    recs = [SeqRecord(r.id, r.seq) for r in _joined()]
    with pytest.raises(RuntimeError, match="is_available"):
        siamaera_filter(recs)
