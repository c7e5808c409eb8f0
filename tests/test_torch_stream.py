"""Port parity: the streaming short-read regime (``_SrDevice`` with
``resident=False``) and the ``debug_dir`` dump of the finish pass.

Above ``sr_device_budget`` the short-read set stays in host memory and each
pass uploads the slab of its sampled rows; passes 2..N then run eagerly.
Tolerance: bit-equality everywhere. ``_SrDevice.take`` streaming equals the
resident gather on every selection and caches a full-set upload;
``Pipeline.run`` with ``sr_device_budget=0`` and sampling on equals the JAX
package's streaming run (``run_both``'s comparison: records, reports,
metrics and QC) and the port's resident run, in ``sr`` and ``mr``; the sr
twin also sets ``debug_dir`` on both sides, and the ``admitted.*.sam``
dumps are byte-identical. Those twins keep every pass running; where the
mask shortcut stops the passes inside the span the fused loop would run,
the streamed run still equals the resident one (it draws the fused loop's
samples up front, as the JAX package's resident run does; the JAX
package's own streaming run draws a pass's sample as it starts, so its
finish samples another subset there)."""

import dataclasses

import numpy as np
import pytest
import torch

from proovread_tpu.pipeline.trim import TrimParams as JTrim

from proovread_tpu_torch.io.batch import pack_reads
from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.pipeline.driver import (Pipeline, PipelineConfig,
                                                 _SrDevice)
from proovread_tpu_torch.state import params_from_fields

import test_torch_pipeline as tp
from test_torch_pipeline import (_compare, _port_records, _rec_key,
                                 _uniform_dataset)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_cli.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sr_device(resident):
    """Ten short reads of 60-89 bases, packed as the device engine packs
    them."""
    rng = np.random.default_rng(29)
    srs = []
    for i in range(10):
        n = int(rng.integers(60, 90))
        srs.append(SeqRecord(f"s{i}", "".join(
            "ACGT"[j] for j in rng.integers(0, 4, n)),
            qual=rng.integers(2, 41, n).astype(np.uint8)))
    return _SrDevice(pack_reads(srs, pad_multiple=16), torch.device("cpu"),
                     resident=resident)


@pytest.mark.parametrize("sel", [np.arange(10), np.array([0, 3, 7]),
                                 np.array([9]), np.array([], np.int64),
                                 np.arange(9, -1, -2)],
                         ids=["full", "three", "last", "empty", "reversed"])
def test_streaming_take_equals_resident(sel):
    ds, dr = _sr_device(False), _sr_device(True)
    got, want = ds.take(sel, pad_multiple=8), dr.take(sel, pad_multiple=8)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    if len(sel) != 10:
        # padded with the pad row (zero length, all N) at the end
        n = len(sel)
        assert got[0].shape[0] == max(8, -(-n // 8) * 8)
        assert (got[3][n:] == 0).all() and (got[0][n:] == 4).all()
    assert ds.max_slab_bytes > 0 and dr.max_slab_bytes == 0
    assert ds.stats()["full_set_on_device"] == (len(sel) == 10)


def test_streaming_full_set_take_is_cached():
    dev = _sr_device(False)
    a = dev.take(np.arange(10))
    b = dev.take(np.arange(10))
    for x, y in zip(a, b):
        assert x is y, "a full-set streaming take must reuse its upload"
    c = dev.take(np.array([1, 2]))
    assert c[0] is not a[0]


def _port_cfg(kw, **over):
    """The port's config of the JAX package's ``PipelineConfig(**kw)``."""
    from proovread_tpu.pipeline.driver import PipelineConfig as JConfig
    fields = dataclasses.asdict(JConfig(**{"engine": "device", **kw}))
    return params_from_fields(PipelineConfig,
                              {**fields, "device": "cpu", **over})


@pytest.mark.parametrize("mode", ["sr", "mr"])
def test_streaming_pipeline_matches_jax_and_resident(tmp_path, mode):
    """Sampling on at an explicit coverage of 60x: each pass takes a
    quarter of the set (the finish half), uploaded as one slab."""
    if mode == "sr":
        longs, srs = _uniform_dataset(np.random.default_rng(31), n_sr=120)
    else:
        longs, srs = _uniform_dataset(np.random.default_rng(32), G=1500,
                                      n_long=3, read_len=700, n_sr=60,
                                      sr_len=250)
    kw = dict(mode=mode, n_iterations=3, sampling=True, coverage=60.0,
              batch_reads=8, device_chunk=128, trim=JTrim(min_length=100),
              mask_shortcut_frac=2.0, mask_min_gain_frac=-1.0,
              sr_device_budget=0)
    if mode == "sr":
        (tmp_path / "jax").mkdir()
        (tmp_path / "port").mkdir()
        kw["debug_dir"] = str(tmp_path / "jax")
    from proovread_tpu.pipeline.driver import Pipeline as JPipeline
    from proovread_tpu.pipeline.driver import PipelineConfig as JConfig
    from proovread_tpu.obs import qc as jqc
    from proovread_tpu_torch.obs import qc as tqc

    jcfg = JConfig(**{"engine": "device", **kw})
    tcfg = _port_cfg(kw, **({"debug_dir": str(tmp_path / "port")}
                            if mode == "sr" else {}))
    with jqc.scope() as jrec, tp._no_jax_ledger():
        jres = JPipeline(jcfg).run(longs, srs)
    pipe = Pipeline(tcfg)
    with tqc.scope() as trec:
        tres = pipe.run(_port_records(longs), _port_records(srs))
    assert trec.records == jrec.records
    _compare(jres, tres)
    # every pass uploaded a sampled slab of 512 rows (the pad multiple),
    # never the whole set
    st = pipe.sr_stats
    width = -(-(250 if mode == "mr" else 100) // 16) * 16
    assert st == dict(resident=False, set_bytes=len(srs) * (3 * width + 4),
                      full_set_on_device=False,
                      max_slab_bytes=512 * (3 * width + 4))
    assert [r.task for r in tres.reports] == [
        f"bwa-{mode}-1", f"bwa-{mode}-2", f"bwa-{mode}-3",
        f"bwa-{mode}-finish"]
    assert sum(r.n_admitted for r in tres.reports) > 0

    # the resident run of the same inputs gives the same bits
    rres = Pipeline(_port_cfg(kw, sr_device_budget=2 << 30,
                              debug_dir=None)).run(
        _port_records(longs), _port_records(srs))
    assert _rec_key(rres.untrimmed) == _rec_key(tres.untrimmed)
    assert _rec_key(rres.trimmed) == _rec_key(tres.trimmed)
    assert rres.chimera == tres.chimera

    if mode == "sr":
        jd = sorted(p.name for p in (tmp_path / "jax").iterdir())
        td = sorted(p.name for p in (tmp_path / "port").iterdir())
        assert jd == td and jd and all(n.startswith("admitted.") for n in jd)
        for name in jd:
            a = (tmp_path / "jax" / name).read_bytes()
            assert (tmp_path / "port" / name).read_bytes() == a
            assert len([ln for ln in a.splitlines()
                        if not ln.startswith(b"@")]) > 0


def test_streaming_shortcut_inside_fused_span_matches_resident():
    """Sampling at 60x with the default mask shortcut, which stops the
    passes at pass 3 of 4: the streamed run's records, reports and sampler
    rotation are the resident run's."""
    longs, srs = _uniform_dataset(np.random.default_rng(35), n_sr=200)
    kw = dict(n_iterations=4, sampling=True, coverage=60.0, batch_reads=8,
              device_chunk=128, trim=JTrim(min_length=100))
    runs = {}
    for budget in (2 << 30, 0):
        pipe = Pipeline(_port_cfg(kw, sr_device_budget=budget))
        runs[budget] = (pipe.run(_port_records(longs), _port_records(srs)),
                        pipe.sr_stats)
    (rres, rst), (sres, sst) = runs[2 << 30], runs[0]
    assert rst["resident"] and not sst["resident"]
    assert [r.task for r in sres.reports] == [
        "bwa-sr-1", "bwa-sr-2", "bwa-sr-3", "bwa-sr-finish"]
    assert _rec_key(sres.untrimmed) == _rec_key(rres.untrimmed)
    assert _rec_key(sres.trimmed) == _rec_key(rres.trimmed)
    assert sres.chimera == rres.chimera
    assert ([dataclasses.asdict(r) for r in sres.reports]
            == [dataclasses.asdict(r) for r in rres.reports])
