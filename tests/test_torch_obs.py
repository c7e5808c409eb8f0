"""Port parity: the metrics registry, the span tracer and the memory
telemetry (``obs/{metrics,trace,memory}.py``).

The same call sequences go to the JAX package's ``obs`` modules and the
port's. Tolerance: ``as_dict()`` dumps and files equal; the port's trace
file passes the JAX package's ``obs/validate.py:validate_trace`` with 95%
of the root span covered by its children; every QC record's
``bucket_span`` of a traced pipeline run names a bucket span of the
trace. On the CPU the memory telemetry reads 0, as the reference's does
on a backend without memory stats."""

import json

import numpy as np
import pytest
import torch

from proovread_tpu.obs import metrics as jm
from proovread_tpu.obs.validate import validate_metrics, validate_trace

from proovread_tpu_torch import obs
from proovread_tpu_torch.obs import memory as tmem
from proovread_tpu_torch.obs import metrics as tm
from proovread_tpu_torch.obs import trace as ttrace


def _calls(mod):
    """One call sequence over every metric kind, label sets and the
    snapshot/restore rollback."""
    reg = mod.MetricsRegistry()
    reg.counter("candidates_total", "candidates", "probed").inc(5)
    reg.counter("candidates_total").inc(7)
    reg.counter("task_runs", "passes").inc(1, task="bwa-sr-1")
    reg.counter("task_runs").inc(2, task="bwa-sr-finish")
    reg.gauge("n_buckets", "buckets").set(3)
    reg.gauge("qc_reads", "", "QC funnel: reads").set(12)
    h = reg.histogram("bucket_seconds", "s", "wall")
    for v in (0.5, 0.25, 1.75):
        h.observe(v)
    h.observe(2.0, bucket=1)
    snap = reg.snapshot()
    reg.counter("candidates_total").inc(100)
    reg.counter("late", "x").inc()
    reg.restore(snap)
    assert reg.counter("candidates_total").value() == 12
    with pytest.raises(TypeError):
        reg.gauge("candidates_total")
    return reg


def test_metrics_registry_matches_jax(tmp_path):
    j, t = _calls(jm), _calls(tm)
    assert t.as_dict() == j.as_dict()
    j.dump(str(tmp_path / "j.json"))
    t.dump(str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    validate_metrics(str(tmp_path / "t.json"), require=["candidates_total"])
    assert tm.SCHEMA_VERSION == jm.SCHEMA_VERSION


def test_without_timings_blanks_only_timing_values():
    """Two registries of the same work that differ only in their wall
    times compare equal after ``without_timings``; the counts stay, and
    the dump it was given is left as it was."""
    a, b = _calls(tm).as_dict(), _calls(tm).as_dict()
    b["histograms"]["bucket_seconds"]["series"][0]["sum"] += 1.0
    assert a != b
    assert tm.without_timings(a) == tm.without_timings(b)
    series = tm.without_timings(a)["histograms"]["bucket_seconds"]["series"]
    assert [(x["count"], x["sum"], x["min"], x["max"]) for x in series] \
        == [(3, None, None, None), (1, None, None, None)]
    assert a["histograms"]["bucket_seconds"]["series"][0]["sum"] is not None
    assert tm.without_timings(a)["counters"] == a["counters"]


def test_metrics_module_helpers_match_jax():
    """The module helpers are no-ops without a registry, write to the
    installed one, and ``scope`` reuses it or installs a fresh one for its
    thread."""
    out = {}
    for name, mod in (("jax", jm), ("port", tm)):
        mod.counter("x").inc(3)                       # no registry: no-op
        assert mod.current() is None and mod.counter("x").value() == 0
        reg = mod.install()
        try:
            mod.counter("x", "u").inc(3, a=1)
            mod.gauge("g").set(2.5)
            mod.histogram("h").observe(4)
            with mod.scope() as r:
                assert r is reg
            with mod.scope(mod.MetricsRegistry()) as r2:
                mod.counter("inner").inc()
                assert mod.current() is r2
            assert mod.current() is reg
        finally:
            mod.uninstall()
        out[name] = (reg.as_dict(), r2.as_dict())
    assert out["port"] == out["jax"]


def test_trace_spans_and_chrome_file(tmp_path):
    with obs.tracing() as t:
        with obs.span("run", cat="run"):
            with obs.span("read", cat="io") as sp:
                sp.set(n=3)
            with obs.span("bucket", cat="bucket", bucket=0) as b:
                with obs.span("bwa-sr-1", cat="pass", bucket=0) as p:
                    p.fence(torch.ones(3))            # CPU: nothing to sync
    assert obs.current_tracer() is None
    names = [(e["name"], e["args"]["depth"]) for e in t.events]
    assert names == [("read", 1), ("bwa-sr-1", 2), ("bucket", 1),
                     ("run", 0)]
    ev = {e["name"]: e for e in t.events}
    assert ev["bucket"]["args"]["span_id"] == b.span_id
    assert ev["bucket"]["args"]["compile_ms"] == 0.0
    assert ev["read"]["args"]["n"] == 3 and "compile_ms" not in \
        ev["read"]["args"]
    path = str(tmp_path / "t.jsonl")
    t.write_chrome(path)
    stats = validate_trace(path)
    assert stats["root"] == "run" and stats["n_buckets"] == 1
    lines = t.summary_lines()
    assert lines[1].startswith("run") and len(lines) == 5
    assert lines[2].split()[-2:] == ["0.000", lines[2].split()[-3]]


def test_span_off_is_the_shared_noop():
    assert obs.span("x", cat="pass") is obs.NOOP_SPAN
    x = torch.zeros(2)
    assert obs.NOOP_SPAN.fence(x) is x


def test_fence_syncs_only_cuda_devices(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.append(dev))
    ttrace._fence((torch.zeros(2), {"a": [torch.ones(1)]}, None, 3))
    assert calls == []
    assert ttrace._cuda_devices((torch.zeros(1),), set()) == set()


def test_memory_telemetry_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmem.live_bytes() == 0
    assert tmem.device_memory_stats() is None
    sampler = tmem.install()
    try:
        with tm.scope() as reg, obs.tracing() as t:
            with obs.span("bucket", cat="bucket", bucket=0):
                with obs.span("p", cat="pass"):
                    pass
    finally:
        tmem.uninstall()
    assert sampler.n_samples == 2
    assert all(e["args"]["live_bytes"] == 0
               and e["args"]["peak_live_bytes"] == 0 for e in t.events)
    d = reg.as_dict()["gauges"]
    assert d["peak_live_bytes"]["series"][0]["value"] == 0
    assert d["bucket_peak_live_bytes"]["series"][0]["labels"] == {
        "bucket": "0"}


def test_leak_check_counts_new_cuda_tensors_only(monkeypatch):
    """On the CPU there is no CUDA tensor; a stand-in for one proves the
    check reports what appeared after its baseline and nothing else."""
    kept = [torch.zeros(4)]
    monkeypatch.setattr(tmem, "_cuda_tensors", lambda: list(kept))
    lc = tmem.LeakCheck()
    assert lc.report() == {"n_leaked": 0, "leaked_bytes": 0, "examples": []}
    kept.append(torch.zeros((2, 8), dtype=torch.int64))
    rep = lc.report()
    assert rep["n_leaked"] == 1 and rep["leaked_bytes"] == 128
    assert rep["examples"] == ["torch.int64[2, 8]=128B"]
    assert tmem.LeakCheck().report()["n_leaked"] == 0


def test_traced_pipeline_links_qc_records_to_bucket_spans(tmp_path):
    """A traced ``Pipeline.run`` with QC on: bucket and pass spans in the
    tree, one bucket span per length bucket, each read's QC
    ``bucket_span`` the span id of its bucket."""
    from proovread_tpu_torch.io.records import SeqRecord
    from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
    from proovread_tpu_torch.pipeline.trim import TrimParams
    rng = np.random.default_rng(5)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
    longs = [SeqRecord(f"r{i}", g[s:s + n]) for i, (s, n) in
             enumerate(((0, 300), (500, 350), (900, 1300), (1000, 1500)))]
    srs = [SeqRecord(f"s{i}", g[s:s + 100], qual=np.full(100, 30, np.uint8))
           for i, s in enumerate(rng.integers(0, 2900, 200))]
    with obs.tracing() as t, obs.qc.scope() as rec:
        res = Pipeline(PipelineConfig(
            n_iterations=2, sampling=False, batch_reads=8, device_chunk=128,
            trim=TrimParams(min_length=100), device="cpu")).run(longs, srs)
    path = str(tmp_path / "t.jsonl")
    t.write_chrome(path)
    stats = validate_trace(path, min_coverage=0.95)
    assert stats["root"] == "pipeline" and stats["n_buckets"] == 2
    buckets = {e["args"]["span_id"]: e["args"]["bucket"] for e in t.events
               if e["cat"] == "bucket"}
    assert {r["bucket_span"] for r in rec.records.values()} == set(buckets)
    for r in rec.records.values():
        assert buckets[r["bucket_span"]] == r["bucket"]
    cats = {e["cat"] for e in t.events}
    assert {"task", "bucket", "pass", "kernel", "host"} <= cats
    assert res.qc["n_reads"] == 4
    assert json.loads(json.dumps(res.metrics))["gauges"]["n_buckets"][
        "series"][0]["value"] == 2
