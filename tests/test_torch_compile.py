"""The kernel build's own account on the CPU: the compile ledger, the
library cache, the span tracer's compile split and ``--xprof``.

A run on the CPU builds nothing, so the tests that need a build window
inside a run stub the build (``fake_build``: a library file written into
the build directory, no ``nvcc``) and have the run ask for the library.
The JAX package is the oracle through its validators: the port's ledger
passes both packages' ``validate_compile_ledger`` and
``reconcile_compile_ledger``."""

import json
import os
import time
from pathlib import Path

import pytest
import torch

from proovread_tpu.obs import validate as jvalidate
from proovread_tpu_torch.obs import validate as tvalidate

torch.set_num_threads(1)

OUTPUTS = ("untrimmed.fq", "trimmed.fq", "trimmed.fa", "ignored.tsv",
           "chim.tsv")


def stub_build(monkeypatch, build_dir):
    """``kernels.build`` stubbed: a library file (and its ptxas log) in
    the build directory (``build_dir``, never the checkout's), 7 nvcc
    compiles when it was missing; ``load`` returns a handle. Every
    module-level build state is restored with ``monkeypatch``."""
    from proovread_tpu_torch import kernels
    from proovread_tpu_torch.obs import compilecache
    for name, value in (("_lib", None), ("loaded_path", None),
                        ("_build_dir_override", Path(build_dir)),
                        ("nvcc_compiles", 0), ("nvcc_seconds", 0.0),
                        ("build_windows", 0), ("build_window_seconds", 0.0),
                        ("nvcc_source_seconds", {}), ("object_bytes", {})):
        monkeypatch.setattr(kernels, name, value)
    monkeypatch.setattr(compilecache, "_cache_dir", None)

    def build(src_dir=None, out_dir=None):
        out = Path(out_dir or kernels.build_dir())
        so = out / kernels.library_name(kernels.digest())
        if not so.exists():
            time.sleep(0.05)
            out.mkdir(parents=True, exist_ok=True)
            so.write_bytes(b"\x7fELF" + bytes(1000))
            so.with_suffix(".log.json").write_text("{}")
            for i, name in enumerate(kernels.SOURCES):
                kernels.nvcc_source_seconds[name] = 0.01 * (i + 1)
                kernels.object_bytes[name] = 100 * (i + 1)
            kernels.nvcc_compiles += len(kernels.SOURCES)
        return so

    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(kernels, "load", lambda path: "handle")
    return kernels


@pytest.fixture
def fake_build(monkeypatch, tmp_path):
    return stub_build(monkeypatch, tmp_path / "build")


def _inputs(tmp):
    from proovread_tpu_torch.io.fastq import FastqWriter
    from proovread_tpu_torch.io.simulate import (random_genome,
                                                 simulate_long_reads,
                                                 simulate_short_reads)
    genome = random_genome(3000, seed=5)
    longs, _ = simulate_long_reads(genome, total_bases=3000, mean_len=700,
                                   min_len=400, seed=6)
    paths = []
    for name, recs in (("l.fq", longs),
                       ("s.fq", simulate_short_reads(genome, 20.0, seed=7))):
        p = str(tmp / name)
        with FastqWriter(p) as w:
            for r in recs:
                w.write(r)
        paths.append(p)
    cfg = tmp / "c.cfg"
    cfg.write_text(json.dumps({"batch-reads": 8, "device-chunk": 128,
                               "mask-shortcut-frac": 0.0}))
    return ["-l", paths[0], "-s", paths[1], "-m", "sr-noccs", "-c",
            str(cfg), "--device", "cpu", "-q", "--no-checkpoint"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One CLI run without the flags and one with ``--compile-ledger``,
    ``--compile-cache``, ``--trace``, ``--xprof`` and ``--metrics-out``,
    its first HCR call asking for the (stubbed) library, so the build
    window lands inside the run."""
    from proovread_tpu_torch.cli import main
    from proovread_tpu_torch.ops import assemble_kernel as ak
    tmp = tmp_path_factory.mktemp("compile")
    mp = pytest.MonkeyPatch()
    try:
        kernels = stub_build(mp, tmp / "build")
        base = _inputs(tmp)
        assert main(base + ["-p", str(tmp / "a")]) == 0
        plain = ak.hcr_mask_plain

        def hcr(*a):
            kernels.lib()
            return plain(*a)
        mp.setattr(ak, "hcr_mask_plain", hcr)
        art = {k: str(tmp / v) for k, v in (
            ("ledger", "led.jsonl"), ("trace", "t.jsonl"),
            ("cache", "cache"), ("xprof", "xp"), ("metrics", "m.json"))}
        assert main(base + ["-p", str(tmp / "b"),
                            "--compile-ledger", art["ledger"],
                            "--compile-cache", art["cache"],
                            "--trace", art["trace"], "--xprof", art["xprof"],
                            "--metrics-out", art["metrics"]]) == 0
        art["state_after"] = (kernels._build_dir_override,
                              kernels.build_windows)
    finally:
        mp.undo()
    return tmp, art


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_ledger_valid_and_reconciles_in_both_packages(runs, pkg):
    _, art = runs
    v = tvalidate if pkg == "port" else jvalidate
    stats = v.validate_compile_ledger(art["ledger"], min_rows=2)
    assert stats["n_backend_compiles"] == 1
    assert stats["census"]["persistent_misses"] == 1
    assert stats["census"]["calls"] > stats["census"]["n_programs"] >= 4
    rec = v.reconcile_compile_ledger(art["ledger"], art["trace"])
    assert rec["ledger_ms"] >= 50.0
    assert rec["diff_ms"] <= 1.0


def test_flags_change_no_output_byte(runs):
    tmp, art = runs
    for f in OUTPUTS:
        assert (tmp / "a" / f"a.{f}").read_bytes() == \
            (tmp / "b" / f"b.{f}").read_bytes(), f
    # the library's cache dir: the built file, hit or miss marked; the
    # process's build directory is back to what it was before main()
    assert any(p.endswith(".so") for p in os.listdir(art["cache"]))
    assert art["state_after"] == (tmp / "build", 1)


def test_xprof_trace_names_the_spans(runs):
    _, art = runs
    files = os.listdir(art["xprof"])
    assert files == ["b.pt.trace.json"]
    text = open(os.path.join(art["xprof"], files[0])).read()
    trace = json.loads(text)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"run:run", "bucket:bucket", "mode:tasks"} <= names


def test_trace_carries_build_window_and_cost_attribution(runs):
    """The bucket whose HCR call asked for the library carries the build
    window as compile_ms; every split span carries the cost keys; the
    metrics hold the kernel_* counters and the ledger's census gauges,
    valid in both packages."""
    _, art = runs
    events = [json.loads(ln) for ln in open(art["trace"])][1:]
    buckets = [e for e in events if e["cat"] == "bucket"]
    assert sum(e["args"]["compile_ms"] for e in buckets) >= 50.0
    assert all("flops" in e["args"] for e in buckets)
    assert sum(e["args"]["flops"] for e in buckets) > 0
    for v in (tvalidate, jvalidate):
        v.validate_trace(art["trace"], require_attribution=True)
        v.validate_metrics(art["metrics"], require=("kernel_flops_total",
                                                    "kernel_bytes_total"))
    m = json.load(open(art["metrics"]))
    fns = {s["labels"]["fn"]
           for s in m["counters"]["kernel_flops_total"]["series"]}
    assert {"bsw_expand_v2", "pileup_accumulate_bits", "assemble_rows",
            "hcr_mask_rows"} <= fns
    assert m["gauges"]["compile_backend_compiles"]["series"][0]["value"] \
        == 1


def test_ledger_rows_match_the_declared_schema(fake_build, tmp_path):
    """Every row kind the writer emits has exactly LEDGER_ROW_FIELDS, in
    both packages' declarations; a load found built is a hit, a build a
    miss, while a cache dir is set, and null without one."""
    from proovread_tpu_torch.obs import compilecache as cc
    led = cc.Ledger(backend="cpu")
    with cc.scope(led):
        tok = led.call_begin("bsw_expand_v2", cc.signature())
        fake_build.lib()
        led.call_end(tok)
        led.call_end(led.call_begin("bsw_expand_v2", cc.signature()))
    assert [r["kind"] for r in led.rows] == ["backend_compile", "retrace"]
    assert led.rows[0]["persistent_cache"] is None
    assert led.rows[1]["compile_ms"] == led.rows[0]["compile_ms"] > 0
    for fields in (tvalidate.LEDGER_ROW_FIELDS, jvalidate.LEDGER_ROW_FIELDS):
        assert all(set(r) == set(fields) for r in led.rows)
    assert led.census()["tracing_hits"] == 1
    state = cc.cache_state()
    try:
        for want in ("miss", "hit"):
            fake_build._lib = None
            cc.enable_persistent_cache(str(tmp_path / "cache"))
            led = cc.Ledger(backend="cpu")
            with cc.scope(led):
                fake_build.lib()
            assert led.rows[0]["persistent_cache"] == want
            assert led.census()["persistent_hit_rate"] == (
                1.0 if want == "hit" else 0.0)
    finally:
        cc.restore_cache(state)


def test_attributed_wrapper_is_one_read_when_off(monkeypatch):
    """With no ledger and no profiler the wrapper calls straight through
    (no signature, no ledger call), and keeps the wrapped function's name
    and the launch count on itself."""
    from proovread_tpu_torch.obs import compilecache as cc
    from proovread_tpu_torch.obs import profile
    from proovread_tpu_torch.ops import pileup_kernel as pk
    monkeypatch.setattr(cc, "_current", None)
    monkeypatch.setattr(profile, "_current", None)
    monkeypatch.setattr(cc, "signature",
                        lambda: pytest.fail("signature read while off"))
    calls = []

    @profile.attributed("x")
    def fn(a):
        calls.append(a)
        return a
    assert fn(3) == 3 and calls == [3] and fn.__name__ == "fn"
    assert pk.pileup_accumulate_bits.__name__ == "pileup_accumulate_bits"
    assert hasattr(pk.pileup_accumulate_bits, "launches")


def test_tracer_charges_a_build_window_to_open_spans(fake_build):
    from proovread_tpu_torch import obs
    with obs.tracing() as tr:
        with obs.span("bucket", cat="bucket"):
            with obs.span("pass", cat="pass"):
                fake_build.lib()
            with obs.span("other", cat="pass"):
                pass
    by = {e["name"]: e["args"] for e in tr.events}
    assert by["pass"]["compile_ms"] > 0
    assert by["bucket"]["compile_ms"] == by["pass"]["compile_ms"]
    assert by["other"]["compile_ms"] == 0.0
    assert tr.n_compiles == 1


def test_set_build_dir_overrides_and_restores(monkeypatch, tmp_path):
    from proovread_tpu_torch import kernels
    monkeypatch.setattr(kernels, "_build_dir_override", None)
    monkeypatch.setenv("PROOVREAD_TORCH_BUILD_DIR", str(tmp_path / "env"))
    own = kernels.build_dir()
    assert own == tmp_path / "env"
    kernels.set_build_dir(tmp_path)
    assert kernels.build_dir() == tmp_path
    kernels.set_build_dir(None)
    assert kernels.build_dir() == own
