"""Port parity: the artifact validators (``obs/validate.py``).

Every validator of the port is called beside the JAX package's on the
same artifact, and the two verdicts must be equal: the same summary on a
pass, or the same exception type and message on a failure. The artifacts
are ones both packages write (a trace, a metrics dump, a QC artifact, a
truth sidecar, an SLO artifact), the LOAD, mesh-metric, compile-ledger,
manifest and boot rows built as the JAX package's own tests build them,
and one mutated copy for each required key and each type rule, as cases
of one parametrised test. The port's ``validate`` command line exits as
the reference's does, with the same output."""

import copy
import json

import pytest
import torch

from proovread_tpu.obs import metrics as jm
from proovread_tpu.obs import qc as jqc
from proovread_tpu.obs import trace as jtrace
from proovread_tpu.obs import validate as jv
from proovread_tpu.obs.compilecache import Ledger
from proovread_tpu.pipeline import driver as jdriver

from proovread_tpu_torch.io.simulate import (random_genome,
                                             simulate_long_reads,
                                             write_truth_sidecar)
from proovread_tpu_torch.obs import metrics as tm
from proovread_tpu_torch.obs import qc as tqc
from proovread_tpu_torch.obs import trace as ttrace
from proovread_tpu_torch.obs import validate as tv
from proovread_tpu_torch.pipeline import driver as tdriver

from test_compilecache import _drive_all_writer_paths
from test_torch_obs import _calls
from test_torch_qc import _drive


def verdict(fn, *args, **kw):
    """("ok", summary) or (exception type name, message)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:                              # noqa: BLE001
        return (type(e).__name__, str(e))


def same_verdict(name, *args, **kw):
    """The port's and the reference's ``name`` on the same arguments."""
    got = verdict(getattr(tv, name), *args, **kw)
    want = verdict(getattr(jv, name), *args, **kw)
    assert got == want
    return got


# --------------------------------------------------------------------------
# the artifacts
# --------------------------------------------------------------------------

def _trace(obs_mod, tracer_mod, path):
    """A run / io / bucket / pass span tree written by ``tracer_mod``."""
    with obs_mod.tracing() as t:
        with obs_mod.span("run", cat="run"):
            with obs_mod.span("read", cat="io") as sp:
                sp.set(n=3)
            with obs_mod.span("bucket", cat="bucket", bucket=0):
                with obs_mod.span("bwa-sr-1", cat="pass", bucket=0):
                    pass
    assert isinstance(t, tracer_mod.Tracer)
    t.write_chrome(path)
    return path


def _slo(server_mod, config_mod, pcfg, tmp, name):
    """An SLO artifact of a server that accepted two jobs and rejected
    three submissions (no wave run: the accepted jobs stay journaled)."""
    from proovread_tpu_torch.io.records import SeqRecord
    from proovread_tpu_torch.serve.protocol import encode_record
    srv = server_mod.CorrectionServer(
        [SeqRecord("s0", "ACGT" * 25)],
        server_mod.ServeConfig(state_dir=str(tmp / name),
                               quota=config_mod(max_jobs=1)), pcfg)
    reads = [encode_record(SeqRecord(f"{name}/r{i}", "ACGT" * 100))
             for i in range(3)]
    for job, tenant, rd in (("a", "t1", reads[:1]), ("b", "t2", reads[1:2]),
                            ("c", "t1", reads[2:]), ("a", "t1", reads[2:]),
                            ("d", "t3", [])):
        srv.handle({"op": "submit", "job_id": job, "tenant": tenant,
                    "reads": rd})
    path = str(tmp / f"{name}.slo.json")
    srv.write_slo(path)
    if hasattr(srv, "_release_ledger"):
        srv._release_ledger()
    return path


def _load_row(**over):
    """A minimal internally-consistent 2-replica LOAD row: one death,
    two handoffs, every identity holding (the JAX package's
    ``tests/test_fleet.py`` row)."""
    row = {
        "load_schema": 1, "scenario": "slam", "n_replicas": 2,
        "backend": "cuda", "wall_s": 10.0, "bases_per_sec_fleet": 500.0,
        "jobs": {"routed": 8, "rejected": 3, "rejected_fleet": 0,
                 "handoffs": 2, "orphaned": 0, "accepted": 10,
                 "completed": 8, "failed": 0, "cancelled": 0,
                 "expired": 0, "journaled": 2},
        "rejections": {"bad-request": 2, "parse-error": 1},
        "latency": {
            "512": {"count": 5, "p50_s": 1.0, "p99_s": 2.0,
                    "max_s": 2.5},
            "1024": {"count": 3, "p50_s": 2.0, "p99_s": 4.0,
                     "max_s": 4.5}},
        "queue": {"depth_peak": 3, "depth_final": 0},
        "demotions": {},
        "accuracy": {"clr": {"n_scored": 10, "identity_before": 0.85,
                             "identity_after": 0.97,
                             "identity_after_min": 0.90}},
        "handoff": {"deaths": 1, "handoffs": 2, "orphaned": 0},
        "heartbeat": {"samples": 50, "replicas_seen": ["r0", "r1"]},
        "compile": {"n_programs": 7, "backend_compiles": 7,
                    "tracing_hit_rate": None},
        "replicas": [
            {"replica_id": "r0", "alive": True, "dead_reason": "",
             "drain_clean": True,
             "jobs": {"accepted": 6, "rejected": 2, "journaled": 0,
                      "completed": 6, "failed": 0, "cancelled": 0,
                      "expired": 0}},
            {"replica_id": "r1", "alive": False,
             "dead_reason": "injected", "drain_clean": False,
             "jobs": {"accepted": 4, "rejected": 1, "journaled": 2,
                      "completed": 2, "failed": 0, "cancelled": 0,
                      "expired": 0}}],
    }
    row = copy.deepcopy(row)
    row.update(over)
    return row


def _boot_row(**over):
    """The JAX package's ``tests/test_boot.py`` boot row."""
    row = {"metric": "boot", "schema": 1, "config": "mini",
           "backend": "cpu", "mode": "artifact", "replica": None,
           "boot_wall_s": 10.0, "compile_s": 1.0,
           "n_backend_compiles": 2, "persistent_hits": 2,
           "persistent_misses": 0, "hit_rate": 1.0, "n_programs": 2,
           "violations": [], "manifest_version": "abc",
           "artifact": "artifact"}
    row.update(over)
    return row


def _manifest():
    """A consistent two-program factory manifest (the shape of
    ``obs/boot.py``'s writer)."""
    progs = [{"entry": "fused_pass", "sig": "aa11", "config": "mini",
              "backend": "cpu", "compile_ms": 120.5,
              "persistent": "miss", "cache_key": "jit_fused-aa11-cache",
              "artifact_bytes": 4096},
             {"entry": "dmesh:step", "sig": "v7.bb22", "config": "mini",
              "backend": "cpu", "compile_ms": 80.0, "persistent": None,
              "cache_key": None, "artifact_bytes": 0}]
    return {"manifest_schema": 1, "version": "0123abcd", "backend": "cpu",
            "interpret": True, "configs": ["mini"], "n_programs": 2,
            "compile_s": 0.2005, "wall_s": 3.5, "n_devices": 8,
            "jax_version": "0.4.30",
            "by_config": {"mini": {"n_programs": 2, "compile_s": 0.2005,
                                   "backend_compiles": 2, "wall_s": 3.5}},
            "files": {"jit_fused-aa11-cache": 4096, "other-cache": 17},
            "programs": progs}


def _mesh(driver_mod, metrics_mod):
    """A driver's declared KPI catalog with attributed mesh series."""
    reg = metrics_mod.MetricsRegistry()
    driver_mod._declare_metrics(reg)
    reg.counter("mesh_passes").inc(3)
    reg.counter("mesh_faults").inc(1, kind="device_lost", shard="1")
    reg.counter("mesh_demotions").inc(1, to_rung="mesh-dp3")
    reg.gauge("mesh_shards_active").set(3)
    return reg.as_dict()


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """Every base artifact, by name: file paths for the file validators,
    objects for the row validators."""
    tmp = tmp_path_factory.mktemp("validate")
    from proovread_tpu import obs as jobs_
    from proovread_tpu.io.simulate import write_truth_sidecar as j_sidecar
    from proovread_tpu.pipeline.driver import PipelineConfig as JConfig
    from proovread_tpu.serve import server as jserver
    from proovread_tpu.serve.admission import TenantQuota as JQuota

    from proovread_tpu_torch import obs as tobs_
    from proovread_tpu_torch.pipeline.driver import PipelineConfig
    from proovread_tpu_torch.serve import server as tserver
    from proovread_tpu_torch.serve.admission import TenantQuota

    a = {}
    a["trace_port"] = _trace(tobs_, ttrace, str(tmp / "t.trace.jsonl"))
    a["trace_jax"] = _trace(jobs_, jtrace, str(tmp / "j.trace.jsonl"))
    for name, mod, declare in (("port", tm, tdriver._declare_metrics),
                               ("jax", jm, jdriver._declare_metrics)):
        reg = _calls(mod)
        declare(reg)
        path = str(tmp / f"{name}.metrics.json")
        reg.dump(path)
        a[f"metrics_{name}"] = path
    for name, mod in (("port", tqc), ("jax", jqc)):
        path = str(tmp / f"{name}.qc.jsonl")
        _drive(mod).write_jsonl(path)
        a[f"qc_{name}"] = path
    genome = random_genome(2000, seed=3)
    longs, truths = simulate_long_reads(genome, 3000, mean_len=500,
                                        min_len=300, seed=4)
    bps = [[] for _ in longs]
    bps[0] = [17, 120]
    write_truth_sidecar(str(tmp / "port.truth.jsonl"), longs, truths, bps)
    j_sidecar(str(tmp / "jax.truth.jsonl"), [r.id for r in longs], truths,
              bps)
    a["truth_port"] = str(tmp / "port.truth.jsonl")
    a["truth_jax"] = str(tmp / "jax.truth.jsonl")
    a["slo_port"] = _slo(tserver, TenantQuota, PipelineConfig(device="cpu"),
                         tmp, "port")
    a["slo_jax"] = _slo(jserver, JQuota, JConfig(), tmp, "jax")
    a["load"] = _load_row()
    a["mesh_port"] = _mesh(tdriver, tm)
    a["mesh_jax"] = _mesh(jdriver, jm)
    led = Ledger(backend="cpu")
    _drive_all_writer_paths(led)
    a["ledger_rows"] = [dict(r) for r in led.rows]
    a["ledger"] = str(tmp / "ledger.jsonl")
    led.write_jsonl(a["ledger"])
    a["manifest"] = _manifest()
    a["boot"] = _boot_row()
    a["tmp"] = tmp
    return a


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the artifacts as written: the same verdict, and a pass
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["port", "jax"])
def test_written_artifacts_pass_both(art, which):
    """What each package writes passes both validators alike."""
    assert same_verdict("validate_trace", art[f"trace_{which}"])[0] == "ok"
    assert same_verdict("validate_trace", art[f"trace_{which}"],
                        min_coverage=0.0)[0] == "ok"
    assert same_verdict("validate_metrics", art[f"metrics_{which}"],
                        require=("candidates_total",
                                 "resilience_demotions"))[0] == "ok"
    assert same_verdict("validate_qc", art[f"qc_{which}"],
                        min_reads=2)[0] == "ok"
    assert same_verdict("validate_truth_sidecar", art[f"truth_{which}"],
                        min_reads=2)[0] == "ok"
    assert same_verdict("validate_slo", art[f"slo_{which}"])[0] == "ok"
    assert same_verdict("validate_mesh_metrics",
                        art[f"mesh_{which}"])[0] == "ok"


def test_rows_pass_both(art):
    assert same_verdict("validate_load", art["load"])[0] == "ok"
    for r in art["ledger_rows"]:
        assert same_verdict("validate_ledger_row", r)[0] == "ok"
    assert same_verdict("validate_compile_ledger", art["ledger"],
                        min_rows=4)[0] == "ok"
    assert same_verdict("validate_manifest", art["manifest"])[0] == "ok"
    assert same_verdict("validate_boot_row", art["boot"])[0] == "ok"


def test_schema_declarations_equal():
    """The declared schemas are the reference's, field for field."""
    for name in dir(jv):
        if name.isupper() and not name.startswith("_"):
            assert getattr(tv, name) == getattr(jv, name), name
    assert tv.SCHEMA_VERSION == jv.SCHEMA_VERSION


def test_ledger_reconciliation_verdicts(art):
    """An inflated ledger against a trace that saw no compile fails alike;
    an empty ledger reconciles alike."""
    tmp = art["tmp"]
    led = Ledger(backend="cpu")
    led._on_backend_compile(10.0)
    bad = str(tmp / "inflated.jsonl")
    led.write_jsonl(bad)
    assert same_verdict("reconcile_compile_ledger", bad,
                        art["trace_port"])[0] == "ValidationError"
    empty = str(tmp / "empty.jsonl")
    Ledger(backend="cpu").write_jsonl(empty)
    same_verdict("reconcile_compile_ledger", empty, art["trace_port"])


# --------------------------------------------------------------------------
# one mutated copy per required key and type rule
# --------------------------------------------------------------------------

def _wrong(types):
    """A JSON value of none of ``types``."""
    for v in ("bad", {"bad": 1}, ["bad"], 1.5, None):
        if not isinstance(v, types):
            return v
    raise AssertionError(types)


def _lines(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]


def _write_lines(path, objs):
    with open(path, "w") as fh:
        for o in objs:
            fh.write(json.dumps(o) + "\n")
    return path


def _file_case(base, edit):
    """A file case: ``edit`` mutates the parsed JSONL lines of ``base``."""
    def make(a, tmp):
        objs = _lines(a[base])
        edit(objs)
        return _write_lines(str(tmp / "mut.jsonl"), objs)
    return make


def _json_case(base, edit):
    """A file case over one JSON object (metrics, SLO)."""
    def make(a, tmp):
        with open(a[base]) as fh:
            obj = json.load(fh)
        edit(obj)
        path = str(tmp / "mut.json")
        with open(path, "w") as fh:
            json.dump(obj, fh)
        return path
    return make


def _obj_case(base, edit):
    def make(a, tmp):
        obj = copy.deepcopy(a[base])
        edit(obj)
        return obj
    return make


def _drop(key):
    return lambda d: d.pop(key)


def _set(key, value):
    return lambda d: d.__setitem__(key, value)


def _in(path, edit):
    """Apply ``edit`` to the object at ``path`` (keys/indices) inside."""
    def go(d):
        for k in path:
            d = d[k]
        edit(d)
    return go


def _cases():
    cases = []

    def add(name, validator, make, **kw):
        cases.append(pytest.param(validator, make, kw, id=name))

    # -- QC records: every field dropped and mistyped, an extra one -------
    for f, types in jv.QC_RECORD_FIELDS.items():
        add(f"qc-drop-{f}", "validate_qc",
            _file_case("qc_port", lambda o, f=f: o[1].pop(f)))
        add(f"qc-type-{f}", "validate_qc",
            _file_case("qc_port",
                       lambda o, f=f, t=types: o[1].__setitem__(f, _wrong(t))))
    for nest, schema in (("siamaera", jv.QC_SIAMAERA_FIELDS),
                         ("ccs", jv.QC_CCS_FIELDS),
                         ("trim", jv.QC_TRIM_FIELDS),
                         ("accuracy", jv.QC_ACCURACY_FIELDS)):
        for f, types in schema.items():
            def edit(o, nest=nest, f=f, t=types, drop=False):
                rec = next(r for r in o[1:] if r[nest] is not None)
                if drop:
                    rec[nest].pop(f)
                else:
                    rec[nest][f] = _wrong(t)
            add(f"qc-{nest}-drop-{f}", "validate_qc",
                _file_case("qc_port",
                           lambda o, e=edit: e(o, drop=True)))
            add(f"qc-{nest}-type-{f}", "validate_qc",
                _file_case("qc_port", edit))
    add("qc-extra-field", "validate_qc",
        _file_case("qc_port", lambda o: o[1].__setitem__("surprise", 1)))
    add("qc-trajectory-length", "validate_qc",
        _file_case("qc_port", lambda o: o[1]["masked_frac"].append(0.5)))
    add("qc-trajectory-range", "validate_qc",
        _file_case("qc_port",
                   lambda o: o[1]["masked_frac"].__setitem__(0, 1.5)))
    add("qc-bad-breakpoint", "validate_qc",
        _file_case("qc_port",
                   lambda o: o[1].__setitem__("chimera", [[1, 2]])))
    add("qc-meta-schema", "validate_qc",
        _file_case("qc_port", lambda o: o[0].__setitem__("qc_schema", 1)))
    add("qc-meta-aggregate", "validate_qc",
        _file_case("qc_port", lambda o: o[0].pop("aggregate")))
    add("qc-meta-count", "validate_qc",
        _file_case("qc_port", lambda o: o[0].__setitem__("n_reads", 99)))
    add("qc-duplicate-id", "validate_qc",
        _file_case("qc_port", lambda o: o.append(dict(o[1]))))
    add("qc-min-reads", "validate_qc", lambda a, tmp: a["qc_port"],
        min_reads=99)
    # -- truth sidecar -------------------------------------------------------
    for f, types in jv.TRUTH_RECORD_FIELDS.items():
        add(f"truth-drop-{f}", "validate_truth_sidecar",
            _file_case("truth_port", lambda o, f=f: o[1].pop(f)))
        add(f"truth-type-{f}", "validate_truth_sidecar",
            _file_case("truth_port",
                       lambda o, f=f, t=types: o[1].__setitem__(f, _wrong(t))))
    add("truth-extra-field", "validate_truth_sidecar",
        _file_case("truth_port", lambda o: o[1].__setitem__("x", 0)))
    add("truth-alphabet", "validate_truth_sidecar",
        _file_case("truth_port", lambda o: o[1].__setitem__("seq", "ACGU")))
    add("truth-breakpoint-range", "validate_truth_sidecar",
        _file_case("truth_port",
                   lambda o: o[1].__setitem__("breakpoints", [10 ** 9])))
    add("truth-meta-schema", "validate_truth_sidecar",
        _file_case("truth_port", lambda o: o[0].pop("truth_schema")))
    add("truth-meta-count", "validate_truth_sidecar",
        _file_case("truth_port", lambda o: o[0].__setitem__("n_reads", 0)))
    add("truth-duplicate-id", "validate_truth_sidecar",
        _file_case("truth_port", lambda o: o.append(dict(o[1]))))
    # -- trace ---------------------------------------------------------------
    for k in jv._REQUIRED_X:
        add(f"trace-drop-{k}", "validate_trace",
            _file_case("trace_port", lambda o, k=k: o[1].pop(k)))
    add("trace-phase", "validate_trace",
        _file_case("trace_port", lambda o: o[1].__setitem__("ph", "B")))
    add("trace-no-ph", "validate_trace",
        _file_case("trace_port", lambda o: o[1].pop("ph")))
    add("trace-args-type", "validate_trace",
        _file_case("trace_port", lambda o: o[1].__setitem__("args", [])))
    add("trace-depth-type", "validate_trace",
        _file_case("trace_port",
                   lambda o: o[1]["args"].__setitem__("depth", "0")))
    for k in ("ts", "dur"):
        add(f"trace-negative-{k}", "validate_trace",
            _file_case("trace_port", lambda o, k=k: o[1].__setitem__(k, -1)))
    add("trace-bucket-split", "validate_trace",
        _file_case("trace_port", lambda o: [
            e["args"].pop("compile_ms") for e in o
            if e.get("cat") == "bucket"]))
    add("trace-no-root", "validate_trace",
        _file_case("trace_port", lambda o: [
            e["args"].__setitem__("depth", e["args"]["depth"] + 1)
            for e in o if e.get("ph") == "X"]))
    add("trace-coverage", "validate_trace",
        lambda a, tmp: a["trace_port"], min_coverage=1.01)
    add("trace-attribution", "validate_trace",
        lambda a, tmp: a["trace_port"], require_attribution=True)
    # -- metrics -------------------------------------------------------------
    add("metrics-schema", "validate_metrics",
        _json_case("metrics_port", _set("schema", 2)))
    for sec in ("counters", "gauges", "histograms"):
        add(f"metrics-drop-{sec}", "validate_metrics",
            _json_case("metrics_port", _drop(sec)))
    for k in ("unit", "help", "series"):
        add(f"metrics-counter-drop-{k}", "validate_metrics",
            _json_case("metrics_port",
                       _in(("counters", "candidates_total"), _drop(k))))
    add("metrics-series-labels", "validate_metrics",
        _json_case("metrics_port", _in(
            ("counters", "candidates_total", "series", 0),
            _drop("labels"))))
    add("metrics-series-value", "validate_metrics",
        _json_case("metrics_port", _in(
            ("gauges", "n_buckets", "series", 0), _set("value", "3"))))
    for k in ("count", "sum", "min", "max"):
        add(f"metrics-histogram-drop-{k}", "validate_metrics",
            _json_case("metrics_port", _in(
                ("histograms", "bucket_seconds", "series", 0), _drop(k))))
    add("metrics-require", "validate_metrics",
        lambda a, tmp: a["metrics_port"], require=("no_such_counter",))
    # -- SLO -----------------------------------------------------------------
    for f in jv.SLO_TOP_FIELDS:
        add(f"slo-drop-{f}", "validate_slo", _json_case("slo_port", _drop(f)))
    add("slo-extra-field", "validate_slo",
        _json_case("slo_port", _set("surprise", 1)))
    for k in jv.SLO_JOB_KEYS:
        add(f"slo-jobs-drop-{k}", "validate_slo",
            _json_case("slo_port", _in(("jobs",), _drop(k))))
        add(f"slo-jobs-type-{k}", "validate_slo",
            _json_case("slo_port", _in(("jobs",), _set(k, "1"))))
    for k in jv.SLO_QUEUE_KEYS:
        add(f"slo-queue-drop-{k}", "validate_slo",
            _json_case("slo_port", _in(("queue",), _drop(k))))
        add(f"slo-queue-type-{k}", "validate_slo",
            _json_case("slo_port", _in(("queue",), _set(k, -1))))
    for k in jv.SLO_COMPILE_KEYS:
        add(f"slo-compile-drop-{k}", "validate_slo",
            _json_case("slo_port", _in(("compile",), _drop(k))))
        add(f"slo-compile-type-{k}", "validate_slo",
            _json_case("slo_port", _in(("compile",), _set(k, "x"))))
    add("slo-compile-rate-range", "validate_slo",
        _json_case("slo_port", _in(("compile",),
                                   _set("tracing_hit_rate", 1.5))))
    for k in jv.SLO_DRAIN_KEYS:
        add(f"slo-drain-drop-{k}", "validate_slo",
            _json_case("slo_port", _in(("drain",), _drop(k))))
        add(f"slo-drain-type-{k}", "validate_slo",
            _json_case("slo_port", _in(("drain",), _set(k, 1))))
    add("slo-schema", "validate_slo",
        _json_case("slo_port", _set("slo_schema", 1)))
    add("slo-lost-job", "validate_slo",
        _json_case("slo_port", _in(("jobs",), lambda j: j.__setitem__(
            "journaled", j["journaled"] - 1))))
    add("slo-reason-vocab", "validate_slo",
        _json_case("slo_port", _in(("rejections",), _set("because", 1))))
    add("slo-rejected-sum", "validate_slo",
        _json_case("slo_port", _in(("jobs",), lambda j: j.__setitem__(
            "rejected", j["rejected"] + 1))))
    add("slo-latency-keys", "validate_slo",
        _json_case("slo_port", _set("latency", {"512": {"count": 1}})))
    add("slo-latency-order", "validate_slo",
        _json_case("slo_port", _set("latency", {"512": {
            "count": 1, "p50_s": 2.0, "p99_s": 1.0, "max_s": 3.0}})))
    add("slo-demotions-type", "validate_slo",
        _json_case("slo_port", _set("demotions", {"t1": -1})))
    add("slo-not-drained", "validate_slo",
        lambda a, tmp: a["slo_port"], require_drained=True)
    # -- LOAD rows -----------------------------------------------------------
    for f in jv.LOAD_ROW_FIELDS:
        add(f"load-drop-{f}", "validate_load", _obj_case("load", _drop(f)))
    add("load-extra-field", "validate_load",
        _obj_case("load", _set("surprise", 1)))
    for k in jv.LOAD_JOB_KEYS:
        add(f"load-jobs-drop-{k}", "validate_load",
            _obj_case("load", _in(("jobs",), _drop(k))))
        add(f"load-jobs-type-{k}", "validate_load",
            _obj_case("load", _in(("jobs",), _set(k, "1"))))
    for k in jv.LOAD_HANDOFF_KEYS:
        add(f"load-handoff-drop-{k}", "validate_load",
            _obj_case("load", _in(("handoff",), _drop(k))))
    for k in jv.LOAD_HEARTBEAT_KEYS:
        add(f"load-heartbeat-drop-{k}", "validate_load",
            _obj_case("load", _in(("heartbeat",), _drop(k))))
    for k in jv.LOAD_ACCURACY_KEYS:
        add(f"load-accuracy-drop-{k}", "validate_load",
            _obj_case("load", _in(("accuracy", "clr"), _drop(k))))
    for k in jv.LOAD_REPLICA_KEYS:
        add(f"load-replica-drop-{k}", "validate_load",
            _obj_case("load", _in(("replicas", 0), _drop(k))))
    for k in jv.LOAD_COMPILE_KEYS:
        add(f"load-compile-drop-{k}", "validate_load",
            _obj_case("load", _in(("compile",), _drop(k))))
    add("load-double-handoff", "validate_load", _obj_case("load", _in(
        ("replicas", 0, "jobs"), lambda j: j.update(
            accepted=j["accepted"] + 1, completed=j["completed"] + 1))))
    add("load-dropped-job", "validate_load", _obj_case("load", _in(
        ("replicas", 1, "jobs"), lambda j: j.__setitem__(
            "journaled", j["journaled"] - 1))))
    add("load-unattributed-journal", "validate_load", _obj_case(
        "load", lambda r: (r["jobs"].__setitem__("handoffs", 1),
                           r["handoff"].__setitem__("handoffs", 1))))
    add("load-reason-vocab", "validate_load", _obj_case("load", _in(
        ("rejections",), _set("because-reasons", 1))))
    add("load-rejected-fleet", "validate_load", _obj_case(
        "load", _in(("jobs",), _set("rejected_fleet", 99))))
    add("load-latency-count", "validate_load", _obj_case("load", _in(
        ("latency", "512"), _set("count", 4))))
    add("load-latency-order", "validate_load", _obj_case("load", _in(
        ("latency", "512"), _set("p50_s", 3.0))))
    add("load-heartbeat-unknown", "validate_load", _obj_case("load", _in(
        ("heartbeat",), _set("replicas_seen", ["r0", "r7"]))))
    add("load-compile-rate", "validate_load", _obj_case("load", _in(
        ("compile",), _set("tracing_hit_rate", 2.0))))
    # -- mesh metrics ----------------------------------------------------------
    for name in jv.MESH_COUNTERS:
        add(f"mesh-drop-{name}", "validate_mesh_metrics",
            _obj_case("mesh_port", _in(("counters",), _drop(name))))
    for name in jv.MESH_GAUGES:
        add(f"mesh-drop-{name}", "validate_mesh_metrics",
            _obj_case("mesh_port", _in(("gauges",), _drop(name))))
    add("mesh-undeclared", "validate_mesh_metrics", _obj_case(
        "mesh_port", _in(("counters",), _set(
            "mesh_bogus", {"unit": "", "help": "", "series": []}))))
    for name, labels in jv.MESH_COUNTER_LABELS.items():
        for lb in labels:
            add(f"mesh-label-{name}-{lb}", "validate_mesh_metrics",
                _obj_case("mesh_port", _in(
                    ("counters", name, "series", 0, "labels"), _drop(lb))))
    # -- compile-ledger rows ---------------------------------------------------
    for f, types in jv.LEDGER_ROW_FIELDS.items():
        add(f"ledger-drop-{f}", "validate_ledger_row",
            _obj_case("ledger_rows", lambda rows, f=f: rows[0].pop(f)))
        add(f"ledger-type-{f}", "validate_ledger_row",
            _obj_case("ledger_rows", lambda rows, f=f, t=types:
                      rows[0].__setitem__(f, _wrong(t))))
    add("ledger-kind", "validate_ledger_row", _obj_case(
        "ledger_rows", lambda rows: rows[0].__setitem__("kind", "teleport")))
    add("ledger-pcache", "validate_ledger_row", _obj_case(
        "ledger_rows",
        lambda rows: rows[0].__setitem__("persistent_cache", "maybe")))
    add("ledger-extra", "validate_ledger_row", _obj_case(
        "ledger_rows", lambda rows: rows[0].__setitem__("sneaky", 1)))
    add("ledger-file-count", "validate_compile_ledger",
        _file_case("ledger", lambda o: o[0].__setitem__(
            "n_rows", o[0]["n_rows"] + 1)))
    add("ledger-file-min-rows", "validate_compile_ledger",
        lambda a, tmp: a["ledger"], min_rows=99)
    # -- manifest --------------------------------------------------------------
    for f, types in jv.MANIFEST_TOP_FIELDS.items():
        add(f"manifest-drop-{f}", "validate_manifest",
            _obj_case("manifest", _drop(f)))
        add(f"manifest-type-{f}", "validate_manifest",
            _obj_case("manifest", lambda m, f=f, t=types:
                      m.__setitem__(f, _wrong(t))))
    for f, types in jv.MANIFEST_ROW_FIELDS.items():
        add(f"manifest-row-drop-{f}", "validate_manifest",
            _obj_case("manifest", _in(("programs", 0), _drop(f))))
        add(f"manifest-row-type-{f}", "validate_manifest",
            _obj_case("manifest", _in(("programs", 0), lambda r, f=f,
                                      t=types: r.__setitem__(f, _wrong(t)))))
    add("manifest-count", "validate_manifest",
        _obj_case("manifest", _set("n_programs", 3)))
    add("manifest-inventory", "validate_manifest", _obj_case(
        "manifest", _in(("programs", 0), _set("cache_key", "nope"))))
    add("manifest-by-config", "validate_manifest", _obj_case(
        "manifest", _set("configs", ["mini", "config4"])))
    add("manifest-duplicate-row", "validate_manifest", _obj_case(
        "manifest", lambda m: (m["programs"].append(dict(m["programs"][0])),
                               m.__setitem__("n_programs", 3),
                               m["by_config"]["mini"].__setitem__(
                                   "n_programs", 3))))
    # -- boot rows -------------------------------------------------------------
    for f, types in jv.BOOT_ROW_FIELDS.items():
        add(f"boot-drop-{f}", "validate_boot_row", _obj_case("boot", _drop(f)))
        add(f"boot-type-{f}", "validate_boot_row", _obj_case(
            "boot", lambda r, f=f, t=types: r.__setitem__(f, _wrong(t))))
    add("boot-mode", "validate_boot_row",
        _obj_case("boot", _set("mode", "lukewarm")))
    add("boot-hit-rate", "validate_boot_row",
        _obj_case("boot", _set("hit_rate", 0.5)))
    add("boot-provenance", "validate_boot_row",
        _obj_case("boot", _set("manifest_version", None)))
    add("boot-violation-kind", "validate_boot_row", _obj_case(
        "boot", _set("violations", [{"kind": "mystery", "entry": "x",
                                     "sig": "y", "detail": "z"}])))
    add("boot-cold-violations", "validate_boot_row", _obj_case(
        "boot", lambda r: r.update(
            mode="cold", manifest_version=None, artifact=None,
            persistent_hits=0, persistent_misses=2, hit_rate=0.0,
            violations=[{"kind": "unmanifested", "entry": "x", "sig": "y",
                         "detail": "z"}])))
    return cases


@pytest.mark.parametrize("validator,make,kw", _cases())
def test_mutated_artifact_same_verdict(art, tmp_path, validator, make, kw):
    """One mutation of a valid artifact: both validators give the same
    verdict (the mutations that break a rule fail alike, by message)."""
    arg = make(art, tmp_path)
    if validator == "validate_ledger_row":
        arg = arg[0]
    same_verdict(validator, arg, **kw)


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

def _cli_cases():
    return [
        ["--trace", "trace_port", "--min-coverage", "0.5"],
        ["--trace", "trace_port", "--min-coverage", "1.5"],
        ["--metrics", "metrics_port", "--require",
         "candidates_total,resilience_demotions"],
        ["--metrics", "metrics_jax", "--require", "no_such"],
        ["--qc", "qc_port", "--min-qc-reads", "2"],
        ["--qc", "qc_jax", "--min-qc-reads", "9"],
        ["--truth-sidecar", "truth_port"],
        ["--slo", "slo_port"],
        ["--slo", "slo_jax", "--require-drained"],
        ["--compile-ledger", "ledger"],
        ["--compile-ledger", "ledger", "--trace", "trace_port"],
        ["--trace", "trace_jax", "--qc", "qc_jax", "--metrics",
         "metrics_jax"],
        [],
    ]


@pytest.mark.parametrize("argv", _cli_cases(),
                         ids=lambda a: "-".join(x.strip("-") for x in a)
                         or "no-args")
def test_cli_exits_as_the_reference(art, capsys, argv):
    """``python -m proovread_tpu_torch.obs.validate``: the same exit code
    and the same output as the reference's command line."""
    argv = [art.get(a, a) for a in argv]
    out = {}
    for name, mod in (("port", tv), ("jax", jv)):
        try:
            rc = mod.main(argv)
        except SystemExit as e:
            rc = ("exit", e.code)
        cap = capsys.readouterr()
        # the usage text wraps at the program's name, which differs
        err = " ".join(cap.err.replace("proovread-tpu-torch-obs-validate",
                                       "proovread-tpu-obs-validate").split())
        out[name] = (rc, cap.out, err)
    assert out["port"] == out["jax"]
