"""Schema validation for the observability artifacts (port of
``proovread_tpu/obs/validate.py``, whole: the same schemas, rules and
messages, so both packages give the same verdict on any file).

``validate_trace`` checks the Chrome trace-event JSONL written by
``Tracer.write_chrome`` (one JSON object per line, ``X`` complete events
plus ``M`` metadata), verifies the span tree (depths, durations, the
compile/execute split on bucket spans) and computes the root-coverage
statistic the acceptance bar cares about: the fraction of the root span's
wall time covered by its direct children. ``validate_metrics`` checks the
metrics JSON against the ``obs.metrics`` schema.

``validate_qc`` strictly checks a ``--qc-out`` per-read JSONL artifact
against the ``QC_RECORD_FIELDS`` schema (undeclared fields fail — the
writer can never silently drift). ``validate_truth_sidecar`` checks the
simulators' truth sidecar (the CLI's ``--truth`` input).

``validate_slo`` strictly checks the serving SLO artifact
(``python -m proovread_tpu_torch serve --slo-out``) — schema plus the
no-job-silently-lost accounting identity; ``validate_load`` a fleet LOAD
row (``obs/load.py``) and its three fleet accounting identities.

The mesh-metric, compile-ledger, manifest and boot-row schemas are plain
data here: the port writes none of those artifacts yet (multiple GPUs and
the kernel-build tooling come later), but a file of the JAX package's
gets the same verdict from either package.

All are importable and runnable::

    python -m proovread_tpu_torch.obs.validate --trace run.trace.jsonl \
        --metrics run.metrics.json --qc run.qc.jsonl \
        --min-coverage 0.95 \
        --require admission_dropped_cov,resilience_demotions
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Iterable, Tuple

from proovread_tpu_torch.obs.metrics import SCHEMA_VERSION

_REQUIRED_X = ("name", "cat", "ph", "ts", "dur", "pid", "tid", "args")

# -- per-read QC record schema (obs/qc.py writer) --------------------------
# Declared HERE, independently of the writer, on purpose: validate_qc is
# STRICT (an undeclared field fails), and the lint-guard test
# (tests/test_qc.py::TestQcSchema::test_schema_never_drifts) drives every writer
# path and validates the result — so the writer and this declaration can
# never silently drift apart. Each entry maps a field name to the tuple
# of accepted JSON-decoded types.
_NUM = (int, float)
_OPT_INT = (int, type(None))
# v2: + the ground-truth "accuracy" field (obs/accuracy.py) — a
# breaking record-schema change, versioned like the SLO v2 bump
QC_SCHEMA_VERSION = 2
QC_RECORD_FIELDS = {
    "id": (str,),
    "bucket": _OPT_INT,            # length-bucket ordinal
    "bucket_span": _OPT_INT,       # span_id of the bucket span (--trace)
    "in_len": (int,),
    "out_len": (int,),
    "n_iterations": (int,),
    "masked_frac": (list,),        # per-iteration trajectory
    "finish_admitted": (int,),
    "mean_support": _NUM,
    "corrected_bases": (int,),
    "phred_uplift": (int,),
    "chimera": (list,),            # [[from, to, score], ...]
    "siamaera": (dict, type(None)),
    "ccs": (dict, type(None)),
    "trim": (dict, type(None)),
    "accuracy": (dict, type(None)),  # ground-truth scoreboard (--truth)
}
# nested-object schemas, same strictness
QC_SIAMAERA_FIELDS = {"action": (str,), "start": (int,), "len": (int,)}
QC_CCS_FIELDS = {"role": (str,), "n_subreads": (int,)}
QC_TRIM_FIELDS = {"pieces": (int,), "chimera_bases_lost": (int,),
                  "trim_bases_lost": (int,), "pieces_dropped": (int,),
                  "bases_out": (int,)}
# ground-truth accuracy verdict (obs/accuracy.py:score_read_sets):
# identity for every scored read; "classes" only on the classified
# sample; "chimera" only when the truth sidecar carried breakpoints
QC_ACCURACY_FIELDS = {"identity_before": _NUM, "identity_after": _NUM,
                      "lcs_before": (int,), "lcs_after": (int,),
                      "truth_len": (int,),
                      "classes": (dict, type(None)),
                      "chimera": (dict, type(None))}
QC_ACCURACY_CLASS_FIELDS = {
    f"{k}_{stage}": (int,)
    for k in ("sub", "ins", "del")
    for stage in ("before", "after", "introduced")}
QC_ACCURACY_CHIMERA_FIELDS = {"truth": (int,), "detected": (int,),
                              "matched": (int,)}

# -- truth-sidecar schema (io/simulate.py:write_truth_sidecar writer) ------
# Same declaration discipline: the sidecar the simulators emit (and the
# CLI --truth flag consumes, obs/accuracy.py:load_truth_sidecar) is
# declared here and validated strictly.
TRUTH_SCHEMA_VERSION = 1
TRUTH_RECORD_FIELDS = {"id": (str,), "seq": (str,),
                       "breakpoints": (list,)}


# -- mesh fault-domain metrics schema (pipeline/driver.py writer) ----------
# Declared HERE, independently of the driver's _declare_metrics, with the
# same discipline as the QC schema: validate_mesh_metrics is STRICT — a
# mesh_* metric the driver dumps that is not declared below fails, and a
# declared one that is absent fails — and a lint-guard test
# (tests/test_dmesh_faults.py) drives _declare_metrics against this
# declaration so the two can never silently drift.
MESH_SCHEMA_VERSION = 1
MESH_COUNTERS = ("mesh_passes", "mesh_faults", "mesh_demotions")
MESH_GAUGES = ("mesh_shards_configured", "mesh_shards_active",
               "mesh_rebalanced_reads")
# labels every non-empty series of these counters must carry (the
# shard-attributed accounting: which chip, which fault, where the bucket
# landed)
MESH_COUNTER_LABELS = {"mesh_faults": ("kind", "shard"),
                       "mesh_demotions": ("to_rung",)}


def validate_mesh_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Strictly validate the ``mesh_*`` slice of a metrics dump (the
    ``PipelineResult.metrics`` / ``--metrics-out`` object). Returns
    summary stats ({'mesh_passes': N, 'mesh_faults': N})."""
    if not isinstance(metrics, dict):
        _fail("mesh metrics: not a metrics dict")
    counters = metrics.get("counters", {})
    gauges = metrics.get("gauges", {})
    for name in MESH_COUNTERS:
        if name not in counters:
            _fail(f"mesh metrics: declared counter {name!r} absent")
    for name in MESH_GAUGES:
        if name not in gauges:
            _fail(f"mesh metrics: declared gauge {name!r} absent")
    for section, declared in (("counters", MESH_COUNTERS),
                              ("gauges", MESH_GAUGES),
                              ("histograms", ())):
        for name in metrics.get(section, {}):
            if name.startswith("mesh_") and name not in declared:
                _fail(f"mesh metrics: undeclared {section[:-1]} {name!r} "
                      "(extend obs/validate.py MESH_* first)")
    for name, want in MESH_COUNTER_LABELS.items():
        for s in counters[name].get("series", ()):
            labels = s.get("labels", {})
            for lb in want:
                if lb not in labels:
                    _fail(f"mesh metrics: {name} series lacks the "
                          f"{lb!r} label (got {sorted(labels)})")
    n_passes = sum(s.get("value", 0)
                   for s in counters["mesh_passes"].get("series", ()))
    n_faults = sum(s.get("value", 0)
                   for s in counters["mesh_faults"].get("series", ()))
    return {"mesh_passes": int(n_passes), "mesh_faults": int(n_faults)}


# -- compile-ledger row schema (obs/compilecache.py writer) ----------------
# Same declaration discipline as the QC schema: declared here,
# independently of the writer, validated STRICTLY (an undeclared field
# fails, a declared one missing fails), and a two-sided lint-guard test
# (tests/test_compilecache.py) drives the writer against this declaration
# so the two can never silently drift.
LEDGER_SCHEMA_VERSION = 1
LEDGER_ROW_FIELDS = {
    "entry": (str,),               # entry point ((unattributed) fallback)
    "sig": (str,),                 # abstract shape/dtype signature hash
    "bucket": _OPT_INT,            # live length bucket, if any
    "backend": (str,),
    "kind": (str,),                # retrace | backend_compile
    "wall_ms": _NUM,
    "compile_ms": _NUM,            # backend-compile ms inside the window
    "persistent_cache": (str, type(None)),   # hit | miss | null (off)
}
LEDGER_KINDS = ("retrace", "backend_compile")
LEDGER_PCACHE = ("hit", "miss")
# census keys the meta line must carry (obs/compilecache.py:Ledger.census)
LEDGER_CENSUS_KEYS = (
    "backend", "n_programs", "n_entries", "calls", "tracing_hits",
    "tracing_misses", "tracing_hit_rate", "backend_compiles",
    "backend_compile_s", "persistent_hits", "persistent_misses",
    "persistent_hit_rate", "by_entry", "top")


def validate_ledger_row(rec: Dict[str, Any], where: str = "row") -> None:
    """Strictly validate ONE compile-ledger row: every declared field
    present with an accepted type, no undeclared fields, values within
    the closed vocabularies, and compile_ms == wall_ms for
    backend_compile rows. Retrace rows deliberately have NO
    compile<=wall containment check: under the serving layer's threads,
    concurrent compiles attribute to the open call window and their
    summed durations can legitimately exceed its wall time."""
    if not isinstance(rec, dict):
        _fail(f"{where}: not an object")
    missing = [k for k in LEDGER_ROW_FIELDS if k not in rec]
    if missing:
        _fail(f"{where}: missing required fields {missing}")
    unknown = [k for k in rec if k not in LEDGER_ROW_FIELDS]
    if unknown:
        _fail(f"{where}: undeclared fields {unknown} — declare them in "
              "obs/validate.py:LEDGER_ROW_FIELDS first")
    for k, types in LEDGER_ROW_FIELDS.items():
        if not isinstance(rec[k], types):
            _fail(f"{where}: field {k!r} has type "
                  f"{type(rec[k]).__name__}, expected one of "
                  f"{[t.__name__ for t in types]}")
    if rec["kind"] not in LEDGER_KINDS:
        _fail(f"{where}: kind {rec['kind']!r} outside {LEDGER_KINDS}")
    if rec["persistent_cache"] is not None \
            and rec["persistent_cache"] not in LEDGER_PCACHE:
        _fail(f"{where}: persistent_cache {rec['persistent_cache']!r} "
              f"outside {LEDGER_PCACHE}")
    for k in ("wall_ms", "compile_ms"):
        if rec[k] < 0:
            _fail(f"{where}: {k} must be >= 0")
    if rec["kind"] == "backend_compile" \
            and rec["compile_ms"] != rec["wall_ms"]:
        _fail(f"{where}: backend_compile row must have "
              "compile_ms == wall_ms")


def validate_compile_ledger(path: str, min_rows: int = 0
                            ) -> Dict[str, Any]:
    """Validate a ``--compile-ledger`` JSONL artifact: one meta line
    (schema version + embedded census) then one strictly-validated row
    per compilation event; the meta row count and the census
    backend-compile totals must agree with the rows. Returns summary
    stats (incl. the summed backend-compile ms — the number
    :func:`reconcile_compile_ledger` checks against the span tree)."""
    n = 0
    backend_ms = 0.0
    n_backend = 0
    meta = None
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                _fail(f"{path}:{lineno}: not JSON ({e})")
            if lineno == 1:
                if not isinstance(obj, dict) \
                        or obj.get("ledger_schema") != LEDGER_SCHEMA_VERSION:
                    _fail(f"{path}: first line must be the meta record "
                          f"with ledger_schema == {LEDGER_SCHEMA_VERSION}")
                census = obj.get("census")
                if not isinstance(census, dict):
                    _fail(f"{path}: meta record lacks the census report")
                miss = [k for k in LEDGER_CENSUS_KEYS if k not in census]
                if miss:
                    _fail(f"{path}: census lacks keys {miss}")
                meta = obj
                continue
            validate_ledger_row(obj, where=f"{path}:{lineno}")
            n += 1
            if obj["kind"] == "backend_compile":
                n_backend += 1
                backend_ms += obj["wall_ms"]
    if meta is None:
        _fail(f"{path}: empty artifact (no meta line)")
    if meta.get("n_rows") != n:
        _fail(f"{path}: meta n_rows {meta.get('n_rows')} != "
              f"{n} row line(s)")
    census = meta["census"]
    if census["backend_compiles"] != n_backend:
        _fail(f"{path}: census backend_compiles "
              f"{census['backend_compiles']} != {n_backend} "
              "backend_compile row(s)")
    if abs(census["backend_compile_s"] * 1e3 - backend_ms) > \
            max(1.0, 0.001 * backend_ms):
        _fail(f"{path}: census backend_compile_s "
              f"{census['backend_compile_s']} disagrees with summed "
              f"row compile ms {backend_ms:.3f}")
    if n < min_rows:
        _fail(f"{path}: {n} row(s) < required {min_rows}")
    return {"n_rows": n, "n_backend_compiles": n_backend,
            "backend_compile_ms": round(backend_ms, 3),
            "n_programs": census["n_programs"],
            "census": census}


def reconcile_compile_ledger(ledger_path: str, trace_path: str,
                             tolerance_frac: float = 0.05,
                             tolerance_ms: float = 100.0
                             ) -> Dict[str, Any]:
    """The ledger and the span tree are fed by the SAME
    ``backend_compile_duration`` monitoring events, so the ledger's
    summed backend-compile ms must reconcile with the trace's depth-0
    compile split (``make trace-smoke`` / ``make dmesh-smoke`` assert
    this). Tolerances absorb the span layer's compile<=duration clamp."""
    lstats = validate_compile_ledger(ledger_path)
    tstats = validate_trace(trace_path)
    trace_ms = tstats["compile_s"] * 1e3
    ledger_ms = lstats["backend_compile_ms"]
    diff = abs(trace_ms - ledger_ms)
    if diff > max(tolerance_ms, tolerance_frac * max(trace_ms, ledger_ms)):
        _fail(f"compile ledger {ledger_path} does not reconcile with "
              f"trace {trace_path}: ledger {ledger_ms:.1f}ms vs trace "
              f"root compile {trace_ms:.1f}ms (diff {diff:.1f}ms)")
    return {"ledger_ms": round(ledger_ms, 3),
            "trace_ms": round(trace_ms, 3), "diff_ms": round(diff, 3)}


# -- serving SLO artifact schema (serve/server.py writer) ------------------
# Same declaration discipline as the QC schema: declared here,
# independently of the writer, and validated STRICTLY (undeclared fields
# fail) so the serving layer can never silently drift its SLO contract.
# v2: the required `compile` section joined the artifact — a
# breaking schema change, versioned like every other schema here, so a
# pre-PR-9 artifact fails with a clean version mismatch instead of a
# misleading missing-field error
SLO_SCHEMA_VERSION = 2
_BOOL = (bool,)
SLO_JOB_KEYS = ("accepted", "rejected", "journaled", "completed",
                "failed", "cancelled", "expired")
SLO_TOP_FIELDS = ("slo_schema", "jobs", "rejections", "queue", "latency",
                  "demotions", "drain", "compile")
# compile-ledger census slice on the SLO artifact: the measurable form of
# continuous batching's "keeps the fused programs hot" claim (ROADMAP
# item 5) — n_programs/backend_compiles are the cold side, tracing
# hits/misses the warm side, tracing_hit_rate the headline. Named
# tracing_hit_rate, NOT cache_hit_rate: bench rows and COMPILE_*.json
# use cache_hit_rate for the PERSISTENT-cache rate, and the serving
# number is the in-process jit tracing rate — two different caches must
# not share one key name
SLO_COMPILE_KEYS = ("n_programs", "backend_compiles",
                    "backend_compile_s", "tracing_hits",
                    "tracing_misses", "tracing_hit_rate")
SLO_LATENCY_KEYS = ("count", "p50_s", "p99_s", "max_s")
SLO_QUEUE_KEYS = ("depth_peak", "depth_final")
SLO_DRAIN_KEYS = ("requested", "clean")
# closed rejection vocabulary (serve/admission.py REJECT_REASONS)
SLO_REJECT_REASONS = ("quota-jobs", "quota-bases", "queue-full",
                      "parse-error", "bad-request", "duplicate-job",
                      "draining")


class ValidationError(ValueError):
    pass


def _fail(msg: str):
    raise ValidationError(msg)


def validate_trace(path: str, min_coverage: float = 0.0,
                   require_attribution: bool = False) -> Dict[str, Any]:
    """Validate a trace JSONL file; returns summary stats.

    ``require_attribution``: the trace must come from a profiled run —
    every bucket span has to carry the cost keys (``flops``,
    ``bytes_accessed``, ``peak_bytes``) and the memory-telemetry keys
    (``live_bytes``, ``peak_live_bytes``). Zero values are legal (a
    replayed bucket does no device work); absent keys are not."""
    events = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                _fail(f"{path}:{lineno}: not a JSON object ({e})")
            if not isinstance(ev, dict) or "ph" not in ev:
                _fail(f"{path}:{lineno}: event missing 'ph'")
            if ev["ph"] == "M":
                continue                    # metadata record
            if ev["ph"] != "X":
                _fail(f"{path}:{lineno}: unexpected phase {ev['ph']!r} "
                      "(writer emits only X/M)")
            missing = [k for k in _REQUIRED_X if k not in ev]
            if missing:
                _fail(f"{path}:{lineno}: X event missing {missing}")
            if not isinstance(ev["args"], dict):
                _fail(f"{path}:{lineno}: args must be an object")
            if not isinstance(ev["args"].get("depth"), int):
                _fail(f"{path}:{lineno}: args.depth missing/not int")
            for k in ("ts", "dur"):
                if not isinstance(ev[k], (int, float)) or ev[k] < 0:
                    _fail(f"{path}:{lineno}: {k} must be a >=0 number")
            events.append(ev)
    if not events:
        _fail(f"{path}: no span events")

    buckets = [e for e in events if e["cat"] == "bucket"]
    for b in buckets:
        if "compile_ms" not in b["args"] or "execute_ms" not in b["args"]:
            _fail(f"{path}: bucket span {b['name']!r} lacks the "
                  "compile_ms/execute_ms split")
    total_flops = total_bytes = peak_live = 0.0
    if require_attribution:
        cost_keys = ("flops", "bytes_accessed", "peak_bytes")
        mem_keys = ("live_bytes", "peak_live_bytes")
        for b in buckets:
            missing_c = [k for k in cost_keys if k not in b["args"]]
            missing_m = [k for k in mem_keys if k not in b["args"]]
            if missing_c:
                _fail(f"{path}: bucket span (bucket="
                      f"{b['args'].get('bucket')}) lacks cost "
                      f"attribution keys {missing_c}")
            if missing_m:
                _fail(f"{path}: bucket span (bucket="
                      f"{b['args'].get('bucket')}) lacks memory "
                      f"telemetry keys {missing_m}")
            for k in cost_keys + mem_keys:
                if not isinstance(b["args"][k], (int, float)) \
                        or b["args"][k] < 0:
                    _fail(f"{path}: bucket attribution {k} must be a "
                          f">=0 number, got {b['args'][k]!r}")
            total_flops += b["args"]["flops"]
            total_bytes += b["args"]["bytes_accessed"]
            peak_live = max(peak_live, b["args"]["peak_live_bytes"])

    roots = [e for e in events if e["args"]["depth"] == 0]
    if not roots:
        _fail(f"{path}: no depth-0 root span")
    root = max(roots, key=lambda e: e["dur"])
    r0, r1 = root["ts"], root["ts"] + root["dur"]
    kids = [e for e in events
            if e["args"]["depth"] == 1 and r0 <= e["ts"] <= r1]
    coverage = (min(1.0, sum(k["dur"] for k in kids) / root["dur"])
                if root["dur"] > 0 else 1.0)
    if coverage < min_coverage:
        _fail(f"{path}: root span {root['name']!r} children cover "
              f"{coverage:.1%} of its wall time (< {min_coverage:.0%})")
    stats = {
        "n_events": len(events),
        "root": root["name"],
        "wall_s": round(root["dur"] / 1e6, 3),
        "coverage": round(coverage, 4),
        "n_buckets": len(buckets),
        "compile_s": round(sum(
            e["args"].get("compile_ms", 0.0) for e in events
            if e["args"]["depth"] == 0) / 1e3, 3),
    }
    if require_attribution:
        stats["bucket_flops"] = total_flops
        stats["bucket_bytes"] = total_bytes
        stats["peak_live_bytes"] = peak_live
    return stats


def validate_metrics(path: str,
                     require: Iterable[str] = ()) -> Dict[str, Any]:
    """Validate a metrics JSON file; ``require`` lists counter names that
    must be present (the pipeline pre-declares its KPI catalog, so even
    zero-valued counters appear)."""
    with open(path) as fh:
        try:
            d = json.load(fh)
        except json.JSONDecodeError as e:
            _fail(f"{path}: not JSON ({e})")
    if not isinstance(d, dict) or d.get("schema") != SCHEMA_VERSION:
        _fail(f"{path}: schema != {SCHEMA_VERSION}")
    n_series = 0
    for section in ("counters", "gauges", "histograms"):
        sec = d.get(section)
        if not isinstance(sec, dict):
            _fail(f"{path}: missing section {section!r}")
        for name, m in sec.items():
            for k in ("unit", "help", "series"):
                if k not in m:
                    _fail(f"{path}: {section}.{name} missing {k!r}")
            for s in m["series"]:
                n_series += 1
                if not isinstance(s.get("labels"), dict):
                    _fail(f"{path}: {section}.{name} series lacks labels")
                if section == "histograms":
                    for k in ("count", "sum", "min", "max"):
                        if k not in s:
                            _fail(f"{path}: histogram {name} series "
                                  f"missing {k!r}")
                elif not isinstance(s.get("value"), (int, float)):
                    _fail(f"{path}: {section}.{name} series value "
                          "missing/not numeric")
    missing = [n for n in require if n not in d["counters"]]
    if missing:
        _fail(f"{path}: required counters absent: {missing}")
    return {"n_counters": len(d["counters"]),
            "n_gauges": len(d["gauges"]),
            "n_histograms": len(d["histograms"]),
            "n_series": n_series}


def validate_qc_record(rec: Dict[str, Any], where: str = "record") -> None:
    """Strictly validate ONE QC record: every declared field present with
    an accepted type, no undeclared fields (the schema-drift guard), and
    structural invariants (trajectory length, breakpoint shape)."""
    if not isinstance(rec, dict):
        _fail(f"{where}: not an object")
    missing = [k for k in QC_RECORD_FIELDS if k not in rec]
    if missing:
        _fail(f"{where}: missing required fields {missing}")
    unknown = [k for k in rec if k not in QC_RECORD_FIELDS]
    if unknown:
        _fail(f"{where}: undeclared fields {unknown} — declare them in "
              "obs/validate.py:QC_RECORD_FIELDS first")
    for k, types in QC_RECORD_FIELDS.items():
        if not isinstance(rec[k], types):
            _fail(f"{where}: field {k!r} has type "
                  f"{type(rec[k]).__name__}, expected one of "
                  f"{[t.__name__ for t in types]}")
    for v in rec["masked_frac"]:
        if not isinstance(v, _NUM) or not (0.0 <= v <= 1.0):
            _fail(f"{where}: masked_frac entry {v!r} not in [0, 1]")
    if rec["n_iterations"] != len(rec["masked_frac"]):
        _fail(f"{where}: n_iterations {rec['n_iterations']} != trajectory "
              f"length {len(rec['masked_frac'])}")
    for bp in rec["chimera"]:
        if (not isinstance(bp, list) or len(bp) != 3
                or not all(isinstance(x, _NUM) for x in bp)):
            _fail(f"{where}: chimera breakpoint {bp!r} is not "
                  "[from, to, score]")
    for key, sub_schema in (("siamaera", QC_SIAMAERA_FIELDS),
                            ("ccs", QC_CCS_FIELDS),
                            ("trim", QC_TRIM_FIELDS)):
        sub = rec[key]
        if sub is None:
            continue
        sub_missing = [k for k in sub_schema if k not in sub]
        sub_unknown = [k for k in sub if k not in sub_schema]
        if sub_missing or sub_unknown:
            _fail(f"{where}: {key} object missing {sub_missing} / "
                  f"undeclared {sub_unknown}")
        for k, types in sub_schema.items():
            if not isinstance(sub[k], types):
                _fail(f"{where}: {key}.{k} has type "
                      f"{type(sub[k]).__name__}")
    acc = rec["accuracy"]
    if acc is not None:
        for nest, schema, sub in (
                ("accuracy", QC_ACCURACY_FIELDS, acc),
                ("accuracy.classes", QC_ACCURACY_CLASS_FIELDS,
                 acc.get("classes")),
                ("accuracy.chimera", QC_ACCURACY_CHIMERA_FIELDS,
                 acc.get("chimera"))):
            if sub is None:
                continue
            sub_missing = [k for k in schema if k not in sub]
            sub_unknown = [k for k in sub if k not in schema]
            if sub_missing or sub_unknown:
                _fail(f"{where}: {nest} object missing {sub_missing} / "
                      f"undeclared {sub_unknown}")
            for k, types in schema.items():
                if not isinstance(sub[k], types):
                    _fail(f"{where}: {nest}.{k} has type "
                          f"{type(sub[k]).__name__}")
        for k in ("identity_before", "identity_after"):
            if not 0.0 <= acc[k] <= 1.0:
                _fail(f"{where}: accuracy.{k} {acc[k]!r} not in [0, 1]")


def validate_qc(path: str, min_reads: int = 0) -> Dict[str, Any]:
    """Validate a ``--qc-out`` JSONL artifact: one meta line (schema
    version + embedded aggregate) followed by one strictly-validated
    record per read. Returns summary stats."""
    n = 0
    n_chimeric = 0
    ids = set()
    meta = None
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                _fail(f"{path}:{lineno}: not JSON ({e})")
            if lineno == 1:
                if not isinstance(obj, dict) \
                        or obj.get("qc_schema") != QC_SCHEMA_VERSION:
                    _fail(f"{path}: first line must be the meta record "
                          f"with qc_schema == {QC_SCHEMA_VERSION}")
                if not isinstance(obj.get("aggregate"), dict):
                    _fail(f"{path}: meta record lacks the aggregate "
                          "report")
                meta = obj
                continue
            validate_qc_record(obj, where=f"{path}:{lineno}")
            if obj["id"] in ids:
                _fail(f"{path}:{lineno}: duplicate read id {obj['id']!r}")
            ids.add(obj["id"])
            n += 1
            if obj["chimera"]:
                n_chimeric += 1
    if meta is None:
        _fail(f"{path}: empty artifact (no meta line)")
    if meta.get("n_reads") != n:
        _fail(f"{path}: meta n_reads {meta.get('n_reads')} != "
              f"{n} record line(s)")
    if n < min_reads:
        _fail(f"{path}: {n} record(s) < required {min_reads}")
    return {"n_records": n, "n_chimeric": n_chimeric,
            "aggregate": meta["aggregate"]}


def validate_truth_sidecar(path: str, min_reads: int = 0
                           ) -> Dict[str, Any]:
    """Strictly validate a truth sidecar (``io/simulate.py:
    write_truth_sidecar`` -> CLI ``--truth``): one meta line (schema
    version + read count) then one record per read — id, the error-free
    source sequence (ACGTN alphabet), and the true chimera-junction
    coordinates (possibly empty, always present). Returns summary
    stats."""
    n = 0
    n_bases = 0
    n_chimeric = 0
    ids = set()
    meta = None
    allowed = set("ACGTN-")
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                _fail(f"{path}:{lineno}: not JSON ({e})")
            if lineno == 1:
                if not isinstance(obj, dict) or \
                        obj.get("truth_schema") != TRUTH_SCHEMA_VERSION:
                    _fail(f"{path}: first line must be the meta record "
                          f"with truth_schema == {TRUTH_SCHEMA_VERSION}")
                meta = obj
                continue
            missing = [k for k in TRUTH_RECORD_FIELDS if k not in obj]
            unknown = [k for k in obj if k not in TRUTH_RECORD_FIELDS]
            if missing or unknown:
                _fail(f"{path}:{lineno}: missing {missing} / undeclared "
                      f"{unknown} — declare in obs/validate.py:"
                      "TRUTH_RECORD_FIELDS first")
            for k, types in TRUTH_RECORD_FIELDS.items():
                if not isinstance(obj[k], types):
                    _fail(f"{path}:{lineno}: field {k!r} has type "
                          f"{type(obj[k]).__name__}")
            if obj["id"] in ids:
                _fail(f"{path}:{lineno}: duplicate read id "
                      f"{obj['id']!r}")
            ids.add(obj["id"])
            bad = set(obj["seq"]) - allowed
            if bad:
                _fail(f"{path}:{lineno}: seq contains non-ACGTN "
                      f"characters {sorted(bad)}")
            for b in obj["breakpoints"]:
                if not isinstance(b, int) or not 0 <= b <= len(obj["seq"]):
                    _fail(f"{path}:{lineno}: breakpoint {b!r} outside "
                          f"[0, {len(obj['seq'])}]")
            n += 1
            n_bases += len(obj["seq"])
            if obj["breakpoints"]:
                n_chimeric += 1
    if meta is None:
        _fail(f"{path}: empty truth sidecar (no meta line)")
    if meta.get("n_reads") != n:
        _fail(f"{path}: meta n_reads {meta.get('n_reads')} != "
              f"{n} record line(s)")
    if n < min_reads:
        _fail(f"{path}: {n} record(s) < required {min_reads}")
    return {"n_records": n, "n_bases": n_bases,
            "n_chimeric": n_chimeric}


def validate_slo(path: str, require_drained: bool = False
                 ) -> Dict[str, Any]:
    """Strictly validate a serving SLO artifact (``serve --slo-out``):
    every declared section present and typed, no undeclared fields, the
    rejection reasons within the closed vocabulary, and — the acceptance
    bar — the job-accounting identity

        accepted == completed + failed + cancelled + expired + journaled

    i.e. *no job is silently lost*: every admitted job either reached a
    terminal state or is journaled for resume. ``require_drained``
    additionally demands a clean drain with nothing left journaled."""
    with open(path) as fh:
        try:
            d = json.load(fh)
        except json.JSONDecodeError as e:
            _fail(f"{path}: not JSON ({e})")
    if not isinstance(d, dict) or d.get("slo_schema") != SLO_SCHEMA_VERSION:
        _fail(f"{path}: slo_schema != {SLO_SCHEMA_VERSION}")
    unknown = [k for k in d if k not in SLO_TOP_FIELDS]
    missing = [k for k in SLO_TOP_FIELDS if k not in d]
    if unknown or missing:
        _fail(f"{path}: undeclared fields {unknown} / missing {missing} "
              "— declare in obs/validate.py:SLO_TOP_FIELDS first")
    jobs = d["jobs"]
    if not isinstance(jobs, dict) or \
            sorted(jobs) != sorted(SLO_JOB_KEYS):
        _fail(f"{path}: jobs must have exactly keys {SLO_JOB_KEYS}")
    for k, v in jobs.items():
        if not isinstance(v, int) or v < 0:
            _fail(f"{path}: jobs.{k} must be a >=0 int")
    accounted = sum(jobs[k] for k in ("completed", "failed", "cancelled",
                                      "expired", "journaled"))
    if jobs["accepted"] != accounted:
        _fail(f"{path}: job accounting broken — accepted "
              f"{jobs['accepted']} != completed+failed+cancelled+expired"
              f"+journaled {accounted} (a job was silently lost)")
    rej = d["rejections"]
    if not isinstance(rej, dict):
        _fail(f"{path}: rejections must be an object")
    bad = [k for k in rej if k not in SLO_REJECT_REASONS]
    if bad:
        _fail(f"{path}: rejection reasons {bad} outside the closed "
              f"vocabulary {SLO_REJECT_REASONS}")
    for k, v in rej.items():
        if not isinstance(v, int) or v < 0:
            _fail(f"{path}: rejections.{k} must be a >=0 int")
    if sum(rej.values()) != jobs["rejected"]:
        _fail(f"{path}: jobs.rejected {jobs['rejected']} != sum of "
              f"per-reason rejections {sum(rej.values())}")
    q = d["queue"]
    if not isinstance(q, dict) or sorted(q) != sorted(SLO_QUEUE_KEYS):
        _fail(f"{path}: queue must have exactly keys {SLO_QUEUE_KEYS}")
    for k in SLO_QUEUE_KEYS:
        if not isinstance(q[k], int) or q[k] < 0:
            _fail(f"{path}: queue.{k} must be a >=0 int")
    lat = d["latency"]
    if not isinstance(lat, dict):
        _fail(f"{path}: latency must be an object")
    for cls, row in lat.items():
        if not isinstance(row, dict) or \
                sorted(row) != sorted(SLO_LATENCY_KEYS):
            _fail(f"{path}: latency[{cls!r}] must have exactly keys "
                  f"{SLO_LATENCY_KEYS}")
        if not isinstance(row["count"], int) or row["count"] <= 0:
            _fail(f"{path}: latency[{cls!r}].count must be a positive "
                  "int")
        for k in ("p50_s", "p99_s", "max_s"):
            if not isinstance(row[k], _NUM) or row[k] < 0:
                _fail(f"{path}: latency[{cls!r}].{k} must be a >=0 "
                      "number")
        if not row["p50_s"] <= row["p99_s"] <= row["max_s"]:
            _fail(f"{path}: latency[{cls!r}] percentiles not monotonic")
    dem = d["demotions"]
    if not isinstance(dem, dict) or any(
            not isinstance(v, int) or v < 0 for v in dem.values()):
        _fail(f"{path}: demotions must map tenant -> >=0 int")
    comp = d["compile"]
    if not isinstance(comp, dict) or \
            sorted(comp) != sorted(SLO_COMPILE_KEYS):
        _fail(f"{path}: compile must have exactly keys "
              f"{SLO_COMPILE_KEYS}")
    for k in SLO_COMPILE_KEYS:
        v = comp[k]
        if k == "tracing_hit_rate":
            if v is not None and (not isinstance(v, _NUM)
                                  or not 0.0 <= v <= 1.0):
                _fail(f"{path}: compile.tracing_hit_rate must be null "
                      "or in [0, 1]")
        elif not isinstance(v, _NUM) or v < 0:
            _fail(f"{path}: compile.{k} must be a >=0 number")
    drain = d["drain"]
    if not isinstance(drain, dict) or \
            sorted(drain) != sorted(SLO_DRAIN_KEYS):
        _fail(f"{path}: drain must have exactly keys {SLO_DRAIN_KEYS}")
    for k in SLO_DRAIN_KEYS:
        if not isinstance(drain[k], bool):
            _fail(f"{path}: drain.{k} must be a bool")
    if require_drained:
        if not drain["clean"]:
            _fail(f"{path}: drain was not clean")
        if jobs["journaled"] and not drain["requested"]:
            _fail(f"{path}: {jobs['journaled']} job(s) journaled without "
                  "a requested drain")
    return {"jobs": jobs, "n_latency_classes": len(lat),
            "rejections": sum(rej.values())}


# -- fleet LOAD artifact schema (obs/load.py writer) ------------------------
# One row per recorded fleet run. Declared here, independently of the
# writer, validated two-sidedly (missing AND undeclared fields fail) —
# the same drift discipline as the SLO schema above, extended fleet-wide:
# the row carries per-replica SLO slices plus the dispatcher's own books,
# and THREE accounting identities must hold simultaneously (validate_load
# docstring). A field added to the writer without being declared here is
# a test failure, and vice versa.
LOAD_SCHEMA_VERSION = 1
LOAD_ROW_FIELDS = ("load_schema", "scenario", "n_replicas", "backend",
                   "wall_s", "bases_per_sec_fleet", "jobs", "rejections",
                   "latency", "queue", "demotions", "accuracy", "handoff",
                   "heartbeat", "compile", "replicas")
LOAD_JOB_KEYS = ("routed", "rejected", "rejected_fleet", "handoffs",
                 "orphaned", "accepted", "completed", "failed",
                 "cancelled", "expired", "journaled")
LOAD_HANDOFF_KEYS = ("deaths", "handoffs", "orphaned")
LOAD_HEARTBEAT_KEYS = ("samples", "replicas_seen")
LOAD_ACCURACY_KEYS = ("n_scored", "identity_before", "identity_after",
                      "identity_after_min")
LOAD_REPLICA_KEYS = ("replica_id", "alive", "dead_reason", "drain_clean",
                     "jobs")
LOAD_COMPILE_KEYS = ("n_programs", "backend_compiles",
                     "tracing_hit_rate")
# replica-summed per-status counters on the fleet jobs section (the
# remaining LOAD_JOB_KEYS are dispatcher-side uniques)
LOAD_SUMMED_KEYS = ("accepted", "completed", "failed", "cancelled",
                    "expired", "journaled")


def validate_load(row: Any, where: str = "LOAD row") -> Dict[str, Any]:
    """Strictly validate one fleet LOAD row (``obs/load.py`` writer).

    Beyond the two-sided schema check, three accounting identities must
    hold — together they pin *zero jobs lost fleet-wide, through
    replica death and journal handoff*:

    A. ``accepted == completed+failed+cancelled+expired+journaled``
       (replica-summed: each replica's own SLO identity, summed — a
       handoff self-balances, +1 accepted at the survivor, +1 stale
       journaled entry at the dead replica);
    B. ``accepted == routed + handoffs`` (the dispatcher's unique-job
       books vs the replicas' accept counters — a double-counted or
       phantom accept breaks this side);
    C. ``journaled == handoffs + orphaned`` (every stale journal entry
       is attributable: either resubmitted to a survivor or an explicit
       orphan — a dropped handoff breaks this side).

    Per-replica slices are validated too (identity A per replica, sums
    reconciled against the fleet section). Raises ValidationError;
    returns a small summary on success."""
    if not isinstance(row, dict):
        _fail(f"{where}: not an object")
    if row.get("load_schema") != LOAD_SCHEMA_VERSION:
        _fail(f"{where}: load_schema != {LOAD_SCHEMA_VERSION}")
    unknown = [k for k in row if k not in LOAD_ROW_FIELDS]
    missing = [k for k in LOAD_ROW_FIELDS if k not in row]
    if unknown or missing:
        _fail(f"{where}: undeclared fields {unknown} / missing {missing} "
              "— declare in obs/validate.py:LOAD_ROW_FIELDS first")
    if not isinstance(row["scenario"], str) or not row["scenario"]:
        _fail(f"{where}: scenario must be a non-empty string")
    n_rep = row["n_replicas"]
    if not isinstance(n_rep, int) or n_rep < 1:
        _fail(f"{where}: n_replicas must be a >=1 int")
    if not isinstance(row["backend"], str) or not row["backend"]:
        _fail(f"{where}: backend must be a non-empty string")
    if not isinstance(row["wall_s"], _NUM) or row["wall_s"] <= 0:
        _fail(f"{where}: wall_s must be a positive number")
    bps = row["bases_per_sec_fleet"]
    if not isinstance(bps, _NUM) or bps < 0:
        _fail(f"{where}: bases_per_sec_fleet must be a >=0 number")

    jobs = row["jobs"]
    if not isinstance(jobs, dict) or sorted(jobs) != sorted(LOAD_JOB_KEYS):
        _fail(f"{where}: jobs must have exactly keys {LOAD_JOB_KEYS}")
    for k, v in jobs.items():
        if not isinstance(v, int) or v < 0:
            _fail(f"{where}: jobs.{k} must be a >=0 int")
    terminal = sum(jobs[k] for k in ("completed", "failed", "cancelled",
                                     "expired", "journaled"))
    if jobs["accepted"] != terminal:
        _fail(f"{where}: identity A broken — accepted {jobs['accepted']} "
              f"!= completed+failed+cancelled+expired+journaled "
              f"{terminal} (a job was silently lost or double-counted)")
    if jobs["accepted"] != jobs["routed"] + jobs["handoffs"]:
        _fail(f"{where}: identity B broken — accepted {jobs['accepted']} "
              f"!= routed {jobs['routed']} + handoffs "
              f"{jobs['handoffs']} (dispatcher books and replica "
              "counters disagree)")
    if jobs["journaled"] != jobs["handoffs"] + jobs["orphaned"]:
        _fail(f"{where}: identity C broken — journaled "
              f"{jobs['journaled']} != handoffs {jobs['handoffs']} + "
              f"orphaned {jobs['orphaned']} (a stale journal entry is "
              "unattributed)")

    rej = row["rejections"]
    if not isinstance(rej, dict):
        _fail(f"{where}: rejections must be an object")
    bad = [k for k in rej if k not in SLO_REJECT_REASONS]
    if bad:
        _fail(f"{where}: rejection reasons {bad} outside the closed "
              f"vocabulary {SLO_REJECT_REASONS}")
    for k, v in rej.items():
        if not isinstance(v, int) or v < 0:
            _fail(f"{where}: rejections.{k} must be a >=0 int")
    if sum(rej.values()) != jobs["rejected"]:
        _fail(f"{where}: jobs.rejected {jobs['rejected']} != sum of "
              f"per-reason rejections {sum(rej.values())}")

    lat = row["latency"]
    if not isinstance(lat, dict):
        _fail(f"{where}: latency must be an object")
    for cls, lrow in lat.items():
        if not isinstance(lrow, dict) or \
                sorted(lrow) != sorted(SLO_LATENCY_KEYS):
            _fail(f"{where}: latency[{cls!r}] must have exactly keys "
                  f"{SLO_LATENCY_KEYS}")
        if not isinstance(lrow["count"], int) or lrow["count"] <= 0:
            _fail(f"{where}: latency[{cls!r}].count must be a positive "
                  "int")
        for k in ("p50_s", "p99_s", "max_s"):
            if not isinstance(lrow[k], _NUM) or lrow[k] < 0:
                _fail(f"{where}: latency[{cls!r}].{k} must be a >=0 "
                      "number")
        if not lrow["p50_s"] <= lrow["p99_s"] <= lrow["max_s"]:
            _fail(f"{where}: latency[{cls!r}] percentiles not monotonic")
    n_lat = sum(v["count"] for v in lat.values())
    if n_lat != jobs["completed"]:
        _fail(f"{where}: latency counts sum to {n_lat} but "
              f"jobs.completed is {jobs['completed']} — a completed "
              "job's latency went unmeasured (or was double-measured)")

    q = row["queue"]
    if not isinstance(q, dict) or sorted(q) != sorted(SLO_QUEUE_KEYS):
        _fail(f"{where}: queue must have exactly keys {SLO_QUEUE_KEYS}")
    for k in SLO_QUEUE_KEYS:
        if not isinstance(q[k], int) or q[k] < 0:
            _fail(f"{where}: queue.{k} must be a >=0 int")

    dem = row["demotions"]
    if not isinstance(dem, dict) or any(
            not isinstance(v, int) or v < 0 for v in dem.values()):
        _fail(f"{where}: demotions must map tenant -> >=0 int")

    acc = row["accuracy"]
    if not isinstance(acc, dict):
        _fail(f"{where}: accuracy must be an object")
    for fam, arow in acc.items():
        if not isinstance(arow, dict) or \
                sorted(arow) != sorted(LOAD_ACCURACY_KEYS):
            _fail(f"{where}: accuracy[{fam!r}] must have exactly keys "
                  f"{LOAD_ACCURACY_KEYS}")
        if not isinstance(arow["n_scored"], int) or arow["n_scored"] < 1:
            _fail(f"{where}: accuracy[{fam!r}].n_scored must be a "
                  "positive int")
        for k in ("identity_before", "identity_after",
                  "identity_after_min"):
            if not isinstance(arow[k], _NUM) or not 0 <= arow[k] <= 1:
                _fail(f"{where}: accuracy[{fam!r}].{k} must be in "
                      "[0, 1]")
        if arow["identity_after_min"] > arow["identity_after"]:
            _fail(f"{where}: accuracy[{fam!r}] min above mean")

    ho = row["handoff"]
    if not isinstance(ho, dict) or \
            sorted(ho) != sorted(LOAD_HANDOFF_KEYS):
        _fail(f"{where}: handoff must have exactly keys "
              f"{LOAD_HANDOFF_KEYS}")
    for k in LOAD_HANDOFF_KEYS:
        if not isinstance(ho[k], int) or ho[k] < 0:
            _fail(f"{where}: handoff.{k} must be a >=0 int")
    if ho["handoffs"] != jobs["handoffs"] \
            or ho["orphaned"] != jobs["orphaned"]:
        _fail(f"{where}: handoff section disagrees with jobs section")
    if ho["deaths"] > n_rep:
        _fail(f"{where}: handoff.deaths {ho['deaths']} exceeds "
              f"n_replicas {n_rep}")

    hb = row["heartbeat"]
    if not isinstance(hb, dict) or \
            sorted(hb) != sorted(LOAD_HEARTBEAT_KEYS):
        _fail(f"{where}: heartbeat must have exactly keys "
              f"{LOAD_HEARTBEAT_KEYS}")
    if not isinstance(hb["samples"], int) or hb["samples"] < 1:
        _fail(f"{where}: heartbeat.samples must be a >=1 int (a fleet "
              "run with no heartbeat coverage measured nothing)")
    seen = hb["replicas_seen"]
    if not isinstance(seen, list) or not seen or any(
            not isinstance(s, str) for s in seen):
        _fail(f"{where}: heartbeat.replicas_seen must be a non-empty "
              "list of replica ids")

    comp = row["compile"]
    if not isinstance(comp, dict) or \
            sorted(comp) != sorted(LOAD_COMPILE_KEYS):
        _fail(f"{where}: compile must have exactly keys "
              f"{LOAD_COMPILE_KEYS}")
    for k in ("n_programs", "backend_compiles"):
        if not isinstance(comp[k], _NUM) or comp[k] < 0:
            _fail(f"{where}: compile.{k} must be a >=0 number")
    thr = comp["tracing_hit_rate"]
    if thr is not None and (not isinstance(thr, _NUM)
                            or not 0.0 <= thr <= 1.0):
        _fail(f"{where}: compile.tracing_hit_rate must be null or in "
              "[0, 1]")

    reps = row["replicas"]
    if not isinstance(reps, list) or len(reps) != n_rep:
        _fail(f"{where}: replicas must be a list of exactly "
              f"n_replicas={n_rep} slices")
    sums = {k: 0 for k in LOAD_SUMMED_KEYS}
    rejected_sum = 0
    ids = []
    for i, rs in enumerate(reps):
        rw = f"{where}: replicas[{i}]"
        if not isinstance(rs, dict) or \
                sorted(rs) != sorted(LOAD_REPLICA_KEYS):
            _fail(f"{rw} must have exactly keys {LOAD_REPLICA_KEYS}")
        if not isinstance(rs["replica_id"], str) or not rs["replica_id"]:
            _fail(f"{rw}.replica_id must be a non-empty string")
        ids.append(rs["replica_id"])
        if not isinstance(rs["alive"], bool):
            _fail(f"{rw}.alive must be a bool")
        if not isinstance(rs["dead_reason"], str):
            _fail(f"{rw}.dead_reason must be a string")
        if rs["drain_clean"] is not None and \
                not isinstance(rs["drain_clean"], bool):
            _fail(f"{rw}.drain_clean must be null or a bool")
        rj = rs["jobs"]
        if not isinstance(rj, dict) or \
                sorted(rj) != sorted(SLO_JOB_KEYS):
            _fail(f"{rw}.jobs must have exactly keys {SLO_JOB_KEYS}")
        for k, v in rj.items():
            if not isinstance(v, int) or v < 0:
                _fail(f"{rw}.jobs.{k} must be a >=0 int")
        accounted = sum(rj[k] for k in ("completed", "failed",
                                        "cancelled", "expired",
                                        "journaled"))
        if rj["accepted"] != accounted:
            _fail(f"{rw}: per-replica identity broken — accepted "
                  f"{rj['accepted']} != terminal+journaled {accounted}")
        for k in LOAD_SUMMED_KEYS:
            sums[k] += rj[k]
        rejected_sum += rj["rejected"]
    for k in LOAD_SUMMED_KEYS:
        if sums[k] != jobs[k]:
            _fail(f"{where}: replica-summed jobs.{k} {sums[k]} != fleet "
                  f"jobs.{k} {jobs[k]}")
    # rejection reconciliation: jobs.rejected_fleet rejections (fleet-
    # level duplicate detection) never reach a replica; the rest must
    # each have been seen server-side. Server-side rejections can still
    # exceed that floor (a handoff resubmission a draining survivor
    # bounces is server-visible only).
    if jobs["rejected_fleet"] > jobs["rejected"]:
        _fail(f"{where}: jobs.rejected_fleet {jobs['rejected_fleet']} "
              f"exceeds jobs.rejected {jobs['rejected']}")
    if rejected_sum < jobs["rejected"] - jobs["rejected_fleet"]:
        _fail(f"{where}: replicas saw {rejected_sum} rejections but the "
              f"dispatcher routed "
              f"{jobs['rejected'] - jobs['rejected_fleet']} to them")
    unseen = [s for s in seen if s not in ids]
    if unseen:
        _fail(f"{where}: heartbeat.replicas_seen {unseen} not in the "
              "replica slices")
    return {"jobs": jobs, "n_latency_classes": len(lat),
            "families": sorted(acc), "deaths": ho["deaths"]}


# -- factory artifact manifest schema (analysis/factory.py writer) ---------
# Same declaration discipline as the QC/SLO/LOAD schemas: declared here,
# independently of the writer, validated two-sidedly (missing AND
# undeclared fields fail), with a lint-guard round-trip test
# (tests/test_boot.py) driving the writer against this declaration. The
# manifest is the shipped-artifact contract — one row per compiled
# program plus the full cache-file inventory obs/boot.py verifies
# byte-for-byte before any replica trusts the artifact.
MANIFEST_SCHEMA_VERSION = 1
MANIFEST_TOP_FIELDS = {
    "manifest_schema": (int,),
    "version": (str,),             # content hash of the program set
    "backend": (str,),
    "interpret": _BOOL,
    "configs": (list,),            # e.g. ["config4", "config3", "mini"]
    "n_programs": (int,),
    "compile_s": _NUM,
    "wall_s": _NUM,
    "n_devices": (int,),           # compile topology (cache-key input)
    "jax_version": (str,),
    "by_config": (dict,),
    "files": (dict,),              # cache file -> exact byte size
    "programs": (list,),
}
MANIFEST_ROW_FIELDS = {
    "entry": (str,),               # registry entry (dmesh:* = salted)
    "sig": (str,),                 # unsalted obs/compilecache.signature
    "config": (str,),
    "backend": (str,),
    "compile_ms": _NUM,
    "persistent": (str, type(None)),   # hit | miss | null (cache off)
    "cache_key": (str, type(None)),    # cache file this compile landed
    "artifact_bytes": (int,),
}
MANIFEST_BY_CONFIG_KEYS = ("n_programs", "compile_s",
                           "backend_compiles", "wall_s")


def validate_manifest(obj: Any, where: str = "manifest"
                      ) -> Dict[str, Any]:
    """Strictly validate a factory artifact manifest: two-sided schema
    on the top level and every program row, the per-config rollup keyed
    exactly by the declared configs, program counts reconciled, and
    every attributed cache key present in the file inventory. Returns a
    small summary."""
    if not isinstance(obj, dict):
        _fail(f"{where}: not an object")
    if obj.get("manifest_schema") != MANIFEST_SCHEMA_VERSION:
        _fail(f"{where}: manifest_schema != {MANIFEST_SCHEMA_VERSION}")
    unknown = [k for k in obj if k not in MANIFEST_TOP_FIELDS]
    missing = [k for k in MANIFEST_TOP_FIELDS if k not in obj]
    if unknown or missing:
        _fail(f"{where}: undeclared fields {unknown} / missing "
              f"{missing} — declare in obs/validate.py:"
              "MANIFEST_TOP_FIELDS first")
    for k, types in MANIFEST_TOP_FIELDS.items():
        if not isinstance(obj[k], types):
            _fail(f"{where}: field {k!r} has type "
                  f"{type(obj[k]).__name__}, expected one of "
                  f"{[t.__name__ for t in types]}")
    if not obj["version"]:
        _fail(f"{where}: version must be non-empty")
    for name, size in obj["files"].items():
        if not isinstance(name, str) or not isinstance(size, int) \
                or size < 0:
            _fail(f"{where}: files must map name -> >=0 byte size "
                  f"(bad entry {name!r}: {size!r})")
    if obj["n_programs"] != len(obj["programs"]):
        _fail(f"{where}: n_programs {obj['n_programs']} != "
              f"{len(obj['programs'])} program row(s)")
    cfg_counts: Dict[str, int] = {}
    for i, row in enumerate(obj["programs"]):
        rw = f"{where}: programs[{i}]"
        if not isinstance(row, dict):
            _fail(f"{rw}: not an object")
        r_unknown = [k for k in row if k not in MANIFEST_ROW_FIELDS]
        r_missing = [k for k in MANIFEST_ROW_FIELDS if k not in row]
        if r_unknown or r_missing:
            _fail(f"{rw}: undeclared fields {r_unknown} / missing "
                  f"{r_missing} — declare in obs/validate.py:"
                  "MANIFEST_ROW_FIELDS first")
        for k, types in MANIFEST_ROW_FIELDS.items():
            if not isinstance(row[k], types):
                _fail(f"{rw}: field {k!r} has type "
                      f"{type(row[k]).__name__}")
        if row["persistent"] is not None \
                and row["persistent"] not in LEDGER_PCACHE:
            _fail(f"{rw}: persistent {row['persistent']!r} outside "
                  f"{LEDGER_PCACHE}")
        if row["compile_ms"] < 0 or row["artifact_bytes"] < 0:
            _fail(f"{rw}: compile_ms/artifact_bytes must be >= 0")
        if row["cache_key"] is not None \
                and row["cache_key"] not in obj["files"]:
            _fail(f"{rw}: cache_key {row['cache_key']!r} not in the "
                  "file inventory")
        cfg_counts[row["config"]] = cfg_counts.get(row["config"], 0) + 1
    if sorted(obj["by_config"]) != sorted(obj["configs"]):
        _fail(f"{where}: by_config keys {sorted(obj['by_config'])} != "
              f"declared configs {sorted(obj['configs'])}")
    for cfg, summary in obj["by_config"].items():
        if not isinstance(summary, dict) or \
                sorted(summary) != sorted(MANIFEST_BY_CONFIG_KEYS):
            _fail(f"{where}: by_config[{cfg!r}] must have exactly keys "
                  f"{MANIFEST_BY_CONFIG_KEYS}")
        for k in MANIFEST_BY_CONFIG_KEYS:
            if not isinstance(summary[k], _NUM) or summary[k] < 0:
                _fail(f"{where}: by_config[{cfg!r}].{k} must be a >=0 "
                      "number")
        if summary["n_programs"] != cfg_counts.get(cfg, 0):
            _fail(f"{where}: by_config[{cfg!r}].n_programs "
                  f"{summary['n_programs']} != {cfg_counts.get(cfg, 0)} "
                  "program row(s) for that config")
    keys = [(r["entry"], r["sig"]) for r in obj["programs"]]
    if len(set(keys)) != len(keys):
        _fail(f"{where}: duplicate (entry, sig) program rows")
    return {"version": obj["version"], "backend": obj["backend"],
            "n_programs": obj["n_programs"],
            "n_files": len(obj["files"]),
            "artifact_bytes": sum(obj["files"].values())}


# -- boot scoreboard row schema (obs/boot.py writer) ------------------------
# One row per measured boot: a subprocess census walk (`boot run`, modes
# cold/artifact) or an in-process replica start under a BootSpan
# (serve/fleet.py). Same two-sided discipline; the itemized violations
# carry a closed kind vocabulary so `make boot-check`'s absolute checks
# stay machine-auditable.
BOOT_SCHEMA_VERSION = 1
BOOT_ROW_FIELDS = {
    "metric": (str,),              # "boot"
    "schema": (int,),
    "config": (str,),              # config4 | config3 | mini | serve
    "backend": (str,),
    "mode": (str,),                # cold | artifact
    "replica": (str, type(None)),  # fleet replica id, if any
    "boot_wall_s": _NUM,
    "compile_s": _NUM,
    "n_backend_compiles": (int,),
    "persistent_hits": (int,),
    "persistent_misses": (int,),
    "hit_rate": (int, float, type(None)),
    "n_programs": (int,),
    "violations": (list,),         # observed ⊄ shipped, itemized
    "manifest_version": (str, type(None)),
    "artifact": (str, type(None)),
}
BOOT_MODES = ("cold", "artifact")
BOOT_VIOLATION_KINDS = ("compiled-at-boot", "unmanifested")
BOOT_VIOLATION_FIELDS = {"kind": (str,), "entry": (str,),
                         "sig": (str,), "detail": (str,)}


def validate_boot_row(row: Any, where: str = "BOOT row") -> None:
    """Strictly validate one boot scoreboard row: two-sided schema,
    closed mode/violation vocabularies, the hit-rate consistency
    identity (null iff no cache-mediated compiles, else
    hits/(hits+misses)), and artifact-mode provenance (an artifact boot
    must name the manifest version and artifact it booted from)."""
    if not isinstance(row, dict):
        _fail(f"{where}: not an object")
    if row.get("metric") != "boot" \
            or row.get("schema") != BOOT_SCHEMA_VERSION:
        _fail(f"{where}: not a boot row with schema == "
              f"{BOOT_SCHEMA_VERSION}")
    unknown = [k for k in row if k not in BOOT_ROW_FIELDS]
    missing = [k for k in BOOT_ROW_FIELDS if k not in row]
    if unknown or missing:
        _fail(f"{where}: undeclared fields {unknown} / missing "
              f"{missing} — declare in obs/validate.py:BOOT_ROW_FIELDS "
              "first")
    for k, types in BOOT_ROW_FIELDS.items():
        if not isinstance(row[k], types):
            _fail(f"{where}: field {k!r} has type "
                  f"{type(row[k]).__name__}, expected one of "
                  f"{[t.__name__ for t in types]}")
    if row["mode"] not in BOOT_MODES:
        _fail(f"{where}: mode {row['mode']!r} outside {BOOT_MODES}")
    for k in ("boot_wall_s", "compile_s"):
        if row[k] < 0:
            _fail(f"{where}: {k} must be >= 0")
    for k in ("n_backend_compiles", "persistent_hits",
              "persistent_misses", "n_programs"):
        if row[k] < 0:
            _fail(f"{where}: {k} must be >= 0")
    hits, misses = row["persistent_hits"], row["persistent_misses"]
    if hits + misses > row["n_backend_compiles"]:
        _fail(f"{where}: persistent hits+misses {hits + misses} exceed "
              f"n_backend_compiles {row['n_backend_compiles']}")
    rate = row["hit_rate"]
    if hits + misses == 0:
        if rate is not None:
            _fail(f"{where}: hit_rate must be null with no "
                  "cache-mediated compiles")
    else:
        want = hits / (hits + misses)
        if not isinstance(rate, _NUM) or abs(rate - want) > 1e-3:
            _fail(f"{where}: hit_rate {rate!r} inconsistent with "
                  f"hits/(hits+misses) = {want:.4f}")
    for i, v in enumerate(row["violations"]):
        vw = f"{where}: violations[{i}]"
        if not isinstance(v, dict):
            _fail(f"{vw}: not an object")
        v_unknown = [k for k in v if k not in BOOT_VIOLATION_FIELDS]
        v_missing = [k for k in BOOT_VIOLATION_FIELDS if k not in v]
        if v_unknown or v_missing:
            _fail(f"{vw}: undeclared fields {v_unknown} / missing "
                  f"{v_missing}")
        for k, types in BOOT_VIOLATION_FIELDS.items():
            if not isinstance(v[k], types):
                _fail(f"{vw}: field {k!r} has type "
                      f"{type(v[k]).__name__}")
        if v["kind"] not in BOOT_VIOLATION_KINDS:
            _fail(f"{vw}: kind {v['kind']!r} outside "
                  f"{BOOT_VIOLATION_KINDS}")
    if row["mode"] == "artifact":
        if row["manifest_version"] is None or row["artifact"] is None:
            _fail(f"{where}: artifact-mode row must carry "
                  "manifest_version and artifact provenance")
    elif row["violations"]:
        _fail(f"{where}: cold-mode row cannot carry violations "
              "(reconciliation is an artifact-mode proof)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="proovread-tpu-torch-obs-validate",
        description="Validate --trace / --metrics-out artifacts.")
    ap.add_argument("--trace", help="trace-event JSONL file")
    ap.add_argument("--metrics", help="metrics JSON file")
    ap.add_argument("--qc", help="per-read QC JSONL file (--qc-out)")
    ap.add_argument("--compile-ledger", dest="compile_ledger",
                    help="compile-ledger JSONL file (--compile-ledger); "
                         "with --trace also checks that the ledger's "
                         "backend-compile ms reconcile with the span "
                         "tree's compile split")
    ap.add_argument("--slo", help="serving SLO artifact (serve --slo-out)")
    ap.add_argument("--truth-sidecar", dest="truth_sidecar",
                    help="truth sidecar JSONL (io/simulate.py writer; "
                         "the CLI --truth input)")
    ap.add_argument("--require-drained", action="store_true",
                    help="SLO artifact must show a clean drain")
    ap.add_argument("--min-qc-reads", type=int, default=0,
                    help="minimum per-read QC record count")
    ap.add_argument("--min-coverage", type=float, default=0.0,
                    help="minimum root-span child coverage (0..1)")
    ap.add_argument("--require-attribution", action="store_true",
                    help="bucket spans must carry the cost/memory "
                         "attribution keys (profiled runs)")
    ap.add_argument("--require", default="",
                    help="comma-separated counter names that must exist")
    args = ap.parse_args(argv)
    if not (args.trace or args.metrics or args.qc or args.slo
            or args.compile_ledger or args.truth_sidecar):
        ap.error("need --trace, --metrics, --qc, --compile-ledger, "
                 "--truth-sidecar and/or --slo")
    try:
        if args.trace:
            stats = validate_trace(
                args.trace, args.min_coverage,
                require_attribution=args.require_attribution)
            print(f"trace OK: {json.dumps(stats)}")
        if args.metrics:
            req: Tuple[str, ...] = tuple(
                s for s in args.require.split(",") if s)
            stats = validate_metrics(args.metrics, require=req)
            print(f"metrics OK: {json.dumps(stats)}")
        if args.qc:
            stats = validate_qc(args.qc, min_reads=args.min_qc_reads)
            print(f"qc OK: {json.dumps({k: v for k, v in stats.items() if k != 'aggregate'})}")
        if args.compile_ledger:
            stats = validate_compile_ledger(args.compile_ledger)
            print("compile-ledger OK: "
                  + json.dumps({k: v for k, v in stats.items()
                                if k != 'census'}))
            if args.trace:
                rstats = reconcile_compile_ledger(args.compile_ledger,
                                                  args.trace)
                print(f"compile-ledger reconciles: {json.dumps(rstats)}")
        if args.truth_sidecar:
            stats = validate_truth_sidecar(args.truth_sidecar)
            print(f"truth-sidecar OK: {json.dumps(stats)}")
        if args.slo:
            stats = validate_slo(args.slo,
                                 require_drained=args.require_drained)
            print(f"slo OK: {json.dumps(stats)}")
    except ValidationError as e:
        print(f"validation FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
