"""The history gates of ``proovread_tpu_torch/obs/`` held against the JAX
package's: ``accuracy_check``, ``compile_check``, ``boot_check`` and
``load_check``, their ``load_rows`` and their ``main check``; the
accuracy recorder (``record_workload``) with its subprocess stubbed; and
the port's own ``reconcile_ledger`` and ``never-shipped`` cross-link.

Inputs: rows made from a seed with numpy in the shapes of the reference's
gate tests (``tests/test_accuracy.py:TestGate``,
``tests/test_compilecache.py:TestCompileCheckGate``,
``tests/test_boot.py:TestBootCheckGate``, ``tests/test_fleet.py:
TestLoadGate``), and copies of the committed ``ACCURACY_r10.json``,
``COMPILE_r09.json``, ``BOOT_r19.json`` and ``LOAD_r18.json`` with their
mutations (an identity drop, a p99 growth, a wall growth, an unusable
row, a ``cuda`` row that must not pool with a ``cpu`` or ``tpu`` row).
Tolerance: none. Verdict dicts, ``main check``'s exit code, standard
output and standard error lines (the census cross-links, which read
files beside each package, aside) and, for the recorder, every row field
but the wall are equal. No command-line subprocess runs here; the real
``record --device cpu`` of config 4, held against ``ACCURACY_r10.json``,
is marked ``slow``."""

import copy
import hashlib
import json
import os
import shutil
import subprocess

import numpy as np
import pytest

from proovread_tpu.obs import accuracy as jaccuracy
from proovread_tpu.obs import boot as jboot
from proovread_tpu.obs import census as jcensus
from proovread_tpu.obs import load as jload
from proovread_tpu_torch.obs import accuracy as taccuracy
from proovread_tpu_torch.obs import boot as tboot
from proovread_tpu_torch.obs import census as tcensus
from proovread_tpu_torch.obs import load as tload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# gate name -> (port module, JAX module, gate function, committed file)
GATES = {
    "accuracy": (taccuracy, jaccuracy, "accuracy_check", "ACCURACY_r10.json"),
    "compile": (tcensus, jcensus, "compile_check", "COMPILE_r09.json"),
    "boot": (tboot, jboot, "boot_check", "BOOT_r19.json"),
    "load": (tload, jload, "load_check", "LOAD_r18.json"),
}


def _jitter(rng, x, frac=0.02):
    return round(float(x * (1.0 + frac * abs(rng.standard_normal()))), 4)


def _entries(rows, prefix="X"):
    return [{"source": f"{prefix}_r{i:02d}.json", "row": r}
            for i, r in enumerate(rows)]


# -- rows, in the shapes of the reference's gate tests ----------------------

def _acc_row(rng, identity_after, identity_before=0.85, config=4,
             backend="cpu", mesh=None, introduced=None, **kw):
    row = {"metric": "accuracy", "schema": 1, "config": config,
           "backend": backend, "mesh_shards": mesh,
           "identity_before": identity_before,
           "identity_after": round(identity_after
                                   - 1e-4 * abs(rng.standard_normal()), 6),
           "introduced": introduced}
    row.update(kw)
    return row


def _census_row(rng, config=4, backend="cpu", warm_s=0.1, nprog=40,
                rate=0.98, cold_s=120.0):
    return {"metric": "compile_census", "schema": 1, "config": config,
            "backend": backend, "cap_bases": None, "n_reads": 6,
            "total_bases": 44880, "cache_dir": "x",
            "cold": {"wall_s": _jitter(rng, 400.0),
                     "compile_s": _jitter(rng, cold_s),
                     "n_programs": nprog, "backend_compiles": nprog,
                     "persistent_hit_rate": 0.0},
            "warm": {"wall_s": _jitter(rng, 350.0),
                     "compile_s": _jitter(rng, warm_s),
                     "n_programs": nprog, "backend_compiles": nprog,
                     "persistent_hit_rate": rate},
            "cache_hit_rate": rate}


def _boot_row(rng, **over):
    row = {"metric": "boot", "schema": 1, "config": "mini",
           "backend": "cpu", "mode": "artifact", "replica": None,
           "boot_wall_s": _jitter(rng, 10.0), "compile_s": 1.0,
           "n_backend_compiles": 2, "persistent_hits": 2,
           "persistent_misses": 0, "hit_rate": 1.0, "n_programs": 2,
           "violations": [], "manifest_version": "abc",
           "artifact": "artifact"}
    row.update(over)
    return row


def _cold(rng, **over):
    return _boot_row(rng, **{"mode": "cold", "manifest_version": None,
                             "artifact": None, "persistent_hits": 0,
                             "persistent_misses": 2, "hit_rate": 0.0,
                             **over})


def _load_row(rng, **over):
    """A consistent 2-replica LOAD row (one death, two handoffs), its
    throughput and latencies jittered."""
    row = {
        "load_schema": 1, "scenario": "slam", "n_replicas": 2,
        "backend": "cpu", "wall_s": 10.0,
        "bases_per_sec_fleet": _jitter(rng, 500.0),
        "jobs": {"routed": 8, "rejected": 3, "rejected_fleet": 0,
                 "handoffs": 2, "orphaned": 0, "accepted": 10,
                 "completed": 8, "failed": 0, "cancelled": 0,
                 "expired": 0, "journaled": 2},
        "rejections": {"bad-request": 2, "parse-error": 1},
        "latency": {
            "512": {"count": 5, "p50_s": 1.0, "p99_s": _jitter(rng, 2.0),
                    "max_s": 2.5},
            "1024": {"count": 3, "p50_s": 2.0, "p99_s": _jitter(rng, 4.0),
                     "max_s": 4.5}},
        "queue": {"depth_peak": 3, "depth_final": 0},
        "demotions": {},
        "accuracy": {"clr": {"n_scored": 10, "identity_before": 0.85,
                             "identity_after": 0.97,
                             "identity_after_min": 0.90}},
        "handoff": {"deaths": 1, "handoffs": 2, "orphaned": 0},
        "heartbeat": {"samples": 50, "replicas_seen": ["r0", "r1"]},
        "compile": {"n_programs": 4, "backend_compiles": 4,
                    "tracing_hit_rate": 0.9},
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


def _accuracy_scenario(name, rng):
    r = lambda ia, **kw: _acc_row(rng, ia, **kw)  # noqa: E731
    intro = lambda s: {"sub": s, "ins": 1, "del": 0}  # noqa: E731
    return {
        "healthy": [r(0.998), r(0.9985), r(0.9982)],
        "floor_first_row": [r(0.91)],
        "uplift": [r(0.96, identity_before=0.97)],
        "no_identity_before": [r(0.99, identity_before=None)],
        "identity_drop": [r(0.999), r(0.9988), r(0.993)],
        "introduced": [r(0.998, introduced=intro(4)),
                       r(0.998, introduced=intro(5)),
                       r(0.998, introduced=intro(80))],
        "introduced_small": [r(0.998, introduced=intro(4)),
                             r(0.998, introduced=intro(12))],
        "pools": [r(0.9995, backend="tpu"), r(0.9990, backend="tpu"),
                  r(0.9960, backend="cpu"),
                  r(0.9961, config="dmesh", mesh=4),
                  r(0.9700, backend="cuda"), r(0.9990, backend=None)],
        "cuda_apart": [r(0.999, backend="cpu"), r(0.999, backend="cpu"),
                       r(0.990, backend="cuda")],
        "skipped_rows": [r(0.998),
                         {"metric": "accuracy", "config": 4,
                          "backend": "cpu", "identity_after": None,
                          "accuracy_skipped": "wall budget fired"},
                         r(0.998)],
        "no_data": [{"metric": "accuracy", "config": 4,
                     "identity_after": None}],
        "window": [r(0.90), r(0.90), r(0.90), r(0.999), r(0.999),
                   r(0.999), r(0.994)],
    }[name]


def _compile_scenario(name, rng):
    r = lambda **kw: _census_row(rng, **kw)  # noqa: E731
    return {
        "stable": [r(), r(), r()],
        "first_row": [r()],
        "extra_program": [r(), r(), r(nprog=42)],
        "slower_warm": [r(), r(), r(warm_s=5.0)],
        "forced_miss": [r(), r(), r(rate=0.5)],
        "rate_absent": [r(rate=None), r(rate=None), r()],
        "backends_apart": [r(backend="tpu", nprog=3200, warm_s=0.2),
                           r(backend="cpu", nprog=40),
                           r(backend="cuda", nprog=7),
                           r(backend=None, nprog=3300, warm_s=0.2)],
        "config_as_text": [r(config="4"), r(config=4), r(config="4",
                                                         nprog=45)],
        "small_jitter": [r(warm_s=0.05), r(warm_s=0.08), r(warm_s=0.3)],
        "unusable": [r(), {"metric": "compile_census", "config": 4,
                           "backend": "cpu", "cold": None}, r()],
        "no_data": [{"metric": "compile_census", "config": 4}],
    }[name]


def _boot_scenario(name, rng):
    r = lambda **kw: _boot_row(rng, **kw)  # noqa: E731
    c = lambda **kw: _cold(rng, **kw)  # noqa: E731
    viol = [{"kind": "compiled-at-boot", "entry": "x", "sig": "y",
             "detail": "persistent_cache=miss"}]
    return {
        "clean_first_row": [r()],
        "violation_first_row": [r(violations=viol)],
        "hit_rate_floor": [r(persistent_hits=1, persistent_misses=1,
                             hit_rate=0.5)],
        "zero_compiles": [r(n_backend_compiles=0, persistent_hits=0,
                            persistent_misses=0, hit_rate=None,
                            compile_s=0.0)],
        "wall_ok": [r(boot_wall_s=10.0), r(boot_wall_s=10.5),
                    r(boot_wall_s=9.8), r(boot_wall_s=12.0)],
        "wall_regression": [r(boot_wall_s=10.0), r(boot_wall_s=10.5),
                            r(boot_wall_s=9.8), r(boot_wall_s=20.0)],
        "cold_wall": [c(boot_wall_s=10.0), c(boot_wall_s=10.0),
                      c(boot_wall_s=40.0)],
        "pools": [r(), c(), r(config="config4"), r(backend="cuda"),
                  r(backend="tpu", boot_wall_s=1.0)],
        "cuda_apart": [r(boot_wall_s=1.0), r(boot_wall_s=1.0),
                       r(backend="cuda", boot_wall_s=30.0)],
        "invalid_row": [{"metric": "boot", "schema": 1}],
        "invalid_then_valid": [r(), {"metric": "boot", "schema": 1,
                                     "config": "mini"}, r()],
    }[name]


def _load_scenario(name, rng):
    r = lambda **kw: _load_row(rng, **kw)  # noqa: E731
    if name == "clean":
        return [r(), r()]
    if name == "p99":
        bad = r()
        bad["latency"]["512"] = {"count": 5, "p50_s": 3.0, "p99_s": 6.5,
                                 "max_s": 7.0}
        return [r(), bad]
    if name == "p99_boundary":
        # growth past the fraction, and exactly the absolute floor
        rows = [r(), r()]
        rows[0]["latency"]["512"]["p99_s"] = 1.5
        rows[1]["latency"]["512"].update(p99_s=3.5, max_s=3.5)
        return rows
    if name == "throughput":
        return [r(), r(bases_per_sec_fleet=100.0)]
    if name == "identity_break":
        bad = r()
        bad["jobs"]["completed"] -= 1
        return [r(), bad]
    if name == "orphaned":
        bad = r()
        bad["jobs"].update(orphaned=1, handoffs=1, routed=9)
        bad["handoff"].update(orphaned=1, handoffs=1)
        return [r(), bad]
    if name == "accuracy_drop":
        bad = r()
        bad["accuracy"]["clr"]["identity_after"] = 0.94
        return [r(), bad]
    if name == "uplift_inverted":
        inv = r()
        inv["accuracy"]["clr"].update(identity_before=0.98,
                                      identity_after=0.90)
        return [inv]
    if name == "family_gone":
        new = r()
        new["accuracy"] = {"ont": dict(new["accuracy"]["clr"])}
        return [r(), new]
    if name == "class_gone":
        new = r()
        del new["latency"]["1024"]
        new["latency"]["512"]["count"] = 8
        return [r(), new]
    if name == "bad_baseline":
        bad = r()
        bad["jobs"]["completed"] -= 1
        return [bad, r(), r()]
    if name == "shapes_apart":
        four = r(n_replicas=4, bases_per_sec_fleet=2000.0)
        return [four, r(), r(backend="cuda", bases_per_sec_fleet=50.0),
                r(backend=None)]
    raise KeyError(name)


SCENARIOS = {
    "accuracy": (_accuracy_scenario,
                 ("healthy", "floor_first_row", "uplift",
                  "no_identity_before", "identity_drop", "introduced",
                  "introduced_small", "pools", "cuda_apart",
                  "skipped_rows", "no_data", "window")),
    "compile": (_compile_scenario,
                ("stable", "first_row", "extra_program", "slower_warm",
                 "forced_miss", "rate_absent", "backends_apart",
                 "config_as_text", "small_jitter", "unusable",
                 "no_data")),
    "boot": (_boot_scenario,
             ("clean_first_row", "violation_first_row", "hit_rate_floor",
              "zero_compiles", "wall_ok", "wall_regression", "cold_wall",
              "pools", "cuda_apart", "invalid_row",
              "invalid_then_valid")),
    "load": (_load_scenario,
             ("clean", "p99", "p99_boundary", "throughput",
              "identity_break", "orphaned",
              "accuracy_drop", "uplift_inverted", "family_gone",
              "class_gone", "bad_baseline", "shapes_apart")),
}
CASES = [(g, n) for g, (_, names) in SCENARIOS.items() for n in names]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("gate,name", CASES,
                         ids=[f"{g}-{n}" for g, n in CASES])
def test_gate_matches_jax(gate, name, seed):
    port, ref, fn, _ = GATES[gate]
    rows = SCENARIOS[gate][0](name, np.random.default_rng(seed))
    entries = _entries(rows)
    want = getattr(ref, fn)(copy.deepcopy(entries))
    assert getattr(port, fn)(copy.deepcopy(entries)) == want
    assert want["verdict"] in ("PASS", "REGRESSION", "NO-DATA")


def test_constants_are_the_reference():
    names = {
        "accuracy": ("SCHEMA_VERSION", "IDENTITY_FLOOR", "IDENTITY_DROP",
                     "INTRODUCED_GROWTH", "INTRODUCED_MIN_ABS",
                     "BASELINE_WINDOW"),
        "compile": ("SCHEMA_VERSION", "WARM_COMPILE_THRESHOLD",
                    "WARM_COMPILE_MIN_ABS_S", "PROGRAMS_THRESHOLD",
                    "HIT_RATE_DROP", "BASELINE_WINDOW", "DEFAULT_CAPS",
                    "MIN_WARM_HIT_RATE"),
        "boot": ("SCHEMA_VERSION", "MIN_ARTIFACT_HIT_RATE",
                 "BOOT_WALL_THRESHOLD", "BOOT_WALL_MIN_ABS_S",
                 "BASELINE_WINDOW"),
        "load": ("SCHEMA_VERSION", "THROUGHPUT_DROP", "P99_GROWTH",
                 "P99_MIN_ABS_S", "IDENTITY_DROP", "BASELINE_WINDOW"),
    }
    for gate, consts in names.items():
        port, ref = GATES[gate][:2]
        for c in consts:
            assert getattr(port, c) == getattr(ref, c), (gate, c)
    vals = [4.0, 1.0, 3.0, 2.0]
    for port in (taccuracy, tcensus, tboot, tload):
        assert port._median(vals) == jload._median(vals) == 2.5


# -- the committed history and its mutations --------------------------------

def _mutate(gate, rows, mutation):
    """The committed rows and one more: a copy of the newest row, changed
    as ``mutation`` says (None: no row added)."""
    new = copy.deepcopy(rows[-1])
    if mutation == "as_is":
        return rows
    if mutation == "cuda_row":
        new["backend"] = "cuda"
        return rows + [new]
    if gate == "accuracy":
        if mutation == "identity_drop":
            new["identity_after"] = round(new["identity_after"] - 0.01, 6)
        elif mutation == "unusable":
            new["identity_after"] = None
            new["accuracy_skipped"] = "run timed out"
        elif mutation == "uplift":
            new["identity_before"] = new["identity_after"] + 0.001
    elif gate == "compile":
        if mutation == "wall_growth":
            new["warm"]["compile_s"] += 3.0
        elif mutation == "unusable":
            new["warm"] = None
        elif mutation == "programs":
            new["cold"]["n_programs"] += 5
    elif gate == "boot":
        if mutation == "wall_growth":
            new["boot_wall_s"] *= 3
        elif mutation == "unusable":
            del new["hit_rate"]
        elif mutation == "violation":
            new["violations"] = [{"kind": "unmanifested", "entry": "e",
                                  "sig": "s", "detail": "d"}]
    elif gate == "load":
        if mutation == "p99_growth":
            for lr in new["latency"].values():
                lr["p99_s"] *= 3
                lr["max_s"] = max(lr["max_s"], lr["p99_s"])
        elif mutation == "unusable":
            new["jobs"]["completed"] -= 1
        elif mutation == "identity_drop":
            for a in new["accuracy"].values():
                a["identity_after"] -= 0.02
    return rows + [new]


MUTATIONS = {
    "accuracy": ("as_is", "identity_drop", "uplift", "unusable",
                 "cuda_row"),
    "compile": ("as_is", "wall_growth", "programs", "unusable",
                "cuda_row"),
    "boot": ("as_is", "wall_growth", "violation", "unusable", "cuda_row"),
    "load": ("as_is", "p99_growth", "identity_drop", "unusable",
             "cuda_row"),
}
HISTORY_CASES = [(g, m) for g, ms in MUTATIONS.items() for m in ms]


@pytest.fixture
def no_crosslinks(monkeypatch):
    """The census cross-links off in both packages: they read the files
    beside each package (the JAX one its own XLA census predictor) and
    are held apart below."""
    monkeypatch.setattr(jcensus, "_crosslink_predicted_census",
                        lambda: None)
    monkeypatch.setattr(jcensus, "_crosslink_manifest", lambda: None)
    monkeypatch.setattr(tcensus, "_crosslink_manifest", lambda: None)


@pytest.mark.parametrize("gate,mutation", HISTORY_CASES,
                         ids=[f"{g}-{m}" for g, m in HISTORY_CASES])
def test_committed_history_matches_jax(tmp_path, capsys, no_crosslinks,
                                       gate, mutation):
    port, ref, fn, committed = GATES[gate]
    with open(os.path.join(ROOT, committed)) as fh:
        rows = [json.loads(ln) for ln in fh if ln.strip()]
    rows = _mutate(gate, rows, mutation)
    path = tmp_path / committed
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    entries = port.load_rows([str(path)])
    assert entries == ref.load_rows([str(path)])
    verdict = getattr(port, fn)(entries)
    assert verdict == getattr(ref, fn)(entries)
    if mutation in ("as_is", "cuda_row"):
        assert verdict["verdict"] == "PASS"
    if mutation == "cuda_row":
        assert any("/cuda" in p for p in verdict["pools"])
    outs = []
    for mod in (port, ref):
        rc = mod.main(["check", str(path)])
        got = capsys.readouterr()
        outs.append((rc, got.out, got.err.splitlines()))
    assert outs[0] == outs[1]
    assert outs[0][0] == (1 if verdict["verdict"] == "REGRESSION" else 0)


@pytest.mark.parametrize("gate", sorted(GATES))
def test_default_paths_match_jax(tmp_path, monkeypatch, capsys,
                                 no_crosslinks, gate):
    """``check`` with no files: nothing found exits 0 with the reference's
    line; round-numbered files first, the rest after them."""
    port, ref, _, committed = GATES[gate]
    monkeypatch.chdir(tmp_path)
    outs = []
    for mod in (port, ref):
        rc = mod.main(["check"])
        outs.append((rc, capsys.readouterr().err))
    assert outs[0] == outs[1] and outs[0][0] == 0
    stem = committed.split("_")[0]
    with open(os.path.join(ROOT, committed)) as fh:
        text = fh.read()
    for name in (f"{stem}_record.json", f"{stem}_r02.json",
                 f"{stem}_r01.json", f"{stem}_local.json"):
        (tmp_path / name).write_text(text)
    assert port._resolve_paths([]) == ref._resolve_paths([])
    assert port._resolve_paths([])[:2] == [f"{stem}_r01.json",
                                           f"{stem}_r02.json"]
    outs = []
    for mod in (port, ref):
        rc = mod.main(["check"])
        got = capsys.readouterr()
        outs.append((rc, got.out, got.err.splitlines()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("gate", sorted(GATES))
def test_load_rows_formats_match_jax(tmp_path, gate):
    """One JSON value a file (an object, or a list where the gate takes
    one), JSON lines with garbage lines, and rows of other histories
    skipped."""
    port, ref, _, committed = GATES[gate]
    with open(os.path.join(ROOT, committed)) as fh:
        rows = [json.loads(ln) for ln in fh if ln.strip()]
    (tmp_path / "one.json").write_text(json.dumps(rows[0]))
    (tmp_path / "list.json").write_text(json.dumps(rows))
    (tmp_path / "lines.json").write_text(
        json.dumps(rows[-1]) + "\nnot json\n" + json.dumps({"metric": "x"})
        + "\n" + json.dumps(rows[0]) + "\n")
    paths = [str(tmp_path / n) for n in ("one.json", "list.json",
                                         "lines.json")]
    assert port.load_rows(paths) == ref.load_rows(paths)


# -- the recorder, its subprocess stubbed ------------------------------------

def _canned_accuracy(rng):
    n = int(rng.integers(3, 9))
    return {"n_scored": n, "n_classified": n,
            "identity_before": {"mean": round(float(rng.uniform(.85, .9)),
                                              6)},
            "identity_after": {"mean": round(float(rng.uniform(.99, 1)),
                                             6)},
            "errors_before": {"sub": 10, "ins": 20, "del": 5},
            "errors_after": {"sub": 1, "ins": 0, "del": 0},
            "introduced": {"sub": 0, "ins": 0, "del": 0},
            "chimera": None}


class FakeRun:
    """``subprocess.run`` of the scored command line: writes a canned QC
    artifact and compile ledger where the command names them, keeps the
    command, the digests of its input files and its config, and exits
    ``rc``."""

    def __init__(self, seed, backend="cpu", rc=0, accuracy=True):
        self.acc = _canned_accuracy(np.random.default_rng(seed))
        self.backend, self.rc, self.accuracy = backend, rc, accuracy
        self.calls = []

    def __call__(self, cmd, **kw):
        arg = lambda flag: cmd[cmd.index(flag) + 1]  # noqa: E731
        digests = {f: hashlib.sha256(open(arg(f), "rb").read()).hexdigest()
                   for f in ("-l", "-s", "--truth")}
        cfg = json.load(open(arg("-c"))) if "-c" in cmd else None
        self.calls.append({"cmd": cmd, "digests": digests, "cfg": cfg})
        agg = {"accuracy": self.acc if self.accuracy else None}
        with open(arg("--qc-out"), "w") as fh:
            fh.write(json.dumps({"qc_schema": 1, "aggregate": agg}) + "\n")
        census = {"backend": self.backend} if self.backend else {}
        with open(arg("--compile-ledger"), "w") as fh:
            fh.write(json.dumps({"ledger_schema": 1,
                                 "census": census}) + "\n")
        return subprocess.CompletedProcess(cmd, self.rc)


def _strip(cmd):
    """A command line without the interpreter and its temp paths, the
    module name generic."""
    out, skip = [], False
    for a in cmd[1:]:
        if skip:
            skip = False
            continue
        if a in ("-l", "-s", "-p", "--truth", "--qc-out", "--compile-ledger",
                 "-c"):
            out.append(a)
            skip = True
            continue
        out.append(a.replace("proovread_tpu_torch", "PKG")
                   .replace("proovread_tpu.cli", "PKG"))
    return out


@pytest.mark.parametrize("workload", ["4", "3", "dmesh"])
def test_record_workload_matches_jax(monkeypatch, workload):
    """The same workload in both packages: the same FASTQs and truth
    sidecar (byte digests), the same config file and flags (the port adds
    ``--device``), and the same row but for its wall."""
    fakes = {}
    rows = {}
    for name, mod in (("port", taccuracy), ("jax", jaccuracy)):
        fakes[name] = FakeRun(seed=int(workload) if workload != "dmesh"
                              else 9)
        monkeypatch.setattr(mod.subprocess, "run", fakes[name])
        kw = {"device": "cpu"} if name == "port" else {}
        rows[name] = mod.record_workload(workload, cache_dir="auto", **kw)
    tcall, jcall = fakes["port"].calls[0], fakes["jax"].calls[0]
    assert tcall["digests"] == jcall["digests"]
    assert tcall["cfg"] == jcall["cfg"]
    tcmd = _strip(tcall["cmd"])
    i = tcmd.index("--device")
    assert tcmd[i:i + 2] == ["--device", "cpu"]
    assert tcmd[:i] + tcmd[i + 2:] == _strip(jcall["cmd"])
    for r in rows.values():
        r.pop("wall_s")
    assert rows["port"] == rows["jax"]
    assert rows["port"]["backend"] == "cpu"
    if workload == "dmesh":
        assert rows["port"]["mesh_shards"] == 4
        assert "--mesh-shards" in tcmd


def test_record_backend_is_the_ledgers(monkeypatch):
    """The row's backend is the subprocess's ledger census, never the
    device asked for; a ledger without one, a failed run and a QC artifact
    without scores raise; an unknown workload is refused."""
    fake = FakeRun(seed=1, backend="cuda")
    monkeypatch.setattr(taccuracy.subprocess, "run", fake)
    row = taccuracy.record_workload("4", cache_dir=None, device="cpu")
    assert row["backend"] == "cuda"
    assert "--compile-cache" not in fake.calls[0]["cmd"]
    for bad, match in ((FakeRun(1, backend=None), "names no backend"),
                       (FakeRun(1, rc=3), "exited 3"),
                       (FakeRun(1, accuracy=False), "no accuracy")):
        monkeypatch.setattr(taccuracy.subprocess, "run", bad)
        with pytest.raises(RuntimeError, match=match):
            taccuracy.record_workload("4", cache_dir="/tmp/c", device="cpu")
    with pytest.raises(ValueError, match="workloads 3, 4 and dmesh"):
        taccuracy.record_workload("5")


def test_record_cli_then_check(monkeypatch, tmp_path, capsys):
    """``record --workloads 4 --device cpu --out F`` appends a row that
    ``check`` passes, in both packages' gates; the ledger is kept where
    asked."""
    fake = FakeRun(seed=4)
    monkeypatch.setattr(taccuracy.subprocess, "run", fake)
    out = tmp_path / "ACCURACY_rec.json"
    assert taccuracy.main(["record", "--workloads", "4", "--device", "cpu",
                           "--cache-dir", "none", "--out", str(out)]) == 0
    cmd = fake.calls[0]["cmd"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert "--compile-cache" not in cmd
    row = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == row
    assert row["backend"] == "cpu" and row["config"] == 4
    for mod in (taccuracy, jaccuracy):
        assert mod.main(["check", str(out)]) == 0
    led = tmp_path / "led.jsonl"
    taccuracy.record_workload("4", device="cpu", ledger_out=str(led))
    assert json.loads(led.read_text())["census"]["backend"] == "cpu"


@pytest.mark.slow
def test_record_config4_on_cpu_equals_r10():
    """The real scored command line (``--device cpu``) on config 4: the
    scoring fields equal the JAX package's recorded row."""
    row = taccuracy.record_workload("4", cache_dir=None, device="cpu")
    with open(os.path.join(ROOT, "ACCURACY_r10.json")) as fh:
        want = [json.loads(ln) for ln in fh if ln.strip()]
    want = next(r for r in want if r["config"] == 4)
    for k in ("n_scored", "n_classified", "identity_before",
              "identity_after", "errors_before", "errors_after",
              "introduced", "chimera", "n_reads", "total_bases"):
        assert row[k] == want[k], k
    assert row["backend"] == "cpu"


# -- the port's own: reconcile_ledger and the never-shipped cross-link ------

@pytest.fixture
def artifact(monkeypatch, tmp_path):
    """(kernels, artifact dir): an artifact built with the build stubbed
    (``test_torch_compile.stub_build``)."""
    from test_torch_compile import stub_build

    from proovread_tpu_torch.analysis import factory
    kernels = stub_build(monkeypatch, tmp_path / "build")
    art = str(tmp_path / "art")
    factory.build_artifact(art, fresh=True)
    return kernels, art


def _ledger(path, kernels, entries):
    """A compile ledger of a run that called ``entries`` (name, sig)."""
    from proovread_tpu_torch.obs.compilecache import Ledger
    led = Ledger(backend="cpu")
    for entry, sig in entries:
        led.call_end(led.call_begin(entry, sig))
    led._on_backend_compile(0.1, compiled=False)
    led.write_jsonl(str(path))
    return str(path)


def test_reconcile_ledger_and_crosslink(artifact, tmp_path, capsys):
    kernels, art = artifact
    manifest = tboot.verify_artifact(art)
    v = kernels.digest()
    clean = _ledger(tmp_path / "LEDGER_a.jsonl", kernels, [
        ("bsw_expand_v2", v), ("fused_pass", v), ("lcs_lengths", v),
        ("bsw_expand_v2", v)])
    assert tboot.reconcile_ledger(manifest, clean) == []
    stale = _ledger(tmp_path / "LEDGER_b.jsonl", kernels, [
        ("bsw_expand_v2", v), ("edit_alignments", "0" * 16),
        ("edit_alignments", "0" * 16), ("call_consensus", "0" * 16)])
    got = tboot.reconcile_ledger(manifest, stale)
    assert [(x["kind"], x["entry"], x["sig"]) for x in got] == [
        ("unmanifested", "edit_alignments", "0" * 16)]
    # a source the manifest does not ship
    short = dict(manifest, programs=[p for p in manifest["programs"]
                                     if p["entry"] != "lcs.cu"])
    assert [x["entry"] for x in tboot.reconcile_ledger(short, clean)] == \
        ["lcs_lengths"]
    assert tboot.main(["reconcile", "--artifact", art,
                       "--ledger", clean]) == 0
    assert tboot.main(["reconcile", "--artifact", art,
                       "--ledger", stale]) == 1
    capsys.readouterr()
    tcensus._crosslink_manifest(art, [stale, clean])
    assert "observed within shipped" in capsys.readouterr().err
    tcensus._crosslink_manifest(art, [clean, stale])
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and err[0].startswith(
        f"compile-check: never-shipped: edit_alignments {'0' * 16}")
    tcensus._crosslink_manifest(str(tmp_path / "none"), [stale])
    assert capsys.readouterr().err == ""
    shutil.rmtree(os.path.join(art, "cache"))
    tcensus._crosslink_manifest(art, [stale])
    assert "cross-link unavailable" in capsys.readouterr().err
