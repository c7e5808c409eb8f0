"""The perf-regression gate (``proovread_tpu_torch/obs/regress.py``) held
against the JAX package's (``proovread_tpu/obs/regress.py``).

Inputs: bench rows made from a seed with numpy, in the shapes of the
reference's own gate tests (``tests/test_profile.py:TestPerfRegress``,
``tests/test_accuracy.py:TestBenchIdentityCheck``), and copies of the
committed ``BENCH_r0*.json`` history with their mutations (a bases/s drop,
a wall growth, an identity drop, an unusable row, a ``cuda`` row that must
not pool with the ``cpu`` rows). Tolerance: none. The verdict dicts, the
``report`` tables (its title and its italic notes aside) and ``main``'s
exit code, standard output and standard error lines are equal."""

import copy
import glob
import json
import os
import shutil

import numpy as np
import pytest

from proovread_tpu.obs import regress as jregress
from proovread_tpu_torch.obs import regress as tregress

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jitter(rng, x, frac=0.02):
    return round(float(x * (1.0 + frac * rng.standard_normal())), 4)


def _row(rng, value=100_000.0, phases="default", **kw):
    row = {"metric": "corrected_bases_per_sec_per_chip",
           "value": None if value is None else _jitter(rng, value),
           "unit": "bases/sec/chip", "config": 4, "backend": "cpu",
           "wall_s": _jitter(rng, 10.0)}
    if phases == "default":
        phases = {"bucket": {"count": 10, "total_s": 20.0,
                             "compile_s": 0.1},
                  "pass": {"count": 40, "total_s": 12.0, "compile_s": 0.1}}
    if phases is not None:
        row["phases"] = {cat: dict(ph, total_s=_jitter(rng, ph["total_s"]))
                         for cat, ph in phases.items()}
    row.update(kw)
    return row


def _tables(lines):
    """A report's lines but its title and its italic notes."""
    return [ln for ln in lines[1:] if not ln.startswith("_")]


def _entries(rows):
    return [{"source": f"BENCH_r{i:02d}.json", "n": i, "rc": 0, "row": r}
            for i, r in enumerate(rows, 1)]


ACC = {"n_scored": 6}          # the accuracy scoreboard's detail marker


def _scenario(name, rng):
    """One history, as ``load_rows`` entries."""
    r = lambda **kw: _row(rng, **kw)  # noqa: E731
    if name == "clean":
        return _entries([r(), r(), r(), r(value=104_000.0)])
    if name == "value_drop":
        return _entries([r(), r(), r(), r(value=60_000.0)])
    if name == "phase_growth":
        return _entries([r(), r(), r(), r(phases={
            "bucket": {"count": 10, "total_s": 55.0, "compile_s": 0.1},
            "pass": {"count": 40, "total_s": 12.0, "compile_s": 0.1}})])
    if name == "phase_noise":
        tiny = {"io": {"count": 1, "total_s": 0.01, "compile_s": 0.0}}
        return _entries([r(phases=tiny)] * 3 + [r(phases={
            "io": {"count": 1, "total_s": 0.02, "compile_s": 0.0}})])
    if name == "phase_missing":
        return _entries([r(), r(), r(phases=None)])
    if name == "phase_new":
        extra = {"bucket": {"count": 10, "total_s": 20.0, "compile_s": 0.1},
                 "score": {"count": 1, "total_s": 2.0, "compile_s": 0.0}}
        return _entries([r(), r(), r(phases=extra)])
    if name == "wall_growth":
        return _entries([r(), r(), r(wall_s=30.0)])
    if name == "dead_rows":
        entries = _entries([r(), r(), r(value=101_000.0)])
        entries.insert(2, {"source": "BENCH_dead.json", "n": 99, "rc": 1,
                           "row": None})
        entries.insert(3, {"source": "BENCH_to.json", "n": 98, "rc": 124,
                           "row": r(value=None, timeout=True)})
        return entries
    if name == "config_mismatch":
        return _entries([r(config=1), r(config=1),
                         r(config=3, value=10.0)])
    if name == "no_data":
        return [{"source": "x", "n": 1, "rc": 1, "row": None}]
    if name == "identity_drop":
        return _entries([r(identity_after=0.999, accuracy=ACC),
                         r(identity_after=0.9985, accuracy=ACC),
                         r(identity_after=0.98, accuracy=ACC)])
    if name == "identity_legacy":
        return _entries([r(identity_after=0.999),
                         r(identity_after=0.99, accuracy=ACC)])
    if name == "identity_skipped":
        return _entries([r(identity_after=0.999, accuracy=ACC),
                         r(identity_after=None,
                           accuracy_skipped="scoring failed")])
    if name == "identity_first":
        return _entries([r(), r(identity_after=0.99, accuracy=ACC)])
    if name == "cuda_apart":
        return _entries([r(), r(), r(backend="cuda", value=5_000.0)])
    if name == "window":
        return _entries([r(value=10_000.0)] * 3
                        + [r(), r(), r(), r(value=90_000.0)])
    raise KeyError(name)


SCENARIOS = ("clean", "value_drop", "phase_growth", "phase_noise",
             "phase_missing", "phase_new", "wall_growth", "dead_rows",
             "config_mismatch", "no_data", "identity_drop",
             "identity_legacy", "identity_skipped", "identity_first",
             "cuda_apart", "window")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", SCENARIOS)
def test_perf_check_matches_jax(name, seed):
    entries = _scenario(name, np.random.default_rng(seed))
    want = jregress.perf_check(copy.deepcopy(entries))
    assert tregress.perf_check(copy.deepcopy(entries)) == want
    assert _tables(tregress.perf_report(entries)) == \
        _tables(jregress.perf_report(entries))


def test_thresholds_are_the_reference():
    for name in ("SCHEMA_VERSION", "VALUE_THRESHOLD", "PHASE_THRESHOLD",
                 "MIN_ABS_S", "IDENTITY_DROP", "BASELINE_WINDOW"):
        assert getattr(tregress, name) == getattr(jregress, name), name
    vals = [3.0, 1.0, 2.0, 10.0]
    assert tregress._median(vals) == jregress._median(vals)
    assert tregress._median(vals[:3]) == jregress._median(vals[:3])


# -- the committed history and its mutations --------------------------------

def _history(tmp_path, mutation):
    """Copies of the committed BENCH files, then the mutation's file (a
    copy of the newest row, changed) as BENCH_r08.json; the paths."""
    paths = []
    for src in sorted(glob.glob(os.path.join(ROOT, "BENCH_r0*.json"))):
        dst = tmp_path / os.path.basename(src)
        shutil.copyfile(src, dst)
        paths.append(str(dst))
    if mutation == "as_is":
        return paths
    with open(paths[-1]) as fh:
        newest = json.load(fh)
    row = copy.deepcopy(newest.get("parsed", newest))
    if mutation == "value_drop":
        row["value"] = row["value"] * 0.5
    elif mutation == "wall_growth":
        row["wall_s"] = row["wall_s"] * 3
    elif mutation == "phase_growth":
        for ph in row["phases"].values():
            ph["total_s"] = ph["total_s"] * 2 + 1.0
    elif mutation == "identity_drop":
        row["identity_after"] = row["identity_after"] - 0.05
        row["accuracy"] = dict(ACC)
    elif mutation == "unusable":
        row = None
    elif mutation == "cuda_row":
        row.update(backend="cuda", value=row["value"] * 0.01)
    # a bare row, as the newest committed one (bare rows sort after the
    # driver's numbered wrappers); a dead run is a wrapper
    p = tmp_path / "BENCH_r08.json"
    p.write_text(json.dumps(row if row is not None else
                            {"n": 8, "rc": 124, "parsed": None}))
    return paths + [str(p)]


MUTATIONS = ("as_is", "value_drop", "wall_growth", "phase_growth",
             "identity_drop", "unusable", "cuda_row")


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_committed_history_matches_jax(tmp_path, capsys, mutation):
    paths = _history(tmp_path, mutation)
    entries = tregress.load_rows(paths)
    assert entries == jregress.load_rows(paths)
    verdict = tregress.perf_check(entries)
    assert verdict == jregress.perf_check(entries)
    if mutation in ("value_drop", "wall_growth", "phase_growth"):
        assert verdict["verdict"] == "REGRESSION"
    elif mutation in ("as_is", "unusable", "cuda_row"):
        assert verdict["verdict"] == "PASS"
    outs = []
    for mod in (tregress, jregress):
        rc = mod.main(["check"] + paths)
        got = capsys.readouterr()
        outs.append((rc, got.out, got.err.splitlines()))
    assert outs[0] == outs[1]
    reports = []
    for mod in (tregress, jregress):
        assert mod.main(["report"] + paths) == 0
        reports.append(_tables(capsys.readouterr().out.splitlines()))
    assert reports[0] == reports[1]


def test_default_paths_and_empty_history(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    for mod in (tregress, jregress):
        assert mod.main(["check"]) == 0
        assert mod.main(["report"]) == 1
    err = capsys.readouterr().err.splitlines()
    assert err[:2] == err[2:] and err[0] == \
        "perf: no bench history files found"
    for name in ("BENCH_r02.json", "BENCH_r01.json", "BENCH_local.json"):
        (tmp_path / name).write_text(json.dumps(
            _row(np.random.default_rng(3))))
    assert tregress._resolve_paths([]) == jregress._resolve_paths([])


def test_load_rows_formats_match_jax(tmp_path):
    """Wrapper objects, bare rows and JSON lines of either, and garbage
    lines skipped, in history order."""
    rng = np.random.default_rng(5)
    (tmp_path / "BENCH_r01.json").write_text(
        json.dumps({"n": 1, "rc": 0, "parsed": _row(rng)}))
    (tmp_path / "BENCH_r02.json").write_text(json.dumps(_row(rng)) + "\n")
    (tmp_path / "BENCH_r03.json").write_text(
        json.dumps({"n": 3, "rc": 124, "parsed": None}))
    (tmp_path / "BENCH_r04.json").write_text(
        json.dumps({"n": 4, "rc": 0, "parsed": _row(rng)}) + "\nnot json\n"
        + json.dumps(_row(rng)) + "\n[1, 2]\n")
    paths = sorted(str(p) for p in tmp_path.iterdir())
    entries = tregress.load_rows(paths)
    assert entries == jregress.load_rows(paths)
    assert [e["n"] for e in entries] == [1, 3, 4, None, None]
