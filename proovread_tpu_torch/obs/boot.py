"""The warm boot as a measured event (port of ``proovread_tpu/obs/boot.py``).

``analysis/factory.py`` ships the kernel library as one versioned
artifact (``cache/`` + ``manifest.json``). This module makes a boot from
it observable:

- :func:`verify_artifact` proves an artifact intact before anything loads
  it: the manifest validates strictly (``obs/validate.py:
  validate_manifest``), every file of its inventory exists under
  ``cache/`` at its exact size and no other file is there, and its
  ``version`` equals the digest of this package's own sources and flags
  (``kernels.digest``): a stale artifact is refused naming both digests
  and is never loaded.
- :func:`fetch_artifact` is a replica's download: verify at the source,
  copy the cache, verify the copy.
- ``run`` measures: per mode (``cold``, an empty cache dir: ``nvcc``
  builds; ``artifact``, a verified copy of the artifact's cache: the
  library loads), a **subprocess** runs the factory's boot child (a fresh
  process, so nothing loaded in memory fakes the boot) and one BOOT row
  (``obs/validate.py:BOOT_ROW_FIELDS``) records its wall (interpreter,
  torch import, CUDA context, build or load, one launch of each kernel
  entry), the build windows and the library cache's hits and misses.
- :func:`reconcile` proves the boot used what was shipped: every build
  window that is not a cache hit (``nvcc`` ran) is a
  ``compiled-at-boot`` violation; a loaded library, or a source an
  entry ran, that the manifest lacks is ``unmanifested``.
  :func:`reconcile_ledger` does the same for a real run's compile
  ledger: each kernel entry it saw whose program the artifact does not
  ship (another library version, or a source the manifest lacks) is
  ``unmanifested``.
- :class:`BootSpan` is the in-process boot row a server writes around its
  start from an artifact (``serve/server.py``, ``serve/fleet.py``).
- ``check`` is the reference's gate over ``BOOT_*.json`` history: rows
  pool per (config, backend, mode), so a row of the card (``cuda``)
  never pools with the JAX package's; an artifact-mode row with any
  violation, or a cache hit rate under ``MIN_ARTIFACT_HIT_RATE`` when it
  built anything, is a regression on the first row, and the boot wall
  gates against the rolling-median baseline of its pool. Exit 1 and
  ``BOOT-REGRESSION:`` lines on any breach.

The reference's ``warm-tier1``, which copies an artifact into the CPU
tests' XLA cache, has no counterpart: the port's CPU tests build nothing.
Nor has its ``stale_programs``: the manifest's programs are the library's
sources, and a run loads the whole library.

    python -m proovread_tpu_torch.obs.boot run --artifact ART
    python -m proovread_tpu_torch.obs.boot verify --artifact ART
    python -m proovread_tpu_torch.obs.boot reconcile --artifact ART \\
        (--report REPORT.json | --ledger LEDGER.jsonl)
    python -m proovread_tpu_torch.obs.boot check [BOOT_*.json ...]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

# one rolling-median implementation for every history gate
from proovread_tpu_torch.obs.regress import (_median, history_paths,
                                             json_values)

SCHEMA_VERSION = 1

# the gate's thresholds (the reference's): an artifact-mode boot's cache
# hit rate must reach this on the first row (a boot that built nothing
# passes) ...
MIN_ARTIFACT_HIT_RATE = 0.98
# ... and a boot's wall may grow by this fraction of the rolling-median
# baseline
BOOT_WALL_THRESHOLD = 0.50
# ... when the absolute growth also exceeds this
BOOT_WALL_MIN_ABS_S = 5.0
# rolling baseline: median over up to this many prior usable rows
BASELINE_WINDOW = 3

_FACTORY_MOD = "proovread_tpu_torch.analysis.factory"


def _log(msg: str) -> None:
    print(f"[boot] {msg}", file=sys.stderr, flush=True)


# -- artifact loading and verification --------------------------------------

def load_manifest(artifact_dir: str) -> Dict[str, Any]:
    """Read and strictly validate ``<artifact>/manifest.json``."""
    from proovread_tpu_torch.analysis.factory import MANIFEST_NAME
    from proovread_tpu_torch.obs.validate import validate_manifest
    path = os.path.join(artifact_dir, MANIFEST_NAME)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{artifact_dir}: no {MANIFEST_NAME}: not a kernel-build "
            "artifact (build one with python -m "
            "proovread_tpu_torch.analysis.factory --artifact DIR)")
    with open(path) as fh:
        manifest = json.load(fh)
    validate_manifest(manifest, where=path)
    return manifest


def verify_artifact(artifact_dir: str,
                    manifest: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """The manifest validates, its version is this package's library
    digest, and ``cache/`` holds exactly its inventory at the recorded
    sizes. Returns the manifest; raises ``ValidationError``."""
    from proovread_tpu_torch import kernels
    from proovread_tpu_torch.analysis.factory import (CACHE_SUBDIR,
                                                      cache_files)
    from proovread_tpu_torch.obs.validate import ValidationError
    if manifest is None:
        manifest = load_manifest(artifact_dir)
    want_version = kernels.digest()
    if manifest["version"] != want_version:
        raise ValidationError(
            f"{artifact_dir}: stale artifact: it ships library version "
            f"{manifest['version']}, this package's sources and flags are "
            f"{want_version}")
    have = cache_files(os.path.join(artifact_dir, CACHE_SUBDIR))
    want = manifest["files"]
    problems = []
    for name, size in sorted(want.items()):
        if name not in have:
            problems.append(f"missing cache file {name!r} ({size} B)")
        elif have[name] != size:
            problems.append(f"cache file {name!r} is {have[name]} B, "
                            f"manifest says {size} B")
    for name in sorted(set(have) - set(want)):
        problems.append(f"unmanifested cache file {name!r} "
                        f"({have[name]} B)")
    if problems:
        raise ValidationError(
            f"{artifact_dir}: artifact fails verification (version "
            f"{manifest['version']}): " + "; ".join(problems))
    return manifest


def fetch_artifact(artifact_dir: str, dest_cache_dir: str
                   ) -> Dict[str, Any]:
    """Verify the artifact, copy its cache to ``dest_cache_dir`` (an old
    copy is replaced) and verify the copy against the same manifest.
    Returns the manifest."""
    from proovread_tpu_torch.analysis.factory import (CACHE_SUBDIR,
                                                      cache_files)
    from proovread_tpu_torch.obs.validate import ValidationError
    manifest = verify_artifact(artifact_dir)
    if os.path.isdir(dest_cache_dir):
        shutil.rmtree(dest_cache_dir)
    shutil.copytree(os.path.join(artifact_dir, CACHE_SUBDIR),
                    dest_cache_dir)
    if cache_files(dest_cache_dir) != manifest["files"]:
        raise ValidationError(
            f"{dest_cache_dir}: artifact copy does not match the manifest "
            f"inventory (version {manifest['version']})")
    return manifest


# -- reconciliation: observed within shipped ----------------------------------

def manifest_keys(manifest: Dict[str, Any]) -> set:
    return {(p["entry"], p["sig"]) for p in manifest["programs"]}


def _compiled_at_boot(rows) -> List[Dict[str, Any]]:
    return [{"kind": "compiled-at-boot", "entry": r["entry"],
             "sig": r["sig"],
             "detail": f"persistent_cache={r.get('persistent_cache')} "
                       f"compile_ms={r.get('compile_ms')}"}
            for r in rows if r.get("kind") == "backend_compile"
            and r.get("persistent_cache") != "hit"]


def reconcile(manifest: Dict[str, Any], report: Dict[str, Any]
              ) -> List[Dict[str, Any]]:
    """Every way a boot report (``factory --report-out``) used more than
    the manifest ships: ``compiled-at-boot`` (a build window that ran
    ``nvcc``, or ran with no cache), ``unmanifested`` (a loaded library
    not in the inventory, or a source an entry ran that the manifest
    lacks). Empty: the proof."""
    violations = _compiled_at_boot(report.get("rows", ()))
    lib = report.get("library")
    if lib is not None and lib not in manifest["files"]:
        violations.append({
            "kind": "unmanifested", "entry": lib,
            "sig": report.get("version") or "-",
            "detail": "loaded library absent from the manifest's files"})
    shipped = manifest_keys(manifest)
    for prog in report.get("programs", ()):
        if (prog["entry"], prog["sig"]) not in shipped:
            violations.append({
                "kind": "unmanifested", "entry": prog["entry"],
                "sig": prog["sig"],
                "detail": "source an entry ran, absent from the manifest"})
    return violations


def reconcile_ledger(manifest: Dict[str, Any], ledger_path: str
                     ) -> List[Dict[str, Any]]:
    """Reconcile a real run's compile ledger with the manifest: each
    kernel entry the run called (a ``retrace`` row) whose program the
    manifest does not ship is ``unmanifested``, once: its library is
    another version (the row's ``sig``, the library digest, is not the
    manifest's ``version``) or its source is not a manifest program.
    Glue entries, which build nothing, are not programs."""
    from proovread_tpu_torch.kernels import ENTRY_SOURCES
    sources = {p["entry"] for p in manifest["programs"]}
    violations: List[Dict[str, Any]] = []
    seen: set = set()
    with open(ledger_path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if lineno == 1 or not line:
                continue                     # meta line
            row = json.loads(line)
            src = ENTRY_SOURCES.get(row.get("entry"))
            if row.get("kind") != "retrace" or src is None:
                continue
            key = (row["entry"], row["sig"])
            if key in seen or (row["sig"] == manifest["version"]
                               and src in sources):
                continue
            seen.add(key)
            violations.append({
                "kind": "unmanifested", "entry": row["entry"],
                "sig": row["sig"],
                "detail": f"{ledger_path}:{lineno}: observed program "
                          "absent from the manifest"})
    return violations


# -- the in-process boot row (servers) ----------------------------------------

class BootSpan:
    """A ledger's build counters around a boot (a server's start from an
    artifact); :meth:`row` is the BOOT row of the span, each build window
    inside it that ran ``nvcc`` a ``compiled-at-boot`` violation in
    artifact mode."""

    def __init__(self, ledger):
        self._ledger = ledger
        self._t0 = time.monotonic()
        self._compiles = ledger.backend_compiles
        self._compile_s = ledger.backend_compile_s
        self._hits = ledger.persistent_hits
        self._misses = ledger.persistent_misses
        self._row0 = len(ledger.rows)

    def row(self, *, config: str, mode: str,
            manifest: Optional[Dict[str, Any]] = None,
            artifact: Optional[str] = None,
            replica: Optional[str] = None) -> Dict[str, Any]:
        led = self._ledger
        hits = led.persistent_hits - self._hits
        misses = led.persistent_misses - self._misses
        span_rows = led.rows[self._row0:]
        return {
            "metric": "boot", "schema": SCHEMA_VERSION,
            "config": config, "backend": led.backend(), "mode": mode,
            "replica": replica,
            "boot_wall_s": round(time.monotonic() - self._t0, 3),
            "compile_s": round(led.backend_compile_s - self._compile_s, 3),
            "n_backend_compiles": led.backend_compiles - self._compiles,
            "persistent_hits": hits, "persistent_misses": misses,
            "hit_rate": (round(hits / (hits + misses), 4)
                         if hits + misses else None),
            "n_programs": sum(1 for r in span_rows
                              if r.get("kind") == "retrace"),
            "violations": (_compiled_at_boot(span_rows)
                           if mode == "artifact" else []),
            "manifest_version": (manifest or {}).get("version"),
            "artifact": artifact,
        }


def artifact_boot(state_dir: str, *, artifact_dir: str, device: str,
                  replica: Optional[str] = None,
                  fetch_to: Optional[str] = None,
                  manifest: Optional[Dict[str, Any]] = None):
    """A server's warm boot, as one BOOT row in ``<state_dir>/boot.json``:
    under the installed compile ledger (else one of its own for the
    span), fetch the artifact into ``fetch_to`` and point the kernel build
    directory at the copy (when given; a fleet fetches once for all its
    replicas and passes the ``manifest``), then load the library on the
    card: a build window that must be a cache hit. Returns (manifest,
    row)."""
    from proovread_tpu_torch import kernels
    from proovread_tpu_torch.obs import compilecache
    from proovread_tpu_torch.obs.validate import validate_boot_row
    led = compilecache.current() or compilecache.Ledger(backend=device)
    with compilecache.scope(led):
        span = BootSpan(led)
        if fetch_to is not None:
            manifest = fetch_artifact(artifact_dir, fetch_to)
            compilecache.enable_persistent_cache(fetch_to)
        if device == "cuda":
            kernels.lib()
        row = span.row(config="serve", mode="artifact", manifest=manifest,
                       artifact=artifact_dir, replica=replica)
    validate_boot_row(row, where=f"{replica} boot")
    with open(os.path.join(state_dir, "boot.json"), "w") as fh:
        fh.write(json.dumps(row) + "\n")
    return manifest, row


# -- measured boots (subprocesses, `boot run`) ---------------------------------

def boot_once(mode: str, artifact_dir: Optional[str], workdir: str, *,
              device: str = "cuda", timeout: float = 1800.0
              ) -> Tuple[Dict[str, Any], float]:
    """One boot in a fresh subprocess, from an empty cache dir (``cold``)
    or a verified copy of the artifact's cache (``artifact``). Returns
    (report, wall): the whole subprocess, what a replica pays."""
    cache_dir = os.path.join(workdir, f"{mode}_cache")
    if mode == "artifact":
        if not artifact_dir:
            raise ValueError("artifact mode needs --artifact")
        fetch_artifact(artifact_dir, cache_dir)
    elif os.path.isdir(cache_dir):
        shutil.rmtree(cache_dir)
    report_path = os.path.join(workdir, f"report_{mode}.json")
    cmd = [sys.executable, "-m", _FACTORY_MOD, "--cache-dir", cache_dir,
           "--report-out", report_path, "--device", device]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=os.getcwd(), timeout=timeout)
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"boot subprocess exited {proc.returncode}: "
                           f"{' '.join(cmd)}")
    with open(report_path) as fh:
        return json.load(fh), wall


def boot_row(mode: str, report: Dict[str, Any], wall_s: float, *,
             manifest: Optional[Dict[str, Any]] = None,
             artifact: Optional[str] = None) -> Dict[str, Any]:
    """The BOOT row of one measured boot."""
    from proovread_tpu_torch.analysis.factory import CONFIG
    census = report["census"]
    hits = census["persistent_hits"]
    misses = census["persistent_misses"]
    violations = (reconcile(manifest, report)
                  if mode == "artifact" and manifest is not None else [])
    return {
        "metric": "boot", "schema": SCHEMA_VERSION, "config": CONFIG,
        "backend": census["backend"], "mode": mode, "replica": None,
        "boot_wall_s": round(wall_s, 3),
        "compile_s": census["backend_compile_s"],
        "n_backend_compiles": census["backend_compiles"],
        "persistent_hits": hits, "persistent_misses": misses,
        "hit_rate": (round(hits / (hits + misses), 4)
                     if hits + misses else None),
        "n_programs": len(report["programs"]),
        "violations": violations,
        "manifest_version": (manifest or {}).get("version"),
        "artifact": artifact,
    }


def run(artifact_dir: str, modes=("cold", "artifact"), *,
        device: str = "cuda", timeout: float = 1800.0) -> list:
    """Verify the artifact, then measure each mode's boot: [(row,
    report)], each row validated."""
    from proovread_tpu_torch.obs.validate import validate_boot_row
    manifest = verify_artifact(artifact_dir)
    out = []
    with tempfile.TemporaryDirectory(prefix="proovread_boot_") as tmp:
        for mode in modes:
            _log(f"{mode} boot")
            report, wall = boot_once(mode, artifact_dir, tmp, device=device,
                                     timeout=timeout)
            row = boot_row(mode, report, wall, manifest=manifest,
                           artifact=artifact_dir)
            validate_boot_row(row, where=f"{mode} boot")
            _log(f"{mode}: wall {wall:.2f} s (torch import "
                 f"{report['import_s']:.2f} s, CUDA context "
                 f"{report['context_s']:.2f} s), {row['n_backend_compiles']} "
                 f"build window(s) / {row['compile_s']:.3f} s, "
                 f"{report['nvcc_compiles']} nvcc compile(s), hit rate "
                 f"{row['hit_rate']}, {len(row['violations'])} "
                 "violation(s)")
            out.append((row, report))
    return out


# -- the gate over BOOT history -----------------------------------------------

def load_rows(paths: List[str]) -> List[Dict[str, Any]]:
    """BOOT history rows, oldest first (one JSON value or JSON lines a
    file)."""
    out: List[Dict[str, Any]] = []
    for path in paths:
        for obj in json_values(path, flatten=True):
            if isinstance(obj, dict) and obj.get("metric") == "boot":
                out.append({"source": path, "row": obj})
    return out


def _pool_key(row: Dict[str, Any]):
    """(config, backend, mode); a row without ``backend`` pools as
    ``"tpu"`` (the reference's default)."""
    return (str(row.get("config")), row.get("backend") or "tpu",
            str(row.get("mode")))


def boot_check(entries: List[Dict[str, Any]],
               min_hit_rate: float = MIN_ARTIFACT_HIT_RATE,
               wall_threshold: float = BOOT_WALL_THRESHOLD,
               wall_min_abs_s: float = BOOT_WALL_MIN_ABS_S,
               window: int = BASELINE_WINDOW) -> Dict[str, Any]:
    """The gate, as data: every (config, backend, mode) pool's newest row.
    A row that fails ``validate_boot_row`` is a non-fatal ``missing``
    item. An artifact-mode row with any violation, or a hit rate under
    ``min_hit_rate`` when it built anything, regresses with no baseline;
    the boot wall gates against its pool's rolling-median baseline, in
    both modes. Verdict PASS / REGRESSION / NO-DATA."""
    from proovread_tpu_torch.obs.validate import (ValidationError,
                                                  validate_boot_row)
    checks: List[Dict[str, Any]] = []
    usable: List[Dict[str, Any]] = []
    for e in entries:
        try:
            validate_boot_row(e["row"], where=e["source"])
            usable.append(e)
        except ValidationError as err:
            checks.append({"check": "row", "status": "missing",
                           "source": e["source"], "note": str(err)})
    if not usable:
        return {"schema": SCHEMA_VERSION, "verdict": "NO-DATA",
                "pools": [], "checks": checks}

    pools: Dict[Any, List[Dict[str, Any]]] = {}
    for e in usable:
        pools.setdefault(_pool_key(e["row"]), []).append(e)

    pool_names = []
    for key in sorted(pools):
        group = pools[key]
        lrow = group[-1]["row"]
        base = group[:-1][-window:]
        name = "/".join(key)
        pool_names.append(name)
        if key[2] == "artifact":
            nviol = len(lrow["violations"])
            checks.append({
                "check": f"{name}:violations",
                "status": "regressed" if nviol else "ok",
                "value": nviol, "baseline": 0, "threshold": 0,
                "violations": lrow["violations"][:20]})
            rate = lrow["hit_rate"]
            if lrow["n_backend_compiles"] == 0:
                checks.append({"check": f"{name}:hit_rate",
                               "status": "ok", "value": None,
                               "baseline": min_hit_rate,
                               "threshold": min_hit_rate,
                               "note": "0 backend compiles"})
            else:
                bad = rate is None or rate < min_hit_rate
                checks.append({"check": f"{name}:hit_rate",
                               "status": "regressed" if bad else "ok",
                               "value": rate, "baseline": min_hit_rate,
                               "threshold": min_hit_rate})
        if not base:
            checks.append({"check": f"{name}:baseline",
                           "status": "skipped",
                           "note": "no prior rows in this pool — "
                                   "nothing to regress against"})
            continue
        base_wall = _median([float(e["row"]["boot_wall_s"])
                             for e in base])
        new_wall = float(lrow["boot_wall_s"])
        regressed = (new_wall - base_wall > wall_min_abs_s
                     and new_wall > base_wall * (1 + wall_threshold))
        checks.append({"check": f"{name}:boot_wall_s",
                       "status": "regressed" if regressed else "ok",
                       "value": round(new_wall, 3),
                       "baseline": round(base_wall, 3),
                       "threshold": wall_threshold})
    verdict = ("REGRESSION" if any(c["status"] == "regressed"
                                   for c in checks) else "PASS")
    return {"schema": SCHEMA_VERSION, "verdict": verdict,
            "pools": pool_names, "checks": checks}


def _resolve_paths(args_paths: List[str]) -> List[str]:
    """The files named, else ``BOOT_r*.json`` in order and every
    other ``BOOT_*.json`` after them."""
    return history_paths(args_paths, "BOOT", "r*")


def check(args) -> int:
    """``check``: the gate over BOOT history; exit 1 on a regression."""
    paths = _resolve_paths(args.files)
    if not paths:
        print("boot-check: no BOOT history files found", file=sys.stderr)
        return 0
    verdict = boot_check(load_rows(paths),
                         min_hit_rate=args.min_hit_rate,
                         wall_threshold=args.wall_threshold,
                         wall_min_abs_s=args.wall_min_abs_s,
                         window=args.window)
    for c in verdict["checks"]:
        if c["status"] == "regressed":
            print(f"BOOT-REGRESSION: {c['check']} = {c['value']} vs "
                  f"baseline {c['baseline']} (threshold "
                  f"{c['threshold']})", file=sys.stderr)
            for v in c.get("violations", ()):
                print(f"BOOT-REGRESSION:   {v['kind']}: {v['entry']} "
                      f"{v['sig']} ({v['detail']})", file=sys.stderr)
        elif c["status"] == "missing":
            print(f"boot-check: bad row — {c.get('note', c)}",
                  file=sys.stderr)
    print(json.dumps(verdict, sort_keys=True))
    if verdict["verdict"] == "REGRESSION":
        return 1
    print(f"boot-check: {verdict['verdict']} "
          f"({len(verdict['pools'])} pool(s))", file=sys.stderr)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    from proovread_tpu_torch.obs.validate import ValidationError
    ap = argparse.ArgumentParser(
        prog="python -m proovread_tpu_torch.obs.boot",
        description="Boots from a kernel-build artifact: measured cold "
                    "and artifact boots, verification, the "
                    "observed-within-shipped reconciliation and the "
                    "boot-check gate.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="measure cold and artifact boots")
    r.add_argument("--artifact", required=True, metavar="DIR")
    r.add_argument("--modes", default="cold,artifact")
    r.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    r.add_argument("--out", default=None, metavar="FILE",
                   help="append the rows to this JSON-lines file")
    r.add_argument("--run-timeout", type=float, default=1800.0)
    rec = sub.add_parser("reconcile", help="rc 1 with itemized violations "
                                           "unless observed within shipped")
    rec.add_argument("--artifact", required=True, metavar="DIR")
    src = rec.add_mutually_exclusive_group(required=True)
    src.add_argument("--report", metavar="FILE",
                     help="a boot report (factory --report-out)")
    src.add_argument("--ledger", metavar="FILE",
                     help="a real run's --compile-ledger JSONL")
    v = sub.add_parser("verify", help="verify an artifact")
    v.add_argument("--artifact", required=True, metavar="DIR")
    chk = sub.add_parser("check", help="gate: exit 1 on regression")
    chk.add_argument("files", nargs="*",
                     help="BOOT history files (default: BOOT_*.json)")
    chk.add_argument("--min-hit-rate", type=float,
                     default=MIN_ARTIFACT_HIT_RATE)
    chk.add_argument("--wall-threshold", type=float,
                     default=BOOT_WALL_THRESHOLD)
    chk.add_argument("--wall-min-abs-s", type=float,
                     default=BOOT_WALL_MIN_ABS_S)
    chk.add_argument("--window", type=int, default=BASELINE_WINDOW)
    args = ap.parse_args(argv)
    if args.cmd == "check":
        return check(args)

    try:
        manifest = verify_artifact(args.artifact)
    except (ValidationError, FileNotFoundError) as e:
        print(f"boot: artifact verification FAILED: {e}", file=sys.stderr)
        return 1
    if args.cmd == "verify":
        print(json.dumps({k: manifest[k] for k in
                          ("version", "backend", "n_programs", "configs",
                           "n_devices", "jax_version")}, sort_keys=True))
        return 0
    if args.cmd == "reconcile":
        if args.report:
            with open(args.report) as fh:
                violations = reconcile(manifest, json.load(fh))
        else:
            violations = reconcile_ledger(manifest, args.ledger)
        for viol in violations:
            print(f"BOOT-VIOLATION: {viol['kind']}: {viol['entry']} "
                  f"{viol['sig']} ({viol['detail']})", file=sys.stderr)
        print(json.dumps({"ok": not violations,
                          "manifest_version": manifest["version"],
                          "n_violations": len(violations)}))
        return 1 if violations else 0
    rows = run(args.artifact, [m for m in args.modes.split(",") if m],
               device=args.device, timeout=args.run_timeout)
    rc, good = 0, []
    for row, _report in rows:
        print(json.dumps(row))
        if row["violations"]:
            for viol in row["violations"]:
                print(f"BOOT-VIOLATION: {viol['kind']}: {viol['entry']} "
                      f"{viol['sig']} ({viol['detail']})", file=sys.stderr)
            rc = 1
            continue
        good.append(row)
    if args.out and good:
        with open(args.out, "a") as fh:
            for row in good:
                fh.write(json.dumps(row) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
