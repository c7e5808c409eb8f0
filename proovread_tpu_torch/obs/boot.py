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
- :class:`BootSpan` is the in-process boot row a server writes around its
  start from an artifact (``serve/server.py``, ``serve/fleet.py``).

The reference's ``check`` (the BOOT-history gate) waits for the port's
benchmark, as ``obs/census.py``'s does. Its ``warm-tier1``, which copies
an artifact into the CPU tests' XLA cache, has no counterpart: the port's
CPU tests build nothing.

    python -m proovread_tpu_torch.obs.boot run --artifact ART
    python -m proovread_tpu_torch.obs.boot verify --artifact ART
    python -m proovread_tpu_torch.obs.boot reconcile --artifact ART \\
        --report REPORT.json
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

SCHEMA_VERSION = 1

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


def main(argv: Optional[List[str]] = None) -> int:
    from proovread_tpu_torch.obs.validate import ValidationError
    ap = argparse.ArgumentParser(
        prog="python -m proovread_tpu_torch.obs.boot",
        description="Boots from a kernel-build artifact: measured cold "
                    "and artifact boots, verification, and the "
                    "observed-within-shipped reconciliation.")
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
    rec.add_argument("--report", required=True, metavar="FILE",
                     help="a boot report (factory --report-out)")
    v = sub.add_parser("verify", help="verify an artifact")
    v.add_argument("--artifact", required=True, metavar="DIR")
    args = ap.parse_args(argv)

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
        with open(args.report) as fh:
            violations = reconcile(manifest, json.load(fh))
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
