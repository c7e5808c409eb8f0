"""The compile census across runs: ``prewarm`` (port of
``proovread_tpu/obs/census.py``).

``prewarm`` fills a kernel-library cache for a bench config by running the
port's command line twice in subprocesses, each with
``--compile-ledger`` and ``--compile-cache DIR``: once **cold** (with
``--fresh``, into an emptied DIR: ``nvcc`` builds the library) and once
**warm** (a fresh process on the filled DIR: the library loads without
``nvcc``, a fresh process so nothing in memory fakes the hit). Each run's
ledger census gives one ``compile_census`` row, the reference's: the
build windows' seconds (``compile_s``: the ``nvcc`` runs and the link,
or the load), the programs (kernel entries called) and the library
cache's hit rate. With ``--from-artifact DIR`` the warm run loads a
verified copy of a kernel-build artifact (``analysis/factory.py``) and
the cold side is the artifact's own build, from its manifest.

The parent never touches the card: the runs are subprocesses, the
artifact copy is file I/O.

``check`` is the reference's gate over ``COMPILE_*.json`` history: rows
pool per (config, backend), so a row of the card (``cuda``) never pools
with the JAX package's, and the gate fails (exit 1,
``COMPILE-REGRESSION:`` lines) when a pool's newest row's warm compile
seconds grow, its program count grows, or its warm cache hit rate drops
against the rolling baseline. Before the gate it cross-links the newest
``LEDGER_*.jsonl`` beside the package with the kernel-build artifact
there (``artifact/``, or ``PROOVREAD_TORCH_ARTIFACT``): each program the
ledger saw that the artifact does not ship is a non-fatal
``never-shipped`` line (``obs/boot.py:reconcile_ledger``). The
reference's second cross-link, against the static census predictor, has
no counterpart: ``analysis/predict.py`` predicts XLA programs per shape,
and the port compiles one library for every shape.

    python -m proovread_tpu_torch.obs.census prewarm --configs 4 \\
        --cache-dir build/prewarm --fresh [--out FILE] [--device cuda]
    python -m proovread_tpu_torch.obs.census prewarm --configs 4 \\
        --from-artifact ART
    python -m proovread_tpu_torch.obs.census check [COMPILE_*.json ...]
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

# one rolling-median implementation for every history gate
from proovread_tpu_torch.obs.regress import (_median, history_paths,
                                             json_values)

SCHEMA_VERSION = 1

# the gate's thresholds (the reference's): warm-run compile seconds may
# grow by this fraction of the baseline ...
WARM_COMPILE_THRESHOLD = 0.30
# ... when the absolute growth also exceeds this
WARM_COMPILE_MIN_ABS_S = 0.5
# the program count may grow by at most this fraction
PROGRAMS_THRESHOLD = 0.02
# the warm cache hit rate may drop by this much, absolute
HIT_RATE_DROP = 0.05
# rolling baseline: median over up to this many prior usable rows
BASELINE_WINDOW = 3

# config 3 (E.coli class) runs at this cap of long-read bases unless
# asked for more; None = the config's whole workload
DEFAULT_CAPS: Dict[int, Optional[int]] = {3: 80_000, 4: None}
# the warm run must reach this library-cache hit rate, or the prewarm
# did not fill the cache
MIN_WARM_HIT_RATE = 0.90
PREWARM_CONFIGS = (3, 4)


def _log(msg: str) -> None:
    print(f"[prewarm] {msg}", file=sys.stderr, flush=True)


def build_workload(config: int, cap_bases: Optional[int] = None):
    """(longs, shorts, truths) of bench config 4 (10 kb genome, 40 kb of
    long reads) or 3 (1.25 Mb genome, 5 Mb of long reads; with
    ``cap_bases`` a slice of its shape: a genome of cap/4 bases, at least
    21,000, and ``cap_bases`` of long reads), 30x of short reads, the
    seeds of ``bench.py``'s builders."""
    from proovread_tpu_torch.io.simulate import (random_genome,
                                                 simulate_long_reads,
                                                 simulate_short_reads)
    if config == 4:
        genome = random_genome(10_000, seed=0)
        longs, truths = simulate_long_reads(genome, 40_000, seed=1)
    elif config == 3:
        if cap_bases:
            genome = random_genome(max(cap_bases // 4, 21_000), seed=0)
            longs, truths = simulate_long_reads(genome, cap_bases, seed=1)
        else:
            genome = random_genome(1_250_000, seed=0)
            longs, truths = simulate_long_reads(genome, 5_000_000, seed=1)
    else:
        raise ValueError(f"prewarm builds bench configs {PREWARM_CONFIGS}, "
                         f"not {config}")
    return longs, simulate_short_reads(genome, 30.0, seed=2), truths


def _write_fastq(path: str, records) -> None:
    from proovread_tpu_torch.io.fastq import FastqWriter
    with FastqWriter(path) as w:
        for r in records:
            w.write(r)


def _run_cli(long_fq: str, short_fq: str, out: str, ledger: str,
             cache_dir: str, device: str, timeout: float) -> None:
    """One command-line run in a fresh subprocess."""
    cmd = [sys.executable, "-m", "proovread_tpu_torch",
           "-l", long_fq, "-s", short_fq, "-p", out, "-m", "sr-noccs",
           "--compile-ledger", ledger, "--compile-cache", cache_dir,
           "--device", device, "--overwrite", "--no-checkpoint"]
    proc = subprocess.run(cmd, cwd=os.getcwd(), timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"prewarm run exited {proc.returncode}: "
                           f"{' '.join(cmd)}")


def _ledger_census(path: str) -> Dict[str, Any]:
    from proovread_tpu_torch.obs.validate import validate_compile_ledger
    return validate_compile_ledger(path)["census"]


def _phase(census: Dict[str, Any], wall_s: float) -> Dict[str, Any]:
    return {"wall_s": round(wall_s, 2),
            "compile_s": census["backend_compile_s"],
            "n_programs": census["n_programs"],
            "backend_compiles": census["backend_compiles"],
            "persistent_hit_rate": census["persistent_hit_rate"]}


def _runs(config: int, cap_bases, cache_dir: str, device: str,
          phases, timeout: float):
    """The runs of ``phases`` on one config's workload: {phase: (census,
    wall)} and (reads, bases)."""
    longs, srs, _truths = build_workload(config, cap_bases)
    total = sum(len(r) for r in longs)
    _log(f"config {config}: {len(longs)} reads / {total} bases"
         + (f" (cap {cap_bases})" if cap_bases else ""))
    out = {}
    with tempfile.TemporaryDirectory(prefix="proovread_prewarm_") as tmp:
        lp, sp = os.path.join(tmp, "long.fq"), os.path.join(tmp, "short.fq")
        _write_fastq(lp, longs)
        _write_fastq(sp, srs)
        for phase in phases:
            led = os.path.join(tmp, f"{phase}.ledger.jsonl")
            _log(f"config {config}: {phase} run")
            t0 = time.monotonic()
            _run_cli(lp, sp, os.path.join(tmp, f"out_{phase}"), led,
                     cache_dir, device, timeout)
            out[phase] = (_ledger_census(led), time.monotonic() - t0)
    return out, (len(longs), total)


def prewarm_config(config: int, cache_dir: str, *,
                   cap_bases: Optional[int] = None, fresh: bool = False,
                   device: str = "cuda",
                   run_timeout: float = 5400.0) -> Dict[str, Any]:
    """Cold and warm command-line runs of one config; the COMPILE row."""
    if fresh and os.path.isdir(cache_dir):
        _log(f"config {config}: emptying {cache_dir} (--fresh)")
        shutil.rmtree(cache_dir)
    runs, (n_reads, total) = _runs(config, cap_bases, cache_dir, device,
                                   ("cold", "warm"), run_timeout)
    phases = {p: _phase(c, w) for p, (c, w) in runs.items()}
    for p, row in phases.items():
        _log(f"config {config}: {p} -> {json.dumps(row)}")
    return {"metric": "compile_census", "schema": SCHEMA_VERSION,
            "config": config, "backend": runs["cold"][0]["backend"],
            "cap_bases": cap_bases, "n_reads": n_reads,
            "total_bases": total, "cache_dir": cache_dir,
            "cold": phases["cold"], "warm": phases["warm"],
            "cache_hit_rate": phases["warm"]["persistent_hit_rate"]}


def artifact_prewarm_config(config: int, manifest: Dict[str, Any],
                            cache_dir: str, *, artifact_dir: str,
                            cap_bases: Optional[int] = None,
                            device: str = "cuda",
                            run_timeout: float = 5400.0
                            ) -> Dict[str, Any]:
    """One warm run on a verified copy of an artifact's cache; the cold
    side is the artifact's build, from its manifest."""
    runs, (n_reads, total) = _runs(config, cap_bases, cache_dir, device,
                                   ("warm",), run_timeout)
    census, wall = runs["warm"]
    warm = _phase(census, wall)
    _log(f"config {config}: warm -> {json.dumps(warm)}")
    bc = next(iter(manifest["by_config"].values()))
    cold = {"wall_s": bc["wall_s"], "compile_s": bc["compile_s"],
            "n_programs": bc["n_programs"],
            "backend_compiles": bc["backend_compiles"],
            "persistent_hit_rate": None}
    return {"metric": "compile_census", "schema": SCHEMA_VERSION,
            "config": config, "backend": census["backend"],
            "cap_bases": cap_bases, "n_reads": n_reads,
            "total_bases": total, "cache_dir": cache_dir,
            "artifact": {"dir": artifact_dir,
                         "version": manifest["version"],
                         "cold_synthesized": True},
            "cold": cold, "warm": warm,
            "cache_hit_rate": warm["persistent_hit_rate"]}


def _gate(row: Dict[str, Any], min_rate: float) -> bool:
    rate = row["cache_hit_rate"]
    if min_rate and (rate is None or rate < min_rate):
        _log(f"FAILED: config {row['config']} warm library-cache hit rate "
             f"{rate} < {min_rate}: the cache was not warm; row withheld")
        return False
    return True


# -- the gate over COMPILE history ------------------------------------------

def load_rows(paths: List[str]) -> List[Dict[str, Any]]:
    """COMPILE history rows, oldest first (one JSON value or JSON lines a
    file, ``obs/regress.py`` conventions)."""
    out: List[Dict[str, Any]] = []
    for path in paths:
        for obj in json_values(path, flatten=True):
            if isinstance(obj, dict) and obj.get("metric") == \
                    "compile_census":
                out.append({"source": path, "row": obj})
    return out


def _usable(entry: Dict[str, Any]) -> bool:
    row = entry["row"]
    return (isinstance(row.get("cold"), dict)
            and isinstance(row.get("warm"), dict))


def _pool_key(row: Dict[str, Any]):
    """(config as an int, backend); a row without ``backend`` pools as
    ``"tpu"`` (the reference's default)."""
    return (int(row.get("config", 0)), row.get("backend") or "tpu")


def compile_check(entries: List[Dict[str, Any]],
                  warm_threshold: float = WARM_COMPILE_THRESHOLD,
                  warm_min_abs_s: float = WARM_COMPILE_MIN_ABS_S,
                  programs_threshold: float = PROGRAMS_THRESHOLD,
                  hit_rate_drop: float = HIT_RATE_DROP,
                  window: int = BASELINE_WINDOW) -> Dict[str, Any]:
    """The gate, as data: every (config, backend) pool's newest row
    against a rolling baseline of its predecessors. Verdict PASS /
    REGRESSION / NO-DATA; check statuses ok / regressed / skipped /
    missing."""
    checks: List[Dict[str, Any]] = []
    for e in entries:
        if not _usable(e):
            checks.append({"check": "row", "status": "missing",
                           "source": e["source"],
                           "note": "row lacks cold/warm phases"})
    usable = [e for e in entries if _usable(e)]
    if not usable:
        return {"schema": SCHEMA_VERSION, "verdict": "NO-DATA",
                "pools": [], "checks": checks}

    pools: Dict[Any, List[Dict[str, Any]]] = {}
    for e in usable:
        pools.setdefault(_pool_key(e["row"]), []).append(e)

    def _grew(name, new, base, *, threshold, min_abs=0.0):
        regressed = (new - base > min_abs
                     and new > base * (1 + threshold))
        return {"check": name,
                "status": "regressed" if regressed else "ok",
                "value": round(new, 4), "baseline": round(base, 4),
                "threshold": threshold}

    pool_names = []
    for key in sorted(pools):
        group = pools[key]
        latest = group[-1]
        base = group[:-1][-window:]
        name = f"config{key[0]}/{key[1]}"
        pool_names.append(name)
        if not base:
            checks.append({"check": f"{name}:baseline",
                           "status": "skipped",
                           "note": "no prior rows in this pool — "
                                   "nothing to regress against"})
            continue
        lrow = latest["row"]
        checks.append(_grew(
            f"{name}:warm_compile_s", float(lrow["warm"]["compile_s"]),
            _median([float(e["row"]["warm"]["compile_s"])
                     for e in base]),
            threshold=warm_threshold, min_abs=warm_min_abs_s))
        checks.append(_grew(
            f"{name}:n_programs", float(lrow["cold"]["n_programs"]),
            _median([float(e["row"]["cold"]["n_programs"])
                     for e in base]),
            threshold=programs_threshold))
        rates = [e["row"].get("cache_hit_rate") for e in base]
        rates = [float(r) for r in rates if r is not None]
        lrate = lrow.get("cache_hit_rate")
        if rates and lrate is not None:
            base_rate = _median(rates)
            regressed = float(lrate) < base_rate - hit_rate_drop
            checks.append({
                "check": f"{name}:cache_hit_rate",
                "status": "regressed" if regressed else "ok",
                "value": round(float(lrate), 4),
                "baseline": round(base_rate, 4),
                "threshold": hit_rate_drop})
        else:
            checks.append({"check": f"{name}:cache_hit_rate",
                           "status": "skipped",
                           "note": "hit rate absent (cache off?)"})
    verdict = ("REGRESSION" if any(c["status"] == "regressed"
                                   for c in checks) else "PASS")
    return {"schema": SCHEMA_VERSION, "verdict": verdict,
            "pools": pool_names, "checks": checks}


def _crosslink_manifest(artifact: Optional[str] = None,
                        ledgers: Optional[List[str]] = None) -> None:
    """Shipped against observed: reconcile the newest compile ledger
    (``LEDGER_*.jsonl`` beside the package, or ``ledgers``) with the
    kernel-build artifact (``artifact/`` there, ``PROOVREAD_TORCH_ARTIFACT``
    or ``artifact``). Each program the ledger saw that the artifact does
    not ship is a ``never-shipped`` line: every boot from the artifact
    builds it. Non-fatal: no artifact, no ledger or an unreadable one
    leaves the plain gate."""
    try:
        from proovread_tpu_torch.obs import boot as _boot
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        if artifact is None:
            artifact = os.environ.get("PROOVREAD_TORCH_ARTIFACT",
                                      os.path.join(root, "artifact"))
        if not os.path.isfile(os.path.join(artifact, "manifest.json")):
            return
        if ledgers is None:
            ledgers = sorted(_glob.glob(os.path.join(root,
                                                     "LEDGER_*.jsonl")))
        if not ledgers:
            return
        manifest = _boot.verify_artifact(artifact)
        never = _boot.reconcile_ledger(manifest, ledgers[-1])
        for v in never:
            print(f"compile-check: never-shipped: {v['entry']} "
                  f"{v['sig']} — observed in {ledgers[-1]} but absent "
                  f"from artifact {manifest['version']}; every boot "
                  "pays this build (rebuild the artifact)",
                  file=sys.stderr)
        if not never:
            print(f"compile-check: artifact {manifest['version']} ≡ "
                  f"{os.path.basename(ledgers[-1])}: observed within "
                  "shipped", file=sys.stderr)
    except Exception as e:                              # noqa: BLE001
        print(f"compile-check: manifest cross-link unavailable: "
              f"{type(e).__name__}: {e}", file=sys.stderr)


def _resolve_paths(args_paths: List[str]) -> List[str]:
    """The files named, else ``COMPILE_r*.json`` in order and every
    other ``COMPILE_*.json`` after them."""
    return history_paths(args_paths, "COMPILE", "r*")


def check(args) -> int:
    """``check``: the cross-link, then the gate; exit 1 on a regression."""
    paths = _resolve_paths(args.files)
    if not paths:
        print("compile-check: no COMPILE history files found",
              file=sys.stderr)
        return 0
    _crosslink_manifest()
    verdict = compile_check(load_rows(paths),
                            warm_threshold=args.warm_threshold,
                            warm_min_abs_s=args.warm_min_abs_s,
                            programs_threshold=args.programs_threshold,
                            hit_rate_drop=args.hit_rate_drop,
                            window=args.window)
    for c in verdict["checks"]:
        if c["status"] == "regressed":
            print(f"COMPILE-REGRESSION: {c['check']} = {c['value']} vs "
                  f"baseline {c['baseline']} (threshold "
                  f"{c['threshold']})", file=sys.stderr)
        elif c["status"] == "missing":
            print(f"compile-check: missing — {c.get('note', c)}",
                  file=sys.stderr)
    print(json.dumps(verdict, sort_keys=True))
    if verdict["verdict"] == "REGRESSION":
        return 1
    print(f"compile-check: {verdict['verdict']} "
          f"({len(verdict['pools'])} pool(s))", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m proovread_tpu_torch.obs.census",
        description="Fill a kernel-library cache with a cold and a warm "
                    "command-line run and record a compile_census row "
                    "per config; gate the COMPILE history.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pw = sub.add_parser("prewarm", help="cold and warm runs, COMPILE rows")
    pw.add_argument("--configs", default="4",
                    help=f"comma-separated bench configs {PREWARM_CONFIGS}")
    pw.add_argument("--cache-dir", default=None,
                    help="the library cache to fill (default: the usual "
                         "build directory)")
    pw.add_argument("--fresh", action="store_true",
                    help="empty --cache-dir before the first config, so "
                         "its cold run builds")
    pw.add_argument("--cap-bases", default=None,
                    help="per-config caps, e.g. '3=80000'")
    pw.add_argument("--from-artifact", default=None, metavar="DIR",
                    help="one warm run per config on a verified copy of "
                         "this kernel-build artifact")
    pw.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    pw.add_argument("--out", default=None, metavar="FILE",
                    help="append the rows to this JSON-lines file")
    pw.add_argument("--run-timeout", type=float, default=5400.0)
    pw.add_argument("--min-warm-hit-rate", type=float,
                    default=MIN_WARM_HIT_RATE,
                    help="fail unless each warm run's library-cache hit "
                         "rate reaches this (0 turns the gate off)")
    chk = sub.add_parser("check", help="gate: exit 1 on regression")
    chk.add_argument("files", nargs="*",
                     help="COMPILE history files (default: "
                          "COMPILE_*.json)")
    chk.add_argument("--warm-threshold", type=float,
                     default=WARM_COMPILE_THRESHOLD)
    chk.add_argument("--warm-min-abs-s", type=float,
                     default=WARM_COMPILE_MIN_ABS_S)
    chk.add_argument("--programs-threshold", type=float,
                     default=PROGRAMS_THRESHOLD)
    chk.add_argument("--hit-rate-drop", type=float, default=HIT_RATE_DROP)
    chk.add_argument("--window", type=int, default=BASELINE_WINDOW)
    args = ap.parse_args(argv)
    if args.cmd == "check":
        return check(args)

    caps = dict(DEFAULT_CAPS)
    for part in (args.cap_bases or "").split(","):
        if part:
            k, _, v = part.partition("=")
            caps[int(k)] = int(v) if v else None
    configs = [int(c) for c in args.configs.split(",") if c]
    rows, rc = [], 0
    if args.from_artifact:
        if args.fresh or args.cache_dir:
            print("prewarm: --from-artifact keeps its own cache copy; "
                  "drop --fresh / --cache-dir", file=sys.stderr)
            return 2
        from proovread_tpu_torch.obs.boot import fetch_artifact
        with tempfile.TemporaryDirectory(prefix="proovread_art_") as tmp:
            copy = os.path.join(tmp, "cache")
            manifest = fetch_artifact(args.from_artifact, copy)
            for cfg in configs:
                row = artifact_prewarm_config(
                    cfg, manifest, copy, artifact_dir=args.from_artifact,
                    cap_bases=caps.get(cfg), device=args.device,
                    run_timeout=args.run_timeout)
                print(json.dumps(row))
                if _gate(row, args.min_warm_hit_rate):
                    rows.append(row)
                else:
                    rc = 1
    else:
        from proovread_tpu_torch.kernels import default_build_dir
        cache_dir = args.cache_dir or str(default_build_dir())
        if args.fresh and not args.cache_dir:
            print("prewarm: --fresh would empty the shared build directory "
                  f"{cache_dir}; name a --cache-dir", file=sys.stderr)
            return 2
        for i, cfg in enumerate(configs):
            row = prewarm_config(cfg, cache_dir, cap_bases=caps.get(cfg),
                                 fresh=args.fresh and i == 0,
                                 device=args.device,
                                 run_timeout=args.run_timeout)
            print(json.dumps(row))
            if _gate(row, args.min_warm_hit_rate):
                rows.append(row)
            else:
                rc = 1
    if args.out and rows:
        with open(args.out, "a") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
        _log(f"{len(rows)} row(s) appended to {args.out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
