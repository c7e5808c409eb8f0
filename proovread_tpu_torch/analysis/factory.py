"""The kernel-build artifact (port of ``proovread_tpu/analysis/factory.py``).

The reference compiles its XLA program zoo ahead of time into one
shippable artifact, so a fresh replica boots warm. What the port
compiles is one CUDA library, built by ``nvcc`` from ``csrc/*.cu``
(``kernels.build``). The artifact ships it::

    <artifact>/cache/          the built library and its ptxas log
    <artifact>/manifest.json   the reference's manifest schema

so a host that boots from it needs neither the build's seconds nor the
CUDA toolkit. The manifest (``obs/validate.py:MANIFEST_*``) holds one
program row per CUDA source: ``entry`` the source, ``sig`` its digest
(``kernels.source_digest``), ``compile_ms`` its own ``nvcc`` wall (the
sources compile in parallel), ``persistent`` ``"miss"`` (built here;
``"hit"`` when the library was found already built), ``cache_key`` the
library file, ``artifact_bytes`` the source's object. ``files`` is the
exact byte inventory of ``cache/``, ``version`` the library's digest
(``kernels.digest``: the sources, headers and flags), which
``obs/boot.py:verify_artifact`` holds against the package's own before
anything loads it. Fields that name XLA notions carry the nearest honest
value: ``jax_version`` the torch, CUDA and ``nvcc`` versions that built
the library, ``interpret`` false, ``n_devices`` the cards the build saw,
``configs`` / ``by_config`` the one build (``"kernels"``).

Two modes:

- ``--artifact DIR [--fresh]`` builds the artifact (``--fresh`` empties
  ``DIR/cache`` first, so ``nvcc`` runs). The manifest is written last:
  a torn build has none and fails verification.
- ``--cache-dir D --report-out F`` is the boot child ``obs/boot.py run``
  measures: under a compile ledger it builds or loads the library in D
  (``kernels.lib()``, the boot's build window), then launches each of
  the eleven kernel entries once at config 4's first-bucket shapes
  (``analysis/shapes.py``), and writes the report ``obs/boot.py``
  reconciles (observed within shipped).

The reference's census walk and its ``--mini`` registry walk compile
XLA programs per shape. CUDA has no counterpart: the library holds every
kernel at every shape, so the manifest's program list is the sources,
and what carries over of the reference's predictor is the boot's
observed-within-shipped reconciliation.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

MANIFEST_SCHEMA = 1
MANIFEST_NAME = "manifest.json"
CACHE_SUBDIR = "cache"
CONFIG = "kernels"          # the manifest's one build


def _log(msg: str) -> None:
    print(f"[factory] {msg}", file=sys.stderr, flush=True)


def cache_files(cache_dir: str) -> Dict[str, int]:
    """Every file under ``cache_dir`` -> its bytes."""
    out: Dict[str, int] = {}
    if not os.path.isdir(cache_dir):
        return out
    for root, _dirs, files in os.walk(cache_dir):
        for f in files:
            p = os.path.join(root, f)
            out[os.path.relpath(p, cache_dir)] = os.path.getsize(p)
    return out


def toolchain_versions() -> str:
    """The torch, CUDA and nvcc versions (the manifest's ``jax_version``
    field)."""
    import torch

    from proovread_tpu_torch import kernels
    nvcc = "none"
    try:
        out = subprocess.run([kernels._nvcc(), "--version"],
                             capture_output=True, text=True, timeout=60)
        nvcc = out.stdout.strip().splitlines()[-1]
    except (kernels.KernelBuildError, OSError, IndexError,
            subprocess.SubprocessError):
        pass
    return f"torch {torch.__version__}; cuda {torch.version.cuda}; {nvcc}"


def build_manifest(cache_dir: str, so_name: str, compiled: bool,
                   build_s: float, wall_s: float) -> Dict[str, Any]:
    """The manifest of a library built (``compiled``) or found in
    ``cache_dir``."""
    import torch

    from proovread_tpu_torch import kernels
    programs = [{
        "entry": name, "sig": kernels.source_digest(name),
        "config": CONFIG, "backend": "cuda",
        "compile_ms": round(kernels.nvcc_source_seconds.get(name, 0.0)
                            * 1e3 if compiled else 0.0, 3),
        "persistent": "miss" if compiled else "hit",
        "cache_key": so_name,
        "artifact_bytes": int(kernels.object_bytes.get(name, 0)
                              if compiled else 0),
    } for name in kernels.SOURCES]
    return {
        "manifest_schema": MANIFEST_SCHEMA,
        "version": kernels.digest(),
        "backend": "cuda",
        "interpret": False,
        "configs": [CONFIG],
        "n_programs": len(programs),
        "compile_s": round(build_s, 3),
        "wall_s": round(wall_s, 3),
        "n_devices": torch.cuda.device_count(),
        "jax_version": toolchain_versions(),
        "by_config": {CONFIG: {"n_programs": len(programs),
                               "compile_s": round(build_s, 3),
                               "backend_compiles": 1 if compiled else 0,
                               "wall_s": round(wall_s, 3)}},
        "files": cache_files(cache_dir),
        "programs": programs,
    }


def build_artifact(artifact_dir: str, fresh: bool = False
                   ) -> Dict[str, Any]:
    """Build the library into ``<artifact>/cache`` and write the manifest
    last; returns it."""
    from proovread_tpu_torch import kernels
    from proovread_tpu_torch.obs.validate import validate_manifest
    t0 = time.monotonic()
    cache_dir = os.path.join(artifact_dir, CACHE_SUBDIR)
    if fresh and os.path.isdir(cache_dir):
        _log(f"emptying {cache_dir} (--fresh)")
        shutil.rmtree(cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    n0 = kernels.nvcc_compiles
    tb = time.monotonic()
    so = kernels.build(out_dir=cache_dir)
    build_s = time.monotonic() - tb
    compiled = kernels.nvcc_compiles > n0
    manifest = build_manifest(cache_dir, os.path.basename(str(so)),
                              compiled, build_s, time.monotonic() - t0)
    # a manifest the boot would refuse fails here, not at boot
    validate_manifest(manifest)
    path = os.path.join(artifact_dir, MANIFEST_NAME)
    with open(path + ".tmp", "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(path + ".tmp", path)
    _log(f"artifact {manifest['version']}: {manifest['n_programs']} "
         f"source(s), {'built' if compiled else 'found'} in "
         f"{build_s:.2f} s, {len(manifest['files'])} file(s), "
         f"{sum(manifest['files'].values())} bytes -> {artifact_dir}")
    return manifest


# -- the boot child -----------------------------------------------------------

def boot_inputs(device: str, plan=None) -> Dict[str, tuple]:
    """One small valid call of each kernel entry: {entry: (function,
    args)}, sized by config 4's first bucket (``plan``: default
    ``shapes.build_plan(4)``)."""
    import numpy as np
    import torch

    from proovread_tpu_torch.align import bsw, sw
    from proovread_tpu_torch.align.params import AlignParams
    from proovread_tpu_torch.analysis.shapes import build_plan
    from proovread_tpu_torch.obs import accuracy
    from proovread_tpu_torch.ops import assemble_kernel as ak
    from proovread_tpu_torch.ops import pileup_kernel as pk
    from proovread_tpu_torch.ops.consensus_call import ConsensusCall
    from proovread_tpu_torch.ops.scatter import scatter_add_ordered
    from proovread_tpu_torch.ops.votes import INS_CAP
    from proovread_tpu_torch.pipeline.masking import MaskParams

    plan = plan or build_plan(4)
    b0 = plan.buckets[0]
    B, Lp, m = b0.rows, b0.Lp, plan.m
    rng = np.random.default_rng(0)
    dev = torch.device(device)

    def t(x):
        return torch.as_tensor(x, device=dev)

    ap = AlignParams()
    W = bsw.band_lanes(ap)
    n = m + W
    R = 128                         # bsw v1's candidates a program
    q = t(rng.integers(0, 4, (R, m)).astype(np.int8))
    qlen = t(np.full(R, m, np.int32))
    idx = t(np.arange(R, dtype=np.int32))
    zeros_r = t(np.zeros(R, np.int32))
    map_pad = t(rng.integers(0, 4, (B, Lp + 2 * n + 32)).astype(np.int8))
    win = t(rng.integers(0, 4, (R, n)).astype(np.int8))
    w0 = t(rng.integers(0, Lp + n, R).astype(np.int32))
    read_of = t(np.sort(rng.integers(0, B, R)).astype(np.int32))
    pile = (B, Lp + 2 * n, 64)
    bits = t(rng.integers(0, 1 << 30, (R, n)).astype(np.int32))
    n_sw = 32 * sw.KERNEL_LANE_COLS[-1]
    pairs = [(rng.integers(0, 4, 900).astype(np.int8),
              rng.integers(0, 4, 1000).astype(np.int8))]
    call = ConsensusCall(
        emitted=t(rng.random((B, Lp)) > 0.1),
        base=t(rng.integers(0, 4, (B, Lp)).astype(np.int8)),
        ins_len=t(np.zeros((B, Lp), np.int32)),
        ins_bases=t(np.zeros((B, Lp, INS_CAP), np.int8)),
        freq=t(np.ones((B, Lp), np.float32)),
        phred=t(rng.integers(0, 41, (B, Lp)).astype(np.int32)),
        coverage=t(np.ones((B, Lp), np.float32)))
    lengths = t(np.full(B, Lp // 2, np.int32))
    M = 4096
    return {
        "bsw_expand_v2": (bsw.bsw_expand_v2, (
            q, q, map_pad, qlen, idx, zeros_r, zeros_r,
            t(rng.integers(0, Lp, R).astype(np.int32)), ap)),
        "bsw_expand": (bsw.bsw_expand, (q, win, qlen, ap)),
        "sw_batch": (sw.sw_batch, (
            q, t(rng.integers(0, 4, (R, n_sw)).astype(np.int8)), qlen, ap)),
        "pileup_accumulate_bits": (pk.pileup_accumulate_bits, (
            torch.zeros(pile, device=dev), bits, bits, read_of, w0)),
        "pileup_accumulate_packed": (pk.pileup_accumulate_packed, (
            torch.zeros(pile, device=dev), bits, read_of, w0)),
        "pileup_accumulate": (pk.pileup_accumulate, (
            torch.zeros(pile, device=dev),
            t(rng.random((R, n, 64)).astype(np.float32)), read_of, w0)),
        "assemble_rows": (ak.assemble_rows, (call, lengths, Lp)),
        "hcr_mask_rows": (ak.hcr_mask_rows, (
            call.phred.to(torch.uint8), lengths,
            ak.mask_params_vec(MaskParams()))),
        "lcs_lengths": (accuracy.lcs_lengths,
                        accuracy.pack_pairs(pairs, dev)),
        "edit_alignments": (accuracy.edit_alignments,
                            (*accuracy.pack_pairs(pairs, dev), [300])),
        "scatter_add_ordered": (scatter_add_ordered, (
            torch.zeros(B * Lp, device=dev),
            t(rng.integers(0, B * Lp, M)), t(rng.random(M).astype(
                np.float32)), t(rng.random(M) < 0.9))),
    }


def boot_report(cache_dir: str, device: str = "cuda") -> Dict[str, Any]:
    """The boot: under a compile ledger, build or load the library in
    ``cache_dir`` (``kernels.lib()``), then launch each kernel entry once.
    The report carries the ledger's rows and census, the sources the
    entries ran (``programs``), the library loaded, the ``nvcc`` compiles
    and the torch import and CUDA-context seconds."""
    t_start = time.monotonic()
    import torch
    import_s = time.monotonic() - t_start
    t0 = time.monotonic()
    if device == "cuda":
        torch.cuda.init()
        torch.empty(1, device="cuda")
    context_s = time.monotonic() - t0

    from proovread_tpu_torch import kernels
    from proovread_tpu_torch.obs import compilecache
    os.makedirs(cache_dir, exist_ok=True)
    state = compilecache.cache_state()
    compilecache.enable_persistent_cache(cache_dir)
    try:
        with compilecache.scope(compilecache.Ledger(backend=device)) as led:
            n0 = kernels.nvcc_compiles
            if device == "cuda":
                kernels.lib()
            launched = {}
            for entry, (fn, args) in boot_inputs(device).items():
                l0 = fn.launches
                fn(*args)
                launched[entry] = fn.launches - l0
            if device == "cuda":
                torch.cuda.synchronize()
            census = led.census()
            rows = list(led.rows)
    finally:
        compilecache.restore_cache(state)
    programs = [{"entry": src, "sig": kernels.source_digest(src)}
                for src in sorted({kernels.ENTRY_SOURCES[e]
                                   for e in launched})]
    return {
        "manifest_schema": MANIFEST_SCHEMA,
        "backend": device, "interpret": False,
        "wall_s": round(time.monotonic() - t_start, 3),
        "import_s": round(import_s, 3), "context_s": round(context_s, 3),
        "version": kernels.digest(),
        "library": (os.path.basename(str(kernels.loaded_path))
                    if device == "cuda" else None),
        "nvcc_compiles": kernels.nvcc_compiles - n0,
        "launches": launched,
        "census": census, "programs": programs, "rows": rows,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m proovread_tpu_torch.analysis.factory",
        description="Build the kernel library into a shippable artifact "
                    "(DIR/cache + DIR/manifest.json), or boot from a "
                    "cache dir and report (the obs.boot child).")
    ap.add_argument("--artifact", default=None, metavar="DIR",
                    help="build the artifact here")
    ap.add_argument("--fresh", action="store_true",
                    help="empty the artifact's cache first")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="boot from this cache dir (the boot child)")
    ap.add_argument("--report-out", default=None, metavar="FILE",
                    help="with --cache-dir: write the boot report here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if (args.artifact is None) == (args.cache_dir is None):
        ap.error("exactly one of --artifact / --cache-dir is required")
    if args.artifact:
        build_artifact(args.artifact, fresh=args.fresh)
        return 0
    report = boot_report(args.cache_dir, args.device)
    if args.report_out:
        with open(args.report_out, "w") as fh:
            json.dump(report, fh)
            fh.write("\n")
    c = report["census"]
    _log(f"boot: {len(report['launches'])} entries launched, "
         f"{c['backend_compiles']} build window(s) / "
         f"{c['backend_compile_s']:.3f} s, {report['nvcc_compiles']} nvcc "
         f"compile(s), library cache {c['persistent_hits']} hit / "
         f"{c['persistent_misses']} miss")
    return 0


if __name__ == "__main__":
    sys.exit(main())
