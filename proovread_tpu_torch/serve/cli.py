"""``python -m proovread_tpu_torch serve`` — the CLI front of the
correction server (port of ``proovread_tpu/serve/cli.py``, the same
flags).

Boots a :class:`~proovread_tpu_torch.serve.server.CorrectionServer`
against a short-read library, listens on a local socket, and runs until
drained (SIGTERM/SIGINT, or a client's ``drain`` op). One flag is the
port's own, as in the batch CLI: ``--device {cuda,cpu}`` (default
``cuda``); asking for the card without one is an error.
``--compile-cache [DIR]`` builds the kernel library into and loads it
from DIR (``obs/compilecache.py``); ``--boot-from-artifact DIR`` warm-boots
from a kernel-build artifact (``analysis/factory.py``; verified first:
one refused exits 2 naming the flag and writes nothing; supersedes
``--compile-cache``), writing a BOOT row to ``<state-dir>/boot.json``.

This module is imported ONLY when the first CLI argument is ``serve`` —
the batch path stays serve-free (``tests/test_torch_serve.py`` holds it).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

log = logging.getLogger("proovread_tpu_torch")


def build_serve_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="proovread-tpu-torch serve",
        description="Long-lived correction service: streaming FASTQ jobs "
                    "over a local-socket JSONL protocol, continuously "
                    "batched into the pipeline on one CUDA card.")
    ap.add_argument("-s", "--short-reads", action="append", default=[],
                    required=True,
                    help="short-read FASTQ/FASTA library the server "
                         "corrects against (repeatable)")
    ap.add_argument("--socket", required=True, metavar="PATH",
                    help="AF_UNIX socket path to listen on")
    ap.add_argument("--state-dir", required=True, metavar="DIR",
                    help="server state: job journal + per-wave checkpoint "
                         "journals (survives restarts; see --resume)")
    ap.add_argument("--resume", action="store_true",
                    help="requeue journaled jobs from a previous lifetime "
                         "and replay their waves' completed buckets "
                         "byte-identically")
    ap.add_argument("--slo-out", metavar="FILE",
                    help="write the SLO artifact (p99 latency per length "
                         "class, queue depth, rejections, demotions per "
                         "tenant) at drain; validates with "
                         "obs.validate --slo")
    ap.add_argument("--qc", action="store_true",
                    help="record per-read QC provenance; completed jobs "
                         "return their records' QC payloads")
    ap.add_argument("--engine", default="device",
                    choices=("device", "scan"),
                    help="correction engine (default: device)")
    ap.add_argument("--compile-cache", metavar="DIR", nargs="?",
                    const="auto",
                    help="build the kernel library into and load it from "
                         "DIR (default: the usual build directory)")
    ap.add_argument("--boot-from-artifact", metavar="DIR",
                    help="warm-boot from a kernel-build artifact "
                         "(python -m proovread_tpu_torch.analysis.factory "
                         "--artifact DIR): verify it, copy its cache under "
                         "--state-dir, load the library from the copy and "
                         "write a boot row to <state-dir>/boot.json. "
                         "Supersedes --compile-cache.")
    ap.add_argument("--max-tenant-jobs", type=int, default=8,
                    help="per-tenant held-job quota (queued + running)")
    ap.add_argument("--max-tenant-bases", type=int, default=4_000_000,
                    help="per-tenant held-bases quota")
    ap.add_argument("--max-server-jobs", type=int, default=64,
                    help="server-wide held-job bound (queue-full beyond)")
    ap.add_argument("--max-wave-jobs", type=int, default=8,
                    help="jobs merged into one continuous-batching wave")
    ap.add_argument("--job-retries", type=int, default=1,
                    help="requeues per job after a worker death")
    ap.add_argument("--job-deadline", type=float, metavar="SECONDS",
                    help="default per-job deadline (a submission may set "
                         "its own deadline_s)")
    ap.add_argument("--bucket-timeout", type=float, metavar="SECONDS",
                    help="soft wall-clock budget per bucket (thread-safe "
                         "deadline; breach demotes down the ladder)")
    ap.add_argument("--batch-reads", type=int, default=256,
                    help="long reads per device bucket")
    ap.add_argument("--n-iterations", type=int, default=6)
    ap.add_argument("--no-sampling", action="store_true")
    ap.add_argument("--coverage", type=float,
                    help="short-read coverage estimate (else per wave)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the waves run (default: the card; there "
                         "is no fallback to the CPU)")
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("-q", "--quiet", action="store_true")
    return ap


def serve_main(argv: Optional[List[str]] = None) -> int:
    args = build_serve_parser().parse_args(argv)
    if args.boot_from_artifact:
        # refused before anything is written
        from proovread_tpu_torch.obs.boot import verify_artifact
        from proovread_tpu_torch.obs.validate import ValidationError
        try:
            verify_artifact(args.boot_from_artifact)
        except (ValidationError, FileNotFoundError) as e:
            print(f"error: serve --boot-from-artifact: {e}",
                  file=sys.stderr)
            return 2
    level = (logging.DEBUG if args.debug
             else logging.ERROR if args.quiet else logging.INFO)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=level,
                            format="[%(asctime)s] %(message)s",
                            datefmt="%H:%M:%S")
    log.setLevel(level)

    from proovread_tpu_torch.cli import _read_records
    from proovread_tpu_torch.device import resolve
    from proovread_tpu_torch.pipeline.driver import PipelineConfig
    from proovread_tpu_torch.serve.admission import TenantQuota
    from proovread_tpu_torch.serve.server import CorrectionServer, ServeConfig

    try:
        resolve(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    shorts = _read_records(args.short_reads)
    if not shorts:
        print("error: empty short-read library", file=sys.stderr)
        return 2
    log.info("serve: %d short reads loaded", len(shorts))
    if args.compile_cache and not args.boot_from_artifact:
        from proovread_tpu_torch.obs.compilecache import \
            enable_persistent_cache
        log.info("serve: kernel library cache at %s",
                 enable_persistent_cache(args.compile_cache))

    pcfg = PipelineConfig(
        engine=args.engine,
        batch_reads=args.batch_reads,
        n_iterations=args.n_iterations,
        sampling=not args.no_sampling,
        coverage=args.coverage,
        bucket_timeout=args.bucket_timeout,
        device=args.device,
    )
    scfg = ServeConfig(
        state_dir=args.state_dir,
        socket_path=args.socket,
        quota=TenantQuota(max_jobs=args.max_tenant_jobs,
                          max_bases=args.max_tenant_bases,
                          max_server_jobs=args.max_server_jobs),
        max_wave_jobs=args.max_wave_jobs,
        job_retries=args.job_retries,
        default_deadline_s=args.job_deadline,
        slo_path=args.slo_out,
        qc=args.qc,
        resume=args.resume,
        artifact_dir=args.boot_from_artifact,
    )
    os.makedirs(args.state_dir, exist_ok=True)
    server = CorrectionServer(shorts, scfg, pcfg)
    server.install_signal_handlers()
    clean = server.serve_forever()
    log.info("serve: drained (%s)", "clean" if clean else "NOT clean")
    return 0 if clean else 1


if __name__ == "__main__":
    sys.exit(serve_main())
