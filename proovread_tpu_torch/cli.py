"""Command-line driver — the role of ``bin/proovread``'s CLI + output layer.

Port of ``proovread_tpu/cli.py``, run as ``python -m proovread_tpu_torch``:
the same flags (``bin/proovread:137-298``), argument checks and exit codes,
mode auto-detection (``:628-654``) and output layout (``:904-956``):
``<pre>/<name>.untrimmed.fq``, ``.trimmed.fq``, ``.trimmed.fa``,
``.ignored.tsv``, ``.chim.tsv``, plus ``.parameter.log`` (``:401-416``).

One flag is the port's own: ``--device {cuda,cpu}`` (default ``cuda``), the
counterpart of the reference's ``JAX_PLATFORMS``; asking for the card
without one is an error. The run's own account works as in the reference
(``:300-440``, ``:591-620``): ``--trace FILE`` (span tree, with CUDA
memory sampled at span boundaries and a leak report at exit),
``--metrics-out FILE``, ``--qc-out FILE`` and ``--truth FILE`` (identity
against a truth sidecar, scored on ``--device``), or their config keys
``trace-file``, ``metrics-out``, ``qc-out`` and ``truth-sidecar``; the
artifacts are written even when the run fails. Every mode of the
reference runs: ``sr`` and ``mr`` (with the ``ccs-1`` subread consensus on
PacBio subread ids), ``-noccs``, ``*+utg`` and ``utg`` with
``-u/--unitigs``, flex mode with ``--haplo-coverage``, the SAM/BAM
re-entry ``-m sam --sam FILE`` / ``-m bam --bam FILE`` (consensus from an
external mapping; the mode is picked by the flag alone too) and the
legacy SHRiMP2 schedule ``-m legacy``. ``--debug`` logs at DEBUG level,
writes each bucket's admitted finish alignments as
``<pre>/admitted.<read id>.sam`` and a per-read ``<name>.debug.tsv`` (id,
length, mean phred, phred-0 fraction). ``serve`` as the first argument
starts the correction server instead (``serve/cli.py``; the batch path
imports nothing of ``serve``).

The kernel build's own account (``:314-392``): ``--compile-ledger FILE``
(or the key ``compile-ledger``) writes the compile ledger
(``obs/compilecache.py``: the kernel library's build window and each
kernel entry's first call); ``--compile-cache [DIR]`` (key
``compile-cache-dir``) builds the library into, and loads it from, DIR
(default: the usual build directory), marking the build a hit or a miss;
``--xprof DIR`` wraps the run in ``torch.profiler`` (CPU activity, and
CUDA on the card) with the span tree's ranges in it, and writes its
Chrome trace into DIR. ``--trace`` and ``--xprof`` switch on the cost
attribution (``obs/profile.py``) and log its roofline. None of them
changes an output file.

``--mesh-shards N`` (or the config key ``mesh-shards``) shards each
bucket's iteration passes over N ranks (``parallel/dmesh.py``). Without a
process group the command starts the N ranks itself
(``parallel/launch.py``: spawned processes on gloo, ``cuda:{rank %
device_count}`` each, so ranks may share a card) and returns rank 0's exit
code; under ``torchrun`` (``WORLD_SIZE`` > 1) it joins the group that is
there. Every rank runs the same command; only rank 0 writes the outputs,
``parameter.log``, the journal, ``--trace``, ``--metrics-out`` and
``--qc-out``, and scores ``--truth``. ``--mesh-pass-timeout`` bounds a
sharded pass's wait on the other ranks.

Resilience works as in the reference (``:276-297``, ``:620-645``): a
per-bucket checkpoint journal at ``<pre>/.proovread_ckpt`` unless
``--no-checkpoint``, removed once the outputs are written unless
``--keep-temporary-files``; ``--resume`` re-enters the output dir of a
crashed or killed run and replays the buckets the journal holds;
``--bucket-timeout`` and ``--no-ladder``; and ``PROOVREAD_FAULT`` in the
environment injects device faults (``testing/faults.py``). Demotions and
replays are named in the task summary.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import List, Optional

import numpy as np

log = logging.getLogger("proovread_tpu_torch")

PROG = "proovread-tpu-torch"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=PROG,
        description="Hybrid correction of PacBio long reads by iterative "
                    "short-read consensus (proovread rebuild), in PyTorch "
                    "on one CUDA card.")
    ap.add_argument("-l", "--long-reads", action="append", default=[],
                    help="long-read FASTQ/FASTA (repeatable)")
    ap.add_argument("-s", "--short-reads", action="append", default=[],
                    help="short-read FASTQ/FASTA (repeatable)")
    ap.add_argument("-u", "--unitigs", action="append", default=[],
                    help="unitig FASTA (enables utg tasks)")
    ap.add_argument("-p", "--pre", help="output directory/prefix")
    ap.add_argument("-m", "--mode", default="auto",
                    help="correction mode (auto|sr|mr|*-noccs|*+utg|utg|"
                         "sam|bam|legacy)")
    ap.add_argument("--sam", help="external SAM mapping (re-entry mode)")
    ap.add_argument("--bam", help="external BAM mapping (re-entry mode)")
    ap.add_argument("-c", "--cfg", help="user config file (JSON + // comments)")
    ap.add_argument("--create-cfg", metavar="PATH",
                    help="write a commented config template and exit")
    ap.add_argument("--coverage", type=float,
                    help="input short-read coverage estimate")
    ap.add_argument("-t", "--threads", type=int, default=1,
                    help="accepted for interface parity; has no effect")
    ap.add_argument("--lr-min-length", type=int,
                    help="min long-read length (0 disables; default 2x "
                         "median short-read length)")
    ap.add_argument("--ignore-sr-length", action="store_true",
                    help="accept short reads longer than 1000bp "
                         "(bin/proovread:457-464 guard)")
    ap.add_argument("--haplo-coverage", type=float, nargs="?", const=-1.0,
                    help="flex mode (proovread-flex role): bare flag = "
                         "estimate each read's own-haplotype coverage on "
                         "the device and tighten admission; a float value "
                         "= explicit per-read coverage cutoff")
    ap.add_argument("--no-sampling", action="store_true",
                    help="use all short reads every iteration")
    ap.add_argument("--resume", action="store_true",
                    help="resume a crashed/killed run: completed buckets "
                         "replay from <pre>/.proovread_ckpt and the rest "
                         "compute; output is byte-identical to an "
                         "uninterrupted run")
    ap.add_argument("--no-checkpoint", action="store_true",
                    help="disable the per-bucket checkpoint journal")
    ap.add_argument("--bucket-timeout", type=float, metavar="SECONDS",
                    help="soft wall-clock budget per length bucket; a "
                         "breach counts as a device fault and demotes the "
                         "bucket down the degradation ladder")
    ap.add_argument("--no-ladder", action="store_true",
                    help="fail fast on device faults instead of retrying "
                         "buckets down the degradation ladder")
    ap.add_argument("--mesh-shards", type=int, metavar="N",
                    help="shard every bucket's iteration passes over N "
                         "ranks (data-parallel mesh; started here on gloo "
                         "unless run under torchrun). A chip-level fault "
                         "drops the failed shard and rebalances its reads "
                         "onto the survivors, then single-device, then "
                         "the host rungs")
    ap.add_argument("--mesh-pass-timeout", type=float, metavar="SECONDS",
                    help="soft wall-clock budget per sharded iteration "
                         "pass; a breach counts as a 'straggler' mesh "
                         "fault")
    ap.add_argument("--trace", metavar="FILE",
                    help="write the span trace (Chrome trace-event JSONL, "
                         "Perfetto-loadable) and log a span summary")
    ap.add_argument("--metrics-out", metavar="FILE",
                    help="write KPI counters/gauges/histograms as JSON")
    ap.add_argument("--qc-out", metavar="FILE",
                    help="write per-read correction-QC provenance as JSONL "
                         "(meta line with the aggregate, then one record "
                         "per read) and log the QC report")
    ap.add_argument("--truth", metavar="FILE",
                    help="score corrected reads against this truth sidecar "
                         "(io/simulate.py:write_truth_sidecar JSONL): "
                         "identity before/after and residual error "
                         "classes land in the QC records, the aggregate "
                         "and the accuracy_* gauges")
    ap.add_argument("--compile-ledger", metavar="FILE",
                    help="write the compile ledger (JSONL: the kernel "
                         "library's build window and each kernel entry's "
                         "first call, with the census) and log the census")
    ap.add_argument("--compile-cache", metavar="DIR", nargs="?",
                    const="auto",
                    help="build the kernel library into and load it from "
                         "DIR (default: the usual build directory); the "
                         "ledger marks the build a hit or a miss")
    ap.add_argument("--xprof", metavar="DIR",
                    help="wrap the run in torch.profiler (CPU, and CUDA on "
                         "the card) with the span tree's ranges, and write "
                         "its Chrome trace into DIR")
    ap.add_argument("--log-json", action="store_true",
                    help="one structured JSON log record per line "
                         "(ts/level/logger/msg) instead of the human "
                         "format")
    ap.add_argument("--overwrite", action="store_true",
                    help="allow writing into a non-empty output dir")
    ap.add_argument("--keep-temporary-files", action="store_true")
    ap.add_argument("--debug", action="store_true",
                    help="DEBUG logging, the finish pass's admitted "
                         "alignments as <pre>/admitted.*.sam and a "
                         "per-read <name>.debug.tsv")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the passes and siamaera run (default: the "
                         "card; there is no fallback to the CPU)")
    return ap


def _read_records(paths: List[str]):
    from proovread_tpu_torch.io import fasta, fastq
    out = []
    for p in paths:
        rd = (fastq.FastqReader(p) if _looks_fastq(p)
              else fasta.FastaReader(p))
        out.extend(rd)
    return out


def _looks_fastq(path: str) -> bool:
    import gzip
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as fh:
        first = fh.read(1)
    return first == b"@"


class _JsonLogFormatter(logging.Formatter):
    """One JSON object per record: the --log-json scraper format."""

    def format(self, record: logging.LogRecord) -> str:
        d = {"ts": round(record.created, 3), "level": record.levelname,
             "logger": record.name, "msg": record.getMessage()}
        if record.exc_info:
            d["exc"] = self.formatException(record.exc_info)
        return json.dumps(d)


def _setup_logging(args) -> None:
    """Configure logging without clobbering a host application's setup:
    ``logging.basicConfig`` only runs when the root logger has no handlers
    yet; ``--log-json`` scopes its handler to this package's logger."""
    level = (logging.DEBUG if args.debug
             else logging.ERROR if args.quiet else logging.INFO)
    root = logging.getLogger()
    if args.log_json:
        if not any(isinstance(h.formatter, _JsonLogFormatter)
                   for h in log.handlers):
            h = logging.StreamHandler()
            h.setFormatter(_JsonLogFormatter())
            log.addHandler(h)
        log.propagate = False
        log.setLevel(level)
        return
    for h in list(log.handlers):
        if isinstance(h.formatter, _JsonLogFormatter):
            log.removeHandler(h)
    log.propagate = True
    log.setLevel(level)
    if not root.handlers:
        logging.basicConfig(
            level=level,
            format="[%(asctime)s] %(message)s", datefmt="%H:%M:%S")


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _launch_ranks(n: int, argv: List[str], device: str) -> int:
    """Run this command on ``n`` ranks started here (``parallel/launch.py``)
    and return rank 0's exit code; 1 naming the rank if one failed."""
    from proovread_tpu_torch.parallel.launch import RankFailed, launch
    try:
        return launch(n, main, argv, device=device)
    except RankFailed as e:
        print(f"error: mesh run: rank {e.rank} failed "
              f"(exit code {e.exitcode})", file=sys.stderr)
        return 1


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "serve":
        # imported only here: the batch path imports nothing of serve
        from proovread_tpu_torch.serve.cli import serve_main
        return serve_main(argv[1:])
    args = build_parser().parse_args(argv)
    from proovread_tpu_torch.parallel.launch import init_from_env
    joined = init_from_env(args.device)
    from proovread_tpu_torch.obs import compilecache
    cache_state = compilecache.cache_state()
    try:
        return _main(args, argv)
    finally:
        # --compile-cache points this process's kernel build directory
        # elsewhere for the run only (main() may run in a host process)
        compilecache.restore_cache(cache_state)
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def _main(args, argv: List[str]) -> int:
    from proovread_tpu_torch.parallel.dmesh import world
    rank, n_ranks = world()
    _setup_logging(args)
    if rank:
        # one log of the run: the other ranks say only what goes wrong
        log.setLevel(max(log.getEffectiveLevel(), logging.WARNING))

    from proovread_tpu_torch.config import Config, mode_auto

    if args.threads and args.threads > 1:
        log.warning("-t/--threads %d is accepted for interface parity but "
                    "has no effect", args.threads)

    if args.create_cfg:
        Config.create_template(args.create_cfg)
        print(f"config template written to {args.create_cfg}")
        return 0

    if not args.long_reads:
        return _error("-l/--long-reads is required")
    if not (args.short_reads or args.unitigs or args.sam or args.bam):
        return _error("need -s, -u, --sam or --bam")
    if not args.pre:
        return _error("-p/--pre is required")

    cfg = Config.load(args.cfg)
    try:
        from proovread_tpu_torch.device import resolve
        resolve(args.device)
    except RuntimeError as e:
        return _error(str(e))
    if args.mesh_shards is not None:
        cfg.data["mesh-shards"] = args.mesh_shards
    if args.mesh_pass_timeout is not None:
        cfg.data["mesh-pass-timeout"] = args.mesh_pass_timeout
    n_mesh = int(cfg.get("mesh-shards") or 0)
    if n_mesh >= 2 and n_ranks == 1:
        return _launch_ranks(n_mesh, argv, args.device)

    outdir = args.pre
    if args.debug:
        # the finish pass's admitted-alignment SAM dumps land next to the
        # outputs
        cfg.data["debug-dir"] = outdir
    # --resume must be able to re-enter the interrupted run's output dir;
    # every rank looks before rank 0 writes anything (the barrier)
    if (os.path.isdir(outdir) and os.listdir(outdir)
            and not (args.overwrite or args.resume)):
        return _error(f"output dir {outdir!r} not empty (use --overwrite, "
                      "or --resume to continue a crashed run)")
    if n_ranks > 1:
        import torch.distributed as dist
        dist.barrier()
    if rank == 0:
        os.makedirs(outdir, exist_ok=True)
    # the journal is on by default: it is what makes --resume possible
    if args.resume and args.no_checkpoint:
        return _error("--resume needs the checkpoint journal; drop "
                      "--no-checkpoint")
    ckpt_dir = None
    if not args.no_checkpoint:
        ckpt_dir = os.path.join(outdir, ".proovread_ckpt")
        cfg.data["checkpoint-dir"] = ckpt_dir
    if args.resume:
        cfg.data["resume"] = 1
    if args.bucket_timeout is not None:
        cfg.data["bucket-timeout"] = args.bucket_timeout
    if args.no_ladder:
        cfg.data["resilience-ladder"] = 0
    name = os.path.basename(outdir.rstrip("/")) or "proovread"

    # observability: flags override config keys. Tracing (--trace or
    # --xprof) brings the profiler, the memory sampler and the leak
    # report with it.
    from proovread_tpu_torch import obs
    trace_path = args.trace or cfg.get("trace-file")
    metrics_path = args.metrics_out or cfg.get("metrics-out")
    qc_path = args.qc_out or cfg.get("qc-out")
    truth_path = args.truth or cfg.get("truth-sidecar")
    ledger_path = args.compile_ledger or cfg.get("compile-ledger")
    cache_dir = args.compile_cache or cfg.get("compile-cache-dir")
    if cache_dir:
        # every rank builds or loads the library
        cache_dir = obs.compilecache.enable_persistent_cache(cache_dir)
        log.info("compile cache: kernel library built into / loaded "
                 "from %s", cache_dir)
    if rank:
        # rank 0 writes the run's account; the others run the same tasks
        # and write nothing, with a QC recorder where rank 0 has one (the
        # passes exchange its rows)
        if qc_path or truth_path:
            with obs.qc.scope():
                return _run(args, argv, cfg, outdir, name, mode_auto,
                            ckpt_dir=ckpt_dir, writer=False)
        return _run(args, argv, cfg, outdir, name, mode_auto,
                    ckpt_dir=ckpt_dir, writer=False)
    tracing_on = bool(trace_path or args.xprof)
    tracer = obs.install_tracer() if tracing_on else None
    registry = obs.metrics.install() if metrics_path else None
    profiler = obs.profile.install() if tracing_on else None
    mem_sampler = obs.memory.install() if tracing_on else None
    leak_check = obs.memory.LeakCheck() if tracing_on else None
    # --truth scores into the per-read QC records, so it brings the
    # recorder with it even without a --qc-out artifact
    qc_recorder = obs.qc.install() if (qc_path or truth_path) else None
    ledger = (obs.compilecache.install(obs.compilecache.Ledger(
        backend=args.device)) if ledger_path else None)
    xprof = None
    if args.xprof:
        # a profiler that fails to start unwinds every install above: a
        # host calling main() again must not stay traced
        try:
            xprof = _start_xprof(args.xprof, args.device)
        except Exception:
            obs.trace.set_annotations(False)
            for on, off in ((mem_sampler, obs.memory.uninstall),
                            (profiler, obs.profile.uninstall),
                            (tracer, obs.uninstall_tracer),
                            (registry, obs.metrics.uninstall),
                            (qc_recorder, obs.qc.uninstall),
                            (ledger, obs.compilecache.uninstall)):
                if on is not None:
                    off()
            raise
        log.info("xprof: torch.profiler trace -> %s (ranges follow the "
                 "span tree)", args.xprof)

    t_start = time.monotonic()
    try:
        rc = _run(args, argv, cfg, outdir, name, mode_auto, truth_path,
                  ckpt_dir)
    finally:
        # written even on a crashed run: the partial span tree, the QC
        # records that completed and the counters say where it died
        if xprof is not None:
            obs.trace.set_annotations(False)
            _stop_xprof(xprof, args.xprof, name)
        if mem_sampler is not None:
            obs.memory.uninstall()
        if tracer is not None:
            obs.uninstall_tracer()
            try:
                if trace_path:
                    tracer.write_chrome(trace_path)
                    log.info("trace: %d span(s) -> %s (load in "
                             "ui.perfetto.dev)", len(tracer.events),
                             trace_path)
                for ln in tracer.summary_lines():
                    log.info("%s", ln)
            except OSError as e:
                log.warning("trace write failed: %s", e)
        if profiler is not None:
            obs.profile.uninstall()
            if profiler.records:
                for ln in obs.profile.roofline_lines(profiler):
                    log.info("%s", ln)
            _queue_leak_report(leak_check)
        if qc_recorder is not None:
            obs.qc.uninstall()
            try:
                qc_agg = (qc_recorder.last_aggregate
                          or qc_recorder.aggregate())
                if qc_path:
                    qc_recorder.write_jsonl(qc_path, agg=qc_agg)
                    log.info("qc: %d per-read record(s) -> %s",
                             len(qc_recorder.records), qc_path)
                for ln in qc_recorder.report_lines(agg=qc_agg):
                    log.info("%s", ln)
            except OSError as e:
                log.warning("qc write failed: %s", e)
        if ledger is not None:
            obs.compilecache.uninstall()
            try:
                # written even on a crashed run: the rows say which build
                # and which entries' first calls happened
                census = ledger.census()
                ledger.write_jsonl(ledger_path, census=census)
                log.info("compile ledger: %d row(s) / %d program(s) -> %s",
                         len(ledger.rows), census["n_programs"],
                         ledger_path)
                for ln in ledger.report_lines(census=census):
                    log.info("%s", ln)
            except OSError as e:
                log.warning("compile ledger write failed: %s", e)
        if registry is not None:
            obs.metrics.uninstall()
            try:
                d = registry.as_dict()
                with open(metrics_path, "w") as fh:
                    json.dump(d, fh, indent=2, sort_keys=True)
                    fh.write("\n")
                log.info("metrics: %d series -> %s",
                         sum(len(m["series"])
                             for sec in ("counters", "gauges", "histograms")
                             for m in d[sec].values()), metrics_path)
            except OSError as e:
                log.warning("metrics write failed: %s", e)
    if rc != 0:
        return rc
    log.info("total wall: %.1fs", time.monotonic() - t_start)
    return 0


def _start_xprof(out_dir: str, device: str):
    """A started ``torch.profiler.profile`` over the CPU (and CUDA on the
    card), with the spans' ``record_function`` ranges switched on."""
    from torch.profiler import ProfilerActivity, profile

    from proovread_tpu_torch.obs import trace as obs_trace
    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    obs_trace.set_annotations(True)
    prof.__enter__()
    return prof


def _stop_xprof(prof, out_dir: str, name: str) -> None:
    """Stop the profiler and write its Chrome trace as
    ``DIR/<name>.pt.trace.json`` (TensorBoard's profiler plugin reads
    ``*.pt.trace.json``)."""
    try:
        prof.__exit__(None, None, None)
        path = os.path.join(out_dir, f"{name}.pt.trace.json")
        prof.export_chrome_trace(path)
        log.info("xprof: trace -> %s", path)
    except (OSError, RuntimeError) as e:
        log.warning("xprof trace write failed: %s", e)


_pending_leak_check = None
_leak_atexit_registered = False


def _queue_leak_report(leak_check) -> None:
    """Queue one end-of-process CUDA tensor leak report, for the most
    recent traced run (a later in-process run replaces the pending one)."""
    global _pending_leak_check, _leak_atexit_registered
    _pending_leak_check = leak_check
    if not _leak_atexit_registered:
        _leak_atexit_registered = True
        import atexit
        atexit.register(_report_pending_leaks)


def _report_pending_leaks() -> None:
    leak_check = _pending_leak_check
    if leak_check is None:
        return
    rep = leak_check.report()
    lvl = log.warning if rep["leaked_bytes"] > (1 << 20) else log.info
    lvl("leak check: %d CUDA tensor(s) / %d bytes still live after the "
        "run%s", rep["n_leaked"], rep["leaked_bytes"],
        f" — top: {rep['examples']}" if rep["n_leaked"] else "")


def _run(args, argv, cfg, outdir: str, name: str, mode_auto,
         truth_path: Optional[str] = None,
         ckpt_dir: Optional[str] = None, writer: bool = True) -> int:
    """Input read → task run → output write (→ accuracy scoring), all
    inside the root ``run`` span; then the journal ``ckpt_dir`` goes.
    ``writer=False`` (a mesh rank but rank 0) runs the tasks and writes
    nothing."""
    from proovread_tpu_torch import obs
    with obs.span("run", cat="run"):
        with obs.span("read-inputs", cat="io"):
            longs = _read_records(args.long_reads)
            shorts = (_read_records(args.short_reads) if args.short_reads
                      else [])
            utgs = _read_records(args.unitigs) if args.unitigs else []

        with obs.span("preflight", cat="host"):
            sr_lens = (np.array([len(r) for r in shorts]) if shorts
                       else np.zeros(0))
            min_sr_len = int(np.median(sr_lens)) if len(sr_lens) else 0

            # preflight (bin/proovread:457-464,586-592): catch mis-supplied
            # inputs before any device time is spent
            if len(sr_lens) and sr_lens.max() > 1000 \
                    and not args.ignore_sr_length:
                print(f"error: short reads up to {int(sr_lens.max())}bp — "
                      "is -s the right file? (--ignore-sr-length to "
                      "proceed)", file=sys.stderr)
                return 2
            too_long = [r.id for r in longs if len(r.id) > 256]
            if too_long:
                print("error: read id longer than 256 chars: "
                      f"{too_long[0]!r}", file=sys.stderr)
                return 2
            if args.device == "cuda":
                import torch
                log.info("preflight: %d device(s), platform cuda (%s)",
                         torch.cuda.device_count(),
                         torch.cuda.get_device_name(0))
            else:
                log.info("preflight: 1 device(s), platform cpu")

            from proovread_tpu_torch.pipeline.ccs import is_subread_set
            mode = args.mode
            if mode == "auto":
                mode = mode_auto(min_sr_len, bool(utgs),
                                 is_subread_set(longs), sam=bool(args.sam),
                                 bam=bool(args.bam))
            tasks = cfg.tasks(mode)
            log.info("mode %s: tasks %s", mode, " ".join(tasks))

            # parameter.log (bin/proovread:401-416)
            if writer:
                with open(os.path.join(outdir, f"{name}.parameter.log"),
                          "w") as fh:
                    fh.write(json.dumps({
                        "argv": sys.argv if argv is None else [PROG] + argv,
                        "mode": mode, "tasks": tasks,
                        "n_long_reads": len(longs),
                        "n_short_reads": len(shorts),
                        "n_unitigs": len(utgs), "median_sr_len": min_sr_len,
                        "config": cfg.data,
                    }, indent=2))

        from proovread_tpu_torch.pipeline.tasks import run_tasks
        with obs.span("tasks", cat="mode", mode=mode):
            result = run_tasks(
                cfg, mode, tasks, longs, shorts, utgs,
                coverage=args.coverage, lr_min_length=args.lr_min_length,
                sampling=not args.no_sampling,
                haplo_coverage=args.haplo_coverage, device=args.device,
                sam=args.sam, bam=args.bam)
        if not writer:
            return 0

        # -- reference output layout (bin/proovread:904-956) --------------
        with obs.span("write-outputs", cat="io"):
            from proovread_tpu_torch.io.fasta import FastaWriter
            from proovread_tpu_torch.io.fastq import FastqWriter

            def _w(path, records, fq=True):
                with open(os.path.join(outdir, path), "wb") as fh:
                    w = FastqWriter(fh) if fq else FastaWriter(fh)
                    for r in records:
                        w.write(r)

            _w(f"{name}.untrimmed.fq", result.untrimmed)
            _w(f"{name}.trimmed.fq", result.trimmed)
            _w(f"{name}.trimmed.fa", result.trimmed, fq=False)
            if args.debug:
                # per-read consensus debug table (the role of bam2cns
                # --debug's trace strings, bin/bam2cns:271-295)
                with open(os.path.join(outdir, f"{name}.debug.tsv"),
                          "w") as fh:
                    fh.write("id\tlen\tmean_phred\tmasked_frac\n")
                    for r in result.untrimmed:
                        q = r.qual if r.qual is not None else np.zeros(0)
                        fh.write(
                            f"{r.id}\t{len(r)}\t"
                            f"{float(q.mean()) if len(q) else 0:.1f}\t"
                            f"{float((q == 0).mean()) if len(q) else 0:.3f}"
                            "\n")
            with open(os.path.join(outdir, f"{name}.ignored.tsv"),
                      "w") as fh:
                for rid, why in result.ignored:
                    fh.write(f"{rid}\t{why}\n")
            with open(os.path.join(outdir, f"{name}.chim.tsv"), "w") as fh:
                for rid, f0, t0, s in result.chimera:
                    fh.write(f"{rid}\t{f0}\t{t0}\t{s:.3f}\n")

        # -- accuracy scoreboard: every corrected read against its
        # error-free source, merged into the QC records and gauges (the
        # recorder is installed whenever truth_path is set)
        if truth_path:
            t_score = time.monotonic()
            with obs.span("score-accuracy", cat="host"):
                truth_map, bp_map = obs.accuracy.load_truth_sidecar(
                    truth_path)
                qc_rec = obs.qc.current()
                summary = obs.accuracy.apply_to_qc(
                    qc_rec, longs, result.untrimmed, truth_map,
                    truth_breakpoints=(bp_map if any(bp_map.values())
                                       else None), device=args.device)
                result.qc = qc_rec.aggregate()
                qc_rec.last_aggregate = result.qc
                qc_rec.to_metrics(result.qc)
            if summary["n_scored"]:
                log.info(
                    "accuracy: %d/%d read(s) scored vs truth — identity "
                    "%.4f -> %.4f (%d classified) in %.3f s",
                    summary["n_scored"], len(longs),
                    summary["identity_before"], summary["identity_after"],
                    summary["n_classified"], time.monotonic() - t_score)
            else:
                log.warning("accuracy: truth sidecar %s matched no "
                            "corrected read ids — nothing scored",
                            truth_path)

        for rep in result.reports:
            if rep.note:
                # demotions and journal replays carry their story here
                log.info("task %-16s %s", rep.task, rep.note)
                continue
            sat = ""
            if rep.n_dropped_cap or rep.n_dropped_cov:
                sat = (f"  dropped {rep.n_dropped_cap} cap /"
                       f" {rep.n_dropped_cov} cov")
            log.info("task %-16s masked/supported %5.1f%%  candidates %d%s",
                     rep.task, rep.masked_frac * 100, rep.n_candidates, sat)
        # the journal's job is done once the outputs are on disk (it holds
        # every corrected read again); --keep-temporary-files keeps it
        if ckpt_dir and os.path.isdir(ckpt_dir) \
                and not args.keep_temporary_files:
            import shutil
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            log.info("checkpoint journal removed (outputs written; "
                     "--keep-temporary-files preserves it)")
        log.info("done: %d corrected, %d trimmed, %d ignored, %d chimera",
                 len(result.untrimmed), len(result.trimmed),
                 len(result.ignored), len(result.chimera))
    return 0


if __name__ == "__main__":
    sys.exit(main())
