"""End-to-end serving smoke (port of ``proovread_tpu/serve/smoke.py``).

Boots the correction server with a deterministic mixed-traffic stream
(``io/simulate.py:simulate_job_stream`` — CLR + CCS + unitig jobs from two
tenants) and ONE injected fault per job-level class
(``testing/faults.py``)::

    parse@j1x1      job 1's submission is unparseable  -> rejected
    quota@j2x1      job 2 hits tenant quota            -> rejected+retry-after
    deadline@j3x1   job 3's deadline breaches          -> expired
    worker@j4x1     the worker dies mid-wave           -> wave retried
    journal@j5      job 5's journal entry corrupts     -> failed at resume

then drains mid-run (the ``drain_after_buckets`` knob — the deterministic
stand-in for the SIGTERM that is ALSO sent and handled when the smoke
runs on the main thread), restarts the server with ``resume=True`` on the
same state dir, and asserts the whole envelope:

* drain is clean, in-flight buckets finished, the rest journaled;
* after resume, EVERY submitted job is terminal with the expected
  status — nothing silently lost (the corrupt entry surfaces as a
  ``failed``/``journal-corrupt`` job);
* both SLO artifacts validate strictly (``obs.validate.validate_slo``),
  the final one with ``require_drained``;
* no CUDA tensor leak once the servers are gone (``obs.memory.LeakCheck``).

``envelope`` runs the drill on any workload and pipeline config
(``chip_smoke.py`` phase 16 runs it at full width on the card);
``python -m proovread_tpu_torch.serve.smoke [--device cpu]`` runs it on a
tiny genome.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import signal
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

FAULTS = "parse@j1x1;quota@j2x1;deadline@j3x1;worker@j4x1;journal@j5"


def _log(msg: str) -> None:
    print(f"[serve-smoke] {msg}", file=sys.stderr, flush=True)


class SmokeFailed(AssertionError):
    """The envelope did not hold; the message names what broke."""


def expected_status(ordinal: int):
    """(status, reason fragment) the drill expects of the job submitted
    at ``ordinal`` (``FAULTS``); ``None`` for the two rejected ones."""
    if ordinal in (1, 2):
        return None
    if ordinal == 3:
        return ("expired", "deadline")
    if ordinal == 5:
        return ("failed", "journal-corrupt")
    return ("completed", "")


def envelope(shorts, jobs, pcfg, tmp: str, max_wave_jobs: int = 3,
             timeout: float = 300.0, signals: bool = True,
             quota=None) -> Dict[str, Any]:
    """The drill on ``jobs`` (``SimJob``s, submitted in order over the
    socket with ``ServeClient``): phase 1 with ``FAULTS`` and a drain after
    one bucket, phase 2 resumed on the same state dir. Raises
    :class:`SmokeFailed`. Returns the two SLO snapshots (``slo1``, ``slo2``:
    the validated artifacts), every accepted job's final status and, for
    completed jobs, the ``result`` payload (``results``), the waves run
    (``waves``) and the two phases' walls. ``quota`` (a ``TenantQuota``,
    the server's default without) must let every job but job 2 in. With
    ``signals`` (on the main
    thread only) phase 1's server takes SIGTERM/SIGINT and is sent a
    SIGTERM at its drain; the process's own handlers are restored after."""
    from proovread_tpu_torch.obs.validate import (ValidationError,
                                                  validate_slo)
    from proovread_tpu_torch.serve.admission import TenantQuota
    from proovread_tpu_torch.serve.protocol import ServeClient
    from proovread_tpu_torch.serve.server import CorrectionServer, ServeConfig

    quota = quota or TenantQuota()
    if len(jobs) < 6:
        raise ValueError("the drill needs at least 6 jobs (ordinals 0-5)")
    state = os.path.join(tmp, "state")
    sock = os.path.join(tmp, "serve.sock")
    slo1 = os.path.join(tmp, "slo1.json")
    slo2 = os.path.join(tmp, "slo2.json")
    signals = signals and (threading.current_thread()
                           is threading.main_thread())

    # -- phase 1: boot, inject one fault per class, drain mid-run --------
    t0 = time.monotonic()
    srv = CorrectionServer(shorts, ServeConfig(
        state_dir=state, socket_path=sock, slo_path=slo1, quota=quota,
        max_wave_jobs=max_wave_jobs, job_retries=3, qc=True,
        fault_spec=FAULTS, drain_after_buckets=1), pcfg)
    handlers = {s: signal.getsignal(s)
                for s in (signal.SIGTERM, signal.SIGINT)}
    if signals:
        srv.install_signal_handlers()
    srv.start(worker=False)        # listener up, worker gated
    rejected = {}
    with ServeClient(sock) as cli:
        if not cli.ping()["ok"]:
            raise SmokeFailed("ping failed")
        for j in jobs:
            r = cli.submit(j.job_id, j.tenant, j.records, mode=j.mode)
            _log(f"submit {j.job_id} ({j.mode}): {r['status']}"
                 + (f" [{r.get('reason')}"
                    f" retry_after={r.get('retry_after_s')}]"
                    if r["status"] == "rejected" else ""))
            if r["status"] == "rejected":
                rejected[j.job_id] = r["reason"]
                if (r["reason"].startswith("quota")
                        and not r.get("retry_after_s", 0) > 0):
                    raise SmokeFailed("backpressure rejection lacks "
                                      "retry_after_s")
        srv.start_worker()
        # the deterministic mid-wave drain (drain_after_buckets=1), plus
        # the real signal path on top (idempotent) where it can land
        while not srv._drain.is_set():
            if time.monotonic() - t0 > timeout:
                raise SmokeFailed("drain never triggered")
            time.sleep(0.05)
        if signals:
            os.kill(os.getpid(), signal.SIGTERM)
    try:
        clean = srv.join(timeout=timeout)
    finally:
        if signals:
            for sig, h in handlers.items():
                signal.signal(sig, h)
    if not clean:
        raise SmokeFailed("phase-1 drain not clean")
    wall1 = time.monotonic() - t0
    snap1 = srv.slo_snapshot()
    _log(f"phase 1 drained: jobs={json.dumps(snap1['jobs'])} "
         f"rejections={json.dumps(snap1['rejections'])}")
    if sorted(rejected.values()) != ["parse-error", "quota-jobs"]:
        raise SmokeFailed(f"expected one parse + one quota rejection, got "
                          f"{rejected}")
    if snap1["jobs"]["journaled"] == 0:
        raise SmokeFailed("drain left nothing journaled — the mid-run "
                          "drain did not exercise resume")
    try:
        validate_slo(slo1)
    except ValidationError as e:
        raise SmokeFailed(f"phase-1 SLO invalid: {e}") from e
    waves1 = srv.registry.counter("serve_waves", "waves").value()
    del srv

    # -- phase 2: restart + resume on the same state dir -----------------
    t1 = time.monotonic()
    srv2 = CorrectionServer(shorts, ServeConfig(
        state_dir=state, socket_path=sock, slo_path=slo2, quota=quota,
        max_wave_jobs=max_wave_jobs, job_retries=3, qc=True,
        fault_spec=FAULTS, resume=True), pcfg)
    srv2.start()
    status: Dict[str, str] = {}
    results: Dict[str, Dict[str, Any]] = {}
    with ServeClient(sock) as cli:
        for k, j in enumerate(jobs):
            want = expected_status(k)
            if want is None:
                continue
            st = cli.wait(j.job_id, timeout=timeout)
            got = st.get("status")
            if got != want[0] or want[1] not in st.get("reason", ""):
                raise SmokeFailed(
                    f"job {j.job_id}: wanted {want[0]}"
                    f"{f'/{want[1]}' if want[1] else ''}, got {got} "
                    f"({st.get('reason')!r})")
            status[j.job_id] = got
            if got == "completed":
                # completed jobs serve their results, QC payloads too
                res = cli.result(j.job_id)
                if not res["ok"] or res["qc"] is None:
                    raise SmokeFailed(f"result op broken: "
                                      f"{json.dumps(res)[:300]}")
                results[j.job_id] = res
        cli.drain()
    if not srv2.join(timeout=timeout):
        raise SmokeFailed("phase-2 drain not clean")
    wall2 = time.monotonic() - t1
    try:
        stats = validate_slo(slo2, require_drained=True)
    except ValidationError as e:
        raise SmokeFailed(f"phase-2 SLO invalid: {e}") from e
    if stats["jobs"]["journaled"] != 0:
        raise SmokeFailed(f"jobs left journaled after full drain: "
                          f"{stats['jobs']}")
    _log(f"phase 2 SLO OK: {json.dumps(stats)}")
    waves = waves1 + srv2.registry.counter("serve_waves", "waves").value()
    with open(slo1) as fh:
        s1 = json.load(fh)
    with open(slo2) as fh:
        s2 = json.load(fh)
    del srv2
    return {"slo1": s1, "slo2": s2, "status": status, "results": results,
            "rejected": rejected, "waves": int(waves),
            "wall1_s": wall1, "wall2_s": wall2}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="proovread-tpu-torch-serve-smoke",
        description="Serving fault drill: one fault per job class, a drain "
                    "mid-run and a resume.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the waves run (default: the card)")
    args = ap.parse_args(argv)

    from proovread_tpu_torch.io.simulate import (simulate_job_stream,
                                                 simulate_short_reads)
    from proovread_tpu_torch.obs.memory import LeakCheck
    from proovread_tpu_torch.pipeline.driver import PipelineConfig
    from proovread_tpu_torch.pipeline.trim import TrimParams

    genome, jobs = simulate_job_stream(seed=23, n_jobs=8,
                                       genome_size=1600, mean_len=420,
                                       min_len=300)
    shorts = simulate_short_reads(genome, 22.0, seed=24)
    _log(f"workload: {len(jobs)} jobs "
         f"({'/'.join(j.mode for j in jobs)}), "
         f"{len(shorts)} short reads, device {args.device}")
    pcfg = PipelineConfig(engine="device", n_iterations=2, sampling=False,
                          batch_reads=8, device_chunk=128,
                          host_chunk_rows=512,
                          trim=TrimParams(min_length=150),
                          device=args.device)
    leak = LeakCheck()
    with tempfile.TemporaryDirectory(prefix="proovread_serve_") as tmp:
        try:
            envelope(shorts, jobs, pcfg, tmp)
        except SmokeFailed as e:
            _log(f"FAILED: {e}")
            return 1
    gc.collect()
    lrep = leak.report()
    if lrep["leaked_bytes"] > 1 << 20:
        _log(f"FAILED: CUDA tensor leak after server shutdown: {lrep}")
        return 1
    _log(f"leak check OK: {json.dumps(lrep)}")
    _log("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
