"""Observability: the run's own account (port of ``proovread_tpu/obs``).

- ``obs.span(name, cat=..., **args)``: hierarchical monotonic-clock spans
  with CUDA fencing while tracing (``obs.trace``), serialized as Chrome
  trace-event JSONL (``--trace``).
- ``obs.metrics``: typed counter/gauge/histogram registry dumped as one
  JSON object (``--metrics-out``) and embedded in
  ``PipelineResult.metrics``.
- ``obs.memory``: CUDA memory sampled at span boundaries, and a leak
  check of CUDA tensors around a run.
- ``obs.qc``: per-read correction-quality provenance (``--qc-out``) and
  its aggregate report.
- ``obs.accuracy``: the accuracy scoreboard, identity against the
  simulators' truth sidecars (``--truth``), its LCS a CUDA kernel.
- ``obs.compilecache``: the compile ledger (``--compile-ledger``: the
  kernel library's build windows and each entry's first call) and the
  library cache (``--compile-cache``); ``obs.profile``: per-kernel cost
  attribution and the roofline (with ``--trace`` / ``--xprof``);
  ``obs.census`` and ``obs.boot``: the cold and warm runs and the
  measured boot from a kernel-build artifact (``analysis/factory.py``).
- ``obs.validate``: the artifact validators (the reference's schemas and
  verdicts); ``obs.smoke``: a traced, scored run with every artifact
  checked; ``obs.load``: the fleet's LOAD rows and load smoke.

All are off by default (shared no-op singletons) and are switched on by
the CLI flags, their config keys, or programmatically with
``obs.tracing()`` / ``obs.metrics.scope()`` / ``obs.qc.scope()``.
"""

from proovread_tpu_torch.obs import (accuracy, compilecache, memory,
                                     metrics, profile, qc)
from proovread_tpu_torch.obs.trace import (NOOP_SPAN, Span, Tracer,
                                           enabled, span, tracing)
from proovread_tpu_torch.obs.trace import current as current_tracer
from proovread_tpu_torch.obs.trace import install as install_tracer
from proovread_tpu_torch.obs.trace import uninstall as uninstall_tracer

__all__ = [
    "accuracy", "compilecache", "metrics", "memory", "profile", "qc",
    "span", "Span", "Tracer", "tracing", "enabled",
    "current_tracer", "install_tracer", "uninstall_tracer", "NOOP_SPAN",
]
