"""Hierarchical span tracer: one clock (``time.monotonic``), one schema.

Port of ``proovread_tpu/obs/trace.py``. The run's timing is one span tree
(run -> task -> bucket -> pass -> kernel) recorded against the monotonic
clock and serialized two ways:

- **Chrome trace events** (:meth:`Tracer.write_chrome`): one JSON object
  per line (``X`` complete events plus one ``M`` process-name record), the
  form Perfetto's JSON trace reader loads directly.
- **Summary table** (:meth:`Tracer.summary_lines`): per-(depth, name)
  aggregation rendered at end of run via ``log.info``.

**Device fencing.** CUDA launches are asynchronous: the host-side duration
of an enqueue says nothing about device time. A span that launches device
work calls :meth:`Span.fence` with its output tensors; at span exit, and
only while a tracer is installed, the tracer synchronizes the CUDA devices
those tensors live on (CPU tensors need nothing), so device time lands in
the span that launched the work. With tracing off, :func:`span` returns a
shared no-op and ``fence`` does nothing: an untraced run adds no
synchronization.

**Compile vs execute.** The reference attributes XLA backend compiles to
the open spans through a ``jax.monitoring`` listener. PyTorch runs eagerly
and the kernels are built once, before the first launch
(``proovread_tpu_torch.kernels``), so the port takes the reference's own
branch for a process without that listener: every split span carries
``compile_ms`` 0 and ``execute_ms`` equal to its duration. Nothing
retraces either, so the reference's ``count_retrace`` hook has no
counterpart and the ``jax_retraces`` counter stays declared at 0.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

# span categories whose args always carry the compile/execute split
_SPLIT_CATS = frozenset(("bucket", "attempt", "pass", "kernel"))

# span categories sampled by the device-memory telemetry (obs/memory.py):
# coarse on purpose, so the sampler never becomes the hot path
_MEM_CATS = frozenset(("bucket", "attempt", "pass", "task"))

# obs.memory's sampler, called at _MEM_CATS span exits (set through
# set_memory_sampler so this module never imports obs.memory)
_mem_sampler = None


def set_memory_sampler(sampler) -> None:
    global _mem_sampler
    _mem_sampler = sampler


class _NoopSpan:
    """Shared do-nothing span, returned by :func:`span` while tracing is
    off: ``fence`` returns its argument and synchronizes nothing."""

    __slots__ = ()
    dur_s = 0.0
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def fence(self, obj):
        return obj

    def set(self, **args):
        return self


NOOP_SPAN = _NoopSpan()

_tracer: Optional["Tracer"] = None


def current() -> Optional["Tracer"]:
    return _tracer


def enabled() -> bool:
    return _tracer is not None


def install(tracer: Optional["Tracer"] = None) -> "Tracer":
    """Make ``tracer`` (or a fresh one) the active tracer."""
    global _tracer
    _tracer = tracer if tracer is not None else Tracer()
    return _tracer


def uninstall() -> None:
    global _tracer
    _tracer = None


@contextmanager
def tracing(tracer: Optional["Tracer"] = None):
    """Scoped tracer installation (tests, attribution runs)."""
    global _tracer
    prev = _tracer
    t = install(tracer)
    try:
        yield t
    finally:
        _tracer = prev


def span(name: str, cat: str = "span", **args):
    """Open a span on the active tracer; a shared no-op when tracing is
    off. Usage::

        with obs.span("bwa-sr-1", cat="pass", bucket=gi) as sp:
            out = launch(...)
            sp.fence(out)       # device time lands in this span
    """
    t = _tracer
    if t is None:
        return NOOP_SPAN
    return Span(t, name, cat, args)


def _cuda_devices(obj, out: set) -> set:
    """The CUDA devices of the tensors in ``obj`` (a tensor, or nested
    tuples, named tuples, lists and dicts of them)."""
    import torch
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_devices(v, out)
    return out


def _fence(obj) -> None:
    import torch
    for dev in _cuda_devices(obj, set()):
        torch.cuda.synchronize(dev)


class Span:
    """One live span. Created via :func:`span` / :meth:`Tracer.span`;
    records a Chrome ``X`` (complete) event at exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "depth", "dur_s",
                 "_start", "_fence_obj", "mem_peak", "span_id")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.dur_s = 0.0
        self._fence_obj = None
        self.mem_peak = 0.0         # max sampled live bytes inside span

    def set(self, **args):
        self.args.update(args)
        return self

    def fence(self, obj):
        """Synchronize the CUDA devices of the tensors in ``obj`` at span
        exit, so their device time is attributed here. Returns ``obj``
        unchanged."""
        self._fence_obj = obj
        return obj

    def __enter__(self):
        t = self._tracer
        self.depth = len(t._stack)
        # stable per-tracer ordinal: the QC records (obs/qc.py) link back
        # into the trace by this id
        self.span_id = t._next_span_id
        t._next_span_id += 1
        t._stack.append(self)
        self._start = t._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        t = self._tracer
        if self._fence_obj is not None and exc_type is None:
            _fence(self._fence_obj)
        end = t._clock()
        if t._stack and t._stack[-1] is self:
            t._stack.pop()
        elif self in t._stack:      # mismatched exit (exception unwinding)
            t._stack.remove(self)
        if _mem_sampler is not None and self.cat in _MEM_CATS \
                and exc_type is None:
            # after the end timestamp and the stack pop: the sample's own
            # cost must not inflate this span's duration
            _mem_sampler.sample(self, t)
        self.dur_s = end - self._start
        args = dict(self.args)
        args["depth"] = self.depth
        args["span_id"] = self.span_id
        if self.cat in _SPLIT_CATS:
            args["compile_ms"] = 0.0
            args["execute_ms"] = round(self.dur_s * 1e3, 3)
        if self.mem_peak or (_mem_sampler is not None
                             and self.cat in _MEM_CATS):
            # while the sampler is installed, sampled categories always
            # carry the key (0: nothing live); absent: telemetry off
            args["peak_live_bytes"] = self.mem_peak
        if exc_type is not None:
            args["error"] = exc_type.__name__
        t.events.append({
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": round((self._start - t.t0) * 1e6, 1),
            "dur": round(self.dur_s * 1e6, 1),
            "pid": 1, "tid": 1, "args": args,
        })
        return False


class Tracer:
    """Span collector for one run. Install with :func:`install` /
    :func:`tracing`; pipeline code only ever calls :func:`span`."""

    def __init__(self):
        self._clock = time.monotonic
        self.t0 = self._clock()
        self.events: List[Dict[str, Any]] = []
        self._stack: List[Span] = []
        self._next_span_id = 1

    def span(self, name: str, cat: str = "span", **args) -> Span:
        return Span(self, name, cat, args)

    # -- serialization ----------------------------------------------------
    def write_chrome(self, path: str) -> None:
        """Chrome trace-event JSONL: one event object per line."""
        with open(path, "w") as fh:
            fh.write(json.dumps({
                "name": "process_name", "ph": "M", "pid": 1, "tid": 1,
                "args": {"name": "proovread-tpu-torch"}}) + "\n")
            for ev in self.events:
                fh.write(json.dumps(ev) + "\n")

    def summary_lines(self) -> List[str]:
        """End-of-run table: spans aggregated by (depth, name, cat),
        printed in first-start order with tree indentation."""
        agg: Dict[tuple, List[float]] = {}
        first_ts: Dict[tuple, float] = {}
        for ev in self.events:
            key = (ev["args"].get("depth", 0), ev["name"], ev["cat"])
            a = agg.setdefault(key, [0, 0.0, 0.0])
            a[0] += 1
            a[1] += ev["dur"] / 1e6
            a[2] += ev["args"].get("compile_ms", 0.0) / 1e3
            ts = ev["ts"]
            if key not in first_ts or ts < first_ts[key]:
                first_ts[key] = ts
        lines = [f"{'span':<40}{'n':>5}{'total_s':>10}"
                 f"{'compile_s':>11}{'execute_s':>11}"]
        for key in sorted(agg, key=lambda k: (first_ts[k], k[0])):
            depth, name, _cat = key
            n, dur, comp = agg[key]
            lines.append(f"{'  ' * depth + name:<40}{n:>5}{dur:>10.3f}"
                         f"{comp:>11.3f}{dur - comp:>11.3f}")
        return lines
