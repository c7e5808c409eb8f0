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
the open spans through a ``jax.monitoring`` listener. What the port
compiles is one CUDA library, once a process (``kernels.lib()``): its
build window (the ``nvcc`` runs and the link, or the load of a library
found built) comes to :func:`_on_build` through the kernels' build
listener and is charged to every open span, so each bucket, attempt,
pass and kernel span carries ``compile_ms`` (0 where no build landed) and
``execute_ms`` = duration - compile. The same window feeds the compile
ledger (``obs/compilecache.py``) and the profiler (``obs/profile.py``),
so the ledger's rows reconcile with the span tree. Nothing retraces, so
the reference's ``count_retrace`` hook has no counterpart and the
``jax_retraces`` counter stays declared at 0.

**Cost attribution.** While a profiler is installed (``obs/profile.py``)
every split span carries ``flops``, ``bytes_accessed`` and ``peak_bytes``:
the cost models of the kernel entries launched inside it. With
:func:`set_annotations` on (``--xprof``) every span also opens a
``torch.profiler.record_function`` range named ``cat:name``, so the
profiler's trace lines up with the span tree.
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

# cross-module switches set by obs.profile / obs.memory / obs.compilecache
# (set through the setters so this module never imports them):
# _profile_active: cost attribution on -> _SPLIT_CATS spans always carry
#   the flops/bytes/peak keys (zeros included)
# _annotate: each span opens a torch.profiler.record_function range
# _mem_sampler: obs.memory's sampler, called at _MEM_CATS span exits
# _profile_compile_cb / _ledger_compile_cb: the profiler's and the
#   ledger's build-window listeners
_profile_active = False
_annotate = False
_mem_sampler = None
_profile_compile_cb = None
_ledger_compile_cb = None


def set_memory_sampler(sampler) -> None:
    global _mem_sampler
    _mem_sampler = sampler


def set_profile_active(on: bool) -> None:
    global _profile_active
    _profile_active = bool(on)


def set_profile_compile_listener(cb) -> None:
    global _profile_compile_cb
    _profile_compile_cb = cb


def set_ledger_compile_listener(cb) -> None:
    global _ledger_compile_cb
    _ledger_compile_cb = cb


def set_annotations(on: bool) -> None:
    global _annotate
    _annotate = bool(on)


def _on_build(seconds: float, compiled: bool) -> None:
    """The kernels' build listener: one ``lib()`` build window, to the
    active tracer's open spans, the profiler and the ledger."""
    t = _tracer
    if t is not None:
        t._on_compile(seconds)
    if _profile_compile_cb is not None:
        _profile_compile_cb(seconds)
    if _ledger_compile_cb is not None:
        _ledger_compile_cb(seconds, compiled)


def install_build_hook() -> None:
    """Make :func:`_on_build` the kernels' build listener (idempotent)."""
    from proovread_tpu_torch import kernels
    kernels.set_build_listener(_on_build)


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
    install_build_hook()
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

    __slots__ = ("_tracer", "name", "cat", "args", "depth", "compile_s",
                 "dur_s", "_start", "_fence_obj", "flops", "bytes_acc",
                 "peak_bytes", "mem_peak", "_ann", "span_id")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.compile_s = 0.0
        self.dur_s = 0.0
        self._fence_obj = None
        # cost attribution (obs/profile.py), summed over the kernel
        # entries launched while this span is open
        self.flops = 0.0
        self.bytes_acc = 0.0
        self.peak_bytes = 0.0       # the largest one call's peak inside
        self.mem_peak = 0.0         # max sampled live bytes inside span
        self._ann = None

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
        if _annotate:
            # --xprof: name the profiler's range after this span
            from torch.profiler import record_function
            self._ann = record_function(f"{self.cat}:{self.name}")
            self._ann.__enter__()
        self._start = t._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        t = self._tracer
        if self._fence_obj is not None and exc_type is None:
            _fence(self._fence_obj)
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
            self._ann = None
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
        if self.compile_s > 0 or self.cat in _SPLIT_CATS:
            # a build window can start before a span that is open at its
            # end: never report compile > duration
            comp = min(self.compile_s, self.dur_s)
            args["compile_ms"] = round(comp * 1e3, 3)
            args["execute_ms"] = round(
                max(self.dur_s - comp, 0.0) * 1e3, 3)
        if self.flops or self.bytes_acc or self.peak_bytes or (
                _profile_active and self.cat in _SPLIT_CATS):
            # cost attribution: on every split span while profiling, so
            # readers tell "no device work" (zeros) from "off" (absent)
            args["flops"] = self.flops
            args["bytes_accessed"] = self.bytes_acc
            args["peak_bytes"] = self.peak_bytes
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
        self.n_compiles = 0         # kernel-library build windows
        self.compile_s = 0.0        # their seconds

    def span(self, name: str, cat: str = "span", **args) -> Span:
        return Span(self, name, cat, args)

    def _on_compile(self, duration: float) -> None:
        """Charge one build window to every open span (a bucket's split
        includes its children's)."""
        self.n_compiles += 1
        self.compile_s += duration
        for sp in self._stack:
            sp.compile_s += duration

    def _on_cost(self, flops: float, bytes_acc: float,
                 peak_bytes: float) -> None:
        """Attribute one profiled kernel call to every open span; the peak
        is a max, not a sum."""
        for sp in self._stack:
            sp.flops += flops
            sp.bytes_acc += bytes_acc
            sp.peak_bytes = max(sp.peak_bytes, peak_bytes)

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
