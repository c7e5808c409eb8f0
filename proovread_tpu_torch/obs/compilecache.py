"""Compile ledger and compile cache (port of ``proovread_tpu/obs/compilecache.py``).

The reference records every XLA compilation against the jitted entry
point and shape signature that caused it. What the port compiles is one
CUDA library, built by ``nvcc`` from ``csrc/*.cu`` once a process
(``kernels.lib()``); CUDA compiles nothing per shape. So the ledger's
rows, in the reference's schema (``obs/validate.py:LEDGER_ROW_FIELDS``),
mean:

- ``backend_compile``: one ``kernels.lib()`` build window, the ``nvcc``
  runs and the link when the library was missing, or its load when it was
  found built (``wall_ms == compile_ms`` == the window). The span tracer
  charges the same window to the open spans, so the rows' sum reconciles
  with the trace's compile split (``reconcile_compile_ledger``). One row
  a window, not one a source: the sources compile in parallel, and rows
  for each would sum past the window. ``persistent_cache`` is ``"miss"``
  (``nvcc`` ran) or ``"hit"`` (a library found built) while a cache
  directory is set (:func:`enable_persistent_cache`), else null.
- ``retrace``: the first call of an attributed entry point in this
  process (``obs/profile.py:attributed``), its wall: lazy module loading
  and the first launch, with any build window inside it as
  ``compile_ms``. A program is an entry of the built library: its ``sig``
  is the library's digest (``kernels.digest``), the same for every shape.
  Later calls count as tracing-cache hits.

The census (:meth:`Ledger.census`) keeps the reference's keys:
``n_programs`` the entries called, ``backend_compiles`` /
``backend_compile_s`` the build windows and their seconds, the tracing
hit rate that of calls after each entry's first. It lands in
``PipelineResult.compile_census``, the ``compile_*`` / ``cache_*``
gauges, the ledger artifact's meta line and the serving SLO's
``compile`` block, which therefore agree.

**Zero overhead off**: with no ledger installed the ``attributed``
wrapper costs one module-global read.

:func:`enable_persistent_cache` is ``--compile-cache [DIR]`` and the
config key ``compile-cache-dir``: it points the kernel build directory at
DIR (default: ``kernels.default_build_dir()``), a cache of built libraries
keyed by digest. The reference's ``jax.monitoring`` hooks and its
persistent-cache counters have no counterpart: the build listener is the
one event source.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from proovread_tpu_torch.obs import trace as obs_trace

LEDGER_SCHEMA_VERSION = 1

_UNATTRIBUTED = "(unattributed)"

# the cache directory enable_persistent_cache set (None: cache off)
_cache_dir: Optional[str] = None
_sig: Optional[str] = None


def signature() -> str:
    """The program signature of every attributed call: the kernel
    library's digest (CUDA compiles nothing per shape)."""
    global _sig
    if _sig is None:
        from proovread_tpu_torch import kernels
        _sig = kernels.digest()
    return _sig


def _default_backend() -> str:
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


class Ledger:
    """Compile-event recorder for one run or service lifetime; thread-safe
    (a fleet's replicas call entries at once)."""

    def __init__(self, backend: Optional[str] = None):
        self._lock = threading.Lock()
        self.rows: List[Dict[str, Any]] = []
        # (entry, sig) -> calls; len() is the distinct-program count
        self.programs: Dict[Tuple[str, str], int] = {}
        # (entry, sig) -> build ms inside its calls (the top offenders)
        self._program_compile_ms: Dict[Tuple[str, str], float] = {}
        self.calls = 0
        self.tracing_hits = 0
        self.backend_compiles = 0
        self.backend_compile_s = 0.0
        self.persistent_hits = 0
        self.persistent_misses = 0
        self._live: List[Dict[str, Any]] = []   # first calls in flight
        self._backend = backend
        self._bucket: Optional[int] = None

    def backend(self) -> str:
        if self._backend is None:
            self._backend = _default_backend()
        return self._backend

    def set_bucket(self, bucket: Optional[int]) -> None:
        self._bucket = bucket

    # -- attributed-entry call windows (obs/profile.py) ------------------
    def call_begin(self, entry: str, sig: str) -> Optional[Dict[str, Any]]:
        """Start of an attributed call: a token for :meth:`call_end` when
        (entry, sig) is new in this ledger, else None (a hit, counted)."""
        with self._lock:
            self.calls += 1
            key = (entry, sig)
            n = self.programs.get(key)
            if n is not None:
                self.programs[key] = n + 1
                self.tracing_hits += 1
                return None
            self.programs[key] = 1
            tok = {"entry": entry, "sig": sig, "bucket": self._bucket,
                   "t0": time.monotonic(),
                   "compile_s0": self.backend_compile_s,
                   "phits0": self.persistent_hits,
                   "pmiss0": self.persistent_misses}
            self._live.append(tok)
        return tok

    def call_end(self, tok: Optional[Dict[str, Any]]) -> None:
        if tok is None:
            return
        with self._lock:
            if tok in self._live:
                self._live.remove(tok)
            hits = self.persistent_hits - tok["phits0"]
            misses = self.persistent_misses - tok["pmiss0"]
            self._row(entry=tok["entry"], sig=tok["sig"],
                      bucket=tok["bucket"], kind="retrace",
                      wall_ms=(time.monotonic() - tok["t0"]) * 1e3,
                      compile_ms=(self.backend_compile_s
                                  - tok["compile_s0"]) * 1e3,
                      persistent_cache=(None if not (hits or misses)
                                        else "miss" if misses else "hit"))

    # -- the build listener (obs/trace.py _on_build) ---------------------
    def _on_backend_compile(self, duration: float,
                            compiled: bool = True) -> None:
        with self._lock:
            self.backend_compiles += 1
            self.backend_compile_s += duration
            persistent = None
            if _cache_dir is not None:
                persistent = "miss" if compiled else "hit"
                if compiled:
                    self.persistent_misses += 1
                else:
                    self.persistent_hits += 1
            if self._live:
                entry, sig = self._live[-1]["entry"], self._live[-1]["sig"]
                bucket = self._live[-1]["bucket"]
            else:
                entry, sig, bucket = _UNATTRIBUTED, "-", self._bucket
            ms = duration * 1e3
            key = (entry, sig)
            self._program_compile_ms[key] = \
                self._program_compile_ms.get(key, 0.0) + ms
            self._row(entry=entry, sig=sig, bucket=bucket,
                      kind="backend_compile", wall_ms=ms, compile_ms=ms,
                      persistent_cache=persistent)

    def _row(self, **kw) -> None:
        # the field set is LEDGER_ROW_FIELDS (obs/validate.py)
        kw["backend"] = self.backend()
        kw["wall_ms"] = round(kw["wall_ms"], 3)
        kw["compile_ms"] = round(kw["compile_ms"], 3)
        self.rows.append(kw)

    # -- census ----------------------------------------------------------
    def census(self) -> Dict[str, Any]:
        """Programs per entry point, hit rates, the build windows and the
        top compile offenders, under the reference's keys."""
        with self._lock:
            by_entry: Dict[str, Dict[str, Any]] = {}
            for (entry, _sig), n in self.programs.items():
                e = by_entry.setdefault(
                    entry, {"programs": 0, "calls": 0, "compile_ms": 0.0})
                e["programs"] += 1
                e["calls"] += n
            for (entry, _sig), ms in self._program_compile_ms.items():
                e = by_entry.setdefault(
                    entry, {"programs": 0, "calls": 0, "compile_ms": 0.0})
                e["compile_ms"] = round(e["compile_ms"] + ms, 3)
            top = sorted(self._program_compile_ms.items(),
                         key=lambda kv: -kv[1])[:10]
            p_total = self.persistent_hits + self.persistent_misses
            return {
                "backend": self.backend(),
                "n_programs": len(self.programs),
                "n_entries": len({e for e, _ in self.programs}),
                "calls": self.calls,
                "tracing_hits": self.tracing_hits,
                "tracing_misses": self.calls - self.tracing_hits,
                "tracing_hit_rate": (round(self.tracing_hits / self.calls,
                                           4) if self.calls else None),
                "backend_compiles": self.backend_compiles,
                "backend_compile_s": round(self.backend_compile_s, 3),
                "persistent_hits": self.persistent_hits,
                "persistent_misses": self.persistent_misses,
                "persistent_hit_rate": (round(self.persistent_hits
                                              / p_total, 4)
                                        if p_total else None),
                "by_entry": by_entry,
                "top": [[e, s, round(ms, 3)] for (e, s), ms in top],
            }

    def to_metrics(self, census: Optional[Dict[str, Any]] = None) -> None:
        """The census headline as the declared ``compile_*`` / ``cache_*``
        gauges (idempotent)."""
        from proovread_tpu_torch.obs import metrics
        if census is None:
            census = self.census()
        g = metrics.gauge
        g("compile_programs", unit="programs").set(census["n_programs"])
        g("compile_backend_compiles", unit="compiles").set(
            census["backend_compiles"])
        g("compile_backend_s", unit="s").set(census["backend_compile_s"])
        g("compile_retraces", unit="traces").set(census["tracing_misses"])
        g("cache_tracing_hit_rate", unit="frac").set(
            census["tracing_hit_rate"] or 0.0)
        g("cache_persistent_hit_rate", unit="frac").set(
            census["persistent_hit_rate"] or 0.0)

    # -- serialization ---------------------------------------------------
    def write_jsonl(self, path: str,
                    census: Optional[Dict[str, Any]] = None) -> None:
        """The ``--compile-ledger`` artifact: one meta line (schema and
        census), then one row per event."""
        if census is None:
            census = self.census()
        with self._lock:
            rows = list(self.rows)
        with open(path, "w") as fh:
            fh.write(json.dumps({"ledger_schema": LEDGER_SCHEMA_VERSION,
                                 "backend": self.backend(),
                                 "n_rows": len(rows),
                                 "census": census}) + "\n")
            for r in rows:
                fh.write(json.dumps(r) + "\n")

    def report_lines(self,
                     census: Optional[Dict[str, Any]] = None) -> List[str]:
        c = census if census is not None else self.census()
        thr = (f"{c['tracing_hit_rate']:.1%}"
               if c["tracing_hit_rate"] is not None else "n/a")
        phr = (f"{c['persistent_hit_rate']:.1%}"
               if c["persistent_hit_rate"] is not None else "off")
        lines = [
            f"compile: {c['n_programs']} program(s) across "
            f"{c['n_entries']} entry point(s), "
            f"{c['backend_compiles']} kernel-library build(s) / "
            f"{c['backend_compile_s']:.3f}s",
            f"compile: first-call hit rate {thr} "
            f"({c['tracing_hits']}/{c['calls']} calls), "
            f"library cache hit rate {phr} "
            f"({c['persistent_hits']} hit / "
            f"{c['persistent_misses']} miss)",
        ]
        for entry, sig, ms in c["top"][:5]:
            lines.append(f"compile: top offender {entry} sig={sig} "
                         f"{ms / 1e3:.3f}s")
        return lines


# -- installation (as obs.metrics / obs.qc) ---------------------------------

_current: Optional[Ledger] = None


def current() -> Optional[Ledger]:
    return _current


def install(ledger: Optional[Ledger] = None) -> Ledger:
    global _current
    _current = ledger if ledger is not None else Ledger()
    obs_trace.set_ledger_compile_listener(_dispatch_backend_compile)
    obs_trace.install_build_hook()
    return _current


def uninstall() -> None:
    global _current
    _current = None
    obs_trace.set_ledger_compile_listener(None)


def _dispatch_backend_compile(duration: float, compiled: bool) -> None:
    led = _current
    if led is not None:
        led._on_backend_compile(duration, compiled)


@contextmanager
def scope(ledger: Optional[Ledger] = None):
    """Scoped installation (tests, smokes); reuses an installed ledger
    when none is given, as ``obs.metrics.scope`` does."""
    global _current
    if ledger is None and _current is not None:
        yield _current
        return
    prev = _current
    led = install(ledger)
    try:
        yield led
    finally:
        _current = prev
        obs_trace.set_ledger_compile_listener(
            _dispatch_backend_compile if prev is not None else None)


def set_bucket(bucket: Optional[int]) -> None:
    """Driver hook: label later rows with the live length bucket (one
    module-global read when the ledger is off)."""
    led = _current
    if led is not None:
        led.set_bucket(bucket)


# -- the compile cache --------------------------------------------------------

def enable_persistent_cache(cache_dir: Optional[str] = None) -> str:
    """Build the kernel library into, and load it from, ``cache_dir``
    (``None`` or ``"auto"``: ``kernels.default_build_dir()``); the ledger
    then marks each build window a hit or a miss. Returns the
    directory."""
    global _cache_dir
    from proovread_tpu_torch import kernels
    if cache_dir in (None, "auto"):
        cache_dir = kernels.default_build_dir()
    kernels.set_build_dir(cache_dir)
    _cache_dir = str(cache_dir)
    return _cache_dir


def cache_state() -> tuple:
    """What :func:`restore_cache` puts back: the build directory set and
    the cache directory."""
    from proovread_tpu_torch import kernels
    return kernels._build_dir_override, _cache_dir


def restore_cache(state: tuple) -> None:
    """Undo :func:`enable_persistent_cache` back to ``state`` (a caller
    that runs in a process it does not own, as the CLI's ``main`` may)."""
    global _cache_dir
    from proovread_tpu_torch import kernels
    kernels.set_build_dir(state[0])
    _cache_dir = state[1]
