"""Typed metrics registry: counters, gauges, histograms (a copy of
``proovread_tpu/obs/metrics.py``, plus :func:`without_timings`; host code,
no device work).

Every KPI is a typed, labeled series with a unit, dumped as ONE JSON
object (``--metrics-out FILE``) and embedded in ``PipelineResult.metrics``.

Usage: instrumentation sites call the module-level helpers, which no-op
(shared :data:`NOOP` sink) while no registry is installed::

    from proovread_tpu_torch.obs import metrics
    metrics.counter("mask_shortcut_hits", unit="events").inc()

Labels are plain keyword strings; each distinct label set is its own
series. ``Pipeline.run`` opens a :func:`scope`, reusing the registry the
CLI installed for the whole run or a fresh one for programmatic callers,
so ``result.metrics`` is always populated.

Serialized shape (``schema`` guards readers)::

    {"schema": 1,
     "counters":   {name: {"unit": u, "help": h,
                           "series": [{"labels": {...}, "value": n}]}},
     "gauges":     {... same shape ...},
     "histograms": {name: {"unit": u, "help": h,
                           "series": [{"labels": {...}, "count": n,
                                       "sum": s, "min": a, "max": b}]}}}
"""

from __future__ import annotations

import json
import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

SCHEMA_VERSION = 1

# histograms of wall times: two runs of the same work agree on all else
TIMING_HISTOGRAMS = ("bucket_seconds",)


def _lkey(labels: Dict[str, Any]) -> Tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    kind = "metric"

    def __init__(self, name: str, unit: str, help: str):    # noqa: A002
        self.name = name
        self.unit = unit
        self.help = help
        self.series: Dict[Tuple, Any] = {}


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1, **labels) -> "Counter":
        k = _lkey(labels)
        self.series[k] = self.series.get(k, 0) + n
        return self

    def value(self, **labels) -> float:
        return self.series.get(_lkey(labels), 0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels) -> "Gauge":
        self.series[_lkey(labels)] = v
        return self

    def value(self, **labels) -> float:
        return self.series.get(_lkey(labels), 0)


class Histogram(_Metric):
    kind = "histogram"

    def observe(self, v: float, **labels) -> "Histogram":
        k = _lkey(labels)
        s = self.series.get(k)
        if s is None:
            s = self.series[k] = {"count": 0, "sum": 0.0,
                                  "min": None, "max": None}
        s["count"] += 1
        s["sum"] += v
        s["min"] = v if s["min"] is None else min(s["min"], v)
        s["max"] = v if s["max"] is None else max(s["max"], v)
        return self

    def value(self, **labels) -> Dict[str, Any]:
        return self.series.get(
            _lkey(labels), {"count": 0, "sum": 0.0, "min": None,
                            "max": None})


class _NoopMetric:
    """Shared sink returned by the module helpers when no registry is
    installed: observability off costs one ``is None`` check."""

    __slots__ = ()

    def inc(self, n: float = 1, **labels):
        return self

    def set(self, v: float, **labels):
        return self

    def observe(self, v: float, **labels):
        return self

    def value(self, **labels):
        return 0


NOOP = _NoopMetric()

_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, unit: str, help: str):    # noqa: A002
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, unit, help)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        else:
            # first registration with a unit/help wins; later bare calls
            # (hot paths skip the strings) must not erase them
            if unit and not m.unit:
                m.unit = unit
            if help and not m.help:
                m.help = help
        return m

    def counter(self, name: str, unit: str = "",
                help: str = "") -> Counter:                  # noqa: A002
        return self._get(Counter, name, unit, help)

    def gauge(self, name: str, unit: str = "",
              help: str = "") -> Gauge:                      # noqa: A002
        return self._get(Gauge, name, unit, help)

    def histogram(self, name: str, unit: str = "",
                  help: str = "") -> Histogram:              # noqa: A002
        return self._get(Histogram, name, unit, help)

    def snapshot(self) -> Dict[str, Any]:
        """Deep-copy the series state for rollback (a retried bucket must
        not double-count its KPIs)."""
        return {name: {k: (dict(v) if isinstance(v, dict) else v)
                       for k, v in m.series.items()}
                for name, m in self._metrics.items()}

    def restore(self, snap: Dict[str, Any]) -> None:
        """Roll series back to ``snap``. Metrics registered after the
        snapshot stay registered (catalog stability) with empty series."""
        for name, m in self._metrics.items():
            saved = snap.get(name)
            m.series = ({} if saved is None else
                        {k: (dict(v) if isinstance(v, dict) else v)
                         for k, v in saved.items()})

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"schema": SCHEMA_VERSION, "counters": {},
                               "gauges": {}, "histograms": {}}
        for m in self._metrics.values():
            series = []
            for k, v in sorted(m.series.items()):
                entry: Dict[str, Any] = {"labels": dict(k)}
                if m.kind == "histogram":
                    entry.update(v)
                else:
                    entry["value"] = v
                series.append(entry)
            out[m.kind + "s"][m.name] = {
                "unit": m.unit, "help": m.help, "series": series}
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.as_dict(), fh, indent=2, sort_keys=True)
            fh.write("\n")


def without_timings(dump: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of a serialized registry (:meth:`MetricsRegistry.as_dict`)
    with the values of its timing histograms blanked, their counts kept:
    what two runs of the same work must agree on."""
    m = json.loads(json.dumps(dump))
    for name in TIMING_HISTOGRAMS:
        for series in m["histograms"].get(name, {}).get("series", []):
            series.update(sum=None, min=None, max=None)
    return m


# Two-level installation: install() is process-global (a CLI installs
# once, every thread of the run sees it), scope() is thread-local, so
# concurrent runs in one process keep their own registries. A thread's
# scope shadows the global install for that thread only.
_installed: Optional[MetricsRegistry] = None
_tls = threading.local()


def current() -> Optional[MetricsRegistry]:
    reg = getattr(_tls, "reg", None)
    return reg if reg is not None else _installed


def install(reg: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    global _installed
    _installed = reg if reg is not None else MetricsRegistry()
    return _installed


def uninstall() -> None:
    global _installed
    _installed = None


@contextmanager
def scope(registry: Optional[MetricsRegistry] = None):
    """Yield the active registry, or install a fresh (or given) one for
    the block — in THIS thread only. ``Pipeline.run`` wraps itself in
    this so CLI-installed registries accumulate across stages while bare
    programmatic runs still get per-run metrics."""
    cur = current()
    if registry is None and cur is not None:
        yield cur
        return
    prev = getattr(_tls, "reg", None)
    _tls.reg = registry if registry is not None else MetricsRegistry()
    try:
        yield _tls.reg
    finally:
        _tls.reg = prev


def counter(name: str, unit: str = "", help: str = ""):      # noqa: A002
    reg = current()
    return reg.counter(name, unit, help) if reg is not None else NOOP


def gauge(name: str, unit: str = "", help: str = ""):        # noqa: A002
    reg = current()
    return reg.gauge(name, unit, help) if reg is not None else NOOP


def histogram(name: str, unit: str = "", help: str = ""):    # noqa: A002
    reg = current()
    return reg.histogram(name, unit, help) if reg is not None else NOOP
