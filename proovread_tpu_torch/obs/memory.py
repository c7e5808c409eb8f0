"""Device-memory telemetry: span-boundary sampling and a leak check.

Port of ``proovread_tpu/obs/memory.py``. Two facilities, both opt-in:

- :class:`MemorySampler`, installed with the tracer (``--trace``). At
  every bucket/attempt/pass/task span exit it reads the bytes PyTorch's
  CUDA allocator holds in tensors (``torch.cuda.memory_allocated``, over
  every device) and ``torch.cuda.memory_stats`` of the current device. The
  sample lands in the span args (``live_bytes``,
  ``device_bytes_in_use``), rolls up into the enclosing spans'
  ``peak_live_bytes``, and feeds the ``peak_live_bytes`` /
  ``bucket_peak_live_bytes`` gauges. Without a card both read 0 and the
  stats are None, as the reference reads on a backend without memory
  stats.
- :class:`LeakCheck`: the CUDA tensors alive before a run, and those
  created since and still alive after it (``gc.get_objects()``). A
  pipeline that parks device tensors in module state grows its memory
  floor with every invocation.

Nothing here runs while no sampler is installed: the hook in
``Span.__exit__`` is one module-global read.
"""

from __future__ import annotations

import gc
import weakref
from typing import Any, Dict, List, Optional

from proovread_tpu_torch.obs import metrics as obs_metrics
from proovread_tpu_torch.obs import trace as obs_trace


def live_bytes() -> int:
    """Bytes held in CUDA tensors, over every device (0 without a
    card)."""
    import torch
    if not torch.cuda.is_available():
        return 0
    return sum(int(torch.cuda.memory_allocated(d))
               for d in range(torch.cuda.device_count()))


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit`` of a
    CUDA device (the current one by default), or None without a card."""
    import torch
    if not torch.cuda.is_available():
        return None
    st = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total), "bytes_free": int(free)}


class MemorySampler:
    """Span-boundary memory telemetry (installed via :func:`install`)."""

    def __init__(self):
        self.n_samples = 0
        self.peak_live = 0
        self.peak_device = 0

    def sample(self, span, tracer) -> None:
        """Called from ``Span.__exit__`` for coarse span categories."""
        lb = live_bytes()
        self.n_samples += 1
        self.peak_live = max(self.peak_live, lb)
        span.args["live_bytes"] = lb
        span.mem_peak = max(span.mem_peak, lb)
        ms = device_memory_stats()
        if ms:
            in_use = ms["bytes_in_use"]
            span.args["device_bytes_in_use"] = in_use
            self.peak_device = max(self.peak_device,
                                   ms["peak_bytes_in_use"])
        # roll the sample up into every open ancestor: the bucket span's
        # peak must cover its children's high-water marks
        for sp in tracer._stack:
            sp.mem_peak = max(sp.mem_peak, lb)
        reg = obs_metrics.current()
        if reg is not None:
            g = reg.gauge("peak_live_bytes", unit="bytes",
                          help="max sampled live CUDA tensor bytes")
            g.set(max(g.value(), lb))
            if span.cat == "bucket" and "bucket" in span.args:
                gb = reg.gauge("bucket_peak_live_bytes", unit="bytes",
                               help="per-bucket peak sampled live bytes")
                b = span.args["bucket"]
                gb.set(max(gb.value(bucket=b), span.mem_peak), bucket=b)


_current: Optional[MemorySampler] = None


def current() -> Optional[MemorySampler]:
    return _current


def install(sampler: Optional[MemorySampler] = None) -> MemorySampler:
    global _current
    _current = sampler if sampler is not None else MemorySampler()
    obs_trace.set_memory_sampler(_current)
    return _current


def uninstall() -> None:
    global _current
    _current = None
    obs_trace.set_memory_sampler(None)


# -- leak check -----------------------------------------------------------

def _cuda_tensors() -> List[Any]:
    import torch
    # type(), not isinstance(): the latter reads __class__, which some
    # deprecated module-level objects answer with a warning
    return [o for o in gc.get_objects()
            if issubclass(type(o), torch.Tensor) and o.is_cuda]


class LeakCheck:
    """CUDA tensor population diff around a run.

    >>> lc = LeakCheck()          # snapshot baseline
    >>> run()
    >>> rep = lc.report()         # what's still live that wasn't before
    """

    def __init__(self):
        # id -> weakref of the baseline tensor: a recycled address of a
        # freed baseline tensor must not hide a new one
        self._base: Dict[int, weakref.ref] = {
            id(t): weakref.ref(t) for t in _cuda_tensors()}

    def report(self, top: int = 5) -> Dict[str, Any]:
        """Collect garbage, then list the CUDA tensors alive now that were
        not alive at the baseline."""
        gc.collect()

        def _is_new(t) -> bool:
            ref = self._base.get(id(t))
            return ref is None or ref() is not t

        leaked = [t for t in _cuda_tensors() if _is_new(t)]
        nbytes = [t.element_size() * t.nelement() for t in leaked]
        examples = [f"{t.dtype}{list(t.shape)}={n}B" for n, t in
                    sorted(zip(nbytes, leaked), key=lambda x: -x[0])[:top]]
        return {"n_leaked": len(leaked), "leaked_bytes": sum(nbytes),
                "examples": examples}
