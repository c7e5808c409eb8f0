"""Per-kernel cost attribution (port of ``proovread_tpu/obs/profile.py``).

Every kernel entry of the hot path, and the glue entries around them, is
wrapped with :func:`attributed` under the reference's names. While a
:class:`Profiler` is installed (``--trace``, ``--xprof``,
:func:`profiling`) each call:

- records its calls and its execute time: the wrapper synchronizes the
  call's CUDA devices before and after it (the reference's perturbation
  contract: timed runs stay unprofiled), less any kernel-library build
  window inside it (``compile_s``);
- applies the entry's **cost model**: operations, bytes and peak bytes.
  The reference asks XLA's ``cost_analysis`` of the compiled program;
  here each kernel entry has a model of the function it computes, the
  counts behind PERF.md's Bound column (``chip_smoke.py`` computes its
  bound from the same count functions). A model reads the call's shapes
  and, where the kernel's own loop bounds are lengths passed to it, those
  lengths (``qlen`` of bsw and sw, the reads' ``lengths`` of assemble,
  the pairs' offsets and bands of the LCS and the traceback), and the
  bit-plane pileup its set bits (each one vote): such models run on every
  call; the models of shapes alone are cached per (entry, signature).
  What only the data decide otherwise (the cells a pileup's votes touch,
  the packed and ordered pileups' votes, a scatter's kept entries and
  segments, the emitted columns of assemble, the matching bases of the
  LCS) is counted at an upper bound (the bit-plane pileup's cells at its
  votes, the rest from the shapes); ``chip_smoke.py`` passes those counts
  from the data and keeps its exact bounds. The peak is the bytes of the
  call's distinct argument and result tensors;
- attributes the operations, bytes and peak to every open span
  (``Tracer._on_cost``) and mirrors them into the metrics registry
  (``kernel_flops_total``, ``kernel_bytes_total``, ``kernel_peak_bytes``).

Glue entries (``fused_accumulate``, ``add_ref_votes``,
``call_consensus``, ``gather_and_align``, ``fused_pass``,
``fused_iterations``) are plain PyTorch: they count calls and time only,
and each signature without a model counts one ``cost_errors``, as the
reference counts an analysis that failed (never a fault).

**Zero overhead off**: with no profiler and no compile ledger installed
the wrapper costs two module-global reads.

**Roofline** (:func:`roofline_lines`): achieved operation and byte rates
per entry against :data:`DEVICE_PEAKS`, the rates of PERF.md's bound,
matched on ``torch.cuda.get_device_name()``; each model names its rate
class (f32 operations without FMA, INT32 operations, or bytes alone). A
run on the CPU prints the counts and rates without %-of-peak.
"""

from __future__ import annotations

import functools
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

from proovread_tpu_torch.obs import compilecache as obs_cc
from proovread_tpu_torch.obs import metrics as obs_metrics
from proovread_tpu_torch.obs import trace as obs_trace

# Per-card peaks, matched by substring against the card's name lowered:
# HBM bytes/s, f32 operations/s without FMA (128 lanes an SM x 132 SMs x
# the 1.98 GHz maximum SM clock) and INT32 operations/s (64 lanes an SM,
# the Hopper white paper); an H100 SXM at its 700 W limit
DEVICE_PEAKS: Dict[str, Dict[str, float]] = {
    "h100": {"bytes": 3.35e12, "f32": 33.45e12, "int32": 16.7e12},
}

# operations a cell or step of each recurrence (PERF.md section 6)
DP_OPS_A_CELL = 16          # bsw and sw: f32, no FMA
LCS_OPS_A_WORD_STEP = 6     # INT32 on 32-bit units
EDIT_OPS_A_CELL = 9         # INT32, the traceback's recurrence


def device_peaks(device_kind: Optional[str] = None
                 ) -> Optional[Dict[str, float]]:
    """The peaks of ``device_kind`` (default: card 0's name), or None when
    it is not in :data:`DEVICE_PEAKS` or there is no card."""
    if device_kind is None:
        import torch
        if not torch.cuda.is_available():
            return None
        device_kind = torch.cuda.get_device_name(0)
    dk = device_kind.lower()
    for key, peaks in DEVICE_PEAKS.items():
        if key in dk:
            return peaks
    return None


# -- count functions: (operations, bytes) of each kernel's function -------
# chip_smoke.py's bound column and the models below share them

def bsw_v2_counts(S: int, m: int, R: int, W: int, map_bytes: int,
                  rows: float) -> Tuple[float, float]:
    """bsw v2: both query slabs, the map words and five i32 a candidate
    read once; five i32 [R, m + W] rows, the score and five i32 a
    candidate written once; 16 f32 operations a banded cell over ``rows``
    DP rows (each query's length, at most m)."""
    n = m + W
    n_bytes = (2 * S * m + map_bytes + 5 * R * 4 + 5 * R * n * 4 + R * 4
               + 5 * R * 4)
    return float(rows) * W * DP_OPS_A_CELL, float(n_bytes)


def bsw_v1_counts(R: int, m: int, W: int,
                  rows: float) -> Tuple[float, float]:
    """bsw v1: the pre-gathered query and window slabs and the lengths in,
    v2's outputs out; the same operations."""
    n = m + W
    n_bytes = R * m + R * n + 4 * R + 5 * R * n * 4 + R * 4 + 5 * R * 4
    return float(rows) * W * DP_OPS_A_CELL, float(n_bytes)


def sw_counts(R: int, m: int, n: int, rows: float) -> Tuple[float, float]:
    """sw: queries, windows and lengths in; seven 4-byte results, the
    reversed ops and two i16 step rows a candidate out; 16 f32 operations
    a cell of ``rows`` full-width DP rows."""
    steps = m + n
    n_bytes = (R * m + R * n + 4 * R + 7 * 4 * R + R * steps
               + 2 * 2 * R * steps)
    return float(rows) * n * DP_OPS_A_CELL, float(n_bytes)


def pileup_counts(in_bytes: float, votes: float,
                  cells: float) -> Tuple[float, float]:
    """A pileup accumulated: its vote inputs read once, each touched cell
    read and written once (8 bytes), one f32 add a vote."""
    return float(votes), float(in_bytes) + 8.0 * cells


def assemble_counts(B: int, Lp: int, valid: float, emit: float,
                    n_ins: float) -> Tuple[float, float]:
    """assemble: the lengths, the emitted flag of each column below its
    read's length, base / ins_len / phred of each emitting column and its
    inserted bases in; 2 bytes a column over Lp and the lengths out."""
    return 0.0, float(4 * B + valid + 9.0 * emit + n_ins + 2.0 * B * Lp
                      + 4 * B)


def hcr_counts(B: int, L: int) -> Tuple[float, float]:
    """HCR: the qualities in, the mask out, the lengths and counts."""
    return 0.0, 2.0 * B * L + 8 * B


def lcs_counts(in_bytes: float, P: int,
               word_steps: float) -> Tuple[float, float]:
    """LCS: every base once, three 8-byte values a pair; 6 INT32
    operations a word-step (a read base against a 64-bit truth word)."""
    return LCS_OPS_A_WORD_STEP * float(word_steps), float(in_bytes) + 24 * P


def edit_counts(in_bytes: float, P: int, cells: float) -> Tuple[float, float]:
    """Traceback: every base once, the band and five outputs a pair; 9
    INT32 operations a banded cell."""
    return EDIT_OPS_A_CELL * float(cells), float(in_bytes) + 48 * P


def scatter_counts(M: int, kept: float, touched: float
                   ) -> Tuple[float, float]:
    """The ordered scatter: ``keep`` read once (a byte an entry), each kept
    entry's index (8) and weight (4), each touched cell read and written
    (8)."""
    return 0.0, float(M + kept * (8 + 4) + touched * 8)


# -- the models of the kernel entries (the wrapped calls' arguments) ------

def _rows(qlen, m: int, lo: int = 0) -> float:
    return float(qlen.clamp(lo, m).sum()) if qlen.numel() else 0.0


def _bsw_v2_model(q, rc, map_pad, qlen, sread, strand, lread, w0p, params):
    from proovread_tpu_torch.align.bsw import band_lanes
    S, m = q.shape
    return bsw_v2_counts(S, m, sread.shape[0], band_lanes(params),
                         map_pad.numel(), _rows(qlen, m))


def _bsw_v1_model(q, win, qlen, params):
    from proovread_tpu_torch.align.bsw import band_lanes
    R, m = q.shape
    return bsw_v1_counts(R, m, band_lanes(params), _rows(qlen, m))


def _sw_model(q, r, qlen, params):
    R, m = q.shape
    return sw_counts(R, m, r.shape[1], _rows(qlen, m, lo=1))


def _pileup_bound(pileup, in_bytes, votes):
    """A pileup's counts with its touched cells at their bound: at most a
    cell a vote, and at most the buffer."""
    B, Lpile, P = pileup.shape
    return pileup_counts(in_bytes, votes, min(votes, B * Lpile * P))


def _set_bits(t) -> float:
    """The set bits of an int32 tensor (a byte table, on its device)."""
    import torch
    table = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int64, device=t.device)
    return float(table[t.contiguous().view(torch.uint8).long()].sum())


def _pileup_bits_model(pileup, bits0, bits1, read_of, w0):
    # each set bit is one vote, and a vote adds to one cell: the votes
    # are exact and bound the cells touched
    R, n = bits0.shape
    votes = _set_bits(bits0) + _set_bits(bits1) if R else 0.0
    return _pileup_bound(pileup, 8.0 * R * n + 8 * R, votes)


def _pileup_packed_model(pileup, words, read_of, w0):
    R, n = words.shape
    return _pileup_bound(pileup, 4.0 * R * n + 8 * R, 64.0 * R * n)


def _pileup_dense_model(pileup, votes, read_of, w0):
    R, n, lanes = votes.shape
    B, Lpile, _ = pileup.shape
    return pileup_counts(4.0 * votes.numel() + 8 * R, float(votes.numel()),
                         min(R * n, B * Lpile) * lanes)


def _assemble_model(call, lengths, Lp):
    B, L = call.base.shape
    valid = float(lengths.clamp(0, L).sum()) if B else 0.0
    return assemble_counts(B, Lp, valid, valid, 6.0 * valid)


def _hcr_model(qual, lengths, pv):
    B, L = qual.shape
    return hcr_counts(B, L)


def _pair_lengths(a_off, b_off):
    import numpy as np
    return (np.diff(a_off.cpu().numpy()).astype(np.int64),
            np.diff(b_off.cpu().numpy()).astype(np.int64))


def _lcs_model(text, text_off, pat, pat_off):
    n, m = _pair_lengths(text_off, pat_off)
    steps = float((n * -(-m // 64)).sum())
    return lcs_counts(text.numel() + pat.numel(), len(n), steps)


def _edit_model(rd, rd_off, tr, tr_off, band):
    import numpy as np
    import torch
    la, lb = _pair_lengths(rd_off, tr_off)
    w = np.asarray(band.cpu() if isinstance(band, torch.Tensor) else band,
                   np.int64).reshape(-1)
    w = np.where(w == 0, 64, np.maximum(w, 1))
    cells = float((np.minimum(la, lb) * (np.abs(la - lb) + 2 * w + 1)).sum())
    return edit_counts(rd.numel() + tr.numel(), len(la), cells)


def _scatter_model(target, idx, w, keep):
    M = idx.numel()
    return scatter_counts(M, M, min(M, target.numel()))


# entry -> (model, rate class, whether it reads only shapes)
COST_MODELS: Dict[str, Tuple[Callable, str, bool]] = {
    "bsw_expand_v2": (_bsw_v2_model, "f32", False),
    "bsw_expand": (_bsw_v1_model, "f32", False),
    "sw_batch": (_sw_model, "f32", False),
    "pileup_accumulate_bits": (_pileup_bits_model, "f32", False),
    "pileup_accumulate_packed": (_pileup_packed_model, "f32", True),
    "pileup_accumulate": (_pileup_dense_model, "f32", True),
    "assemble_rows": (_assemble_model, "bytes", False),
    "hcr_mask_rows": (_hcr_model, "bytes", True),
    "lcs_lengths": (_lcs_model, "int32", False),
    "edit_alignments": (_edit_model, "int32", False),
    "scatter_add_ordered": (_scatter_model, "bytes", True),
}


def cost_of(name: str, args: tuple, kwargs: dict
            ) -> Optional[Dict[str, float]]:
    """The model of entry ``name`` on these arguments: {"flops",
    "bytes_accessed"} (flops: the operations, of the entry's rate class),
    or None for an entry without a model."""
    spec = COST_MODELS.get(name)
    if spec is None:
        return None
    ops, n_bytes = spec[0](*args, **kwargs)
    return {"flops": float(ops), "bytes_accessed": float(n_bytes)}


def _abstract(x):
    """A call argument reduced to what its cost depends on when the model
    reads shapes alone: tensors to (shape, dtype, device type)."""
    import dataclasses

    import torch
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), str(x.dtype), x.device.type)
    if isinstance(x, (tuple, list)):
        return tuple(_abstract(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _abstract(v)) for k, v in x.items()))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple(
            _abstract(getattr(x, f.name)) for f in dataclasses.fields(x)))
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return type(x).__name__


def _tensors(obj, out: list) -> list:
    import torch
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _tensors(v, out)
    return out


def _peak_bytes(*objs) -> float:
    """Bytes of the distinct storages of the tensors in ``objs``."""
    seen: Dict[Tuple[str, int], int] = {}
    for obj in objs:
        for t in _tensors(obj, []):
            st = t.untyped_storage()
            seen[(t.device.type, st.data_ptr())] = st.nbytes()
    return float(sum(seen.values()))


def _sync(obj) -> None:
    import torch
    for dev in {t.device for t in _tensors(obj, []) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class KernelRecord:
    """What one attributed entry point cost over a run."""

    __slots__ = ("name", "calls", "flops", "bytes_accessed", "peak_bytes",
                 "exec_s", "compile_s", "n_signatures", "cost_errors",
                 "launches", "launch_flops", "rate", "device")

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.flops = 0.0            # operations, of the model's rate class
        self.bytes_accessed = 0.0
        self.peak_bytes = 0.0       # the largest one call's
        self.exec_s = 0.0           # synchronized wall less build windows
        self.compile_s = 0.0        # build windows inside its calls
        self.n_signatures = 0
        self.cost_errors = 0        # signatures without a cost model
        self.launches = 0           # the wrapper's kernel launches
        self.launch_flops = 0.0     # operations of the calls that launched
        spec = COST_MODELS.get(name)
        self.rate = spec[1] if spec else None
        self.device = "cpu"         # "cuda" once a call ran on a card

    def as_dict(self) -> Dict[str, Any]:
        return {"calls": self.calls, "flops": self.flops,
                "bytes_accessed": self.bytes_accessed,
                "peak_bytes": self.peak_bytes,
                "exec_s": round(self.exec_s, 4),
                "compile_s": round(self.compile_s, 4),
                "n_signatures": self.n_signatures,
                "cost_errors": self.cost_errors,
                "launches": self.launches}


class Profiler:
    """Cost attribution collector for one run."""

    def __init__(self):
        self.records: Dict[str, KernelRecord] = {}
        self._sig_cost: Dict[Tuple[str, Any], Optional[Dict[str, float]]] \
            = {}
        self._seen_sigs: set = set()
        # build-window seconds seen while installed: each call's window
        # minus the builds inside it is its execute time
        self._compile_s_seen = 0.0

    def _on_backend_compile(self, duration: float) -> None:
        self._compile_s_seen += duration

    def _record(self, name: str) -> KernelRecord:
        rec = self.records.get(name)
        if rec is None:
            rec = self.records[name] = KernelRecord(name)
        return rec

    def call(self, name: str, fn, args: tuple, kwargs: dict,
             counter=None):
        """Run ``fn`` with attribution (the :func:`attributed` wrapper's
        path while a profiler is installed). ``counter`` is the object
        whose ``launches`` the wrapped kernel entry counts."""
        _sync((args, kwargs))
        l0 = getattr(counter, "launches", 0)
        c0 = self._compile_s_seen
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        _sync(out)
        dt = time.monotonic() - t0
        dc = min(self._compile_s_seen - c0, dt)
        launched = getattr(counter, "launches", 0) - l0
        rec = self._record(name)
        rec.calls += 1
        rec.compile_s += dc
        rec.exec_s += max(dt - dc, 0.0)
        rec.launches += launched
        if any(t.is_cuda for t in _tensors((args, kwargs), [])):
            rec.device = "cuda"
        cost = self._cost(rec, args, kwargs, out)
        if cost is None:
            return out
        rec.flops += cost["flops"]
        rec.bytes_accessed += cost["bytes_accessed"]
        rec.peak_bytes = max(rec.peak_bytes, cost["peak_bytes"])
        if launched:
            rec.launch_flops += cost["flops"]
        tr = obs_trace.current()
        if tr is not None:
            tr._on_cost(cost["flops"], cost["bytes_accessed"],
                        cost["peak_bytes"])
        reg = obs_metrics.current()
        if reg is not None:
            reg.counter("kernel_flops_total", unit="flops",
                        help="cost-model operations per profiled kernel "
                             "entry").inc(cost["flops"], fn=name)
            reg.counter("kernel_bytes_total", unit="bytes",
                        help="cost-model bytes per profiled kernel "
                             "entry").inc(cost["bytes_accessed"], fn=name)
            g = reg.gauge("kernel_peak_bytes", unit="bytes",
                          help="largest argument + result bytes of one "
                               "call per profiled kernel entry")
            g.set(max(g.value(fn=name), cost["peak_bytes"]), fn=name)
        return out

    def _cost(self, rec: KernelRecord, args, kwargs, out
              ) -> Optional[Dict[str, float]]:
        name = rec.name
        spec = COST_MODELS.get(name)
        sig = (name, _abstract((args, kwargs)))
        if sig not in self._seen_sigs:
            self._seen_sigs.add(sig)
            if spec is None:
                rec.cost_errors += 1
            else:
                rec.n_signatures += 1
        if spec is None:
            return None
        if spec[2] and sig in self._sig_cost:
            return self._sig_cost[sig]
        cost = cost_of(name, args, kwargs)
        cost["peak_bytes"] = _peak_bytes(args, kwargs, out)
        if spec[2]:
            self._sig_cost[sig] = cost
        return cost



def roofline_lines(profiler: Profiler,
                   device_kind: Optional[str] = None) -> List[str]:
    """Per-entry table: counts, measured time, achieved rates, and, for
    entries that ran on a card in :data:`DEVICE_PEAKS`, the share of its
    peak (operations at the model's rate class, bytes at HBM's)."""
    any_cuda = any(r.device == "cuda" for r in profiler.records.values())
    peaks = device_peaks(device_kind) if any_cuda or device_kind else None
    hdr = (f"{'kernel':<26}{'calls':>7}{'Gops':>10}{'GB':>9}"
           f"{'ops/B':>8}{'exec_s':>9}{'comp_s':>8}{'Gops/s':>10}"
           f"{'GB/s':>9}")
    if peaks:
        hdr += f"{'rate':>6}{'%peakOp':>9}{'%peakB':>8}"
    lines = [hdr]
    for name, rec in sorted(profiler.records.items(),
                            key=lambda kv: -kv[1].exec_s):
        ai = rec.flops / rec.bytes_accessed if rec.bytes_accessed else 0.0
        fs = rec.flops / rec.exec_s if rec.exec_s else 0.0
        bs = rec.bytes_accessed / rec.exec_s if rec.exec_s else 0.0
        ln = (f"{name:<26}{rec.calls:>7}{rec.flops / 1e9:>10.3f}"
              f"{rec.bytes_accessed / 1e9:>9.3f}{ai:>8.2f}"
              f"{rec.exec_s:>9.3f}{rec.compile_s:>8.3f}"
              f"{fs / 1e9:>10.2f}{bs / 1e9:>9.2f}")
        if peaks and rec.device == "cuda" and rec.rate is not None:
            op = (f"{100 * fs / peaks[rec.rate]:>9.3f}"
                  if rec.rate in peaks else f"{'-':>9}")
            ln += f"{rec.rate:>6}{op}{100 * bs / peaks['bytes']:>8.3f}"
        lines.append(ln)
    if not peaks:
        lines.append("(no card in DEVICE_PEAKS ran these calls: counts "
                     "and rates only, no %-of-peak)")
    return lines


# -- installation ---------------------------------------------------------

_current: Optional[Profiler] = None


def current() -> Optional[Profiler]:
    return _current


def install(profiler: Optional[Profiler] = None) -> Profiler:
    global _current
    _current = profiler if profiler is not None else Profiler()
    obs_trace.set_profile_active(True)
    obs_trace.set_profile_compile_listener(_current._on_backend_compile)
    obs_trace.install_build_hook()
    return _current


def uninstall() -> None:
    global _current
    _current = None
    obs_trace.set_profile_active(False)
    obs_trace.set_profile_compile_listener(None)


@contextmanager
def profiling(profiler: Optional[Profiler] = None):
    """Scoped profiler installation (tests, smokes)."""
    global _current
    prev = _current
    p = install(profiler)
    try:
        yield p
    finally:
        _current = prev
        obs_trace.set_profile_active(prev is not None)
        obs_trace.set_profile_compile_listener(
            prev._on_backend_compile if prev is not None else None)


def attributed(name: str):
    """Wrap an entry point for cost attribution and the compile ledger::

        @attributed("bsw_expand_v2")
        def bsw_expand_v2(...): ...

    Off (no profiler and no ledger) the wrapper costs two module-global
    reads. With a ledger each call reports its entry and the library's
    digest (``obs/compilecache.py``). The wrapper is what the module's
    name holds, so a kernel entry's ``launches`` count lives on it; the
    function it wraps stays reachable as ``__wrapped__``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            prof = _current
            led = obs_cc._current
            if prof is None and led is None:
                return fn(*args, **kwargs)
            tok = (led.call_begin(name, obs_cc.signature())
                   if led is not None else None)
            try:
                if prof is None:
                    return fn(*args, **kwargs)
                return prof.call(name, fn, args, kwargs, counter=wrapper)
            finally:
                if led is not None:
                    led.call_end(tok)
        return wrapper
    return deco
