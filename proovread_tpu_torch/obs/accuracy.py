"""Accuracy scoreboard: ground-truth identity scoring of a run.

Port of the scoring half of ``proovread_tpu/obs/accuracy.py``:

- **Identity for every read.** ``identity = LCS / max(len_read,
  len_truth)``, the LCS from the bit-parallel CIPR/Hyyro recurrence in
  ``O(n * ceil(m/64))`` word operations a pair. :func:`lcs_lengths` runs
  the CUDA kernel ``csrc/lcs.cu`` for CUDA tensors (a warp a pair, or a
  wavefront of a block's warps for a long truth; :func:`lcs_plan`) and
  its plain PyTorch version, a torch copy of the reference's lockstep
  ``_lcs_group``, for CPU tensors. Both give the reference's integers.
- **Residual error classes.** A banded unit-cost edit alignment with
  traceback classifies the remaining errors as sub/ins/del, and derives
  the *introduced* counts (per class ``max(0, after - before)``), on a
  deterministic sample of reads (``classify_cap``). Scored on the CPU it
  is the reference's host numpy (:func:`edit_alignment`); on a card every
  classified pair goes through the CUDA kernel ``csrc/edit.cu`` in one
  call (:func:`edit_alignments`, plain version
  :func:`edit_alignments_plain`), with the same integers.
- **Chimera correctness.** With junction coordinates in the truth sidecar,
  each read's detected breakpoints (the QC record's ``chimera``
  intervals) are matched against the truth within ``chimera_tol`` bp.

Scores merge into the per-read QC records (``accuracy`` field), the
``PipelineResult.qc`` aggregate and the ``accuracy_*`` gauges. Truth
comes as a sidecar JSONL written next to simulated FASTQs
(``io/simulate.py:write_truth_sidecar``), so a command-line run can be
scored with ``--truth``.

The **recorder** (:func:`record_workload`) runs a workload through the
port's command line as a subprocess, scored with ``--truth``, and turns
its QC artifact into one ``ACCURACY`` row, the reference's fields; the
row's ``backend`` is the subprocess's own (its compile ledger's census),
``"cuda"`` or ``"cpu"``. The **gate** (:func:`accuracy_check`) replays
``ACCURACY_*.json`` history as the reference's does: rows pool per
(config, backend, mesh_shards), so a row of the card (``cuda``) never
pools with the JAX package's (``tpu`` or ``cpu``), and the newest row of
each pool must clear the identity floor, show uplift (``identity_after
>= identity_before``) and stay within ``identity_drop`` of the
rolling-baseline median. A ``--device cpu`` row pools with the JAX
package's CPU rows, whose scores it equals.

CLI::

    python -m proovread_tpu_torch.obs.accuracy record --workloads 4 \\
        [--device cuda|cpu] [--out FILE]
    python -m proovread_tpu_torch.obs.accuracy check [ACCURACY_*.json ...]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from proovread_tpu_torch import kernels
from proovread_tpu_torch.obs.profile import attributed
# one rolling-median implementation for every history gate
from proovread_tpu_torch.obs.regress import (_median, history_paths,
                                             json_values)

SCHEMA_VERSION = 1

# truth-sidecar schema version (writer: io/simulate.py:write_truth_sidecar)
TRUTH_SCHEMA_VERSION = 1

# -- gate thresholds (the reference's) ------------------------------------
# corrected identity must clear this absolute floor
IDENTITY_FLOOR = 0.95
# ... and may drop at most this much below the rolling-baseline median
IDENTITY_DROP = 0.003
# introduced-error growth allowed over the baseline median: this fraction
# and this many absolute errors
INTRODUCED_GROWTH = 1.0
INTRODUCED_MIN_ABS = 10
# rolling baseline: median over up to this many prior rows
BASELINE_WINDOW = 3

# class-breakdown sample size (identity itself is never sampled)
CLASSIFY_CAP = 64
# classification cell budget a read: the banded traceback keeps its whole
# (rows x band-width) int32 matrix, so a read whose exact matrix would
# exceed this many cells is not classified (logged; classes stay None)
MAX_CLASSIFY_CELLS = 80_000_000
# detected-vs-truth chimera junction match tolerance (bp)
CHIMERA_TOL = 100

_W = 64
_BIG = 1 << 20

# csrc/lcs.cu: a pair takes K = ceil(k / (32 W)) warps of a block (its
# truth's k = ceil(len / 64) words), W = 1 word of V a lane when one warp
# holds the truth so, else 2 (a step costs each warp about the same issue
# slots at either W, so fewer warps are faster: PERF.md); a pair needing
# more than WAVE_MAX_WARPS warps runs one warp a pair from a global-memory
# scratch
WAVE_MAX_WARPS = 32


def _log(msg: str) -> None:
    print(f"[accuracy] {msg}", file=sys.stderr, flush=True)


def _liblog():
    return logging.getLogger("proovread_tpu_torch.obs.accuracy")


# --------------------------------------------------------------------------
# bit-parallel LCS
# --------------------------------------------------------------------------

def pack_pairs(pairs: Sequence[Tuple[np.ndarray, np.ndarray]], device
               ) -> Tuple[torch.Tensor, ...]:
    """``(read_codes, truth_codes)`` pairs -> (reads i8 flat, read offsets
    i64 [P+1], truths i8 flat, truth offsets i64 [P+1]) on ``device``."""
    out = []
    for side in (0, 1):
        seqs = [np.asarray(p[side], np.int8) for p in pairs]
        off = np.zeros(len(seqs) + 1, np.int64)
        off[1:] = np.cumsum([len(s) for s in seqs])
        flat = (np.concatenate(seqs) if seqs else np.zeros(0, np.int8))
        out += [torch.as_tensor(flat, device=device),
                torch.as_tensor(off, device=device)]
    return tuple(out)


def _check(text, text_off, pat, pat_off, what="lcs_lengths"):
    """Host copies of the offsets, after checking what the kernel
    dereferences."""
    req = kernels.require
    req(text.dtype == torch.int8 and pat.dtype == torch.int8
        and text.dim() == 1 and pat.dim() == 1,
        f"{what}: reads and truths must be flat int8")
    req(text_off.dtype == torch.int64 and pat_off.dtype == torch.int64
        and text_off.dim() == 1 and text_off.shape == pat_off.shape
        and text_off.numel() >= 1,
        f"{what}: offsets must be int64 [P+1], the same P for both")
    req(len({t.device for t in (text, text_off, pat, pat_off)}) == 1,
        f"{what}: tensors on mixed devices")
    to, po = text_off.cpu().numpy(), pat_off.cpu().numpy()
    for name, off, flat in (("read", to, text), ("truth", po, pat)):
        req(off[0] == 0 and off[-1] == flat.numel()
            and bool((np.diff(off) >= 0).all()),
            f"{what}: {name} offsets must rise from 0 to {flat.numel()}")
    return to, po


@attributed("lcs_lengths")
def lcs_lengths(text: torch.Tensor, text_off: torch.Tensor,
                pat: torch.Tensor, pat_off: torch.Tensor) -> torch.Tensor:
    """LCS length (int64 [P]) of each pair (read ``text[text_off[p]:
    text_off[p+1]]``, truth ``pat[pat_off[p]:pat_off[p+1]]``); codes
    outside A, C, G, T (0-3) never match. CPU tensors take the plain
    version, CUDA tensors the kernel ``csrc/lcs.cu``."""
    if text.device.type == "cpu":
        return lcs_lengths_plain(text, text_off, pat, pat_off)
    if text.device.type != "cuda":
        raise ValueError(f"lcs_lengths: unsupported device {text.device}")
    to, po = _check(text, text_off, pat, pat_off)
    return _lcs_cuda(text, text_off, pat, pat_off, to, po)


lcs_lengths.launches = 0


def lcs_plan(n: np.ndarray, m: np.ndarray,
             max_warps: Optional[int] = None) -> Dict[str, Any]:
    """How ``csrc/lcs.cu`` runs pairs of read lengths ``n`` and truth
    lengths ``m``: each pair with both sides non-empty takes K warps at W
    words a lane (W = 1 for a truth of at most 32 words, else 2), and its
    warps run ``ceil(n / 32) + K - 1`` tile steps. Pairs are packed whole,
    most tile steps first, into blocks of ``warps_per_block`` warps (the
    next power of two >= the largest K, at least 4), a block closed when
    the next pair does not fit (``slots``: pair * 64 + (W - 1) * 32 + warp
    of the pair, or -1; ``steps``: a block's tile steps, its first
    pair's). A pair needing more than ``max_warps``
    warps runs from the global scratch instead (``glob``: its pairs; ``gw``
    words a lane; ``gofs`` its scratch offsets)."""
    max_warps = WAVE_MAX_WARPS if max_warps is None else max_warps
    n, m = np.asarray(n, np.int64), np.asarray(m, np.int64)
    k = -(-m // _W)
    W = np.where(k <= 32, 1, 2)
    K = -(-k // (32 * W))
    live = (n > 0) & (m > 0)
    glob = np.flatnonzero(live & (K > max_warps))
    wave = np.flatnonzero(live & (K <= max_warps))
    steps = -(-n // 32) + K - 1
    kmax = int(K[wave].max()) if len(wave) else 1
    C = max(4, 1 << (kmax - 1).bit_length())
    order = wave[np.argsort(-steps[wave], kind="stable")]
    slots, block_steps, used = [], [], C
    for p in order.tolist():
        kp = int(K[p])
        if used + kp > C:
            slots.append(np.full(C, -1, np.int32))
            block_steps.append(int(steps[p]))
            used = 0
        slots[-1][used:used + kp] = p * 64 + (W[p] - 1) * 32 + np.arange(kp)
        used += kp
    gw = -(-k[glob] // 32)
    size = 6 * 32 * gw
    return dict(
        slots=(np.concatenate(slots) if slots else np.zeros(0, np.int32)),
        steps=np.asarray(block_steps, np.int32), blocks=len(block_steps),
        warps_per_block=C, glob=glob.astype(np.int32),
        gw=gw.astype(np.int32),
        gofs=(np.cumsum(size) - size).astype(np.int64),
        scratch_words=int(size.sum()),
        longest_pair_warps=int(K[order[0]]) if len(order) else 0,
        words_a_lane=W, warps=K,
        pairs_by_warps={int(x): int(c) for x, c in zip(
            *np.unique(K[wave], return_counts=True))})


def _lcs_cuda(text, text_off, pat, pat_off, to, po) -> torch.Tensor:
    dev = text.device
    P = len(to) - 1
    plan = lcs_plan(np.diff(to), np.diff(po))
    out = torch.zeros(P, dtype=torch.int64, device=dev)
    scratch = torch.empty(max(plan["scratch_words"], 1), dtype=torch.int64,
                          device=dev)
    meta = [torch.as_tensor(plan[key], device=dev)
            for key in ("slots", "steps", "glob", "gw", "gofs")]
    text, text_off, pat, pat_off = (t.contiguous() for t in
                                    (text, text_off, pat, pat_off))
    if plan["blocks"] or len(plan["glob"]):
        rc = kernels.lib().pt_lcs_lengths(
            text.data_ptr(), text_off.data_ptr(), pat.data_ptr(),
            pat_off.data_ptr(), meta[0].data_ptr(), meta[1].data_ptr(),
            plan["blocks"], plan["warps_per_block"], meta[2].data_ptr(),
            meta[3].data_ptr(), meta[4].data_ptr(), scratch.data_ptr(),
            len(plan["glob"]), out.data_ptr(), kernels.stream_of(text))
        kernels.check(rc, "lcs_lengths")
        kernels.count_launch(lcs_lengths)
    return out


_MIN64 = -(1 << 63)
_POP8 = torch.tensor([bin(i).count("1") for i in range(256)],
                     dtype=torch.int64)


def _popcount_rows(v: torch.Tensor) -> torch.Tensor:
    """int64 [R, k] -> [R] set-bit counts."""
    b = v.contiguous().view(torch.uint8).to(torch.int64)
    return _POP8.to(v.device)[b].sum(dim=1)


def _mw_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Multiword addition over [R, k] int64 little-endian words (wrapping
    adds are the reference's uint64 ones): a Kogge-Stone scan resolves
    the carries, a word generating one when its sum overflows (unsigned
    compare: both sides with the sign bit flipped) and propagating one
    when its sum is all ones. The carry out of the top word is dropped."""
    s = x + y
    k = s.shape[1]
    if k == 1:
        return s
    g = (s ^ _MIN64) < (x ^ _MIN64)          # generate
    p = s == -1                              # propagate
    shift = 1
    while shift < k:
        g_hi = g[:, shift:] | (p[:, shift:] & g[:, :-shift])
        p_hi = p[:, shift:] & p[:, :-shift]
        g[:, shift:] = g_hi
        p[:, shift:] = p_hi
        shift *= 2
    carry_in = torch.zeros_like(s)
    carry_in[:, 1:] = g[:, :-1].to(torch.int64)
    return s + carry_in


def _padded(flat, off, idx, width: int) -> torch.Tensor:
    """Rows ``idx`` of a flat code array as int8 [R, width], padded with
    N (4); codes outside 0-3 become N too."""
    dev = flat.device
    start = off[idx]
    lens = off[idx + 1] - start
    pos = torch.arange(width, device=dev)
    valid = pos[None, :] < lens[:, None]
    if flat.numel() == 0:
        return torch.full((len(idx), width), 4, dtype=torch.int8,
                          device=dev)
    vals = flat[torch.where(valid, start[:, None] + pos[None, :], 0)]
    vals = torch.where((vals >= 0) & (vals < 4), vals, 4)
    return torch.where(valid, vals, 4).to(torch.int8)


def _lcs_group(txt: torch.Tensor, pat: torch.Tensor) -> torch.Tensor:
    """LCS length per row of (txt [R, n] codes, pat [R, 64k] codes), all
    rows advanced in lockstep by the CIPR recurrence
    ``V' = (V + (V & M)) | (V & ~M)``, V starting all ones: a pattern
    position's bit reaches 0 when it joins the LCS, so LCS = the count of
    zero bits. Pads and N never match (M bit 0) and the OR pins them at
    1."""
    R, n = txt.shape
    k = pat.shape[1] // _W
    dev = txt.device
    if R == 0 or k == 0 or n == 0:
        return torch.zeros(R, dtype=torch.int64, device=dev)
    shifts = torch.tensor([(1 << b) - (1 << 64 if b == 63 else 0)
                           for b in range(_W)], dtype=torch.int64,
                          device=dev)
    pm = torch.zeros((R, 5, k), dtype=torch.int64, device=dev)
    for c in range(4):                           # row 4 (N/pad) stays 0
        bits = (pat == c).view(R, k, _W).to(torch.int64)
        pm[:, c, :] = (bits * shifts).sum(dim=2)
    v = torch.full((R, k), -1, dtype=torch.int64, device=dev)
    ridx = torch.arange(R, device=dev)
    codes = txt.to(torch.int64)
    for j in range(n):
        m = pm[ridx, codes[:, j]]
        u = v & m
        v = _mw_add(v, u) | (v & ~m)
    return k * _W - _popcount_rows(v)


def lcs_lengths_plain(text, text_off, pat, pat_off,
                      group: int = 256) -> torch.Tensor:
    """The plain version of :func:`lcs_lengths`, on the tensors' device:
    pairs sorted by length and advanced a group at a time, as the
    reference's ``lcs_lengths`` does (a pair's result does not depend on
    its group)."""
    to, po = _check(text, text_off, pat, pat_off)
    dev = text.device
    P = len(to) - 1
    n, m = np.diff(to), np.diff(po)
    out = torch.zeros(P, dtype=torch.int64, device=dev)
    order = sorted(range(P), key=lambda i: (m[i], n[i]))
    for g0 in range(0, P, group):
        idx_h = np.asarray(order[g0:g0 + group], np.int64)
        idx = torch.as_tensor(idx_h, device=dev)
        k = -(-int(m[idx_h].max()) // _W)
        out[idx] = _lcs_group(
            _padded(text, text_off, idx, int(n[idx_h].max())),
            _padded(pat, pat_off, idx, k * _W))
    return out


def _lcs(pairs, device) -> np.ndarray:
    """LCS length of each ``(read_codes, truth_codes)`` pair, run on
    ``device``."""
    return lcs_lengths(*pack_pairs(pairs, device)).cpu().numpy()


# --------------------------------------------------------------------------
# banded unit-cost edit alignment with traceback (error-class breakdown)
# --------------------------------------------------------------------------

def _banded_tb(a: np.ndarray, b: np.ndarray, w: int) -> Dict[str, int]:
    """One banded pass, ``len(b) >= len(a)`` guaranteed by the caller.
    Rows are vectorized over the diagonal band; the within-row horizontal
    dependency (``dp[i][j-1] + 1``) closes via a min-plus prefix scan
    (``min_t C0[d-t] + t  =  d + cummin(C0[d'] - d')``). Cells off the
    truth (``j < 0`` or ``j > lb``) hold ``_BIG``; each row is computed
    in place in preallocated buffers, a few numpy calls a row, since the
    narrow bands of corrected reads are bound by call overhead."""
    la, lb = len(a), len(b)
    d = lb - la
    width = d + 2 * w + 1                       # diag idx j - i + w
    rows = np.empty((la + 1, width), np.int32)
    offs = np.arange(width, dtype=np.int32)
    j0 = offs - w
    rows[0] = np.where((j0 >= 0) & (j0 <= lb), j0, _BIG)
    # row i's truth bases b[j-1], j = i - w + offs, are bp[i:i + width];
    # the pad lies under cells that are _BIG either way (j < 1 has no
    # diagonal, j > lb is masked)
    bp = np.full(la + width + 1, 4, np.int8)
    bp[w + 1:w + 1 + lb] = b
    neq = np.empty(width, bool)
    diag = np.empty(width, np.int32)
    up = np.full(width, _BIG, np.int32)         # (i-1, j) lives at idx+1
    c0 = np.empty(width, np.int32)
    scan = np.empty(width, np.int32)
    for i in range(1, la + 1):
        prev, cur = rows[i - 1], rows[i]
        ai = a[i - 1]
        # N (code 4+) never matches, as in the LCS identity
        if ai >= 4:
            np.add(prev, 1, out=diag)
        else:
            np.not_equal(bp[i:i + width], ai, out=neq)
            np.add(prev, neq, out=diag)
        if i <= w:
            diag[:w + 1 - i] = _BIG             # j < 1: no diagonal
        np.add(prev[1:], 1, out=up[:-1])
        np.minimum(diag, up, out=c0)
        np.subtract(c0, offs, out=scan)
        np.minimum.accumulate(scan, out=scan)
        np.add(scan, offs, out=scan)
        np.minimum(c0, scan, out=cur)
        np.minimum(cur, _BIG, out=cur)
        if i < w:
            cur[:w - i] = _BIG                  # j < 0
        hi = lb - i + w + 1                     # j > lb from here
        if hi < width:
            cur[max(hi, 0):] = _BIG
    dist = int(rows[la, d + w])

    # traceback: count matches / substitutions / read-only bases (ins) /
    # truth-only bases (del) along one optimal path
    def cell(i: int, j: int) -> int:
        idx = j - i + w
        if idx < 0 or idx >= width:
            return _BIG
        return int(rows[i, idx])

    i, j = la, lb
    matches = sub = ins = dele = 0
    while i > 0 or j > 0:
        cur = cell(i, j)
        is_match = i > 0 and j > 0 and a[i - 1] == b[j - 1] \
            and a[i - 1] < 4
        if i > 0 and j > 0 and cell(i - 1, j - 1) + int(
                not is_match) == cur:
            if is_match:
                matches += 1
            else:
                sub += 1
            i -= 1
            j -= 1
        elif i > 0 and cell(i - 1, j) + 1 == cur:
            ins += 1
            i -= 1
        else:
            dele += 1
            j -= 1
    return {"dist": dist, "matches": matches, "sub": sub,
            "ins": ins, "del": dele}


def edit_alignment(a, b, band: Optional[int] = None) -> Dict[str, int]:
    """Exact unit-cost edit alignment of read ``a`` vs truth ``b`` with
    class counts from one optimal path: ``sub`` substitutions, ``ins``
    read bases absent from the truth, ``del`` truth bases absent from
    the read, plus ``matches`` and ``dist``. The band doubles until the
    Ukkonen condition ``dist <= band`` holds, so the result is optimal.
    N (code 4+) never matches: an N==N column counts as a substitution."""
    a = np.asarray(a, np.int8)
    b = np.asarray(b, np.int8)
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return {"dist": la + lb, "matches": 0, "sub": 0,
                "ins": la, "del": lb}
    swap = la > lb
    if swap:
        a, b, la, lb = b, a, lb, la
    w = max(int(band), 1) if band else 64
    while True:
        res = _banded_tb(a, b, w)
        if res["dist"] <= w or w >= la:
            break
        w *= 2
    if swap:
        res["ins"], res["del"] = res["del"], res["ins"]
    return res


def _edit_args(what, rd, rd_off, tr, tr_off, band):
    """Host offsets and :func:`edit_alignment`'s first band of each pair
    (the band asked for, at least 1; 64 where it is 0), after checking
    the tensors."""
    to, po = _check(rd, rd_off, tr, tr_off, what)
    band = np.asarray(band.cpu() if isinstance(band, torch.Tensor)
                      else band, np.int64).reshape(-1)
    kernels.require(len(band) == len(to) - 1,
                    f"{what}: one band a pair ({len(band)} for "
                    f"{len(to) - 1} pairs)")
    return to, po, np.where(band == 0, 64, np.maximum(band, 1))


@attributed("edit_alignments")
def edit_alignments(rd: torch.Tensor, rd_off: torch.Tensor,
                    tr: torch.Tensor, tr_off: torch.Tensor,
                    band) -> torch.Tensor:
    """:func:`edit_alignment` of every pair (read ``rd[rd_off[p]:
    rd_off[p+1]]``, truth ``tr[tr_off[p]:tr_off[p+1]]``, ``band[p]``):
    int64 [P, 5] of (dist, matches, sub, ins, del). CPU tensors take the
    plain version, CUDA tensors the kernel ``csrc/edit.cu`` (all pairs in
    one launch; pairs whose distance exceeds their band while the band is
    below the shorter length go again at twice the band)."""
    if rd.device.type == "cpu":
        return edit_alignments_plain(rd, rd_off, tr, tr_off, band)
    if rd.device.type != "cuda":
        raise ValueError(f"edit_alignments: unsupported device {rd.device}")
    return _edit_cuda(rd, rd_off, tr, tr_off,
                      *_edit_args("edit_alignments", rd, rd_off, tr, tr_off,
                                  band))


edit_alignments.launches = 0

# a block of csrc/edit.cu keeps its two DP rows and a state byte a cell
# in shared memory up to this many bytes (two blocks an SM); wider bands
# use a global scratch. A block has a thread a cell of the widest band row
# of the launch, at most EDIT_MAX_THREADS (a thread of a wider row takes
# several contiguous cells)
EDIT_SMEM_BYTES = 100 * 1024
EDIT_MAX_THREADS = 1024


def _edit_cuda(rd, rd_off, tr, tr_off, to, po, w) -> torch.Tensor:
    dev = rd.device
    P = len(to) - 1
    la, lb = np.diff(to), np.diff(po)
    short, d = np.minimum(la, lb), np.abs(la - lb)
    out = torch.zeros((P, 5), dtype=torch.int64, device=dev)
    rd, rd_off, tr, tr_off = (t.contiguous() for t in
                              (rd, rd_off, tr, tr_off))
    todo = np.arange(P)
    while len(todo):
        width = d[todo] + 2 * w[todo] + 1
        live = short[todo] > 0
        bits = np.where(live, 2 * short[todo] * -(-width // 32), 0)
        dp = 2 * width + -(-width // 4)         # csrc/edit.cu dp_words
        smem = live & (dp * 4 <= EDIT_SMEM_BYTES)
        rows = np.where(live & ~smem, dp, 0)
        meta = {}
        for key, vals, fill in (("bits_off", np.cumsum(bits) - bits, 0),
                                ("rows_off", np.where(
                                    smem, -1, np.cumsum(rows) - rows), -1)):
            full = np.full(P, fill, np.int64)
            full[todo] = vals
            meta[key] = torch.as_tensor(full, device=dev)
        band = torch.as_tensor(w.astype(np.int32), device=dev)
        lst = torch.as_tensor(todo.astype(np.int32), device=dev)
        bits_t = torch.empty(max(int(bits.sum()), 1), dtype=torch.int32,
                             device=dev)
        rows_t = torch.empty(max(int(rows.sum()), 1), dtype=torch.int32,
                             device=dev)
        wmax = int(width[live].max()) if live.any() else 32
        threads = int(min(EDIT_MAX_THREADS, -(-wmax // 32) * 32))
        smem_width = int(width[smem].max()) if smem.any() else 0
        rc = kernels.lib().pt_edit_alignments(
            rd.data_ptr(), rd_off.data_ptr(), tr.data_ptr(),
            tr_off.data_ptr(), lst.data_ptr(), len(todo), band.data_ptr(),
            meta["bits_off"].data_ptr(), meta["rows_off"].data_ptr(),
            bits_t.data_ptr(), rows_t.data_ptr(), threads, smem_width,
            out.data_ptr(), kernels.stream_of(rd))
        kernels.check(rc, f"edit_alignments ({len(todo)} pairs, {threads} "
                          f"threads, rows of {smem_width} cells in shared "
                          "memory)")
        kernels.count_launch(edit_alignments)
        dist = out[:, 0].cpu().numpy()[todo]
        kernels.require(bool((dist >= 0).all()),
                        "edit_alignments: a walk left its band (kernel "
                        "fault)")
        grow = (dist > w[todo]) & (w[todo] < short[todo])
        todo = todo[grow]
        w = w.copy()
        w[todo] *= 2
    return out


def _banded_tb_plain(a: torch.Tensor, b: torch.Tensor, w: int
                     ) -> Tuple[int, int, int, int, int]:
    """:func:`_banded_tb` in PyTorch on the tensors' device (``len(b) >=
    len(a)``): the same rows, masks and scan (``torch.cummin``), then the
    same walk over the rows."""
    dev = a.device
    la, lb = len(a), len(b)
    d = lb - la
    width = d + 2 * w + 1
    rows = torch.empty((la + 1, width), dtype=torch.int32, device=dev)
    offs = torch.arange(width, dtype=torch.int32, device=dev)
    j0 = offs - w
    rows[0] = torch.where((j0 >= 0) & (j0 <= lb), j0, _BIG)
    bp = torch.full((la + width + 1,), 4, dtype=torch.int8, device=dev)
    bp[w + 1:w + 1 + lb] = b
    up = torch.full((width,), _BIG, dtype=torch.int32, device=dev)
    codes = a.tolist()
    for i in range(1, la + 1):
        prev, cur = rows[i - 1], rows[i]
        ai = codes[i - 1]
        if ai >= 4:
            diag = prev + 1
        else:
            diag = prev + (bp[i:i + width] != ai).to(torch.int32)
        if i <= w:
            diag[:w + 1 - i] = _BIG             # j < 1: no diagonal
        up[:-1] = prev[1:] + 1
        c0 = torch.minimum(diag, up)
        scan = torch.cummin(c0 - offs, 0).values + offs
        torch.minimum(torch.minimum(c0, scan), torch.full_like(c0, _BIG),
                      out=cur)
        if i < w:
            cur[:w - i] = _BIG                  # j < 0
        hi = lb - i + w + 1                     # j > lb from here
        if hi < width:
            cur[max(hi, 0):] = _BIG
    cells = rows.cpu().numpy()
    tcodes = b.tolist()
    dist = int(cells[la, d + w])

    def cell(i: int, j: int) -> int:
        idx = j - i + w
        if idx < 0 or idx >= width:
            return _BIG
        return int(cells[i, idx])

    i, j = la, lb
    matches = sub = ins = dele = 0
    while i > 0 or j > 0:
        cur_v = cell(i, j)
        is_match = i > 0 and j > 0 and codes[i - 1] == tcodes[j - 1] \
            and codes[i - 1] < 4
        if i > 0 and j > 0 and cell(i - 1, j - 1) + int(
                not is_match) == cur_v:
            if is_match:
                matches += 1
            else:
                sub += 1
            i -= 1
            j -= 1
        elif i > 0 and cell(i - 1, j) + 1 == cur_v:
            ins += 1
            i -= 1
        else:
            dele += 1
            j -= 1
    return dist, matches, sub, ins, dele


def edit_alignments_plain(rd, rd_off, tr, tr_off, band) -> torch.Tensor:
    """The plain version of :func:`edit_alignments`, on the tensors'
    device: :func:`edit_alignment` pair by pair (the swap, the empty
    sides, the band doubling) over :func:`_banded_tb_plain`."""
    to, po, first = _edit_args("edit_alignments", rd, rd_off, tr, tr_off,
                               band)
    out = torch.zeros((len(to) - 1, 5), dtype=torch.int64)
    for p in range(len(to) - 1):
        a, b = rd[to[p]:to[p + 1]], tr[po[p]:po[p + 1]]
        la, lb = len(a), len(b)
        if la == 0 or lb == 0:
            out[p] = torch.tensor([la + lb, 0, 0, la, lb])
            continue
        swap = la > lb
        if swap:
            a, b, la, lb = b, a, lb, la
        w = int(first[p])
        while True:
            res = list(_banded_tb_plain(a, b, w))
            if res[0] <= w or w >= la:
                break
            w *= 2
        if swap:
            res[3], res[4] = res[4], res[3]
        out[p] = torch.tensor(res)
    return out.to(rd.device)


def _edit(pairs, bands, device) -> List[Dict[str, int]]:
    """:func:`edit_alignments` of ``(read_codes, truth_codes)`` pairs at
    their bands, run on ``device``, as :func:`edit_alignment`'s dicts."""
    res = edit_alignments(*pack_pairs(pairs, device),
                          np.asarray(bands, np.int64)).cpu().tolist()
    return [dict(zip(("dist", "matches", "sub", "ins", "del"), r))
            for r in res]


# --------------------------------------------------------------------------
# scoring
# --------------------------------------------------------------------------

def _classes(eb: Dict[str, int], ea: Dict[str, int]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for k in ("sub", "ins", "del"):
        out[f"{k}_before"] = int(eb[k])
        out[f"{k}_after"] = int(ea[k])
        out[f"{k}_introduced"] = max(0, int(ea[k]) - int(eb[k]))
    return out


def score_read_sets(before: Dict[str, np.ndarray],
                    after: Dict[str, np.ndarray],
                    truth: Dict[str, np.ndarray], *,
                    classify_cap: Optional[int] = CLASSIFY_CAP,
                    seed: int = 7,
                    detected_chimera: Optional[Dict[str, list]] = None,
                    truth_breakpoints: Optional[Dict[str, list]] = None,
                    chimera_tol: int = CHIMERA_TOL,
                    device="cuda",
                    ) -> Tuple[Dict[str, Dict[str, Any]], Dict[str, Any]]:
    """Score every read present in all three maps (id -> int8 codes); the
    LCS of both read sets runs on ``device`` in one call.

    Returns ``(per_read, summary)``: one accuracy record per read in the
    QC ``accuracy``-field schema (identity for every read; class
    breakdown on a deterministic ``classify_cap`` sample, each sampled
    read also subject to the ``MAX_CLASSIFY_CELLS`` budget; chimera
    correctness when ``truth_breakpoints`` is given), plus the flat
    summary (mean identities, summed class counts)."""
    ids = [i for i in truth if i in before and i in after]
    per_read: Dict[str, Dict[str, Any]] = {}
    if ids:
        lcs = _lcs([(before[i], truth[i]) for i in ids]
                   + [(after[i], truth[i]) for i in ids], device)
        lcs_b, lcs_a = lcs[:len(ids)], lcs[len(ids):]
        for x, rid in enumerate(ids):
            tl = len(truth[rid])
            per_read[rid] = {
                "identity_before": round(
                    float(lcs_b[x]) / max(len(before[rid]), tl, 1), 6),
                "identity_after": round(
                    float(lcs_a[x]) / max(len(after[rid]), tl, 1), 6),
                "lcs_before": int(lcs_b[x]),
                "lcs_after": int(lcs_a[x]),
                "truth_len": int(tl),
                "classes": None,
                "chimera": None,
            }
        cl_ids = list(ids)
        if classify_cap is not None and len(cl_ids) > classify_cap:
            rng = np.random.default_rng(seed)
            pick = sorted(rng.choice(len(ids), classify_cap,
                                     replace=False))
            cl_ids = [ids[int(i)] for i in pick]
        lcs_by_id = {rid: (int(lcs_b[x]), int(lcs_a[x]))
                     for x, rid in enumerate(ids)}

        def _band_and_cells(read, tr, lcs):
            # exact band bound from the known LCS: unit-cost edit dist
            # <= indel-only dist = la + lb - 2*LCS, and a band >= dist is
            # optimal, so the matrix size is known before allocating
            la, lb = len(read), len(tr)
            w = max(la + lb - 2 * lcs + 8, 16)
            cells = (min(la, lb) + 1) * (abs(la - lb) + 2 * w + 1)
            return w, cells

        on_host = torch.device(device).type == "cpu"
        todo = []
        for rid in cl_ids:
            wb, cb = _band_and_cells(before[rid], truth[rid],
                                     lcs_by_id[rid][0])
            wa, ca = _band_and_cells(after[rid], truth[rid],
                                     lcs_by_id[rid][1])
            if max(cb, ca) > MAX_CLASSIFY_CELLS:
                _liblog().info(
                    "accuracy: read %s not classified — banded "
                    "traceback would need %d cells (> %d); identity "
                    "is still scored", rid, max(cb, ca),
                    MAX_CLASSIFY_CELLS)
                continue
            if on_host:
                per_read[rid]["classes"] = _classes(
                    edit_alignment(before[rid], truth[rid], band=wb),
                    edit_alignment(after[rid], truth[rid], band=wa))
            else:
                todo.append((rid, wb, wa))
        if todo:
            # the kernel: every classified pair, before and after, at once
            res = _edit([(before[r], truth[r]) for r, _, _ in todo]
                        + [(after[r], truth[r]) for r, _, _ in todo],
                        [wb for _, wb, _ in todo]
                        + [wa for _, _, wa in todo], device)
            for x, (rid, _, _) in enumerate(todo):
                per_read[rid]["classes"] = _classes(res[x],
                                                    res[len(todo) + x])
        if truth_breakpoints is not None:
            det = detected_chimera or {}
            for rid in ids:
                tbps = [int(t) for t in truth_breakpoints.get(rid, [])]
                dbps = [(int(fr), int(to)) for fr, to in det.get(rid, [])]
                matched = sum(
                    1 for t in tbps
                    if any(fr - chimera_tol <= t <= to + chimera_tol
                           for fr, to in dbps))
                per_read[rid]["chimera"] = {"truth": len(tbps),
                                            "detected": len(dbps),
                                            "matched": matched}
    return per_read, summarize(per_read)


def class_totals(classes: Sequence[Dict[str, int]], stage: str
                 ) -> Optional[Dict[str, int]]:
    """Summed sub/ins/del counts for one stage over per-read ``classes``
    dicts: the one implementation the flat summary and the QC aggregate
    (obs/qc.py) both build on."""
    if not classes:
        return None
    return {k: int(sum(c[f"{k}_{stage}"] for c in classes))
            for k in ("sub", "ins", "del")}


def chimera_totals(chims: Sequence[Dict[str, int]]
                   ) -> Optional[Dict[str, int]]:
    """Summed truth/detected/matched junction counts (shared with the QC
    aggregate, as :func:`class_totals` is)."""
    if not chims:
        return None
    return {k: int(sum(c[k] for c in chims))
            for k in ("truth", "detected", "matched")}


def summarize(per_read: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Flat summary over per-read accuracy records."""
    accs = list(per_read.values())
    if not accs:
        return {"n_scored": 0, "n_classified": 0,
                "identity_before": None, "identity_after": None,
                "identity_after_min": None, "errors_before": None,
                "errors_after": None, "introduced": None, "chimera": None}
    classes = [a["classes"] for a in accs if a["classes"] is not None]
    chim = [a["chimera"] for a in accs if a["chimera"] is not None]
    return {
        "n_scored": len(accs),
        "n_classified": len(classes),
        "identity_before": round(float(np.mean(
            [a["identity_before"] for a in accs])), 6),
        "identity_after": round(float(np.mean(
            [a["identity_after"] for a in accs])), 6),
        "identity_after_min": round(float(min(
            a["identity_after"] for a in accs)), 6),
        "errors_before": class_totals(classes, "before"),
        "errors_after": class_totals(classes, "after"),
        "introduced": class_totals(classes, "introduced"),
        "chimera": chimera_totals(chim),
    }


def apply_to_qc(recorder, longs, corrected, truth: Dict[str, np.ndarray],
                truth_breakpoints: Optional[Dict[str, list]] = None, *,
                classify_cap: Optional[int] = CLASSIFY_CAP,
                device="cuda") -> Dict[str, Any]:
    """Score a finished run and merge the verdicts into the QC recorder's
    per-read records (``accuracy`` field). ``longs`` are the input
    records (identity_before), ``corrected`` the untrimmed output records
    (identity_after); detected chimera junctions come from the recorder's
    own ``chimera`` breakpoints. The LCS runs on ``device``. Returns the
    flat summary."""
    from proovread_tpu_torch.ops.encode import encode_ascii
    before = {r.id: encode_ascii(r.seq) for r in longs if r.id in truth}
    after = {r.id: encode_ascii(r.seq) for r in corrected
             if r.id in truth}
    det = None
    if truth_breakpoints is not None:
        det = {rid: [(bp[0], bp[1]) for bp in rec["chimera"]]
               for rid, rec in recorder.records.items()}
    per_read, summary = score_read_sets(
        before, after, truth, classify_cap=classify_cap,
        detected_chimera=det, truth_breakpoints=truth_breakpoints,
        device=device)
    for rid, acc in per_read.items():
        recorder.record_accuracy(rid, acc)
    return summary


# --------------------------------------------------------------------------
# truth sidecar (reader; the writer lives with the simulators,
# io/simulate.py:write_truth_sidecar)
# --------------------------------------------------------------------------

def load_truth_sidecar(path: str) -> Tuple[Dict[str, np.ndarray],
                                           Dict[str, List[int]]]:
    """Read a truth-sidecar JSONL: ``(truth_map, breakpoint_map)`` with
    sequences encoded to int8 codes."""
    from proovread_tpu_torch.ops.encode import encode_ascii
    truth: Dict[str, np.ndarray] = {}
    bps: Dict[str, List[int]] = {}
    with open(path) as fh:
        meta = None
        for line in fh:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if meta is None:
                if obj.get("truth_schema") != TRUTH_SCHEMA_VERSION:
                    raise ValueError(
                        f"{path}: truth_schema != {TRUTH_SCHEMA_VERSION}")
                meta = obj
                continue
            truth[obj["id"]] = encode_ascii(obj["seq"])
            bps[obj["id"]] = [int(b) for b in obj.get("breakpoints", [])]
    if meta is None:
        raise ValueError(f"{path}: empty truth sidecar (no meta line)")
    return truth, bps


# --------------------------------------------------------------------------
# the gate over ACCURACY history (obs/regress.py conventions)
# --------------------------------------------------------------------------

def load_rows(paths: List[str]) -> List[Dict[str, Any]]:
    """ACCURACY history rows, oldest first (one JSON value or JSON lines
    a file)."""
    out: List[Dict[str, Any]] = []
    for path in paths:
        for obj in json_values(path, flatten=True):
            if isinstance(obj, dict) and obj.get("metric") == "accuracy":
                out.append({"source": path, "row": obj})
    return out


def _usable(entry: Dict[str, Any]) -> bool:
    return isinstance(entry["row"].get("identity_after"), (int, float))


def _pool_key(row: Dict[str, Any]):
    """Rows pool per (config, backend, mesh shape); a row without
    ``backend`` pools as ``"cpu"`` (the reference's default)."""
    return (str(row.get("config")), row.get("backend") or "cpu",
            int(row.get("mesh_shards") or 1))


def accuracy_check(entries: List[Dict[str, Any]],
                   identity_floor: float = IDENTITY_FLOOR,
                   identity_drop: float = IDENTITY_DROP,
                   introduced_growth: float = INTRODUCED_GROWTH,
                   introduced_min_abs: int = INTRODUCED_MIN_ABS,
                   window: int = BASELINE_WINDOW) -> Dict[str, Any]:
    """The gate, as data: every pool's newest row must clear the absolute
    identity floor, show uplift (identity_after >= identity_before) and
    stay within ``identity_drop`` of the rolling-baseline median;
    introduced-error growth past the threshold also trips. Verdict PASS /
    REGRESSION / NO-DATA; check statuses ok / regressed / skipped /
    missing."""
    checks: List[Dict[str, Any]] = []
    for e in entries:
        if not _usable(e):
            note = "row lacks identity_after"
            skipped = e["row"].get("accuracy_skipped")
            if skipped:
                note += f" (accuracy_skipped: {skipped})"
            checks.append({"check": "row", "status": "missing",
                           "source": e["source"], "note": note})
    usable = [e for e in entries if _usable(e)]
    if not usable:
        return {"schema": SCHEMA_VERSION, "verdict": "NO-DATA",
                "pools": [], "checks": checks}

    pools: Dict[Any, List[Dict[str, Any]]] = {}
    for e in usable:
        pools.setdefault(_pool_key(e["row"]), []).append(e)

    pool_names = []
    for key in sorted(pools):
        group = pools[key]
        lrow = group[-1]["row"]
        name = f"config{key[0]}/{key[1]}" + (
            f"/mesh{key[2]}" if key[2] != 1 else "")
        pool_names.append(name)
        lid_a = float(lrow["identity_after"])
        checks.append({
            "check": f"{name}:identity_floor",
            "status": "regressed" if lid_a < identity_floor else "ok",
            "value": round(lid_a, 4), "threshold": identity_floor})
        lid_b = lrow.get("identity_before")
        if isinstance(lid_b, (int, float)):
            checks.append({
                "check": f"{name}:identity_uplift",
                "status": "regressed" if lid_a < float(lid_b) else "ok",
                "value": round(lid_a, 4),
                "baseline": round(float(lid_b), 4),
                "note": "correction must never lower identity"})
        else:
            checks.append({"check": f"{name}:identity_uplift",
                           "status": "skipped",
                           "note": "row carries no identity_before"})
        base = group[:-1][-window:]
        if not base:
            checks.append({"check": f"{name}:baseline",
                           "status": "skipped",
                           "note": "no prior rows in this pool — "
                                   "nothing to regress against"})
            continue
        med = _median([float(e["row"]["identity_after"]) for e in base])
        checks.append({
            "check": f"{name}:identity_after",
            "status": ("regressed" if lid_a < med - identity_drop
                       else "ok"),
            "value": round(lid_a, 4), "baseline": round(med, 4),
            "threshold": identity_drop})
        intro = lrow.get("introduced")
        base_intros = [sum((e["row"].get("introduced") or {}).values())
                       for e in base
                       if isinstance(e["row"].get("introduced"), dict)]
        if isinstance(intro, dict) and base_intros:
            lat = sum(intro.values())
            bmed = _median([float(v) for v in base_intros])
            regressed = (lat > bmed * (1 + introduced_growth)
                         and lat - bmed >= introduced_min_abs)
            checks.append({
                "check": f"{name}:introduced_errors",
                "status": "regressed" if regressed else "ok",
                "value": lat, "baseline": round(bmed, 1),
                "threshold": introduced_growth})
        else:
            checks.append({"check": f"{name}:introduced_errors",
                           "status": "skipped",
                           "note": "class breakdown absent on latest "
                                   "and/or all baseline rows"})
    verdict = ("REGRESSION" if any(c["status"] == "regressed"
                                   for c in checks) else "PASS")
    return {"schema": SCHEMA_VERSION, "verdict": verdict,
            "pools": pool_names, "checks": checks}


# --------------------------------------------------------------------------
# recording: one ACCURACY row from one scored command-line subprocess
# --------------------------------------------------------------------------

# the dmesh workload's knobs (parallel/smoke.py's small-workload config),
# so the command line runs the mesh regime the drill runs
DMESH_CONFIG = {"batch-reads": 8, "device-chunk": 128,
                "host-chunk-rows": 512, "mesh-chunks-per-shard": 1,
                "seq-filter": {"--min-length": 150}}
DMESH_SHARDS = 4


def _workload(workload: str, cap_bases: Optional[int]):
    """(longs, shorts, truths, cap, mesh, config label, extra config) of
    an accuracy workload, simulated with numpy."""
    if workload in ("3", "4"):
        from proovread_tpu_torch.obs.census import (DEFAULT_CAPS,
                                                    build_workload)
        cfg_n = int(workload)
        cap = cap_bases if cap_bases is not None \
            else DEFAULT_CAPS.get(cfg_n)
        longs, srs, truths = build_workload(cfg_n, cap)
        return longs, srs, truths, cap, None, cfg_n, None
    if workload == "dmesh":
        from proovread_tpu_torch.io.simulate import \
            simulate_independent_segments
        from proovread_tpu_torch.parallel.smoke import (N_LONG, READ_LEN,
                                                        SEED, SR_PER)
        longs, srs, truths = simulate_independent_segments(
            seed=SEED, n_long=N_LONG, read_len=READ_LEN, sr_per=SR_PER,
            with_truth=True)
        return (longs, srs, truths, None, DMESH_SHARDS, "dmesh",
                DMESH_CONFIG)
    raise ValueError(f"accuracy record supports workloads 3, 4 and dmesh, "
                     f"not {workload!r}")


def record_workload(workload: str, *, cache_dir: Optional[str] = "auto",
                    cap_bases: Optional[int] = None,
                    run_timeout: float = 5400.0, device: str = "cuda",
                    ledger_out: Optional[str] = None) -> Dict[str, Any]:
    """One scored command-line subprocess run, one ACCURACY row.

    Workloads: ``3`` and ``4`` are the bench configs of
    ``obs/census.py:build_workload`` (config 3 under its pinned cap,
    ``DEFAULT_CAPS``); ``dmesh`` is the mesh drill's shard-exact workload
    through ``--mesh-shards 4``. This process only simulates the workload
    (numpy), writes the FASTQs and the truth sidecar and reads the QC
    artifact and compile ledger the subprocess leaves: it never touches
    the card, which the subprocess (``--device``) owns. The row's
    ``backend`` is the ledger census's. ``ledger_out`` keeps a copy of
    the run's compile ledger (its census counts each entry's calls)."""
    from proovread_tpu_torch.io.simulate import write_truth_sidecar
    from proovread_tpu_torch.obs.census import _write_fastq
    longs, srs, truths, cap, mesh, config_label, extra_cfg = _workload(
        workload, cap_bases)
    total_bases = sum(len(r) for r in longs)
    _log(f"workload {workload}: {len(longs)} reads / {total_bases} bases"
         + (f" (cap {cap})" if cap else "")
         + (f", mesh={mesh}" if mesh else ""))
    with tempfile.TemporaryDirectory(prefix="proovread_accuracy_") as tmp:
        lp = os.path.join(tmp, "long.fq")
        sp = os.path.join(tmp, "short.fq")
        tp = os.path.join(tmp, "truth.jsonl")
        qcp = os.path.join(tmp, "run.qc.jsonl")
        ledp = os.path.join(tmp, "run.ledger.jsonl")
        _write_fastq(lp, longs)
        _write_fastq(sp, srs)
        write_truth_sidecar(tp, longs, truths)
        cmd = [sys.executable, "-m", "proovread_tpu_torch",
               "-l", lp, "-s", sp, "-p", os.path.join(tmp, "out"),
               "-m", "sr-noccs", "--truth", tp, "--qc-out", qcp,
               "--compile-ledger", ledp, "--overwrite",
               "--device", device]
        if extra_cfg is not None:
            cfgp = os.path.join(tmp, "run.cfg")
            with open(cfgp, "w") as fh:
                json.dump(extra_cfg, fh)
            cmd += ["-c", cfgp]
        if mesh:
            cmd += ["--mesh-shards", str(mesh)]
        if cache_dir:
            cmd += (["--compile-cache"] if cache_dir == "auto"
                    else ["--compile-cache", cache_dir])
        _log(f"workload {workload}: scored command-line run")
        t0 = time.monotonic()
        proc = subprocess.run(cmd, cwd=os.getcwd(), timeout=run_timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"scored pipeline run exited {proc.returncode}: "
                f"{' '.join(cmd)}")
        wall = time.monotonic() - t0
        with open(qcp) as fh:
            meta = json.loads(fh.readline())
        with open(ledp) as fh:
            led_meta = json.loads(fh.readline())
        if ledger_out is not None:
            shutil.copyfile(ledp, ledger_out)
    backend = (led_meta.get("census") or {}).get("backend")
    if not backend:
        raise RuntimeError(f"workload {workload}: the run's compile ledger "
                           "names no backend")
    acc = (meta.get("aggregate") or {}).get("accuracy")
    if not acc:
        raise RuntimeError(
            f"workload {workload}: QC artifact carries no accuracy "
            "aggregate — was --truth dropped?")
    row = {
        "metric": "accuracy", "schema": SCHEMA_VERSION,
        "config": config_label, "backend": backend,
        "mesh_shards": mesh, "cap_bases": cap,
        "n_reads": len(longs), "total_bases": total_bases,
        "wall_s": round(wall, 2),
        "n_scored": acc["n_scored"],
        "n_classified": acc["n_classified"],
        "identity_before": acc["identity_before"]["mean"],
        "identity_after": acc["identity_after"]["mean"],
        "errors_before": acc["errors_before"],
        "errors_after": acc["errors_after"],
        "introduced": acc["introduced"],
        "chimera": acc["chimera"],
    }
    _log(f"workload {workload}: identity "
         f"{row['identity_before']} -> {row['identity_after']} "
         f"({row['n_scored']}/{row['n_reads']} reads scored, "
         f"{row['n_classified']} classified) in {row['wall_s']}s "
         f"on {backend}")
    return row


# -- CLI -------------------------------------------------------------------

def _resolve_paths(args_paths: List[str]) -> List[str]:
    """The files named, else ``ACCURACY_r<digits>*.json`` in order and every
    other ``ACCURACY_*.json`` after them."""
    return history_paths(args_paths, "ACCURACY", "r[0-9]*")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m proovread_tpu_torch.obs.accuracy",
        description="Ground-truth accuracy scoreboard: record scored "
                    "command-line runs as ACCURACY rows and gate the "
                    "history.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rec = sub.add_parser("record",
                         help="run and score workloads through the "
                              "command line (truth sidecar), one "
                              "ACCURACY row each")
    rec.add_argument("--workloads", default="3,4,dmesh",
                     help="comma-separated: 3 (the capped E.coli-class "
                          "slice), 4 (config 4), dmesh (a 4-rank mesh "
                          "run) (default: 3,4,dmesh)")
    rec.add_argument("--out", default=None, metavar="FILE",
                     help="append rows to this ACCURACY_*.json "
                          "(JSON lines); default: stdout only")
    rec.add_argument("--cache-dir", default="auto",
                     help="kernel-library cache of the runs (default: the "
                          "usual build directory; 'none' disables)")
    rec.add_argument("--cap-bases", type=int, default=None,
                     help="override config 3's pinned cap "
                          "(default: obs/census.py DEFAULT_CAPS)")
    rec.add_argument("--run-timeout", type=float, default=5400.0)
    rec.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="where the runs correct and score (default: "
                          "the card)")
    chk = sub.add_parser("check", help="gate: exit 1 on regression")
    chk.add_argument("files", nargs="*",
                     help="ACCURACY history files (default: "
                          "ACCURACY_*.json)")
    chk.add_argument("--identity-floor", type=float,
                     default=IDENTITY_FLOOR,
                     help=f"absolute identity_after floor "
                          f"(default {IDENTITY_FLOOR})")
    chk.add_argument("--identity-drop", type=float, default=IDENTITY_DROP,
                     help="allowed absolute identity_after drop vs the "
                          f"rolling baseline (default {IDENTITY_DROP})")
    chk.add_argument("--window", type=int, default=BASELINE_WINDOW)
    args = ap.parse_args(argv)

    if args.cmd == "record":
        cache = None if args.cache_dir == "none" else args.cache_dir
        rows = []
        for wl in (w.strip() for w in args.workloads.split(",") if w):
            row = record_workload(wl, cache_dir=cache,
                                  cap_bases=(args.cap_bases
                                             if wl == "3" else None),
                                  run_timeout=args.run_timeout,
                                  device=args.device)
            print(json.dumps(row))
            rows.append(row)
        if args.out and rows:
            with open(args.out, "a") as fh:
                for row in rows:
                    fh.write(json.dumps(row) + "\n")
            _log(f"{len(rows)} row(s) appended to {args.out}")
        return 0

    paths = _resolve_paths(args.files)
    if not paths:
        print("accuracy-check: no ACCURACY history files found",
              file=sys.stderr)
        return 0
    verdict = accuracy_check(load_rows(paths),
                             identity_floor=args.identity_floor,
                             identity_drop=args.identity_drop,
                             window=args.window)
    for c in verdict["checks"]:
        if c["status"] == "regressed":
            print(f"ACCURACY-REGRESSION: {c['check']} = {c.get('value')}"
                  + (f" vs baseline {c['baseline']}" if "baseline" in c
                     else "")
                  + (f" (threshold {c['threshold']})" if "threshold" in c
                     else ""), file=sys.stderr)
        elif c["status"] == "missing":
            print(f"accuracy-check: missing — {c.get('note', c)}",
                  file=sys.stderr)
    print(json.dumps(verdict, sort_keys=True))
    if verdict["verdict"] == "REGRESSION":
        return 1
    print(f"accuracy-check: {verdict['verdict']} "
          f"({len(verdict['pools'])} pool(s))", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
