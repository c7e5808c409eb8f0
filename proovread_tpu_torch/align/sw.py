"""Affine-gap Smith-Waterman with clip penalties and traceback.

Port of ``proovread_tpu/align/sw.py:sw_batch``, the aligner of the host
mapper that siamaera runs on. The reference is XLA, not Pallas: a
``lax.scan`` over query rows (``_dp_one``) with an ``associative_scan``
running max inside each row for the deletion state, then a ``lax.scan`` of
m+n traceback steps over per-cell direction bits (``_traceback_one``).

``sw_batch`` runs the plain PyTorch version below for CPU tensors and the
CUDA kernel ``csrc/sw.cu`` for CUDA tensors. Both give the reference's bits
in f32, in the op order XLA's CPU backend compiles ``sw_batch`` to: the
deletion-extension test compares ``e_shift - e_del`` against
``hp_shift - (o_del + e_del)`` (XLA folds the two constant subtractions into
one), while ``e = (u_excl - o_del) - j_e`` keeps its two roundings.

Query rows past a candidate's length change no output (they are not end
cells and the walk starts at or above the last valid row), so both versions
stop the DP at row ``max(qlen, 1)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from proovread_tpu_torch import kernels
from proovread_tpu_torch.align.params import AlignParams

NEG = -1e9                      # exact in f32 (ulp 64)

# direction-bit layout (uint8 per DP cell)
#   bits 0-1: H' source: 0 = M starting the alignment, 1 = M continuing, 2 = F(ins)
#   bit 2:    H realized by E (deletion) rather than H'
#   bit 3:    E extends the previous deletion (vs opening from H')
#   bit 4:    F extends the previous insertion (vs opening from H)
_SRC_MASK = 3
_BIT_E = 4
_BIT_EEXT = 8
_BIT_FEXT = 16

# traceback modes
_FULL, _HPRIME, _EMODE, _FMODE, _DONE = 0, 1, 2, 3, 4

# emitted op codes == consensus.cigar codes
OP_M, OP_I, OP_D, OP_NONE = 0, 1, 2, 3

# columns a lane of the kernel holds (n = 32 * K)
KERNEL_LANE_COLS = (4, 8, 12, 16, 20, 24)


class SWResult(NamedTuple):
    score: torch.Tensor      # f32 [R]  raw local score (clip penalties undone)
    sel_score: torch.Tensor  # f32 [R]  clip-penalized selection score
    q_start: torch.Tensor    # i32 [R]  first aligned query base (head clip len)
    q_end: torch.Tensor      # i32 [R]  one past last aligned query base
    r_start: torch.Tensor    # i32 [R]  window-relative ref start
    r_end: torch.Tensor      # i32 [R]  one past last aligned ref pos
    ops_rev: torch.Tensor    # i8  [R, m+n] ops end->start, OP_NONE padded
    n_ops: torch.Tensor      # i32 [R]
    step_i: torch.Tensor     # i16 [R, m+n] DP row of each emitted op (1-based)
    step_j: torch.Tensor     # i16 [R, m+n] DP col of each emitted op (1-based)


def _sub_table(p: AlignParams) -> np.ndarray:
    """6x6 substitution scores over the code alphabet (N/GAP ambiguous)."""
    t = np.full((6, 6), -float(p.mismatch), np.float32)
    for b in range(4):
        t[b, b] = float(p.match)
    t[4, :] = t[:, 4] = -float(p.n_penalty)
    t[5, :] = t[:, 5] = -float(p.n_penalty)
    return t


def _check_args(q, r, qlen):
    req = kernels.require
    req(q.dim() == 2 and r.dim() == 2 and q.shape[0] == r.shape[0],
        f"sw_batch: q {tuple(q.shape)} and r {tuple(r.shape)} must be "
        "[R, m] and [R, n]")
    R, m = q.shape
    n = r.shape[1]
    req(q.dtype == torch.int8 and r.dtype == torch.int8,
        f"sw_batch: q/r must be int8, got {q.dtype}/{r.dtype}")
    req(qlen.dtype == torch.int32 and qlen.shape == (R,),
        f"sw_batch: qlen must be int32 [{R}]")
    req(m >= 1 and n >= 1 and m + n < 2 ** 15,
        f"sw_batch: m={m}, n={n} outside what int16 steps hold")
    req(r.device == q.device and qlen.device == q.device,
        "sw_batch: tensors on mixed devices")
    return R, m, n


def sw_batch(q, r, qlen, params: AlignParams) -> SWResult:
    """Align a batch of queries to ref windows.

    q: i8 [R, m] query codes (N-padded, codes 0-5); r: i8 [R, n] ref window
    codes; qlen: i32 [R]."""
    _check_args(q, r, qlen)
    if q.device.type == "cpu":
        return sw_batch_plain(q, r, qlen, params)
    if q.device.type != "cuda":
        raise ValueError(f"sw_batch: unsupported device {q.device}")
    return _sw_cuda(q, r, qlen, params)


sw_batch.launches = 0


def _sw_cuda(q, r, qlen, params: AlignParams) -> SWResult:
    R, m, n = _check_args(q, r, qlen)
    kernels.require(n % 32 == 0 and n // 32 in KERNEL_LANE_COLS,
                    f"sw_batch: window of {n} columns is not 32 x one of "
                    f"{KERNEL_LANE_COLS}")
    q, r, qlen = q.contiguous(), r.contiguous(), qlen.contiguous()
    dev = q.device
    f32 = torch.empty((2, R), dtype=torch.float32, device=dev)
    i32 = torch.empty((5, R), dtype=torch.int32, device=dev)
    ops_rev = torch.empty((R, m + n), dtype=torch.int8, device=dev)
    steps = torch.empty((2, R, m + n), dtype=torch.int16, device=dev)
    # five decision bit-planes of K = n/32 bits a lane a DP row, packed in
    # one record of 8 (5K <= 64) or 16 bytes, written once; the walk kernel
    # reads tiles of them
    rec = 8 if 5 * (n // 32) <= 64 else 16
    dirs = torch.empty(R * m * 32 * rec, dtype=torch.uint8, device=dev)
    p = params
    if R > 0:
        rc_ = kernels.lib().pt_sw_batch(
            q.data_ptr(), r.data_ptr(), qlen.data_ptr(), R, m, n,
            float(p.match), float(p.mismatch), float(p.n_penalty),
            float(p.o_del), float(p.e_del), float(p.o_ins), float(p.e_ins),
            float(p.clip), dirs.data_ptr(), f32.data_ptr(), i32.data_ptr(),
            ops_rev.data_ptr(), steps.data_ptr(), kernels.stream_of(q))
        kernels.check(rc_, "sw_batch")
        kernels.count_launch(sw_batch)
    return SWResult(score=f32[0], sel_score=f32[1], q_start=i32[0],
                    q_end=i32[1], r_start=i32[2], r_end=i32[3],
                    ops_rev=ops_rev, n_ops=i32[4], step_i=steps[0],
                    step_j=steps[1])


def sw_batch_plain(q, r, qlen, params: AlignParams) -> SWResult:
    """Plain PyTorch version of the kernel: the reference's row recurrence,
    vectorised over candidates and columns ([R, n] per query row), with a
    running first-index argmax for the end cell instead of the [R, m, n]
    score slab, then the walk vectorised over candidates."""
    R, m, n = _check_args(q, r, qlen)
    dev = q.device
    p = params
    f32 = torch.float32
    o_del, e_del = float(p.o_del), float(p.e_del)
    e_ins, clip = float(p.e_ins), float(p.clip)
    oe_ins, oe_del = float(p.o_ins + p.e_ins), float(p.o_del + p.e_del)
    sub = torch.as_tensor(_sub_table(p), device=dev)
    qi, ri = q.long(), r.long()
    ql = qlen.long()
    j_e = (torch.arange(n, dtype=f32, device=dev) + 1.0) * e_del
    neg_col = torch.full((R, 1), NEG, dtype=f32, device=dev)
    rows = int(ql.clamp(1, m).max()) if R else 1

    h_prev = torch.zeros((R, n), dtype=f32, device=dev)
    f_prev = torch.full((R, n), NEG, dtype=f32, device=dev)
    dirs = torch.empty((R, rows, n), dtype=torch.uint8, device=dev)
    best_sel = torch.full((R,), -float("inf"), dtype=f32, device=dev)
    best_h = torch.zeros(R, dtype=f32, device=dev)
    best_flat = torch.zeros(R, dtype=torch.int64, device=dev)
    for i in range(1, rows + 1):
        sub_row = sub[qi[:, i - 1:i], ri]                        # [R, n]
        start_prev = 0.0 if i == 1 else -clip
        diag_shift = torch.cat([neg_col, h_prev[:, :-1]], 1)
        diag_base = diag_shift.clamp_min(start_prev)
        is_start = diag_shift < start_prev
        f_open = (torch.full_like(h_prev, NEG) if i == 1
                  else h_prev - oe_ins)
        f_ext = f_prev - e_ins
        f_row = torch.maximum(f_open, f_ext)
        f_is_ext = f_ext > f_open
        m_row = diag_base + sub_row
        hp = torch.maximum(m_row, f_row)
        src = torch.where(f_row > m_row, 2, torch.where(is_start, 0, 1))
        u = torch.cummax(hp + j_e, dim=1).values
        u_excl = torch.cat([neg_col, u[:, :-1]], 1)
        e_row = (u_excl - o_del) - j_e
        hp_shift = torch.cat([neg_col, hp[:, :-1]], 1)
        e_shift = torch.cat([neg_col, e_row[:, :-1]], 1)
        e_is_ext = (e_shift - e_del) >= (hp_shift - oe_del)
        h_row = torch.maximum(hp, e_row)
        h_is_e = e_row > hp
        dirs[:, i - 1] = (src + _BIT_E * h_is_e + _BIT_EEXT * e_is_ext
                          + _BIT_FEXT * f_is_ext).to(torch.uint8)
        # end cell: the first row-major maximum of the clip-penalised score
        tail = torch.where(ql == i, 0.0, clip).to(f32)[:, None]
        sel = torch.where((ql >= i)[:, None], h_row - tail,
                          torch.tensor(NEG, dtype=f32, device=dev))
        rmax, rarg = sel.max(dim=1)
        better = rmax > best_sel
        best_sel = torch.where(better, rmax, best_sel)
        best_h = torch.where(better, h_row.gather(1, rarg[:, None])[:, 0],
                             best_h)
        best_flat = torch.where(better, (i - 1) * n + rarg, best_flat)
        h_prev, f_prev = h_row, f_row

    ei, ej = best_flat // n + 1, best_flat % n + 1
    steps = m + n
    ops = torch.full((R, steps), OP_NONE, dtype=torch.int8, device=dev)
    step_i = torch.zeros((R, steps), dtype=torch.int16, device=dev)
    step_j = torch.zeros((R, steps), dtype=torch.int16, device=dev)
    i, j = ei.clone(), ej.clone()
    mode = torch.full((R,), _FULL, dtype=torch.int64, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    ar = torch.arange(R, device=dev)
    for t in range(steps):
        if bool(done.all()):
            break
        b = dirs[ar, (i - 1).clamp(min=0), (j - 1).clamp(min=0)].long()
        src = b & _SRC_MASK
        mode = torch.where(mode == _FULL,
                           torch.where(b & _BIT_E != 0, _EMODE, _HPRIME), mode)
        mode = torch.where((mode == _HPRIME) & (src == 2), _FMODE, mode)
        op = torch.where(mode == _EMODE, OP_D,
                         torch.where(mode == _FMODE, OP_I, OP_M))
        ops[:, t] = torch.where(done, OP_NONE, op).to(torch.int8)
        step_i[:, t] = torch.where(done, 0, i).to(torch.int16)
        step_j[:, t] = torch.where(done, 0, j).to(torch.int16)
        ni = torch.where(mode == _EMODE, i, i - 1)
        nj = torch.where(mode == _FMODE, j, j - 1)
        nmode = torch.where(
            mode == _EMODE,
            torch.where(b & _BIT_EEXT != 0, _EMODE, _HPRIME),
            torch.where(mode == _FMODE,
                        torch.where(b & _BIT_FEXT != 0, _FMODE, _FULL),
                        torch.where(src == 0, _DONE, _FULL)))
        ndone = done | (nmode == _DONE) | (ni <= 0) | (nj <= 0)
        i = torch.where(done, i, ni)
        j = torch.where(done, j, nj)
        mode = torch.where(done, mode, nmode)
        done = ndone
    score = best_h + torch.where(i > 0, clip, 0.0).to(f32)
    i32 = torch.int32
    return SWResult(score=score, sel_score=best_sel, q_start=i.to(i32),
                    q_end=ei.to(i32), r_start=j.to(i32), r_end=ej.to(i32),
                    ops_rev=ops, n_ops=(ops != OP_NONE).sum(1).to(i32),
                    step_i=step_i, step_j=step_j)


def ops_to_cigar(ops_rev: np.ndarray, n_ops: int, q_start: int, q_end: int,
                 qlen: int):
    """Host: reversed op stream -> (ops, lens) arrays with soft clips.

    Returns arrays in consensus.cigar op codes (M=0 I=1 D=2 S=3)."""
    path = ops_rev[:n_ops][::-1]
    out_ops, out_lens = [], []
    if q_start > 0:
        out_ops.append(3)
        out_lens.append(int(q_start))
    if n_ops:
        change = np.flatnonzero(np.diff(path)) + 1
        bounds = np.concatenate([[0], change, [len(path)]])
        for a, b in zip(bounds[:-1], bounds[1:]):
            out_ops.append(int(path[a]))
            out_lens.append(int(b - a))
    tail = qlen - q_end
    if tail > 0:
        out_ops.append(3)
        out_lens.append(int(tail))
    return np.array(out_ops, np.uint8), np.array(out_lens, np.int32)
