"""Banded Smith-Waterman with in-kernel traceback, expanded per window column.

Port of ``proovread_tpu/align/bsw.py:bsw_expand_v2`` and ``bsw_expand`` (v1)
(the Pallas kernels ``_bsw_v2_kernel`` and ``_bsw_kernel`` over
``_bsw_core``). Per candidate: take the query row and the ``n = m + W``
reference window, run the banded affine-gap local DP over W band lanes (lane
w = ref column - query row), walk the optimal path back one query row per
step, and emit per window column the voted state, consuming query row,
insertion length and the packed inserted bases (3 bits per base, 20 bases
over two words).

v2 reads the strand-selected query row and the window of the padded
combined map word (code in bits 0-2, MCR-ignore flag in bit 3) by candidate
metadata, and gates ignored columns. v1 takes pre-gathered query and window
slabs and gates nothing; the qual-weighted pass masks ignored columns when
it builds votes.

Scoring, boundary and tie-break semantics are those of the reference,
bit for bit in f32: M wins score ties against F and E, deletion extension
wins ties against re-opening (the log-shift running max keeps the smaller
origin lane), insertion opening wins ties against extension, and end cells
resolve ties in row-major (i, j) order.

``bsw_expand_v2`` and ``bsw_expand`` run the plain PyTorch version for CPU
tensors and the CUDA kernel (``csrc/bsw.cu``) for CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from proovread_tpu_torch import kernels
from proovread_tpu_torch.align.params import AlignParams
from proovread_tpu_torch.obs.profile import attributed
from proovread_tpu_torch.ops.encode import GAP, N

NEG = -1e9                      # exact in f32 (ulp 64)
MAP_IGNORE_BIT = 8


class BswResult(NamedTuple):
    """Expanded alignments, candidate major (the JAX package's public
    layout)."""
    state: torch.Tensor    # i32 [R, n] voted state per window col (-1 = none)
    qrow: torch.Tensor     # i32 [R, n] 0-based query row consuming the col
    ins_len: torch.Tensor  # i32 [R, n] inserted bases attached after the col
    score: torch.Tensor    # f32 [R] raw local score (clip penalties undone)
    q_start: torch.Tensor  # i32 [R] first aligned query base
    q_end: torch.Tensor    # i32 [R] one past last aligned query base
    r_start: torch.Tensor  # i32 [R] window-relative ref start
    r_end: torch.Tensor    # i32 [R] one past last aligned window col
    valid: torch.Tensor    # bool [R]
    ins_b0: torch.Tensor   # i32 [R, n] inserted bases 0-9 packed 3b/base
    ins_b1: torch.Tensor   # i32 [R, n] inserted bases 10-19 packed 3b/base


def band_lanes(params: AlignParams) -> int:
    """Band width in lanes: 2x the configured bwa band, padded to 32."""
    w = 2 * params.band_width
    return max(32, ((w + 31) // 32) * 32)


def map_pad_width(n: int) -> int:
    """Left/right pad (columns) of the combined map array: >= n + 16 so a
    fully out-of-range window clamps into a pad region (all N, ignore bit
    clear), and a multiple of 32 so 16-aligned starts stay 16-aligned."""
    return -(-(n + 16) // 32) * 32


def build_map_pad(map_codes: torch.Tensor, ignore_cols, n: int
                  ) -> torch.Tensor:
    """[B, Lp] map codes (+ optional bool ignore mask) -> the padded
    combined-word array the windows are read from."""
    comb = map_codes.to(torch.int8)
    if ignore_cols is not None:
        comb = comb | torch.where(ignore_cols, MAP_IGNORE_BIT, 0).to(
            torch.int8)
    padw = map_pad_width(n)
    return torch.nn.functional.pad(comb, (padw, padw), value=N)


def window_starts(diag: torch.Tensor, W: int, Lp: int, n: int):
    """Per-candidate (win_start, padded-map w0) from the seeder diagonal:
    the 16-aligned band placement ``(diag - W//2) & ~15`` (floors for
    negative diagonals) and its clip into the padded map."""
    win_start = (diag - W // 2) & ~15
    padw = map_pad_width(n)
    limit = (Lp + 2 * padw - n) & ~15
    w0p = torch.clamp(win_start + padw, 0, limit)
    return win_start, w0p


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _check_args(q, rc, map_pad, qlen, sread, strand, lread, w0p, W):
    S, m = q.shape
    R = sread.shape[0]
    n = m + W
    req = kernels.require
    req(W <= 128, f"bsw_expand_v2: band of {W} lanes > 128")
    req(q.dtype == torch.int8 and rc.dtype == torch.int8,
        f"bsw_expand_v2: q/rc must be int8, got {q.dtype}/{rc.dtype}")
    req(rc.shape == (S, m), f"bsw_expand_v2: rc {tuple(rc.shape)} != {(S, m)}")
    req(map_pad.dtype == torch.int8 and map_pad.dim() == 2
        and map_pad.shape[1] >= n + 32,
        f"bsw_expand_v2: map_pad must be int8 [B, >= {n + 32}]")
    for name, t in (("qlen", qlen), ("sread", sread), ("strand", strand),
                    ("lread", lread), ("w0p", w0p)):
        req(t.dtype == torch.int32 and t.shape == (R,),
            f"bsw_expand_v2: {name} must be int32 [{R}]")
    req(all(t.device == q.device
            for t in (rc, map_pad, qlen, sread, strand, lread, w0p)),
        "bsw_expand_v2: tensors on mixed devices")
    return S, m, R, n


@attributed("bsw_expand_v2")
def bsw_expand_v2(q, rc, map_pad, qlen, sread, strand, lread, w0p,
                  params: AlignParams) -> BswResult:
    """Align + expand a candidate batch.

    q, rc:   i8 [S, m] forward / reverse-complemented query codes
    map_pad: i8 [B, Lp + 2*map_pad_width(n)] combined map words
    qlen, sread, strand, lread, w0p: i32 [R] per-candidate query length,
             query row, strand, long read and padded-map window start
    """
    W = band_lanes(params)
    _check_args(q, rc, map_pad, qlen, sread, strand, lread, w0p, W)
    if q.device.type == "cpu":
        return bsw_expand_v2_plain(q, rc, map_pad, qlen, sread, strand,
                                   lread, w0p, params)
    if q.device.type != "cuda":
        raise ValueError(f"bsw_expand_v2: unsupported device {q.device}")
    return _bsw_cuda(q, rc, map_pad, qlen, sread, strand, lread, w0p,
                     params)


bsw_expand_v2.launches = 0


def _bsw_cuda(q, rc, map_pad, qlen, sread, strand, lread, w0p,
              params: AlignParams) -> BswResult:
    W = band_lanes(params)
    S, m, R, n = _check_args(q, rc, map_pad, qlen, sread, strand, lread,
                             w0p, W)
    tensors = [t.contiguous() for t in (q, rc, map_pad, qlen, sread, strand,
                                        lread, w0p)]
    q, rc, map_pad, qlen, sread, strand, lread, w0p = tensors
    kernels.require_in_range(
        "bsw_expand_v2", (sread, 0, S - 1, "sread"),
        (lread, 0, map_pad.shape[0] - 1, "lread"),
        (w0p, 0, map_pad.shape[1] - n, "w0p"), (qlen, 0, m, "qlen"))
    outs, score, pos = _outputs(R, n, q.device)
    p = params
    if R > 0:
        rc_ = kernels.lib().pt_bsw_expand_v2(
            q.data_ptr(), rc.data_ptr(), S, m, map_pad.data_ptr(),
            map_pad.shape[1], qlen.data_ptr(), sread.data_ptr(),
            strand.data_ptr(), lread.data_ptr(), w0p.data_ptr(), R, W,
            *_scores(p),
            *[o.data_ptr() for o in outs], score.data_ptr(), pos.data_ptr(),
            kernels.stream_of(q))
        kernels.check(rc_, "bsw_expand_v2")
        kernels.count_launch(bsw_expand_v2)
    return _result(outs, score, pos)


def bsw_expand_v2_plain(q, rc, map_pad, qlen, sread, strand, lread, w0p,
                        params: AlignParams) -> BswResult:
    """Plain PyTorch version of the kernel: the same DP, vectorised over
    candidates ([R, W] per query row) instead of one block per candidate."""
    W = band_lanes(params)
    S, m, R, n = _check_args(q, rc, map_pad, qlen, sread, strand, lread,
                             w0p, W)
    dev = q.device
    sread_l = sread.long()
    qsel = torch.where((strand == 0)[:, None], q[sread_l], rc[sread_l])
    cols = w0p.long()[:, None] + torch.arange(n, device=dev)[None, :]
    win = map_pad[lread.long()[:, None], cols].to(torch.int32)   # [R, n]
    res = _plain_core(qsel.to(torch.int32), win, qlen, params)
    # MCR-ignore gating (bit 3 of the map word): votes and attached
    # insertion runs die, per-candidate stats stay untouched
    ign = (win >> 3) > 0
    return res._replace(state=torch.where(ign, -1, res.state),
                        ins_len=torch.where(ign, 0, res.ins_len))


def _check_v1(q, win, qlen, W):
    R, m = q.shape
    n = m + W
    req = kernels.require
    req(W <= 128, f"bsw_expand: band of {W} lanes > 128")
    req(q.dtype == torch.int8 and win.dtype == torch.int8,
        f"bsw_expand: q/win must be int8, got {q.dtype}/{win.dtype}")
    req(win.shape == (R, n), f"bsw_expand: win {tuple(win.shape)} != {(R, n)}")
    req(qlen.dtype == torch.int32 and qlen.shape == (R,),
        f"bsw_expand: qlen must be int32 [{R}]")
    req(win.device == q.device and qlen.device == q.device,
        "bsw_expand: tensors on mixed devices")
    return R, m, n


@attributed("bsw_expand")
def bsw_expand(q, win, qlen, params: AlignParams) -> BswResult:
    """Align + expand a candidate batch from pre-gathered slabs (v1).

    q: i8 [R, m] strand-oriented, N-padded query codes; win: i8 [R, n]
    reference window codes, n = m + band_lanes(params); qlen: i32 [R].
    R is a multiple of the reference's per-program candidate block."""
    W = band_lanes(params)
    R, m, _ = _check_v1(q, win, qlen, W)
    C = 128 if m <= 256 else 64    # the reference's candidates per program
    kernels.require(R % C == 0,
                    f"bsw_expand: {R} candidates not a multiple of {C}")
    if q.device.type == "cpu":
        return bsw_expand_plain(q, win, qlen, params)
    if q.device.type != "cuda":
        raise ValueError(f"bsw_expand: unsupported device {q.device}")
    return _bsw_v1_cuda(q, win, qlen, params)


bsw_expand.launches = 0


def _bsw_v1_cuda(q, win, qlen, params: AlignParams) -> BswResult:
    W = band_lanes(params)
    R, m, n = _check_v1(q, win, qlen, W)
    q, win, qlen = q.contiguous(), win.contiguous(), qlen.contiguous()
    kernels.require_in_range("bsw_expand", (qlen, 0, m, "qlen"))
    outs, score, pos = _outputs(R, n, q.device)
    p = params
    if R > 0:
        rc_ = kernels.lib().pt_bsw_expand_v1(
            q.data_ptr(), win.data_ptr(), m, qlen.data_ptr(), R, W,
            *_scores(p),
            *[o.data_ptr() for o in outs], score.data_ptr(), pos.data_ptr(),
            kernels.stream_of(q))
        kernels.check(rc_, "bsw_expand")
        kernels.count_launch(bsw_expand)
    return _result(outs, score, pos)


def bsw_expand_plain(q, win, qlen, params: AlignParams) -> BswResult:
    """Plain PyTorch version of the v1 kernel (no ignore gating)."""
    W = band_lanes(params)
    _check_v1(q, win, qlen, W)
    return _plain_core(q.to(torch.int32), win.to(torch.int32), qlen, params)


def _scores(p: AlignParams) -> list:
    """The eight scoring parameters the C entries take, as floats."""
    return [float(p.match), float(p.mismatch), float(p.n_penalty),
            float(p.o_del), float(p.e_del), float(p.o_ins), float(p.e_ins),
            float(p.clip)]


def _outputs(R: int, n: int, dev):
    """The kernel's outputs: five i32 [R, n] rows (state, qrow, ins_len,
    ins_b0, ins_b1) from one allocation, the score and the [5, R] per-
    candidate positions."""
    return (list(torch.empty((5, R, n), dtype=torch.int32, device=dev)),
            torch.empty(R, dtype=torch.float32, device=dev),
            torch.empty((5, R), dtype=torch.int32, device=dev))


def _result(outs, score, pos) -> BswResult:
    state, qrow, ins_len, b0, b1 = outs
    return BswResult(state=state, qrow=qrow, ins_len=ins_len, score=score,
                     q_start=pos[0], q_end=pos[1], r_start=pos[2],
                     r_end=pos[3], valid=pos[4] > 0, ins_b0=b0, ins_b1=b1)


def _plain_core(qi, win, qlen, params: AlignParams) -> BswResult:
    """The DP and traceback over i32 query rows [R, m] and windows [R, n]
    (the window code is bits 0-2)."""
    W = band_lanes(params)
    R, m = qi.shape
    n = m + W
    dev = qi.device
    f32, i32 = torch.float32, torch.int32
    p = params
    match, mismatch = float(p.match), float(p.mismatch)
    n_pen, clip = float(p.n_penalty), float(p.clip)
    o_del, e_del = float(p.o_del), float(p.e_del)
    oe_ins, e_ins = float(p.o_ins + p.e_ins), float(p.e_ins)
    qlen_ = qlen.to(i32)[:, None]

    iota = torch.arange(W, device=dev, dtype=i32)[None, :]     # [1, W]
    iota_f = iota.to(f32)
    iota_e = iota_f * e_del
    negc = torch.full((R, 1), NEG, dtype=f32, device=dev)

    h_prev = torch.zeros((R, W), dtype=f32, device=dev)
    f_prev = torch.full((R, W), NEG, dtype=f32, device=dev)
    best = torch.full((R, W), NEG, dtype=f32, device=dev)
    best_pay = torch.zeros((R, W), dtype=i32, device=dev)
    dirs = torch.empty((m, R, W), dtype=i32, device=dev)
    for r in range(m):
        qr = qi[:, r:r + 1]
        wslab = win[:, r:r + W] & 7
        ambig = (qr > 3) | (wslab > 3)
        sub = torch.where(ambig, -n_pen,
                          torch.where(wslab == qr, match, -mismatch)).to(f32)
        start = 0.0 if r == 0 else -clip
        diag_base = torch.clamp(h_prev, min=start)
        src0 = start > h_prev
        m_row = diag_base + sub
        h_up = torch.cat([h_prev[:, 1:], negc], 1)
        f_up = torch.cat([f_prev[:, 1:], negc], 1)
        if r == 0:
            f_open = torch.full_like(h_up, NEG)
        else:
            f_open = h_up - oe_ins
        f_ext = f_up - e_ins
        f_row = torch.maximum(f_open, f_ext)
        fext = f_ext > f_open
        hp = torch.maximum(m_row, f_row)
        src = torch.where(f_row > m_row, 2, torch.where(src0, 0, 1)).to(i32)
        u = hp + iota_e
        pay = iota.expand(R, W)
        s = 1
        while s < W:
            us = torch.cat([negc.expand(R, s), u[:, :-s]], 1)
            ps = torch.cat([torch.zeros((R, s), dtype=i32, device=dev),
                            pay[:, :-s]], 1)
            take = us >= u
            u = torch.where(take, us, u)
            pay = torch.where(take, ps, pay)
            s <<= 1
        u_excl = torch.cat([negc, u[:, :-1]], 1)
        pay_excl = torch.cat([torch.zeros((R, 1), dtype=i32, device=dev),
                              pay[:, :-1]], 1)
        e_row = (u_excl - o_del) - iota_e
        h_row = torch.maximum(hp, e_row)
        bit_e = e_row > hp
        dirs[r] = (src | torch.where(bit_e, 4, 0) | torch.where(fext, 8, 0)
                   | (pay_excl << 8))
        tailpen = torch.where(qlen_ - 1 == r, 0.0, clip).to(f32)
        sel = torch.where(qlen_ > r, h_row - tailpen, NEG).to(f32)
        better = sel > best
        best = torch.maximum(best, sel)
        best_pay = torch.where(better, (r << 7) | iota, best_pay)
        h_prev, f_prev = h_row, f_row

    m1 = best.max(1, keepdim=True).values
    pay_sel = torch.where(best == m1, best_pay, 1 << 30).min(1).values
    end_r = pay_sel >> 7
    end_w = pay_sel & 127
    m1 = m1[:, 0]
    qlen1 = qlen.to(i32)
    valid = (m1 > NEG / 2) & (qlen1 > 0)
    h_best = m1 + torch.where(end_r == qlen1 - 1, 0.0, clip).to(f32)

    state = torch.full((R, n), -1, dtype=i32, device=dev)
    qrow = torch.zeros((R, n), dtype=i32, device=dev)
    inslen = torch.zeros((R, n), dtype=i32, device=dev)
    b0 = torch.zeros((R, n), dtype=torch.int64, device=dev)
    b1 = torch.zeros((R, n), dtype=torch.int64, device=dev)
    cur_w = end_w.clone()
    mode = torch.zeros(R, dtype=i32, device=dev)
    done = torch.where(valid, 0, 1).to(i32)
    q_start = torch.zeros(R, dtype=i32, device=dev)
    r_start = torch.zeros(R, dtype=i32, device=dev)
    rows = torch.arange(R, device=dev)

    def extract(d, w):
        inb = (w >= 0) & (w < W)
        v = d[rows, w.clamp(0, W - 1).long()]
        return torch.where(inb, v, -1)

    iota1 = iota[0]
    for r in range(m - 1, -1, -1):
        active = (done == 0) & (r <= end_r)
        word = extract(dirs[r], cur_w)
        is_h = active & (mode == 0)
        dj = is_h & (((word >> 2) & 1) == 1)
        w_h = torch.where(dj, (word >> 8) & 0xFF, cur_w)
        word2 = torch.where(dj, extract(dirs[r], w_h), word)
        src = word2 & 3
        is_m = is_h & (src <= 1)
        is_i_open = is_h & (src == 2)
        is_i = is_i_open | (active & (mode == 1))
        fext = torch.where(is_i_open, (word2 >> 3) & 1, (word >> 3) & 1) == 1
        att_w = torch.where(is_i_open, w_h, cur_w)

        dmask = (dj[:, None] & (iota1[None, :] > w_h[:, None])
                 & (iota1[None, :] <= cur_w[:, None]))
        mhot = (iota1[None, :] == w_h[:, None]) & is_m[:, None]
        ihot = (iota1[None, :] == att_w[:, None]) & is_i[:, None]
        qbase = qi[:, r:r + 1]
        sl = slice(r, r + W)
        slab = torch.where(dmask, GAP, state[:, sl])
        state[:, sl] = torch.where(mhot, qbase, slab)
        qrow[:, sl] = torch.where(dmask | mhot, r, qrow[:, sl])
        inslen[:, sl] += ihot.to(i32)
        b0s, b1s = b0[:, sl], b1[:, sl]
        b1[:, sl] = torch.where(ihot, ((b1s << 3) | ((b0s >> 27) & 7))
                                & 0xFFFFFFFF, b1s)
        b0[:, sl] = torch.where(ihot, ((b0s << 3) | qbase) & 0xFFFFFFFF, b0s)

        started = is_m & ((src == 0) | (r == 0))
        q_start = torch.where(started, r, q_start)
        r_start = torch.where(started, r + w_h, r_start)
        done = torch.where(started, 1, done)
        mode = torch.where(is_m, 0, torch.where(
            is_i, torch.where(fext, 1, 0), mode)).to(i32)
        cur_w = torch.where(is_m & ~started, w_h,
                            torch.where(is_i, att_w + 1, cur_w))

    score = h_best + torch.where(q_start > 0, clip, 0.0).to(f32)
    return BswResult(
        state=state, qrow=qrow, ins_len=inslen,
        score=torch.where(valid, score, NEG).to(f32),
        q_start=q_start, q_end=(end_r + 1).to(i32), r_start=r_start.to(i32),
        r_end=(end_r + end_w + 1).to(i32), valid=valid,
        ins_b0=_wrap32(b0), ins_b1=_wrap32(b1))
