"""Pileup accumulation: per-candidate votes -> per-read pileup tensors.

Port of ``proovread_tpu/ops/pileup_kernel.py``: each candidate's votes over
the 64 lanes of its ``n`` window columns are added into
``pileup[read_of, w0:w0+n, :]``, from

- ``pileup_accumulate_bits``: two i32 bit planes per column (+1 votes);
- ``pileup_accumulate_packed``: one packed i32 vote word per column (+1
  votes; the reference's f32 path for ``2*max_coverage+2 > 256``);
- ``pileup_accumulate``: dense f32 vote slabs (qual-weighted votes).

The buffer is f32 ``[B, Lp + 2n, PACK_LANES]`` and is updated IN PLACE (the
JAX buffer is aliased in and out). Unweighted votes add +1 to integer counts
far below 2^24, so any order of adds gives the same bits. Weighted votes are
fractional: the reference folds each cell over the candidates in index
order, and so does the port. The TPU's bf16 128-lane buffer, its VMEM budget
split and the windowed fallback only laid data out; what the port holds
equal is ``unpack_pileup``'s result.

Each wrapper runs the plain PyTorch version for CPU tensors and the CUDA
kernel (``csrc/pileup.cu``) for CUDA tensors.
"""

from __future__ import annotations

import torch

from proovread_tpu_torch import kernels
from proovread_tpu_torch.ops.votes import INS_CAP, PACK_LANES


def _check_common(pileup, R, read_of, w0, others):
    req = kernels.require
    req(pileup.dim() == 3 and pileup.shape[2] == PACK_LANES
        and pileup.dtype == torch.float32 and pileup.is_contiguous(),
        "pileup: buffer must be contiguous f32 [B, L, 64] (updated in place)")
    for name, t in (("read_of", read_of), ("w0", w0)):
        req(t.dtype == torch.int32 and t.shape == (R,),
            f"pileup: {name} must be int32 [{R}]")
    req(all(t.device == pileup.device for t in (read_of, w0, *others)),
        "pileup: tensors on mixed devices")


def _check(pileup, bits0, bits1, read_of, w0):
    B, Lpile, P = pileup.shape
    R, n = bits0.shape
    kernels.require(bits0.dtype == torch.int32 and bits1.dtype == torch.int32
                    and bits1.shape == (R, n),
                    "pileup: bit planes must be int32 [R, n]")
    _check_common(pileup, R, read_of, w0, (bits0, bits1))
    return B, Lpile, R, n


def pileup_accumulate_bits(pileup, bits0, bits1, read_of, w0):
    """Add each candidate's votes into ``pileup`` (in place) and return it.

    pileup: f32 [B, Lp + 2n, 64]; bits0/bits1: i32 [R, n] vote lanes 0-31 /
    32-63; read_of: i32 [R] target read; w0: i32 [R] window offset in the
    padded buffer, in [0, Lp + n]. Rows of dead candidates must be zero.

    Raises ValueError where ``read_of`` or ``w0`` is out of range. On the
    card that check runs in the kernel's own launch, so the buffer then
    already holds the votes of the valid candidates and must be thrown
    away."""
    _check(pileup, bits0, bits1, read_of, w0)
    if pileup.device.type == "cpu":
        return pileup_accumulate_bits_plain(pileup, bits0, bits1, read_of, w0)
    if pileup.device.type != "cuda":
        raise ValueError(f"pileup_accumulate_bits: device {pileup.device}")
    return _pileup_cuda(pileup, bits0, bits1, read_of, w0)


pileup_accumulate_bits.launches = 0


def _raise_flags(what: str, flags: int, B: int, Lpile: int, n: int):
    """Raise for a kernel's metadata flag word (0: nothing to raise)."""
    kernels.require(flags == 0, f"{what}: " + ", ".join(
        msg for bit, msg in ((1, f"read_of outside [0, {B - 1}]"),
                             (2, f"w0 outside [0, {Lpile - n}]"),
                             (4, "read_of must be sorted ascending"))
        if flags & bit))


def _cols_cuda(fn, entry, pileup, cols, read_of, w0, n):
    """Launch a column kernel of ``csrc/pileup.cu`` (``entry``: the C entry
    point; ``cols``: its i32 [R, n] vote words) and count it on ``fn``: one
    thread per window column, the launch also checks ``read_of`` and
    ``w0`` into a flag word, read once after it (the only host sync). A
    candidate that fails the check writes nothing; the wrapper raises."""
    B, Lpile, _ = pileup.shape
    R = read_of.shape[0]
    if R == 0:
        return pileup
    cols = [t.contiguous() for t in cols]
    read_of, w0 = read_of.contiguous(), w0.contiguous()
    bad = torch.empty(1, dtype=torch.int32, device=pileup.device)
    rc = getattr(kernels.lib(), entry)(
        pileup.data_ptr(), B, Lpile, *(t.data_ptr() for t in cols),
        read_of.data_ptr(), w0.data_ptr(), R, n, bad.data_ptr(),
        kernels.stream_of(pileup))
    kernels.check(rc, fn.__name__)
    kernels.count_launch(fn)
    _raise_flags(fn.__name__, int(bad.item()), B, Lpile, n)
    return pileup


def _pileup_cuda(pileup, bits0, bits1, read_of, w0):
    _, _, _, n = _check(pileup, bits0, bits1, read_of, w0)
    return _cols_cuda(pileup_accumulate_bits, "pt_pileup_accumulate_bits",
                      pileup, (bits0, bits1), read_of, w0, n)


def decode_bits(bits0, bits1) -> torch.Tensor:
    """[R, n] bit planes -> f32 one-hot vote slab [R, n, 64]."""
    lane = torch.arange(32, device=bits0.device, dtype=torch.int32)
    v0 = (bits0[:, :, None] >> lane) & 1
    v1 = (bits1[:, :, None] >> lane) & 1
    return torch.cat([v0, v1], -1).to(torch.float32)


def pileup_accumulate_bits_plain(pileup, bits0, bits1, read_of, w0):
    """Plain PyTorch version: decode to a dense slab, then ``index_add_``."""
    B, Lpile, R, n = _check(pileup, bits0, bits1, read_of, w0)
    rows = (read_of.to(torch.int64)[:, None] * Lpile + w0.to(torch.int64)[:, None]
            + torch.arange(n, device=pileup.device)[None, :])
    pileup.view(B * Lpile, PACK_LANES).index_add_(
        0, rows.reshape(-1), decode_bits(bits0, bits1).reshape(-1, PACK_LANES))
    return pileup


def _rows(read_of, w0, Lpile: int, n: int) -> torch.Tensor:
    """[R, n] flat buffer row of each candidate's window columns."""
    return (read_of.to(torch.int64)[:, None] * Lpile
            + w0.to(torch.int64)[:, None]
            + torch.arange(n, device=read_of.device)[None, :])


# --------------------------------------------------------------------------
# packed vote words (f32 exact counts past 256 votes per lane)
# --------------------------------------------------------------------------

def _check_packed(pileup, words, read_of, w0):
    B, Lpile, _ = pileup.shape
    R, n = words.shape
    kernels.require(words.dtype == torch.int32,
                    "pileup_accumulate_packed: words must be int32 [R, n]")
    _check_common(pileup, R, read_of, w0, (words,))
    return B, Lpile, R, n


def pileup_accumulate_packed(pileup, words, read_of, w0):
    """Add each candidate's packed vote words into ``pileup`` (in place)
    and return it.

    pileup: f32 [B, Lp + 2n, 64]; words: i32 [R, n] (``ops/votes.py``
    word layout; all-zero words vote nothing); read_of: i32 [R] target read;
    w0: i32 [R] window offset in the padded buffer, in [0, Lp + n].

    Raises ValueError where ``read_of`` or ``w0`` is out of range. On the
    card that check runs in the kernel's own launch, so the buffer then
    already holds the votes of the valid candidates and must be thrown
    away."""
    _check_packed(pileup, words, read_of, w0)
    if pileup.device.type == "cpu":
        return pileup_accumulate_packed_plain(pileup, words, read_of, w0)
    if pileup.device.type != "cuda":
        raise ValueError(f"pileup_accumulate_packed: device {pileup.device}")
    return _packed_cuda(pileup, words, read_of, w0)


pileup_accumulate_packed.launches = 0


def _packed_cuda(pileup, words, read_of, w0):
    _, _, _, n = _check_packed(pileup, words, read_of, w0)
    return _cols_cuda(pileup_accumulate_packed, "pt_pileup_accumulate_packed",
                      pileup, (words,), read_of, w0, n)


def decode_words(words) -> torch.Tensor:
    """[R, n] packed vote words -> f32 one-hot vote slab [R, n, 64]: lane
    st-1 and, with the marker bit, 8+st-1 for a state field st > 0; lane
    16+len-1 for a length field len > 0; and, when len > 0, lane 24+5k+b
    for each inserted-base field b < 5."""
    w = words.to(torch.int64)[:, :, None]
    lanes = torch.arange(PACK_LANES, device=words.device)
    st_f = w & 7
    len_f = (w >> 4) & 7
    votes = (lanes == st_f - 1) & (st_f > 0)
    votes |= (lanes == 8 + st_f - 1) & (((w >> 3) & 1) > 0) & (st_f > 0)
    votes |= (lanes == 16 + len_f - 1) & (len_f > 0)
    for k in range(INS_CAP):
        b_f = (w >> (7 + 3 * k)) & 7                  # 5 = none
        votes |= (lanes == 24 + 5 * k + b_f) & (b_f < 5) & (len_f > 0)
    return votes.to(torch.float32)


def pileup_accumulate_packed_plain(pileup, words, read_of, w0):
    """Plain PyTorch version: decode to a dense slab, then ``index_add_``."""
    B, Lpile, R, n = _check_packed(pileup, words, read_of, w0)
    pileup.view(B * Lpile, PACK_LANES).index_add_(
        0, _rows(read_of, w0, Lpile, n).reshape(-1),
        decode_words(words).reshape(-1, PACK_LANES))
    return pileup


# --------------------------------------------------------------------------
# dense f32 vote slabs (qual-weighted votes), folded in candidate order
# --------------------------------------------------------------------------

def _check_dense(pileup, votes, read_of, w0):
    B, Lpile, _ = pileup.shape
    kernels.require(votes.dim() == 3 and votes.shape[2] == PACK_LANES
                    and votes.dtype == torch.float32,
                    "pileup_accumulate: votes must be f32 [R, n, 64]")
    R, n, _ = votes.shape
    _check_common(pileup, R, read_of, w0, (votes,))
    return B, Lpile, R, n


def pileup_accumulate(pileup, votes, read_of, w0):
    """Add each candidate's vote slab into its read's pileup rows (in
    place) and return it. Every cell is folded over the candidates in index
    order, as the reference's sequential grid does; ``read_of`` must be
    sorted ascending.

    pileup: f32 [B, Lp + 2n, 64]; votes: f32 [R, n, 64] (rows of dead
    candidates all zero); read_of, w0: i32 [R] as for the other wrappers."""
    _check_dense(pileup, votes, read_of, w0)
    if pileup.device.type == "cpu":
        return pileup_accumulate_plain(pileup, votes, read_of, w0)
    if pileup.device.type != "cuda":
        raise ValueError(f"pileup_accumulate: device {pileup.device}")
    return _dense_cuda(pileup, votes, read_of, w0)


pileup_accumulate.launches = 0


# columns of a read row that one block of the ordered kernel holds
# (csrc/pileup.cu)
DENSE_TILE = 128


def _dense_cuda(pileup, votes, read_of, w0):
    B, Lpile, R, n = _check_dense(pileup, votes, read_of, w0)
    if R == 0:
        return pileup
    votes, read_of, w0 = (t.contiguous() for t in (votes, read_of, w0))
    # the work list: one key per (candidate, tile its window overlaps),
    # sorted stably so each (read, tile) item keeps candidate order. The
    # same kernel checks read_of and w0 into one flag word: the only sync.
    K = (n + DENSE_TILE - 2) // DENSE_TILE + 1   # most tiles a window spans
    n_tiles = -(-Lpile // DENSE_TILE)
    keys = torch.empty(R * K, dtype=torch.int32, device=pileup.device)
    bad = torch.empty(1, dtype=torch.int32, device=pileup.device)
    stream = kernels.stream_of(pileup)
    lib = kernels.lib()
    kernels.check(lib.pt_pileup_work_keys(
        keys.data_ptr(), bad.data_ptr(), read_of.data_ptr(), w0.data_ptr(),
        R, K, n, n_tiles, B, Lpile, stream), "pileup_accumulate")
    _raise_flags("pileup_accumulate", int(bad.item()), B, Lpile, n)
    keys, order = torch.sort(keys, stable=True)
    rc = lib.pt_pileup_accumulate(
        pileup.data_ptr(), Lpile, n_tiles, votes.data_ptr(), w0.data_ptr(),
        keys.data_ptr(), order.data_ptr(), R * K, K, n, stream)
    kernels.check(rc, "pileup_accumulate")
    kernels.count_launch(pileup_accumulate)
    return pileup


def pileup_accumulate_plain(pileup, votes, read_of, w0):
    """Plain PyTorch version, folded in candidate order: round k adds the
    k-th candidate of every read with one ``index_add_`` over rows that are
    all distinct, so each cell gets its adds one at a time, in order."""
    B, Lpile, R, n = _check_dense(pileup, votes, read_of, w0)
    if R == 0:
        return pileup
    kernels.require(bool((read_of[1:] >= read_of[:-1]).all()),
                    "pileup_accumulate: read_of must be sorted ascending")
    first = torch.searchsorted(read_of, read_of, side="left")
    rank = torch.arange(R, device=read_of.device) - first
    rows = _rows(read_of, w0, Lpile, n)
    flat = pileup.view(B * Lpile, PACK_LANES)
    for k in range(int(rank.max()) + 1):
        sel = torch.nonzero(rank == k).flatten()
        flat.index_add_(0, rows[sel].reshape(-1),
                        votes[sel].reshape(-1, PACK_LANES))
    return pileup
