"""Consensus assembly and HCR masking, per read.

Port of ``proovread_tpu/ops/assemble_kernel.py``: ``assemble_rows`` (the
Pallas ``_assemble_kernel``) and ``hcr_mask_rows`` (``_hcr_kernel``).

Assembly streams each read's emitted columns and their inserted bases out to
a cursor, truncated at Lp. The reference packs all fields of a column into
one i32 word first; the plain version does the same (``pack_columns``):

    bit 0      emitted
    bits 1-3   base code (0-4)
    bits 4-6   emitted insertion length (0-6)
    bits 7-12  phred (0-40)
    bits 13-30 six 3-bit inserted base codes

The CUDA kernels read the ``ConsensusCall`` fields themselves and apply the
packing's rules (valid columns, clamps) as they go, so the public call on
the card is two launches with no packing pass.

HCR masking is the SeqFilter ``--phred-mask`` interval machine: runs of phred
in [pmin, pmax] of at least ``mask_min_len``, merged across gaps shorter than
``unmask_min_len``, shrunk at their ends by ``mask_reduce`` (by
``round(mask_reduce * end_ratio)`` where they touch a read end). It returns
the mask and the masked fraction that drives the mask shortcut.

Each function runs its plain PyTorch version for CPU tensors and the CUDA
kernels (``csrc/assemble.cu``) for CUDA tensors.
"""

from __future__ import annotations

import torch

from proovread_tpu_torch import kernels
from proovread_tpu_torch.obs.profile import attributed
from proovread_tpu_torch.ops.votes import INS_CAP as INS_K


# --------------------------------------------------------------------------
# consensus assembly
# --------------------------------------------------------------------------

def pack_columns(call, lengths: torch.Tensor) -> torch.Tensor:
    """ConsensusCall -> one i32 word per source column (layout above)."""
    B, L = call.base.shape
    valid = (torch.arange(L, device=lengths.device)[None, :]
             < lengths[:, None])
    word = (valid & call.emitted).to(torch.int32)
    word |= torch.clamp(call.base.to(torch.int32), 0, 7) << 1
    word |= torch.clamp(call.ins_len.to(torch.int32), 0, INS_K) << 4
    word |= torch.clamp(call.phred.to(torch.int32), 0, 63) << 7
    ib = torch.clamp(call.ins_bases.to(torch.int32), 0, 7)
    for k in range(INS_K):
        word |= ib[:, :, k] << (13 + 3 * k)
    return word


@attributed("assemble_rows")
def assemble_rows(call, lengths: torch.Tensor, Lp: int):
    """(new codes i8 [B, Lp], new qual u8 [B, Lp], new lengths i32 [B]);
    output longer than Lp is truncated."""
    lengths = lengths.to(torch.int32)
    dev = call.base.device
    if dev.type == "cpu":
        return assemble_rows_plain(call, lengths, Lp)
    if dev.type != "cuda":
        raise ValueError(f"assemble_rows: device {dev}")
    return assemble_fields_cuda(call, lengths, Lp)


assemble_rows.launches = 0


def _check_words(word, lengths):
    B, L = word.shape
    kernels.require(word.dtype == torch.int32, "assemble: word must be int32")
    kernels.require(lengths.dtype == torch.int32 and lengths.shape == (B,)
                    and lengths.device == word.device,
                    f"assemble: lengths must be int32 [{B}] on {word.device}")
    return B, L


def assemble_rows_plain(call, lengths: torch.Tensor, Lp: int):
    """Plain PyTorch version of ``assemble_rows``: the reference's column
    words, then the cursor walk's cumsum and scatter."""
    lengths = lengths.to(torch.int32)
    return assemble_words_plain(pack_columns(call, lengths), lengths, Lp)


# columns of a read that one block of the assembly kernels takes
# (ASM_TILE, csrc/assemble.cu)
ASM_TILE = 1024

_FIELDS = (("emitted", torch.bool, ()), ("base", torch.int8, ()),
           ("ins_len", torch.int32, ()), ("phred", torch.int32, ()),
           ("ins_bases", torch.int8, (INS_K,)))


def assemble_fields_cuda(call, lengths, Lp: int):
    """Two launches over (tile of ASM_TILE columns, read): each tile's emit
    count, then each tile's bytes at its read's cursor; the fields are read
    as they are (dtypes of ``ConsensusCall``), no host sync."""
    B, L = call.base.shape
    dev = call.base.device
    fields = []
    for name, dtype, tail in _FIELDS:
        f = getattr(call, name)
        kernels.require(f.dtype == dtype and f.shape == (B, L, *tail)
                        and f.device == dev,
                        f"assemble_rows: {name} must be {dtype} "
                        f"{[B, L, *tail]} on {dev}")
        fields.append(f.contiguous())
    kernels.require(lengths.dtype == torch.int32 and lengths.shape == (B,)
                    and lengths.device == dev,
                    f"assemble_rows: lengths must be int32 [{B}] on {dev}")
    lengths = lengths.contiguous()
    codes = torch.empty((B, Lp), dtype=torch.int8, device=dev)
    qual = torch.empty((B, Lp), dtype=torch.uint8, device=dev)
    nlen = torch.empty(B, dtype=torch.int32, device=dev)
    if B > 0:
        counts = torch.empty((B, max(1, -(-L // ASM_TILE))),
                             dtype=torch.int32, device=dev)
        rc = kernels.lib().pt_assemble_rows(
            *(f.data_ptr() for f in fields), lengths.data_ptr(), B, L, Lp,
            counts.data_ptr(), codes.data_ptr(), qual.data_ptr(),
            nlen.data_ptr(), kernels.stream_of(codes))
        kernels.check(rc, "assemble_rows")
        kernels.count_launch(assemble_rows)
    return codes, qual, nlen


def assemble_words_plain(word, lengths, Lp: int):
    """Plain PyTorch version: exclusive cumsum of the per-column emit
    counts, then scatter of each base and inserted base at its cursor."""
    B, L = _check_words(word, lengths)
    dev = word.device
    em = ((word & 1) == 1) & (torch.arange(L, device=dev)[None, :]
                              < lengths[:, None])
    nins = (word >> 4) & 7
    cnt = torch.where(em, 1 + nins, 0).to(torch.int64)
    cur = torch.cumsum(cnt, 1) - cnt                       # exclusive
    nlen = torch.clamp(cnt.sum(1), max=Lp).to(torch.int32)
    phred3 = ((word >> 7) & 63) << 3
    out = torch.full((B, Lp), 4, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)[:, None].expand(B, L)
    for k in range(-1, INS_K):
        if k < 0:
            ok = em
            val = ((word >> 1) & 7) | phred3
        else:
            ok = em & (k < nins)
            val = ((word >> (13 + 3 * k)) & 7) | phred3
        pos = cur + 1 + k
        ok = ok & (pos < Lp)
        out[rows[ok], pos[ok]] = val[ok]
    live = torch.arange(Lp, device=dev)[None, :] < nlen[:, None]
    codes = torch.where(live, out & 7, 4).to(torch.int8)
    qual = torch.where(live, (out >> 3) & 63, 0).to(torch.uint8)
    return codes, qual, nlen


# --------------------------------------------------------------------------
# HCR masking
# --------------------------------------------------------------------------

def mask_params_vec(p) -> torch.Tensor:
    """MaskParams as a length-6 f32 vector (the reference's
    ``mask_params_vec``), kept on the host."""
    return torch.tensor([p.phred_min, p.phred_max, p.mask_min_len,
                         p.unmask_min_len, p.mask_reduce, p.end_ratio],
                        dtype=torch.float32)


def _int_params(pv) -> list:
    """f32 params vector -> the kernel's six ints: the first five
    truncated, the end reduction ``round(red * end_ratio)`` in f32 (half to
    even, as ``jnp.round``)."""
    pvf = torch.as_tensor(pv, dtype=torch.float32).cpu()
    ints = [int(v) for v in pvf[:5].to(torch.int32)]
    ints.append(int(torch.round(pvf[4] * pvf[5]).to(torch.int32)))
    return ints


@attributed("hcr_mask_rows")
def hcr_mask_rows(qual: torch.Tensor, lengths: torch.Tensor, pv):
    """(mask bool [B, L], masked fraction f32 0-dim tensor)."""
    pvi = _int_params(pv)
    lengths = lengths.to(torch.int32)
    if qual.device.type == "cpu":
        mask, counts = hcr_mask_plain(qual, lengths, pvi)
    elif qual.device.type == "cuda":
        mask, counts = hcr_mask_cuda(qual, lengths, pvi)
    else:
        raise ValueError(f"hcr_mask_rows: device {qual.device}")
    total = torch.clamp(lengths.sum(), min=1).to(torch.float32)
    return mask, counts.sum().to(torch.float32) / total


hcr_mask_rows.launches = 0


def _check_qual(qual, lengths):
    B, L = qual.shape
    kernels.require(qual.dtype == torch.uint8, "hcr_mask: qual must be uint8")
    kernels.require(lengths.dtype == torch.int32 and lengths.shape == (B,)
                    and lengths.device == qual.device,
                    f"hcr_mask: lengths must be int32 [{B}] on {qual.device}")
    return B, L


def hcr_mask_cuda(qual, lengths, pvi):
    B, L = _check_qual(qual, lengths)
    qual, lengths = qual.contiguous(), lengths.contiguous()
    mask = torch.empty((B, L), dtype=torch.bool, device=qual.device)
    counts = torch.empty(B, dtype=torch.int32, device=qual.device)
    if B > 0:
        rc = kernels.lib().pt_hcr_mask_rows(
            qual.data_ptr(), lengths.data_ptr(), B, L, *pvi,
            mask.data_ptr(), counts.data_ptr(), kernels.stream_of(qual))
        kernels.check(rc, "hcr_mask_rows")
        kernels.count_launch(hcr_mask_rows)
    return mask, counts


def _runs(m: torch.Tensor, pos: torch.Tensor, L: int):
    """Per position (start, end) of the containing True run of ``m``."""
    start = torch.cummax(torch.where(~m, pos + 1, 0), 1).values
    end_r = torch.cummax(torch.where(~m, L - pos, 0).flip(1), 1).values
    return start, L - end_r.flip(1)


def hcr_mask_plain(qual, lengths, pvi):
    """Plain PyTorch version (run starts/ends by running maxima, as the
    reference's scan formulation ``device_hcr_mask_dyn_xla``)."""
    B, L = _check_qual(qual, lengths)
    pmin, pmax, min_len, unmask_len, red, end_red = pvi
    dev = qual.device
    pos = torch.arange(L, device=dev, dtype=torch.int64)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    valid = pos < lens
    q = qual.to(torch.int64)
    inq = (q >= pmin) & (q <= pmax) & valid

    s1, e1 = _runs(inq, pos, L)
    kept = inq & ((e1 - s1) >= min_len)
    gap = (~kept) & valid
    gs, ge = _runs(gap, pos, L)
    has_left = torch.cummax(kept.to(torch.int8), 1).values > 0
    has_right = torch.cummax(kept.to(torch.int8).flip(1), 1).values.flip(1) > 0
    left_in = (gs > 0) & torch.gather(has_left, 1, torch.clamp(gs - 1, min=0))
    right_ok = (ge < lens) & torch.gather(has_right, 1,
                                          torch.clamp(ge, 0, L - 1))
    fill = gap & ((ge - gs) < unmask_len) & left_in & right_ok
    merged = kept | fill
    ms, me = _runs(merged, pos, L)
    lo = ms + torch.where(ms == 0, end_red, red)
    hi = me - torch.where(me == lens, end_red, red)
    final = merged & (pos >= lo) & (pos < hi)
    return final, final.sum(1).to(torch.int32)
