"""Pileup accumulation: vote bit planes -> per-read pileup counts.

Port of ``proovread_tpu/ops/pileup_kernel.py:pileup_accumulate_bits``. Each
candidate's two i32 bit planes per window column decode to one-hot votes over
the 64 lanes, added into ``pileup[read_of, w0:w0+n, :]``.

The buffer is f32 ``[B, Lp + 2n, PACK_LANES]`` and is updated IN PLACE (the
JAX buffer is aliased in and out). Every add is +1 to an integer count far
below 2^24, so any order of adds gives the same bits. The TPU's bf16 128-lane
buffer, its VMEM budget split and the windowed fallback only laid data out;
what the port holds equal is ``unpack_pileup``'s result.

``pileup_accumulate_bits`` runs the plain PyTorch version for CPU tensors and
the CUDA kernel (``csrc/pileup.cu``) for CUDA tensors.
"""

from __future__ import annotations

import torch

from proovread_tpu_torch import kernels
from proovread_tpu_torch.ops.votes import PACK_LANES


def _check(pileup, bits0, bits1, read_of, w0):
    B, Lpile, P = pileup.shape
    R, n = bits0.shape
    req = kernels.require
    req(P == PACK_LANES and pileup.dtype == torch.float32
        and pileup.is_contiguous(),
        "pileup: buffer must be contiguous f32 [B, L, 64] (updated in place)")
    req(bits0.dtype == torch.int32 and bits1.dtype == torch.int32
        and bits1.shape == (R, n), "pileup: bit planes must be int32 [R, n]")
    for name, t in (("read_of", read_of), ("w0", w0)):
        req(t.dtype == torch.int32 and t.shape == (R,),
            f"pileup: {name} must be int32 [{R}]")
    req(all(t.device == pileup.device for t in (bits0, bits1, read_of, w0)),
        "pileup: tensors on mixed devices")
    return B, Lpile, R, n


def pileup_accumulate_bits(pileup, bits0, bits1, read_of, w0):
    """Add each candidate's votes into ``pileup`` (in place) and return it.

    pileup: f32 [B, Lp + 2n, 64]; bits0/bits1: i32 [R, n] vote lanes 0-31 /
    32-63; read_of: i32 [R] target read; w0: i32 [R] window offset in the
    padded buffer, in [0, Lp + n]. Rows of dead candidates must be zero."""
    _check(pileup, bits0, bits1, read_of, w0)
    if pileup.device.type == "cpu":
        return pileup_accumulate_bits_plain(pileup, bits0, bits1, read_of, w0)
    if pileup.device.type != "cuda":
        raise ValueError(f"pileup_accumulate_bits: device {pileup.device}")
    return _pileup_cuda(pileup, bits0, bits1, read_of, w0)


pileup_accumulate_bits.launches = 0


def _pileup_cuda(pileup, bits0, bits1, read_of, w0):
    B, Lpile, R, n = _check(pileup, bits0, bits1, read_of, w0)
    kernels.require_in_range("pileup_accumulate_bits", (read_of, 0, B - 1),
                             (w0, 0, Lpile - n))
    bits0, bits1, read_of, w0 = (t.contiguous()
                                 for t in (bits0, bits1, read_of, w0))
    if R > 0:
        rc = kernels.lib().pt_pileup_accumulate_bits(
            pileup.data_ptr(), B, Lpile, bits0.data_ptr(), bits1.data_ptr(),
            read_of.data_ptr(), w0.data_ptr(), R, n,
            kernels.stream_of(pileup))
        kernels.check(rc, "pileup_accumulate_bits")
        pileup_accumulate_bits.launches += 1
    return pileup


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
