"""Prefix sums in the reference's f32 order.

The JAX package sums admission spans with ``jnp.cumsum`` over f32
(``proovread_tpu/pipeline/dcorrect.py:device_admit``). Past 2^24 the sums
round, so the order of the adds is part of the result. XLA's CPU backend
lowers that cumsum to a blocked scan, and ``cumsum_f32_xla`` reproduces it
bit for bit: the input, zero-padded to a multiple of 16, is cut into rows of
16; each row is folded left to right; the row totals are scanned the same
way, recursively, until 16 values or fewer remain (a plain left fold); each
value is its row's inclusive sum plus the exclusive prefix of the row totals
(one f32 add). ``torch.cumsum`` adds in another order, which differs between
devices and sizes. Here each level is 15 elementwise column adds, so the
result is the same on the CPU and on the card, with no host sync.
"""

from __future__ import annotations

import torch

BLOCK = 16


def cumsum_f32_xla(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D f32 tensor in XLA's CPU order."""
    n = x.shape[0]
    if n <= BLOCK:
        cols = [x[:1]]
        for i in range(1, n):
            cols.append(cols[-1] + x[i:i + 1])
        return torch.cat(cols)
    rows = -(-n // BLOCK)
    v = torch.nn.functional.pad(x, (0, rows * BLOCK - n)).view(rows, BLOCK)
    cols = [v[:, 0]]
    for j in range(1, BLOCK):
        cols.append(cols[-1] + v[:, j])
    within = torch.stack(cols, 1)
    totals = cumsum_f32_xla(cols[-1])
    excl = torch.cat([totals.new_zeros(1), totals[:-1]])
    return (within + excl[:, None]).reshape(-1)[:n]
