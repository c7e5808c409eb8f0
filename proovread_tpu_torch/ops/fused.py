"""Reference-read votes added to a pileup (port of
``proovread_tpu/ops/fused.py:add_ref_votes``)."""

from __future__ import annotations

import torch

from proovread_tpu_torch.ops.pileup import Pileup


# round((phred^2/120)*100)/100 (Sam/Seq.pm:151-156) as XLA compiles the
# reference's f32 expression: both divisions become multiplications by
# constant reciprocals and the two scalings fold into one constant
_P2F_SCALE = torch.tensor(1.0 / 120.0, dtype=torch.float32) * 100.0
_P2F_UNIT = torch.tensor(0.01, dtype=torch.float32)


def phred2freq(p: torch.Tensor) -> torch.Tensor:
    """Phred -> vote weight in f32, rounding half to even."""
    pf = p.to(torch.float32)
    return (torch.round(pf * pf * _P2F_SCALE.to(pf.device))
            * _P2F_UNIT.to(pf.device))


def add_ref_votes(pile: Pileup, ref_codes: torch.Tensor,
                  ref_qual: torch.Tensor, length_mask: torch.Tensor
                  ) -> Pileup:
    """use_ref_qual: the long read's own bases vote with phred->freq weight
    (Sam/Seq.pm:255-266)."""
    S = pile.counts.shape[-1]
    w = phred2freq(ref_qual) * length_mask
    lanes = torch.arange(S, device=ref_codes.device)
    onehot = ((ref_codes.to(torch.int64)[:, :, None] == lanes)
              .to(torch.float32) * w[:, :, None])
    return pile._replace(counts=pile.counts + onehot)
