"""Carry the reference package's state across: configuration dataclasses and
packed read batches, from plain Python values and numpy arrays.

The system has no weights; what must match between the two packages is
configuration and packed batches. ``params_from_fields`` rebuilds the
port's dataclasses from ``dataclasses.asdict()`` of the reference objects
(nested dataclasses arrive as dicts), and ``batch_to_tensors`` builds the
port's ``ReadBatch`` from a reference batch's numpy arrays."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from proovread_tpu_torch.align.params import AlignParams
from proovread_tpu_torch.io.batch import ReadBatch
from proovread_tpu_torch.pipeline.driver import PipelineConfig
from proovread_tpu_torch.pipeline.masking import MaskParams
from proovread_tpu_torch.pipeline.trim import TrimParams

# nested dataclass fields of PipelineConfig
_NESTED = {"hcr_mask": MaskParams, "hcr_mask_late": MaskParams,
           "trim": TrimParams}


def params_from_fields(cls, fields: dict):
    """An instance of the port's ``cls`` (AlignParams, ConsensusParams,
    MaskParams, TrimParams or PipelineConfig) from ``asdict()`` of the
    reference's object. Fields the port's class lacks raise TypeError."""
    kw = dict(fields)
    if cls is PipelineConfig:
        for name, sub in _NESTED.items():
            if isinstance(kw.get(name), dict):
                kw[name] = sub(**kw[name])
        sched = kw.get("align_schedule")
        if sched:
            kw["align_schedule"] = {k: (AlignParams(**v) if isinstance(v, dict)
                                        else v) for k, v in sched.items()}
    names = {f.name for f in dataclasses.fields(cls)}
    extra = set(kw) - names
    if extra:
        raise TypeError(f"{cls.__name__} has no field(s) {sorted(extra)}")
    return cls(**kw)


def batch_to_tensors(ids: Sequence[str], codes: np.ndarray, qual: np.ndarray,
                     lengths: np.ndarray, device="cpu"):
    """(ReadBatch of the numpy arrays, (codes, qual, lengths) tensors on
    ``device``)."""
    batch = ReadBatch(ids=list(ids), codes=np.asarray(codes, np.int8),
                      qual=np.asarray(qual, np.uint8),
                      lengths=np.asarray(lengths, np.int32))
    tensors = (torch.as_tensor(batch.codes, device=device),
               torch.as_tensor(batch.qual, device=device),
               torch.as_tensor(batch.lengths, device=device))
    return batch, tensors
