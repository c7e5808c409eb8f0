"""The shape oracle: per-config bucket tables, rebuilt on the host (port
of ``proovread_tpu/analysis/shapes.py``).

The table comes from the same host-side planning code the driver runs:
the workload of ``obs/census.py:build_workload``, the pipeline config
``pipeline/tasks.py:_pipeline_config`` builds for ``-m sr-noccs`` over
the default ``Config``, and the driver's own read filter, bucketing, row
rounding and Lp ladder (``read_long``, ``_bucket_records``,
``batch_rows``, ``bucket_lp``), so the oracle and the driver cannot
disagree. It is host arithmetic only: nothing touches a device.

The reference feeds these tables to its census predictor and its factory
walk, which compile one XLA program per shape. CUDA compiles nothing per
shape, so here the table sizes the factory's boot child, which launches
each kernel entry once at the first bucket's shapes
(``analysis/factory.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

MODE = "sr-noccs"          # the census/prewarm CLI mode
SR_PAD_MULTIPLE = 16       # driver: device-engine query padding
SEL_PAD_MULTIPLE = 512     # sampled-selection rounding


@dataclass(frozen=True)
class Bucket:
    """One length bucket as the device engine pads it."""
    n_reads: int           # records in the bucket
    rows: int              # padded device rows (batch_rows)
    Lp: int                # padded length (bucket_lp ladder)
    pad: int               # longest read in the bucket


@dataclass
class ConfigPlan:
    """Everything shape-determining about one bench config's run."""
    config: int
    cap_bases: Optional[int]
    pc: object                       # PipelineConfig
    n_short: int
    m: int                           # padded short-read length
    coverage: float                  # the driver's SR/LR estimate
    min_sr_len: int
    buckets: List[Bucket] = field(default_factory=list)


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def build_plan(config: int, cap_bases: Optional[int] = None) -> ConfigPlan:
    """The shape plan of bench config 3 or 4 (config 3 at its pinned
    prewarm cap, ``census.DEFAULT_CAPS``, unless ``cap_bases`` is
    given)."""
    from proovread_tpu_torch.config import Config
    from proovread_tpu_torch.obs.census import DEFAULT_CAPS, build_workload
    from proovread_tpu_torch.pipeline.driver import (Pipeline,
                                                     PipelineConfig,
                                                     _bucket_records,
                                                     batch_rows, bucket_lp)
    from proovread_tpu_torch.pipeline.tasks import _pipeline_config

    if cap_bases is None:
        cap_bases = DEFAULT_CAPS.get(config)
    longs, shorts, _truths = build_workload(config, cap_bases)

    cfg = Config()
    pc = _pipeline_config(cfg, MODE, cfg.tasks(MODE), None, None, True)

    # run_tasks' read-long normalization, then the driver's own filter
    sr_lens = sorted(len(r) for r in shorts)
    min_sr = sr_lens[len(sr_lens) // 2] if sr_lens else 200
    kept, _ = Pipeline(PipelineConfig(lr_min_length=None)).read_long(
        longs, min_sr)
    kept, _ = Pipeline(pc).read_long(kept, min_sr)

    total_lr = sum(len(r) for r in kept)
    coverage = (pc.coverage if pc.coverage is not None
                else sum(len(r) for r in shorts) / max(total_lr, 1))
    m = max(SR_PAD_MULTIPLE,
            _round_up(max((len(r) for r in shorts), default=0),
                      SR_PAD_MULTIPLE))
    buckets = [Bucket(n_reads=len(recs),
                      rows=batch_rows(len(recs), pc.batch_reads),
                      Lp=bucket_lp(pad, pc.length_slack), pad=pad)
               for pad, recs in _bucket_records(kept, pc.batch_reads)]
    return ConfigPlan(config=config, cap_bases=cap_bases, pc=pc,
                      n_short=len(shorts), m=m, coverage=coverage,
                      min_sr_len=min_sr, buckets=buckets)
