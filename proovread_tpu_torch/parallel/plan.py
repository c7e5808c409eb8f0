"""Mesh placement plan: which long read lives on which shard.

Port of ``proovread_tpu/parallel/plan.py`` (pure numpy, the same bits).

The naive ``B/n`` contiguous split inherits whatever length ordering the
bucket happens to have, and candidate load is roughly proportional to read
length (every query window that overlaps a read is a potential candidate),
so a length-skewed bucket turns into one hot shard that every pass's
all-reduce waits on. :func:`balance_placement` instead does an LPT
(longest-processing-time) greedy assignment under an equal-cardinality
constraint: reads sorted by descending length, each placed on the
least-loaded shard that still has slots. Shards stay equal-sized while
per-shard *base* load, the candidate proxy, is balanced.

Placement is a pure function of ``(lengths, n_shards)``: recomputing it
for a shrunken mesh after a shard loss IS the rebalance, and
:func:`moved_reads` counts how many reads changed shard so the demotion
can be attributed and metered (``mesh_rebalanced_reads``). Nothing here
is keyed by shard slot: the checkpoint journal stays keyed by read ids
(``resilience.bucket_key``), which is what makes a journal written at
mesh=4 replayable at mesh=2.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def balance_placement(lengths, n_shards: int) -> np.ndarray:
    """Candidate-balanced placement of ``rows = len(lengths)`` reads onto
    ``n_shards`` equal slices.

    Returns ``order`` (i32 ``[rows]``): ``order[j]`` is the original row
    placed at position ``j``, with positions ``[k*S, (k+1)*S)`` forming
    shard ``k`` (``S = rows // n_shards``; ``rows`` must divide evenly:
    the caller pads with sentinel reads, which act as near-zero load).
    Within a shard, rows keep ascending original order, so the placement
    is deterministic and stable under ties."""
    lengths = np.asarray(lengths)
    rows = len(lengths)
    if rows % n_shards:
        raise ValueError(f"{rows} rows do not split over {n_shards} shards")
    S = rows // n_shards
    if n_shards == 1:
        return np.arange(rows, dtype=np.int32)
    # LPT under the equal-cardinality cap; ties break toward the lower
    # original row (a stable argsort on -lengths keeps it deterministic)
    by_len = np.argsort(-lengths.astype(np.int64), kind="stable")
    load = np.zeros(n_shards, np.int64)
    fill = np.zeros(n_shards, np.int32)
    shard_rows = [[] for _ in range(n_shards)]
    for r in by_len:
        open_ = np.flatnonzero(fill < S)
        k = open_[np.argmin(load[open_])]
        shard_rows[k].append(int(r))
        load[k] += int(lengths[r])
        fill[k] += 1
    order = np.concatenate(
        [np.sort(np.array(rows_k, np.int32)) for rows_k in shard_rows])
    return order.astype(np.int32)


def shard_of_rows(order: np.ndarray, n_shards: int) -> np.ndarray:
    """Inverse view of a placement: ``shard_of_rows(order, n)[i]`` is the
    shard holding original row ``i``."""
    rows = len(order)
    S = rows // n_shards
    out = np.empty(rows, np.int32)
    out[order] = np.repeat(np.arange(n_shards, dtype=np.int32), S)
    return out


def moved_reads(prev_shard: Optional[np.ndarray],
                cur_shard: np.ndarray, n_real: int) -> int:
    """Reads (among the first ``n_real`` original rows: pad rows are free
    to move) whose shard changed between two placements. 0 when there is
    no previous placement or the read count changed (a fresh bucket, not a
    rebalance)."""
    if prev_shard is None or len(prev_shard) < n_real \
            or len(cur_shard) < n_real:
        return 0
    return int(np.sum(prev_shard[:n_real] != cur_shard[:n_real]))
