"""TorchMapper: the port's counterpart of ``proovread_tpu/align/mapper.py``'s
``JaxMapper``, the mapper under siamaera.

Per call: seed (host k-mer index, ``align/seed.py``) -> extract candidate
ref windows -> batched SW extension + traceback on the device
(``align/sw.py:sw_batch``, the ``csrc/sw.cu`` kernel on the card) ->
threshold (per-base ``-T``, ``proovread.cfg:325``) -> Alignment records
grouped into per-long-read ``AlnSet``s, each carrying the caller's
``ConsensusParams`` for its filters and admission. Chunks of ``chunk_rows`` (2048)
candidates, window clipping and the records are the reference's; the last
chunk is not padded to a full one (the reference pads it only to keep one
jitted shape).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from proovread_tpu_torch.align import seed as seed_mod
from proovread_tpu_torch.align.params import AlignParams
from proovread_tpu_torch.align.sw import ops_to_cigar, sw_batch
from proovread_tpu_torch.consensus.alnset import Alignment, AlnSet
from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.device import resolve
from proovread_tpu_torch.io.batch import ReadBatch

FLAG_REVERSE = 16


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


@dataclass
class MapResult:
    alnsets: List[AlnSet]          # one per long read, index-aligned to refs
    n_candidates: int = 0
    n_passed: int = 0


class TorchMapper:
    def __init__(
        self,
        params: Optional[AlignParams] = None,
        chunk_rows: int = 2048,
        device: str = "cuda",
    ):
        self.params = params or AlignParams()
        self.chunk_rows = chunk_rows
        self.device = device

    def map_batch(
        self,
        refs: ReadBatch,
        queries: ReadBatch,
        cns_params: Optional[ConsensusParams] = None,
        candidate_filter=None,
    ) -> MapResult:
        p = self.params
        cns = cns_params or ConsensusParams()
        dev = resolve(self.device)
        B, L = refs.codes.shape
        alnsets = [AlnSet(ref_id=refs.ids[i], ref_len=int(refs.lengths[i]),
                          params=cns)
                   for i in range(B)]

        rc_codes = seed_mod.revcomp_batch(queries.codes, queries.lengths)
        index = seed_mod.build_index(refs.codes, refs.lengths, p.min_seed_len)
        cand = seed_mod.find_candidates(
            index, queries.codes, queries.lengths, p, rc=rc_codes
        )
        if candidate_filter is not None:
            keep = candidate_filter(cand)
            cand = seed_mod.Candidates(*(a[keep] for a in cand))
        n_cand = len(cand.sread)
        if n_cand == 0:
            return MapResult(alnsets, 0, 0)

        m = queries.pad_len
        n = _round_up(m + 2 * p.band_width, 128)

        # candidate window starts, clipped into the padded ref array
        win_start = cand.diag - p.band_width
        win_start = np.clip(win_start, 0, max(0, L - n))
        if L >= n:
            ref_windows = np.lib.stride_tricks.sliding_window_view(
                refs.codes, n, axis=1
            )
        else:
            pad = np.full((B, n - L), 4, np.int8)  # N padding
            ref_windows = np.lib.stride_tricks.sliding_window_view(
                np.concatenate([refs.codes, pad], axis=1), n, axis=1
            )

        n_passed = 0
        for start in range(0, n_cand, self.chunk_rows):
            sl = slice(start, min(start + self.chunk_rows, n_cand))
            # materialize only this chunk's query/window copies (no pad
            # rows: the reference pads the last chunk only to keep its
            # jitted shape)
            qc = np.where(cand.strand[sl, None] == 0,
                          queries.codes[cand.sread[sl]],
                          rc_codes[cand.sread[sl]])
            rcw = np.ascontiguousarray(
                ref_windows[cand.lread[sl], win_start[sl]])
            ql = queries.lengths[cand.sread[sl]].astype(np.int32)

            res = sw_batch(torch.as_tensor(qc, device=dev),
                           torch.as_tensor(rcw, device=dev),
                           torch.as_tensor(ql, device=dev), p)
            score, q_start, q_end, r_start, ops_rev, n_ops = (
                t.cpu().numpy() for t in (
                    res.score, res.q_start, res.q_end, res.r_start,
                    res.ops_rev, res.n_ops))

            thr = np.array([p.threshold(q) for q in ql])
            passed = np.flatnonzero(score >= thr)
            n_passed += len(passed)
            for j in passed:
                ci = start + j
                li = int(cand.lread[ci])
                qlen = int(ql[j])
                ops, lens = ops_to_cigar(
                    ops_rev[j], int(n_ops[j]), int(q_start[j]), int(q_end[j]), qlen
                )
                if len(ops) == 0:
                    continue
                si = int(cand.sread[ci])
                strand = int(cand.strand[ci])
                seq = (rc_codes if strand else queries.codes)[si, :qlen]
                qual = queries.qual[si, :qlen]
                if strand:
                    qual = qual[::-1]
                pos0 = int(win_start[ci]) + int(r_start[j])
                alnsets[li].alns.append(Alignment(
                    qname=queries.ids[si],
                    pos0=pos0,
                    seq_codes=seq.copy(),
                    ops=ops,
                    lens=lens,
                    qual=qual.copy(),
                    score=float(score[j]),
                    flag=FLAG_REVERSE if strand else 0,
                ))
        return MapResult(alnsets, n_cand, n_passed)
