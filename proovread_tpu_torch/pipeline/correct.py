"""FastCorrector: one map + consensus pass over a long-read batch, the
engine of ``engine="scan"`` and of the resilience ladder's host-scan rung.

Port of ``proovread_tpu/pipeline/correct.py``. Per pass: host seeding
(``align/seed.py``, numpy), Smith-Waterman of every candidate against its
ref window in chunks of ``chunk_rows`` (``align/sw.py:sw_batch``: the
``csrc/sw.cu`` kernel on the card), one fetch of the O(R) per-candidate
scalars for threshold and score-binned admission on the host
(``consensus/alnset.py:admit_mask``, the reference's f64 sums), then the
admitted traceback streams scatter-added into the pileup
(``ops/fused.py:fused_accumulate``) and the consensus called
(``ops/consensus_call.py``), as torch tensors on the pass's device, and
each read assembled on the host (``consensus/engine.py``). This is one
``bwa-sr-N`` mapping task plus its ``bam2cns`` fan-out
(``bin/proovread:835-869`` + ``:1528-1721``).

The reference pads the last SW chunk to ``chunk_rows`` to keep one jitted
shape; the port does not (pad rows vote nothing, so no output changes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from proovread_tpu_torch.align import seed as seed_mod
from proovread_tpu_torch.align.params import AlignParams
from proovread_tpu_torch.align.sw import sw_batch
from proovread_tpu_torch.consensus.alnset import admit_mask
from proovread_tpu_torch.consensus.engine import (ConsensusResult,
                                                  assemble_consensus)
from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.device import resolve
from proovread_tpu_torch.io.batch import ReadBatch
from proovread_tpu_torch.obs import qc as obs_qc
from proovread_tpu_torch.ops.consensus_call import call_consensus
from proovread_tpu_torch.ops.fused import add_ref_votes, fused_accumulate
from proovread_tpu_torch.ops.pileup import init_pileup


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


@dataclass
class CorrectionStats:
    n_candidates: int = 0
    n_admitted: int = 0
    # threshold-passed candidates with a positive ref span; eligible minus
    # admitted is what the max_coverage bin-budget admission dropped
    n_eligible: int = 0
    n_dropped_cov: int = 0
    # per-read QC arrays (obs/qc.py), filled only while a QC recorder is
    # installed: 'edits' / 'uplift' (i64 [B] pass deltas), 'admitted'
    # (i64 [B] admitted alignments per read), 'support_sum' (f32 [B]
    # integer-exact column-coverage sums); the host twin of
    # dcorrect.qc_pass_row_stats / qc_finish_support
    qc_rows: Optional[Dict[str, Any]] = None


@dataclass
class _Chunk:
    """One SW chunk: its candidate slice, the SW result on the device, and
    the host query codes and lengths the chimera scan re-reads."""
    sl: slice
    res: Any
    q: np.ndarray
    ql: np.ndarray
    q_dev: torch.Tensor
    ops_host: Optional[np.ndarray] = None


class FastCorrector:
    def __init__(
        self,
        align_params: Optional[AlignParams] = None,
        cns_params: Optional[ConsensusParams] = None,
        chunk_rows: int = 4096,
        device: str = "cuda",
    ):
        self.align_params = align_params or AlignParams()
        self.cns_params = cns_params or ConsensusParams()
        self.chunk_rows = chunk_rows
        self.device = device

    def correct_batch(
        self,
        refs: ReadBatch,
        queries: ReadBatch,
        ignore_coords: Optional[Sequence[Sequence[Tuple[int, int]]]] = None,
        mask_codes: Optional[np.ndarray] = None,
        detect_chimera: bool = False,
        candidate_filter=None,
    ) -> Tuple[List[ConsensusResult], CorrectionStats]:
        """Correct one batch.

        ``mask_codes``: N-masked copy of ``refs.codes`` used as the *mapping*
        target (seeding + SW windows), while consensus ref votes use the
        unmasked reads (``bin/proovread:837-851,1547``). ``ignore_coords``:
        MCR intervals whose columns take no SR votes. ``detect_chimera``:
        run the low-coverage-bin entropy scan (finish tasks,
        ``bin/bam2cns:461-491``); results land on each
        ``ConsensusResult.chimera``."""
        p = self.align_params
        cns = self.cns_params
        dev = resolve(self.device)
        B, L = refs.codes.shape
        map_codes = mask_codes if mask_codes is not None else refs.codes

        rc_codes = seed_mod.revcomp_batch(queries.codes, queries.lengths)
        index = seed_mod.build_index(map_codes, refs.lengths, p.min_seed_len)
        cand = seed_mod.find_candidates(
            index, queries.codes, queries.lengths, p, rc=rc_codes)
        if candidate_filter is not None:
            keep = candidate_filter(cand)
            cand = seed_mod.Candidates(*(a[keep] for a in cand))
        n_cand = len(cand.sread)

        m = queries.pad_len
        n = _round_up(m + 2 * p.band_width, 128)
        win_start = np.clip(cand.diag - p.band_width, 0, max(0, L - n))
        padded = (map_codes if L >= n else np.concatenate(
            [map_codes, np.full((B, n - L), 4, np.int8)], axis=1))
        ref_windows = np.lib.stride_tricks.sliding_window_view(
            padded, n, axis=1)

        # pass 1: SW every chunk, traceback tensors stay on the device; the
        # per-candidate scalars come back in one fetch
        chunks: List[_Chunk] = []
        C = self.chunk_rows
        for start in range(0, n_cand, C):
            sl = slice(start, min(start + C, n_cand))
            qc = np.where(cand.strand[sl, None] == 0,
                          queries.codes[cand.sread[sl]],
                          rc_codes[cand.sread[sl]])
            rcw = np.ascontiguousarray(ref_windows[cand.lread[sl],
                                                   win_start[sl]])
            ql = queries.lengths[cand.sread[sl]].astype(np.int32)
            q_dev = torch.as_tensor(qc, device=dev)
            res = sw_batch(q_dev, torch.as_tensor(rcw, device=dev),
                           torch.as_tensor(ql, device=dev), p)
            chunks.append(_Chunk(sl, res, qc, ql, q_dev))

        if chunks:
            def cat(name):
                return torch.cat([getattr(c.res, name) for c in chunks])
            score, q_start, q_end, r_start, r_end = (
                t.cpu().numpy() for t in (
                    cat("score"), cat("q_start"), cat("q_end"),
                    cat("r_start"), cat("r_end")))
            if p.score_per_base:
                thr = p.min_out_score * queries.lengths[cand.sread]
            else:
                thr = np.full(n_cand, p.min_out_score)
            passed = score >= thr
            span = r_end - r_start
            pos0 = win_start + r_start
            admitted = admit_mask(cand.lread, pos0, span, score,
                                  refs.lengths, cns, valid=passed)
            n_eligible = int((passed & (span > 0)).sum())
        else:
            admitted = np.zeros(0, bool)
            n_eligible = 0

        ignore = None
        if ignore_coords is not None:
            ig = np.zeros((B, L), bool)
            for i, regions in enumerate(ignore_coords):
                for off, ln in regions or []:
                    ig[i, max(0, off): off + ln] = True
            ignore = torch.as_tensor(ig, device=dev)

        # pass 2: the admitted traceback streams into the pileup
        pile = init_pileup(B, L, cns.ins_cap, device=dev)
        for c in chunks:
            sr = cand.sread[c.sl]
            fwdq = queries.qual[sr]
            revq = _reverse_quals(fwdq, queries.lengths[sr])
            qualc = np.where(cand.strand[c.sl, None] == 0, fwdq, revq)

            def t(a, dtype=None):
                return torch.as_tensor(
                    a if dtype is None else a.astype(dtype), device=dev)
            fused_accumulate(
                pile, c.res.ops_rev, c.res.step_i, c.res.step_j, c.q_dev,
                t(qualc), c.res.q_start, c.res.q_end,
                t(cand.lread[c.sl], np.int32), t(win_start[c.sl], np.int32),
                t(admitted[c.sl]), ignore_mask=ignore,
                qual_weighted=cns.qual_weighted,
                taboo_frac=cns.indel_taboo if cns.trim else 0.0,
                taboo_abs=(cns.indel_taboo_length or 0) if cns.trim else 0,
                min_aln_length=cns.min_aln_length)

        ref_codes = torch.as_tensor(refs.codes, device=dev)
        if cns.use_ref_qual:
            pile = add_ref_votes(
                pile, ref_codes,
                torch.as_tensor(refs.qual.astype(np.float32), device=dev),
                torch.as_tensor(refs.position_mask().astype(np.float32),
                                device=dev))
        call = call_consensus(pile, ref_codes, cns.max_ins_length)
        del pile
        emitted, base, ins_len, ins_bases, freq, phred, coverage = (
            x.cpu().numpy() for x in (
                call.emitted, call.base, call.ins_len, call.ins_bases,
                call.freq, call.phred, call.coverage))

        results = []
        for i in range(B):
            nn = int(refs.lengths[i])
            results.append(assemble_consensus(
                refs.ids[i], emitted[i, :nn], base[i, :nn], ins_len[i, :nn],
                ins_bases[i, :nn], freq[i, :nn], phred[i, :nn],
                coverage[i, :nn]))

        if detect_chimera and chunks and admitted.any():
            self._detect_chimera(
                results, refs, queries, cand, chunks, admitted,
                win_start, r_start, r_end, q_start, q_end, score)

        qc_rows = None
        if obs_qc.enabled():
            # host twin of dcorrect.qc_pass_row_stats/qc_finish_support:
            # the same formulas over the fetched call arrays, so the
            # host-scan rung's QC records match the device rungs exactly
            pos = np.arange(L)[None, :]
            valid = pos < refs.lengths[:, None]
            em = emitted & valid
            subs = (em & (base != refs.codes)).sum(1)
            ins = np.where(em, ins_len, 0).sum(1)
            dels = (valid & ~emitted).sum(1)
            uplift = (em & (phred > refs.qual.astype(np.int32))).sum(1)
            adm_pr = (np.bincount(cand.lread[admitted], minlength=B)
                      if n_cand else np.zeros(B, np.int64))
            qc_rows = {
                "edits": (subs + ins + dels).astype(np.int64),
                "uplift": uplift.astype(np.int64),
                "admitted": adm_pr.astype(np.int64),
                "support_sum": np.where(valid, coverage, 0.0).sum(
                    1, dtype=np.float32),
            }

        n_adm = int(admitted.sum())
        return results, CorrectionStats(
            n_cand, n_adm, n_eligible=n_eligible,
            n_dropped_cov=max(0, n_eligible - n_adm), qc_rows=qc_rows)

    def _detect_chimera(self, results, refs, queries, cand, chunks, admitted,
                        win_start, r_start, r_end, q_start, q_end, score):
        """Lazy chimera scan: bin stats from the admitted-candidate arrays;
        only alignments flanking a suspicious low-fill bin run are fetched
        from the device chunks (a chunk's ops once) and expanded on host."""
        from proovread_tpu_torch.align.sw import ops_to_cigar
        from proovread_tpu_torch.consensus.cigar import expand_alignment
        from proovread_tpu_torch.consensus.engine import chimera_scan

        cns = self.cns_params
        bs = cns.bin_size
        C = self.chunk_rows
        span = r_end - r_start
        pos0 = win_start + r_start
        bins = np.clip(((pos0 + 1 + span / 2) // bs).astype(np.int64),
                       0, None)
        adm_idx = np.flatnonzero(admitted)
        ops_cache = {}

        def fetch_cols(ci):
            """ColumnStates of candidate ci (host-expanded, cached)."""
            if ci in ops_cache:
                return ops_cache[ci]
            ck = chunks[ci // C]
            row = ci % C
            if ck.ops_host is None:
                ck.ops_host = ck.res.ops_rev.cpu().numpy()
            ops_rev = ck.ops_host[row]
            n_ops = int((ops_rev != 3).sum())
            ops, lens = ops_to_cigar(
                ops_rev, n_ops, int(q_start[ci]), int(q_end[ci]),
                int(ck.ql[row]))
            si = int(cand.sread[ci])
            qual = queries.qual[si, :int(ck.ql[row])]
            if cand.strand[ci]:
                qual = qual[::-1]
            cs = expand_alignment(
                int(pos0[ci]), ops, lens, ck.q[row, :int(ck.ql[row])], qual,
                cns)
            ops_cache[ci] = cs
            return cs

        for b in range(refs.codes.shape[0]):
            L_i = int(refs.lengths[b])
            mine = adm_idx[cand.lread[adm_idx] == b]
            if mine.size == 0:
                continue
            n_bins = L_i // bs + 1
            bb = np.bincount(np.clip(bins[mine], 0, n_bins - 1),
                             weights=span[mine].astype(np.float64),
                             minlength=n_bins)
            if n_bins <= 20 or not (
                    bb[5:-5] <= cns.bin_max_bases / 5 + 1).any():
                continue
            cover = np.zeros(L_i)
            for ci in mine:
                a, e = max(0, int(pos0[ci])), min(L_i,
                                                  int(pos0[ci] + span[ci]))
                cover[a:e] += 1

            def select(fl, tl, fr, tr, mine=mine):
                sel_l = [fetch_cols(ci) for ci in mine
                         if fl <= bins[ci] <= tl]
                sel_r = [fetch_cols(ci) for ci in mine
                         if fr <= bins[ci] <= tr]
                return ([c for c in sel_l if c is not None],
                        [c for c in sel_r if c is not None])

            results[b].chimera = chimera_scan(
                bb, L_i, cns, results[b], cover, select)


def _reverse_quals(qual: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Reverse each row's first `lengths[i]` entries (strand flip)."""
    R, m = qual.shape
    cols = (lengths[:, None] - 1 - np.arange(m)[None, :]) % m
    return np.take_along_axis(qual, cols, axis=1)
