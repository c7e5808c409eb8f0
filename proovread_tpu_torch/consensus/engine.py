"""Consensus engine: host packing -> pileup + call on the device -> host
assembly, plus the chimera entropy detector (port of
``proovread_tpu/consensus/engine.py``).

``ConsensusEngine`` is the per-worker flow of ``bin/bam2cns:375-491``
(generate_consensus / detect_chimera) over alignment sets: score filters,
binned admission, state-matrix consensus with MCR ignore-coords, optional
chimera scan with breakpoint projection through the consensus cigar (-I, +D:
``bin/bam2cns:461-491``); the ``ccs-1`` and ``utg`` tasks run on it. The
alignment windows go into the pileup through ``ops/pileup.py:accumulate``
(the ordered scatter kernel ``csrc/scatter.cu`` on the card), so the
qual-weighted votes sum to the reference's bits on every device.
``ConsensusResult``, ``assemble_consensus``, ``chimera_runs``,
``chimera_score``, ``chimera_scan``, ``window_counts`` and ``emit_prefix``
are also what the device finish path and the scan engine use (host numpy,
``Sam/Seq.pm:774-888``). ``variant_table`` is the per-column variant call
(``ops/variants.py``) over an unweighted pileup built the same way, so on
the card it too runs the scatter kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from proovread_tpu_torch.consensus.alnset import AlnSet
from proovread_tpu_torch.consensus.cigar import (ColumnStates,
                                                 expand_alignment,
                                                 phreds_to_freqs)
from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.device import resolve
from proovread_tpu_torch.io.batch import ReadBatch
from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.ops import pileup as pileup_ops
from proovread_tpu_torch.ops.consensus_call import call_consensus
from proovread_tpu_torch.ops.encode import N_STATES, decode_codes


@dataclass
class ConsensusResult:
    record: SeqRecord                 # corrected read (id, seq, phred qual)
    freqs: np.ndarray                 # winning vote weight per consensus base
    coverage: np.ndarray              # total column coverage per ref column
    cigar: str                        # consensus->reference cigar (M/I/D)
    chimera: List[Tuple[int, int, float]] = field(default_factory=list)
    # (from, to, score) in corrected-sequence coords
    # per-ref-column emitted base count (1 + ins_len, 0 for dropped cols);
    # when present, emit_prefix derives coordinates from it directly — the
    # device finish path fills this instead of building a cigar string
    emit_counts: Optional[np.ndarray] = None

    @property
    def masked_frac(self) -> float:
        """Fraction of bases at phred 0 (uncorrected)."""
        if self.record.qual is None or len(self.record.qual) == 0:
            return 0.0
        return float((self.record.qual == 0).mean())


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


class ConsensusEngine:
    """Batched consensus over groups of long reads, on ``device``.

    ``cell_budget`` bounds the transient [chunk_rows x window] tensors; the
    chunk row count adapts to the window width so that unitig-scale
    alignments do not blow memory. Chunks are added in order, each row by
    row, so the order of the votes into a cell, and with it every f32 sum,
    does not depend on the chunk size.
    """

    def __init__(self, params: Optional[ConsensusParams] = None,
                 cell_budget: int = 1 << 22, device: str = "cuda"):
        self.params = params or ConsensusParams()
        self.cell_budget = cell_budget
        self.device = device

    # -- packing ---------------------------------------------------------
    def _expand_sets(self, alnsets: Sequence[AlnSet]
                     ) -> List[List[Tuple[ColumnStates, int]]]:
        """Per read: [(column states, index into aset.alns)] — the index keeps
        bin bookkeeping aligned after taboo-trim drops."""
        out = []
        for aset in alnsets:
            cols = []
            for j, a in enumerate(aset.alns):
                cs = expand_alignment(a.pos0, a.ops, a.lens, a.seq_codes,
                                      a.qual, self.params)
                if cs is not None:
                    cols.append((cs, j))
            out.append(cols)
        return out

    def _build_pileup(
        self,
        expanded: Sequence[Sequence[Tuple[ColumnStates, int]]],
        L: int,
        ignore_mask: Optional[np.ndarray] = None,
        ref_codes: Optional[np.ndarray] = None,
        ref_freqs: Optional[np.ndarray] = None,
    ) -> pileup_ops.Pileup:
        dev = resolve(self.device)
        B = len(expanded)
        K = self.params.ins_cap
        pile = pileup_ops.init_pileup(B, L, K, device=dev)

        flat: List[Tuple[int, ColumnStates]] = [
            (i, cs) for i, group in enumerate(expanded) for cs, _ in group]
        if flat:
            W = _round_up(max(cs.span for _, cs in flat), 128)
            R = max(1, min(len(flat), self.cell_budget // W))
            ign = (torch.as_tensor(ignore_mask, device=dev)
                   if ignore_mask is not None else None)
            for start in range(0, len(flat), R):
                chunk = flat[start:start + R]
                read_idx = np.zeros(R, np.int32)
                rpos = np.zeros(R, np.int32)
                state = np.full((R, W), -1, np.int8)
                freq = np.zeros((R, W), np.float32)
                ins_len = np.zeros((R, W), np.int16)
                ins_bases = np.zeros((R, W, K), np.int8)
                valid = np.zeros(R, bool)
                for j, (ri, cs) in enumerate(chunk):
                    n = cs.span
                    read_idx[j] = ri
                    rpos[j] = cs.rpos
                    state[j, :n] = cs.state
                    freq[j, :n] = cs.freq
                    ins_len[j, :n] = cs.ins_len
                    ins_bases[j, :n] = cs.ins_bases
                    valid[j] = True
                pileup_ops.accumulate(
                    pile, *(torch.as_tensor(a, device=dev) for a in (
                        read_idx, rpos, state, freq, ins_len, ins_bases,
                        valid)), ign)

        if (self.params.use_ref_qual and ref_codes is not None
                and ref_freqs is not None):
            # the read's own bases vote with phred->freq weight, after all
            # alignment votes (Sam/Seq.pm:255-266); never through the
            # insertion tensors
            onehot = ((ref_codes[:, :, None]
                       == np.arange(N_STATES)[None, None, :])
                      .astype(np.float32) * ref_freqs[:, :, None])
            pile = pile._replace(
                counts=pile.counts + torch.as_tensor(onehot, device=dev))
        return pile

    # -- main entry ------------------------------------------------------
    def consensus_batch(
        self,
        refs: ReadBatch,
        alnsets: Sequence[AlnSet],
        ignore_coords: Optional[Sequence[Sequence[Tuple[int, int]]]] = None,
        detect_chimera: bool = False,
    ) -> List[ConsensusResult]:
        """Correct a batch of long reads.

        ``refs``: the long reads (packed); ``alnsets[i]``: alignments onto
        read i (admission is applied here if not already done);
        ``ignore_coords[i]``: [offset, length] regions whose columns take no
        votes (MCRs from previous iterations, utg overlap windows).
        """
        B, L = refs.codes.shape
        if len(alnsets) != B:
            raise ValueError(f"{len(alnsets)} alignment sets for {B} reads")
        for aset in alnsets:
            if aset.bin_bases is None:
                aset.filter_by_scores()
                aset.admit()
            # pre-admitted sets keep their bin bookkeeping untouched:
            # re-filtering here would desync aln_bins/bin_bases from alns

        expanded = self._expand_sets(alnsets)

        ignore_mask = None
        if ignore_coords is not None:
            ignore_mask = np.zeros((B, L), bool)
            for i, regions in enumerate(ignore_coords):
                for off, ln in regions or []:
                    ignore_mask[i, max(0, off):off + ln] = True

        ref_freqs = None
        if self.params.use_ref_qual:
            ref_freqs = phreds_to_freqs(
                refs.qual.astype(np.float32)).astype(np.float32)
            ref_freqs *= refs.position_mask()

        pile = self._build_pileup(expanded, L, ignore_mask=ignore_mask,
                                  ref_codes=refs.codes, ref_freqs=ref_freqs)
        call = call_consensus(
            pile, torch.as_tensor(refs.codes, device=pile.counts.device),
            self.params.max_ins_length)
        del pile
        emitted, base, ins_len, ins_bases, freq, phred, coverage = (
            x.cpu().numpy() for x in (
                call.emitted, call.base, call.ins_len, call.ins_bases,
                call.freq, call.phred, call.coverage))

        results = []
        for i in range(B):
            n = int(refs.lengths[i])
            res = assemble_consensus(
                refs.ids[i], emitted[i, :n], base[i, :n], ins_len[i, :n],
                ins_bases[i, :n], freq[i, :n], phred[i, :n],
                coverage[i, :n])
            if detect_chimera:
                res.chimera = self._chimera(alnsets[i], expanded[i], n, res)
            results.append(res)
        return results

    # -- variant calling (Sam/Seq.pm:1666-1734) --------------------------
    def variant_table(self, refs: ReadBatch, alnsets: Sequence[AlnSet],
                      min_freq: float = 4.0, min_prob: float = 0.0,
                      or_min: bool = False):
        """Per-column variant call over the batch (``ops/variants.py``).

        The state matrix is recomputed unweighted and without ref-qual
        votes, as upstream ``call_variants`` does when it re-inits the
        matrix with default options (Sam/Seq.pm:1676-1677), whatever this
        engine's consensus weighting."""
        from dataclasses import replace

        from proovread_tpu_torch.ops.variants import (call_variants,
                                                      majority_insertion,
                                                      variant_freqs)
        L = refs.codes.shape[1]
        for aset in alnsets:
            if aset.bin_bases is None:
                aset.filter_by_scores()
                aset.admit()
        plain_engine = ConsensusEngine(
            replace(self.params, qual_weighted=False, use_ref_qual=False),
            self.cell_budget, device=self.device)
        pile = plain_engine._build_pileup(plain_engine._expand_sets(alnsets),
                                          L)
        mlen, mbases = majority_insertion(pile)
        vf, mlen, mbases = (t.cpu().numpy() for t in (
            variant_freqs(pile), mlen, mbases))
        return call_variants(vf, refs.lengths, min_freq=min_freq,
                             min_prob=min_prob, or_min=or_min,
                             ins_call=(mlen, mbases))

    # -- chimera (Sam/Seq.pm:774-888 + bam2cns:461-491) ------------------
    def _chimera(self, aset: AlnSet,
                 expanded: Sequence[Tuple[ColumnStates, int]], L: int,
                 res: "ConsensusResult") -> List[Tuple[int, int, float]]:
        p = self.params
        bb = aset.bin_bases
        if bb is None or len(bb) <= 20:
            return []
        # cheap prescreen before the O(total aligned bases) cover build
        if not (np.asarray(bb)[5:-5] <= p.bin_max_bases / 5 + 1).any():
            return []
        # plain full coverage for the covered-window check (the chimera
        # scan recomputes its own matrix without ignore coords or
        # weighting, bam2cns:461)
        cover = np.zeros(L)
        for cs, _ in expanded:
            a, b = max(0, cs.rpos), min(L, cs.rpos + cs.span)
            cover[a:b] += 1
        aln_bins = aset.aln_bins

        def select(fl, tl, fr, tr):
            sel_l = [cs for cs, j in expanded if fl <= aln_bins[j] <= tl]
            sel_r = [cs for cs, j in expanded if fr <= aln_bins[j] <= tr]
            return sel_l, sel_r

        return chimera_scan(aset.bin_bases, L, p, res, cover, select)


def assemble_consensus(
    rid, emitted, base, ins_len, ins_bases, freq, phred, coverage
) -> ConsensusResult:
    """Host assembly of one read's consensus call: emitted columns + inserted
    bases -> sequence/qual/freq arrays and the trace cigar (M per emitted
    column, +D per inserted base, I per dropped column — Sam::Seq trace
    semantics, Sam/Seq.pm:1625-1635)."""
    n = len(emitted)
    emit_counts = np.where(emitted, 1 + ins_len, 0)
    total = int(emit_counts.sum())
    seq = np.zeros(total, np.int8)
    quals = np.zeros(total, np.uint8)
    freqs = np.zeros(total, np.float32)
    # target offset of each column's first emitted base
    offs = np.concatenate([[0], np.cumsum(emit_counts)[:-1]])
    em = emitted.astype(bool)
    seq[offs[em]] = base[em]
    quals[offs[em]] = phred[em]
    freqs[offs[em]] = freq[em]
    ins_cols = np.flatnonzero(em & (ins_len > 0))
    for c in ins_cols:
        k = int(ins_len[c])
        o = int(offs[c]) + 1
        seq[o : o + k] = ins_bases[c, :k]
        quals[o : o + k] = phred[c]
        freqs[o : o + k] = freq[c]

    cigar_parts = []
    run_char, run_len = None, 0
    for c in range(n):
        chars = "I" if not em[c] else ("M" + "D" * int(ins_len[c]))
        for ch in chars:
            if ch == run_char:
                run_len += 1
            else:
                if run_char is not None:
                    cigar_parts.append(f"{run_len}{run_char}")
                run_char, run_len = ch, 1
    if run_char is not None:
        cigar_parts.append(f"{run_len}{run_char}")

    rec = SeqRecord(id=rid, seq=decode_codes(seq), qual=quals)
    return ConsensusResult(
        record=rec,
        freqs=freqs,
        coverage=coverage,
        cigar="".join(cigar_parts),
    )


def chimera_runs(bin_bases, L, params, cover) -> List[Tuple[int, ...]]:
    """Geometry stage of the chimera scan (Sam/Seq.pm:774-812): runs of 1-4
    low-fill bins away from the 5 terminal bins, fully covered, with their
    window/flank coordinates. Returns (mat_from, mat_to, fl, tl, fr, tr)
    per candidate breakpoint region."""
    p = params
    if bin_bases is None or len(bin_bases) <= 20:
        return []
    thr = p.bin_max_bases / 5 + 1

    raw = []
    lcov = 0
    for i in range(5, len(bin_bases) - 5):
        if bin_bases[i] <= thr:
            lcov += 1
        else:
            if 1 <= lcov < 5:
                raw.append((i - lcov, i - 1))
            lcov = 0

    bs = p.bin_size
    out = []
    for (r0, r1) in raw:
        mat_from = (r0 - 1) * bs
        mat_to = (r1 + 2) * bs - 1
        if mat_from < 0 or mat_to >= L:
            continue
        if np.any(cover[mat_from: mat_to + 1] == 0):
            continue
        fl, tr = r0 - 4, r1 + 5
        delta = (tr - fl - 1) // 2
        out.append((mat_from, mat_to, fl, fl + delta, tr - delta, tr))
    return out


def chimera_score(runs, counts_fn, res, L, params
                  ) -> List[Tuple[int, int, float]]:
    """Entropy stage (Sam/Seq.pm:844-888): per run, per-column entropy of
    the combined window minus the max flank entropy; score = fraction of
    columns with delta > 0.7. ``counts_fn(mat_from, Wn, fl, tl, fr, tr)``
    returns the ([Wn, S+1], [Wn, S+1]) left/right state-count matrices."""
    emit_counts_prefix = None
    out = []
    bs = params.bin_size
    for (mat_from, mat_to, fl, tl, fr, tr) in runs:
        Wn = mat_to + 1 - mat_from
        cl, cr = counts_fn(mat_from, Wn, fl, tl, fr, tr)
        hx_delta = []
        for c in range(Wn):
            lcol, rcol = cl[c], cr[c]
            if lcol.sum() == 0 or rcol.sum() == 0:
                continue
            hx_delta.append(_hx(lcol + rcol) - max(_hx(lcol), _hx(rcol)))
        if not hx_delta:
            continue
        score = float(np.mean(np.array(hx_delta) > 0.7))
        f, t = mat_from + bs, mat_to - bs
        if emit_counts_prefix is None:
            emit_counts_prefix = emit_prefix(res, L)
        out.append((int(emit_counts_prefix[f]), int(emit_counts_prefix[t]), score))
    return out


def chimera_scan(bin_bases, L, params, res, cover, select) -> List[Tuple[int, int, float]]:
    """Chimera core (Sam/Seq.pm:774-888) in terms of the two stages above.

    ``select(fl, tl, fr, tr)`` returns (left, right) lists of
    :class:`ColumnStates` for alignments whose bin falls in those ranges."""
    runs = chimera_runs(bin_bases, L, params, cover)
    if not runs:
        return []

    def counts_fn(mat_from, Wn, fl, tl, fr, tr):
        sel_l, sel_r = select(fl, tl, fr, tr)
        return (window_counts(sel_l, mat_from, Wn),
                window_counts(sel_r, mat_from, Wn))

    return chimera_score(runs, counts_fn, res, L, params)


def window_counts(sel: Sequence[ColumnStates], mat_from: int, Wn: int) -> np.ndarray:
    """[Wn, S+1] plain state counts + merged-insertion pseudo-state."""
    counts = np.zeros((Wn, N_STATES + 1), np.float64)
    for cs in sel:
        lo = max(cs.rpos, mat_from)
        hi = min(cs.rpos + cs.span, mat_from + Wn)
        if lo >= hi:
            continue
        w0, w1 = lo - cs.rpos, hi - cs.rpos
        cols = np.arange(lo - mat_from, hi - mat_from)
        st = cs.state[w0:w1].astype(np.int64)
        has_ins = cs.ins_len[w0:w1] > 0
        np.add.at(counts, (cols[~has_ins], st[~has_ins]), 1.0)
        np.add.at(counts, (cols[has_ins], np.full(has_ins.sum(), N_STATES)), 1.0)
    return counts


def emit_prefix(res: ConsensusResult, L: int) -> np.ndarray:
    """corrected-coordinate of each reference column (prefix sum of emitted
    base counts), recovered from the consensus cigar — or directly from
    ``emit_counts`` when the result carries it (device finish path)."""
    import re as _re

    ec = getattr(res, "emit_counts", None)
    if ec is not None:
        emit = np.zeros(L + 1, np.int64)
        n = min(len(ec), L)
        emit[1:n + 1] = np.cumsum(ec[:n])
        emit[n + 1:] = emit[n]
        return emit

    emit = np.zeros(L + 1, np.int64)
    col = 0
    pos_corr = 0
    for m in _re.finditer(r"(\d+)([MID])", res.cigar):
        ln, op = int(m.group(1)), m.group(2)
        if op == "M":
            for _ in range(ln):
                emit[col] = pos_corr
                pos_corr += 1
                col += 1
        elif op == "I":
            for _ in range(ln):
                emit[col] = pos_corr
                col += 1
        else:  # D: extra consensus bases, no ref column consumed
            pos_corr += ln
    emit[col:] = pos_corr
    return emit


def _hx(col: np.ndarray) -> float:
    """Shannon entropy over nonzero counts (Sam/Seq.pm:188-197)."""
    nz = col[col > 0]
    if nz.size == 0:
        return 0.0
    p = nz / nz.sum()
    return float(-(p * np.log2(p)).sum())
