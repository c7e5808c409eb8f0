"""Device-resident iterative correction: one pass, and passes 2..N.

Port of the main-path subset of ``proovread_tpu/pipeline/dcorrect.py``:

    masked codes -> k-mer index -> probe seeding -> bsw kernel
    -> threshold + binned admission -> packed votes -> pileup kernel
    -> consensus call -> assembly kernel -> HCR mask kernel

The fused ``lax.while_loop`` over passes 2..N becomes a host loop with the
same semantics: per-pass sampled query rows and mask parameters, the static
candidate cap of ``n_chunks * CH`` rows (candidates past it are truncated
and counted as dropped), and the f32 mask-shortcut decision
``frac > shortcut_frac | frac - frac_prev < min_gain``.

Each stage runs under a ``torch.profiler.record_function`` range (seed,
align, vote, consensus) so a profile attributes device time per layer.

The admission bin prefix sums are exact integer sums here; the reference
sums the spans in f32, which rounds once a pass's total span passes 2^24.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from proovread_tpu_torch.align import bsw, dseed
from proovread_tpu_torch.align.params import AlignParams
from proovread_tpu_torch.consensus.params import (NCSCORE_CONSTANT,
                                                  ConsensusParams)
from proovread_tpu_torch.ops.assemble_kernel import (assemble_rows,
                                                     hcr_mask_rows,
                                                     mask_params_vec)
from proovread_tpu_torch.ops.consensus_call import call_consensus
from proovread_tpu_torch.ops.encode import N, N_STATES
from proovread_tpu_torch.ops.fused import add_ref_votes
from proovread_tpu_torch.ops.pileup_kernel import pileup_accumulate_bits
from proovread_tpu_torch.ops.votes import (PACK_LANES,
                                           encode_votes_packed_bases,
                                           unpack_pileup, word_to_bits)


def device_revcomp(codes: torch.Tensor, lengths: torch.Tensor
                   ) -> torch.Tensor:
    """Per-row reverse complement, left-aligned (pad stays at the tail)."""
    B, m = codes.shape
    j = torch.arange(m, device=codes.device)[None, :]
    ln = lengths.to(torch.int64)[:, None]
    src = torch.clamp(ln - 1 - j, 0, m - 1)
    g = torch.gather(codes, 1, src)
    rc = torch.where(g < 4, 3 - g, g)
    return torch.where(j < ln, rc, 4).to(codes.dtype)


def device_admit(lread, pos0, span, score, passed, ref_lens,
                 params: ConsensusParams) -> torch.Tensor:
    """Binned admission (consensus/alnset.py:admit_mask semantics): per
    (read, bin), candidates ranked by ncscore, admitted while the bin's
    span budget before them is <= bin_max_bases."""
    R = lread.shape[0]
    dev = lread.device
    if R == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    f32 = torch.float32
    keep = passed & (span > 0)
    eff = -score if params.invert_scores else score
    spanf = span.to(f32)
    ncscore = torch.where(span > 0, eff / (NCSCORE_CONSTANT + spanf),
                          float("-inf"))
    if params.min_score is not None:
        keep &= eff >= params.min_score
    if params.min_nscore is not None:
        keep &= torch.where(span > 0, eff / torch.clamp(spanf, min=1.0),
                            float("-inf")) >= params.min_nscore
    if params.min_ncscore is not None:
        keep &= ncscore >= params.min_ncscore

    bs = params.bin_size
    n_bins = ref_lens.to(torch.int64) // bs + 1
    bin_of = ((pos0 + 1).to(f32) + spanf / 2) / bs
    bin_of = bin_of.to(torch.int64)                 # truncates, as astype
    lr = lread.to(torch.int64)
    bin_of = torch.minimum(torch.clamp(bin_of, min=0),
                           n_bins[torch.clamp(lr, min=0)] - 1)
    gbin = lr * n_bins.max() + bin_of
    primary = torch.where(keep, gbin, 1 << 30)

    # lexsort (primary, -ncscore, index): stable sorts, last key first
    order = torch.argsort(-ncscore, stable=True)
    order = order[torch.argsort(primary[order], stable=True)]
    sbins = primary[order]
    sspans = torch.where(keep, span.to(torch.int64), 0)[order]
    cum = torch.cumsum(sspans, 0)
    first = torch.searchsorted(sbins, sbins, side="left")
    before = torch.where(first > 0, cum[torch.clamp(first - 1, min=0)], 0)
    cum_before = cum - sspans - before
    admit = keep[order] & (cum_before <= params.bin_max_bases)
    out = torch.zeros(R, dtype=torch.bool, device=dev)
    out[order] = admit
    return out


def device_assemble(call, lengths, Lp: int):
    """Emitted columns + inserted bases -> new codes/qual/lengths."""
    return assemble_rows(call, lengths, Lp)


def device_hcr_mask(qual, lengths, p):
    """(mask bool [B, L], masked fraction) for static MaskParams ``p``."""
    return hcr_mask_rows(qual, lengths, mask_params_vec(p))


def pileup_fits(cns: ConsensusParams) -> bool:
    """The main path's pileup holds at most 2*max_coverage+2 votes per
    column lane; beyond 256 the reference switches to its f32 packed-word
    kernel, which the port does not have yet."""
    return 2 * cns.max_coverage + 2 <= 256


# --------------------------------------------------------------------------
# one correction pass
# --------------------------------------------------------------------------

@dataclass
class DevicePassStats:
    n_candidates: int = 0
    n_admitted: object = 0      # 0-dim tensors until the caller reads them
    n_eligible: object = 0


@dataclass
class AlnData:
    """Host view of the finish pass's candidates, for the chimera entropy
    scan (``bin/bam2cns:461-491``). The expanded column slabs stay on the
    device; ``prefetch`` pulls the needed rows in one transfer per chunk."""
    lread: np.ndarray
    pos0: np.ndarray
    span: np.ndarray
    admitted: np.ndarray
    vote_ok: np.ndarray
    q_start: np.ndarray
    q_end: np.ndarray
    win_start: np.ndarray
    r_start: np.ndarray
    r_end: np.ndarray
    cns: ConsensusParams
    chunks: list            # per live chunk: (state i8, qrow i16, ins_len i16)
    chunk_size: int
    sread: Optional[np.ndarray] = None
    strand: Optional[np.ndarray] = None
    score: Optional[np.ndarray] = None
    _rows: dict = field(default_factory=dict)

    def prefetch(self, cis) -> None:
        cis = [int(c) for c in cis if int(c) not in self._rows]
        by_chunk: dict = {}
        for ci in cis:
            by_chunk.setdefault(ci // self.chunk_size, []).append(ci)
        for ch, group in sorted(by_chunk.items()):
            st_d, qr_d, il_d = self.chunks[ch]
            idx = torch.as_tensor(np.asarray(group, np.int64)
                                  - ch * self.chunk_size, device=st_d.device)
            st, qr, il = (t[idx].cpu().numpy() for t in (st_d, qr_d, il_d))
            for j, ci in enumerate(group):
                self._rows[ci] = (st[j], qr[j], il[j])

    def window_counts(self, cis: np.ndarray, taboo_abs: int,
                      mat_from: int, Wn: int) -> np.ndarray:
        """[Wn, N_STATES+1] live-window state counts over the candidates;
        insertion-bearing columns count as the merged pseudo-state."""
        S1 = N_STATES + 1
        cis = np.asarray(cis, np.int64)
        if cis.size == 0:
            return np.zeros((Wn, S1), np.float64)
        self.prefetch(cis)
        st = np.stack([self._rows[int(c)][0] for c in cis])
        qr = np.stack([self._rows[int(c)][1] for c in cis])
        il = np.stack([self._rows[int(c)][2] for c in cis])
        aln_len = self.q_end[cis] - self.q_start[cis]
        if taboo_abs:
            taboo = np.full(cis.size, taboo_abs, np.int64)
        else:
            taboo = (aln_len * self.cns.indel_taboo + 0.5).astype(np.int64)
        col = self.win_start[cis][:, None] + np.arange(st.shape[1])
        live = ((st >= 0)
                & (qr >= (self.q_start[cis] + taboo)[:, None])
                & (qr < (self.q_end[cis] - taboo)[:, None])
                & (col >= mat_from) & (col < mat_from + Wn))
        cls = np.where(il > 0, N_STATES, st).astype(np.int64)
        idx = (col - mat_from) * S1 + cls
        flat = np.bincount(idx[live], minlength=Wn * S1)
        return flat.reshape(Wn, S1).astype(np.float64)


def detect_chimera_device(results, ref_lens: np.ndarray, aln: AlnData
                          ) -> None:
    """Chimera scan over the finish pass's admitted candidates (the
    reference's ``detect_chimera_device``): run geometry from host
    scalars, then window state counts over the slabs of the candidates
    whose bin falls inside a run window. Fills ``results[b].chimera``."""
    from proovread_tpu_torch.consensus.engine import (chimera_runs,
                                                      chimera_score)

    cns = aln.cns
    bs = cns.bin_size
    adm_idx = np.flatnonzero(aln.admitted & aln.vote_ok)
    if adm_idx.size == 0:
        return
    span, pos0 = aln.span, aln.pos0
    bins = np.clip(((pos0 + 1 + span / 2) // bs).astype(np.int64), 0, None)

    scans = []
    needed: List[np.ndarray] = []
    for b in range(len(results)):
        L_i = int(ref_lens[b])
        mine = adm_idx[aln.lread[adm_idx] == b]
        if mine.size == 0:
            continue
        n_bins = L_i // bs + 1
        if n_bins <= 20:
            continue
        bb = np.bincount(np.clip(bins[mine], 0, n_bins - 1),
                         weights=span[mine].astype(np.float64),
                         minlength=n_bins)
        if not (bb[5:-5] <= cns.bin_max_bases / 5 + 1).any():
            continue
        diff = np.zeros(L_i + 1)
        np.add.at(diff, np.clip(pos0[mine], 0, L_i), 1)
        np.add.at(diff, np.clip(pos0[mine] + span[mine], 0, L_i), -1)
        cover = np.cumsum(diff[:L_i])
        runs = chimera_runs(bb, L_i, cns, cover)
        if not runs:
            continue
        lo = min(r[2] for r in runs)
        hi = max(r[5] for r in runs)
        needed.append(mine[(bins[mine] >= lo) & (bins[mine] <= hi)])
        scans.append((b, L_i, mine, runs))
    if not scans:
        return
    aln.prefetch(np.concatenate(needed))

    taboo_abs = cns.indel_taboo_length or 0
    for b, L_i, mine, runs in scans:

        def counts_fn(mat_from, Wn, fl, tl, fr, tr, mine=mine):
            def side(f, t):
                cis = mine[(bins[mine] >= f) & (bins[mine] <= t)]
                return aln.window_counts(cis, taboo_abs, mat_from, Wn)
            return side(fl, tl), side(fr, tr)

        results[b].chimera = chimera_score(runs, counts_fn, results[b],
                                           L_i, cns)


def _fused_pass(map_codes, ignore_cols, codes, qual, lengths,
                q_codes, rc_codes, q_lengths,
                sread, strand, lread, diag, n_cand: int,
                m: int, W: int, CH: int, n_chunks: int,
                ap: AlignParams, cns: ConsensusParams, collect: bool):
    """One full correction pass over ``n_chunks`` chunks of CH candidate
    rows (the reference's ``_fused_pass_scanned``). Chunks that start at
    or past ``n_cand`` are dead: their rows carry the reference's dead-chunk
    values and are neither aligned nor voted."""
    if cns.qual_weighted:
        raise NotImplementedError(
            "qual-weighted voting (the reference's unrolled v1 path with "
            "pileup_accumulate) is not ported yet")
    if not pileup_fits(cns):
        raise NotImplementedError(
            f"max_coverage={cns.max_coverage} needs 2*max_coverage+2 > 256 "
            "votes per lane: the f32 pileup_accumulate_packed fallback is "
            "not ported yet")
    B, Lp = codes.shape
    dev = codes.device
    n = m + W
    pad = n
    Lpile = Lp + 2 * n
    taboo_frac = cns.indel_taboo if cns.trim else 0.0
    taboo_abs = (cns.indel_taboo_length or 0) if cns.trim else 0
    i32 = torch.int32

    map_pad = bsw.build_map_pad(map_codes, ignore_cols, n)
    qlen_all = q_lengths[sread.long()].to(i32)
    win_start_all, w0p_all = bsw.window_starts(diag, W, Lp, n)
    strand32 = strand.to(i32)

    n_live = min(n_chunks, -(-n_cand // CH))
    R_tot = n_chunks * CH
    passed = torch.zeros(R_tot, dtype=torch.bool, device=dev)
    pos0 = torch.zeros(R_tot, dtype=i32, device=dev)
    span = torch.zeros(R_tot, dtype=i32, device=dev)
    score = torch.full((R_tot,), -1e9, dtype=torch.float32, device=dev)
    qs_all = torch.zeros(R_tot, dtype=i32, device=dev)
    qe_all = torch.zeros(R_tot, dtype=i32, device=dev)
    rs_all = torch.zeros(R_tot, dtype=i32, device=dev)
    re_all = torch.zeros(R_tot, dtype=i32, device=dev)
    ws_all = torch.zeros(R_tot, dtype=i32, device=dev)
    words, slabs = [], []
    with record_function("align"):
        for c in range(n_live):
            sl = slice(c * CH, (c + 1) * CH)
            res = bsw.bsw_expand_v2(
                q_codes, rc_codes, map_pad, qlen_all[sl], sread[sl],
                strand32[sl], lread[sl], w0p_all[sl], ap)
            qlen_c = qlen_all[sl]
            thr = (ap.min_out_score * qlen_c.to(torch.float32)
                   if ap.score_per_base else ap.min_out_score)
            live_m = (c * CH + torch.arange(CH, device=dev)) < n_cand
            passed[sl] = res.valid & (res.score >= thr) & live_m
            pos0[sl] = win_start_all[sl] + res.r_start
            span[sl] = res.r_end - res.r_start
            score[sl] = res.score
            qs_all[sl], qe_all[sl] = res.q_start, res.q_end
            rs_all[sl], re_all[sl] = res.r_start, res.r_end
            ws_all[sl] = win_start_all[sl]
            words.append(encode_votes_packed_bases(
                res.state, res.qrow, res.ins_len, res.ins_b0, res.ins_b1,
                res.q_start, res.q_end, taboo_frac=taboo_frac,
                taboo_abs=taboo_abs, min_aln_length=cns.min_aln_length))
            if collect:
                slabs.append((res.state.to(torch.int8),
                              res.qrow.to(torch.int16),
                              res.ins_len.to(torch.int16)))

    with record_function("vote"):
        admitted = device_admit(lread, pos0, span, score, passed, lengths, cns)
        pileup = torch.zeros((B, Lpile, PACK_LANES), dtype=torch.float32,
                             device=dev)
        for c in range(n_live):
            sl = slice(c * CH, (c + 1) * CH)
            w = torch.where(admitted[sl][:, None], words[c], 0)
            b0, b1 = word_to_bits(w)
            w0p = torch.clamp(win_start_all[sl] + pad, 0, Lpile - n).to(i32)
            pileup_accumulate_bits(pileup, b0, b1, lread[sl].to(i32), w0p)

    with record_function("consensus"):
        pile = unpack_pileup(pileup, pad, Lp)
        if cns.use_ref_qual:
            pos = torch.arange(Lp, device=dev)[None, :]
            lmask = (pos < lengths[:, None]).to(torch.float32)
            pile = add_ref_votes(pile, codes, qual.to(torch.float32), lmask)
        call = call_consensus(pile, codes, cns.max_ins_length)
    n_admitted = admitted.sum()
    n_eligible = (passed & (span > 0)).sum()
    if not collect:
        return call, n_admitted, n_eligible, None, None
    scalars = (lread, pos0, span, admitted, qs_all, qe_all, ws_all, rs_all,
               re_all, sread, strand, score)
    return call, n_admitted, n_eligible, scalars, slabs


def _pad_candidates(sread, strand, lread, diag, R_need: int):
    """Pad (repeating the last lread, so read order stays sorted) or cut
    the compacted candidate arrays to exactly ``R_need`` rows."""
    R0 = sread.shape[0]
    if R_need > R0:
        padn = R_need - R0

        def z(t):
            return torch.zeros(padn, dtype=t.dtype, device=t.device)
        sread = torch.cat([sread, z(sread)])
        strand = torch.cat([strand, z(strand)])
        lread = torch.cat([lread, lread[-1:].expand(padn)])
        diag = torch.cat([diag, z(diag)])
    return sread[:R_need], strand[:R_need], lread[:R_need], diag[:R_need]


def _bucket_chunks(need: int) -> int:
    """Smallest {2^k, 3*2^(k-1)} ladder value >= need
    (1,2,3,4,6,8,12,16,24,...)."""
    p = 1
    while True:
        if need <= p:
            return p
        if p >= 2 and need <= p + p // 2:
            return p + p // 2
        p *= 2


def _seed(map_codes, lengths, q_codes, q_lengths, rc_codes, ap, stride,
          min_votes):
    with record_function("seed"):
        index = dseed.build_index(map_codes, lengths, ap.min_seed_len)
        cand = dseed.probe_candidates(index, q_codes, q_lengths, rc_codes,
                                      ap, stride=stride, min_votes=min_votes)
        return dseed.compact_candidates(cand)


class DeviceCorrector:
    """Chunked device correction over one long-read batch state."""

    def __init__(self, chunk: int = 8192):
        if chunk % 128:
            raise ValueError(f"chunk {chunk} must be a multiple of 128")
        self.chunk = chunk

    def correct_pass(self, codes, qual, lengths, mask_cols,
                     q_codes, rc_codes, q_qual, q_lengths,
                     ap: AlignParams, cns: ConsensusParams,
                     use_mask_as_ignore: bool = True,
                     seed_stride: int = 8, seed_min_votes: int = 2,
                     collect_aln: bool = False):
        """One correction pass with a chunk count sized from this pass's
        candidate count (``q_qual`` is unused by the unweighted path)."""
        B, Lp = codes.shape
        m = q_codes.shape[1]
        W = bsw.band_lanes(ap)
        map_codes = (torch.where(mask_cols, N, codes).to(codes.dtype)
                     if mask_cols is not None else codes)
        sread, strand, lread, diag, n_valid = _seed(
            map_codes, lengths, q_codes, q_lengths, rc_codes, ap,
            seed_stride, seed_min_votes)
        n_cand = int(n_valid)
        ignore_cols = (mask_cols if use_mask_as_ignore and mask_cols
                       is not None else None)
        CH = self.chunk
        n_chunks = _bucket_chunks(max(1, -(-n_cand // CH)))
        R_need = n_chunks * CH
        sread, strand, lread, diag = _pad_candidates(sread, strand, lread,
                                                     diag, R_need)
        call, n_adm, n_elig, scalars, slabs = _fused_pass(
            map_codes, ignore_cols, codes, qual, lengths, q_codes, rc_codes,
            q_lengths, sread, strand, lread, diag, n_cand, m=m, W=W, CH=CH,
            n_chunks=n_chunks, ap=ap, cns=cns, collect=collect_aln)
        stats = DevicePassStats(n_candidates=n_cand, n_admitted=n_adm,
                                n_eligible=n_elig)
        if not collect_aln:
            return call, stats

        (h_lread, h_pos0, h_span, h_adm, h_qs, h_qe, h_ws, h_rs, h_re,
         h_sread, h_strand, h_score) = (t.cpu().numpy() for t in scalars)
        aln_len = h_qe - h_qs
        if cns.indel_taboo_length:
            taboo = np.full(R_need, cns.indel_taboo_length, np.int32)
        else:
            taboo = np.floor(aln_len * cns.indel_taboo + 0.5).astype(np.int32)
        kept = (h_qe - taboo) - (h_qs + taboo)
        vote_ok = ((aln_len > cns.min_aln_length)
                   & (kept >= cns.min_aln_length)
                   & (kept >= 0.7 * aln_len))
        aln = AlnData(
            lread=h_lread, pos0=h_pos0, span=h_span, admitted=h_adm,
            vote_ok=vote_ok, q_start=h_qs, q_end=h_qe, win_start=h_ws,
            r_start=h_rs, r_end=h_re, cns=cns, chunks=slabs,
            chunk_size=CH, sread=h_sread, strand=h_strand, score=h_score)
        return call, stats, aln


@dataclass
class FusedResult:
    """Read state after passes 2..N plus per-pass KPIs (run passes only)."""
    codes: torch.Tensor
    qual: torch.Tensor
    lengths: torch.Tensor
    mask_cols: torch.Tensor
    fracs: List[float]
    ncands: List[int]
    nadms: List[int]
    neligs: List[int]
    ndrops: List[int]
    shortcut: bool


def fused_iterations(codes, qual, lengths, mask_cols, frac_prev: float,
                     sr_codes, sr_rc, sr_qual, sr_lengths,
                     sels: Optional[np.ndarray], mask_pvs: np.ndarray,
                     m: int, W: int, CH: int, n_chunks: int,
                     ap: AlignParams, cns: ConsensusParams, n_rest: int,
                     Lp: int, seed_stride: int, seed_min_votes: int,
                     shortcut_frac: float, min_gain: float
                     ) -> FusedResult:
    """Passes 2..N with the reference's ``fused_iterations`` semantics.

    ``sels``: i32 [n_rest, Rsel] sampled short-read rows per pass (pad rows
    point at the zero-length sentinel read), or None when every pass uses
    the whole set. ``mask_pvs``: f32 [n_rest, 6] per-pass HCR mask params.
    Each pass reads the candidate count on the host (the chunk loop length);
    the shortcut test is the reference's f32 arithmetic."""
    dev = codes.device
    fracs, ncands, nadms, neligs, ndrops = [], [], [], [], []
    frac_prev32 = np.float32(frac_prev)
    done = False
    it = 0
    R_need = n_chunks * CH
    while it < n_rest and not done:
        if sels is None:
            qc, rcq, qlen = sr_codes, sr_rc, sr_lengths
        else:
            sel = torch.as_tensor(sels[it], dtype=torch.int64, device=dev)
            qc, rcq, qlen = sr_codes[sel], sr_rc[sel], sr_lengths[sel]
        map_codes = torch.where(mask_cols, N, codes).to(codes.dtype)
        sread, strand, lread, diag, n_valid = _seed(
            map_codes, lengths, qc, qlen, rcq, ap, seed_stride,
            seed_min_votes)
        sread, strand, lread, diag = _pad_candidates(sread, strand, lread,
                                                     diag, R_need)
        n_valid = int(n_valid)
        n_cand = min(n_valid, R_need)
        call, n_adm, n_elig, _, _ = _fused_pass(
            map_codes, mask_cols, codes, qual, lengths, qc, rcq, qlen,
            sread, strand, lread, diag, n_cand, m=m, W=W, CH=CH,
            n_chunks=n_chunks, ap=ap, cns=cns, collect=False)
        codes, qual, lengths = assemble_rows(call, lengths, Lp)
        mask_cols, frac = hcr_mask_rows(qual, lengths, mask_pvs[it])
        frac32 = np.float32(frac.item())
        gain = np.float32(frac32 - frac_prev32)
        done = bool((frac32 > np.float32(shortcut_frac))
                    | (gain < np.float32(min_gain)))
        fracs.append(float(frac32))
        ncands.append(n_cand)
        nadms.append(int(n_adm))
        neligs.append(int(n_elig))
        ndrops.append(max(n_valid - R_need, 0))
        frac_prev32 = frac32
        it += 1
    return FusedResult(codes, qual, lengths, mask_cols, fracs, ncands, nadms,
                       neligs, ndrops, done)
