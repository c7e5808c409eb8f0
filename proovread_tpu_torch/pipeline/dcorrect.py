"""Device-resident iterative correction: one pass, and passes 2..N.

Port of ``proovread_tpu/pipeline/dcorrect.py`` (device engine, no flex):

    masked codes -> k-mer index -> probe seeding -> bsw kernel
    -> threshold + binned admission -> votes -> pileup kernel
    -> consensus call -> assembly kernel -> HCR mask kernel

Unweighted votes take the reference's scanned pass: bsw v2, packed vote
words, and the bit-plane pileup kernel, or the packed-word kernel when a
lane can collect more than 256 votes (``2*max_coverage+2 > 256``).
Qual-weighted votes take its unrolled pass: gathered query/qual/window
slabs, bsw v1, dense phred-weighted vote slabs and the ordered pileup
kernel.

The fused ``lax.while_loop`` over passes 2..N becomes a host loop with the
same semantics: per-pass sampled query rows and mask parameters, the static
candidate cap of ``n_chunks * CH`` rows (candidates past it are truncated
and counted as dropped), and the f32 mask-shortcut decision
``frac > shortcut_frac | frac - frac_prev < min_gain``.

Each stage runs under a ``torch.profiler.record_function`` range (seed,
align, vote, consensus) so a profile attributes device time per layer;
``correct_pass`` also opens the reference's ``seed`` and ``consense``
spans (``obs.trace``), which fence their outputs only while tracing.

The per-read QC reductions (``qc_*``) run only while a QC recorder is
installed (``obs.qc``): with QC off a pass runs no extra device work and
no extra synchronization.

The admission bin prefix sums are the reference's f32 sums in XLA's CPU
order (``ops/scan.py``): once a pass's total span passes 2^24 they round,
and the port rounds as the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from proovread_tpu_torch import obs
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
from proovread_tpu_torch.ops.pileup_kernel import (pileup_accumulate,
                                                   pileup_accumulate_bits,
                                                   pileup_accumulate_packed)
from proovread_tpu_torch.ops.scan import cumsum_f32_xla
from proovread_tpu_torch.ops.votes import (PACK_LANES, build_votes,
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


def device_reverse_rows(x: torch.Tensor, lengths: torch.Tensor
                        ) -> torch.Tensor:
    """Reverse each row's first lengths[i] entries (the rest stay)."""
    B, m = x.shape
    j = torch.arange(m, device=x.device)[None, :]
    ln = lengths.to(torch.int64)[:, None]
    out = torch.gather(x, 1, torch.clamp(ln - 1 - j, 0, m - 1))
    return torch.where(j < ln, out, x)


def admit_prefix(sspans, sbins, lr_sorted):
    """The admission's span sums over the candidates in admission order
    (``sspans``, kept candidates first, grouped by (read, bin) ``sbins``;
    ``lr_sorted`` their reads): each one's inclusive f32 prefix sum and
    the sum before its bin. The reference's f32 sums in its order
    (``ops/scan.py``): past 2^24 summed bases they round, so a sum depends
    on every candidate before it, of every read of the batch."""
    cum = cumsum_f32_xla(sspans)
    first = torch.searchsorted(sbins, sbins, side="left")
    before = torch.where(first > 0, cum[torch.clamp(first - 1, min=0)], 0.0)
    return cum, before


def device_admit(lread, pos0, span, score, passed, ref_lens,
                 params: ConsensusParams,
                 budget_r: Optional[torch.Tensor] = None,
                 prefix=admit_prefix) -> torch.Tensor:
    """Binned admission (consensus/alnset.py:admit_mask semantics): per
    (read, bin), candidates ranked by ncscore, admitted while the bin's
    span budget before them is <= bin_max_bases. The span sums are the
    reference's f32 prefix sums in its order (``admit_prefix``), so past
    2^24 summed bases they round as the reference's do; a mesh's shard
    passes ``prefix`` to sum its candidates where the whole batch's would
    (``parallel/dmesh.py``). ``budget_r`` (f32 [B]) caps the budget per
    read: flex mode's filter_by_coverage (Sam/Seq.pm:1059-1084) expressed
    in the admission budget."""
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
    sspans = torch.where(keep, spanf, 0.0)[order]
    cum, before = prefix(sspans, sbins, lr[order])
    cum_before = (cum - sspans) - before
    if budget_r is None:
        budget = float(params.bin_max_bases)  # static-ok: host param
    else:
        budget = torch.minimum(
            budget_r[torch.clamp(lr, min=0)],
            torch.tensor(float(params.bin_max_bases),  # static-ok: param
                         dtype=f32,
                         device=dev))[order]
    admit = keep[order] & (cum_before <= budget)
    out = torch.zeros(R, dtype=torch.bool, device=dev)
    out[order] = admit
    return out


def estimate_haplo_coverage(plain_counts, ins_mbase, coverage, ref_codes,
                            lengths) -> torch.Tensor:
    """``Sam::Seq::haplo_coverage`` (Sam/Seq.pm:1136-1172) on the pileup
    tensors: variant columns have >= 2 single-base A/C/G/T states at freq
    >= 4 and no qualifying non-ATGC or composite (insertion) state; each
    gives the freq of the state that agrees with the read's own base (0
    when that base does not qualify). The estimate is the 75th percentile
    of those (sorted, index ``((n_sel - 1) * 3) // 4``). It stands when
    (#variant cols / #cols with coverage >= 1.5x estimate) > 0.00015, in
    f32 as the reference divides. Returns f32 [B], +inf where there is no
    significant estimate (no tightening)."""
    B, L, S = plain_counts.shape
    dev = plain_counts.device
    base_counts = plain_counts[:, :, :4]
    valid = (torch.arange(L, device=dev)[None, :]
             < lengths.to(torch.int64)[:, None])
    n_qual = (base_counts >= 4.0).sum(-1)
    # a qualifying N/gap or composite state disqualifies the whole column
    bad = ((plain_counts[:, :, 4:].amax(-1) >= 4.0)
           | (ins_mbase.amax(-1) >= 4.0))
    rc = ref_codes.to(torch.int64).clamp(0, 3)
    fc = torch.gather(base_counts, 2, rc[:, :, None])[:, :, 0]
    sel = valid & ~bad & (n_qual >= 2)
    fc_eff = torch.where((ref_codes < 4) & (fc >= 4.0), fc, 0.0)
    inf = float("inf")
    svals = torch.sort(torch.where(sel, fc_eff, inf), dim=1).values
    n_sel = sel.sum(1)
    q_idx = torch.where(n_sel > 0, ((n_sel - 1) * 3) // 4, 0)
    hpl = torch.gather(svals, 1, q_idx[:, None])[:, 0]
    high = (valid & (coverage >= 1.5 * hpl[:, None])).sum(1)
    df = n_sel.to(torch.float32) / torch.clamp(high, min=1).to(torch.float32)
    ok = (n_sel > 0) & (high > 0) & (df > 0.00015)
    return torch.where(ok, hpl, inf)


def device_assemble(call, lengths, Lp: int):
    """Emitted columns + inserted bases -> new codes/qual/lengths."""
    return assemble_rows(call, lengths, Lp)


def device_hcr_mask(qual, lengths, p):
    """(mask bool [B, L], masked fraction) for static MaskParams ``p``."""
    return hcr_mask_rows(qual, lengths, mask_params_vec(p))


# --------------------------------------------------------------------------
# per-read QC reductions (obs/qc.py): row reductions of tensors a pass
# already produced, run only while a QC recorder is installed; integer
# results (or integer-valued f32 sums) so the records are the reference's
# --------------------------------------------------------------------------

def qc_row_mask_counts(mask_cols: torch.Tensor) -> torch.Tensor:
    """i32 [B]: HCR-masked columns per read (the numerator of the
    masked-fraction trajectory; the host divides)."""
    return mask_cols.sum(dim=1).to(torch.int32)


def qc_pass_row_stats(call, codes: torch.Tensor, qual: torch.Tensor,
                      lengths: torch.Tensor):
    """Per-read correction deltas of one pass against its input state:
    ``edits`` i32 [B], substituted (emitted base != input base) + inserted
    (ins_len of emitted columns) + deleted (valid columns not emitted)
    bases; ``uplift`` i32 [B], emitted columns whose called phred exceeds
    the input phred. ``call`` is indexed by the pass's input columns."""
    L = codes.shape[1]
    pos = torch.arange(L, device=codes.device)[None, :]
    valid = pos < lengths[:, None]
    em = call.emitted & valid
    subs = (em & (call.base != codes)).sum(dim=1)
    ins = torch.where(em, call.ins_len, 0).sum(dim=1)
    dels = (valid & ~call.emitted).sum(dim=1)
    uplift = (em & (call.phred > qual.to(torch.int32))).sum(dim=1)
    return (subs + ins + dels).to(torch.int32), uplift.to(torch.int32)


def qc_finish_support(call, lengths: torch.Tensor) -> torch.Tensor:
    """f32 [B]: summed finish-pass column coverage per read. The finish
    pass votes unweighted, so coverage is integer-valued and the f32 sum
    is exact, in any order of adds, while a read's total stays below 2^24
    (49,152 columns of 300 votes do); the reference sums the same way.
    The host divides by the column count."""
    L = call.coverage.shape[1]
    pos = torch.arange(L, device=lengths.device)[None, :]
    valid = pos < lengths[:, None]
    return torch.where(valid, call.coverage, 0.0).sum(dim=1)


def bits_pileup(cns: ConsensusParams) -> bool:
    """Whether the unweighted pass takes the bit-plane pileup kernel. A
    column lane can collect up to 2*max_coverage+2 votes (admission bins by
    midpoint, plus the ref vote); past 256 the reference's bf16 bits buffer
    would round, so it takes the f32 packed-word kernel, and so does the
    port."""
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
        """Bring the slab rows of candidates ``cis`` to the host: the three
        fields of every row, from every chunk, in one transfer."""
        cis = [int(c) for c in cis if int(c) not in self._rows]
        by_chunk: dict = {}
        for ci in cis:
            by_chunk.setdefault(ci // self.chunk_size, []).append(ci)
        if not by_chunk:
            return
        parts, order = [], []
        for ch, group in sorted(by_chunk.items()):
            st_d, qr_d, il_d = self.chunks[ch]
            idx = torch.as_tensor(np.asarray(group, np.int64)
                                  - ch * self.chunk_size, device=st_d.device)
            parts.append(torch.stack(
                [st_d[idx].to(torch.int16), qr_d[idx], il_d[idx]], 1))
            order.extend(group)
        rows = torch.cat(parts).cpu().numpy()          # [n, 3, W] int16
        st = rows[:, 0].astype(np.int8)
        for j, ci in enumerate(order):
            self._rows[ci] = (st[j], rows[j, 1], rows[j, 2])

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


def dump_admitted_sam(aln: AlnData, path: str, lr_ids, lr_lens,
                      sr_ids, sr_lens, sel: np.ndarray) -> int:
    """Debug dump of exactly the finish pass's admitted alignments as SAM —
    the role of bam2cns --debug's filtered BAM (bin/bam2cns:271-295).
    CIGARs are rebuilt from the expanded state slabs (M/D per live column,
    I per insertion run, soft clips from the aligned query interval); SEQ
    is omitted ('*'). ``sel`` maps slab query rows back to short-read
    indices. The slab rows come to the host in one transfer."""
    from proovread_tpu_torch.io.sam import SamAlignment, SamHeader, SamWriter
    from proovread_tpu_torch.ops.encode import GAP

    use = np.flatnonzero(aln.admitted & aln.vote_ok)
    aln.prefetch(use)
    hdr = SamHeader()
    for rid, ln in zip(lr_ids, lr_lens):
        hdr.add_ref(rid, int(ln))
    n = 0
    with SamWriter(path, header=hdr) as w:
        for ci in use:
            ci = int(ci)
            st, qr, il = aln._rows[ci]
            a, b = int(aln.r_start[ci]), int(aln.r_end[ci])
            ops = []
            for col in range(a, b):
                if st[col] < 0:
                    continue
                if st[col] == GAP:
                    ops.append("D")
                else:
                    ops.append("M")
                    ops.extend("I" * int(il[col]))
            if not ops:
                continue
            cig_parts = []
            k = 0
            while k < len(ops):
                j = k
                while j < len(ops) and ops[j] == ops[k]:
                    j += 1
                cig_parts.append(f"{j - k}{ops[k]}")
                k = j
            row = int(aln.sread[ci]) if aln.sread is not None else -1
            sid = (sr_ids[int(sel[row])]
                   if 0 <= row < len(sel) else f"q{row}")
            qs, qe = int(aln.q_start[ci]), int(aln.q_end[ci])
            qlen = (int(sr_lens[int(sel[row])])
                    if 0 <= row < len(sel) else qe)
            head = f"{qs}S" if qs else ""
            tail = f"{qlen - qe}S" if qlen - qe > 0 else ""
            strand = int(aln.strand[ci]) if aln.strand is not None else 0
            rec = SamAlignment(
                qname=sid, flag=0x10 if strand else 0,
                rname=lr_ids[int(aln.lread[ci])],
                pos=int(aln.pos0[ci]), mapq=255,
                cigar=head + "".join(cig_parts) + tail,
                seq="*", qual="*")
            if aln.score is not None:
                rec.tags["AS"] = ("i", int(aln.score[ci]))
            w.write(rec)
            n += 1
    return n


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


@obs.profile.attributed("fused_pass")
def _fused_pass(map_codes, ignore_cols, codes, qual, lengths,
                q_codes, rc_codes, q_qual, q_lengths,
                sread, strand, lread, diag, n_cand: int,
                m: int, W: int, CH: int, n_chunks: int,
                ap: AlignParams, cns: ConsensusParams, collect: bool,
                budget_r=None, haplo: bool = False, prefix=admit_prefix):
    """One full correction pass over ``n_chunks`` chunks of CH candidate
    rows: the reference's unrolled pass for qual-weighted votes, else its
    scanned pass. Chunks that start at or past ``n_cand`` are dead: their
    rows carry the reference's dead-chunk values and are neither aligned
    nor voted. ``budget_r`` caps the admission budget per read; ``haplo``
    also returns the flex estimate (``estimate_haplo_coverage``) from the
    pileup before the ref votes (the last of six outputs, else None);
    ``prefix`` is the admission's span sums (``device_admit``)."""
    impl = _fused_pass_unrolled if cns.qual_weighted else _fused_pass_scanned
    return impl(map_codes, ignore_cols, codes, qual, lengths, q_codes,
                rc_codes, q_qual, q_lengths, sread, strand, lread, diag,
                n_cand, m=m, W=W, CH=CH, n_chunks=n_chunks, ap=ap, cns=cns,
                collect=collect, budget_r=budget_r, haplo=haplo,
                prefix=prefix)


class _PassRows:
    """Per-candidate scalars of a pass, dead-chunk values by default."""

    def __init__(self, R_tot: int, dev):
        i32 = torch.int32

        def z():
            return torch.zeros(R_tot, dtype=i32, device=dev)
        self.passed = torch.zeros(R_tot, dtype=torch.bool, device=dev)
        self.score = torch.full((R_tot,), -1e9, dtype=torch.float32,
                                device=dev)
        self.pos0, self.span, self.ws = z(), z(), z()
        self.qs, self.qe, self.rs, self.re = z(), z(), z(), z()

    def set(self, sl, res, win_start, passed):
        self.passed[sl] = passed
        self.pos0[sl] = win_start + res.r_start
        self.span[sl] = res.r_end - res.r_start
        self.score[sl] = res.score
        self.qs[sl], self.qe[sl] = res.q_start, res.q_end
        self.rs[sl], self.re[sl] = res.r_start, res.r_end
        self.ws[sl] = win_start

    def finish(self, codes, qual, lengths, pileup, pad, lread, sread, strand,
               admitted, cns, collect, slabs, haplo=False):
        """Consensus over the pileup, and the pass's outputs."""
        Lp = codes.shape[1]
        hpl = None
        with record_function("consensus"):
            pile = unpack_pileup(pileup, pad, Lp)
            if haplo:
                # flex mode: the read's own-haplotype coverage, from the
                # pileup before the ref votes
                hpl = estimate_haplo_coverage(
                    pile.counts - pile.ins_mbase, pile.ins_mbase,
                    pile.coverage, codes, lengths)
            if cns.use_ref_qual:
                pos = torch.arange(Lp, device=codes.device)[None, :]
                lmask = (pos < lengths[:, None]).to(torch.float32)
                pile = add_ref_votes(pile, codes, qual.to(torch.float32),
                                     lmask)
            call = call_consensus(pile, codes, cns.max_ins_length)
        n_admitted = admitted.sum()
        n_eligible = (self.passed & (self.span > 0)).sum()
        if not collect:
            return call, n_admitted, n_eligible, None, None, hpl
        scalars = (lread, self.pos0, self.span, admitted, self.qs, self.qe,
                   self.ws, self.rs, self.re, sread, strand, self.score)
        return call, n_admitted, n_eligible, scalars, slabs, hpl


def _threshold(ap: AlignParams, res, qlen):
    thr = (ap.min_out_score * qlen.to(torch.float32)
           if ap.score_per_base else ap.min_out_score)
    return res.valid & (res.score >= thr)


def _fused_pass_scanned(map_codes, ignore_cols, codes, qual, lengths,
                        q_codes, rc_codes, q_qual, q_lengths,
                        sread, strand, lread, diag, n_cand: int,
                        m: int, W: int, CH: int, n_chunks: int,
                        ap: AlignParams, cns: ConsensusParams,
                        collect: bool, budget_r=None, haplo: bool = False,
                        prefix=admit_prefix):
    """Unweighted votes (the reference's ``_fused_pass_scanned``): bsw v2
    per chunk, admission over the pass, then packed vote words into the
    bit-plane or the packed-word pileup kernel."""
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
    rows = _PassRows(n_chunks * CH, dev)
    words, slabs = [], []
    with record_function("align"):
        for c in range(n_live):
            sl = slice(c * CH, (c + 1) * CH)
            res = bsw.bsw_expand_v2(
                q_codes, rc_codes, map_pad, qlen_all[sl], sread[sl],
                strand32[sl], lread[sl], w0p_all[sl], ap)
            live_m = (c * CH + torch.arange(CH, device=dev)) < n_cand
            rows.set(sl, res, win_start_all[sl],
                     _threshold(ap, res, qlen_all[sl]) & live_m)
            words.append(encode_votes_packed_bases(
                res.state, res.qrow, res.ins_len, res.ins_b0, res.ins_b1,
                res.q_start, res.q_end, taboo_frac=taboo_frac,
                taboo_abs=taboo_abs, min_aln_length=cns.min_aln_length))
            if collect:
                slabs.append((res.state.to(torch.int8),
                              res.qrow.to(torch.int16),
                              res.ins_len.to(torch.int16)))

    with record_function("vote"):
        admitted = device_admit(lread, rows.pos0, rows.span, rows.score,
                                rows.passed, lengths, cns, budget_r,
                                prefix)
        pileup = torch.zeros((B, Lpile, PACK_LANES), dtype=torch.float32,
                             device=dev)
        use_bits = bits_pileup(cns)
        for c in range(n_live):
            sl = slice(c * CH, (c + 1) * CH)
            w = torch.where(admitted[sl][:, None], words[c], 0)
            w0p = torch.clamp(win_start_all[sl] + pad, 0, Lpile - n).to(i32)
            if use_bits:
                b0, b1 = word_to_bits(w)
                pileup_accumulate_bits(pileup, b0, b1, lread[sl].to(i32), w0p)
            else:
                pileup_accumulate_packed(pileup, w, lread[sl].to(i32), w0p)
    return rows.finish(codes, qual, lengths, pileup, pad, lread, sread,
                       strand, admitted, cns, collect, slabs, haplo)


@obs.profile.attributed("gather_and_align")
def _gather_and_align(map_codes, ignore_cols, q_codes, rc_codes, q_qual,
                      q_lengths, sread, strand, lread, diag,
                      m: int, W: int, ap: AlignParams):
    """One chunk of the qual-weighted pass (the reference's
    ``_gather_and_align``): gather the strand-oriented query, qual and
    window slabs, run bsw v1. Returns (bsw result, query i8 [CH, m], qual
    u8 [CH, m], window start, ignored columns bool [CH, n] or None)."""
    L = map_codes.shape[1]
    n = m + W
    sr = sread.long()
    fwd = (strand == 0)[:, None]
    q = torch.where(fwd, q_codes[sr], rc_codes[sr]).to(torch.int8)
    qlen = q_lengths[sr].to(torch.int32)
    qual_f = q_qual[sr]
    qual = torch.where(fwd, qual_f, device_reverse_rows(qual_f, qlen))
    win_start = (diag - W // 2) & ~15
    idx = win_start.to(torch.int64)[:, None] + torch.arange(
        n, device=diag.device)[None, :]
    inb = (idx >= 0) & (idx < L)
    lr = lread.long()[:, None]
    col = torch.clamp(idx, 0, L - 1)
    win = torch.where(inb, map_codes[lr, col], 4).to(torch.int8)
    res = bsw.bsw_expand(q, win, qlen, ap)
    ign = (torch.where(inb, ignore_cols[lr, col], False)
           if ignore_cols is not None else None)
    return res, q, qual, qlen, win_start.to(torch.int32), ign


def _fused_pass_unrolled(map_codes, ignore_cols, codes, qual, lengths,
                         q_codes, rc_codes, q_qual, q_lengths,
                         sread, strand, lread, diag, n_cand: int,
                         m: int, W: int, CH: int, n_chunks: int,
                         ap: AlignParams, cns: ConsensusParams,
                         collect: bool, budget_r=None, haplo: bool = False,
                         prefix=admit_prefix):
    """Qual-weighted votes (the reference's ``_fused_pass_unrolled``): per
    chunk gather + bsw v1 (chunk 0 always, later chunks while they hold a
    candidate), admission over the pass, then per live chunk a dense
    phred-weighted vote slab added by the ordered pileup kernel. Each slab
    ([CH, n, 64] f32) lives only while its chunk is voted."""
    B, Lp = codes.shape
    dev = codes.device
    n = m + W
    pad = n
    Lpile = Lp + 2 * n
    taboo_frac = cns.indel_taboo if cns.trim else 0.0
    taboo_abs = (cns.indel_taboo_length or 0) if cns.trim else 0
    i32 = torch.int32

    n_live = max(1, min(n_chunks, -(-n_cand // CH)))
    rows = _PassRows(n_chunks * CH, dev)
    chunks, slabs = [], []
    with record_function("align"):
        for c in range(n_live):
            sl = slice(c * CH, (c + 1) * CH)
            res, q, qq, qlen, win_start, ign = _gather_and_align(
                map_codes, ignore_cols, q_codes, rc_codes, q_qual,
                q_lengths, sread[sl], strand[sl], lread[sl], diag[sl],
                m=m, W=W, ap=ap)
            live_m = (c * CH + torch.arange(CH, device=dev)) < n_cand
            rows.set(sl, res, win_start, _threshold(ap, res, qlen) & live_m)
            st = res.state.to(torch.int8)
            qr = res.qrow.to(torch.int16)
            il = res.ins_len.to(torch.int16)
            chunks.append((st, qr, il, res.q_start, res.q_end, q, qq, ign))
            if collect:
                slabs.append((st, qr, il))

    with record_function("vote"):
        admitted = device_admit(lread, rows.pos0, rows.span, rows.score,
                                rows.passed, lengths, cns, budget_r,
                                prefix)
        pileup = torch.zeros((B, Lpile, PACK_LANES), dtype=torch.float32,
                             device=dev)
        for c, (st, qr, il, qs, qe, q, qq, ign) in enumerate(chunks):
            sl = slice(c * CH, (c + 1) * CH)
            votes = build_votes(
                st, qr, il, q, qq, qs, qe, admitted[sl], ignore_cols=ign,
                qual_weighted=True, taboo_frac=taboo_frac,
                taboo_abs=taboo_abs, min_aln_length=cns.min_aln_length)
            w0p = torch.clamp(rows.ws[sl] + pad, 0, Lpile - n).to(i32)
            pileup_accumulate(pileup, votes, lread[sl].to(i32), w0p)
            del votes
    return rows.finish(codes, qual, lengths, pileup, pad, lread, sread,
                       strand, admitted, cns, collect, slabs, haplo)


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
                     collect_aln: bool = False, budget_r=None,
                     haplo: bool = False):
        """One correction pass with a chunk count sized from this pass's
        candidate count (``q_qual``, the short reads' phreds, weights the
        votes of a qual-weighted ``cns``). Returns (call, stats), with
        ``collect_aln`` (call, stats, AlnData), else with ``haplo`` (call,
        stats, the flex estimate f32 [B]). ``budget_r`` caps each read's
        admission budget (flex mode)."""
        B, Lp = codes.shape
        m = q_codes.shape[1]
        W = bsw.band_lanes(ap)
        map_codes = (torch.where(mask_cols, N, codes).to(codes.dtype)
                     if mask_cols is not None else codes)
        with obs.span("seed", cat="kernel") as sp:
            sread, strand, lread, diag, n_valid = _seed(
                map_codes, lengths, q_codes, q_lengths, rc_codes, ap,
                seed_stride, seed_min_votes)
            sp.fence(n_valid)
        n_cand = int(n_valid)
        ignore_cols = (mask_cols if use_mask_as_ignore and mask_cols
                       is not None else None)
        CH = self.chunk
        n_chunks = _bucket_chunks(max(1, -(-n_cand // CH)))
        R_need = n_chunks * CH
        sread, strand, lread, diag = _pad_candidates(sread, strand, lread,
                                                     diag, R_need)
        with obs.span("consense", cat="kernel", n_cand=n_cand,
                      chunks=n_chunks) as sp:
            call, n_adm, n_elig, scalars, slabs, hpl = _fused_pass(
                map_codes, ignore_cols, codes, qual, lengths, q_codes,
                rc_codes, q_qual, q_lengths, sread, strand, lread, diag,
                n_cand, m=m, W=W, CH=CH, n_chunks=n_chunks, ap=ap, cns=cns,
                collect=collect_aln, budget_r=budget_r, haplo=haplo)
            sp.fence(call)
        stats = DevicePassStats(n_candidates=n_cand, n_admitted=n_adm,
                                n_eligible=n_elig)
        if haplo and not collect_aln:
            return call, stats, hpl
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
    # with collect_qc: per run pass, masked columns and lengths of each
    # read (i32 [passes, B]), and the run's edits and uplift (i32 [B])
    qc_masked: Optional[torch.Tensor] = None
    qc_lengths: Optional[torch.Tensor] = None
    qc_edits: Optional[torch.Tensor] = None
    qc_uplift: Optional[torch.Tensor] = None


@obs.profile.attributed("fused_iterations")
def fused_iterations(codes, qual, lengths, mask_cols, frac_prev: float,
                     sr_codes, sr_rc, sr_qual, sr_lengths,
                     sels: Optional[np.ndarray], mask_pvs: np.ndarray,
                     m: int, W: int, CH: int, n_chunks: int,
                     ap: AlignParams, cns: ConsensusParams, n_rest: int,
                     Lp: int, seed_stride: int, seed_min_votes: int,
                     shortcut_frac: float, min_gain: float,
                     collect_qc: bool = False) -> FusedResult:
    """Passes 2..N with the reference's ``fused_iterations`` semantics.

    ``sels``: i32 [n_rest, Rsel] sampled short-read rows per pass (pad rows
    point at the zero-length sentinel read), or None when every pass uses
    the whole set. ``mask_pvs``: f32 [n_rest, 6] per-pass HCR mask params.
    Each pass reads the candidate count on the host (the chunk loop length);
    the shortcut test is the reference's f32 arithmetic.

    ``collect_qc`` also carries the reference's QC accumulators on the
    device: each pass's masked-column counts and lengths per read, and the
    run's base edits and phred uplift per read (``FusedResult.qc_*``).
    Off, no QC reduction runs."""
    dev = codes.device
    fracs, ncands, nadms, neligs, ndrops = [], [], [], [], []
    qc_m, qc_l = [], []
    qc_e = qc_u = None
    if collect_qc:
        qc_e = torch.zeros(codes.shape[0], dtype=torch.int32, device=dev)
        qc_u = torch.zeros_like(qc_e)
    frac_prev32 = np.float32(frac_prev)
    done = False
    it = 0
    R_need = n_chunks * CH
    while it < n_rest and not done:
        if sels is None:
            qc, rcq, qq, qlen = sr_codes, sr_rc, sr_qual, sr_lengths
        else:
            sel = torch.as_tensor(sels[it], dtype=torch.int64, device=dev)
            qc, rcq, qq, qlen = (sr_codes[sel], sr_rc[sel], sr_qual[sel],
                                 sr_lengths[sel])
        map_codes = torch.where(mask_cols, N, codes).to(codes.dtype)
        sread, strand, lread, diag, n_valid = _seed(
            map_codes, lengths, qc, qlen, rcq, ap, seed_stride,
            seed_min_votes)
        sread, strand, lread, diag = _pad_candidates(sread, strand, lread,
                                                     diag, R_need)
        n_valid = int(n_valid)
        n_cand = min(n_valid, R_need)
        call, n_adm, n_elig, _, _, _ = _fused_pass(
            map_codes, mask_cols, codes, qual, lengths, qc, rcq, qq, qlen,
            sread, strand, lread, diag, n_cand, m=m, W=W, CH=CH,
            n_chunks=n_chunks, ap=ap, cns=cns, collect=False)
        if collect_qc:
            # deltas against this pass's input, before assembly shifts
            # the columns
            ed, up = qc_pass_row_stats(call, codes, qual, lengths)
            qc_e, qc_u = qc_e + ed, qc_u + up
        codes, qual, lengths = assemble_rows(call, lengths, Lp)
        mask_cols, frac = hcr_mask_rows(qual, lengths, mask_pvs[it])
        if collect_qc:
            qc_m.append(qc_row_mask_counts(mask_cols))
            qc_l.append(lengths)
        frac32 = np.float32(frac.item())
        gain = np.float32(frac32 - frac_prev32)
        done = bool((frac32 > np.float32(shortcut_frac))
                    | (gain < np.float32(min_gain)))
        fracs.append(float(frac32))  # static-ok: a host numpy scalar
        ncands.append(n_cand)
        nadms.append(int(n_adm))
        neligs.append(int(n_elig))
        ndrops.append(max(n_valid - R_need, 0))
        frac_prev32 = frac32
        it += 1
    out = FusedResult(codes, qual, lengths, mask_cols, fracs, ncands, nadms,
                      neligs, ndrops, done)
    if collect_qc:
        out.qc_masked, out.qc_lengths = torch.stack(qc_m), torch.stack(qc_l)
        out.qc_edits, out.qc_uplift = qc_e, qc_u
    return out
