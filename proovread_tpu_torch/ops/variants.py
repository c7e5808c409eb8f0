"""Per-column variant calling on the pileup tensors (port of
``proovread_tpu/ops/variants.py``).

``Sam::Seq::call_variants`` (``lib/Sam/Seq.pm:1666-1734``) walks the Perl
state matrix per column: coverage = sum of all state freqs, states sorted
by freq descending, and the kept set is the top ``k`` where ``k`` counts
states with freq >= ``min_freq`` (optionally intersected/unioned with a
``min_prob`` relative-frequency cutoff); at least the top state is always
kept. ``variant_consensus`` (``Sam/Seq.pm:1506-1560``) then emits the top
variant per column.

Here the state matrix is the dense pileup (``ops/pileup.py``), so the
per-column state freqs are two torch ops on the pileup's device:

    lanes 0..5   plain single-base states A C G T N -   (counts - ins_mbase)
    lanes 6..11  composite insertion states, merged by their match base
                 (``ins_mbase``)

``variant_freqs`` (one f32 subtraction) and ``majority_insertion`` (first-
index ``torch.argmax``, the tie order of ``jnp.argmax``) are plain torch;
``call_variants``, ``stabilize_variants`` and ``variants_tsv`` are host
numpy.

Documented deviation: the Perl matrix keys every distinct composite state
string ("AT" vs "AG") separately; the dense pileup merges composites by
their first (match) base and votes the inserted bases per offset, so two
distinct same-base composites at one column count as one merged state whose
suffix is the column's majority insertion. Coverage is unaffected (the
merged freq is the sum), and single-base variant calls are exact.

Tie-breaking when freqs are equal is deterministic here (state-code order);
upstream it inherits Perl hash order and is run-to-run nondeterministic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from proovread_tpu_torch.ops.encode import N_STATES, decode_codes
from proovread_tpu_torch.ops.pileup import Pileup, lane_sum

# variant-state alphabet: plain states then merged-composite by match base
N_VSTATES = 2 * N_STATES


def variant_freqs(pile: Pileup) -> torch.Tensor:
    """f32 [B, L, N_VSTATES] per-column variant-state freqs (see module
    docstring for the lane layout)."""
    plain = pile.counts - pile.ins_mbase
    return torch.cat([plain, pile.ins_mbase], -1)


def majority_insertion(pile: Pileup) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column majority insertion (length bucket + per-offset bases) for
    rendering merged-composite state strings — the same majority the
    consensus call emits (ops/consensus_call.py), but independent of which
    state wins the column."""
    ins_w = lane_sum(pile.ins_mbase)
    K = pile.ins_len_votes.shape[-1]
    maj_len = torch.where(ins_w > 0,
                          torch.argmax(pile.ins_len_votes, -1) + 1, 0)
    bases = torch.argmax(pile.ins_base_votes, -1).to(torch.int8)
    return torch.clamp(maj_len, max=K).to(torch.int32), bases


@dataclass
class VariantTable:
    """Host-side per-column variant call for a batch of B reads.

    ``order``/``freqs`` are freq-descending per column; only the first
    ``n_kept[b, l]`` entries are the called variants (0 for uncovered
    columns — upstream renders those as ``['?']``)."""
    covs: np.ndarray       # f32 [B, L] total column coverage
    order: np.ndarray      # i8  [B, L, N_VSTATES] state codes, freq desc
    freqs: np.ndarray      # f32 [B, L, N_VSTATES] sorted freqs
    n_kept: np.ndarray     # i32 [B, L]
    ins_strings: List[List[str]]   # [B][L] majority insertion suffix ('' if none)
    # filled by stabilize_variants: [B] -> list of rewritten groups
    stabilized: Optional[list] = None

    def states_of(self, b: int, col: int) -> List[Tuple[str, float]]:
        """[(state_string, freq)] of the kept variants at one column, in
        call order. Composite states render as match base + majority
        insertion suffix; plain states as their single char."""
        out = []
        for j in range(int(self.n_kept[b, col])):
            s = int(self.order[b, col, j])
            f = float(self.freqs[b, col, j])
            if s < N_STATES:
                out.append((decode_codes(np.array([s]))[0], f))
            else:
                base = decode_codes(np.array([s - N_STATES]))[0]
                out.append((base + self.ins_strings[b][col], f))
        return out


def call_variants(
    vfreqs: np.ndarray,                  # [B, L, N_VSTATES] (variant_freqs)
    lengths: np.ndarray,                 # i32 [B]
    min_freq: float = 4.0,
    min_prob: float = 0.0,
    or_min: bool = False,
    ins_call: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    # (ins_len [B, L], ins_bases [B, L, K]) from the consensus call, used
    # only to render merged-composite suffix strings
) -> VariantTable:
    """Variant table from the per-state freqs (Sam/Seq.pm:1666-1734
    semantics; see module docstring). Vectorized on host — the tensor work
    (pileup + freqs) happens on device, the per-column sort is numpy."""
    vfreqs = np.asarray(vfreqs)
    B, L, S = vfreqs.shape
    assert S == N_VSTATES
    covs = vfreqs.sum(-1)

    order = np.argsort(-vfreqs, axis=-1, kind="stable").astype(np.int8)
    sfreqs = np.take_along_axis(vfreqs, order.astype(np.int64), axis=-1)

    present = (sfreqs > 0).sum(-1)
    if min_freq:
        k = (sfreqs >= min_freq).sum(-1)
    else:
        k = present
    if min_prob:
        probs = sfreqs / np.maximum(covs[..., None], 1e-9)
        kp = ((sfreqs > 0) & (probs >= min_prob)).sum(-1)
        k = np.maximum(k, kp) if or_min else np.minimum(k, kp)
    # at least the top state on covered columns (Perl keeps vars[0] when
    # k-1 < 0); uncovered columns keep nothing
    n_kept = np.where(covs > 0, np.maximum(k, 1), 0).astype(np.int32)
    pos = np.arange(L)[None, :]
    n_kept = np.where(pos < np.asarray(lengths)[:, None], n_kept, 0)

    ins_strings: List[List[str]] = []
    if ins_call is not None:
        ins_len, ins_bases = (np.asarray(a) for a in ins_call)
        for b in range(B):
            row = []
            for l in range(L):
                n = int(ins_len[b, l])
                row.append(decode_codes(ins_bases[b, l, :n]) if n else "")
            ins_strings.append(row)
    else:
        ins_strings = [[""] * L for _ in range(B)]

    return VariantTable(covs=covs, order=order, freqs=sfreqs, n_kept=n_kept,
                        ins_strings=ins_strings)


# Sam::Seq's pairwise scoring scheme (Sam/Seq.pm:20-33: MA deliberately 0
# "to prevent just having the longer alignment win")
_MA, _MM, _RGO, _RGE, _QGO, _QGE = 0, -11, -2, -4, -1, -3


def _aln2score_seq(r: str, q: str) -> int:
    """``Sam::Seq::aln2score`` (Sam/Seq.pm:1965-1989) over padded strings.
    Computed over the overlap when lengths differ (upstream's string-xor
    pads with NULs, which count as mismatches; equal lengths in practice)."""
    import re as _re

    def gaps(s):
        g = s.count("-")
        go = len(_re.findall(r"-+", s))
        return go, g - go

    rgo, rge = gaps(r)
    qgo, qge = gaps(q)
    rg, qg = rgo + rge, qgo + qge
    diff = sum(a != b for a, b in zip(r, q)) + abs(len(r) - len(q))
    mm = diff - (rg + qg)
    ma = len(r) - (rg + qg + mm)
    return (_MA * ma + _MM * mm + _RGO * rgo + _RGE * rge
            + _QGO * qgo + _QGE * qge)


def _raw_states(a) -> List[str]:
    """``Sam::Alignment::seq_states`` (Sam/Alignment.pm:468-493) on the
    engine's compact alignment form: one string per reference column —
    base char, '-' for a deletion, insertions appended to the previous
    column's string. No indel-taboo trimming (matching upstream)."""
    from proovread_tpu_torch.consensus.cigar import D, H, I, M, S

    s: List[str] = []
    pos = 0
    for op, ln in zip(a.ops, a.lens):
        ln = int(ln)
        if op == S:
            pos += ln
        elif op == I:
            if s:
                s[-1] += decode_codes(a.seq_codes[pos:pos + ln])
            pos += ln
        elif op == D:
            s.extend(["-"] * ln)
        elif op == M:
            s.extend(decode_codes(a.seq_codes[pos:pos + ln]))
            pos += ln
        # H: neither query nor reference consumed
    return s


@dataclass
class StabilizedGroup:
    """One re-called close-variant group (Sam/Seq.pm:1777-1958): whole-group
    variant strings at column ``start``, columns (start, start+length)
    become '-' placeholders carrying the group coverage."""
    start: int
    length: int
    vars: List[str]
    freqs: List[float]
    cov: float


def stabilize_variants(
    table: VariantTable,
    alnsets,
    ref_seqs,
    min_freq: float = 2.0,
    var_dist: int = 4,
) -> List[List[StabilizedGroup]]:
    """``Sam::Seq::stabilize_variants`` (Sam/Seq.pm:1777-1958): noise at
    SNP-ish positions with close indels is re-called as variant strings
    over the whole close-variant group, extracted per admitted alignment
    and re-scored against the reference substring (``aln2score``; the
    reference-padding mirrors upstream's sequential substr-insert, indexed
    into the evolving string). Groups are recorded on ``table.stabilized``
    so :func:`variants_tsv` renders the rewritten columns; ties in the
    score ordering break deterministically by string (upstream inherits
    hash order). Requires the table built from the same (post-admission)
    ``alnsets``."""
    out: List[List[StabilizedGroup]] = []
    for b, aset in enumerate(alnsets):
        vpos = np.flatnonzero(table.n_kept[b] > 1)
        groups: List[List[int]] = []
        cur = [int(vpos[0])] if len(vpos) else []
        for p in vpos[1:]:
            p = int(p)
            if p - cur[-1] > var_dist:
                if len(cur) > 1:
                    groups.append(cur)
                cur = [p]
            else:
                cur.append(p)
        if len(cur) > 1:
            groups.append(cur)
        vranges = [(g[0], g[-1] - g[0] + 1) for g in groups]
        counts: List[dict] = [dict() for _ in vranges]
        for a in sorted(aset.alns, key=lambda a: a.pos0):
            s = _raw_states(a)
            if not s:
                continue
            o, last = a.pos0, a.pos0 + len(s) - 1
            for i, (vs, vl) in enumerate(vranges):
                # upstream's containment check compares against o + $#s
                # exclusive (_is_in_range with LENGTH = last index)
                if vs >= o and vs + vl - 1 < last:
                    seg = s[vs - o:vs - o + vl]
                    var = "".join(seg).replace("-", "")
                    e = counts[i].setdefault(var, [seg, 0])
                    e[1] += 1
        read_groups: List[StabilizedGroup] = []
        for (vs, vl), cnt in zip(vranges, counts):
            ref = str(ref_seqs[b])[vs:vs + vl].upper()
            scored = []
            for var, (seg, f) in cnt.items():
                if f < min_freq:
                    continue
                q_padded = "".join(seg)
                r_padded = ref
                for i2, col in enumerate(seg):
                    if len(col) > 1:
                        r_padded = (r_padded[:i2 + 1]
                                    + "-" * (len(col) - 1)
                                    + r_padded[i2 + 1:])
                scored.append((_aln2score_seq(r_padded, q_padded), var, f))
            if not scored:
                continue
            scored.sort(key=lambda t: (-t[0], t[1]))
            read_groups.append(StabilizedGroup(
                start=int(vs), length=int(vl),
                vars=[v for _, v, _ in scored],
                freqs=[float(f) for _, _, f in scored],
                cov=float(sum(f for _, _, f in scored))))
        out.append(read_groups)
    table.stabilized = out
    return out


def variants_tsv(table: VariantTable, read_ids, lengths) -> str:
    """Serialize the variant table the way ``--debug``/operators consume it:
    one line per covered column: ``read_id  col  cov  vars  freqs`` with
    comma-joined state strings and freqs (uncovered columns render '?',
    mirroring Sam/Seq.pm:1689-1694)."""
    lines = []
    for b, rid in enumerate(read_ids):
        over = {}
        if table.stabilized:
            for g in table.stabilized[b]:
                over[g.start] = (g.cov, g.vars, g.freqs)
                for c in range(g.start + 1, g.start + g.length):
                    over[c] = (g.cov, ["-"], [g.cov])
        for col in range(int(lengths[b])):
            if col in over:
                cov, vs, fs = over[col]
                lines.append(f"{rid}\t{col}\t{_fmt(cov)}"
                             f"\t{','.join(vs)}"
                             f"\t{','.join(_fmt(f) for f in fs)}")
                continue
            if table.covs[b, col] <= 0:
                lines.append(f"{rid}\t{col}\t0\t?\t")
                continue
            kept = table.states_of(b, col)
            vars_s = ",".join(s for s, _ in kept)
            freqs_s = ",".join(_fmt(f) for _, f in kept)
            lines.append(f"{rid}\t{col}\t{_fmt(table.covs[b, col])}"
                         f"\t{vars_s}\t{freqs_s}")
    return "\n".join(lines) + "\n"


def _fmt(x: float) -> str:
    return str(int(x)) if float(x).is_integer() else f"{x:g}"
