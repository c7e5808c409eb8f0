"""CIGAR machinery (port of ``proovread_tpu/consensus/cigar.py``): parsing,
clip stripping, indel-taboo end trimming, and expansion of one alignment
into dense per-reference-column state arrays.

This is the op-stream normalizer the reference implements inline in
``Sam/Seq.pm::State_matrix`` (``Sam/Seq.pm:232-467``): soft/hard-clip handling
(``:290-310``), InDelTaboo head/tail trimming with the 50 bp / 70 %-kept
admission rule (``:318-385``), CIGAR->states with insertions attached to the
preceding column and the bowtie2 ``1D1I``->mismatch correction (``:388-432``).
The scan engine's chimera scan expands the alignments around a suspect
breakpoint with it. Host numpy.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.ops.encode import GAP, N

# op codes
M, I, D, S, H = 0, 1, 2, 3, 4
_OP_CODE = {"M": M, "=": M, "X": M, "I": I, "D": D, "S": S, "H": H}
_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def parse_cigar(cigar: str) -> Tuple[np.ndarray, np.ndarray]:
    """CIGAR string -> (ops uint8, lens int32). '*' -> empty. N/P unsupported
    (the reference dies on them too: Sam/Seq.pm:348)."""
    if cigar == "*":
        return np.empty(0, np.uint8), np.empty(0, np.int32)
    ops, lens = [], []
    pos = 0
    for m in _CIGAR_RE.finditer(cigar):
        if m.start() != pos:
            raise ValueError(f"malformed CIGAR: {cigar!r}")
        pos = m.end()
        op = m.group(2)
        if op not in _OP_CODE:
            raise ValueError(f"unsupported CIGAR op {op!r} in {cigar!r}")
        ops.append(_OP_CODE[op])
        lens.append(int(m.group(1)))
    if pos != len(cigar):
        raise ValueError(f"malformed CIGAR: {cigar!r}")
    return np.array(ops, np.uint8), np.array(lens, np.int32)


def ref_span(ops: np.ndarray, lens: np.ndarray) -> int:
    """Reference bases consumed (M+D) — the aln 'length' the reference uses
    for bins/coverage (Sam/Alignment.pm:393-431, soft-clip branch)."""
    return int(lens[(ops == M) | (ops == D)].sum())


@dataclass
class ColumnStates:
    """One alignment expanded over its reference window.

    All arrays have length ``span`` (reference columns covered):
      - ``state``: int8 code per column — base (0-4) for M, GAP for D
      - ``freq``: float32 vote weight per column (1.0, or the min
        phred->freq over the state's chars when qual_weighted)
      - ``ins_len``: int16 inserted bases *after* this column (capped)
      - ``ins_bases``: int8 [span, ins_cap] inserted base codes (N-padded)
    ``rpos`` is the 0-based reference start of the window.
    """

    rpos: int
    state: np.ndarray
    freq: np.ndarray
    ins_len: np.ndarray
    ins_bases: np.ndarray

    @property
    def span(self) -> int:
        return len(self.state)


def _trim_taboo(
    ops: np.ndarray,
    lens: np.ndarray,
    seq: np.ndarray,
    qual: np.ndarray,
    rpos: int,
    orig_len: int,
    params: ConsensusParams,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]]:
    """InDelTaboo head/tail trim (Sam/Seq.pm:318-385). Returns None if the
    alignment fails the >=min_aln_length & >=70%-kept admission rule."""
    taboo = params.taboo_len(orig_len)

    # head: advance to the first M run that crosses the taboo boundary and
    # cut everything before it
    mc = dc = ic = 0
    for i in range(len(ops)):
        if ops[i] == M:
            if mc + ic + lens[i] > taboo:
                if i:
                    rpos += mc + dc
                    seq = seq[mc + ic :]
                    qual = qual[mc + ic :]
                    ops, lens = ops[i:], lens[i:]
                break
            mc += int(lens[i])
        elif ops[i] == D:
            dc += int(lens[i])
        elif ops[i] == I:
            ic += int(lens[i])
        else:
            raise ValueError(f"unexpected CIGAR op {ops[i]} after clip strip")
    if len(seq) < max(50, 1) or len(seq) / orig_len < 0.7:
        return None

    # tail: mirror pass; the first op is never a cut point (reference loop
    # bound `$i;` in Sam/Seq.pm:358)
    tail = 0
    for i in range(len(ops) - 1, 0, -1):
        if ops[i] == M:
            tail += int(lens[i])
            if tail > taboo:
                if i < len(ops) - 1:
                    tail_cut = tail - int(lens[i])
                    ops, lens = ops[: i + 1], lens[: i + 1]
                    if tail_cut > 0:  # seq[:-0] would empty the array
                        seq = seq[:-tail_cut]
                        qual = qual[:-tail_cut]
                break
        elif ops[i] == I:
            tail += int(lens[i])
        # D: ignored
    if len(seq) < params.min_aln_length or len(seq) / orig_len < 0.7:
        return None
    return ops, lens, seq, qual, rpos


def expand_alignment(
    pos0: int,
    ops: np.ndarray,
    lens: np.ndarray,
    seq_codes: np.ndarray,
    qual: Optional[np.ndarray],
    params: ConsensusParams,
) -> Optional[ColumnStates]:
    """Normalize one alignment to per-column states.

    ``pos0``: 0-based reference position; ``seq_codes``/``qual``: full query
    incl. soft-clipped bases (hard clips already absent from seq). Returns
    None when the alignment is dropped (too short, fails taboo admission).
    """
    if len(ops) == 0:
        return None
    orig_qlen = int(lens[(ops == M) | (ops == I) | (ops == S)].sum())
    if len(seq_codes) != orig_qlen:
        raise ValueError(f"seq length {len(seq_codes)} != CIGAR query length {orig_qlen}")

    # strip clips (S consumes query; H is annotation only)
    if len(ops) and ops[0] == S:
        seq_codes = seq_codes[lens[0] :]
        qual = qual[lens[0] :] if qual is not None else None
        ops, lens = ops[1:], lens[1:]
    if len(ops) and ops[-1] == S:
        seq_codes = seq_codes[: -lens[-1]]
        qual = qual[: -lens[-1]] if qual is not None else None
        ops, lens = ops[:-1], lens[:-1]
    if len(ops) and ops[0] == H:
        ops, lens = ops[1:], lens[1:]
    if len(ops) and ops[-1] == H:
        ops, lens = ops[:-1], lens[:-1]
    if len(ops) == 0:
        raise ValueError("empty CIGAR after clip strip")

    orig_len = len(seq_codes)  # post-clip length, the reference's $orig_seq_length
    if orig_len <= params.min_aln_length:
        return None
    if qual is None:
        qual = np.full(orig_len, params.fallback_phred, np.uint8)

    rpos = pos0
    if params.trim:
        trimmed = _trim_taboo(ops, lens, seq_codes, qual, rpos, orig_len, params)
        if trimmed is None:
            return None
        ops, lens, seq_codes, qual, rpos = trimmed

    span = ref_span(ops, lens)
    if span <= 0:
        return None
    K = params.ins_cap
    state = np.full(span, GAP, np.int8)
    freq_q = np.full(span, 255, np.int16)  # min phred per column; 255 = unset
    ins_len = np.zeros(span, np.int16)
    ins_bases = np.full((span, K), N, np.int8)

    qpos = 0  # query cursor
    c = 0     # column cursor (window-relative)
    for k in range(len(ops)):
        op, ln = int(ops[k]), int(lens[k])
        if op == M:
            state[c : c + ln] = seq_codes[qpos : qpos + ln]
            freq_q[c : c + ln] = qual[qpos : qpos + ln]
            qpos += ln
            c += ln
        elif op == D:
            qb = qual[qpos - 1] if qpos > 1 else qual[qpos]
            qa = qual[qpos] if qpos < len(qual) else qual[qpos - 1]
            state[c : c + ln] = GAP
            freq_q[c : c + ln] = min(int(qb), int(qa))
            c += ln
        elif op == I:
            ins = seq_codes[qpos : qpos + ln]
            insq = qual[qpos : qpos + ln]
            tgt = c - 1
            if tgt < 0:
                # leading insertion (only possible with trim off): no
                # preceding column exists; fold into the next column's weight
                # instead of the reference's states[0]-overwrite quirk
                # (Sam/Seq.pm:424-427)
                qpos += ln
                continue
            if state[tgt] == GAP and ins_len[tgt] == 0:
                # bowtie2 1D1I: gap + insertion is really a mismatch
                # (Sam/Seq.pm:413-419)
                state[tgt] = ins[0]
                freq_q[tgt] = int(insq[0])
                extra, extraq = ins[1:], insq[1:]
            else:
                extra, extraq = ins, insq
            take = min(len(extra), K - int(ins_len[tgt]))
            if take > 0:
                ins_bases[tgt, ins_len[tgt] : ins_len[tgt] + take] = extra[:take]
            ins_len[tgt] += len(extra)  # true length for vote, bases capped
            if len(extraq):
                freq_q[tgt] = min(int(freq_q[tgt]), int(extraq.min()))
            qpos += ln
        else:
            raise ValueError(f"unexpected CIGAR op {op} in alignment body")

    freq = phreds_to_freqs(np.minimum(freq_q, 93).astype(np.float32)) if params.qual_weighted else np.ones(span, np.float32)
    return ColumnStates(rpos=rpos, state=state, freq=freq, ins_len=ins_len, ins_bases=ins_bases)


def phreds_to_freqs(phreds: np.ndarray) -> np.ndarray:
    """freq = round((p^2/120)*100)/100 (Sam/Seq.pm:151-156)."""
    return np.round((phreds.astype(np.float64) ** 2 / 120.0) * 100.0 + 1e-9) / 100.0


def freqs_to_phreds(freqs: np.ndarray) -> np.ndarray:
    """phred = min(40, int(sqrt(f*120)+0.5)) (Sam/Seq.pm:136-142)."""
    p = np.floor(np.sqrt(np.maximum(freqs, 0.0) * 120.0) + 0.5)
    return np.minimum(p, 40.0).astype(np.uint8)
