"""Device-side seeding: strided k-mer probes -> extension candidates.

Port of ``proovread_tpu/align/dseed.py`` in torch ops. Each short read fires
strided probe k-mers into a sorted index of the long-read batch; each probe
contributes up to ``occ_cap`` hits, and candidate (long read, diagonal
bucket) clusters are extracted per (read, strand) with dense in-row
comparisons, then ranked by votes.

K-mer values live in int64 (the reference's u32 values and its sentinels
``0xFFFFFFFF`` / ``0xFFFFFFFE`` keep their order there), every sort is
stable as ``jax.lax.sort`` is, and multi-operand sorts become an argsort
plus gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from proovread_tpu_torch.align.params import AlignParams

# direct-address bucket table over the top TABLE_BASES bases of the k-mer
TABLE_BASES = 12
INVALID_KMER = 0xFFFFFFFF       # index sentinel (sorts last)
INVALID_PROBE = 0xFFFFFFFE      # probe sentinel (never equals an index key)


class DeviceIndex(NamedTuple):
    kmers: torch.Tensor   # i64 [M] sorted k-mer values (INVALID_KMER = none)
    gpos: torch.Tensor    # i64 [M] read * L + offset
    starts: torch.Tensor  # i64 [T + 1] bucket start in the sorted table
    counts: torch.Tensor  # i64 [T + 1] bucket occurrence count
    k: int
    length: int           # L of the indexed batch
    n_reads: int

    @property
    def shift(self) -> int:
        return 2 * max(self.k - TABLE_BASES, 0)


class DeviceCandidates(NamedTuple):
    """Dense candidate slots [Bq, 2, S]; invalid slots have lread = -1."""
    lread: torch.Tensor   # i32 [Bq, 2, S]
    diag: torch.Tensor    # i32 [Bq, 2, S] mean cluster diagonal
    votes: torch.Tensor   # i32 [Bq, 2, S]


def _rolling_kmers(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """codes i8 [B, L] -> (u32 values in i64 [B, L-k+1], valid mask)."""
    B, L = codes.shape
    c = codes.to(torch.int64)
    n_pos = L - k + 1
    vals = torch.zeros((B, n_pos), dtype=torch.int64, device=codes.device)
    bad = torch.zeros((B, n_pos), dtype=torch.bool, device=codes.device)
    for i in range(k):
        w = c[:, i:i + n_pos]
        # u32 arithmetic: for k > 16 the oldest bases shift out
        vals = ((vals << 2) | (w & 3)) & 0xFFFFFFFF
        bad = bad | (w > 3) | (w < 0)
    pos = torch.arange(n_pos, device=codes.device)[None, :]
    valid = (~bad) & ((pos + k) <= lengths.to(torch.int64)[:, None])
    return vals, valid


def build_index(codes: torch.Tensor, lengths: torch.Tensor, k: int
                ) -> DeviceIndex:
    """Sorted k-mer table + direct-address bucket table."""
    B, L = codes.shape
    dev = codes.device
    vals, valid = _rolling_kmers(codes, lengths, k)
    n_pos = vals.shape[1]
    keys = torch.where(valid, vals, INVALID_KMER).reshape(-1)
    gpos = (torch.arange(B, device=dev)[:, None] * L
            + torch.arange(n_pos, device=dev)[None, :]).reshape(-1)
    skeys, order = torch.sort(keys, stable=True)
    sgpos = gpos[order]
    t = min(k, TABLE_BASES)
    shift = 2 * (k - t)
    T = 4 ** t
    bucket = torch.clamp(skeys >> shift, max=T)
    counts = torch.bincount(bucket, minlength=T + 1)
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(counts, 0)[:-1]])
    return DeviceIndex(kmers=skeys, gpos=sgpos, starts=starts, counts=counts,
                       k=k, length=L, n_reads=B)


def _probe_slab(index: DeviceIndex, q_codes, q_lengths, rc_codes, *,
                stride, occ_cap, slots, quant, max_occ, min_votes):
    """One query slab's probe + clustering."""
    Bq, m = q_codes.shape
    dev = q_codes.device
    k, L, shift = index.k, index.length, index.shift
    INVALID = 1 << 29
    DQ_SPAN = (L + m) // quant + 2
    T = index.starts.shape[0] - 1
    M = index.gpos.shape[0]

    keys_all, diags_all = [], []
    for qc in (q_codes, rc_codes):
        vals, valid = _rolling_kmers(qc, q_lengths, k)
        ps = torch.arange(0, vals.shape[1], stride, device=dev)
        vals, valid = vals[:, ps], valid[:, ps]
        P = ps.shape[0]
        flat = torch.where(valid, vals, INVALID_PROBE).reshape(-1)
        pk = torch.clamp(flat >> shift, max=T)
        lo = index.starts[pk]
        occ = index.counts[pk]
        use = valid.reshape(-1) & (occ > 0) & (occ <= max_occ)
        occ_use = torch.clamp(occ, max=occ_cap)
        qpos = ps[None, :].expand(Bq, P).reshape(-1)
        hit_keys, hit_diags = [], []
        for j in range(occ_cap):
            idx = torch.clamp(lo + j, 0, M - 1)
            g = index.gpos[idx]
            lread = g // L
            diag = g % L - qpos
            key = lread * DQ_SPAN + torch.div(diag + m, quant,
                                              rounding_mode="floor")
            ok = use & (j < occ_use)
            if shift > 0:
                ok &= index.kmers[idx] == flat
            hit_keys.append(torch.where(ok, key, INVALID))
            hit_diags.append(torch.where(ok, diag, 0))
        keys_all.append(torch.stack(hit_keys, -1).reshape(Bq, P * occ_cap))
        diags_all.append(torch.stack(hit_diags, -1).reshape(Bq, P * occ_cap))

    keys = torch.stack(keys_all, 1)       # [Bq, 2, S_in]
    diags = torch.stack(diags_all, 1)
    S_in = keys.shape[-1]

    # cluster votes within each row: O(S_in^2) dense comparisons
    eq = keys[..., :, None] == keys[..., None, :]          # [Bq, 2, S, S]
    votes = eq.sum(-1)
    dsum = (eq * diags[..., None, :]).sum(-1)
    tri = torch.tril(torch.ones((S_in, S_in), dtype=torch.bool, device=dev),
                     diagonal=-1)
    first = ~(eq & tri).any(-1)
    live = first & (keys != INVALID) & (votes >= min_votes)

    mean_diag = torch.div(dsum + torch.div(votes, 2, rounding_mode="floor"),
                          torch.clamp(votes, min=1), rounding_mode="floor")
    neg_rank = torch.where(live, -votes, 1 << 30)
    keys_m = torch.where(live, keys, INVALID)
    diag_m = torch.where(live, mean_diag, 0)
    votes_m = torch.where(live, votes, 0)
    _, order = torch.sort(neg_rank, dim=-1, stable=True)
    order = order[..., :slots]
    key_top = torch.gather(keys_m, -1, order)
    lread = torch.where(key_top < INVALID,
                        torch.div(key_top, DQ_SPAN, rounding_mode="floor"),
                        -1)
    return (lread.to(torch.int32),
            torch.gather(diag_m, -1, order).to(torch.int32),
            torch.gather(votes_m, -1, order).to(torch.int32))


# queries per probe slab: bounds the [slab, 2, S, S] clustering transient
PROBE_SLAB = 8192


def probe_candidates(index: DeviceIndex, q_codes, q_lengths, rc_codes,
                     params: AlignParams, stride: int = 16,
                     occ_cap: int = 4, min_votes: int = 2
                     ) -> DeviceCandidates:
    quant = max(params.band_width // 2, 1)
    kw = dict(stride=stride, occ_cap=occ_cap, slots=params.max_candidates,
              quant=quant, max_occ=params.max_occ, min_votes=min_votes)
    Bq = q_codes.shape[0]
    parts = [_probe_slab(index, q_codes[a:a + PROBE_SLAB],
                         q_lengths[a:a + PROBE_SLAB],
                         rc_codes[a:a + PROBE_SLAB], **kw)
             for a in range(0, max(Bq, 1), PROBE_SLAB)]
    lread, diag, votes = (torch.cat([p[i] for p in parts]) for i in range(3))
    return DeviceCandidates(lread=lread, diag=diag, votes=votes)


def compact_candidates(cand: DeviceCandidates):
    """Flatten candidate slots to a dense prefix sorted by long read.

    Returns (sread, strand, lread, diag, n_valid): the first n_valid rows
    hold the real candidates; the tail's lread repeats the last valid read
    (keeps the pileup's read order sorted). ``n_valid`` is a 0-dim tensor."""
    Bq, two, S = cand.lread.shape
    dev = cand.lread.device
    lread = cand.lread.reshape(-1)
    diag = cand.diag.reshape(-1)
    idx = torch.arange(Bq * two * S, dtype=torch.int32, device=dev)
    sread = idx // (two * S)
    strand = (idx // S) % two
    valid = lread >= 0
    order_key = torch.where(valid, lread, 1 << 30)
    _, order = torch.sort(order_key, stable=True)
    o_lread = lread[order]
    n_valid = valid.sum()
    last = torch.where(valid, lread, 0).max() if lread.numel() else 0
    o_lread = torch.where(o_lread < 0, last, o_lread).to(torch.int32)
    return (sread[order], strand[order].to(torch.int8), o_lread,
            diag[order], n_valid)
