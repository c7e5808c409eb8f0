"""Seeding: exact k-mer matching + diagonal clustering -> candidate windows.

The host (numpy) seeder of ``proovread_tpu/align/seed.py``, copied so the
port imports nothing of the JAX package; siamaera's mapper runs on it.

Plays the role of bwa's seeding/chaining stage (MEM seeds -> chains) for the
SW extension kernel: build a sorted k-mer table of the packed long-read batch,
look up every short-read k-mer (both strands), vote on (long read, diagonal
band) buckets, and keep the top buckets per read+strand as extension
candidates. Everything is vectorized numpy on host; positions use the padded
[B, L] global coordinate space so a candidate is (short read, strand, long
read, diagonal).

Masked bases (N) never form k-mers, so previously-corrected high-confidence
regions stop attracting seeds exactly like the reference's masked FASTA does
(``bin/proovread:1702-1714``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from proovread_tpu_torch.align.params import AlignParams
from proovread_tpu_torch.ops.encode import revcomp_codes


class SeedIndex(NamedTuple):
    k: int
    kmers: np.ndarray      # uint64 [M] sorted k-mer values
    gpos: np.ndarray       # int64  [M] global position (read * L + offset)
    length: int            # L of the indexed batch
    n_reads: int


class Candidates(NamedTuple):
    """One row per extension candidate."""
    sread: np.ndarray      # int32 short-read index
    strand: np.ndarray     # int8  0 fwd / 1 rev
    lread: np.ndarray      # int32 long-read index
    diag: np.ndarray       # int32 ref_pos - query_pos of the seed cluster
    votes: np.ndarray      # int32 seed hits supporting the cluster


def revcomp_batch(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Per-row reverse complement keeping reads left-aligned in the padded
    array (padding stays at the tail)."""
    B, m = codes.shape
    rc = np.stack([revcomp_codes(codes[i]) for i in range(B)]) if B else codes
    shift = (m - lengths).astype(np.int64)
    cols = (np.arange(m)[None, :] + shift[:, None]) % m
    return np.take_along_axis(rc, cols, axis=1)


def _rolling_kmers(codes: np.ndarray, k: int):
    """codes int8 [B, L] -> (values uint64 [B, L-k+1], valid bool mask).
    K-mers containing N (code > 3) are invalid."""
    B, L = codes.shape
    if L < k:
        return np.zeros((B, 0), np.uint64), np.zeros((B, 0), bool)
    c = codes.astype(np.uint64)
    bad = codes > 3
    n_pos = L - k + 1
    vals = np.zeros((B, n_pos), np.uint64)
    invalid = np.zeros((B, n_pos), bool)
    for i in range(k):
        vals = (vals << np.uint64(2)) | c[:, i : i + n_pos]
        invalid |= bad[:, i : i + n_pos]
    return vals, ~invalid


def build_index(codes: np.ndarray, lengths: np.ndarray, k: int) -> SeedIndex:
    """Index a packed long-read batch (int8 [B, L], N-padded)."""
    B, L = codes.shape
    vals, valid = _rolling_kmers(codes, k)
    n_pos = vals.shape[1]
    if n_pos:
        valid &= (np.arange(n_pos)[None, :] + k) <= lengths[:, None]
    flat = np.flatnonzero(valid)
    v = vals.reshape(-1)[flat]
    # re-stride from the [B, L-k+1] kmer grid to [B, L] coordinates
    gpos = (flat // n_pos) * np.int64(L) + (flat % n_pos) if n_pos else flat
    order = np.argsort(v, kind="stable")
    return SeedIndex(k=k, kmers=v[order], gpos=gpos[order].astype(np.int64),
                     length=L, n_reads=B)


def find_candidates(
    index: SeedIndex,
    q_codes: np.ndarray,     # int8 [Bq, m] short reads, N-padded
    q_lengths: np.ndarray,
    params: AlignParams,
    rc: np.ndarray = None,   # precomputed revcomp_batch(q_codes, q_lengths)
) -> Candidates:
    k = index.k
    Bq, m = q_codes.shape
    if rc is None:
        rc = revcomp_batch(q_codes, q_lengths)
    # rc is left-aligned, so qpos semantics are identical on both strands
    out = []
    for strand, qc in ((0, q_codes), (1, rc)):
        vals, valid = _rolling_kmers(qc, k)
        if vals.shape[1]:
            valid &= (np.arange(vals.shape[1])[None, :] + k) <= q_lengths[:, None]
        flat = np.flatnonzero(valid)
        if flat.size == 0:
            continue
        qv = vals.reshape(-1)[flat]
        qread = (flat // max(vals.shape[1], 1)).astype(np.int32)
        qpos = (flat % max(vals.shape[1], 1)).astype(np.int32)

        lo = np.searchsorted(index.kmers, qv, side="left")
        hi = np.searchsorted(index.kmers, qv, side="right")
        occ = hi - lo
        keep = (occ > 0) & (occ <= params.max_occ)
        lo, occ = lo[keep], occ[keep]
        qread, qpos = qread[keep], qpos[keep]
        if lo.size == 0:
            continue
        # expand hit ranges [lo, lo+occ)
        tot = int(occ.sum())
        starts = np.zeros(len(occ), np.int64)
        np.cumsum(occ[:-1], out=starts[1:])
        idx = np.repeat(lo, occ) + (np.arange(tot) - np.repeat(starts, occ))
        g = index.gpos[idx]
        h_qread = np.repeat(qread, occ)
        h_qpos = np.repeat(qpos, occ)
        lread = (g // index.length).astype(np.int64)
        rpos = (g % index.length).astype(np.int64)
        diag = rpos - h_qpos
        out.append((strand, h_qread, lread, diag))

    if not out:
        z = np.zeros(0, np.int32)
        return Candidates(z, z.astype(np.int8), z, z, z)

    # vote per (sread, strand, lread, diag bucket); quantize diagonals to
    # half the band so clusters within one band width merge
    quant = max(params.band_width // 2, 1)
    srs, sts, lrs, dgs = [], [], [], []
    for strand, h_qread, lread, diag in out:
        srs.append(h_qread.astype(np.int64))
        sts.append(np.full(len(h_qread), strand, np.int64))
        lrs.append(lread)
        dgs.append(diag)
    sread = np.concatenate(srs)
    strand = np.concatenate(sts)
    lread = np.concatenate(lrs)
    diag = np.concatenate(dgs)

    # shift by the query pad width: diag = rpos - qpos >= -(m-1), and m may
    # exceed the indexed length (e.g. ccs windows vs short ref subreads)
    dq = (diag + m) // quant
    key = ((sread * 2 + strand) * index.n_reads + lread) * (
        (index.length + m) // quant + 2
    ) + dq
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    # mean diagonal per cluster
    diag_sum = np.bincount(inv, weights=diag.astype(np.float64))
    order = np.argsort(inv, kind="stable")
    fidx = order[np.searchsorted(inv[order], np.arange(len(uniq)))]
    c_sread = sread[fidx].astype(np.int32)
    c_strand = strand[fidx].astype(np.int8)
    c_lread = lread[fidx].astype(np.int32)
    c_diag = np.round(diag_sum / counts).astype(np.int32)
    c_votes = counts.astype(np.int32)

    # keep top max_candidates clusters per (sread, strand) by votes
    rank_key = (c_sread.astype(np.int64) * 2 + c_strand) << np.int64(32)
    order = np.lexsort((-c_votes, rank_key))
    grp = rank_key[order]
    pos_in_grp = np.arange(len(order)) - np.searchsorted(grp, grp, side="left")
    keep = order[pos_in_grp < params.max_candidates]
    keep.sort()
    return Candidates(
        sread=c_sread[keep], strand=c_strand[keep], lread=c_lread[keep],
        diag=c_diag[keep], votes=c_votes[keep],
    )
