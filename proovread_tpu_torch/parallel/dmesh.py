"""Data-parallel sharding of the device correction pass over the ranks of a
``torch.distributed`` group.

Port of ``proovread_tpu/parallel/dmesh.py``. The reference's outermost
parallelism is job-level data parallelism: long reads are split into
chunks and each chunk is an independent process. The JAX package runs one
process over ``jax.devices()`` and ``shard_map`` puts the same pass on each
device. The port runs the equivalent as one program on every rank (SPMD):
every rank runs the same ``Pipeline.run`` on the same inputs, config,
buckets and sampler draws, and the only difference is which rows of a
bucket a rank corrects in the mesh loop. Each rank runs the same pass the
single-device pipeline runs (seeding, banded SW, admission, pileup,
consensus, assembly, HCR mask: ``pipeline/dcorrect.py``'s ``_seed``,
``_fused_pass``, ``device_assemble`` and the HCR kernel) on its own shard,
with the short-read set replicated on every rank's device. Reads cross no
rank inside a pass: the problem is embarrassingly parallel over reads.

The collectives run on gloo, over host tensors:

* the pass's integer KPI sums (masked and total bases, admitted, eligible,
  candidates, candidates past the per-shard cap), plus each row's QC
  counts while a QC recorder is installed, all-reduced once a pass (the
  reference's ``psum``). The host reads these sums every pass anyway: the
  driver divides the masked fraction on the host, as the reference does;
* the spans of each shard's admissible candidates, gathered once a pass
  (:class:`ShardPrefix`). Admission sums spans in f32 over the whole
  batch's candidates in order, and past 2^24 summed bases those sums
  round (``dcorrect.admit_prefix``): a shard that summed its own
  candidates alone would admit differently from one device at E.coli
  depth. The reference's shards do, so its mesh departs from its single
  device there; the port's shard sums each candidate where the whole
  batch's sums would, and its mesh equals one device's;
* the read state, gathered once a bucket after the mesh loop, so that
  every rank runs the single-device finish pass on the whole bucket.

gloo also works where ranks share one card, which NCCL does not; NCCL
(device-side sums, no host round trip) is later performance work. A
collective is waited on by polling its ``Work``, so a wall-clock deadline
around it (``resilience.soft_deadline``) can fire; the group's own timeout
bounds every collective in any case.

Four layers live here:

* :func:`make_dp_mesh`: a :class:`DPMesh` over the alive ranks. Shard
  ``k`` runs on ``ranks[k]``; the shrunken rung after a shard loss passes
  the survivors, so the lost shard's rank holds no rows. Its collectives
  run over a group of every rank of the world all the same: a rank without
  a shard (a dropped shard's, or one past the mesh width) adds zeros, and
  its host stays in step (the same sampler draws, shortcut and reports)
  and receives the gathered state for the finish;
* :func:`compile_step_with_plan`: no mesh gives the plain step, a mesh the
  step on this rank's shard, its admission summed over the whole
  placement, plus the all-reduce of its sums. Nothing is compiled
  (PyTorch runs eagerly); the name is the reference's;
* :func:`build_sharded_step`: the cached step for ``(mesh, align params,
  consensus params, statics)``, and :func:`clear_step_cache`;
* :func:`sharded_iteration_step`: the reference's dryrun-era contract (the
  whole batch in, the whole batch out on every rank), for tests.

Read placement is not decided here: the driver permutes the bucket with
``parallel/plan.py:balance_placement`` before a rank takes its shard, and
un-permutes once after the gather.
"""

from __future__ import annotations

import datetime
import time
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from proovread_tpu_torch.align import bsw
from proovread_tpu_torch.align.params import AlignParams
from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.ops.assemble_kernel import (hcr_mask_rows,
                                                     mask_params_vec)
from proovread_tpu_torch.ops.encode import N
from proovread_tpu_torch.ops.scan import cumsum_f32_xla
from proovread_tpu_torch.pipeline.dcorrect import (_fused_pass,
                                                   _pad_candidates, _seed,
                                                   admit_prefix,
                                                   device_assemble,
                                                   qc_pass_row_stats,
                                                   qc_row_mask_counts)
from proovread_tpu_torch.pipeline.masking import MaskParams

# the step's all-reduced sums, in order: HCR-masked bases, total bases
# (both over valid rows), admitted, eligible, candidates, candidates past
# the per-shard cap
N_SUMS = 6
# per-row QC counts a step returns with collect_qc: masked columns, new
# length, edits, uplift
N_QC_ROWS = 4


def world() -> Tuple[int, int]:
    """(rank, world size) of this process's default group; (0, 1) without
    an initialised one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _wait(work) -> None:
    """Wait for a collective by polling, so that a deadline armed around
    the wait (SIGALRM, or an async exception on a thread) lands between
    bytecodes; ``wait`` then raises the collective's own error, gloo's
    timeout included."""
    while not work.is_completed():
        time.sleep(0.0002)
    work.wait()


@dataclass(eq=False)
class DPMesh:
    """The alive ranks of a mesh rung (shard ``k`` on ``ranks[k]``), this
    process's rank and the gloo group every rank of the world joins."""
    ranks: Tuple[int, ...]
    group: object
    rank: int
    world_size: int

    @property
    def n_shards(self) -> int:
        return len(self.ranks)

    @property
    def shard(self) -> Optional[int]:
        """This rank's shard ordinal, or None on a rank without a shard."""
        return (self.ranks.index(self.rank) if self.rank in self.ranks
                else None)

    def all_reduce(self, vec: np.ndarray) -> np.ndarray:
        """Element-wise int64 sum of ``vec`` over every rank."""
        import torch.distributed as dist
        t = torch.from_numpy(np.array(vec, dtype=np.int64))
        _wait(dist.all_reduce(t, group=self.group, async_op=True))
        return t.numpy()

    def gather_shards(self, parts: Optional[Sequence[torch.Tensor]],
                      like: Sequence[Tuple[tuple, torch.dtype]]
                      ) -> list:
        """Each array of the whole placement on every rank: ``parts`` are
        this rank's shard's host tensors (None on a rank without a shard),
        ``like`` one shard's (shape, dtype) per array, the dtype each part
        is sent as. Returns host tensors, shards in order."""
        import torch.distributed as dist
        out = []
        for i, (shape, dtype) in enumerate(like):
            mine = (parts[i].to(dtype).contiguous() if parts is not None
                    else torch.zeros(shape, dtype=dtype))
            bufs = [torch.empty_like(mine) for _ in range(self.world_size)]
            _wait(dist.all_gather(bufs, mine, group=self.group,
                                  async_op=True))
            out.append(torch.cat([bufs[r] for r in self.ranks]))
        return out


class ShardPrefix:
    """The admission's span sums (``dcorrect.admit_prefix``'s contract) of
    this rank's shard, each summed at the position the whole batch's
    admission would sum it: every rank gathers each shard's admissible
    spans (kept candidates, in admission order) with their rows' counts,
    lays them out in the placement's original row order (admission orders
    by read, then bin, score and candidate; a read's candidates are the
    same and in the same order in its shard), and runs the f32 prefix sum
    over all of them. ``order`` is the placement (``order[k*S + j]``: the
    original row of shard k's row j). A rank without a shard joins the
    gathers (:meth:`join`)."""

    def __init__(self, mesh: "DPMesh", order):
        self.mesh = mesh
        self.order = np.asarray(order)
        self.S = len(self.order) // mesh.n_shards

    def _gather(self, counts, spans):
        """Every shard's kept counts by row ([n, S]), their spans (shard k's
        first ``counts[k].sum()`` of row k of [n, width])."""
        n, S = self.mesh.n_shards, self.S
        counts_all = self.mesh.gather_shards(
            None if counts is None else [counts],
            [((S,), torch.int64)])[0].numpy().reshape(n, S)
        width = max(int(counts_all.sum(1).max()), 1)
        mine = None
        if spans is not None:
            mine = [torch.nn.functional.pad(spans, (0, width - len(spans)))]
        spans_all = self.mesh.gather_shards(
            mine, [((width,), torch.float32)])[0].reshape(n, width)
        return counts_all, spans_all

    def join(self) -> None:
        self._gather(None, None)

    def __call__(self, sspans, sbins, lr_sorted):
        dev = sspans.device
        K = int((sbins < (1 << 30)).sum())
        counts = torch.bincount(lr_sorted[:K], minlength=self.S).cpu()
        counts_all, spans_all = self._gather(counts, sspans[:K].cpu())
        # each original row's block in the whole batch's admission order
        row_counts = np.zeros(len(self.order), np.int64)
        row_counts[self.order] = counts_all.reshape(-1)
        row_start = np.cumsum(row_counts) - row_counts
        spans = torch.empty(int(row_counts.sum()), dtype=torch.float32)
        mine = None
        for k in range(self.mesh.n_shards):
            ck = counts_all[k]
            # a kept candidate's position there: its own plus its row's shift
            shift = np.repeat(row_start[self.order[k * self.S:
                                                   (k + 1) * self.S]]
                              - (np.cumsum(ck) - ck), ck)
            pos = torch.as_tensor(np.arange(ck.sum()) + shift)
            spans[pos] = spans_all[k, :len(pos)]
            if k == self.mesh.shard:
                mine = (pos, torch.as_tensor(shift))
        cum_all = cumsum_f32_xla(spans)
        pos, shift = mine
        first = torch.searchsorted(sbins, sbins, side="left")[:K].cpu()
        first = first + shift
        cum = torch.zeros_like(sspans)
        before = torch.zeros_like(sspans)
        cum[:K] = cum_all[pos].to(dev)
        before[:K] = torch.where(
            first > 0, cum_all[torch.clamp(first - 1, min=0)], 0.0).to(dev)
        return cum, before


def make_dp_mesh(n_devices: Optional[int] = None,
                 ranks: Optional[Sequence[int]] = None,
                 group=None, timeout: Optional[float] = None) -> DPMesh:
    """A mesh over ``ranks`` (default: the first ``n_devices`` ranks of the
    world, all of them without ``n_devices``). Passing the survivors is
    how the shrunken rung excludes a lost shard's rank. ``group`` reuses a
    gloo group over every rank of the world; without one a new group is
    made (every rank of the world must then call this together), with
    ``timeout`` seconds (default: torch's) on each of its collectives."""
    import torch.distributed as dist
    rank, size = world()
    if size < 2:
        raise RuntimeError(
            "a mesh needs an initialised torch.distributed process group "
            f"of 2 or more ranks (world size {size})")
    if ranks is None:
        ranks = range(n_devices or size)
    ranks = tuple(int(r) for r in ranks)
    if not ranks or any(not 0 <= r < size for r in ranks):
        raise ValueError(f"mesh ranks {ranks} outside a world of {size}")
    if group is None:
        group = dist.new_group(
            list(range(size)), backend="gloo",
            timeout=(datetime.timedelta(seconds=timeout)
                     if timeout else None))
    return DPMesh(ranks, group, rank, size)


def compile_step_with_plan(body, mesh: Optional[DPMesh] = None,
                           n_row_stats: int = 0):
    """The one place that knows how a step is partitioned (the reference's
    chokepoint). ``body(codes, qual, lengths, mask_cols, row_valid,
    prefix, *replicated)`` returns ``(state, sums, row_stats)``: ``sums``
    int64 [N_SUMS], ``row_stats`` int64 [n_row_stats, rows] (or None);
    ``prefix`` is its admission's span sums.

    No mesh: ``step(codes, qual, lengths, mask_cols, row_valid, order,
    *replicated)`` runs the body on the whole batch (``order`` unused).
    A mesh: the read tensors are this rank's shard (None on a rank without
    one), ``row_valid`` the whole placement's (host bool [rows]) and
    ``order`` the placement; the body runs on the shard with a
    :class:`ShardPrefix`, and its sums and row stats, each placed at the
    shard's rows, are all-reduced over every rank. The step returns this
    rank's new state (None without a shard), the sums and the whole
    placement's row stats."""
    if mesh is None:
        def plain(codes, qual, lengths, mask_cols, row_valid, order,
                  *replicated):
            return body(codes, qual, lengths, mask_cols, row_valid,
                        admit_prefix, *replicated)
        return plain

    def step(codes, qual, lengths, mask_cols, row_valid, order,
             *replicated):
        rows = len(row_valid)
        S = rows // mesh.n_shards
        vec = np.zeros(N_SUMS + n_row_stats * rows, np.int64)
        state = None
        k = mesh.shard
        prefix = ShardPrefix(mesh, order)
        if k is None:
            prefix.join()
        else:
            sl = slice(k * S, (k + 1) * S)
            state, sums, stats = body(codes, qual, lengths, mask_cols,
                                      row_valid[sl], prefix, *replicated)
            vec[:N_SUMS] = sums
            if n_row_stats:
                vec[N_SUMS:].reshape(n_row_stats, rows)[:, sl] = stats
        vec = mesh.all_reduce(vec)
        return (state, vec[:N_SUMS],
                vec[N_SUMS:].reshape(n_row_stats, rows))

    return step


# steps keyed by (mesh ranks, group, params, statics): a shrunken mesh or
# another align-params pass reuses its entry across buckets
_STEP_CACHE: dict = {}


def clear_step_cache() -> None:
    _STEP_CACHE.clear()


def build_sharded_step(mesh: Optional[DPMesh], ap: AlignParams,
                       cns: ConsensusParams, chunks_per_shard: int = 2,
                       chunk: int = 8192, seed_stride: int = 8,
                       seed_min_votes: int = 2, collect_qc: bool = False):
    """Build (or fetch cached) the sharded iteration step.

    ``step(codes, qual, lengths, mask_cols, row_valid, order, qc, rcq, qq,
    qlen, pvec) -> ((new_codes, new_qual, new_len, new_mask), sums,
    row_stats)``
    (:func:`compile_step_with_plan`): ``sums`` are (masked, total,
    n_admitted, n_eligible, n_candidates, n_dropped_cap); with
    ``collect_qc`` ``row_stats`` are each row's (masked columns, new
    length, edits, uplift).

    ``row_valid`` masks the masked/total sums: a mesh whose shard count
    does not divide the single-device row count pads EXTRA sentinel rows,
    and those must not enter the fraction's sums (the base pad rows up to
    the single-device row count are valid, as they are there). The
    fraction is divided on the host from the two integer sums, exactly
    like the single-device path, so the shortcut decision is rung- and
    mesh-shape-invariant.

    ``chunks_per_shard`` caps a shard's candidates at ``chunks_per_shard
    * chunk`` (the reference's static cap); overflow is counted in
    ``n_dropped_cap``. The driver treats a nonzero count as a mesh fault
    and retreats to the single-device rung (dynamic chunk count, never
    truncates) instead of accepting truncated, and therefore mesh-shape-
    dependent, output."""
    key = (None if mesh is None else (mesh.ranks, id(mesh.group)), ap, cns,
           chunks_per_shard, chunk, seed_stride, seed_min_votes, collect_qc)
    step = _STEP_CACHE.get(key)
    if step is not None:
        return step

    W = bsw.band_lanes(ap)
    CH = chunk
    n_chunks = chunks_per_shard
    R_need = n_chunks * CH

    def local_step(codes, qual, lengths, mask_cols, row_valid, prefix,
                   qc, rcq, qq, qlen, pvec):
        Lp = codes.shape[1]
        dev = codes.device
        map_codes = torch.where(mask_cols, N, codes).to(codes.dtype)
        sread, strand, lread, diag, n_valid = _seed(
            map_codes, lengths, qc, qlen, rcq, ap, seed_stride,
            seed_min_votes)
        n_valid = int(n_valid)
        sread, strand, lread, diag = _pad_candidates(sread, strand, lread,
                                                     diag, R_need)
        call, n_adm, n_elig, _, _, _ = _fused_pass(
            map_codes, mask_cols, codes, qual, lengths, qc, rcq, qq, qlen,
            sread, strand, lread, diag, min(n_valid, R_need),
            m=qc.shape[1], W=W, CH=CH, n_chunks=n_chunks, ap=ap, cns=cns,
            collect=False, prefix=prefix)
        new_codes, new_qual, new_len = device_assemble(call, lengths, Lp)
        new_mask, _ = hcr_mask_rows(new_qual, new_len, pvec)
        valid = torch.as_tensor(row_valid, device=dev)
        dev_sums = torch.stack([
            (new_mask & valid[:, None]).sum(),
            torch.where(valid, new_len, 0).sum(),
            n_adm, n_elig]).to(torch.int64)
        stats = None
        if collect_qc:
            ed, up = qc_pass_row_stats(call, codes, qual, lengths)
            stats = torch.stack([qc_row_mask_counts(new_mask), new_len,
                                 ed, up]).to(torch.int64).cpu().numpy()
        sums = np.concatenate([dev_sums.cpu().numpy(),
                               [n_valid, max(n_valid - R_need, 0)]])
        return (new_codes, new_qual, new_len, new_mask), sums, stats

    step = compile_step_with_plan(local_step, mesh,
                                  n_row_stats=N_QC_ROWS if collect_qc else 0)
    _STEP_CACHE[key] = step
    return step


def sharded_iteration_step(mesh: DPMesh, ap: AlignParams,
                           cns: ConsensusParams, mask_params: MaskParams,
                           Lp: int, m: int, chunks_per_shard: int = 2,
                           chunk: int = 8192, seed_stride: int = 8,
                           seed_min_votes: int = 2):
    """The reference's dryrun-era contract over :func:`build_sharded_step`:
    ``run(codes, qual, lengths, mask_cols, qc, rcq, qq, qlen) ->
    (new_codes, new_qual, new_lengths, new_mask, masked_frac,
    n_admitted)``, the whole batch in and out on every rank (its rows
    split contiguously over the shards), static mask params, the fraction
    derived from the summed integers. ``Lp`` and ``m`` are kept for the
    reference's signature; the tensors carry them."""
    del Lp, m
    step = build_sharded_step(
        mesh, ap, cns, chunks_per_shard=chunks_per_shard, chunk=chunk,
        seed_stride=seed_stride, seed_min_votes=seed_min_votes)
    pvec = mask_params_vec(mask_params)

    def run(codes, qual, lengths, mask_cols, qc, rcq, qq, qlen):
        B, L = codes.shape
        S = B // mesh.n_shards
        if S * mesh.n_shards != B:
            raise ValueError(f"{B} rows do not split over "
                             f"{mesh.n_shards} shards")
        k = mesh.shard
        part = None
        if k is not None:
            sl = slice(k * S, (k + 1) * S)
            part = (codes[sl], qual[sl], lengths[sl], mask_cols[sl])
        state, sums, _ = step(*(part or (None,) * 4), np.ones(B, bool),
                              np.arange(B), qc, rcq, qq, qlen, pvec)
        like = [((S, L), codes.dtype), ((S, L), qual.dtype),
                ((S,), lengths.dtype), ((S, L), torch.bool)]
        full = mesh.gather_shards(
            None if state is None else [t.cpu() for t in state], like)
        nc, nq, nl, nm = (t.to(codes.device) for t in full)
        frac = float(np.float32(sums[0]) / np.float32(max(int(sums[1]), 1)))
        return nc, nq, nl, nm, frac, int(sums[2])

    return run
