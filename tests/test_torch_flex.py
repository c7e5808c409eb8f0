"""Port parity: flex mode (``haplo_coverage``, the ``proovread-flex`` role).

The same seeded numpy inputs go through the JAX package and the port on
the CPU: ``estimate_haplo_coverage`` on random pileup tensors with rows
that have no variant column (+inf), rows with too few columns for the
significance test and rows of two haplotypes; ``device_admit`` with a
per-read ``budget_r`` (finite, +inf and tighter than ``bin_max_bases``);
and ``Pipeline.run`` with ``haplo_coverage`` bare (-1.0) and explicit
(12.0) on a two-haplotype case after ``tests/test_flex.py:_make_case``
(a read of haplotype A, 8x of A short reads, 30x of B). Tolerance:
bitwise (estimates, admission masks) and equal (records, reports,
metrics, QC)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proovread_tpu.consensus.params import ConsensusParams as JCns
from proovread_tpu.io.records import SeqRecord as JRecord
from proovread_tpu.ops.encode import decode_codes, revcomp_codes
from proovread_tpu.pipeline import dcorrect as jdc
from proovread_tpu.pipeline.trim import TrimParams as JTrim

from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.pipeline import dcorrect as tdc
from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
from proovread_tpu_torch.pipeline.trim import TrimParams

from test_torch_pipeline import _compare, _port_records, run_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on a few cores, and torch's CPU kernels in each spreading over
    every core slow all of them down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pileup(rng, B, L):
    """Counts of a few kinds of row: 0 no variant column (all +inf), 1 two
    haplotypes at ~8x/30x with many variant columns, 2 a single variant
    column, 3 noise with composite (insertion) states, 4 empty."""
    counts = np.zeros((B, L, 6), np.float32)
    ins = np.zeros((B, L, 6), np.float32)
    ref = rng.integers(0, 5, (B, L)).astype(np.int8)
    lengths = np.array([L, L - 7, L, L - 40, 0, L][:B], np.int32)
    counts[0, :, 0] = 20.0
    for b in (1, 5):
        a_base = rng.integers(0, 4, L)
        counts[b, np.arange(L), a_base] = rng.integers(6, 11, L)
        var = rng.random(L) < 0.3
        b_base = (a_base + 1) % 4
        counts[b, np.flatnonzero(var), b_base[var]] = rng.integers(
            25, 35, int(var.sum()))
        ref[b] = a_base
    counts[2, :, 1] = 12.0
    counts[2, 50, 2] = 5.0
    counts[3] = rng.integers(0, 7, (L, 6))
    ins[3] = rng.integers(0, 5, (L, 6))
    counts[3] += ins[3]
    return counts, ins, ref, lengths


def test_estimate_haplo_coverage_matches_jax():
    rng = np.random.default_rng(21)
    counts, ins, ref, lengths = _pileup(rng, 6, 300)
    plain = counts - ins
    cov = counts.sum(-1)
    want = np.asarray(jdc.estimate_haplo_coverage(
        *(jnp.asarray(a) for a in (plain, ins, cov, ref, lengths))))
    got = tdc.estimate_haplo_coverage(
        *(torch.as_tensor(a) for a in (plain, ins, cov, ref, lengths)))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()
    assert np.isinf(want[[0, 4]]).all() and np.isfinite(want[[1, 5]]).all()


def test_device_admit_with_budget_matches_jax():
    rng = np.random.default_rng(22)
    R, B, L = 700, 4, 900
    lread = np.sort(rng.integers(0, B, R)).astype(np.int32)
    span = rng.integers(1, 110, R).astype(np.int32)
    pos0 = rng.integers(0, L - 110, R).astype(np.int32)
    score = rng.integers(50, 201, R).astype(np.float32)
    passed = rng.random(R) < 0.9
    ref_lens = np.full(B, L, np.int32)
    budget = np.array([np.inf, 100.0, 20.0 * 2.5, 5000.0], np.float32)
    arrays = (lread, pos0, span, score, passed, ref_lens)
    admitted = {}
    for name, budget_r in (("budget", budget), ("none", None)):
        want = np.asarray(jdc.device_admit(
            *(jnp.asarray(a) for a in arrays), JCns(max_coverage=8),
            budget_r=None if budget_r is None else jnp.asarray(budget_r)))
        got = tdc.device_admit(
            *(torch.as_tensor(a) for a in arrays),
            ConsensusParams(max_coverage=8),
            None if budget_r is None else torch.as_tensor(budget_r)).numpy()
        assert got.tobytes() == want.tobytes()
        admitted[name] = got
    # reads 1 and 2 lose candidates to their tighter budgets, 0 and 3 none
    for b, fewer in enumerate((False, True, True, False)):
        mine = lread == b
        n_b, n_n = (int(admitted[k][mine].sum()) for k in ("budget", "none"))
        assert (n_b < n_n) == fewer and n_b > 0


def _two_haplotypes(seed=0, L=600, snp_every=60, cov_a=8, cov_b=30):
    """``tests/test_flex.py:_make_case``: a CLR-like read of haplotype A
    (4% substitutions away from the SNPs), 100 bp short reads of A at
    ``cov_a`` and of B (A with a SNP every ``snp_every`` bases) at
    ``cov_b``, both strands."""
    rng = np.random.default_rng(seed)
    hap_a = rng.integers(0, 4, L).astype(np.int8)
    hap_b = hap_a.copy()
    snps = np.arange(snp_every // 2, L - 10, snp_every)
    for p in snps:
        hap_b[p] = (hap_b[p] + 1 + rng.integers(0, 3)) % 4
    lr = hap_a.copy()
    noise = rng.random(L) < 0.04
    lr[noise] = (lr[noise] + 1 + rng.integers(0, 3, int(noise.sum()))) % 4
    lr[snps] = hap_a[snps]

    def reads_from(hap, cov, tag):
        out = []
        for i in range(int(cov * L / 100)):
            st = int(rng.integers(0, L - 100))
            seq = hap[st:st + 100].copy()
            if rng.random() < 0.5:
                seq = revcomp_codes(seq)
            out.append(JRecord(f"{tag}{i}", decode_codes(seq),
                               qual=np.full(100, 30, np.uint8)))
        return out

    srs = reads_from(hap_a, cov_a, "a") + reads_from(hap_b, cov_b, "b")
    return [JRecord("read_1", decode_codes(lr))], srs


@pytest.mark.parametrize("haplo", [-1.0, 12.0])
def test_pipeline_flex_matches_jax(haplo):
    longs, srs = _two_haplotypes()
    jres, tres = run_both(longs, srs, n_iterations=2, sampling=False,
                          sr_coverage=100.0, finish_coverage=100.0,
                          device_chunk=128, haplo_coverage=haplo,
                          trim=JTrim(min_length=100))
    _compare(jres, tres)
    assert [r.task for r in tres.reports] == [
        "bwa-sr-1", "bwa-sr-2", "bwa-sr-finish"]
    # the budget bites: the same run without flex admits more and writes
    # another read
    kw = dict(n_iterations=2, sampling=False, sr_coverage=100.0,
              finish_coverage=100.0, device_chunk=128, device="cpu",
              trim=TrimParams(min_length=100))
    plain = Pipeline(PipelineConfig(**kw)).run(_port_records(longs),
                                               _port_records(srs))
    assert (sum(r.n_admitted for r in tres.reports)
            < sum(r.n_admitted for r in plain.reports))
    assert tres.untrimmed[0].seq != plain.untrimmed[0].seq
