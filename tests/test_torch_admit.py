"""Binned admission past 2^24 summed span bases.

At high coverage a pass's summed candidate spans pass 2^24. The reference
sums them with an f32 ``jnp.cumsum`` (``pipeline/dcorrect.py:device_admit``),
which then rounds and can flip ``cum_before <= bin_max_bases`` by a few
bases. The port reproduces those sums bit for bit (``ops/scan.py``), so its
admission equals the reference's; the host oracle
``consensus/alnset.py:admit_mask`` sums in f64 and departs from both.
Tolerance: bitwise."""

import numpy as np
import jax.numpy as jnp
import torch

from proovread_tpu.consensus.alnset import admit_mask
from proovread_tpu.consensus.params import ConsensusParams as JCns
from proovread_tpu.pipeline.dcorrect import device_admit as j_admit

from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.ops.scan import cumsum_f32_xla
from proovread_tpu_torch.pipeline.dcorrect import device_admit


def _pass(seed, R, B, L, span_lo, span_hi):
    rng = np.random.default_rng(seed)
    lread = np.sort(rng.integers(0, B, R)).astype(np.int32)
    span = rng.integers(span_lo, span_hi + 1, R).astype(np.int32)
    pos0 = rng.integers(0, L - span_hi, R).astype(np.int32)
    score = rng.integers(50, 201, R).astype(np.float32)
    passed = rng.random(R) < 0.95
    ref_lens = np.full(B, L, np.int32)
    assert int(span[passed].sum()) > 1 << 24
    return lread, pos0, span, score, passed, ref_lens


def _both(arrays, max_coverage):
    t = torch.as_tensor
    got = device_admit(*(t(a) for a in arrays),
                       ConsensusParams(max_coverage=max_coverage)).numpy()
    ref = np.asarray(j_admit(*(jnp.asarray(a) for a in arrays),
                             JCns(max_coverage=max_coverage)))
    return got, ref


def test_admission_past_2_24_matches_host_oracle():
    """Synthetic pass: 200,000 candidates, spans 90-110, over 64 reads of
    1 kb, ``max_coverage=150`` (bin budget 3000 bases, every bin over-full).
    The port equals the reference; both depart from the f64 host oracle in
    the same 3 candidates (seed 0, first index 185291: the oracle admits
    it, the f32 sums do not)."""
    arrays = _pass(0, 200_000, 64, 1000, 90, 110)
    lread, pos0, span, score, passed, ref_lens = arrays
    got, ref = _both(arrays, 150)
    np.testing.assert_array_equal(got, ref)
    want = admit_mask(lread, pos0, span, score, ref_lens,
                      JCns(max_coverage=150), valid=passed)
    assert 0 < want.sum() < passed.sum()
    diff = np.flatnonzero(got != want)
    assert len(diff) == 3 and diff[0] == 185291
    assert want[185291] and not got[185291]


def test_admission_four_scan_levels_matches_reference():
    """R = 70,001 (not a multiple of 16, past 16^4): the blocked scan
    recurses four times before its last left fold."""
    arrays = _pass(1, 70_001, 16, 4000, 230, 290)
    got, ref = _both(arrays, 100)
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < arrays[4].sum()


def test_blocked_scan_matches_jnp_cumsum():
    """10^6 f32 integers in 90-110 (seed 0): bitwise equal to ``jnp.cumsum``
    on the CPU, where a sequential f32 fold and ``torch.cumsum`` are not."""
    rng = np.random.default_rng(0)
    x = rng.integers(90, 111, 1_000_000).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x)))
    got = cumsum_f32_xla(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.cumsum(x, dtype=np.float32) != want).sum() > 0
    for n in (0, 1, 16, 17, 4097):
        np.testing.assert_array_equal(
            cumsum_f32_xla(torch.as_tensor(x[:n])).numpy(),
            np.asarray(jnp.cumsum(jnp.asarray(x[:n]))))
