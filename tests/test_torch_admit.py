"""Binned admission past 2^24 summed span bases.

At high coverage a pass's summed candidate spans pass 2^24 (the reference
sums them with an f32 ``cumsum``, ``pipeline/dcorrect.py:device_admit``,
which then rounds and can flip ``cum_before <= bin_max_bases`` by a few
bases). The port sums exactly and must equal the host oracle
``consensus/alnset.py:admit_mask`` (f64 sums). Synthetic pass: 200,000
candidates, spans 90-110, over 64 reads of 1 kb, ``max_coverage=150``
(bin budget 3000 bases, so every bin is over-full)."""

import numpy as np
import jax.numpy as jnp
import torch

from proovread_tpu.consensus.alnset import admit_mask
from proovread_tpu.consensus.params import ConsensusParams as JCns
from proovread_tpu.pipeline.dcorrect import device_admit as j_admit

from proovread_tpu_torch.consensus.params import ConsensusParams
from proovread_tpu_torch.pipeline.dcorrect import device_admit


def test_admission_past_2_24_matches_host_oracle():
    rng = np.random.default_rng(0)
    R, B, L = 200_000, 64, 1000
    lread = np.sort(rng.integers(0, B, R)).astype(np.int32)
    span = rng.integers(90, 111, R).astype(np.int32)
    pos0 = rng.integers(0, L - 110, R).astype(np.int32)
    score = rng.integers(50, 201, R).astype(np.float32)
    passed = rng.random(R) < 0.95
    ref_lens = np.full(B, L, np.int32)
    assert int(span[passed].sum()) > 1 << 24

    want = admit_mask(lread, pos0, span, score, ref_lens,
                      JCns(max_coverage=150), valid=passed)
    t = torch.as_tensor
    got = device_admit(t(lread), t(pos0), t(span), t(score), t(passed),
                       t(ref_lens), ConsensusParams(max_coverage=150))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < passed.sum()

    # the reference's f32 sums do round here (ROADMAP queue 3)
    ref = np.asarray(j_admit(*(jnp.asarray(a) for a in (
        lread, pos0, span, score, passed, ref_lens)), JCns(max_coverage=150)))
    assert (ref != want).sum() > 0
