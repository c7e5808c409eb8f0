"""Port parity: dense vote slabs (``build_votes``), uniform and qual-weighted.

Seeded expanded-alignment columns (states with deletions and 1D1I columns,
insertion runs crossing the InDelTaboo edges, MCR-ignored and out-of-bounds
columns, rejected candidates) go through the JAX ``build_votes`` and the
port's. Tolerance: bitwise (every lane of a slab gets at most one weight,
and the port's ``phred2freq`` computes what the CPU-compiled reference
does)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from proovread_tpu.ops.votes import build_votes as j_build_votes

from proovread_tpu_torch.ops.votes import build_votes


def _columns(rng, R=96, n=176, m=112):
    state = rng.integers(-1, 6, (R, n)).astype(np.int32)
    state[rng.random((R, n)) < 0.1] = 5                     # deletions
    qrow = np.sort(rng.integers(0, m, (R, n)), axis=1).astype(np.int32)
    ins_len = np.where(rng.random((R, n)) < 0.15,
                       rng.integers(1, 9, (R, n)), 0).astype(np.int32)
    q = rng.integers(0, 5, (R, m)).astype(np.int8)
    qual = rng.integers(0, 42, (R, m)).astype(np.uint8)
    q_start = rng.integers(0, 20, R).astype(np.int32)
    q_end = np.minimum(q_start + rng.integers(20, 110, R), m).astype(np.int32)
    keep = rng.random(R) < 0.85
    ignore = rng.random((R, n)) < 0.1
    in_bounds = rng.random((R, n)) < 0.9
    return state, qrow, ins_len, q, qual, q_start, q_end, keep, ignore, \
        in_bounds


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("qual_weighted", [False, True])
def test_build_votes_matches_jax(seed, qual_weighted):
    rng = np.random.default_rng(seed)
    cols = _columns(rng)
    kw = dict(qual_weighted=qual_weighted, taboo_frac=0.1,
              taboo_abs=7 if seed else 0, min_aln_length=30)
    want = np.asarray(j_build_votes(
        *(jnp.asarray(a) for a in cols[:8]), ignore_cols=jnp.asarray(cols[8]),
        in_bounds=jnp.asarray(cols[9]), **kw))
    got = build_votes(*(torch.as_tensor(a) for a in cols[:8]),
                      ignore_cols=torch.as_tensor(cols[8]),
                      in_bounds=torch.as_tensor(cols[9]), **kw).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (want[:, :, 16:22] > 0).any() and (want[:, :, 24:54] > 0).any()
    frac = want[(want > 0) & (want != np.round(want))]
    assert (frac.size > 0) == qual_weighted
