"""Port parity: the ordered scatter-add (``ops/scatter.py``) and the pileup
``accumulate`` built on it.

The plain ordered scatter is held against the reference's XLA scatter
(``jnp.zeros(...).at[idx].add(w, mode="drop")``) and against torch's CPU
``index_add_`` on fractional weights with heavy duplication, an empty
``keep`` and indices past the target (dropped, as ``mode="drop"``
drops them); ``accumulate`` against ``proovread_tpu.ops.pileup.accumulate`` on
seeded column-state windows, with and without ``ignore_mask``, over two
chunks into one pileup. Tolerance: bitwise (f32 sums of fractional votes
in the reference's order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proovread_tpu.ops import pileup as jpileup

from proovread_tpu_torch.ops import pileup as tpileup
from proovread_tpu_torch.ops import scatter as tscatter


def _bits(a):
    a = np.asarray(a)
    return a.dtype, a.shape, a.tobytes()


def _inputs(rng, N, M, oob=False):
    """Fractional weights onto few cells (segments of up to ~M/N*4
    entries), a keep mask, and with ``oob`` indices at and past N (the
    reference's drop row is N; it makes no negative index, which JAX
    would wrap)."""
    hot = rng.integers(0, N, max(1, N // 4))
    idx = np.where(rng.random(M) < 0.8, rng.choice(hot, M),
                   rng.integers(0, N, M)).astype(np.int64)
    if oob:
        idx[rng.random(M) < 0.1] = N + rng.integers(0, 5)
    w = (rng.random(M) * rng.choice([0.01, 1.0, 37.0], M)).astype(np.float32)
    keep = rng.random(M) < 0.7
    base = (rng.random(N) * 3).astype(np.float32)
    return base, idx, w, keep


@pytest.mark.parametrize("case", ["dup", "oob", "empty", "all"])
def test_plain_scatter_matches_xla_and_index_add(case):
    rng = np.random.default_rng({"dup": 1, "oob": 2, "empty": 3,
                                 "all": 4}[case])
    N, M = 97, 5000
    base, idx, w, keep = _inputs(rng, N, M, oob=case == "oob")
    if case == "empty":
        keep[:] = False
    if case == "all":
        keep[:] = True
    drop = np.where(keep, idx, N)             # the reference's OOB row
    want = jnp.asarray(base).at[drop].add(w, mode="drop")
    got = tscatter.scatter_add_ordered(
        torch.as_tensor(base.copy()), torch.as_tensor(idx),
        torch.as_tensor(w), torch.as_tensor(keep))
    assert _bits(got.numpy()) == _bits(want)
    live = keep & (idx >= 0) & (idx < N)
    ref = torch.as_tensor(base.copy()).index_add_(
        0, torch.as_tensor(idx[live]), torch.as_tensor(w[live]))
    assert _bits(got.numpy()) == _bits(ref.numpy())
    if case == "empty":
        assert _bits(got.numpy()) == _bits(base)
    else:
        # the order matters: the same adds in reverse order differ
        li = np.flatnonzero(live)[::-1]
        rev = torch.as_tensor(base.copy()).index_add_(
            0, torch.as_tensor(idx[li]), torch.as_tensor(w[li]))
        assert _bits(got.numpy()) != _bits(rev.numpy())


def test_scatter_checks_its_arguments():
    t = torch.zeros(4)
    i = torch.zeros(3, dtype=torch.int64)
    w = torch.ones(3)
    k = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="int64"):
        tscatter.scatter_add_ordered(t, i.to(torch.int32), w, k)
    with pytest.raises(ValueError, match="one shape"):
        tscatter.scatter_add_ordered(t, i, w[:2], k)
    with pytest.raises(ValueError, match="contiguous flat"):
        tscatter.scatter_add_ordered(torch.zeros(2, 2), i, w, k)


def _windows(rng, B, L, R, W, K):
    read_idx = rng.integers(0, B, R).astype(np.int32)
    rpos = rng.integers(-30, L - 20, R).astype(np.int32)
    state = rng.integers(-1, 6, (R, W)).astype(np.int8)
    state[:, W - rng.integers(0, W // 2):] = -1
    freq = (rng.random((R, W)) * rng.choice([0.01, 1.0, 0.83], (R, W))
            ).astype(np.float32)
    ins_len = np.where(rng.random((R, W)) < 0.15,
                       rng.integers(1, K + 3, (R, W)), 0).astype(np.int16)
    ins_bases = rng.integers(0, 6, (R, W, K)).astype(np.int8)
    valid = rng.random(R) < 0.9
    return read_idx, rpos, state, freq, ins_len, ins_bases, valid


@pytest.mark.parametrize("ignore", [False, True])
def test_accumulate_matches_jax(ignore):
    rng = np.random.default_rng(5 + ignore)
    B, L, K, W = 3, 150, 6, 128
    ign = (rng.random((B, L)) < 0.2) if ignore else None
    jp = jpileup.init_pileup(B, L, K)
    tp = tpileup.init_pileup(B, L, K)
    for R in (70, 33):                  # two chunks into one pileup
        arrs = _windows(rng, B, L, R, W, K)
        jp = jpileup.accumulate(
            jp, *(jnp.asarray(a) for a in arrs),
            None if ign is None else jnp.asarray(ign))
        tp = tpileup.accumulate(
            tp, *(torch.as_tensor(a) for a in arrs),
            None if ign is None else torch.as_tensor(ign))
    for name in jp._fields:
        assert _bits(getattr(tp, name).numpy()) == _bits(getattr(jp, name))
    assert float(tp.ins_base_votes.sum()) > 0
