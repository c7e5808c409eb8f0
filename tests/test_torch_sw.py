"""Port parity: ``align/sw.py:sw_batch`` (the plain PyTorch version the
wrapper runs on CPU tensors), ``ops_to_cigar`` and the host seeder
``align/seed.py``.

Random batches made with numpy go through the JAX ``sw_batch`` (XLA on the
CPU) and the port. Tolerance: every ``SWResult`` field bitwise equal, dtype
included. The batches hold queries planted in their windows with
substitutions and indels, clipped heads, chance pairs, tandem repeats (equal scores at
several end cells), N codes in queries and windows, and queries shorter
than m, of length 1 and of length 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from proovread_tpu.align import seed as jseed
from proovread_tpu.align import sw as jsw
from proovread_tpu.align.params import AlignParams as JParams

from proovread_tpu_torch.align import seed as tseed
from proovread_tpu_torch.align import sw as tsw
from proovread_tpu_torch.align.params import AlignParams

PARAMS = {
    # siamaera's mapper, the defaults (BWA_SR scoring) and the finish scoring
    "siamaera": dict(min_out_score=0.0, score_per_base=False),
    "default": {},
    "finish": dict(mismatch=13, o_del=15, e_del=3, o_ins=19, e_ins=3,
                   min_seed_len=17, band_width=30, min_out_score=4.0),
}


def _batch(rng, R, m, n):
    r = rng.integers(0, 4, (R, n)).astype(np.int8)
    q = np.full((R, m), 4, np.int8)
    ql = rng.integers(m // 2, m + 1, R).astype(np.int32)
    ql[:4] = [0, 1, m, 3]
    for i in range(R):
        kind = i % 6
        st = int(rng.integers(0, n - m))
        src = r[i, st:st + m].copy()
        if kind == 0:
            src = rng.integers(0, 4, m).astype(np.int8)        # chance pair
        elif kind == 1:
            src = np.insert(src, m // 3, rng.integers(0, 4, 3))[:m]
        elif kind == 2:
            src = np.append(np.delete(src, slice(m // 2, m // 2 + 2)),
                            [0, 1])
        elif kind == 3:
            unit = rng.integers(0, 4, 4).astype(np.int8)       # repeats
            r[i] = np.resize(unit, n)
            src = np.resize(unit, m)
        elif kind == 4:                                    # clipped head
            src = np.concatenate([rng.integers(0, 4, 20).astype(np.int8),
                                  src])[:m]
        sub = rng.random(m) < 0.03
        src[sub] = (src[sub] + 1) % 4
        q[i, :ql[i]] = src[:ql[i]]
    q[rng.random((R, m)) < 0.01] = 4
    r[rng.random((R, n)) < 0.01] = 4
    return q, r, ql


def _jax_fields(q, r, ql, params):
    res = jsw.sw_batch(jnp.asarray(q), jnp.asarray(r), jnp.asarray(ql),
                       JParams(**params))
    return {f: np.asarray(getattr(res, f)) for f in res._fields}


@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("seed,R,m,n", [(0, 48, 32, 128), (1, 24, 48, 128),
                                        (2, 12, 64, 256)])
def test_sw_batch_matches_jax(name, seed, R, m, n):
    q, r, ql = _batch(np.random.default_rng(seed), R, m, n)
    want = _jax_fields(q, r, ql, PARAMS[name])
    got = tsw.sw_batch(torch.as_tensor(q), torch.as_tensor(r),
                       torch.as_tensor(ql), AlignParams(**PARAMS[name]))
    assert list(want) == list(got._fields)
    for f in got._fields:
        a, b = want[f], getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    # the batch exercises what it claims: a walk through every op, and
    # clipped starts where gaps cost more than the clip
    assert int(want["n_ops"].max()) >= m - 2
    assert name != "finish" or (want["q_start"] > 0).any()
    assert set(np.unique(want["ops_rev"])) >= {0, 1, 2, 3}


def test_sw_batch_device_checks():
    q = torch.zeros((2, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="int32"):
        tsw.sw_batch(q, torch.zeros((2, 128), dtype=torch.int8),
                     torch.zeros(2, dtype=torch.int64), AlignParams())
    meta = torch.zeros((2, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="device"):
        tsw.sw_batch(meta, torch.zeros((2, 128), dtype=torch.int8,
                                       device="meta"),
                     torch.zeros(2, dtype=torch.int32, device="meta"),
                     AlignParams())


def test_ops_to_cigar_matches_jax():
    q, r, ql = _batch(np.random.default_rng(3), 36, 32, 128)
    res = _jax_fields(q, r, ql, PARAMS["default"])
    for i in range(len(ql)):
        args = (res["ops_rev"][i], int(res["n_ops"][i]),
                int(res["q_start"][i]), int(res["q_end"][i]), int(ql[i]))
        for a, b in zip(jsw.ops_to_cigar(*args), tsw.ops_to_cigar(*args)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("k", [12, 13, 17])
def test_seed_candidates_match_jax(k):
    rng = np.random.default_rng(4)
    B, L, S, m = 3, 700, 60, 100
    refs = rng.integers(0, 4, (B, L)).astype(np.int8)
    ref_len = np.array([700, 650, 400], np.int32)
    for b in range(B):
        refs[b, ref_len[b]:] = 4
    q = np.full((S, m), 4, np.int8)
    qlen = rng.integers(40, m + 1, S).astype(np.int32)
    for s in range(S):
        b = int(rng.integers(0, B))
        st = int(rng.integers(0, ref_len[b] - m))
        src = refs[b, st:st + m].copy()
        src[rng.random(m) < 0.02] = 4
        q[s, :qlen[s]] = src[:qlen[s]]
    q[:10] = rng.integers(0, 4, (10, m))                 # chance seeds
    jp, tp = JParams(min_seed_len=k), AlignParams(min_seed_len=k)
    rc_j = jseed.revcomp_batch(q, qlen)
    rc_t = tseed.revcomp_batch(q, qlen)
    assert np.array_equal(rc_j, rc_t)
    ij = jseed.build_index(refs, ref_len, k)
    it = tseed.build_index(refs, ref_len, k)
    for a, b in zip(ij, it):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    cj = jseed.find_candidates(ij, q, qlen, jp, rc=rc_j)
    ct = tseed.find_candidates(it, q, qlen, tp, rc=rc_t)
    assert len(cj.sread) >= S // 2
    for a, b in zip(cj, ct):
        assert a.dtype == b.dtype and np.array_equal(a, b)
