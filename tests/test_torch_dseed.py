"""Port parity: device seeding (index, probes, clustering, compaction).

Inputs are TestDeviceSeed's (tests/test_device_path.py), plus masked index
columns and the finish schedule's k=17 (a k-mer longer than the 12-base
bucket table, so hits verify the full k-mer). Tolerance: bitwise."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from proovread_tpu.align import dseed as jds
from proovread_tpu.align.params import AlignParams as JAlign, BWA_SR_FINISH
from proovread_tpu.pipeline.dcorrect import device_revcomp as j_revcomp

from proovread_tpu_torch.align import dseed as tds
from proovread_tpu_torch.align.params import AlignParams
from proovread_tpu_torch.pipeline.dcorrect import device_revcomp


def _batch(seed=6, B=4, L=1024, nq=32, qlen=100, n_mask=0):
    """TestDeviceSeed._batch (plus optional N-masked index columns and
    zero-length pad queries)."""
    rng = np.random.default_rng(seed)
    lr = rng.integers(0, 4, (B, L)).astype(np.int8)
    lengths = np.full(B, L, np.int32)
    qs = []
    for _ in range(nq):
        b = int(rng.integers(0, B))
        p = int(rng.integers(0, L - qlen))
        qs.append(lr[b, p:p + qlen].copy())
    q = np.full((nq, 112), 4, np.int8)
    q[:, :qlen] = np.stack(qs)
    ql = np.full(nq, qlen, np.int32)
    ql[-2:] = 0
    q[-2:] = 4
    if n_mask:
        for b in range(B):
            a = int(rng.integers(0, L - n_mask))
            lr[b, a:a + n_mask] = 4
    return lr, lengths, q, ql


@pytest.mark.parametrize("finish,n_mask", [(False, 0), (False, 300),
                                           (True, 0)])
def test_seed_bitwise_vs_jax(finish, n_mask):
    jap = BWA_SR_FINISH if finish else JAlign()
    tap = AlignParams(**{f: getattr(jap, f)
                         for f in jap.__dataclass_fields__})
    lr, lengths, q, ql = _batch(n_mask=n_mask)
    jq = jnp.asarray(q)
    jrc = j_revcomp(jq, jnp.asarray(ql))
    jidx = jds.device_index(jnp.asarray(lr), jnp.asarray(lengths),
                            jap.min_seed_len)
    jc = jds.probe_candidates(jidx, jq, jnp.asarray(ql), jrc, jap, stride=8,
                              min_votes=2)
    jcomp = jds.compact_candidates(jc)

    tq = torch.as_tensor(q)
    trc = device_revcomp(tq, torch.as_tensor(ql))
    tidx = tds.build_index(torch.as_tensor(lr), torch.as_tensor(lengths),
                           tap.min_seed_len)
    assert tidx.shift == jidx.shift == (10 if finish else 0)
    np.testing.assert_array_equal(tidx.kmers.numpy(),
                                  np.asarray(jidx.kmers).astype(np.int64))
    np.testing.assert_array_equal(tidx.gpos.numpy(), np.asarray(jidx.gpos))
    np.testing.assert_array_equal(tidx.starts.numpy(),
                                  np.asarray(jidx.starts))
    np.testing.assert_array_equal(tidx.counts.numpy(),
                                  np.asarray(jidx.counts))
    tc = tds.probe_candidates(tidx, tq, torch.as_tensor(ql), trc, tap,
                              stride=8, min_votes=2)
    for f in ("lread", "diag", "votes"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    assert int((tc.lread >= 0).sum()) >= 15
    tcomp = tds.compact_candidates(tc)
    for name, a, b in zip(("sread", "strand", "lread", "diag", "n_valid"),
                          jcomp, tcomp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)


def test_probe_slabs_match_one_slab(monkeypatch):
    """Slabbing the queries (bounds the clustering transient) changes
    nothing: a non-divisor slab against one slab."""
    lr, lengths, q, ql = _batch(seed=7)
    ap = AlignParams()
    tq, tql = torch.as_tensor(q), torch.as_tensor(ql)
    trc = device_revcomp(tq, tql)
    idx = tds.build_index(torch.as_tensor(lr), torch.as_tensor(lengths),
                          ap.min_seed_len)
    one = tds.probe_candidates(idx, tq, tql, trc, ap, stride=8)
    monkeypatch.setattr(tds, "PROBE_SLAB", 7)
    many = tds.probe_candidates(idx, tq, tql, trc, ap, stride=8)
    for a, b in zip(one, many):
        assert torch.equal(a, b)
