"""Port parity: vote bit planes, pileup accumulation and the consensus call.

Seeded packed vote words go through ``word_to_bits``, two chunks of
``pileup_accumulate_bits`` (cross-chunk accumulation into one buffer) and
``unpack_pileup`` on both sides: the JAX kernel in interpret mode with its
bf16 128-lane buffer, the port's plain version with its f32 64-lane buffer.
What is held equal is the unpacked pileup (exact: integer vote counts) and
the bit planes (bitwise). The consensus call with reference votes is held
field by field (bitwise; coverage to 1e-6 relative, a six-term f32 sum of
fractional reference weights whose order is the backend's)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from proovread_tpu.ops import pileup_kernel as jpk
from proovread_tpu.ops.consensus_call import call_consensus as j_call
from proovread_tpu.ops.fused import add_ref_votes as j_addref
from proovread_tpu.ops.votes import unpack_pileup as j_unpack
from proovread_tpu.ops.votes import word_to_bits as j_bits

from proovread_tpu_torch.ops import pileup_kernel as tpk
from proovread_tpu_torch.ops.consensus_call import call_consensus
from proovread_tpu_torch.ops.fused import add_ref_votes
from proovread_tpu_torch.ops.votes import unpack_pileup, word_to_bits


def _random_words(rng, R, n, density=0.6):
    """Valid packed vote words: state field, marker bit, insertion length
    and six inserted-base fields (5 = none), zero rows for dead columns."""
    st = rng.integers(1, 7, (R, n))
    mb = rng.integers(0, 2, (R, n))
    ln = np.where(rng.random((R, n)) < 0.2, rng.integers(1, 7, (R, n)), 0)
    word = st | (mb << 3) | (ln << 4)
    for k in range(6):
        b = np.where(k < ln, rng.integers(0, 5, (R, n)), 5)
        word |= b << (7 + 3 * k)
    word[rng.random((R, n)) > density] = 0
    return word.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_bits_pileup_unpack_match_jax(seed):
    rng = np.random.default_rng(seed)
    B, Lp, n, R = 3, 640, 208, 128
    pad = n
    Lpile = Lp + 2 * n
    jpile = jnp.zeros((B, Lpile, 128), jnp.bfloat16)
    tpile = torch.zeros((B, Lpile, 64), dtype=torch.float32)
    for chunk in range(2):
        words = _random_words(rng, R, n)
        read_of = np.sort(rng.integers(0, B, R)).astype(np.int32)
        w0 = (rng.integers(0, (Lpile - n) // 16, R) * 16).astype(np.int32)
        jb0, jb1 = j_bits(jnp.asarray(words))
        tb0, tb1 = word_to_bits(torch.as_tensor(words))
        np.testing.assert_array_equal(tb0.numpy(), np.asarray(jb0))
        np.testing.assert_array_equal(tb1.numpy(), np.asarray(jb1))
        assert (tb0.numpy() < 0).any()            # lane 31 (sign bit) used
        jpile = jpk.pileup_accumulate_bits(jpile, jb0, jb1,
                                           jnp.asarray(read_of),
                                           jnp.asarray(w0), interpret=True)
        out = tpk.pileup_accumulate_bits(tpile, tb0, tb1,
                                         torch.as_tensor(read_of),
                                         torch.as_tensor(w0))
        assert out is tpile                        # updated in place
    jp = j_unpack(jpile, pad, Lp)
    tp = unpack_pileup(tpile, pad, Lp)
    for f in jp._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    assert float(tp.counts.sum()) > 1000


@pytest.mark.parametrize("max_ins_length", [0, 3])
def test_consensus_call_matches_jax(max_ins_length):
    rng = np.random.default_rng(4 + max_ins_length)
    B, L, K = 3, 300, 6
    counts = rng.integers(0, 5, (B, L, 6)).astype(np.float32)
    counts[:, :20] = 0                          # uncovered columns
    ins_mbase = np.minimum(counts, rng.integers(0, 3, (B, L, 6))
                           ).astype(np.float32)
    ins_len = rng.integers(0, 4, (B, L, K)).astype(np.float32)
    ins_base = rng.integers(0, 4, (B, L, K, 5)).astype(np.float32)
    codes = rng.integers(0, 5, (B, L)).astype(np.int8)
    qual = rng.integers(0, 41, (B, L)).astype(np.uint8)
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lmask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)

    from proovread_tpu.ops.pileup import Pileup as JPileup
    from proovread_tpu_torch.ops.pileup import Pileup
    jp = JPileup(*(jnp.asarray(a) for a in (counts, ins_mbase, ins_len,
                                             ins_base)))
    tp = Pileup(*(torch.as_tensor(a) for a in (counts, ins_mbase, ins_len,
                                                ins_base)))
    jp = j_addref(jp, jnp.asarray(codes), jnp.asarray(qual).astype(
        jnp.float32), jnp.asarray(lmask))
    tp = add_ref_votes(tp, torch.as_tensor(codes),
                       torch.as_tensor(qual).float(), torch.as_tensor(lmask))
    np.testing.assert_array_equal(tp.counts.numpy(), np.asarray(jp.counts))
    jc = j_call(jp, jnp.asarray(codes), max_ins_length)
    tc = call_consensus(tp, torch.as_tensor(codes), max_ins_length)
    for f in jc._fields:
        a, b = np.asarray(getattr(jc, f)), getattr(tc, f).numpy()
        if f == "coverage":
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    assert int(tc.ins_len.sum()) > 0 and int((~tc.emitted).sum()) > 0
