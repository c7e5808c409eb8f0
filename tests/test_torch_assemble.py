"""Port parity: consensus assembly and HCR masking.

The port's plain versions are held against the JAX kernels (interpret mode)
and their XLA oracles (``device_assemble_xla``, ``device_hcr_mask_dyn_xla``)
on seeded inputs with truncation at Lp, empty reads and high-quality runs
that touch both read ends. Tolerance: bitwise for codes, qual, lengths and
mask; the masked fraction equal as f32."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from proovread_tpu.ops.assemble_kernel import assemble_rows as j_assemble
from proovread_tpu.ops.assemble_kernel import hcr_mask_rows as j_hcr
from proovread_tpu.ops.consensus_call import ConsensusCall as JCall
from proovread_tpu.pipeline import dcorrect as jdc
from proovread_tpu.pipeline.masking import MaskParams as JMask

from proovread_tpu_torch.ops import assemble_kernel as tak
from proovread_tpu_torch.ops.consensus_call import ConsensusCall
from proovread_tpu_torch.pipeline.masking import MaskParams


def _call(rng, B, L, K=6):
    """TestScalarWalkKernels._call: random emitted/base/insertion columns."""
    f = dict(
        emitted=rng.random((B, L)) > 0.15,
        base=rng.integers(0, 5, (B, L)).astype(np.int8),
        ins_len=np.where(rng.random((B, L)) < 0.08,
                         rng.integers(1, K + 1, (B, L)), 0).astype(np.int32),
        ins_bases=rng.integers(0, 5, (B, L, K)).astype(np.int8),
        freq=rng.random((B, L)).astype(np.float32),
        phred=rng.integers(0, 41, (B, L)).astype(np.int32),
        coverage=rng.random((B, L)).astype(np.float32))
    return (JCall(**{k: jnp.asarray(v) for k, v in f.items()}),
            ConsensusCall(**{k: torch.as_tensor(v) for k, v in f.items()}))


@pytest.mark.parametrize("Lp", [320, 300])
def test_assemble_matches_jax(Lp):
    rng = np.random.default_rng(23 + Lp)
    B, L = 7, 300
    for trial in range(3):
        jcall, tcall = _call(rng, B, L)
        lengths = rng.integers(0, L + 1, B).astype(np.int32)
        lengths[0], lengths[1] = 0, L              # empty and full rows
        qual = jnp.asarray(rng.integers(0, 41, (B, L)).astype(np.uint8))
        ref = jdc.device_assemble_xla(jcall, qual, jnp.asarray(lengths), Lp)
        ker = j_assemble(jcall, jnp.asarray(lengths), Lp, interpret=True)
        got = tak.assemble_rows(tcall, torch.as_tensor(lengths), Lp)
        for a, b, c, name in zip(ref, ker, got, ("codes", "qual", "len")):
            np.testing.assert_array_equal(c.numpy(), np.asarray(a),
                                          err_msg=f"{trial} {name} xla")
            np.testing.assert_array_equal(c.numpy(), np.asarray(b),
                                          err_msg=f"{trial} {name} kernel")
        if Lp == L:                                # truncation happened
            assert int(got[2][1]) == Lp
        assert int(got[2][0]) == 0


def test_assemble_out_of_range_fields_match_jax_kernel():
    """Fields outside the ranges the packing clamps (insertion length 7-9
    and negative, phred 64-70, base -1 and 9, inserted base 7 and
    negative), a negative length: the port's ``assemble_rows`` equals the
    JAX kernel bit for bit, truncation at Lp included."""
    rng = np.random.default_rng(31)
    B, L, K = 6, 400, 6

    def wild(a, vals, frac):
        a = a.copy()
        sel = rng.random(a.shape) < frac
        a[sel] = rng.choice(vals, int(sel.sum()))
        return a

    f = dict(
        emitted=rng.random((B, L)) > 0.15,
        base=wild(rng.integers(0, 5, (B, L)), [-1, 9], 0.1).astype(np.int8),
        ins_len=wild(np.where(rng.random((B, L)) < 0.08,
                              rng.integers(1, K + 1, (B, L)), 0),
                     [7, 8, 9, -2], 0.03).astype(np.int32),
        ins_bases=wild(rng.integers(0, 5, (B, L, K)), [7, -3], 0.1)
        .astype(np.int8),
        freq=np.zeros((B, L), np.float32),
        phred=wild(rng.integers(0, 41, (B, L)), [64, 67, 70], 0.1)
        .astype(np.int32),
        coverage=np.zeros((B, L), np.float32))
    jcall = JCall(**{k: jnp.asarray(v) for k, v in f.items()})
    tcall = ConsensusCall(**{k: torch.as_tensor(v) for k, v in f.items()})
    lengths = np.array([0, L, L - 1, 250, 1, -4], np.int32)
    for Lp in (L + 40, L):
        ker = j_assemble(jcall, jnp.asarray(lengths), Lp, interpret=True)
        got = tak.assemble_rows(tcall, torch.as_tensor(lengths), Lp)
        for a, c, name in zip(ker, got, ("codes", "qual", "len")):
            np.testing.assert_array_equal(c.numpy(), np.asarray(a),
                                          err_msg=f"{Lp} {name}")
    assert int(got[2][1]) == L and int(got[2][0]) == 0
    assert int(got[1].max()) == 63 and int(got[0].max()) == 7


def _qual_rows(rng, B, L):
    qual = np.zeros((B, L), np.uint8)
    lengths = rng.integers(50, L + 1, B).astype(np.int32)
    lengths[0] = 0
    for b in range(B):
        pos = 0
        hi = b % 2 == 1            # odd rows start (and may end) high
        while pos < lengths[b]:
            seg = int(rng.integers(3, 180))
            qual[b, pos:pos + seg] = (rng.integers(25, 41) if hi
                                      else rng.integers(0, 10))
            pos += seg
            hi = not hi
    qual[-1, :lengths[-1]] = 40                    # one run spans the read
    return qual, lengths


@pytest.mark.parametrize("which", [0, 1, 2])
def test_hcr_mask_matches_jax(which):
    rng = np.random.default_rng(29 + which)
    B, L = 9, 640
    mp = (JMask().scaled(100), JMask(end_ratio=0.3).scaled(100),
          JMask(mask_min_len=10, unmask_min_len=20, mask_reduce=3,
                end_ratio=0.5))[which]
    qual, lengths = _qual_rows(rng, B, L)
    pv = jdc.mask_params_vec(mp)
    m1, f1 = jdc.device_hcr_mask_dyn_xla(jnp.asarray(qual),
                                         jnp.asarray(lengths), pv)
    m2, f2 = j_hcr(jnp.asarray(qual), jnp.asarray(lengths), pv,
                   interpret=True)
    tpv = tak.mask_params_vec(MaskParams(**mp.__dict__))
    np.testing.assert_array_equal(tpv.numpy(), np.asarray(pv))
    m3, f3 = tak.hcr_mask_rows(torch.as_tensor(qual),
                               torch.as_tensor(lengths), tpv)
    np.testing.assert_array_equal(m3.numpy(), np.asarray(m1))
    np.testing.assert_array_equal(m3.numpy(), np.asarray(m2))
    assert np.float32(f3.item()) == np.float32(f1) == np.float32(f2)
    assert m3[-1].any() and m3[-1, lengths[-1] - 1 - 50:].sum() > 0
