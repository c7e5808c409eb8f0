"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips, with the reason, where
``torch.cuda.is_available()`` is False (there is no CPU mode for a CUDA
kernel). On a card: ``python -m pytest tests/test_torch_gpu.py``. The same
checks run at the main path's shapes in ``chip_smoke.py``. Tolerance:
bitwise (integer outputs), exact (bsw score, pileup counts)."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _equal(a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


@pytest.mark.parametrize("finish", [False, True])
def test_bsw_kernel_matches_plain(cuda, finish):
    from proovread_tpu_torch.align import bsw
    from proovread_tpu_torch.align.params import BWA_SR, BWA_SR_FINISH
    from proovread_tpu_torch.pipeline.dcorrect import device_revcomp
    ap = BWA_SR_FINISH if finish else BWA_SR
    rng = np.random.default_rng(finish)
    S, m, B, Lp, R = 64, 112, 4, 2048, 256
    W = bsw.band_lanes(ap)
    n = m + W
    genome = rng.integers(0, 4, (B, Lp)).astype(np.int8)
    qlen = rng.integers(60, 101, S).astype(np.int32)
    qlen[0] = 0
    qf = np.full((S, m), 4, np.int8)
    for s in range(S):
        b, p = int(rng.integers(0, B)), int(rng.integers(0, Lp - 120))
        qf[s, :qlen[s]] = genome[b, p:p + qlen[s]]
    t = lambda x: torch.as_tensor(x, device=cuda)   # noqa: E731
    sread = rng.integers(0, S, R).astype(np.int32)
    diag = rng.integers(-2 * n, Lp + 2 * n, R).astype(np.int32)
    mp = bsw.build_map_pad(t(genome), t(rng.random((B, Lp)) < 0.1), n)
    _, w0p = bsw.window_starts(t(diag), W, Lp, n)
    args = (t(qf), device_revcomp(t(qf), t(qlen)), mp,
            t(qlen)[t(sread).long()], t(sread),
            t(rng.integers(0, 2, R).astype(np.int32)),
            t(np.sort(rng.integers(0, B, R)).astype(np.int32)), w0p, ap)
    launches = bsw.bsw_expand_v2.launches
    got = bsw.bsw_expand_v2(*args)
    assert bsw.bsw_expand_v2.launches == launches + 1
    assert _equal(got, bsw.bsw_expand_v2_plain(*args))


def test_pileup_kernel_matches_plain(cuda):
    from proovread_tpu_torch.ops import pileup_kernel as pk
    rng = np.random.default_rng(2)
    B, Lpile, R, n = 4, 1200, 256, 208
    t = lambda x: torch.as_tensor(x, device=cuda)   # noqa: E731
    b0 = t(rng.integers(-2**31, 2**31, (R, n)).astype(np.int32))
    b1 = t(rng.integers(0, 1 << 22, (R, n)).astype(np.int32))
    ro = t(np.sort(rng.integers(0, B, R)).astype(np.int32))
    w0 = t(rng.integers(0, Lpile - n, R).astype(np.int32))
    base = torch.zeros((B, Lpile, 64), device=cuda)
    got = pk.pileup_accumulate_bits(base.clone(), b0, b1, ro, w0)
    assert torch.equal(got, pk.pileup_accumulate_bits_plain(
        base.clone(), b0, b1, ro, w0))


def test_assemble_and_hcr_kernels_match_plain(cuda):
    from proovread_tpu_torch.ops import assemble_kernel as ak
    from proovread_tpu_torch.pipeline.masking import MaskParams
    rng = np.random.default_rng(3)
    B, L = 16, 3000
    t = lambda x: torch.as_tensor(x, device=cuda)   # noqa: E731
    word = t(rng.integers(0, 2**31, (B, L)).astype(np.int32))
    lengths = t(rng.integers(0, L + 1, B).astype(np.int32))
    assert _equal(ak.assemble_words_cuda(word, lengths, L),
                  ak.assemble_words_plain(word, lengths, L))
    qual = t(np.repeat(rng.integers(0, 41, (B, L // 50)), 50, axis=1)
             .astype(np.uint8))
    pvi = ak._int_params(ak.mask_params_vec(MaskParams().scaled(100)))
    assert _equal(ak.hcr_mask_cuda(qual, lengths, pvi),
                  ak.hcr_mask_plain(qual, lengths, pvi))
