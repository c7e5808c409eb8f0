"""Per-kernel cost attribution (``obs/profile.py``) on the CPU.

The kernel entries' cost models are the counts behind PERF.md section
6's Bound column: at the main path's shapes they give its bounds at the
H100 rates (bytes at 3.35 TB/s, f32 operations at 33.45 x 10^12/s
without FMA), to the digits the table states. Where the data decide a
count (the pileups' touched cells, the scatter's kept entries and
segments, assemble's emitted columns, the LCS's matching bases) the
model is an upper bound of the data count (the bit-plane pileup's votes,
its set bits, exact). On
the CPU the roofline prints counts and rates, no share of a peak; the
``kernel_*`` metrics pass both packages' ``validate_metrics``."""

import json

import numpy as np
import pytest
import torch

from proovread_tpu.obs import validate as jvalidate
from proovread_tpu_torch.obs import profile
from proovread_tpu_torch.obs import validate as tvalidate

torch.set_num_threads(1)

H100 = profile.DEVICE_PEAKS["h100"]


def _ms(cost, rate):
    """The bound of a cost: the larger of its bytes and its operations
    over the H100's rates, in ms."""
    return 1e3 * max(cost["bytes_accessed"] / H100["bytes"],
                     cost["flops"] / H100[rate] if rate != "bytes" else 0.0)


def _bsw_v2_args(R, m, W, ql, S=16384, B=256, Lp=24576):
    from proovread_tpu_torch.align.params import AlignParams
    ap = AlignParams(band_width=W // 2)
    n = m + W
    i32 = lambda v: torch.full((R,), v, dtype=torch.int32)  # noqa: E731
    return (torch.zeros((S, m), dtype=torch.int8),
            torch.zeros((S, m), dtype=torch.int8),
            torch.zeros((B, Lp + 2 * n + 32), dtype=torch.int8),
            i32(ql), i32(0), i32(0), i32(0), i32(0), ap)


@pytest.mark.parametrize("entry,shape,want_ms", [
    ("bsw_expand_v2", dict(R=8192, m=112, W=96, ql=100), "0.0376"),
    ("bsw_expand_v2", dict(R=8192, m=112, W=64, ql=100), "0.0251"),
    ("bsw_expand_v2", dict(R=8192, m=256, W=96, ql=250), "0.0940"),
    ("bsw_expand", dict(R=8192, m=112, W=96, ql=100), "0.0376"),
    ("hcr_mask_rows", dict(B=256, L=24576), "0.00376"),
    ("hcr_mask_rows", dict(B=32, L=49152), "0.00094"),
], ids=["bsw-W96", "bsw-W64", "bsw-m256", "bsw-v1", "hcr", "hcr-longest"])
def test_cost_models_give_the_table_bounds(entry, shape, want_ms):
    from proovread_tpu_torch.ops.assemble_kernel import mask_params_vec
    from proovread_tpu_torch.pipeline.masking import MaskParams
    if entry == "hcr_mask_rows":
        args = (torch.zeros((shape["B"], shape["L"]), dtype=torch.uint8),
                torch.zeros(shape["B"], dtype=torch.int32),
                mask_params_vec(MaskParams()))
    else:
        args = _bsw_v2_args(**shape)
        if entry == "bsw_expand":
            R, m, n = shape["R"], shape["m"], shape["m"] + shape["W"]
            args = (torch.zeros((R, m), dtype=torch.int8),
                    torch.zeros((R, n), dtype=torch.int8), args[3], args[8])
    rate = profile.COST_MODELS[entry][1]
    # to the digits the table states
    digits = len(want_ms.split(".")[1])
    got = _ms(profile.cost_of(entry, args, {}), rate)
    assert round(got, digits) == float(want_ms)


def test_data_counts_stay_under_the_shape_models():
    """A pileup's votes and touched cells, a scatter's kept and touched
    entries, assemble's emitted columns and the LCS's matching bases never
    pass the model's upper bound (the bit-plane pileup's votes exact)."""
    from proovread_tpu_torch.ops import pileup_kernel as pk
    from proovread_tpu_torch.ops.scatter import scatter_add_ordered
    rng = np.random.default_rng(1)
    R, n, B, Lp = 64, 40, 4, 200
    b0 = torch.as_tensor(rng.integers(0, 1 << 31, (R, n)).astype(np.int32))
    read_of = torch.as_tensor(np.sort(rng.integers(0, B, R)).astype(np.int32))
    w0 = torch.as_tensor(rng.integers(0, Lp + n, R).astype(np.int32))
    pile = torch.zeros((B, Lp + 2 * n, 64))
    args = (pile, b0, b0, read_of, w0)
    model = profile.cost_of("pileup_accumulate_bits", args, {})
    out = pk.pileup_accumulate_bits(*args)
    votes, cells = float(out.sum()), int((out != 0).sum())
    exact = profile.pileup_counts(8.0 * R * n + 8 * R, votes, cells)
    assert exact[0] == model["flops"] and exact[1] <= model["bytes_accessed"]
    tgt = torch.zeros(500)
    idx = torch.as_tensor(rng.integers(-5, 505, 2000))
    keep = torch.as_tensor(rng.random(2000) < 0.7)
    w = torch.ones(2000)
    model = profile.cost_of("scatter_add_ordered", (tgt, idx, w, keep), {})
    live = keep & (idx >= 0) & (idx < 500)
    exact = profile.scatter_counts(2000, int(live.sum()),
                                   int(torch.unique(idx[live]).numel()))
    assert exact[1] <= model["bytes_accessed"]
    scatter_add_ordered(tgt, idx, w, keep)


def test_profiled_calls_feed_records_spans_and_metrics(tmp_path):
    """Under a profiler (and a tracer and a metrics registry) each call of
    a kernel entry adds its model's operations to its record, to the open
    spans and to ``kernel_flops_total``; a glue entry counts calls and a
    ``cost_errors`` a signature, never operations. The roofline on the
    CPU has no %-of-peak column; the metrics pass both validators."""
    from proovread_tpu_torch import obs
    from proovread_tpu_torch.ops import fused
    from proovread_tpu_torch.ops.pileup import init_pileup
    args = _bsw_v2_args(R=256, m=112, W=96, ql=100, S=256, B=4, Lp=2048)
    from proovread_tpu_torch.align import bsw
    with obs.metrics.scope() as reg, obs.tracing() as tr, \
            profile.profiling() as prof:
        with obs.span("bucket", cat="bucket"):
            bsw.bsw_expand_v2(*args)
            bsw.bsw_expand_v2(*args)
            fused.add_ref_votes(init_pileup(2, 16),
                                torch.zeros((2, 16), dtype=torch.int8),
                                torch.full((2, 16), 20, dtype=torch.uint8),
                                torch.ones((2, 16)))
    rec = prof.records["bsw_expand_v2"]
    one = profile.cost_of("bsw_expand_v2", args, {})
    assert rec.calls == 2 and rec.flops == 2 * one["flops"]
    assert rec.launches == 0 and rec.n_signatures == 1
    assert prof.records["add_ref_votes"].cost_errors == 1
    assert prof.records["add_ref_votes"].flops == 0.0
    span = next(e for e in tr.events if e["name"] == "bucket")["args"]
    assert span["flops"] == rec.flops
    assert span["peak_bytes"] >= rec.peak_bytes > 0
    path = tmp_path / "m.json"
    path.write_text(json.dumps(reg.as_dict()))
    series = {s["labels"]["fn"]: s["value"] for s in
              reg.as_dict()["counters"]["kernel_flops_total"]["series"]}
    assert series == {"bsw_expand_v2": rec.flops}
    for v in (tvalidate, jvalidate):
        v.validate_metrics(str(path), require=("kernel_flops_total",
                                               "kernel_bytes_total"))
    lines = profile.roofline_lines(prof)
    assert "%peak" not in lines[0] and "no %-of-peak" in lines[-1]
    assert any(ln.startswith("bsw_expand_v2") for ln in lines)


def test_device_peaks_match_the_card_name():
    assert profile.device_peaks("NVIDIA H100 80GB HBM3") == H100
    assert profile.device_peaks("NVIDIA A100-SXM4-40GB") is None
    assert H100 == {"bytes": 3.35e12, "f32": 33.45e12, "int32": 16.7e12}
