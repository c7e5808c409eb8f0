#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``proovread_tpu_torch``) on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order;
any failure exits non-zero:

1. setup: the card's name and power limit, torch/CUDA versions, and the
   kernel build from ``proovread_tpu_torch/csrc`` (seconds printed);
2. every kernel against its plain PyTorch version on the card, on seeded
   inputs at the main path's shapes (bsw at W=96 and W=64, R=8192, m=112;
   pileup at B=256, Lp=24576; assemble and HCR at B=256, L=24576): integer
   outputs bitwise equal, the bsw score and the pileup counts exactly equal;
   kernel, plain and library times (median of CUDA-event timings after a
   warm-up) and each kernel's bound from its bytes and operations;
3. ``Pipeline.run`` on bench config 4's workload (10 kb genome, 40 kb of
   long reads, 30x short reads, 4 iterations) on the card and on the CPU:
   records, qual, chimeras and task reports must be identical;
4. ``Pipeline.run`` on the E.coli-class workload (1.25 Mb genome, 5 Mb of
   CLR reads, 30x short reads, 6 iterations) with every kernel's launch
   count reset just before and read just after; fails if a kernel was not
   launched or no pass admitted a candidate.

Phase 2 calls each kernel's public wrapper on CUDA tensors and holds it
against the plain version on the same card inputs, and against the wrapper
on CPU copies where the wrapper does work of its own around the kernel
(assemble's column packing, HCR's parameter rounding and masked fraction).
Its times are those of the kernel's launcher alone.

It then prints the card line, the ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Without a card, or without the package
beside it, it exits non-zero and prints no result.

``--profile`` reruns phase 4 under ``torch.profiler``. ``--skip`` drops
phases for development runs; a run that skips a phase prints no result
lines (the full run takes no arguments).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet), used for each kernel's bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in ms."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        a, b = a.double(), b.double()
        if a.numel():
            err = max(err, float((a - b).abs().max()))
    return err


def assert_equal(name, pairs) -> None:
    import torch
    for i, (a, b) in enumerate(pairs):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{name}: output {i} differs from the plain "
                                 "version")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def bsw_inputs(rng, ap, dev, R=8192, m=112, S=16384, B=256, Lp=24576):
    """Seeded candidates with real alignments planted (both strands,
    substitutions and indels), empty queries, out-of-range windows and
    15% ignore bits."""
    import torch
    from proovread_tpu_torch.align import bsw
    from proovread_tpu_torch.ops.encode import revcomp_codes
    from proovread_tpu_torch.pipeline.dcorrect import device_revcomp
    W = bsw.band_lanes(ap)
    n = m + W
    genome = rng.integers(0, 4, (B, Lp)).astype(np.int8)
    qf = np.full((S, m), 4, np.int8)
    qlen = np.full(S, 100, np.int32)
    qlen[:4] = 0
    sread = rng.integers(0, S, R).astype(np.int32)
    strand = rng.integers(0, 2, R).astype(np.int32)
    lread = np.sort(rng.integers(0, B, R)).astype(np.int32)
    diag = rng.integers(0, Lp - 200, R).astype(np.int32)
    for s in range(4, S):
        b, p = int(rng.integers(0, B)), int(rng.integers(0, Lp - 200))
        src = genome[b, p:p + 100].copy()
        k = int(rng.integers(0, 4))
        if k == 1:
            src = np.insert(src, int(rng.integers(10, 90)), rng.integers(0, 4, 2))[:100]
        elif k == 2:
            src = np.delete(src, int(rng.integers(10, 90)))
            src = np.append(src, genome[b, p + 100])
        sub = rng.random(100) < 0.02
        src[sub] = (src[sub] + 1) % 4
        qf[s, :100] = src
    # point candidates at their query's true placement, strand 1 at the
    # reverse complement of it
    for i in range(R):
        s = int(sread[i])
        if s < 4:
            continue
        b, p = int(lread[i]), int(diag[i])
        q = qf[s, :100]
        genome[b, p:p + 100] = q if strand[i] == 0 else revcomp_codes(q)
    diag[: R // 20] = rng.integers(-2 * n, 8, R // 20)
    diag[R // 20: R // 10] = rng.integers(Lp - 8, Lp + 2 * n, R // 10 - R // 20)
    ign = rng.random((B, Lp)) < 0.15
    t = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731
    q_t = t(qf)
    rc_t = device_revcomp(q_t, t(qlen))
    map_pad = bsw.build_map_pad(t(genome), t(ign), n)
    _, w0p = bsw.window_starts(t(diag), W, Lp, n)
    args = (q_t, rc_t, map_pad, t(qlen)[t(sread).long()], t(sread), t(strand),
            t(lread), w0p)
    return args, n


def check_bsw(rng, dev, ap, label):
    import torch
    from proovread_tpu_torch.align import bsw
    args, n = bsw_inputs(rng, ap, dev)
    R = args[4].shape[0]
    m = args[0].shape[1]
    W = bsw.band_lanes(ap)
    got = bsw.bsw_expand_v2(*args, ap)
    want = bsw.bsw_expand_v2_plain(*args, ap)
    torch.cuda.synchronize()
    pairs = [(getattr(got, f).int() if f == "valid" else getattr(got, f),
              getattr(want, f).int() if f == "valid" else getattr(want, f))
             for f in want._fields]
    assert_equal(f"bsw_expand_v2 {label}", pairs)
    n_valid = int(want.valid.sum())
    n_ins = int((want.ins_len > 0).sum())
    if n_valid < R // 2 or n_ins == 0:
        raise AssertionError(f"bsw {label}: weak inputs ({n_valid} valid, "
                             f"{n_ins} insertion columns)")
    ms = time_ms(lambda: bsw._bsw_cuda(*args, ap))
    plain_ms = time_ms(lambda: bsw.bsw_expand_v2_plain(*args, ap), reps=5,
                       warmup=1)
    S = args[0].shape[0]
    n_bytes = (2 * S * m + args[2].numel() + 5 * R * 4
               + 5 * R * n * 4 + R * 4 + 5 * R * 4)
    # f32 operations each banded DP cell needs, whatever the design: the
    # substitution score (compare, select, add to the diagonal), the
    # insertion and deletion gaps (two subtracts, a max and the direction
    # compare each), H (three maxima) and its two source compares. None of
    # them is an FMA, and the peak counts an FMA as two, so the bound is
    # optimistic by up to 2x.
    ops_per_cell = 16
    b_ms, b_by = bound(n_bytes, float(R) * m * W * ops_per_cell)
    return dict(max_abs_err=max_abs_err(
        [(a.float(), b.float()) for a, b in pairs]), ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"R={R} m={m} W={W} n={n}", valid=n_valid), got, args


def check_pileup(rng, dev, bsw_res, bsw_args):
    import torch
    from proovread_tpu_torch.ops import pileup_kernel as pk
    from proovread_tpu_torch.ops.votes import (encode_votes_packed_bases,
                                               word_to_bits)
    words = encode_votes_packed_bases(
        bsw_res.state, bsw_res.qrow, bsw_res.ins_len, bsw_res.ins_b0,
        bsw_res.ins_b1, bsw_res.q_start, bsw_res.q_end, taboo_abs=7)
    b0, b1 = word_to_bits(words)
    R, n = b0.shape
    B, Lp = 256, 24576
    Lpile = Lp + 2 * n
    read_of = bsw_args[6]
    w0 = torch.as_tensor(rng.integers(0, Lp + n, R).astype(np.int32),
                         device=dev)
    base = torch.zeros((B, Lpile, 64), dtype=torch.float32, device=dev)
    got = pk.pileup_accumulate_bits(base.clone(), b0, b1, read_of, w0)
    want = pk.pileup_accumulate_bits_plain(base.clone(), b0, b1, read_of, w0)
    torch.cuda.synchronize()
    assert_equal("pileup_accumulate_bits", [(got, want)])
    n_set = int(want.sum())
    if n_set == 0:
        raise AssertionError("pileup: no votes in the check inputs")
    buf = base.clone()
    ms = time_ms(lambda: pk._pileup_cuda(buf, b0, b1, read_of, w0))
    plain_ms = time_ms(lambda: pk.pileup_accumulate_bits_plain(
        buf, b0, b1, read_of, w0), reps=5, warmup=1)
    votes = pk.decode_bits(b0, b1).reshape(-1, 64)
    rows = (read_of.long()[:, None] * Lpile + w0.long()[:, None]
            + torch.arange(n, device=dev)[None, :]).reshape(-1)
    flat = buf.view(-1, 64)
    lib_ms = time_ms(lambda: flat.index_add_(0, rows, votes), reps=5,
                     warmup=1)
    # bit planes + metadata read once; one 4-byte read and write per vote
    b_ms, b_by = bound(8.0 * R * n + 8 * R + 8.0 * n_set, float(n_set))
    return dict(max_abs_err=max_abs_err([(got, want)]), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, shape=f"B={B} Lp={Lp} R={R} n={n}",
                votes=n_set)


def random_call(rng, dev, B, L, K=6):
    import torch
    from proovread_tpu_torch.ops.consensus_call import ConsensusCall
    t = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731
    return ConsensusCall(
        emitted=t(rng.random((B, L)) > 0.15),
        base=t(rng.integers(0, 5, (B, L)).astype(np.int8)),
        ins_len=t(np.where(rng.random((B, L)) < 0.08,
                           rng.integers(1, K + 1, (B, L)), 0).astype(np.int32)),
        ins_bases=t(rng.integers(0, 5, (B, L, K)).astype(np.int8)),
        freq=t(rng.random((B, L)).astype(np.float32)),
        phred=t(rng.integers(0, 41, (B, L)).astype(np.int32)),
        coverage=t(rng.random((B, L)).astype(np.float32)))


def check_assemble(rng, dev, B=256, L=24576):
    import torch
    from proovread_tpu_torch.ops import assemble_kernel as ak
    call = random_call(rng, dev, B, L)
    lengths = torch.as_tensor(rng.integers(L // 2, L + 1, B).astype(np.int32),
                              device=dev)
    lengths[:2] = torch.tensor([0, L], dtype=torch.int32)
    word = ak.pack_columns(call, lengths)
    Lp = L
    got = ak.assemble_rows(call, lengths, Lp)
    want = ak.assemble_words_plain(word, lengths, Lp)
    want_cpu = ak.assemble_rows(type(call)(*(t.cpu() for t in call)),
                                lengths.cpu(), Lp)
    torch.cuda.synchronize()
    assert_equal("assemble_rows", list(zip(got, want)))
    assert_equal("assemble_rows (card vs CPU)",
                 [(a.cpu(), b) for a, b in zip(got, want_cpu)])
    if int((want[2] == Lp).sum()) == 0:
        raise AssertionError("assemble: no row was truncated at Lp")
    ms = time_ms(lambda: ak.assemble_words_cuda(word, lengths, Lp))
    plain_ms = time_ms(lambda: ak.assemble_words_plain(word, lengths, Lp),
                       reps=5, warmup=1)
    b_ms, b_by = bound(4.0 * B * L + 4 * B + 2.0 * B * Lp + 4 * B, 0.0)
    return dict(max_abs_err=max_abs_err(list(zip(got, want))), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, shape=f"B={B} L={L} Lp={Lp}")


def check_hcr(rng, dev, B=256, L=24576):
    import torch
    from proovread_tpu_torch.ops import assemble_kernel as ak
    from proovread_tpu_torch.pipeline.masking import MaskParams
    qual = np.zeros((B, L), np.uint8)
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    seg = rng.integers(3, 400, (B, L // 3 + 1))
    for b in range(B):
        bounds = np.cumsum(seg[b])
        bounds = bounds[bounds < L]
        hi = bool(rng.integers(0, 2))
        prev = 0
        for e in list(bounds) + [L]:
            qual[b, prev:e] = (rng.integers(25, 41) if hi
                               else rng.integers(0, 10))
            prev, hi = e, not hi
    q = torch.as_tensor(qual, device=dev)
    ln = torch.as_tensor(lengths, device=dev)
    errs = []
    for mp in (MaskParams().scaled(100), MaskParams(end_ratio=0.3).scaled(100)):
        pv = ak.mask_params_vec(mp)
        pvi = ak._int_params(pv)
        mask, frac = ak.hcr_mask_rows(q, ln, pv)
        want_mask, _ = ak.hcr_mask_plain(q, ln, pvi)
        mask_cpu, frac_cpu = ak.hcr_mask_rows(q.cpu(), ln.cpu(), pv)
        torch.cuda.synchronize()
        pairs = [(mask, want_mask), (mask.cpu(), mask_cpu),
                 (frac.cpu(), frac_cpu)]
        assert_equal("hcr_mask_rows", pairs)
        if float(frac_cpu) == 0.0:
            raise AssertionError("hcr: nothing masked in the check inputs")
        errs.append(max_abs_err([(a.float(), b.float()) for a, b in pairs]))
    ms = time_ms(lambda: ak.hcr_mask_cuda(q, ln, pvi))
    plain_ms = time_ms(lambda: ak.hcr_mask_plain(q, ln, pvi), reps=5,
                       warmup=1)
    b_ms, b_by = bound(2.0 * B * L + 8 * B, 0.0)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=f"B={B} L={L}")


# --------------------------------------------------------------------------
# phases 3 and 4: the pipeline
# --------------------------------------------------------------------------

def workload(genome_size, long_bases, n_iterations):
    from proovread_tpu_torch.io.simulate import (random_genome,
                                                 simulate_long_reads,
                                                 simulate_short_reads)
    genome = random_genome(genome_size, seed=0)
    longs, _ = simulate_long_reads(genome, long_bases, seed=1)
    srs = simulate_short_reads(genome, 30.0, seed=2)
    return longs, srs, n_iterations


def run_pipeline(longs, srs, n_iterations, device):
    import torch
    from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
    cfg = PipelineConfig(mode="sr", n_iterations=n_iterations, device=device)
    t0 = time.monotonic()
    res = Pipeline(cfg).run(longs, srs)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, time.monotonic() - t0


def result_key(res):
    recs = lambda rs: [(r.id, r.seq, r.qual.tobytes(), r.desc)  # noqa: E731
                       for r in rs]
    return (recs(res.untrimmed), recs(res.trimmed), res.ignored,
            res.chimera, res.reports)


def profile_phase4(longs, srs, n_it, wall_unprofiled) -> None:
    """Phase 4 again (warm) under torch.profiler: the device time of every
    CUDA kernel, the share of the wall the device was busy, and the span
    on the device timeline of each stage range (seed / align / vote /
    consensus, ``pipeline/dcorrect.py``)."""
    import os
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    stages = ("seed", "align", "vote", "consensus")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        _, wall = run_pipeline(longs, srs, n_it, "cuda")
    evs = prof.key_averages()
    dev_attr = ("self_device_time_total"
                if hasattr(evs[0], "self_device_time_total")
                else "self_cuda_time_total")
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA
               and e.key not in stages and getattr(e, dev_attr) > 0]
    busy_us = sum(getattr(e, dev_attr) for e in kernels)
    launches = sum(e.count for e in kernels)
    lines = [f"profile: wall {wall:.2f} s under the profiler "
             f"({wall_unprofiled:.2f} s without); {launches} kernel launches"
             f", device busy {busy_us / 1e6:.2f} s = "
             f"{busy_us / 1e6 / wall:.3f} of the profiled wall"]
    for e in evs:
        if e.key in stages:
            lines.append(f"profile stage {e.key} ({e.device_type.name}): "
                         f"calls {e.count}, span "
                         f"{getattr(e, dev_attr) / 1e6:.3f} s")
    for e in sorted(kernels, key=lambda e: -getattr(e, dev_attr))[:25]:
        lines.append(f"profile kernel {getattr(e, dev_attr) / 1e6:.4f} s "
                     f"x{e.count}: {e.key[:110]}")
    for line in lines:
        log(line)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/profile.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
        f.write(evs.table(sort_by=dev_attr, row_limit=60))


def main(argv=None) -> int:
    ap_ = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap_.add_argument("--skip", default="",
                     help="comma list of phases 2,3,4 to leave out; such a "
                          "run prints no result lines")
    ap_.add_argument("--profile", action="store_true",
                     help="rerun phase 4 under torch.profiler and print the "
                          "device time per pipeline stage and per kernel")
    args = ap_.parse_args(argv)
    skip = {s for s in args.skip.split(",") if s}

    import logging
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from proovread_tpu_torch import kernels
    from proovread_tpu_torch.align import bsw
    from proovread_tpu_torch.align.params import BWA_SR, BWA_SR_FINISH
    from proovread_tpu_torch.ops import assemble_kernel, pileup_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1 -------------------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    t0 = time.monotonic()
    kernels.lib()
    log(f"kernels built and loaded in {time.monotonic() - t0:.1f} s "
        f"(nvcc {kernels.build_seconds if kernels.build_seconds is not None else 'cached'})")
    dev = torch.device("cuda")

    wrappers = {
        "bsw_expand_v2": (bsw.bsw_expand_v2, "proovread_tpu_torch/csrc/bsw.cu",
                          "proovread_tpu/align/bsw.py:463"),
        "pileup_accumulate_bits": (
            pileup_kernel.pileup_accumulate_bits,
            "proovread_tpu_torch/csrc/pileup.cu",
            "proovread_tpu/ops/pileup_kernel.py:208"),
        "assemble_rows": (assemble_kernel.assemble_rows,
                          "proovread_tpu_torch/csrc/assemble.cu",
                          "proovread_tpu/ops/assemble_kernel.py:76"),
        "hcr_mask_rows": (assemble_kernel.hcr_mask_rows,
                          "proovread_tpu_torch/csrc/assemble.cu",
                          "proovread_tpu/ops/assemble_kernel.py:212"),
    }
    results = {}

    # -- phase 2 -------------------------------------------------------------
    if "2" not in skip:
        rng = np.random.default_rng(0)
        # "launches" here counts the comparison launches of this phase
        def report(name, r):
            log("phase2 " + json.dumps(
                {"name": name, "launches": wrappers[name][0].launches, **r}))

        r64, _, _ = check_bsw(rng, dev, BWA_SR_FINISH, "W=64")
        report("bsw_expand_v2", r64)
        r96, bres, bargs = check_bsw(rng, dev, BWA_SR, "W=96")
        report("bsw_expand_v2", r96)
        results["bsw_expand_v2"] = r96
        results["pileup_accumulate_bits"] = check_pileup(rng, dev, bres, bargs)
        del bres, bargs
        results["assemble_rows"] = check_assemble(rng, dev)
        results["hcr_mask_rows"] = check_hcr(rng, dev)
        for name in ("pileup_accumulate_bits", "assemble_rows",
                     "hcr_mask_rows"):
            report(name, results[name])
        torch.cuda.empty_cache()

    # -- phase 3 -------------------------------------------------------------
    if "3" not in skip:
        longs, srs, n_it = workload(10_000, 40_000, 4)
        res_gpu, t_gpu = run_pipeline(longs, srs, n_it, "cuda")
        res_cpu, t_cpu = run_pipeline(longs, srs, n_it, "cpu")
        if result_key(res_gpu) != result_key(res_cpu):
            raise AssertionError("config 4: card and CPU results differ")
        if not res_gpu.untrimmed or not any(r.n_admitted for r in
                                            res_gpu.reports):
            raise AssertionError("config 4: nothing corrected")
        log(f"phase3 config 4: card {t_gpu:.1f} s, CPU {t_cpu:.1f} s, "
            f"{len(res_gpu.untrimmed)} reads, {len(res_gpu.trimmed)} trimmed, "
            f"{len(res_gpu.chimera)} chimera, identical")

    # -- phase 4: the main path ----------------------------------------------
    if "4" not in skip:
        longs, srs, n_it = workload(1_250_000, 5_000_000, 6)
        bases = sum(len(r) for r in longs)
        log(f"phase4 workload: {len(longs)} long reads ({bases} bases), "
            f"{len(srs)} short reads, {n_it} iterations")
        for fn, _, _ in wrappers.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        res, wall = run_pipeline(longs, srs, n_it, "cuda")
        launches = {name: fn.launches for name, (fn, _, _) in wrappers.items()}
        log(f"phase4 wall {wall:.2f} s, {bases / wall:.0f} corrected bases/s, "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for rep in res.reports:
            log(f"phase4 pass {rep.task}: masked {rep.masked_frac:.4f}, "
                f"candidates {rep.n_candidates}, admitted {rep.n_admitted}, "
                f"dropped cap {rep.n_dropped_cap}, cov {rep.n_dropped_cov}")
        log("phase4 launches " + json.dumps(launches))
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"main path never launched {missing}")
        if not any(rep.n_admitted for rep in res.reports):
            raise AssertionError("no pass admitted a candidate")
        if len(res.untrimmed) == 0:
            raise AssertionError("no corrected reads")

    if args.profile and "4" not in skip:
        profile_phase4(longs, srs, n_it, wall)

    if skip:
        log(f"phases {sorted(skip)} skipped: no result printed")
        return 0
    rows = []
    for name, (_, source, replaces) in wrappers.items():
        r = results.get(name, {})
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r.get("max_abs_err"),
                     "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                     "bound_ms": r.get("bound_ms"),
                     "bound_by": r.get("bound_by"),
                     "library_ms": r.get("library_ms")})
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
