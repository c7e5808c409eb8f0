#!/usr/bin/env python3
"""Compare copies of the port's kernel sources on one NVIDIA card: the
Smith-Waterman kernel (``csrc/sw.cu``) with and without its traceback
walk, and the ordered vote scatter (``csrc/scatter.cu``), on the inputs
of ``chip_smoke.py`` phase 2 and of a real ``utg`` chunk.

Run from the repository root::

    python3 tools/kernel_probe.py [--csrc LABEL=DIR ...] [--out DIR]

Each ``--csrc`` names a directory of kernel sources with the package's C
signatures (default: the package's own, ``proovread_tpu_torch/csrc``, as
``current``). Each is built twice by the package's build
(``kernels.build``, ``-Xptxas -v``) into a scratch directory: as it is,
and ``walkless``, with ``sw.cu``'s walk loop made to run no step (the DP,
its direction bits, the end cell and the ``OP_NONE`` padding still run).
The probe logs each build's registers and spills and the instruction mix
of its K = 20 ``sw`` kernels (``cuobjdump -sass``), and times, all copies
on the same inputs in one process (CUDA events, the median of 7 after 2):

- ``pt_sw_batch`` at phase 2's three synthetic shapes and on the first
  full chunk of a utg run (``chip_smoke.utg_chunk_inputs``);
- ``pt_scatter_add_ordered`` alone, over the wrapper's sorted int32 keys,
  on 16 M random entries, on 4 M in segments of 1,000 and more, and on the
  four scatters of a ccs-1 chunk and of the utg chunk, with each input's
  segment lengths (kept entries a touched cell);
- with the first copy only: the utg chunk's ``sw`` launched after the card
  idled for each of ``--gaps`` seconds (the host seeder's gap between
  chunks is about 0.24 s in ``chip_smoke.py`` phase 12), beside the SM
  clock that ``nvidia-smi`` reads at the end of each gap.

With ``lcs`` among ``--kernels`` it times the package's own LCS kernel
(``csrc/lcs.cu``, the accuracy scoreboard's) on ``chip_smoke.py`` phase
2's 646 pairs and on their longest pair alone (a 45,000-base truth),
with the time a step of that pair's chain takes, the kernel's registers
and spills (ptxas), its instruction mix (``cuobjdump -sass``) and its
resident blocks an SM.

Every unpatched copy's outputs, and the LCS, must equal the plain
versions' bit for bit. Prints one JSON object a line; the last line
holds them all, and with ``--out DIR`` also ``DIR/kernel_probe.json``.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the walk loop of sw.cu, and the same loop made to run no step: the first
# pair is the walk of the one-kernel design (the port before its two-kernel
# sw.cu), so that a parent's copy can be probed too
WALK_LOOPS = (("    while (true) {\n      const int b = dc[",
               "    while (false) {\n      const int b = dc["),
              ("  while (true) {  // one step of the walk a pass",
               "  while (false) {  // one step of the walk a pass"))


def walkless(src: str) -> str:
    """``sw.cu``'s source with its one walk loop made to run no step."""
    hits = [(a, b) for a, b in WALK_LOOPS if src.count(a) == 1]
    if len(hits) != 1:
        raise SystemExit("kernel_probe: sw.cu has no single known walk loop")
    return src.replace(*hits[0])


def sass_mix(so: Path, fn_filter: str) -> dict:
    """Instructions by opcode (modifiers dropped) of each kernel in ``so``
    whose mangled name holds ``fn_filter``, from ``cuobjdump -sass``."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / \
        "bin" / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(so)],
                         capture_output=True, text=True).stdout
    mix, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = name if fn_filter in name else None
            if fn:
                mix[fn] = {}
            continue
        parts = line.split("*/")
        if fn is None or len(parts) < 2 or not parts[0].strip().startswith(
                "/*"):
            continue
        toks = parts[1].replace(";", " ").split()
        if toks and toks[0].startswith("@"):
            toks = toks[1:]
        if toks:
            op = toks[0].split(".")[0]
            mix[fn][op] = mix[fn].get(op, 0) + 1
    return {f: dict(sorted(c.items(), key=lambda kv: -kv[1]))
            for f, c in mix.items()}


def probe_lcs(emit) -> None:
    """The LCS row of the probe (see the module's docstring)."""
    import ctypes
    import numpy as np
    import torch
    import chip_smoke as cs
    from proovread_tpu_torch import kernels
    from proovread_tpu_torch.obs import accuracy as acc
    dev = torch.device("cuda")
    pairs = cs.lcs_inputs(np.random.default_rng(0))
    every = acc.pack_pairs(pairs, dev)
    longest = acc.pack_pairs(pairs[:1], dev)
    want = acc.lcs_lengths_plain(*acc.pack_pairs(pairs, "cpu"))
    if not torch.equal(acc.lcs_lengths(*every).cpu(), want):
        raise SystemExit("kernel_probe: lcs differs from the plain version")
    n = np.asarray([len(rd) for rd, _ in pairs])
    plan = acc.lcs_plan(n, np.asarray([len(tr) for _, tr in pairs]))
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    rc = kernels.lib().pt_lcs_occupancy(plan["warps_per_block"],
                                        ctypes.byref(regs),
                                        ctypes.byref(blocks))
    assert rc == 0, f"pt_lcs_occupancy: CUDA error {rc}"
    row = dict(kernel="lcs", pairs=len(pairs), longest_truth=len(pairs[0][1]),
               longest_read=int(n[0]), blocks=plan["blocks"],
               warps_per_block=plan["warps_per_block"],
               longest_pair_warps=int(plan["warps"][0]),
               longest_pair_words_a_lane=int(plan["words_a_lane"][0]),
               longest_chain_steps=int(n[0] + 32 * (plan["warps"][0] - 1)),
               regs=regs.value, blocks_per_sm=blocks.value,
               ptxas=kernels.ptxas_usage("lcs.cu"),
               sass=sass_mix(kernels.build(), "lcs_wave"))
    for name, args in (("646 pairs", every), ("longest pair", longest)):
        tm = cs.launcher_times(lambda args=args: acc.lcs_lengths(*args),
                               ("lcs_",))
        row[name] = dict(ms=tm["ms"], kernel_ms=tm["kernel_ms"],
                         device_ops=tm["device_ops"])
    row["ns_a_step"] = (row["longest pair"]["kernel_ms"] * 1e6
                        / row["longest_chain_steps"])
    row["equal_to_plain"] = True
    emit(row)


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0])


def main() -> int:
    ap_ = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap_.add_argument("--csrc", action="append", default=[],
                     help="LABEL=DIR of kernel sources (repeatable)")
    ap_.add_argument("--gaps", default="0.05,0.25,1.0",
                     help="idle seconds before the utg chunk's sw launches")
    ap_.add_argument("--out", default=None, help="directory for the JSON")
    ap_.add_argument("--kernels", default="sw,scatter,lcs",
                     help="comma list of the kernels to probe")
    args = ap_.parse_args()
    probe = set(args.kernels.split(","))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_probe: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from proovread_tpu_torch import kernels
    from proovread_tpu_torch.align import sw
    from proovread_tpu_torch.align.params import AlignParams, BWA_SR
    from proovread_tpu_torch.ops import scatter as sc
    from proovread_tpu_torch.pipeline.ccs import CCS_ALIGN

    srcs = [tuple(x.split("=", 1)) for x in args.csrc] or [
        ("current", str(ROOT / "proovread_tpu_torch" / "csrc"))]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    t = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731
    rows = []

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    emit(dict(card=cs.card_line(), max_sm_clock_mhz=cs.max_sm_clock_hz()
              / 1e6))
    if "lcs" in probe:
        probe_lcs(emit)
    shapes, scatters = [], []
    if "sw" in probe:
        for label, R, m, n, qmax, ap in (
                ("siamaera", 2048, 256, 384, None,
                 AlignParams(min_out_score=0.0, score_per_base=False)),
                ("scan", 4096, 128, 256, 100, BWA_SR),
                ("ccs chunk", 4096, 512, 640, None, CCS_ALIGN)):
            q, r, ql = cs.sw_inputs(rng, R, m, n, qmax=qmax)
            shapes.append((label, t(q), t(r), t(ql), ap))
    if probe & {"sw", "scatter"}:
        utg_sw, utg_scatters = cs.utg_chunk_inputs(dev)
    if "sw" in probe:
        shapes.append(("utg chunk",) + tuple(utg_sw))
    if "scatter" in probe:
        scatters = [("random",) + cs.scatter_inputs(rng, dev)[:4],
                    ("long segments",) + cs.scatter_inputs(
                        rng, dev, M=4 << 20, hot_cells=2000)[:4]]
        scatters += [(f"ccs {x[0]}",) + x[1:]
                     for x in cs.ccs_chunk_scatters(dev)]
        scatters += [(f"utg {x[0]}",) + x[1:] for x in utg_scatters]

    def sw_call(handle, q, r, ql, ap, bufs):
        """One launch through the C entry into ``bufs`` (a scratch as
        large as either direction layout needs)."""
        f32, i32, ops, steps, dirs = bufs
        R, m = q.shape
        rc = handle.pt_sw_batch(
            q.data_ptr(), r.data_ptr(), ql.data_ptr(), R, m, r.shape[1],
            float(ap.match), float(ap.mismatch), float(ap.n_penalty),
            float(ap.o_del), float(ap.e_del), float(ap.o_ins),
            float(ap.e_ins), float(ap.clip), dirs.data_ptr(), f32.data_ptr(),
            i32.data_ptr(), ops.data_ptr(), steps.data_ptr(),
            kernels.stream_of(q))
        assert rc == 0, f"pt_sw_batch: CUDA error {rc}"

    sw_cases = []
    for name, q, r, ql, ap in shapes:
        R, m = q.shape
        n = r.shape[1]
        e = lambda *s, dt: torch.empty(s, dtype=dt, device=dev)  # noqa
        bufs = (e(2, R, dt=torch.float32), e(5, R, dt=torch.int32),
                e(R, m + n, dt=torch.int8), e(2, R, m + n, dt=torch.int16),
                e(R * m * max(n, 640), dt=torch.uint8))
        want = sw.sw_batch_plain(q, r, ql, ap)
        sw_cases.append((name, (q, r, ql, ap), bufs, (torch.cat([
            want.score, want.sel_score, want.q_start.float(),
            want.q_end.float(), want.r_start.float(), want.r_end.float(),
            want.n_ops.float()]), want.ops_rev, want.step_i, want.step_j)))

    sc_cases = []
    for name, target, idx, w, keep in scatters:
        n = target.numel()
        flat = idx.reshape(-1)
        live = keep.reshape(-1) & (flat >= 0) & (flat < n)
        keys, order = torch.sort(torch.where(live, flat.to(torch.int32), n),
                                 stable=True)
        want = sc.scatter_add_ordered_plain(target.clone(), idx, w, keep)
        b_ms, _, kept, touched = cs.scatter_bound(idx, keep, n)
        sc_cases.append((name, target, keys, order, w.reshape(-1)
                         .contiguous(), want))
        emit(dict(scatter_input=name, entries=flat.numel(), cells=n,
                  kept=kept, touched=touched, bound_ms=b_ms,
                  segments=cs.segment_lengths(idx, keep, n)))
    torch.cuda.synchronize()

    variants = ("kernel", "walkless") if "sw" in probe else ("kernel",)
    with tempfile.TemporaryDirectory(prefix="kernel_probe_") as tmp:
        for k, (label, csrc) in enumerate(srcs if shapes or scatters
                                          else ()):
            for variant in variants:
                work = Path(tmp) / f"{label}-{variant}"
                shutil.copytree(csrc, work)
                if variant == "walkless":
                    (work / "sw.cu").write_text(
                        walkless((work / "sw.cu").read_text()))
                try:
                    so = kernels.build(work, work / "build")
                except kernels.KernelBuildError as exc:
                    emit(dict(source=label, variant=variant,
                              build_error=str(exc)[-600:]))
                    continue
                handle = kernels.load(so)
                emit(dict(source=label, variant=variant, ptxas={
                    s: kernels.ptxas_usage(s) for s in ("sw.cu",
                                                        "scatter.cu")},
                    sass_k20=sass_mix(so, "ILi20E")))
                for name, call, bufs, want in sw_cases:
                    q, r, ql, ap = call
                    sw_call(handle, *call, bufs)
                    f32, i32, ops, steps, _ = bufs
                    got = (torch.cat([f32[0], f32[1]] + [
                        x.float() for x in i32]), ops, steps[0], steps[1])
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    if variant == "kernel" and not same:
                        raise SystemExit(f"kernel_probe: {label} sw differs "
                                         f"from the plain version on {name}")
                    ms = cs.time_ms(lambda: sw_call(handle, *call, bufs))
                    emit(dict(source=label, variant=variant, kernel="sw",
                              input=name, R=q.shape[0], m=q.shape[1],
                              n=r.shape[1], ms=ms, equal_to_plain=same))
                    if name == "utg chunk" and k == 0 and \
                            variant == "kernel":
                        for gap in map(float, args.gaps.split(",")):
                            ms_gap, clocks = [], []
                            for _ in range(5):
                                torch.cuda.synchronize()
                                t0 = time.monotonic()
                                time.sleep(gap)
                                clocks.append(sm_clock_mhz())
                                idle = time.monotonic() - t0
                                ms_gap.append(cs.time_ms(
                                    lambda: sw_call(handle, *call, bufs),
                                    reps=1, warmup=0))
                            emit(dict(source=label, kernel="sw",
                                      input=name, gap_s=gap, idle_s=idle,
                                      ms=ms_gap, sm_clock_mhz=clocks))
                        emit(dict(source=label, kernel="sw", input=name,
                                  gap_s=0, sm_clock_mhz_after_series=
                                  sm_clock_mhz()))
                if variant == "walkless":
                    continue
                for name, target, keys, order, w, want in sc_cases:
                    out = target.clone()

                    def launch(out=out, keys=keys, order=order, w=w):
                        rc = handle.pt_scatter_add_ordered(
                            out.data_ptr(), keys.data_ptr(),
                            order.data_ptr(), w.data_ptr(), keys.numel(),
                            out.numel(), kernels.stream_of(out))
                        assert rc == 0, f"scatter: CUDA error {rc}"
                    launch()
                    if not torch.equal(out, want):
                        raise SystemExit(f"kernel_probe: {label} scatter "
                                         f"differs from the plain version "
                                         f"on {name}")
                    emit(dict(source=label, kernel="scatter", input=name,
                              ms=cs.time_ms(launch), equal_to_plain=True))
                torch.cuda.empty_cache()
    out = dict(rows=rows)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "kernel_probe.json").write_text(json.dumps(out))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
