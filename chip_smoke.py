#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``proovread_tpu_torch``) on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order;
any failure exits non-zero:

1. setup: the card's name and power limit, torch/CUDA versions, the
   kernel build from ``proovread_tpu_torch/csrc`` (seconds printed), the
   registers, shared memory and spills ptxas reports for the kernels of
   ``sw.cu`` and ``scatter.cu``, and the f32 rate of the bounds;
2. every kernel against its plain PyTorch version on the card, on seeded
   inputs at the main path's shapes (bsw v2 and v1 at W=96 and W=64,
   R=8192, m=112; the three pileups at B=256, Lp=24576, R=8192, n=208;
   assemble at B=256, L=24576 and at the longest bucket, B=40, L=49152;
   HCR at B=256, L=24576 and at B=32, L=49152): every output bitwise
   equal, bsw v1 also equal to v2 on the same candidates. The bit-plane
   pileup runs on random windows and on the main path's clustered shape
   (the same planes as sorted candidates of 12 reads, 16-aligned windows);
   the packed-word pileup on random windows, on the high-coverage path's
   clustered shape (the same words as sorted candidates of 2 reads,
   16-aligned windows in the first ~2,000 columns of each, about 140 state
   votes a covered column) and on one window (lanes past 256 votes); the ordered pileup is
   equal again on a second run, on random windows and on clustered ones
   (the same slabs as sorted candidates of 8 reads at Lp=12288, about 1000
   a read, the shape of the qual-weighted pass's chunks). Assemble's
   fields are partly out of the ranges the packing clamps. bsw v2 also runs
   at the mr shapes (m=256 with 250 bp queries, W=96 and W=64), and the
   Smith-Waterman kernel of siamaera's mapper at its chunk (R=2048, m=256,
   n=384: half a read's window against its reverse complement, half chance
   seeds) and at the scan engine's sr chunk (R=4096, m=128, n=256, 100 bp
   queries, BWA_SR) and at the ccs/utg chunk (R=4096, m=512, n=640,
   512-base windows, CCS_ALIGN), and on a real ``utg`` chunk (the first
   2048 candidates ``utg_correct`` sends the kernel on phase 12's genome
   and unitigs: windows aligned end to end), the accuracy scoreboard's LCS kernel on
   646 (read, truth) pairs at the E.coli-class spread (truths up to 45,000
   bases) with the edge cases (empty read or truth, truths of 64, 2048 and
   4096 bases, a read past its truth, N codes; its blocks, warps a pair,
   registers and occupancy logged), the scoreboard's banded traceback
   (``csrc/edit.cu``: its DP and walk kernels, each timed, beside the
   DP's chain floor) on 64 pairs before (~15% errors) and after (~0.1%)
   correction at E.coli-class lengths and its edge cases (also against
   the host numpy ``edit_alignment``, in the background), and the
   ordered vote
   scatter (``csrc/scatter.cu``) on 16 M random fractional weights with
   heavy duplication onto a 256 x 24576 x 6 target, on 4 M with segments
   of 1,000 and more, and on the four scatters of one real ``ccs-1``
   chunk (phase 11's subreads at 400 kb of molecules) and of the real
   ``utg`` chunk's first ``accumulate``, each twice, also equal to
   ``index_add_`` of the kept entries in index order on CPU copies, with
   their segment lengths (and the public call's sort alone timed
   beside). Launcher, plain
   and library times (median of CUDA-event timings after a warm-up; the
   plain versions of bsw, sw, the LCS and the traceback, which take
   seconds, once: the call that checks the kernel), the
   kernels' own device time and the device operations of one launcher
   call (torch.profiler), and each kernel's bound from its bytes and
   operations;
3. on bench config 4's workload (10 kb genome, 40 kb of long reads, 30x
   short reads), on the card and on the CPU, all identical: ``Pipeline.run``
   (4 iterations; records, qual, chimeras and task reports), the same at
   coverage 400 (every pass on the packed-word pileup), and the
   qual-weighted ``DeviceCorrector`` chain (pass 1, fused passes, a
   finish pass collecting alignments: consensus calls, read state, pass
   counts and alignment data; three fused passes), and the command line (``cli.main``, siamaera
   on) in sr-noccs and, with 30x of 250 bp short reads, mr-noccs: all six
   output files (``parameter.log`` but its argv), and, scored against the
   workload's truth (``--truth --qc-out --metrics-out``), ``qc.jsonl``
   byte for byte and the metrics but for their timings; the sr-noccs
   accuracy aggregate must equal the JAX package's recorded config-4 row
   in ``ACCURACY_r10.json`` (read as data); then one ``--trace`` run on
   the card, whose span tree must hold the run, bucket, pass and
   score-accuracy spans and every QC record's bucket span; then
   ``Pipeline.run(engine="scan")`` on the card and the CPU, identical;
   then, on config 4's genome with 80 kb of long reads (11 reads, two
   buckets at ``batch_reads`` 8), the resilience ladder under
   ``fault_spec="compile@b0.p2;oom@b1"`` (every pass run): each faulted
   bucket walks fused -> eager -> chunk-halved -> host-scan and equals the
   card's ``engine="scan"`` run on that bucket's reads, with the
   reference's demotion reports and ``resilience_demotions{to_rung}`` and
   ``device_faults{kind}`` counts; and the command line killed by
   ``PROOVREAD_FAULT=compile@b1 --no-ladder`` with bucket 0 journaled, then
   ``--resume``d: the five files, ``parameter.log`` (but its argv and the
   journal's config keys) and ``qc.jsonl`` byte-identical to an
   uninterrupted run's; and the command line, scored, in the modes of
   ``ccs-1``, ``-u`` and ``--haplo-coverage``: config 4's genome as PacBio
   subreads (16 kb of molecules) in ``sr``, config 4's long reads with
   unitigs in ``sr+utg-noccs`` and ``utg-noccs``, and two haplotypes
   (``haplotype_workload``) with ``--haplo-coverage`` bare and 12 in
   ``sr-noccs``: all six files and ``qc.jsonl`` identical on card and
   CPU; and, the same way, sr-noccs and mr-noccs with the short-read set
   streamed (a config's ``sr-device-budget`` of 4 KiB; their five files
   also equal to the resident runs'), sr-noccs with ``--debug`` (its
   ``admitted.*.sam`` dumps and ``res.debug.tsv`` identical too),
   ``-m legacy``, ``-m sam --sam`` and ``-m bam --bam`` (all long reads but
   the last: a ``.bai`` region fetch) on config 4's mapping
   (``mapping_sam``: pass 1's device pass on the card, exact records,
   converted to BAM and indexed with the port's tools), and ``tools
   sam2cns --variants --stabilize`` on that mapping (the table
   identical); and ``python -m proovread_tpu_torch serve`` as a subprocess
   with config 4's short reads, its long reads submitted over the socket
   as one job, every verb asked, drained clean, its
   SLO valid: the card's job results byte for byte those of the same
   server with ``--device cpu`` (``ServeTwin``; the CPU server runs from
   the end of phase 1 on, at low priority, beside the card phases). Every
   CPU half of phase 3 runs in two subprocesses of 4 threads each at low
   priority (``CpuSide``) started after phase 1, beside phases 2-17 (so
   every phase's times, phase 2's launcher times among them, are taken
   beside it, those of phases 3-17 beside the traceback holds,
   ``EditHold``, and those of phases 7-17 beside the lanes); phase 3
   runs the card halves, and the
   two sides are compared, and phase 3's comparison lines logged, after
   the lanes have ended;
4. the main path: ``Pipeline.run`` on the E.coli-class workload (1.25 Mb
   genome, 5 Mb of CLR reads, 30x short reads, 6 iterations);
5. high coverage: ``Pipeline.run`` on a 250 kb genome, 1 Mb of CLR reads
   and 200x short reads at ``coverage=sr_coverage=finish_coverage=200``
   (max_coverage 150 on every pass: a lane may collect up to 2*150+2 = 302
   votes, more than the reference's bf16 bit-plane buffer counts exactly,
   so every pass takes the packed-word pileup); it also prints how many votes the first bucket's
   columns really collect in one pass;
6. qual-weighted votes: the first length bucket of phase 4's workload
   that fills the driver's 256 rows, packed as the driver packs it, through
   ``DeviceCorrector.correct_pass`` and two fused passes against the whole
   resident short-read set;
7. the command line at E.coli class: phase 4's reads written as FASTQ,
   ``cli.main`` with its defaults (mode sr-noccs, siamaera on, the
   checkpoint journal on), scored against the reads' truth (``--truth
   --qc-out --metrics-out``): wall, bases/s (the wall without the
   scoring), the journal's writes, bytes and write seconds (and that it is
   removed at the end), peak
   memory, siamaera's seconds split into host seeding and Smith-Waterman,
   its candidates and counts, the bsw, sw, LCS and traceback launches
   and device time (CUDA events around each launch), the score-accuracy
   seconds
   (from the command line's ``accuracy:`` log line), the
   reads scored, identity before and after, the error classes before and
   after and those introduced; every output read must be scored, and its
   mean identity after must reach the scoreboard's floor (0.95) and pass
   the identity before;
9. kill and resume at E.coli class: phase 7's command without ``--truth``
   under ``PROOVREAD_FAULT=compile@b3 --no-ladder`` must stop with buckets
   0-2 journaled; ``--resume`` in the same output dir must then write
   phase 7's five files and ``parameter.log`` (but its argv and the
   journal's config keys) byte for byte, with 3 journal replays and 3
   writes;
10. the scan engine timed: ``Pipeline.run(engine="scan")`` on the card on
   20 reads of phase 4's first length bucket with every third short read
   (10x; cut to keep the whole run short):
   wall, passes, the sw kernel's launches and device time;
8. mr at E.coli class: the first half of the same long reads (2.5 Mb, cut
   to keep the whole run short) with 30x of 250 bp short reads (mode
   mr-noccs), the same numbers and holds, but the scoring classifies 16
   sampled reads' errors, not the default 64 (also a cut for time;
   identity is scored for every read);
11. subreads at E.coli class: 2 Mb of molecules of phase 4's genome as
   PacBio subreads (``subread_workload``: one subread in 1 ZMW of 5, 2-4
   of alternating strand in the rest, CLR errors, ~5 Mb) with phase 7's
   short reads, ``cli.main`` with its defaults (mode sr: ``ccs-1``, then
   the passes), scored: phase 7's numbers plus the ``ccs-1`` seconds,
   ``CcsStats``, reads and bases after it, its sw and scatter launches and
   device time, and every subread's identity against its molecule;
12. unitigs at E.coli class: phase 4's CLR reads, phase 7's short reads
   and 15-30 kb unitigs tiling the genome at ~1.2x with 0.1%
   substitutions (``unitig_workload``), ``cli.main -u`` (mode
   sr+utg-noccs), scored: phase 7's numbers plus the ``utg`` seconds split
   into host seeding, sw, the scatter and the consensus call, each sw
   launch's device time and its C call's host time (least, median,
   largest; so in phase 11), and its TaskReport;
13. flex at E.coli class: two haplotypes (A = B with a SNP every 200
   bases), 5 Mb of CLR reads half from each, 8x of A's and 30x of B's
   short reads, ``cli.main --haplo-coverage`` (mode sr-noccs), scored:
   the passes, the reads with a finite own-haplotype estimate and their
   median, the identity of A's and B's reads against their own haplotype,
   and the share of A's reads (and of their SNP columns) that keep A's
   bases, with flex and, in the same phase, without it (siamaera off);
14. the streaming regime at full width: ``Pipeline.run`` on 1 Mb of CLR
   reads of phase 4's genome with 80x of 100 bp short reads (1,000,000
   reads, 340,000,000 bytes packed; the passes sample), once resident and
   once streamed (``sr_device_budget`` 128 MiB): each run's wall, bases/s,
   peak device memory and regime, the largest slab's bytes; the two runs'
   records identical, and the streaming peak below the resident one by at
   least half of the set's bytes less the largest slab's;
15. SAM/BAM re-entry at full width: the first ~500 kb of phase 4's raw
   reads (a cut for time: a re-entry run takes ~0.4 ms of wall an
   alignment) mapped on the card against phase 4's short reads
   (``mapping_sam``: each bucket through one ``correct_pass`` with
   pass 1's parameters, the admitted alignments dumped with
   ``dump_admitted_sam`` and written as exact records), converted to BAM
   and ``.bai`` with ``tools samfilter`` / ``tools bamindex``, then
   ``cli.main -m sam --sam`` and ``-m bam --bam`` on all those reads but
   the last, scored: the mapping seconds, the re-entry walls and bases/s,
   identity before and after; the two runs' five files identical and the
   identity after above before; then ``tools sam2cns --variants`` on the
   SAM (seconds, rows);
16. serving at full width (``phase16``): ``simulate_job_stream`` on phase
   4's genome, eight jobs each of clr, ccs and unitig from two tenants
   (reads of 2-15 kb, ~2 Mb), served through ``CorrectionServer`` over its
   socket against phase 4's short reads (``serve/smoke.py:envelope``: the
   reference smoke's five job faults, a drain after one bucket, a resume on
   the same state dir), batches of 64 reads: wall, completed bases/s,
   waves, p50 and p99 latency by length class, the device's busy share
   (``torch.profiler``); every job terminal with its expected status, each
   completed clr job's records those of one batch ``Pipeline.run`` of its
   wave's reads, both SLOs valid, no CUDA tensor left;
17. the fleet on one card (``phase17``): ``obs/load.run_smoke`` with the
   ``slam`` scenario, two in-process replicas, ``replica_death@r1.j5``,
   fleet accuracy scored on the card: wall, fleet bases/s, handoffs,
   identity before and after by family, the device's busy share; a
   handoff, no job lost or counted twice, a valid LOAD row;
18. more than one GPU (``phase18``): the shard-exact workload family
   (``simulate_independent_segments``, seed 18: 640 reads of 8,000 bases,
   each read's own segment, 30x of 100 bp short reads, 1,536,000 of them;
   simulated in the background from the start of the process that runs
   the phase, ``MeshWorkload``) through ``Pipeline.run`` (6 iterations,
   the default config), scored, once on one device and once at
   ``mesh_shards=2`` with two ranks (``parallel/launch.py``; on one card
   both ranks share it) and a shard's candidate cap of 32 chunks: the
   corrected and trimmed records and the QC aggregate, identity scores
   included, byte for byte; both walls, identity before and after, each
   rank's launches of bsw v2, the bit-plane pileup, assemble and HCR (each
   above 0); then the mesh fault drill (``parallel/smoke.drill``: four
   ranks on the card, the five phases of ``python -m
   proovread_tpu_torch.parallel.smoke``);
19. the kernel build's own account (``phase19``): a kernel-build artifact
   built (``analysis/factory.py --artifact``, ``nvcc`` afresh), its
   manifest valid under the port's validator and verified, a copy with
   its library truncated and one with its version edited both refused; a
   cold and an artifact boot measured in subprocesses (``obs/boot.py
   run``: the cold one builds, the artifact one compiles nothing, no
   violation, hit rate 1.0; walls, torch import and CUDA-context seconds
   logged); phase 4's workload, uncut, through ``Pipeline.run`` in a fresh
   process under the profiler, a span tracer and a compile ledger with an
   empty library cache (``profiled_run``, started first and run beside the
   rest), so the build lands inside the run: its records byte-equal to
   phase 4's, its ledger valid and reconciling with the trace, one build
   window that ran ``nvcc``, each kernel entry's ``kernel_flops_total``
   the cost models' sum over the calls that launched and its launches
   ``count_launch``'s, the roofline printed with a share of the card's
   peak for rows 1-4; config 4 through the command line plain and with
   ``--trace --xprof --compile-ledger --compile-cache`` (a verified copy
   of the artifact): the five files equal, the library a cache hit, the
   profiler's trace naming the port's kernels and the span ranges; and
   ``serve --boot-from-artifact`` answering config 4's reads as one job,
   its ``boot.json`` a valid row with a cache hit and no violation;
20. the history gates (``phase20``): ``obs/accuracy.py record_workload``
   records config 4, config 3 (80,000 bases) and dmesh (four gloo ranks
   on the card) as ``cuda`` ACCURACY rows, each a scored command-line
   subprocess (its wall and each kernel entry's calls, from its compile
   ledger, logged); 3 and 4 score as ``ACCURACY_r10.json`` does, dmesh
   as the same workload on one device; then ``accuracy_check`` (r10 and
   the new rows), ``boot_check`` (phase 19's BOOT rows),
   ``compile_check`` (``COMPILE_r09.json`` and one warm config 4 run on a
   copy of phase 19's artifact) and, in the main process after the
   lanes, ``load_check`` (``LOAD_r18.json`` and phase 17's LOAD row):
   each PASS, the card's rows in pools of their own.

Every trace, metrics, QC and truth-sidecar artifact the command-line runs
write (phases 3, 7, 8, 11-13, both sides of phase 3's twins) passes the
port's own validators (``obs/validate.py``) too.

The main process runs phases 2-7, 11, 9, 10, 14 and 17 in that order.
From the end of phase 6 on, three lanes (``Lane``: a second
``chip_smoke.py`` each, ``--skip`` every other phase and ``--lane-out``)
run phases 13, 8 and 16, phases 12, 15 and 18, and phases 19 and 20
beside it,
the first two each on its own copy of phase 4's workload (phase 19's
subprocesses build, boot and profile on their own); their logs are
printed after phase 17.
Phases 9-12, 15 and 16 use phase 7's short reads. Each phase logs its wall
and when it ended in seconds of its process. Phases 4-18 each reset every kernel's launch count
just before and read them just after; each fails if a kernel of its path
was not launched (phases 7 and 8: sw, bsw v2, the bit-plane pileup,
assemble, HCR, the LCS and the traceback; phase 9 the same but the
scoreboard's two; phase 10 sw; phases 11 and
12 those of 7 and the scatter; phase 13 those of 7 but sw; phase 14 bsw
v2, the bit-plane pileup, assemble and HCR; phase 15 bsw v2, the
bit-plane pileup, the scatter and sw; phase 16 those of 14, sw and the
scatter; phase 17 those of 16, the LCS and the traceback; phase 18 those
of 14, and in each rank of its mesh run), and phase 5
also if the bit-plane pileup was. No unfaulted phase may demote: phases
3-5, 7-13 and 14 fail on a ``resilience_demotions`` or ``device_faults``
count or a ``demote-`` report (phase 6 drives ``DeviceCorrector`` below
the ladder). Every scored phase holds that every output read was scored
and that the mean identity after reaches 0.95 and passes the one before;
phase 13 holds that for haplotype B's reads, and A's by the SNP share.
Every pair the scoreboard classifies on the card in phases 7, 11 and 12,
and phase 2's traceback pairs, are held in background subprocesses
(``EditHold``; phase 2's started after phase 2's kernel times, the others
after their phase) against the host numpy ``edit_alignment`` and (but
phase 2's, whose plain run is its check's) ``edit_alignments_plain``, one
subprocess each; the script waits for them at the end.

Phase 2 calls each kernel's public wrapper on CUDA tensors and holds it
against the plain version on the same card inputs, and against the wrapper
on CPU copies where the wrapper does work of its own around the kernel
(assemble's field rules, HCR's parameter rounding and masked fraction).
Its times are those of the kernel's launcher alone (``ms``, the number
the kernels line reports; for assemble the whole public call) and, from
the profiler, of the kernel itself.

It then prints the card line, the ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Without a card, or without the package
beside it, it exits non-zero and prints no result.

``--profile`` reruns phases 4-6 under ``torch.profiler`` and prints the
device time and launches of every port kernel in each. ``--skip`` drops
phases for development runs; a run that skips a phase prints no result
lines (the full run takes no arguments). ``--lane-out`` is the lanes'.

The functions of phases 3-6 and 11-18 take the device as an argument,
and those of phases 7-8 run ``cli.main``, so the same code runs on the
CPU at a small size.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet), used for each kernel's bound; the
# INT32 rate is the Hopper white paper's 64 INT32 lanes an SM x 132 SMs at
# the 1.98 GHz boost clock
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 16.7e12
# the least clocks between two dependent integer instructions on Hopper;
# a loose lower bound on a chain of them (shuffles, ballots and predicate
# logic take longer)
MIN_DEP_CLOCKS = 4


def edit_chain_instructions(W):
    """The dependent instructions of one column of ``csrc/edit.cu``'s DP
    at W words a lane, counted from the source, a 64-bit add or compare as
    two (low and high half), 64-bit logic as one (its halves are
    independent): Eq & Pv (1), a word's sum (2) and its carry-out test
    (2), the lane's generate (1 a word), the ballot (1), the lanes'
    carries (or, add, xor, the lane's bit: 4), the words' carries up to the
    top word's sum (1 a word), Xh and Ph (2), the top bits (2), the shuffle
    (1), lane 0's +1 (1), the shift's or (1), Pv (1). Not the compiled
    code's chain: a count for a loose lower bound."""
    return 17 + 2 * W


def edit_chain(pairs, bands):
    """``csrc/edit.cu``'s DP chains on ``pairs`` at ``bands`` (as
    ``edit_alignments`` takes them): each pair's shorter and longer sides
    (``la``, ``lb``), the wrapper's plan (``edit_plan``), its words a lane
    (``words``) and ``clocks``, a loose lower bound on its DP's time: its
    columns x ``edit_chain_instructions`` x MIN_DEP_CLOCKS, each
    instruction at the least latency of any (the card's single pairs take
    several times it: PERF.md, row 11)."""
    from proovread_tpu_torch.obs import accuracy as acc
    la = np.asarray([min(len(a), len(b)) for a, b in pairs])
    lb = np.asarray([max(len(a), len(b)) for a, b in pairs])
    band = np.asarray(bands, np.int64)
    plan = acc.edit_plan(la, lb, np.where(band == 0, 64,
                                          np.maximum(band, 1)))
    words = np.abs(plan["W"])
    clocks = np.where(la > 0, lb * MIN_DEP_CLOCKS
                      * edit_chain_instructions(words), 0)
    return dict(la=la, lb=lb, plan=plan, words=words, clocks=clocks)

# f32 lanes an SM a clock for one add, max or compare. No bound here counts
# a fused multiply-add (the data sheet's 67 TFLOP/s counts one as two): the
# bsw and sw DPs are built with -fmad=false, and the pileups and the
# scatter add. The f32 rate of every bound is this x the card's SMs x its
# maximum SM clock (f32_ops_per_s)
F32_LANES_PER_SM_CLOCK = 128
# free card memory phase 1 waits for: about twice the most that a phase
# holds (PERF.md, section 5)
NEED_FREE_GIB = 8.0


# when this process started, for ``mark``
T_START = time.monotonic()


def log(msg: str) -> None:
    print(msg, flush=True)


def mark(label: str, t0: float) -> None:
    """Log how long ``label`` took since ``t0`` and when it ended, in
    seconds of this process."""
    now = time.monotonic()
    log(f"{label} took {now - t0:.1f} s, ended at {now - T_START:.1f} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi clocks.max.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


_F32_RATE = []


def f32_ops_per_s() -> float:
    """The bounds' f32 rate: ``F32_LANES_PER_SM_CLOCK`` x SMs x the
    maximum SM clock (33.45 x 10^12/s on an H100 SXM at 1,980 MHz)."""
    import torch
    if not _F32_RATE:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _F32_RATE.append(F32_LANES_PER_SM_CLOCK * sms * max_sm_clock_hz())
    return _F32_RATE[0]


def card_memory() -> str:
    """The card's memory in use and every compute process nvidia-smi sees
    on it, for the log."""
    def query(*args):
        out = subprocess.run(["nvidia-smi", *args, "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return "; ".join(out.stdout.strip().splitlines()) or "none"
    return (f"memory used, total: {query('--query-gpu=memory.used,memory.total')}"
            f"; compute processes (pid, memory): "
            f"{query('--query-compute-apps=pid,used_memory')}")


def wait_for_card_memory(need_gib: float = NEED_FREE_GIB,
                         max_wait_s: float = 240.0, poll_s: float = 5.0):
    """Wait, at most ``max_wait_s``, until the card has ``need_gib`` free,
    since another process may hold the card for a while. Logs what holds
    the card while it waits; returns the free GiB at the end (the run goes
    on either way)."""
    import torch
    t0 = time.monotonic()
    free = torch.cuda.mem_get_info()[0] / 2**30
    log(f"card memory: {free:.2f} GiB free; {card_memory()}")
    while free < need_gib and time.monotonic() - t0 < max_wait_s:
        time.sleep(poll_s)
        free = torch.cuda.mem_get_info()[0] / 2**30
        log(f"card memory: {free:.2f} GiB free after "
            f"{time.monotonic() - t0:.0f} s; {card_memory()}")
    if free < need_gib:
        log(f"card memory: only {free:.2f} GiB free after waiting "
            f"{max_wait_s:.0f} s, less than the {need_gib} GiB this run "
            "may need")
    return free


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


def timed_once(fn):
    """(``fn()``, its CUDA-event time in ms): one call, the plain
    versions' time (each runs for seconds; their check's call is the
    timed one)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def launcher_times(fn, names, reps: int = 5, entry=None) -> dict:
    """Times of one call of a kernel's launcher ``fn``: ``ms``, its median
    CUDA-event time (host syncs and launch gaps included); ``kernel_ms``,
    the device time of the kernels of one call whose names hold one of
    ``names``, and ``kernel_ms_by_name`` that time for each of ``names``;
    ``device_ms``, all device work of one call (the
    kernels plus what the launcher runs around them: index checks, work
    lists, packing, copies), and ``device_ops``, the kernels, memsets and
    copies of one call. The last three from torch.profiler over ``reps``
    calls after a warm-up: each distinct kernel's mean time times its
    launches a call. Only ``check_sw`` at m=512 passes ``entry``: the
    profiler records no launch of that shape after phase 2's earlier
    checks, though it does in a process that profiles that shape first
    (cause not found). There, when the profiler records no launch of
    ``names`` three times over, the kernel's time comes from CUDA events
    around each call of the C ``entry`` instead (``KernelTimer``; nothing
    else runs on the stream between them), and ``kernel_ms_by_name``,
    ``device_ms`` and ``device_ops`` are then not measured (None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ms = time_ms(fn)
    # the profiler now and then returns no record of a kernel that ran
    # (seen in phase-2 runs on an H100: one launch in five or ten, or all
    # of them): profile again before failing, and count a call's launches
    # of each kernel as the rounded mean over the calls
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count > 0]
        mine = [e for e in evs if any(nm in e.key for nm in names)]
        if mine:
            break
    else:
        seen = sorted({e.key[:48] for e in evs})
        if entry is None:
            raise AssertionError(f"the profiler saw no launch of {names} "
                                 f"(it saw {seen})")
        log(f"launcher_times: the profiler saw no launch of {names} (it saw "
            f"{seen}); timing {entry} with CUDA events")
        with KernelTimer(entry) as kt:
            for _ in range(reps):
                fn()
        return dict(ms=ms, kernel_ms=kt.total_ms() / max(len(kt.events), 1),
                    kernel_ms_by_name=None, device_ms=None, device_ops=None,
                    kernel_timed_by="cuda events")
    attr = ("self_device_time_total" if hasattr(
        evs[0], "self_device_time_total") else "self_cuda_time_total")

    def per_call(events):
        ms_, ops = 0.0, 0
        for e in events:
            k = max(1, round(e.count / reps))
            ms_ += getattr(e, attr) / e.count * k / 1e3
            ops += k
        return ms_, ops
    kernel_ms, _ = per_call(mine)
    device_ms, device_ops = per_call(evs)
    by_name = {nm: per_call([e for e in mine if nm in e.key])[0]
               for nm in names}
    return dict(ms=ms, kernel_ms=kernel_ms, kernel_ms_by_name=by_name,
                device_ms=device_ms, device_ops=device_ops)


# each kernel's names as the profiler shows them
KERNEL_NAMES = {
    "bsw": ("bsw_kernel",),
    "bits": ("BitPlanes",),
    "packed": ("PackedWords",),
    "ordered": ("pileup_ordered_kernel",),
    "assemble": ("assemble_count_kernel", "assemble_tiles_kernel"),
    "hcr": ("hcr_scan_kernel",),
    "sw": ("sw_dp_kernel", "sw_walk_kernel"),
    "lcs": ("lcs_wave_kernel", "lcs_global_kernel"),
    "edit": ("edit_dp_kernel", "edit_walk_kernel"),
    "scatter": ("scatter_ordered_kernel",),
}


def bound(n_bytes: float, n_ops: float, ops_per_s: float | None = None):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over ``ops_per_s`` (default: the f32
    rate, ``f32_ops_per_s``)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / (ops_per_s or f32_ops_per_s()) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def bound_of(counts, ops_per_s: float | None = None):
    """``bound`` of (operations, bytes) as ``obs/profile.py``'s count
    functions give them."""
    n_ops, n_bytes = counts
    return bound(n_bytes, n_ops, ops_per_s)


def dp_rows(qlen, m: int) -> float:
    """Banded DP rows a bsw launch needs: each candidate's query length,
    at most m (the kernel stops at the query's end)."""
    return float(qlen.clamp(max=m).sum())


def count_where(t, pred, chunk: int = 1 << 24) -> int:
    """How many elements of ``t`` satisfy ``pred``, ``chunk`` elements at a
    time: a whole-size bool sum widens to int64, 3 GiB for a pileup."""
    flat = t.reshape(-1)
    return sum(int(pred(flat[i:i + chunk]).sum())
               for i in range(0, flat.numel(), chunk))


def max_abs_err(pairs, chunk: int = 1 << 24) -> float:
    """The largest |a - b| over the pairs, in f64, ``chunk`` elements at a
    time: whole f64 copies of a 1.6 GB pileup pair would take 13 GB."""
    err = 0.0
    for a, b in pairs:
        a, b = a.reshape(-1), b.reshape(-1)
        for i in range(0, a.numel(), chunk):
            d = a[i:i + chunk].double() - b[i:i + chunk].double()
            err = max(err, float(d.abs().max()))
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

def bsw_inputs(rng, ap, dev, R=8192, m=112, S=16384, B=256, Lp=24576,
               ql=100):
    """Seeded candidates with real alignments of ``ql`` bases planted (both
    strands, substitutions and indels), empty queries, out-of-range
    windows and 15% ignore bits."""
    import torch
    from proovread_tpu_torch.align import bsw
    from proovread_tpu_torch.ops.encode import revcomp_codes
    from proovread_tpu_torch.pipeline.dcorrect import device_revcomp
    W = bsw.band_lanes(ap)
    n = m + W
    genome = rng.integers(0, 4, (B, Lp)).astype(np.int8)
    qf = np.full((S, m), 4, np.int8)
    qlen = np.full(S, ql, np.int32)
    qlen[:4] = 0
    sread = rng.integers(0, S, R).astype(np.int32)
    strand = rng.integers(0, 2, R).astype(np.int32)
    lread = np.sort(rng.integers(0, B, R)).astype(np.int32)
    diag = rng.integers(0, Lp - 2 * ql, R).astype(np.int32)
    for s in range(4, S):
        b, p = int(rng.integers(0, B)), int(rng.integers(0, Lp - 2 * ql))
        src = genome[b, p:p + ql].copy()
        k = int(rng.integers(0, 4))
        if k == 1:
            src = np.insert(src, int(rng.integers(10, ql - 10)),
                            rng.integers(0, 4, 2))[:ql]
        elif k == 2:
            src = np.delete(src, int(rng.integers(10, ql - 10)))
            src = np.append(src, genome[b, p + ql])
        sub = rng.random(ql) < 0.02
        src[sub] = (src[sub] + 1) % 4
        qf[s, :ql] = src
    # point candidates at their query's true placement, strand 1 at the
    # reverse complement of it
    for i in range(R):
        s = int(sread[i])
        if s < 4:
            continue
        b, p = int(lread[i]), int(diag[i])
        q = qf[s, :ql]
        genome[b, p:p + ql] = q if strand[i] == 0 else revcomp_codes(q)
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


def check_bsw(rng, dev, ap, label, m=112, ql=100):
    import torch
    from proovread_tpu_torch.align import bsw
    args, n = bsw_inputs(rng, ap, dev, m=m, ql=ql)
    R = args[4].shape[0]
    m = args[0].shape[1]
    W = bsw.band_lanes(ap)
    got = bsw.bsw_expand_v2(*args, ap)
    want, plain_ms = timed_once(lambda: bsw.bsw_expand_v2_plain(*args, ap))
    pairs = [(getattr(got, f).int() if f == "valid" else getattr(got, f),
              getattr(want, f).int() if f == "valid" else getattr(want, f))
             for f in want._fields]
    assert_equal(f"bsw_expand_v2 {label}", pairs)
    n_valid = int(want.valid.sum())
    n_ins = int((want.ins_len > 0).sum())
    if n_valid < R // 2 or n_ins == 0:
        raise AssertionError(f"bsw {label}: weak inputs ({n_valid} valid, "
                             f"{n_ins} insertion columns)")
    tm = launcher_times(lambda: bsw._bsw_cuda(*args, ap),
                        KERNEL_NAMES["bsw"])
    # the count of obs/profile.py's model (bsw_v2_counts): 16 f32
    # operations each banded DP cell needs, whatever the design (the
    # substitution score: compare, select, add to the diagonal; the
    # insertion and deletion gaps: two subtracts, a max and the direction
    # compare each; H: three maxima and its two source compares), none an
    # FMA, so at the unfused rate (f32_ops_per_s); only rows up to each
    # query's length
    from proovread_tpu_torch.obs.profile import bsw_v2_counts
    n_ops, n_bytes = bsw_v2_counts(args[0].shape[0], m, R, W,
                                   args[2].numel(), dp_rows(args[3], m))
    b_ms, b_by = bound(n_bytes, n_ops)
    return dict(max_abs_err=max_abs_err(
        [(a.float(), b.float()) for a, b in pairs]), **tm,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"R={R} m={m} W={W} n={n}", valid=n_valid), got, args


def pileup_zeros(B, Lpile, dev):
    """A fresh f32 pileup of zeros. The checks make one for each call, and
    no spare copy, so that phase 2 holds at most two pileups (1.6 GB each
    at B=256, Lp=24576) at once."""
    import torch
    return torch.zeros((B, Lpile, 64), dtype=torch.float32, device=dev)


def touched_bound(in_bytes: float, want):
    """Bound of an unweighted pileup accumulated into zeros: its inputs read
    once, each cell that gains a vote read and written once; one f32 add
    per vote (``obs/profile.py:pileup_counts``, with the votes and cells
    these inputs give)."""
    from proovread_tpu_torch.obs.profile import pileup_counts
    cells = count_where(want, lambda c: c != 0)
    return bound_of(pileup_counts(in_bytes, float(want.sum()),
                                   cells)), cells


def check_pileup(rng, dev, bsw_res, bsw_args, B=256, Lp=24576,
                 clustered_reads=12):
    """The bit-plane pileup on phase 2's random windows (candidates of all
    256 reads) and on the main path's clustered shape (the same planes as
    sorted candidates of 12 reads, 16-aligned windows)."""
    import torch
    from proovread_tpu_torch.ops import pileup_kernel as pk
    from proovread_tpu_torch.ops.votes import (encode_votes_packed_bases,
                                               word_to_bits)
    words = encode_votes_packed_bases(
        bsw_res.state, bsw_res.qrow, bsw_res.ins_len, bsw_res.ins_b0,
        bsw_res.ins_b1, bsw_res.q_start, bsw_res.q_end, taboo_abs=7)
    b0, b1 = word_to_bits(words)
    R, n = b0.shape
    Lpile = Lp + 2 * n
    t = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731
    zeros = lambda: pileup_zeros(B, Lpile, dev)   # noqa: E731
    reads = rng.choice(B, clustered_reads, replace=False)
    inputs = {
        "random": (bsw_args[6], t(rng.integers(0, Lp + n, R).astype(np.int32))),
        "clustered": (t(np.sort(rng.choice(reads, R)).astype(np.int32)),
                      t((rng.integers(0, (Lp + n) // 16 + 1, R) * 16)
                        .astype(np.int32)))}
    out = {}
    for label, (read_of, w0) in inputs.items():
        want = pk.pileup_accumulate_bits_plain(zeros(), b0, b1, read_of, w0)
        got = pk.pileup_accumulate_bits(zeros(), b0, b1, read_of, w0)
        torch.cuda.synchronize()
        assert_equal(f"pileup_accumulate_bits ({label})", [(got, want)])
        err = max_abs_err([(got, want)])
        (b_ms, b_by), cells = touched_bound(8.0 * R * n + 8 * R, want)
        if cells == 0:
            raise AssertionError("pileup: no votes in the check inputs")
        peak = float(want.max())
        del got, want
        buf = zeros()
        tm = launcher_times(lambda: pk._pileup_cuda(buf, b0, b1, read_of, w0),
                            KERNEL_NAMES["bits"])
        plain_ms = time_ms(lambda: pk.pileup_accumulate_bits_plain(
            buf, b0, b1, read_of, w0), reps=5, warmup=1)
        votes = pk.decode_bits(b0, b1).reshape(-1, 64)
        rows = pk._rows(read_of, w0, Lpile, n).reshape(-1)
        flat = buf.view(-1, 64)
        lib_ms = time_ms(lambda: flat.index_add_(0, rows, votes), reps=5,
                         warmup=1)
        out[label] = dict(max_abs_err=err, **tm, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          touched_cells=cells, peak_cell=peak,
                          shape=f"B={B} Lp={Lp} R={R} n={n}")
        del buf, flat, votes
        torch.cuda.empty_cache()
    return dict(**out["random"], clustered=out["clustered"])


def check_bsw_v1(dev, ap, label, args, v2):
    """bsw v1 on the slabs v2 read (strand-oriented query rows, window
    codes): equal to its plain version, and, with v2's ignore gating
    applied, to v2."""
    import torch
    from proovread_tpu_torch.align import bsw
    q, rc, map_pad, qlen, sread, strand, lread, w0p = args
    R, m = sread.shape[0], q.shape[1]
    W = bsw.band_lanes(ap)
    n = m + W
    sr = sread.long()
    q1 = torch.where((strand == 0)[:, None], q[sr], rc[sr])
    cols = w0p.long()[:, None] + torch.arange(n, device=dev)[None, :]
    word = map_pad[lread.long()[:, None], cols]
    win1 = word & 7
    got = bsw.bsw_expand(q1, win1, qlen, ap)
    want, plain_ms = timed_once(lambda: bsw.bsw_expand_plain(q1, win1, qlen,
                                                             ap))
    ints = lambda r: [getattr(r, f).int() if f == "valid"  # noqa: E731
                      else getattr(r, f) for f in r._fields]
    pairs = list(zip(ints(got), ints(want)))
    assert_equal(f"bsw_expand {label}", pairs)
    ign = (word >> 3) > 0
    gated = got._replace(state=torch.where(ign, -1, got.state),
                         ins_len=torch.where(ign, 0, got.ins_len))
    assert_equal(f"bsw_expand == bsw_expand_v2 {label}",
                 list(zip(ints(gated), ints(v2))))
    tm = launcher_times(lambda: bsw._bsw_v1_cuda(q1, win1, qlen, ap),
                        KERNEL_NAMES["bsw"])
    # the same 16 f32 operations per banded DP cell as v2 (see check_bsw)
    from proovread_tpu_torch.obs.profile import bsw_v1_counts
    b_ms, b_by = bound_of(bsw_v1_counts(R, m, W, dp_rows(qlen, m)))
    return dict(max_abs_err=max_abs_err(
        [(a.float(), b.float()) for a, b in pairs]), **tm,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"R={R} m={m} W={W} n={n}"), got, (q1, ign)


def sw_inputs(rng, R=2048, m=256, n=384, band=40, qmax=None):
    """Siamaera-like candidates at the mapper's chunk shape: half are a
    read's own window against the reverse-complemented read on the
    matching strand (the plus-strand self-match siamaera drops after the
    alignment: the whole query aligns, so the walk runs its full length),
    half chance seeds against random windows; one in eight queries is
    shorter than ``qmax`` (default m; a read's last window), two are of
    length 0 and 1, and both sides carry N codes."""
    qmax = qmax or m
    r = rng.integers(0, 4, (R, n)).astype(np.int8)
    q = np.full((R, m), 4, np.int8)
    ql = np.full(R, qmax, np.int32)
    short = rng.random(R) < 0.125
    ql[short] = rng.integers(2, qmax, int(short.sum()))
    ql[:2] = [0, 1]
    off = band + rng.integers(-8, 9, R)
    for i in range(R):
        src = (r[i, off[i]:off[i] + m] if i % 2 == 0
               else rng.integers(0, 4, m).astype(np.int8))
        q[i, :ql[i]] = src[:ql[i]]
    q[(rng.random((R, m)) < 0.005) & (np.arange(m)[None, :] < ql[:, None])] = 4
    r[rng.random((R, n)) < 0.005] = 4
    return q, r, ql


def check_sw(rng, dev, R=2048, m=256, n=384, qmax=None, ap=None,
             chunk=None):
    """The Smith-Waterman kernel against its plain version: by default at
    siamaera's shape (R=2048, m=256, n=384) with siamaera's mapper
    parameters; the scan engine's sr chunk is R=4096, m=128, n=256 with
    100 bp queries and BWA_SR. ``chunk`` (q, r, qlen, params on the card,
    as ``utg_chunk_inputs`` captures them) replaces the synthetic inputs."""
    import torch
    from proovread_tpu_torch.align import sw
    from proovread_tpu_torch.align.params import AlignParams
    if chunk is not None:
        q, r, ql, ap = chunk
    else:
        ap = ap or AlignParams(min_out_score=0.0, score_per_base=False)
        q, r, ql = (torch.as_tensor(x, device=dev)
                    for x in sw_inputs(rng, R, m, n, qmax=qmax))
    R, m = q.shape
    n = r.shape[1]
    got = sw.sw_batch(q, r, ql, ap)
    want, plain_ms = timed_once(lambda: sw.sw_batch_plain(q, r, ql, ap))
    pairs = list(zip(got, want))
    assert_equal("sw_batch", pairs)
    long_walks = int((want.n_ops >= int(ql.max()) - 8).sum())
    if long_walks < R // 4:
        raise AssertionError(f"sw: weak inputs ({long_walks} long walks)")
    tm = launcher_times(lambda: sw._sw_cuda(q, r, ql, ap), KERNEL_NAMES["sw"],
                        entry="pt_sw_batch" if m == 512 else None)
    # the 16 f32 operations of a DP cell counted as for bsw (check_bsw),
    # over the rows each query needs (the kernel stops at max(qlen, 1))
    from proovread_tpu_torch.obs.profile import sw_counts
    rows = float(ql.clamp(1, m).sum())
    b_ms, b_by = bound_of(sw_counts(R, m, n, rows))
    return dict(max_abs_err=max_abs_err(
        [(a.float(), b.float()) for a, b in pairs]), **tm,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"R={R} m={m} n={n}", long_walks=long_walks,
        ops_walked=int(want.n_ops.sum()))


def check_pileup_packed(rng, dev, bsw_res, bsw_args, B=256, Lp=24576):
    """The packed-word pileup on phase 2's words placed three ways: random
    windows over all 256 reads (the kernel's row); the high-coverage path's
    clustered shape (``clustered``: the 8192 candidates sorted over 2
    reads, 16-aligned windows in the first columns of each, as few as give
    about 140 state votes a covered column, the coverage phase 5's columns
    reach); every
    candidate on one window of one read (``one_window``: lanes far past 256
    votes, where a bf16 buffer would round). Each bitwise equal to the
    plain version, with its own times, bound and ``index_add_`` time."""
    import torch
    from proovread_tpu_torch.ops import pileup_kernel as pk
    from proovread_tpu_torch.ops.votes import encode_votes_packed_bases
    words = encode_votes_packed_bases(
        bsw_res.state, bsw_res.qrow, bsw_res.ins_len, bsw_res.ins_b0,
        bsw_res.ins_b1, bsw_res.q_start, bsw_res.q_end, taboo_abs=7)
    R, n = words.shape
    Lpile = Lp + 2 * n
    t = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731
    zeros = lambda: pileup_zeros(B, Lpile, dev)   # noqa: E731
    # the clustered span: the words' state votes over 2 reads at 140 a
    # column, plus the window columns where no word votes
    state = pk.decode_words(words)[:, :, :8].sum(-1)
    offs = torch.nonzero(state.sum(0)).flatten()
    reach = int(offs[-1] - offs[0]) + 1
    span = max(n, 16 * round((float(state.sum()) / (2 * 140) + n - reach)
                             / 16))
    del state
    reads = rng.choice(B, 2, replace=False)
    inputs = {
        "random": (bsw_args[6], t(rng.integers(0, Lp + n, R).astype(np.int32))),
        "clustered": (t(np.sort(rng.choice(reads, R)).astype(np.int32)),
                      t((rng.integers(0, (span - n) // 16 + 1, R) * 16)
                        .astype(np.int32))),
        "one_window": (t(np.zeros(R, np.int32)),
                       t(np.full(R, 1000, np.int32)))}
    out = {}
    for label, (read_of, w0) in inputs.items():
        want = pk.pileup_accumulate_packed_plain(zeros(), words, read_of, w0)
        got = pk.pileup_accumulate_packed(zeros(), words, read_of, w0)
        torch.cuda.synchronize()
        assert_equal(f"pileup_accumulate_packed ({label})", [(got, want)])
        err = max_abs_err([(got, want)])
        (b_ms, b_by), cells = touched_bound(4.0 * R * n + 8 * R, want)
        n_votes = int(want.sum())
        if n_votes == 0:
            raise AssertionError("pileup packed: no votes in the check inputs")
        peak = float(want.max())
        if label == "one_window" and peak <= 256:
            raise AssertionError(f"pileup packed: peak lane count {peak} "
                                 "<= 256")
        state_votes = want[:, :, :8].sum(-1)
        col_votes = float(state_votes.sum() / (state_votes > 0).sum())
        if label == "clustered" and col_votes < 100:
            raise AssertionError(f"pileup packed: {col_votes} state votes a "
                                 "covered column on the clustered input")
        del got, want, state_votes
        buf = zeros()
        tm = launcher_times(lambda: pk._packed_cuda(buf, words, read_of, w0),
                            KERNEL_NAMES["packed"])
        plain_ms = time_ms(lambda: pk.pileup_accumulate_packed_plain(
            buf, words, read_of, w0), reps=5, warmup=1)
        votes = pk.decode_words(words).reshape(-1, 64)
        rows = pk._rows(read_of, w0, Lpile, n).reshape(-1)
        flat = buf.view(-1, 64)
        lib_ms = time_ms(lambda: flat.index_add_(0, rows, votes), reps=5,
                         warmup=1)
        out[label] = dict(max_abs_err=err, **tm, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          votes=n_votes, touched_cells=cells,
                          state_votes_per_column=col_votes, peak_lane=peak,
                          shape=f"B={B} Lp={Lp} R={R} n={n}")
        del buf, flat, votes
        torch.cuda.empty_cache()
    random = out.pop("random")
    random["max_abs_err"] = max(r["max_abs_err"]
                                for r in (random, *out.values()))
    return dict(**random, **out)


def check_pileup_dense(rng, dev, v1_res, v1_slabs, read_of):
    """The ordered pileup on qual-weighted build_votes slabs of the bsw v1
    check's candidates: bitwise equal to the plain version, twice."""
    import torch
    from proovread_tpu_torch.ops import pileup_kernel as pk
    from proovread_tpu_torch.ops.votes import build_votes
    q1, ign = v1_slabs
    qual = torch.as_tensor(rng.integers(2, 41, q1.shape).astype(np.uint8),
                           device=dev)
    votes = build_votes(v1_res.state, v1_res.qrow, v1_res.ins_len, q1, qual,
                        v1_res.q_start, v1_res.q_end, v1_res.valid,
                        ignore_cols=ign, qual_weighted=True, taboo_abs=7)
    R, n, _ = votes.shape
    B, Lp = 256, 24576
    Lpile = Lp + 2 * n
    w0 = torch.as_tensor(rng.integers(0, Lp + n, R).astype(np.int32),
                         device=dev)
    got = pk.pileup_accumulate(pileup_zeros(B, Lpile, dev), votes, read_of,
                               w0)
    want = pk.pileup_accumulate_plain(pileup_zeros(B, Lpile, dev), votes,
                                      read_of, w0)
    torch.cuda.synchronize()
    assert_equal("pileup_accumulate", [(got, want)])
    err = max_abs_err([(got, want)])
    del got
    got = pk.pileup_accumulate(pileup_zeros(B, Lpile, dev), votes, read_of,
                               w0)
    assert_equal("pileup_accumulate (second run)", [(got, want)])
    frac = count_where(want, lambda c: (c != 0) & (c != torch.round(c)))
    if frac == 0:
        raise AssertionError("pileup dense: no fractional sums in the check")
    del got, want
    buf = pileup_zeros(B, Lpile, dev)
    tm = launcher_times(lambda: pk._dense_cuda(buf, votes, read_of, w0),
                        KERNEL_NAMES["ordered"])
    plain_ms = time_ms(lambda: pk.pileup_accumulate_plain(
        buf, votes, read_of, w0), reps=5, warmup=1)
    rows = pk._rows(read_of, w0, Lpile, n).reshape(-1)
    flat = buf.view(-1, 64)
    v2d = votes.reshape(-1, 64)
    lib_ms = time_ms(lambda: flat.index_add_(0, rows, v2d), reps=5,
                     warmup=1)
    b_ms, b_by = dense_bound(votes, rows)
    del buf, flat
    clustered = check_pileup_dense_clustered(rng, dev, votes)
    return dict(max_abs_err=max(err, clustered.pop("max_abs_err")), **tm,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, shape=f"B={B} Lp={Lp} R={R} n={n}",
                fractional_cells=frac, clustered=clustered)


def dense_bound(votes, rows):
    """The ordered pileup's bound: the slabs and metadata read once, each
    touched cell read and written once; one f32 add per slab element
    (``obs/profile.py:pileup_counts``, with the cells these inputs
    touch)."""
    import torch

    from proovread_tpu_torch.obs.profile import pileup_counts
    R = votes.shape[0]
    cells = int(torch.unique(rows).numel()) * 64
    return bound_of(pileup_counts(4.0 * votes.numel() + 8 * R,
                                  float(votes.numel()), cells))


def check_pileup_dense_clustered(rng, dev, votes, B=8, Lp=12288):
    """The ordered pileup on the shape of the qual-weighted pass's chunks:
    the same slabs as sorted candidates of a few reads (about 1000 a read),
    windows spread over each read. Bitwise equal to the plain version,
    twice; kernel, plain and library times beside its bound."""
    import torch
    from proovread_tpu_torch.ops import pileup_kernel as pk
    R, n, _ = votes.shape
    Lpile = Lp + 2 * n
    read_of = torch.as_tensor(np.sort(rng.integers(0, B, R)).astype(np.int32),
                              device=dev)
    w0 = torch.as_tensor(rng.integers(0, Lp + n, R).astype(np.int32),
                         device=dev)
    got = pk.pileup_accumulate(pileup_zeros(B, Lpile, dev), votes, read_of,
                               w0)
    want = pk.pileup_accumulate_plain(pileup_zeros(B, Lpile, dev), votes,
                                      read_of, w0)
    torch.cuda.synchronize()
    assert_equal("pileup_accumulate (clustered)", [(got, want)])
    err = max_abs_err([(got, want)])
    del got
    got = pk.pileup_accumulate(pileup_zeros(B, Lpile, dev), votes, read_of,
                               w0)
    assert_equal("pileup_accumulate (clustered, second run)", [(got, want)])
    del got, want
    buf = pileup_zeros(B, Lpile, dev)
    tm = launcher_times(lambda: pk._dense_cuda(buf, votes, read_of, w0),
                        KERNEL_NAMES["ordered"])
    plain_ms = time_ms(lambda: pk.pileup_accumulate_plain(
        buf, votes, read_of, w0), reps=3, warmup=1)
    rows = pk._rows(read_of, w0, Lpile, n).reshape(-1)
    flat = buf.view(-1, 64)
    v2d = votes.reshape(-1, 64)
    lib_ms = time_ms(lambda: flat.index_add_(0, rows, v2d), reps=5,
                     warmup=1)
    b_ms, b_by = dense_bound(votes, rows)
    per_read = np.bincount(read_of.cpu().numpy(), minlength=B)
    return dict(max_abs_err=err, **tm, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                shape=f"B={B} Lp={Lp} R={R} n={n}",
                candidates_per_read=[int(x) for x in per_read])


def random_call(rng, dev, B, L, K=6):
    """ConsensusCall fields as the consensus call makes them, with some
    outside the ranges the packing clamps (insertion length 7-9, phred
    64-70, base -1 and 9, inserted base 7), so the clamps are checked."""
    import torch
    from proovread_tpu_torch.ops.consensus_call import ConsensusCall
    t = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731

    def wild(a, vals, frac):
        sel = rng.random(a.shape) < frac
        a[sel] = rng.choice(vals, int(sel.sum()))
        return a

    return ConsensusCall(
        emitted=t(rng.random((B, L)) > 0.15),
        base=t(wild(rng.integers(0, 5, (B, L)), [-1, 9], 0.01)
               .astype(np.int8)),
        ins_len=t(wild(np.where(rng.random((B, L)) < 0.08,
                                rng.integers(1, K + 1, (B, L)), 0),
                       [7, 8, 9], 0.002).astype(np.int32)),
        ins_bases=t(wild(rng.integers(0, 5, (B, L, K)), [7], 0.01)
                    .astype(np.int8)),
        freq=t(rng.random((B, L)).astype(np.float32)),
        phred=t(wild(rng.integers(0, 41, (B, L)), [64, 67, 70], 0.01)
                .astype(np.int32)),
        coverage=t(rng.random((B, L)).astype(np.float32)))


def check_assemble(rng, dev):
    """Assembly at the main path's shape (the kernel's row) and at its
    longest bucket (``longest_bucket``), each with its own numbers."""
    return dict(**check_assemble_at(rng, dev, 256, 24576),
                longest_bucket=check_assemble_at(rng, dev, 40, 49152))


def check_assemble_at(rng, dev, B, L):
    """The public ``assemble_rows(call, lengths, Lp)`` at Lp = L on fields
    partly out of range: equal to the plain version on the card (the
    reference's column words, then cumsum and scatter) and to the wrapper
    on CPU copies. Its time is that of the whole public call (``ms``),
    beside the device time of its assembly kernels alone (``kernel_ms``),
    all its device work (``device_ms``: the packing too, where the call
    packs) and its device operations."""
    import torch
    from proovread_tpu_torch.ops import assemble_kernel as ak
    call = random_call(rng, dev, B, L)
    lengths = torch.as_tensor(rng.integers(L // 2, L + 1, B).astype(np.int32),
                              device=dev)
    lengths[:2] = torch.tensor([0, L], dtype=torch.int32)
    Lp = L

    def plain():
        return ak.assemble_words_plain(ak.pack_columns(call, lengths),
                                       lengths, Lp)

    got = ak.assemble_rows(call, lengths, Lp)
    want = plain()
    want_cpu = ak.assemble_rows(type(call)(*(t.cpu() for t in call)),
                                lengths.cpu(), Lp)
    torch.cuda.synchronize()
    assert_equal(f"assemble_rows B={B}", list(zip(got, want)))
    assert_equal(f"assemble_rows B={B} (card vs CPU)",
                 [(a.cpu(), b) for a, b in zip(got, want_cpu)])
    if int((want[2] == Lp).sum()) == 0:
        raise AssertionError("assemble: no row was truncated at Lp")
    if int(want[1].max()) != 63 or int(want[0].max()) != 7:
        raise AssertionError("assemble: no clamped phred or base in the "
                             "check inputs")
    tm = launcher_times(lambda: ak.assemble_rows(call, lengths, Lp),
                        KERNEL_NAMES["assemble"])
    plain_ms = time_ms(plain, reps=5, warmup=1)
    # what the public call must move on these inputs: the lengths; the
    # emitted flag of each column below its read's length; base, ins_len
    # and phred of each emitting column; the inserted bases it uses; out,
    # 2 bytes a column over Lp and the new lengths
    valid = (torch.arange(L, device=dev)
             < lengths.clamp(0, L)[:, None].long())
    emit = valid & call.emitted
    n_ins = int(call.ins_len.clamp(0, 6)[emit].sum())
    from proovread_tpu_torch.obs.profile import assemble_counts
    b_ms, b_by = bound_of(assemble_counts(
        B, Lp, int(valid.sum()), int(emit.sum()), n_ins))
    return dict(max_abs_err=max_abs_err(list(zip(got, want))), **tm,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, shape=f"B={B} L={L} Lp={Lp}")


def check_hcr(rng, dev):
    """HCR masking at the main path's shape (the kernel's row) and at its
    longest bucket (``longest_bucket``), each with its own numbers."""
    return dict(**check_hcr_at(rng, dev, 256, 24576),
                longest_bucket=check_hcr_at(rng, dev, 32, 49152))


def check_hcr_at(rng, dev, B, L):
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
    tm = launcher_times(lambda: ak.hcr_mask_cuda(q, ln, pvi),
                        KERNEL_NAMES["hcr"])
    plain_ms = time_ms(lambda: ak.hcr_mask_plain(q, ln, pvi), reps=5,
                       warmup=1)
    from proovread_tpu_torch.obs.profile import hcr_counts
    b_ms, b_by = bound_of(hcr_counts(B, L))
    return dict(max_abs_err=max(errs), **tm, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=f"B={B} L={L}")


def lcs_inputs(rng, P=640):
    """(read, truth) code pairs at the E.coli-class spread: truths of
    lognormal length (mean ~8 kb, clipped to 500..45,000 bases, the
    longest set to 45,000), each read its truth with the CLR simulator's
    errors (~15%); then the edge cases: an empty read, an empty truth,
    truths of exactly 64, 2048 (a kernel lane's block) and 4096 bases, a
    read past its truth, N codes on either side, runs of N in a truth."""
    from proovread_tpu_torch.io.simulate import _apply_errors
    lens = np.clip(rng.lognormal(np.log(7000), 0.55, P), 500,
                   45_000).astype(np.int64)
    lens[0] = 45_000
    pairs = []
    for n_t in lens:
        tr = rng.integers(0, 4, int(n_t)).astype(np.int8)
        pairs.append((_apply_errors(tr, rng, 0.02, 0.08, 0.05), tr))
    for n_t in (64, 2048, 4096, 3000, 0, 700):
        tr = rng.integers(0, 4, n_t).astype(np.int8)
        pairs.append((_apply_errors(tr, rng, 0.02, 0.08, 0.05), tr))
    pairs[-1] = (np.zeros(0, np.int8), pairs[-1][1])         # empty read
    pairs[-3] = (np.concatenate([pairs[-3][0], rng.integers(0, 4, 900)])
                 .astype(np.int8), pairs[-3][1])             # read past truth
    pairs[-4][1][::7] = 4                                     # N in a truth
    pairs[-4][0][::5] = 4                                     # N in its read
    for a, b in ((320, 384), (1000, 1300), (2040, 2120)):     # runs of N a
        pairs[-3][1][a:b] = 4                                 # carry crosses
    return pairs


def check_lcs(rng, dev):
    """The accuracy scoreboard's LCS kernel against its plain version on
    ~640 pairs at the E.coli-class spread plus the edge cases (bitwise);
    the plain version runs once, as one group, and that run is its time."""
    import torch
    from proovread_tpu_torch.obs import accuracy as acc
    pairs = lcs_inputs(rng)
    args = acc.pack_pairs(pairs, dev)
    got = acc.lcs_lengths(*args)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    want = acc.lcs_lengths_plain(*args, group=len(pairs))
    b.record()
    b.synchronize()
    plain_ms = a.elapsed_time(b)
    assert_equal("lcs_lengths", [(got, want)])
    if int(want[0]) < 30_000:
        raise AssertionError(f"lcs: weak inputs (longest LCS {int(want[0])})")
    tm = launcher_times(lambda: acc.lcs_lengths(*args), KERNEL_NAMES["lcs"])
    # each input byte once, the offsets and the output; the recurrence on
    # a 64-bit word as Hopper's 32-bit units do it, 6 INT32 operations for
    # each matching-alphabet read base and truth word: u = V & M (one LOP3
    # a half), V + u with its carry (IADD3, IADD3.X), V' = s | (V & ~M)
    # (one three-input LOP3 a half). This is a throughput figure: the
    # floor in fact is the longest pair's dependent chain of steps
    from proovread_tpu_torch.obs.profile import lcs_counts
    steps = [int(((r >= 0) & (r < 4)).sum()) for r, _ in pairs]
    word_steps = sum(st * -(-len(t) // 64)
                     for st, (_, t) in zip(steps, pairs))
    n_ops, n_bytes = lcs_counts(sum(len(r) + len(t) for r, t in pairs),
                                len(pairs), word_steps)
    b_ms, b_by = bound(n_bytes, n_ops, PEAK_INT32_OPS_PER_S)
    layout = lcs_layout(pairs)
    return dict(max_abs_err=max_abs_err([(got.float(), want.float())]),
                **tm, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, word_steps=word_steps,
                ns_a_chain_step=tm["kernel_ms"] * 1e6
                / layout["longest_chain_steps"], **layout,
                shape=f"P={len(pairs)} bases={n_bytes}")


def lcs_layout(pairs):
    """How the LCS kernel runs ``pairs`` (``accuracy.lcs_plan``): its
    blocks, warps a block, the longest pair's warps and chain of steps
    (read length + 32 per further warp), pairs by warps and on the global
    scratch, and the kernel's registers a thread and resident blocks an SM
    at that block size."""
    import ctypes
    from proovread_tpu_torch import kernels
    from proovread_tpu_torch.obs import accuracy as acc
    n = np.asarray([len(r) for r, _ in pairs])
    m = np.asarray([len(t) for _, t in pairs])
    plan = acc.lcs_plan(n, m)
    K = plan["warps"]
    chain = np.where((n > 0) & (m > 0), n + 32 * (K - 1), 0)
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    kernels.check(kernels.lib().pt_lcs_occupancy(
        plan["warps_per_block"], ctypes.byref(regs), ctypes.byref(blocks)),
        "lcs_occupancy")
    return dict(blocks=plan["blocks"],
                warps_per_block=plan["warps_per_block"],
                longest_pair_warps=int(K[int(np.argmax(chain))]),
                longest_chain_steps=int(chain.max()),
                pairs_by_warps={str(x): c for x, c in
                                plan["pairs_by_warps"].items()},
                global_pairs=len(plan["glob"]), regs=regs.value,
                blocks_per_sm=blocks.value,
                ptxas=kernels.ptxas_usage("lcs.cu"))


def edit_bands(pairs, lcs):
    """The scoreboard's band of each (read, truth) pair from its LCS
    (``score_read_sets``: la + lb - 2 LCS + 8, at least 16) and the cells
    of its banded matrix."""
    la = np.asarray([len(r) for r, _ in pairs])
    lb = np.asarray([len(t) for _, t in pairs])
    w = np.maximum(la + lb - 2 * np.asarray(lcs) + 8, 16)
    return w, (np.minimum(la, lb) + 1) * (np.abs(la - lb) + 2 * w + 1)


def edit_inputs(rng, dev, n_each=32):
    """(read, truth) pairs as the scoreboard classifies them at E.coli
    class: ``n_each`` reads with the CLR simulator's errors (~15%, the
    reads before correction) and ``n_each`` with ~0.1% (after), truths of
    lognormal length (mean ~8 kb) redrawn while the banded matrix would
    pass ``MAX_CLASSIFY_CELLS`` (as the scoreboard skips such reads), the
    first truth 12,000 bases; then the edge cases: an empty
    read, an empty truth, a read past its truth, N on either side, an
    identical pair. Returns the pairs and their bands (``edit_bands``,
    from their LCS on the card)."""
    from proovread_tpu_torch.io.simulate import _apply_errors
    from proovread_tpu_torch.obs import accuracy as acc
    pairs, draws = [], 0
    for errs in ((0.02, 0.08, 0.05), (0.0004, 0.0003, 0.0003)):
        while len(pairs) < (n_each if errs[0] > 0.01 else 2 * n_each):
            n_t = int(np.clip(rng.lognormal(np.log(7000), 0.55), 500,
                              45_000))
            draws += 1
            if draws == 1:
                n_t = 12_000            # ~70 M cells at ~15% errors
            tr = rng.integers(0, 4, n_t).astype(np.int8)
            pr = (_apply_errors(tr, rng, *errs), tr)
            lcs = acc._lcs([pr], dev)
            if edit_bands([pr], lcs)[1][0] <= acc.MAX_CLASSIFY_CELLS:
                pairs.append(pr)
    tr = rng.integers(0, 4, 900).astype(np.int8)
    rd = _apply_errors(tr, rng, 0.02, 0.08, 0.05)
    rd_n, tr_n = rd.copy(), tr.copy()
    rd_n[::6] = 4
    tr_n[::9] = 4
    pairs += [(rd[:0], tr), (rd, tr[:0]),
              (np.concatenate([rd, rng.integers(0, 4, 400)]).astype(np.int8),
               tr), (rd_n, tr_n), (tr.copy(), tr)]
    lcs = acc._lcs(pairs, dev)
    return pairs, edit_bands(pairs, lcs)[0]


def check_edit(rng, dev, hold):
    """The scoreboard's banded traceback kernels against their plain version
    (CPU tensors) on ``edit_inputs`` (bitwise); the plain version runs
    once, on the host, and that run is its time (``plain_ms``). The same
    pairs and the kernel's result go to ``hold`` (an ``EditHold``), which
    holds them against the host numpy ``edit_alignment`` once phase 2's
    kernel times are taken."""
    from proovread_tpu_torch.obs import accuracy as acc
    pairs, bands = edit_inputs(rng, dev)
    args = acc.pack_pairs(pairs, dev)
    got = acc.edit_alignments(*args, bands)
    hold.start("phase2", [(pairs, bands, [
        dict(zip(("dist", "matches", "sub", "ins", "del"), r))
        for r in got.cpu().tolist()])], plain=False)
    t0 = time.monotonic()
    want = acc.edit_alignments_plain(*acc.pack_pairs(pairs, "cpu"), bands)
    plain_ms = (time.monotonic() - t0) * 1e3
    assert_equal("edit_alignments", [(got.cpu(), want)])
    if int(want[0, 0]) < 1000 or int(want[:, 3].sum()) == 0:
        raise AssertionError(f"edit: weak inputs ({want[0].tolist()})")
    tm = launcher_times(lambda: acc.edit_alignments(*args, bands),
                        KERNEL_NAMES["edit"])
    # each input byte once, the bands and the five outputs a pair; the
    # recurrence counts obs/profile.py's EDIT_OPS_A_CELL INT32 operations
    # a cell (the match compare, the diagonal add, the up add, their
    # minimum, the left add, the minimum with it, the clamp to _BIG and
    # the two decisions), whatever implements it; the walk's steps are
    # not counted. A throughput figure: the floor is the longest chain
    from proovread_tpu_torch.obs.profile import edit_counts
    ch = edit_chain(pairs, bands)
    la, lb, plan = ch["la"], ch["lb"], ch["plan"]
    width = lb - la + 2 * np.asarray(bands) + 1
    cells = int((la * width).sum())
    n_ops, n_bytes = edit_counts(sum(len(a) + len(b) for a, b in pairs),
                                 len(pairs), cells)
    b_ms, b_by = bound(n_bytes, n_ops, PEAK_INT32_OPS_PER_S)
    # the DP's chain: the longest pair's loose lower bound (edit_chain);
    # in this log line only, as it is counted, not measured
    live = la > 0
    k = int(np.argmax(ch["clocks"]))
    by_name = tm["kernel_ms_by_name"] or {}
    return dict(max_abs_err=max_abs_err([(got.cpu().float(),
                                          want.float())]),
                **tm, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, cells=cells,
                dp_kernel_ms=by_name.get("edit_dp_kernel"),
                walk_kernel_ms=by_name.get("edit_walk_kernel"),
                chain_floor_ms=float(ch["clocks"][k]) / max_sm_clock_hz()
                * 1e3,
                longest_chain_columns=int(lb[live].max()),
                floor_pair_columns=int(lb[k]),
                floor_pair_words_a_lane=int(ch["words"][k]),
                words_a_lane={str(x): int(c) for x, c in zip(
                    *np.unique(plan["W"][live], return_counts=True))},
                widest_window_words=int(plan["S"].max()),
                state_bytes=int(16 * plan["rec"].sum()),
                widest_row_cells=int(width.max()),
                shape=f"P={len(pairs)} bases={n_bytes}")


def scatter_bound(idx, keep, n_cells):
    """The ordered scatter's bound: what the function ``target[idx[k]] +=
    w[k]`` must move, ``keep`` read once (a byte an entry), each kept
    entry's index (8) and weight (4) once, each touched cell read and
    written once (4 + 4), over the card's memory rate (the kernel's sort
    permutation is its design's, not the function's). Returns (bound ms,
    by, kept, touched)."""
    import torch
    from proovread_tpu_torch.obs.profile import scatter_counts
    live = keep & (idx >= 0) & (idx < n_cells)
    kept = int(live.sum())
    touched = int(torch.unique(idx[live]).numel())
    b_ms, b_by = bound_of(scatter_counts(idx.numel(), kept, touched))
    return b_ms, b_by, kept, touched


def hold_scatter(label, target, idx, w, keep):
    """The scatter kernel (public wrapper) against its plain version on the
    same card inputs, twice, and against ``index_add_`` of the kept entries
    in index order on CPU copies: bitwise. Returns the largest |kernel -
    plain| over both runs."""
    import torch
    from proovread_tpu_torch.ops import scatter as sc
    got = sc.scatter_add_ordered(target.clone(), idx, w, keep)
    again = sc.scatter_add_ordered(target.clone(), idx, w, keep)
    want = sc.scatter_add_ordered_plain(target.clone(), idx, w, keep)
    torch.cuda.synchronize()
    assert_equal(f"scatter {label}", [(got, want), (again, want)])
    live = (keep & (idx >= 0) & (idx < target.numel())).cpu()
    cpu = target.cpu().index_add_(0, idx.cpu()[live], w.cpu()[live])
    if not torch.equal(cpu, got.cpu()):
        raise AssertionError(f"scatter {label}: differs from the CPU's "
                             "index_add_")
    return max_abs_err([(got, want), (again, want)])


def segment_lengths(idx, keep, n_cells) -> dict:
    """Kept entries a touched cell (the sorted segments the kernel folds):
    mean, median, 99th percentile and longest."""
    import torch
    live = keep & (idx >= 0) & (idx < n_cells)
    seg = torch.unique(idx[live], return_counts=True)[1].double()
    if seg.numel() == 0:
        return dict(mean=0.0, median=0.0, p99=0.0, longest=0)
    return dict(mean=float(seg.mean()), median=float(seg.median()),
                p99=float(torch.quantile(seg, 0.99)),
                longest=int(seg.max()))


def scatter_times(target, idx, w, keep):
    """Launcher, kernel, plain and ``index_add_`` times of one scatter
    (``index_add_`` adds the same weights, zero where not kept, with
    atomics in no order: the same function but for the order), its bound,
    the public call's stable sort of the int32 keys alone (``sort_ms``)
    and the segment lengths."""
    import torch
    from proovread_tpu_torch.ops import scatter as sc
    tm = launcher_times(
        lambda: sc.scatter_add_ordered(target.clone(), idx, w, keep),
        KERNEL_NAMES["scatter"])
    plain_ms = time_ms(lambda: sc.scatter_add_ordered_plain(
        target.clone(), idx, w, keep), reps=3, warmup=1)
    wz = w.masked_fill(~keep, 0.0).reshape(-1)
    flat_idx = idx.reshape(-1)
    lib_ms = time_ms(lambda: target.clone().index_add_(0, flat_idx, wz))
    clone_ms = time_ms(lambda: target.clone())
    b_ms, b_by, kept, touched = scatter_bound(idx, keep, target.numel())
    n = target.numel()
    live = keep.reshape(-1) & (flat_idx >= 0) & (flat_idx < n)
    key = torch.where(live, flat_idx.to(torch.int32), n)
    sort_ms = time_ms(lambda: torch.sort(key, stable=True))
    return dict(tm, ms=tm["ms"] - clone_ms, plain_ms=plain_ms - clone_ms,
                library_ms=lib_ms - clone_ms, clone_ms=clone_ms,
                bound_ms=b_ms, bound_by=b_by, entries=idx.numel(),
                kept=kept, touched=touched, sort_ms=sort_ms,
                segments=segment_lengths(idx, keep, n))


def scatter_inputs(rng, dev, B=256, L=24576, M=16 << 20, hot_cells=None):
    """Random fractional weights with heavy duplication: M entries onto a
    B x L x 6 pileup's counts, 9 in 10 onto a set of hot cells (~100
    entries each), 1 in 10 onto 1% of those (segments of a few hundred),
    the rest anywhere; 7 in 10 kept; a non-zero target. With
    ``hot_cells``, 19 in 20 entries go to that many cells instead
    (segments of thousands). Returns (target, idx, w, keep, hot)."""
    import torch
    N = B * L * 6
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    hot = torch.randint(0, N, (hot_cells or M // 100,), device=dev,
                        generator=g)
    u = torch.rand(M, device=dev, generator=g)
    pick = torch.randint(0, hot.numel(), (M,), device=dev, generator=g)
    if hot_cells is None:
        pick = torch.where(u < 0.1, pick % max(1, hot.numel() // 100), pick)
    idx = torch.where(u < 0.95, hot[pick],
                      torch.randint(0, N, (M,), device=dev, generator=g))
    w = (torch.rand(M, device=dev, generator=g)
         * torch.where(u < 0.5, 0.83, 37.0)).to(torch.float32)
    keep = torch.rand(M, device=dev, generator=g) < 0.7
    target = torch.rand(N, device=dev, generator=g) * 3
    return target, idx, w, keep, hot


def check_scatter(rng, dev, B=256, L=24576, M=16 << 20, hot_cells=None):
    """The ordered scatter-add on ``scatter_inputs``. Returns the row's
    numbers."""
    import torch
    target, idx, w, keep, hot = scatter_inputs(rng, dev, B, L, M, hot_cells)
    err = hold_scatter("random" if hot_cells is None else "long segments",
                       target, idx, w, keep)
    seg = torch.bincount(idx[keep], minlength=target.numel())
    r = scatter_times(target, idx, w, keep)
    return dict(r, max_abs_err=err, shape=f"M={M} N={target.numel()} "
                f"({B}x{L}x6)", shortest_hot_segment=int(seg[hot].min()))


# the four scatters of an accumulate, in its order
SCATTER_NAMES = ("counts", "ins_mbase", "ins_len_votes", "ins_base_votes")


def ccs_chunk_scatters(dev):
    """The four scatters of one real ``ccs-1`` chunk on the card: phase
    11's subread simulation at 400 kb of molecules (about 1 Mb of
    subreads, more than one chunk of 4096 candidates) through
    ``ccs_correct``, its first ``fused_accumulate`` call's inputs captured
    (the targets as they were before it). Returns [(name, target, idx, w,
    keep)]."""
    from proovread_tpu_torch.ops import fused
    from proovread_tpu_torch.pipeline import ccs
    recs, _, _ = subread_workload(400_000, 400_000, seed=5)
    seen, orig = [], fused.scatter_add_ordered

    def capture(target, idx, w, keep):
        if len(seen) < 4:
            seen.append((target.clone(), idx, w, keep))
        return orig(target, idx, w, keep)
    fused.scatter_add_ordered = capture
    try:
        ccs.ccs_correct(recs, device="cuda")
    finally:
        fused.scatter_add_ordered = orig
    return [(n,) + c for n, c in zip(SCATTER_NAMES, seen)]


class _Captured(Exception):
    """Stops a run once the calls it was started for have been captured."""


def utg_chunk_inputs(dev, genome_size=1_250_000, long_bases=1_000_000):
    """The first full ``sw_batch`` chunk and the first ``accumulate``
    call's four scatters of a real ``utg`` run on the card: phase 12's
    genome and unitigs (``unitig_workload``, 512-base windows at m = 512,
    n = 640), ``long_bases`` of its CLR reads (one batch of 128 long
    reads), through ``utg_correct`` until the consensus engine's first
    ``accumulate`` (after the mapper's chunks of 2048 candidates); the run
    stops there. Returns ((q, r, qlen, params), [(name, target, idx, w,
    keep)]), the targets as they were before the scatter."""
    from proovread_tpu_torch.align import mapper
    from proovread_tpu_torch.config import Config
    from proovread_tpu_torch.io.simulate import (random_genome,
                                                 simulate_long_reads)
    from proovread_tpu_torch.ops import pileup
    from proovread_tpu_torch.pipeline import utg
    genome = random_genome(genome_size, seed=0)
    longs, _ = simulate_long_reads(genome, long_bases, seed=1)
    utgs = unitig_workload(genome_size)
    chunks, scatters = [], []
    orig_sw, orig_add = mapper.sw_batch, pileup.scatter_add_ordered
    chunk = mapper.TorchMapper().chunk_rows

    def capture_sw(q, r, qlen, params):
        if q.shape[0] == chunk and not chunks:
            chunks.append((q.clone(), r.clone(), qlen.clone(), params))
        return orig_sw(q, r, qlen, params)

    def capture_add(target, idx, w, keep):
        scatters.append((target.clone(), idx.clone(), w.clone(),
                         keep.clone()))
        orig_add(target, idx, w, keep)
        if len(scatters) == 4:
            raise _Captured
        return target
    mapper.sw_batch, pileup.scatter_add_ordered = capture_sw, capture_add
    try:
        utg.utg_correct(Config(), longs, utgs, device=str(dev))
    except _Captured:
        pass
    finally:
        mapper.sw_batch, pileup.scatter_add_ordered = orig_sw, orig_add
    if not chunks or len(scatters) < 4:
        raise AssertionError("utg chunk: no sw_batch call of a whole chunk "
                             "or no accumulate")
    return chunks[0], [(n,) + c for n, c in zip(SCATTER_NAMES, scatters)]


def check_chunk_scatters(label, scatters):
    """The scatter kernel on the real layout of one chunk's ``accumulate``
    (ccs or utg): each of the four scatters held (``hold_scatter``), with
    its segment lengths; the times of the largest (``counts``) are the
    row's."""
    out, err = {}, 0.0
    for name, target, idx, w, keep in scatters:
        err = max(err, hold_scatter(f"{label} {name}", target, idx, w, keep))
        b_ms, _, kept, touched = scatter_bound(idx, keep, target.numel())
        out[name] = dict(entries=idx.numel(), kept=kept, touched=touched,
                         bound_ms=b_ms, segments=segment_lengths(
                             idx, keep, target.numel()))
    name, target, idx, w, keep = scatters[0]
    r = scatter_times(target, idx, w, keep)
    return dict(r, max_abs_err=err, shape=f"{label} {name}: "
                f"{tuple(idx.shape)} entries onto {target.numel()} cells",
                scatters=out)


# --------------------------------------------------------------------------
# phases 3-6: the pipeline and the qual-weighted pass
# --------------------------------------------------------------------------

def workload(genome_size, long_bases, n_iterations, sr_coverage=30.0,
             sr_len=100):
    from proovread_tpu_torch.io.simulate import (random_genome,
                                                 simulate_long_reads,
                                                 simulate_short_reads)
    genome = random_genome(genome_size, seed=0)
    longs, truths = simulate_long_reads(genome, long_bases, seed=1)
    srs = simulate_short_reads(genome, sr_coverage, read_len=sr_len, seed=2)
    return longs, srs, n_iterations, truths


def _molecules(rng, genome, total_bases, mean_len=7000, min_len=500):
    """(start, length) of reads drawn as ``simulate_long_reads`` draws
    them: log-normal lengths around ``mean_len``, uniform starts."""
    G = len(genome)
    out, tot = [], 0
    while tot < total_bases:
        ln = int(np.clip(rng.lognormal(np.log(mean_len), 0.55), min_len,
                         G - 1))
        out.append((int(rng.integers(0, G - ln)), ln))
        tot += ln
    return out


def subread_workload(genome_size, molecule_bases, seed=3):
    """PacBio CLR subreads: molecules of ``random_genome(genome_size)``
    (phase 4's genome at 1.25 Mb) drawn as ``simulate_long_reads`` draws
    reads, ~``molecule_bases`` in all; one ZMW a molecule, one subread in
    1 of 5 ZMWs and 2-4 of alternating strand in the rest, each an
    independent CLR error draw (sub 0.02, ins 0.08, del 0.05, phred 10),
    ids ``m<movie>/<hole>/<start>_<end>``. Returns (subreads, truths, the
    ZMW of each subread): a truth is the molecule oriented as its
    subread."""
    from proovread_tpu_torch.io.records import SeqRecord
    from proovread_tpu_torch.io.simulate import _apply_errors, random_genome
    from proovread_tpu_torch.ops.encode import decode_codes, revcomp_codes
    genome = random_genome(genome_size, seed=0)
    rng = np.random.default_rng(seed)
    recs, truths, zmw = [], [], []
    for hole, (st, ln) in enumerate(_molecules(rng, genome, molecule_bases)):
        mol = genome[st:st + ln]
        n_sub = 1 if rng.random() < 0.2 else int(rng.integers(2, 5))
        flip0, pos = int(rng.integers(0, 2)), 0
        for k in range(n_sub):
            src = mol if (k + flip0) % 2 == 0 else revcomp_codes(mol)
            mut = _apply_errors(src, rng, 0.02, 0.08, 0.05)
            recs.append(SeqRecord(
                f"m150101_120000_42137_c1/{hole + 10}/{pos}_{pos + len(mut)}",
                decode_codes(mut), qual=np.full(len(mut), 10, np.uint8)))
            truths.append(src)
            zmw.append(hole)
            pos += len(mut) + 45
    return recs, truths, zmw


def unitig_workload(genome_size, frag=(15_000, 30_000), seed=4):
    """Assembly unitigs of ``random_genome(genome_size)``: fragments of
    ``frag`` bases that tile the genome at about 1.2x (each next one starts
    a sixth of a fragment before the last one ends, at least 1 kb), 0.1%
    substitutions, either orientation, no qualities (FASTA)."""
    from proovread_tpu_torch.io.records import SeqRecord
    from proovread_tpu_torch.io.simulate import random_genome
    from proovread_tpu_torch.ops.encode import decode_codes, revcomp_codes
    genome = random_genome(genome_size, seed=0)
    rng = np.random.default_rng(seed)
    G, st, out = len(genome), 0, []
    while True:
        ln = int(rng.integers(frag[0], frag[1] + 1))
        end = min(st + ln, G)
        f = genome[st:end].copy()
        sub = rng.random(len(f)) < 0.001
        f[sub] = (f[sub] + 1 + rng.integers(0, 3, int(sub.sum()))) % 4
        if rng.random() < 0.5:
            f = revcomp_codes(f)
        out.append(SeqRecord(f"utg{len(out)}", decode_codes(f)))
        if end == G:
            return out
        st = end - max(1000, ln // 6)


def haplotype_workload(genome_size, long_bases, seed=6):
    """A heterozygous genome: haplotype B ``random_genome(genome_size)``,
    haplotype A B with a SNP every 200 bases; CLR reads (as
    ``simulate_long_reads`` draws them) of ``long_bases``, half from each
    haplotype; 100 bp short reads, 8x of A and 30x of B. Returns (long
    reads, short reads, truths (each read's own haplotype, oriented as
    the read), per read (haplotype, start, length, reversed), A, B)."""
    from proovread_tpu_torch.io.records import SeqRecord
    from proovread_tpu_torch.io.simulate import (_apply_errors,
                                                 random_genome,
                                                 simulate_short_reads)
    from proovread_tpu_torch.ops.encode import decode_codes, revcomp_codes
    hap_b = random_genome(genome_size, seed=0)
    hap_a = hap_b.copy()
    rng = np.random.default_rng(seed)
    snps = np.arange(100, genome_size, 200)
    hap_a[snps] = (hap_a[snps] + 1 + rng.integers(0, 3, len(snps))) % 4
    longs, truths, meta = [], [], []
    for name, hap in (("A", hap_a), ("B", hap_b)):
        for i, (st, ln) in enumerate(_molecules(rng, hap, long_bases // 2)):
            src = hap[st:st + ln]
            mut = _apply_errors(src, rng, 0.02, 0.08, 0.05)
            rev = bool(rng.random() < 0.5)
            if rev:
                mut, src = revcomp_codes(mut), revcomp_codes(src)
            longs.append(SeqRecord(f"hap{name}_{i}", decode_codes(mut),
                                   qual=np.full(len(mut), 10, np.uint8)))
            truths.append(src)
            meta.append((name, st, ln, rev))
    srs = (simulate_short_reads(hap_a, 8.0, seed=7, id_prefix="srA")
           + simulate_short_reads(hap_b, 30.0, seed=8, id_prefix="srB"))
    return longs, srs, truths, meta, hap_a, hap_b


def snp_share(untrimmed, meta, longs, hap_a, hap_b, flank=8, slack=60):
    """Haplotype-A reads whose SNP columns keep A's base: each SNP 30+
    bases inside an A read is looked for in the corrected read (turned to
    the genome's strand) as A's and as B's 17-mer around it, within
    ``slack`` of where it should be. Returns (share of A reads with a
    found SNP that show more A 17-mers than B ones, share of found SNP
    columns that show A's, A reads with a found SNP)."""
    from proovread_tpu_torch.ops.encode import decode_codes
    comp = str.maketrans("ACGT", "TGCA")
    snps = np.flatnonzero(hap_a != hap_b)
    by_id = {r.id: r.seq for r in untrimmed}
    keep = n_reads = a_cols = b_cols = 0
    for rec, (name, st, ln, rev) in zip(longs, meta):
        if name != "A" or rec.id not in by_id:
            continue
        cor = by_id[rec.id]
        if rev:
            cor = cor.translate(comp)[::-1]
        a_n = b_n = 0
        for p in snps[(snps >= st + 30) & (snps < st + ln - 30)]:
            o = int(p - st)
            seg = cor[max(0, o - slack):o + slack]
            wa = decode_codes(hap_a[p - flank:p + flank + 1])
            wb = decode_codes(hap_b[p - flank:p + flank + 1])
            if wa in seg:
                a_n += 1
            elif wb in seg:
                b_n += 1
        if a_n + b_n:
            n_reads += 1
            keep += a_n > b_n
            a_cols, b_cols = a_cols + a_n, b_cols + b_n
    return (keep / max(n_reads, 1), a_cols / max(a_cols + b_cols, 1),
            n_reads)


def run_pipeline(longs, srs, n_iterations, device, **kw):
    import torch
    from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
    cfg = PipelineConfig(mode="sr", n_iterations=n_iterations, device=device,
                         **kw)
    t0 = time.monotonic()
    res = Pipeline(cfg).run(longs, srs)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, time.monotonic() - t0


def first_bucket(longs, srs, full=False, coverage=None, qual_weighted=True,
                 **cfg_kw):
    """The first length bucket of a workload (with ``full``, the first that
    fills the driver's ``batch_reads`` rows), packed as
    ``Pipeline._run_batch_device`` packs it, with the driver's iteration
    and finish ConsensusParams (qual-weighted unless told otherwise), the
    HCR mask parameters per iteration and the packed short reads."""
    import dataclasses
    from proovread_tpu_torch.io.batch import pack_reads
    from proovread_tpu_torch.io.records import SeqRecord
    from proovread_tpu_torch.pipeline import driver as drv
    cfg = drv.PipelineConfig(**cfg_kw)
    min_sr_len = int(np.median([len(r) for r in srs]))
    kept, _ = drv.Pipeline(cfg).read_long(longs, min_sr_len)
    buckets = drv._bucket_records(kept, cfg.batch_reads)
    if full:
        buckets = [b for b in buckets
                   if len(b[1]) == cfg.batch_reads] or buckets
    pad, recs = buckets[0]
    Lp = drv.bucket_lp(pad, cfg.length_slack)
    rows = drv.batch_rows(len(recs), cfg.batch_reads)
    pads = [SeqRecord(f"_pad{i}", "A" * 8) for i in range(rows - len(recs))]
    lr = pack_reads(list(recs) + pads, pad_len=Lp)
    if coverage is None:
        coverage = sum(len(r) for r in srs) / sum(len(r) for r in kept)
    cns_it = dataclasses.replace(drv.iteration_consensus_params(cfg, coverage),
                                 qual_weighted=qual_weighted)
    cns_fin = dataclasses.replace(drv.finish_consensus_params(cfg, coverage),
                                  qual_weighted=qual_weighted)
    masks = [(cfg.hcr_mask if it < 4 else cfg.hcr_mask_late).scaled(
        min_sr_len) for it in range(1, cfg.n_iterations + 1)]
    return lr, pack_reads(srs, pad_multiple=16), cns_it, cns_fin, masks


def qual_chain(bucket, device, n_rest, finish, CH=8192):
    """The qual-weighted DeviceCorrector chain on one bucket: pass 1
    (``correct_pass``), ``n_rest`` fused passes against the whole resident
    short-read set (no shortcut), then, with ``finish``, a finish pass that
    collects its alignments. Returns (host copies of every output, per-pass
    stats)."""
    import torch
    from proovread_tpu_torch.align.bsw import band_lanes
    from proovread_tpu_torch.align.params import BWA_SR, BWA_SR_FINISH
    from proovread_tpu_torch.ops.assemble_kernel import mask_params_vec
    from proovread_tpu_torch.pipeline import dcorrect as dc
    from proovread_tpu_torch.pipeline.driver import _SrDevice
    lr, sr, cns_it, cns_fin, masks = bucket
    dev = torch.device(device)
    codes, qual, lengths = (torch.as_tensor(a, device=dev)
                            for a in (lr.codes, lr.qual, lr.lengths))
    Lp = codes.shape[1]
    srd = _SrDevice(sr, dev)
    corr = dc.DeviceCorrector(chunk=CH)
    host = {}
    stats = []

    def keep(prefix, tensors):
        for k, v in tensors.items():
            host[f"{prefix}.{k}"] = v.cpu().numpy()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.monotonic()
    call, st = corr.correct_pass(codes, qual, lengths, None, *srd.full(),
                                 BWA_SR, cns_it)
    sync()
    stats.append(dict(pass_="1", candidates=st.n_candidates,
                      admitted=int(st.n_admitted),
                      eligible=int(st.n_eligible),
                      seconds=time.monotonic() - t0))
    keep("pass1", call._asdict())
    codes, qual, lengths = dc.device_assemble(call, lengths, Lp)
    mask, frac = dc.device_hcr_mask(qual, lengths, masks[0])
    n_chunks = dc._bucket_chunks(max(1, -(-int(st.n_candidates * 1.5) // CH)))
    pvs = np.stack([mask_params_vec(masks[1 + k]).numpy()
                    for k in range(n_rest)])
    t0 = time.monotonic()
    fr = dc.fused_iterations(
        codes, qual, lengths, mask, float(frac), *srd.full(), None, pvs,
        m=srd.width,
        W=band_lanes(BWA_SR), CH=CH, n_chunks=n_chunks, ap=BWA_SR,
        cns=cns_it, n_rest=n_rest, Lp=Lp, seed_stride=8, seed_min_votes=2,
        shortcut_frac=2.0, min_gain=-1.0)
    sync()
    dt = time.monotonic() - t0
    for k in range(len(fr.fracs)):
        stats.append(dict(pass_=str(2 + k), candidates=fr.ncands[k],
                          admitted=fr.nadms[k], eligible=fr.neligs[k],
                          dropped_cap=fr.ndrops[k], masked=fr.fracs[k],
                          seconds=dt / len(fr.fracs)))
    keep("fused", dict(codes=fr.codes, qual=fr.qual, lengths=fr.lengths,
                       mask=fr.mask_cols))
    if finish:
        t0 = time.monotonic()
        call, st, aln = corr.correct_pass(
            fr.codes, fr.qual, fr.lengths, None, *srd.full(), BWA_SR_FINISH,
            cns_fin, collect_aln=True)
        sync()
        stats.append(dict(pass_="finish", candidates=st.n_candidates,
                          admitted=int(st.n_admitted),
                          eligible=int(st.n_eligible),
                          seconds=time.monotonic() - t0))
        keep("finish", call._asdict())
        for f in ("lread", "pos0", "span", "admitted", "vote_ok", "q_start",
                  "q_end", "win_start", "r_start", "r_end", "sread",
                  "strand", "score"):
            host[f"aln.{f}"] = np.asarray(getattr(aln, f))
        use = np.flatnonzero(aln.admitted & aln.vote_ok)
        aln.prefetch(use)
        for j, name in enumerate(("state", "qrow", "ins_len")):
            host[f"aln.{name}"] = np.stack([aln._rows[int(c)][j]
                                            for c in use])
    return host, stats


def column_votes(bucket, device, CH=8192):
    """Largest winning vote count and column coverage of one unweighted
    pass 1 over a bucket (how many votes its columns really collect)."""
    import torch
    from proovread_tpu_torch.align.params import BWA_SR
    from proovread_tpu_torch.pipeline import dcorrect as dc
    from proovread_tpu_torch.pipeline.driver import _SrDevice
    lr, sr, cns_it, _, _ = bucket
    dev = torch.device(device)
    codes, qual, lengths = (torch.as_tensor(a, device=dev)
                            for a in (lr.codes, lr.qual, lr.lengths))
    srd = _SrDevice(sr, dev)
    call, st = dc.DeviceCorrector(chunk=CH).correct_pass(
        codes, qual, lengths, None, *srd.full(), BWA_SR, cns_it)
    return (float(call.freq.max()), float(call.coverage.max()),
            int((call.freq > 256).sum()), st.n_candidates)


# --------------------------------------------------------------------------
# phases 3, 7 and 8: the command line
# --------------------------------------------------------------------------

CLI_OUTPUTS = ("untrimmed.fq", "trimmed.fq", "trimmed.fa", "ignored.tsv",
               "chim.tsv")


def write_inputs(tmp, label, longs, srs):
    """The workload as the FASTQ files a user hands the command line."""
    from proovread_tpu_torch.io.fastq import FastqWriter
    paths = []
    for kind, recs in (("long", longs), ("short", srs)):
        path = os.path.join(tmp, f"{label}.{kind}.fq")
        with open(path, "wb") as fh:
            w = FastqWriter(fh)
            for r in recs:
                w.write(r)
        paths.append(path)
    return paths


def input_args(tmp, label, longs, srs, utgs=None):
    """``-l``, ``-s`` (when there are short reads) and ``-u`` (unitigs as
    FASTA) arguments for the workload's files."""
    from proovread_tpu_torch.io.fasta import FastaWriter
    lp, sp = write_inputs(tmp, label, longs, srs)
    argv = ["-l", lp] + (["-s", sp] if srs else [])
    if utgs:
        up = os.path.join(tmp, f"{label}.utg.fa")
        with open(up, "wb") as fh:
            w = FastaWriter(fh)
            for r in utgs:
                w.write(r)
        argv += ["-u", up]
    return argv


def cli_outputs(out):
    """The five read and table files' bytes and parameter.log without its
    argv (which names the device and the output directory) and, after
    ``--debug``, its config's ``debug-dir`` (the output directory)."""
    files = {}
    for suf in CLI_OUTPUTS:
        with open(os.path.join(out, f"res.{suf}"), "rb") as fh:
            files[suf] = fh.read()
    with open(os.path.join(out, "res.parameter.log")) as fh:
        plog = json.load(fh)
    plog.pop("argv")
    plog["config"].pop("debug-dir", None)
    return files, plog


def extra_outputs(out) -> dict:
    """The files of an output directory besides the five and
    parameter.log: ``--debug``'s ``res.debug.tsv`` and ``admitted.*.sam``
    dumps."""
    std = {f"res.{suf}" for suf in CLI_OUTPUTS + ("parameter.log",)}
    files = {}
    for name in sorted(os.listdir(out)):
        if name not in std:
            with open(os.path.join(out, name), "rb") as fh:
                files[name] = fh.read()
    return files


class CallTimer:
    """Wall seconds spent in named functions during a run: each target
    (module or class, attribute, key, synchronise the card after it) is
    replaced by a timed wrapper until exit. Nested targets count inside
    their callers too."""

    def __init__(self, targets):
        self.targets, self.t, self.n = targets, {}, {}

    def __enter__(self):
        import torch
        self.saved = []
        for obj, name, key, sync in self.targets:
            fn = getattr(obj, name)
            self.saved.append((obj, name, fn))
            self.t[key], self.n[key] = 0.0, 0

            def timed(*a, _fn=fn, _key=key, _sync=sync, **k):
                t0 = time.monotonic()
                out = _fn(*a, **k)
                if _sync:
                    torch.cuda.synchronize()
                self.t[_key] += time.monotonic() - t0
                self.n[_key] += 1
                return out
            setattr(obj, name, timed)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self.saved):
            setattr(obj, name, fn)


class SiamaeraProbe(CallTimer):
    """Times siamaera's parts inside a command-line run: the whole filter,
    its host seeding (``align/seed.py``: index and candidates) and its
    Smith-Waterman calls (synchronised), and counts its candidates and
    keeps its SiamaeraStats."""

    def __init__(self):
        from proovread_tpu_torch.align import mapper, seed
        from proovread_tpu_torch.pipeline import siamaera
        super().__init__([(siamaera, "siamaera_filter", "siamaera", False),
                          (seed, "build_index", "seed", False),
                          (seed, "find_candidates", "seed", False),
                          (mapper, "sw_batch", "sw", True)])
        self.mods = (siamaera, mapper.TorchMapper)
        self.candidates, self.stats = 0, None

    def __enter__(self):
        super().__enter__()
        siamaera, mapper_cls = self.mods
        filt, mb = siamaera.siamaera_filter, mapper_cls.map_batch

        def filter_(*a, **k):
            out = filt(*a, **k)
            self.stats = out[1]
            return out

        def map_batch(self_, *a, **k):
            res = mb(self_, *a, **k)
            self.candidates += res.n_candidates
            return res
        self.saved += [(siamaera, "siamaera_filter", filt),
                       (mapper_cls, "map_batch", mb)]
        siamaera.siamaera_filter = filter_
        mapper_cls.map_batch = map_batch
        return self

    @property
    def calls(self) -> int:
        return self.n["siamaera"]


# seconds the garbage collector has run while a KernelTimer was entered,
# and the start of the collection under way
_GC = [0.0, None]


def _gc_clock(phase, info) -> None:
    if phase == "start":
        _GC[1] = time.perf_counter()
    elif _GC[1] is not None:
        _GC[0] += time.perf_counter() - _GC[1]
        _GC[1] = None


class KernelTimer:
    """CUDA events around every call of one C entry point of the kernel
    library: the device time of its launches, with nothing else on the
    stream between the two events; and the host time of each call, and
    how much of it the garbage collector took."""

    def __init__(self, entry):
        self.entry, self.events, self.host_ms, self.gc_ms = entry, [], [], []

    def __enter__(self):
        import torch
        from proovread_tpu_torch import kernels
        self.lib = kernels.lib()
        self.orig = orig = getattr(self.lib, self.entry)
        # one clock for nested timers: the first entered installs it
        self.own_gc = _gc_clock not in gc.callbacks
        if self.own_gc:
            gc.callbacks.append(_gc_clock)

        def timed(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            g0, h0 = _GC[0], time.perf_counter()
            rc = orig(*a)
            self.host_ms.append((time.perf_counter() - h0) * 1e3)
            self.gc_ms.append((_GC[0] - g0) * 1e3)
            e1.record()
            self.events.append((e0, e1))
            return rc
        setattr(self.lib, self.entry, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.lib, self.entry, self.orig)
        if self.own_gc:
            gc.callbacks.remove(_gc_clock)

    def total_ms(self) -> float:
        import torch
        torch.cuda.synchronize()
        return float(sum(a.elapsed_time(b) for a, b in self.events))


def write_truth(tmp, label, longs, truths):
    """The workload's truth sidecar (``io/simulate.py``)."""
    from proovread_tpu_torch.io.simulate import write_truth_sidecar
    path = os.path.join(tmp, f"{label}.truth.jsonl")
    write_truth_sidecar(path, longs, truths)
    return path


def read_qc(path):
    """(meta line, per-read records) of a ``--qc-out`` file."""
    with open(path) as fh:
        lines = [json.loads(ln) for ln in fh if ln.strip()]
    return lines[0], lines[1:]


def recorded_accuracy(config):
    """The JAX package's recorded accuracy row of a bench config, read as
    data from ``ACCURACY_r10.json`` beside this script."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ACCURACY_r10.json")
    with open(path) as fh:
        rows = [json.loads(ln) for ln in fh if ln.strip()]
    return next(r for r in rows if r["config"] == config)


def acc_fields(acc) -> dict:
    """A QC aggregate's accuracy section as an ACCURACY row's scoring
    fields: the read counts, the mean identities and the summed error
    classes."""
    return dict(n_scored=acc["n_scored"], n_classified=acc["n_classified"],
                identity_before=acc["identity_before"]["mean"],
                identity_after=acc["identity_after"]["mean"],
                errors_before=acc["errors_before"],
                errors_after=acc["errors_after"],
                introduced=acc["introduced"], chimera=acc["chimera"])


def hold_accuracy(label, acc, row):
    """A QC aggregate's accuracy section against a recorded row: the
    scoring fields equal."""
    got = acc_fields(acc)
    want = {k: row[k] for k in got}
    if got != want:
        raise AssertionError(f"{label}: accuracy {got} is not the recorded "
                             f"{want}")
    return got


def cli_trace(tmp, label, longs, srs, truths):
    """``cli.main`` on the card with ``--trace``, ``--qc-out`` and
    ``--truth``: the span tree has its run, bucket, pass and
    score-accuracy spans, the root's children cover >= 95% of it, each
    bucket span carries its compile/execute split and sampled memory, and
    every QC record's ``bucket_span`` is a bucket span of the tree."""
    from proovread_tpu_torch import cli
    lp, sp = write_inputs(tmp, label, longs, srs)
    tp = write_truth(tmp, label, longs, truths)
    trace, qc = (os.path.join(tmp, f"{label}.{x}") for x in ("t", "qc"))
    rc = cli.main(["-l", lp, "-s", sp, "-p", os.path.join(tmp, label, "res"),
                   "--no-checkpoint", "-q", "--trace", trace, "--qc-out", qc,
                   "--truth", tp])
    if rc != 0:
        raise AssertionError(f"cli {label} --trace: exit {rc}")
    valid = validate_artifacts(label, trace=trace, qc=qc, truth=tp)
    with open(trace) as fh:
        events = [json.loads(ln) for ln in fh][1:]
    root = next(e for e in events if e["args"]["depth"] == 0)
    kids = sum(e["dur"] for e in events if e["args"]["depth"] == 1)
    names = {e["name"] for e in events}
    buckets = [e for e in events if e["cat"] == "bucket"]
    need = {"run", "bucket", "bwa-sr-1", "bwa-sr-finish", "score-accuracy"}
    _, records = read_qc(qc)
    ids = {e["args"]["span_id"] for e in buckets}
    bad = [r["id"] for r in records if r["bucket_span"] not in ids]
    if (root["name"] != "run" or kids < 0.95 * root["dur"]
            or not need <= names or bad or not buckets
            or not all({"compile_ms", "execute_ms", "live_bytes"}
                       <= set(e["args"]) for e in buckets)
            or not all(e["args"]["live_bytes"] > 0 for e in buckets)):
        raise AssertionError(f"cli {label} --trace: bad span tree (names "
                             f"{sorted(names)}, {len(bad)} records outside "
                             "it)")
    return dict(spans=len(events), buckets=len(buckets), valid=valid,
                root_s=root["dur"] / 1e6,
                covered=kids / max(root["dur"], 1e-9),
                peak_live_bytes=max(e["args"]["peak_live_bytes"]
                                    for e in buckets))


EDIT_SIDE = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
sys.exit(chip_smoke.edit_side(sys.argv[2], sys.argv[3]))
"""


def edit_side(path, part) -> int:
    """The background half of ``EditHold``: the pairs of ``path`` (an
    ``.npz``) through the host numpy ``edit_alignment`` (``part``
    "host") or ``edit_alignments_plain`` on CPU tensors ("plain"), held
    equal to the kernel's result; writes ``path.<part>.json``; 0 if they
    agree."""
    import torch
    from proovread_tpu_torch.obs import accuracy as acc
    torch.set_num_threads(1)
    z = np.load(path)
    rd, ro, tr, to, band, got = (
        z[k] for k in ("rd", "ro", "tr", "to", "band", "got"))
    pairs = [(rd[ro[i]:ro[i + 1]], tr[to[i]:to[i + 1]])
             for i in range(len(ro) - 1)]
    t0 = time.monotonic()
    if part == "host":
        res = [[acc.edit_alignment(a, b, band=int(w))[k] for k in
                ("dist", "matches", "sub", "ins", "del")]
               for (a, b), w in zip(pairs, band)]
    else:
        res = acc.edit_alignments_plain(*acc.pack_pairs(pairs, "cpu"),
                                        band).tolist()
    out = {"pairs": len(pairs), f"equal_{part}": res == got.tolist(),
           f"{part}_s": time.monotonic() - t0}
    with open(f"{path}.{part}.json", "w") as fh:
        json.dump(out, fh)
    return 0 if out[f"equal_{part}"] else 1


class EditHold:
    """Every pair a command-line run's scoreboard classified on the card
    (``accuracy._edit``: the kernel's call), held after the run against
    the host numpy ``edit_alignment`` and ``edit_alignments_plain``, each
    in a niced subprocess of one thread (``edit_side``); phase 2's pairs
    (``start``) wait for ``launch`` after phase 2's kernel times.
    ``check`` at the end of the script waits for them and fails on any
    difference."""

    def __init__(self):
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_edit_")
        self.queued, self.procs = [], {}

    @contextlib.contextmanager
    def probe(self, label):
        from proovread_tpu_torch.obs import accuracy
        orig, calls = accuracy._edit, []

        def recorded(pairs, bands, device):
            res = orig(pairs, bands, device)
            calls.append((pairs, bands, res))
            return res
        accuracy._edit = recorded
        try:
            yield
        finally:
            accuracy._edit = orig
        if calls:
            self.start(label, calls)
            self.launch()

    def start(self, label, calls, plain=True) -> None:
        """Keep ``calls`` (the kernel's pairs, bands and results) for
        ``launch``; ``plain``: also through the plain version."""
        pairs = [p for c in calls for p in c[0]]
        path = os.path.join(self.tmp, f"{label}.npz")
        off = lambda k: np.concatenate(  # noqa: E731
            [[0], np.cumsum([len(p[k]) for p in pairs])]).astype(np.int64)
        np.savez(path, rd=np.concatenate([p[0] for p in pairs]),
                 ro=off(0), tr=np.concatenate([p[1] for p in pairs]),
                 to=off(1), band=np.asarray([b for c in calls for b in c[1]],
                                            np.int64),
                 got=np.asarray([[r[k] for k in ("dist", "matches", "sub",
                                                 "ins", "del")]
                                 for c in calls for r in c[2]], np.int64))
        self.queued += [(label, path, "host")] + (
            [(label, path, "plain")] if plain else [])

    def launch(self) -> None:
        """Start a subprocess for every kept run and part."""
        here = os.path.dirname(os.path.abspath(__file__))
        for label, path, part in self.queued:
            err = open(f"{path}.{part}.err", "w")
            self.procs[label, part] = (subprocess.Popen(
                ["nice", "-n", "10", sys.executable, "-c", EDIT_SIDE, here,
                 path, part], cwd=here,
                env=dict(os.environ, OMP_NUM_THREADS="1"),
                stdout=subprocess.DEVNULL, stderr=err), path, err)
        self.queued = []

    def check(self) -> dict:
        """Wait for every run's hold; raise on a difference."""
        self.launch()
        out = {}
        t0 = time.monotonic()
        for (label, part), (proc, path, err) in self.procs.items():
            rc = proc.wait(timeout=900)
            err.close()
            res = f"{path}.{part}.json"
            if not os.path.exists(res):
                with open(err.name) as fh:
                    raise AssertionError(f"{label}: the edit hold ({part}) "
                                         "failed: " + fh.read()[-3000:])
            with open(res) as fh:
                out.setdefault(label, {}).update(json.load(fh))
            if rc != 0:
                raise AssertionError(f"{label}: the traceback kernel "
                                     f"differs: {out[label]}")
        log(f"edit hold: waited {time.monotonic() - t0:.1f} s; "
            + json.dumps(out))
        return out

    def close(self) -> None:
        for proc, _, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


class ScoreLog(logging.Handler):
    """The seconds of a command-line run's score-accuracy step, from the
    ``accuracy:`` line it logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.s = None

    def emit(self, record):
        if str(record.msg).startswith("accuracy: %d/%d"):
            self.s = record.args[-1]

    def __enter__(self):
        logging.getLogger("proovread_tpu_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("proovread_tpu_torch").removeHandler(self)


class TaskProbe:
    """One task function inside a command-line run (``obj.name``, e.g. the
    ``ccs-1`` or ``utg`` task): its wall seconds (synchronised), its
    return value, and, while it ran, the seconds of the run's
    ``CallTimer`` keys and the launches of its ``KernelTimer``s."""

    def __init__(self, obj, name, calls, timers):
        self.obj, self.name, self.calls, self.timers = (obj, name, calls,
                                                        timers)
        self.wall, self.out, self.s, self.marks = 0.0, None, {}, {}

    def __enter__(self):
        import torch
        self.fn = fn = getattr(self.obj, self.name)

        def counted(c):
            return dict(c.t, **({"candidates": c.candidates}
                                if hasattr(c, "candidates") else {}))

        def run(*a, **k):
            t_in = [counted(c) for c in self.calls]
            ev = {key: len(t.events) for key, t in self.timers.items()}
            t0 = time.monotonic()
            self.out = fn(*a, **k)
            torch.cuda.synchronize()
            self.wall += time.monotonic() - t0
            for c, before in zip(self.calls, t_in):
                for key, v in counted(c).items():
                    self.s[key] = v - before[key]
            self.marks = {key: (ev[key], len(t.events))
                          for key, t in self.timers.items()}
            return self.out
        setattr(self.obj, self.name, run)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.fn)

    def launches(self, key) -> int:
        a, b = self.marks[key]
        return b - a

    def device_ms(self, key) -> float:
        import torch
        torch.cuda.synchronize()
        a, b = self.marks[key]
        return float(sum(x.elapsed_time(y)
                         for x, y in self.timers[key].events[a:b]))

    def launch_ms(self, key) -> dict:
        """Each launch's device time (events) and the host time of its C
        call: their least, median and largest; and the garbage
        collector's ms inside the C calls, in all and in the call that
        took the host longest."""
        import torch
        torch.cuda.synchronize()
        a, b = self.marks[key]
        t = self.timers[key]
        dev = [x.elapsed_time(y) for x, y in t.events[a:b]]
        q = lambda v: dict(min=float(np.min(v)), median=float(  # noqa: E731
            np.median(v)), max=float(np.max(v))) if v else {}
        gc_ms = t.gc_ms[a:b]
        return dict(device=q(dev), host=q(t.host_ms[a:b]),
                    gc_ms=float(sum(gc_ms)), gc_ms_in_longest=float(
                        gc_ms[int(np.argmax(t.host_ms[a:b]))])
                    if gc_ms else 0.0)


def cli_run(tmp, label, longs, srs, want_mode, truths, utgs=None, extra=(),
            hold_identity=True, tasks=(), classify_cap=None,
            edit_hold=None):
    """``cli.main`` with its defaults (the checkpoint journal on) on the
    workload's files (``utgs``, unitigs, as ``-u``; ``extra`` arguments),
    scoring ``--truth`` into ``--qc-out`` and ``--metrics-out``, with
    siamaera's parts, bsw's, sw's, the scatter's and the LCS's device
    time, the journal's writes and the scoring measured, and each of
    ``tasks`` ((key, module, function name)) probed (``TaskProbe``), and
    with ``classify_cap`` the scoring's class breakdown on that many
    sampled reads instead of the scoreboard's 64 (identity is scored for
    every read either way), and with ``edit_hold`` (an ``EditHold``) every
    classified pair and the kernel's result held in the background; holds
    that every output read was scored, and (``hold_identity``) corrected
    to at least the identity floor and above its input, that nothing was
    demoted and that the journal is gone; returns what phases 7, 8 and
    11-13 log, the outputs (``cli_outputs``), the task probes and the QC
    records."""
    import contextlib
    import functools
    import torch
    from proovread_tpu_torch import cli
    from proovread_tpu_torch.align import sw
    from proovread_tpu_torch.consensus import engine
    from proovread_tpu_torch.obs import accuracy
    from proovread_tpu_torch.obs.accuracy import IDENTITY_FLOOR
    from proovread_tpu_torch.pipeline import correct
    t0 = time.monotonic()
    inputs = input_args(tmp, label, longs, srs, utgs)
    tp = write_truth(tmp, label, longs, truths)
    t_write = time.monotonic() - t0
    out = os.path.join(tmp, label, "res")
    qc, mpath = (os.path.join(tmp, f"{label}.{x}") for x in ("qc", "m"))
    torch.cuda.reset_peak_memory_stats()
    sw0 = sw.sw_batch.launches
    with contextlib.ExitStack() as stack:
        if classify_cap is not None:
            apply = accuracy.apply_to_qc
            stack.callback(setattr, accuracy, "apply_to_qc", apply)
            accuracy.apply_to_qc = functools.partial(
                apply, classify_cap=classify_cap)
        probe = stack.enter_context(SiamaeraProbe())
        score = stack.enter_context(ScoreLog())
        journal = stack.enter_context(JournalProbe())
        calls = stack.enter_context(CallTimer([
            (engine, "call_consensus", "consensus_call", True),
            (correct, "call_consensus", "consensus_call", True)]))
        timers = {key: stack.enter_context(KernelTimer(f"pt_{key}"))
                  for key in ("bsw_expand_v2", "sw_batch", "lcs_lengths",
                              "scatter_add_ordered", "edit_alignments")}
        bsw_t, sw_t, lcs_t, sc_t, edit_t = timers.values()
        if edit_hold is not None:
            stack.enter_context(edit_hold.probe(label))
        probes = {key: stack.enter_context(
            TaskProbe(obj, name, (probe, calls), timers))
            for key, obj, name in tasks}
        t0 = time.monotonic()
        rc = cli.main([*inputs, "-p", out, "--truth", tp, "--qc-out", qc,
                       "--metrics-out", mpath, *extra])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    if rc != 0:
        raise AssertionError(f"cli {label}: exit {rc}")
    validate_artifacts(label, metrics=mpath, qc=qc, truth=tp)
    files, plog = cli_outputs(out)
    if plog["mode"] != want_mode:
        raise AssertionError(f"cli {label}: mode {plog['mode']}, "
                             f"not {want_mode}")
    if probe.calls != 1 or probe.stats.checked == 0:
        raise AssertionError(f"cli {label}: siamaera did not run")
    if score.s is None:
        raise AssertionError(f"cli {label}: no accuracy line logged")
    meta, qc_recs = read_qc(qc)
    acc = meta["aggregate"]["accuracy"]
    n_out = files["untrimmed.fq"].count(b"\n") // 4
    before, after = acc["identity_before"]["mean"], acc["identity_after"][
        "mean"]
    if acc["n_scored"] != n_out or (hold_identity and not (
            IDENTITY_FLOOR <= after and after > before)):
        raise AssertionError(f"cli {label}: {acc['n_scored']} of {n_out} "
                             f"reads scored, identity {before} -> {after}")
    with open(mpath) as fh:
        metrics = json.load(fh)
    gauges = metrics["gauges"]
    if gauges["accuracy_reads_scored"]["series"][0]["value"] != n_out:
        raise AssertionError(f"cli {label}: accuracy gauges not published")
    no_demotion(f"cli {label}", metrics)
    n_buckets = gauges["n_buckets"]["series"][0]["value"]
    if journal.writes != n_buckets or os.path.exists(
            os.path.join(out, ".proovread_ckpt")):
        raise AssertionError(f"cli {label}: {journal.writes} journal "
                             f"writes for {n_buckets} buckets, or the "
                             "journal was left behind")
    bases = sum(len(r) for r in longs)
    n_bsw = len(bsw_t.events)
    # siamaera's own seeding, Smith-Waterman and candidates: the probes
    # also count the ccs-1 and utg tasks' (the same host seeder and
    # mapper), less a probe of the whole task run ("run"), which holds
    # siamaera itself
    inner = [pr for key, pr in probes.items() if key != "run"]
    seed_s = probe.t["seed"] - sum(pr.s.get("seed", 0.0) for pr in inner)
    return dict(
        mode=plog["mode"], wall_s=wall, write_inputs_s=t_write,
        score_accuracy_s=score.s, wall_unscored_s=wall - score.s,
        corrected_bases_per_s=bases / (wall - score.s),
        peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
        untrimmed_bytes=len(files["untrimmed.fq"]),
        trimmed_bytes=len(files["trimmed.fq"]),
        siamaera_s=probe.t["siamaera"], siamaera_seed_s=seed_s,
        siamaera_sw_s=probe.t["sw"] - sum(pr.s.get("sw", 0.0)
                                          for pr in inner),
        siamaera_candidates=probe.candidates - sum(
            pr.s.get("candidates", 0) for pr in inner),
        siamaera_stats=vars(probe.stats),
        sw_launches=sw.sw_batch.launches - sw0,
        sw_device_ms=sw_t.total_ms(), bsw_launches=n_bsw,
        bsw_device_ms=bsw_t.total_ms(),
        bsw_ms_per_launch=bsw_t.total_ms() / max(n_bsw, 1),
        n_out=n_out, n_scored=acc["n_scored"],
        n_classified=acc["n_classified"], identity_before=before,
        identity_after=after, errors_before=acc["errors_before"],
        errors_after=acc["errors_after"], introduced=acc["introduced"],
        lcs_launches=len(lcs_t.events), lcs_device_ms=lcs_t.total_ms(),
        edit_launches=len(edit_t.events), edit_device_ms=edit_t.total_ms(),
        journal_writes=journal.writes, journal_bytes=journal.bytes,
        journal_write_s=journal.s,
        journal_bytes_per_base=journal.bytes / bases,
        scatter_launches=len(sc_t.events),
        scatter_device_ms=sc_t.total_ms()), (
            files, without_journal_keys(plog)), (probes, qc_recs)


class JournalProbe:
    """Counts the checkpoint journal's bucket writes inside a run, with
    the bytes of the files written and the seconds the writes took."""

    def __enter__(self):
        from proovread_tpu_torch.pipeline import resilience
        self.cls, self.put = resilience.CheckpointJournal, \
            resilience.CheckpointJournal.put
        self.writes, self.bytes, self.s = 0, 0, 0.0
        probe, put = self, self.put

        def timed(j, key, *a, **k):
            t0 = time.monotonic()
            put(j, key, *a, **k)
            probe.s += time.monotonic() - t0
            probe.writes += 1
            probe.bytes += os.path.getsize(
                os.path.join(j.path, f"bucket_{key}.json"))
        self.cls.put = timed
        return self

    def __exit__(self, *exc):
        self.cls.put = self.put


def series(metrics, kind, name):
    """{labels: value} of one metric of a metrics dump."""
    return {tuple(sorted(s["labels"].items())): s["value"]
            for s in metrics[kind][name]["series"]}


def no_demotion(label, metrics, reports=()):
    """The ladder hid nothing: no demotion, no absorbed device fault, no
    demotion report in an unfaulted run."""
    dem = series(metrics, "counters", "resilience_demotions")
    faults = series(metrics, "counters", "device_faults")
    demote = [r.task for r in reports if r.task.startswith("demote-")]
    if dem or faults or demote:
        raise AssertionError(f"{label}: demoted in an unfaulted run: "
                             f"{dem} {faults} {demote}")


def ladder_check(longs, srs, n_it, device="cuda"):
    """The ladder on the card: ``compile@b0.p2;oom@b1`` walks both buckets
    (batch_reads 8) fused -> eager -> chunk-halved -> host-scan. Each
    faulted bucket's records, chimeras and pass reports equal the card's
    ``engine="scan"`` run on that bucket's reads alone (same coverage,
    sampling off, every pass run), and the demotion reports and counters
    are the reference's."""
    from proovread_tpu_torch.pipeline import driver as drv
    kw = dict(batch_reads=8, sampling=False, mask_shortcut_frac=2.0,
              mask_min_gain_frac=-1.0)
    cfg = drv.PipelineConfig(**kw)
    min_sr = int(np.median([len(r) for r in srs]))
    kept, _ = drv.Pipeline(cfg).read_long(longs, min_sr)
    groups = drv._bucket_records(kept, cfg.batch_reads)
    if len(groups) != 2:
        raise AssertionError(f"ladder: {len(groups)} buckets, not 2")
    kw["coverage"] = (sum(len(r) for r in srs)
                      / sum(len(r) for r in kept))
    t0 = time.monotonic()
    res, _ = run_pipeline(longs, srs, n_it, device,
                          fault_spec="compile@b0.p2;oom@b1", **kw)
    wall = time.monotonic() - t0
    want_reports = []
    for gi, (_, recs) in enumerate(groups):
        alone, _ = run_pipeline(recs, srs, n_it, device, engine="scan",
                                **kw)
        ids = {r.id for r in recs}
        got = [r for r in res.untrimmed if r.id in ids]
        if (result_key(alone)[0] != [k for k in result_key(res)[0]
                                     if k[0] in ids]
                or alone.chimera != [c for c in res.chimera
                                     if c[0] in ids] or len(got) != len(recs)):
            raise AssertionError(f"ladder: bucket {gi} differs from the "
                                 "scan engine")
        rungs = ("eager", "chunk-halved", "host-scan")
        kind = ("compile", "oom")[gi]
        want_reports += [("demote-b%d" % gi, kind, r) for r in rungs]
        want_reports += [(r.task, None, None) for r in alone.reports]
    got_reports = [(r.task, r.note.split(" ")[0] if r.note else None,
                    r.note.split("'")[3] if r.note else None)
                   for r in res.reports]
    if got_reports != want_reports:
        raise AssertionError(f"ladder: reports {got_reports}")
    dem = series(res.metrics, "counters", "resilience_demotions")
    faults = series(res.metrics, "counters", "device_faults")
    if (dem != {(("to_rung", r),): 2 for r in ("eager", "chunk-halved",
                                                 "host-scan")}
            or faults != {(("kind", "compile"),): 3, (("kind", "oom"),): 3}):
        raise AssertionError(f"ladder: counters {dem} {faults}")
    return dict(wall_s=wall, buckets=[len(g[1]) for g in groups],
                demotions={k[0][1]: v for k, v in dem.items()},
                device_faults={k[0][1]: v for k, v in faults.items()})


def run_cli_faulted(argv, spec):
    """``cli.main(argv)`` under ``PROOVREAD_FAULT=spec`` with the ladder
    off: it must stop with the injected fault. Returns its message."""
    from proovread_tpu_torch import cli
    from proovread_tpu_torch.testing.faults import InjectedFault
    os.environ["PROOVREAD_FAULT"] = spec
    try:
        cli.main([*argv, "--no-ladder"])
    except InjectedFault as e:
        return str(e)
    finally:
        os.environ.pop("PROOVREAD_FAULT", None)
    raise AssertionError(f"PROOVREAD_FAULT={spec}: the run did not stop")


def without_journal_keys(plog):
    """parameter.log without the config keys that name the journal and the
    resume (``checkpoint-dir`` lies in each run's own output dir)."""
    return dict(plog, config={k: v for k, v in plog["config"].items()
                              if k not in ("checkpoint-dir", "resume")})


def resume_outputs(out):
    files, plog = cli_outputs(out)
    return files, without_journal_keys(plog)


def cli_kill_resume(tmp, label, longs, srs, spec, n_journaled, ref=None,
                    cfg=None, qc=False, device="cuda"):
    """The command line killed by ``PROOVREAD_FAULT=spec`` under
    ``--no-ladder`` with ``n_journaled`` buckets in its journal, then
    ``--resume``d in the same output dir: its outputs (and with ``qc`` its
    ``qc.jsonl``) equal ``ref`` or, without one, an uninterrupted run's;
    the resumed run replays the journaled buckets, journals the rest,
    demotes nothing and leaves no journal."""
    from proovread_tpu_torch import cli
    lp, sp = write_inputs(tmp, label, longs, srs)
    base = ["-l", lp, "-s", sp, "-q", "--device", device] + (
        ["-c", cfg] if cfg else [])

    def argv(out, *extra):
        return base + ["-p", out, *extra] + (
            ["--qc-out", out + ".qc.jsonl"] if qc else [])
    ref_qc = None
    if ref is None:
        ref_out = os.path.join(tmp, f"{label}-ref", "res")
        if cli.main(argv(ref_out)) != 0:
            raise AssertionError(f"cli {label}: uninterrupted run failed")
        ref = resume_outputs(ref_out)
        ref_qc = ref_out + ".qc.jsonl" if qc else None
    out = os.path.join(tmp, label, "res")
    t0 = time.monotonic()
    killed = run_cli_faulted(argv(out), spec)
    t_kill = time.monotonic() - t0
    journal = os.path.join(out, ".proovread_ckpt")
    n = len([f for f in os.listdir(journal) if f.startswith("bucket_")])
    if n != n_journaled:
        raise AssertionError(f"cli {label}: {n} buckets journaled, not "
                             f"{n_journaled}")
    mpath = os.path.join(tmp, f"{label}.resume.m")
    t0 = time.monotonic()
    if cli.main(argv(out, "--resume", "--metrics-out", mpath)) != 0:
        raise AssertionError(f"cli {label}: --resume failed")
    t_resume = time.monotonic() - t0
    got = resume_outputs(out)
    diff = [k for k in got[0] if got[0][k] != ref[0][k]]
    if diff or got[1] != ref[1]:
        raise AssertionError(f"cli {label}: the resumed run differs in "
                             f"{diff or 'parameter.log'}")
    if ref_qc and (open(out + ".qc.jsonl", "rb").read()
                   != open(ref_qc, "rb").read()):
        raise AssertionError(f"cli {label}: qc.jsonl differs after resume")
    with open(mpath) as fh:
        metrics = json.load(fh)
    no_demotion(f"cli {label} --resume", metrics)
    c = metrics["counters"]
    replays = sum(x["value"] for x in
                  c["checkpoint_journal_replays"]["series"])
    writes = sum(x["value"] for x in c["checkpoint_journal_writes"]["series"])
    n_buckets = metrics["gauges"]["n_buckets"]["series"][0]["value"]
    if replays != n_journaled or writes != n_buckets - n_journaled:
        raise AssertionError(f"cli {label}: {replays} replays, {writes} "
                             f"writes of {n_buckets} buckets")
    if os.path.exists(journal):
        raise AssertionError(f"cli {label}: journal left after --resume")
    return dict(killed=killed, killed_s=t_kill, resume_s=t_resume,
                replays=replays, writes=writes, buckets=n_buckets)


def scan_timed(longs, srs, n_it, n_reads=None):
    """The scan engine on the card on the first length bucket of a
    workload (its first ``n_reads`` reads), with all the workload's short
    reads: wall, passes, the sw kernel's launches and device time, and the
    wall split into host seeding, Smith-Waterman (synchronised),
    admission, the vote scatter and the rest of each pass."""
    import torch
    from proovread_tpu_torch.align import seed, sw
    from proovread_tpu_torch.pipeline import correct
    from proovread_tpu_torch.pipeline import driver as drv
    min_sr = int(np.median([len(r) for r in srs]))
    kept, _ = drv.Pipeline(drv.PipelineConfig()).read_long(longs, min_sr)
    recs = drv._bucket_records(kept, 256)[0][1][:n_reads]
    coverage = sum(len(r) for r in srs) / sum(len(r) for r in kept)
    sw0 = sw.sw_batch.launches
    torch.cuda.reset_peak_memory_stats()
    with KernelTimer("pt_sw_batch") as sw_t, CallTimer([
            (correct.FastCorrector, "correct_batch", "pass", True),
            (seed, "build_index", "seed", False),
            (seed, "find_candidates", "seed", False),
            (correct, "sw_batch", "sw", True),
            (correct, "admit_mask", "admit", False),
            (correct, "fused_accumulate", "votes", True)]) as ct:
        res, wall = run_pipeline(recs, srs, n_it, "cuda", engine="scan",
                                 coverage=coverage)
    no_demotion("scan engine", res.metrics, res.reports)
    bases = sum(len(r) for r in recs)
    split = dict(ct.t)
    split["pass_other"] = split["pass"] - sum(
        split[k] for k in ("seed", "sw", "admit", "votes"))
    return res, dict(
        reads=len(recs), bases=bases, wall_s=wall,
        corrected_bases_per_s=bases / wall,
        passes=[(r.task, r.n_candidates, r.n_admitted) for r in res.reports],
        sw_launches=sw.sw_batch.launches - sw0,
        sw_device_ms=sw_t.total_ms(), seconds=split,
        peak_device_gib=torch.cuda.max_memory_allocated() / 2**30)


# --------------------------------------------------------------------------
# phases 3 and 11-13: subreads (ccs-1), unitigs (utg) and flex mode
# --------------------------------------------------------------------------

# phase 3's CPU side: a subprocess of this script runs ``cpu_side``
CPU_SIDE = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.cpu_side(sys.argv[2])
"""
# the subprocesses phase 3's CPU side spreads its runs over
CPU_SIDE_WORKERS = 2

COVERAGE_400 = dict(coverage=400.0, sr_coverage=400.0, finish_coverage=400.0)


def cpu_pipelines(tmp) -> None:
    """Config 4's ``Pipeline.run`` on the CPU (default and coverage 400),
    the qual-weighted chain and the scan engine, pickled to
    ``cpu_side.pkl``."""
    import pickle
    longs, srs, n_it, _ = workload(10_000, 40_000, 4)
    out = {}
    for label, kw in (("", {}), (" coverage 400", COVERAGE_400)):
        res, t = run_pipeline(longs, srs, n_it, "cpu", **kw)
        out["pipeline" + label] = (result_key(res), t)
    t0 = time.monotonic()
    out["qual_chain"] = qual_chain(first_bucket(longs, srs), "cpu",
                                   n_rest=3, finish=True)
    out["qual_chain_s"] = time.monotonic() - t0
    res, t = run_pipeline(longs, srs, n_it, "cpu", engine="scan")
    out["scan"] = (result_key(res), t)
    with open(os.path.join(tmp, "cpu_side.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def cpu_side(tmp) -> None:
    """Phase 3's CPU halves, in each of the subprocesses ``CpuSide``
    starts: until none is left, claim the next job of ``cli_runs.json``'s
    ``order`` (a file created exclusively, so each job runs once) and run
    it: "pipelines" (``cpu_pipelines``), or the index of a command line
    of its ``runs`` (``--device cpu``), whose exit code and wall go to
    ``cli_run.<index>.done``."""
    with open(os.path.join(tmp, "cli_runs.json")) as fh:
        spec = json.load(fh)
    for job in spec["order"]:
        try:
            os.close(os.open(os.path.join(tmp, f"claim.{job}"),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        except FileExistsError:
            continue
        if job == "pipelines":
            cpu_pipelines(tmp)
            continue
        t0 = time.monotonic()
        rc = run_argv(spec["runs"][job])
        with open(os.path.join(tmp, f"cli_run.{job}.done"), "w") as fh:
            json.dump([rc, time.monotonic() - t0], fh)


def run_argv(argv) -> int:
    """A command line of phase 3's: ``tools ...`` through the tools'
    entry point, anything else through ``cli.main``."""
    from proovread_tpu_torch import cli, tools
    if argv and argv[0] == "tools":
        return tools.main(argv[1:])
    return cli.main(argv)


class CpuSide:
    """Phase 3's CPU halves, run from the end of phase 1 on in
    ``CPU_SIDE_WORKERS`` subprocesses of 4 threads each at low priority
    (``cpu_side``), beside the card's phases:
    config 4's pipeline runs, qual-weighted chain and scan engine, and the
    command line, scored, in sr-noccs and mr-noccs and in the modes of
    ``ccs-1``, ``-u`` and ``--haplo-coverage``: PacBio subreads (16 kb of
    molecules) in ``sr``; config 4's long reads with unitigs (3-5 kb
    fragments) in ``sr+utg-noccs`` and, without short reads,
    ``utg-noccs``; two haplotypes (40 kb of long reads) with
    ``--haplo-coverage`` bare and 12 in ``sr-noccs``; sr-noccs and
    mr-noccs streamed (a config's ``sr-device-budget`` of 4 KiB) and with
    ``--debug``; ``-m legacy``; ``-m sam`` and ``-m bam`` (all long reads
    but the last, so that the run fetches through the ``.bai``) on config
    4's mapping (``mapping_sam`` on ``device``, converted with the port's
    tools); and ``tools sam2cns --variants --stabilize`` on that mapping.
    Phase 3 runs the card halves (``run_cli`` for the command lines);
    ``compare``, at the end of the script, holds the two sides identical:
    records, reports and chimeras; every ``ConsensusCall`` field of the
    chain; all six files, ``qc.jsonl``, the metrics but for their timings
    and ``--debug``'s files; the variant table; and the streamed runs'
    five files equal to the resident runs'."""

    def __init__(self, tmp, device="cuda"):
        from proovread_tpu_torch import tools
        longs, srs, _, truths = workload(10_000, 40_000, 4)
        _, srs_mr, _, _ = workload(10_000, 40_000, 4, sr_len=250)
        subs, sub_truths, _ = subread_workload(10_000, 16_000)
        utgs = unitig_workload(10_000, frag=(3_000, 5_000))
        hl, hs, ht, _, _, _ = haplotype_workload(10_000, 40_000)
        self.tmp, self.procs, self.cases, self.card = tmp, [], [], {}
        stream = os.path.join(tmp, "stream.cfg")
        with open(stream, "w") as fh:
            json.dump({"sr-device-budget": 4096}, fh)
        sam, bam = (os.path.join(tmp, f"config4-map.{x}")
                    for x in ("sam", "bam"))
        t0 = time.monotonic()
        self.map_records, _, kept, _ = mapping_sam(sam, longs, srs, device)
        if (tools.main(["samfilter", sam, bam])
                or tools.main(["bamindex", bam])):
            raise AssertionError("phase 3: samfilter or bamindex failed")
        log(f"phase3 config 4 mapping: {self.map_records} records, "
            f"{time.monotonic() - t0:.1f} s")
        refs = write_inputs(tmp, "config4-refs", kept, [])[0]
        self.tools = [("sam2cns --variants --stabilize", [
            "tools", "sam2cns", "--variants", "--stabilize", "--device",
            "{device}", sam, refs, "{out}"])]
        self.streamed = {"sr-noccs streaming": "sr-noccs",
                         "mr-noccs streaming": "mr-noccs"}
        truth_of = {x.id: t for x, t in zip(longs, truths)}
        for label, (lr, sr, mode, tr, ut, extra) in (
                ("sr-noccs", (longs, srs, "sr-noccs", truths, None, [])),
                ("mr-noccs", (longs, srs_mr, "mr-noccs", truths, None, [])),
                ("sr-noccs streaming", (longs, srs, "sr-noccs", truths,
                                        None, ["-c", stream])),
                ("mr-noccs streaming", (longs, srs_mr, "mr-noccs", truths,
                                        None, ["-c", stream])),
                ("sr-noccs --debug", (longs, srs, "sr-noccs", truths, None,
                                      ["--debug"])),
                ("legacy", (longs, srs, "legacy", truths, None,
                            ["-m", "legacy"])),
                ("sam", (kept, [], "sam", [truth_of[x.id] for x in kept],
                         None, ["--sam", sam, "-m", "sam"])),
                ("bam", (kept[:-1], [], "bam",
                         [truth_of[x.id] for x in kept[:-1]], None,
                         ["--bam", bam, "-m", "bam"])),
                ("sr subreads", (subs, srs, "sr", sub_truths, None, [])),
                ("sr+utg-noccs", (longs, srs, "sr+utg-noccs", truths, utgs,
                                  [])),
                ("utg-noccs", (longs, [], "utg-noccs", truths, utgs, [])),
                ("flex bare", (hl, hs, "sr-noccs", ht, None,
                               ["--haplo-coverage"])),
                ("flex 12", (hl, hs, "sr-noccs", ht, None,
                             ["--haplo-coverage", "12"]))):
            name = "config4-" + label.replace(" ", "-")
            self.cases.append((label, name, input_args(tmp, name, lr, sr, ut),
                               write_truth(tmp, name, lr, tr), mode, extra))

    def _out(self, name, device):
        return os.path.join(self.tmp, f"{name}-{device}")

    def _argv(self, case, device):
        _, name, inputs, tp, _, extra = case
        out = self._out(name, device)
        return [*inputs, "-p", os.path.join(out, "res"), "--no-checkpoint",
                "--device", device, "-q", "--truth", tp, "--qc-out",
                out + ".qc", "--metrics-out", out + ".m", *extra]

    def _tool_argv(self, tool, device):
        label, argv = tool
        out = self._out(label.split()[0], device)
        return [a.format(device=device, out=out) for a in argv]

    def start(self) -> None:
        runs = ([self._argv(c, "cpu") for c in self.cases]
                + [self._tool_argv(t, "cpu") for t in self.tools])
        # the pipelines (~135 s on the card's host), then the command
        # lines from the end of the list, where the two flex runs (~75 s
        # each) are, to the short ones
        order = ["pipelines"] + list(range(len(runs)))[::-1]
        with open(os.path.join(self.tmp, "cli_runs.json"), "w") as fh:
            json.dump({"runs": runs, "order": order}, fh)
        self.err = open(os.path.join(self.tmp, "cpu_side.err"), "w")
        here = os.path.dirname(os.path.abspath(__file__))
        self.procs = [subprocess.Popen(
            ["nice", "-n", "10", sys.executable, "-c", CPU_SIDE, here,
             self.tmp], cwd=here, env=dict(os.environ, OMP_NUM_THREADS="4"),
            stdout=subprocess.DEVNULL, stderr=self.err)
            for _ in range(CPU_SIDE_WORKERS)]

    def run_cli(self) -> None:
        """The command lines' card halves."""
        from proovread_tpu_torch import cli
        for case in self.cases:
            t0 = time.monotonic()
            rc = cli.main(self._argv(case, "cuda"))
            self.card[case[0]] = time.monotonic() - t0
            if rc != 0:
                raise AssertionError(f"cli {case[1]} on the card: exit {rc}")
        for tool in self.tools:
            t0 = time.monotonic()
            rc = run_argv(self._tool_argv(tool, "cuda"))
            self.card[tool[0]] = time.monotonic() - t0
            if rc != 0:
                raise AssertionError(f"tools {tool[0]} on the card: exit "
                                     f"{rc}")

    def compare(self, card) -> None:
        """Wait for the CPU side, then hold it identical to the card's
        (``card``: phase 3's pipeline keys, the chain and the scan engine's
        keys) and log each comparison."""
        import pickle
        from proovread_tpu_torch.obs.metrics import without_timings
        t0 = time.monotonic()
        if any(p.wait(timeout=1200) != 0 for p in self.procs):
            self.err.flush()
            with open(self.err.name) as fh:
                raise AssertionError("phase 3's CPU side failed: "
                                     + fh.read()[-3000:])
        log(f"phase3 waited {time.monotonic() - t0:.1f} s for the CPU side")
        with open(os.path.join(self.tmp, "cpu_side.pkl"), "rb") as fh:
            cpu = pickle.load(fh)
        for label in ("", " coverage 400"):
            key, t_gpu, counts = card["pipeline" + label]
            if key != cpu["pipeline" + label][0]:
                raise AssertionError(f"config 4{label}: card and CPU differ")
            log(f"phase3 config 4{label}: card {t_gpu:.1f} s, CPU "
                f"{cpu['pipeline' + label][1]:.1f} s, {counts}, identical")
        (h_gpu, st_gpu), t_gpu = card["qual_chain"]
        h_cpu, st_cpu = cpu["qual_chain"]
        strip = lambda st: [{k: v for k, v in d.items()  # noqa: E731
                             if k != "seconds"} for d in st]
        if not same_host(h_gpu, h_cpu) or strip(st_gpu) != strip(st_cpu):
            diff = [k for k in h_gpu if k not in h_cpu
                    or h_gpu[k].tobytes() != h_cpu[k].tobytes()]
            raise AssertionError(f"config 4 qual-weighted chain: card and CPU"
                                 f" differ in {diff or 'pass counts'}")
        log(f"phase3 config 4 qual-weighted chain: card {t_gpu:.1f} s, CPU "
            f"{cpu['qual_chain_s']:.1f} s, {len(st_gpu)} passes, identical: "
            + json.dumps(strip(st_gpu)))
        key, t_gpu, counts = card["scan"]
        if key != cpu["scan"][0]:
            raise AssertionError("config 4 scan engine: card and CPU differ")
        log(f"phase3 config 4 scan engine: card {t_gpu:.2f} s, CPU "
            f"{cpu['scan'][1]:.1f} s, {counts}, identical")
        done = []
        for i in range(len(self.cases) + len(self.tools)):
            with open(os.path.join(self.tmp, f"cli_run.{i}.done")) as fh:
                done.append(json.load(fh))
        for tool, (rc, cpu_s) in zip(self.tools, done[len(self.cases):]):
            if rc != 0:
                raise AssertionError(f"tools {tool[0]} on the CPU: exit {rc}")
            got = {}
            for d in ("cuda", "cpu"):
                with open(self._tool_argv(tool, d)[-1], "rb") as fh:
                    got[d] = fh.read()
            if got["cuda"] != got["cpu"] or not got["cuda"]:
                raise AssertionError(f"tools {tool[0]}: card and CPU differ")
            log(f"phase3 tools {tool[0]} on config 4's mapping "
                f"({self.map_records} records): card {self.card[tool[0]]:.1f}"
                f" s, CPU {cpu_s:.1f} s, {got['cuda'].count(b'\n')} rows, "
                "identical")
        for (label, name, _, case_truth, mode, _), (rc, cpu_s) in zip(
                self.cases, done):
            if rc != 0:
                raise AssertionError(f"cli {name} on the CPU: exit {rc}")
            got = {d: cli_outputs(os.path.join(self._out(name, d), "res"))
                   for d in ("cuda", "cpu")}
            files, plog = got["cuda"]
            if plog["mode"] != mode:
                raise AssertionError(f"cli {name}: mode {plog['mode']}")
            diff = [k for k in files if files[k] != got["cpu"][0][k]]
            if diff or plog != got["cpu"][1]:
                raise AssertionError(f"cli {name}: card and CPU differ in "
                                     f"{diff or 'parameter.log'}")
            extra = {d: extra_outputs(os.path.join(self._out(name, d),
                                                   "res"))
                     for d in ("cuda", "cpu")}
            if extra["cuda"] != extra["cpu"]:
                raise AssertionError(f"cli {name}: card and CPU differ in "
                                     f"{sorted(extra['cuda'])}")
            if "--debug" in label and not (
                    "res.debug.tsv" in extra["cuda"]
                    and any(k.startswith("admitted.") for k in extra["cuda"])):
                raise AssertionError(f"cli {name}: no debug files")
            if label in self.streamed:
                res_files = cli_outputs(os.path.join(self._out(
                    "config4-" + self.streamed[label], "cuda"), "res"))[0]
                if files != res_files:
                    raise AssertionError(f"cli {name}: streamed and resident "
                                         "files differ")
            for d in ("cuda", "cpu"):
                validate_artifacts(f"{name} {d}",
                                   metrics=self._out(name, d) + ".m",
                                   qc=self._out(name, d) + ".qc",
                                   truth=case_truth)
            qc_b, m_b = ({d: open(self._out(name, d) + ext, "rb").read()
                          for d in ("cuda", "cpu")} for ext in (".qc", ".m"))
            if qc_b["cuda"] != qc_b["cpu"]:
                raise AssertionError(f"cli {name}: card and CPU qc.jsonl "
                                     "differ")
            if without_timings(json.loads(m_b["cuda"])) != without_timings(
                    json.loads(m_b["cpu"])):
                raise AssertionError(f"cli {name}: card and CPU metrics "
                                     "differ")
            acc = read_qc(self._out(name, "cuda") + ".qc")[0][
                "aggregate"]["accuracy"]
            log(f"phase3 cli config 4 {label}: card {self.card[label]:.1f} s,"
                f" CPU {cpu_s:.1f} s, {files['untrimmed.fq'].count(b'\n') // 4}"
                f" untrimmed, {files['trimmed.fa'].count(b'>')} trimmed; all "
                "six files and qc.jsonl identical, metrics but timings"
                + (f", {len(extra['cuda'])} debug files identical"
                   if extra["cuda"] else "")
                + (", the five files == the resident run's"
                   if label in self.streamed else "")
                + f"; identity {acc['identity_before']['mean']} -> "
                f"{acc['identity_after']['mean']}")
            if label == "sr-noccs":
                # the JAX package's recorded config-4 row (sr-noccs)
                acc = hold_accuracy("config 4 sr-noccs", acc,
                                    recorded_accuracy(4))
                log("phase3 config 4 sr-noccs accuracy == the JAX package's "
                    "ACCURACY_r10.json row: " + json.dumps(acc))

    def close(self) -> None:
        """Stop the CPU side if it still runs, and remove the files."""
        import shutil
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


# phase 8's class-breakdown sample (the scoreboard's default classifies
# 64 reads, ~30 s of host numpy a run at E.coli class), cut to keep the
# whole run short
CLASSIFY_MR = 16


def device_args(device: str):
    """The command line's device flag for ``device`` (none for the card,
    the default a user runs)."""
    return [] if device == "cuda" else ["--device", device]


def phase11(tmp, srs, genome=1_250_000, molecule_bases=2_000_000,
            device="cuda", edit_hold=None):
    """Subreads at E.coli class: 2 Mb of molecules of phase 4's genome as
    PacBio subreads (~5 Mb) with phase 7's short reads, through
    ``cli.main`` with its defaults (mode sr: ``ccs-1``, then the passes),
    scored. Returns what it logs; the kernels of its path must launch."""
    from proovread_tpu_torch.obs.accuracy import score_read_sets
    from proovread_tpu_torch.ops.encode import encode_ascii
    from proovread_tpu_torch.pipeline import tasks
    subs, truths, zmw = subread_workload(genome, molecule_bases)
    r, _, (probes, _) = cli_run(tmp, "ecoli-subreads", subs, srs, "sr",
                                truths, extra=device_args(device),
                                tasks=[("ccs", tasks, "ccs_correct")],
                                edit_hold=edit_hold)
    pr = probes["ccs"]
    ccs_out, st = pr.out
    # identity before: every subread against its molecule (the scored
    # run's own before is the reference subreads')
    codes = {x.id: encode_ascii(x.seq) for x in subs}
    _, summ = score_read_sets(codes, codes, dict(zip(codes, truths)),
                              classify_cap=0, device=device)
    n_sub_bases = sum(len(x) for x in subs)
    r.update(
        subreads=len(subs), zmws=len(set(zmw)), subread_bases=n_sub_bases,
        subread_bases_per_s=n_sub_bases / r["wall_unscored_s"],
        ccs_s=pr.wall, ccs_stats=vars(st), ccs_reads=len(ccs_out),
        ccs_bases=sum(len(x) for x in ccs_out),
        ccs_seed_s=pr.s["seed"], ccs_consensus_call_s=pr.s["consensus_call"],
        ccs_sw_launches=pr.launches("sw_batch"),
        ccs_sw_device_ms=pr.device_ms("sw_batch"),
        ccs_sw_launch_ms=pr.launch_ms("sw_batch"),
        ccs_scatter_launches=pr.launches("scatter_add_ordered"),
        ccs_scatter_device_ms=pr.device_ms("scatter_add_ordered"),
        subread_identity=summ["identity_before"])
    if st.primary == 0:
        raise AssertionError("phase 11: ccs-1 made no consensus")
    return r


def phase12(tmp, longs, srs, truths, genome=1_250_000, device="cuda",
            edit_hold=None):
    """Unitigs at E.coli class: phase 4's CLR reads, phase 7's short reads
    and 15-30 kb unitigs tiling the genome at ~1.2x, through ``cli.main
    -u`` (mode sr+utg-noccs), scored. Returns what it logs."""
    import dataclasses
    from proovread_tpu_torch.pipeline import utg
    utgs = unitig_workload(genome, frag=(min(15_000, genome // 3),
                                         min(30_000, genome // 2)))
    r, _, (probes, _) = cli_run(tmp, "ecoli-utg", longs, srs,
                                "sr+utg-noccs", truths, utgs=utgs,
                                extra=device_args(device),
                                tasks=[("utg", utg, "utg_correct")],
                                edit_hold=edit_hold)
    pr = probes["utg"]
    _, rep = pr.out
    r.update(
        unitigs=len(utgs), unitig_bases=sum(len(x) for x in utgs),
        utg_s=pr.wall, utg_seed_s=pr.s["seed"], utg_sw_s=pr.s["sw"],
        utg_sw_launches=pr.launches("sw_batch"),
        utg_sw_device_ms=pr.device_ms("sw_batch"),
        utg_sw_launch_ms=pr.launch_ms("sw_batch"),
        utg_scatter_launches=pr.launches("scatter_add_ordered"),
        utg_scatter_device_ms=pr.device_ms("scatter_add_ordered"),
        utg_consensus_call_s=pr.s["consensus_call"],
        utg_report=dataclasses.asdict(rep))
    if rep.n_admitted == 0:
        raise AssertionError("phase 12: utg admitted no alignment")
    return r


class HaploProbe:
    """The flex estimates of a run: each device bucket's calls of
    ``estimate_haplo_coverage``, the running minimum a read of the bucket
    gets over them."""

    def __enter__(self):
        import torch
        from proovread_tpu_torch.pipeline import dcorrect, driver
        self.mods = (dcorrect, driver.Pipeline)
        self.est, self.buckets = dcorrect.estimate_haplo_coverage, []
        self.run = driver.Pipeline._run_batch_device
        probe, est, run = self, self.est, self.run

        def estimate(*a, **k):
            hpl = est(*a, **k)
            b = probe.buckets[-1]
            b[1] = hpl if b[1] is None else torch.minimum(b[1], hpl)
            return hpl

        def run_batch(self_, batch_recs, *a, **k):
            probe.buckets.append([len(batch_recs), None])
            return run(self_, batch_recs, *a, **k)
        dcorrect.estimate_haplo_coverage = estimate
        driver.Pipeline._run_batch_device = run_batch
        return self

    def __exit__(self, *exc):
        dcorrect, pipe = self.mods
        dcorrect.estimate_haplo_coverage = self.est
        pipe._run_batch_device = self.run

    def per_read(self) -> np.ndarray:
        return np.concatenate([h[:n].cpu().numpy() for n, h in self.buckets
                               if h is not None] or [np.zeros(0)])


def phase13(tmp, genome=1_250_000, long_bases=5_000_000, device="cuda"):
    """Flex at E.coli class: two haplotypes (a SNP every 200 bases), 5 Mb
    of CLR reads half from each, 8x of A's and 30x of B's short reads,
    through ``cli.main --haplo-coverage`` (mode sr-noccs), scored; then,
    in the same phase, the same command without flex (siamaera off,
    unscored, on A's reads) for the SNP share. Holds: every read scored;
    haplotype B's reads reach the identity floor and pass their input;
    A's reads keep more of A's SNP bases with flex than without. Returns
    what it logs."""
    import io
    from proovread_tpu_torch import cli
    from proovread_tpu_torch.io.fastq import FastqReader
    from proovread_tpu_torch.obs.accuracy import IDENTITY_FLOOR
    from proovread_tpu_torch.pipeline import tasks
    hl, hs, ht, meta, hap_a, hap_b = haplotype_workload(genome, long_bases)
    with HaploProbe() as hp:
        r, _, (probes, qc_recs) = cli_run(
            tmp, "ecoli-flex", hl, hs, "sr-noccs", ht,
            extra=[*device_args(device), "--haplo-coverage"],
            hold_identity=False, tasks=[("run", tasks, "run_tasks")])
    est = hp.per_read()
    finite = est[np.isfinite(est)]
    reports = probes["run"].out.reports
    ident = {"A": [], "B": []}
    hap_of = {x.id: m[0] for x, m in zip(hl, meta)}
    for rec in qc_recs:
        a = rec.get("accuracy")
        if a is not None:
            ident[hap_of[rec["id"]]].append((a["identity_before"],
                                             a["identity_after"]))
    mean = {h: np.mean(v, axis=0).tolist() if v else None
            for h, v in ident.items()}
    # without flex: the same command on A's reads, siamaera off, unscored
    nos = os.path.join(tmp, "nosiamaera.cfg")
    with open(nos, "w") as fh:
        json.dump({"siamaera": None}, fh)
    out0 = os.path.join(tmp, "ecoli-noflex", "res")
    reads_a = [x for x, m in zip(hl, meta) if m[0] == "A"]
    t0 = time.monotonic()
    rc = cli.main([*input_args(tmp, "ecoli-noflex", reads_a, hs), "-p", out0,
                   "--no-checkpoint", "-q", "-c", nos,
                   *device_args(device)])
    wall0 = time.monotonic() - t0
    if rc != 0:
        raise AssertionError(f"phase 13 without flex: exit {rc}")

    def recs(out):
        return list(FastqReader(io.BytesIO(cli_outputs(out)[0][
            "untrimmed.fq"])))
    share_flex = snp_share(recs(os.path.join(tmp, "ecoli-flex", "res")),
                           meta, hl, hap_a, hap_b)
    share_plain = snp_share(recs(out0), meta, hl, hap_a, hap_b)
    r.update(
        passes=[x.task for x in reports if x.task.startswith("bwa-")],
        reads_a=len(ident["A"]), reads_b=len(ident["B"]),
        identity_a=mean["A"], identity_b=mean["B"],
        estimates=int(est.size), finite_estimates=int(finite.size),
        median_estimate=float(np.median(finite)) if finite.size else None,
        snp_share_flex=share_flex, snp_share_plain=share_plain,
        wall_plain_s=wall0)
    b_before, b_after = mean["B"]
    if not (b_after >= IDENTITY_FLOOR and b_after > b_before):
        raise AssertionError(f"phase 13: haplotype B identity {b_before} "
                             f"-> {b_after}")
    if not share_flex[1] > share_plain[1]:
        raise AssertionError(f"phase 13: SNP share with flex {share_flex} "
                             f"not above without {share_plain}")
    return r


# --------------------------------------------------------------------------
# phases 3, 14 and 15: the streaming regime and SAM/BAM re-entry
# --------------------------------------------------------------------------

def exact_alignments(aln, lr_ids, srs):
    """SAM records of a device pass's admitted alignments (``aln``, the
    ``AlnData`` of ``correct_pass(..., collect_aln=True)`` against the whole
    short-read set ``srs``) that ``sam2cns`` can read back: the CIGAR from
    the vote slabs' query rows (M a base column, D a gap column, I the
    query bases between two base columns, S the bases outside the first and
    last base column), SEQ and QUAL the read's, reverse-complemented on the
    reverse strand. ``dump_admitted_sam`` writes the reference's debug
    records instead: SEQ '*' and a CIGAR that drops the bases of a leading
    insertion, whose query length then differs from the read's. Built with
    numpy over all rows at once."""
    from proovread_tpu_torch.io.sam import _COMPLEMENT, SamAlignment
    from proovread_tpu_torch.ops.encode import GAP, encode_ascii
    use = np.flatnonzero(aln.admitted & aln.vote_ok)
    aln.prefetch(use)
    st = np.stack([aln._rows[int(c)][0] for c in use])
    qr = np.stack([aln._rows[int(c)][1] for c in use]).astype(np.int64)
    n, W = st.shape
    is_m = (st >= 0) & (st != GAP)
    has = is_m.any(1)
    first = np.argmax(is_m, 1)
    last = W - 1 - np.argmax(is_m[:, ::-1], 1)
    col = np.arange(W)[None, :]
    inside = ((col >= first[:, None]) & (col <= last[:, None])
              & has[:, None])
    is_m &= inside
    live = is_m | ((st == GAP) & inside)
    rows, cols = np.nonzero(live)
    op = np.where(is_m[rows, cols], 0, 1)           # 0 M, 1 D, 2 I
    mrow, mcol = np.nonzero(is_m)
    qpos = qr[mrow, mcol]
    ins_m = np.zeros(len(mrow), np.int64)
    ins_m[:-1] = np.where(mrow[1:] == mrow[:-1], qpos[1:] - qpos[:-1] - 1,
                          0)
    if (ins_m < 0).any():
        raise AssertionError("exact_alignments: query rows not increasing")
    # the slab's state of a base column is the query's base there
    sread = aln.sread[use].astype(np.int64)
    strand = aln.strand[use].astype(bool)
    seqs = {}

    def seq_of(i):
        k = (int(sread[i]), bool(strand[i]))
        if k not in seqs:
            r = srs[k[0]]
            q = "".join(chr(33 + int(x)) for x in r.qual)
            seqs[k] = ((r.seq.translate(_COMPLEMENT)[::-1], q[::-1]) if k[1]
                       else (r.seq, q))
        return seqs[k]
    wrong = 0
    for i in range(0, n, max(1, n // 200)):        # ~200 rows checked
        codes = encode_ascii(seq_of(i)[0])
        sel = mrow == i
        wrong += int((codes[qpos[sel]] != st[i, mcol[sel]]).sum())
    if wrong:
        raise AssertionError(f"exact_alignments: {wrong} base columns "
                             "differ from the read's bases")
    ins = np.zeros(len(rows), np.int64)
    ins[op == 0] = ins_m
    t_op = np.stack([op, np.full_like(op, 2)], 1).ravel()
    t_len = np.stack([np.ones_like(op), ins], 1).ravel()
    t_row = np.repeat(rows, 2)
    keep = t_len > 0
    t_op, t_len, t_row = t_op[keep], t_len[keep], t_row[keep]
    start = np.ones(len(t_op), bool)
    start[1:] = (t_op[1:] != t_op[:-1]) | (t_row[1:] != t_row[:-1])
    idx = np.flatnonzero(start)
    r_len, r_op, r_row = np.add.reduceat(t_len, idx), t_op[idx], t_row[idx]
    parts = [f"{ln}{c}" for ln, c in zip(
        r_len.tolist(), np.array(list("MDI"))[r_op].tolist())]
    bound = np.searchsorted(r_row, np.arange(n + 1))
    q_first = qr[np.arange(n), first]
    q_last = qr[np.arange(n), last]
    out = []
    for i in np.flatnonzero(has):
        seq, qual = seq_of(i)
        head, tail = int(q_first[i]), len(seq) - 1 - int(q_last[i])
        ci = use[i]
        out.append(SamAlignment(
            qname=srs[int(sread[i])].id, flag=16 if strand[i] else 0,
            rname=lr_ids[int(aln.lread[ci])],
            pos=int(aln.win_start[ci]) + int(first[i]), mapq=255,
            cigar=(f"{head}S" if head else "")
            + "".join(parts[bound[i]:bound[i + 1]])
            + (f"{tail}S" if tail else ""),
            seq=seq, qual=qual, tags={"AS": ("i", int(aln.score[ci]))}))
    return out


def mapping_sam(path, longs, srs, device, chunk=8192):
    """An external mapping made with the port's own device pass: each
    length bucket of ``longs`` (packed as the driver packs it) through one
    ``DeviceCorrector.correct_pass(..., collect_aln=True)`` with pass 1's
    parameters (``BWA_SR``, the iteration consensus parameters at the set's
    coverage) against the whole short-read set, each bucket's admitted
    alignments dumped with ``dump_admitted_sam`` and written as
    ``exact_alignments`` records, coordinate-sorted under one header of
    every long read. Returns (records, dumped records, the long reads the
    header names, seconds)."""
    import torch
    from proovread_tpu_torch.align.params import BWA_SR
    from proovread_tpu_torch.io import sam as samio
    from proovread_tpu_torch.io.batch import pack_reads
    from proovread_tpu_torch.io.records import SeqRecord
    from proovread_tpu_torch.pipeline import dcorrect as dc
    from proovread_tpu_torch.pipeline import driver as drv
    t0 = time.monotonic()
    cfg = drv.PipelineConfig()
    min_sr_len = int(np.median([len(r) for r in srs]))
    kept, _ = drv.Pipeline(cfg).read_long(longs, min_sr_len)
    cns = drv.iteration_consensus_params(
        cfg, sum(len(r) for r in srs) / sum(len(r) for r in kept))
    dev = torch.device(device)
    srd = drv._SrDevice(pack_reads(srs, pad_multiple=16), dev)
    corr = dc.DeviceCorrector(chunk=chunk)
    sr_ids = [r.id for r in srs]
    sr_lens = np.array([len(r) for r in srs])
    recs, n_dump = [], 0
    for gi, (pad, brecs) in enumerate(drv._bucket_records(kept,
                                                          cfg.batch_reads)):
        rows = drv.batch_rows(len(brecs), cfg.batch_reads)
        lr = pack_reads(list(brecs) + [SeqRecord(f"_pad{i}", "A" * 8)
                                       for i in range(rows - len(brecs))],
                        pad_len=drv.bucket_lp(pad, cfg.length_slack))
        codes, qual, lengths = (torch.as_tensor(a, device=dev)
                                for a in (lr.codes, lr.qual, lr.lengths))
        _, _, aln = corr.correct_pass(codes, qual, lengths, None,
                                      *srd.full(), BWA_SR, cns,
                                      collect_aln=True)
        dump = f"{path}.b{gi}"
        n_dump += dc.dump_admitted_sam(
            aln, dump, lr.ids[:len(brecs)], lr.lengths[:len(brecs)], sr_ids,
            sr_lens, np.arange(len(srs)))
        mine = exact_alignments(aln, lr.ids, srs)
        got = [(a.qname, a.flag, a.rname, a.pos, a.opt("AS"))
               for a in samio.SamReader(dump)]
        if got != [(a.qname, a.flag, a.rname, a.pos, a.opt("AS"))
                   for a in mine]:
            raise AssertionError(f"mapping bucket {gi}: the dump's records "
                                 "are not the exact ones'")
        os.remove(dump)
        recs.extend(mine)
    order = {r.id: i for i, r in enumerate(kept)}
    recs.sort(key=lambda a: (order[a.rname], a.pos))
    hdr = samio.SamHeader(lines=["@HD\tVN:1.6\tSO:coordinate"])
    for r in kept:
        hdr.add_ref(r.id, len(r))
    with samio.SamWriter(path, header=hdr) as w:
        for a in recs:
            w.write(a)
    if device == "cuda":
        torch.cuda.synchronize()
    return len(recs), n_dump, kept, time.monotonic() - t0


def phase14(genome=1_250_000, long_bases=1_000_000, sr_coverage=80.0,
            budget=128 << 20, device="cuda"):
    """The streaming regime at full width: ``Pipeline.run`` on 1 Mb of CLR
    reads of phase 4's genome with 80x of 100 bp short reads, once with
    the set resident (the default budget) and once streamed (``budget``).
    Holds: the two runs' records equal, the regimes as asked, and the
    streaming run's peak device memory below the resident run's by at
    least half of the set's bytes less the largest slab's. Returns what
    it logs."""
    import torch
    from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
    t0 = time.monotonic()
    longs, srs, n_it, _ = workload(genome, long_bases, 6,
                                   sr_coverage=sr_coverage)
    r = dict(long_reads=len(longs), long_bases=sum(len(x) for x in longs),
             short_reads=len(srs), simulate_s=time.monotonic() - t0)
    keys = {}
    for label, b in (("resident", 2 << 30), ("streaming", budget)):
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        pipe = Pipeline(PipelineConfig(mode="sr", n_iterations=n_it,
                                       device=device, sr_device_budget=b))
        t0 = time.monotonic()
        res = pipe.run(longs, srs)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        no_demotion(f"phase 14 {label}", res.metrics, res.reports)
        keys[label] = result_key(res)
        r[label] = dict(
            wall_s=wall, bases_per_s=r["long_bases"] / wall,
            peak_device_bytes=(torch.cuda.max_memory_allocated()
                               if device == "cuda" else 0),
            passes=[(x.task, x.n_candidates, x.n_admitted)
                    for x in res.reports], **pipe.sr_stats)
        del pipe, res
    res_r, res_s = r["resident"], r["streaming"]
    if not (res_r["resident"] and not res_s["resident"]):
        raise AssertionError("phase 14: the regimes are not the ones asked")
    if keys["resident"][:4] != keys["streaming"][:4]:
        raise AssertionError("phase 14: streaming and resident records "
                             "differ")
    r["reports_equal"] = keys["resident"][4] == keys["streaming"][4]
    need = (res_s["set_bytes"] - res_s["max_slab_bytes"]) / 2
    r["peak_saving_bytes"] = (res_r["peak_device_bytes"]
                              - res_s["peak_device_bytes"])
    r["peak_saving_needed_bytes"] = need
    if device == "cuda" and r["peak_saving_bytes"] < need:
        raise AssertionError(f"phase 14: streaming peak "
                             f"{res_s['peak_device_bytes']} not below the "
                             f"resident {res_r['peak_device_bytes']} by "
                             f"{need:.0f} bytes")
    return r


def reentry_run(tmp, label, longs, truths, flag, path, device="cuda"):
    """``cli.main`` in re-entry mode (``-m sam --sam`` / ``-m bam --bam``)
    on ``longs``, scored against ``truths``. Returns (wall, the five
    files, the QC aggregate's accuracy)."""
    from proovread_tpu_torch import cli
    lp = write_inputs(tmp, label, longs, [])[0]
    tp = write_truth(tmp, label, longs, truths)
    out = os.path.join(tmp, label, "res")
    qc = os.path.join(tmp, f"{label}.qc")
    t0 = time.monotonic()
    rc = cli.main(["-l", lp, flag, path, "-m", flag[2:], "-p", out, "-q",
                   "--truth", tp, "--qc-out", qc, *device_args(device)])
    wall = time.monotonic() - t0
    if rc != 0:
        raise AssertionError(f"cli {label}: exit {rc}")
    return wall, cli_outputs(out)[0], read_qc(qc)[0]["aggregate"][
        "accuracy"]


def phase15(tmp, longs, srs, truths, device="cuda"):
    """SAM/BAM re-entry at full width: a mapping of ``longs`` (phase 4's
    raw reads) against phase 4's short reads made on the card
    (``mapping_sam``), converted to BAM and ``.bai`` with the port's
    tools, then ``-m sam`` and ``-m bam`` on all reads but the last (so
    the BAM run fetches its references through the ``.bai``), scored; and
    ``tools sam2cns --variants`` on the same SAM. Holds: the two runs'
    files equal, every read scored, identity after above before. Returns
    what it logs."""
    from proovread_tpu_torch import tools
    sam = os.path.join(tmp, "map.sam")
    n_rec, n_dump, kept, map_s = mapping_sam(sam, longs, srs, device)
    bam = os.path.join(tmp, "map.bam")
    t0 = time.monotonic()
    if tools.main(["samfilter", sam, bam]) or tools.main(["bamindex", bam]):
        raise AssertionError("phase 15: samfilter or bamindex failed")
    convert_s = time.monotonic() - t0
    truth_of = {x.id: t for x, t in zip(longs, truths)}
    sub = kept[:-1]
    sub_truths = [truth_of[x.id] for x in sub]
    runs = {}
    for flag, path in (("--sam", sam), ("--bam", bam)):
        runs[flag] = reentry_run(tmp, f"reentry{flag[1:]}", sub, sub_truths,
                                 flag, path, device)
    if runs["--sam"][1] != runs["--bam"][1]:
        raise AssertionError("phase 15: -m sam and -m bam outputs differ")
    wall, files, acc = runs["--sam"]
    n_out = files["untrimmed.fq"].count(b"\n") // 4
    before = acc["identity_before"]["mean"]
    after = acc["identity_after"]["mean"]
    if acc["n_scored"] != n_out or not after > before:
        raise AssertionError(f"phase 15: {acc['n_scored']} of {n_out} "
                             f"scored, identity {before} -> {after}")
    ref = os.path.join(tmp, "refs.fq")
    write_inputs(tmp, "refs", kept, [])
    shutil.copy(os.path.join(tmp, "refs.long.fq"), ref)
    tsv = os.path.join(tmp, "vars.tsv")
    t0 = time.monotonic()
    if tools.main(["sam2cns", "--variants", "--device", device, sam, ref,
                   tsv]):
        raise AssertionError("phase 15: sam2cns --variants failed")
    var_s = time.monotonic() - t0
    with open(tsv) as fh:
        var_rows = sum(1 for _ in fh)
    bases = sum(len(x) for x in sub)
    return dict(
        long_reads=len(kept), mapped_reads=len(sub), records=n_rec,
        dumped=n_dump, mapping_s=map_s, convert_s=convert_s,
        sam_bytes=os.path.getsize(sam), bam_bytes=os.path.getsize(bam),
        sam_wall_s=wall, bam_wall_s=runs["--bam"][0],
        reentry_bases_per_s=bases / wall, identity_before=before,
        identity_after=after, n_scored=acc["n_scored"],
        variants_s=var_s, variant_rows=var_rows)


# --------------------------------------------------------------------------
# phases 3 (serve twin), 16 and 17: serving and the fleet
# --------------------------------------------------------------------------

def validate_artifacts(label, trace=None, metrics=None, qc=None, truth=None,
                       min_coverage=0.95):
    """The port's own validators (``obs/validate.py``) on a run's
    artifacts; a ``ValidationError`` ends the phase. Returns their
    summaries (the QC aggregate left out)."""
    from proovread_tpu_torch.obs import validate as v
    out = {}
    if trace is not None:
        out["trace"] = v.validate_trace(trace, min_coverage=min_coverage)
    if metrics is not None:
        out["metrics"] = v.validate_metrics(
            metrics, require=("reads_processed", "resilience_demotions"))
    if qc is not None:
        out["qc"] = {k: x for k, x in v.validate_qc(qc).items()
                     if k != "aggregate"}
    if truth is not None:
        out["truth"] = v.validate_truth_sidecar(truth, min_reads=1)
    return out


def device_busy(fn):
    """(fn's result, its wall s, device busy s): ``torch.profiler``'s CUDA
    activity over ``fn`` (every kernel and copy of every thread); the wall
    leaves out the profiler's own start and stop."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():          # a rehearsal on the CPU
        t0 = time.monotonic()
        out = fn()
        return out, time.monotonic() - t0, 0.0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    evs = prof.key_averages()
    attr = ("self_device_time_total" if evs and hasattr(
        evs[0], "self_device_time_total") else "self_cuda_time_total")
    busy = sum(getattr(e, attr) for e in evs
               if e.device_type == DeviceType.CUDA) / 1e6
    return out, wall, busy


SERVE_LOG = "serve.log"


class ServeTwin:
    """Phase 3's serve twin: ``python -m proovread_tpu_torch serve`` as a
    subprocess on ``device`` with config 4's short reads, its long reads
    submitted over the socket as one job (one wave), every verb asked; then a
    drain, a clean exit and an SLO artifact the port's ``validate_slo``
    accepts with ``require_drained``. ``run`` drives it on this thread;
    ``start`` on a background one (the CPU twin, at low priority beside
    the card phases), ``join`` waits for it. ``results``: job id -> the
    ``result`` payload."""

    def __init__(self, tmp, device, longs, srs, n_iterations):
        self.tmp, self.device = os.path.join(tmp, device), device
        os.makedirs(self.tmp, exist_ok=True)
        self.sock = os.path.join(self.tmp, "serve.sock")
        self.slo = os.path.join(self.tmp, "slo.json")
        sp = write_inputs(self.tmp, "twin", [], srs)[1]
        self.argv = [sys.executable, "-m", "proovread_tpu_torch", "serve",
                     "-s", sp, "--socket", self.sock, "--state-dir",
                     os.path.join(self.tmp, "state"), "--slo-out", self.slo,
                     "--qc", "--n-iterations", str(n_iterations),
                     "--device", device]
        self.jobs = [("config4", "t0", longs)]
        self.results, self.error, self.thread = {}, None, None
        self.wall = self.slo_stats = None

    def run(self) -> None:
        from proovread_tpu_torch.obs.validate import validate_slo
        from proovread_tpu_torch.serve.protocol import ServeClient
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        cmd = list(self.argv)
        if self.device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
            cmd = ["nice", "-n", "19"] + cmd
        t0 = time.monotonic()
        with open(os.path.join(self.tmp, SERVE_LOG), "w") as err:
            proc = subprocess.Popen(cmd, cwd=here, env=env,
                                    stdout=subprocess.DEVNULL, stderr=err)
            try:
                while not os.path.exists(self.sock):
                    if proc.poll() is not None:
                        raise AssertionError(f"serve on {self.device} "
                                             f"exited {proc.returncode}")
                    if time.monotonic() - t0 > 300:
                        raise AssertionError("serve never listened")
                    time.sleep(0.1)
                with ServeClient(self.sock, timeout=600) as c:
                    if not c.ping()["ok"]:
                        raise AssertionError("serve: ping failed")
                    for jid, tenant, recs in self.jobs:
                        r = c.submit(jid, tenant, recs)
                        if r["status"] != "accepted":
                            raise AssertionError(f"serve: {jid} {r}")
                        st = c.wait(jid, timeout=1200, poll_s=0.1)
                        if st["status"] != "completed":
                            raise AssertionError(f"serve: {jid} {st}")
                        self.results[jid] = c.result(jid)
                    if c.cancel(self.jobs[0][0]).get("note") != \
                            "already terminal":
                        raise AssertionError("serve: cancel op broken")
                    if (c.stats()["slo"]["jobs"]["completed"]
                            != len(self.jobs)):
                        raise AssertionError("serve: stats op broken")
                    c.drain()
                if proc.wait(timeout=600) != 0:
                    raise AssertionError(f"serve on {self.device} drained "
                                         f"with exit {proc.returncode}")
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        self.wall = time.monotonic() - t0
        self.slo_stats = validate_slo(self.slo, require_drained=True)

    def _run_caught(self) -> None:
        try:
            self.run()
        except Exception as e:                          # noqa: BLE001
            self.error = e

    def start(self) -> None:
        import threading
        self.thread = threading.Thread(target=self._run_caught, daemon=True)
        self.thread.start()

    def join(self) -> None:
        self.thread.join(timeout=1200)
        if self.thread.is_alive() or self.error is not None:
            with open(os.path.join(self.tmp, SERVE_LOG)) as fh:
                tail = fh.read()[-3000:]
            raise AssertionError(f"serve twin on {self.device}: "
                                 f"{self.error or 'no end'}\n{tail}")


def hold_serve_twin(card, cpu) -> dict:
    """The card twin's job results byte for byte the CPU twin's."""
    for jid, _, _ in card.jobs:
        a, b = card.results[jid], cpu.results[jid]
        if json.dumps(a, sort_keys=True) != json.dumps(b, sort_keys=True):
            diff = [k for k in a if a[k] != b.get(k)]
            raise AssertionError(f"serve twin {jid}: card and CPU differ "
                                 f"in {diff}")
    return dict(jobs=len(card.jobs),
                reads=sum(len(r["untrimmed"]) for r in card.results.values()),
                card_s=card.wall, cpu_s=cpu.wall,
                slo_jobs=card.slo_stats["jobs"])


# phase 16's traffic: eight jobs each of clr, ccs and unitig, so ordered
# that job 3 (the drill's deadline fault) is the first unitig job, the
# head of its wave when the queue reaches it: it expires in the queue and
# its reads never enter a bucket beside another job's
PHASE16_MODES = ("clr", "ccs", "clr", "unitig", "ccs", "unitig") * 4


def phase16(tmp, srs, genome_size=1_250_000, device="cuda", n_jobs=24,
            reads_per_job=(9, 11), mean_len=5000, min_len=2000,
            batch_reads=64, n_iterations=6):
    """Serving at full width: ``simulate_job_stream`` on phase 4's genome
    (eight jobs each of clr, ccs and unitig from two tenants, reads of
    2-15 kb, ~2 Mb of long-read bases) through ``CorrectionServer`` over
    its socket (``serve/smoke.py:envelope``: the reference smoke's five job
    faults, a drain after one bucket, a resume on the same state dir, both
    SLOs valid) against ``srs`` (phase 4's short reads), each tenant's
    quota raised to every job it sends. Holds: every job
    terminal with the drill's expected status; each completed clr job's
    untrimmed and trimmed records (as the wire returns them) those of one
    batch ``Pipeline.run`` of the reads of the wave that completed it; no
    CUDA tensor left once the servers are gone. Returns what it logs."""
    from dataclasses import replace
    from proovread_tpu_torch.io.simulate import (random_genome,
                                                 simulate_job_stream)
    from proovread_tpu_torch.obs.memory import LeakCheck
    from proovread_tpu_torch.pipeline import driver as drv
    from proovread_tpu_torch.pipeline.trim import pieces_of
    from proovread_tpu_torch.serve import batcher, smoke
    from proovread_tpu_torch.serve.admission import TenantQuota
    from proovread_tpu_torch.serve.protocol import encode_records
    genome = random_genome(genome_size, seed=0)
    _, jobs = simulate_job_stream(
        seed=16, n_jobs=n_jobs, genome=genome,
        modes=PHASE16_MODES[:n_jobs], reads_per_job=reads_per_job,
        mean_len=mean_len, min_len=min_len)
    bases = {j.job_id: j.n_bases for j in jobs}
    lens = [len(r) for j in jobs for r in j.records]
    r = dict(jobs=len(jobs), reads=len(lens), bases=sum(bases.values()),
             read_len_min=min(lens), read_len_max=max(lens),
             modes={m: sum(j.mode == m for j in jobs)
                    for m in ("clr", "ccs", "unitig")})
    cfg = drv.PipelineConfig(n_iterations=n_iterations,
                             batch_reads=batch_reads, device=device)
    # every wave attempt's jobs (a retried or resumed wave runs only those
    # not yet terminal, so a job's journaled wave index alone does not give
    # the reads beside it) and the attempt that completed each job
    attempts, done_in = [], {}
    orig_run_wave = batcher.WaveRunner.run_wave

    def run_wave(self, wave_idx, wave_jobs, finalize):
        k = len(attempts)
        attempts.append(list(wave_jobs))
        try:
            return orig_run_wave(self, wave_idx, wave_jobs, finalize)
        finally:
            for j in wave_jobs:
                if j.status == "completed":
                    done_in.setdefault(j.job_id, k)

    leak = LeakCheck()
    batcher.WaveRunner.run_wave = run_wave
    try:
        out, wall, busy = device_busy(lambda: smoke.envelope(
            srs, jobs, cfg, tmp, max_wave_jobs=8, timeout=900,
            quota=TenantQuota(max_jobs=n_jobs, max_bases=8_000_000)))
    finally:
        batcher.WaveRunner.run_wave = orig_run_wave
    gc.collect()
    lrep = leak.report()
    if lrep["leaked_bytes"] > 1 << 20:
        raise AssertionError(f"phase 16: CUDA tensors left after the "
                             f"servers: {lrep}")
    done_bases = sum(bases[j] for j, s in out["status"].items()
                     if s == "completed")
    r.update(wall_s=wall, phase1_s=out["wall1_s"], phase2_s=out["wall2_s"],
             completed_bases=done_bases, bases_per_s=done_bases / wall,
             device_busy_s=busy, device_busy_share=busy / wall,
             waves=out["waves"], status=out["status"],
             rejected=out["rejected"], slo1_jobs=out["slo1"]["jobs"],
             slo2_jobs=out["slo2"]["jobs"],
             latency={c: (x["count"], x["p50_s"], x["p99_s"])
                      for c, x in out["slo2"]["latency"].items()},
             compile=out["slo2"]["compile"], leak=lrep)
    # the batch runs: one for each wave attempt that completed clr jobs, of
    # the reads that attempt ran (a ccs job's collapsed reads)
    by_run = {}
    for j in jobs:
        if j.mode == "clr" and out["status"].get(j.job_id) == "completed":
            by_run.setdefault(done_in.get(j.job_id), []).append(j)
    if None in by_run or not by_run:
        raise AssertionError("phase 16: a clr job completed outside a wave, "
                             "or none completed")
    held = 0
    for idx, js in sorted(by_run.items()):
        wave_jobs = attempts[idx]
        union = [x for w in wave_jobs for x in
                 (w.ccs_records if w.mode == "ccs" else w.records)]
        res = drv.Pipeline(replace(
            cfg, mode=batcher.BASE_MODE[wave_jobs[0].mode],
            fault_spec="")).run(union, srs)
        for j in js:
            ids = {x.id for x in j.records}
            got = out["results"][j.job_id]
            if (got["untrimmed"] != encode_records(pieces_of(res.untrimmed,
                                                             ids))
                    or got["trimmed"] != encode_records(
                        pieces_of(res.trimmed, ids))):
                raise AssertionError(f"phase 16: job {j.job_id} differs "
                                     f"from the batch run of wave attempt "
                                     f"{idx}")
            held += 1
    r.update(batch_runs=len(by_run), clr_jobs_held=held,
             wave_runs=len(attempts))
    return r


def phase17(device="cuda", kill="replica_death@r1.j5"):
    """The fleet on one card: ``obs/load.run_smoke`` with the ``slam``
    scenario (two in-process replicas, poison jobs, every family; replica
    1 killed at dispatch ordinal 5, its journal handed off), fleet
    accuracy scored on ``device``. Holds: the smoke's checks, a handoff,
    no job lost or counted twice (the LOAD row passed the port's
    ``validate_load`` in ``build_row``: its three accounting identities;
    every routed job completed), the row's backend ``device``. Returns
    what it logs."""
    from proovread_tpu_torch.obs import load
    from proovread_tpu_torch.obs.memory import LeakCheck
    from proovread_tpu_torch.obs.validate import validate_load
    leak = LeakCheck()
    (ok, rows), wall, busy = device_busy(lambda: load.run_smoke(
        n_replicas=2, pipeline_config=load.smoke_config(device), kill=kill,
        overload=False))
    # the smoke's own leak check passed; the tensors left, by example
    lrep = leak.report()
    if not ok or len(rows) != 1:
        raise AssertionError("phase 17: the fleet smoke failed (its lines "
                             "above name the check)")
    row = rows[0]
    validate_load(row, where="phase 17 LOAD row")
    jb = row["jobs"]
    if (row["backend"] != device or jb["handoffs"] < 1
            or jb["orphaned"] or jb["failed"] or jb["expired"]
            or jb["completed"] != jb["routed"]):
        raise AssertionError(f"phase 17: jobs {jb}, backend "
                             f"{row['backend']}")
    return dict(wall_s=wall, row_wall_s=row["wall_s"],
                bases_per_s_fleet=row["bases_per_sec_fleet"],
                device_busy_s=busy, device_busy_share=busy / wall,
                jobs=jb, handoff=row["handoff"],
                rejections=row["rejections"],
                latency={c: (x["count"], x["p50_s"], x["p99_s"])
                         for c, x in row["latency"].items()},
                accuracy=row["accuracy"], heartbeat=row["heartbeat"],
                compile=row["compile"], leak=lrep, row=row)


# phase 18's workload: the shard-exact family at E.coli-class depth, 640
# reads of 8,000 bases (5.12 Mb), each with 2,400 100 bp short reads (30x)
MESH18 = dict(seed=18, n_long=640, read_len=8000, sr_per=2400)
# a shard's candidate cap in phase 18, in chunks of 8192: the default of 2
# (the reference's) overflows at this depth (a pass probes ~100,000
# candidates a shard) and every bucket would retreat to one device
MESH18_CHUNKS = 32


def write_mesh_workload(path: str, n_long: int = MESH18["n_long"]) -> None:
    """Simulate phase 18's workload (``simulate_independent_segments``,
    ~30 s of host Python) and save it compactly to ``path`` (npz: the
    reads' ASCII and lengths, the truths), so that each process that runs
    it rebuilds the records in seconds instead of simulating again."""
    from proovread_tpu_torch.io.simulate import simulate_independent_segments
    longs, srs, truths = simulate_independent_segments(
        **dict(MESH18, n_long=n_long), with_truth=True)
    ascii_ = lambda rs: np.frombuffer(  # noqa: E731
        "".join(r.seq for r in rs).encode(), np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, long_ascii=ascii_(longs),
             long_len=np.array([len(r) for r in longs], np.int64),
             truth=np.concatenate(truths),
             truth_len=np.array([len(t) for t in truths], np.int64),
             sr_ascii=ascii_(srs).reshape(len(srs), -1))
    os.replace(tmp, path)


def read_mesh_workload(path: str):
    """(longs, srs, truth map) of ``write_mesh_workload``'s file: the
    records ``simulate_independent_segments`` returns, rebuilt."""
    from proovread_tpu_torch.io.records import SeqRecord
    d = np.load(path)
    ends = np.cumsum(d["long_len"])
    text = d["long_ascii"].tobytes().decode()
    longs = [SeqRecord(f"r{i}", text[e - n:e])
             for i, (n, e) in enumerate(zip(d["long_len"], ends))]
    tends = np.cumsum(d["truth_len"])
    truth = {r.id: d["truth"][e - n:e]
             for r, n, e in zip(longs, d["truth_len"], tends)}
    sr = d["sr_ascii"]
    w = sr.shape[1]
    text = sr.tobytes().decode()
    srs = [SeqRecord(f"s{j}", text[j * w:(j + 1) * w],
                     qual=np.full(w, 30, np.uint8))
           for j in range(sr.shape[0])]
    return longs, srs, truth


class MeshWorkload:
    """``write_mesh_workload`` in a process of its own, started early so
    that the file is there when phase 18 starts."""

    def __init__(self, n_long: int = MESH18["n_long"]):
        import multiprocessing as mp
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
        self.path = os.path.join(self.tmp, "mesh18.npz")
        self.proc = mp.get_context("spawn").Process(
            target=write_mesh_workload, args=(self.path, n_long))
        self.proc.start()

    def wait(self) -> str:
        self.proc.join(timeout=900)
        if self.proc.exitcode != 0:
            raise AssertionError(f"phase 18's workload: exit "
                                 f"{self.proc.exitcode}")
        return self.path

    def close(self) -> None:
        if self.proc.exitcode is None:
            self.proc.kill()
            self.proc.join()
        shutil.rmtree(self.tmp, ignore_errors=True)


def first_diffs(a, b, path="", out=None, limit=8):
    """Up to ``limit`` (path, a's value, b's value) where two nested
    structures of dicts, lists and leaves differ."""
    out = [] if out is None else out
    if len(out) >= limit:
        return out
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            if a.get(k) != b.get(k):
                first_diffs(a.get(k), b.get(k), f"{path}/{k}", out, limit)
    elif (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
          and len(a) == len(b)):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                first_diffs(x, y, f"{path}[{i}]", out, limit)
    elif a != b:
        out.append((path, a, b))
    return out


def mesh_rank18(path, config, kernels):
    """Rank function of phase 18's mesh run: the workload rebuilt from its
    file on every rank, then ``parallel/smoke.pipeline_on_ranks``."""
    from proovread_tpu_torch.parallel import smoke
    longs, srs, truth = read_mesh_workload(path)
    return smoke.pipeline_on_ranks(longs, srs, truth, config, kernels)


def phase18(path, device="cuda", n_ranks=2, chunks=MESH18_CHUNKS,
            drill=True, **cfg):
    """More than one GPU: phase 18's workload (``path``) through
    ``Pipeline.run`` once on one device and once at ``mesh_shards=2``
    with 2 ranks (``parallel/launch.py``; on one card the two share it),
    both scored against the truth. Holds: the corrected and trimmed
    records and the QC aggregate, identity scores included, byte for byte;
    bsw v2, the bit-plane pileup, assemble and HCR launched in every rank;
    no demotion. Then (``drill``) the mesh fault drill with 4 ranks
    (``parallel/smoke.drill``). Returns what it logs."""
    from proovread_tpu_torch.align import bsw
    from proovread_tpu_torch.obs.accuracy import IDENTITY_FLOOR
    from proovread_tpu_torch.ops import assemble_kernel, pileup_kernel
    from proovread_tpu_torch.parallel import smoke
    from proovread_tpu_torch.parallel.launch import launch
    from proovread_tpu_torch.pipeline.driver import PipelineConfig
    path_kernels = (bsw.bsw_expand_v2, pileup_kernel.pileup_accumulate_bits,
                    assemble_kernel.assemble_rows,
                    assemble_kernel.hcr_mask_rows)
    t0 = time.monotonic()
    longs, srs, truth = read_mesh_workload(path)
    bases = sum(len(r) for r in longs)
    log(f"phase18 workload: {len(longs)} long reads ({bases} bases), "
        f"{len(srs)} short reads, rebuilt in {time.monotonic() - t0:.1f} s")
    config = PipelineConfig(device=device, **cfg)
    t0 = time.monotonic()
    agg, recs, res = smoke.run(longs, srs, truth, config=config)
    wall1 = time.monotonic() - t0
    no_demotion("phase 18 one device", res.metrics, res.reports)
    passes1 = [(r.task, r.masked_frac, r.n_candidates) for r in res.reports]
    one = (smoke.records_of(res.untrimmed), smoke.records_of(res.trimmed))
    del longs, srs, truth, res
    gc.collect()
    mesh_cfg = PipelineConfig(device=device, mesh_shards=n_ranks,
                              mesh_chunks_per_shard=chunks, **cfg)
    t0 = time.monotonic()
    mesh = launch(n_ranks, mesh_rank18, path, mesh_cfg, path_kernels,
                  device=device, timeout=900)
    wall_launch = time.monotonic() - t0
    if (mesh["agg"] != agg or mesh["recs"] != recs
            or (mesh["untrimmed"], mesh["trimmed"]) != one):
        raise AssertionError(
            "phase 18: the mesh run differs from one device's: "
            f"{json.dumps(first_diffs(one, (mesh['untrimmed'], mesh['trimmed'])), default=str)[:1500]}; "
            f"aggregate {json.dumps(first_diffs(json.loads(agg), json.loads(mesh['agg'])), default=str)[:1500]}; "
            f"QC records {json.dumps(first_diffs(recs, mesh['recs']), default=str)[:3000]}; "
            f"one device's passes {passes1}; the mesh's {mesh['passes']}")
    if mesh["notes"]:
        raise AssertionError(f"phase 18: the mesh run demoted: "
                             f"{mesh['notes']}")
    passes = sum(s["value"] for s in mesh["metrics"]["counters"]
                 ["mesh_passes"]["series"])
    # (kernels launch on the card only: on the CPU every count stays 0)
    idle = [(r, k) for r, counts in enumerate(mesh["launches"])
            for k, v in counts.items() if v == 0 and device == "cuda"]
    if not passes or idle:
        raise AssertionError(f"phase 18: mesh passes {passes}; kernels "
                             f"that did not launch (rank, kernel): {idle}")
    acc = json.loads(agg)["accuracy"]
    out = dict(reads=len(one[0]), bases=bases, wall_one_s=wall1,
               wall_mesh_s=mesh["wall"], wall_mesh_launch_s=wall_launch,
               bases_per_s_one=bases / wall1,
               bases_per_s_mesh=bases / mesh["wall"],
               identity_before=acc["identity_before"]["mean"],
               identity_after=acc["identity_after"]["mean"],
               n_scored=acc["n_scored"], mesh_passes=passes,
               launches_by_rank=mesh["launches"])
    if out["n_scored"] != out["reads"] or not (
            out["identity_after"] >= IDENTITY_FLOOR
            and out["identity_after"] > out["identity_before"]):
        raise AssertionError(f"phase 18: scoring {acc}")
    if drill:
        t0 = time.monotonic()
        out["drill"] = smoke.drill(device)
        out["drill_s"] = time.monotonic() - t0
    return out


# --------------------------------------------------------------------------
# phase 19: the kernel build's own account
# --------------------------------------------------------------------------

# the roofline rows phase 19 must show with a share of the card's peak:
# PERF.md rows 1-4, the main path's kernels
ROOFLINE_ROWS = ("bsw_expand_v2", "pileup_accumulate_bits", "assemble_rows",
                 "hcr_mask_rows")

PROFILED_RUN = """
import sys
sys.path.insert(0, {here!r})
import chip_smoke
chip_smoke.profiled_run({out!r}, {cache!r}, {shape!r}, {device!r})
"""


def kernel_entries() -> dict:
    """Each kernel entry's public wrapper (the counts live on it), by
    name."""
    from proovread_tpu_torch import kernels
    from proovread_tpu_torch.align import bsw, sw
    from proovread_tpu_torch.obs import accuracy
    from proovread_tpu_torch.ops import assemble_kernel, pileup_kernel
    from proovread_tpu_torch.ops import scatter
    mods = (bsw, sw, accuracy, assemble_kernel, pileup_kernel, scatter)
    return {name: next(getattr(m, name) for m in mods if hasattr(m, name))
            for name in kernels.ENTRY_SOURCES}


def result_digest(res) -> str:
    """A digest of ``result_key(res)``: what two runs' results are held
    equal on."""
    import hashlib
    return hashlib.sha256(repr(result_key(res)).encode()).hexdigest()


def profiled_run(out, cache, shape, device="cuda"):
    """Phase 19's profiled run, in a fresh process (the kernel library
    not loaded yet): phase 4's workload (``shape``: genome, long-read
    bases, iterations) through ``Pipeline.run`` under the profiler, a span
    tracer and a compile ledger, the kernel build directory the empty
    ``cache``, so the build lands inside the run. Writes into ``out`` the
    trace, the ledger and ``profiled.json``: the result's digest, the
    wall, the profiler's records, the ``kernel_flops_total`` series, each
    kernel's launches, the roofline and the ``nvcc`` compiles."""
    from proovread_tpu_torch import kernels, obs
    from proovread_tpu_torch.obs import compilecache, profile
    longs, srs, n_it, _ = workload(shape[0], shape[1], shape[2])
    fns = kernel_entries()
    for f in fns.values():
        f.launches = 0
    compilecache.enable_persistent_cache(cache)
    with obs.tracing() as tr, profile.profiling() as prof, \
            compilecache.scope(compilecache.Ledger(backend=device)):
        res, wall = run_pipeline(longs, srs, n_it, device)
        led = compilecache.current()
    tr.write_chrome(os.path.join(out, "trace.jsonl"))
    led.write_jsonl(os.path.join(out, "ledger.jsonl"))
    series = {s["labels"]["fn"]: s["value"] for s in
              res.metrics["counters"]["kernel_flops_total"]["series"]}
    records = {n: dict(r.as_dict(), launch_flops=r.launch_flops,
                       rate=r.rate) for n, r in prof.records.items()}
    with open(os.path.join(out, "profiled.json"), "w") as fh:
        json.dump(dict(digest=result_digest(res), wall=wall,
                       records=records, flops_series=series,
                       launches={n: f.launches for n, f in fns.items()},
                       roofline=profile.roofline_lines(prof),
                       nvcc_compiles=kernels.nvcc_compiles,
                       compile_census=res.compile_census), fh)


def hold_profiled(prof_dir) -> dict:
    """Phase 19's profiled run held: its ledger valid and reconciling with
    its trace, the build inside the run (one build window, ``nvcc`` ran);
    per kernel entry, ``kernel_flops_total`` equal to the cost models'
    sum over the calls that launched, and the profiler's launches equal
    to ``kernels.count_launch``'s; rows 1-4 launched, with a share of the
    card's peak in the roofline."""
    from proovread_tpu_torch.obs.validate import (reconcile_compile_ledger,
                                                  validate_compile_ledger)
    with open(os.path.join(prof_dir, "profiled.json")) as fh:
        p = json.load(fh)
    ledger = os.path.join(prof_dir, "ledger.jsonl")
    lstats = validate_compile_ledger(ledger)
    rstats = reconcile_compile_ledger(ledger,
                                      os.path.join(prof_dir, "trace.jsonl"))
    census = lstats["census"]
    if census["backend_compiles"] != 1 or census["persistent_misses"] != 1 \
            or p["nvcc_compiles"] < 1 or rstats["trace_ms"] <= 0:
        raise AssertionError(f"phase 19: the build did not land inside the "
                             f"profiled run: {census} {rstats}")
    for name, rec in p["records"].items():
        if rec["rate"] is None:
            continue
        if not (p["flops_series"].get(name, 0.0) == rec["flops"]
                == rec["launch_flops"]) or \
                rec["launches"] != p["launches"][name]:
            raise AssertionError(f"phase 19: {name}: kernel_flops_total "
                                 f"{p['flops_series'].get(name)}, record "
                                 f"{rec}, launches {p['launches'][name]}")
    for name in ROOFLINE_ROWS:
        line = next((ln for ln in p["roofline"] if ln.startswith(name)), "")
        if not p["launches"][name] or " f32 " not in f" {line} " \
                and " bytes " not in f" {line} ":
            raise AssertionError(f"phase 19: no share of the peak for "
                                 f"{name}: {line!r}")
    for line in p["roofline"]:
        log(f"phase19 roofline {line}")
    return dict(digest=p["digest"], wall_s=p["wall"], ledger=rstats,
                census={k: census[k] for k in (
                    "n_programs", "calls", "backend_compiles",
                    "backend_compile_s", "persistent_hit_rate")},
                launches={k: p["launches"][k] for k in ROOFLINE_ROWS},
                records={k: p["records"][k] for k in ROOFLINE_ROWS})


def damaged_copies(tmp, art) -> dict:
    """Two copies of the artifact, one cache file truncated and one with
    its manifest's version edited: each must be refused; the messages."""
    from proovread_tpu_torch.obs import boot
    from proovread_tpu_torch.obs.validate import ValidationError
    out = {}
    for damage in ("torn", "stale"):
        bad = os.path.join(tmp, f"art_{damage}")
        shutil.copytree(art, bad)
        manifest_path = os.path.join(bad, "manifest.json")
        with open(manifest_path) as fh:
            m = json.load(fh)
        if damage == "torn":
            lib = os.path.join(bad, "cache", m["programs"][0]["cache_key"])
            with open(lib, "r+b") as fh:
                fh.truncate(os.path.getsize(lib) // 2)
        else:
            m["version"] = "0" * len(m["version"])
            with open(manifest_path, "w") as fh:
                json.dump(m, fh)
        try:
            boot.verify_artifact(bad)
        except ValidationError as e:
            out[damage] = str(e)[-160:]
        else:
            raise AssertionError(f"phase 19: a {damage} artifact verified")
    return out


def xprof_run(tmp, art) -> dict:
    """Config 4 through the command line on the card, in fresh processes:
    once plain, once with ``--trace --xprof --compile-ledger
    --compile-cache`` (a verified copy of the artifact): the five files
    equal; the ledger valid, reconciling with the trace, its one build
    window a cache hit; the profiler's trace naming the port's CUDA
    kernels and the span ranges."""
    from proovread_tpu_torch.obs import boot
    from proovread_tpu_torch.obs.validate import (reconcile_compile_ledger,
                                                  validate_compile_ledger)
    here = os.path.dirname(os.path.abspath(__file__))
    longs, srs, _, _ = workload(10_000, 40_000, 4)
    argv = input_args(tmp, "xprof", longs, srs)
    copy = os.path.join(tmp, "xprof_cache")
    boot.fetch_artifact(art, copy)
    f = {k: os.path.join(tmp, v) for k, v in (
        ("trace", "x.trace.jsonl"), ("xprof", "xprof"),
        ("ledger", "x.ledger.jsonl"))}
    outs, walls = {}, {}
    for label, extra in (("plain", []), ("flags", [
            "--trace", f["trace"], "--xprof", f["xprof"],
            "--compile-ledger", f["ledger"], "--compile-cache", copy])):
        out = os.path.join(tmp, f"xprof_{label}", "res")
        t0 = time.monotonic()
        proc = subprocess.run([sys.executable, "-m", "proovread_tpu_torch",
                               *argv, "-p", out, "-q", *extra], cwd=here,
                              capture_output=True, text=True, timeout=600)
        walls[label] = time.monotonic() - t0
        if proc.returncode != 0:
            raise AssertionError(f"phase 19 cli {label}: exit "
                                 f"{proc.returncode}\n{proc.stderr[-3000:]}")
        outs[label] = cli_outputs(out)[0]
    if outs["plain"] != outs["flags"]:
        raise AssertionError("phase 19: --trace --xprof --compile-ledger "
                             "--compile-cache changed the outputs")
    census = validate_compile_ledger(f["ledger"])["census"]
    rstats = reconcile_compile_ledger(f["ledger"], f["trace"])
    if census["persistent_hits"] != 1 or census["persistent_misses"]:
        raise AssertionError(f"phase 19 cli: the library did not load from "
                             f"the artifact's copy: {census}")
    (trace_file,) = os.listdir(f["xprof"])
    with open(os.path.join(f["xprof"], trace_file)) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    kernels_seen = sorted({m.group(1) for n in names
                           for m in [PORT_KERNEL.search(n)] if m})
    spans = sorted(n for n in names if n.split(":")[0] in
                   ("run", "bucket", "pass", "mode", "task", "kernel"))
    if not kernels_seen or "bucket:bucket" not in spans:
        raise AssertionError(f"phase 19: the --xprof trace names kernels "
                             f"{kernels_seen} and spans {spans[:20]}")
    return dict(walls_s=walls, kernels=kernels_seen, spans=len(spans),
                ledger=rstats, census_hit_rate=census["persistent_hit_rate"])


def serve_from_artifact(tmp, art) -> dict:
    """``python -m proovread_tpu_torch serve --boot-from-artifact`` on the
    card with config 4's short reads, its long reads as one job
    (``ServeTwin``): it boots, answers, drains clean; its ``boot.json`` a
    valid artifact-mode BOOT row whose one build window (the library's
    load) is a cache hit, no violation."""
    from proovread_tpu_torch.obs.validate import validate_boot_row
    longs, srs, n_it, _ = workload(10_000, 40_000, 4)
    twin = ServeTwin(tmp, "cuda", longs, srs, n_it)
    twin.argv += ["--boot-from-artifact", art]
    twin.run()
    with open(os.path.join(twin.tmp, "state", "boot.json")) as fh:
        row = json.loads(fh.readline())
    validate_boot_row(row)
    if row["violations"] or row["persistent_misses"] \
            or row["hit_rate"] != 1.0:
        raise AssertionError(f"phase 19 serve: boot row {row}")
    return dict(wall_s=twin.wall, boot=row, jobs=len(twin.results),
                slo=twin.slo_stats)


def phase19(tmp, shape=(1_250_000, 5_000_000, 6)) -> dict:
    """The kernel build's own account on the card: a kernel-build artifact
    built, valid and verified (damaged copies refused); a cold and an
    artifact boot measured (``obs/boot.py run``: subprocesses); phase 4's
    workload profiled in a fresh process from the start (``profiled_run``,
    beside the rest), the build inside it; ``--xprof`` on config 4; a
    server booted from the artifact. Fails on any check."""
    from proovread_tpu_torch.analysis import factory
    from proovread_tpu_torch.obs import boot
    from proovread_tpu_torch.obs.validate import validate_manifest
    here = os.path.dirname(os.path.abspath(__file__))
    prof_dir = os.path.join(tmp, "profiled")
    os.makedirs(prof_dir)
    prof_log = open(os.path.join(tmp, "profiled.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", PROFILED_RUN.format(
            here=here, out=prof_dir, cache=os.path.join(tmp, "cold_cache"),
            shape=tuple(shape), device="cuda")],
        cwd=here, stdout=prof_log, stderr=subprocess.STDOUT)
    out = {}
    try:
        art = os.path.join(tmp, "art")
        t0 = time.monotonic()
        manifest = factory.build_artifact(art, fresh=True)
        out["artifact"] = dict(
            build_s=round(time.monotonic() - t0, 3),
            version=manifest["version"], files=manifest["files"],
            nvcc_ms={p["entry"]: p["compile_ms"]
                     for p in manifest["programs"]},
            toolchain=manifest["jax_version"])
        validate_manifest(manifest)
        boot.verify_artifact(art)
        out["refused"] = damaged_copies(tmp, art)
        rows = boot.run(art, ("cold", "artifact"))
        (cold, crep), (warm, wrep) = rows
        if cold["n_backend_compiles"] < 1 or crep["nvcc_compiles"] < 1:
            raise AssertionError(f"phase 19: the cold boot built nothing: "
                                 f"{cold}")
        if wrep["nvcc_compiles"] or warm["violations"] \
                or warm["hit_rate"] != 1.0:
            raise AssertionError(f"phase 19: the artifact boot: {warm}, "
                                 f"{wrep['nvcc_compiles']} nvcc compiles")
        out["boot_rows"] = [row for row, _ in rows]
        out["boot"] = {row["mode"]: dict(
            wall_s=row["boot_wall_s"], import_s=rep["import_s"],
            context_s=rep["context_s"], build_window_s=row["compile_s"],
            nvcc_compiles=rep["nvcc_compiles"], hit_rate=row["hit_rate"],
            violations=len(row["violations"])) for row, rep in rows}
        out["xprof"] = xprof_run(tmp, art)
        out["serve"] = serve_from_artifact(tmp, art)
    finally:
        try:
            rc = proc.wait(timeout=900)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            prof_log.close()
    if rc != 0:
        with open(prof_log.name) as fh:
            raise AssertionError(f"phase 19 profiled run: exit {rc}\n"
                                 f"{fh.read()[-3000:]}")
    out["profiled"] = hold_profiled(prof_dir)
    return out


# phase 20's scored workloads, in the order they run (the JAX package's
# ``ACCURACY_r10.json`` rows, each recorded afresh on the card)
ACCURACY20 = ("4", "3", "dmesh")
# the fields of an ACCURACY row that its scoring gives (``acc_fields``)
SCORE_FIELDS = ("n_scored", "n_classified", "identity_before",
                "identity_after", "errors_before", "errors_after",
                "introduced", "chimera")


def score_fields(row) -> dict:
    return {k: row[k] for k in SCORE_FIELDS}


def dmesh_one_device(tmp, device="cuda") -> dict:
    """The dmesh workload (``obs/accuracy.py``: the mesh drill's
    shard-exact reads with the drill's config) through ``cli.main`` in
    this process on one device, scored: the QC aggregate's scores as an
    ACCURACY row's fields."""
    from proovread_tpu_torch import cli
    from proovread_tpu_torch.obs import accuracy
    longs, srs, truths, _, _, _, cfg = accuracy._workload("dmesh", None)
    inputs = input_args(tmp, "dmesh-one", longs, srs)
    tp = write_truth(tmp, "dmesh-one", longs, truths)
    cfgp = os.path.join(tmp, "dmesh-one.cfg")
    with open(cfgp, "w") as fh:
        json.dump(cfg, fh)
    qc = os.path.join(tmp, "dmesh-one.qc")
    rc = cli.main(inputs + ["-p", os.path.join(tmp, "dmesh-one", "res"),
                            "-m", "sr-noccs", "--truth", tp, "--qc-out", qc,
                            "-c", cfgp, "--device", device])
    if rc != 0:
        raise AssertionError(f"phase 20: dmesh on one device exited {rc}")
    return acc_fields(read_qc(qc)[0]["aggregate"]["accuracy"])


def gate_verdict(label, verdict, pools=()) -> dict:
    """A history gate's verdict: PASS with every pool of ``pools`` in it,
    else fail; its pools and the statuses of its checks."""
    if verdict["verdict"] != "PASS" or not set(pools) <= set(
            verdict["pools"]):
        raise AssertionError(f"phase 20: {label} gate: "
                             + json.dumps(verdict))
    statuses = {}
    for c in verdict["checks"]:
        statuses[c["status"]] = statuses.get(c["status"], 0) + 1
    return dict(verdict=verdict["verdict"], pools=verdict["pools"],
                checks=statuses)


def phase20(tmp, boot_rows=None, art=None, device="cuda") -> dict:
    """The history gates on the card's own rows. ``record_workload``
    (``obs/accuracy.py``) records config 4, config 3 (its 80,000-base
    cap) and dmesh (``--mesh-shards 4``: four gloo ranks on the card) as
    ``cuda`` ACCURACY rows, each a scored command-line subprocess; the
    scoring fields of 3 and 4 must equal ``ACCURACY_r10.json``'s, and
    dmesh's the same workload's on one device (``dmesh_one_device``; the
    port's mesh equals one device), its difference to r10's dmesh row
    logged. Then the gates, each PASS: ``accuracy_check`` over r10 and the
    new rows (the ``cuda`` pools apart from the ``cpu`` ones),
    ``boot_check`` over phase 19's BOOT rows (``boot_rows``), and
    ``compile_check`` over ``COMPILE_r09.json`` and the COMPILE row of one
    warm command-line run of config 4 on a verified copy of phase 19's
    artifact (``art``: ``census.artifact_prewarm_config``). ``load_check``
    over phase 17's LOAD row runs in ``main``, where that row is.
    ``perf_check`` has no card leg: the port writes no bench rows before
    its benchmark. Returns what it logs."""
    from proovread_tpu_torch.obs import accuracy, boot, census
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(tmp, exist_ok=True)
    r10 = {str(r["config"]): r for r in (
        e["row"] for e in accuracy.load_rows(
            [os.path.join(here, "ACCURACY_r10.json")]))}
    out = {"walls": {}, "calls": {}, "rows": {}}
    for wl in ACCURACY20:
        led = os.path.join(tmp, f"ledger_{wl}.jsonl")
        t0 = time.monotonic()
        row = accuracy.record_workload(wl, device=device, ledger_out=led,
                                       run_timeout=900)
        out["walls"][wl] = round(time.monotonic() - t0, 2)
        with open(led) as fh:
            by_entry = json.loads(fh.readline())["census"]["by_entry"]
        # each kernel entry's calls in the run (its compile ledger)
        out["calls"][wl] = {e: v["calls"] for e, v in sorted(
            by_entry.items())}
        if row["backend"] != device:
            raise AssertionError(f"phase 20: workload {wl} ran on "
                                 f"{row['backend']}, not {device}")
        out["rows"][wl] = row
    for wl in ("4", "3"):
        got, want = score_fields(out["rows"][wl]), score_fields(r10[wl])
        if got != want:
            raise AssertionError(f"phase 20: config {wl} scores {got}, "
                                 f"ACCURACY_r10.json {want}")
    t0 = time.monotonic()
    one = dmesh_one_device(tmp, device)
    out["dmesh_one_device_s"] = round(time.monotonic() - t0, 2)
    if score_fields(out["rows"]["dmesh"]) != one:
        raise AssertionError(f"phase 20: dmesh at mesh 4 "
                             f"{score_fields(out['rows']['dmesh'])}, on "
                             f"one device {one}")
    out["dmesh_vs_r10"] = {k: [out["rows"]["dmesh"][k], r10["dmesh"][k]]
                           for k in SCORE_FIELDS
                           if out["rows"]["dmesh"][k] != r10["dmesh"][k]}
    card = os.path.join(tmp, "ACCURACY_card.json")
    with open(card, "w") as fh:
        for wl in ACCURACY20:
            fh.write(json.dumps(out["rows"][wl]) + "\n")
    out["gates"] = {"accuracy": gate_verdict(
        "accuracy", accuracy.accuracy_check(accuracy.load_rows(
            [os.path.join(here, "ACCURACY_r10.json"), card])),
        (f"config3/{device}", f"config4/{device}",
         f"configdmesh/{device}/mesh4"))}
    if boot_rows:
        out["gates"]["boot"] = gate_verdict("boot", boot.boot_check(
            [{"source": "phase19", "row": r} for r in boot_rows]),
            [f"kernels/{device}/cold", f"kernels/{device}/artifact"])
    if art:
        t0 = time.monotonic()
        copy = os.path.join(tmp, "art_copy")
        manifest = boot.fetch_artifact(art, copy)
        row = census.artifact_prewarm_config(4, manifest, copy,
                                             artifact_dir=art, device=device,
                                             run_timeout=900)
        out["compile_row"] = row
        out["compile_s"] = round(time.monotonic() - t0, 2)
        if row["cache_hit_rate"] != 1.0 or row["backend"] != device:
            raise AssertionError(f"phase 20: the warm run {row}")
        out["gates"]["compile"] = gate_verdict(
            "compile", census.compile_check(census.load_rows(
                [os.path.join(here, "COMPILE_r09.json")])
                + [{"source": "phase20", "row": row}]),
            [f"config4/{device}"])
    return out


def same_host(a, b) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


def result_key(res):
    recs = lambda rs: [(r.id, r.seq, r.qual.tobytes(), r.desc)  # noqa: E731
                       for r in rs]
    return (recs(res.untrimmed), recs(res.trimmed), res.ignored,
            res.chimera, res.reports)


# the port's CUDA kernels (csrc/*.cu), by the names the profiler shows
# (a template kernel with its argument: pileup_col_kernel<PackedWords>)
PORT_KERNEL = re.compile(
    r"\b((?:bsw|sw|pileup|assemble|hcr|lcs|scatter)_\w*kernel)\b"
    r"(?:<(?:\(anonymous namespace\)::)?(\w+)>)?")


# the phases that run in lanes (``Lane``) beside the main process's
# phases 7, 11, 9, 10, 14 and 17 (each in the order of ``main``'s code:
# 13, 8, 16; 12, 15, 18; 19, 20): each group depends on nothing the main
# process makes (phase 20 on phase 19's artifact and BOOT rows)
LANES = (("8", "13", "16"), ("12", "15", "18"), ("19", "20"))
ALL_PHASES = tuple(str(p) for p in range(2, 21))


class Lane:
    """Phases run by a second ``chip_smoke.py`` process (``--skip``
    every other phase, ``--lane-out`` its results), started after phase
    6 so that the kernels' times and the main path's run without it. The
    card is busy a few percent of a command-line run's wall, whose host
    work this spreads over the host's cores. Its standard output goes to
    a file that ``join`` prints; its errors to this process's."""

    def __init__(self, phases, skip):
        self.phases = [p for p in phases if p not in skip]
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_lane_")
        self.out = os.path.join(self.tmp, "lane.json")
        self.log = open(os.path.join(self.tmp, "lane.log"), "w")
        here = os.path.dirname(os.path.abspath(__file__))
        others = [p for p in ALL_PHASES if p not in self.phases]
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--skip",
             ",".join(others), "--lane-out", self.out], cwd=here,
            stdout=self.log, stderr=None)

    def join(self) -> dict:
        """Wait for the lane, print its log; raise if it failed; its
        results by phase."""
        rc = self.proc.wait(timeout=1100)
        self.log.close()
        log(f"lane {','.join(self.phases)}: exit {rc} in "
            f"{time.monotonic() - self.t0:.1f} s; its log:")
        with open(self.log.name) as fh:
            for line in fh:
                log(line.rstrip("\n"))
        if rc != 0:
            raise AssertionError(f"lane {self.phases} failed: exit {rc}")
        with open(self.out) as fh:
            return json.load(fh)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def profile_phase(phase, fn, wall_unprofiled) -> None:
    """A phase's run again (warm) under torch.profiler: the device time and
    launches of each port kernel (every kernel named as those of
    ``csrc/*.cu`` are) and of the 25 largest CUDA kernels, the
    share of the wall the device was busy, and the span on the device
    timeline of each stage range (seed / align / vote / consensus,
    ``pipeline/dcorrect.py``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    stages = ("seed", "align", "vote", "consensus")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.monotonic()
    with profile(activities=acts) as prof:
        fn()
    wall = time.monotonic() - t0
    evs = prof.key_averages()
    dev_attr = ("self_device_time_total"
                if hasattr(evs[0], "self_device_time_total")
                else "self_cuda_time_total")
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA
               and e.key not in stages and getattr(e, dev_attr) > 0]
    busy_us = sum(getattr(e, dev_attr) for e in kernels)
    launches = sum(e.count for e in kernels)
    lines = [f"profile phase{phase}: wall {wall:.2f} s under the profiler "
             f"({wall_unprofiled:.2f} s without); {launches} kernel launches"
             f", device busy {busy_us / 1e6:.2f} s = "
             f"{busy_us / 1e6 / wall:.3f} of the profiled wall"]
    for e in evs:
        if e.key in stages:
            lines.append(f"profile phase{phase} stage {e.key} "
                         f"({e.device_type.name}): calls {e.count}, span "
                         f"{getattr(e, dev_attr) / 1e6:.3f} s")
    port = {}
    for e in kernels:
        m = PORT_KERNEL.search(e.key)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            tot = port.setdefault(name, [0.0, 0])
            tot[0] += getattr(e, dev_attr)
            tot[1] += e.count
    for name, (us, count) in sorted(port.items()):
        lines.append(f"profile phase{phase} port kernel {name}: "
                     f"{us / 1e6:.6f} s x{count}")
    for e in sorted(kernels, key=lambda e: -getattr(e, dev_attr))[:25]:
        lines.append(f"profile phase{phase} kernel "
                     f"{getattr(e, dev_attr) / 1e6:.4f} s x{e.count}: "
                     f"{e.key[:110]}")
    for line in lines:
        log(line)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/profile_phase{phase}.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
        f.write(evs.table(sort_by=dev_attr, row_limit=60))


def main(argv=None) -> int:
    ap_ = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap_.add_argument("--skip", default="",
                     help="comma list of phases 2-20 to leave out; such a "
                          "run prints no result lines")
    ap_.add_argument("--lane-out", default=None,
                     help="run as a lane of a full run: no lanes of its "
                          "own, and this run's results by phase written "
                          "as JSON to this path")
    ap_.add_argument("--profile", action="store_true",
                     help="rerun phases 4-6 under torch.profiler and print "
                          "the device time per pipeline stage and per "
                          "kernel")
    args = ap_.parse_args(argv)
    skip = {s for s in args.skip.split(",") if s}

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import proovread_tpu_torch
    from proovread_tpu_torch import kernels
    from proovread_tpu_torch.align import bsw, sw
    from proovread_tpu_torch.align.params import (BWA_MR, BWA_MR_FINISH,
                                                  BWA_SR, BWA_SR_FINISH)
    from proovread_tpu_torch.obs import accuracy
    from proovread_tpu_torch.ops import assemble_kernel, pileup_kernel
    from proovread_tpu_torch.ops import scatter
    from proovread_tpu_torch.pipeline.ccs import CCS_ALIGN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1 -------------------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    log(f"package {os.path.dirname(proovread_tpu_torch.__file__)}")
    t0 = time.monotonic()
    kernels.lib()
    log(f"kernels built and loaded in {time.monotonic() - t0:.1f} s "
        f"(nvcc {kernels.build_seconds if kernels.build_seconds is not None else 'cached'})")
    dev = torch.device("cuda")
    for src in ("sw.cu", "scatter.cu"):
        log(f"ptxas {src}: " + json.dumps(kernels.ptxas_usage(src)))
    log(f"f32 bound rate {f32_ops_per_s():.4g} operations/s "
        f"({F32_LANES_PER_SM_CLOCK} lanes x "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs "
        f"x {max_sm_clock_hz() / 1e6:.0f} MHz)")
    wait_for_card_memory()

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
        "pileup_accumulate_packed": (
            pileup_kernel.pileup_accumulate_packed,
            "proovread_tpu_torch/csrc/pileup.cu",
            "proovread_tpu/ops/pileup_kernel.py:61"),
        "bsw_expand": (bsw.bsw_expand, "proovread_tpu_torch/csrc/bsw.cu",
                       "proovread_tpu/align/bsw.py:364"),
        "pileup_accumulate": (pileup_kernel.pileup_accumulate,
                              "proovread_tpu_torch/csrc/pileup.cu",
                              "proovread_tpu/ops/pileup_kernel.py:306"),
        # a port-only kernel: the reference's sw_batch is XLA
        "sw_batch": (sw.sw_batch, "proovread_tpu_torch/csrc/sw.cu",
                     "proovread_tpu/align/sw.py:175 (XLA sw_batch, no "
                     "Pallas kernel)"),
        # a port-only kernel: the reference's lcs_lengths is numpy
        "lcs_lengths": (accuracy.lcs_lengths,
                        "proovread_tpu_torch/csrc/lcs.cu",
                        "proovread_tpu/obs/accuracy.py:203 (numpy "
                        "lcs_lengths, no Pallas kernel)"),
        # a port-only kernel: the reference's traceback is numpy
        "edit_alignments": (accuracy.edit_alignments,
                            "proovread_tpu_torch/csrc/edit.cu",
                            "proovread_tpu/obs/accuracy.py:224 (numpy "
                            "_banded_tb and its walk, no Pallas kernel)"),
        # a port-only kernel: the reference's vote scatters are XLA
        "scatter_add_ordered": (
            scatter.scatter_add_ordered,
            "proovread_tpu_torch/csrc/scatter.cu",
            "proovread_tpu/ops/pileup.py:57 and ops/fused.py:59 (XLA "
            "scatter-adds in accumulate and fused_accumulate, no Pallas "
            "kernel)"),
    }
    # the phase whose path each kernel's launch count is read from
    path_phase = {"bsw_expand_v2": 4, "pileup_accumulate_bits": 4,
                  "assemble_rows": 4, "hcr_mask_rows": 4,
                  "pileup_accumulate_packed": 5, "bsw_expand": 6,
                  "pileup_accumulate": 6, "sw_batch": 7, "lcs_lengths": 7,
                  "edit_alignments": 7, "scatter_add_ordered": 11}
    # the command-line runs go through the main path's kernels, and when
    # scored against their truth through the scoreboard's
    run_path = ("sw_batch", "bsw_expand_v2", "pileup_accumulate_bits",
                "assemble_rows", "hcr_mask_rows")
    cli_path = run_path + ("lcs_lengths", "edit_alignments")
    results, launches = {}, {}

    def drive(phase, fn, required=()):
        """Run a path with every launch count reset just before and read
        just after; keep the counts of the kernels read from this phase,
        and fail if one of them, or of ``required``, did not launch."""
        for f, _, _ in wrappers.values():
            f.launches = 0
        t0 = time.monotonic()
        out = fn()
        counts = {name: f.launches for name, (f, _, _) in wrappers.items()}
        mark(f"phase{phase}", t0)
        launches.update({k: v for k, v in counts.items()
                         if path_phase[k] == phase})
        log(f"phase{phase} launches " + json.dumps(counts))
        missing = [k for k, ph in path_phase.items()
                   if (ph == phase or k in required) and counts[k] == 0]
        if missing:
            raise AssertionError(f"phase {phase} never launched {missing}")
        return out, counts

    def report_passes(phase, res):
        for rep in res.reports:
            log(f"phase{phase} pass {rep.task}: masked {rep.masked_frac:.4f}"
                f", candidates {rep.n_candidates}, admitted {rep.n_admitted}"
                f", dropped cap {rep.n_dropped_cap}, cov {rep.n_dropped_cov}")
        if not any(rep.n_admitted for rep in res.reports):
            raise AssertionError(f"phase {phase}: no pass admitted")
        if len(res.untrimmed) == 0:
            raise AssertionError(f"phase {phase}: no corrected reads")

    # every pair the scoreboard classifies on the card in phases 2, 7, 11
    # and 12, held in the background against the host numpy and the plain
    # version (phase 2: its traceback check's pairs)
    hold = EditHold()
    import atexit
    atexit.register(hold.close)

    # phase 18's workload, simulated from here on in the process that runs
    # phase 18 (a lane's, in a full run)
    mesh18 = None
    if "18" not in skip and (args.lane_out is not None
                             or not any("18" in g for g in LANES)):
        mesh18 = MeshWorkload()
        atexit.register(mesh18.close)

    # phase 3's CPU side and its CPU serve twin run from here on, beside
    # the card's phases (at low priority)
    cpu3 = twin3 = None
    if "3" not in skip:
        cpu3 = CpuSide(tempfile.mkdtemp(prefix="chip_smoke_cpu_"))
        atexit.register(cpu3.close)
        cpu3.start()
        twin_tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
        atexit.register(shutil.rmtree, twin_tmp, True)
        l4, s4, n4, _ = workload(10_000, 40_000, 4)
        twin3 = {d: ServeTwin(twin_tmp, d, l4, s4, n4)
                 for d in ("cuda", "cpu")}
        twin3["cpu"].start()
        # (the CPU side's mapping ran on the card)
        for f, _, _ in wrappers.values():
            f.launches = 0

    # -- phase 2 -------------------------------------------------------------
    t2 = time.monotonic()
    if "2" not in skip:
        rng = np.random.default_rng(0)
        torch.cuda.reset_peak_memory_stats()
        peak2 = [0.0]

        # "launches" here counts the comparison launches of this phase;
        # "peak_gib" is the most device memory held since the last report
        def report(name, r):
            peak = torch.cuda.max_memory_allocated() / 2**30
            peak2[0] = max(peak2[0], peak)
            torch.cuda.reset_peak_memory_stats()
            log("phase2 " + json.dumps(
                {"name": name, "launches": wrappers[name][0].launches,
                 "peak_gib": peak, **r}))

        r64, bres64, bargs64 = check_bsw(rng, dev, BWA_SR_FINISH, "W=64")
        report("bsw_expand_v2", r64)
        r, _, _ = check_bsw_v1(dev, BWA_SR_FINISH, "W=64", bargs64, bres64)
        report("bsw_expand", r)
        del bres64, bargs64
        r96, bres, bargs = check_bsw(rng, dev, BWA_SR, "W=96")
        report("bsw_expand_v2", r96)
        results["bsw_expand_v2"] = r96
        results["bsw_expand"], v1res, v1slabs = check_bsw_v1(
            dev, BWA_SR, "W=96", bargs, bres)
        report("bsw_expand", results["bsw_expand"])
        results["pileup_accumulate_bits"] = check_pileup(rng, dev, bres, bargs)
        report("pileup_accumulate_bits", results["pileup_accumulate_bits"])
        results["pileup_accumulate_packed"] = check_pileup_packed(
            rng, dev, bres, bargs)
        report("pileup_accumulate_packed",
               results["pileup_accumulate_packed"])
        results["pileup_accumulate"] = check_pileup_dense(
            rng, dev, v1res, v1slabs, bargs[6])
        report("pileup_accumulate", results["pileup_accumulate"])
        del bres, bargs, v1res, v1slabs
        torch.cuda.empty_cache()
        results["assemble_rows"] = check_assemble(rng, dev)
        report("assemble_rows", results["assemble_rows"])
        results["hcr_mask_rows"] = check_hcr(rng, dev)
        report("hcr_mask_rows", results["hcr_mask_rows"])
        torch.cuda.empty_cache()
        # bsw v2 at the mr shapes: 250 bp queries padded to m = 256, the mr
        # passes' band (W=96) and the mr finish's (W=64)
        for ap, label in ((BWA_MR, "m=256 W=96"),
                          (BWA_MR_FINISH, "m=256 W=64")):
            r, _, _ = check_bsw(rng, dev, ap, label, m=256, ql=250)
            report("bsw_expand_v2", dict(r, label=label))
            torch.cuda.empty_cache()
        results["sw_batch"] = check_sw(rng, dev)
        report("sw_batch", results["sw_batch"])
        torch.cuda.empty_cache()
        # the scan engine's sr chunk: host_chunk_rows = 4096 candidates,
        # 100 bp queries packed to m = 128, BWA_SR's band of 40 (n = 256)
        r = check_sw(rng, dev, R=4096, m=128, n=256, qmax=100, ap=BWA_SR)
        report("sw_batch", dict(r, label="scan engine"))
        torch.cuda.empty_cache()
        results["lcs_lengths"] = check_lcs(rng, dev)
        report("lcs_lengths", results["lcs_lengths"])
        torch.cuda.empty_cache()
        results["edit_alignments"] = check_edit(rng, dev, hold)
        report("edit_alignments", results["edit_alignments"])
        torch.cuda.empty_cache()
        # the ccs and utg windows: 512 bases at m = 512, CCS_ALIGN's band
        # of 40 (n = 640), ccs-1's chunk of 4096 candidates
        r = check_sw(rng, dev, R=4096, m=512, n=640, ap=CCS_ALIGN)
        report("sw_batch", dict(r, label="ccs chunk"))
        torch.cuda.empty_cache()
        # a real utg chunk (phase 12's path): 2048 unitig windows of 512
        # bases against long reads, nearly all aligned end to end
        utg_sw, utg_scatters = utg_chunk_inputs(dev)
        r = check_sw(rng, dev, chunk=utg_sw)
        del utg_sw
        report("sw_batch", dict(r, label="utg chunk"))
        torch.cuda.empty_cache()
        r = check_scatter(rng, dev)
        report("scatter_add_ordered", dict(r, label="random"))
        torch.cuda.empty_cache()
        # segments of 1,000 and more: 4 M entries, 19 in 20 onto 2,000
        # cells (~1,330 kept each)
        r = check_scatter(rng, dev, M=4 << 20, hot_cells=2000)
        report("scatter_add_ordered", dict(r, label="long segments"))
        if r["shortest_hot_segment"] < 1000:
            raise AssertionError("scatter long segments: weak inputs")
        torch.cuda.empty_cache()
        results["scatter_add_ordered"] = check_chunk_scatters(
            "ccs chunk", ccs_chunk_scatters(dev))
        report("scatter_add_ordered", results["scatter_add_ordered"])
        r = check_chunk_scatters("utg chunk", utg_scatters)
        del utg_scatters
        report("scatter_add_ordered", r)
        log(f"phase2 peak device memory {peak2[0]:.2f} GiB")
        torch.cuda.empty_cache()
        mark("phase2", t2)

    # phase 2's traceback hold starts once phase 2's kernel times are
    # taken
    hold.launch()
    skip_here = skip
    lane_results = {}

    # -- phase 3: the card halves (the CPU side is compared at the end) ------
    card3 = {}
    if "3" not in skip_here:
        t3 = time.monotonic()
        longs, srs, n_it, truths = workload(10_000, 40_000, 4)
        for label, kw in (("", {}), (" coverage 400", COVERAGE_400)):
            packed0 = pileup_kernel.pileup_accumulate_packed.launches
            res_gpu, t_gpu = run_pipeline(longs, srs, n_it, "cuda", **kw)
            if not res_gpu.untrimmed or not any(r.n_admitted for r in
                                                res_gpu.reports):
                raise AssertionError(f"config 4{label}: nothing corrected")
            if kw and pileup_kernel.pileup_accumulate_packed.launches == packed0:
                raise AssertionError("config 4 coverage 400: no packed pileup")
            no_demotion(f"config 4{label}", res_gpu.metrics, res_gpu.reports)
            card3["pipeline" + label] = (
                result_key(res_gpu), t_gpu,
                f"{len(res_gpu.untrimmed)} reads, {len(res_gpu.trimmed)} "
                f"trimmed, {len(res_gpu.chimera)} chimera")
        t0 = time.monotonic()
        chain = qual_chain(first_bucket(longs, srs), "cuda", n_rest=3,
                           finish=True)
        card3["qual_chain"] = (chain, time.monotonic() - t0)
        if not all(d["admitted"] for d in chain[1]):
            raise AssertionError("config 4 qual-weighted: a pass admitted 0")
        # the command line: sr-noccs and mr-noccs, and the modes of ccs-1,
        # -u and --haplo-coverage, each scored (card halves)
        cpu3.run_cli()
        with tempfile.TemporaryDirectory() as tmp:
            tr = cli_trace(tmp, "config4-trace", longs, srs, truths)
            log("phase3 cli config 4 --trace: " + json.dumps(tr))
        res, t = run_pipeline(longs, srs, n_it, "cuda", engine="scan")
        if not any(r.n_admitted for r in res.reports):
            raise AssertionError("config 4 scan engine: nothing admitted")
        no_demotion("config 4 scan engine", res.metrics, res.reports)
        card3["scan"] = (result_key(res), t, f"{len(res.untrimmed)} reads, "
                         f"passes {[r.task for r in res.reports]}")
        # the serve command line on the card (its CPU twin runs beside)
        twin3["cuda"].run()
        log(f"phase3 serve on the card: {twin3['cuda'].wall:.1f} s, "
            f"{len(twin3['cuda'].jobs)} jobs, SLO "
            + json.dumps(twin3["cuda"].slo_stats))
        # the ladder and --resume need two buckets: config 4's genome with
        # twice its long-read bases (11 reads) at batch_reads 8
        l3, s3, _, _ = workload(10_000, 80_000, 4)
        log("phase3 ladder compile@b0.p2;oom@b1: " + json.dumps(
            ladder_check(l3, s3, 4)))
        with tempfile.TemporaryDirectory() as tmp:
            cfg8 = os.path.join(tmp, "batch8.cfg")
            with open(cfg8, "w") as fh:
                json.dump({"batch-reads": 8}, fh)
            log("phase3 cli kill at b1 and --resume: " + json.dumps(
                cli_kill_resume(tmp, "config4-resume", l3, s3,
                                "compile@b1", 1, cfg=cfg8, qc=True)))
        mark("phase3 card halves", t3)

    # -- phase 4: the main path ----------------------------------------------
    if "4" not in skip_here:
        longs, srs, n_it, truths = workload(1_250_000, 5_000_000, 6)
        bases = sum(len(r) for r in longs)
        log(f"phase4 workload: {len(longs)} long reads ({bases} bases), "
            f"{len(srs)} short reads, {n_it} iterations")
        torch.cuda.reset_peak_memory_stats()
        (res, wall), _ = drive(4, lambda: run_pipeline(longs, srs, n_it,
                                                       "cuda"))
        log(f"phase4 wall {wall:.2f} s, {bases / wall:.0f} corrected bases/s, "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        report_passes(4, res)
        no_demotion("phase 4", res.metrics, res.reports)
        digest4 = result_digest(res)

    if args.profile and "4" not in skip_here:
        profile_phase(4, lambda: run_pipeline(longs, srs, n_it, "cuda"), wall)

    # -- phase 5: high coverage ----------------------------------------------
    if "5" not in skip_here:
        l5, s5, n5, _ = workload(250_000, 1_000_000, 6, sr_coverage=200.0)
        bases5 = sum(len(r) for r in l5)
        log(f"phase5 workload: {len(l5)} long reads ({bases5} bases), "
            f"{len(s5)} short reads, {n5} iterations, coverage 200")
        torch.cuda.reset_peak_memory_stats()
        (res5, wall5), counts = drive(5, lambda: run_pipeline(
            l5, s5, n5, "cuda", coverage=200.0, sr_coverage=200.0,
            finish_coverage=200.0))
        if counts["pileup_accumulate_bits"]:
            raise AssertionError("phase 5 launched the bit-plane pileup")
        log(f"phase5 wall {wall5:.2f} s, {bases5 / wall5:.0f} corrected "
            f"bases/s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if args.profile:
            profile_phase(5, lambda: run_pipeline(
                l5, s5, n5, "cuda", coverage=200.0, sr_coverage=200.0,
                finish_coverage=200.0), wall5)
        report_passes(5, res5)
        no_demotion("phase 5", res5.metrics, res5.reports)
        fmax, cmax, n256, ncand = column_votes(first_bucket(
            l5, s5, coverage=200.0, qual_weighted=False, sr_coverage=200.0,
            finish_coverage=200.0), "cuda")
        log(f"phase5 first bucket, pass 1 alone: {ncand} candidates, largest"
            f" winning vote count {fmax:.0f}, largest column coverage "
            f"{cmax:.2f}, {n256} columns whose winning lane passed 256 "
            f"votes")
        del l5, s5, res5

    # -- phase 6: qual-weighted votes ----------------------------------------
    if "6" not in skip_here:
        if "4" in skip_here:
            longs, srs, _, truths = workload(1_250_000, 5_000_000, 6)
        bucket = first_bucket(longs, srs, full=True)
        lr6 = bucket[0]
        log(f"phase6 bucket: {int((lr6.lengths > 8).sum())} reads "
            f"(+ pad rows to {lr6.codes.shape[0]}), Lp {lr6.codes.shape[1]},"
            f" {len(srs)} short reads resident, max_coverage "
            f"{bucket[2].max_coverage}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        (_, st6), _ = drive(6, lambda: qual_chain(bucket, "cuda", n_rest=2,
                                                  finish=False))
        wall6 = time.monotonic() - t0
        for d in st6:
            log("phase6 pass " + json.dumps(d))
        log(f"phase6 wall {wall6:.2f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not all(d["admitted"] for d in st6):
            raise AssertionError("phase 6: a pass admitted no candidate")
        # (phase 6 drives DeviceCorrector directly: no ladder to demote)
        if args.profile:
            profile_phase(6, lambda: qual_chain(bucket, "cuda", n_rest=2,
                                                finish=False), wall6)

    # -- the lanes, from here on beside the main process's phases 7, 11, 9,
    # 14 and 17 ------------------------------------------------------------
    lanes = []
    if args.lane_out is None:
        for group in LANES:
            if set(group) - skip:
                lanes.append(Lane(group, skip))
                atexit.register(lanes[-1].close)
    # the phases skipped here: the caller's and the lanes'
    skip_here = skip | {p for lane in lanes for p in lane.phases}

    # -- phase 7: the command line at E.coli class ----------------------------
    cli7 = out7 = None
    if (({"7", "8", "9", "10", "11", "12", "15", "16"} - skip_here)
            and "4" in skip_here and "6" in skip_here):
        longs, srs, _, truths = workload(1_250_000, 5_000_000, 6)
    if "7" not in skip_here:
        with tempfile.TemporaryDirectory() as tmp:
            (cli7, out7, _), _ = drive(7, lambda: cli_run(
                tmp, "ecoli-sr", longs, srs, "sr-noccs", truths,
                edit_hold=hold), required=cli_path)
        log("phase7 " + json.dumps(cli7))
        log(f"phase7 score-accuracy {cli7['score_accuracy_s']:.2f} s")

    # -- phase 11: subreads at E.coli class (its traceback hold starts
    # early) ------------------------------------------------------------------
    sub_path = cli_path + ("scatter_add_ordered",)
    if "11" not in skip_here:
        with tempfile.TemporaryDirectory() as tmp:
            cli11, _ = drive(11, lambda: phase11(tmp, srs, edit_hold=hold),
                             required=sub_path)
        log("phase11 " + json.dumps(cli11))
        log(f"phase11 score-accuracy {cli11['score_accuracy_s']:.2f} s")

    # -- phase 9: kill and resume at E.coli class -----------------------------
    if "9" not in skip_here:
        with tempfile.TemporaryDirectory() as tmp:
            cli9, _ = drive(9, lambda: cli_kill_resume(
                tmp, "ecoli-resume", longs, srs, "compile@b3", 3, ref=out7),
                required=run_path)
        log("phase9 " + json.dumps(cli9))

    # -- phases 12-13: unitigs, flex at E.coli class -------------------------
    if "12" not in skip_here:
        with tempfile.TemporaryDirectory() as tmp:
            cli12, _ = drive(12, lambda: phase12(tmp, longs, srs, truths,
                                                 edit_hold=hold),
                             required=sub_path)
        log("phase12 " + json.dumps(cli12))
        log(f"phase12 score-accuracy {cli12['score_accuracy_s']:.2f} s")
    if "13" not in skip_here:
        with tempfile.TemporaryDirectory() as tmp:
            cli13, _ = drive(13, lambda: phase13(tmp),
                             required=cli_path[1:])
        log("phase13 " + json.dumps(cli13))

    # -- phase 8: mr at E.coli class -----------------------------------------
    if "8" not in skip_here:
        _, srs8, _, _ = workload(1_250_000, 5_000_000, 6, sr_len=250)
        # half phase 7's long reads (the first 2.5 Mb), to keep the run short
        half = len(longs) // 2
        log(f"phase8 workload: {half} long reads, {len(srs8)} short "
            "reads of 250 bp")
        with tempfile.TemporaryDirectory() as tmp:
            (cli8, _, _), _ = drive(8, lambda: cli_run(
                tmp, "ecoli-mr", longs[:half], srs8, "mr-noccs",
                truths[:half], classify_cap=CLASSIFY_MR),
                required=cli_path)
        log("phase8 " + json.dumps(cli8))
        lane_results["8"] = cli8
        del srs8

    # -- phase 15: SAM/BAM re-entry at full width ----------------------------
    if "15" not in skip_here:
        # the first ~500 kb of phase 4's raw reads (a re-entry run takes
        # ~0.4 ms of wall an alignment)
        n15 = int(np.searchsorted(np.cumsum([len(x) for x in longs]),
                                  500_000)) + 1
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory() as tmp:
            r15, _ = drive(15, lambda: phase15(tmp, longs[:n15], srs,
                                               truths[:n15]),
                           required=("bsw_expand_v2", "pileup_accumulate_bits",
                                     "scatter_add_ordered", "sw_batch"))
        log("phase15 " + json.dumps(r15))
        log(f"phase15 wall {time.monotonic() - t0:.2f} s")

    # -- phase 10: the scan engine timed at E.coli class ----------------------
    if "10" not in skip_here:
        (res10, scan10), _ = drive(10, lambda: scan_timed(longs, srs[::3], 6,
                                                          20),
                                   required=("sw_batch",))
        report_passes(10, res10)
        log("phase10 " + json.dumps(scan10))
        del res10

    # -- phase 14: the streaming regime at full width ------------------------
    if "14" not in skip_here:
        t0 = time.monotonic()
        r14, _ = drive(14, phase14, required=run_path[1:])
        log("phase14 " + json.dumps(r14))
        log(f"phase14 wall {time.monotonic() - t0:.2f} s")

    # -- phase 16: serving at full width -------------------------------------
    serve_path = run_path + ("scatter_add_ordered",)
    if "16" not in skip_here:
        with tempfile.TemporaryDirectory() as tmp:
            r16, _ = drive(16, lambda: phase16(tmp, srs),
                           required=serve_path)
        log("phase16 " + json.dumps(r16))
        log(f"phase16 wall {r16['wall_s']:.2f} s, {r16['bases_per_s']:.0f} "
            f"completed bases/s, {r16['waves']} waves, device busy "
            f"{r16['device_busy_share']:.3f} of the wall; latency by class "
            "(count, p50 s, p99 s) " + json.dumps(r16["latency"]))

    # -- phase 17: the fleet on one card --------------------------------------
    r17 = None
    if "17" not in skip_here:
        r17, _ = drive(17, phase17,
                       required=serve_path + ("lcs_lengths",
                                              "edit_alignments"))
        log("phase17 " + json.dumps({k: v for k, v in r17.items()
                                     if k != "row"}))
        log(f"phase17 (a drill: its rate is fixed per-wave cost) wall "
            f"{r17['wall_s']:.2f} s, {r17['bases_per_s_fleet']} fleet "
            f"bases/s, handoffs "
            f"{r17['jobs']['handoffs']}, device busy "
            f"{r17['device_busy_share']:.3f} of the wall; identity "
            + json.dumps({f: (a["identity_before"], a["identity_after"])
                          for f, a in r17["accuracy"].items()}))

    # -- phase 18: more than one GPU -------------------------------------------
    if "18" not in skip_here:
        r18, _ = drive(18, lambda: phase18(mesh18.wait()),
                       required=run_path[1:])
        log("phase18 " + json.dumps({k: v for k, v in r18.items()
                                     if k != "drill"}))
        for line in r18["drill"]:
            log(f"phase18 drill: {line}")
        log(f"phase18 walls: one device {r18['wall_one_s']:.2f} s "
            f"({r18['bases_per_s_one']:.0f} bases/s), mesh 2 on "
            f"{torch.cuda.device_count()} card(s) {r18['wall_mesh_s']:.2f} s"
            f" ({r18['bases_per_s_mesh']:.0f} bases/s; "
            f"{r18['wall_mesh_launch_s']:.2f} s with the ranks' start), "
            f"drill {r18['drill_s']:.1f} s; identity "
            f"{r18['identity_before']:.6f} -> {r18['identity_after']:.6f}")

    # -- phases 19-20: the kernel build's own account, the history gates ------
    if {"19", "20"} - skip_here:
        with tempfile.TemporaryDirectory() as tmp:
            r19 = None
            if "19" not in skip_here:
                t19 = time.monotonic()
                r19 = phase19(tmp)
                mark("phase19", t19)
                log("phase19 " + json.dumps(r19))
                lane_results["19"] = r19
            if "20" not in skip_here:
                t20 = time.monotonic()
                art = os.path.join(tmp, "art")
                r20 = phase20(os.path.join(tmp, "phase20"),
                              boot_rows=r19 and r19["boot_rows"],
                              art=art if os.path.isdir(art) else None)
                mark("phase20", t20)
                for wl, row in r20["rows"].items():
                    log(f"phase20 ACCURACY row {wl} ({r20['walls'][wl]:.2f} "
                        f"s with its subprocess): " + json.dumps(row))
                    log(f"phase20 {wl} kernel entry calls "
                        + json.dumps(r20["calls"][wl]))
                log("phase20 " + json.dumps(
                    {k: v for k, v in r20.items()
                     if k not in ("rows", "calls")}))
                for gate, v in r20["gates"].items():
                    log(f"phase20 gate {gate}: {v['verdict']} "
                        + json.dumps(v))
                lane_results["20"] = r20

    # -- the lanes' phases ---------------------------------------------------
    for lane in lanes:
        lane_results.update(lane.join())
    if "19" in lane_results and "4" not in skip:
        # the profiled run (under the profiler, a ledger and a tracer, the
        # build inside it) corrected phase 4's reads byte for byte
        if lane_results["19"]["profiled"]["digest"] != digest4:
            raise AssertionError("phase 19: the profiled run's records "
                                 "differ from phase 4's")
        log("phase19 profiled run == phase 4, byte for byte")
    if r17 is not None and "20" not in skip:
        # phase 20's gate over phase 17's LOAD row (with the JAX package's
        # committed history, which pools apart)
        from proovread_tpu_torch.obs import load as obs_load
        v = gate_verdict("load", obs_load.load_check(
            obs_load.load_rows([os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "LOAD_r18.json")])
            + [{"source": "phase17", "row": r17["row"]}]),
            ["slam/x2/cuda"])
        log("phase20 gate load: " + v["verdict"] + " " + json.dumps(v))
    cli8 = lane_results.get("8")
    if cli7 is not None and cli8 is not None:
        log(f"phase8 bsw device time a launch at m=256: "
            f"{cli8['bsw_ms_per_launch']:.4f} ms, "
            f"{cli8['bsw_ms_per_launch'] / cli7['bsw_ms_per_launch']:.2f}"
            f"x phase 7's at m=112 ({cli7['bsw_ms_per_launch']:.4f} ms)")

    # -- phase 3: the CPU side against the card's -----------------------------
    if cpu3 is not None:
        cpu3.compare(card3)
        twin3["cpu"].join()
        log("phase3 serve twin, card == CPU: " + json.dumps(
            hold_serve_twin(twin3["cuda"], twin3["cpu"])))
    hold.check()

    if args.lane_out is not None:
        with open(args.lane_out, "w") as fh:
            json.dump(lane_results, fh)
    if skip:
        log(f"phases {sorted(skip)} skipped: no result printed")
        return 0
    rows = []
    for name, (_, source, replaces) in wrappers.items():
        r = results[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "kernel_ms": r["kernel_ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"],
               "library_ms": r["library_ms"]}
        # an entry of several kernels: each one's time
        if len(r.get("kernel_ms_by_name") or {}) > 1:
            row["kernel_ms_by_name"] = r["kernel_ms_by_name"]
        rows.append(row)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
