"""The port's CUDA kernel sources, run on the CPU against their plain
versions.

There is no CPU mode for a CUDA kernel, so the sources under
``proovread_tpu_torch/csrc/`` are compiled here by g++ against a small
emulation of the CUDA runtime subset they use: one ``std::thread`` per CUDA
thread, blocks one after another (2-D grids row by row), a barrier whose
waiters yield their core a while before they sleep (``pt_barrier``) for
``__syncthreads``, ``__syncthreads_count`` and ``__syncthreads_or``,
per-warp barriers for ``__syncwarp``, ``__ballot_sync`` and the
``__shfl_up_sync`` / ``__shfl_down_sync`` / ``__shfl_xor_sync`` /
``__shfl_sync`` exchanges (any 32- or 64-bit type), GCC builtins for
``__popc``, ``__popcll``, ``__ffs`` and ``__clz``, ``__float_as_uint``,
``__funnelshift_l``, ``uint2``/``uint4`` and their ``make_``, ``float4``, and ``std::atomic_ref`` for
``atomicAdd`` (float, int, unsigned) and ``atomicOr``. The launch syntax
and the ``__shared__`` qualifiers are rewritten mechanically before
compiling.
Each check runs in a process of its own with a timeout: forked from one
server process that has imported numpy and torch once (``SERVER``), so a
check does not pay for the imports. Tolerance: bitwise (integer
outputs, bsw score, pileup sums). Skips, with the reason, where g++ with
C++20 is missing."""

import os
import queue
import re
import shutil
import signal
import subprocess
import sys
import threading
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "proovread_tpu_torch" / "csrc"

CUDA_RUNTIME_EMU = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <sched.h>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __align__(x) __attribute__((aligned(x)))
#define __launch_bounds__(...)
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <typename T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
struct cudaFuncAttributes { int numRegs; size_t sharedSizeBytes; };
template <typename T>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, T*) {
  a->numRegs = 0;
  a->sharedSizeBytes = 0;
  return 0;
}
template <typename T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T*, int,
                                                          size_t) {
  *n = 1;
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
// a barrier of n threads: the last to arrive opens the next phase; the
// others yield their core up to 64 times, then sleep on the phase. Beside
// CPU-bound processes a woken thread waits for a core: the barrier-heavy
// cases ran 2-3x slower with std::barrier's sleeping waiters, as slow
// with 8 yields, slower still with 1024 (the yielding threads hold the
// cores)
struct pt_barrier {
  explicit pt_barrier(int n) : n_(n) {}
  void arrive_and_wait() {
    unsigned ph = phase_.load(std::memory_order_acquire);
    if (count_.fetch_add(1, std::memory_order_acq_rel) + 1 == n_) {
      count_.store(0, std::memory_order_relaxed);
      phase_.store(ph + 1, std::memory_order_release);
      phase_.notify_all();
      return;
    }
    for (int i = 0; i < 64; ++i) {
      if (phase_.load(std::memory_order_acquire) != ph) return;
      sched_yield();
    }
    while (phase_.load(std::memory_order_acquire) == ph)
      phase_.wait(ph, std::memory_order_acquire);
  }
  const int n_;
  std::atomic<int> count_{0};
  std::atomic<unsigned> phase_{0};
};
inline std::unique_ptr<pt_barrier> g_bar;
inline std::vector<std::unique_ptr<pt_barrier>> g_wbar;
// warp exchanges alternate between two halves: a lane writes a half again
// only after the next exchange's barrier, which every lane reaches after
// its read, so one warp barrier an exchange is enough
inline uint64_t g_xchg[2][1024];
inline thread_local unsigned g_half = 0;
alignas(16) inline unsigned char g_smem[240 * 1024];
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline int pt_tid() { return threadIdx.x + threadIdx.y * blockDim.x; }
inline std::atomic<int> g_count{0};
inline int __syncthreads_count(int pred) {
  if (pred) g_count.fetch_add(1);
  g_bar->arrive_and_wait();
  int r = g_count.load();
  g_bar->arrive_and_wait();
  if (pt_tid() == 0) g_count.store(0);
  g_bar->arrive_and_wait();
  return r;
}
inline int __syncthreads_or(int pred) { return __syncthreads_count(pred) > 0; }
inline void __syncwarp(unsigned = 0xffffffffu) {
  g_wbar[pt_tid() >> 5]->arrive_and_wait();
}
// every lane of the warp publishes v, then reads lane src (its own value
// where src is -1)
template <typename T>
T pt_shfl(T v, int src) {
  int t = pt_tid();
  uint64_t* x = g_xchg[g_half ^= 1];
  std::memcpy(&x[t], &v, sizeof(T));
  __syncwarp();
  T r = v;
  if (src >= 0) std::memcpy(&r, &x[(t & ~31) + src], sizeof(T));
  return r;
}
template <typename T>
T __shfl_up_sync(unsigned, T v, int o) {
  int lane = pt_tid() & 31;
  return pt_shfl(v, lane >= o ? lane - o : -1);
}
template <typename T>
T __shfl_down_sync(unsigned, T v, int o) {
  int lane = pt_tid() & 31;
  return pt_shfl(v, lane + o < 32 ? lane + o : -1);
}
template <typename T>
T __shfl_sync(unsigned, T v, int src) { return pt_shfl(v, src & 31); }
template <typename T>
T __shfl_xor_sync(unsigned, T v, int m) {
  return pt_shfl(v, (pt_tid() & 31) ^ (m & 31));
}
// every lane publishes its predicate; each reads the whole warp's
inline unsigned __ballot_sync(unsigned, int pred) {
  int t = pt_tid(), w0 = t & ~31;
  uint64_t* x = g_xchg[g_half ^= 1];
  x[t] = pred != 0;
  __syncwarp();
  unsigned r = 0;
  int nt = int(blockDim.x * blockDim.y);
  for (int l = 0; l < 32 && w0 + l < nt; ++l)
    if (x[w0 + l]) r |= 1u << l;
  return r;
}
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, 4);
  return u;
}
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned s) {
  return unsigned(((uint64_t(hi) << 32 | lo) << (s & 31)) >> 32);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __clz(int x) { return x ? __builtin_clz(unsigned(x)) : 32; }
inline float atomicAdd(float* p, float v) {
  return std::atomic_ref<float>(*p).fetch_add(v);
}
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline int atomicOr(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_or(v);
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
template <typename F>
void pt_launch(dim3 grid, dim3 block, size_t, F body) {
  blockDim = block;
  gridDim = grid;
  int nt = block.x * block.y;
  for (unsigned by = 0; by < grid.y; ++by)
  for (unsigned b = 0; b < grid.x; ++b) {
    g_bar = std::make_unique<pt_barrier>(nt);
    g_wbar.clear();
    for (int w = 0; w < (nt + 31) / 32; ++w)
      g_wbar.push_back(
          std::make_unique<pt_barrier>(std::min(32, nt - 32 * w)));
    std::memset(g_smem, 0xAB, sizeof g_smem);  // shared memory is not zeroed
    std::vector<std::thread> th;
    for (int t = 0; t < nt; ++t)
      th.emplace_back([&, t, b, by] {
        blockIdx = dim3(b, by);
        threadIdx = dim3(t % block.x, t / block.x);
        body();
      });
    for (auto& x : th) x.join();
  }
}
"""

CHECKS = r"""
import ctypes, sys
import numpy as np, torch
from proovread_tpu_torch import kernels
lib = ctypes.CDLL(sys.argv[1])
for name, argtypes in kernels._SIGNATURES.items():
    getattr(lib, name).argtypes = argtypes
    getattr(lib, name).restype = ctypes.c_int
kernels._lib = lib
kernels.stream_of = lambda t: 0
which = sys.argv[2]
rng = np.random.default_rng(7)
t = torch.as_tensor

def same(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a, b)), which

if which.startswith("bsw"):
    from proovread_tpu_torch.align import bsw
    from proovread_tpu_torch.align.params import BWA_SR, BWA_SR_FINISH
    from proovread_tpu_torch.pipeline.dcorrect import device_revcomp
    ap = BWA_SR if which == "bsw96" else BWA_SR_FINISH
    # R odd: several candidates (warps) per block, the last block partial;
    # every query is some candidate's: qlen 0 (query 0), an N inside each
    # query, inserted (s % 3 == 1) and deleted (s % 3 == 2) bases
    S, m, B, Lp, R = 8, 112, 3, 800, 15
    W = bsw.band_lanes(ap)
    n = m + W
    genome = rng.integers(0, 4, (B, Lp)).astype(np.int8)
    qlen = rng.integers(60, 101, S).astype(np.int32)
    qlen[0] = 0
    qf = np.full((S, m), 4, np.int8)
    for s in range(S):
        b, p = int(rng.integers(0, B)), int(rng.integers(0, Lp - 120))
        src = genome[b, p:p + qlen[s]].copy()
        if s % 3 == 1 and len(src) > 50:
            src = np.insert(src, 30, [1, 2])[:len(src)]
        if s % 3 == 2 and len(src) > 50:
            src = np.append(np.delete(src, 40), 3)
        qf[s, :len(src)] = src
        qf[s, 5] = 4                 # an N inside the query
    sread = rng.integers(0, S, R).astype(np.int32)
    sread[:S] = np.arange(S)
    diag = rng.integers(-2 * n, Lp + 2 * n, R).astype(np.int32)
    mp = bsw.build_map_pad(t(genome), t(rng.random((B, Lp)) < 0.1), n)
    _, w0p = bsw.window_starts(t(diag), W, Lp, n)
    args = (t(qf), device_revcomp(t(qf), t(qlen)), mp, t(qlen)[t(sread).long()],
            t(sread), t(rng.integers(0, 2, R).astype(np.int32)),
            t(np.sort(rng.integers(0, B, R)).astype(np.int32)), w0p, ap)
    got = bsw._bsw_cuda(*args)
    same(got, bsw.bsw_expand_v2_plain(*args))
    # v1 over the slabs v2 read, ignore bits cleared: v1 == v2 ungated
    q_t, rc_t, mp, qlen_c, sr_t, st_t, lr_t, w0p = args[:8]
    q1 = torch.where((st_t == 0)[:, None], q_t[sr_t.long()], rc_t[sr_t.long()])
    cols = w0p.long()[:, None] + torch.arange(n)[None, :]
    win1 = mp[lr_t.long()[:, None], cols] & 7
    v1 = bsw._bsw_v1_cuda(q1, win1, qlen_c, ap)
    same(v1, bsw.bsw_expand_plain(q1, win1, qlen_c, ap))
    ign = (mp[lr_t.long()[:, None], cols] >> 3) > 0
    same([torch.where(ign, -1, v1.state), torch.where(ign, 0, v1.ins_len)],
         [got.state, got.ins_len])
    same(v1[3:9], got[3:9])
    assert bool(ign.any()) and bool((got.state == -1).any())
elif which == "pileup":
    from proovread_tpu_torch.ops import pileup_kernel as pk
    B, Lpile, R, n = 3, 900, 48, 176
    b0 = t(rng.integers(-2**31, 2**31, (R, n)).astype(np.int32))
    b1 = t(rng.integers(0, 1 << 22, (R, n)).astype(np.int32))
    ro = t(np.sort(rng.integers(0, B, R)).astype(np.int32))
    w0 = t(rng.integers(0, Lpile - n + 1, R).astype(np.int32))
    base = torch.zeros((B, Lpile, 64))
    same([pk._pileup_cuda(base.clone(), b0, b1, ro, w0)],
         [pk.pileup_accumulate_bits_plain(base.clone(), b0, b1, ro, w0)])
elif which == "pileup_clustered":
    # the main path's shape: sorted candidates of 3 reads (one of them a
    # single candidate) whose 16-aligned windows overlap, planes from real
    # vote words, a share of dead (all-zero) rows, counts already in the
    # buffer; then the metadata checks
    from proovread_tpu_torch.ops import pileup_kernel as pk
    from proovread_tpu_torch.ops.votes import word_to_bits
    B, Lpile, n = 4, 700, 176
    ro = np.repeat([0, 2, 3], [40, 1, 23]).astype(np.int32)
    R = len(ro)
    w0 = (rng.integers(0, (Lpile - n) // 16 + 1, R) * 16).astype(np.int32)
    w0[:20] = rng.integers(8, 12, 20) * 16      # 20 windows on one spot
    st = rng.integers(1, 7, (R, n))
    ln = np.where(rng.random((R, n)) < 0.2, rng.integers(1, 7, (R, n)), 0)
    words = st | (rng.integers(0, 2, (R, n)) << 3) | (ln << 4)
    for k in range(6):
        words |= np.where(k < ln, rng.integers(0, 5, (R, n)), 5) << (7 + 3 * k)
    words[rng.random((R, n)) < 0.3] = 0
    words[rng.random(R) < 0.15] = 0
    b0, b1 = word_to_bits(t(words.astype(np.int32)))
    assert (b0 < 0).any() and (b1 != 0).any()
    base = t(rng.integers(0, 5, (B, Lpile, 64)).astype(np.float32))
    want = pk.pileup_accumulate_bits_plain(base.clone(), b0, b1, t(ro), t(w0))
    assert int((want - base).max()) >= 8         # many votes on one cell
    same([pk._pileup_cuda(base.clone(), b0, b1, t(ro), t(w0))], [want])
    # the kernel writes nothing for a bad candidate (the others land) and
    # the wrapper raises
    ok = np.ones(R, bool)
    ok[[3, 30, 50]] = False
    for bad_ro, bad_w0, msg in ((np.where(ok, ro, 4), w0, "read_of outside"),
                                (ro, np.where(ok, w0, Lpile - n + 16),
                                 "w0 outside"),
                                (np.where(ok, ro, -1), np.where(ok, w0, -16),
                                 "read_of outside [0, 3], w0 outside")):
        buf = base.clone()
        try:
            pk._pileup_cuda(buf, b0, b1, t(bad_ro), t(bad_w0))
            raise AssertionError("no error for " + msg)
        except ValueError as e:
            assert msg in str(e), e
        assert torch.equal(buf, pk.pileup_accumulate_bits_plain(
            base.clone(), b0[t(ok)], b1[t(ok)], t(ro[ok]), t(w0[ok])))
elif which == "pileup_packed":
    from proovread_tpu_torch.ops import pileup_kernel as pk
    B, Lpile, R, n = 3, 900, 48, 176
    words = rng.integers(0, 1 << 25, (R, n)).astype(np.int32)
    words[rng.random((R, n)) < 0.3] = 0
    ro = t(np.sort(rng.integers(0, B, R)).astype(np.int32))
    w0 = t(rng.integers(0, Lpile - n + 1, R).astype(np.int32))
    base = torch.zeros((B, Lpile, 64))
    same([pk._packed_cuda(base.clone(), t(words), ro, w0)],
         [pk.pileup_accumulate_packed_plain(base.clone(), t(words), ro, w0)])
elif which == "pileup_packed_clustered":
    # the high-coverage path's shape: sorted candidates of 3 reads (one of
    # them a single candidate) whose 16-aligned windows overlap, real vote
    # words (marker bits, insertions, unset inserted bases) and raw random
    # words, a share of dead (all-zero) rows, counts already in the
    # buffer; then the metadata checks
    from proovread_tpu_torch.ops import pileup_kernel as pk
    B, Lpile, n = 4, 700, 176
    ro = np.repeat([0, 2, 3], [40, 1, 23]).astype(np.int32)
    R = len(ro)
    w0 = (rng.integers(0, (Lpile - n) // 16 + 1, R) * 16).astype(np.int32)
    w0[:20] = 160                               # 20 windows on one spot
    st = np.where(rng.random((R, n)) < 0.8, 1, rng.integers(1, 7, (R, n)))
    ln = np.where(rng.random((R, n)) < 0.2, rng.integers(1, 7, (R, n)), 0)
    words = st | (rng.integers(0, 2, (R, n)) << 3) | (ln << 4)
    for k in range(6):
        words |= np.where(k < ln, rng.integers(0, 5, (R, n)), 5) << (7 + 3 * k)
    words[50:54] = rng.integers(0, 2**31, (4, n))
    words[rng.random((R, n)) < 0.3] = 0
    words[rng.random(R) < 0.15] = 0
    words = t(words.astype(np.int32))
    base = t(rng.integers(0, 5, (B, Lpile, 64)).astype(np.float32))
    want = pk.pileup_accumulate_packed_plain(base.clone(), words, t(ro),
                                             t(w0))
    assert int((want - base).max()) >= 8         # many votes on one cell
    same([pk._packed_cuda(base.clone(), words, t(ro), t(w0))], [want])
    # the kernel writes nothing for a bad candidate (the others land) and
    # the wrapper raises with the flag word's message
    ok = np.ones(R, bool)
    ok[[3, 30, 50]] = False
    for bad_ro, bad_w0, msg in ((np.where(ok, ro, 4), w0,
                                 "read_of outside [0, 3]"),
                                (ro, np.where(ok, w0, Lpile - n + 16),
                                 f"w0 outside [0, {Lpile - n}]"),
                                (np.where(ok, ro, -1), np.where(ok, w0, -16),
                                 "read_of outside [0, 3], w0 outside")):
        buf = base.clone()
        try:
            pk._packed_cuda(buf, words, t(bad_ro), t(bad_w0))
            raise AssertionError("no error for " + msg)
        except ValueError as e:
            assert str(e).startswith("pileup_accumulate_packed: " + msg), e
        assert torch.equal(buf, pk.pileup_accumulate_packed_plain(
            base.clone(), words[t(ok)], t(ro[ok]), t(w0[ok])))
elif which == "pileup_dense":
    from proovread_tpu_torch.ops import pileup_kernel as pk
    B, Lpile, R, n = 4, 400, 40, 176
    votes = rng.integers(0, 4000, (R, n, 64)).astype(np.float32) * np.float32(0.01)
    votes[rng.random((R, n, 64)) < 0.7] = 0
    ro = t(np.sort(rng.integers(0, B - 1, R)).astype(np.int32))
    w0 = t(rng.integers(0, Lpile - n + 1, R).astype(np.int32))
    base = torch.as_tensor(rng.random((B, Lpile, 64)).astype(np.float32))
    got = pk._dense_cuda(base.clone(), t(votes), ro, w0)
    same([got], [pk.pileup_accumulate_plain(base.clone(), t(votes), ro, w0)])
elif which == "pileup_dense_clustered":
    # read 0: 30 candidates whose windows all cover tile 1 (one item folds
    # many candidates); read 1: windows starting on and around tile edges;
    # read 2: one candidate (a run of length 1); read 3: untouched
    from proovread_tpu_torch.ops import pileup_kernel as pk
    B, Lpile, n = 4, 700, 176
    w0 = np.concatenate([rng.integers(90, 128, 30),
                         [0, 127, 128, 129, 255, 256, 383, 384, 511, 524,
                          1, 250, 400, 300],
                         [77]]).astype(np.int32)
    ro = np.repeat([0, 1, 2], [30, 14, 1]).astype(np.int32)
    R = len(w0)
    votes = rng.integers(0, 4000, (R, n, 64)).astype(np.float32) * np.float32(0.01)
    votes[rng.random((R, n, 64)) < 0.5] = 0
    base = torch.as_tensor(rng.random((B, Lpile, 64)).astype(np.float32))
    got = pk._dense_cuda(base.clone(), t(votes), t(ro), t(w0))
    want = pk.pileup_accumulate_plain(base.clone(), t(votes), t(ro), t(w0))
    same([got], [want])
    assert torch.equal(got[3], base[3]) and not torch.equal(got[0], base[0])
    # the work-list kernel's metadata checks raise before the fold runs
    for bad_ro, bad_w0, msg in ((ro[::-1].copy(), w0, "sorted"),
                                (ro, w0 + 600, "w0 outside"),
                                (ro + 2, w0, "read_of outside")):
        buf = base.clone()
        try:
            pk._dense_cuda(buf, t(votes), t(bad_ro), t(bad_w0))
            raise AssertionError("no error for " + msg)
        except ValueError as e:
            assert msg in str(e), e
        assert torch.equal(buf, base)
elif which.startswith("assemble"):
    # fields as ConsensusCall holds them, some outside the ranges the
    # packing clamps (insertion length 7-9 and negative, phred 64-70 and
    # negative, base -1 and 9, inserted base 7 and negative); "assemble":
    # lengths on the tile edges (ASM_TILE = 1024 columns, L not a multiple
    # of it), Lp above, at and below L; "assemble_long": many tiles a read,
    # a length past L, truncation in an early tile
    from proovread_tpu_torch.ops import assemble_kernel as ak
    from proovread_tpu_torch.ops.consensus_call import ConsensusCall
    T = ak.ASM_TILE
    if which == "assemble":
        B, L = 7, 2500
        lens = np.array([0, T - 1, T, T + 1, L, 2 * T + 5, 1], np.int32)
        lps = (L + 300, L, 2000)
    else:
        B, L = 3, 20000
        lens = np.array([L, L + 7, 15000], np.int32)
        lps = (L + 500, 3000)
    def wild(a, lo, hi, frac=0.05):
        a = a.copy()
        sel = rng.random(a.shape) < frac
        a[sel] = rng.integers(lo, hi + 1, int(sel.sum()))
        return a
    call = ConsensusCall(
        emitted=t(rng.random((B, L)) > 0.15),
        base=t(wild(wild(rng.integers(0, 5, (B, L)), -1, -1), 9, 9)
               .astype(np.int8)),
        ins_len=t(wild(np.where(rng.random((B, L)) < 0.08,
                                rng.integers(1, 7, (B, L)), 0), 7, 9, 0.01)
                  .astype(np.int32)),
        ins_bases=t(wild(wild(rng.integers(0, 5, (B, L, 6)), 7, 7), -3, -1,
                         0.01).astype(np.int8)),
        freq=t(np.zeros((B, L), np.float32)),
        phred=t(wild(wild(rng.integers(0, 41, (B, L)), 64, 70), -5, -1, 0.01)
                .astype(np.int32)),
        coverage=t(np.zeros((B, L), np.float32)))
    for Lp in lps:
        got = ak.assemble_fields_cuda(call, t(lens), Lp)
        want = ak.assemble_rows_plain(call, t(lens), Lp)
        same(got, want)
        assert bool((want[2][t(lens <= 0)] == 0).all())
    assert int(want[2].max()) == lps[-1]         # truncated at Lp
    assert int(want[1].max()) == 63 and int(want[0].max()) == 7
elif which == "hcr":
    from proovread_tpu_torch.ops import assemble_kernel as ak
    from proovread_tpu_torch.pipeline.masking import MaskParams
    B, L = 6, 9000
    seg = np.repeat(rng.integers(0, 2, (B, L // 60 + 1)), 60, axis=1)[:, :L]
    qual = t(np.where(seg > 0, rng.integers(25, 41, (B, L)),
                      rng.integers(0, 10, (B, L))).astype(np.uint8))
    lens = t(np.array([0, L, 4100, 8999, 60, 7000], np.int32))
    for mp in (MaskParams().scaled(100), MaskParams(end_ratio=0.3).scaled(100),
               MaskParams(mask_min_len=10, unmask_min_len=20, mask_reduce=3,
                          end_ratio=0.5)):
        pvi = ak._int_params(ak.mask_params_vec(mp))
        got, want = ak.hcr_mask_cuda(qual, lens, pvi), ak.hcr_mask_plain(qual, lens, pvi)
        same(got, want)
        assert int(want[1].sum()) > 0
elif which == "hcr_long":
    # a read past one block's HCR_THREADS words (two scan tiles with a
    # carry), runs from 1 to thousands of columns that cross 32-column
    # words, warps and the tile edge, a partial last word, lengths 0, 1, L
    # and past L, and a reduction larger than many runs
    from proovread_tpu_torch.ops import assemble_kernel as ak
    from proovread_tpu_torch.pipeline.masking import MaskParams
    B, L = 6, 20001
    qual = np.zeros((B, L), np.uint8)
    for b in range(B):
        pos, hi = 0, bool(b & 1)
        while pos < L:
            k = int(rng.choice([rng.integers(1, 40), rng.integers(40, 400),
                                rng.integers(400, 5000)]))
            qual[b, pos:pos + k] = (rng.integers(25, 41) if hi
                                    else rng.integers(0, 10))
            pos, hi = pos + k, not hi
    # a run that starts 14 columns before column 16384, the edge between
    # the forward scan's two tiles, and one that ends 12 columns after
    # column 3648, the backward scan's edge: only the carry between the
    # tiles places their reduced ends
    qual[2, 16300:17500] = [3] * 70 + [35] * 1130
    qual[3, 2500:3700] = [35] * 1160 + [3] * 40
    lens = t(np.array([0, 1, L, L + 7, 16400, 12345], np.int32))
    for mp in (MaskParams().scaled(100),
               MaskParams(mask_min_len=10, unmask_min_len=20, mask_reduce=40,
                          end_ratio=0.5),
               MaskParams(mask_min_len=1, unmask_min_len=1000, mask_reduce=0,
                          end_ratio=0.0)):
        pvi = ak._int_params(ak.mask_params_vec(mp))
        got = ak.hcr_mask_cuda(t(qual), lens, pvi)
        want = ak.hcr_mask_plain(t(qual), lens, pvi)
        same(got, want)
        assert int(want[1].sum()) > 0 and int(want[1][0]) == 0
elif which.startswith("sw"):
    # "sw": siamaera-like candidates at a small size: queries planted in
    # their windows (some with an indel), chance pairs, N codes, empty and
    # short queries; R not a multiple of the block's four candidates.
    # "sw640": n = 640 (K = 20, 32-bit plane words) with full-length walks
    # (queries planted end to end, some with a deletion or insertion run)
    # past several of the walk's 32-row tiles and its lane windows
    from proovread_tpu_torch.align import sw
    from proovread_tpu_torch.align.params import AlignParams, BWA_SR_FINISH
    if which == "sw":
        R, m, n = 23, 32, 128
        ql = rng.integers(1, m + 1, R).astype(np.int32)
        ql[:3] = [0, m, 1]
    else:
        R, m, n = 6, 96, 640
        ql = np.full(R, m, np.int32)
        ql[5] = 70
    r = rng.integers(0, 4, (R, n)).astype(np.int8)
    q = np.full((R, m), 4, np.int8)
    for i in range(R):
        st = int(rng.integers(0, n - m)) if which == "sw" else 200 + 40 * i
        src = r[i, st:st + m].copy()
        if which == "sw" and i % 3 == 0:
            src = rng.integers(0, 4, m).astype(np.int8)
        elif i % 3 == 1:
            src = np.insert(src, 9, [1, 2])[:m]
        elif which == "sw640" and i % 3 == 2:
            src = np.concatenate([src[:40], src[70:], src[:30]])[:m]
        q[i, :ql[i]] = src[:ql[i]]
    q[5, 3] = 4
    r[::6, 40:44] = 4
    for ap in (AlignParams(min_out_score=0.0, score_per_base=False),
               BWA_SR_FINISH):
        args = (t(q), t(r), t(ql), ap)
        got, want = sw._sw_cuda(*args), sw.sw_batch_plain(*args)
        same(got, want)
        assert int(want.n_ops.max()) >= m // 2
        if which == "sw640":
            assert int((want.n_ops >= m - 8).sum()) >= 4, want.n_ops
elif which.startswith("lcs"):
    # "lcs": read/truth pairs at the edges of the words and of the lanes'
    # blocks, a warp a pair, packed four warps a block: empty read, empty
    # truth, truths of exactly 64, 2048 (32 words: one warp at one word a
    # lane) and 4096 bases (one at two), a read longer than its truth, N
    # codes on either side, runs of N in a truth, reads of ~12% errors
    # (for time, at most 500 bases of each truth but the 2,049-base one's:
    # a chain of ~2,000 steps at two words a lane);
    # "lcs_global" runs the same pairs, at most 500 bases of each truth
    # but the 3,000-base one's (runs of N: a ~2,900-step chain at two
    # words a lane), from the global-memory scratch instead; "lcs_wave":
    # truths of 3 warps
    # (8,193 to 12,000 bases) and
    # of 2 (4,097) at two words a lane beside short pairs in one block,
    # runs of N across the warps' edges (words that never match, all ones,
    # that a carry from below must cross) and over a whole warp, read
    # lengths that are no multiple of the 32-step tile
    from proovread_tpu_torch.obs import accuracy as acc
    if which == "lcs_global":
        acc.WAVE_MAX_WARPS = 0
    if which == "lcs_wave":
        tl = [12_000, 9_000, 8_193, 4_097, 300, 64, 1]
    else:
        tl = [0, 10, 64, 63, 65, 2048, 2049, 4096, 700, 130, 1, 3000, 2200,
              90]
    pairs = []
    for i, n_t in enumerate(tl):
        tr = rng.integers(0, 4, n_t).astype(np.int8)
        rd = tr.copy()
        err = rng.random(len(rd)) < 0.12
        rd[err] = rng.integers(0, 5, int(err.sum()))
        rd = np.delete(rd, np.flatnonzero(rng.random(len(rd)) < 0.04))
        if which == "lcs_wave":
            # reads of 600-800 bases from across the warps' edges
            if i == 0:
                rd = rd[3700:4501]
            if i == 1:
                tr[4000:4200] = 4                   # across warps 0 and 1
                tr[8100:8300] = 4                   # across warps 1 and 2
                rd = np.concatenate([rd[3800:4200], rd[-400:]])
            if i == 2:
                tr[4096:8192] = 4                   # all of warp 1
                rd = np.concatenate([rd[3500:3900], tr[8000:]])
            if i == 3:
                rd = rd[1700:2317]
        else:
            if i != (6 if which == "lcs" else 11) and len(rd) > 500:
                rd = rd[len(rd) // 3:len(rd) // 3 + 500]
            if i == 1:
                rd = np.zeros(0, np.int8)           # empty read
            if i == 8:
                rd = np.concatenate([rd, rng.integers(0, 4, 900)]).astype(
                    np.int8)
            if i == 9:
                tr[::7] = 4                         # N in the truth
                rd[::5] = 4                         # N in the read
            if i == 11:
                # runs of N in the truth: a carry from below must cross
                # them (in a lane, and between lanes)
                tr[320:384] = 4
                tr[1000:1300] = 4
                tr[2040:2120] = 4
        pairs.append((rd, tr))
    args = acc.pack_pairs(pairs, "cpu")
    to, po = acc._check(*args)
    plan = acc.lcs_plan(np.diff(to), np.diff(po))
    got = acc._lcs_cuda(*args, to, po)
    want = acc.lcs_lengths_plain(*args)
    same([got], [want])
    if which == "lcs_wave":
        assert plan["longest_pair_warps"] == 3 and plan["blocks"] >= 4, plan
        assert plan["pairs_by_warps"] == {1: 3, 2: 1, 3: 3}, plan
        assert plan["words_a_lane"][:4].tolist() == [2, 2, 2, 2], plan
        assert int(want[0]) > 500 and int(want[2]) > 300, want
    else:
        assert int(want[0]) == 0 and int(want[1]) == 0 and int(want[2]) > 40
        assert (plan["blocks"] == 0) == (which == "lcs_global"), plan
elif which.startswith("edit"):
    # the traceback's DP and walk kernels (a pair a warp, EDIT_WARPS pairs
    # a block), each pair against the plain version and the host numpy.
    # "edit": four pairs a block, a partial last block: a read of ~320
    # bases against a shorter truth (the swap), a band too small (doubled,
    # relaunched) and one of 0 (64), N on either side, negative codes on
    # both (equal ones match), a read past its truth, empty and identical
    # sides, a one-base pair. "edit_edges": paths pushed toward each band
    # edge (a block of the truth missing at the start and extra bases at
    # the end, and the mirror), at their distance as the band and one
    # below it, with the band at the shorter length (the whole matrix);
    # homopolymers and repeats whose equal-cost paths tie between the
    # diagonal and up across the row words' edges (rows 64, 128, 192).
    # "edit_wide": a pair whose window spans more than one warp's 32 row
    # words (two words a lane) and one of a warp's 32, both windows full
    # (the band's rows fill every stored word, and its top reaches the
    # word the window takes on as it slides), beside narrow pairs, four
    # pairs a block. "edit_global": the two full windows, the doubled band
    # and an edge pair with every window in the global scratch
    # (EDIT_REG_WORDS = 0).
    from proovread_tpu_torch.obs import accuracy as acc

    def mutated(tr, err=0.12):
        rd = tr.copy()
        sub = rng.random(len(rd)) < err
        rd[sub] = rng.integers(0, 5, int(sub.sum()))
        return np.delete(rd, np.flatnonzero(rng.random(len(rd)) < 0.05))

    def at_dist(a, b, less=0):
        return max(acc.edit_alignment(a, b, band=len(b))["dist"] - less, 1)

    tr2 = rng.integers(0, 4, 60).astype(np.int8)
    dbl = ((np.insert(mutated(tr2), 20, rng.integers(0, 4, 12)), tr2), 2)
    # windows exactly full: S = 32 W row words stored, so the band's top
    # reaches the word the window takes on top as it slides
    tr5 = rng.integers(0, 4, 4300).astype(np.int8)
    wide = ((mutated(tr5, 0.1)[:4100], tr5[:4200]), 1950)
    narrow = ((mutated(tr5, 0.1)[:2150], tr5[:2200]), 940)
    tr6 = rng.integers(0, 4, 200).astype(np.int8)
    edge_hi = (np.concatenate([tr6[24:], rng.integers(0, 4, 24)])
               .astype(np.int8), tr6)
    edge_lo = (np.concatenate([rng.integers(0, 4, 24), tr6[:-24]])
               .astype(np.int8), tr6)
    acc.EDIT_WARPS = 3 if which == "edit_edges" else 4
    if which == "edit":
        tr = rng.integers(0, 4, 280).astype(np.int8)
        long_rd = np.concatenate([mutated(tr), rng.integers(0, 4, 40)])
        tr3 = rng.integers(0, 4, 100).astype(np.int8)
        tr3[::9] = 4                                # N in the truth
        rd4 = mutated(tr2)
        rd4[::6] = 4                                # N in the read
        rd7, tr7 = mutated(tr2), tr2.copy()
        rd7[3:6], tr7[3:6] = -1, -1                 # negative codes
        rd7[30], tr7[40] = -2, -3
        cases = [((long_rd.astype(np.int8), tr), 40), dbl,
                 ((mutated(tr3), tr3), 0), ((rd4, tr2), 3), ((rd7, tr7), 9),
                 ((np.concatenate([mutated(tr2), rng.integers(0, 4, 30)])
                   .astype(np.int8), tr2), 12),     # read past its truth
                 ((tr2[:0], tr2), 8),               # empty read
                 ((tr2, tr2[:0]), 8),               # empty truth
                 ((tr2.copy(), tr2), 100),          # identical
                 ((tr2[:1].copy(), tr2[:1]), 1)]
    elif which == "edit_edges":
        cases = []
        for a, b in (edge_hi, edge_lo):
            cases += [((a, b), at_dist(a, b)), ((b, a), at_dist(a, b)),
                      ((a, b), at_dist(a, b, 1)), ((a, b), len(a))]
        for rep in ([0] * 200, [0, 1] * 100, [2, 2, 3] * 70):
            b = np.asarray(rep, np.int8)
            for a in (b[7:], np.concatenate([b[:60], b[71:]]),
                      np.concatenate([b, [0, 0, 1]])):
                a = np.asarray(a, np.int8)
                cases += [((a, b), at_dist(a, b)), ((b, a), 0)]
    elif which == "edit_wide":
        cases = [wide, narrow, ((mutated(tr6), tr6), 16),
                 ((tr2, mutated(tr2)), 5), dbl,
                 ((edge_hi[1], edge_hi[0]), 40)]
    else:
        acc.EDIT_REG_WORDS = 0
        cases = [wide, narrow, dbl, (edge_lo, at_dist(*edge_lo))]
    pairs = [c[0] for c in cases]
    bands = np.asarray([c[1] for c in cases])
    args = acc.pack_pairs(pairs, "cpu")
    to, po, w = acc._edit_args("edit", *args, bands)
    plan = acc.edit_plan(np.minimum(np.diff(to), np.diff(po)),
                         np.maximum(np.diff(to), np.diff(po)), w)
    n0 = acc.edit_alignments.launches
    got = acc._edit_cuda(*args, to, po, w)
    same([got], [acc.edit_alignments_plain(*args, bands)])
    host = [acc.edit_alignment(r, t, band=int(b)) for (r, t), b in
            zip(pairs, bands)]
    assert got.tolist() == [[h[k] for k in ("dist", "matches", "sub", "ins",
                                            "del")] for h in host]
    if which in ("edit_wide", "edit_global"):
        assert plan["S"][:2].tolist() == [64, 32], plan
        assert np.abs(plan["W"][:2]).tolist() == [2, 1], plan
        assert (plan["W"] < 0).all() == (which == "edit_global"), plan
    if which != "edit_edges":                       # a band doubled
        assert acc.edit_alignments.launches - n0 >= 2
    else:
        assert int(got[:, 0].max()) >= 40 and int(got[:, 3].sum()) > 0
elif which.startswith("scatter"):
    # "scatter": fractional weights onto a few hot cells (segments up to
    # ~100 long, crossing the blocks' edges), a keep mask, indices past the
    # target and negative ones, a non-zero target; then an empty keep.
    # "scatter_long": segments of 65 to ~870 entries that cross thread
    # blocks (256 sorted entries), beside short ones; an entry count that
    # is no multiple of 32. "scatter_edges": every entry dropped,
    # every entry onto one cell, and one entry.
    from proovread_tpu_torch.ops import scatter as sc
    cases = []
    if which == "scatter":
        N, M = 300, 3000
        hot = rng.integers(0, N, 40)
        idx = np.where(rng.random(M) < 0.8, rng.choice(hot, M),
                       rng.integers(-3, N + 5, M))
        cases.append((N, idx, rng.random(M) < 0.7))
    elif which == "scatter_long":
        N, M = 500, 4001
        seg = rng.choice([0, 7, 11, 123], M, p=[0.25, 0.25, 0.2, 0.3])
        idx = np.where(rng.random(M) < 0.9, seg, rng.integers(0, N, M))
        cases.append((N, idx, rng.random(M) < 0.8))
    else:
        N, M = 50, 1500
        cases += [(N, rng.integers(0, N, M), np.zeros(M, bool)),
                  (N, np.full(M, 17), rng.random(M) < 0.9),
                  (N, np.full(1, 3), np.ones(1, bool))]
    for N, idx, keep in cases:
        M = len(idx)
        w = (rng.random(M) * rng.choice([0.01, 1.0, 37.0], M)).astype(
            np.float32)
        base = (rng.random(N) * 3).astype(np.float32)
        args = (t(idx.astype(np.int64)), t(w), t(keep))
        want = sc.scatter_add_ordered_plain(t(base.copy()), *args)
        n0 = sc.scatter_add_ordered.launches
        got = sc._scatter_cuda(t(base.copy()), *args)
        same([got], [want])
        assert sc.scatter_add_ordered.launches == n0 + 1
        live = keep & (idx >= 0) & (idx < N)
        cnt = np.bincount(idx[live], minlength=N)
        if which == "scatter_long":
            assert cnt.max() > 800 and (cnt > 64).sum() >= 4, cnt.max()
        if which == "scatter":
            none = t(np.zeros(M, bool))
            same([sc._scatter_cuda(t(base.copy()), args[0], args[1], none)],
                 [t(base)])
print("EMU-OK", which)
"""


def _emulation_source(src: str) -> str:
    """Kernel source -> C++ the emulation compiles: dynamic shared arrays
    become the emulated shared buffer, static ones become function
    statics (one block runs at a time), launches (of a kernel or of a
    template kernel's instance, ``k<T><<<...>>>``) become pt_launch
    calls."""
    src = re.sub(r"extern __shared__ (?:__align__\(16\) )?([\w ]+?) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(g_smem);", src)
    src = src.replace("__shared__", "static")
    return re.sub(
        r"(\w+(?:<\w+>)?)<<<([^>]*)>>>\((.*?)\);",
        lambda m: ("pt_launch(" + ",".join(m.group(2).split(",")[:3])
                   + ", [&]{ " + m.group(1) + "(" + m.group(3) + "); });"),
        src, flags=re.S)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel sources for the CPU")
    d = tmp_path_factory.mktemp("cuda_emu")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_EMU)
    (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
    srcs = []
    for name in ("bsw.cu", "pileup.cu", "assemble.cu", "sw.cu", "lcs.cu",
                 "scatter.cu", "edit.cu"):
        out = d / (Path(name).stem + ".cpp")
        out.write_text(_emulation_source((CSRC / name).read_text()))
        srcs.append(str(out))
    so = d / "libemu.so"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         f"-I{d}", *srcs, "-o", str(so)],
        capture_output=True, text=True, timeout=300)
    if res.returncode != 0 and "no member named 'wait'" in res.stderr:
        pytest.skip("g++ lacks C++20 std::atomic::wait")
    assert res.returncode == 0, res.stderr[-3000:]
    return so


# reads a check's name and its log's path a line; forks a process that
# runs CHECKS for it with its output in the log; answers "PID <pid>" and
# "RC <exit code>" (negative: the signal that ended it). The server itself
# runs no torch operation, so each fork starts without torch's threads.
SERVER = r"""
import os, sys, traceback
import numpy, torch
from proovread_tpu_torch import kernels
lib, checks = sys.argv[1], open(sys.argv[2]).read()
code = compile(checks, "<checks>", "exec")
for line in sys.stdin:
    which, log = line.split()
    pid = os.fork()
    if pid == 0:
        fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
        sys.argv = ["checks", lib, which]
        rc = 0
        try:
            exec(code, {"__name__": "__main__"})
        except BaseException:
            traceback.print_exc()
            rc = 1
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    print("PID", pid, flush=True)
    print("RC", os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1]), flush=True)
"""


@pytest.fixture(scope="module")
def emu_server(emu_lib, tmp_path_factory):
    """The check server (``SERVER``), its answers a line in a queue, and
    a directory for the checks' logs."""
    d = tmp_path_factory.mktemp("cuda_emu_logs")
    (d / "checks.py").write_text(CHECKS)
    proc = subprocess.Popen([sys.executable, "-c", SERVER, str(emu_lib),
                             str(d / "checks.py")], cwd=ROOT, text=True,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    yield proc, lines, d
    proc.stdin.close()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("which", ["bsw96", "bsw64", "pileup",
                                   "pileup_clustered",
                                   "pileup_packed", "pileup_packed_clustered",
                                   "pileup_dense", "pileup_dense_clustered",
                                   "assemble", "assemble_long", "hcr",
                                   "hcr_long", "sw", "sw640", "lcs",
                                   "lcs_global", "lcs_wave", "edit",
                                   "edit_edges", "edit_wide", "edit_global",
                                   "scatter", "scatter_long",
                                   "scatter_edges"])
def test_kernel_source_matches_plain(emu_server, which):
    proc, lines, d = emu_server
    log = d / f"{which}.log"
    proc.stdin.write(f"{which} {log}\n")
    proc.stdin.flush()
    pid = int(lines.get(timeout=120).split()[1])
    try:
        rc = int(lines.get(timeout=300).split()[1])
    except queue.Empty:
        os.kill(pid, signal.SIGKILL)
        lines.get(timeout=60)
        pytest.fail(f"{which}: no result within 300 s")
    out = log.read_text()
    assert rc == 0 and f"EMU-OK {which}" in out, out[-3000:]
