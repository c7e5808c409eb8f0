"""The port's CUDA kernel sources, run on the CPU against their plain
versions.

There is no CPU mode for a CUDA kernel, so the sources under
``proovread_tpu_torch/csrc/`` are compiled here by g++ against a small
emulation of the CUDA runtime subset they use: one ``std::thread`` per CUDA
thread, blocks one after another (2-D grids row by row), ``std::barrier``
for ``__syncthreads``, ``__syncthreads_count`` and ``__syncthreads_or``,
per-warp barriers for ``__syncwarp``, ``__ballot_sync`` and the
``__shfl_up_sync`` / ``__shfl_down_sync`` / ``__shfl_xor_sync`` /
``__shfl_sync`` exchanges (any 32- or 64-bit type), GCC builtins for
``__popc``, ``__popcll``, ``__ffs`` and ``__clz``, ``__float_as_uint``,
``__funnelshift_l``, ``uint2``/``uint4`` and their ``make_``, ``float4``, and ``std::atomic_ref`` for
``atomicAdd`` (float, int, unsigned) and ``atomicOr``. The launch syntax
and the ``__shared__`` qualifiers are rewritten mechanically before
compiling.
Each check runs in a subprocess with a timeout. Tolerance: bitwise (integer
outputs, bsw score, pileup sums). Skips, with the reason, where g++ with
C++20 is missing."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "proovread_tpu_torch" / "csrc"

CUDA_RUNTIME_EMU = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
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
struct cudaFuncAttributes { int numRegs; };
template <typename T>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, T*) {
  a->numRegs = 0;
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
inline std::unique_ptr<std::barrier<>> g_bar;
inline std::vector<std::unique_ptr<std::barrier<>>> g_wbar;
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
    g_bar = std::make_unique<std::barrier<>>(nt);
    g_wbar.clear();
    for (int w = 0; w < (nt + 31) / 32; ++w)
      g_wbar.push_back(
          std::make_unique<std::barrier<>>(std::min(32, nt - 32 * w)));
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
    # R odd: several candidates (warps) per block, the last block partial
    S, m, B, Lp, R = 24, 112, 3, 800, 47
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
    # read/truth pairs at the edges of the words and of the lanes' blocks:
    # empty read, empty truth, truths of exactly 64, 2048 (a lane's block)
    # and 4096 bases, a read longer than its truth, N codes on either
    # side, runs of N in a truth, reads of ~12% errors; "lcs_global" puts
    # every pair past one
    # word a lane in the global-memory scratch instead of a register class
    from proovread_tpu_torch.obs import accuracy as acc
    if which == "lcs_global":
        acc.SMEM_MAX_WPL = 1
    tl = [0, 10, 64, 63, 65, 2048, 2049, 4096, 700, 130, 1, 3000, 2200, 90]
    pairs = []
    for i, n_t in enumerate(tl):
        tr = rng.integers(0, 4, n_t).astype(np.int8)
        rd = tr.copy()
        err = rng.random(len(rd)) < 0.12
        rd[err] = rng.integers(0, 5, int(err.sum()))
        rd = np.delete(rd, np.flatnonzero(rng.random(len(rd)) < 0.04))
        if i == 1:
            rd = np.zeros(0, np.int8)               # empty read
        if i == 8:
            rd = np.concatenate([rd, rng.integers(0, 4, 900)]).astype(np.int8)
        if i == 9:
            tr[::7] = 4                             # N in the truth
            rd[::5] = 4                             # N in the read
        if i == 11:
            # runs of N in the truth: words that never match, all ones,
            # that a carry from below must cross (in a lane, and between
            # lanes)
            tr[320:384] = 4
            tr[1000:1300] = 4
            tr[2040:2120] = 4
        pairs.append((rd, tr))
    args = acc.pack_pairs(pairs, "cpu")
    to, po = acc._check(*args)
    got = acc._lcs_cuda(*args, to, po)
    want = acc.lcs_lengths_plain(*args)
    same([got], [want])
    assert int(want[0]) == 0 and int(want[1]) == 0 and int(want[2]) > 40
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
                 "scatter.cu"):
        out = d / (Path(name).stem + ".cpp")
        out.write_text(_emulation_source((CSRC / name).read_text()))
        srcs.append(str(out))
    so = d / "libemu.so"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         f"-I{d}", *srcs, "-o", str(so)],
        capture_output=True, text=True, timeout=300)
    if res.returncode != 0 and "barrier" in res.stderr:
        pytest.skip("g++ lacks C++20 <barrier>")
    assert res.returncode == 0, res.stderr[-3000:]
    return so


@pytest.mark.parametrize("which", ["bsw96", "bsw64", "pileup",
                                   "pileup_clustered",
                                   "pileup_packed", "pileup_packed_clustered",
                                   "pileup_dense", "pileup_dense_clustered",
                                   "assemble", "assemble_long", "hcr",
                                   "hcr_long", "sw", "sw640", "lcs",
                                   "lcs_global", "scatter", "scatter_long",
                                   "scatter_edges"])
def test_kernel_source_matches_plain(emu_lib, which):
    out = subprocess.run([sys.executable, "-c", CHECKS, str(emu_lib), which],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and f"EMU-OK {which}" in out.stdout, \
        out.stderr[-3000:]
