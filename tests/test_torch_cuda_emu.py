"""The port's CUDA kernel sources, run on the CPU against their plain
versions.

There is no CPU mode for a CUDA kernel, so the sources under
``proovread_tpu_torch/csrc/`` are compiled here by g++ against a small
emulation of the CUDA runtime subset they use: one ``std::thread`` per CUDA
thread, blocks one after another, ``std::barrier`` for ``__syncthreads``,
per-warp barriers for ``__shfl_up_sync`` and ``std::atomic_ref`` for
``atomicAdd``. The launch syntax and the ``__shared__`` qualifiers are
rewritten mechanically before compiling. Each check runs in a subprocess
with a timeout. Tolerance: bitwise (integer outputs), exact (bsw score,
pileup counts). Skips, with the reason, where g++ with C++20 is missing."""

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
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __align__(x)
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <typename T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t cudaGetLastError() { return 0; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::unique_ptr<std::barrier<>> g_bar;
inline std::vector<std::unique_ptr<std::barrier<>>> g_wbar;
inline int g_xchg[1024];
alignas(16) inline unsigned char g_smem[240 * 1024];
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline int __shfl_up_sync(unsigned, int v, int o) {
  int t = threadIdx.x + threadIdx.y * blockDim.x, lane = t & 31, w = t >> 5;
  g_xchg[t] = v;
  g_wbar[w]->arrive_and_wait();
  int r = lane >= o ? g_xchg[t - o] : v;
  g_wbar[w]->arrive_and_wait();
  return r;
}
inline float atomicAdd(float* p, float v) {
  return std::atomic_ref<float>(*p).fetch_add(v);
}
template <typename F>
void pt_launch(dim3 grid, dim3 block, size_t, F body) {
  blockDim = block;
  gridDim = grid;
  int nt = block.x * block.y;
  for (unsigned b = 0; b < grid.x; ++b) {
    g_bar = std::make_unique<std::barrier<>>(nt);
    g_wbar.clear();
    for (int w = 0; w < (nt + 31) / 32; ++w)
      g_wbar.push_back(
          std::make_unique<std::barrier<>>(std::min(32, nt - 32 * w)));
    std::memset(g_smem, 0xAB, sizeof g_smem);  // shared memory is not zeroed
    std::vector<std::thread> th;
    for (int t = 0; t < nt; ++t)
      th.emplace_back([&, t, b] {
        blockIdx = dim3(b);
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
    S, m, B, Lp, R = 24, 112, 3, 800, 48
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
    same(bsw._bsw_cuda(*args), bsw.bsw_expand_v2_plain(*args))
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
elif which == "assemble":
    from proovread_tpu_torch.ops import assemble_kernel as ak
    B, L = 5, 700
    word = t(rng.integers(0, 2**31, (B, L)).astype(np.int32))
    lens = t(np.array([0, L, 350, 699, 1], np.int32))
    for Lp in (720, 600):
        same(ak.assemble_words_cuda(word, lens, Lp),
             ak.assemble_words_plain(word, lens, Lp))
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
print("EMU-OK", which)
"""


def _emulation_source(src: str) -> str:
    """Kernel source -> C++ the emulation compiles: dynamic shared arrays
    become the emulated shared buffer, static ones become function
    statics (one block runs at a time), launches become pt_launch calls."""
    src = re.sub(r"extern __shared__ (?:__align__\(16\) )?([\w ]+?) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(g_smem);", src)
    src = src.replace("__shared__", "static")
    return re.sub(
        r"(\w+)<<<([^>]*)>>>\((.*?)\);",
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
    for name in ("bsw.cu", "pileup.cu", "assemble.cu"):
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


@pytest.mark.parametrize("which", ["bsw96", "bsw64", "pileup", "assemble",
                                   "hcr"])
def test_kernel_source_matches_plain(emu_lib, which):
    out = subprocess.run([sys.executable, "-c", CHECKS, str(emu_lib), which],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and f"EMU-OK {which}" in out.stdout, \
        out.stderr[-3000:]
