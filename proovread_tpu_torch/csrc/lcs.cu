// Bit-parallel LCS length of (read, truth) pairs: the accuracy scoreboard's
// identity numerator.
//
// Replaces proovread_tpu/obs/accuracy.py:lcs_lengths, which is host numpy
// (no Pallas kernel): the CIPR bit-vector recurrence
//     V' = (V + (V & M)) | (V & ~M)
// over k = ceil(len(truth) / 64) little-endian 64-bit words, all pairs of a
// group advanced in lockstep, the carries between words resolved by a
// Kogge-Stone generate/propagate scan (_mw_add). V starts all ones; pad and
// N positions never match; the carry out of the top word is dropped; the
// LCS is the count of zero bits, 64k - popcount(V).
//
// What bounds it: a dependent chain of len(read) steps per pair, each a
// multiword addition whose carry crosses every word. The integer work of a
// whole read set (~10^9 word-steps at E.coli class) is milliseconds on this
// card; the longest pair's chain is the floor. So one warp takes one pair
// (a block is one warp; blocks come longest pair first): lane l holds the
// contiguous words l*W .. l*W+W-1 of V in registers (W = words a lane, one
// of the template classes 1..32, chosen per pair by the wrapper). A step
// adds the lane's block with its carries rippling inside the lane, then
// resolves the carries between lanes from two __ballot_sync words ("this
// lane's block generates a carry", "it propagates one"): the carry into
// every lane is one 32-bit addition of those words, the warp form of the
// reference's scan. Pad words above the truth have M = 0, so the OR with
// V & ~M keeps them all ones whatever carry reaches them. The match masks
// (M for A, C, G, T; N and pads never match and their steps are skipped)
// are built once per pair by the lane that reads them, in shared memory,
// lane-interleaved so a warp's loads hit 32 consecutive words. A pair
// whose truth needs more than the wrapper's largest register class keeps
// V, its block sums and its masks in a global scratch of the same layout.
// The text comes 32 bytes at a time, one a lane, and steps take theirs by
// __shfl_sync. At the end each lane counts its zero bits with __popcll and
// the warp sums them.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr uint64_t ONES = ~0ull;

// V and the block sums S of one lane, in registers (W > 0) ...
template <int W>
struct RegWords {
  static constexpr int kW = W;
  uint64_t v[W], s[W];
  __device__ __forceinline__ uint64_t& V(int i) { return v[i]; }
  __device__ __forceinline__ uint64_t& S(int i) { return s[i]; }
};

// ... or in global memory, lane-interleaved like the masks (W runtime)
struct GlobalWords {
  static constexpr int kW = 0;
  uint64_t* v;
  uint64_t* s;
  __device__ __forceinline__ uint64_t& V(int i) { return v[i * 32]; }
  __device__ __forceinline__ uint64_t& S(int i) { return s[i * 32]; }
};

// Match masks of one pair: pm[(c * w + i) * 32 + lane] holds bits
// 64 * (lane * w + i) + b of "pattern position == c", c = 0..3.
__device__ void build_masks(const int8_t* pat, int64_t m, int w, int lane,
                            uint64_t* pm) {
  for (int i = 0; i < w; ++i) {
    uint64_t bits[4] = {0, 0, 0, 0};
    const int64_t base = int64_t(lane * w + i) * 64;
    for (int b = 0; b < 64 && base + b < m; ++b) {
      const int c = pat[base + b];
      if (c >= 0 && c < 4) bits[c] |= 1ull << b;
    }
    for (int c = 0; c < 4; ++c) pm[(c * w + i) * 32 + lane] = bits[c];
  }
}

template <class St>
__device__ int64_t lcs_steps(St& st, int w_rt, const int8_t* txt, int64_t n,
                             const uint64_t* pm, int lane) {
  const int w = St::kW ? St::kW : w_rt;
#pragma unroll
  for (int i = 0; i < w; ++i) st.V(i) = ONES;
  int tb = 0;
  for (int64_t j = 0; j < n; ++j) {
    if ((j & 31) == 0)
      tb = j + lane < n ? int(txt[j + lane]) : 4;
    const int c = __shfl_sync(FULL, tb, int(j & 31));
    if (c < 0 || c > 3) continue;        // N never matches: V unchanged
    const uint64_t* row = pm + c * w * 32 + lane;
    // the lane's block sum V + (V & M), carries rippling inside the lane
    uint64_t carry = 0;
    bool all_ones = true;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const uint64_t m = row[i * 32];
      const uint64_t v = st.V(i);
      const uint64_t t = v + (v & m);
      const uint64_t s = t + carry;
      carry = (t < v) | (s < t);          // unsigned overflow: generate
      all_ones &= s == ONES;
      st.S(i) = s;
      st.V(i) = v & ~m;
    }
    // carry into each lane: lane l-1 generates, or propagates a carry in
    const unsigned g = __ballot_sync(FULL, carry != 0);
    const unsigned p = __ballot_sync(FULL, all_ones);
    const unsigned a = g | p;
    uint64_t cin = (((a + g) ^ a ^ g) >> lane) & 1u;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const uint64_t s = st.S(i) + cin;
      cin &= s == 0;
      st.V(i) |= s;
    }
  }
  int64_t zeros = 0;
#pragma unroll
  for (int i = 0; i < w; ++i) zeros += 64 - __popcll(st.V(i));
  return zeros;
}

template <int W>
__device__ int64_t lcs_smem_pair(const int8_t* txt, int64_t n,
                                 const int8_t* pat, int64_t m, int lane,
                                 uint64_t* pm) {
  build_masks(pat, m, W, lane, pm);
  RegWords<W> st;
  return lcs_steps(st, W, txt, n, pm, lane);
}

// order: pairs longest first; wcls: words a lane (0: empty pair); gofs:
// offset of a pair's global scratch (4 mask rows, V, S) in words, or -1
// when it runs from shared memory at its register class.
__global__ void __launch_bounds__(32)
lcs_kernel(const int8_t* txt, const int64_t* txt_off, const int8_t* pat,
           const int64_t* pat_off, const int32_t* order,
           const int32_t* wcls, const int64_t* gofs, uint64_t* gscratch,
           int64_t* out) {
  extern __shared__ __align__(16) uint64_t lcs_smem[];
  const int lane = threadIdx.x;
  const int p = order[blockIdx.x];
  const int w = wcls[p];
  const int8_t* t = txt + txt_off[p];
  const int64_t n = txt_off[p + 1] - txt_off[p];
  const int8_t* q = pat + pat_off[p];
  const int64_t m = pat_off[p + 1] - pat_off[p];
  int64_t zeros = 0;
  if (w > 0 && n > 0) {
    if (gofs[p] >= 0) {
      uint64_t* base = gscratch + gofs[p];
      build_masks(q, m, w, lane, base);
      GlobalWords st{base + 4 * w * 32 + lane, base + 5 * w * 32 + lane};
      zeros = lcs_steps(st, w, t, n, base, lane);
    } else {
      switch (w) {
        case 1: zeros = lcs_smem_pair<1>(t, n, q, m, lane, lcs_smem); break;
        case 2: zeros = lcs_smem_pair<2>(t, n, q, m, lane, lcs_smem); break;
        case 3: zeros = lcs_smem_pair<3>(t, n, q, m, lane, lcs_smem); break;
        case 4: zeros = lcs_smem_pair<4>(t, n, q, m, lane, lcs_smem); break;
        case 6: zeros = lcs_smem_pair<6>(t, n, q, m, lane, lcs_smem); break;
        case 8: zeros = lcs_smem_pair<8>(t, n, q, m, lane, lcs_smem); break;
        case 12: zeros = lcs_smem_pair<12>(t, n, q, m, lane, lcs_smem); break;
        case 16: zeros = lcs_smem_pair<16>(t, n, q, m, lane, lcs_smem); break;
        case 24: zeros = lcs_smem_pair<24>(t, n, q, m, lane, lcs_smem); break;
        case 32: zeros = lcs_smem_pair<32>(t, n, q, m, lane, lcs_smem); break;
        default: zeros = -1;              // not a class: the wrapper's fault
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) zeros += __shfl_xor_sync(FULL, zeros, o);
  if (lane == 0) out[p] = zeros < 0 ? -1 : zeros;
}

}  // namespace

// txt/pat i8 flat, txt_off/pat_off i64 [P+1]; order i32 [P]; wcls i32 [P];
// gofs i64 [P]; gscratch u64 (the global pairs' words); out i64 [P].
// smem_w: the largest shared-memory class among the pairs (0: none).
PT_EXPORT int pt_lcs_lengths(const void* txt, const void* txt_off,
                             const void* pat, const void* pat_off,
                             const void* order, const void* wcls,
                             const void* gofs, void* gscratch, int P,
                             int smem_w, void* out, void* stream) {
  if (P <= 0) return cudaSuccess;
  const size_t smem = size_t(4) * 32 * smem_w * sizeof(uint64_t);
  cudaError_t e = pt_reserve_smem(lcs_kernel, smem);
  if (e != cudaSuccess) return e;
  const auto s = static_cast<cudaStream_t>(stream);
  lcs_kernel<<<P, 32, smem, s>>>(
      static_cast<const int8_t*>(txt), static_cast<const int64_t*>(txt_off),
      static_cast<const int8_t*>(pat), static_cast<const int64_t*>(pat_off),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(wcls),
      static_cast<const int64_t*>(gofs), static_cast<uint64_t*>(gscratch),
      static_cast<int64_t*>(out));
  return cudaGetLastError();
}

// The kernel's registers a thread and resident blocks (warps) an SM at the
// shared memory of a launch whose largest shared-memory class is smem_w.
PT_EXPORT int pt_lcs_occupancy(int smem_w, void* regs, void* blocks_per_sm) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, lcs_kernel);
  if (e != cudaSuccess) return e;
  *static_cast<int*>(regs) = a.numRegs;
  const size_t smem = size_t(4) * 32 * smem_w * sizeof(uint64_t);
  e = pt_reserve_smem(lcs_kernel, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      static_cast<int*>(blocks_per_sm), lcs_kernel, 32, smem);
}
