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
// whole read set (~10^9 word-steps at E.coli class) is a fraction of a
// millisecond at the card's INT32 rate; the longest pair's chain is the
// floor. The earlier design gave a pair one warp whose lanes each rippled
// up to 24 words a step (a 45 kb truth: 704 words), so the chain was
// 46,846 steps of ~1,290 clocks on the H100 (PERF.md), and one kernel
// carrying every register class reserved 254 registers a thread.
//
// This design cuts the work of a step, not the number of steps:
// - A warp holds 32 * W words of V, W = 1 or 2 words a lane, in registers:
//   a lane's W words are one 64- or 128-bit integer X, so its sum
//   s = V + (V & M) is one addition (the carries inside the lane ride the
//   add-with-carry chain). The lane generates a carry when the top bit of
//   (V & M) | (V & ~s) is set (the carry out of a + b is the top bit of
//   (a & b) | ((a | b) & ~s), and V & M lies inside V) and propagates one
//   when s is all ones; two __ballot_sync words of those, plus the warp's
//   carry-in, make one 32-bit addition whose carries are each lane's
//   carry-in and whose bit 32 is the warp's carry out; then
//   V' = (V & ~M) | (s + carry-in). The match masks (A, C, G, T, and zero
//   for N and pads) sit in shared memory, a 16-byte slot a lane a code,
//   one load a step; N steps run as no-ops.
// - A pair takes K = ceil(k / (32 W)) warps, at W = 1 when one warp holds
//   its truth (up to 2,048 bases), else at W = 2 (a 45 kb truth: 11
//   warps; the wrapper picks W, up to 32 warps); warp b holds words
//   [32Wb, 32W(b + 1)). A step is issue-bound on its SM and costs a warp
//   nearly as many issue slots at W = 1 as at 2, so the longest pair at
//   22 warps of W = 1 measured slower than at 11 of W = 2 (PERF.md). The
//   warps run as a wavefront over tiles of 32 text steps: at tile step
//   t, warp b runs text tile t - b, taking its carry-in
//   at each of the tile's 32 steps from the 32-bit word of carries out
//   that warp b - 1 wrote to shared memory for the same tile one tile step
//   earlier (double-buffered by the tile's parity). One __syncthreads() a
//   tile step, no spin on flags. The chain is n + 32 (K - 1) steps.
// - Several pairs share a block (the wrapper packs whole pairs, most tile
//   steps first, into blocks of a power-of-two warp count), so short pairs
//   fill the SMs; a block runs as many tile steps as its longest pair.
// - Pad words above the truth have M = 0, so V & ~M keeps them all ones
//   whatever carry reaches them. The text comes 32 bytes a tile, one a
//   lane, and steps take theirs by __shfl_sync. At the end each lane
//   counts its zero bits with __popcll, the warp sums them, and the pair's
//   first warp adds its warps' sums.
// A pair needing more than the wrapper's largest block (32 warps, a truth
// over 131,072 bases) runs one warp a pair from a global-memory scratch
// (V, its block sums and its masks), lane l holding words l*w .. l*w+w-1.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr uint64_t ONES = ~0ull;
constexpr int TILE = 32;          // text steps a tile of the wavefront
constexpr int MAX_WARPS = 32;     // warps a block of the wavefront

using u128 = unsigned __int128;

// A lane's W words of V as one integer X (W = 1: uint64_t, W = 2: u128).
// tab: the warp's match masks, tab[c * 32 + lane] for code c (A, C, G, T;
// 4, N and pads: none), 16 bytes a slot.
template <class X>
__device__ __forceinline__ X mask_of(const uint4* tab, int c, int lane) {
  return *reinterpret_cast<const X*>(&tab[c * 32 + lane]);
}

// The warp's masks of the lane's words w0 .. w0+W-1 (bit b of word i:
// pattern position 64 * (w0 + i) + b holds that base).
template <class X>
__device__ void build_lane_masks(uint4* tab, const int8_t* pat, int64_t m,
                                 int64_t w0, int lane) {
  X a = 0, c = 0, g = 0, t = 0;
  for (int k = 0; k < 64 * int(sizeof(X) / 8); ++k) {
    const int64_t at = w0 * 64 + k;
    const int x = at < m ? pat[at] : 4;
    const X bit = X(1) << k;
    a |= x == 0 ? bit : X(0);
    c |= x == 1 ? bit : X(0);
    g |= x == 2 ? bit : X(0);
    t |= x == 3 ? bit : X(0);
  }
  const X rows[5] = {a, c, g, t, X(0)};
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    tab[r * 32 + lane] = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<X*>(&tab[r * 32 + lane]) = rows[r];
  }
}

// The 32 steps of one text tile (codes tb, one a lane, 4 past the read);
// cin_word bit j is the carry into the warp's lowest word at step j, and
// bit j of the result the carry out of its top word. A step: the lane's
// sum s = V + (V & M) in one X addition; it generates a carry when the top
// bit of (V & M) | (V & ~s) is set (the carry out of a + b is the top bit
// of (a & b) | ((a | b) & ~s), and V & M lies inside V) and propagates one
// when s is all ones; an N step has M = 0 and changes nothing.
template <class X>
__device__ __forceinline__ uint32_t wave_tile(X& v, const uint4* tab, int tb,
                                              uint32_t cin_word, int lane) {
  constexpr int TOP = 8 * sizeof(X) - 1;
  uint32_t cout_word = 0;
#pragma unroll 8
  for (int j = 0; j < TILE; ++j) {
    const X mm = mask_of<X>(tab, __shfl_sync(FULL, tb, j), lane);
    const X u = v & mm;
    const X s = v + u;
    const unsigned g = __ballot_sync(FULL, int((u | (v & ~s)) >> TOP));
    const unsigned p = __ballot_sync(FULL, s == ~X(0));
    const unsigned a = g | p;
    // carry into each lane: lane l-1 generates, or propagates a carry in;
    // into lane 0 the warp's carry-in; bit 32 is the warp's carry out
    const uint64_t tot = uint64_t(a) + g + ((cin_word >> j) & 1u);
    cout_word |= uint32_t(tot >> 32) << j;
    const X cin = X(((uint32_t(tot) ^ a ^ g) >> lane) & 1u);
    v = (v & ~mm) | (s + cin);
  }
  return cout_word;
}

__device__ __forceinline__ int zero_bits(uint64_t v) {
  return 64 - __popcll(v);
}
__device__ __forceinline__ int zero_bits(u128 v) {
  return 128 - __popcll(uint64_t(v)) - __popcll(uint64_t(v >> 64));
}

// The wavefront's pairs at X words a lane (the block's loop; see
// lcs_wave_kernel).
template <class X>
__device__ int wave_pair(const int8_t* t, int64_t n, const int8_t* pat,
                         int64_t m, int b, int warp, int nsteps,
                         uint4* tab, uint32_t (*carry_s)[MAX_WARPS],
                         int lane) {
  build_lane_masks<X>(tab, pat, m, (int64_t(b) * 32 + lane) *
                      int64_t(sizeof(X) / 8), lane);
  X v = ~X(0);
  const int64_t ntiles = (n + TILE - 1) / TILE;
  for (int ts = 0; ts < nsteps; ++ts) {
    const int64_t x = ts - b;             // this warp's text tile
    if (x >= 0 && x < ntiles) {
      const uint32_t cin = b > 0 ? carry_s[x & 1][warp - 1] : 0u;
      const int64_t j = x * TILE + lane;
      int tb = j < n ? int(t[j]) : 4;
      tb = tb >= 0 && tb < 4 ? tb : 4;
      const uint32_t cout = wave_tile<X>(v, tab, tb, cin, lane);
      if (lane == 0) carry_s[x & 1][warp] = cout;
    }
    __syncthreads();
  }
  return zero_bits(v);
}

// slots [gridDim.x * warps a block]: pair * 64 + (W - 1) * 32 + b for warp
// b of a pair at W words a lane, or -1 (an idle warp); steps [gridDim.x]:
// the block's tile steps. Dynamic shared memory: 5 * 32 mask slots of 16
// bytes a warp.
__global__ void __launch_bounds__(1024)
lcs_wave_kernel(const int8_t* txt, const int64_t* txt_off, const int8_t* pat,
                const int64_t* pat_off, const int32_t* slots,
                const int32_t* steps, int64_t* out) {
  extern __shared__ __align__(16) uint4 lcs_tab[];
  __shared__ uint32_t carry_s[2][MAX_WARPS];
  __shared__ int zeros_s[MAX_WARPS];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = slots[blockIdx.x * nw + warp];
  const int p = slot >> 6, wide = (slot >> 5) & 1, b = slot & 31;
  const int nsteps = steps[blockIdx.x];
  uint4* tab = lcs_tab + warp * 5 * 32;
  int zeros = 0;
  int64_t m = 0;
  if (slot < 0) {
    for (int ts = 0; ts < nsteps; ++ts) __syncthreads();
  } else {
    const int64_t n = txt_off[p + 1] - txt_off[p];
    m = pat_off[p + 1] - pat_off[p];
    const int8_t* t = txt + txt_off[p];
    const int8_t* q = pat + pat_off[p];
    zeros = wide
        ? wave_pair<u128>(t, n, q, m, b, warp, nsteps, tab, carry_s, lane)
        : wave_pair<uint64_t>(t, n, q, m, b, warp, nsteps, tab, carry_s,
                              lane);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) zeros += __shfl_xor_sync(FULL, zeros, o);
  if (lane == 0) zeros_s[warp] = zeros;
  __syncthreads();
  if (slot >= 0 && b == 0 && lane == 0) {
    const int64_t k = (m + 63) / 64;
    const int64_t per = wide ? 64 : 32;     // words a warp
    const int K = int((k + per - 1) / per);
    int64_t sum = 0;
    for (int i = 0; i < K; ++i) sum += zeros_s[warp + i];
    out[p] = sum;
  }
}

// A pair past the largest block: V and its block sums S of one lane in
// global memory, lane-interleaved like the masks.
struct GlobalWords {
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

__device__ int64_t lcs_global_steps(GlobalWords& st, int w,
                                    const int8_t* txt, int64_t n,
                                    const uint64_t* pm, int lane) {
  for (int i = 0; i < w; ++i) st.V(i) = ONES;
  int tb = 0;
  for (int64_t j = 0; j < n; ++j) {
    if ((j & 31) == 0)
      tb = j + lane < n ? int(txt[j + lane]) : 4;
    const int c = __shfl_sync(FULL, tb, int(j & 31));
    if (c < 0 || c > 3) continue;        // N never matches: V unchanged
    const uint64_t* row = pm + c * w * 32 + lane;
    uint64_t carry = 0;
    bool all_ones = true;
    for (int i = 0; i < w; ++i) {
      const uint64_t m = row[i * 32];
      const uint64_t v = st.V(i);
      const uint64_t t = v + (v & m);
      const uint64_t s = t + carry;
      carry = (t < v) | (s < t);
      all_ones &= s == ONES;
      st.S(i) = s;
      st.V(i) = v & ~m;
    }
    const unsigned g = __ballot_sync(FULL, carry != 0);
    const unsigned p = __ballot_sync(FULL, all_ones);
    const unsigned a = g | p;
    uint64_t cin = (((a + g) ^ a ^ g) >> lane) & 1u;
    for (int i = 0; i < w; ++i) {
      const uint64_t s = st.S(i) + cin;
      cin &= s == 0;
      st.V(i) |= s;
    }
  }
  int64_t zeros = 0;
  for (int i = 0; i < w; ++i) zeros += 64 - __popcll(st.V(i));
  return zeros;
}

// gpairs [G]: the pairs; gw [G]: words a lane; gofs [G]: offset of a pair's
// scratch (4 mask rows, V, S; 6 * 32 * w words).
__global__ void __launch_bounds__(32)
lcs_global_kernel(const int8_t* txt, const int64_t* txt_off,
                  const int8_t* pat, const int64_t* pat_off,
                  const int32_t* gpairs, const int32_t* gw,
                  const int64_t* gofs, uint64_t* gscratch, int64_t* out) {
  const int lane = threadIdx.x;
  const int p = gpairs[blockIdx.x];
  const int w = gw[blockIdx.x];
  uint64_t* base = gscratch + gofs[blockIdx.x];
  build_masks(pat + pat_off[p], pat_off[p + 1] - pat_off[p], w, lane, base);
  GlobalWords st{base + 4 * w * 32 + lane, base + 5 * w * 32 + lane};
  int64_t zeros = lcs_global_steps(st, w, txt + txt_off[p],
                                   txt_off[p + 1] - txt_off[p], base, lane);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) zeros += __shfl_xor_sync(FULL, zeros, o);
  if (lane == 0) out[p] = zeros;
}

}  // namespace

// txt/pat i8 flat, txt_off/pat_off i64 [P+1]; the wavefront's blocks:
// slots i32 [blocks * warps], steps i32 [blocks]; the global pairs: gpairs
// i32 [G], gw i32 [G], gofs i64 [G], gscratch u64; out i64 [P], zeroed by
// the caller (pairs in neither list keep 0).
PT_EXPORT int pt_lcs_lengths(const void* txt, const void* txt_off,
                             const void* pat, const void* pat_off,
                             const void* slots, const void* steps,
                             int blocks, int warps, const void* gpairs,
                             const void* gw, const void* gofs,
                             void* gscratch, int G, void* out,
                             void* stream) {
  if (warps < 1 || warps > MAX_WARPS) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t8 = static_cast<const int8_t*>(txt);
  const auto* to = static_cast<const int64_t*>(txt_off);
  const auto* p8 = static_cast<const int8_t*>(pat);
  const auto* po = static_cast<const int64_t*>(pat_off);
  auto* o = static_cast<int64_t*>(out);
  if (blocks > 0) {
    const size_t smem = size_t(warps) * 5 * 32 * sizeof(uint4);
    cudaError_t e = pt_reserve_smem(lcs_wave_kernel, smem);
    if (e != cudaSuccess) return e;
    lcs_wave_kernel<<<blocks, warps * 32, smem, s>>>(
        t8, to, p8, po, static_cast<const int32_t*>(slots),
        static_cast<const int32_t*>(steps), o);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (G > 0) {
    lcs_global_kernel<<<G, 32, 0, s>>>(
        t8, to, p8, po, static_cast<const int32_t*>(gpairs),
        static_cast<const int32_t*>(gw), static_cast<const int64_t*>(gofs),
        static_cast<uint64_t*>(gscratch), o);
  }
  return cudaGetLastError();
}

// The wavefront kernel's registers a thread and resident blocks an SM for
// blocks of ``warps`` warps.
PT_EXPORT int pt_lcs_occupancy(int warps, void* regs, void* blocks_per_sm) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, lcs_wave_kernel);
  if (e != cudaSuccess) return e;
  *static_cast<int*>(regs) = a.numRegs;
  const size_t smem = size_t(warps) * 5 * 32 * sizeof(uint4);
  e = pt_reserve_smem(lcs_wave_kernel, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      static_cast<int*>(blocks_per_sm), lcs_wave_kernel, warps * 32, smem);
}
