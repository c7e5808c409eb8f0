// Affine-gap Smith-Waterman with clip penalties and traceback.
//
// Replaces proovread_tpu/align/sw.py:sw_batch, which is XLA (no Pallas
// kernel): a lax.scan over query rows with an associative_scan running max
// inside each row (_dp_one), then a lax.scan of m+n traceback steps over
// per-cell direction bits (_traceback_one). The host mapper calls it for
// siamaera (m=256, n=384, chunks of 2048), ccs-1 and utg (m=512, n=640)
// and the scan engine (m=128, n=256, chunks of 4096).
//
// Two kernels. The DP kernel takes one candidate a warp (four a block):
// lane L keeps columns j = L*K + k (K = n/32, a template parameter) of the
// previous row's H and F, and this row's H', in registers; the diagonal H
// and the shifted H'/E come from the lane's own previous register or, for
// its first column, from lane L-1 by __shfl_up_sync; the deletion running
// max is the lane's own maximum, a 5-step __shfl_up_sync inclusive scan of
// the lane maxima, then each column's exclusive value as a running max
// (max is exact, so any order gives the reference's bits). The DP stops at
// row max(qlen, 1): later rows change no output. The end cell is a running
// first-index maximum per lane, then a butterfly reduction that keeps the
// larger score and, on equal scores, the smaller row-major index
// (jnp.argmax). The walk kernel then walks each path back, a warp a
// candidate.
//
// What bounds it (measured on the H100, PERF.md): instruction issue. A
// single kernel with compare-and-select maxima and a direction byte a
// cell issued about 78 instructions a DP cell (1.63 cells an SM a clock),
// most of them compares and selects, which Hopper issues at 64 lanes an
// SM a clock (half its f32 add rate); its walk (one lane, a dependent
// device-memory load a step, after its DP) took 10-18% of a launch. This
// DP issues about 33 a cell. So, per cell of the DP:
// - each maximum is one fmaxf, and each direction decision is the sign bit
//   of a difference (an f32 subtraction) shifted into a per-lane bit-plane
//   word with one funnel shift, not a compare, a select and an OR. Both
//   are exact: fmaxf differs from the reference's maximum only between +0
//   and -0, and the sign of a - b is the sign of the comparison for finite
//   a != b and +0 for a == b; no -0 arises in the DP, since the kernel
//   forms its negated constants as 0 - x and no sum or difference of
//   values that are not -0 is -0. (The plain version negates clip and the
//   substitution penalties directly; with a penalty of 0 it may hold a -0
//   where the kernel holds +0, which changes an output only if a
//   substitution score is 0 as well.)
// - the substitution score is a load: each warp keeps its candidate's
//   scores of the five query classes (A, C, G, T, N) against every column
//   in shared memory, and a row reads its class's, four columns a load.
// - (j + 1) * e_del comes from shared memory (once a block), row 1's
//   "no insertion from row 0" is h - 1e9 = NEG exactly (h is 0 there),
//   and the exclusive running max of a column needs no array.
// The direction decisions go to device memory as five bit-planes a row
// (is_start, F chosen over M, F extends, E chosen, E does not extend), K
// bits a lane a plane, packed in one 8- or 16-byte record a lane a row
// (one vector store; 5 of 6.4 bits a cell at K=20, not a byte). The
// walk has
// a kernel of its own, so its code costs the DP no registers and every
// walk runs at once (the walk inside the DP kernel, after each warp's DP,
// measured slower: PERF.md). The whole warp walks: it stages the records
// of 32 rows x 4 lanes above and to the left of the current cell in
// shared memory, walks inside that tile, every lane the same
// steps, and stages the next tile when the path leaves it: a device-memory
// round trip a tile, not a step. In FULL mode the lanes look at the next
// 32 cells down the diagonal at once, and a run of M steps (most of a
// path) is taken, and stored coalesced, in one pass; other steps go one
// at a time. The warp pads ops_rev / step_i / step_j with OP_NONE / 0.
// Build with -fmad=false: the
// reference rounds (u_excl - o_del) - j_e and h_prev - (o_ins + e_ins) op
// by op in f32, and compares e_shift - e_del against
// hp_shift - (o_del + e_del) (XLA folds the two constants of the
// reference's hp_shift - o_del - e_del).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr float NEG = -1e9f;      // exact in f32 (ulp 64)
constexpr float BELOW = -2e9f;    // below every selection score
constexpr float ROW0 = 1e9f;      // row 1: f_open = 0 - ROW0 = NEG
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;           // candidates a block of the DP
constexpr int WALK_WARPS = 8;      // candidates a block of the walk

// direction bits of the walk (align/sw.py), traceback modes and op codes
constexpr int BIT_E = 4, BIT_EEXT = 8, BIT_FEXT = 16;
constexpr int TB_FULL = 0, TB_HPRIME = 1, TB_E = 2, TB_F = 3, TB_DONE = 4;
constexpr int OP_M = 0, OP_I = 1, OP_D = 2, OP_NONE = 3;

// the five decision planes of a row: bit K-1-k of a lane's plane word is
// column L*K + k's decision; a lane's five words are packed into one
// record a row, plane p at bits [p*K, p*K + K) of 64 (K <= 12) or 128
// bits, stored [row][lane]
constexpr int PLANES = 5;
constexpr int P_START = 0, P_FSRC = 1, P_FEXT = 2, P_E = 3, P_NOEEXT = 4;
// the walk's tile: rows x lanes of records
constexpr int TILE_ROWS = 32, TILE_LANES = 4;

struct SwParams {
  float match, mis_neg, n_neg, o_del, e_del, oe_del, oe_ins, e_ins, clip,
      clip_neg;
};

template <int K>
using Rec = std::conditional_t<(PLANES * K <= 64), uint2, uint4>;

// a record as two 64-bit halves, and one decision bit of it
struct Bits128 {
  uint64_t lo, hi;
};
__device__ __forceinline__ Bits128 unpack(const uint2& r) {
  return {uint64_t(r.x) | uint64_t(r.y) << 32, 0};
}
__device__ __forceinline__ Bits128 unpack(const uint4& r) {
  return {uint64_t(r.x) | uint64_t(r.y) << 32,
          uint64_t(r.z) | uint64_t(r.w) << 32};
}
template <int K>
__device__ __forceinline__ int decision(const Bits128& b, int plane, int k) {
  const int pos = plane * K + (K - 1 - k);
  return int((pos < 64 ? b.lo >> pos : b.hi >> (pos - 64)) & 1u);
}

// one row's five plane words of a lane as its record
template <int K>
__device__ __forceinline__ void pack_record(Rec<K>* dst, const uint32_t* w) {
  uint64_t lo = 0, hi = 0;
#pragma unroll
  for (int p = 0; p < PLANES; ++p) {
    const int o = p * K;
    const uint64_t v = w[p];
    if (o + K <= 64) {
      lo |= v << o;
    } else if (o >= 64) {
      hi |= v << (o - 64);
    } else {
      lo |= v << o;
      hi |= v >> (64 - o);
    }
  }
  if constexpr (PLANES * K <= 64) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(uint32_t(lo),
                                                uint32_t(lo >> 32));
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(
        uint32_t(lo), uint32_t(lo >> 32), uint32_t(hi), uint32_t(hi >> 32));
  }
}

// shift the sign bit of d (the decision "d < 0") into a plane word
__device__ __forceinline__ uint32_t push_sign(float d, uint32_t plane) {
  return __funnelshift_l(__float_as_uint(d), plane, 1);
}

// The DP of each candidate, a warp a candidate: its bit-planes to dirs,
// its end cell to f32out / i32out.
template <int K>
__global__ void __launch_bounds__(32 * WARPS, 4)
sw_dp_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
             const int32_t* __restrict__ qlen, int R, int m, SwParams p,
             void* __restrict__ dirs, float* __restrict__ f32out,
             int32_t* __restrict__ i32out) {
  constexpr int n = 32 * K;
  // (j + 1) * e_del (0-based j), then each warp's substitution scores
  // [query base 0-3, N][column]
  extern __shared__ __align__(16) float dp_smem[];
  float* je_s = dp_smem;
  for (int j = threadIdx.x; j < n; j += 32 * WARPS)
    je_s[j] = (float(j) + 1.0f) * p.e_del;
  __syncthreads();
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int c = blockIdx.x * WARPS + wid;
  if (c >= R) return;  // the whole warp leaves together
  const int j0 = lane * K;
  const int8_t* qc = q + size_t(c) * m;
  Rec<K>* dc = static_cast<Rec<K>*>(dirs) + size_t(c) * m * 32;
  float* sub_w = dp_smem + n + wid * 5 * n;
  const float* je = je_s + j0;

  float h[K], f[K], hp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int rc = r[size_t(c) * n + j0 + k];
#pragma unroll
    for (int b = 0; b < 5; ++b)  // _sub_table: N (4) and GAP (5) score -n_pen
      sub_w[b * n + j0 + k] =
          (b >= 4 || rc >= 4) ? p.n_neg : (b == rc ? p.match : p.mis_neg);
    h[k] = 0.0f;
    f[k] = NEG;
  }
  __syncwarp();
  const int ql = qlen[c];
  const int rows = min(max(ql, 1), m);

  // per lane: the first maximum in row-major order
  float best_sel = BELOW, best_h = 0.0f;
  int best_k = 0, best_row = 1;

  for (int i = 1; i <= rows; ++i) {
    // this row's substitution scores, four columns a load
    const float4* sub4 = reinterpret_cast<const float4*>(
        sub_w + min(int(qc[i - 1]), 4) * n + j0);
    const float start_prev = i == 1 ? 0.0f : p.clip_neg;
    const float oe_row = i == 1 ? ROW0 : p.oe_ins;
    float h_left = __shfl_up_sync(FULL, h[K - 1], 1);
    if (lane == 0) h_left = NEG;

    uint32_t p_start = 0, p_fsrc = 0, p_fext = 0;
    float tot = NEG, tot_but_last = NEG;  // lane maxima of hp + j_e
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float diag_shift = k == 0 ? h_left : h[k - 1];
      const float diag_base = fmaxf(diag_shift, start_prev);
      p_start = push_sign(diag_shift - start_prev, p_start);
      const float f_open = h[k] - oe_row;
      const float f_ext = f[k] - p.e_ins;
      const float f_row = fmaxf(f_open, f_ext);
      p_fext = push_sign(f_open - f_ext, p_fext);
      const float4 s4 = sub4[k / 4];
      const float sub =
          k % 4 == 0 ? s4.x : k % 4 == 1 ? s4.y : k % 4 == 2 ? s4.z : s4.w;
      const float m_row = diag_base + sub;
      hp[k] = fmaxf(m_row, f_row);
      p_fsrc = push_sign(m_row - f_row, p_fsrc);
      f[k] = f_row;
      if (k == K - 1) tot_but_last = tot;
      tot = fmaxf(tot, hp[k] + je[k]);
    }
    // running max of hp + j_e along the row: the lanes' inclusive scan,
    // then each column's exclusive value
    float inc = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      inc = fmaxf(inc, __shfl_up_sync(FULL, inc, o));
    float excl = __shfl_up_sync(FULL, inc, 1);
    if (lane == 0) excl = NEG;
    const float e_last = (fmaxf(excl, tot_but_last) - p.o_del) - je[K - 1];
    float hp_left = __shfl_up_sync(FULL, hp[K - 1], 1);
    float e_left = __shfl_up_sync(FULL, e_last, 1);
    if (lane == 0) hp_left = e_left = NEG;

    const float tail = i == ql ? 0.0f : p.clip;
    const float row_best = best_sel;
    uint32_t p_e = 0, p_noeext = 0;
    float run = excl, e_shift = e_left, hp_shift = hp_left;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float e = (run - p.o_del) - je[k];
      p_noeext = push_sign((e_shift - p.e_del) - (hp_shift - p.oe_del),
                           p_noeext);
      const float hk = fmaxf(hp[k], e);
      p_e = push_sign(hp[k] - e, p_e);
      run = fmaxf(run, hp[k] + je[k]);
      e_shift = e;
      hp_shift = hp[k];
      h[k] = hk;
      const float sel = hk - tail;
      if (sel > best_sel) {
        best_sel = sel;
        best_h = hk;
        best_k = k;
      }
    }
    if (best_sel != row_best) best_row = i;
    const uint32_t words[PLANES] = {p_start, p_fsrc, p_fext, p_e, p_noeext};
    pack_record<K>(dc + size_t(i - 1) * 32 + lane, words);
  }
  if (ql <= 0) {  // no valid row: the end cell is (1, 1), sel NEG
    best_sel = lane == 0 ? NEG : BELOW;
    best_h = h[0];
    best_k = 0;
    best_row = 1;
  }

  // end cell across the warp: larger score, then smaller row-major index
  int best_flat = (best_row - 1) * n + j0 + best_k;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float s2 = __shfl_xor_sync(FULL, best_sel, o);
    const float h2 = __shfl_xor_sync(FULL, best_h, o);
    const int f2 = __shfl_xor_sync(FULL, best_flat, o);
    if (s2 > best_sel || (s2 == best_sel && f2 < best_flat)) {
      best_sel = s2;
      best_h = h2;
      best_flat = f2;
    }
  }
  if (lane == 0) {  // the walk kernel reads these and adds the rest
    f32out[c] = best_h;
    f32out[R + c] = best_sel;
    i32out[R + c] = best_flat / n + 1;  // q_end
    i32out[3 * R + c] = best_flat % n + 1;  // r_end
  }
}

// The walk back from each candidate's end cell, a warp a candidate, by
// the whole warp from tiles of the bit-planes in shared memory.
template <int K>
__global__ void __launch_bounds__(32 * WALK_WARPS)
sw_walk_kernel(int R, int m, float clip, const void* __restrict__ dirs,
               float* __restrict__ f32out, int32_t* __restrict__ i32out,
               int8_t* __restrict__ ops_rev, int16_t* __restrict__ steps) {
  using RK = Rec<K>;
  constexpr int n = 32 * K;
  __shared__ RK tiles[WALK_WARPS][TILE_ROWS * TILE_LANES];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int c = blockIdx.x * WALK_WARPS + wid;
  if (c >= R) return;  // the whole warp leaves together
  const RK* dc = static_cast<const RK*>(dirs) + size_t(c) * m * 32;
  const int ei = i32out[R + c], ej = i32out[3 * R + c];
  const int n_steps = m + n;
  int8_t* ops_c = ops_rev + size_t(c) * n_steps;
  int16_t* si_c = steps + size_t(c) * n_steps;
  int16_t* sj_c = steps + (size_t(R) + c) * n_steps;

  RK* tile = tiles[wid];  // [rows][lanes]
  int r0 = 1 << 30, s0 = 0;  // the tile's first row (1-based) and lane
  int i = ei, j = ej, mode = TB_FULL, t = 0;
  while (true) {  // one step of the walk a pass
    const int cl = (j - 1) / K;
    if (i < r0 || cl < s0) {
      // stage rows max(1, i-31)..i of lanes cl-3..cl: the path only goes
      // up and left
      r0 = max(1, i - TILE_ROWS + 1);
      s0 = max(0, cl - TILE_LANES + 1);
      const int n_recs = (i - r0 + 1) * TILE_LANES;
      __syncwarp();
      for (int x = lane; x < n_recs; x += 32) {
        const int row = x / TILE_LANES, l = x - row * TILE_LANES;
        tile[x] = dc[size_t(r0 - 1 + row) * 32 + s0 + l];
      }
      __syncwarp();
    }
    if (mode == TB_FULL) {
      // a run of M steps down the diagonal, 32 cells at a time: lane l
      // looks at (i - l, j - l) if the tile holds it; the run goes on
      // past a cell that is an M step (neither E nor F) which neither
      // starts the alignment nor reaches row 0, column 0 or the last step
      const int avail = min(i - r0, (j - 1) - s0 * K) + 1;
      bool m_step = false, goes_on = false;
      if (lane < avail) {
        const int il = i - lane, jl = j - lane;
        const int c2 = (jl - 1) / K, k2 = (jl - 1) - c2 * K;
        const Bits128 rb = unpack(tile[(il - r0) * TILE_LANES + (c2 - s0)]);
        m_step = !decision<K>(rb, P_E, k2) && !decision<K>(rb, P_FSRC, k2);
        goes_on = m_step && !decision<K>(rb, P_START, k2) && il > 1 &&
                  jl > 1 && t + lane + 1 < n_steps;
      }
      const unsigned stop = __ballot_sync(FULL, !goes_on);
      const int run = stop ? __ffs(int(stop)) - 1 : 32;
      // the run's last cell, if an M step, ends the walk
      const bool last = run < 32 && __shfl_sync(FULL, int(m_step), run);
      const int n_run = run + (last ? 1 : 0);
      if (lane < n_run) {  // one coalesced store each
        ops_c[t + lane] = int8_t(OP_M);
        si_c[t + lane] = int16_t(i - lane);
        sj_c[t + lane] = int16_t(j - lane);
      }
      t += n_run;
      i -= n_run;
      j -= n_run;
      if (last) break;
      if (n_run > 0) continue;  // a new run (the tile may need staging)
    }
    // one step at (i, j) in the tile
    const int k = (j - 1) - cl * K;
    const Bits128 rb = unpack(tile[(i - r0) * TILE_LANES + (cl - s0)]);
    const int b = (decision<K>(rb, P_FSRC, k)
                       ? 2
                       : (decision<K>(rb, P_START, k) ? 0 : 1)) |
                  (decision<K>(rb, P_E, k) ? BIT_E : 0) |
                  (decision<K>(rb, P_NOEEXT, k) ? 0 : BIT_EEXT) |
                  (decision<K>(rb, P_FEXT, k) ? BIT_FEXT : 0);
    const int src = b & 3;
    if (mode == TB_FULL) mode = (b & BIT_E) ? TB_E : TB_HPRIME;
    if (mode == TB_HPRIME && src == 2) mode = TB_F;
    if (lane == 0) {
      ops_c[t] = int8_t(mode == TB_E ? OP_D : (mode == TB_F ? OP_I : OP_M));
      si_c[t] = int16_t(i);
      sj_c[t] = int16_t(j);
    }
    ++t;
    int nmode;
    if (mode == TB_E) {
      nmode = (b & BIT_EEXT) ? TB_E : TB_HPRIME;
    } else if (mode == TB_F) {
      nmode = (b & BIT_FEXT) ? TB_F : TB_FULL;
      --i;
    } else {
      nmode = src == 0 ? TB_DONE : TB_FULL;
      --i;
    }
    if (mode != TB_F) --j;
    mode = nmode;
    if (mode == TB_DONE || i <= 0 || j <= 0 || t >= n_steps) break;
  }
  if (lane == 0) {
    f32out[c] += i > 0 ? clip : 0.0f;  // the score: clip penalties undone
    i32out[c] = i;               // q_start
    i32out[2 * R + c] = j;       // r_start
    i32out[4 * R + c] = t;       // n_ops
  }
  for (int s = t + lane; s < n_steps; s += 32) {  // OP_NONE padding
    ops_c[s] = int8_t(OP_NONE);
    si_c[s] = 0;
    sj_c[s] = 0;
  }
}

template <int K>
cudaError_t launch(const int8_t* q, const int8_t* r, const int32_t* qlen,
                   int R, int m, const SwParams& p, void* dirs,
                   float* f32out, int32_t* i32out, int8_t* ops_rev,
                   int16_t* steps, cudaStream_t stream) {
  const dim3 grid((R + WARPS - 1) / WARPS), block(32 * WARPS);
  const size_t smem = size_t(32 * K) * (1 + 5 * WARPS) * sizeof(float);
  cudaError_t e = pt_reserve_smem(sw_dp_kernel<K>, smem);
  if (e != cudaSuccess) return e;
  sw_dp_kernel<K><<<grid, block, smem, stream>>>(q, r, qlen, R, m, p, dirs,
                                                 f32out, i32out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 wgrid((R + WALK_WARPS - 1) / WALK_WARPS), wblock(32 * WALK_WARPS);
  sw_walk_kernel<K><<<wgrid, wblock, 0, stream>>>(R, m, p.clip, dirs, f32out,
                                                  i32out, ops_rev, steps);
  return cudaGetLastError();
}

}  // namespace

// q i8 [R, m], r i8 [R, n], qlen i32 [R]; dirs: R * m * 32 records of 8
// (n <= 384) or 16 bytes, scratch; f32out [2, R]
// (score, sel_score); i32out [5, R] (q_start, q_end, r_start, r_end,
// n_ops); ops_rev i8 [R, m+n]; steps i16 [2, R, m+n] (step_i, step_j).
// n = 32*K for K in 4, 8, ..., 24.
PT_EXPORT int pt_sw_batch(const void* q, const void* r, const void* qlen,
                          int R, int m, int n, float match, float mismatch,
                          float n_pen, float o_del, float e_del, float o_ins,
                          float e_ins, float clip, void* dirs, void* f32out,
                          void* i32out, void* ops_rev, void* steps,
                          void* stream) {
  // negated constants as 0 - x: never -0 (see the notes above)
  SwParams p{match,         0.0f - mismatch, 0.0f - n_pen, o_del,
             e_del,         o_del + e_del,   o_ins + e_ins, e_ins,
             clip,          0.0f - clip};
  auto* q8 = static_cast<const int8_t*>(q);
  auto* r8 = static_cast<const int8_t*>(r);
  auto* ql = static_cast<const int32_t*>(qlen);
  auto* fo = static_cast<float*>(f32out);
  auto* io = static_cast<int32_t*>(i32out);
  auto* ops = static_cast<int8_t*>(ops_rev);
  auto* st = static_cast<int16_t*>(steps);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 128: return launch<4>(q8, r8, ql, R, m, p, dirs, fo, io, ops, st, s);
    case 256: return launch<8>(q8, r8, ql, R, m, p, dirs, fo, io, ops, st, s);
    case 384: return launch<12>(q8, r8, ql, R, m, p, dirs, fo, io, ops, st, s);
    case 512: return launch<16>(q8, r8, ql, R, m, p, dirs, fo, io, ops, st, s);
    case 640: return launch<20>(q8, r8, ql, R, m, p, dirs, fo, io, ops, st, s);
    case 768: return launch<24>(q8, r8, ql, R, m, p, dirs, fo, io, ops, st, s);
    default: return cudaErrorInvalidValue;
  }
}
