// Affine-gap Smith-Waterman with clip penalties and traceback.
//
// Replaces proovread_tpu/align/sw.py:sw_batch, which is XLA (no Pallas
// kernel): a lax.scan over query rows with an associative_scan running max
// inside each row (_dp_one), then a lax.scan of m+n traceback steps over
// per-cell direction bits (_traceback_one). The host mapper under siamaera
// calls it at m=256, n=384 in chunks of 2048 candidates.
//
// What bounds it: the dependent chain of m query rows per candidate, each
// row needing a running max across all n columns. So one warp takes one
// candidate (four candidates a block): lane L keeps columns j = L*K + k
// (K = n/32, a template parameter) of the previous row's H and F in
// registers; the diagonal H and the shifted H'/E come from the lane's own
// previous register or, for its first column, from lane L-1 by
// __shfl_up_sync; the deletion running max is a sequential prefix over the
// lane's own columns, then a 5-step __shfl_up_sync inclusive scan of the
// lane totals and each column's exclusive value (max is exact, so any scan
// tree gives the reference's bits). There is no block barrier. The DP
// stops at row max(qlen, 1): later rows change no output. The end cell is
// a running first-index maximum per lane, then a butterfly reduction that
// keeps the larger score and, on equal scores, the smaller row-major index
// (jnp.argmax). Direction bytes (u8 [m, n], 98 KB a candidate at m=256,
// n=384) go to device memory, not shared memory: a warp writes a row's n
// bytes in one coalesced store of K bytes a lane, the walk reads at most
// m+n of them, and at one warp a block shared memory would cap an SM at
// two candidates. The score slab [m, n] of the reference is never
// materialised. Then lane 0 walks the path back until it is done (not a
// fixed m+n steps) and the warp pads ops_rev / step_i / step_j with
// OP_NONE / 0. Build with -fmad=false: the reference rounds
// (u_excl - o_del) - j_e and h_prev - (o_ins + e_ins) op by op in f32, and
// compares e_shift - e_del against hp_shift - (o_del + e_del) (XLA folds
// the two constants of the reference's hp_shift - o_del - e_del).

#include "common.cuh"

namespace {

constexpr float NEG = -1e9f;      // exact in f32 (ulp 64)
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;           // candidates a block

// direction bits, traceback modes and op codes of align/sw.py
constexpr int BIT_E = 4, BIT_EEXT = 8, BIT_FEXT = 16;
constexpr int TB_FULL = 0, TB_HPRIME = 1, TB_E = 2, TB_F = 3, TB_DONE = 4;
constexpr int OP_M = 0, OP_I = 1, OP_D = 2, OP_NONE = 3;

struct SwParams {
  float match, mismatch, n_pen, o_del, e_del, oe_del, oe_ins, e_ins, clip;
};

__device__ __forceinline__ float fmax_j(float a, float b) {
  return a > b ? a : b;
}

// _sub_table: codes 4 (N) and 5 (GAP) score -n_pen against anything
__device__ __forceinline__ float sub_score(int a, int b, const SwParams& p) {
  return (a >= 4 || b >= 4) ? -p.n_pen : (a == b ? p.match : -p.mismatch);
}

template <int K>
__global__ void __launch_bounds__(32 * WARPS)
sw_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
          const int32_t* __restrict__ qlen, int R, int m, SwParams p,
          uint8_t* __restrict__ dirs, float* __restrict__ f32out,
          int32_t* __restrict__ i32out, int8_t* __restrict__ ops_rev,
          int16_t* __restrict__ steps) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= R) return;  // the whole warp leaves together
  constexpr int n = 32 * K;
  const int j0 = lane * K;
  const int8_t* qc = q + size_t(c) * m;
  uint8_t* dc = dirs + size_t(c) * m * n;

  int rcode[K];
  float je[K], h[K], f[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    rcode[k] = r[size_t(c) * n + j0 + k];
    je[k] = (float(j0 + k) + 1.0f) * p.e_del;
    h[k] = 0.0f;
    f[k] = NEG;
  }
  const int ql = qlen[c];
  const int rows = min(max(ql, 1), m);

  // per-lane end cell: first maximum in row-major order
  float best_sel = 0.0f, best_h = 0.0f;
  int best_flat = -1;

  for (int i = 1; i <= rows; ++i) {
    const int qb = qc[i - 1];
    const float start_prev = i == 1 ? 0.0f : -p.clip;
    float h_left = __shfl_up_sync(FULL, h[K - 1], 1);
    if (lane == 0) h_left = NEG;

    float hp[K], e[K];
    uint32_t bits[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float diag_shift = k == 0 ? h_left : h[k - 1];
      const float diag_base = fmax_j(diag_shift, start_prev);
      const bool is_start = start_prev > diag_shift;
      const float f_open = i == 1 ? NEG : h[k] - p.oe_ins;
      const float f_ext = f[k] - p.e_ins;
      const float f_row = fmax_j(f_open, f_ext);
      const float m_row = diag_base + sub_score(qb, rcode[k], p);
      hp[k] = fmax_j(m_row, f_row);
      bits[k] = (f_row > m_row ? 2u : (is_start ? 0u : 1u)) |
                (f_ext > f_open ? uint32_t(BIT_FEXT) : 0u);
      f[k] = f_row;
    }
    // running max of hp + j_e along the row: lane prefix, warp scan
    float pm[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float v = hp[k] + je[k];
      pm[k] = k == 0 ? v : fmax_j(pm[k - 1], v);
    }
    float inc = pm[K - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc = fmax_j(inc, y);
    }
    const float excl = __shfl_up_sync(FULL, inc, 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float u_excl;
      if (k == 0)
        u_excl = lane == 0 ? NEG : excl;
      else
        u_excl = lane == 0 ? pm[k - 1] : fmax_j(excl, pm[k - 1]);
      e[k] = (u_excl - p.o_del) - je[k];
    }
    float hp_left = __shfl_up_sync(FULL, hp[K - 1], 1);
    float e_left = __shfl_up_sync(FULL, e[K - 1], 1);
    if (lane == 0) hp_left = e_left = NEG;

    const bool valid = i <= ql;
    const float tail = i == ql ? 0.0f : p.clip;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float hp_shift = k == 0 ? hp_left : hp[k - 1];
      const float e_shift = k == 0 ? e_left : e[k - 1];
      if ((e_shift - p.e_del) >= (hp_shift - p.oe_del)) bits[k] |= BIT_EEXT;
      if (e[k] > hp[k]) bits[k] |= BIT_E;
      h[k] = fmax_j(hp[k], e[k]);
      const float sel = valid ? h[k] - tail : NEG;
      if (best_flat < 0 || sel > best_sel) {
        best_sel = sel;
        best_h = h[k];
        best_flat = (i - 1) * n + j0 + k;
      }
    }
    uint8_t* drow = dc + size_t(i - 1) * n + j0;
    if constexpr (K % 4 == 0) {
#pragma unroll
      for (int w = 0; w < K / 4; ++w)
        reinterpret_cast<uint32_t*>(drow)[w] =
            bits[4 * w] | (bits[4 * w + 1] << 8) | (bits[4 * w + 2] << 16) |
            (bits[4 * w + 3] << 24);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) drow[k] = uint8_t(bits[k]);
    }
  }

  // end cell across the warp: larger score, then smaller row-major index
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
  const int ei = best_flat / n + 1, ej = best_flat % n + 1;
  const int n_steps = m + n;
  int8_t* ops_c = ops_rev + size_t(c) * n_steps;
  int16_t* si_c = steps + size_t(c) * n_steps;
  int16_t* sj_c = steps + (size_t(R) + c) * n_steps;

  __syncwarp();  // the direction bytes of every lane are visible to lane 0
  int t = 0;
  if (lane == 0) {
    int i = ei, j = ej, mode = TB_FULL;
    while (true) {
      const int b = dc[size_t(i - 1) * n + (j - 1)];
      const int src = b & 3;
      if (mode == TB_FULL) mode = (b & BIT_E) ? TB_E : TB_HPRIME;
      if (mode == TB_HPRIME && src == 2) mode = TB_F;
      ops_c[t] = int8_t(mode == TB_E ? OP_D : (mode == TB_F ? OP_I : OP_M));
      si_c[t] = int16_t(i);
      sj_c[t] = int16_t(j);
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
    f32out[c] = best_h + (i > 0 ? p.clip : 0.0f);
    f32out[R + c] = best_sel;
    i32out[c] = i;               // q_start
    i32out[R + c] = ei;          // q_end
    i32out[2 * R + c] = j;       // r_start
    i32out[3 * R + c] = ej;      // r_end
    i32out[4 * R + c] = t;       // n_ops
  }
  t = __shfl_sync(FULL, t, 0);
  for (int s = t + lane; s < n_steps; s += 32) {
    ops_c[s] = int8_t(OP_NONE);
    si_c[s] = 0;
    sj_c[s] = 0;
  }
}

template <int K>
cudaError_t launch(const int8_t* q, const int8_t* r, const int32_t* qlen,
                   int R, int m, const SwParams& p, uint8_t* dirs,
                   float* f32out, int32_t* i32out, int8_t* ops_rev,
                   int16_t* steps, cudaStream_t stream) {
  const dim3 grid((R + WARPS - 1) / WARPS), block(32 * WARPS);
  sw_kernel<K><<<grid, block, 0, stream>>>(q, r, qlen, R, m, p, dirs, f32out,
                                           i32out, ops_rev, steps);
  return cudaGetLastError();
}

}  // namespace

// q i8 [R, m], r i8 [R, n], qlen i32 [R]; dirs u8 [R, m, n] scratch;
// f32out [2, R] (score, sel_score); i32out [5, R] (q_start, q_end,
// r_start, r_end, n_ops); ops_rev i8 [R, m+n]; steps i16 [2, R, m+n]
// (step_i, step_j). n = 32*K for K in 4, 8, ..., 24.
PT_EXPORT int pt_sw_batch(const void* q, const void* r, const void* qlen,
                          int R, int m, int n, float match, float mismatch,
                          float n_pen, float o_del, float e_del, float o_ins,
                          float e_ins, float clip, void* dirs, void* f32out,
                          void* i32out, void* ops_rev, void* steps,
                          void* stream) {
  SwParams p{match, mismatch, n_pen, o_del, e_del, o_del + e_del,
             o_ins + e_ins, e_ins, clip};
  auto* q8 = static_cast<const int8_t*>(q);
  auto* r8 = static_cast<const int8_t*>(r);
  auto* ql = static_cast<const int32_t*>(qlen);
  auto* d = static_cast<uint8_t*>(dirs);
  auto* fo = static_cast<float*>(f32out);
  auto* io = static_cast<int32_t*>(i32out);
  auto* ops = static_cast<int8_t*>(ops_rev);
  auto* st = static_cast<int16_t*>(steps);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 128: return launch<4>(q8, r8, ql, R, m, p, d, fo, io, ops, st, s);
    case 256: return launch<8>(q8, r8, ql, R, m, p, d, fo, io, ops, st, s);
    case 384: return launch<12>(q8, r8, ql, R, m, p, d, fo, io, ops, st, s);
    case 512: return launch<16>(q8, r8, ql, R, m, p, d, fo, io, ops, st, s);
    case 640: return launch<20>(q8, r8, ql, R, m, p, d, fo, io, ops, st, s);
    case 768: return launch<24>(q8, r8, ql, R, m, p, d, fo, io, ops, st, s);
    default: return cudaErrorInvalidValue;
  }
}
