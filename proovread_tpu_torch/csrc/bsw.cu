// Banded Smith-Waterman with in-kernel traceback, expanded per window column.
//
// Replaces the Pallas kernels proovread_tpu/align/bsw.py:bsw_expand_v2
// (_bsw_v2_kernel) and bsw_expand (v1, _bsw_kernel), both over _bsw_core.
// The two entry points share the DP and traceback (bsw_warp) and differ
// only in where a candidate's operands come from: v2 reads its own query row
// (by sread/strand) and its n = m + W window of the padded combined map word
// (by lread/w0p) straight from device memory and gates MCR-ignored columns
// (bit 3 of the map word); v1 reads row c of the pre-gathered [R, m] query
// and [R, n] window slabs and gates nothing (its caller masks ignored
// columns when it builds votes). The TPU's DMA staging and transposes only
// laid data out and are dropped.
//
// What bounds it: instruction issue, not bytes. Each candidate's DP is m
// dependent rows, and each row needs the in-row deletion running max across
// the band. So one warp takes one candidate, and a block holds two
// candidates (one where two do not fit in shared memory). Lane L keeps band
// lanes w = L*K + k (K = W/32, a template parameter) in registers: h and f
// of the row above come from the lane's own next register or, for its last
// band lane, from lane L+1 by __shfl_down_sync; the deletion running max is
// a sequential prefix over the lane's own band lanes, then a 5-step
// __shfl_up_sync scan of (value, origin lane) across the warp that keeps
// the left operand on >= (the leftmost max, which rounds nothing, so any
// scan tree gives the reference's bits), then each band lane's exclusive
// value. There is no block barrier at all. dirs (uint16 [m, W], stored
// [m][K][32] so a row's stores hit distinct banks) is the largest per-warp
// shared array: 21.5 KB of the warp's 22.4 KB at m=112, W=96. The end cell
// is a warp butterfly reduction; then one lane walks the traceback, one
// step per query row, into the warp's shared state and query-row rows
// (an insertion run is gathered in registers and stored to device memory
// when the walk leaves its column), and the warp stores the two rows
// coalesced, v2 leaving ignored columns at "nothing voted". Build with
// -fmad=false: the reference rounds u_excl - o_del - w*e_del and
// h_up - (o_ins + e_ins) op by op in f32.

#include "common.cuh"

namespace {

constexpr float NEG = -1e9f;      // exact in f32 (ulp 64)
constexpr int GAP = 5;
constexpr unsigned FULL = 0xffffffffu;

struct BswParams {
  float match, mismatch, n_pen, o_del, e_del, oe_ins, e_ins, clip;
};

__device__ __forceinline__ float fmax_j(float a, float b) {
  return a > b ? a : b;
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// shared memory of one warp: dirs u16 [m][K][32] | query i8 [m] |
// window i8 [n] | walked state i8 [n] | walked qrow u16 [n]
__host__ __device__ inline size_t bsw_warp_smem(int m, int W) {
  return align16(size_t(m) * W * 2) + align16(size_t(m)) +
         2 * align16(size_t(m + W)) + align16(size_t(m + W) * 2);
}

// v2 operands: fetched by candidate metadata; ignored columns are gated
struct GatherOperands {
  const int8_t* q;
  const int8_t* rc;
  const int8_t* map_pad;
  int Lmap;
  const int32_t* sread;
  const int32_t* strand;
  const int32_t* lread;
  const int32_t* w0p;
  static constexpr bool kGateIgnore = true;
  __device__ const int8_t* query(int c, int m) const {
    return (strand[c] == 0 ? q : rc) + size_t(sread[c]) * m;
  }
  __device__ const int8_t* window(int c, int n) const {
    return map_pad + size_t(lread[c]) * Lmap + w0p[c];
  }
};

// v1 operands: row c of the pre-gathered slabs; nothing is gated
struct SlabOperands {
  const int8_t* q;
  const int8_t* win;
  static constexpr bool kGateIgnore = false;
  __device__ const int8_t* query(int c, int m) const {
    return q + size_t(c) * m;
  }
  __device__ const int8_t* window(int c, int n) const {
    return win + size_t(c) * n;
  }
};

struct BswOutputs {
  int32_t* state;
  int32_t* qrow;
  int32_t* inslen;
  int32_t* b0;
  int32_t* b1;
  float* score;
  int32_t* pos;                               // [5, R]
};

// running max with its origin lane: the left operand wins ties
__device__ __forceinline__ void keep_left(float& u, int& pay, float ul,
                                          int pl) {
  if (ul >= u) {
    u = ul;
    pay = pl;
  }
}

// The backward walk of one candidate, by one lane: one step per query row
// from the end cell. State and query row of each visited column go to the
// warp's shared rows; an insertion run is gathered in registers and stored
// to device memory when the walk leaves its column.
template <int K, class Ops>
__device__ void walk(const uint16_t* dirs, const int8_t* s_q,
                     const int8_t* s_win, int8_t* s_state, uint16_t* s_qrow,
                     float m1, int pay_sel, int ql, int c, int R, int n,
                     BswParams p, BswOutputs out) {
  constexpr int W = 32 * K;
  const size_t o0 = size_t(c) * n;
  const int end_r = pay_sel >> 7;
  const int end_w = pay_sel & 127;
  const bool valid = (m1 > NEG / 2) && (ql > 0);
  const float h_best = m1 + ((end_r == ql - 1) ? 0.f : p.clip);
  auto dir_at = [&](int r, int w) -> int32_t {
    const unsigned u = unsigned(w);            // w < 0 wraps past W
    return u < unsigned(W) ? int32_t(dirs[(r * K + u % K) * 32 + u / K])
                           : -1;
  };
  int ins_col = -1, ins_n = 0;                 // the insertion run walked now
  uint32_t ins0 = 0u, ins1 = 0u;
  auto flush_ins = [&]() {
    if (ins_col < 0) return;
    if (!(Ops::kGateIgnore && (s_win[ins_col] >> 3) > 0))   // not ignored
      out.inslen[o0 + ins_col] = ins_n;
    out.b0[o0 + ins_col] = int32_t(ins0);
    out.b1[o0 + ins_col] = int32_t(ins1);
  };
  int cur_w = end_w, mode = 0;
  int q_start = 0, r_start = 0;
  // rows past end_r, and every row once the walk has started, do nothing
  for (int r = valid ? end_r : -1; r >= 0; --r) {
    const int32_t word = dir_at(r, cur_w);
    const bool is_h = (mode == 0);
    const bool dj = is_h && (((word >> 2) & 1) == 1);
    const int w_h = dj ? ((word >> 8) & 0xFF) : cur_w;
    const int32_t word2 = dj ? dir_at(r, w_h) : word;
    const int src = word2 & 3;
    const bool is_m = is_h && (src <= 1);
    const bool is_i_open = is_h && (src == 2);
    const bool is_i = is_i_open || (mode == 1);
    const bool fext =
        (is_i_open ? ((word2 >> 3) & 1) : ((word >> 3) & 1)) == 1;
    const int att_w = is_i_open ? w_h : cur_w;
    const int qbase = s_q[r];
    if (dj) {                                  // deletion run (w_h, cur_w]
      const int lo = w_h + 1 > 0 ? w_h + 1 : 0;
      const int hi = cur_w < W - 1 ? cur_w : W - 1;
      for (int lw = lo; lw <= hi; ++lw) {
        s_state[r + lw] = GAP;
        s_qrow[r + lw] = uint16_t(r);
      }
    }
    if (is_m && w_h >= 0 && w_h < W) {
      s_state[r + w_h] = int8_t(qbase);
      s_qrow[r + w_h] = uint16_t(r);
    }
    if (is_i && att_w >= 0 && att_w < W) {
      // the walk never comes back to a column it has left, so a column's
      // insertion run is walked in one go, last base first: shift left and
      // or at bits 0-2; bases past 20 fall off the top (u32 shifts)
      const int col = r + att_w;
      if (col != ins_col) {
        flush_ins();
        ins_col = col;
        ins_n = 0;
        ins0 = ins1 = 0u;
      }
      ins_n += 1;
      ins1 = (ins1 << 3) | ((ins0 >> 27) & 7u);
      ins0 = (ins0 << 3) | uint32_t(qbase);
    }
    if (is_m && (src == 0 || r == 0)) {        // the alignment starts here
      q_start = r;
      r_start = r + w_h;
      break;
    }
    mode = is_m ? 0 : (is_i ? (fext ? 1 : 0) : mode);
    cur_w = is_m ? w_h : (is_i ? att_w + 1 : cur_w);
  }
  flush_ins();
  const float score = h_best + (q_start > 0 ? p.clip : 0.f);
  out.score[c] = valid ? score : NEG;
  out.pos[c] = q_start;
  out.pos[R + c] = end_r + 1;
  out.pos[2 * R + c] = r_start;
  out.pos[3 * R + c] = end_r + end_w + 1;
  out.pos[4 * R + c] = valid ? 1 : 0;
}

template <int K, class Ops>
__device__ void bsw_warp(const Ops& ops, int m,
                         const int32_t* __restrict__ qlen_a, int R,
                         BswParams p, BswOutputs out) {
  constexpr int W = 32 * K;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = m + W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= R) return;                          // the last block's spare warps

  unsigned char* mine = smem + size_t(warp) * bsw_warp_smem(m, W);
  uint16_t* dirs = reinterpret_cast<uint16_t*>(mine);
  int8_t* s_q = reinterpret_cast<int8_t*>(mine + align16(size_t(m) * W * 2));
  int8_t* s_win = s_q + align16(size_t(m));
  int8_t* s_state = s_win + align16(size_t(n));
  uint16_t* s_qrow =
      reinterpret_cast<uint16_t*>(s_state + align16(size_t(n)));

  const int ql = qlen_a[c];
  const int8_t* qsrc = ops.query(c, m);
  const int8_t* wsrc = ops.window(c, n);
  for (int i = lane; i < m; i += 32) s_q[i] = qsrc[i];
  for (int i = lane; i < n; i += 32) s_win[i] = wsrc[i];
  // every column starts as "nothing voted": the walk stores the state and
  // query row of the columns it visits into shared rows, and the rare
  // insertion runs straight into the zeroed device rows
  const size_t o0 = size_t(c) * n;
  for (int i = lane; i < n; i += 32) {
    s_state[i] = -1;
    s_qrow[i] = 0;
    out.inslen[o0 + i] = 0;
    out.b0[o0 + i] = 0;
    out.b1[o0 + i] = 0;
  }
  __syncwarp();

  // ---------------- forward banded DP, K band lanes per lane ----------------
  float h[K], f[K], iota_e[K], best[K];
  int best_pay[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    h[k] = 0.f;
    f[k] = NEG;
    iota_e[k] = float(lane * K + k) * p.e_del;
    best[k] = NEG;
    best_pay[k] = 0;
  }
  // rows past the query's end change nothing that the end cell or the walk
  // reads (their cells never score), so the DP stops at ql
  const int rows = ql < m ? ql : m;
  for (int r = 0; r < rows; ++r) {
    const int qr = s_q[r];
    const float start = (r == 0) ? 0.f : -p.clip;
    // h and f of band lane w + 1 in row r - 1: the lane's own next register,
    // or for its last band lane lane L+1's first (none past the band)
    float h_up[K], f_up[K];
#pragma unroll
    for (int k = 0; k + 1 < K; ++k) {
      h_up[k] = h[k + 1];
      f_up[k] = f[k + 1];
    }
    h_up[K - 1] = __shfl_down_sync(FULL, h[0], 1);
    f_up[K - 1] = __shfl_down_sync(FULL, f[0], 1);
    if (lane == 31) {
      h_up[K - 1] = NEG;
      f_up[K - 1] = NEG;
    }
    float hp[K], f_row[K], pu[K];
    int src[K], pp[K];
    bool fext[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = lane * K + k;
      const int wv = s_win[r + w] & 7;
      const bool ambig = (qr > 3) || (wv > 3);
      const float sub = ambig ? -p.n_pen : (wv == qr ? p.match : -p.mismatch);
      const float diag = h[k];
      const float diag_base = fmax_j(diag, start);
      const bool src0 = start > diag;
      const float m_row = diag_base + sub;
      const float f_open = (r == 0) ? NEG : h_up[k] - p.oe_ins;
      const float f_ext = f_up[k] - p.e_ins;
      f_row[k] = fmax_j(f_open, f_ext);
      fext[k] = f_ext > f_open;                // open wins ties
      hp[k] = fmax_j(m_row, f_row[k]);
      src[k] = (f_row[k] > m_row) ? 2 : (src0 ? 0 : 1);
      pu[k] = hp[k] + iota_e[k];
      pp[k] = w;
    }
    // within-row deletion: running max of hp[w] + w*e_del with the origin
    // lane as payload, first over this lane's own band lanes, then across
    // the warp (inclusive), then over the lanes before this one
#pragma unroll
    for (int k = 1; k < K; ++k) keep_left(pu[k], pp[k], pu[k - 1], pp[k - 1]);
    float tu = pu[K - 1];
    int tp = pp[K - 1];
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      // lanes below s get their own (tu, tp) back, and keep it
      const float us = __shfl_up_sync(FULL, tu, s);
      const int ps = __shfl_up_sync(FULL, tp, s);
      keep_left(tu, tp, us, ps);
    }
    float u_excl[K];                           // max over band lanes [0, w)
    int pay_excl[K];
    u_excl[0] = __shfl_up_sync(FULL, tu, 1);
    pay_excl[0] = __shfl_up_sync(FULL, tp, 1);
    if (lane == 0) {
      u_excl[0] = NEG;
      pay_excl[0] = 0;
    }
#pragma unroll
    for (int k = 1; k < K; ++k) {
      u_excl[k] = pu[k - 1];
      pay_excl[k] = pp[k - 1];
      keep_left(u_excl[k], pay_excl[k], u_excl[0], pay_excl[0]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = lane * K + k;
      const float e_row = (u_excl[k] - p.o_del) - iota_e[k];
      const float h_row = fmax_j(hp[k], e_row);
      const bool bit_e = e_row > hp[k];        // H' wins ties
      dirs[(r * K + k) * 32 + lane] =
          uint16_t(src[k] | (bit_e ? 4 : 0) | (fext[k] ? 8 : 0) |
                   (pay_excl[k] << 8));
      const float tailpen = (r == ql - 1) ? 0.f : p.clip;
      const float sel = h_row - tailpen;
      if (sel > best[k]) best_pay[k] = (r << 7) | w;   // earlier row wins ties
      best[k] = fmax_j(best[k], sel);
      h[k] = h_row;
      f[k] = f_row[k];
    }
  }

  // ---------------- end cell: max score, then the smallest (r, w) ----------
  float m1 = best[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m1 = fmax_j(m1, best[k]);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    m1 = fmax_j(m1, __shfl_sync(FULL, m1, lane ^ s));
  int pay_sel = 1 << 30;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (best[k] == m1 && best_pay[k] < pay_sel) pay_sel = best_pay[k];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int o = __shfl_sync(FULL, pay_sel, lane ^ s);
    pay_sel = o < pay_sel ? o : pay_sel;
  }
  __syncwarp();                                // dirs complete for the walk
  if (lane == 0) {
    walk<K, Ops>(dirs, s_q, s_win, s_state, s_qrow, m1, pay_sel, ql, c, R,
                 n, p, out);
  }
  __syncwarp();                                // the walked rows complete
  // the walked rows, coalesced; v2 leaves ignored columns' state at -1
  for (int i = lane; i < n; i += 32) {
    const bool ignored = Ops::kGateIgnore && (s_win[i] >> 3) > 0;
    out.state[o0 + i] = ignored ? -1 : s_state[i];
    out.qrow[o0 + i] = s_qrow[i];
  }
}


template <int K, class Ops>
__global__ void bsw_kernel(Ops ops, int m, const int32_t* __restrict__ qlen,
                           int R, BswParams p, BswOutputs out) {
  bsw_warp<K>(ops, m, qlen, R, p, out);
}

template <int K, class Ops>
int launch_k(const Ops& ops, int m, const void* qlen, int R, BswParams p,
             BswOutputs out, void* stream) {
  // two candidates (warps) a block, or one where two do not fit
  const size_t per_warp = bsw_warp_smem(m, 32 * K);
  auto kernel = bsw_kernel<K, Ops>;
  int wpb = 2;
  cudaError_t e = pt_reserve_smem(kernel, per_warp * wpb);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();                  // clear it and try one warp
    wpb = 1;
    e = pt_reserve_smem(kernel, per_warp);
  }
  if (e != cudaSuccess) return int(e);
  const size_t smem = per_warp * wpb;
  kernel<<<(R + wpb - 1) / wpb, 32 * wpb, smem, cudaStream_t(stream)>>>(
      ops, m, static_cast<const int32_t*>(qlen), R, p, out);
  return int(cudaGetLastError());
}

template <class Ops>
int launch_bsw(const Ops& ops, int m, const void* qlen, int R, int W,
               BswParams p, BswOutputs out, void* stream) {
  if (W > 128 || W % 32 != 0 || m <= 0) return int(cudaErrorInvalidValue);
  switch (W / 32) {
    case 1: return launch_k<1>(ops, m, qlen, R, p, out, stream);
    case 2: return launch_k<2>(ops, m, qlen, R, p, out, stream);
    case 3: return launch_k<3>(ops, m, qlen, R, p, out, stream);
    default: return launch_k<4>(ops, m, qlen, R, p, out, stream);
  }
}

BswParams make_params(float match, float mismatch, float n_pen, float o_del,
                      float e_del, float o_ins, float e_ins, float clip) {
  BswParams p;
  p.match = match;
  p.mismatch = mismatch;
  p.n_pen = n_pen;
  p.o_del = o_del;
  p.e_del = e_del;
  p.oe_ins = o_ins + e_ins;                    // f32, as (o_ins + e_ins)
  p.e_ins = e_ins;
  p.clip = clip;
  return p;
}

BswOutputs make_outputs(void* state, void* qrow, void* ins_len, void* ins_b0,
                        void* ins_b1, void* score, void* pos) {
  BswOutputs o;
  o.state = static_cast<int32_t*>(state);
  o.qrow = static_cast<int32_t*>(qrow);
  o.inslen = static_cast<int32_t*>(ins_len);
  o.b0 = static_cast<int32_t*>(ins_b0);
  o.b1 = static_cast<int32_t*>(ins_b1);
  o.score = static_cast<float*>(score);
  o.pos = static_cast<int32_t*>(pos);
  return o;
}

}  // namespace

PT_EXPORT const char* pt_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

PT_EXPORT int pt_bsw_expand_v2(const void* q, const void* rc, int S, int m,
                               const void* map_pad, int Lmap,
                               const void* qlen, const void* sread,
                               const void* strand, const void* lread,
                               const void* w0p, int R, int W, float match,
                               float mismatch, float n_pen, float o_del,
                               float e_del, float o_ins, float e_ins,
                               float clip, void* state, void* qrow,
                               void* ins_len, void* ins_b0, void* ins_b1,
                               void* score, void* pos, void* stream) {
  (void)S;
  GatherOperands ops;
  ops.q = static_cast<const int8_t*>(q);
  ops.rc = static_cast<const int8_t*>(rc);
  ops.map_pad = static_cast<const int8_t*>(map_pad);
  ops.Lmap = Lmap;
  ops.sread = static_cast<const int32_t*>(sread);
  ops.strand = static_cast<const int32_t*>(strand);
  ops.lread = static_cast<const int32_t*>(lread);
  ops.w0p = static_cast<const int32_t*>(w0p);
  return launch_bsw(
      ops, m, qlen, R, W,
      make_params(match, mismatch, n_pen, o_del, e_del, o_ins, e_ins, clip),
      make_outputs(state, qrow, ins_len, ins_b0, ins_b1, score, pos), stream);
}

PT_EXPORT int pt_bsw_expand_v1(const void* q, const void* win, int m,
                               const void* qlen, int R, int W, float match,
                               float mismatch, float n_pen, float o_del,
                               float e_del, float o_ins, float e_ins,
                               float clip, void* state, void* qrow,
                               void* ins_len, void* ins_b0, void* ins_b1,
                               void* score, void* pos, void* stream) {
  SlabOperands ops;
  ops.q = static_cast<const int8_t*>(q);
  ops.win = static_cast<const int8_t*>(win);
  return launch_bsw(
      ops, m, qlen, R, W,
      make_params(match, mismatch, n_pen, o_del, e_del, o_ins, e_ins, clip),
      make_outputs(state, qrow, ins_len, ins_b0, ins_b1, score, pos), stream);
}
