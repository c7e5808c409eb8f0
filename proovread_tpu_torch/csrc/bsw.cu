// Banded Smith-Waterman with in-kernel traceback, expanded per window column.
//
// Replaces the Pallas kernels proovread_tpu/align/bsw.py:bsw_expand_v2
// (_bsw_v2_kernel) and bsw_expand (v1, _bsw_kernel), both over _bsw_core.
// One block per candidate, one thread per band lane (W = 64 or 96, at most
// 128). The two entry points share the DP and traceback (bsw_block) and
// differ only in where a candidate's operands come from: v2 reads its own
// query row (by sread/strand) and its n = m + W window of the padded
// combined map word (by lread/w0p) straight from device memory and gates
// MCR-ignored columns (bit 3 of the map word); v1 reads row c of the
// pre-gathered [R, m] query and [R, n] window slabs and gates nothing (its
// caller masks ignored columns when it builds votes). The TPU's DMA staging
// and transposes only laid data out and are dropped.
//
// What bounds it: operations and latency, not bytes. Each candidate's DP is
// m dependent rows, and the in-row deletion recurrence is a log-shift running
// max (log2 W steps, each a block barrier), so a block does ~m*(2 + 2*log2 W)
// barriers for ~m*W cells. The design keeps every DP row in registers and
// shared memory (dirs is m x W uint16, ~21.5 KB at m=112, W=96, so several
// blocks share an SM and hide each other's barriers); nothing but the
// operands and the [R, n] outputs touches device memory. The traceback is
// one step per query row, walked by one thread into shared [n] buffers that
// are then stored coalesced. Build with -fmad=false: the reference rounds
// u_excl - o_del - w*e_del and h_up - (o_ins + e_ins) op by op in f32.

#include "common.cuh"

namespace {

constexpr float NEG = -1e9f;      // exact in f32 (ulp 64)
constexpr int GAP = 5;

struct BswParams {
  float match, mismatch, n_pen, o_del, e_del, oe_ins, e_ins, clip;
};

__device__ __forceinline__ float fmax_j(float a, float b) {
  return a > b ? a : b;
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// shared layout: dirs u16 [m*W] | state, qrow, ins, b0, b1, win i32 [n] |
// q i32 [m] | h, f, u, pay double buffers [2*W] | reduction f32/i32 [W]
__host__ __device__ inline size_t bsw_smem_bytes(int m, int W) {
  const int n = m + W;
  return align16(size_t(m) * W * 2) + size_t(n) * 4 * 6 + size_t(m) * 4 +
         size_t(W) * 4 * 8 + size_t(W) * 4 * 2;
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

template <class Ops>
__device__ void bsw_block(const Ops& ops, int m,
                          const int32_t* __restrict__ qlen_a, int R, int W,
                          BswParams p, BswOutputs out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = m + W;
  const int c = blockIdx.x;
  const int w = threadIdx.x;

  uint16_t* dirs = reinterpret_cast<uint16_t*>(smem);
  int32_t* s_state = reinterpret_cast<int32_t*>(smem + align16(size_t(m) * W * 2));
  int32_t* s_qrow = s_state + n;
  int32_t* s_ins = s_qrow + n;
  uint32_t* s_b0 = reinterpret_cast<uint32_t*>(s_ins + n);
  uint32_t* s_b1 = s_b0 + n;
  int32_t* s_win = reinterpret_cast<int32_t*>(s_b1 + n);
  int32_t* s_q = s_win + n;
  float* hbuf = reinterpret_cast<float*>(s_q + m);
  float* fbuf = hbuf + 2 * W;
  float* ubuf = fbuf + 2 * W;
  int32_t* pbuf = reinterpret_cast<int32_t*>(ubuf + 2 * W);
  float* red_f = reinterpret_cast<float*>(pbuf + 2 * W);
  int32_t* red_i = reinterpret_cast<int32_t*>(red_f + W);

  const int ql = qlen_a[c];
  const int8_t* qsrc = ops.query(c, m);
  const int8_t* wsrc = ops.window(c, n);
  for (int i = w; i < m; i += W) s_q[i] = qsrc[i];
  for (int i = w; i < n; i += W) {
    s_win[i] = wsrc[i];
    s_state[i] = -1;
    s_qrow[i] = 0;
    s_ins[i] = 0;
    s_b0[i] = 0u;
    s_b1[i] = 0u;
  }
  hbuf[w] = 0.f;
  fbuf[w] = NEG;
  __syncthreads();

  // ---------------- forward banded DP ----------------
  const float iota_e = float(w) * p.e_del;
  float best = NEG;
  int32_t best_pay = 0;
  int cur = 0;
  for (int r = 0; r < m; ++r) {
    const float* h_prev = hbuf + cur * W;
    const float* f_prev = fbuf + cur * W;
    const int qr = s_q[r];
    const int wv = s_win[r + w] & 7;
    const bool ambig = (qr > 3) || (wv > 3);
    const float sub = ambig ? -p.n_pen : (wv == qr ? p.match : -p.mismatch);
    const float start = (r == 0) ? 0.f : -p.clip;
    const float diag = h_prev[w];
    const float diag_base = fmax_j(diag, start);
    const bool src0 = start > diag;
    const float m_row = diag_base + sub;
    const float h_up = (w + 1 < W) ? h_prev[w + 1] : NEG;
    const float f_up = (w + 1 < W) ? f_prev[w + 1] : NEG;
    const float f_open = (r == 0) ? NEG : h_up - p.oe_ins;
    const float f_ext = f_up - p.e_ins;
    const float f_row = fmax_j(f_open, f_ext);
    const bool fext = f_ext > f_open;          // open wins ties
    const float hp = fmax_j(m_row, f_row);
    const int src = (f_row > m_row) ? 2 : (src0 ? 0 : 1);

    // within-row deletion: running max of hp[k] + k*e_del with the origin
    // lane as payload; ties keep the smaller (left) origin
    float u = hp + iota_e;
    int pay = w;
    int ub = 0;
    for (int s = 1; s < W; s <<= 1) {
      ubuf[ub * W + w] = u;
      pbuf[ub * W + w] = pay;
      __syncthreads();
      const float us = (w >= s) ? ubuf[ub * W + w - s] : NEG;
      const int ps = (w >= s) ? pbuf[ub * W + w - s] : 0;
      if (us >= u) {
        u = us;
        pay = ps;
      }
      ub ^= 1;
    }
    ubuf[ub * W + w] = u;
    pbuf[ub * W + w] = pay;
    __syncthreads();
    const float u_excl = (w >= 1) ? ubuf[ub * W + w - 1] : NEG;
    const int pay_excl = (w >= 1) ? pbuf[ub * W + w - 1] : 0;
    const float e_row = (u_excl - p.o_del) - iota_e;
    const float h_row = fmax_j(hp, e_row);
    const bool bit_e = e_row > hp;             // H' wins ties
    dirs[r * W + w] = uint16_t(src | (bit_e ? 4 : 0) | (fext ? 8 : 0) |
                               (pay_excl << 8));

    const float tailpen = (r == ql - 1) ? 0.f : p.clip;
    const float sel = (r < ql) ? h_row - tailpen : NEG;
    if (sel > best) best_pay = (r << 7) | w;  // earlier row wins ties
    best = fmax_j(best, sel);
    hbuf[(cur ^ 1) * W + w] = h_row;
    fbuf[(cur ^ 1) * W + w] = f_row;
    __syncthreads();
    cur ^= 1;
  }
  red_f[w] = best;
  red_i[w] = best_pay;
  __syncthreads();

  // ---------------- end cell + backward walk (one thread) ----------------
  if (w == 0) {
    float m1 = red_f[0];
    for (int i = 1; i < W; ++i) m1 = fmax_j(m1, red_f[i]);
    int pay_sel = 1 << 30;                     // smallest packed (r, w)
    for (int i = 0; i < W; ++i)
      if (red_f[i] == m1 && red_i[i] < pay_sel) pay_sel = red_i[i];
    const int end_r = pay_sel >> 7;
    const int end_w = pay_sel & 127;
    const bool valid = (m1 > NEG / 2) && (ql > 0);
    const float h_best = m1 + ((end_r == ql - 1) ? 0.f : p.clip);

    int cur_w = end_w, mode = 0, done = valid ? 0 : 1;
    int q_start = 0, r_start = 0;
    for (int r = m - 1; r >= 0; --r) {
      const bool active = (done == 0) && (r <= end_r);
      const uint16_t* drow = dirs + r * W;
      const int32_t word = (cur_w >= 0 && cur_w < W) ? int32_t(drow[cur_w]) : -1;
      const bool is_h = active && (mode == 0);
      const bool dj = is_h && (((word >> 2) & 1) == 1);
      const int w_h = dj ? ((word >> 8) & 0xFF) : cur_w;
      const int32_t word2 =
          dj ? ((w_h >= 0 && w_h < W) ? int32_t(drow[w_h]) : -1) : word;
      const int src = word2 & 3;
      const bool is_m = is_h && (src <= 1);
      const bool is_i_open = is_h && (src == 2);
      const bool is_i = is_i_open || (active && (mode == 1));
      const bool fext =
          (is_i_open ? ((word2 >> 3) & 1) : ((word >> 3) & 1)) == 1;
      const int att_w = is_i_open ? w_h : cur_w;
      const int qbase = s_q[r];
      if (dj) {                                // deletion run (w_h, cur_w]
        const int lo = w_h + 1 > 0 ? w_h + 1 : 0;
        const int hi = cur_w < W - 1 ? cur_w : W - 1;
        for (int lw = lo; lw <= hi; ++lw) {
          s_state[r + lw] = GAP;
          s_qrow[r + lw] = r;
        }
      }
      if (is_m && w_h >= 0 && w_h < W) {
        s_state[r + w_h] = qbase;
        s_qrow[r + w_h] = r;
      }
      if (is_i && att_w >= 0 && att_w < W) {
        // the walk visits a run's bases last to first: shift left and or
        // at bits 0-2; bases past 20 fall off the top (u32 shifts)
        const int col = r + att_w;
        const uint32_t b0 = s_b0[col], b1 = s_b1[col];
        s_ins[col] += 1;
        s_b1[col] = (b1 << 3) | ((b0 >> 27) & 7u);
        s_b0[col] = (b0 << 3) | uint32_t(qbase);
      }
      const bool started = is_m && (src == 0 || r == 0);
      if (started) {
        q_start = r;
        r_start = r + w_h;
        done = 1;
      }
      mode = is_m ? 0 : (is_i ? (fext ? 1 : 0) : mode);
      cur_w = (is_m && !started) ? w_h : (is_i ? att_w + 1 : cur_w);
    }
    const float score = h_best + (q_start > 0 ? p.clip : 0.f);
    out.score[c] = valid ? score : NEG;
    out.pos[c] = q_start;
    out.pos[R + c] = end_r + 1;
    out.pos[2 * R + c] = r_start;
    out.pos[3 * R + c] = end_r + end_w + 1;
    out.pos[4 * R + c] = valid ? 1 : 0;
  }
  __syncthreads();

  // coalesced store; v2's MCR-ignore gating (bit 3 of the map word) kills
  // votes and attached insertion runs, per-candidate stats stay untouched
  for (int i = w; i < n; i += W) {
    const bool ign = Ops::kGateIgnore && (s_win[i] >> 3) > 0;
    const size_t o = size_t(c) * n + i;
    out.state[o] = ign ? -1 : s_state[i];
    out.qrow[o] = s_qrow[i];
    out.inslen[o] = ign ? 0 : s_ins[i];
    out.b0[o] = int32_t(s_b0[i]);
    out.b1[o] = int32_t(s_b1[i]);
  }
}

__global__ void bsw_v2_kernel(GatherOperands ops, int m,
                              const int32_t* __restrict__ qlen, int R, int W,
                              BswParams p, BswOutputs out) {
  bsw_block(ops, m, qlen, R, W, p, out);
}

__global__ void bsw_v1_kernel(SlabOperands ops, int m,
                              const int32_t* __restrict__ qlen, int R, int W,
                              BswParams p, BswOutputs out) {
  bsw_block(ops, m, qlen, R, W, p, out);
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
  if (W > 128 || W % 32 != 0 || m <= 0) return int(cudaErrorInvalidValue);
  GatherOperands ops;
  ops.q = static_cast<const int8_t*>(q);
  ops.rc = static_cast<const int8_t*>(rc);
  ops.map_pad = static_cast<const int8_t*>(map_pad);
  ops.Lmap = Lmap;
  ops.sread = static_cast<const int32_t*>(sread);
  ops.strand = static_cast<const int32_t*>(strand);
  ops.lread = static_cast<const int32_t*>(lread);
  ops.w0p = static_cast<const int32_t*>(w0p);
  const size_t smem = bsw_smem_bytes(m, W);
  cudaError_t e = pt_reserve_smem(bsw_v2_kernel, smem);
  if (e != cudaSuccess) return int(e);
  bsw_v2_kernel<<<R, W, smem, cudaStream_t(stream)>>>(
      ops, m, static_cast<const int32_t*>(qlen), R, W,
      make_params(match, mismatch, n_pen, o_del, e_del, o_ins, e_ins, clip),
      make_outputs(state, qrow, ins_len, ins_b0, ins_b1, score, pos));
  return int(cudaGetLastError());
}

PT_EXPORT int pt_bsw_expand_v1(const void* q, const void* win, int m,
                               const void* qlen, int R, int W, float match,
                               float mismatch, float n_pen, float o_del,
                               float e_del, float o_ins, float e_ins,
                               float clip, void* state, void* qrow,
                               void* ins_len, void* ins_b0, void* ins_b1,
                               void* score, void* pos, void* stream) {
  if (W > 128 || W % 32 != 0 || m <= 0) return int(cudaErrorInvalidValue);
  SlabOperands ops;
  ops.q = static_cast<const int8_t*>(q);
  ops.win = static_cast<const int8_t*>(win);
  const size_t smem = bsw_smem_bytes(m, W);
  cudaError_t e = pt_reserve_smem(bsw_v1_kernel, smem);
  if (e != cudaSuccess) return int(e);
  bsw_v1_kernel<<<R, W, smem, cudaStream_t(stream)>>>(
      ops, m, static_cast<const int32_t*>(qlen), R, W,
      make_params(match, mismatch, n_pen, o_del, e_del, o_ins, e_ins, clip),
      make_outputs(state, qrow, ins_len, ins_b0, ins_b1, score, pos));
  return int(cudaGetLastError());
}
