// Consensus assembly and HCR masking, one block per read.
//
// assemble_rows replaces the Pallas kernel proovread_tpu/ops/
// assemble_kernel.py:assemble_rows (_assemble_kernel), a scalar cursor walk
// over each read's packed column words. Here a block takes the read in
// tiles of blockDim columns: a block-wide exclusive prefix sum of the
// per-column emit counts (emitted ? 1 + ins_len : 0) gives each column its
// cursor, and the column writes its base and inserted bases there when the
// cursor is below Lp. What bounds it: bytes (4 bytes in and 2 bytes out per
// column); the scan costs two barriers per tile.
//
// hcr_mask_rows replaces _hcr_kernel: the SeqFilter --phred-mask interval
// state machine (runs in [pmin, pmax] of >= min_len, merged across gaps
// < unmask_len, reduced at their ends). It is sequential per read, so one
// thread walks it over qual tiles the block stages in shared memory, and
// ORs each emitted run into a shared bit row, 32 columns per word; the
// whole block then expands the bits into the bool mask. What bounds it:
// the serial walk (latency), one thread per read.

#include "common.cuh"

namespace {

constexpr int ASM_THREADS = 256;
constexpr int INS_K = 6;

__global__ void assemble_kernel(const int32_t* __restrict__ word,
                                const int32_t* __restrict__ lengths, int L,
                                int Lp, int8_t* __restrict__ codes,
                                uint8_t* __restrict__ qual,
                                int32_t* __restrict__ nlen) {
  __shared__ int warp_sums[ASM_THREADS / 32];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, wid = t >> 5;
  const int nwarps = ASM_THREADS / 32;
  const int32_t* row = word + size_t(b) * L;
  int8_t* oc = codes + size_t(b) * Lp;
  uint8_t* oq = qual + size_t(b) * Lp;
  for (int i = t; i < Lp; i += ASM_THREADS) {
    oc[i] = 4;
    oq[i] = 0;
  }
  __syncthreads();
  const int len = lengths[b] < L ? lengths[b] : L;
  int carry = 0;
  for (int base = 0; base < len; base += ASM_THREADS) {
    const int col = base + t;
    const int32_t w = col < len ? row[col] : 0;
    const bool em = (w & 1) != 0;
    const int nins = (w >> 4) & 7;
    const int cnt = em ? 1 + nins : 0;
    int x = cnt;                               // inclusive warp scan
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[wid] = x;
    __syncthreads();
    if (wid == 0) {
      int s = lane < nwarps ? warp_sums[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      if (lane < nwarps) warp_sums[lane] = s;
    }
    __syncthreads();
    const int cur = carry + x + (wid > 0 ? warp_sums[wid - 1] : 0) - cnt;
    if (em) {
      const int phred = (w >> 7) & 63;
      if (cur < Lp) {
        oc[cur] = int8_t((w >> 1) & 7);
        oq[cur] = uint8_t(phred);
      }
      for (int k = 0; k < INS_K; ++k) {
        const int p = cur + 1 + k;
        if (k < nins && p < Lp) {
          oc[p] = int8_t((w >> (13 + 3 * k)) & 7);
          oq[p] = uint8_t(phred);
        }
      }
    }
    carry += warp_sums[nwarps - 1];
    __syncthreads();
  }
  if (t == 0) nlen[b] = carry < Lp ? carry : Lp;
}

constexpr int HCR_THREADS = 128;
constexpr int HCR_TILE = 4096;

struct HcrParams {
  int pmin, pmax, min_len, unmask_len, red, end_red;
};

// OR the boundary-reduced merged run [ms, me) into the bit row
__device__ void emit_run(uint32_t* bits, int ms, int me, int len,
                         const HcrParams& p, int& count) {
  int lo = ms + (ms == 0 ? p.end_red : p.red);
  int hi = me - (me == len ? p.end_red : p.red);
  lo = lo > 0 ? lo : 0;
  hi = hi < len ? hi : len;
  if (hi <= lo) return;
  count += hi - lo;
  const int wlo = lo >> 5, whi = (hi - 1) >> 5;
  const uint32_t first = 0xFFFFFFFFu << (lo & 31);
  const uint32_t last = (hi & 31) == 0 ? 0xFFFFFFFFu
                                       : ~(0xFFFFFFFFu << (hi & 31));
  for (int i = wlo; i <= whi; ++i) {
    uint32_t m = 0xFFFFFFFFu;
    if (i == wlo) m &= first;
    if (i == whi) m &= last;
    bits[i] |= m;
  }
}

__global__ void hcr_kernel(const uint8_t* __restrict__ qual,
                           const int32_t* __restrict__ lengths, int L,
                           HcrParams p, uint8_t* __restrict__ mask,
                           int32_t* __restrict__ counts) {
  extern __shared__ uint32_t bits[];           // (L + 31) / 32 words
  __shared__ uint8_t tile[HCR_TILE];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int nw = (L + 31) >> 5;
  for (int i = t; i < nw; i += HCR_THREADS) bits[i] = 0u;
  const int len = lengths[b] < L ? lengths[b] : L;
  const uint8_t* row = qual + size_t(b) * L;
  // walker state: open in-range run start, pending merged run [ms, me)
  int run_s = -1, ms = -1, me = -1, count = 0;
  __syncthreads();
  for (int base = 0; base < len; base += HCR_TILE) {
    const int nt = len - base < HCR_TILE ? len - base : HCR_TILE;
    for (int i = t; i < nt; i += HCR_THREADS) tile[i] = row[base + i];
    __syncthreads();
    if (t == 0) {
      for (int i = 0; i < nt; ++i) {
        const int col = base + i;
        const int q = tile[i];
        const bool inq = q >= p.pmin && q <= p.pmax;
        const bool qual_run = !inq && run_s >= 0 && (col - run_s) >= p.min_len;
        const bool extend = qual_run && ms >= 0 && (run_s - me) < p.unmask_len;
        if (qual_run && ms >= 0 && !extend) emit_run(bits, ms, me, len, p, count);
        if (qual_run) {
          ms = extend ? ms : run_s;
          me = col;
        }
        run_s = inq ? (run_s < 0 ? col : run_s) : -1;
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    // a run reaching the read end closes at len
    const bool qual_run = run_s >= 0 && (len - run_s) >= p.min_len;
    const bool extend = qual_run && ms >= 0 && (run_s - me) < p.unmask_len;
    if (qual_run && ms >= 0 && !extend) emit_run(bits, ms, me, len, p, count);
    if (qual_run) {
      ms = extend ? ms : run_s;
      me = len;
    }
    if (ms >= 0) emit_run(bits, ms, me, len, p, count);
    counts[b] = count;
  }
  __syncthreads();
  uint8_t* mrow = mask + size_t(b) * L;
  for (int i = t; i < L; i += HCR_THREADS)
    mrow[i] = uint8_t((bits[i >> 5] >> (i & 31)) & 1u);
}

}  // namespace

PT_EXPORT int pt_assemble_rows(const void* word, const void* lengths, int B,
                               int L, int Lp, void* codes, void* qual,
                               void* nlen, void* stream) {
  assemble_kernel<<<B, ASM_THREADS, 0, cudaStream_t(stream)>>>(
      static_cast<const int32_t*>(word), static_cast<const int32_t*>(lengths),
      L, Lp, static_cast<int8_t*>(codes), static_cast<uint8_t*>(qual),
      static_cast<int32_t*>(nlen));
  return int(cudaGetLastError());
}

PT_EXPORT int pt_hcr_mask_rows(const void* qual, const void* lengths, int B,
                               int L, int pmin, int pmax, int min_len,
                               int unmask_len, int red, int end_red,
                               void* mask, void* counts, void* stream) {
  HcrParams p{pmin, pmax, min_len, unmask_len, red, end_red};
  const size_t smem = size_t((L + 31) / 32) * 4;
  // the static qual tile takes HCR_TILE bytes beside the dynamic bit row
  cudaError_t e = pt_reserve_smem(hcr_kernel, smem + HCR_TILE);
  if (e != cudaSuccess) return int(e);
  hcr_kernel<<<B, HCR_THREADS, smem, cudaStream_t(stream)>>>(
      static_cast<const uint8_t*>(qual), static_cast<const int32_t*>(lengths),
      L, p, static_cast<uint8_t*>(mask), static_cast<int32_t*>(counts));
  return int(cudaGetLastError());
}
