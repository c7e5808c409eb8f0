// Consensus assembly and HCR masking.
//
// assemble_rows replaces the Pallas kernel proovread_tpu/ops/
// assemble_kernel.py:assemble_rows (_assemble_kernel), a scalar cursor walk
// over each read's column words, which XLA packs from the ConsensusCall
// fields first. Here the kernels read the fields themselves (emitted,
// base, ins_len, phred, ins_bases, lengths) and apply the packing's rules:
// a column emits where col < length and emitted; base, insertion length,
// phred and inserted bases clamped to 0-7, 0-6, 0-63 and 0-7. A column
// emits 1 + ins_len bytes, so the cursor is a prefix sum, found in two
// passes over a grid of (tile of ASM_TILE columns, read), neither of
// which waits on another block: assemble_count_kernel writes each tile's
// emit count; assemble_tiles_kernel adds up the counts of its read's
// earlier tiles and of all of them (one block reduction), scans its own
// tile (four columns a thread), stages the tile's codes and qual bytes in
// shared memory and stores them coalesced at the read's cursor, truncated
// at Lp. The tail [total, Lp) is cut into one share per tile, each filled
// with 4/0 by its tile's block, and the read's last tile writes the new
// length: every output byte is written once. What bounds it: bytes (in,
// the flag of each column below the length, 9 more where it emits and its
// inserted bases; out, 2 a column); a read is spread over L / ASM_TILE
// blocks.
//
// hcr_mask_rows replaces _hcr_kernel: the SeqFilter --phred-mask interval
// state machine (runs in [pmin, pmax] of >= min_len, merged across gaps
// < unmask_len, reduced at their ends). The reference walks it column by
// column; here a block of HCR_THREADS threads takes one read and computes
// the three levels of the plain version (hcr_mask_plain) on bit words of
// 32 columns in shared memory: the in-range bits come from one ballot per
// warp over coalesced qual loads; for each level, two block-wide scans
// over the words (a forward max of the last zero bit, a backward min of
// the first) give the edges of the runs that cross a word's ends, and a
// thread finds the runs inside each of its words with __ffs and keeps,
// fills or trims them: (1) in-range runs of >= min_len are kept; (2) gaps
// between kept runs shorter than unmask_len are filled; (3) each merged
// run is trimmed by red, or end_red where it touches column 0 or the read
// length. The block then writes the mask (coalesced bytes) and the count
// (popcounts, a block reduction). Integers only, so the result is the
// plain version's bit for bit. What bounds it: bytes (1 in, 1 out per
// column); the scans run over L / 32 words, a few barriers per level.

#include "common.cuh"

namespace {

constexpr int ASM_THREADS = 256;
constexpr int ASM_WARPS = ASM_THREADS / 32;
constexpr int ASM_COLS = 4;                           // columns a thread
constexpr int ASM_TILE = ASM_THREADS * ASM_COLS;      // columns a block
constexpr int INS_K = 6;
constexpr int ASM_SPAN = ASM_TILE * (1 + INS_K);      // a tile's most bytes

// the ConsensusCall fields, [B, L] (ins_bases [B, L, INS_K]), contiguous
struct AsmFields {
  const uint8_t* emitted;                             // bool
  const int8_t* base;
  const int32_t* ins_len;
  const int32_t* phred;
  const int8_t* ins_bases;
  const int32_t* lengths;
  int L;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// read b's columns: its length clamped to [0, L]
__device__ __forceinline__ int row_len(const AsmFields& f, int b) {
  return clampi(f.lengths[b], 0, f.L);
}

// bytes column col of read b emits: 1 + its insertion length, 0 where it
// does not emit
__device__ __forceinline__ int emit_count(const AsmFields& f, size_t at,
                                          int col, int len) {
  if (col >= len || !f.emitted[at]) return 0;
  return 1 + clampi(f.ins_len[at], 0, INS_K);
}

// the block-wide sums of a and b, in every thread (ws: 2 * ASM_WARPS ints)
__device__ __forceinline__ void block_sum2(int& a, int& b, int* ws) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    ws[wid] = a;
    ws[ASM_WARPS + wid] = b;
  }
  __syncthreads();
  a = b = 0;
  for (int w = 0; w < ASM_WARPS; ++w) {
    a += ws[w];
    b += ws[ASM_WARPS + w];
  }
  __syncthreads();
}

// pass 1: counts[b, tile], the bytes tile emits
__global__ void __launch_bounds__(ASM_THREADS)
assemble_count_kernel(AsmFields f, int n_tiles,
                      int32_t* __restrict__ counts) {
  __shared__ int ws[2 * ASM_WARPS];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int len = row_len(f, b);
  const int c0 = tile * ASM_TILE + threadIdx.x * ASM_COLS;
  int cnt = 0, none = 0;
#pragma unroll
  for (int j = 0; j < ASM_COLS; ++j)
    cnt += emit_count(f, size_t(b) * f.L + c0 + j, c0 + j, len);
  block_sum2(cnt, none, ws);
  if (threadIdx.x == 0) counts[size_t(b) * n_tiles + tile] = cnt;
}

// pass 2: the tile's bytes at the read's cursor, its share of the tail
__global__ void __launch_bounds__(ASM_THREADS)
assemble_tiles_kernel(AsmFields f, int n_tiles,
                      const int32_t* __restrict__ counts, int Lp, int share,
                      int8_t* __restrict__ codes, uint8_t* __restrict__ qual,
                      int32_t* __restrict__ nlen) {
  __shared__ int ws[2 * ASM_WARPS];
  __shared__ int8_t s_codes[ASM_SPAN];
  __shared__ uint8_t s_qual[ASM_SPAN];
  const int tile = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int lane = t & 31, wid = t >> 5;
  // the cursor at this tile (the read's earlier tiles) and the read's total
  int before = 0, total = 0;
  for (int i = t; i < n_tiles; i += ASM_THREADS) {
    const int c = counts[size_t(b) * n_tiles + i];
    total += c;
    if (i < tile) before += c;
  }
  block_sum2(before, total, ws);
  // this thread's four columns, then a block-wide exclusive scan of their
  // sums (a warp scan with __shfl_up_sync, the warp totals in shared memory)
  const int len = row_len(f, b);
  const int c0 = tile * ASM_TILE + t * ASM_COLS;
  const size_t at0 = size_t(b) * f.L + c0;
  int cnt[ASM_COLS], mine = 0;
#pragma unroll
  for (int j = 0; j < ASM_COLS; ++j) {
    cnt[j] = emit_count(f, at0 + j, c0 + j, len);
    mine += cnt[j];
  }
  int x = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[wid] = x;
  __syncthreads();
  int off = x - mine, in_tile = 0;
  for (int w = 0; w < ASM_WARPS; ++w) {
    if (w < wid) off += ws[w];
    in_tile += ws[w];
  }
  // stage the tile's bytes: each emitting column its base, then its
  // inserted bases, all with its phred
#pragma unroll
  for (int j = 0; j < ASM_COLS; ++j) {
    if (cnt[j] == 0) continue;
    const size_t at = at0 + j;
    const uint8_t q = uint8_t(clampi(f.phred[at], 0, 63));
    s_codes[off] = int8_t(clampi(f.base[at], 0, 7));
    s_qual[off] = q;
    const int8_t* ins = f.ins_bases + at * INS_K;
    for (int k = 1; k < cnt[j]; ++k) {
      s_codes[off + k] = int8_t(clampi(ins[k - 1], 0, 7));
      s_qual[off + k] = q;
    }
    off += cnt[j];
  }
  __syncthreads();
  int8_t* oc = codes + size_t(b) * Lp;
  uint8_t* oq = qual + size_t(b) * Lp;
  const int end = min(in_tile, Lp - before);           // truncated at Lp
  for (int j = t; j < end; j += ASM_THREADS) {
    oc[before + j] = s_codes[j];
    oq[before + j] = s_qual[j];
  }
  // this tile's share of the tail [total, Lp)
  const int hi = min(Lp, (tile + 1) * share);
  for (int p = max(total, tile * share) + t; p < hi; p += ASM_THREADS) {
    oc[p] = 4;
    oq[p] = 0;
  }
  if (tile == n_tiles - 1 && t == 0) nlen[b] = min(total, Lp);
}

constexpr int HCR_THREADS = 512;
constexpr int HCR_WARPS = HCR_THREADS / 32;
constexpr uint32_t FULL = 0xFFFFFFFFu;

struct HcrParams {
  int pmin, pmax, min_len, unmask_len, red, end_red;
};

// the bits [lo, hi) of a word, 0 <= lo, hi <= 32
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
  if (lo >= hi) return 0u;
  return (hi == 32 ? 0u : 1u << hi) - (1u << lo);
}

// For words x[0, NW) of L columns: before[w], the last zero bit of words
// [0, w) (-1 if none), and after[w], the first zero bit of words (w, NW)
// (L if none), so a run of set bits that crosses word w's low end starts
// at before[w] + 1 and one that crosses its high end ends at after[w].
// Both block-wide scans in one pass over tiles of HCR_THREADS words: an
// inclusive warp scan with __shfl_up_sync, the warp totals scanned by warp
// 0 in shared memory, a carry between tiles. The backward scan takes the
// words in reverse order. Ends with a barrier.
__device__ void run_edges(const uint32_t* x, int NW, int L, int* before,
                          int* after, int* tot_f, int* tot_b) {
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  int carry_f = -1, carry_b = L;
  for (int tb = 0; tb < NW; tb += HCR_THREADS) {
    const int wf = tb + t, wb = NW - 1 - tb - t;
    int f = -1, b = L;
    if (wf < NW) {
      const uint32_t z = ~x[wf];
      if (z) f = 32 * wf + 31 - __clz(int(z));
    }
    if (wb >= 0) {
      const uint32_t z = ~x[wb];
      if (z) b = 32 * wb + __ffs(int(z)) - 1;
    }
    for (int o = 1; o < 32; o <<= 1) {
      const int yf = __shfl_up_sync(FULL, f, o);
      const int yb = __shfl_up_sync(FULL, b, o);
      if (lane >= o) {
        f = max(f, yf);
        b = min(b, yb);
      }
    }
    if (lane == 31) {
      tot_f[wid] = f;
      tot_b[wid] = b;
    }
    __syncthreads();
    if (wid == 0) {
      int sf = lane < HCR_WARPS ? tot_f[lane] : -1;
      int sb = lane < HCR_WARPS ? tot_b[lane] : L;
      for (int o = 1; o < 32; o <<= 1) {
        const int yf = __shfl_up_sync(FULL, sf, o);
        const int yb = __shfl_up_sync(FULL, sb, o);
        if (lane >= o) {
          sf = max(sf, yf);
          sb = min(sb, yb);
        }
      }
      if (lane < HCR_WARPS) {
        tot_f[lane] = sf;
        tot_b[lane] = sb;
      }
    }
    __syncthreads();
    // exclusive: the earlier warps' total and the previous lane's value
    int pf = __shfl_up_sync(FULL, f, 1), pb = __shfl_up_sync(FULL, b, 1);
    if (lane == 0) {
      pf = -1;
      pb = L;
    }
    if (wid > 0) {
      pf = max(pf, tot_f[wid - 1]);
      pb = min(pb, tot_b[wid - 1]);
    }
    if (wf < NW) before[wf] = max(carry_f, pf);
    if (wb >= 0) after[wb] = min(carry_b, pb);
    carry_f = max(carry_f, tot_f[HCR_WARPS - 1]);
    carry_b = min(carry_b, tot_b[HCR_WARPS - 1]);
    __syncthreads();
  }
}

// One level: for every run of set bits [rs, re) of x (columns), the part
// [a, z) of it in word w, from a = the word's first column of the run and
// z = one past its last, narrowed by pick(rs, re, a, z) (a >= z drops
// it); out[w] = those bits | (also ? also[w] : 0). Returns the thread's
// popcount of what it wrote.
template <typename Pick>
__device__ int runs_level(const uint32_t* x, uint32_t* out,
                          const uint32_t* also, const int* before,
                          const int* after, int NW, Pick pick) {
  int count = 0;
  for (int w = threadIdx.x; w < NW; w += HCR_THREADS) {
    uint32_t rest = x[w], y = 0u;
    while (rest) {
      const int s = __ffs(int(rest)) - 1;
      const uint32_t u = ~(rest >> s);
      const int e = u ? s + __ffs(int(u)) - 1 : 32;
      const int rs = s == 0 ? before[w] + 1 : 32 * w + s;
      const int re = e == 32 ? after[w] : 32 * w + e;
      int a = 32 * w + s, z = 32 * w + e;
      pick(rs, re, a, z);
      y |= bit_range(a - 32 * w, z - 32 * w);
      rest &= ~bit_range(s, e);
    }
    if (also) y |= also[w];
    out[w] = y;
    count += __popc(y);
  }
  return count;
}

__global__ void __launch_bounds__(HCR_THREADS)
hcr_scan_kernel(const uint8_t* __restrict__ qual,
                const int32_t* __restrict__ lengths, int L, HcrParams p,
                uint8_t* __restrict__ mask, int32_t* __restrict__ counts) {
  extern __shared__ uint32_t words[];          // 4 arrays of NW words
  __shared__ int tot_f[HCR_WARPS], tot_b[HCR_WARPS], total;
  const int NW = (L + 31) >> 5;
  uint32_t* xa = words;
  uint32_t* xb = words + NW;
  int* before = reinterpret_cast<int*>(words + 2 * NW);
  int* after = reinterpret_cast<int*>(words + 3 * NW);
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31;
  const int len = lengths[b];                  // as given: compared to run ends
  const int lenc = len < 0 ? 0 : (len < L ? len : L);
  const uint8_t* row = qual + size_t(b) * L;
  if (t == 0) total = 0;
  // in-range bits: one ballot per warp over 32 columns
  for (int tb = 0; tb < L; tb += HCR_THREADS) {
    const int col = tb + t;
    const int q = col < lenc ? row[col] : -1;
    const uint32_t bits = __ballot_sync(FULL, q >= p.pmin && q <= p.pmax &&
                                                  col < lenc);
    if (lane == 0 && col < L) xa[col >> 5] = bits;
  }
  __syncthreads();
  // (1) in-range runs of >= min_len are kept: xb
  run_edges(xa, NW, L, before, after, tot_f, tot_b);
  runs_level(xa, xb, nullptr, before, after, NW,
             [&](int rs, int re, int& a, int& z) {
               if (re - rs < p.min_len) z = a;
             });
  __syncthreads();
  // (2) gaps (valid columns not kept) shorter than unmask_len between two
  // kept runs are filled; merged = kept | filled: xa
  for (int w = t; w < NW; w += HCR_THREADS)
    xa[w] = ~xb[w] & bit_range(0, min(32, max(0, lenc - 32 * w)));
  __syncthreads();
  run_edges(xa, NW, L, before, after, tot_f, tot_b);
  runs_level(xa, xa, xb, before, after, NW,
             [&](int rs, int re, int& a, int& z) {
               if (!(re - rs < p.unmask_len && rs > 0 && re < lenc)) z = a;
             });
  __syncthreads();
  // (3) merged runs trimmed at their ends: xb, counted
  run_edges(xa, NW, L, before, after, tot_f, tot_b);
  int count = runs_level(xa, xb, nullptr, before, after, NW,
                         [&](int rs, int re, int& a, int& z) {
                           a = max(a, rs + (rs == 0 ? p.end_red : p.red));
                           z = min(z, re - (re == len ? p.end_red : p.red));
                         });
  for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(FULL, count, o);
  if (lane == 0 && count) atomicAdd(&total, count);
  __syncthreads();
  uint8_t* mrow = mask + size_t(b) * L;
  for (int i = t; i < L; i += HCR_THREADS)
    mrow[i] = uint8_t((xb[i >> 5] >> (i & 31)) & 1u);
  if (t == 0) counts[b] = total;
}

}  // namespace

// counts: int32 scratch [B, n_tiles], n_tiles = max(1, ceil(L / ASM_TILE))
PT_EXPORT int pt_assemble_rows(const void* emitted, const void* base,
                               const void* ins_len, const void* phred,
                               const void* ins_bases, const void* lengths,
                               int B, int L, int Lp, void* counts,
                               void* codes, void* qual, void* nlen,
                               void* stream) {
  if (B <= 0) return int(cudaSuccess);
  const AsmFields f{static_cast<const uint8_t*>(emitted),
                    static_cast<const int8_t*>(base),
                    static_cast<const int32_t*>(ins_len),
                    static_cast<const int32_t*>(phred),
                    static_cast<const int8_t*>(ins_bases),
                    static_cast<const int32_t*>(lengths), L};
  const int n_tiles = L > ASM_TILE ? (L + ASM_TILE - 1) / ASM_TILE : 1;
  const int share = (Lp + n_tiles - 1) / n_tiles;
  const dim3 grid(n_tiles, B);
  int32_t* cnt = static_cast<int32_t*>(counts);
  assemble_count_kernel<<<grid, ASM_THREADS, 0, cudaStream_t(stream)>>>(
      f, n_tiles, cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  assemble_tiles_kernel<<<grid, ASM_THREADS, 0, cudaStream_t(stream)>>>(
      f, n_tiles, cnt, Lp, share, static_cast<int8_t*>(codes),
      static_cast<uint8_t*>(qual), static_cast<int32_t*>(nlen));
  return int(cudaGetLastError());
}

PT_EXPORT int pt_hcr_mask_rows(const void* qual, const void* lengths, int B,
                               int L, int pmin, int pmax, int min_len,
                               int unmask_len, int red, int end_red,
                               void* mask, void* counts, void* stream) {
  HcrParams p{pmin, pmax, min_len, unmask_len, red, end_red};
  const size_t smem = size_t((L + 31) / 32) * 16;   // 4 words a column word
  cudaError_t e = pt_reserve_smem(hcr_scan_kernel, smem);
  if (e != cudaSuccess) return int(e);
  hcr_scan_kernel<<<B, HCR_THREADS, smem, cudaStream_t(stream)>>>(
      static_cast<const uint8_t*>(qual), static_cast<const int32_t*>(lengths),
      L, p, static_cast<uint8_t*>(mask), static_cast<int32_t*>(counts));
  return int(cudaGetLastError());
}
