// Banded unit-cost edit alignment with traceback: the accuracy scoreboard's
// error classes (dist, matches, substitutions, insertions, deletions of one
// optimal path of each (read, truth) pair).
//
// Replaces the host numpy of proovread_tpu_torch/obs/accuracy.py:_banded_tb
// and its walk (the reference's proovread_tpu/obs/accuracy.py:_banded_tb is
// the same numpy; no Pallas kernel): rows of the shorter sequence a against
// a diagonal band of the longer b, cell idx = j - i + w of width
// lb - la + 2w + 1; diagonal (i-1, j-1) + (a[i-1] != b[j-1] or a[i-1] is
// N), up (i-1, j) + 1, and the left dependency (i, j-1) + 1 closed by a
// min-plus prefix scan, cur = min(c0, cummin(c0 - idx) + idx); j < 1 has no
// diagonal, j < 0 and j > lb hold _BIG, every cell is clamped to _BIG. The
// walk goes back from (la, lb) preferring the diagonal, then up, then left,
// with the host's exact comparisons (_BIG arithmetic included).
//
// What bounds it: each pair is a chain of la rows, each a scan across the
// band; the host ran a dozen numpy calls a row (18-23 s a scored run for
// ~115 alignments on the card's host, PERF.md). The work is la * width
// cells (~40 M for a 15%-error 8 kb read) of a few dozen instructions, a
// few ms a pair at one SM's issue rate; the floor is the longest pair's
// row chain. So one block takes one pair (all pairs of a call in one
// launch, one SM each), and a row costs two __syncthreads() (on the H100
// the widest before-correction pairs hold a launch at ~50 ms, with
// 1,024-thread blocks faster than smaller ones: PERF.md):
// - the two DP rows and a state byte a cell live in shared memory (in a
//   global scratch past the wrapper's shared-memory size).
// - each thread owns E contiguous cells of the row (E = ceil(width /
//   threads), made odd so that a warp's threads reading their e-th cells
//   hit 32 different banks); warps past the row's cells only meet the
//   barriers, so a narrow band (a corrected read's) costs a few warps. In
//   a first pass a thread computes each cell's c0 = min(diagonal, up),
//   keeps it in the new row, and the minimum of c0 - idx; a warp
//   __shfl_up_sync min-scan and the warps' totals through shared memory
//   give each thread the minimum over the threads before it; a second
//   pass runs the scan along its cells (cur = min(c0, cummin(c0 - idx) +
//   idx)), applies the band's masks and the clamp, and stores each cell's
//   state: 0 the diagonal is a match, 1 a substitution, 2 up (an
//   insertion), 3 left (a deletion), the host walk's first choice among
//   "diagonal predecessor gives this cell", "up predecessor does", else
//   left. After the row's barrier the warps pack the states into two
//   bit-planes by __ballot_sync (coalesced, ceil(width / 32) words a row
//   each).
// - after the last row one warp walks back: it stages tiles of 32 rows x
//   8 words of both planes in shared memory (a device-memory round trip a
//   tile, not a step), finds in each row the highest cell at or left of
//   the current one whose state is not "left" (one __clz a word; the
//   cells it passes are deletions) and takes that cell's step.
// The wrapper doubles the band and relaunches the pairs whose distance
// exceeds it while the band is below the shorter length, as the host does.

#include <climits>

#include "common.cuh"

namespace {

constexpr int BIG = 1 << 20;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WALK_ROWS = 32;     // rows of a walk tile
constexpr int WALK_WORDS = 8;     // words of a walk tile's row, a plane

// A pair's DP scratch in 32-bit words: two band rows and a state byte a
// cell.
__host__ __device__ __forceinline__ int64_t dp_words(int width) {
  return 2 * int64_t(width) + (width + 3) / 4;
}

__device__ __forceinline__ int warp_min_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x = min(x, y);
  }
  return x;
}

// list [gridDim.x]: the pairs of this launch; band [P]: w; bits_off [P]:
// a pair's bit-planes (row i >= 1, plane q at words ((i-1) * 2 + q) * S);
// rows_off [P]: its two DP rows in grows, or -1 for shared memory; out
// [P, 5]: dist (-1 if the walk left the band), matches, sub, ins, del.
__global__ void __launch_bounds__(1024)
edit_kernel(const int8_t* rd, const int64_t* rd_off, const int8_t* tr,
            const int64_t* tr_off, const int32_t* list,
            const int32_t* band, const int64_t* bits_off,
            const int64_t* rows_off, uint32_t* bits, int32_t* grows,
            int64_t* out) {
  extern __shared__ __align__(16) int32_t edit_smem[];
  __shared__ int tot_s[32];
  __shared__ uint32_t tile_s[WALK_ROWS][2][WALK_WORDS];
  const int p = list[blockIdx.x];
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const int8_t* a = rd + rd_off[p];
  const int8_t* b = tr + tr_off[p];
  int la = int(rd_off[p + 1] - rd_off[p]);
  int lb = int(tr_off[p + 1] - tr_off[p]);
  const bool swap = la > lb;             // a is the shorter sequence
  if (swap) {
    const int8_t* x = a;
    a = b;
    b = x;
    const int y = la;
    la = lb;
    lb = y;
  }
  int64_t* o = out + int64_t(p) * 5;
  if (la == 0) {
    if (tid == 0) {
      o[0] = la + lb;
      o[1] = 0;
      o[2] = 0;
      o[3] = swap ? lb : 0;
      o[4] = swap ? 0 : lb;
    }
    return;
  }
  const int w = band[p];
  const int d = lb - la;
  const int width = d + 2 * w + 1;
  const int S = (width + 31) >> 5;
  uint32_t* pb = bits + bits_off[p];
  int32_t* prev = rows_off[p] < 0 ? edit_smem : grows + rows_off[p];
  int32_t* cur = prev + width;
  uint8_t* st = reinterpret_cast<uint8_t*>(cur + width);
  for (int idx = tid; idx < width; idx += T) {
    const int j = idx - w;
    prev[idx] = j >= 0 && j <= lb ? j : BIG;
  }
  // the thread's cells: E contiguous ones, E odd so that the threads of a
  // warp reading their e-th cells hit 32 different banks; nwa warps hold
  // cells, the others only meet the barriers
  const int E = ((width + T - 1) / T) | 1;
  const int c_lo = min(width, E * tid);
  const int c_hi = min(width, c_lo + E);
  const int nwa = ((width + E - 1) / E + 31) >> 5;
  __syncthreads();
  for (int i = 1; i <= la; ++i) {
    const int ai = a[i - 1];
    int incl = INT_MAX;
    if (warp < nwa) {
      // pass 1: each cell's c0 = min(diagonal, up), kept in cur, and the
      // thread's minimum of c0 - idx, then its warp's inclusive min-scan
      int r = INT_MAX;
      for (int idx = c_lo; idx < c_hi; ++idx) {
        const int j = i + idx - w;
        const int cost = ai >= 4 || j < 1 || j > lb || b[j - 1] != ai;
        const int diag = j >= 1 ? prev[idx] + cost : BIG;
        const int up = idx + 1 < width ? prev[idx + 1] + 1 : BIG;
        const int c0 = min(diag, up);
        cur[idx] = c0;
        r = min(r, c0 - idx);
      }
      incl = warp_min_scan(r, lane);
      if (lane == 31) tot_s[warp] = incl;
    }
    __syncthreads();
    if (warp < nwa) {
      // the minimum over the threads before this one: the warps' totals
      // scanned, then the warp's own scan shifted by a lane
      const int ws = warp_min_scan(lane < nwa ? tot_s[lane] : INT_MAX, lane);
      const int before = __shfl_sync(FULL, ws, warp > 0 ? warp - 1 : 0);
      const int left = __shfl_up_sync(FULL, incl, 1);
      int sc = min(warp > 0 ? before : INT_MAX, lane > 0 ? left : INT_MAX);
      // pass 2: cur = min(c0, cummin(c0 - idx) + idx), the band's masks,
      // the clamp, and each cell's state byte
      for (int idx = c_lo; idx < c_hi; ++idx) {
        const int j = i + idx - w;
        const int c0 = cur[idx];
        sc = min(sc, c0 - idx);
        int cv = min(c0, sc + idx);
        if (j < 0 || j > lb) cv = BIG;
        cv = min(cv, BIG);
        cur[idx] = cv;
        const int cost = ai >= 4 || j < 1 || j > lb || b[j - 1] != ai;
        const int pu = idx + 1 < width ? prev[idx + 1] : BIG;
        int state = 3;
        if (j >= 1 && prev[idx] + cost == cv)
          state = cost;                  // 0: a match, 1: a substitution
        else if (pu + 1 == cv)
          state = 2;
        st[idx] = uint8_t(state);
      }
    }
    __syncthreads();
    // the row's states as two bit-planes, a word of 32 cells a warp step
    uint32_t* rb = pb + int64_t(i - 1) * 2 * S;
    for (int wd = warp; wd < S; wd += nw) {
      const int idx = wd * 32 + lane;
      const int state = idx < width ? st[idx] : 3;
      const unsigned b0 = __ballot_sync(FULL, state & 1);
      const unsigned b1 = __ballot_sync(FULL, state >> 1);
      if (lane == 0) {
        rb[wd] = b0;
        rb[S + wd] = b1;
      }
    }
    int32_t* t = prev;
    prev = cur;
    cur = t;
  }
  __syncthreads();                       // the last row's bit-planes
  if (warp != 0) return;

  // the walk, every lane taking the same steps
  const int dist = prev[d + w];
  int i = la, idx = d + w;
  int t_hi = -1, t_w0 = 0;               // the tile: rows t_hi-31..t_hi
  auto stage = [&](int hi, int w0) {
    __syncwarp();
    for (int e = lane; e < WALK_ROWS * 2 * WALK_WORDS; e += 32) {
      const int r = e / (2 * WALK_WORDS), q = (e / WALK_WORDS) & 1;
      const int row = hi - r, word = w0 + e % WALK_WORDS;
      tile_s[r][q][e % WALK_WORDS] =
          row >= 1 && word >= 0 && word < S
              ? pb[(int64_t(row - 1) * 2 + q) * S + word] : FULL;
    }
    __syncwarp();
    t_hi = hi;
    t_w0 = w0;
  };
  // word wd of plane q of row i, in the tile
  auto tw = [&](int q, int wd) { return tile_s[t_hi - i][q][wd - t_w0]; };
  int64_t matches = 0, sub = 0, ins = 0, del = 0;
  bool ok = true;
  while (i > 0) {
    int wd = idx >> 5;
    if (i > t_hi || i <= t_hi - WALK_ROWS || wd < t_w0
        || wd >= t_w0 + WALK_WORDS)
      stage(i, wd - (WALK_WORDS - 2));
    // the highest cell at or left of idx whose state is not "left"
    uint32_t X = ~(tw(0, wd) & tw(1, wd)) & (FULL >> (31 - (idx & 31)));
    while (X == 0) {
      if (--wd < 0) break;
      if (wd < t_w0) stage(i, wd - (WALK_WORDS - 2));
      X = ~(tw(0, wd) & tw(1, wd));
    }
    if (wd < 0) {
      ok = false;
      break;
    }
    const int bit = 31 - __clz(int(X));
    const int at = wd * 32 + bit;
    del += idx - at;
    idx = at;
    const int st = int((tw(0, wd) >> bit) & 1u)
                   | int(((tw(1, wd) >> bit) & 1u) << 1);
    if (st == 0) {
      ++matches;
    } else if (st == 1) {
      ++sub;
    } else {
      ++ins;
      ++idx;
    }
    --i;
  }
  del += idx - w;                        // row 0: left to j = 0
  if (lane == 0) {
    o[0] = ok ? dist : -1;
    o[1] = matches;
    o[2] = sub;
    o[3] = swap ? del : ins;
    o[4] = swap ? ins : del;
  }
}

}  // namespace

// rd/tr i8 flat (reads, truths), rd_off/tr_off i64 [P+1]; list i32 [G];
// band i32 [P]; bits_off, rows_off i64 [P]; bits u32, grows i32 scratch;
// threads a block; smem_width: the widest band row kept in shared memory;
// out i64 [P, 5] (the listed pairs' rows written).
PT_EXPORT int pt_edit_alignments(const void* rd, const void* rd_off,
                                 const void* tr, const void* tr_off,
                                 const void* list, int G, const void* band,
                                 const void* bits_off, const void* rows_off,
                                 void* bits, void* grows, int threads,
                                 int smem_width, void* out, void* stream) {
  if (G <= 0) return cudaSuccess;
  if (threads < 32 || threads > 1024 || threads % 32) {
    return cudaErrorInvalidValue;
  }
  const size_t smem =
      smem_width > 0 ? size_t(dp_words(smem_width)) * sizeof(int32_t) : 0;
  cudaError_t e = pt_reserve_smem(edit_kernel, smem);
  if (e != cudaSuccess) return e;
  const auto s = static_cast<cudaStream_t>(stream);
  edit_kernel<<<G, threads, smem, s>>>(
      static_cast<const int8_t*>(rd), static_cast<const int64_t*>(rd_off),
      static_cast<const int8_t*>(tr), static_cast<const int64_t*>(tr_off),
      static_cast<const int32_t*>(list), static_cast<const int32_t*>(band),
      static_cast<const int64_t*>(bits_off),
      static_cast<const int64_t*>(rows_off), static_cast<uint32_t*>(bits),
      static_cast<int32_t*>(grows), static_cast<int64_t*>(out));
  return cudaGetLastError();
}
