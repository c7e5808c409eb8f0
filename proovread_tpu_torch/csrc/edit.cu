// Banded unit-cost edit alignment with traceback: the accuracy scoreboard's
// error classes (dist, matches, substitutions, insertions, deletions of one
// optimal path of each (read, truth) pair).
//
// Replaces the host numpy of proovread_tpu_torch/obs/accuracy.py:_banded_tb
// and its walk (the reference's proovread_tpu/obs/accuracy.py:_banded_tb is
// the same numpy; no Pallas kernel): with a the shorter sequence (m rows)
// and b the longer (n columns, d = n - m), the host fills the band of cells
// with offset j - i in [-w, d + w] (diagonal + (a != b or a is N), up + 1,
// left + 1; every other cell _BIG), then walks back from (m, n) preferring
// the diagonal, then up, then left. The wrapper doubles w and relaunches
// the pairs whose distance exceeds it while w is below m.
//
// Exactness: every step off the diagonal moves j - i by one and costs 1,
// so a path of cost <= w from (0, 0) stays inside offsets [-w, w], inside
// the band; every cell whose true distance D is <= w has its banded value
// equal to D, every other cell a value >= D > w. The walk starts at dist
// <= w and only compares candidates against a current value <= w, so it
// visits only cells with D <= w and takes the same branch under any DP X
// with X = D where D <= w and X > w elsewhere; the relaunch test dist > w
// has the same truth value under such an X. This kernel computes such an
// X: the exact recurrence on a region of whole 64-bit words that contains
// the band, its boundary cells set to upper bounds of D (a value one above
// a neighbour's), never below it, so X >= D everywhere and X = D along
// every path of cost <= w. With w >= m the band is the whole matrix and X
// is D everywhere.
//
// What bounds it: the host's recurrence costs ~9 integer operations a
// banded cell (0.4 ms for phase 2's 743 M cells at the card's INT32 rate,
// obs/profile.py edit_counts), but each pair is a chain of dependent steps.
// The earlier design (one 1,024-thread block a pair, a row a step: a
// two-pass min-plus scan across the band, two __syncthreads() and a global
// load of b twice a cell) issued several dozen instructions a cell and
// took ~3 us a row: 50 ms for those pairs on the H100 (PERF.md row 11).
//
// This design cuts the work of a step by about 64x (Myers 1999; Hyyrö's
// blocked and banded form; Edlib's traceback from stored deltas), so the
// floor becomes the longest pair's chain of columns, each a chain of
// dependent instructions that one warp issues in order:
// - DP (edit_dp_kernel): a pair is one warp, up to 8 pairs a block (the
//   wrapper's EDIT_WARPS), no block barrier. The rows are the bit-vector
//   axis: the vertical deltas of a column (Pv, Mv: +1, -1) over a window of
//   32 W words, W words a lane (lane l holds slots lW .. lW + W - 1, slot
//   k the row word wlo + k), W picked by the wrapper so that the window
//   holds the band's rows at every column (W <= 6 in registers, else a
//   global scratch). b is stepped a base a column: Eq (the rows whose base
//   equals b[j-1]; none for N, so an N never matches) from a per-pair
//   table of four masks a word and a zero row, built by the warp first,
//   loaded a column ahead. The sum (Eq & Pv) + Pv is a carry-lookahead
//   adder: each word's sum and that sum plus one, the lane's generate and
//   propagate, the carries between lanes from two ballots and one 32-bit
//   addition (as csrc/lcs.cu), then each word's carry selects its sum. The
//   horizontal deltas shift up a row through one shuffle; the row below
//   the window takes a +1 horizontal delta (exact on row 0, an upper
//   bound above it). As the band slides down (its lowest row is j - d -
//   w), the window drops its lowest word and takes a fresh one on top
//   (Pv all ones: one above the cell below, an upper bound; the window
//   keeps a word to spare, so that word's base is above the band anyway),
//   and the value below the window (the anchor, for dist) adds the
//   dropped word's deltas. The columns between two slides or tiles of b
//   run as a loop without a branch, two columns an iteration at W <= 4,
//   so that one column's stores fill the gaps of the next one's chain.
//   Each column stores two bit-planes a word, 16 bytes: D (the walk takes
//   the diagonal: a match, or X(i-1, j-1) + 1 == X(i, j), read off the
//   vertical and shifted horizontal deltas) and M (on the diagonal a
//   match; off it, the up step: X(i-1, j) + 1 == X(i, j)).
// - Walk (edit_walk_kernel): a pair is one warp, which stages 32 columns
//   (lane x column j0 - x) of three row words in registers, and the 32
//   columns to their left as it enters them, looks down the diagonal from
//   the current cell at once (lane x at (i - x', j - x')), takes the run
//   of matches with one ballot and the step after it from its lane, the
//   host's branch order throughout. A walk that reaches a word outside a
//   column's stored window left the band: dist -1. Pairs that the wrapper
//   will relaunch at twice the band skip it.
// Codes outside 0..4 compare as the host does: equal negative codes
// match (their Eq is built from a directly), codes >= 4 never do.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr uint64_t ONES = ~0ull;
constexpr int MAX_WARPS = 8;      // pairs a block (255 registers a thread)

// The lowest row word of the window at column j (rows max(1, j - dw) ..,
// dw = d + w).
__device__ __forceinline__ int wlo_of(int j, int dw) {
  return (max(1, j - dw) - 1) >> 6;
}

// A lane's words in registers (W a compile-time constant). UNROLL: the
// columns a loop iteration runs, so that one column's states and stores
// fill the gaps of the next column's chain (more spill at larger W).
template <int W>
struct RegWords {
  static constexpr int UNROLL = W <= 4 ? 2 : 1;
  uint64_t pv[W], mv[W], eq[W], en[W], s[W], h[W], s1[W];
  __device__ __forceinline__ constexpr int size() const { return W; }
  __device__ __forceinline__ uint64_t& PV(int t) { return pv[t]; }
  __device__ __forceinline__ uint64_t& MV(int t) { return mv[t]; }
  __device__ __forceinline__ uint64_t& EQ(int t) { return eq[t]; }
  __device__ __forceinline__ uint64_t& EN(int t) { return en[t]; }
  __device__ __forceinline__ uint64_t& S(int t) { return s[t]; }
  __device__ __forceinline__ uint64_t& H(int t) { return h[t]; }
  __device__ __forceinline__ uint64_t& S1(int t) { return s1[t]; }
};

// A lane's words in a global scratch, lane-interleaved (seven arrays of w
// words a lane), for windows past the register ones.
struct GlobWords {
  static constexpr int UNROLL = 1;
  uint64_t* base;                   // the pair's scratch + lane
  int w;
  __device__ __forceinline__ int size() const { return w; }
  __device__ __forceinline__ uint64_t& at(int a, int t) {
    return base[(int64_t(a) * w + t) * 32];
  }
  __device__ __forceinline__ uint64_t& PV(int t) { return at(0, t); }
  __device__ __forceinline__ uint64_t& MV(int t) { return at(1, t); }
  __device__ __forceinline__ uint64_t& EQ(int t) { return at(2, t); }
  __device__ __forceinline__ uint64_t& EN(int t) { return at(3, t); }
  __device__ __forceinline__ uint64_t& S(int t) { return at(4, t); }
  __device__ __forceinline__ uint64_t& H(int t) { return at(5, t); }
  __device__ __forceinline__ uint64_t& S1(int t) { return at(6, t); }
};

// The rows of word q (rows 64q + 1 ..) whose base is c, for a code the
// table does not hold (negative).
__device__ uint64_t eq_direct(const int8_t* a, int m, int64_t q, int c) {
  uint64_t e = 0;
  for (int k = 0; k < 64; ++k) {
    const int64_t r = q * 64 + k;
    if (r < m && a[r] == c) e |= 1ull << k;
  }
  return e;
}

// Eq of the lane's words (slots lane * nw + t, words q0 + t) for code c
// into EN: codes 0-3 from their rows of the table, others from its zero
// row (4), negative ones (only where NEG) from a directly.
template <bool NEG, class Wd>
__device__ __forceinline__ void load_eq(Wd& ws, const uint64_t* peq,
                                        int npad, const int8_t* a, int m,
                                        int c, int q0) {
  const int nw = ws.size();
  if (NEG && c < 0) {
#pragma unroll
    for (int t = 0; t < nw; ++t) ws.EN(t) = eq_direct(a, m, q0 + t, c);
  } else {
    const uint64_t* row = peq + int64_t(min(unsigned(c), 4u)) * npad + q0;
#pragma unroll
    for (int t = 0; t < nw; ++t) ws.EN(t) = row[t];
  }
}

// One column of the pair's DP. Pv, Mv: the vertical deltas of column j-1
// over the window, turned into column j's; EQ: b[j-1]'s match masks. The
// states of the column's stored slots (k < S) go to rec.
template <class Wd>
__device__ __forceinline__ void dp_column(Wd& ws, uint4* rec, int S,
                                          int lane) {
  const int nw = ws.size();
  // s = (Eq & Pv) + Pv over the warp's integer, as a carry-lookahead
  // adder: each word's sum, and that sum plus one, without a carry in;
  // its generate (a carry out) and propagate (all ones) bits; the lane's
  // generate and propagate from those; the lanes' carries from two
  // ballots; then each word's carry in selects its sum
  bool G = false, P = true;
#pragma unroll
  for (int t = 0; t < nw; ++t) {
    const uint64_t pv = ws.PV(t);
    const uint64_t s = (ws.EQ(t) & pv) + pv;
    ws.S(t) = s;
    ws.S1(t) = s + 1;
    G = s < pv || (s == ONES && G);
    P = P && s == ONES;
  }
  const unsigned g = __ballot_sync(FULL, G);
  const unsigned a = g | __ballot_sync(FULL, P);
  // carry into each lane (nothing into the window's lowest word)
  bool cin = (((a + g) ^ a ^ g) >> lane) & 1u;
#pragma unroll
  for (int t = 0; t < nw; ++t) {
    const uint64_t pv = ws.PV(t);
    const uint64_t s = cin ? ws.S1(t) : ws.S(t);
    cin = ws.S(t) < pv || (ws.S(t) == ONES && cin);
    const uint64_t xh = (s ^ pv) | ws.EQ(t);
    ws.S(t) = ws.MV(t) | ~(xh | pv);       // Ph
    ws.H(t) = pv & xh;                     // Mh
  }
  // the horizontal deltas one row up: the top bits cross to the next
  // lane; into the window's lowest row a +1 (Ph bit 0)
  const unsigned top = unsigned(ws.S(nw - 1) >> 63)
                       | unsigned(ws.H(nw - 1) >> 63) << 1;
  unsigned in = __shfl_up_sync(FULL, top, 1);
  if (lane == 0) in = 1;
  uint4* out = rec + lane * nw;
#pragma unroll
  for (int t = nw - 1; t >= 0; --t) {
    const uint64_t ph = ws.S(t) << 1
        | (t > 0 ? ws.S(t > 0 ? t - 1 : 0) >> 63 : uint64_t(in & 1u));
    const uint64_t mh = ws.H(t) << 1
        | (t > 0 ? ws.H(t > 0 ? t - 1 : 0) >> 63 : uint64_t(in >> 1));
    const uint64_t eq = ws.EQ(t);
    const uint64_t xv = eq | ws.MV(t);
    const uint64_t pv = mh | ~(xv | ph);
    const uint64_t mv = ph & xv;
    ws.PV(t) = pv;
    ws.MV(t) = mv;
    // X(i, j) - X(i-1, j-1) = dv + dh' is 1 where (dv, dh') is (1, 0) or
    // (0, 1); on a match it is 0 and the diagonal is taken
    const uint64_t dg = eq | (pv & ~mh) | (ph & ~mv);
    const uint64_t mk = eq | (~dg & pv);
    if (lane * nw + t < S)
      out[t] = make_uint4(unsigned(dg), unsigned(dg >> 32), unsigned(mk),
                          unsigned(mk >> 32));
  }
}

// Columns j .. end (j left past end): each loads b[j]'s masks for column
// j + 1 (a word up when that column slides the window) and runs column j.
template <bool NEG, class Wd>
__device__ __forceinline__ void dp_columns(Wd& ws, int& j, int end, int t0,
                                           int tb, int next_slide, int q0,
                                           const uint64_t* peq, int npad,
                                           const int8_t* a, int m,
                                           uint4* rec, int S, int lane) {
  const int nw = ws.size();
#pragma unroll Wd::UNROLL
  for (; j <= end; ++j) {
#pragma unroll
    for (int t = 0; t < nw; ++t) ws.EQ(t) = ws.EN(t);
    load_eq<NEG>(ws, peq, npad, a, m, __shfl_sync(FULL, tb, j - t0),
                 q0 + (j + 1 >= next_slide));
    dp_column(ws, rec + int64_t(j - 1) * S, S, lane);
  }
}

// The window one word up: slot k takes slot k + 1, the top slot a fresh
// word (Pv all ones).
template <class Wd>
__device__ __forceinline__ void slide(Wd& ws, int lane) {
  const int nw = ws.size();
  const uint64_t p0 = __shfl_down_sync(FULL, ws.PV(0), 1);
  const uint64_t m0 = __shfl_down_sync(FULL, ws.MV(0), 1);
#pragma unroll
  for (int t = 0; t + 1 < nw; ++t) {
    ws.PV(t) = ws.PV(t + 1);
    ws.MV(t) = ws.MV(t + 1);
  }
  ws.PV(nw - 1) = lane == 31 ? ONES : p0;
  ws.MV(nw - 1) = lane == 31 ? 0 : m0;
}

// The DP of one pair (a the shorter side, m >= 1): the match-mask table,
// the columns, then X(m, n) into o[0].
template <class Wd>
__device__ void dp_pair(Wd& ws, const int8_t* a, int m, const int8_t* b,
                        int n, int w, int S, uint64_t* peq, uint4* rec,
                        int lane, int64_t* o) {
  const int nw = ws.size();
  const int nwords = (m + 63) >> 6;
  const int npad = nwords + 32 * nw;       // past the last word: zeros
  for (int q = lane; q < npad; q += 32) {
    uint64_t ma = 0, mc = 0, mg = 0, mt = 0;
    for (int k = 0; k < 64; ++k) {
      const int64_t r = int64_t(q) * 64 + k;
      const int x = r < m ? a[r] : 4;
      const uint64_t bit = 1ull << k;
      ma |= x == 0 ? bit : 0;
      mc |= x == 1 ? bit : 0;
      mg |= x == 2 ? bit : 0;
      mt |= x == 3 ? bit : 0;
    }
    peq[q] = ma;
    peq[npad + q] = mc;
    peq[2 * npad + q] = mg;
    peq[3 * npad + q] = mt;
    peq[4 * npad + q] = 0;
  }
  __syncwarp();
  const int dw = n - m + w;
#pragma unroll
  for (int t = 0; t < nw; ++t) {
    ws.PV(t) = ONES;                       // column 0: X(i, 0) = i
    ws.MV(t) = 0;
  }
  int wlo = 0;
  int anchor = 0;                          // X(64 wlo, j)
  int next_slide = dw + 65;                // the first j of wlo + 1
  // b's codes 32 a tile, lane x holding b[t0 + x] (4 past n), the next
  // tile loaded a tile ahead; columns t0 .. t0 + 31 load the masks of
  // b[j] for column j + 1, one column ahead
  int tb = lane < n ? int(b[lane]) : 4;
  int tn = 32 + lane < n ? int(b[32 + lane]) : 4;
  load_eq<true>(ws, peq, npad, a, m, __shfl_sync(FULL, tb, 0), lane * nw);
  for (int t0 = 0; t0 <= n; t0 += 32) {
    const bool neg = __ballot_sync(FULL, tb < 0) != 0;
    int j = max(1, t0);
    const int jend = min(n, t0 + 31);
    while (j <= jend) {
      if (j == next_slide) {
        // the row below the window moves up a word: its value adds the
        // dropped word's deltas (column j - 1)
        anchor += __shfl_sync(FULL,
                              __popcll(ws.PV(0)) - __popcll(ws.MV(0)), 0);
        slide(ws, lane);
        ++wlo;
        next_slide += 64;
      }
      // a run of columns without a slide or a new tile, and without a
      // branch unless the tile holds a negative code
      const int end = min(jend, next_slide - 1);
      const int q0 = wlo + lane * nw;
      if (neg)
        dp_columns<true>(ws, j, end, t0, tb, next_slide, q0, peq, npad, a,
                         m, rec, S, lane);
      else
        dp_columns<false>(ws, j, end, t0, tb, next_slide, q0, peq, npad, a,
                          m, rec, S, lane);
    }
    anchor += jend - max(1, t0) + 1;       // the +1 below the window
    tb = tn;
    tn = t0 + 64 + lane < n ? int(b[t0 + 64 + lane]) : 4;
  }
  // X(m, n): the anchor and the deltas of the rows up to m
  int sum = 0;
#pragma unroll
  for (int t = 0; t < nw; ++t) {
    const int64_t r0 = int64_t(wlo + lane * nw + t) * 64;   // rows r0 + 1 ..
    const uint64_t mask = r0 >= m ? 0
        : m - r0 >= 64 ? ONES : (1ull << (m - r0)) - 1;
    sum += __popcll(ws.PV(t) & mask) - __popcll(ws.MV(t) & mask);
  }
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) sum += __shfl_xor_sync(FULL, sum, x);
  if (lane == 0) o[0] = anchor + sum;
}

// The pair of a launch's warp: a the shorter side, swap when the read is
// the longer one.
struct Pair {
  const int8_t* a;
  const int8_t* b;
  int m, n;
  bool swap;
};

__device__ __forceinline__ Pair pair_of(const int8_t* rd,
                                        const int64_t* rd_off,
                                        const int8_t* tr,
                                        const int64_t* tr_off, int p) {
  Pair x{rd + rd_off[p], tr + tr_off[p], int(rd_off[p + 1] - rd_off[p]),
         int(tr_off[p + 1] - tr_off[p]), false};
  if (x.m > x.n) {
    const int8_t* y = x.a;
    x.a = x.b;
    x.b = y;
    const int k = x.m;
    x.m = x.n;
    x.n = k;
    x.swap = true;
  }
  return x;
}

// meta [P, 5] (int64): a pair's states in rec (uint4 index), its mask
// table in peq, its word scratch in gst (-1: registers), S (slots stored a
// column) and W (words a lane; negative: |W| in the global scratch).
// list [G]: the pairs of this launch, a warp each.
__global__ void __launch_bounds__(MAX_WARPS * 32)
edit_dp_kernel(const int8_t* rd, const int64_t* rd_off, const int8_t* tr,
               const int64_t* tr_off, const int32_t* list, int G,
               const int32_t* band, const int64_t* meta, uint4* rec,
               uint64_t* peq, uint64_t* gst, int64_t* out) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= G) return;
  const int p = list[g];
  const Pair x = pair_of(rd, rd_off, tr, tr_off, p);
  int64_t* o = out + int64_t(p) * 5;
  if (x.m == 0) {
    if (lane == 0) {
      o[0] = x.n;
      o[1] = 0;
      o[2] = 0;
      o[3] = x.swap ? x.n : 0;
      o[4] = x.swap ? 0 : x.n;
    }
    return;
  }
  const int64_t* mt = meta + int64_t(p) * 5;
  uint4* r = rec + mt[0];
  uint64_t* q = peq + mt[1];
  const int S = int(mt[3]), W = int(mt[4]), w = band[p];
  switch (W) {
#define EDIT_REGS(K)                                                    \
  case K: {                                                             \
    RegWords<K> ws;                                                     \
    dp_pair(ws, x.a, x.m, x.b, x.n, w, S, q, r, lane, o);               \
    break;                                                              \
  }
    EDIT_REGS(1)
    EDIT_REGS(2)
    EDIT_REGS(3)
    EDIT_REGS(4)
    EDIT_REGS(6)
#undef EDIT_REGS
    default: {
      GlobWords ws{gst + mt[2] + lane, -W};
      dp_pair(ws, x.a, x.m, x.b, x.n, w, S, q, r, lane, o);
    }
  }
}

// A walk's tile: lane x holds column j0 - x, row words q - 2 .. q (v[k]
// word q - 2 + k, bit k of ok set when the column stored it).
struct Tile {
  uint4 v[3];
  unsigned ok;
  int j0, q;
};

__device__ __forceinline__ void stage(Tile& t, const uint4* r, int S,
                                      int dw, int j0, int q, int lane) {
  t.j0 = j0;
  t.q = q;
  t.ok = 0;
  const int jl = j0 - lane;
  // a column past the first: no word stored
  const int wl = jl >= 1 ? wlo_of(jl, dw) : -(S + 3);
  const uint4* col = r + int64_t(max(jl, 1) - 1) * S;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int x = q - 2 + k - wl;
    const bool in = x >= 0 && x < S;
    t.v[k] = in ? col[x] : make_uint4(0, 0, 0, 0);
    t.ok |= unsigned(in) << k;
  }
}

// The walk of one pair from its DP's states; counts into o[1..4] (dist -1
// when it left the band).
__global__ void __launch_bounds__(MAX_WARPS * 32)
edit_walk_kernel(const int8_t* rd, const int64_t* rd_off, const int8_t* tr,
                 const int64_t* tr_off, const int32_t* list, int G,
                 const int32_t* band, const int64_t* meta, const uint4* rec,
                 int64_t* out) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= G) return;
  const int p = list[g];
  const Pair x = pair_of(rd, rd_off, tr, tr_off, p);
  int64_t* o = out + int64_t(p) * 5;
  const int w = band[p];
  // nothing to walk: an empty side (the DP wrote the row), or a pair the
  // wrapper runs again at twice the band
  if (x.m == 0 || (o[0] > w && w < x.m)) return;
  const int64_t* mt = meta + int64_t(p) * 5;
  const uint4* r = rec + mt[0];
  const int S = int(mt[3]);
  const int dw = x.n - x.m + w;
  int i = x.m, j = x.n;
  int matches = 0, sub = 0, ins = 0, del = 0;
  bool ok = true;
  // the tile in use and the next one (the 32 columns to its left, staged
  // when the walk enters this one, around the row it entered at)
  Tile cur, nxt;
  cur.j0 = nxt.j0 = -64;
  cur.q = nxt.q = 0;
  cur.ok = nxt.ok = 0;
  while (i > 0 && j > 0) {
    const int q = (i - 1) >> 6;
    int L = cur.j0 - j;
    if (L < 0 || L > 31 || q < cur.q - 2 || q > cur.q) {
      if (j <= nxt.j0 && j > nxt.j0 - 32 && q >= nxt.q - 2 && q <= nxt.q)
        cur = nxt;
      else
        stage(cur, r, S, dw, j, q, lane);
      L = cur.j0 - j;
      stage(nxt, r, S, dw, cur.j0 - 32, q, lane);
    }
    // down the diagonal: lane x >= L looks at (i - (x - L), j - (x - L));
    // st 3 a match, 1 a substitution, 2 up, 0 left, 4 not staged, 5
    // outside the column's stored window
    const int row = i - (lane - L);
    const int k = ((row - 1) >> 6) - cur.q + 2;
    const bool staged = lane >= L && row >= 1 && cur.j0 - lane >= 1
                        && k >= 0 && k <= 2;
    const uint4 v = k == 2 ? cur.v[2] : k == 1 ? cur.v[1] : cur.v[0];
    const int bit = (row - 1) & 31;
    const unsigned dg = (row - 1) & 32 ? v.y : v.x;
    const unsigned mk = (row - 1) & 32 ? v.w : v.z;
    const int st = !staged ? 4
        : !((cur.ok >> k) & 1u) ? 5
        : int((dg >> bit) & 1u) | int(((mk >> bit) & 1u) << 1);
    const unsigned stop = __ballot_sync(FULL, lane >= L && st != 3);
    const int f = stop ? __ffs(int(stop)) - 1 : 32;
    matches += f - L;
    i -= f - L;
    j -= f - L;
    if (f == 32 || i == 0 || j == 0) continue;
    const int s = __shfl_sync(FULL, st, f);
    if (s >= 4) {
      if (s == 5) {
        ok = false;
        break;
      }
      continue;                            // staged next round
    }
    sub += s == 1;
    ins += s == 2;
    del += s == 0;
    i -= s != 0;
    j -= s != 2;
  }
  ins += i;                                // column 0: up to row 0
  del += j;                                // row 0: left to column 0
  if (lane == 0) {
    if (!ok) o[0] = -1;
    o[1] = matches;
    o[2] = sub;
    o[3] = x.swap ? del : ins;
    o[4] = x.swap ? ins : del;
  }
}

}  // namespace

// rd/tr i8 flat (reads, truths), rd_off/tr_off i64 [P+1]; list i32 [G];
// band i32 [P]; meta i64 [P, 5] (see edit_dp_kernel); rec, peq, gst: the
// states, mask tables and word scratch the wrapper planned; warps: pairs a
// block; out i64 [P, 5] (the listed pairs' rows written). The DP kernel,
// then the walk kernel.
PT_EXPORT int pt_edit_alignments(const void* rd, const void* rd_off,
                                 const void* tr, const void* tr_off,
                                 const void* list, int G, const void* band,
                                 const void* meta, void* rec, void* peq,
                                 void* gst, int warps, void* out,
                                 void* stream) {
  if (G <= 0) return cudaSuccess;
  if (warps < 1 || warps > MAX_WARPS) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r8 = static_cast<const int8_t*>(rd);
  const auto* ro = static_cast<const int64_t*>(rd_off);
  const auto* t8 = static_cast<const int8_t*>(tr);
  const auto* to = static_cast<const int64_t*>(tr_off);
  const auto* ls = static_cast<const int32_t*>(list);
  const auto* bd = static_cast<const int32_t*>(band);
  const auto* mt = static_cast<const int64_t*>(meta);
  auto* o = static_cast<int64_t*>(out);
  const int blocks = (G + warps - 1) / warps;
  edit_dp_kernel<<<blocks, warps * 32, 0, s>>>(
      r8, ro, t8, to, ls, G, bd, mt, static_cast<uint4*>(rec),
      static_cast<uint64_t*>(peq), static_cast<uint64_t*>(gst), o);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  edit_walk_kernel<<<blocks, warps * 32, 0, s>>>(
      r8, ro, t8, to, ls, G, bd, mt, static_cast<const uint4*>(rec), o);
  return cudaGetLastError();
}
