// Pileup accumulation: per-candidate votes -> per-read pileup tensors
// pileup[read, w0 + col, lane] (f32, 64 vote lanes per column).
//
// Replaces the Pallas kernels of proovread_tpu/ops/pileup_kernel.py:
//
// - pileup_accumulate_bits (_accum_bits_kernel, row resident, and
//   _accum_bits_win_kernel, windowed) and pileup_accumulate_packed
//   (_accum_packed_kernel): one kernel body, pileup_col_kernel, templated
//   on how a window column's votes are read: two plane words (BitPlanes) or
//   one packed vote word (PackedWords), either way turned into two 32-lane
//   masks. One thread per (candidate, window column): it loads the
//   column's words (4 or 8 bytes, coalesced across the warp), leaves a
//   column with no votes at once (an all-zero packed word, or a dead
//   candidate's zeroed row, costs one load), and walks the set lanes with
//   __ffs: at most 9 a column (state, marker, length, six inserted bases),
//   each one atomicAdd(+1.0f). The same launch checks every candidate's
//   read_of and w0 into one flag word (the wrapper's only host sync); a
//   candidate that fails writes nothing. Bound by bytes: the words are
//   read once, and each touched cell is one read-modify-write in L2.
//   These add +1 to integer counts far below 2^24, so any order of the
//   adds gives the same bits.
//
// - pileup_accumulate (_accum_kernel): dense f32 vote slabs, phred-weighted,
//   so the order of the adds is the result. The reference folds every cell
//   over the candidates in index order (a sequential grid). Here a work list
//   gives each (read, tile of DENSE_TILE columns) its candidates in order:
//   pileup_keys_kernel writes one key read * n_tiles + tile per (candidate,
//   tile its window overlaps), 2-3 a candidate, and checks the metadata in
//   the same pass (one flag word, the wrapper's only host sync); the
//   wrapper sorts the keys stably, so the entries of one (read, tile) item
//   keep candidate order. The block of a sorted entry that starts an item
//   (the others exit at once, so no host sync counts the items) counts the
//   item's entries with one block-wide vote and holds the tile's cells in
//   registers: thread (g, lane) owns columns g, g + 8, ... of its lane,
//   loads them once, adds the item's candidates one after another (the
//   next candidate's votes are loaded while the current one's are added)
//   and stores them once. Each cell has one owner that adds its votes in
//   candidate order, so the sums are the reference's, with no atomics and
//   no barrier in the fold. Bound by bytes: each slab is read once
//   (256-byte rows, coalesced), and each cell inside the item's windows is
//   read and written once.
//
// The TPU's bf16 128-lane buffer, VMEM budget and windowed fallback only
// laid data out on the TPU and are dropped.

#include "common.cuh"

namespace {

// 1 read_of outside [0, B), 2 w0 outside [0, Lpile - n]
__device__ __forceinline__ int meta_flags(int read, int b, int B, int Lpile,
                                          int n) {
  return (read < 0 || read >= B ? 1 : 0) | (b < 0 || b > Lpile - n ? 2 : 0);
}

constexpr int COL_THREADS = 256;

// How pileup_col_kernel reads window column i (flat index candidate * n +
// column): its votes as lane masks v0 (lanes 0-31) and v1 (lanes 32-63).
struct BitPlanes {
  const int32_t* bits0;
  const int32_t* bits1;
  __device__ __forceinline__ void operator()(size_t i, uint32_t& v0,
                                             uint32_t& v1) const {
    v0 = uint32_t(bits0[i]);
    v1 = uint32_t(bits1[i]);
  }
};

// ops/votes.py's packed word: state field st in bits 0-2 (0 none, else
// state + 1) with a marker bit 3; length field len in bits 4-6 (0 none,
// else bucket + 1); six 3-bit inserted bases from bit 7 (5 = none). Lanes:
// st-1, 8+st-1 with the marker, 16+len-1, and 24+5k+b for each inserted
// base b < 5; the inserted bases vote only with a length (so an all-zero
// word votes nothing).
struct PackedWords {
  const int32_t* words;
  __device__ __forceinline__ void operator()(size_t i, uint32_t& v0,
                                             uint32_t& v1) const {
    const uint32_t w = uint32_t(words[i]);
    const uint32_t st = w & 7u, len = (w >> 4) & 7u;
    uint64_t m = 0;
    if (st) m = (1ull << (st - 1)) | (uint64_t((w >> 3) & 1u) << (st + 7));
    if (len) {
      m |= 1ull << (15 + len);
      for (int k = 0; k < 6; ++k) {
        const uint32_t b = (w >> (7 + 3 * k)) & 7u;
        if (b < 5) m |= 1ull << (24 + 5 * k + b);
      }
    }
    v0 = uint32_t(m);
    v1 = uint32_t(m >> 32);
  }
};

template <typename Decode>
__global__ void __launch_bounds__(COL_THREADS)
pileup_col_kernel(float* __restrict__ pile, int B, int Lpile, Decode decode,
                  const int32_t* __restrict__ read_of,
                  const int32_t* __restrict__ w0, int R, int n,
                  int32_t* __restrict__ bad) {
  const size_t i = size_t(blockIdx.x) * COL_THREADS + threadIdx.x;
  if (i < size_t(R)) {                         // candidate i's metadata
    const int flags = meta_flags(read_of[i], w0[i], B, Lpile, n);
    if (flags) atomicOr(bad, flags);
  }
  if (i >= size_t(R) * n) return;
  uint32_t v0, v1;
  decode(i, v0, v1);
  if ((v0 | v1) == 0u) return;
  const int c = int(i / size_t(n));
  const int read = read_of[c], b = w0[c];
  if (meta_flags(read, b, B, Lpile, n)) return;
  float* cell = pile + (size_t(read) * Lpile + b + int(i - size_t(c) * n)) * 64;
  for (; v0; v0 &= v0 - 1u) atomicAdd(cell + __ffs(int(v0)) - 1, 1.0f);
  for (; v1; v1 &= v1 - 1u) atomicAdd(cell + 31 + __ffs(int(v1)), 1.0f);
}

// the flag word cleared, then one thread per window column (a thread per
// candidate where n is 0, for the checks)
template <typename Decode>
int launch_cols(Decode decode, void* pile, int B, int Lpile,
                const void* read_of, const void* w0, int R, int n, void* bad,
                void* stream) {
  cudaError_t err = cudaMemsetAsync(bad, 0, sizeof(int32_t),
                                    cudaStream_t(stream));
  const size_t threads = size_t(R) * (n > 1 ? n : 1);
  if (err != cudaSuccess || threads == 0) return int(err);
  const unsigned grid = unsigned((threads + COL_THREADS - 1) / COL_THREADS);
  pileup_col_kernel<Decode><<<grid, COL_THREADS, 0, cudaStream_t(stream)>>>(
      static_cast<float*>(pile), B, Lpile, decode,
      static_cast<const int32_t*>(read_of), static_cast<const int32_t*>(w0),
      R, n, static_cast<int32_t*>(bad));
  return int(cudaGetLastError());
}

// columns of a read row that one block of the ordered kernel holds
constexpr int DENSE_TILE = 128;
constexpr int DENSE_THREADS = 512;
constexpr int DENSE_GROUPS = DENSE_THREADS / 64;               // 8
constexpr int DENSE_CELLS = DENSE_TILE / DENSE_GROUPS;         // 16 a thread

__device__ __forceinline__ void load_votes(float (&v)[DENSE_CELLS],
                                           const float* __restrict__ votes,
                                           int c, int base, int n, int col0,
                                           int lane) {
  const float* slab = votes + size_t(c) * n * 64 + lane;
#pragma unroll
  for (int j = 0; j < DENSE_CELLS; ++j) {
    const int k = col0 + DENSE_GROUPS * j - base;              // slab row
    v[j] = (k >= 0 && k < n) ? slab[size_t(k) * 64] : 0.f;
  }
}

// work-list keys: entry c * K + k is the k-th tile of candidate c's
// window, keyed read * n_tiles + tile, or INT32_MAX past its last tile (so
// the sort puts it after every item). It also checks the metadata the
// ordered kernel dereferences and ors into *bad: 1 read_of outside [0, B),
// 2 w0 outside [0, Lpile - n], 4 read_of not ascending.
__global__ void pileup_keys_kernel(int32_t* __restrict__ keys,
                                   int32_t* __restrict__ bad,
                                   const int32_t* __restrict__ read_of,
                                   const int32_t* __restrict__ w0, int R,
                                   int K, int n, int n_tiles, int B,
                                   int Lpile) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= R * K) return;
  const int c = e / K;
  const int read = read_of[c], b = w0[c];
  if (e % K == 0) {
    const int flags = meta_flags(read, b, B, Lpile, n) |
                      (c > 0 && read_of[c - 1] > read ? 4 : 0);
    if (flags) atomicOr(bad, flags);
  }
  const int tile = b / DENSE_TILE + e % K;
  keys[e] = tile <= (b + n - 1) / DENSE_TILE ? read * n_tiles + tile
                                             : INT32_MAX;
}

__global__ void __launch_bounds__(DENSE_THREADS)
pileup_ordered_kernel(float* __restrict__ pile, int Lpile, int n_tiles,
                      const float* __restrict__ votes,
                      const int32_t* __restrict__ w0,
                      const int32_t* __restrict__ keys,
                      const int64_t* __restrict__ order, int E, int K,
                      int n) {
  const int lo = blockIdx.x;
  const int key = keys[lo];
  if (key == INT32_MAX || (lo > 0 && keys[lo - 1] == key)) return;
  // the item ends at the first larger key: count the equal keys after lo,
  // DENSE_THREADS at a time (they are contiguous)
  int hi = lo + 1;
  for (;;) {
    const int e = hi + threadIdx.x;
    const int same = __syncthreads_count(e < E && keys[e] == key);
    hi += same;
    if (same < DENSE_THREADS) break;
  }
  const int t0 = (key % n_tiles) * DENSE_TILE;
  const int lane = threadIdx.x & 63;
  const int col0 = t0 + (threadIdx.x >> 6);    // this thread's first column
  // the columns of the tile that the item's windows cover: only those are
  // loaded and stored
  int c_lo = t0 + DENSE_TILE, c_hi = t0;
  for (int e = lo; e < hi; ++e) {
    const int b = w0[int(order[e] / K)];
    c_lo = min(c_lo, max(b, t0));
    c_hi = max(c_hi, min(b + n, t0 + DENSE_TILE));
  }
  float* row = pile + size_t(key / n_tiles) * Lpile * 64 + lane;
  float acc[DENSE_CELLS];
#pragma unroll
  for (int j = 0; j < DENSE_CELLS; ++j) {
    const int col = col0 + DENSE_GROUPS * j;
    acc[j] = (col >= c_lo && col < c_hi) ? row[size_t(col) * 64] : 0.f;
  }
  int base = w0[int(order[lo] / K)];
  float cur[DENSE_CELLS];
  load_votes(cur, votes, int(order[lo] / K), base, n, col0, lane);
  for (int e = lo; e < hi; ++e) {
    int base_next = 0;
    float nxt[DENSE_CELLS];
    if (e + 1 < hi) {
      const int c_next = int(order[e + 1] / K);
      base_next = w0[c_next];
      load_votes(nxt, votes, c_next, base_next, n, col0, lane);
    } else {
#pragma unroll
      for (int j = 0; j < DENSE_CELLS; ++j) nxt[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < DENSE_CELLS; ++j) {
      const int k = col0 + DENSE_GROUPS * j - base;
      if (k >= 0 && k < n) acc[j] = acc[j] + cur[j];
      cur[j] = nxt[j];
    }
    base = base_next;
  }
#pragma unroll
  for (int j = 0; j < DENSE_CELLS; ++j) {
    const int col = col0 + DENSE_GROUPS * j;
    if (col >= c_lo && col < c_hi) row[size_t(col) * 64] = acc[j];
  }
}

}  // namespace

PT_EXPORT int pt_pileup_accumulate_bits(void* pile, int B, int Lpile,
                                        const void* bits0, const void* bits1,
                                        const void* read_of, const void* w0,
                                        int R, int n, void* bad,
                                        void* stream) {
  return launch_cols(BitPlanes{static_cast<const int32_t*>(bits0),
                               static_cast<const int32_t*>(bits1)},
                     pile, B, Lpile, read_of, w0, R, n, bad, stream);
}

PT_EXPORT int pt_pileup_accumulate_packed(void* pile, int B, int Lpile,
                                          const void* words,
                                          const void* read_of,
                                          const void* w0, int R, int n,
                                          void* bad, void* stream) {
  return launch_cols(PackedWords{static_cast<const int32_t*>(words)}, pile,
                     B, Lpile, read_of, w0, R, n, bad, stream);
}

PT_EXPORT int pt_pileup_work_keys(void* keys, void* bad, const void* read_of,
                                  const void* w0, int R, int K, int n,
                                  int n_tiles, int B, int Lpile,
                                  void* stream) {
  cudaError_t err = cudaMemsetAsync(bad, 0, sizeof(int32_t),
                                    cudaStream_t(stream));
  const int E = R * K;
  if (err != cudaSuccess || E <= 0) return int(err);
  pileup_keys_kernel<<<(E + 255) / 256, 256, 0, cudaStream_t(stream)>>>(
      static_cast<int32_t*>(keys), static_cast<int32_t*>(bad),
      static_cast<const int32_t*>(read_of), static_cast<const int32_t*>(w0),
      R, K, n, n_tiles, B, Lpile);
  return int(cudaGetLastError());
}

PT_EXPORT int pt_pileup_accumulate(void* pile, int Lpile, int n_tiles,
                                   const void* votes, const void* w0,
                                   const void* keys, const void* order,
                                   int E, int K, int n, void* stream) {
  if (E <= 0) return int(cudaSuccess);
  pileup_ordered_kernel<<<E, DENSE_THREADS, 0, cudaStream_t(stream)>>>(
      static_cast<float*>(pile), Lpile, n_tiles,
      static_cast<const float*>(votes), static_cast<const int32_t*>(w0),
      static_cast<const int32_t*>(keys), static_cast<const int64_t*>(order),
      E, K, n);
  return int(cudaGetLastError());
}
