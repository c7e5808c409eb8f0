// Pileup accumulation: per-candidate votes -> per-read pileup tensors
// pileup[read, w0 + col, lane] (f32, 64 vote lanes per column).
//
// Replaces the Pallas kernels of proovread_tpu/ops/pileup_kernel.py:
//
// - pileup_accumulate_bits (_accum_bits_kernel, row resident, and
//   _accum_bits_win_kernel, windowed): one block per candidate; a 64 x 4
//   thread block covers the 64 vote lanes of 4 window columns at a time,
//   and every set bit adds 1.0f with atomicAdd.
// - pileup_accumulate_packed (_accum_packed_kernel): one block per
//   candidate, one thread per window column; the thread decodes the packed
//   vote word (state, marker, insertion length, six inserted bases) and
//   adds 1.0f to each of its at most 9 lanes with atomicAdd.
//
//   Both add +1 to integer counts far below 2^24, so any order of the
//   atomics gives the same bits. Bound by bytes: 4-8 bytes read per window
//   column and one read-modify-write per vote into a buffer that is mostly
//   resident in the 50 MB L2 for the candidates of one read.
//
// - pileup_accumulate (_accum_kernel): dense f32 vote slabs, phred-weighted,
//   so the order of the adds is the result. The reference folds every cell
//   over the candidates in index order (a sequential grid). Here block
//   (r, t) takes run r of the candidates of one read (read_of is sorted)
//   and tile t of DENSE_TILE columns of that read's row, and walks the run
//   in order, skipping windows that miss the tile; thread (g, lane) owns
//   the tile's columns col % G == g in its lane, so each cell has one owner
//   that adds the candidates' votes one after another, with no atomics and
//   no barrier. Tiling the row matters: a chunk of sorted candidates may
//   hold only a few reads, each with a thousand candidates. Bound by
//   bytes: each candidate's n x 64 f32 slab is read once and its cells
//   read and written once; every block also reads its run's window starts.
//
// The TPU's bf16 128-lane buffer, VMEM budget and windowed fallback only
// laid data out on the TPU and are dropped.

#include "common.cuh"

namespace {

__global__ void pileup_bits_kernel(float* __restrict__ pile, int Lpile,
                                   const int32_t* __restrict__ bits0,
                                   const int32_t* __restrict__ bits1,
                                   const int32_t* __restrict__ read_of,
                                   const int32_t* __restrict__ w0, int n) {
  const int c = blockIdx.x;
  const int lane = threadIdx.x;                // vote lane 0..63
  const size_t base = (size_t(read_of[c]) * Lpile + w0[c]) * 64;
  const int32_t* plane = (lane < 32 ? bits0 : bits1) + size_t(c) * n;
  const int bit = lane & 31;
  for (int col = threadIdx.y; col < n; col += blockDim.y) {
    const uint32_t word = uint32_t(plane[col]);
    if ((word >> bit) & 1u) atomicAdd(pile + base + size_t(col) * 64 + lane, 1.0f);
  }
}

__global__ void pileup_packed_kernel(float* __restrict__ pile, int Lpile,
                                     const int32_t* __restrict__ words,
                                     const int32_t* __restrict__ read_of,
                                     const int32_t* __restrict__ w0, int n) {
  const int c = blockIdx.x;
  float* row = pile + (size_t(read_of[c]) * Lpile + w0[c]) * 64;
  for (int col = threadIdx.x; col < n; col += blockDim.x) {
    const uint32_t w = uint32_t(words[size_t(c) * n + col]);
    float* cell = row + size_t(col) * 64;
    const int st = w & 7u;                     // 0 none, else state + 1
    const int len = (w >> 4) & 7u;             // 0 none, else bucket + 1
    if (st > 0) {
      atomicAdd(cell + st - 1, 1.0f);
      if ((w >> 3) & 1u) atomicAdd(cell + 8 + st - 1, 1.0f);
    }
    if (len > 0) {                             // also rejects all-zero words
      atomicAdd(cell + 16 + len - 1, 1.0f);
      for (int k = 0; k < 6; ++k) {
        const int b = (w >> (7 + 3 * k)) & 7u;  // 5 = none
        if (b < 5) atomicAdd(cell + 24 + 5 * k + b, 1.0f);
      }
    }
  }
}

// columns of the read row one block of the dense kernel owns
constexpr int DENSE_TILE = 128;

__global__ void pileup_dense_kernel(float* __restrict__ pile, int Lpile,
                                    const float* __restrict__ votes,
                                    const int32_t* __restrict__ w0,
                                    const int32_t* __restrict__ read_of,
                                    const int32_t* __restrict__ runs, int n) {
  const int lo = runs[blockIdx.x];
  const int hi = runs[blockIdx.x + 1];
  const int t0 = blockIdx.y * DENSE_TILE;
  const int t1 = min(t0 + DENSE_TILE, Lpile);
  float* row = pile + size_t(read_of[lo]) * Lpile * 64;
  const int lane = threadIdx.x & 63;
  const int G = blockDim.x >> 6;               // column groups
  const int g = threadIdx.x >> 6;
  for (int c = lo; c < hi; ++c) {
    const int base = w0[c];
    const int c0 = max(base, t0);
    const int c1 = min(base + n, t1);
    if (c0 >= c1) continue;                    // window misses this tile
    const float* v = votes + size_t(c) * n * 64 + lane;
    // this thread's first column in [c0, c1): col % G == g
    int col = c0 + ((g - c0 % G) % G + G) % G;
    for (; col < c1; col += G) {
      float* cell = row + size_t(col) * 64 + lane;
      *cell = *cell + v[size_t(col - base) * 64];
    }
  }
}

}  // namespace

PT_EXPORT int pt_pileup_accumulate_bits(void* pile, int B, int Lpile,
                                        const void* bits0, const void* bits1,
                                        const void* read_of, const void* w0,
                                        int R, int n, void* stream) {
  (void)B;
  dim3 block(64, 4);
  pileup_bits_kernel<<<R, block, 0, cudaStream_t(stream)>>>(
      static_cast<float*>(pile), Lpile, static_cast<const int32_t*>(bits0),
      static_cast<const int32_t*>(bits1),
      static_cast<const int32_t*>(read_of), static_cast<const int32_t*>(w0),
      n);
  return int(cudaGetLastError());
}

PT_EXPORT int pt_pileup_accumulate_packed(void* pile, int Lpile,
                                          const void* words,
                                          const void* read_of,
                                          const void* w0, int R, int n,
                                          void* stream) {
  pileup_packed_kernel<<<R, 256, 0, cudaStream_t(stream)>>>(
      static_cast<float*>(pile), Lpile, static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(read_of), static_cast<const int32_t*>(w0),
      n);
  return int(cudaGetLastError());
}

PT_EXPORT int pt_pileup_accumulate(void* pile, int Lpile, const void* votes,
                                   const void* w0, const void* read_of,
                                   const void* runs, int n_runs, int n,
                                   void* stream) {
  const dim3 grid(n_runs, (Lpile + DENSE_TILE - 1) / DENSE_TILE);
  pileup_dense_kernel<<<grid, 512, 0, cudaStream_t(stream)>>>(
      static_cast<float*>(pile), Lpile, static_cast<const float*>(votes),
      static_cast<const int32_t*>(w0), static_cast<const int32_t*>(read_of),
      static_cast<const int32_t*>(runs), n);
  return int(cudaGetLastError());
}
