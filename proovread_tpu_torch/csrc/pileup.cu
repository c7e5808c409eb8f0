// Pileup accumulation: per-candidate vote bit planes -> per-read counts.
//
// Replaces the Pallas kernel proovread_tpu/ops/pileup_kernel.py:
// pileup_accumulate_bits (_accum_bits_kernel, row resident, and
// _accum_bits_win_kernel, windowed). One block per candidate; a 64 x 4
// thread block covers the 64 vote lanes of 4 window columns at a time, and
// every set bit adds 1.0f to pileup[read, w0 + col, lane] with atomicAdd.
// Each add is +1 to an integer count far below 2^24, so any order of the
// atomics gives the same bits.
//
// What bounds it: bytes. It reads 2 x 4 bytes per window column and does
// one read-modify-write per set bit (a few per column) into a buffer that
// is mostly resident in the 50 MB L2 for the candidates of one read. The
// TPU's bf16 128-lane buffer, VMEM budget and windowed fallback only laid
// data out on the TPU and are dropped.

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
