// Ordered f32 scatter-add: target[idx[k]] += w[k] for every kept k, each
// target cell's contributions added one at a time in increasing k.
//
// Replaces the XLA scatters of proovread_tpu/ops/pileup.py:accumulate and
// proovread_tpu/ops/fused.py:fused_accumulate (`.at[idx].add(w)`, no Pallas
// kernel). XLA's CPU scatter adds in update order, so a cell's f32 sum is
// ((t + w_k0) + w_k1) + ... for its entries k0 < k1 < ... The votes of the
// qual-weighted passes (ccs-1, utg) are fractional, so any other order can
// change a sum's last bits, and with it a consensus phred or a near-tie
// base call. Atomic adds (index_add_ on the card) give no order at all.
//
// The wrapper (ops/scatter.py) compacts the kept, in-range entries and
// stable-sorts them by cell (torch.sort), so each cell's entries form one
// segment of the sorted keys, in increasing k. Here one thread takes one
// sorted position; a thread that starts a segment (keys[s] != keys[s-1])
// loads its cell once, adds the segment's weights in order in a register,
// and stores the sum once. No atomics, no two threads on one cell.
//
// What bounds it: bytes. Each kept entry's key (8), permutation entry (8)
// and weight (4) are read once, each touched cell read and written once.
// Segments are a column's coverage, a few to a few hundred votes; a warp
// waits for the longest segment that starts in it, and the weight reads
// through the permutation are scattered.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
scatter_ordered_kernel(float* __restrict__ target,
                       const int64_t* __restrict__ keys,
                       const int64_t* __restrict__ order,
                       const float* __restrict__ w, int M) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= M) return;
  const int64_t cell = keys[s];
  if (s > 0 && keys[s - 1] == cell) return;  // inside another's segment
  float acc = target[cell];
  for (int t = s; t < M && keys[t] == cell; ++t) acc += w[order[t]];
  target[cell] = acc;
}

}  // namespace

// target: f32 [N]; keys: i64 [M] kept cells, sorted, stable in k; order:
// i64 [M] the entry k of each sorted position; w: f32 [>= max(order) + 1].
PT_EXPORT int pt_scatter_add_ordered(void* target, const void* keys,
                                     const void* order, const void* w, int M,
                                     void* stream) {
  if (M <= 0) return cudaSuccess;
  const int blocks = (M + THREADS - 1) / THREADS;
  auto s = static_cast<cudaStream_t>(stream);
  scatter_ordered_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<float*>(target), static_cast<const int64_t*>(keys),
      static_cast<const int64_t*>(order), static_cast<const float*>(w), M);
  return cudaGetLastError();
}
