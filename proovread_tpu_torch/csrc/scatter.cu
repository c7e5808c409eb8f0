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
// The wrapper (ops/scatter.py) keys every entry by its cell as int32, a
// dropped or out-of-range entry by n (the target's size), and stable-sorts
// all M entries once (torch.sort): each cell's entries form one segment of
// the sorted keys, in increasing k, and the dropped ones sort to the end.
// There is no host sync: M comes from the shape.
//
// Here one thread takes one sorted position; a thread that starts a
// segment (a key below n that differs from the one before) loads its cell
// once, adds the segment's weights in order in a register, and stores the
// sum once. No atomics, no two threads on one cell.
//
// Why one thread a segment: on the main path a segment is a column's few
// votes. On a real ccs-1 chunk a touched cell has 3.3 kept entries on
// average and 14 at most (`counts`; 1.8 and 11 on the insertion scatters),
// on a real utg chunk 1.2 and 4, so a thread's loop is a few dependent
// loads and short segments need no cooperation. A warp-wide fold (32
// sorted entries a step, segments carried across windows) lost to this
// body on 7 of those chunks' 8 scatters (tools/kernel_probe.py); it won
// only on segments of hundreds or thousands of entries, which no path of
// the program makes. There a thread walks its segment alone, one
// dependent load a step, and a warp waits for its longest segment. Each
// kept entry's key, permutation entry and weight are read once, each
// touched cell read and written once.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
scatter_ordered_kernel(float* __restrict__ target,
                       const int32_t* __restrict__ keys,
                       const int64_t* __restrict__ order,
                       const float* __restrict__ w, int M, int n) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= M) return;
  const int cell = keys[s];
  // a dropped entry, or inside another thread's segment
  if (cell >= n || (s > 0 && keys[s - 1] == cell)) return;
  float acc = target[cell];
  for (int t = s; t < M && keys[t] == cell; ++t) acc += w[order[t]];
  target[cell] = acc;
}

}  // namespace

// target: f32 [n]; keys: i32 [M] every entry's cell (n where dropped),
// sorted, stable in k; order: i64 [M] the entry k of each sorted position;
// w: f32 [M]. n < 2^31.
PT_EXPORT int pt_scatter_add_ordered(void* target, const void* keys,
                                     const void* order, const void* w, int M,
                                     int n, void* stream) {
  if (M <= 0) return cudaSuccess;
  const int blocks = (M + THREADS - 1) / THREADS;
  auto s = static_cast<cudaStream_t>(stream);
  scatter_ordered_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<float*>(target), static_cast<const int32_t*>(keys),
      static_cast<const int64_t*>(order), static_cast<const float*>(w), M, n);
  return cudaGetLastError();
}
