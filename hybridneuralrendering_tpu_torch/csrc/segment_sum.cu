// Segment sum of id-sorted rows: the reduction of the point gather's backward.
//
// Replaces the Pallas TPU kernel tools/pallas_gather.py `banded_segment_sum`
// (body `_segsum_kernel`): given cotangent rows sg [M, C] f32 sorted by point
// id and the inclusive segment ends end_pos [n] i32 (end_pos[p] is the last
// sorted row whose id is <= p, -1 where there is none), it writes
// out[p] = sum of rows (end_pos[p-1], end_pos[p]] for every id p < n.  Ids
// with no rows get zeros; rows after end_pos[n-1] belong to no id.
//
// Bound on an H100: one pass, no arithmetic to speak of (one add per input
// element), so it is bound by memory.  It reads M*C*4 + n*4 bytes and writes
// n*C*4: at the training shape (M = 602,112, C = 64, n = 600,000) that is
// 154.1 MB + 2.4 MB read and 153.6 MB written, 0.093 ms at 3.35 TB/s.
//
// Design: one warp per output id reads its segment's rows in sorted order
// (at C = 64 every lane loads one float2 of a row: one coalesced read),
// accumulates in f32 registers and writes its row once.  The TPU kernel's
// 0/1 band matrices on the MXU are not needed here.  A segment's time grows
// with its length, so the gather backward keeps the empty neighbour slots
// (two thirds of a training step's rows) out of the sorted segments
// (models/neural_points.py); what is left averages about 9 rows an id.
// Inside a segment, four interleaved partial sums (row i = 4k + r into
// partial r, the last length % 4 rows into partial 0) are combined as
// (p0 + p1) + (p2 + p3).  No atomics, no zero-fill pass, and the order of
// every sum is fixed by the input alone, so the result is the same from
// launch to launch.  The kernel reads the permuted copy sg, as the TPU kernel
// does, not the unsorted cotangent through the permutation.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (hybridneuralrendering_tpu_torch/ops/build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;

__device__ __forceinline__ float vzero(float*) { return 0.f; }
__device__ __forceinline__ float2 vzero(float2*) {
  return make_float2(0.f, 0.f);
}
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float2 vadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// One warp per output id p: out[p] = the sum of its segment's rows.
template <typename V>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segment_sums(const V* __restrict__ sg, const int* __restrict__ end_pos,
             V* __restrict__ out, int n, int C2) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long p =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (p >= n) return;  // whole warps leave together
  const long long hi = (long long)end_pos[p] + 1;
  const long long lo = p == 0 ? 0 : (long long)end_pos[p - 1] + 1;
  for (int c = lane; c < C2; c += kWarp) {
    V acc[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) acc[r] = vzero((V*)nullptr);
    long long j = lo;
    for (; j + kUnroll <= hi; j += kUnroll) {
      V v[kUnroll];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) v[r] = sg[(j + r) * C2 + c];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) acc[r] = vadd(acc[r], v[r]);
    }
    for (; j < hi; ++j) acc[0] = vadd(acc[0], sg[j * C2 + c]);
    out[p * C2 + c] = vadd(vadd(acc[0], acc[1]), vadd(acc[2], acc[3]));
  }
}

template <typename V>
cudaError_t launch(const void* sg, const void* end_pos, void* out, int C2,
                   int n, cudaStream_t st) {
  segment_sums<V><<<(n + kWarpsPerBlock - 1) / kWarpsPerBlock,
                    kWarp * kWarpsPerBlock, 0, st>>>(
      static_cast<const V*>(sg), static_cast<const int*>(end_pos),
      static_cast<V*>(out), n, C2);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value: 0 on a successful launch.  The launch is
// asynchronous on `stream`.  end_pos must be non-decreasing with values in
// [-1, M - 1].  The wrapper (ops/segment_sum.py) checks shapes and types.
extern "C" int segment_sum_launch(const void* sg, const void* end_pos,
                                  void* out, long long M, int C, int n,
                                  void* stream) {
  if (M < 0 || C < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long ptrs = reinterpret_cast<unsigned long long>(sg) |
                                  reinterpret_cast<unsigned long long>(out);
  if (C % 2 == 0 && (ptrs & 7ull) == 0) {
    return (int)launch<float2>(sg, end_pos, out, C / 2, n, st);
  }
  return (int)launch<float>(sg, end_pos, out, C, n, st);
}
