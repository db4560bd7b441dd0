// K smallest entries of each row of a candidate-distance matrix, ascending.
//
// Replaces the Pallas TPU kernel hybridneuralrendering_tpu/ops/pallas_select.py
// `k_smallest` (body `_select_kernel`): for each of S rows of d [S, C] f32 with
// ids [S, C] i32 it returns the K smallest distances in ascending order and
// their ids.  Ties go to the lowest column.  A selected entry is overwritten
// with BIG = 1e30, so a row with fewer than K entries below BIG repeats its
// first BIG column, exactly as the TPU kernel and its XLA twin do.
//
// Bound on an H100: the work is K rounds of a min over C values per row, a few
// operations per byte, so it is bound by memory.  It reads S*C*8 bytes and
// writes S*K*8 bytes: at S = 393,216, C = 32, K = 8 that is 126 MB, 38 us at
// 3.35 TB/s.
//
// Design: one warp per row.  Lane l holds columns l, l+32, l+64, ... in
// registers (NPER of them, the row read once with neighbouring lanes on
// neighbouring addresses).  Each of the K rounds is a local min over the
// lane's registers and a warp argmin over (d, col) with __shfl_xor_sync, in
// which a tie goes to the lower column.  The TPU kernel tiled 256 rows into
// VMEM and re-read them K times there; here the row never leaves registers.
//
// Built by nvcc into a shared library with a plain C interface and loaded with
// ctypes (hybridneuralrendering_tpu_torch/ops/build.py).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ bool less_pair(float da, int ca, float db, int cb) {
  return da < db || (da == db && ca < cb);
}

template <int NPER>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
k_smallest_kernel(const float* __restrict__ d, const int* __restrict__ ids,
                  float* __restrict__ out_d, int* __restrict__ out_i,
                  int S, int C, int K) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x / kWarp);
  if (row >= S) return;  // whole warps leave together
  const float* drow = d + row * C;
  const int* irow = ids + row * C;

  float v[NPER];
  int id[NPER];
#pragma unroll
  for (int j = 0; j < NPER; ++j) {
    const int col = lane + j * kWarp;
    // columns past C never win: +inf is above every real entry, BIG included
    v[j] = col < C ? drow[col] : CUDART_INF_F;
    id[j] = col < C ? irow[col] : -1;
  }

  for (int k = 0; k < K; ++k) {
    // local min over this lane's columns; j ascending keeps the lowest column
    float bd = v[0];
    int bc = lane;
#pragma unroll
    for (int j = 1; j < NPER; ++j) {
      if (v[j] < bd) {
        bd = v[j];
        bc = lane + j * kWarp;
      }
    }
    // warp argmin over (d, col)
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
      if (less_pair(od, oc, bd, bc)) {
        bd = od;
        bc = oc;
      }
    }
    // the owning lane writes the result and retires the entry
    if ((bc & (kWarp - 1)) == lane) {
      const int jj = bc / kWarp;
#pragma unroll
      for (int j = 0; j < NPER; ++j) {
        if (j == jj) {
          out_d[row * K + k] = bd;
          out_i[row * K + k] = id[j];
          v[j] = kBig;
        }
      }
    }
  }
}

template <int NPER>
cudaError_t launch(const float* d, const int* ids, float* out_d, int* out_i,
                   int S, int C, int K, cudaStream_t stream) {
  const int blocks = (S + kRowsPerBlock - 1) / kRowsPerBlock;
  k_smallest_kernel<NPER><<<blocks, kWarp * kRowsPerBlock, 0, stream>>>(
      d, ids, out_d, out_i, S, C, K);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value: 0 on a successful launch.  The launch is
// asynchronous on `stream`.  C must lie in [1, 1024] and K be at least 1.
extern "C" int k_smallest_launch(const void* d, const void* ids, void* out_d,
                                 void* out_i, int S, int C, int K,
                                 void* stream) {
  if (S < 0 || C < 1 || C > 32 * kWarp || K < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (S == 0) return 0;
  const float* dp = static_cast<const float*>(d);
  const int* ip = static_cast<const int*>(ids);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nper = (C + kWarp - 1) / kWarp;
  cudaError_t err;
  if (nper <= 1) err = launch<1>(dp, ip, od, oi, S, C, K, st);
  else if (nper <= 2) err = launch<2>(dp, ip, od, oi, S, C, K, st);
  else if (nper <= 4) err = launch<4>(dp, ip, od, oi, S, C, K, st);
  else if (nper <= 8) err = launch<8>(dp, ip, od, oi, S, C, K, st);
  else if (nper <= 16) err = launch<16>(dp, ip, od, oi, S, C, K, st);
  else err = launch<32>(dp, ip, od, oi, S, C, K, st);
  return (int)err;
}
