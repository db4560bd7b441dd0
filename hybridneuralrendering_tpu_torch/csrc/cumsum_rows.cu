// Inclusive cumsum of the rows of x [M, F] along axis 0.
//
// Replaces the Pallas TPU kernel tools/pallas_scan.py `cumsum_rows` (body
// `_cumsum_kernel`): y[i, c] = x[0, c] + ... + x[i, c].  Two instantiations:
// float32 -> float32 (the TPU kernel's function) and int32 -> int32 (the
// ranks of 0/1 flags in the dedup gather and the voxel-grid build; summed
// as unsigned 32-bit, so it wraps as two's-complement int32 does and is
// exact for every sum below 2**31).
//
// Bound on an H100: one add per element, so it is bound by memory.  The
// function reads x once and writes y once: at [602,112, 64] float32 that is
// 2 * 154.1 MB, 0.092 ms at 3.35 TB/s; at the grid build's 16.2M int32
// flags 2 * 64.8 MB, 0.039 ms.
//
// Design: the TPU kernel walks 1,176 blocks in order and carries the running
// sum from one grid step to the next.  Blocks here run in parallel in no
// order, so the scan is reduce-then-scan in three launches:
//   1. tile_sums: each block sums one tile of rows per column;
//   2. scan_totals: one block per column turns the tile sums, in place, into
//      exclusive prefixes (a block-wide scan per chunk of 256 tiles, with a
//      carry from chunk to chunk);
//   3. scan_tiles: each block re-reads its tile, scans it and adds the
//      tile's prefix.
// x is read twice and y written once: 1.5x the bytes of the bound.  A tile is
// 4,096 consecutive elements for F == 1 (16 per thread, a warp-shuffle scan
// of the thread sums) and 256 rows x 32 columns otherwise (8 row groups of
// 32 rows, one thread per column of a group, a sequential sum over the
// groups).  No atomics: every sum is taken in an order fixed by M and F, so
// the result is the same from launch to launch.  The wrapper
// (ops/scan.py) allocates y and the [tiles, F] scratch and states the
// float32 error bound that follows from these orders (scan.tolerance).
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (hybridneuralrendering_tpu_torch/ops/build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                         // F == 1: per thread
constexpr int kTile1 = kThreads * kItems;          // F == 1: per tile
constexpr int kCols = 32;                          // F > 1: per block
constexpr int kGroups = kThreads / kCols;          // F > 1: row groups
constexpr int kRowsPerGroup = 32;
constexpr int kTile2 = kGroups * kRowsPerGroup;    // F > 1: rows per tile

template <typename T>
__device__ __forceinline__ T warp_inclusive(T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// The exclusive prefix of v over the block's threads in thread order, and
// the block's total in *total.  Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ T block_exclusive(T v, T* total) {
  __shared__ T s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const T incl = warp_inclusive(v, lane);
  T excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = T(0);
  if (lane == 31) s_warp[w] = incl;
  __syncthreads();
  if (w == 0) {
    T t = lane < kWarps ? s_warp[lane] : T(0);
    t = warp_inclusive(t, lane);
    if (lane < kWarps) s_warp[lane] = t;
  }
  __syncthreads();
  if (w > 0) excl = s_warp[w - 1] + excl;
  *total = s_warp[kWarps - 1];
  __syncthreads();
  return excl;
}

// ---- F == 1: a tile is kTile1 consecutive elements, kItems per thread.

template <typename T>
__device__ __forceinline__ T load1(const T* __restrict__ x, long long r,
                                   long long M) {
  return r < M ? x[r] : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_sums_1d(const T* __restrict__ x, T* __restrict__ part, long long M) {
  const long long base =
      (long long)blockIdx.x * kTile1 + (long long)threadIdx.x * kItems;
  T run = T(0);
#pragma unroll
  for (int j = 0; j < kItems; ++j) run += load1(x, base + j, M);
  T total;
  block_exclusive(run, &total);
  if (threadIdx.x == 0) part[blockIdx.x] = total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_tiles_1d(const T* __restrict__ x, const T* __restrict__ offs,
              T* __restrict__ y, long long M) {
  const long long base =
      (long long)blockIdx.x * kTile1 + (long long)threadIdx.x * kItems;
  T v[kItems];
  T run = T(0);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    run += load1(x, base + j, M);
    v[j] = run;
  }
  T total;
  const T off = offs[blockIdx.x] + block_exclusive(run, &total);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (base + j < M) y[base + j] = off + v[j];
  }
}

// ---- F > 1: a tile is kTile2 rows of kCols columns; thread (g, lane) owns
// column blockIdx.y * kCols + lane in rows g * kRowsPerGroup + [0, 32).

template <typename T>
__device__ __forceinline__ T load2(const T* __restrict__ x, long long r,
                                   int c, long long M, int F) {
  return (r < M && c < F) ? x[r * F + c] : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_sums_2d(const T* __restrict__ x, T* __restrict__ part, long long M,
             int F) {
  __shared__ T s[kGroups][kCols];
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int c = blockIdx.y * kCols + lane;
  const long long r0 = (long long)blockIdx.x * kTile2 + g * kRowsPerGroup;
  T run = T(0);
#pragma unroll 8
  for (int j = 0; j < kRowsPerGroup; ++j) run += load2(x, r0 + j, c, M, F);
  s[g][lane] = run;
  __syncthreads();
  if (g == 0 && c < F) {
    T t = s[0][lane];
#pragma unroll
    for (int k = 1; k < kGroups; ++k) t += s[k][lane];
    part[(long long)blockIdx.x * F + c] = t;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_tiles_2d(const T* __restrict__ x, const T* __restrict__ offs,
              T* __restrict__ y, long long M, int F) {
  __shared__ T s[kGroups][kCols];
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int c = blockIdx.y * kCols + lane;
  const long long r0 = (long long)blockIdx.x * kTile2 + g * kRowsPerGroup;
  T v[kRowsPerGroup];
  T run = T(0);
#pragma unroll
  for (int j = 0; j < kRowsPerGroup; ++j) {
    run += load2(x, r0 + j, c, M, F);
    v[j] = run;
  }
  s[g][lane] = run;
  __syncthreads();
  if (c >= F) return;  // after the only barrier
  T goff = T(0);
  for (int k = 0; k < g; ++k) goff += s[k][lane];
  const T off = offs[(long long)blockIdx.x * F + c] + goff;
#pragma unroll
  for (int j = 0; j < kRowsPerGroup; ++j) {
    if (r0 + j < M) y[(r0 + j) * F + c] = off + v[j];
  }
}

// ---- both layouts: part [nb, F] tile sums -> exclusive prefixes, in place;
// block c scans column c.

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_totals(T* __restrict__ part, long long nb, int F) {
  const int c = blockIdx.x;
  T carry = T(0);
  for (long long t0 = 0; t0 < nb; t0 += kThreads) {
    const long long t = t0 + threadIdx.x;
    const T v = t < nb ? part[t * F + c] : T(0);
    T total;
    const T excl = block_exclusive(v, &total);
    if (t < nb) part[t * F + c] = carry + excl;
    carry += total;
  }
}

template <typename T>
cudaError_t run(const void* xv, void* yv, void* partv, long long M, int F,
                cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  T* part = static_cast<T*>(partv);
  cudaError_t err;
  if (F == 1) {
    const long long nb = (M + kTile1 - 1) / kTile1;
    tile_sums_1d<T><<<(unsigned)nb, kThreads, 0, st>>>(x, part, M);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scan_totals<T><<<1, kThreads, 0, st>>>(part, nb, 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scan_tiles_1d<T><<<(unsigned)nb, kThreads, 0, st>>>(x, part, y, M);
    return cudaGetLastError();
  }
  const long long nb = (M + kTile2 - 1) / kTile2;
  const dim3 grid((unsigned)nb, (unsigned)((F + kCols - 1) / kCols));
  tile_sums_2d<T><<<grid, kThreads, 0, st>>>(x, part, M, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_totals<T><<<(unsigned)F, kThreads, 0, st>>>(part, nb, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_tiles_2d<T><<<grid, kThreads, 0, st>>>(x, part, y, M, F);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value: 0 when all three launches were accepted.  The
// launches are asynchronous on `stream`.  x and y are [M, F] row-major and
// do not overlap; part holds ceil(M / tile) * F elements of x's type, with
// tile = 4,096 for F == 1 and 256 otherwise.  is_int selects int32 (else
// float32).  The wrapper (ops/scan.py) checks shapes and types.
extern "C" int cumsum_rows_launch(const void* x, void* y, void* part,
                                  long long M, int F, int is_int,
                                  void* stream) {
  if (M < 0 || F < 1 || F > 65535 * kCols) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const long long nb = (M + (F == 1 ? kTile1 : kTile2) - 1) /
                       (F == 1 ? kTile1 : kTile2);
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_int ? (int)run<unsigned int>(x, y, part, M, F, st)
                : (int)run<float>(x, y, part, M, F, st);
}
