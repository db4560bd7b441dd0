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
// order.  Three paths:
//   int32, F == 1 (the main path's ranks): one pass with decoupled
//     look-back (Merrill & Garland 2016).  A block takes its tile from an
//     atomic ticket, so every tile it waits on belongs to a block that is
//     already running; it scans its tile, publishes the tile's aggregate in
//     the tile's 64-bit status word (flag and value in one store), looks
//     back over its predecessors 32 status words at a time until it meets
//     an inclusive prefix, publishes its own inclusive prefix and writes y.
//     x is read once and y written once.  The sums wrap as uint32, which is
//     associative, so the order in which the look-back meets its
//     predecessors changes no bit.  The wrapper's scratch holds the status
//     words and the ticket; the launch zeroes it on the stream first
//     (cudaMemsetAsync), so no call reads another's state.
//   float32, F == 1: reduce-then-scan in three launches, so that every sum
//     is taken in an order fixed by M alone: tile_sums_1d writes each
//     tile's total, scan_totals turns the totals into exclusive prefixes
//     in one block (chunks of 256 tiles with a carry), scan_tiles_1d
//     rescans each tile and adds its prefix.
//   F > 1 (float32 [602,112, 64] in the smoke; int32 too): the same three
//     launches over tiles of 256 rows x 32 columns (8 row groups of 32
//     rows, one thread per column of a group, a sequential sum over the
//     groups).
// An F == 1 tile is 8,192 elements: each warp owns 1,024 consecutive ones
// and loads them as 8 steps of 32 lanes x 16 bytes, neighbouring lanes on
// neighbouring addresses, and scans them warp-striped with shuffles
// (tile_scan).  No float atomics: the float32 result is the same from launch
// to launch, and ops/scan.tolerance states its error bound from these
// orders.  The wrapper (ops/scan.py) allocates y and the scratch.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (hybridneuralrendering_tpu_torch/ops/build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 8;                           // F == 1: vectors a thread
constexpr int kTile1 = kThreads * kVecs * 4;       // F == 1: per tile
constexpr int kWindow = 32;                        // look-back: words at once
constexpr int kCols = 32;                          // F > 1: per block
constexpr int kGroups = kThreads / kCols;          // F > 1: row groups
constexpr int kRowsPerGroup = 32;
constexpr int kTile2 = kGroups * kRowsPerGroup;    // F > 1: rows per tile

// status word of a look-back tile: flag in the high 32 bits, value below
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<unsigned int> { using type = uint4; };

__device__ __forceinline__ float4 make4(float a, float b, float c, float d) {
  return make_float4(a, b, c, d);
}
__device__ __forceinline__ uint4 make4(unsigned a, unsigned b, unsigned c,
                                       unsigned d) {
  return make_uint4(a, b, c, d);
}

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

// ---- F == 1: a tile is kTile1 consecutive elements.  Warp w owns elements
// [w, w + 1) * kVecs * 128 of the tile; in step k its lane l holds the
// 4-element vector k * 32 + l of that range.

__device__ __forceinline__ long long first_vector(long long tile) {
  return tile * (kTile1 / 4) + (long long)(threadIdx.x >> 5) * (kVecs * 32) +
         (threadIdx.x & 31);
}

// Loads and scans one tile.  On return v[k][j] holds the inclusive sum of
// the thread's vector of step k up to element j, base[k] the sum of the
// warp's elements before that vector, *warp_off the sum of the tile before
// this warp and *agg the tile's total.  `vec`: the whole tile lies in x and
// x is 16-byte aligned.  Every thread of the block calls it.  The order of
// each float32 sum (tests/test_torch_port_cached.py models it):
//   vector:  prefixes ((x0 + x1) + x2) + x3;
//   lanes:   a Kogge-Stone inclusive scan of the vector totals (5 levels),
//            made exclusive by one shuffle;
//   steps:   run_0 = 0, run_{k+1} = run_k + (total of step k),
//            base[k] = run_k + exclusive;
//   warps:   warp_off = ((0 + W_0) + W_1) + ... + W_{w-1}, agg the same
//            over all kWarps warp totals W.
template <typename T>
__device__ __forceinline__ void tile_scan(const T* __restrict__ x,
                                          long long M, long long tile,
                                          bool vec, T (&v)[kVecs][4],
                                          T (&base)[kVecs], T* warp_off,
                                          T* agg) {
  using V4 = typename Vec4<T>::type;
  __shared__ T s_tot[kWarps];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long v0 = first_vector(tile);
  if (vec) {
    const V4* x4 = reinterpret_cast<const V4*>(x);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const V4 q = x4[v0 + k * 32];
      v[k][0] = q.x;
      v[k][1] = q.y;
      v[k][2] = q.z;
      v[k][3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long e = (v0 + k * 32) * 4 + j;
        v[k][j] = e < M ? x[e] : T(0);
      }
    }
  }
  T run = T(0);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    v[k][1] = v[k][0] + v[k][1];
    v[k][2] = v[k][1] + v[k][2];
    v[k][3] = v[k][2] + v[k][3];
    const T incl = warp_inclusive(v[k][3], lane);
    T excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = T(0);
    base[k] = run + excl;
    run = run + __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) s_tot[w] = run;
  __syncthreads();
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    if (i == w) *warp_off = acc;
    acc = acc + s_tot[i];
  }
  *agg = acc;
}

// y = (off + base[k]) + v[k][j] for the tile's elements; off is the sum of
// everything before this warp's range.
template <typename T>
__device__ __forceinline__ void tile_store(T* __restrict__ y, long long M,
                                           long long tile, bool vec,
                                           const T (&v)[kVecs][4],
                                           const T (&base)[kVecs], T off) {
  using V4 = typename Vec4<T>::type;
  const long long v0 = first_vector(tile);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const T b = off + base[k];
    if (vec) {
      reinterpret_cast<V4*>(y)[v0 + k * 32] =
          make4(b + v[k][0], b + v[k][1], b + v[k][2], b + v[k][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long e = (v0 + k * 32) * 4 + j;
        if (e < M) y[e] = b + v[k][j];
      }
    }
  }
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// int32 (as uint32), F == 1: the whole scan in one pass.  status [nb] and
// *ticket are zero at launch.
__global__ void __launch_bounds__(kThreads)
scan_lookback(const unsigned* __restrict__ x, unsigned* __restrict__ y,
              unsigned long long* status, unsigned* ticket, long long M,
              bool vec) {
  __shared__ unsigned s_tile;
  __shared__ unsigned s_prefix;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const bool full = vec && (tile + 1) * kTile1 <= M;
  unsigned v[kVecs][4], base[kVecs], warp_off, agg;
  tile_scan(x, M, tile, full, v, base, &warp_off, &agg);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned prefix = 0;
    if (tile == 0) {
      if (lane == 0) store_status(status, kInclusive | agg);
    } else {
      if (lane == 0) store_status(status + tile, kAggregate | agg);
      // predecessors [end - kWindow, end), the nearest in lane 31; a word
      // before tile 0 reads as an inclusive prefix of 0
      for (long long end = tile;; end -= kWindow) {
        const long long j = end - kWindow + lane;
        unsigned long long s = j >= 0 ? load_status(status + j) : kInclusive;
        while (__any_sync(0xffffffffu, (s >> 32) == 0)) {
          if ((s >> 32) == 0) s = load_status(status + j);
        }
        const unsigned incl = __ballot_sync(0xffffffffu, (s >> 32) == 2);
        // the nearest inclusive prefix and the aggregates after it
        const int from = incl ? 31 - __clz(incl) : 0;
        unsigned val = lane >= from ? (unsigned)s : 0u;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          val += __shfl_xor_sync(0xffffffffu, val, d);
        }
        prefix += val;
        if (incl) break;
      }
      if (lane == 0) store_status(status + tile, kInclusive | (prefix + agg));
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  tile_store(y, M, tile, full, v, base, s_prefix + warp_off);
}

// float32, F == 1: the tile totals, then (after scan_totals) the tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_sums_1d(const T* __restrict__ x, T* __restrict__ part, long long M,
             bool vec) {
  const long long tile = blockIdx.x;
  T v[kVecs][4], base[kVecs], warp_off, agg;
  tile_scan(x, M, tile, vec && (tile + 1) * kTile1 <= M, v, base, &warp_off,
            &agg);
  if (threadIdx.x == 0) part[tile] = agg;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_tiles_1d(const T* __restrict__ x, const T* __restrict__ offs,
              T* __restrict__ y, long long M, bool vec) {
  const long long tile = blockIdx.x;
  const bool full = vec && (tile + 1) * kTile1 <= M;
  T v[kVecs][4], base[kVecs], warp_off, agg;
  tile_scan(x, M, tile, full, v, base, &warp_off, &agg);
  tile_store(y, M, tile, full, v, base, offs[tile] + warp_off);
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

// float32, F == 1: three launches in a fixed order.
cudaError_t run_1d(const float* x, float* y, float* part, long long M,
                   cudaStream_t st) {
  const long long nb = (M + kTile1 - 1) / kTile1;
  const bool vec = ((reinterpret_cast<unsigned long long>(x) |
                     reinterpret_cast<unsigned long long>(y)) & 15) == 0;
  cudaError_t err;
  tile_sums_1d<float><<<(unsigned)nb, kThreads, 0, st>>>(x, part, M, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_totals<float><<<1, kThreads, 0, st>>>(part, nb, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_tiles_1d<float><<<(unsigned)nb, kThreads, 0, st>>>(x, part, y, M,
                                                          vec);
  return cudaGetLastError();
}

// F > 1, either type.
template <typename T>
cudaError_t run_2d(const void* xv, void* yv, void* partv, long long M, int F,
                   cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  T* part = static_cast<T*>(partv);
  cudaError_t err;
  const long long nb = (M + kTile2 - 1) / kTile2;
  const dim3 grid((unsigned)nb, (unsigned)((F + kCols - 1) / kCols));
  tile_sums_2d<T><<<grid, kThreads, 0, st>>>(x, part, M, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_totals<T><<<(unsigned)F, kThreads, 0, st>>>(part, nb, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_tiles_2d<T><<<grid, kThreads, 0, st>>>(x, part, y, M, F);
  return cudaGetLastError();
}

// int32, F == 1: zero the status words and the ticket, then one pass.
cudaError_t run_lookback(const void* x, void* y, void* scratch, long long M,
                         cudaStream_t st) {
  const long long nb = (M + kTile1 - 1) / kTile1;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)(nb + 1) * 8, st);
  if (err != cudaSuccess) return err;
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  const bool vec = ((reinterpret_cast<unsigned long long>(x) |
                     reinterpret_cast<unsigned long long>(y)) & 15) == 0;
  scan_lookback<<<(unsigned)nb, kThreads, 0, st>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(y), status,
      reinterpret_cast<unsigned*>(status + nb), M, vec);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value: 0 when every launch was accepted.  The
// launches are asynchronous on `stream` of CUDA device `device` (made
// current for the call if it is not).  x and y are [M, F] row-major and
// do not overlap.  `scratch` holds, for int32 with F == 1, nb + 1 words of
// 8 bytes, 8-byte aligned (the status words and the ticket), nb =
// ceil(M / 8,192);
// otherwise nb * F elements of x's type, nb = ceil(M / tile) with tile =
// 8,192 for F == 1 and 256 for F > 1.  is_int selects int32 (else float32).
// The wrapper (ops/scan.py) checks shapes and types.
extern "C" int cumsum_rows_launch(const void* x, void* y, void* scratch,
                                  long long M, int F, int is_int,
                                  int device, void* stream) {
  if (M < 0 || F < 1 || F > 65535 * kCols) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const long long nb = (M + (F == 1 ? kTile1 : kTile2) - 1) /
                       (F == 1 ? kTile1 : kTile2);
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int prev;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F == 1) {
    err = is_int ? run_lookback(x, y, scratch, M, st)
                 : run_1d(static_cast<const float*>(x), static_cast<float*>(y),
                          static_cast<float*>(scratch), M, st);
  } else {
    err = is_int ? run_2d<unsigned int>(x, y, scratch, M, F, st)
                 : run_2d<float>(x, y, scratch, M, F, st);
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}
