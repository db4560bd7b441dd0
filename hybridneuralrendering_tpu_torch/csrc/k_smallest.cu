// K smallest entries of each row of a candidate-distance matrix, ascending.
//
// Replaces the Pallas TPU kernel hybridneuralrendering_tpu/ops/pallas_select.py
// `k_smallest` (body `_select_kernel`): for each of S rows of d [S, C] f32 with
// ids [S, C] i32 it returns the K smallest distances in ascending order and
// their ids.  Ties go to the lowest column.  A selected entry is overwritten
// with BIG = 1e30, so a row with fewer than K entries below BIG goes on with
// the lowest column whose value is then <= BIG, exactly as the TPU kernel's
// XLA twin and the port's plain version (ops/select.py) do.  NaN is outside
// the contract: no column reaches a NaN minimum, and the plain version fails
// to index one (it raises on the CPU).  -0.0 ties with +0.0; the value
// written is the entry's own.
//
// Bound on an H100: the selection does no arithmetic, so the least work is
// moving the bytes.  It reads S*C*8 bytes and writes S*K*8: at a serving chunk
// (S = 393,216, C = 32, K = 8) 126 MB, 37.6 us at 3.35 TB/s.
//
// The first port gave each row a warp: K rounds of a 5-stage shuffle argmin,
// ~10k thread instructions to select 8 of 32 values.  It was bound by
// instructions and latency at 7x the byte bound.  The narrow path (C <= 64,
// K <= 16: the main path's rows) gives each row one thread instead:
//   - A block of kTile threads owns tiles of kTile rows.  A tile of d and one
//     of ids are contiguous spans whose byte counts are multiples of 16, and
//     arrive in shared memory by one 1-D bulk copy each (cp.async.bulk) on an
//     mbarrier.  The grid is persistent: as many blocks as fit on each SM
//     (six at C = 32), each walking its tiles and asking for the next one as
//     soon as its threads are done with this one, so one block's copy runs
//     under the other blocks' selection.  (A ring of two or three stages a
//     block, with two or three blocks an SM, ran slower: the selection needs
//     the warps more than a block needs its own prefetch.)  An input that is
//     not 16-byte aligned (a view at a row offset with odd C), and a last
//     tile whose bytes are not a multiple of 16, are copied into the tile by
//     the block's threads, one word each, instead.
//   - A thread keeps the row's KB smallest (value, column) pairs sorted in
//     registers (KB = 4, 8 or 16, the least that holds K): the value as an
//     order-preserving unsigned key, the column beside it.  It reads its row
//     in column order, 16 bytes at a time where C is a multiple of 4, so a
//     strict compare keeps an equal value's lower column ahead.  Each value
//     is inserted by compare-and-shift over all KB slots, every slot taking
//     its new pair from the old list (no dynamic index, so nothing spills):
//     a compare, a max and a select a slot, ~27 instructions a value at
//     K = 8.  Compares and selects issue at half rate (16 lanes of an SM
//     partition), so at a serving chunk the selection alone takes about as
//     long as the copies alone.
//   - Bank conflicts: at C = 32 every row starts on bank 0, so the eight
//     threads of a 16-byte load's phase hit one bank group.  A rotated order
//     (chunk (j + t) mod C/4) avoids that but breaks the column order, and
//     ordering by (value, column) then takes 64-bit keys: twice the compares
//     and selects.  That design was measured first and was slower (PERF.md
//     §6).
//   - The fill rule is applied in closed form to the sorted list L (its first
//     min(K, C) entries): with n entries below BIG, picks 0..n-1 are L[0..n-1];
//     if n < K, F is the lowest column among them and L[n]'s if L[n] is
//     exactly BIG, and picks n..K-1 are (BIG, ids[F]); with no F (n = 0, every
//     entry above BIG) pick 0 is L[0] and picks 1..K-1 are (BIG, its id).  The
//     values and ids are read back from the tile by column.
//   - Each thread writes its K distances and K ids as 16-byte stores when K
//     is the list's size (4, 8 or 16), one word each otherwise.
// Wider rows (C > 64: the per-voxel K-NN's ~700 candidates) and K > 16 keep
// the first port's warp-per-row kernel: off the main path.
//
// Built by nvcc into a shared library with a plain C interface and loaded with
// ctypes (hybridneuralrendering_tpu_torch/ops/build.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kBig = 1e30f;
constexpr int kWarp = 32;

// ---------------------------------------------------------------- narrow path

constexpr int kTile = 128;          // rows of a tile = threads of a block
constexpr int kNarrowC = 64;
constexpr int kNarrowK = 16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// the input is read once: it leaves L2 first
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// A float as an unsigned integer of the same order, -0.0 folded onto +0.0.
// Every float but NaN maps below kNone.
__device__ __forceinline__ uint32_t ord(float v) {
  const uint32_t u = __float_as_uint(v + 0.0f);
  return u ^ ((uint32_t)((int32_t)u >> 31) | 0x80000000u);
}
constexpr uint32_t kNone = 0xffffffffu;

// The KB smallest (value, column) pairs seen so far, ascending: values as
// ord() keys, unused slots kNone.
template <int KB>
struct List {
  uint32_t v[KB];
  int c[KB];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      v[j] = kNone;
      c[j] = 0;
    }
  }
  // Columns arrive in ascending order, so a strict compare keeps an equal
  // value's earlier column ahead.  Every slot takes its new pair from the
  // old list: all indices are compile-time constants.
  __device__ __forceinline__ void insert(uint32_t x, int col) {
    bool after = x < v[KB - 1];
#pragma unroll
    for (int j = KB - 1; j > 0; --j) {
      const bool here = x < v[j - 1];
      if (after) {
        v[j] = here ? v[j - 1] : x;
        c[j] = here ? c[j - 1] : col;
      }
      after = here;
    }
    if (after) {
      v[0] = x;
      c[0] = col;
    }
  }
};

struct Narrow {
  const float* d;
  const int* ids;
  float* out_d;
  int* out_i;
  long long S;
  int C, K;
  long long tiles;
  bool bulk;  // d and ids are 16-byte aligned
};

// A tile goes by bulk copy when the inputs are aligned and its byte count is
// a multiple of 16 (every full tile; the last one if rows * C is a multiple
// of 4).
__device__ __forceinline__ bool by_bulk(const Narrow& p, long long tile) {
  const long long rows = min((long long)kTile, p.S - tile * kTile);
  return p.bulk && (rows * p.C) % 4 == 0;
}

template <int KB>
__global__ void __launch_bounds__(kTile)
narrow_kernel(const Narrow p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x;
  const int C = p.C, K = p.K;
  const long long span = (long long)kTile * C;  // words of a full tile
  float* sd = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(smem + span * 4);
  const uint32_t bar_s = smem_u32(&bar);

  uint64_t policy = 0;
  if (tid == 0) {
    mbar_init(bar_s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    policy = evict_first();
  }
  __syncthreads();

  auto issue = [&](long long tile) {
    const long long rows = min((long long)kTile, p.S - tile * kTile);
    const uint32_t bytes = (uint32_t)(rows * C * 4);
    mbar_expect_tx(bar_s, 2 * bytes);
    bulk_load(smem_u32(sd), p.d + tile * span, bytes, bar_s, policy);
    bulk_load(smem_u32(si), p.ids + tile * span, bytes, bar_s, policy);
  };
  if (tid == 0 && blockIdx.x < p.tiles && by_bulk(p, blockIdx.x)) {
    issue(blockIdx.x);
  }

  const uint32_t ordbig = ord(kBig);
  const int kc = min(K, C);
  uint32_t parity = 0;
  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const long long rows = min((long long)kTile, p.S - tile * kTile);
    if (by_bulk(p, tile)) {
      mbar_wait(bar_s, parity);
      parity ^= 1;
    } else {
      // one word a thread at a time: any 4-byte alignment, any byte count
      const long long n = rows * C;
      const float* gd = p.d + tile * span;
      const int* gi = p.ids + tile * span;
      for (long long w = tid; w < n; w += kTile) {
        sd[w] = gd[w];
        si[w] = gi[w];
      }
      __syncthreads();
    }

    if (tid < rows) {
      const float* rd = sd + tid * C;
      const int* ri = si + tid * C;
      List<KB> L;
      L.clear();
      if (C % 4 == 0) {
        const float4* r4 = reinterpret_cast<const float4*>(rd);
        for (int c = 0; c < C; c += 4) {
          const float4 v = r4[c / 4];
          L.insert(ord(v.x), c);
          L.insert(ord(v.y), c + 1);
          L.insert(ord(v.z), c + 2);
          L.insert(ord(v.w), c + 3);
        }
      } else {
        for (int c = 0; c < C; ++c) L.insert(ord(rd[c]), c);
      }

      // the fill rule on L's first kc pairs
      int n = 0;
      int f = C;
      bool past = false;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        if (j < kc) {
          if (L.v[j] < ordbig) {
            ++n;
            f = min(f, L.c[j]);
          } else if (!past) {
            past = true;
            if (L.v[j] == ordbig) f = min(f, L.c[j]);
          }
        }
      }
      const bool has_f = f < C;
      const int fill = has_f ? f : L.c[0];
      float od[KB];
      int oi[KB];
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const bool own = k < n || (!has_f && k == 0);
        const int c = own ? L.c[k] : fill;
        od[k] = k < K ? (own ? rd[c] : kBig) : 0.f;
        oi[k] = k < K ? ri[c] : 0;
      }
      const long long row = tile * kTile + tid;
      float* gd = p.out_d + row * K;
      int* gi = p.out_i + row * K;
      if (K == KB) {
#pragma unroll
        for (int k = 0; k < KB; k += 4) {
          *reinterpret_cast<float4*>(gd + k) =
              make_float4(od[k], od[k + 1], od[k + 2], od[k + 3]);
          *reinterpret_cast<int4*>(gi + k) =
              make_int4(oi[k], oi[k + 1], oi[k + 2], oi[k + 3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          if (k < K) {
            gd[k] = od[k];
            gi[k] = oi[k];
          }
        }
      }
    }

    __syncthreads();  // every read of the tile is done
    const long long next = tile + gridDim.x;
    if (tid == 0 && next < p.tiles && by_bulk(p, next)) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(next);
    }
  }
}

constexpr int kMaxDevices = 16;

// Blocks of narrow_kernel<KB> that fit on an SM at C columns (a tile of d and
// one of ids: kTile * C * 8 bytes of shared memory).  The attributes and the
// occupancy query cost more host time than the launch itself, so they are
// asked once a device and C.
template <int KB>
cudaError_t blocks_per_sm(int dev, int C, int* out) {
  static std::atomic<int> known[kMaxDevices][kNarrowC + 1];
  if (dev < kMaxDevices && (*out = known[dev][C].load()) > 0) {
    return cudaSuccess;
  }
  cudaError_t e = cudaFuncSetAttribute(
      narrow_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTile * kNarrowC * 8);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(narrow_kernel<KB>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, narrow_kernel<KB>,
                                                    kTile, kTile * C * 8);
  if (e != cudaSuccess) return e;
  if (*out < 1) return cudaErrorInvalidConfiguration;
  if (dev < kMaxDevices) known[dev][C].store(*out);
  return cudaSuccess;
}

template <int KB>
cudaError_t launch_narrow(Narrow p, cudaStream_t stream) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if ((e = blocks_per_sm<KB>(dev, p.C, &per_sm)) != cudaSuccess) return e;
  p.tiles = (p.S + kTile - 1) / kTile;
  const long long most = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(p.tiles < most ? p.tiles : most);
  narrow_kernel<KB><<<grid, kTile, kTile * p.C * 8, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ wide path

constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ bool less_pair(float da, int ca, float db, int cb) {
  return da < db || (da == db && ca < cb);
}

// One warp per row.  Lane l holds columns l, l+32, l+64, ... in registers
// (NPER of them).  Each of the K rounds is a local min over the lane's
// registers and a warp argmin over (d, col) with __shfl_xor_sync, in which a
// tie goes to the lower column; the owner writes the pick and retires it
// with BIG.
template <int NPER>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
wide_kernel(const float* __restrict__ d, const int* __restrict__ ids,
            float* __restrict__ out_d, int* __restrict__ out_i, int S, int C,
            int K) {
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
cudaError_t launch_wide(const float* d, const int* ids, float* out_d,
                        int* out_i, int S, int C, int K, cudaStream_t stream) {
  const int blocks = (S + kRowsPerBlock - 1) / kRowsPerBlock;
  wide_kernel<NPER><<<blocks, kWarp * kRowsPerBlock, 0, stream>>>(
      d, ids, out_d, out_i, S, C, K);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value: 0 on a successful launch.  The launch is
// asynchronous on `stream`.  C must lie in [1, 1024] and K be at least 1; d
// and ids must be 4-byte aligned, out_d and out_i 16-byte aligned.
extern "C" int k_smallest_launch(const void* d, const void* ids, void* out_d,
                                 void* out_i, int S, int C, int K,
                                 void* stream) {
  if (S < 0 || C < 1 || C > 32 * kWarp || K < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)d | (uintptr_t)ids) & 3) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)out_d | (uintptr_t)out_i) & 15) {
    return (int)cudaErrorInvalidValue;
  }
  if (S == 0) return 0;
  const float* dp = static_cast<const float*>(d);
  const int* ip = static_cast<const int*>(ids);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= kNarrowC && K <= kNarrowK) {
    Narrow p{dp, ip, od, oi, S, C, K, 0,
             (((uintptr_t)d | (uintptr_t)ids) & 15) == 0};
    cudaError_t err;
    if (K <= 4) err = launch_narrow<4>(p, st);
    else if (K <= 8) err = launch_narrow<8>(p, st);
    else err = launch_narrow<16>(p, st);
    return (int)err;
  }
  const int nper = (C + kWarp - 1) / kWarp;
  cudaError_t err;
  if (nper <= 1) err = launch_wide<1>(dp, ip, od, oi, S, C, K, st);
  else if (nper <= 2) err = launch_wide<2>(dp, ip, od, oi, S, C, K, st);
  else if (nper <= 4) err = launch_wide<4>(dp, ip, od, oi, S, C, K, st);
  else if (nper <= 8) err = launch_wide<8>(dp, ip, od, oi, S, C, K, st);
  else if (nper <= 16) err = launch_wide<16>(dp, ip, od, oi, S, C, K, st);
  else err = launch_wide<32>(dp, ip, od, oi, S, C, K, st);
  return (int)err;
}
