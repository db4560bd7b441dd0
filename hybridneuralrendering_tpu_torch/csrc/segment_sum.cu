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
// element), so it is bound by memory.  It reads the U rows that belong to
// ids (U = end_pos[n-1] + 1), U*C*4 + n*4 bytes, and writes n*C*4: at a
// training step's pyramid map (U = 301,056, C = 45, n = 1,228,800) that is
// 54.2 MB + 4.9 MB read and 221.2 MB written, 0.082 ms at 3.35 TB/s.  Most
// of the bytes are the zero rows of ids that no row touches.
//
// Design: the work is spread by rows, and the gaps are filled with wide
// stores, in two launches whose sizes follow from M, C and n alone:
//   rows: each warp takes a tile of kRows consecutive rows of sg.  It finds
//     the segments that end in its tile from end_pos (a galloping warp
//     search for the tile's first id, then 256 ids a step, and a new
//     search over any run of ids without rows), loads its rows 32 at a
//     time into registers (each lane two columns of a chunk of 64: at even
//     C side by side, one float2, so a row is one coalesced read) and walks
//     them in order.  A segment that lies inside the tile is written to
//     out at once.  A segment that crosses a tile edge leaves each tile's
//     piece in scratch (a tile's first piece in its head slot, its last in
//     its tail slot), and the tile where it ends records its id.  Rows
//     after end_pos[n-1] are never read.
//   fix_up_and_zeros: fix-up blocks sum each recorded segment's pieces,
//     warp w summing the pieces j = w, w + 8, ... in order and the eight
//     warp sums added as a tree, so a segment of 38k rows spreads over
//     ~300 row warps and 8 fix-up warps, not one warp; zero blocks store
//     zeros over the flat range of out [n*C] 16 bytes at a time: a vector
//     whose ids all lack rows is stored whole, a vector that mixes ids with
//     and without rows element by element (at C = 45 a vector may span two
//     ids).
// Each element of out is written once.  Inside a piece four running sums
// take the rows by row index mod 4 and are added as (s0 + s1) + (s2 + s3).
// No float atomics and no host read; the order of every sum follows from
// the inputs, so the result is the same from launch to launch and
// ops/segment_sum.tolerance states its bound from this order.  The zeros
// run after the rows: in one launch with the rows, the zero blocks were
// held to the row blocks' occupancy and the whole ran slower.  The kernel
// reads the permuted copy sg, as the TPU kernel does, not the unsorted
// cotangent through the permutation.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (hybridneuralrendering_tpu_torch/ops/build.py).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;                          // per block
constexpr int kThreads = kWarp * kWarps;
constexpr int kRows = 128;                         // rows of a warp's tile
constexpr int kBatch = kWarp;                      // rows held at once
constexpr int kBatches = kRows / kBatch;
constexpr int kIdSteps = 8;                        // ids read: 8 x 32 a step
constexpr int kZeroVecs = 8;                       // zero vectors a thread
constexpr int kZeroBlock = kThreads * kZeroVecs;   // zero vectors a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// A lane's two columns of a chunk of 64: side by side (c0 + 2 * lane and
// the next, one float2) when C is even and the arrays 8-byte aligned,
// else c0 + lane and c0 + lane + 32.
template <bool kPair>
__device__ __forceinline__ int2 lane_cols(int c0, int lane) {
  return kPair ? make_int2(c0 + 2 * lane, c0 + 2 * lane + 1)
               : make_int2(c0 + lane, c0 + lane + kWarp);
}

template <bool kPair>
__device__ __forceinline__ float2 load_cols(const float* __restrict__ row,
                                            int2 c, int C) {
  if (kPair) {
    return c.x < C ? __ldg(reinterpret_cast<const float2*>(row + c.x))
                   : make_float2(0.f, 0.f);
  }
  return make_float2(c.x < C ? __ldg(row + c.x) : 0.f,
                     c.y < C ? __ldg(row + c.y) : 0.f);
}

template <bool kPair>
__device__ __forceinline__ void store_cols(float* row, int2 c, int C,
                                           float2 v) {
  if (kPair) {
    if (c.x < C) *reinterpret_cast<float2*>(row + c.x) = v;
  } else {
    if (c.x < C) row[c.x] = v.x;
    if (c.y < C) row[c.y] = v.y;
  }
}

// The first p in [from, n) with ep[p] >= r; needs ep[n - 1] >= r.  The
// warp gallops (lane l probes from + 2**l - 1), then narrows the bracket
// 33-fold a step with 32 probes.
__device__ int lower_bound_warp(const int* __restrict__ ep, int n,
                                long long from, long long r, int lane) {
  long long q = from + (1LL << lane) - 1;
  if (q > n - 1) q = n - 1;
  unsigned m = __ballot_sync(kFull, __ldg(ep + q) >= r);
  int f = __ffs(m) - 1;
  const long long q_prev = __shfl_up_sync(kFull, q, 1);
  long long hi = __shfl_sync(kFull, q, f);
  long long lo = f == 0 ? from : __shfl_sync(kFull, q_prev, f) + 1;
  while (hi - lo > kWarp) {          // the answer lies in [lo, hi]
    const long long pr = lo + (hi - lo) * (lane + 1) / (kWarp + 1);
    m = __ballot_sync(kFull, __ldg(ep + pr) >= r);
    const long long pr_prev = __shfl_up_sync(kFull, pr, 1);
    if (m == 0) {
      lo = __shfl_sync(kFull, pr, kWarp - 1) + 1;
    } else {
      f = __ffs(m) - 1;
      hi = __shfl_sync(kFull, pr, f);
      if (f > 0) lo = __shfl_sync(kFull, pr_prev, f) + 1;
    }
  }
  const long long c = lo + lane;
  m = __ballot_sync(kFull, c < hi && __ldg(ep + c) >= r);
  return (int)(m ? lo + __ffs(m) - 1 : hi);
}

// Rows [rb, rb + kBatch) of columns c into v (zeros past r1 or past C).
template <bool kPair>
__device__ __forceinline__ void load_batch(float2 (&v)[kBatch],
                                           const float* __restrict__ sg,
                                           long long rb, long long r1,
                                           int2 c, int C) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    v[i] = rb + i < r1 ? load_cols<kPair>(sg + (rb + i) * C, c, C)
                       : make_float2(0.f, 0.f);
  }
}

// One warp's tile t: rows [t * kRows, min((t + 1) * kRows, U)).  s_id is
// the warp's row -> id map of the segments that end in the tile (-1
// elsewhere).
template <bool kPair>
__device__ void row_tile(const float* __restrict__ sg,
                         const int* __restrict__ ep, float* __restrict__ out,
                         float* __restrict__ part, int* __restrict__ info,
                         int C, int n, long long t, int (&s_id)[kRows],
                         int lane) {
  const long long used = (long long)__ldg(ep + n - 1) + 1;
  const long long r0 = t * kRows;
  if (r0 >= used) {
    if (lane == 0) info[t] = -1;
    return;
  }
  const long long r1 = min(r0 + kRows, used);
  // the first batch of rows is in flight while the ids are read
  float2 v[kBatch];
  load_batch<kPair>(v, sg, r0, r1, lane_cols<kPair>(0, lane), C);
  for (int i = lane; i < kRows; i += kWarp) s_id[i] = -1;
  __syncwarp();
  // pa: the tile's first segment (it holds row r0)
  const int pa = lower_bound_warp(ep, n, 0, r0, lane);
  // The ids from p on, 256 a step: the segments that end in the tile, up
  // to the first that ends after it (the tile's pending segment).  A step
  // that met ids with rows goes on with the next 256 ids; one that met
  // none searches for the segment of the next row (a run of ids without
  // rows).  `before` is end_pos[p - 1], or -1 after a search: the id found
  // has rows, so any value below its end will do.
  int tail = -1;
  long long p = pa;
  int before = -1;
  for (;;) {
    int e[kIdSteps];
#pragma unroll
    for (int k = 0; k < kIdSteps; ++k) {
      const long long q = p + k * kWarp + lane;
      e[k] = q < n ? __ldg(ep + q) : INT_MAX;
    }
    bool found = false;
    unsigned met = 0;
#pragma unroll
    for (int k = 0; k < kIdSteps; ++k) {
      const long long q = p + k * kWarp + lane;
      const int up = __shfl_up_sync(kFull, e[k], 1);
      const int prev = lane == 0 ? before : up;
      const bool in = q < n && e[k] != prev && e[k] < r1;
      if (in) s_id[e[k] - r0] = (int)q;
      met |= __ballot_sync(kFull, in);
      const unsigned past = __ballot_sync(kFull, e[k] >= r1);
      if (past && !found) {
        const long long qf = p + k * kWarp + __ffs(past) - 1;
        tail = qf < n ? (int)qf : -1;
        found = true;
      }
      before = __shfl_sync(kFull, e[k], kWarp - 1);
    }
    if (found) break;
    const long long next = (long long)before + 1;
    if (next >= r1) break;
    if (met) {
      p += kIdSteps * kWarp;
    } else {
      p = lower_bound_warp(ep, n, p + kIdSteps * kWarp, next, lane);
      before = -1;
    }
  }
  __syncwarp();
  const long long head_lo = pa > 0 ? (long long)__ldg(ep + pa - 1) + 1 : 0;
  const bool head_cont = head_lo < r0;      // pa began in an earlier tile
  const bool pending = s_id[r1 - 1 - r0] < 0;
  if (lane == 0) info[t] = head_cont && __ldg(ep + pa) < r1 ? pa : -1;
  float* head_slot = part + t * 2 * C;
  float* tail_slot = head_slot + C;
  const float2 z = make_float2(0.f, 0.f);
  for (int c0 = 0; c0 < C; c0 += 2 * kWarp) {
    const int2 c = lane_cols<kPair>(c0, lane);
    float2 acc[4] = {z, z, z, z};
    // one batch of rows in registers at a time (unrolled, the batches'
    // loads would all be hoisted and spill)
#pragma unroll 1
    for (int b = 0; b < kBatches; ++b) {
      const long long rb = r0 + b * kBatch;
      if (rb >= r1) break;
      if (c0 > 0 || b > 0) load_batch<kPair>(v, sg, rb, r1, c, C);
      const unsigned ends = __ballot_sync(kFull, s_id[b * kBatch + lane] >= 0);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        acc[i & 3] = add2(acc[i & 3], v[i]);
        if ((ends >> i) & 1u) {
          const int q = s_id[b * kBatch + i];
          store_cols<kPair>(
              q == pa && head_cont ? head_slot : out + (long long)q * C, c,
              C, add2(add2(acc[0], acc[1]), add2(acc[2], acc[3])));
          acc[0] = acc[1] = acc[2] = acc[3] = z;
        }
      }
    }
    if (pending) {
      store_cols<kPair>(tail == pa && head_cont ? head_slot : tail_slot, c, C,
                        add2(add2(acc[0], acc[1]), add2(acc[2], acc[3])));
    }
  }
}

__device__ __forceinline__ long long id_of(long long i, int C,
                                           unsigned long long cdiv) {
  // i / C for i < 2**32 by one 64-bit multiply (cdiv = ceil(2**64 / C))
  return C == 1 ? i : (long long)__umul64hi(cdiv, (unsigned long long)i);
}

// Zero block zb: vectors [zb, zb + 1) * kZeroBlock of out's flat range.
// Every vector's end_pos reads are issued before its stores.
__device__ void zero_fill(const int* __restrict__ ep, float* __restrict__ out,
                          long long nc, int C, unsigned long long cdiv,
                          long long zb) {
  const long long nvec = (nc + 3) / 4;
  long long i0[kZeroVecs], p0[kZeroVecs], p3[kZeroVecs];
  int before[kZeroVecs], last[kZeroVecs];
#pragma unroll
  for (int j = 0; j < kZeroVecs; ++j) {
    const long long vi = zb * kZeroBlock + j * kThreads + threadIdx.x;
    i0[j] = min(vi, nvec - 1) * 4;
    p0[j] = id_of(i0[j], C, cdiv);
    p3[j] = id_of(min(i0[j] + 3, nc - 1), C, cdiv);
    before[j] = p0[j] > 0 ? __ldg(ep + p0[j] - 1) : -1;
    last[j] = __ldg(ep + p3[j]);
  }
#pragma unroll
  for (int j = 0; j < kZeroVecs; ++j) {
    if (zb * kZeroBlock + j * kThreads + threadIdx.x >= nvec) return;
    if (last[j] == before[j]) {             // no id of the vector has rows
      if (i0[j] + 3 < nc) {
        reinterpret_cast<float4*>(out)[i0[j] / 4] =
            make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (long long i = i0[j]; i < nc; ++i) out[i] = 0.f;
      }
    } else if (p3[j] != p0[j]) {            // ids with and without rows
      for (long long i = i0[j]; i < min(i0[j] + 4, nc); ++i) {
        const long long p = id_of(i, C, cdiv);
        if (__ldg(ep + p) == (p > 0 ? __ldg(ep + p - 1) : -1)) out[i] = 0.f;
      }
    }
  }
}

template <bool kPair>
__global__ void __launch_bounds__(kThreads, 2)
rows(const float* __restrict__ sg, const int* __restrict__ ep,
     float* __restrict__ out, float* __restrict__ part,
     int* __restrict__ info, int C, int n, long long T) {
  __shared__ int s_id[kWarps][kRows];
  const int w = threadIdx.x / kWarp;
  const long long t = (long long)blockIdx.x * kWarps + w;
  if (t >= T) return;
  row_tile<kPair>(sg, ep, out, part, info, C, n, t, s_id[w],
                  threadIdx.x & (kWarp - 1));
}

// Fix-up block b: the segments recorded by tiles 8b .. 8b + 7, each summed
// from its pieces (the tail slot of its first tile ts, the head slots of
// tiles ts + 1 .. t).
__device__ void fix_up(const float* __restrict__ part,
                       const int* __restrict__ info,
                       const int* __restrict__ ep, float* __restrict__ out,
                       long long T, int C, long long b) {
  __shared__ int s_seg[kWarps];
  __shared__ float s[kWarps][kWarp];
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  if (threadIdx.x < kWarps) {
    const long long t = b * kWarps + threadIdx.x;
    s_seg[threadIdx.x] = t < T ? info[t] : -1;
  }
  __syncthreads();
  for (int j = 0; j < kWarps; ++j) {
    const int p = s_seg[j];
    if (p < 0) continue;
    const long long t = b * kWarps + j;
    const long long lo = p > 0 ? (long long)__ldg(ep + p - 1) + 1 : 0;
    const long long ts = lo / kRows;
    const long long pieces = t - ts + 1;
    for (int c0 = 0; c0 < C; c0 += kWarp) {
      const int c = c0 + lane;
      float acc = 0.f;
      if (c < C) {
#pragma unroll 8
        for (long long k = w; k < pieces; k += kWarps) {
          const long long slot = k == 0 ? ts * 2 + 1 : (ts + k) * 2;
          acc += part[slot * C + c];
        }
      }
      s[w][lane] = acc;
      __syncthreads();
      if (w == 0 && c < C) {
        out[(long long)p * C + c] =
            ((s[0][lane] + s[1][lane]) + (s[2][lane] + s[3][lane])) +
            ((s[4][lane] + s[5][lane]) + (s[6][lane] + s[7][lane]));
      }
      __syncthreads();
    }
  }
}

// After `rows`: blocks [0, fix_blocks) fix up crossing segments, the rest
// fill the ids without rows with zeros.
__global__ void __launch_bounds__(kThreads)
fix_up_and_zeros(const float* __restrict__ part, const int* __restrict__ info,
                 const int* __restrict__ ep, float* __restrict__ out,
                 long long T, int C, long long fix_blocks, long long nc,
                 unsigned long long cdiv) {
  if (blockIdx.x < fix_blocks) {
    fix_up(part, info, ep, out, T, C, blockIdx.x);
  } else {
    zero_fill(ep, out, nc, C, cdiv, blockIdx.x - fix_blocks);
  }
}

template <bool kPair>
cudaError_t launch(const float* sg, const int* ep, float* out, float* part,
                   long long M, int C, int n, cudaStream_t st) {
  const long long T = (M + kRows - 1) / kRows;
  const long long nc = (long long)n * C;
  const long long fix_blocks = (T + kWarps - 1) / kWarps;
  const long long zero_blocks = ((nc + 3) / 4 + kZeroBlock - 1) / kZeroBlock;
  if (fix_blocks + zero_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned long long cdiv = C > 1 ? ~0ull / (unsigned)C + 1 : 0;
  int* info = reinterpret_cast<int*>(part + T * 2 * C);
  if (T > 0) {
    rows<kPair><<<(unsigned)fix_blocks, kThreads, 0, st>>>(sg, ep, out, part,
                                                           info, C, n, T);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  fix_up_and_zeros<<<(unsigned)(fix_blocks + zero_blocks), kThreads, 0,
                      st>>>(part, info, ep, out, T, C, fix_blocks, nc, cdiv);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value: 0 when both launches were accepted.  The
// launches are asynchronous on `stream` of CUDA device `device` (made
// current for the call if it is not).  end_pos must be non-decreasing
// with values in [-1, M - 1], n * C at most 2**32 and out 16-byte aligned.
// scratch holds ceil(M / 128) * (2 * C + 1) float32 words (the pieces of
// the segments that cross a tile edge and one id per tile); nothing in it
// needs to be initialised.  The wrapper (ops/segment_sum.py) checks shapes
// and types.
extern "C" int segment_sum_launch(const void* sg, const void* end_pos,
                                  void* out, void* scratch, long long M,
                                  int C, int n, int device, void* stream) {
  if (M < 0 || M > 0x7fffffffLL || C < 1 || n < 0 ||
      (long long)n * C > (1LL << 32) ||
      (reinterpret_cast<unsigned long long>(out) & 15ull) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  int prev;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long ptrs =
      reinterpret_cast<unsigned long long>(sg) |
      reinterpret_cast<unsigned long long>(out) |
      reinterpret_cast<unsigned long long>(scratch);
  const float* x = static_cast<const float*>(sg);
  const int* ep = static_cast<const int*>(end_pos);
  float* y = static_cast<float*>(out);
  float* part = static_cast<float*>(scratch);
  err = C % 2 == 0 && (ptrs & 7ull) == 0
            ? launch<true>(x, ep, y, part, M, C, n, st)
            : launch<false>(x, ep, y, part, M, C, n, st);
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}
