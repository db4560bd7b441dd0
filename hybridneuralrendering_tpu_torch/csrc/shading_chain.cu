// The per-neighbour shading chain, forward and recompute backward.
//
// Replaces the Pallas TPU kernels of tools/pallas_shading.py
// `fused_feat_alpha_pe` (forward body `_fwd_kernel`, backward body
// `_bwd_kernel` with its on-chip weight-gradient sums `accum`).  For each
// neighbour row it computes
//   x1   = [emb | PE(emb) | PE(dists)]   (the reference's d-major
//          interleaved sin/cos layout, core/encoding.positional_encoding)
//   h    = block1 (+ block2): Linear + leaky ReLU (slope 0.01) per layer
//   feat = block3([h | extra])           every layer activated
//   alpha_raw = head(feat)               activated but for the last layer
// and the backward of that chain: d_emb, d_dists, d_extra, every dW and db.
// Operands of every product are rounded to the compute type (bf16 or f32);
// products accumulate in f32; bias, leaky ReLU and the positional encoding
// are f32, as in the TPU kernel's `_mm`.
//
// Bound on an H100: operations.  At the scannet_full widths a row costs
// 271,360 multiply-adds forward (block1 284->256->256, block3 263->256->256,
// head 256->1); at the bf16 tensor-core peak of 989 TFLOP/s the forward of
// 602,112 rows takes at least 0.330 ms, forward + backward 0.991 ms, and a
// serving chunk of 3,145,728 rows 1.726 ms forward.  Its bytes (raw inputs
// in, feat f32 out: about 3.8 GB at 3.1M rows) would take 1.13 ms.
//
// Design (the simple one; a first kernel that is right):
//   chain_fwd     one block of 512 threads per tile of 64 rows.  The tile's
//                 raw inputs go to shared memory, the positional encoding is
//                 expanded there in f32 with sincosf (not __sinf: the dist
//                 bands reach 2^4 * d) and stored in the compute type.  Each
//                 layer is one block-wide product, 256 output columns a
//                 pass: the weights (all of them stay in the 50 MB L2)
//                 stream through a ring of three shared-memory chunks (64
//                 rows in bf16, 16 in f32) by cp.async, two chunks ahead of
//                 the one being multiplied; bf16 products run on the tensor
//                 cores (ldmatrix, mma.sync m16n8k16, f32 accumulators),
//                 f32 products on the CUDA cores.  An epilogue adds the
//                 bias, applies the leaky ReLU, writes feat / alpha, and
//                 stores the next layer's input (block3's starts with the
//                 extra columns after block1's padded output): in bf16
//                 straight from the accumulators, in f32 through a shared
//                 f32 buffer.
//   chain_bwd     the same tiles: the forward again, writing every layer's
//                 input A_l (compute type) to a scratch buffer, then the
//                 reverse sweep of `_bwd_kernel`: g * dlrelu, one partial
//                 db per tile (f32, rows in order), G_l = g in the compute
//                 type to a second scratch buffer, dX = G_l W_l^T on the
//                 same product routine into the shared f32 buffer (the
//                 wrapper packs W^T beside W),
//                 + dfeat at the head's bottom, the d_extra split at
//                 block3's bottom, and the PE backward to d_emb / d_dists.
//   chain_dw      dW_l = sum_rows A_l^T G_l in two passes.  The first
//                 takes one chunk of 4,096 rows and 128 columns of dW_l a
//                 block: rows of A_l and G_l stream through a shared-memory
//                 ring by cp.async, 64 rows a step, into mma.sync f32
//                 accumulators that hold all the block's dW; each chunk's
//                 share of the per-tile db partials too; into an f32 buffer
//                 [chunks, dW | db].  The second (chain_reduce) sums that
//                 buffer over chunks in a fixed order.
// No atomics: two launches give the same bits.
//
// What the simple design costs: every 64-row tile streams all 544 KB of
// weights from L2 again; the A/G scratch (about 2.8 GB at 602,112 rows,
// written once and read two to three times) is traffic the TPU kept in
// VMEM, about 1.7 ms at 3.35 TB/s; a barrier at every chunk of the ring and
// the backward's f32 round trips through shared memory leave the tensor
// cores idle most of the time, and 220 KB of shared memory keep one block
// on an SM.  A later version can take more rows per weight pass and
// accumulate dW on chip with wgmma, TMA and persistent blocks.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (hybridneuralrendering_tpu_torch/ops/build.py); the wrapper is
// hybridneuralrendering_tpu_torch/ops/shading_chain.py, which also computes
// the packed layout that `meta` describes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;         // rows per tile
constexpr int kThreads = 512;  // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kNB = 256;       // output columns per pass
constexpr int kSkew = 8;       // extra elements per shared row
constexpr int kMaxLayers = 16;
constexpr int kRowsPerThread = kT * kNB / kThreads;  // f32 product: 32
constexpr int kDwCols = 128;   // dW columns a chain_dw block computes
constexpr int kDwRows = 64;    // rows of A and G a chain_dw step stages
constexpr int kDwM = 288;      // dW rows a chain_dw pass holds
constexpr int kMaxSmem = 232448;
constexpr float kSlope = 0.01f;

// meta layout (ints), written by ops/shading_chain.ChainLayout.meta:
// [L, na, nb, de, dd, ce, fe, fd, c1, atot, gtot, btot, wtot] then per layer
// [kp, np, nreal, woff, wtoff, boff, aoff, goff]
constexpr int kHead = 13;
constexpr int kPerLayer = 8;

struct Layer {
  int kp, np, nreal, woff, wtoff, boff, aoff, goff;
};

struct Chain {
  int L, na, nb, de, dd, ce, fe, fd, c1, atot, gtot, btot, wtot;
  int xld, cld, rawld;
  Layer layer[kMaxLayers];
};

// The weights stream through a ring of kStages chunks of kc<Act>() rows by
// kNB columns: 64 rows in bf16, 16 in f32 (its operands are twice as wide).
constexpr int kStages = 3;
template <typename Act>
__host__ __device__ constexpr int kc() {
  return sizeof(Act) == 2 ? 64 : 16;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename Act>
__device__ __forceinline__ Act from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : kSlope * v;
}

__host__ __device__ __forceinline__ size_t align128(size_t b) {
  return (b + 127) & ~size_t(127);
}

constexpr int kWld = kNB + kSkew;  // leading dimension of a staged chunk

template <typename Act>
struct Smem {
  Act* x;      // [kT, xld]  the current product's left operand
  float* c;    // [kT, cld]  the current product's f32 result
  Act* w;      // [kStages, kc, kWld] ring of staged weight chunks
  float* raw;  // [kT, rawld] emb | dists | extra of the tile
  float* bias; // [btot] every layer's bias

  __host__ __device__ static size_t bytes(const Chain& ch) {
    return align128(sizeof(Act) * kT * ch.xld) +
           align128(sizeof(float) * kT * ch.cld) +
           align128(sizeof(Act) * kStages * kc<Act>() * kWld) +
           align128(sizeof(float) * kT * ch.rawld) +
           align128(sizeof(float) * ch.btot);
  }
  __device__ Smem(unsigned char* base, const Chain& ch) {
    x = reinterpret_cast<Act*>(base);
    base += align128(sizeof(Act) * kT * ch.xld);
    c = reinterpret_cast<float*>(base);
    base += align128(sizeof(float) * kT * ch.cld);
    w = reinterpret_cast<Act*>(base);
    base += align128(sizeof(Act) * kStages * kc<Act>() * kWld);
    raw = reinterpret_cast<float*>(base);
    base += align128(sizeof(float) * kT * ch.rawld);
    bias = reinterpret_cast<float*>(base);
  }
};

// 16-byte asynchronous copy global -> shared (cp.async), commit of this
// thread's copies as one group, and the wait until at most n groups are
// still in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// Start copying W[k0:k0+kc, n0:n0+nb] (row-major, leading dimension N) into
// a ring slot.  kc, nb and N are multiples of 16; rows start 16-byte
// aligned.
template <typename Act>
__device__ __forceinline__ void stage_chunk(const Act* __restrict__ W, int N,
                                            int k0, int kc, int n0, int nb,
                                            Act* slot) {
  constexpr int per = 16 / sizeof(Act);
  const int vpr = nb / per;
  for (int i = threadIdx.x; i < kc * vpr; i += kThreads) {
    const int r = i / vpr, v = i - r * vpr;
    cp_async16(slot + r * kWld + v * per,
               W + (size_t)(k0 + r) * N + n0 + v * per);
  }
}

constexpr int kc_bf16 = kc<__nv_bfloat16>();

// Tensor-core primitives: ldmatrix (four 8x8 b16 tiles from shared memory,
// lane l giving the row address of tile l / 8; .trans delivers them
// transposed) and mma.sync m16n8k16 with bf16 operands and f32
// accumulators, the fragment layouts of the PTX ISA.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// A 16x16 bf16 tile of a row-major [rows, cols] matrix at `tile` (leading
// dimension ld) as the A operand; its transpose, for a matrix stored
// column-major; and two 16x8 B operands from a row-major [k, n] tile.
__device__ __forceinline__ void load_a(unsigned (&a)[4],
                                       const __nv_bfloat16* tile, int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, tile + ((l & 7) + ((l >> 3) & 1) * 8) * ld + (l >> 4) * 8);
}
__device__ __forceinline__ void load_a_t(unsigned (&a)[4],
                                         const __nv_bfloat16* tile, int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(a, tile + ((l & 7) + (l >> 4) * 8) * ld + ((l >> 3) & 1) * 8);
}
__device__ __forceinline__ void load_b(unsigned (&b)[4],
                                       const __nv_bfloat16* tile, int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(b, tile + (l & 15) * ld + (l >> 4) * 8);
}
// Write a 16x16 f32 result (two m16n8 accumulators) at `out` (row-major,
// leading dimension ld).
__device__ __forceinline__ void store_acc(float* out, int ld,
                                          const float (&d)[2][4]) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* o = out + g * ld + h * 8 + 2 * t;
    *reinterpret_cast<float2*>(o) = make_float2(d[h][0], d[h][1]);
    *reinterpret_cast<float2*>(o + 8 * ld) = make_float2(d[h][2], d[h][3]);
  }
}

// The bf16 product's per-warp state: the warp's row tile and four 16x16
// f32 results in a pass of kNB columns (column tiles warp / 4 + 4 j).
struct MmaBf16 {
  float acc[4][2][4];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][h][e] = 0.f;
  }
  // acc += X[:, k0:k0+kc] @ slot (kc rows of the pass's nb columns)
  __device__ void chunk(const __nv_bfloat16* X, int xld, int k0, int kc,
                        const __nv_bfloat16* slot, int nb) {
    const int warp = threadIdx.x / 32, rt = warp & 3;
#pragma unroll
    for (int kk = 0; kk < kc_bf16; kk += 16) {
      if (kk >= kc) break;
      unsigned a[4];
      load_a(a, X + rt * 16 * xld + k0 + kk, xld);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ct = (warp >> 2) + 4 * j;
        if (ct * 16 < nb) {
          unsigned b[4];
          load_b(b, slot + kk * kWld + ct * 16, kWld);
          mma_bf16(acc[j][0], a, b[0], b[1]);
          mma_bf16(acc[j][1], a, b[2], b[3]);
        }
      }
    }
  }
  __device__ void store(float* C, int cld, int n0, int nb) {
    const int warp = threadIdx.x / 32, rt = warp & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ct = (warp >> 2) + 4 * j;
      if (ct * 16 < nb)
        store_acc(C + rt * 16 * cld + n0 + ct * 16, cld, acc[j]);
    }
  }
};

// The f32 product's per-thread state: one column of a pass, every other row.
struct MmaF32 {
  float acc[kRowsPerThread];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0.f;
  }
  __device__ void chunk(const float* X, int xld, int k0, int kc,
                        const float* slot, int nb) {
    const int col = threadIdx.x % kNB, row0 = threadIdx.x / kNB;
    if (col >= nb) return;
    for (int kk = 0; kk < kc; ++kk) {
      const float w = slot[kk * kWld + col];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j)
        acc[j] += X[(row0 + 2 * j) * xld + k0 + kk] * w;
    }
  }
  __device__ void store(float* C, int cld, int n0, int nb) {
    const int col = threadIdx.x % kNB, row0 = threadIdx.x / kNB;
    if (col >= nb) return;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      C[(row0 + 2 * j) * cld + n0 + col] = acc[j];
  }
};

template <typename Act>
struct Mma;
template <>
struct Mma<__nv_bfloat16> : MmaBf16 {};
template <>
struct Mma<float> : MmaF32 {};

// X[kT, K] @ W[K, N] for the tile; K and N multiples of 16.  The product
// runs as steps of (pass of kNB columns, chunk of kc rows); the weight
// chunks stream through the ring by cp.async, kStages - 1 steps ahead of
// the one being multiplied, across the pass boundaries.  Each pass's result
// goes to done(mma, n0, nb), called by every thread at the pass's last
// step.  Begins and ends with a barrier.
template <typename Act, typename Done>
__device__ void block_mm(const Act* X, int xld, int K,
                         const Act* __restrict__ W, int N, Act* ring,
                         Done done) {
  constexpr int S = kStages, KC = kc<Act>();
  const int nch = (K + KC - 1) / KC;
  const int steps = ((N + kNB - 1) / kNB) * nch;
  auto issue = [&](int s) {
    if (s < steps) {
      const int n0 = (s / nch) * kNB, k0 = (s % nch) * KC;
      stage_chunk(W, N, k0, min(KC, K - k0), n0, min(kNB, N - n0),
                  ring + (s % S) * KC * kWld);
    }
    cp_async_commit();
  };
  __syncthreads();  // the ring's previous user is done with it
  for (int s = 0; s < S - 1; ++s) issue(s);
  Mma<Act> m;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk s is in; every thread is done with s - 1
    issue(s + S - 1);
    const int n0 = (s / nch) * kNB, k0 = (s % nch) * KC;
    const int nb = min(kNB, N - n0);
    if (k0 == 0) m.zero();
    m.chunk(X, xld, k0, min(KC, K - k0), ring + (s % S) * KC * kWld, nb);
    if (s % nch == nch - 1) done(m, n0, nb);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The tile's raw rows (zeros past n) and the biases into shared memory,
// then layer 0's input into x.
template <typename Act>
__device__ void load_tile(const Chain& ch, const Smem<Act>& s,
                          const float* __restrict__ emb,
                          const float* __restrict__ dists,
                          const float* __restrict__ extra,
                          const float* __restrict__ bias, long long r0,
                          long long n) {
  for (int c = threadIdx.x; c < ch.btot; c += kThreads) s.bias[c] = bias[c];
  for (int r = threadIdx.x / 32; r < kT; r += kWarps)
    for (int c = threadIdx.x % 32; c < ch.rawld; c += 32) {
      const long long row = r0 + r;
      float v = 0.f;
      if (row < n) {
        if (c < ch.de)
          v = emb[row * ch.de + c];
        else if (c < ch.de + ch.dd)
          v = dists[row * ch.dd + c - ch.de];
        else
          v = extra[row * ch.ce + c - ch.de - ch.dd];
      }
      s.raw[r * ch.rawld + c] = v;
    }
  __syncthreads();
  // layer 0's input: emb, the sin/cos pairs of emb * 2^j (pair d * fe + j
  // at columns de + 2 pair, + 1), the same of dists (or dists raw), zeros
  const int npe = ch.fe * ch.de, npd = ch.fd ? ch.fd * ch.dd : ch.dd;
  const int items = ch.de + npe + npd + (ch.layer[0].kp - ch.c1);
  for (int r = threadIdx.x / 32; r < kT; r += kWarps) {
    const float* raw = s.raw + r * ch.rawld;
    Act* x = s.x + r * ch.xld;
    for (int it = threadIdx.x % 32; it < items; it += 32) {
      int p = it - ch.de;
      if (p < 0) {
        x[it] = from_f<Act>(raw[it]);
        continue;
      }
      float sn, cs;
      if (p < npe) {
        const int d = p / ch.fe, j = p - d * ch.fe;
        sincosf(raw[d] * (float)(1 << j), &sn, &cs);
        x[ch.de + 2 * p] = from_f<Act>(sn);
        x[ch.de + 2 * p + 1] = from_f<Act>(cs);
        continue;
      }
      p -= npe;
      const int base = ch.de + 2 * npe;
      if (p >= npd) {
        x[ch.c1 + p - npd] = from_f<Act>(0.f);
      } else if (ch.fd == 0) {
        x[base + p] = from_f<Act>(raw[ch.de + p]);
      } else {
        const int d = p / ch.fd, j = p - d * ch.fd;
        sincosf(raw[ch.de + d] * (float)(1 << j), &sn, &cs);
        x[base + 2 * p] = from_f<Act>(sn);
        x[base + 2 * p + 1] = from_f<Act>(cs);
      }
    }
  }
  __syncthreads();
}

// Epilogue of forward layer l: bias, leaky ReLU (all but the last layer),
// feat / alpha out, and the next layer's input into x.
template <typename Act>
__device__ void forward_epilogue(const Chain& ch, const Smem<Act>& s, int l,
                                 long long r0, long long n, float* feat,
                                 float* alpha) {
  const Layer& ly = ch.layer[l];
  const bool last = l == ch.L - 1;
  const bool is_feat = l == ch.na + ch.nb - 1;
  const int wfill = last ? ly.np : ch.layer[l + 1].kp;
  // a lane owns a column across a warp's rows: its bias is read once
  for (int c = threadIdx.x % 32; c < wfill; c += 32) {
    const bool out = c < ly.np;
    const bool tail = !out && l + 1 == ch.na && c - ly.np < ch.ce;
    const float b = out ? s.bias[ly.boff + c] : 0.f;
#pragma unroll
    for (int r = threadIdx.x / 32; r < kT; r += kWarps) {
      const long long row = r0 + r;
      float v = 0.f;
      if (out) {
        v = s.c[r * ch.cld + c] + b;
        if (!last) v = lrelu(v);
        if (row < n && c < ly.nreal) {
          if (is_feat && feat) feat[row * ly.nreal + c] = v;
          if (last && alpha) alpha[row * ly.nreal + c] = v;
        }
      } else if (tail) {
        v = s.raw[r * ch.rawld + ch.de + ch.dd + (c - ly.np)];
      }
      if (!last) s.x[r * ch.xld + c] = from_f<Act>(v);
    }
  }
  __syncthreads();
}

// The same for bf16 from the product's accumulators (the layer's whole
// width in one pass), at its last step: no f32 round trip through shared
// memory.
__device__ void forward_epilogue_regs(const Chain& ch,
                                      const Smem<__nv_bfloat16>& s, int l,
                                      long long r0, long long n, float* feat,
                                      float* alpha, const MmaBf16& m,
                                      int nb) {
  const Layer& ly = ch.layer[l];
  const bool last = l == ch.L - 1;
  float* out = l == ch.na + ch.nb - 1 ? feat : (last ? alpha : nullptr);
  const int warp = threadIdx.x / 32, rt = warp & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncthreads();  // every warp is done reading x
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ct = (warp >> 2) + 4 * j;
    if (ct * 16 >= nb) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = ct * 16 + h * 8 + 2 * t;
      const float b0 = s.bias[ly.boff + c], b1 = s.bias[ly.boff + c + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rt * 16 + g + 8 * half;
        float v0 = m.acc[j][h][2 * half] + b0;
        float v1 = m.acc[j][h][2 * half + 1] + b1;
        if (!last) {
          v0 = lrelu(v0);
          v1 = lrelu(v1);
        }
        const long long row = r0 + r;
        if (out && row < n) {
          if (c < ly.nreal) out[row * ly.nreal + c] = v0;
          if (c + 1 < ly.nreal) out[row * ly.nreal + c + 1] = v1;
        }
        if (!last)
          *reinterpret_cast<__nv_bfloat162*>(s.x + r * ch.xld + c) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  if (last) return;
  // the next layer's input past this output: block3's extra columns, zeros
  for (int r = warp; r < kT; r += kWarps)
    for (int c = ly.np + lane; c < ch.layer[l + 1].kp; c += 32)
      s.x[r * ch.xld + c] = __float2bfloat16(
          l + 1 == ch.na && c - ly.np < ch.ce
              ? s.raw[r * ch.rawld + ch.de + ch.dd + (c - ly.np)]
              : 0.f);
}

// Forward layer l of the tile: the product, then its epilogue.
template <typename Act>
__device__ void forward_layer(const Chain& ch, const Smem<Act>& s, int l,
                              const Act* __restrict__ w, long long r0,
                              long long n, float* feat, float* alpha) {
  const Layer& ly = ch.layer[l];
  if constexpr (sizeof(Act) == 2) {
    block_mm(s.x, ch.xld, ly.kp, w + ly.woff, ly.np, s.w,
             [&](const MmaBf16& m, int, int nb) {
               forward_epilogue_regs(ch, s, l, r0, n, feat, alpha, m, nb);
             });
  } else {
    block_mm(s.x, ch.xld, ly.kp, w + ly.woff, ly.np, s.w,
             [&](MmaF32& m, int n0, int nb) {
               m.store(s.c, ch.cld, n0, nb);
             });
    forward_epilogue(ch, s, l, r0, n, feat, alpha);
  }
}

template <typename Act>
__global__ void __launch_bounds__(kThreads)
chain_fwd(Chain ch, const float* __restrict__ emb,
          const float* __restrict__ dists, const float* __restrict__ extra,
          const Act* __restrict__ w, const float* __restrict__ bias,
          long long n, float* __restrict__ feat, float* __restrict__ alpha) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<Act> s(smem, ch);
  const long long r0 = (long long)blockIdx.x * kT;
  load_tile(ch, s, emb, dists, extra, bias, r0, n);
  for (int l = 0; l < ch.L; ++l)
    forward_layer(ch, s, l, w, r0, n, feat, alpha);
}

template <typename Act>
__global__ void __launch_bounds__(kThreads)
chain_bwd(Chain ch, const float* __restrict__ emb,
          const float* __restrict__ dists, const float* __restrict__ extra,
          const float* __restrict__ dfeat, const float* __restrict__ dalpha,
          const Act* __restrict__ w, const float* __restrict__ bias,
          long long n, Act* __restrict__ ascr, Act* __restrict__ gscr,
          float* __restrict__ dbpart, float* __restrict__ demb,
          float* __restrict__ ddists, float* __restrict__ dextra) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<Act> s(smem, ch);
  const long long r0 = (long long)blockIdx.x * kT;
  load_tile(ch, s, emb, dists, extra, bias, r0, n);

  // forward again; every layer's input to the A scratch
  for (int l = 0; l < ch.L; ++l) {
    const Layer& ly = ch.layer[l];
    for (int r = threadIdx.x / 32; r < kT; r += kWarps)
      for (int c = threadIdx.x % 32; c < ly.kp; c += 32) {
        ascr[(r0 + r) * ch.atot + ly.aoff + c] = s.x[r * ch.xld + c];
      }
    if (l == ch.L - 1) break;
    forward_layer<Act>(ch, s, l, w, r0, n, nullptr, nullptr);
  }

  // the cotangent of the head's last (linear) layer
  {
    const Layer& ly = ch.layer[ch.L - 1];
    for (int r = threadIdx.x / 32; r < kT; r += kWarps)
      for (int c = threadIdx.x % 32; c < ly.np; c += 32) {
        const long long row = r0 + r;
        s.c[r * ch.cld + c] =
            (row < n && c < ly.nreal) ? dalpha[row * ly.nreal + c] : 0.f;
      }
    __syncthreads();
  }

  // reverse sweep: s.c holds g (f32, masked) of layer i's output
  for (int i = ch.L - 1; i >= 0; --i) {
    const Layer& ly = ch.layer[i];
    for (int c = threadIdx.x; c < ly.np; c += kThreads) {
      float sum = 0.f;
      for (int r = 0; r < kT; ++r) sum += s.c[r * ch.cld + c];
      dbpart[(long long)blockIdx.x * ch.btot + ly.boff + c] = sum;
    }
    for (int r = threadIdx.x / 32; r < kT; r += kWarps)
      for (int c = threadIdx.x % 32; c < ly.np; c += 32) {
        const Act g = from_f<Act>(s.c[r * ch.cld + c]);
        s.x[r * ch.xld + c] = g;
        gscr[(r0 + r) * ch.gtot + ly.goff + c] = g;
      }
    __syncthreads();
    // dX = G W^T: the packed W^T is [np, kp]
    block_mm(s.x, ch.xld, ly.np, w + ly.wtoff, ly.kp, s.w,
             [&](Mma<Act>& m, int n0, int nb) {
               m.store(s.c, ch.cld, n0, nb);
             });
    if (i == 0) break;
    const Layer& pv = ch.layer[i - 1];
    const bool head_bottom = i == ch.na + ch.nb;
    for (int c = threadIdx.x % 32; c < ly.kp; c += 32) {
#pragma unroll
      for (int r = threadIdx.x / 32; r < kT; r += kWarps) {
        const long long row = r0 + r;
        float v = s.c[r * ch.cld + c];
        if (c < pv.np) {
          if (head_bottom && c < pv.nreal && row < n)
            v += dfeat[row * pv.nreal + c];
          // dlrelu of layer i-1 from the sign of its output, layer i's input
          const float a = to_f(ascr[(r0 + r) * ch.atot + ly.aoff + c]);
          v *= signbit(a) ? kSlope : 1.f;
          s.c[r * ch.cld + c] = v;
        } else if (i == ch.na && c - pv.np < ch.ce) {
          if (row < n) dextra[row * ch.ce + (c - pv.np)] = v;
        }
      }
    }
    __syncthreads();
  }

  // PE backward: s.c holds d x1 in the block1 input layout
  const int nraw = ch.de + ch.dd;
  for (int r = threadIdx.x / 32; r < kT; r += kWarps)
    for (int j = threadIdx.x % 32; j < nraw; j += 32) {
      const long long row = r0 + r;
      if (row >= n) continue;
      const float* dx = s.c + r * ch.cld;
      const float* raw = s.raw + r * ch.rawld;
      // as the TPU kernel's _pe_backward: the raw part, then the sin terms
      // band by band, then the cos terms
      const bool is_emb = j < ch.de;
      const int d = is_emb ? j : j - ch.de;
      const int nf = is_emb ? ch.fe : ch.fd;
      const int off = is_emb ? ch.de + 2 * d * ch.fe
                             : ch.de + 2 * ch.fe * ch.de + 2 * d * ch.fd;
      const float x = is_emb ? raw[d] : raw[ch.de + d];
      float v = is_emb ? dx[d]
                       : (ch.fd == 0 ? dx[ch.de + 2 * ch.fe * ch.de + d] : 0.f);
      float sn, cs;
      for (int f = 0; f < nf; ++f) {
        sincosf(x * (float)(1 << f), &sn, &cs);
        v += ((float)(1 << f) * cs) * dx[off + 2 * f];
      }
      for (int f = 0; f < nf; ++f) {
        sincosf(x * (float)(1 << f), &sn, &cs);
        v -= ((float)(1 << f) * sn) * dx[off + 2 * f + 1];
      }
      if (is_emb)
        demb[row * ch.de + d] = v;
      else
        ddists[row * ch.dd + d] = v;
    }
}

// Which layer and which kDwCols columns of its dW a block computes.
__device__ bool dw_tile(const Chain& ch, int t, int* l, int* n0) {
  for (int i = 0; i < ch.L; ++i) {
    const int nt = (ch.layer[i].np + kDwCols - 1) / kDwCols;
    if (t < nt) {
      *l = i;
      *n0 = t * kDwCols;
      return true;
    }
    t -= nt;
  }
  return false;
}

// One chunk of rows' share of dW[:, n0:n0+kDwCols] = A^T G (bf16): rows of
// A and G stream through a shared-memory ring by cp.async, kDwRows rows a
// step; warp w holds column tile w % 8 and row tiles w / 8 + 2 j of up to
// kDwM rows of dW in f32 accumulators.
__device__ void dw_product(const Chain& ch, const __nv_bfloat16* ascr,
                           const __nv_bfloat16* gscr, const Layer& ly, int n0,
                           long long lo, long long hi, float* out,
                           __nv_bfloat16* ring) {
  constexpr int kJ = kDwM / 16 / 2;  // row tiles a warp holds
  constexpr int kAld = kDwM + kSkew, kGld = kDwCols + kSkew;
  constexpr int kStage = kDwRows * (kAld + kGld);
  const int warp = threadIdx.x / 32, ct = warp % 8, mbase = warp / 8;
  const int nb = min(kDwCols, ly.np - n0);
  const int steps = (int)((hi - lo) / kDwRows);
  for (int mb = 0; mb < ly.kp; mb += kDwM) {
    const int mrows = min(kDwM, ly.kp - mb);
    auto issue = [&](int s) {
      if (s < steps) {
        __nv_bfloat16* st = ring + (s % kStages) * kStage;
        const long long r0 = lo + (long long)s * kDwRows;
        const int va = mrows / 8, vg = nb / 8;
        for (int i = threadIdx.x; i < kDwRows * (va + vg); i += kThreads) {
          const int r = i / (va + vg), v = i - r * (va + vg);
          if (v < va)
            cp_async16(st + r * kAld + v * 8,
                       ascr + (r0 + r) * ch.atot + ly.aoff + mb + v * 8);
          else
            cp_async16(st + kDwRows * kAld + r * kGld + (v - va) * 8,
                       gscr + (r0 + r) * ch.gtot + ly.goff + n0 +
                           (v - va) * 8);
        }
      }
      cp_async_commit();
    };
    float acc[kJ][2][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][e / 4][e % 4] = 0.f;
    __syncthreads();
    for (int s = 0; s < kStages - 1; ++s) issue(s);
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      issue(s + kStages - 1);
      const __nv_bfloat16* st = ring + (s % kStages) * kStage;
      if (ct * 16 >= nb) continue;
#pragma unroll
      for (int kk = 0; kk < kDwRows; kk += 16) {
        unsigned b[4];
        load_b(b, st + kDwRows * kAld + kk * kGld + ct * 16, kGld);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int mt = mbase + 2 * j;
          if (mt * 16 < mrows) {
            unsigned a[4];
            load_a_t(a, st + kk * kAld + mt * 16, kAld);
            mma_bf16(acc[j][0], a, b[0], b[1]);
            mma_bf16(acc[j][1], a, b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    if (ct * 16 < nb) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int mt = mbase + 2 * j;
        if (mt * 16 < mrows)
          store_acc(out + ly.woff + (size_t)(mb + mt * 16) * ly.np + n0 +
                        ct * 16,
                    ly.np, acc[j]);
      }
    }
  }
}

// f32 (the small test presets only): a thread owns one column and every
// eighth row of a 64-row slice of dW, straight from the scratch buffers.
__device__ void dw_product(const Chain& ch, const float* ascr,
                           const float* gscr, const Layer& ly, int n0,
                           long long lo, long long hi, float* out, float*) {
  constexpr int kStride = kThreads / kDwCols;  // 4
  constexpr int kPer = 64 / kStride;
  const int tn = threadIdx.x % kDwCols, tm = threadIdx.x / kDwCols;
  const int nn = n0 + tn;
  if (nn >= ly.np) return;
  for (int m0 = 0; m0 < ly.kp; m0 += 64) {
    float acc[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
    for (long long r = lo; r < hi; ++r) {
      const float g = gscr[r * ch.gtot + ly.goff + nn];
      const float* a = ascr + r * ch.atot + ly.aoff + m0 + tm;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (m0 + tm + kStride * j < ly.kp) acc[j] += a[kStride * j] * g;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (m0 + tm + kStride * j < ly.kp)
        out[ly.woff + (size_t)(m0 + tm + kStride * j) * ly.np + nn] = acc[j];
  }
}

template <typename Act>
__host__ __device__ constexpr size_t dw_smem() {
  return sizeof(Act) == 2
             ? sizeof(Act) * kStages * kDwRows *
                   (kDwM + kSkew + kDwCols + kSkew)
             : 0;
}

// grid (dW column tiles + db tiles, chunks): partial[chunk] = this chunk's
// dW | db.
template <typename Act>
__global__ void __launch_bounds__(kThreads)
chain_dw(Chain ch, const Act* __restrict__ ascr, const Act* __restrict__ gscr,
         const float* __restrict__ dbpart, long long npad, int chunk_rows,
         int w_tiles, float* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long lo = (long long)blockIdx.y * chunk_rows;
  const long long hi = min(npad, lo + chunk_rows);
  float* out = partial + (size_t)blockIdx.y * (ch.wtot + ch.btot);
  const int t = blockIdx.x;
  if (t < w_tiles) {
    int l, n0;
    if (dw_tile(ch, t, &l, &n0))
      dw_product(ch, ascr, gscr, ch.layer[l], n0, lo, hi, out,
                 reinterpret_cast<Act*>(smem));
    return;
  }
  const int c = (t - w_tiles) * kThreads + threadIdx.x;
  if (c >= ch.btot) return;
  float sum = 0.f;
  for (long long b = lo / kT; b < hi / kT; ++b) sum += dbpart[b * ch.btot + c];
  out[ch.wtot + c] = sum;
}

// out[c] = sum over k of partial[k, c], k in order.
__global__ void __launch_bounds__(kThreads)
chain_reduce(const float* __restrict__ partial, int chunks, long long width,
             float* __restrict__ out) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= width) return;
  float sum = 0.f;
  for (int k = 0; k < chunks; ++k) sum += partial[k * width + c];
  out[c] = sum;
}

// The Chain of `meta`; false if it is not one the kernels take.
bool read_meta(const int* meta, Chain* ch) {
  ch->L = meta[0];
  ch->na = meta[1];
  ch->nb = meta[2];
  ch->de = meta[3];
  ch->dd = meta[4];
  ch->ce = meta[5];
  ch->fe = meta[6];
  ch->fd = meta[7];
  ch->c1 = meta[8];
  ch->atot = meta[9];
  ch->gtot = meta[10];
  ch->btot = meta[11];
  ch->wtot = meta[12];
  if (ch->L < 3 || ch->L > kMaxLayers || ch->na < 1 || ch->nb < 1 ||
      ch->na + ch->nb >= ch->L || ch->fe > 20 || ch->fd > 20)
    return false;
  int widest = 0;
  for (int i = 0; i < ch->L; ++i) {
    const int* m = meta + kHead + kPerLayer * i;
    Layer& ly = ch->layer[i];
    ly.kp = m[0];
    ly.np = m[1];
    ly.nreal = m[2];
    ly.woff = m[3];
    ly.wtoff = m[4];
    ly.boff = m[5];
    ly.aoff = m[6];
    ly.goff = m[7];
    if (ly.kp < 16 || ly.np < 16 || ly.np > kNB || ly.kp % 16 || ly.np % 16 ||
        ly.woff % 16 || ly.wtoff % 16 || ly.aoff % 16 || ly.goff % 16)
      return false;
    widest = ly.kp > widest ? ly.kp : widest;
    widest = ly.np > widest ? ly.np : widest;
  }
  ch->xld = widest + kSkew;
  ch->cld = widest + 4;
  ch->rawld = ch->de + ch->dd + ch->ce;
  return ch->atot % 16 == 0 && ch->gtot % 16 == 0;
}

template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename Act>
cudaError_t fwd(const Chain& ch, const void* emb, const void* dists,
                const void* extra, const void* w, const void* bias,
                long long n, void* feat, void* alpha, cudaStream_t st) {
  const size_t bytes = Smem<Act>::bytes(ch);
  cudaError_t e = prepare(chain_fwd<Act>, bytes);
  if (e != cudaSuccess) return e;
  chain_fwd<Act><<<(unsigned)((n + kT - 1) / kT), kThreads, bytes, st>>>(
      ch, (const float*)emb, (const float*)dists, (const float*)extra,
      (const Act*)w, (const float*)bias, n, (float*)feat, (float*)alpha);
  return cudaGetLastError();
}

template <typename Act>
cudaError_t bwd(const Chain& ch, const void* emb, const void* dists,
                const void* extra, const void* dfeat, const void* dalpha,
                const void* w, const void* bias, long long n, void* ascr,
                void* gscr, void* dbpart, void* demb, void* ddists,
                void* dextra, cudaStream_t st) {
  const size_t bytes = Smem<Act>::bytes(ch);
  cudaError_t e = prepare(chain_bwd<Act>, bytes);
  if (e != cudaSuccess) return e;
  chain_bwd<Act><<<(unsigned)((n + kT - 1) / kT), kThreads, bytes, st>>>(
      ch, (const float*)emb, (const float*)dists, (const float*)extra,
      (const float*)dfeat, (const float*)dalpha, (const Act*)w,
      (const float*)bias, n, (Act*)ascr, (Act*)gscr, (float*)dbpart,
      (float*)demb, (float*)ddists, (float*)dextra);
  return cudaGetLastError();
}

int w_tiles(const Chain& ch) {
  int t = 0;
  for (int i = 0; i < ch.L; ++i)
    t += (ch.layer[i].np + kDwCols - 1) / kDwCols;
  return t;
}

}  // namespace

// Each function returns a cudaError_t value: 0 on a successful launch.  The
// launches are asynchronous on `stream`.  dtype 1 is bf16 (weights and
// scratch bf16), 0 is float32.  A chain the kernels do not take (a layer
// wider than kNB columns, tiles beyond kMaxSmem of shared memory) returns
// cudaErrorInvalidValue.  The wrapper (ops/shading_chain.py) checks
// devices, types and contiguity and allocates every buffer.

// feat [n, F] f32 and alpha [n, H] f32 of emb [n, de], dists [n, dd] and
// extra [n, ce] (f32); w the packed weights, bias the packed f32 biases.
extern "C" int chain_fwd_launch(const int* meta, int dtype, const void* emb,
                                const void* dists, const void* extra,
                                const void* w, const void* bias, long long n,
                                void* feat, void* alpha, void* stream) {
  Chain ch;
  if (!read_meta(meta, &ch) || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype ? fwd<__nv_bfloat16>(ch, emb, dists, extra, w, bias, n,
                                          feat, alpha, st)
                     : fwd<float>(ch, emb, dists, extra, w, bias, n, feat,
                                  alpha, st));
}

// The recompute backward over rows padded to a multiple of 64: d_emb,
// d_dists, d_extra, the scratch A [npad, atot] and G [npad, gtot], and the
// per-tile db partials [npad / 64, btot].
extern "C" int chain_bwd_launch(const int* meta, int dtype, const void* emb,
                                const void* dists, const void* extra,
                                const void* dfeat, const void* dalpha,
                                const void* w, const void* bias, long long n,
                                void* ascr, void* gscr, void* dbpart,
                                void* demb, void* ddists, void* dextra,
                                void* stream) {
  Chain ch;
  if (!read_meta(meta, &ch) || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype ? bwd<__nv_bfloat16>(ch, emb, dists, extra, dfeat,
                                          dalpha, w, bias, n, ascr, gscr,
                                          dbpart, demb, ddists, dextra, st)
                     : bwd<float>(ch, emb, dists, extra, dfeat, dalpha, w,
                                  bias, n, ascr, gscr, dbpart, demb, ddists,
                                  dextra, st));
}

// grad [wtot + btot] = every dW and db, from the scratch A and G and the
// per-tile db partials of chain_bwd: each chunk of chunk_rows rows into
// partial [chunks, wtot + btot] (chain_dw), then the chunks summed in order
// (chain_reduce).
extern "C" int chain_dw_launch(const int* meta, int dtype, const void* ascr,
                               const void* gscr, const void* dbpart,
                               long long npad, int chunk_rows, int chunks,
                               void* partial, void* grad, void* stream) {
  Chain ch;
  if (!read_meta(meta, &ch) || npad <= 0 || npad % kT ||
      chunk_rows <= 0 || chunk_rows % kT ||
      (long long)chunks * chunk_rows < npad ||
      (long long)(chunks - 1) * chunk_rows >= npad)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int wt = w_tiles(ch);
  const dim3 grid(wt + (ch.btot + kThreads - 1) / kThreads, chunks);
  cudaError_t e;
  if (dtype) {
    constexpr size_t bytes = dw_smem<__nv_bfloat16>();
    e = prepare(chain_dw<__nv_bfloat16>, bytes);
    if (e != cudaSuccess) return (int)e;
    chain_dw<__nv_bfloat16><<<grid, kThreads, bytes, st>>>(
        ch, (const __nv_bfloat16*)ascr, (const __nv_bfloat16*)gscr,
        (const float*)dbpart, npad, chunk_rows, wt, (float*)partial);
  } else {
    chain_dw<float><<<grid, kThreads, 0, st>>>(
        ch, (const float*)ascr, (const float*)gscr, (const float*)dbpart,
        npad, chunk_rows, wt, (float*)partial);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long width = (long long)ch.wtot + ch.btot;
  chain_reduce<<<(unsigned)((width + kThreads - 1) / kThreads), kThreads, 0,
                 st>>>((const float*)partial, chunks, width, (float*)grad);
  return (int)cudaGetLastError();
}
