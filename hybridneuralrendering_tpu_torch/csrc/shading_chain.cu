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
// What bounds them on an H100.  At the scannet_full widths a row costs
// 271,360 multiply-adds forward (block1 284->256->256, block3
// 263->256->256, head 256->1); at the bf16 tensor-core peak of 989 TFLOP/s
// chain_fwd takes at least 1.726 ms for a serving chunk of 3,145,728 rows
// and 0.330 ms for a step's 602,112, chain_bwd (the recompute and the dX
// products, twice the forward's) 0.661 ms: operations bound both (the
// forward's bytes, raw inputs in and feat f32 out, about 3.8 GB at 3.1M
// rows, would take 1.13 ms).  chain_dw is bound by bytes: its products
// take 0.330 ms, but reading its inputs once, the bf16 A / G scratch
// (1,328 + 1,040 columns, 2.852 GB at 602,112 rows) and the db partials
// (39 MB), takes 0.863 ms at 3.35 TB/s.
//
// bf16 chain_fwd and chain_bwd (the scannet_full path), built for Hopper:
//   persistent    a grid of at most one block per SM; block b takes the
//                 128-row tiles b, b + grid, ... so each tile, and every
//                 sum, is the same whatever the timing.  A block is one
//                 producer warpgroup (registers lowered with setmaxnreg; one
//                 thread works) and two consumer warpgroups, each owning 64
//                 of the tile's rows.
//   weight ring   the producer streams the weights through three 32 KB
//                 stages of shared memory, one cp.async.bulk per stage on
//                 full / empty mbarriers, running ahead across layers and
//                 tiles; no block-wide barrier anywhere in the loop.  Both
//                 consumers read the same stage, so the weights are read
//                 from L2 once per 128 rows (kept there: evict-last).
//                 ops/shading_chain.stage_images lays every chunk out once
//                 per call as the exact shared-memory image wgmma reads
//                 (K-major, 128-byte swizzle, 64 K rows by 256 or 32 output
//                 columns), so a stage is one 1-D bulk copy and needs no
//                 tensor map.
//   products      wgmma.mma_async m64n256k16 (m64n32k16 for a pass of at
//                 most 32 columns), bf16 operands from shared memory, f32
//                 accumulators in registers (128 a thread), a stage's
//                 k-steps issued as one batch and the next stage's issued
//                 before the previous one is waited for.  The left operand
//                 is the warpgroup's activation buffer.  An output wider
//                 than 256 columns (the backward's dX of the layers with 272
//                 and 288 inputs) is a 32-column pass, then a 256-column
//                 one.  The head (256 -> 1, padded to 16) is a 32-column
//                 pass: one product routine, and its 4 KB stages cost little.
//                 The first k-step of a pass writes the accumulators without
//                 reading them, and nothing else writes them, so ptxas keeps
//                 the wgmma pipeline (no serialization).
//   epilogues     from the accumulators: bias, leaky ReLU, feat f32 to
//                 global memory in 8-byte stores, the next layer's bf16
//                 input into the buffer by stmatrix (16 columns of a warp's
//                 rows a store, in the swizzled layout the next descriptor
//                 reads), block3's extra columns and zero padding from the
//                 raw tile; warpgroup-local named barriers and a proxy fence
//                 before the next product.  The PE is expanded from a
//                 per-column plan, 8 columns a 16-byte store, with sincosf
//                 (not __sinf: the dist bands reach 2^4 * d); the next
//                 tile's raw rows are prefetched into L2 at the tile's start
//                 and copied by cp.async once block3's extra columns are
//                 read.
//   chain_bwd     the forward again through the same product and epilogue
//                 code (its bf16 activations are the forward's bit for bit),
//                 each layer's input copied to the A scratch in 16-byte
//                 stores and the leaky-ReLU signs kept on chip as a bit mask
//                 (each thread's own 128 bits a layer); then the reverse
//                 sweep, the accumulators only read: g of a layer formed from
//                 the dX accumulators (+ dfeat at the head's bottom, x the
//                 slope from the mask), written as G = bf16(g) into the
//                 buffer by stmatrix and to the G scratch in 16-byte stores,
//                 its db partial per 64 rows (shuffles, then the four warps
//                 in order), dX = G W^T on wgmma with W^T stages from the
//                 ring, the d_extra split at block3's bottom, and the PE
//                 backward from layer 0's dX, staged in f32 32 rows at a
//                 time, each of its first 8 bands' sincosf computed once.
// What it still costs: the consumers' CUDA-core work is not overlapped
// with the tensor cores (both consumers reach their epilogues together):
// forward, the PE expansion and the epilogues take longer than the
// products; backward also the PE backward, the scratch stores and the dfeat
// loads (from device memory, at the head's bottom).  PERF.md has the times
// by phase.  Each 128-row tile streams 592 KB of stage images
// from L2 forward (1,152 KB backward), about 14.9 GB per serving chunk.
// Writing the backward's A / G scratch (2.852 GB at 602,112 rows) takes
// chain_bwd at least 0.85 ms at 3.35 TB/s, and reading it back chain_dw as
// much: a floor of this design.  The TPU kernel sums dW on chip instead
// (its grid runs in order, VMEM carries the sums); on Hopper every
// persistent block would need its own f32 copy of every dW, 1.1 MB, five
// times an SM's shared memory, so the scratch stays and chain_dw reads it
// once.
//
// bf16 chain_dw (hop::dw_hop), a split-K GEMM dW_l = A_l^T G_l over the
// rows, in two launches:
//   plan          ops/shading_chain.dw_plan, from the shapes alone: an item
//                 is 128 dW rows of one layer (its input columns; the last
//                 slab of block1's 288 and block3's 272 is 32 and 16 rows),
//                 all its columns, over one row split; 12 items a split at
//                 scannet_full, 11 splits (132 items, one wave of an H100's
//                 132 SMs).  The splits, not the card's SM count, fix every
//                 sum's order: two launches give the same bits.
//   persistent    a grid of at most one block per SM; block b takes items
//                 b, b + grid, ...; items of one split and layer have
//                 neighbouring indices, run side by side, and read the same
//                 G rows at about the same time, so G's second and third
//                 reads can come from L2.
//   loads         one producer thread streams 64-row stages by TMA (2-D
//                 tensor maps over A and G, 64 x 64 boxes, 128-byte swizzle,
//                 encoded through the runtime's driver entry point): G's 256
//                 columns (32 KB; the head's 64, zero-filled past the
//                 scratch) then the item's 128 A columns (16 KB,
//                 evict-first), into a ring of three 48 KB stages on full /
//                 empty mbarriers; no block-wide barrier.  (Four stages, a
//                 256-byte L2 promotion or A's boxes first each ran slower on
//                 an H100.)  A slab's columns past its layer (the 32- and
//                 16-row tails) read the next layer's, whose rows of the
//                 product are dropped (both warpgroups run every item: a
//                 branch on the warpgroup around the wgmmas made ptxas
//                 serialize them).
//   products      two consumer warpgroups, 64 dW rows each, all 256 (or 64)
//                 columns in f32 registers for the whole item:
//                 wgmma.mma_async m64n256k16 (m64n64k16 for the head's 16),
//                 both operands MN-major from shared memory (the scratch row
//                 is the reduction dimension), four k-steps a stage, the next
//                 stage's issued before the previous one is waited for.
//   db            the producer warpgroup's other three warps sum the split's
//                 per-64-row db partials in row order, a share of the
//                 columns per item.
//   reduce        partial [splits, dW | db] (12.3 MB at 11 splits), summed
//                 over the splits in order by chain_reduce.
// What it still costs: each 64-row stage moves 528 KB from L2 into the
// SMs for 303 KB of scratch (G is read once per 128 dW rows, the tails read
// 128 A columns for 32 or 16, the head 64 G columns for 16), and items
// that finish early (the head's) leave their SMs idle.  The tensor cores
// cut, not round, each k-step's sum into the f32 accumulator, so dW's error
// grows with a split's k-steps: about 6e-5 relative at 602,112 rows (3,424
// k-steps), against about 5e-3 from the bf16 scratch itself.
// float32 (the small test presets and shading_dtype="float32"): the first
//                design, one 512-thread block per 64-row tile, the weights
//                through a cp.async ring with a barrier per chunk, products
//                on the CUDA cores through an f32 shared buffer; chain_dw
//                one chunk of 4,096 rows and 128 dW columns a block, then
//                chain_reduce over the chunks.
// No atomics: two launches give the same bits.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (hybridneuralrendering_tpu_torch/ops/build.py); the wrapper is
// hybridneuralrendering_tpu_torch/ops/shading_chain.py, which also computes
// the packed layout that `meta` describes and the bf16 stage images.

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;         // rows per tile (f32 kernels, chain_dw, db)
constexpr int kThreads = 512;  // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kNB = 256;       // output columns per pass
constexpr int kSkew = 8;       // extra elements per shared row
constexpr int kMaxLayers = 16;
constexpr int kRowsPerThread = kT * kNB / kThreads;  // f32 product: 32
constexpr int kDwCols = 128;   // dW columns a float32 chain_dw block computes
constexpr int kF32ChunkRows = 4096;  // rows of a float32 chain_dw partial sum
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

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : kSlope * v;
}

__host__ __device__ __forceinline__ size_t align128(size_t b) {
  return (b + 127) & ~size_t(127);
}

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

// ------------------------------------------------ float32 chain_fwd, chain_bwd

// The weights stream through a ring of kStages chunks of kKc rows by kNB
// columns.
constexpr int kStages = 3;
constexpr int kKc = 16;
constexpr int kWld = kNB + kSkew;  // leading dimension of a staged chunk

struct Smem {
  float* x;    // [kT, xld]  the current product's left operand
  float* c;    // [kT, cld]  the current product's f32 result
  float* w;    // [kStages, kKc, kWld] ring of staged weight chunks
  float* raw;  // [kT, rawld] emb | dists | extra of the tile
  float* bias; // [btot] every layer's bias

  __host__ __device__ static size_t bytes(const Chain& ch) {
    return align128(sizeof(float) * kT * ch.xld) +
           align128(sizeof(float) * kT * ch.cld) +
           align128(sizeof(float) * kStages * kKc * kWld) +
           align128(sizeof(float) * kT * ch.rawld) +
           align128(sizeof(float) * ch.btot);
  }
  __device__ Smem(unsigned char* base, const Chain& ch) {
    x = reinterpret_cast<float*>(base);
    base += align128(sizeof(float) * kT * ch.xld);
    c = reinterpret_cast<float*>(base);
    base += align128(sizeof(float) * kT * ch.cld);
    w = reinterpret_cast<float*>(base);
    base += align128(sizeof(float) * kStages * kKc * kWld);
    raw = reinterpret_cast<float*>(base);
    base += align128(sizeof(float) * kT * ch.rawld);
    bias = reinterpret_cast<float*>(base);
  }
};

// Start copying W[k0:k0+kc, n0:n0+nb] (row-major, leading dimension N) into
// a ring slot.  kc, nb and N are multiples of 16; rows start 16-byte
// aligned.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ W,
                                            int N, int k0, int kc, int n0,
                                            int nb, float* slot) {
  constexpr int per = 4;
  const int vpr = nb / per;
  for (int i = threadIdx.x; i < kc * vpr; i += kThreads) {
    const int r = i / vpr, v = i - r * vpr;
    cp_async16(slot + r * kWld + v * per,
               W + (size_t)(k0 + r) * N + n0 + v * per);
  }
}

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

// X[kT, K] @ W[K, N] for the tile into C; K and N multiples of 16.  The
// product runs as steps of (pass of kNB columns, chunk of kKc rows); the
// weight chunks stream through the ring by cp.async, kStages - 1 steps
// ahead of the one being multiplied, across the pass boundaries.  Begins and
// ends with a barrier.
__device__ void block_mm(const float* X, int xld, int K,
                         const float* __restrict__ W, int N, float* ring,
                         float* C, int cld) {
  constexpr int S = kStages, KC = kKc;
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
  MmaF32 m;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk s is in; every thread is done with s - 1
    issue(s + S - 1);
    const int n0 = (s / nch) * kNB, k0 = (s % nch) * KC;
    const int nb = min(kNB, N - n0);
    if (k0 == 0) m.zero();
    m.chunk(X, xld, k0, min(KC, K - k0), ring + (s % S) * KC * kWld, nb);
    if (s % nch == nch - 1) m.store(C, cld, n0, nb);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The tile's raw rows (zeros past n) and the biases into shared memory,
// then layer 0's input into x.
__device__ void load_tile(const Chain& ch, const Smem& s,
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
    float* x = s.x + r * ch.xld;
    for (int it = threadIdx.x % 32; it < items; it += 32) {
      int p = it - ch.de;
      if (p < 0) {
        x[it] = raw[it];
        continue;
      }
      float sn, cs;
      if (p < npe) {
        const int d = p / ch.fe, j = p - d * ch.fe;
        sincosf(raw[d] * (float)(1 << j), &sn, &cs);
        x[ch.de + 2 * p] = sn;
        x[ch.de + 2 * p + 1] = cs;
        continue;
      }
      p -= npe;
      const int base = ch.de + 2 * npe;
      if (p >= npd) {
        x[ch.c1 + p - npd] = 0.f;
      } else if (ch.fd == 0) {
        x[base + p] = raw[ch.de + p];
      } else {
        const int d = p / ch.fd, j = p - d * ch.fd;
        sincosf(raw[ch.de + d] * (float)(1 << j), &sn, &cs);
        x[base + 2 * p] = sn;
        x[base + 2 * p + 1] = cs;
      }
    }
  }
  __syncthreads();
}

// Epilogue of forward layer l: bias, leaky ReLU (all but the last layer),
// feat / alpha out, and the next layer's input into x.
__device__ void forward_epilogue(const Chain& ch, const Smem& s, int l,
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
      if (!last) s.x[r * ch.xld + c] = v;
    }
  }
  __syncthreads();
}

// Forward layer l of the tile: the product, then its epilogue.
__device__ void forward_layer(const Chain& ch, const Smem& s, int l,
                              const float* __restrict__ w, long long r0,
                              long long n, float* feat, float* alpha) {
  const Layer& ly = ch.layer[l];
  block_mm(s.x, ch.xld, ly.kp, w + ly.woff, ly.np, s.w, s.c, ch.cld);
  forward_epilogue(ch, s, l, r0, n, feat, alpha);
}

__global__ void __launch_bounds__(kThreads)
chain_fwd_f32(Chain ch, const float* __restrict__ emb,
              const float* __restrict__ dists,
              const float* __restrict__ extra, const float* __restrict__ w,
              const float* __restrict__ bias, long long n,
              float* __restrict__ feat, float* __restrict__ alpha) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s(smem, ch);
  const long long r0 = (long long)blockIdx.x * kT;
  load_tile(ch, s, emb, dists, extra, bias, r0, n);
  for (int l = 0; l < ch.L; ++l)
    forward_layer(ch, s, l, w, r0, n, feat, alpha);
}

__global__ void __launch_bounds__(kThreads)
chain_bwd_f32(Chain ch, const float* __restrict__ emb,
              const float* __restrict__ dists,
              const float* __restrict__ extra,
              const float* __restrict__ dfeat,
              const float* __restrict__ dalpha, const float* __restrict__ w,
              const float* __restrict__ bias, long long n,
              float* __restrict__ ascr, float* __restrict__ gscr,
              float* __restrict__ dbpart, float* __restrict__ demb,
              float* __restrict__ ddists, float* __restrict__ dextra) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s(smem, ch);
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
    forward_layer(ch, s, l, w, r0, n, nullptr, nullptr);
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
        const float g = s.c[r * ch.cld + c];
        s.x[r * ch.xld + c] = g;
        gscr[(r0 + r) * ch.gtot + ly.goff + c] = g;
      }
    __syncthreads();
    // dX = G W^T: the packed W^T is [np, kp]
    block_mm(s.x, ch.xld, ly.np, w + ly.wtoff, ly.kp, s.w, s.c, ch.cld);
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
          const float a = ascr[(r0 + r) * ch.atot + ly.aoff + c];
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

// ------------------------------------------------------ chain_dw, chain_reduce

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

// f32 (the small test presets and shading_dtype="float32"): a thread owns
// one column and every eighth row of a 64-row slice of dW, straight from the
// scratch buffers.
__device__ void dw_product(const Chain& ch, const float* ascr,
                           const float* gscr, const Layer& ly, int n0,
                           long long lo, long long hi, float* out) {
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

// float32, grid (dW column tiles + db tiles, chunks): partial[chunk] = this
// chunk's dW | db.
__global__ void __launch_bounds__(kThreads)
chain_dw_f32(Chain ch, const float* __restrict__ ascr,
             const float* __restrict__ gscr, const float* __restrict__ dbpart,
             long long npad, int chunk_rows, int w_tiles,
             float* __restrict__ partial) {
  const long long lo = (long long)blockIdx.y * chunk_rows;
  const long long hi = min(npad, lo + chunk_rows);
  float* out = partial + (size_t)blockIdx.y * (ch.wtot + ch.btot);
  const int t = blockIdx.x;
  if (t < w_tiles) {
    int l, n0;
    if (dw_tile(ch, t, &l, &n0))
      dw_product(ch, ascr, gscr, ch.layer[l], n0, lo, hi, out);
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
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  float sum = 0.f;
  for (int k = 0; k < chunks; ++k) sum += partial[k * width + c];
  out[c] = sum;
}

// ------------------------------------------- bf16 chain_fwd, chain_bwd (Hopper)

namespace hop {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 128;               // rows of a tile
constexpr int kWgRows = 64;              // rows of a consumer warpgroup
constexpr int kThreads = 384;            // producer warpgroup + 2 consumers
constexpr int kRing = 3;                 // weight stages
constexpr int kChunkK = 64;              // K rows of a stage: 128 bytes
constexpr int kWide = 256, kNarrow = 32; // output columns of a pass
constexpr int kStageBytes = kWide * 128;
constexpr int kPanelBytes = kWgRows * 128;  // 64 columns of 64 rows
constexpr int kMaxOut = kWide + kNarrow;    // widest product output
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// The passes of a product with N output columns: one of 32 columns
// (N <= 32) or of 256, or (N in (256, 288]) the 32 columns past 256 first,
// then the first 256 (ops/shading_chain._passes): their widths.
__host__ __device__ __forceinline__ int npasses(int N) {
  return N > kWide ? 2 : 1;
}
__host__ __device__ __forceinline__ int pass_nw(int N, int p) {
  return N <= kNarrow || (N > kWide && p == 0) ? kNarrow : kWide;
}
__host__ __device__ __forceinline__ int nchunks(int K) {
  return (K + kChunkK - 1) / kChunkK;
}
// bf16 elements of a product's stage images: per pass, K / 64 chunks of
// [nw, 64]
__host__ __forceinline__ long long image_elems(int K, int N) {
  long long e = 0;
  for (int p = 0; p < npasses(N); ++p)
    e += (long long)pass_nw(N, p) * kChunkK * nchunks(K);
  return e;
}

// Where each layer's images start (bf16 elements: every layer's forward
// product in order, then the backward's dX products from the last layer to
// the first, as ops/shading_chain.stage_images lays them out) and the
// shared-memory layout, offsets from a 1024-byte aligned base.
struct Plan {
  long long fimg[kMaxLayers], bimg[kMaxLayers];
  int npanels;   // 64-column panels of a warpgroup's activation buffer
  int a_off, raw_off, bias_off, plan_off, mask_off, bar_off;
  int bytes;     // dynamic shared memory, with the alignment slack
  int sld;       // row stride (floats) of the PE backward's f32 staging
};

__host__ int align16(long long b) { return (int)((b + 15) & ~15LL); }

// False if the chain is not one these kernels take: an output wider than
// 256 columns forward or 288 backward, more than 255 raw columns, or more
// shared memory than the card's.
bool make_plan(const Chain& ch, bool bwd, Plan* pl) {
  if (ch.rawld > 255) return false;
  long long off = 0;
  int widest = 0;
  for (int l = 0; l < ch.L; ++l) {
    const Layer& ly = ch.layer[l];
    if (ly.np > kWide || ly.kp > kMaxOut) return false;
    pl->fimg[l] = off;
    off += image_elems(ly.kp, ly.np);
    widest = ly.kp > widest ? ly.kp : widest;
  }
  for (int l = ch.L - 1; l >= 0; --l) {
    pl->bimg[l] = off;
    off += image_elems(ch.layer[l].np, ch.layer[l].kp);
  }
  // a warpgroup's buffer also holds G (up to 4 panels) and the db
  // partials [4, kWide] f32 past it
  pl->npanels = (widest + kChunkK - 1) / kChunkK;
  if (pl->npanels < 5) pl->npanels = 5;
  long long o = (long long)kRing * kStageBytes;
  pl->a_off = (int)o;
  o += 2LL * pl->npanels * kPanelBytes;
  pl->raw_off = (int)o;
  o += align16(4LL * kRows * ch.rawld);
  pl->bias_off = (int)o;
  o += align16(4LL * ch.btot);
  pl->plan_off = (int)o;
  o += align16(4LL * ch.layer[0].kp);
  pl->mask_off = (int)o;
  if (bwd) o += (long long)(ch.L - 1) * 2 * 128 * 16;
  pl->bar_off = (int)o;
  o += 2 * kRing * 8;
  o += 1024;
  pl->bytes = (int)o;
  // the staging of 32 rows of layer 0's dX fits a warpgroup's buffer
  const int kp0 = ch.layer[0].kp;
  pl->sld = 32 * (kp0 + 2) * 4 <= pl->npanels * kPanelBytes ? kp0 + 2 : kp0;
  return o <= kMaxSmem;
}

// ---- primitives: mbarriers, bulk copies, wgmma, barriers, fences

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
// until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// L2 policies: the weights stay (every block reads them for every tile),
// the streams written once (scratch, feat) leave first.
__device__ __forceinline__ uint64_t evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
// bytes from global to shared memory, completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void stg128(void* dst, uint4 v, uint64_t policy) {
  asm volatile(
      "st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(
          dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void stg64(void* dst, float x, float y,
                                      uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.v2.f32 [%0], {%1, %2}, %3;\n" ::"l"(
                   dst),
               "f"(x), "f"(y), "l"(policy)
               : "memory");
}
// bytes (a multiple of 16, from a 16-byte aligned address) into L2
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// the 128 threads of consumer warpgroup k (named barrier k + 1)
__device__ __forceinline__ void wg_bar(int k) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(k + 1) : "memory");
}
// this thread's shared-memory writes, seen by the next wgmma (async proxy)
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving the accumulators across a wgmma wait
__device__ __forceinline__ void pin(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a K-major operand with the 128-byte swizzle at shared
// address `addr`: rows of 128 bytes (64 bf16 of K), 8-row groups 1,024
// bytes apart (SBO), the leading offset unused by this layout.  A k-step of
// 16 moves the start by 32 bytes inside the swizzled rows.
__device__ __forceinline__ uint64_t sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// The descriptor of an MN-major operand with the 128-byte swizzle (chain_dw:
// both operands have the reduction dimension K outermost): K rows of 128
// bytes (64 bf16 of M or N), 8-row groups 1,024 bytes apart (SBO), the next
// 64 columns of M or N `lbo` bytes on (LBO).  A k-step of 16 moves the start
// by 16 rows, 2,048 bytes.
__device__ __forceinline__ uint64_t mn128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// The accumulator operands of an m64n256 wgmma (128 f32 a thread), of an
// m64n64 one (32) and of an m64n32 one (16), and the instruction with
// scale-d from operand `s` (0: d = A B, the registers' previous values
// unread; 1: d += A B) and both operands' transpose flags from the
// immediate `t` (0: K-major; 1: MN-major).
#define D128                                                          \
  "{"                                                                 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define D32                                                           \
  "{"                                                                 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WGMMA(shape, d, a, b, s, t)                                       \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " s ", 0;\n"                          \
  "wgmma.mma_async.sync.aligned." shape ".f32.bf16.bf16 " d ", " a ", " b \
  ", p, 1, 1, " t ", " t ";\n}\n"
#define F8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define W8(i)                                                         \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]),          \
      "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])

// d[64 rows, 256] += A[64, 16] B[16, 256]
template <int T = 0>
__device__ __forceinline__ void mma_n256(float (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(WGMMA("m64n256k16", D128, "%128", "%129", "%130", "%131")
               : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56),
                 F8(64), F8(72), F8(80), F8(88), F8(96), F8(104), F8(112),
                 F8(120)
               : "l"(da), "l"(db), "r"(1), "n"(T));
}
// d = A[64, 16] B[16, 256], d written only: the registers' previous values
// are no input, so whatever wrote them last does not hold the wgmma
// pipeline back.
template <int T = 0>
__device__ __forceinline__ void mma_n256_first(float (&d)[128], uint64_t da,
                                               uint64_t db) {
  asm volatile(WGMMA("m64n256k16", D128, "%128", "%129", "%130", "%131")
               : W8(0), W8(8), W8(16), W8(24), W8(32), W8(40), W8(48), W8(56),
                 W8(64), W8(72), W8(80), W8(88), W8(96), W8(104), W8(112),
                 W8(120)
               : "l"(da), "l"(db), "r"(0), "n"(T));
}
// The same for 64 columns: d[0:32] in the fragment layout of the first 64
// columns of mma_n256's.
template <int T = 0>
__device__ __forceinline__ void mma_n64(float (&d)[128], uint64_t da,
                                        uint64_t db) {
  asm volatile(WGMMA("m64n64k16", D32, "%32", "%33", "%34", "%35")
               : F8(0), F8(8), F8(16), F8(24)
               : "l"(da), "l"(db), "r"(1), "n"(T));
}
template <int T = 0>
__device__ __forceinline__ void mma_n64_first(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(WGMMA("m64n64k16", D32, "%32", "%33", "%34", "%35")
               : W8(0), W8(8), W8(16), W8(24)
               : "l"(da), "l"(db), "r"(0), "n"(T));
}
// The same for 32 columns: d[0:16] in the fragment layout of the first 32
// columns of mma_n256's.
__device__ __forceinline__ void mma_n32(float (&d)[128], uint64_t da,
                                        uint64_t db) {
  asm volatile(WGMMA("m64n32k16", D16, "%16", "%17", "%18", "%19")
               : F8(0), F8(8)
               : "l"(da), "l"(db), "r"(1), "n"(0));
}
__device__ __forceinline__ void mma_n32_first(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(WGMMA("m64n32k16", D16, "%16", "%17", "%18", "%19")
               : W8(0), W8(8)
               : "l"(da), "l"(db), "r"(0), "n"(0));
}
#undef D128
#undef D32
#undef D16
#undef WGMMA
#undef F8
#undef W8

// ---- the weight ring

template <int kN, int kBytes>  // stages, bytes a stage
struct RingOf {
  uint32_t stages, full, empty;  // shared addresses of stage 0, full[0],
                                 // empty[0] (8 bytes a barrier)
  int it;                        // stages consumed (or filled) so far
  __device__ uint32_t stage() const { return stages + (it % kN) * kBytes; }
  __device__ uint32_t full_bar() const { return full + 8 * (it % kN); }
  __device__ uint32_t empty_bar() const { return empty + 8 * (it % kN); }
  __device__ uint32_t parity() const { return (it / kN) & 1; }
};
typedef RingOf<kRing, kStageBytes> Ring;

// Product `p` of a tile: chain_fwd runs every layer forward; chain_bwd the
// layers but the head forward, then the dX products from the head down.
// K, N and where its images start.
__device__ __forceinline__ void product_of(const Chain& ch, const Plan& pl,
                                           bool bwd, int p, int* K, int* N,
                                           long long* img) {
  const int nf = bwd ? ch.L - 1 : ch.L;
  if (p < nf) {
    *K = ch.layer[p].kp;
    *N = ch.layer[p].np;
    *img = pl.fimg[p];
  } else {
    const int i = 2 * ch.L - 2 - p;
    *K = ch.layer[i].np;
    *N = ch.layer[i].kp;
    *img = pl.bimg[i];
  }
}

// The producer (one thread): every stage of every product of every tile of
// this block, in the order the consumers read them.
__device__ void produce(const Chain& ch, const Plan& pl, bool bwd,
                        const bf16* __restrict__ img, long long tiles,
                        Ring r) {
  const int nprod = bwd ? 2 * ch.L - 1 : ch.L;
  const uint64_t keep = evict_last();
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x)
    for (int p = 0; p < nprod; ++p) {
      int K, N;
      long long off;
      product_of(ch, pl, bwd, p, &K, &N, &off);
      const char* src = reinterpret_cast<const char*>(img + off);
      for (int ps = 0; ps < npasses(N); ++ps) {
        const uint32_t bytes = pass_nw(N, ps) * 128;
        for (int kc = 0; kc < nchunks(K); ++kc, ++r.it) {
          mbar_wait(r.empty_bar(), r.parity() ^ 1);
          mbar_expect_tx(r.full_bar(), bytes);
          bulk_load(r.stage(), src, bytes, r.full_bar(), keep);
          src += bytes;
        }
      }
    }
}

// One stage's products: KS k-steps of 16 (KS compile-time, so that no
// branch splits a wgmma batch), acc (+)= A[:, 16 k] B[16 k, :NW]; the
// first stage of a pass overwrites acc.
template <int NW, int KS, bool kFirst>
__device__ __forceinline__ void stage_mma(float (&acc)[128], uint32_t a,
                                          uint32_t b) {
  wg_fence();
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const uint64_t da = sw128(a + 32 * k), db = sw128(b + 32 * k);
    if (kFirst && k == 0) {
      if (NW == kWide)
        mma_n256_first(acc, da, db);
      else
        mma_n32_first(acc, da, db);
    } else if (NW == kWide) {
      mma_n256(acc, da, db);
    } else {
      mma_n32(acc, da, db);
    }
  }
  wg_commit();
}

template <int NW, bool kFirst>
__device__ __forceinline__ void stage_mma_ks(float (&acc)[128], uint32_t a,
                                             uint32_t b, int ks) {
  if (ks >= 4)
    stage_mma<NW, 4, kFirst>(acc, a, b);
  else if (ks == 3)
    stage_mma<NW, 3, kFirst>(acc, a, b);
  else if (ks == 2)
    stage_mma<NW, 2, kFirst>(acc, a, b);
  else
    stage_mma<NW, 1, kFirst>(acc, a, b);
}

// acc[:, :NW] = A[:, :K] B for the warpgroup's 64 rows: A its activation
// buffer at `a` (K-major panels of 64 columns, 128-byte swizzle), B the
// pass's K / 64 stages from the ring, released to the producer as soon as
// their products are done (one arrival per warpgroup).
template <int NW>
__device__ __forceinline__ void product(float (&acc)[128], uint32_t a, int K,
                                        Ring& r, bool leader) {
  const int nk = nchunks(K);
  uint32_t prev = 0;
  for (int kc = 0; kc < nk; ++kc, ++r.it) {
    mbar_wait(r.full_bar(), r.parity());
    const int ks = (K - kc * kChunkK) / 16;
    const uint32_t b = r.stage(), ak = a + kc * kPanelBytes;
    if (kc == 0)
      stage_mma_ks<NW, true>(acc, ak, b, ks);
    else
      stage_mma_ks<NW, false>(acc, ak, b, ks);
    if (kc > 0) {
      wg_wait<1>();
      if (leader) mbar_arrive(prev);
    }
    prev = r.empty_bar();
  }
  wg_wait<0>();
  if (leader) mbar_arrive(prev);
  pin(acc);
}

// Byte offset of 16-byte unit u (columns 8u .. 8u + 7) of row lr in a
// warpgroup's activation buffer: panels of 64 columns, rows of 128 bytes,
// the unit index XORed with lr % 8 (the 128-byte swizzle).
__device__ __forceinline__ uint32_t a_unit(int lr, int u) {
  return (u >> 3) * kPanelBytes + lr * 128 + (((u & 7) ^ (lr & 7)) << 4);
}

__device__ __forceinline__ void sts128(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
// Four 8x8 bf16 tiles from the accumulator fragment layout (tile i from
// register ri: row lane / 4, columns 2 (lane % 4), + 1), lanes 8 i .. 8 i + 7
// giving the addresses of tile i's rows.
__device__ __forceinline__ void stsm_x4(uint32_t a, uint32_t r0, uint32_t r1,
                                        uint32_t r2, uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
          a),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Everything a consumer warpgroup needs.  A thread holds rows r and r + 8
// of the warpgroup's 64 (r = 16 warp + g) and columns 8 j + 2 q, + 1 of
// each 8-column block j of an accumulator fragment: registers
// 4 j + 2 h + e.
struct Wg {
  int k, tid, warp, g, q, r;  // warpgroup 0 / 1, thread, warp, lane / 4,
                              // lane % 4, its first row
  uint32_t a_s;               // its activation buffer (shared address)
  uint32_t sm[4];             // stmatrix row addresses: 16-column block jj
                              // of the warp's 16 rows at sm[jj % 4] + jj / 4
                              // panels (see stsm_block)
  unsigned char* a;           // its activation buffer (generic)
  float* raw;                 // its 64 raw rows [64, rawld]
  const float* bias;          // every bias (shared)
  const int* plan;            // the PE's column plan (shared)
  uint64_t stream;            // L2 policy of the streams written once
  uint4* mask;                // its sign masks: layer l's word of this
                              // thread at mask[l * 256]
  bool leader;
  // Lane L addresses row ri = L % 8 of tile m = L / 8: warp row
  // ri + 8 (m % 2), column block j = 2 jj + m / 2, so (j % 8) ^ ri =
  // (2 jj % 8) ^ (m / 2 ^ ri) and the panel is jj / 4.
  __device__ void init_sm() {
    const int lane = tid & 31, ri = lane & 7, m = lane >> 3;
    const uint32_t base = a_s + (16 * warp + ri + 8 * (m & 1)) * 128;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sm[i] = base + (((2 * i) ^ ((m >> 1) ^ ri)) << 4);
  }
};

// Columns 16 jj .. 16 jj + 15 of the warp's 16 rows into the buffer from
// the fragment's 8-column blocks 2 jj and 2 jj + 1 (rows r and r + 8).
__device__ __forceinline__ void stsm_block(const Wg& w, int jj, uint32_t lo0,
                                           uint32_t hi0, uint32_t lo1,
                                           uint32_t hi1) {
  stsm_x4(w.sm[jj & 3] + (jj >> 2) * kPanelBytes, lo0, hi0, lo1, hi1);
}

// The warpgroup's raw rows of the tile from row0 (zeros past n) by
// cp.async: a lane owns columns lane and lane + 32 of [emb | dists | extra],
// a warp every fourth row; cp_async_wait_all and a warpgroup barrier make
// them visible.
__device__ __forceinline__ void load_raw(const Chain& ch, const Wg& w,
                                         const float* __restrict__ emb,
                                         const float* __restrict__ dists,
                                         const float* __restrict__ extra,
                                         long long row0, long long n) {
  const int lane = w.tid & 31;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int c = lane + 32 * s;
    if (32 * s >= ch.rawld) break;
    if (c >= ch.rawld) continue;
    const float* src;
    int ld;
    if (c < ch.de) {
      src = emb + c;
      ld = ch.de;
    } else if (c < ch.de + ch.dd) {
      src = dists + (c - ch.de);
      ld = ch.dd;
    } else {
      src = extra + (c - ch.de - ch.dd);
      ld = ch.ce;
    }
    for (int lr = w.warp; lr < kWgRows; lr += 4) {
      const long long row = row0 + lr;
      float* dst = w.raw + lr * ch.rawld + c;
      if (row < n)
        cp_async4(dst, src + row * ld);
      else
        *dst = 0.f;
    }
  }
  cp_async_commit();
}

// Ask L2 for the rows row0 .. row0 + 63 (those below n) of a row-major
// [n, width] f32 array, so that the loads that follow find them there.
__device__ __forceinline__ void prefetch_rows(const float* a, int width,
                                              long long row0, long long n) {
  const long long rows = n - row0 < kWgRows ? n - row0 : kWgRows;
  const float* src = a + row0 * width;
  const uint32_t bytes = (uint32_t)(rows * width * 4) & ~15u;
  if (rows > 0 && bytes && (reinterpret_cast<uintptr_t>(src) & 15) == 0)
    prefetch_l2(src, bytes);
}

// The PE's column plan: for each column c of layer 0's input, what it
// holds: zero, raw value `src` of the row, or sin / cos of raw value `src`
// times 2^band (emb, the sin/cos pairs of emb * 2^j at columns de + 2 (d fe
// + j), + 1, the same of dists (or dists raw), zeros to kp).
constexpr int kZero = 0, kRaw = 1, kSin = 2, kCos = 3;
__host__ __device__ __forceinline__ int plan_code(int kind, int band,
                                                  int src) {
  return kind << 16 | band << 8 | src;
}
__device__ int plan_of(const Chain& ch, int c) {
  if (c < ch.de) return plan_code(kRaw, 0, c);
  int p = c - ch.de;
  if (p < 2 * ch.fe * ch.de)
    return plan_code(p & 1 ? kCos : kSin, (p >> 1) % ch.fe,
                     (p >> 1) / ch.fe);
  p -= 2 * ch.fe * ch.de;
  if (ch.fd == 0)
    return p < ch.dd ? plan_code(kRaw, 0, ch.de + p) : plan_code(kZero, 0, 0);
  if (p < 2 * ch.fd * ch.dd)
    return plan_code(p & 1 ? kCos : kSin, (p >> 1) % ch.fd,
                     ch.de + (p >> 1) / ch.fd);
  return plan_code(kZero, 0, 0);
}
__device__ __forceinline__ float plan_value(int code, const float* raw) {
  const int kind = code >> 16;
  if (kind == kZero) return 0.f;
  const float x = raw[code & 255];
  if (kind == kRaw) return x;
  float sn, cs;
  sincosf(x * (float)(1 << ((code >> 8) & 255)), &sn, &cs);
  return kind == kSin ? sn : cs;
}

// Layer 0's input of the warpgroup's rows by the column plan, 8 columns
// (one 16-byte store) at a time; a sin column followed by the cos of the
// same value takes one sincosf (not __sinf: the dist bands reach 2^4 * d).
__device__ void expand_pe(const Chain& ch, const Wg& w) {
  const int units = ch.layer[0].kp / 8;
  for (int idx = w.tid; idx < kWgRows * units; idx += 128) {
    const int lr = idx & (kWgRows - 1), u = idx / kWgRows;
    const float* raw = w.raw + lr * ch.rawld;
    uint32_t out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t0 = w.plan[8 * u + 2 * e], t1 = w.plan[8 * u + 2 * e + 1];
      float v0, v1;
      if (t0 >> 16 == kSin && t1 == t0 + (1 << 16)) {
        sincosf(raw[t0 & 255] * (float)(1 << ((t0 >> 8) & 255)), &v0, &v1);
      } else {
        v0 = plan_value(t0, raw);
        v1 = plan_value(t1, raw);
      }
      out[e] = pack_bf16(v0, v1);
    }
    sts128(w.a_s + a_unit(lr, u), make_uint4(out[0], out[1], out[2], out[3]));
  }
}

// Columns [0, width) of the buffer's rows to dst[row, off:off + width]
// (leading dimension ld), 16 bytes a store, rows below npad.
__device__ void copy_out(const Wg& w, bf16* __restrict__ dst, int ld,
                         int off, int width, long long row0, long long npad) {
  const int cpr = width / 8;
  for (int idx = w.tid; idx < kWgRows * cpr; idx += 128) {
    const int lr = idx / cpr, u = idx - lr * cpr;
    const long long row = row0 + lr;
    if (row < npad)
      stg128(dst + row * ld + off + 8 * u, lds128(w.a_s + a_unit(lr, u)),
             w.stream);
  }
}

// What a forward layer's epilogue writes: a hidden layer the next layer's
// input; block3's last layer that and feat; the head's last layer alpha.
enum { kHidden, kFeat, kAlpha };

// Epilogue of forward layer l from the accumulators (a pass of NW
// columns): bias, leaky ReLU (but kAlpha), the sign bits (kSigns), feat or
// alpha out, the next layer's bf16 input into the buffer (16 columns of the
// warp's rows a stmatrix), block3's extra columns and zeros after block1's
// output.
template <int NW, bool kSigns, int kMode>
__device__ __forceinline__ void fwd_epilogue(const Chain& ch, const Wg& w,
                                             int l, float (&acc)[128],
                                             long long row0, long long n,
                                             float* __restrict__ out) {
  const Layer& ly = ch.layer[l];
  const int np = ly.np, nreal = ly.nreal;
  const bool pairs = nreal % 2 == 0;
  const float* bias = w.bias + ly.boff + 2 * w.q;
  float* orow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + w.r + 8 * h;
    orow[h] = kMode != kHidden && row < n ? out + row * nreal + 2 * w.q
                                          : nullptr;
  }
  uint32_t bits[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int jj = 0; jj < NW / 16; ++jj) {
    if (16 * jj >= np) break;
    uint32_t pk[4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = 2 * jj + t;
      const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * j + 2 * h] + b.x, v1 = acc[4 * j + 2 * h + 1] + b.y;
        if (kMode != kAlpha) {
          v0 = fmaxf(v0, kSlope * v0);  // leaky ReLU
          v1 = fmaxf(v1, kSlope * v1);
        }
        if (kSigns)
          bits[2 * h + (j >> 4)] |= ((__float_as_uint(v0) >> 31) |
                                     (__float_as_uint(v1) >> 31) << 1)
                                    << (2 * (j & 15));
        if (kMode != kHidden && orow[h]) {
          const int c = 8 * j + 2 * w.q;
          float* o = orow[h] + 8 * j;
          if (pairs && c + 1 < nreal) {
            stg64(o, v0, v1, w.stream);
          } else {
            if (c < nreal) o[0] = v0;
            if (c + 1 < nreal) o[1] = v1;
          }
        }
        pk[2 * t + h] = pack_bf16(v0, v1);
      }
    }
    if (kMode != kAlpha) stsm_block(w, jj, pk[0], pk[1], pk[2], pk[3]);
  }
  if (kSigns) w.mask[l * 256] = make_uint4(bits[0], bits[1], bits[2], bits[3]);
  if (kMode == kAlpha || l + 1 != ch.na) return;
  // block3's input past block1's output, 8 columns a store: the extra
  // columns, then zeros
  const int units = (ch.layer[l + 1].kp - np) / 8;
  for (int idx = w.tid; idx < kWgRows * units; idx += 128) {
    const int lr = idx & (kWgRows - 1), u = idx / kWgRows;
    const float* ex = w.raw + lr * ch.rawld + ch.de + ch.dd;
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * u + 2 * e;
      o[e] = pack_bf16(c < ch.ce ? ex[c] : 0.f, c + 1 < ch.ce ? ex[c + 1] : 0.f);
    }
    sts128(w.a_s + a_unit(lr, np / 8 + u), make_uint4(o[0], o[1], o[2], o[3]));
  }
}

// Forward layer l's epilogue, its pass width and mode chosen.
template <bool kSigns>
__device__ __forceinline__ void fwd_epilogue_l(const Chain& ch, const Wg& w,
                                               int l, float (&acc)[128],
                                               long long row0, long long n,
                                               float* feat, float* alpha) {
  const bool narrow = ch.layer[l].np <= kNarrow;
  if (l == ch.L - 1) {
    if (narrow)
      fwd_epilogue<kNarrow, kSigns, kAlpha>(ch, w, l, acc, row0, n, alpha);
    else
      fwd_epilogue<kWide, kSigns, kAlpha>(ch, w, l, acc, row0, n, alpha);
  } else if (l == ch.na + ch.nb - 1 && feat) {
    if (narrow)
      fwd_epilogue<kNarrow, kSigns, kFeat>(ch, w, l, acc, row0, n, feat);
    else
      fwd_epilogue<kWide, kSigns, kFeat>(ch, w, l, acc, row0, n, feat);
  } else {
    if (narrow)
      fwd_epilogue<kNarrow, kSigns, kHidden>(ch, w, l, acc, row0, n, nullptr);
    else
      fwd_epilogue<kWide, kSigns, kHidden>(ch, w, l, acc, row0, n, nullptr);
  }
}

// Where g of a layer comes from in the reverse sweep: dalpha (the head's
// last layer), or the dX accumulators of the layer after it (+ dfeat at
// the head's bottom).
enum { kFromAlpha, kFromDx, kFromDxFeat };

// g of layer `gl` (np columns) into the buffer as G = bf16(g), the left
// operand of its dX product (stmatrix, 16 columns a store), and its db
// partial over the warpgroup's 64 rows into part [4 warps, kWide]: each
// thread's two rows, the warp's 8 row groups by shuffles (a fixed tree),
// then (db_sum) the four warps in order.  From dX (kFromDx*), g = (dX +
// dfeat) * the leaky ReLU's slope from layer gl's sign mask; acc is only
// read, so that no other instruction writes the wgmma accumulators.  dalpha
// and dfeat are read kGroup blocks of 16 columns at a time, their loads
// first.
constexpr int kGroup = 4;
template <int NW, int kSrc>
__device__ __forceinline__ void g_step(const Chain& ch, const Wg& w, int gl,
                                       const float (&acc)[128],
                                       long long row0, long long n,
                                       const float* __restrict__ src,
                                       float* part) {
  const Layer& ly = ch.layer[gl];
  const int np = ly.np, nreal = ly.nreal;
  const bool pairs = nreal % 2 == 0;
  uint32_t m[4] = {0u, 0u, 0u, 0u};
  if (kSrc != kFromAlpha) {
    const uint4 m4 = w.mask[gl * 256];
    m[0] = m4.x;
    m[1] = m4.y;
    m[2] = m4.z;
    m[3] = m4.w;
  }
  const float* rowp[2];  // dalpha or dfeat rows (null past n)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + w.r + 8 * h;
    rowp[h] = kSrc != kFromDx && row < n ? src + row * nreal : nullptr;
  }
#pragma unroll
  for (int jg = 0; jg < NW / 16; jg += kGroup) {
    if (16 * jg >= np) break;
    float xs[kGroup][2][2][2];  // [block][t][row h][column e]
#pragma unroll
    for (int b = 0; b < kGroup; ++b)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 16 * (jg + b) + 8 * t + 2 * w.q;
          float x0 = 0.f, x1 = 0.f;
          if (kSrc != kFromDx && jg + b < NW / 16 && rowp[h]) {
            if (pairs && c + 1 < nreal) {
              const float2 x = *reinterpret_cast<const float2*>(rowp[h] + c);
              x0 = x.x;
              x1 = x.y;
            } else {
              if (c < nreal) x0 = rowp[h][c];
              if (c + 1 < nreal) x1 = rowp[h][c + 1];
            }
          }
          xs[b][t][h][0] = x0;
          xs[b][t][h][1] = x1;
        }
#pragma unroll
    for (int b = 0; b < kGroup; ++b) {
      const int jj = jg + b;
      if (jj >= NW / 16 || 16 * jj >= np) break;
      float v[2][2][2];  // [block t][row h][column e]
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 2 * jj + t;
            float g = xs[b][t][h][e];
            if (kSrc != kFromAlpha) {
              g = acc[4 * j + 2 * h + e];
              if (kSrc == kFromDxFeat) g += xs[b][t][h][e];
              if (m[2 * h + (j >> 4)] & (1u << (2 * (j & 15) + e)))
                g *= kSlope;
            }
            v[t][h][e] = g;
          }
      stsm_block(w, jj, pack_bf16(v[0][0][0], v[0][0][1]),
                 pack_bf16(v[0][1][0], v[0][1][1]),
                 pack_bf16(v[1][0][0], v[1][0][1]),
                 pack_bf16(v[1][1][0], v[1][1][1]));
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float s0 = v[t][0][0] + v[t][1][0], s1 = v[t][0][1] + v[t][1][1];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        if (w.g == 0)
          *reinterpret_cast<float2*>(part + w.warp * kWide + 16 * jj +
                                     8 * t + 2 * w.q) = make_float2(s0, s1);
      }
    }
  }
}

// Layer `gl`'s db partial of the warpgroup's rows: part's four warps in
// order.
__device__ __forceinline__ void db_sum(const Chain& ch, const Wg& w, int gl,
                                       const float* part, long long row0,
                                       long long npad,
                                       float* __restrict__ dbpart) {
  const Layer& ly = ch.layer[gl];
  if (row0 < npad)
    for (int c = w.tid; c < ly.np; c += 128)
      dbpart[(row0 / kT) * ch.btot + ly.boff + c] =
          ((part[c] + part[kWide + c]) + part[2 * kWide + c]) +
          part[3 * kWide + c];
}

// d_extra from dX of block3's first layer: its columns past block1's
// output (a pass of NW columns from n0).
template <int NW>
__device__ __forceinline__ void dx_extra(const Chain& ch, const Wg& w,
                                         const float (&acc)[128], int n0,
                                         long long row0, long long n,
                                         float* __restrict__ dextra) {
  const int np = ch.layer[ch.na - 1].np;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    if (n0 + 8 * j + 8 <= np) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n0 + 8 * j + 2 * w.q + e - np;
        const long long row = row0 + w.r + 8 * h;
        if (row < n && c >= 0 && c < ch.ce)
          dextra[row * ch.ce + c] = acc[4 * j + 2 * h + e];
      }
  }
}

constexpr int kCached = 8;  // PE bands whose sincosf the backward reuses

// PE backward from layer 0's dX (acc: columns < 256; nar: 256 .. kp0),
// staged in f32 through the buffer 32 rows at a time, in the arithmetic and
// order of the f32 kernel (and the TPU kernel's _pe_backward): the raw
// part, then the sin terms band by band, then the cos terms; each of the
// first kCached bands' sincosf is computed once.
__device__ __forceinline__ void pe_backward(
    const Chain& ch, const Plan& pl, const Wg& w, float (&acc)[128],
    const float (&nar)[16], long long row0, long long n,
    float* __restrict__ demb, float* __restrict__ ddists) {
  const int kp0 = ch.layer[0].kp, nraw = ch.de + ch.dd;
  float* st = reinterpret_cast<float*>(w.a);
  for (int half = 0; half < 2; ++half) {
    if ((w.warp >> 1) == half) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* srow = st + (16 * (w.warp & 1) + w.g + 8 * h) * pl.sld;
#pragma unroll
        for (int j = 0; j < kWide / 8; ++j) {
          const int c = 8 * j + 2 * w.q;
          if (c < kp0)
            *reinterpret_cast<float2*>(srow + c) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
#pragma unroll
        for (int j = 0; j < kNarrow / 8; ++j) {
          const int c = kWide + 8 * j + 2 * w.q;
          if (c < kp0)
            *reinterpret_cast<float2*>(srow + c) =
                make_float2(nar[4 * j + 2 * h], nar[4 * j + 2 * h + 1]);
        }
      }
    }
    wg_bar(w.k);
    // a warp's lanes take 32 rows of one output column
    const int lr = w.tid & 31;
    const long long row = row0 + 32 * half + lr;
    for (int jj = w.warp; jj < nraw && row < n; jj += 4) {
      const float* dx = st + lr * pl.sld;
      const bool is_emb = jj < ch.de;
      const int d = is_emb ? jj : jj - ch.de;
      const int nf = is_emb ? ch.fe : ch.fd;
      const int off = is_emb ? ch.de + 2 * d * ch.fe
                             : ch.de + 2 * ch.fe * ch.de + 2 * d * ch.fd;
      const float x = w.raw[(32 * half + lr) * ch.rawld + jj];
      float v = is_emb ? dx[d]
                       : (ch.fd == 0 ? dx[ch.de + 2 * ch.fe * ch.de + d] : 0.f);
      // the first kCached bands' sin factors stay in registers
      float sf[kCached], sn, cs;
#pragma unroll
      for (int f = 0; f < kCached; ++f) {
        if (f < nf) {
          sincosf(x * (float)(1 << f), &sn, &cs);
          v += ((float)(1 << f) * cs) * dx[off + 2 * f];
          sf[f] = (float)(1 << f) * sn;
        }
      }
      for (int f = kCached; f < nf; ++f) {
        sincosf(x * (float)(1 << f), &sn, &cs);
        v += ((float)(1 << f) * cs) * dx[off + 2 * f];
      }
#pragma unroll
      for (int f = 0; f < kCached; ++f)
        if (f < nf) v -= sf[f] * dx[off + 2 * f + 1];
      for (int f = kCached; f < nf; ++f) {
        sincosf(x * (float)(1 << f), &sn, &cs);
        v -= ((float)(1 << f) * sn) * dx[off + 2 * f + 1];
      }
      if (is_emb)
        demb[row * ch.de + d] = v;
      else
        ddists[row * ch.dd + d] = v;
    }
    wg_bar(w.k);
  }
}

// One product of the warpgroup, its pass width chosen by N.
__device__ __forceinline__ void product_n(float (&acc)[128], const Wg& w,
                                          int K, int N, Ring& r) {
  if (N <= kNarrow)
    product<kNarrow>(acc, w.a_s, K, r, w.leader);
  else
    product<kWide>(acc, w.a_s, K, r, w.leader);
}

// chain_fwd (kBwd false): feat, alpha.  chain_bwd (kBwd true): the A and G
// scratch, the per-64-row db partials, d_emb, d_dists, d_extra.
template <bool kBwd>
__global__ void __launch_bounds__(kThreads, 1)
chain_hop(const Chain ch, const Plan pl, const float* __restrict__ emb,
          const float* __restrict__ dists, const float* __restrict__ extra,
          const float* __restrict__ dfeat, const float* __restrict__ dalpha,
          const bf16* __restrict__ img, const float* __restrict__ bias,
          long long n, float* __restrict__ feat, float* __restrict__ alpha,
          bf16* __restrict__ ascr, bf16* __restrict__ gscr,
          float* __restrict__ dbpart, float* __restrict__ demb,
          float* __restrict__ ddists, float* __restrict__ dextra) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(base);
  Ring ring{sb, sb + pl.bar_off, sb + pl.bar_off + 8 * kRing, 0};
  float* bias_s = reinterpret_cast<float*>(base + pl.bias_off);
  int* plan = reinterpret_cast<int*>(base + pl.plan_off);
  for (int c = threadIdx.x; c < ch.btot; c += kThreads) bias_s[c] = bias[c];
  for (int c = threadIdx.x; c < ch.layer[0].kp; c += kThreads)
    plan[c] = plan_of(ch, c);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long tiles = (n + kRows - 1) / kRows;
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) produce(ch, pl, kBwd, img, tiles, ring);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  Wg w;
  w.k = threadIdx.x / 128 - 1;
  w.tid = threadIdx.x & 127;
  w.warp = w.tid >> 5;
  w.g = (w.tid & 31) >> 2;
  w.q = w.tid & 3;
  w.r = 16 * w.warp + w.g;
  w.leader = w.tid == 0;
  w.a = base + pl.a_off + w.k * pl.npanels * kPanelBytes;
  w.a_s = smem_u32(w.a);
  w.init_sm();
  w.plan = plan;
  w.stream = evict_first();
  w.raw = reinterpret_cast<float*>(base + pl.raw_off) +
          w.k * kWgRows * ch.rawld;
  w.bias = bias_s;
  w.mask = reinterpret_cast<uint4*>(base + pl.mask_off) + w.k * 128 + w.tid;
  const long long npad = (n + kT - 1) / kT * kT;
  const int nfwd = kBwd ? ch.L - 1 : ch.L;

  float acc[128];
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0.f;
  long long t = blockIdx.x;
  if (t < tiles) load_raw(ch, w, emb, dists, extra, t * kRows + w.k * kWgRows, n);
  for (; t < tiles; t += gridDim.x) {
    const long long row0 = t * kRows + w.k * kWgRows;
    const long long next0 = row0 + (long long)gridDim.x * kRows;
    if (w.leader) {
      // into L2 now (the streams written meanwhile leave L2 first): the
      // next tile's raw rows, read by load_raw; the backward's dalpha and
      // dfeat rows, read by the reverse sweep
      prefetch_rows(emb, ch.de, next0, n);
      prefetch_rows(dists, ch.dd, next0, n);
      prefetch_rows(extra, ch.ce, next0, n);
      if (kBwd) {
        prefetch_rows(dalpha, ch.layer[ch.L - 1].nreal, row0, n);
        prefetch_rows(dfeat, ch.layer[ch.na + ch.nb - 1].nreal, row0, n);
      }
    }
    cp_async_wait_all();
    wg_bar(w.k);
    expand_pe(ch, w);
    proxy_fence();
    wg_bar(w.k);
    if (kBwd)
      copy_out(w, ascr, ch.atot, ch.layer[0].aoff, ch.layer[0].kp, row0, npad);
    for (int l = 0; l < nfwd; ++l) {
      const Layer& ly = ch.layer[l];
      product_n(acc, w, ly.kp, ly.np, ring);
      wg_bar(w.k);  // every read of the buffer is done
      fwd_epilogue_l<kBwd>(ch, w, l, acc, row0, n, feat, alpha);
      proxy_fence();
      wg_bar(w.k);
      // the forward reads its raw rows no more: the next tile's come in
      if (!kBwd && l + 1 == ch.na && t + gridDim.x < tiles)
        load_raw(ch, w, emb, dists, extra, next0, n);
      if (kBwd)
        copy_out(w, ascr, ch.atot, ch.layer[l + 1].aoff, ch.layer[l + 1].kp,
                 row0, npad);
    }
    if (!kBwd) continue;

    // reverse sweep
    wg_bar(w.k);  // every read of the buffer by copy_out is done
    // the db partials lie past G's panels
    float* part = reinterpret_cast<float*>(w.a + 4 * kPanelBytes);
    if (ch.layer[ch.L - 1].np <= kNarrow)
      g_step<kNarrow, kFromAlpha>(ch, w, ch.L - 1, acc, row0, n, dalpha, part);
    else
      g_step<kWide, kFromAlpha>(ch, w, ch.L - 1, acc, row0, n, dalpha, part);
    float nar[16];
    for (int i = ch.L - 1; i >= 0; --i) {
      const Layer& ly = ch.layer[i];
      proxy_fence();
      wg_bar(w.k);  // G_i and its db partials are in
      db_sum(ch, w, i, part, row0, npad, dbpart);
      copy_out(w, gscr, ch.gtot, ly.goff, ly.np, row0, npad);
      // dX = G W^T, N = kp columns: the 32 past 256 first, if any
      if (ly.kp > kWide) {
        product<kNarrow>(acc, w.a_s, ly.np, ring, w.leader);
        if (i == 0) {
#pragma unroll
          for (int e = 0; e < 16; ++e) nar[e] = acc[e];
        } else if (i == ch.na) {
          dx_extra<kNarrow>(ch, w, acc, kWide, row0, n, dextra);
        }
        product<kWide>(acc, w.a_s, ly.np, ring, w.leader);
      } else {
        product_n(acc, w, ly.np, ly.kp, ring);
      }
      wg_bar(w.k);  // every read of the buffer is done
      if (i == 0) {
        pe_backward(ch, pl, w, acc, nar, row0, n, demb, ddists);
        break;
      }
      const bool wide = ly.kp > kNarrow;
      if (i == ch.na) {
        if (wide)
          dx_extra<kWide>(ch, w, acc, 0, row0, n, dextra);
        else
          dx_extra<kNarrow>(ch, w, acc, 0, row0, n, dextra);
      }
      if (i == ch.na + ch.nb) {
        if (wide)
          g_step<kWide, kFromDxFeat>(ch, w, i - 1, acc, row0, n, dfeat, part);
        else
          g_step<kNarrow, kFromDxFeat>(ch, w, i - 1, acc, row0, n, dfeat,
                                       part);
      } else if (wide) {
        g_step<kWide, kFromDx>(ch, w, i - 1, acc, row0, n, nullptr, part);
      } else {
        g_step<kNarrow, kFromDx>(ch, w, i - 1, acc, row0, n, nullptr, part);
      }
    }
    // the PE backward read the raw rows last: the next tile's come in
    if (t + gridDim.x < tiles) load_raw(ch, w, emb, dists, extra, next0, n);
  }
}

template <bool kBwd>
cudaError_t launch(const Chain& ch, const void* emb, const void* dists,
                   const void* extra, const void* dfeat, const void* dalpha,
                   const void* img, const void* bias, long long n, void* feat,
                   void* alpha, void* ascr, void* gscr, void* dbpart,
                   void* demb, void* ddists, void* dextra, cudaStream_t st) {
  Plan pl;
  if (!make_plan(ch, kBwd, &pl)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      chain_hop<kBwd>, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.bytes);
  if (e != cudaSuccess) return e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long tiles = (n + kRows - 1) / kRows;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  chain_hop<kBwd><<<grid, kThreads, pl.bytes, st>>>(
      ch, pl, (const float*)emb, (const float*)dists, (const float*)extra,
      (const float*)dfeat, (const float*)dalpha, (const bf16*)img,
      (const float*)bias, n, (float*)feat, (float*)alpha, (bf16*)ascr,
      (bf16*)gscr, (float*)dbpart, (float*)demb, (float*)ddists,
      (float*)dextra);
  return cudaGetLastError();
}

// ---- bf16 chain_dw: dW_l = sum over rows of A_l^T G_l, split-K on wgmma

constexpr int kDwSlab = 128;                  // dW rows of an item
constexpr int kDwRing = 3;                    // stages (4 ran slower)
constexpr int kBox = 64 * 128;                // a TMA box: 64 rows x 64 bf16
constexpr int kDwGOff = 2 * kBox;             // G's boxes follow A's two
constexpr int kDwStageBytes = 6 * kBox;       // A 128 columns, G up to 256
constexpr int kDwSmem = kDwRing * kDwStageBytes + 2 * kDwRing * 8 + 1024;
constexpr int kDwMaxItems = 48, kDwMaxSplits = 64;

// One item of a row split (ops/shading_chain.dw_plan): dW rows
// [k0, k0 + rows) of one layer, all its np columns, in nw-column wgmmas
// (64 or 256); the A columns from acol (= aoff + k0), the G columns from
// gcol (= goff); its dW at out (= woff + k0 np) of a split's partial row; and
// the db columns [db0, db1) this item's block sums for the split.
struct DwItem {
  int acol, gcol, rows, nw, np, out, db0, db1;
};
// The items of one split (J) and the S splits' first 64-row stage
// (split[S] = npad / 64): item i of the launch is item i % J of split i / J.
struct DwPlan {
  int J, S, wtot, width;  // width: wtot + btot, a partial row
  DwItem item[kDwMaxItems];
  int split[kDwMaxSplits + 1];
};

// A box of 64 columns from column x and 64 rows from row y of the tensor
// map's array into shared memory at dst, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar,
                                         uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar),
      "l"(policy)
      : "memory");
}
__device__ __forceinline__ uint64_t evict_normal() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

typedef RingOf<kDwRing, kDwStageBytes> DwRing;

// The producer (one thread): each stage of each of the block's items, G's
// boxes (read by the split's other items of the layer at about the same
// time) then A's (the columns only this item reads: leave L2 first).
__device__ void dw_produce(const CUtensorMap* amap, const CUtensorMap* gmap,
                           const DwPlan& plan, DwRing r) {
  const uint64_t once = evict_first(), shared = evict_normal();
  for (int i = blockIdx.x; i < plan.J * plan.S; i += gridDim.x) {
    const DwItem& it = plan.item[i % plan.J];
    const int s = i / plan.J;
    const int ng = it.nw / 64;
    for (int t = plan.split[s]; t < plan.split[s + 1]; ++t, ++r.it) {
      mbar_wait(r.empty_bar(), r.parity() ^ 1);
      mbar_expect_tx(r.full_bar(), (2 + ng) * kBox);
      for (int p = 0; p < ng; ++p)
        tma_load(r.stage() + kDwGOff + p * kBox, gmap, it.gcol + 64 * p,
                 64 * t, r.full_bar(), shared);
      for (int p = 0; p < 2; ++p)
        tma_load(r.stage() + p * kBox, amap, it.acol + 64 * p, 64 * t,
                 r.full_bar(), once);
    }
  }
}

// Warps 1-3 of the producer warpgroup: the db columns of each of the
// block's items, the split's per-64-row partials summed in row order.
__device__ void dw_db(const DwPlan& plan, const float* __restrict__ dbpart,
                      int btot, float* __restrict__ partial, int tid) {
  for (int i = blockIdx.x; i < plan.J * plan.S; i += gridDim.x) {
    const DwItem& it = plan.item[i % plan.J];
    const int s = i / plan.J, b0 = plan.split[s], nb = plan.split[s + 1] - b0;
    for (int c = it.db0 + tid; c < it.db1; c += 96) {
      const float* p = dbpart + (size_t)b0 * btot + c;
      float sum = 0.f;
      int b = 0;
      for (; b + 8 <= nb; b += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = p[(size_t)(b + u) * btot];
#pragma unroll
        for (int u = 0; u < 8; ++u) sum += v[u];
      }
      for (; b < nb; ++b) sum += p[(size_t)b * btot];
      partial[(size_t)s * plan.width + plan.wtot + c] = sum;
    }
  }
}

// One stage's products for the warpgroup: its 64 dW rows (a: its A box,
// 64 rows of the scratch by 64 columns) by NW columns (b: G's boxes), the
// stage's 64 scratch rows as four k-steps of 16; the first stage of an item
// overwrites acc.
template <int NW, bool kFirst>
__device__ __forceinline__ void dw_stage(float (&acc)[128], uint32_t a,
                                         uint32_t b) {
  wg_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t da = mn128(a + 2048 * k, kBox), db = mn128(b + 2048 * k, kBox);
    if (kFirst && k == 0) {
      if (NW == kWide)
        mma_n256_first<1>(acc, da, db);
      else
        mma_n64_first<1>(acc, da, db);
    } else if (NW == kWide) {
      mma_n256<1>(acc, da, db);
    } else {
      mma_n64<1>(acc, da, db);
    }
  }
  wg_commit();
}

// The warpgroup's share of an item over its split's n stages: each stage's
// products issued before the previous stage's are waited for, each stage
// released to the producer once its products are done (one arrival per
// warpgroup).  Both warpgroups run every item (no branch on the warpgroup
// around a wgmma, which ptxas would serialize): in an item of at most 64
// dW rows the second one's rows are dropped.
template <int NW>
__device__ __forceinline__ void dw_consume(float (&acc)[128], DwRing& r, int n,
                                           uint32_t a_off, bool leader) {
  uint32_t prev = 0;
  for (int t = 0; t < n; ++t, ++r.it) {
    mbar_wait(r.full_bar(), r.parity());
    const uint32_t st = r.stage();
    if (t == 0)
      dw_stage<NW, true>(acc, st + a_off, st + kDwGOff);
    else
      dw_stage<NW, false>(acc, st + a_off, st + kDwGOff);
    if (t > 0) {
      wg_wait<1>();
      if (leader) mbar_arrive(prev);
    }
    prev = r.empty_bar();
  }
  // outside the loop: ptxas cannot tell that the loop ran (n >= 1), and an
  // accumulator read on a path without a wait serializes every wgmma
  wg_wait<0>();
  if (leader) mbar_arrive(prev);
  pin(acc);
}

// The warpgroup's dW rows [0, rows) (of its 64) by columns [0, np) into
// out (row stride np), 8 bytes a store.  A thread holds rows 16 warp + g,
// + 8 and columns 8 j + 2 q, + 1.
template <int NW>
__device__ __forceinline__ void dw_store(const float (&acc)[128],
                                         float* __restrict__ out, int np,
                                         int rows, int warp, int g, int q) {
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int c = 8 * j + 2 * q;
    if (c < np) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * warp + g + 8 * h;
        if (m < rows)
          *reinterpret_cast<float2*>(out + (size_t)m * np + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// partial[s] = split s's dW | db.  Persistent: block b takes items b,
// b + grid, ...; a producer warpgroup (one TMA thread, three db warps) and
// two consumer warpgroups of 64 dW rows each.
__global__ void __launch_bounds__(kThreads, 1)
dw_hop(const __grid_constant__ CUtensorMap amap,
       const __grid_constant__ CUtensorMap gmap,
       const __grid_constant__ DwPlan plan, const float* __restrict__ dbpart,
       int btot, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sb0 = smem_u32(smem_raw);
  const uint32_t sb = sb0 + ((1024 - (sb0 & 1023)) & 1023);
  const uint32_t bars = sb + kDwRing * kDwStageBytes;
  DwRing ring{sb, bars, bars + 8 * kDwRing, 0};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwRing; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0)
      dw_produce(&amap, &gmap, plan, ring);
    else if (threadIdx.x >= 32)
      dw_db(plan, dbpart, btot, partial, threadIdx.x - 32);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int k = threadIdx.x / 128 - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
  float acc[128];
  for (int i = blockIdx.x; i < plan.J * plan.S; i += gridDim.x) {
    const DwItem& it = plan.item[i % plan.J];
    const int s = i / plan.J, n = plan.split[s + 1] - plan.split[s];
    const int rows = it.rows - kWgRows * k;
    float* out = partial + (size_t)s * plan.width + it.out +
                 (size_t)kWgRows * k * it.np;
    if (it.nw == kWide) {
      dw_consume<kWide>(acc, ring, n, k * kBox, tid == 0);
      dw_store<kWide>(acc, out, it.np, rows, warp, g, q);
    } else {
      dw_consume<64>(acc, ring, n, k * kBox, tid == 0);
      dw_store<64>(acc, out, it.np, rows, warp, g, q);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (the library
// links no libcuda); null if the driver has none.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a row-major bf16 [rows, cols] scratch: 64 x 64 boxes,
// the 128-byte swizzle wgmma reads, zeros past its last column.
bool scratch_map(EncodeTiled enc, CUtensorMap* map, const void* base,
                 int cols, long long rows) {
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64}, step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
             dim, stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The DwPlan of dw_plan's ints [J, S, J items of 8, S + 1 split bounds];
// false unless every item and bound lies inside the chain's arrays and the
// kernel's tiles (a layer over 256 columns, or rows not 64-row stages, are
// refused) and every split has rows.
bool read_dw_plan(const Chain& ch, const int* p, int len, long long npad,
                  DwPlan* pl) {
  if (len < 2) return false;
  pl->J = p[0];
  pl->S = p[1];
  pl->wtot = ch.wtot;
  pl->width = ch.wtot + ch.btot;
  if (pl->J < 1 || pl->J > kDwMaxItems || pl->S < 1 || pl->S > kDwMaxSplits ||
      len != 2 + 8 * pl->J + pl->S + 1 || npad % 64 ||
      npad / 64 > (1LL << 30))
    return false;
  for (int j = 0; j < pl->J; ++j) {
    const int* m = p + 2 + 8 * j;
    DwItem& it = pl->item[j];
    it = DwItem{m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7]};
    if (it.acol < 0 || it.rows < 1 || it.rows > kDwSlab ||
        it.acol + it.rows > ch.atot || (it.nw != 64 && it.nw != kWide) ||
        it.np < 1 || it.np > it.nw || it.np % 2 || it.gcol < 0 ||
        it.gcol + it.np > ch.gtot || it.out < 0 || it.out % 2 ||
        (long long)it.out + (long long)it.rows * it.np > ch.wtot ||
        it.db0 < 0 || it.db0 > it.db1 || it.db1 > ch.btot)
      return false;
  }
  const int* b = p + 2 + 8 * pl->J;
  if (b[0] != 0 || b[pl->S] != npad / 64) return false;
  for (int s = 0; s <= pl->S; ++s) {
    if (s > 0 && b[s] <= b[s - 1]) return false;
    pl->split[s] = b[s];
  }
  return true;
}

cudaError_t dw_launch(const Chain& ch, const int* plan, int plan_len,
                      const void* ascr, const void* gscr, const void* dbpart,
                      long long npad, int parts, void* partial, void* grad,
                      cudaStream_t st) {
  DwPlan pl;
  if (!read_dw_plan(ch, plan, plan_len, npad, &pl) || pl.S != parts)
    return cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap amap, gmap;
  if (!scratch_map(enc, &amap, ascr, ch.atot, npad) ||
      !scratch_map(enc, &gmap, gscr, ch.gtot, npad))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dw_hop, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem);
  if (e != cudaSuccess) return e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int items = pl.J * pl.S;
  dw_hop<<<items < sms ? items : sms, kThreads, kDwSmem, st>>>(
      amap, gmap, pl, (const float*)dbpart, ch.btot, (float*)partial);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  chain_reduce<<<(unsigned)((pl.width + kThreads - 1) / kThreads), kThreads,
                 0, st>>>(
      (const float*)partial, pl.S, pl.width, (float*)grad);
  return cudaGetLastError();
}

}  // namespace hop

// ------------------------------------------------------------------- host

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

cudaError_t fwd_f32(const Chain& ch, const void* emb, const void* dists,
                    const void* extra, const void* w, const void* bias,
                    long long n, void* feat, void* alpha, cudaStream_t st) {
  const size_t bytes = Smem::bytes(ch);
  cudaError_t e = prepare(chain_fwd_f32, bytes);
  if (e != cudaSuccess) return e;
  chain_fwd_f32<<<(unsigned)((n + kT - 1) / kT), kThreads, bytes, st>>>(
      ch, (const float*)emb, (const float*)dists, (const float*)extra,
      (const float*)w, (const float*)bias, n, (float*)feat, (float*)alpha);
  return cudaGetLastError();
}

cudaError_t bwd_f32(const Chain& ch, const void* emb, const void* dists,
                    const void* extra, const void* dfeat, const void* dalpha,
                    const void* w, const void* bias, long long n, void* ascr,
                    void* gscr, void* dbpart, void* demb, void* ddists,
                    void* dextra, cudaStream_t st) {
  const size_t bytes = Smem::bytes(ch);
  cudaError_t e = prepare(chain_bwd_f32, bytes);
  if (e != cudaSuccess) return e;
  chain_bwd_f32<<<(unsigned)((n + kT - 1) / kT), kThreads, bytes, st>>>(
      ch, (const float*)emb, (const float*)dists, (const float*)extra,
      (const float*)dfeat, (const float*)dalpha, (const float*)w,
      (const float*)bias, n, (float*)ascr, (float*)gscr, (float*)dbpart,
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
// scratch bf16; `w` the stage images of ops/shading_chain.stage_images),
// 0 is float32 (`w` pack_chain's [W | W^T]).  A chain the kernels do not
// take (a layer wider than 256 columns, a bf16 layer input wider than 288,
// shared memory beyond the card's) returns cudaErrorInvalidValue.  The
// wrapper (ops/shading_chain.py) checks devices, types and contiguity and
// allocates every buffer.

// feat [n, F] f32 and alpha [n, H] f32 of emb [n, de], dists [n, dd] and
// extra [n, ce] (f32); bias the packed f32 biases.
extern "C" int chain_fwd_launch(const int* meta, int dtype, const void* emb,
                                const void* dists, const void* extra,
                                const void* w, const void* bias, long long n,
                                void* feat, void* alpha, void* stream) {
  Chain ch;
  if (!read_meta(meta, &ch) || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype ? hop::launch<false>(ch, emb, dists, extra, nullptr,
                                          nullptr, w, bias, n, feat, alpha,
                                          nullptr, nullptr, nullptr, nullptr,
                                          nullptr, nullptr, st)
                     : fwd_f32(ch, emb, dists, extra, w, bias, n, feat, alpha,
                               st));
}

// The recompute backward over rows padded to a multiple of 64: d_emb,
// d_dists, d_extra, the scratch A [npad, atot] and G [npad, gtot], and the
// per-64-row db partials [npad / 64, btot].
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
  return (int)(dtype ? hop::launch<true>(ch, emb, dists, extra, dfeat,
                                         dalpha, w, bias, n, nullptr, nullptr,
                                         ascr, gscr, dbpart, demb, ddists,
                                         dextra, st)
                     : bwd_f32(ch, emb, dists, extra, dfeat, dalpha, w, bias,
                               n, ascr, gscr, dbpart, demb, ddists, dextra,
                               st));
}

// grad [wtot + btot] = every dW and db, from the scratch A and G and the
// per-64-row db partials of chain_bwd, over npad rows (a multiple of 64),
// in two launches: the sums of each part of the rows into partial
// [parts, wtot + btot], then the parts summed in order (chain_reduce).
// bf16: the parts are the row splits of `plan`, ops/shading_chain.dw_plan's
// plan_len ints (hop::dw_hop).  float32: chunks of 4,096 rows
// (kF32ChunkRows), `plan` unread.
extern "C" int chain_dw_launch(const int* meta, int dtype, const void* ascr,
                               const void* gscr, const void* dbpart,
                               long long npad, const int* plan, int plan_len,
                               int parts, void* partial, void* grad,
                               void* stream) {
  Chain ch;
  if (!read_meta(meta, &ch) || npad <= 0 || npad % kT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype)
    return (int)hop::dw_launch(ch, plan, plan_len, ascr, gscr, dbpart, npad,
                               parts, partial, grad, st);
  if (parts != (npad + kF32ChunkRows - 1) / kF32ChunkRows)
    return (int)cudaErrorInvalidValue;
  const int wt = w_tiles(ch);
  const dim3 grid(wt + (ch.btot + kThreads - 1) / kThreads, parts);
  chain_dw_f32<<<grid, kThreads, 0, st>>>(
      ch, (const float*)ascr, (const float*)gscr, (const float*)dbpart, npad,
      kF32ChunkRows, wt, (float*)partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long width = (long long)ch.wtot + ch.btot;
  chain_reduce<<<(unsigned)((width + kThreads - 1) / kThreads), kThreads, 0,
                 st>>>((const float*)partial, parts, width, (float*)grad);
  return (int)cudaGetLastError();
}
