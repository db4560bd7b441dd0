// One Adam step over the point table, in place.
//
// Replaces the Pallas TPU kernel tools/pallas_adam.py `adam_table_update`
// (body `_adam_kernel`): optax.adam's update of a [N, F] f32 table p with
// gradient g and moments mu, nu, all in one pass:
//
//     mu' = b1*mu + c1*g                   (c1 = 1 - b1)
//     nu' = b2*nu + c2*(g*g)               (c2 = 1 - b2)
//     p'  = p + neg_lr * ((mu'/bc1) / (sqrt(nu'/bc2) + eps))
//
// with bc1 = 1 - b1^t, bc2 = 1 - b2^t at t = count + 1 and neg_lr = -lr at the
// schedule's count; the wrapper (ops/adam.py:adam_scalars) computes the eight
// scalars on the host and passes them by value.  The association is optax's
// (c2*(g*g), where the TPU kernel took (c2*g)*g).  p, mu and nu are updated in
// place.  Every product, sum, quotient and the square root is rounded on its
// own (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn): nvcc would otherwise
// contract a*b + c into one FMA, and the plain PyTorch version rounds each
// operation, so the two agree bit for bit on the card.
//
// Bound on an H100: 4 reads and 3 writes of N*F*4 bytes and about 15
// operations per element, so it is bound by memory: at [600,000, 64] that is
// 1.075 GB, 0.321 ms at 3.35 TB/s.
//
// Design: a grid-stride elementwise pass with 16-byte (float4) loads and
// stores; a scalar loop takes the tail when N*F is not a multiple of 4 or a
// pointer is not 16-byte aligned.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (hybridneuralrendering_tpu_torch/ops/build.py).

#include <cuda_runtime.h>

namespace {

struct AdamScalars {
  float b1, b2, c1, c2, bc1, bc2, neg_lr, eps;
};

__device__ __forceinline__ void adam_one(const AdamScalars& s, float g,
                                         float* p, float* mu, float* nu) {
  const float m = __fadd_rn(__fmul_rn(s.b1, *mu), __fmul_rn(s.c1, g));
  const float v = __fadd_rn(__fmul_rn(s.b2, *nu),
                            __fmul_rn(s.c2, __fmul_rn(g, g)));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps);
  const float upd = __fdiv_rn(__fdiv_rn(m, s.bc1), den);
  *mu = m;
  *nu = v;
  *p = __fadd_rn(*p, __fmul_rn(s.neg_lr, upd));
}

__global__ void adam_vec4(float4* __restrict__ p, const float4* __restrict__ g,
                          float4* __restrict__ mu, float4* __restrict__ nu,
                          long long n4, AdamScalars s) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 pp = p[i], gg = g[i], mm = mu[i], vv = nu[i];
    adam_one(s, gg.x, &pp.x, &mm.x, &vv.x);
    adam_one(s, gg.y, &pp.y, &mm.y, &vv.y);
    adam_one(s, gg.z, &pp.z, &mm.z, &vv.z);
    adam_one(s, gg.w, &pp.w, &mm.w, &vv.w);
    p[i] = pp;
    mu[i] = mm;
    nu[i] = vv;
  }
}

__global__ void adam_scalar(float* __restrict__ p, const float* __restrict__ g,
                            float* __restrict__ mu, float* __restrict__ nu,
                            long long begin, long long n, AdamScalars s) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = begin + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float pp = p[i], mm = mu[i], vv = nu[i];
    adam_one(s, g[i], &pp, &mm, &vv);
    p[i] = pp;
    mu[i] = mm;
    nu[i] = vv;
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 resident blocks per SM

int blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// Returns a cudaError_t value: 0 on a successful launch.  The launch is
// asynchronous on `stream`.  p, g, mu and nu hold n float32 values each.
extern "C" int adam_table_launch(void* p, const void* g, void* mu, void* nu,
                                 long long n, float b1, float b2, float c1,
                                 float c2, float bc1, float bc2, float neg_lr,
                                 float eps, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const AdamScalars s{b1, b2, c1, c2, bc1, bc2, neg_lr, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((reinterpret_cast<unsigned long long>(p) |
        reinterpret_cast<unsigned long long>(g) |
        reinterpret_cast<unsigned long long>(mu) |
        reinterpret_cast<unsigned long long>(nu)) & 15ull) == 0;
  long long done = 0;
  if (aligned && n >= 4) {
    const long long n4 = n / 4;
    adam_vec4<<<blocks_for(n4), kThreads, 0, st>>>(
        static_cast<float4*>(p), static_cast<const float4*>(g),
        static_cast<float4*>(mu), static_cast<float4*>(nu), n4, s);
    done = n4 * 4;
  }
  if (done < n) {
    adam_scalar<<<blocks_for(n - done), kThreads, 0, st>>>(
        static_cast<float*>(p), static_cast<const float*>(g),
        static_cast<float*>(mu), static_cast<float*>(nu), done, n, s);
  }
  return (int)cudaGetLastError();
}
