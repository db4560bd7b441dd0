// Native batch-assembly core for the training data pipeline.
//
// The reference's per-step host work (dilated pixel sampling, ground-truth
// gather, ray-direction generation — the reference's data/
// scannet_ft_dataset.py:893-976) runs in Python per batch.  Here it is a
// small C++ library driven through ctypes: one call assembles a full batch
// from a pinned decoded-image cache, and a background thread pool keeps a
// ring of future batches ready (the `pin_data_in_memory` + prefetch analog,
// without the GIL).
//
// Build: at first use, by ops/build.load_host_library, into
// build/torch_native/ (the same source as native/sampler.cpp, whose
// Makefile flags the build uses).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// xorshift128+ generator — deterministic across platforms for a given seed.
struct Rng {
  uint64_t s0, s1;
};

static inline uint64_t rng_next(Rng* r) {
  uint64_t x = r->s0, y = r->s1;
  r->s0 = y;
  x ^= x << 23;
  r->s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
  return r->s1 + y;
}

static inline double rng_uniform(Rng* r) {
  return (rng_next(r) >> 11) * (1.0 / 9007199254740992.0);
}

static inline int64_t rng_randint(Rng* r, int64_t lo, int64_t hi) {
  // [lo, hi)
  return lo + (int64_t)(rng_uniform(r) * (double)(hi - lo));
}

// --- pixel samplers -------------------------------------------------------

// Dilated sampler (scannet_ft_dataset.py:920-940): patch_num^2 patches of
// patch_size^2 pixels, random placement, random integer dilation.
void sample_dilated(int height, int width, int margin, int patch_num,
                    int patch_size, int dil_min, int dil_max, uint64_t seed,
                    float* out_xy /* [S*S*2] row-major (x,y) */) {
  Rng rng{seed ^ 0x9e3779b97f4a7c15ULL, seed | 1};
  int side = patch_num * patch_size;
  for (int pi = 0; pi < patch_num; pi++) {
    for (int pj = 0; pj < patch_num; pj++) {
      int d = (int)rng_randint(&rng, dil_min, dil_max + 1);
      int ix = (int)rng_randint(&rng, margin,
                                width - margin - (patch_size - 1) * d);
      int iy = (int)rng_randint(&rng, margin,
                                height - margin - (patch_size - 1) * d);
      for (int y = 0; y < patch_size; y++) {
        for (int x = 0; x < patch_size; x++) {
          int row = pi * patch_size + y;
          int col = pj * patch_size + x;
          float* o = out_xy + (row * side + col) * 2;
          o[0] = (float)(ix + d * x);
          o[1] = (float)(iy + d * y);
        }
      }
    }
  }
}

void sample_random(int height, int width, int margin, int size, uint64_t seed,
                   float* out_xy) {
  Rng rng{seed ^ 0x853c49e6748fea9bULL, seed | 1};
  for (int i = 0; i < size * size; i++) {
    out_xy[i * 2 + 0] = (float)rng_randint(&rng, margin, width - margin);
    out_xy[i * 2 + 1] = (float)rng_randint(&rng, margin, height - margin);
  }
}

// --- per-batch assembly ---------------------------------------------------

// Gather GT colors at integer pixel coords from an [H, W, 3] float image.
void gather_pixels(const float* image, int height, int width,
                   const float* xy, int n, float* out_rgb) {
  for (int i = 0; i < n; i++) {
    int x = (int)xy[i * 2 + 0];
    int y = (int)xy[i * 2 + 1];
    if (x < 0) x = 0;
    if (x >= width) x = width - 1;
    if (y < 0) y = 0;
    if (y >= height) y = height - 1;
    std::memcpy(out_rgb + i * 3, image + (y * width + x) * 3,
                3 * sizeof(float));
  }
}

// Ray directions (get_dtu_raydir, data/data_utils.py:57-71): +0.5 pixel
// centers, intrinsics inverse, rotate by c2w, normalize.
void compute_raydirs(const float* xy, int n, const float* intrinsic /*3x3*/,
                     const float* camrot /*3x3 row-major c2w*/, int normalize,
                     float* out_dirs) {
  float fx = intrinsic[0], cx = intrinsic[2];
  float fy = intrinsic[4], cy = intrinsic[5];
  for (int i = 0; i < n; i++) {
    float x = (xy[i * 2 + 0] + 0.5f - cx) / fx;
    float y = (xy[i * 2 + 1] + 0.5f - cy) / fy;
    float z = 1.0f;
    if (normalize) {
      float inv = 1.0f / std::sqrt(x * x + y * y + 1.0f);
      x *= inv;
      y *= inv;
      z = inv;
    }
    // world dir = R @ [x, y, z]
    out_dirs[i * 3 + 0] = camrot[0] * x + camrot[1] * y + camrot[2] * z;
    out_dirs[i * 3 + 1] = camrot[3] * x + camrot[4] * y + camrot[5] * z;
    out_dirs[i * 3 + 2] = camrot[6] * x + camrot[7] * y + camrot[8] * z;
  }
}

// One-call batch assembly: sample pixels, gather gt, compute ray dirs.
void assemble_batch(const float* image, int height, int width, int margin,
                    int patch_num, int patch_size, int dil_min, int dil_max,
                    const float* intrinsic, const float* camrot,
                    uint64_t seed, float* out_xy, float* out_rgb,
                    float* out_dirs) {
  int side = patch_num * patch_size;
  sample_dilated(height, width, margin, patch_num, patch_size, dil_min,
                 dil_max, seed, out_xy);
  gather_pixels(image, height, width, out_xy, side * side, out_rgb);
  compute_raydirs(out_xy, side * side, intrinsic, camrot, 1, out_dirs);
}

// --- prefetching pipeline -------------------------------------------------
//
// A worker pool assembles future batches into a bounded ring; the Python side
// pops ready batches without holding the GIL during assembly.

struct BatchJob {
  const float* image;  // pinned decoded image (owned by Python cache)
  int height, width, margin;
  int patch_num, patch_size, dil_min, dil_max;
  float intrinsic[9];
  float camrot[9];
  uint64_t seed;
  // outputs (owned by the pipeline)
  std::vector<float> xy, rgb, dirs;
  uint64_t ticket;
};

struct Pipeline {
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::queue<BatchJob*> pending;
  std::queue<BatchJob*> done;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  uint64_t next_ticket = 0;
};

static void worker_loop(Pipeline* p) {
  for (;;) {
    BatchJob* job = nullptr;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_work.wait(lk,
                      [&] { return p->stop.load() || !p->pending.empty(); });
      if (p->stop.load() && p->pending.empty()) return;
      job = p->pending.front();
      p->pending.pop();
    }
    int side = job->patch_num * job->patch_size;
    int n = side * side;
    job->xy.resize(n * 2);
    job->rgb.resize(n * 3);
    job->dirs.resize(n * 3);
    assemble_batch(job->image, job->height, job->width, job->margin,
                   job->patch_num, job->patch_size, job->dil_min, job->dil_max,
                   job->intrinsic, job->camrot, job->seed, job->xy.data(),
                   job->rgb.data(), job->dirs.data());
    {
      std::lock_guard<std::mutex> lk(p->mu);
      p->done.push(job);
    }
    p->cv_done.notify_all();
  }
}

void* pipeline_create(int num_workers) {
  Pipeline* p = new Pipeline();
  for (int i = 0; i < num_workers; i++)
    p->workers.emplace_back(worker_loop, p);
  return p;
}

uint64_t pipeline_submit(void* handle, const float* image, int height,
                         int width, int margin, int patch_num, int patch_size,
                         int dil_min, int dil_max, const float* intrinsic,
                         const float* camrot, uint64_t seed) {
  Pipeline* p = (Pipeline*)handle;
  BatchJob* job = new BatchJob();
  job->image = image;
  job->height = height;
  job->width = width;
  job->margin = margin;
  job->patch_num = patch_num;
  job->patch_size = patch_size;
  job->dil_min = dil_min;
  job->dil_max = dil_max;
  std::memcpy(job->intrinsic, intrinsic, 9 * sizeof(float));
  std::memcpy(job->camrot, camrot, 9 * sizeof(float));
  job->seed = seed;
  uint64_t t;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    t = p->next_ticket++;
    job->ticket = t;
    p->pending.push(job);
  }
  p->cv_work.notify_one();
  return t;
}

// Pop one finished batch (blocking); copies results into caller buffers.
// Returns the job's ticket.
uint64_t pipeline_pop(void* handle, float* out_xy, float* out_rgb,
                      float* out_dirs) {
  Pipeline* p = (Pipeline*)handle;
  BatchJob* job = nullptr;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_done.wait(lk, [&] { return !p->done.empty(); });
    job = p->done.front();
    p->done.pop();
  }
  std::memcpy(out_xy, job->xy.data(), job->xy.size() * sizeof(float));
  std::memcpy(out_rgb, job->rgb.data(), job->rgb.size() * sizeof(float));
  std::memcpy(out_dirs, job->dirs.data(), job->dirs.size() * sizeof(float));
  uint64_t t = job->ticket;
  delete job;
  return t;
}

void pipeline_destroy(void* handle) {
  Pipeline* p = (Pipeline*)handle;
  p->stop.store(true);
  p->cv_work.notify_all();
  for (auto& t : p->workers) t.join();
  while (!p->pending.empty()) {
    delete p->pending.front();
    p->pending.pop();
  }
  while (!p->done.empty()) {
    delete p->done.front();
    p->done.pop();
  }
  delete p;
}

}  // extern "C"
