// Native host data pipeline: multithreaded ray-batch producer/prefetcher.
//
// Counterpart of the reference's native runtime layer (the ISPC
// task system, loma_public/runtime/tasksys.cpp: a pthread pool executing
// launched tasks).  Here the host-side work worth parallelizing is the input
// pipeline: per-batch camera-ray generation (train_nerf.py:23-62 semantics:
// normalized pixel grid, principal point K, dirs @ R^T, UNNORMALIZED
// directions), stratified depth sampling with the 1e8 far sentinel
// (train_nerf.py:289-311), and target-pixel gather — produced ahead of the
// accelerator by a worker pool into a ring of batch slots.
//
// Depths are emitted in OFFSET form: a static per-pipeline base comb
// t_base[s] = near + step*s with uniform dists (+1e8 sentinel), plus a
// per-ray scalar offset dt[r] (a Cranley-Patterson shifted lattice:
// stratified = every ray's comb shifts by u01*bin; 0 when unjittered).
// The consumer folds dt into ray origins (o + d*dt), which keeps batch
// depth arrays O(S) instead of O(N*S) (per-ray-uniform depths).
//
// C ABI only (consumed via ctypes; no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

// splitmix64: tiny counter-based RNG, deterministic per (seed, batch, i)
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}
static inline double u01(uint64_t x) {
  return (double)(x >> 11) * (1.0 / 9007199254740992.0);
}

struct Config {
  int n_rays;
  int n_samples;
  float near_t, far_t;
  int stratified;
  uint64_t seed;
};

struct Batch {
  std::vector<float> origins, dirs, toffs, targets;
  void resize(const Config& c) {
    origins.resize((size_t)c.n_rays * 3);
    dirs.resize((size_t)c.n_rays * 3);
    toffs.resize((size_t)c.n_rays);
    targets.resize((size_t)c.n_rays * 3);
  }
};

struct Context {
  // dataset (owned copies)
  std::vector<float> poses;   // V * 16 (row-major 4x4 c2w)
  std::vector<float> images;  // V * H * W * 3, [0,1]
  int n_views = 0, height = 0, width = 0;
  float focal = 1.f;
  Config cfg{};

  // worker pool + ready queue
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::queue<Batch*> ready;
  std::vector<Batch*> free_slots;
  std::vector<Batch> slots;
  std::atomic<uint64_t> batch_counter{0};
  std::atomic<bool> stop{false};

  void produce(Batch* b, uint64_t batch_id) {
    const int S = cfg.n_samples;
    const float cx = 0.5f, cy = 0.5f;
    const float fx = focal, fy = focal;
    const uint64_t base = splitmix64(cfg.seed ^ (batch_id * 0x9e3779b9ull));
    // random view per batch (reference picks one view per iteration,
    // train_nerf.py:254)
    const int view = (int)(splitmix64(base ^ 0xabcdef) % (uint64_t)n_views);
    const float* P = &poses[(size_t)view * 16];
    const float R[9] = {P[0], P[1], P[2], P[4], P[5], P[6], P[8], P[9], P[10]};
    const float T[3] = {P[3], P[7], P[11]};
    for (int r = 0; r < cfg.n_rays; ++r) {
      const uint64_t h = splitmix64(base + (uint64_t)r * 0x100000001b3ull);
      const int px = (int)(h % (uint64_t)(width * width));
      const int ix = px % width, iy = px / width;
      // linspace(0,1,width) grid, 'xy' indexing then flatten: i varies
      // fastest (train_nerf.py:37-39)
      const float u = (width > 1) ? (float)ix / (float)(width - 1) : 0.f;
      const float v = (width > 1) ? (float)iy / (float)(width - 1) : 0.f;
      const float dc[3] = {(u - cx) / fx, -(v - cy) / fy, -1.0f};
      // world dir = dc @ R^T  (row-vector times R transpose)
      float dw[3];
      for (int k = 0; k < 3; ++k)
        dw[k] = dc[0] * R[k * 3 + 0] + dc[1] * R[k * 3 + 1] +
                dc[2] * R[k * 3 + 2];
      for (int k = 0; k < 3; ++k) {
        b->origins[(size_t)r * 3 + k] = T[k];
        b->dirs[(size_t)r * 3 + k] = dw[k];
      }
      // depth offset: 0 (uniform comb) or a per-ray shifted-lattice
      // jitter within one bin width (the reference sketches per-sample
      // jitter, train_nerf.py:290-294; the per-ray comb shift is the
      // unbiased variant that keeps depths per-ray-uniform)
      b->toffs[r] =
          cfg.stratified
              ? (float)u01(splitmix64(h ^ 0x5eedb175ull)) *
                    ((cfg.far_t - cfg.near_t) / (float)S)
              : 0.0f;
      // target pixel: images laid out H x W x 3; flat pixel index px maps to
      // row iy, col ix (matching the reference's reshape(-1, 3) of an image
      // indexed by the same meshgrid flattening)
      const float* t3 =
          &images[((size_t)view * height + iy) * width * 3 + (size_t)ix * 3];
      std::memcpy(&b->targets[(size_t)r * 3], t3, 3 * sizeof(float));
    }
  }

  float far_minus_near() const { return cfg.far_t - cfg.near_t; }

  void worker_loop() {
    for (;;) {
      Batch* slot = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || !free_slots.empty(); });
        if (stop.load()) return;
        slot = free_slots.back();
        free_slots.pop_back();
      }
      const uint64_t id = batch_counter.fetch_add(1);
      produce(slot, id);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.push(slot);
      }
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* ln_create(const float* poses, const float* images, int n_views,
                int height, int width, float focal, int n_rays, int n_samples,
                float near_t, float far_t, int stratified, uint64_t seed,
                int queue_depth, int n_threads) {
  auto* ctx = new Context();
  ctx->poses.assign(poses, poses + (size_t)n_views * 16);
  ctx->images.assign(images,
                     images + (size_t)n_views * height * width * 3);
  ctx->n_views = n_views;
  ctx->height = height;
  ctx->width = width;
  ctx->focal = focal;
  ctx->cfg = Config{n_rays, n_samples, near_t, far_t, stratified, seed};
  if (queue_depth < 2) queue_depth = 2;
  ctx->slots.resize(queue_depth);
  for (auto& b : ctx->slots) {
    b.resize(ctx->cfg);
    ctx->free_slots.push_back(&b);
  }
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i)
    ctx->workers.emplace_back([ctx] { ctx->worker_loop(); });
  return ctx;
}

// Static per-pipeline depth comb: t_base (S) and dists (S, 1e8 sentinel).
void ln_depths(void* vctx, float* t_base, float* dists) {
  auto* ctx = static_cast<Context*>(vctx);
  const int S = ctx->cfg.n_samples;
  const float step = ctx->far_minus_near() / (float)(S - 1);
  for (int s = 0; s < S; ++s) t_base[s] = ctx->cfg.near_t + step * (float)s;
  for (int s = 0; s < S - 1; ++s) dists[s] = step;
  dists[S - 1] = 1e8f;  // far sentinel
}

// Blocking: copy the next ready batch into caller-provided buffers.
// Returns 0 on success.
int ln_next_batch(void* vctx, float* origins, float* dirs, float* toffs,
                  float* targets) {
  auto* ctx = static_cast<Context*>(vctx);
  Batch* b = nullptr;
  {
    std::unique_lock<std::mutex> lk(ctx->mu);
    ctx->cv_ready.wait(lk, [&] { return !ctx->ready.empty(); });
    b = ctx->ready.front();
    ctx->ready.pop();
  }
  const auto cpy = [](float* dst, const std::vector<float>& src) {
    std::memcpy(dst, src.data(), src.size() * sizeof(float));
  };
  cpy(origins, b->origins);
  cpy(dirs, b->dirs);
  cpy(toffs, b->toffs);
  cpy(targets, b->targets);
  {
    std::lock_guard<std::mutex> lk(ctx->mu);
    ctx->free_slots.push_back(b);
  }
  ctx->cv_free.notify_one();
  return 0;
}

void ln_destroy(void* vctx) {
  auto* ctx = static_cast<Context*>(vctx);
  ctx->stop.store(true);
  ctx->cv_free.notify_all();
  for (auto& t : ctx->workers) t.join();
  delete ctx;
}

}  // extern "C"
