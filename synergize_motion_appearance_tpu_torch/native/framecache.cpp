// framecache: native data-loader runtime for VoxCeleb-style frame folders.
//
// The port's own copy of the JAX package's native/framecache.cpp, which
// replaces the reference's host input stack (torch DataLoader workers +
// threaded PrefetchDataLoader + CUDAPrefetcher,
// basicsr/data/prefetch_dataloader.py:7-125): frames are packed once into a
// single binary cache (data/native_loader.py::write_cache), this library
// mmaps it and serves normalized float32 (source, driving) pairs from a
// multithreaded ring buffer. No Python in the per-batch path; the GIL is
// released while workers copy and augment.
//
// Cache layout (little-endian):
//   magic  u64  'SAMTFC01'
//   u32 num_videos, u32 height, u32 width, u32 channels
//   per video: u64 frame_offset_index (into frame table), u32 num_frames
//   frame table: for each video, frames stored contiguously as raw
//                uint8 H*W*C (RGB)
//
// C ABI (ctypes-friendly). Built at first use by data/native_loader.py:
//   g++ -O3 -fPIC -std=c++17 -pthread -shared
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x31304346544d4153ULL;  // "SAMTFC01"

struct VideoMeta {
  uint64_t frame_offset;  // byte offset of first frame from data start
  uint32_t num_frames;
};

struct Cache {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  uint32_t num_videos = 0, height = 0, width = 0, channels = 0;
  std::vector<VideoMeta> videos;
  const uint8_t* data = nullptr;  // start of frame payload

  size_t frame_bytes() const {
    return size_t(height) * width * channels;
  }
  const uint8_t* frame(uint32_t v, uint32_t f) const {
    return data + videos[v].frame_offset + size_t(f) * frame_bytes();
  }
};

struct Batch {
  std::vector<float> source;
  std::vector<float> driving;
};

struct Sampler {
  Cache* cache = nullptr;
  int batch = 0;
  bool hflip = true, time_flip = true;
  float mean = 0.5f, stddev = 0.5f;
  uint64_t seed = 0;
  std::atomic<uint64_t> counter{0};

  std::vector<std::thread> workers;
  std::deque<Batch> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  size_t max_ready = 4;
  std::atomic<bool> stop{false};
};

void normalize_frame(const uint8_t* src, float* dst, size_t n, float mean,
                     float stddev, bool hflip, uint32_t h, uint32_t w,
                     uint32_t c) {
  const float inv = 1.0f / (255.0f * stddev);
  const float off = mean / stddev;
  if (!hflip) {
    for (size_t i = 0; i < n; ++i) dst[i] = float(src[i]) * inv - off;
    return;
  }
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* row = src + size_t(y) * w * c;
    float* drow = dst + size_t(y) * w * c;
    for (uint32_t x = 0; x < w; ++x) {
      const uint8_t* px = row + size_t(w - 1 - x) * c;
      float* dp = drow + size_t(x) * c;
      for (uint32_t ch = 0; ch < c; ++ch)
        dp[ch] = float(px[ch]) * inv - off;
    }
  }
}

void fill_batch(Sampler* s, Batch* out, uint64_t tick) {
  Cache* cc = s->cache;
  const size_t fb = cc->frame_bytes();
  out->source.resize(size_t(s->batch) * fb);
  out->driving.resize(size_t(s->batch) * fb);
  for (int b = 0; b < s->batch; ++b) {
    std::mt19937_64 rng(s->seed * 0x9e3779b97f4a7c15ULL + tick * 1000003ULL +
                        b);
    uint32_t v = uint32_t(rng() % cc->num_videos);
    uint32_t nf = cc->videos[v].num_frames;
    uint32_t f0 = uint32_t(rng() % nf);
    uint32_t f1 = uint32_t(rng() % nf);
    if (f0 > f1) std::swap(f0, f1);  // sorted like np.sort(choice(2))
    bool hf = s->hflip && (rng() & 1);
    bool tf = s->time_flip && (rng() & 1);
    if (tf) std::swap(f0, f1);
    normalize_frame(cc->frame(v, f0), out->source.data() + size_t(b) * fb,
                    fb, s->mean, s->stddev, hf, cc->height, cc->width,
                    cc->channels);
    normalize_frame(cc->frame(v, f1), out->driving.data() + size_t(b) * fb,
                    fb, s->mean, s->stddev, hf, cc->height, cc->width,
                    cc->channels);
  }
}

void worker_loop(Sampler* s) {
  while (!s->stop.load()) {
    uint64_t tick = s->counter.fetch_add(1);
    Batch b;
    fill_batch(s, &b, tick);
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_space.wait(lk, [s] {
      return s->ready.size() < s->max_ready || s->stop.load();
    });
    if (s->stop.load()) return;
    s->ready.push_back(std::move(b));
    s->cv_ready.notify_one();
  }
}

}  // namespace

extern "C" {

void* fc_open(const char* path) {
  auto* c = new Cache();
  c->fd = open(path, O_RDONLY);
  if (c->fd < 0) {
    delete c;
    return nullptr;
  }
  struct stat st;
  fstat(c->fd, &st);
  c->size = size_t(st.st_size);
  c->base = static_cast<const uint8_t*>(
      mmap(nullptr, c->size, PROT_READ, MAP_PRIVATE, c->fd, 0));
  if (c->base == MAP_FAILED) {
    close(c->fd);
    delete c;
    return nullptr;
  }
  const uint8_t* p = c->base;
  uint64_t magic;
  memcpy(&magic, p, 8);
  p += 8;
  if (magic != kMagic) {
    munmap(const_cast<uint8_t*>(c->base), c->size);
    close(c->fd);
    delete c;
    return nullptr;
  }
  memcpy(&c->num_videos, p, 4); p += 4;
  memcpy(&c->height, p, 4); p += 4;
  memcpy(&c->width, p, 4); p += 4;
  memcpy(&c->channels, p, 4); p += 4;
  c->videos.resize(c->num_videos);
  for (uint32_t i = 0; i < c->num_videos; ++i) {
    memcpy(&c->videos[i].frame_offset, p, 8); p += 8;
    memcpy(&c->videos[i].num_frames, p, 4); p += 4;
  }
  c->data = p;
  return c;
}

void fc_close(void* h) {
  auto* c = static_cast<Cache*>(h);
  if (!c) return;
  munmap(const_cast<uint8_t*>(c->base), c->size);
  close(c->fd);
  delete c;
}

uint32_t fc_num_videos(void* h) {
  return static_cast<Cache*>(h)->num_videos;
}
uint32_t fc_num_frames(void* h, uint32_t v) {
  return static_cast<Cache*>(h)->videos[v].num_frames;
}
uint32_t fc_height(void* h) { return static_cast<Cache*>(h)->height; }
uint32_t fc_width(void* h) { return static_cast<Cache*>(h)->width; }
uint32_t fc_channels(void* h) { return static_cast<Cache*>(h)->channels; }

// copy one raw frame (uint8 RGB) into out
void fc_get_frame(void* h, uint32_t v, uint32_t f, uint8_t* out) {
  auto* c = static_cast<Cache*>(h);
  memcpy(out, c->frame(v, f), c->frame_bytes());
}

void* fc_sampler_start(void* h, int batch, int threads, uint64_t seed,
                       int hflip, int time_flip, float mean, float stddev) {
  auto* s = new Sampler();
  s->cache = static_cast<Cache*>(h);
  s->batch = batch;
  s->seed = seed;
  s->hflip = hflip != 0;
  s->time_flip = time_flip != 0;
  s->mean = mean;
  s->stddev = stddev;
  int n = threads > 0 ? threads : 2;
  for (int i = 0; i < n; ++i)
    s->workers.emplace_back(worker_loop, s);
  return s;
}

// blocks until a batch is ready; copies into caller float32 buffers of
// shape (batch, H, W, C)
void fc_sampler_next(void* sh, float* source, float* driving) {
  auto* s = static_cast<Sampler*>(sh);
  Batch b;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_ready.wait(lk, [s] { return !s->ready.empty(); });
    b = std::move(s->ready.front());
    s->ready.pop_front();
    s->cv_space.notify_one();
  }
  memcpy(source, b.source.data(), b.source.size() * sizeof(float));
  memcpy(driving, b.driving.data(), b.driving.size() * sizeof(float));
}

void fc_sampler_stop(void* sh) {
  auto* s = static_cast<Sampler*>(sh);
  s->stop.store(true);
  s->cv_space.notify_all();
  s->cv_ready.notify_all();
  for (auto& t : s->workers) t.join();
  delete s;
}

}  // extern "C"
