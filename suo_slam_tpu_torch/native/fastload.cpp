// fastload: memory-mapped frame cache with a threaded batch gatherer.
//
// The native half of the training loader's frame cache
// (`suo_slam_tpu_torch/data/fastload.py`, `--use_cache`): BOP frames are
// PNG-decoded once into a flat binary cache, and at train time this library
// mmaps the cache and copies shuffled batches out of it on a std::thread
// pool, with readahead hints for the next batch, so the host pays no decode
// per epoch. A copy of the JAX package's `native/fastload.cpp` (same file
// layout, same C API); built with g++ at first use into `build/suo_native/`.
//
// File layout (little-endian):
//   header: char[4] magic "SUOC", u32 version, u64 n_samples,
//           u32 H, u32 W, u32 C, u32 depth_flag,
//           u64 record_bytes
//   per-sample record (fixed size):
//     i32 scene_id, i32 view_id,
//     u8 img[H*W*C],
//     (if depth_flag) f32 depth[H*W]
//
// C API (ctypes-friendly): fl_open / fl_close / fl_* accessors /
// fl_gather (parallel copy of B records into caller buffers) /
// fl_prefetch (madvise WILLNEED readahead for the next batch).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Header {
  char magic[4];
  uint32_t version;
  uint64_t n_samples;
  uint32_t h, w, c, depth_flag;
  uint64_t record_bytes;
} __attribute__((packed));

struct Cache {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  Header hdr{};
  const uint8_t* records = nullptr;
};

inline const uint8_t* record_ptr(const Cache* ca, int64_t i) {
  return ca->records + static_cast<uint64_t>(i) * ca->hdr.record_bytes;
}

void parallel_for(int64_t n, int n_threads, const std::function<void(int64_t)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  int nt = std::min<int64_t>(n_threads, n);
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    pool.emplace_back([&] {
      for (int64_t i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void* fl_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* ca = new Cache();
  ca->fd = fd;
  ca->base = static_cast<const uint8_t*>(base);
  ca->size = st.st_size;
  std::memcpy(&ca->hdr, base, sizeof(Header));
  if (std::memcmp(ca->hdr.magic, "SUOC", 4) != 0 ||
      ca->size < sizeof(Header) + ca->hdr.n_samples * ca->hdr.record_bytes) {
    munmap(base, st.st_size);
    ::close(fd);
    delete ca;
    return nullptr;
  }
  ca->records = ca->base + sizeof(Header);
  // random access pattern over a large file
  madvise(const_cast<uint8_t*>(ca->base), ca->size, MADV_RANDOM);
  return ca;
}

void fl_close(void* handle) {
  auto* ca = static_cast<Cache*>(handle);
  if (!ca) return;
  munmap(const_cast<uint8_t*>(ca->base), ca->size);
  ::close(ca->fd);
  delete ca;
}

int64_t fl_num_samples(void* h) { return static_cast<Cache*>(h)->hdr.n_samples; }
int32_t fl_height(void* h) { return static_cast<Cache*>(h)->hdr.h; }
int32_t fl_width(void* h) { return static_cast<Cache*>(h)->hdr.w; }
int32_t fl_channels(void* h) { return static_cast<Cache*>(h)->hdr.c; }
int32_t fl_has_depth(void* h) { return static_cast<Cache*>(h)->hdr.depth_flag; }

// Parallel-copy B records into caller-provided buffers.
//   ids_out:   [B, 2] int32 (scene_id, view_id)
//   img_out:   [B, H, W, C] uint8
//   depth_out: [B, H, W] float32 (may be null when the cache has no depth)
// Returns 0 on success, -1 on out-of-range index.
int fl_gather(void* handle, const int64_t* indices, int64_t b,
              int32_t* ids_out, uint8_t* img_out, float* depth_out,
              int n_threads) {
  auto* ca = static_cast<Cache*>(handle);
  const uint64_t img_bytes = static_cast<uint64_t>(ca->hdr.h) * ca->hdr.w * ca->hdr.c;
  const uint64_t depth_bytes =
      ca->hdr.depth_flag ? sizeof(float) * ca->hdr.h * ca->hdr.w : 0;
  std::atomic<int> err(0);
  parallel_for(b, n_threads, [&](int64_t k) {
    int64_t i = indices[k];
    if (i < 0 || static_cast<uint64_t>(i) >= ca->hdr.n_samples) {
      err.store(-1);
      return;
    }
    const uint8_t* rec = record_ptr(ca, i);
    std::memcpy(ids_out + 2 * k, rec, 2 * sizeof(int32_t));
    std::memcpy(img_out + k * img_bytes, rec + 2 * sizeof(int32_t), img_bytes);
    if (depth_out && depth_bytes) {
      std::memcpy(depth_out + k * static_cast<int64_t>(ca->hdr.h) * ca->hdr.w,
                  rec + 2 * sizeof(int32_t) + img_bytes, depth_bytes);
    }
  });
  return err.load();
}

// Readahead hint for an upcoming batch (overlaps page-in with compute).
void fl_prefetch(void* handle, const int64_t* indices, int64_t b) {
  auto* ca = static_cast<Cache*>(handle);
  long pagesz = sysconf(_SC_PAGESIZE);
  for (int64_t k = 0; k < b; ++k) {
    int64_t i = indices[k];
    if (i < 0 || static_cast<uint64_t>(i) >= ca->hdr.n_samples) continue;
    auto* p = const_cast<uint8_t*>(record_ptr(ca, i));
    auto addr = reinterpret_cast<uintptr_t>(p) & ~(pagesz - 1);
    size_t len = ca->hdr.record_bytes + (reinterpret_cast<uintptr_t>(p) - addr);
    madvise(reinterpret_cast<void*>(addr), len, MADV_WILLNEED);
  }
}

}  // extern "C"
