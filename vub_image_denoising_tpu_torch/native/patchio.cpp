// patchio — native host-side data-loader core of the PyTorch port: batched
// uint8 patch gather.
//
// The port's PatchLoader (data/loader.py) keeps decoded images in a
// byte-budgeted LRU cache (data/datasets.py::DecodeCache) and this function
// copies a whole batch of patches out of those cached frames in one call — one
// C pass instead of a per-sample Python __getitem__ / np.stack loop, threaded
// across patches when the host has cores to spare.  The reference's torch
// DataLoader worker pool (dataset_creation/data_loader.py:76-77) is what it
// stands in for.
//
// C ABI only (built by g++ and consumed via ctypes from
// vub_image_denoising_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// Copy one patch: rows of `patch_w * channels` bytes from a strided HWC source.
inline void copy_patch(const uint8_t* src, int64_t src_row_bytes, int64_t top,
                       int64_t left, int64_t patch_h, int64_t patch_w,
                       int64_t channels, uint8_t* dst) {
  const int64_t row_bytes = patch_w * channels;
  const uint8_t* s = src + top * src_row_bytes + left * channels;
  for (int64_t r = 0; r < patch_h; ++r) {
    std::memcpy(dst + r * row_bytes, s + r * src_row_bytes, row_bytes);
  }
}

}  // namespace

extern "C" {

// Gather n patches into a contiguous (n, patch_h, patch_w, channels) uint8 batch.
//   srcs[i]          base pointer of the decoded HWC uint8 image for patch i
//   src_row_bytes[i] byte stride between rows of image i (width * channels, unless
//                    the frame is a view)
//   tops/lefts[i]    patch origin in image i
// Threads: min(n_threads, hardware_concurrency, n); n_threads <= 1 runs inline.
void pio_gather_u8(const uint8_t** srcs, const int64_t* src_row_bytes,
                   const int64_t* tops, const int64_t* lefts, int64_t n,
                   int64_t patch_h, int64_t patch_w, int64_t channels,
                   uint8_t* out, int64_t n_threads) {
  const int64_t patch_bytes = patch_h * patch_w * channels;
  int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  const int64_t k = std::max<int64_t>(1, std::min({n_threads, hw, n}));

  auto run = [&](int64_t start, int64_t stop) {
    for (int64_t i = start; i < stop; ++i) {
      copy_patch(srcs[i], src_row_bytes[i], tops[i], lefts[i], patch_h, patch_w,
                 channels, out + i * patch_bytes);
    }
  };

  if (k == 1) {
    run(0, n);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(k);
  const int64_t chunk = (n + k - 1) / k;
  for (int64_t t = 0; t < k; ++t) {
    const int64_t start = t * chunk;
    const int64_t stop = std::min(n, start + chunk);
    if (start >= stop) break;
    workers.emplace_back(run, start, stop);
  }
  for (auto& w : workers) w.join();
}

// ABI/version probe so the Python side can reject a stale cached .so.
int64_t pio_abi_version() { return 1; }

}  // extern "C"
