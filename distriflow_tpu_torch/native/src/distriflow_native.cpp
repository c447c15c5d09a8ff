// Native host-side kernels of distriflow_tpu_torch: the port's own copy of
// the JAX package's distriflow_native.cpp, the same C ABI and the same
// arithmetic, loaded with ctypes by distriflow_tpu_torch/native/__init__.py
// (numpy paths with the reference's semantics when no compiler is present):
//
//   - df_gather_rows: assemble a batch by gathering rows into a contiguous
//     buffer (the DistributedDataset get_batch hot path, reference
//     dataset.ts:69-85 slice).
//   - df_mean_f32: elementwise mean over N clients' gradient buffers (the
//     federated "stack + mean(0)" aggregation, reference
//     federated_server.ts:96-109 / utils.ts:53-75).
//
// Device-side numerics stay on the card: these kernels only touch host
// memory on the wire/coordination path.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Spawn up to n_threads workers over [0, n) in contiguous chunks. Small
// inputs run inline: thread spawn costs more than the memcpy it saves.
template <typename Fn>
void parallel_chunks(uint64_t n, uint64_t grain, int n_threads, Fn fn) {
  if (n_threads <= 1 || n <= grain) {
    fn(0, n);
    return;
  }
  uint64_t max_workers = (n + grain - 1) / grain;
  uint64_t workers = static_cast<uint64_t>(n_threads) < max_workers
                         ? static_cast<uint64_t>(n_threads)
                         : max_workers;
  uint64_t chunk = (n + workers - 1) / workers;
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (uint64_t w = 0; w < workers; ++w) {
    uint64_t lo = w * chunk;
    uint64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// dst[i, :] = src[idx[i], :] for row_bytes-wide rows. idx values must be
// in [0, n_src_rows); caller validates (the Python wrapper does).
void df_gather_rows(const uint8_t* src, uint64_t row_bytes,
                    const int64_t* idx, uint64_t n_idx, uint8_t* dst,
                    int n_threads) {
  const uint64_t grain = row_bytes > 0 ? (1 << 20) / row_bytes + 1 : n_idx;
  parallel_chunks(n_idx, grain, n_threads, [=](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
    }
  });
}

// dst[j] = mean_i srcs[i][j] over n_srcs float32 buffers of n_elems each.
void df_mean_f32(const float* const* srcs, uint64_t n_srcs, uint64_t n_elems,
                 float* dst, int n_threads) {
  const float inv = n_srcs > 0 ? 1.0f / static_cast<float>(n_srcs) : 0.0f;
  parallel_chunks(n_elems, 1 << 16, n_threads, [=](uint64_t lo, uint64_t hi) {
    for (uint64_t j = lo; j < hi; ++j) {
      float acc = 0.0f;
      for (uint64_t i = 0; i < n_srcs; ++i) acc += srcs[i][j];
      dst[j] = acc * inv;
    }
  });
}

// Sanity/version probe for the ctypes loader.
int df_abi_version() { return 1; }

}  // extern "C"
