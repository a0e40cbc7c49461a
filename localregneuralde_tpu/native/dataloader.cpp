// Native prefetching batch loader.
//
// Equivalent of the reference's threaded host data pipeline
// (MLUtils.eachobsparallel with a FLoops ThreadedEx executor and a buffered
// channel, reference experiments/src/utils.jl:155-166): worker threads gather
// shuffled rows from pinned host arrays into batch buffers feeding a bounded
// ring queue, so batch assembly overlaps device compute and the Python/JAX
// thread only ever memcpy-free hands off ready batches.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -fPIC -shared dataloader.cpp -o libnativeloader.so -lpthread

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <numeric>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Batch {
  std::vector<std::vector<uint8_t>> buffers;  // one per array
  int64_t index;                              // monotonically increasing
};

struct Loader {
  // dataset description
  std::vector<const uint8_t*> arrays;
  std::vector<int64_t> row_bytes;
  int64_t n_rows = 0;
  int64_t batch_size = 0;
  bool shuffle = false;
  bool drop_last = true;
  bool cycle = false;
  uint64_t seed = 0;
  int64_t skip_batches = 0;  // fast-forward for exact checkpoint resume

  // queue
  size_t capacity = 4;
  std::queue<Batch> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<bool> stop{false};
  bool finished = false;  // producer exhausted (non-cycle mode)

  std::thread producer;

  int64_t batches_per_epoch() const {
    return drop_last ? n_rows / batch_size
                     : (n_rows + batch_size - 1) / batch_size;
  }

  void produce() {
    std::vector<int64_t> idx(n_rows);
    std::iota(idx.begin(), idx.end(), 0);
    const int64_t nb = batches_per_epoch();
    // index-only fast-forward: a resumed run replays the SAME epoch
    // permutations (seed + epoch) and starts mid-epoch, so the resumed
    // batch stream is bitwise-identical to the uninterrupted run's
    int64_t epoch = nb > 0 ? skip_batches / nb : 0;
    int64_t b_start = nb > 0 ? skip_batches % nb : 0;
    int64_t batch_counter = skip_batches;
    while (!stop.load()) {
      if (shuffle) {
        // history-free per-epoch permutation (re-iota before shuffling):
        // epoch k's ordering depends only on (seed, k), so a resumed
        // loader that jumps straight to epoch k reproduces it exactly
        std::iota(idx.begin(), idx.end(), 0);
        std::mt19937_64 rng(seed + static_cast<uint64_t>(epoch));
        std::shuffle(idx.begin(), idx.end(), rng);
      }
      for (int64_t b = b_start; b < nb && !stop.load(); ++b) {
        const int64_t start = b * batch_size;
        const int64_t count =
            std::min(batch_size, n_rows - start);
        Batch batch;
        batch.index = batch_counter++;
        batch.buffers.resize(arrays.size());
        for (size_t a = 0; a < arrays.size(); ++a) {
          const int64_t rb = row_bytes[a];
          batch.buffers[a].resize(static_cast<size_t>(count) * rb);
          uint8_t* dst = batch.buffers[a].data();
          for (int64_t r = 0; r < count; ++r) {
            std::memcpy(dst + r * rb, arrays[a] + idx[start + r] * rb,
                        static_cast<size_t>(rb));
          }
        }
        std::unique_lock<std::mutex> lock(mu);
        cv_push.wait(lock, [&] {
          return queue.size() < capacity || stop.load();
        });
        if (stop.load()) return;
        queue.push(std::move(batch));
        cv_pop.notify_one();
      }
      if (!cycle) break;
      ++epoch;
      b_start = 0;
    }
    std::lock_guard<std::mutex> lock(mu);
    finished = true;
    cv_pop.notify_all();
  }
};

}  // namespace

extern "C" {

Loader* dl_create(int n_arrays, const void** arrays, const int64_t* row_bytes,
                  int64_t n_rows, int64_t batch_size, int shuffle,
                  uint64_t seed, int queue_cap, int drop_last, int cycle,
                  int64_t skip_batches) {
  auto* loader = new Loader();
  for (int i = 0; i < n_arrays; ++i) {
    loader->arrays.push_back(static_cast<const uint8_t*>(arrays[i]));
    loader->row_bytes.push_back(row_bytes[i]);
  }
  loader->n_rows = n_rows;
  loader->batch_size = batch_size;
  loader->shuffle = shuffle != 0;
  loader->seed = seed;
  loader->capacity = queue_cap > 0 ? static_cast<size_t>(queue_cap) : 4;
  loader->drop_last = drop_last != 0;
  loader->cycle = cycle != 0;
  loader->skip_batches = skip_batches > 0 ? skip_batches : 0;
  loader->producer = std::thread([loader] { loader->produce(); });
  return loader;
}

// Copy the next ready batch into caller buffers. Returns the number of rows
// in the batch, or -1 when the (non-cycling) stream is exhausted.
int64_t dl_next(Loader* loader, void** dst) {
  Batch batch;
  {
    std::unique_lock<std::mutex> lock(loader->mu);
    loader->cv_pop.wait(lock, [&] {
      return !loader->queue.empty() || loader->finished || loader->stop.load();
    });
    if (loader->queue.empty()) return -1;
    batch = std::move(loader->queue.front());
    loader->queue.pop();
    loader->cv_push.notify_one();
  }
  int64_t rows = -1;
  for (size_t a = 0; a < batch.buffers.size(); ++a) {
    std::memcpy(dst[a], batch.buffers[a].data(), batch.buffers[a].size());
    rows = static_cast<int64_t>(batch.buffers[a].size()) /
           loader->row_bytes[a];
  }
  return rows;
}

int64_t dl_batches_per_epoch(Loader* loader) {
  return loader->batches_per_epoch();
}

void dl_destroy(Loader* loader) {
  loader->stop.store(true);
  loader->cv_push.notify_all();
  loader->cv_pop.notify_all();
  if (loader->producer.joinable()) loader->producer.join();
  delete loader;
}

}  // extern "C"
