// Native prefetching dataloader core.
//
// TPU-native counterpart of the reference's C++ batched prefetching loader
// (hetu/graph/data/dataloader.h:18 — background batch assembly with a
// worker queue, shuffle, drop_last, and dp-rank sharding via set_dp_rank,
// dataloader.h:116).  Host-side only: assembles contiguous batch buffers
// from fixed-stride sample rows on background threads so the accelerator
// step never waits on Python-side indexing.
//
// C ABI, loaded via ctypes (see hetu_tpu/csrc/build.py).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Batch {
  std::vector<uint8_t> buf;
  int32_t rows = 0;
};

struct Loader {
  const uint8_t* data = nullptr;
  int64_t num_samples = 0;
  int64_t row_bytes = 0;
  int32_t batch_size = 0;
  bool shuffle = false;
  bool drop_last = true;
  // dp sharding: this loader yields the dp_rank-th of dp_nrank disjoint
  // sample shards (reference Dataloader::set_dp_rank)
  int32_t dp_rank = 0;
  int32_t dp_nrank = 1;

  std::vector<int64_t> order;   // local (sharded) sample indices
  int64_t cursor = 0;           // next sample in `order`

  // prefetch machinery
  size_t queue_cap = 2;
  std::deque<Batch> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::thread worker;
  std::atomic<bool> stop{false};
  bool epoch_done = false;

  int64_t num_batches() const {
    const int64_t n = static_cast<int64_t>(order.size());
    if (drop_last) return n / batch_size;
    return (n + batch_size - 1) / batch_size;
  }

  void build_order(uint64_t seed) {
    order.clear();
    for (int64_t i = dp_rank; i < num_samples; i += dp_nrank)
      order.push_back(i);
    if (shuffle) {
      std::mt19937_64 rng(seed);
      std::shuffle(order.begin(), order.end(), rng);
    }
    cursor = 0;
  }

  bool assemble(Batch& out) {
    const int64_t n = static_cast<int64_t>(order.size());
    if (cursor >= n) return false;
    int64_t take = std::min<int64_t>(batch_size, n - cursor);
    if (take < batch_size && drop_last) return false;
    out.rows = static_cast<int32_t>(take);
    out.buf.resize(static_cast<size_t>(batch_size) * row_bytes);
    for (int64_t r = 0; r < take; ++r) {
      std::memcpy(out.buf.data() + r * row_bytes,
                  data + order[cursor + r] * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
    cursor += take;
    return true;
  }

  void run() {
    while (true) {
      Batch b;
      const bool ok = assemble(b);
      std::unique_lock<std::mutex> lk(mu);
      if (!ok) {
        epoch_done = true;
        cv_pop.notify_all();
        return;
      }
      cv_push.wait(lk, [&] {
        return stop.load() || queue.size() < queue_cap;
      });
      if (stop.load()) return;
      queue.push_back(std::move(b));
      cv_pop.notify_one();
    }
  }

  void start() {
    epoch_done = false;
    stop.store(false);
    worker = std::thread([this] { run(); });
  }

  void join() {
    stop.store(true);
    cv_push.notify_all();
    if (worker.joinable()) worker.join();
  }
};

}  // namespace

extern "C" {

void* hetu_loader_create(const void* data, int64_t num_samples,
                         int64_t row_bytes, int32_t batch_size,
                         int32_t queue_size, int32_t shuffle, uint64_t seed,
                         int32_t drop_last, int32_t dp_rank,
                         int32_t dp_nrank) {
  auto* l = new Loader();
  l->data = static_cast<const uint8_t*>(data);
  l->num_samples = num_samples;
  l->row_bytes = row_bytes;
  l->batch_size = batch_size;
  l->queue_cap = queue_size > 0 ? static_cast<size_t>(queue_size) : 2;
  l->shuffle = shuffle != 0;
  l->drop_last = drop_last != 0;
  l->dp_rank = dp_nrank > 1 ? dp_rank : 0;
  l->dp_nrank = dp_nrank > 1 ? dp_nrank : 1;
  l->build_order(seed);
  l->start();
  return l;
}

int64_t hetu_loader_num_batches(void* handle) {
  return static_cast<Loader*>(handle)->num_batches();
}

// Blocks until the next prefetched batch is ready and copies it into
// `out` (batch_size*row_bytes).  Returns the number of valid rows, or 0
// at epoch end.
int32_t hetu_loader_next(void* handle, void* out) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv_pop.wait(lk, [&] { return !l->queue.empty() || l->epoch_done; });
  if (l->queue.empty()) return 0;
  Batch b = std::move(l->queue.front());
  l->queue.pop_front();
  l->cv_push.notify_one();
  lk.unlock();
  std::memcpy(out, b.buf.data(), b.buf.size());
  return b.rows;
}

// Restart an epoch (optionally reshuffled with a new seed).
void hetu_loader_reset(void* handle, uint64_t seed) {
  auto* l = static_cast<Loader*>(handle);
  l->join();
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->queue.clear();
  }
  l->build_order(seed);
  l->start();
}

void hetu_loader_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  l->join();
  delete l;
}

}  // extern "C"
