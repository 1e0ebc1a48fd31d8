// Native streaming scan loader of the PyTorch port (patchworkpp_tpu_torch).
//
// A copy of the JAX package's native/loader.cpp with one change: a worker
// takes a free slot BEFORE it claims its scan index. Slots are emitted in
// index order, so in the original (claim, then wait for a slot) the free
// slots could all fill with later indices while the worker holding the
// next index waited for a slot and the consumer waited for that index: a
// deadlock with more than one worker. Claiming under the slot's lock means
// the worker holding the lowest outstanding index always holds a slot, so
// ordered emission cannot stall.
//
// A pool of prefetch threads reads KITTI .bin files ahead of the consumer
// and stages them as fixed-capacity padded (capacity, 4) float32 buffers
// behind a bounded ring of reusable slots (the reference reads each scan
// synchronously in its demo loop, cpp/patchworkpp/examples/
// demo_sequential.cpp:16-33).
//
// C ABI (consumed from Python via ctypes, io/native_loader.py):
//   ppk_loader_create(paths, n, capacity, depth, threads, loop) -> handle
//   ppk_loader_acquire(handle, &buf, &npts, &scan_index, &truncated)
//       -> 0 ok, 1 end, <0 err
//   ppk_loader_release(handle, buf) -> 0 ok, -1 foreign pointer (slot NOT
//       returned; a caller bug, surfaced instead of deadlocking the ring)
//   ppk_loader_io_errors(handle)     // unreadable files so far
//   ppk_loader_truncations(handle)   // scans longer than capacity so far
//   ppk_loader_destroy(handle)
//
// Built at first use by io/native_loader.py (g++ -O2 -shared -fPIC -pthread).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<float> data;  // capacity * 4 floats, zero-padded
  int npts = 0;
  int scan_index = -1;
  bool truncated = false;  // scan was longer than capacity
};

struct Loader {
  std::vector<std::string> paths;
  int capacity = 0;
  bool loop = false;

  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits: ready queue non-empty
  std::condition_variable cv_free;    // producers wait: free list non-empty
  std::deque<Slot*> ready;            // filled slots in scan order
  std::deque<Slot*> free_slots;
  std::vector<Slot> slots;

  std::atomic<int> next_to_read{0};   // next scan index to claim
  int next_to_emit = 0;               // scan order enforcement
  std::vector<Slot*> pending;         // slots filled, awaiting ordering
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<int> io_errors{0};
  std::atomic<int> truncations{0};

  ~Loader() {
    stop.store(true);
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
  }
};

// Read one .bin into a slot (zero-padding beyond npts). Returns false on IO
// error (unreadable file). A scan LONGER than capacity is truncated to
// capacity points and reported through *truncated — the caller surfaces the
// data loss (counter + per-scan flag) instead of passing it off as a
// capacity-sized scan.
bool read_scan(const std::string& path, int capacity, Slot* slot,
               bool* truncated) {
  *truncated = false;
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  size_t max_floats = static_cast<size_t>(capacity) * 4;
  size_t got = std::fread(slot->data.data(), sizeof(float), max_floats, f);
  if (got == max_floats) {
    // Capacity filled exactly: probe one byte to distinguish a scan that
    // fits exactly from one that was cut short.
    char probe;
    *truncated = std::fread(&probe, 1, 1, f) == 1;
  }
  std::fclose(f);
  size_t n = got / 4;
  slot->npts = static_cast<int>(n);
  std::memset(slot->data.data() + n * 4, 0, (max_floats - n * 4) * sizeof(float));
  return true;
}

void worker_main(Loader* L) {
  const int total = static_cast<int>(L->paths.size());
  while (!L->stop.load()) {
    // Slot first, then the index, both under the lock: the worker that
    // holds the lowest index not yet emitted always holds a slot.
    Slot* slot = nullptr;
    int idx = 0;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_free.wait(lk, [&] { return L->stop.load() || !L->free_slots.empty(); });
      if (L->stop.load()) return;
      idx = L->next_to_read.fetch_add(1);
      if (!L->loop && idx >= total) {
        L->cv_free.notify_one();  // the slot stays free: let the next worker see the end
        return;
      }
      slot = L->free_slots.front();
      L->free_slots.pop_front();
    }
    int scan_idx = L->loop ? idx % total : idx;

    slot->scan_index = idx;
    bool truncated = false;
    if (!read_scan(L->paths[scan_idx], L->capacity, slot, &truncated)) {
      L->io_errors.fetch_add(1);
      slot->npts = 0;
    }
    slot->truncated = truncated;
    if (truncated) L->truncations.fetch_add(1);

    {
      std::unique_lock<std::mutex> lk(L->mu);
      // Restore scan order: emit idx only after idx-1.
      L->pending.push_back(slot);
      bool emitted = true;
      while (emitted) {
        emitted = false;
        for (auto it = L->pending.begin(); it != L->pending.end(); ++it) {
          if ((*it)->scan_index == L->next_to_emit) {
            L->ready.push_back(*it);
            L->pending.erase(it);
            L->next_to_emit++;
            emitted = true;
            break;
          }
        }
      }
      L->cv_ready.notify_all();
    }
  }
}

}  // namespace

extern "C" {

void* ppk_loader_create(const char** paths, int n_paths, int capacity,
                        int queue_depth, int n_threads, int loop) {
  if (n_paths <= 0 || capacity <= 0 || queue_depth < 2) return nullptr;
  auto* L = new Loader();
  L->paths.assign(paths, paths + n_paths);
  L->capacity = capacity;
  L->loop = loop != 0;
  L->slots.resize(queue_depth);
  for (auto& s : L->slots) {
    s.data.assign(static_cast<size_t>(capacity) * 4, 0.0f);
    L->free_slots.push_back(&s);
  }
  int threads = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < threads; ++i) L->workers.emplace_back(worker_main, L);
  return L;
}

// Blocks until the next scan (in order) is staged. Returns 0 and sets
// (*buf, *npts, *scan_index, *truncated) on success; 1 when the dataset is
// exhausted. *truncated (may be NULL) is 1 iff this scan was longer than
// capacity and lost its tail.
int ppk_loader_acquire(void* handle, float** buf, int* npts, int* scan_index,
                       int* truncated) {
  auto* L = static_cast<Loader*>(handle);
  const int total = static_cast<int>(L->paths.size());
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] {
    if (!L->ready.empty() || L->stop.load()) return true;
    // Exhausted: every scan claimed and emitted, nothing in flight.
    return !L->loop && L->next_to_emit >= total && L->pending.empty();
  });
  if (L->ready.empty()) return 1;
  Slot* s = L->ready.front();
  L->ready.pop_front();
  *buf = s->data.data();
  *npts = s->npts;
  *scan_index = s->scan_index;
  if (truncated) *truncated = s->truncated ? 1 : 0;
  return 0;
}

// Return a slot (identified by its buffer pointer) to the free ring.
// Returns 0 on success, -1 for a pointer that is not one of this loader's
// slot buffers — a caller bug that must fail loudly (silently ignoring it
// turned a leak in the caller into an eventual acquire() deadlock once the
// free ring drained).
int ppk_loader_release(void* handle, float* buf) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  for (auto& s : L->slots) {
    if (s.data.data() == buf) {
      L->free_slots.push_back(&s);
      L->cv_free.notify_one();
      return 0;
    }
  }
  std::fprintf(stderr,
               "ppk_loader_release: foreign buffer %p (not a loader slot)\n",
               static_cast<void*>(buf));
  return -1;
}

int ppk_loader_io_errors(void* handle) {
  return static_cast<Loader*>(handle)->io_errors.load();
}

int ppk_loader_truncations(void* handle) {
  return static_cast<Loader*>(handle)->truncations.load();
}

void ppk_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
