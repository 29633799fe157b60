// Async batch-assembly prefetcher for the training data pipeline (the
// port's copy of ddsp_svc_tpu/data/_prefetch.cpp).
//
// The reference overlaps host IO with GPU steps via torch
// DataLoader(num_workers=2..4, data_loaders.py:96-123); this is its
// equivalent for an uncached corpus: a worker pool that preads exactly the
// crop byte ranges of the preprocessed .npy/.wav files into slot buffers
// while the previous batch is on the card. Python plans the crops (RNG,
// augmentation) and hands this library a flat job table per slot; a slot
// becomes ready when its jobs hit zero. Built with g++ at first use into
// build/prefetch/ at the repository root (data/prefetch.py).
//
// Exposed C ABI (ctypes, see data/prefetch.py):
//   pf_create(n_slots, slot_bytes, n_threads) -> handle
//   pf_open(handle, path) -> file_id (-1 on error)
//   pf_submit(handle, slot, PfJob* jobs, n_jobs) -> 0/-1
//   pf_wait(handle, slot) -> 0 on ready, -1 on job error
//   pf_buffer(handle, slot) -> float* slot base
//   pf_destroy(handle)
//
// Job kinds: 0 = raw copy of float32 bytes; 1 = PCM16 -> float32 (/32768).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

struct PfJob {
  int32_t file_id;
  int32_t kind;       // 0 = f32 copy, 1 = pcm16 -> f32
  int64_t src_off;    // byte offset in file
  int64_t n_src;      // bytes to read
  int64_t dst_off;    // byte offset in slot buffer
};

}  // extern "C"

namespace {

struct Slot {
  std::vector<uint8_t> buf;
  std::atomic<int64_t> pending{0};
  std::atomic<int> error{0};
};

struct Task {
  int slot;
  PfJob job;
};

struct Prefetcher {
  std::vector<Slot> slots;
  std::vector<int> fds;
  std::vector<std::thread> workers;
  std::deque<Task> queue;
  std::mutex mu;
  std::condition_variable cv_work;
  std::condition_variable cv_done;
  bool stop = false;

  Prefetcher(int n_slots, int64_t slot_bytes, int n_threads)
      : slots(n_slots) {
    for (auto& s : slots) s.buf.resize(slot_bytes);
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { this->worker(); });
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& w : workers) w.join();
    for (int fd : fds)
      if (fd >= 0) ::close(fd);
  }

  void run_job(const Task& t) {
    Slot& s = slots[t.slot];
    const PfJob& j = t.job;
    bool ok = j.file_id >= 0 && j.file_id < (int)fds.size();
    if (ok) {
      int fd = fds[j.file_id];
      if (j.kind == 0) {
        ok = j.dst_off + j.n_src <= (int64_t)s.buf.size();
        if (ok) {
          int64_t got = 0;
          while (got < j.n_src) {
            ssize_t r = ::pread(fd, s.buf.data() + j.dst_off + got,
                                j.n_src - got, j.src_off + got);
            if (r <= 0) break;
            got += r;
          }
          // short source (crop past EOF): zero-fill the tail, like the
          // Python path's np.pad
          if (got < j.n_src)
            std::memset(s.buf.data() + j.dst_off + got, 0, j.n_src - got);
        }
      } else {  // pcm16 -> f32: dst needs 2x the source bytes
        int64_t n_samp = j.n_src / 2;
        ok = j.dst_off + n_samp * 4 <= (int64_t)s.buf.size();
        if (ok) {
          std::vector<int16_t> tmp(n_samp, 0);
          int64_t got = 0;
          while (got < j.n_src) {
            ssize_t r = ::pread(fd, (uint8_t*)tmp.data() + got,
                                j.n_src - got, j.src_off + got);
            if (r <= 0) break;
            got += r;
          }
          if (got < j.n_src)
            std::memset((uint8_t*)tmp.data() + got, 0, j.n_src - got);
          float* dst = (float*)(s.buf.data() + j.dst_off);
          for (int64_t i = 0; i < n_samp; ++i)
            dst[i] = (float)tmp[i] / 32768.0f;
        }
      }
    }
    if (!ok) s.error.store(1);
    if (s.pending.fetch_sub(1) == 1) cv_done.notify_all();
  }

  void worker() {
    for (;;) {
      Task t;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [this] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        t = queue.front();
        queue.pop_front();
      }
      run_job(t);
    }
  }
};

}  // namespace

extern "C" {

void* pf_create(int n_slots, int64_t slot_bytes, int n_threads) {
  return new Prefetcher(n_slots, slot_bytes, n_threads);
}

int pf_open(void* h, const char* path) {
  auto* p = (Prefetcher*)h;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  std::lock_guard<std::mutex> lk(p->mu);
  p->fds.push_back(fd);
  return (int)p->fds.size() - 1;
}

int pf_submit(void* h, int slot, const PfJob* jobs, int n_jobs) {
  auto* p = (Prefetcher*)h;
  if (slot < 0 || slot >= (int)p->slots.size()) return -1;
  Slot& s = p->slots[slot];
  if (s.pending.load() != 0) return -1;  // slot still in flight
  s.error.store(0);
  s.pending.store(n_jobs);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    for (int i = 0; i < n_jobs; ++i) p->queue.push_back({slot, jobs[i]});
  }
  p->cv_work.notify_all();
  return 0;
}

int pf_wait(void* h, int slot) {
  auto* p = (Prefetcher*)h;
  Slot& s = p->slots[slot];
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_done.wait(lk, [&s] { return s.pending.load() == 0; });
  return s.error.load() ? -1 : 0;
}

void* pf_buffer(void* h, int slot) {
  auto* p = (Prefetcher*)h;
  return p->slots[slot].buf.data();
}

void pf_destroy(void* h) { delete (Prefetcher*)h; }

}  // extern "C"
