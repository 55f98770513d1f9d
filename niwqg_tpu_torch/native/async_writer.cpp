// Asynchronous snapshot writer: background-thread file sink so the
// simulation step loop never blocks on disk I/O (the reference's h5py
// writes stall the loop every `tsnaps` steps, niwqg/Saving.py:59-86).
//
// C ABI for ctypes binding (niwqg_tpu_torch/io_native.py):
//   aw_create(n_threads)      -> handle
//   aw_submit(h, path, data, nbytes)  (copies the buffer; returns queued count)
//   aw_pending(h)             -> writes not yet completed
//   aw_errors(h)              -> failed writes so far
//   aw_drain(h)               (block until queue empty)
//   aw_destroy(h)
//
// Built by niwqg_tpu_torch/io_native.py (g++, at first use).

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

struct Job {
  std::string path;
  std::vector<char> data;
};

struct Writer {
  std::vector<std::thread> workers;
  std::deque<Job> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_done;
  int in_flight = 0;
  long errors = 0;
  bool stop = false;

  explicit Writer(int n_threads) {
    if (n_threads < 1) n_threads = 1;
    for (int i = 0; i < n_threads; ++i) {
      workers.emplace_back([this] { this->run(); });
    }
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [this] { return stop || !queue.empty(); });
        if (queue.empty()) {
          if (stop) return;
          continue;
        }
        job = std::move(queue.front());
        queue.pop_front();
        ++in_flight;
      }
      bool ok = write_file(job);
      {
        std::lock_guard<std::mutex> lk(mu);
        --in_flight;
        if (!ok) ++errors;
        if (queue.empty() && in_flight == 0) cv_done.notify_all();
      }
    }
  }

  static bool write_file(const Job& job) {
    std::FILE* f = std::fopen(job.path.c_str(), "wb");
    if (!f) return false;
    size_t n = std::fwrite(job.data.data(), 1, job.data.size(), f);
    int rc = std::fclose(f);
    return n == job.data.size() && rc == 0;
  }

  int submit(const char* path, const void* data, uint64_t nbytes) {
    Job job;
    job.path = path;
    job.data.resize(nbytes);
    std::memcpy(job.data.data(), data, nbytes);
    int depth;
    {
      std::lock_guard<std::mutex> lk(mu);
      queue.push_back(std::move(job));
      depth = static_cast<int>(queue.size());
    }
    cv_push.notify_one();
    return depth;
  }

  int pending() {
    std::lock_guard<std::mutex> lk(mu);
    return static_cast<int>(queue.size()) + in_flight;
  }

  void drain() {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [this] { return queue.empty() && in_flight == 0; });
  }

  ~Writer() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_push.notify_all();
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

void* aw_create(int n_threads) { return new Writer(n_threads); }

int aw_submit(void* h, const char* path, const void* data, uint64_t nbytes) {
  return static_cast<Writer*>(h)->submit(path, data, nbytes);
}

int aw_pending(void* h) { return static_cast<Writer*>(h)->pending(); }

long aw_errors(void* h) {
  Writer* w = static_cast<Writer*>(h);
  std::lock_guard<std::mutex> lk(w->mu);
  return w->errors;
}

void aw_drain(void* h) { static_cast<Writer*>(h)->drain(); }

void aw_destroy(void* h) { delete static_cast<Writer*>(h); }

}  // extern "C"
