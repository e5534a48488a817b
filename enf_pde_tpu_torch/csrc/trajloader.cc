// Background trajectory prefetcher for the npz/raw trajectory cache.
//
// The training loop's host side runs on few cores; decompressing / reading
// trajectory files synchronously between steps leaves the card waiting.
// This library maintains a small worker pool that reads raw float32 trajectory
// files (written by the Python cache) into a bounded set of buffers ahead of
// the consumer. Exposed through a minimal C ABI consumed via ctypes
// (enf_pde_tpu_torch/data/native_loader.py, which builds it at first use).
//
// Build: g++ -O2 -shared -fPIC -pthread -o libtrajloader.so trajloader.cc

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Request {
  int64_t ticket;
  std::string path;
};

struct Result {
  std::vector<float> data;
  int64_t num_floats = -1;  // -1: failed
};

class Prefetcher {
 public:
  Prefetcher(int num_threads, int max_inflight)
      : max_inflight_(max_inflight), stop_(false) {
    for (int i = 0; i < num_threads; ++i) {
      workers_.emplace_back([this] { WorkerLoop(); });
    }
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Enqueue a file read; returns a ticket to fetch the result with.
  int64_t Submit(const char* path) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_space_.wait(lk, [this] {
      return static_cast<int>(queue_.size() + results_.size()) < max_inflight_ || stop_;
    });
    int64_t ticket = next_ticket_++;
    queue_.push_back(Request{ticket, std::string(path)});
    cv_.notify_one();
    return ticket;
  }

  // Blocks until the ticket's file is loaded. Returns float count (-1: error).
  // The data stays owned by the prefetcher until Release(ticket).
  int64_t Wait(int64_t ticket, const float** out_ptr) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_done_.wait(lk, [this, ticket] { return results_.count(ticket) > 0; });
    Result& r = results_[ticket];
    *out_ptr = r.data.data();
    return r.num_floats;
  }

  void Release(int64_t ticket) {
    std::lock_guard<std::mutex> lk(mu_);
    results_.erase(ticket);
    cv_space_.notify_all();
  }

 private:
  void WorkerLoop() {
    for (;;) {
      Request req;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        req = queue_.front();
        queue_.pop_front();
      }
      Result res;
      FILE* f = std::fopen(req.path.c_str(), "rb");
      if (f != nullptr) {
        std::fseek(f, 0, SEEK_END);
        long bytes = std::ftell(f);
        std::fseek(f, 0, SEEK_SET);
        if (bytes > 0 && bytes % sizeof(float) == 0) {
          res.data.resize(bytes / sizeof(float));
          size_t got = std::fread(res.data.data(), 1, bytes, f);
          res.num_floats = (got == static_cast<size_t>(bytes))
                               ? static_cast<int64_t>(res.data.size())
                               : -1;
        }
        std::fclose(f);
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        results_[req.ticket] = std::move(res);
      }
      cv_done_.notify_all();
    }
  }

  const int max_inflight_;
  std::mutex mu_;
  std::condition_variable cv_, cv_done_, cv_space_;
  std::deque<Request> queue_;
  std::unordered_map<int64_t, Result> results_;
  std::vector<std::thread> workers_;
  int64_t next_ticket_ = 0;
  bool stop_;
};

}  // namespace

extern "C" {

void* trajloader_create(int num_threads, int max_inflight) {
  return new Prefetcher(num_threads, max_inflight);
}

void trajloader_destroy(void* h) { delete static_cast<Prefetcher*>(h); }

int64_t trajloader_submit(void* h, const char* path) {
  return static_cast<Prefetcher*>(h)->Submit(path);
}

// Copies the loaded floats into `dst` (caller-allocated, capacity `cap` floats).
// Returns the float count, -1 on read failure, -2 if cap is too small.
int64_t trajloader_fetch(void* h, int64_t ticket, float* dst, int64_t cap) {
  auto* p = static_cast<Prefetcher*>(h);
  const float* src = nullptr;
  int64_t n = p->Wait(ticket, &src);
  if (n >= 0) {
    if (n > cap) {
      p->Release(ticket);
      return -2;
    }
    std::memcpy(dst, src, n * sizeof(float));
  }
  p->Release(ticket);
  return n;
}

}  // extern "C"
