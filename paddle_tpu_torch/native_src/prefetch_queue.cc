// Bounded multi-producer/multi-consumer byte-record queue with reader
// threads — the native data plane (the port's copy of
// paddle_tpu/native_src/prefetch_queue.cc).
//
// Parity with the reference's reader-op pipeline
// (paddle/fluid/operators/reader/: buffered_reader.cc
// double-buffer prefetch, open_files_op multi-file readers,
// lod_tensor_blocking_queue.h): N worker threads stream records out of
// recordio files into a bounded queue; Python (or any consumer) pops them
// without holding the GIL during the wait. Capacity-bounded so readers
// throttle instead of exhausting host RAM.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace recordio {
class Reader;  // from recordio.cc
}

// implemented in recordio.cc's C API
extern "C" {
void* recordio_reader_open(const char* path);
int64_t recordio_reader_next(void* r, uint8_t* buf, int64_t buf_len);
void recordio_reader_close(void* r);
}

namespace prefetch {

class Queue {
 public:
  Queue(uint32_t capacity) : capacity_(capacity) {}

  ~Queue() { Stop(); }

  void StartFiles(const std::vector<std::string>& files, int n_threads,
                  int n_epochs) {
    {
      std::lock_guard<std::mutex> g(mu_);
      files_ = files;
      next_file_ = 0;
      epochs_left_ = n_epochs;
      n_active_ = n_threads;
      done_ = false;
      stop_ = false;
    }
    for (int i = 0; i < n_threads; ++i)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  // push from any producer (also used directly by Python feeders)
  bool Push(const uint8_t* data, uint32_t len) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [this] { return q_.size() < capacity_ || stop_; });
    if (stop_) return false;
    q_.emplace_back(reinterpret_cast<const char*>(data), len);
    not_empty_.notify_one();
    return true;
  }

  // pop; returns -1 when the stream is exhausted and the queue drained
  int64_t Pop(uint8_t* buf, int64_t buf_len) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [this] { return !q_.empty() || done_ || stop_; });
    if (q_.empty()) return -1;
    const std::string& rec = q_.front();
    if (static_cast<int64_t>(rec.size()) > buf_len)
      return -2 - static_cast<int64_t>(rec.size());  // not consumed: retry
    memcpy(buf, rec.data(), rec.size());
    int64_t n = static_cast<int64_t>(rec.size());
    q_.pop_front();
    not_full_.notify_one();
    return n;
  }

  int64_t Size() {
    std::lock_guard<std::mutex> g(mu_);
    return static_cast<int64_t>(q_.size());
  }

  void MarkDone() {
    std::lock_guard<std::mutex> g(mu_);
    done_ = true;
    not_empty_.notify_all();
  }

  void Stop() {
    {
      std::lock_guard<std::mutex> g(mu_);
      stop_ = true;
      done_ = true;
      not_empty_.notify_all();
      not_full_.notify_all();
    }
    for (auto& t : workers_) t.join();
    workers_.clear();
  }

 private:
  // each worker claims files round-robin; when the file list is exhausted
  // an epoch ends and the list restarts (n_epochs<0 = loop forever)
  bool ClaimFile(std::string* path) {
    std::lock_guard<std::mutex> g(mu_);
    if (stop_ || files_.empty()) return false;
    if (next_file_ >= files_.size()) {
      if (epochs_left_ > 0) --epochs_left_;
      if (epochs_left_ == 0) return false;
      next_file_ = 0;
    }
    *path = files_[next_file_++];
    return true;
  }

  void WorkerLoop() {
    std::vector<uint8_t> buf(1 << 20);
    std::string path;
    while (ClaimFile(&path)) {
      void* r = recordio_reader_open(path.c_str());
      if (!r) continue;
      for (;;) {
        int64_t n = recordio_reader_next(r, buf.data(),
                                         static_cast<int64_t>(buf.size()));
        if (n == -1) break;
        if (n < -1) {  // grow buffer and retry would lose the record; the
          buf.resize(static_cast<size_t>(-n - 2) * 2);  // next one is fine
          continue;
        }
        if (!Push(buf.data(), static_cast<uint32_t>(n))) {
          recordio_reader_close(r);
          return;  // stopped
        }
      }
      recordio_reader_close(r);
    }
    std::lock_guard<std::mutex> g(mu_);
    if (--n_active_ == 0) {
      done_ = true;
      not_empty_.notify_all();
    }
  }

  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
  std::deque<std::string> q_;
  uint32_t capacity_;
  std::vector<std::thread> workers_;
  std::vector<std::string> files_;
  size_t next_file_ = 0;
  int epochs_left_ = 1;
  int n_active_ = 0;
  bool done_ = false;
  bool stop_ = false;
};

}  // namespace prefetch

extern "C" {

void* prefetch_queue_create(uint32_t capacity) {
  return new prefetch::Queue(capacity);
}

// files: '\n'-joined paths
void prefetch_queue_start(void* q, const char* files, int n_threads,
                          int n_epochs) {
  std::vector<std::string> fs;
  const char* p = files;
  while (*p) {
    const char* e = strchr(p, '\n');
    if (!e) {
      fs.emplace_back(p);
      break;
    }
    fs.emplace_back(p, e - p);
    p = e + 1;
  }
  static_cast<prefetch::Queue*>(q)->StartFiles(fs, n_threads, n_epochs);
}

int prefetch_queue_push(void* q, const uint8_t* data, uint32_t len) {
  return static_cast<prefetch::Queue*>(q)->Push(data, len) ? 1 : 0;
}

int64_t prefetch_queue_pop(void* q, uint8_t* buf, int64_t buf_len) {
  return static_cast<prefetch::Queue*>(q)->Pop(buf, buf_len);
}

int64_t prefetch_queue_size(void* q) {
  return static_cast<prefetch::Queue*>(q)->Size();
}

void prefetch_queue_mark_done(void* q) {
  static_cast<prefetch::Queue*>(q)->MarkDone();
}

void prefetch_queue_destroy(void* q) {
  auto* qq = static_cast<prefetch::Queue*>(q);
  qq->Stop();
  delete qq;
}
}
