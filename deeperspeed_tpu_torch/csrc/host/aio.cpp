// Asynchronous whole-file IO on a pool of threads (the port's copy of the
// repository's csrc/aio/dst_aio.cpp).
//
// Host code, not a device kernel: the NVMe optimizer tier, ZeRO-Infinity's
// chunk store and the async checkpoint writer hand whole-file reads and
// writes to worker threads that drain a submission queue with POSIX
// pread/pwrite, so the training loop does not block on the disk.
//
// A write goes to ``<path>.dst_tmp``, optionally fsync'd, then renamed onto
// ``path``: a file is either absent, the old content or the whole new one.
// A write to a descriptor (dst_aio_pwrite_fd) only writes the bytes: the
// caller opened the file and keeps its fsync, close and rename.
//
// C ABI for ctypes.  Buffer lifetime contract: the caller keeps every
// buffer it submitted alive until dst_aio_wait() returns.

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Request {
  bool is_write;
  std::string path;
  int fd;  // >= 0: write to this open descriptor, which the caller keeps
  void* buf;
  int64_t nbytes;
  bool fsync_on_close;
};

class AioPool {
 public:
  explicit AioPool(int num_threads) : stop_(false), pending_(0), error_(0) {
    for (int i = 0; i < num_threads; ++i)
      workers_.emplace_back([this] { Run(); });
  }

  ~AioPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  void Submit(Request req) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      queue_.push_back(std::move(req));
      ++pending_;
    }
    cv_.notify_one();
  }

  int Wait() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_ == 0; });
    return error_.exchange(0);
  }

  int Pending() {
    std::lock_guard<std::mutex> lk(mu_);
    return pending_;
  }

 private:
  void Run() {
    for (;;) {
      Request req;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        req = std::move(queue_.front());
        queue_.pop_front();
      }
      int err = Execute(req);
      if (err != 0) {
        int expected = 0;  // keep the first failure's errno for Wait()
        error_.compare_exchange_strong(expected, err);
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        --pending_;
      }
      done_cv_.notify_all();
    }
  }

  static int WriteAll(int fd, const void* buf, int64_t nbytes) {
    int64_t off = 0;
    const char* p = static_cast<const char*>(buf);
    while (off < nbytes) {
      ssize_t w = ::pwrite(fd, p + off, nbytes - off, off);
      if (w < 0) return -errno;
      off += w;
    }
    return 0;
  }

  static int Execute(const Request& req) {
    if (req.is_write && req.fd >= 0) return WriteAll(req.fd, req.buf, req.nbytes);
    if (req.is_write) {
      std::string tmp = req.path + ".dst_tmp";
      int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
      if (fd < 0) return -errno;
      int err = WriteAll(fd, req.buf, req.nbytes);
      if (err != 0) {
        ::close(fd);
        ::unlink(tmp.c_str());
        return err;
      }
      if (req.fsync_on_close && ::fsync(fd) != 0) {
        int e = errno;
        ::close(fd);
        ::unlink(tmp.c_str());
        return -e;
      }
      ::close(fd);
      if (::rename(tmp.c_str(), req.path.c_str()) != 0) return -errno;
      return 0;
    }
    int fd = ::open(req.path.c_str(), O_RDONLY);
    if (fd < 0) return -errno;
    int64_t off = 0;
    char* p = static_cast<char*>(req.buf);
    while (off < req.nbytes) {
      ssize_t r = ::pread(fd, p + off, req.nbytes - off, off);
      if (r < 0) {
        int e = errno;
        ::close(fd);
        return -e;
      }
      if (r == 0) break;  // a short file: the caller sized the buffer
      off += r;
    }
    ::close(fd);
    return off == req.nbytes ? 0 : -EIO;
  }

  std::vector<std::thread> workers_;
  std::deque<Request> queue_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  bool stop_;
  int pending_;
  std::atomic<int> error_;
};

}  // namespace

extern "C" {

void* dst_aio_create(int num_threads) {
  if (num_threads < 1) num_threads = 1;
  return new AioPool(num_threads);
}

void dst_aio_destroy(void* h) { delete static_cast<AioPool*>(h); }

void dst_aio_pwrite(void* h, const char* path, const void* buf, int64_t nbytes,
                    int fsync_on_close) {
  static_cast<AioPool*>(h)->Submit(
      {true, path, -1, const_cast<void*>(buf), nbytes, fsync_on_close != 0});
}

void dst_aio_pwrite_fd(void* h, int fd, const void* buf, int64_t nbytes) {
  static_cast<AioPool*>(h)->Submit(
      {true, std::string(), fd, const_cast<void*>(buf), nbytes, false});
}

void dst_aio_pread(void* h, const char* path, void* buf, int64_t nbytes) {
  static_cast<AioPool*>(h)->Submit({false, path, -1, buf, nbytes, false});
}

// Blocks until the queue drains; returns 0 or the negative errno of the
// first request that failed since the last wait.
int dst_aio_wait(void* h) { return static_cast<AioPool*>(h)->Wait(); }

int dst_aio_pending(void* h) { return static_cast<AioPool*>(h)->Pending(); }

}  // extern "C"
