// exoground_io: native feature-file IO + batched window gather for the
// PyTorch port's loader (exoground_tpu_torch/utils/native.py).
//
// The port's own copy of the JAX package's native reader, with the same C
// ABI (eg_version, eg_npy_shape, eg_npy_read_window, eg_gather_windows).
// .npy feature files are parsed and mmap'd in C++, and the hot collate
// operation -- gather B windows [start, end) from B files, pad each to a
// fixed bucket by repeating the last frame (reference loader_htm.py:13-23),
// emit the padding mask -- runs as one multithreaded call that writes
// straight into caller-provided numpy buffers. ctypes releases the GIL for
// the call, so the loader holds it for none of the IO.
//
// Host code, not a GPU kernel. Built at first use by utils/native.py:
//   g++ -O3 -std=c++17 -shared -fPIC -pthread exoground_io.cpp
// into build/native/exoground_io-<hash of this file and the flags>.so.

#include <atomic>
#include <condition_variable>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// ------------------------------------------------------------------ npy mmap

enum class Dtype { F32, F16, UNSUPPORTED };

struct NpyFile {
  int fd = -1;
  void* map = nullptr;
  size_t map_size = 0;
  const uint8_t* data = nullptr;  // first element
  int64_t rows = 0;
  int64_t cols = 0;
  Dtype dtype = Dtype::UNSUPPORTED;
};

// minimal .npy v1/v2 header parser (format spec: numpy/lib/format.py)
bool parse_npy_header(const uint8_t* buf, size_t len, size_t* data_offset,
                      int64_t* rows, int64_t* cols, Dtype* dtype) {
  if (len < 10 || std::memcmp(buf, "\x93NUMPY", 6) != 0) return false;
  const uint8_t major = buf[6];
  size_t header_len, header_start;
  if (major == 1) {
    header_len = buf[8] | (buf[9] << 8);
    header_start = 10;
  } else {
    header_len = buf[8] | (buf[9] << 8) | (buf[10] << 16) |
                 (size_t(buf[11]) << 24);
    header_start = 12;
  }
  if (header_start + header_len > len) return false;
  std::string h(reinterpret_cast<const char*>(buf + header_start), header_len);
  *data_offset = header_start + header_len;

  if (h.find("'fortran_order': True") != std::string::npos) return false;

  auto dpos = h.find("'descr':");
  if (dpos == std::string::npos) return false;
  if (h.find("<f4", dpos) != std::string::npos ||
      h.find("|f4", dpos) != std::string::npos) {
    *dtype = Dtype::F32;
  } else if (h.find("<f2", dpos) != std::string::npos) {
    *dtype = Dtype::F16;
  } else {
    *dtype = Dtype::UNSUPPORTED;
    return false;
  }

  auto spos = h.find("'shape':");
  if (spos == std::string::npos) return false;
  auto open = h.find('(', spos);
  auto close = h.find(')', open);
  if (open == std::string::npos || close == std::string::npos) return false;
  std::string shape = h.substr(open + 1, close - open - 1);
  // parse the FULL shape tuple: only 1-D/2-D arrays are valid feature files.
  // N-D files must fail the parse (the numpy plain version raises on them);
  // sscanf of just the first two dims would silently misread (T, N, C) data.
  long long dims[4] = {0, 1, -1, -1};
  int ndim = 0;
  const char* p = shape.c_str();
  while (*p && ndim < 4) {
    char* end = nullptr;
    long long v = std::strtoll(p, &end, 10);
    if (end == p) break;  // trailing comma of a 1-tuple, or spaces
    dims[ndim++] = v;
    p = end;
    while (*p == ',' || *p == ' ') ++p;
  }
  if (ndim < 1 || ndim > 2) return false;
  *rows = dims[0];
  *cols = ndim == 2 ? dims[1] : 1;
  return true;
}

bool npy_open(const char* path, NpyFile* out) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) {
    ::close(fd);
    return false;
  }
  void* map = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return false;
  }
  const uint8_t* buf = static_cast<const uint8_t*>(map);
  size_t data_offset;
  if (!parse_npy_header(buf, st.st_size, &data_offset, &out->rows, &out->cols,
                        &out->dtype)) {
    ::munmap(map, st.st_size);
    ::close(fd);
    return false;
  }
  // reject headers whose declared payload exceeds the mapped bytes: a file
  // truncated mid-write keeps a valid header claiming the full shape, and
  // copy_rows would otherwise memcpy past the mapping (SIGBUS). Division
  // form avoids rows*cols overflow.
  const uint64_t item = out->dtype == Dtype::F32 ? 4 : 2;
  const uint64_t avail =
      data_offset <= size_t(st.st_size) ? uint64_t(st.st_size) - data_offset : 0;
  // rows == 0 or cols == 0 is a legitimate empty (0, C)/(R, 0) file with
  // zero payload bytes (np.load accepts both) — only files claiming elements
  // must fit their declared payload in the mapping
  bool bounded = out->rows >= 0 && out->cols >= 0 &&
                 (out->rows == 0 || out->cols == 0 ||
                  (uint64_t(out->cols) <= avail / item &&
                   uint64_t(out->rows) <= avail / (uint64_t(out->cols) * item)));
  if (!bounded) {
    ::munmap(map, st.st_size);
    ::close(fd);
    return false;
  }
  out->fd = fd;
  out->map = map;
  out->map_size = st.st_size;
  out->data = buf + data_offset;
  return true;
}

void npy_close(NpyFile* f) {
  if (f->map) ::munmap(f->map, f->map_size);
  if (f->fd >= 0) ::close(f->fd);
  f->map = nullptr;
  f->fd = -1;
}

inline float half_to_float(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  uint32_t out;
  if (exp == 0) {
    if (mant == 0) {
      out = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while ((mant & 0x400) == 0) {
        mant <<= 1;
        exp--;
      }
      mant &= 0x3FF;
      out = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    out = sign | 0x7F800000u | (mant << 13);
  } else {
    out = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &out, sizeof(f));
  return f;
}

// copy rows [start, start+n) to dst as f32
void copy_rows(const NpyFile& f, int64_t start, int64_t n, float* dst) {
  if (f.dtype == Dtype::F32) {
    std::memcpy(dst, f.data + size_t(start) * f.cols * 4, size_t(n) * f.cols * 4);
  } else {
    const uint16_t* src =
        reinterpret_cast<const uint16_t*>(f.data) + size_t(start) * f.cols;
    for (int64_t i = 0; i < n * f.cols; ++i) dst[i] = half_to_float(src[i]);
  }
}

// ---------------------------------------------------------------- thread pool

class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { loop(); });
  }
  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void run(std::function<void()> fn) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      q_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void loop() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        fn = std::move(q_.front());
        q_.pop();
      }
      fn();
    }
  }
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> q_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

ThreadPool* pool() {
  static ThreadPool p(std::max(4u, std::thread::hardware_concurrency()));
  return &p;
}

}  // namespace

extern "C" {

int eg_version() { return 1; }

// Probe a .npy file: returns 0 on success, fills rows/cols.
int eg_npy_shape(const char* path, int64_t* rows, int64_t* cols) {
  NpyFile f;
  if (!npy_open(path, &f)) return -1;
  *rows = f.rows;
  *cols = f.cols;
  npy_close(&f);
  return 0;
}

// Read rows [start, end) of one .npy into out (f32, (end-start) x cols).
int eg_npy_read_window(const char* path, int64_t start, int64_t end,
                       float* out) {
  NpyFile f;
  if (!npy_open(path, &f)) return -1;
  if (start < 0 || end > f.rows || end < start) {
    npy_close(&f);
    return -2;
  }
  copy_rows(f, start, end - start, out);
  npy_close(&f);
  return 0;
}

// Batched window gather + pad-by-last collate.
//   paths:  n file paths (NULL-terminated strings)
//   starts/ends: window bounds per item; rows are clamped to file length
//   out:    (n, seq_bucket, dim) f32, padded tail = last valid row
//   mask:   (n, seq_bucket) uint8, 1 = PAD
// Returns number of items that failed (0 = all good); failed items are
// zero-filled with full-pad masks.
int eg_gather_windows(const char** paths, const int64_t* starts,
                      const int64_t* ends, int n, int64_t seq_bucket,
                      int64_t dim, float* out, uint8_t* mask) {
  std::atomic<int> failures{0};
  // the count of items still running is read and written under done_mu
  // only: a worker that sees it reach 0 notifies while holding the mutex,
  // so this frame (and done_mu / done_cv with it) outlives every use
  int remaining = n;
  std::mutex done_mu;
  std::condition_variable done_cv;

  for (int i = 0; i < n; ++i) {
    pool()->run([&, i] {
      float* dst = out + size_t(i) * seq_bucket * dim;
      uint8_t* m = mask + size_t(i) * seq_bucket;
      NpyFile f;
      bool ok = npy_open(paths[i], &f);
      if (ok && f.cols != dim) {
        npy_close(&f);
        ok = false;
      }
      if (!ok) {
        std::memset(dst, 0, size_t(seq_bucket) * dim * 4);
        std::memset(m, 1, seq_bucket);
        failures.fetch_add(1);
      } else {
        int64_t s = std::max<int64_t>(0, starts[i]);
        int64_t e = std::min<int64_t>(f.rows, ends[i]);
        int64_t valid = std::min<int64_t>(std::max<int64_t>(e - s, 0), seq_bucket);
        if (valid > 0) {
          copy_rows(f, s, valid, dst);
          // pad by repeating the last frame (loader_htm.py:13-23)
          for (int64_t r = valid; r < seq_bucket; ++r)
            std::memcpy(dst + r * dim, dst + (valid - 1) * dim, dim * 4);
          std::memset(m, 0, valid);
          std::memset(m + valid, 1, seq_bucket - valid);
        } else {
          // readable file, window past its end: a legitimately empty window
          // is a zero row with a full-PAD mask, NOT a failure (parity with
          // the numpy plain version and FeatureStore.read_windows)
          std::memset(dst, 0, size_t(seq_bucket) * dim * 4);
          std::memset(m, 1, seq_bucket);
        }
        npy_close(&f);
      }
      std::lock_guard<std::mutex> lk(done_mu);
      if (--remaining == 0) done_cv.notify_one();
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining == 0; });
  return failures.load();
}

}  // extern "C"
