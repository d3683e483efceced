// Native host I/O of the PyTorch port: an mmap'd ratings parser on every
// core and the fixed-9-decimal factor writer. C ABI, loaded with ctypes by
// qmf_tpu_torch/data/native.py, which builds this file with g++ at first use
// into qmf_tpu_torch/_build/.
//
// A copy of qmf_tpu/_native/qmf_native.cpp, with the same three entry points
// (qmf_count_lines, qmf_read_dataset, qmf_write_factors), the same formats
// and the same error codes. The reference's loader is C++ too
// (qmf/DatasetReader.cpp: getline + sscanf, one thread) and so is its factor
// writer (iostream at fixed 9-decimal precision, qmf/Engine.cpp:98-122).

#include <cctype>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    size = static_cast<size_t>(st.st_size);
    if (size == 0) {
      data = "";
      return true;
    }
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) return false;
    madvise(p, size, MADV_SEQUENTIAL);
    data = static_cast<const char*>(p);
    return true;
  }

  ~MappedFile() {
    if (data && size) munmap(const_cast<char*>(data), size);
    if (fd >= 0) close(fd);
  }
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// parse int64; returns nullptr on failure
inline const char* parse_i64(const char* p, const char* end, long long* out) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  if (p >= end || !isdigit(static_cast<unsigned char>(*p))) return nullptr;
  long long v = 0;
  while (p < end && isdigit(static_cast<unsigned char>(*p))) {
    v = v * 10 + (*p++ - '0');
  }
  *out = neg ? -v : v;
  return p;
}

// parse double (fixed/scientific). The mmap'd buffer is not NUL-terminated
// (strtod straight on it could fault on a page-aligned tail), so first scan
// the token extent fully bounds-checked, then strtod a bounded local copy —
// bit-exact with the reference's sscanf %lf (qmf/DatasetReader.cpp:33).
// Requires at least one mantissa digit: a bare "." / "-." is a parse error,
// not 0.0. Returns nullptr on failure.
inline const char* parse_f64(const char* p, const char* end, double* out) {
  p = skip_ws(p, end);
  const char* start = p;
  if (p < end && (*p == '-' || *p == '+')) ++p;
  bool any_digit = false;
  while (p < end && isdigit(static_cast<unsigned char>(*p))) {
    ++p;
    any_digit = true;
  }
  if (p < end && *p == '.') {
    ++p;
    while (p < end && isdigit(static_cast<unsigned char>(*p))) {
      ++p;
      any_digit = true;
    }
  }
  if (!any_digit) return nullptr;
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    if (p < end && (*p == '-' || *p == '+')) ++p;
    if (p >= end || !isdigit(static_cast<unsigned char>(*p))) return nullptr;
    while (p < end && isdigit(static_cast<unsigned char>(*p))) ++p;
  }
  char buf[512];
  size_t len = static_cast<size_t>(p - start);
  if (len >= sizeof(buf)) return nullptr;
  memcpy(buf, start, len);
  buf[len] = '\0';
  char* endp = nullptr;
  double v = strtod(buf, &endp);
  if (endp != buf + len) return nullptr;
  *out = v;
  return p;
}

size_t count_lines_range(const char* p, const char* end) {
  size_t n = 0;
  while (p < end) {
    const void* nl = memchr(p, '\n', static_cast<size_t>(end - p));
    if (!nl) {
      // final line without trailing newline
      const char* q = skip_ws(p, end);
      if (q < end) ++n;
      break;
    }
    // count only non-blank lines
    const char* q = skip_ws(p, static_cast<const char*>(nl));
    if (q < static_cast<const char*>(nl)) ++n;
    p = static_cast<const char*>(nl) + 1;
  }
  return n;
}

// physical newline count in [p, end) — for 1-based error line numbers
size_t count_newlines(const char* p, const char* end) {
  size_t n = 0;
  while (p < end) {
    const void* nl = memchr(p, '\n', static_cast<size_t>(end - p));
    if (!nl) break;
    ++n;
    p = static_cast<const char*>(nl) + 1;
  }
  return n;
}

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 1 : static_cast<int>(n);
}

}  // namespace

extern "C" {

// Count non-blank lines (= capacity needed). Returns -1 on open failure.
long long qmf_count_lines(const char* path) {
  MappedFile mf;
  if (!mf.open(path)) return -1;
  return static_cast<long long>(count_lines_range(mf.data, mf.data + mf.size));
}

// Parse "<user> <item> <value>" lines into the output arrays.
// Returns number parsed (>= 0), or a distinct error code:
//   QMF_ERR_OPEN (-1)      file could not be opened/mapped
//   QMF_ERR_CAPACITY (-2)  more lines than `capacity` (file grew after
//                          qmf_count_lines)
//   QMF_ERR_PARSE (-3)     malformed line; *err_line (1-based) says which
// err_line may be NULL.
#define QMF_ERR_OPEN (-1)
#define QMF_ERR_CAPACITY (-2)
#define QMF_ERR_PARSE (-3)
long long qmf_read_dataset(const char* path,
                           long long* users,
                           long long* items,
                           double* values,
                           long long capacity,
                           long long* err_line) {
  MappedFile mf;
  if (!mf.open(path)) return QMF_ERR_OPEN;
  const char* begin = mf.data;
  const char* end = mf.data + mf.size;

  // split into per-thread byte ranges aligned to line starts
  int nthreads = hw_threads();
  if (mf.size < (1u << 20)) nthreads = 1;
  std::vector<const char*> starts(nthreads + 1);
  starts[0] = begin;
  starts[nthreads] = end;
  for (int t = 1; t < nthreads; ++t) {
    const char* p = begin + (mf.size * t) / nthreads;
    const void* nl = memchr(p, '\n', static_cast<size_t>(end - p));
    starts[t] = nl ? static_cast<const char*>(nl) + 1 : end;
  }

  // per-thread counts first (so outputs are written contiguously in order)
  std::vector<size_t> counts(nthreads);
  std::vector<std::thread> pool;
  for (int t = 0; t < nthreads; ++t) {
    pool.emplace_back([&, t] {
      counts[t] = count_lines_range(starts[t], starts[t + 1]);
    });
  }
  for (auto& th : pool) th.join();
  pool.clear();

  std::vector<size_t> offsets(nthreads + 1, 0);
  for (int t = 0; t < nthreads; ++t) offsets[t + 1] = offsets[t] + counts[t];
  if (static_cast<long long>(offsets[nthreads]) > capacity) {
    return QMF_ERR_CAPACITY;
  }

  std::atomic<long long> bad_line{0};
  std::vector<size_t> line_base(nthreads, 0);
  // approximate line numbers: count lines before each range lazily on error
  for (int t = 0; t < nthreads; ++t) {
    pool.emplace_back([&, t] {
      const char* p = starts[t];
      const char* rend = starts[t + 1];
      size_t out = offsets[t];
      while (p < rend) {
        const void* nlv = memchr(p, '\n', static_cast<size_t>(rend - p));
        const char* nl = nlv ? static_cast<const char*>(nlv) : rend;
        const char* q = skip_ws(p, nl);
        if (q < nl) {  // non-blank
          long long u, i;
          double v;
          const char* c = parse_i64(q, nl, &u);
          if (c) c = parse_i64(c, nl, &i);
          if (c) c = parse_f64(c, nl, &v);
          if (!c) {
            // p is the start of the offending line: its physical 1-based
            // number is (newlines before it) + 1
            long long global_line =
                static_cast<long long>(count_newlines(begin, p) + 1);
            bad_line.store(global_line, std::memory_order_relaxed);
            return;
          }
          users[out] = u;
          items[out] = i;
          values[out] = v;
          ++out;
        }
        p = nl + 1;
      }
    });
  }
  for (auto& th : pool) th.join();
  if (bad_line.load()) {
    if (err_line) *err_line = bad_line.load();
    return QMF_ERR_PARSE;
  }
  return static_cast<long long>(offsets[nthreads]);
}

// Write "id [bias] f0 ... f{k-1}" lines at fixed 9-decimal precision
// (format parity with reference qmf/Engine.cpp:105-121). Returns 0 on ok.
int qmf_write_factors(const char* path,
                      const long long* ids,
                      const double* factors,
                      const double* biases,  // nullable
                      long long nelems,
                      long long nfactors) {
  FILE* f = fopen(path, "w");
  if (!f) return 1;
  std::vector<char> buf(1 << 22);
  setvbuf(f, buf.data(), _IOFBF, buf.size());
  char num[64];
  for (long long i = 0; i < nelems; ++i) {
    int n = snprintf(num, sizeof(num), "%lld", ids[i]);
    fwrite(num, 1, static_cast<size_t>(n), f);
    if (biases) {
      n = snprintf(num, sizeof(num), " %.9f", biases[i]);
      fwrite(num, 1, static_cast<size_t>(n), f);
    }
    const double* row = factors + i * nfactors;
    for (long long j = 0; j < nfactors; ++j) {
      n = snprintf(num, sizeof(num), " %.9f", row[j]);
      fwrite(num, 1, static_cast<size_t>(n), f);
    }
    fputc('\n', f);
  }
  int rc = ferror(f);
  fclose(f);
  return rc ? 1 : 0;
}

}  // extern "C"
