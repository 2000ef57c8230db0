// Native (C++) whitespace-table reader/writer for the ASCII fixture
// formats (model grids, model values, data points, bounds, weights).
//
// The reference's readers/writers are Fortran list-directed I/O
// (model_IO.F90:135-241, data_gravmag.f90:204-239); this is the
// package's native data-loader: a multithreaded strtod/snprintf
// scanner, ~an order of magnitude faster than numpy's loadtxt/savetxt
// on multi-million-row grids (8M cells = a ~600 MB grid file). A copy of
// the JAX package's io/_native/fasttab.cpp. Python binding via ctypes
// (tomofastx_tpu_torch/io/_native/__init__.py); every call site falls back
// to numpy when the shared library cannot be built.
//
// Semantics matched to np.loadtxt defaults: arbitrary whitespace
// separators, '\r' tolerated, '#' starts a comment to end-of-line,
// blank lines skipped. Values are C doubles (strtod — same grammar as
// Fortran list-directed reals including 'E'/'e' exponents; 'D'
// exponents are not used by any shipped fixture).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <string>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

struct Range {
  const char* begin;
  const char* end;
};

// Powers of ten exactly representable in a double (Clinger 1990): a
// decimal mantissa < 2^53 scaled by one of these in a single multiply /
// divide is correctly rounded.
const double kPow10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
    1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

// Fast float scan: Clinger fast path (mantissa <= 19 digits kept exact
// in uint64, |decimal exponent| <= 22 -> one correctly-rounded multiply);
// anything else (long mantissas, big exponents, inf/nan spellings)
// defers to strtod for bit-exact libc behavior. Returns the advanced
// pointer, or `p` itself when no number starts here.
inline const char* scan_double(const char* p, const char* end, double* out) {
  const char* start = p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  uint64_t mant = 0;
  int digits = 0;
  int extra_int = 0;  // integer digits beyond the 19 kept in `mant`
  bool any = false, overflow = false;
  while (p < end && *p >= '0' && *p <= '9') {
    any = true;
    if (digits < 19) {
      mant = mant * 10 + static_cast<uint64_t>(*p - '0');
      if (mant) ++digits;
    } else {
      overflow = true;
      ++extra_int;
    }
    ++p;
  }
  int fdigits = 0;
  if (p < end && *p == '.') {
    ++p;
    while (p < end && *p >= '0' && *p <= '9') {
      any = true;
      if (digits < 19) {
        mant = mant * 10 + static_cast<uint64_t>(*p - '0');
        if (mant) ++digits;
        ++fdigits;
      } else {
        overflow = true;
      }
      ++p;
    }
  }
  if (!any) {  // not a decimal number: let strtod try (inf/nan/hex)
    char* next = nullptr;
    double v = strtod(start, &next);
    if (next == start) return start;
    *out = v;
    return next;
  }
  int exp10 = extra_int - fdigits;
  if (p < end && (*p == 'e' || *p == 'E')) {
    const char* epos = p;
    ++p;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) {
      eneg = (*p == '-');
      ++p;
    }
    if (p < end && *p >= '0' && *p <= '9') {
      int ev = 0;
      while (p < end && *p >= '0' && *p <= '9') {
        if (ev < 100000) ev = ev * 10 + (*p - '0');
        ++p;
      }
      exp10 += eneg ? -ev : ev;
    } else {
      p = epos;  // bare 'E' belongs to the next token
    }
  }
  // Fast path: exact mantissa and small decimal exponent.
  if (!overflow && mant < (1ull << 53) && exp10 >= -22 && exp10 <= 22) {
    double v = static_cast<double>(mant);
    v = exp10 >= 0 ? v * kPow10[exp10] : v / kPow10[-exp10];
    *out = neg ? -v : v;
    return p;
  }
  char* next = nullptr;
  double v = strtod(start, &next);
  if (next == start) return start;
  *out = v;
  return next;
}

// Parse every float in [begin, end), honoring '#' comments.
void parse_range(const char* p, const char* end, std::vector<double>* out) {
  // Shipped fixtures average >= 8 bytes per value ("%.9E" is 17);
  // reserving span/8 upper-bounds the growth to one allocation.
  out->reserve(static_cast<size_t>(end - p) / 8 + 16);
  while (p < end) {
    char c = *p;
    if (c == '#') {  // comment: skip to end of line
      while (p < end && *p != '\n') ++p;
      continue;
    }
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == ',' ||
        c == '\f' || c == '\v') {
      ++p;
      continue;
    }
    double v;
    const char* next = scan_double(p, end, &v);
    if (next == p) {  // unparseable token: skip it (caller validates count)
      while (p < end && *p != ' ' && *p != '\t' && *p != '\n' &&
             *p != '\r' && *p != ',')
        ++p;
      continue;
    }
    out->push_back(v);
    p = next;
  }
}

}  // namespace

extern "C" {

// Parse all floats in `path` after skipping `skiprows` lines.
// Returns a malloc'd array of doubles (caller frees with ft_free) and
// writes the count to *n_out. Returns nullptr on I/O error (n_out = -1)
// or empty table (n_out = 0).
double* ft_parse_file(const char* path, long skiprows, long* n_out) {
  *n_out = -1;
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 0) {
    fclose(f);
    return nullptr;
  }
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  size_t rd = fread(buf.data(), 1, static_cast<size_t>(size), f);
  fclose(f);
  if (static_cast<long>(rd) != size) return nullptr;
  buf[rd] = '\0';

  const char* p = buf.data();
  const char* end = buf.data() + rd;
  for (long i = 0; i < skiprows && p < end; ++i) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    p = nl ? nl + 1 : end;
  }

  unsigned hw = std::thread::hardware_concurrency();
  size_t nthreads = std::min<size_t>(hw ? hw : 1, 16);
  size_t span = static_cast<size_t>(end - p);
  if (span < (1u << 20)) nthreads = 1;  // small file: no thread overhead

  // Split into ranges aligned to line starts so no token straddles two
  // threads (a '#' comment also cannot leak across a '\n' boundary).
  std::vector<Range> ranges;
  const char* cur = p;
  for (size_t t = 0; t < nthreads && cur < end; ++t) {
    const char* stop =
        (t + 1 == nthreads) ? end : p + span * (t + 1) / nthreads;
    if (stop < end) {
      const char* nl = static_cast<const char*>(memchr(stop, '\n', end - stop));
      stop = nl ? nl + 1 : end;
    }
    if (stop > cur) ranges.push_back({cur, stop});
    cur = stop;
  }

  std::vector<std::vector<double>> parts(ranges.size());
  std::vector<std::thread> threads;
  for (size_t t = 1; t < ranges.size(); ++t)
    threads.emplace_back(parse_range, ranges[t].begin, ranges[t].end,
                         &parts[t]);
  if (!ranges.empty()) parse_range(ranges[0].begin, ranges[0].end, &parts[0]);
  for (auto& th : threads) th.join();

  size_t total = 0;
  for (auto& v : parts) total += v.size();
  *n_out = static_cast<long>(total);
  if (total == 0) return nullptr;
  double* out = static_cast<double*>(malloc(total * sizeof(double)));
  if (!out) {
    *n_out = -1;
    return nullptr;
  }
  size_t off = 0;
  for (auto& v : parts) {
    memcpy(out + off, v.data(), v.size() * sizeof(double));
    off += v.size();
  }
  return out;
}

void ft_free(double* p) { free(p); }

// Append `nrows` x `ncols` doubles to `path` (create when append == 0),
// one space-separated row per line. `fmt` holds `ncols` NUL-separated
// printf specs, each formatting exactly one value: float conversions
// (e/E/f/F/g/G) receive the double; integer conversions (d/i) receive
// the truncated value as long long (matching numpy's %d-on-float
// semantics). Multithreaded formatting into per-chunk buffers,
// sequential write. Returns 0 on success, -1 on error.
int ft_write_table(const char* path, const double* data, long nrows,
                   long ncols, const char* fmt, int append) {
  if (nrows < 0 || ncols <= 0) return -1;

  // Split the NUL-separated specs and pre-rewrite integer conversions
  // ("%5d" -> "%5lld").
  std::vector<std::string> specs;
  std::vector<bool> is_int;
  {
    const char* p = fmt;
    for (long c = 0; c < ncols; ++c) {
      std::string s(p);
      if (s.empty() || s[0] != '%') return -1;
      p += s.size() + 1;
      char conv = s.back();
      if (conv == 'd' || conv == 'i') {
        s.insert(s.size() - 1, "ll");
        is_int.push_back(true);
      } else if (conv == 'e' || conv == 'E' || conv == 'f' || conv == 'F' ||
                 conv == 'g' || conv == 'G') {
        is_int.push_back(false);
      } else {
        return -1;
      }
      specs.push_back(s);
    }
  }

  unsigned hw = std::thread::hardware_concurrency();
  size_t nthreads = std::min<size_t>(hw ? hw : 1, 16);
  if (static_cast<size_t>(nrows) < 4096) nthreads = 1;

  std::vector<std::string> chunks(nthreads);
  auto format_rows = [&](size_t t) {
    long r0 = static_cast<long>(nrows * t / nthreads);
    long r1 = static_cast<long>(nrows * (t + 1) / nthreads);
    std::string& s = chunks[t];
    s.reserve(static_cast<size_t>(r1 - r0) * ncols * 18);
    char tmp[64];
    for (long r = r0; r < r1; ++r) {
      for (long c = 0; c < ncols; ++c) {
        double v = data[r * ncols + c];
        int n = is_int[c]
                    ? snprintf(tmp, sizeof(tmp), specs[c].c_str(),
                               static_cast<long long>(v))
                    : snprintf(tmp, sizeof(tmp), specs[c].c_str(), v);
        if (n <= 0 || n >= static_cast<int>(sizeof(tmp))) return;
        if (c) s.push_back(' ');
        s.append(tmp, n);
      }
      s.push_back('\n');
    }
  };
  std::vector<std::thread> threads;
  for (size_t t = 1; t < nthreads; ++t) threads.emplace_back(format_rows, t);
  format_rows(0);
  for (auto& th : threads) th.join();

  FILE* f = fopen(path, append ? "ab" : "wb");
  if (!f) return -1;
  for (auto& s : chunks) {
    if (fwrite(s.data(), 1, s.size(), f) != s.size()) {
      fclose(f);
      return -1;
    }
  }
  return fclose(f) == 0 ? 0 : -1;
}

}  // extern "C"
