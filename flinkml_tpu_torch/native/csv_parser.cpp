// Multithreaded numeric-CSV parser with a C ABI for ctypes.
//
// The port's copy of flinkml_tpu/native/csv_parser.cpp, unchanged but for
// these comments. Companion to libsvm_parser.cpp: host ingest fast enough
// that the GPU does not wait on text parsing (the reference reads CSV
// through Flink's table connectors, record-at-a-time on the JVM).
//
// Scope: numeric CSV — every field parses as a floating-point number,
// empty fields become NaN. No quoting support (documented; ML feature
// tables are numeric). '\r\n' and '\n' line endings; blank lines skipped.
// The column count is fixed by the first data row; any row with a
// different field count is a hard error reported by row number.
//
// Two passes over thread-private chunks split at line boundaries:
//   pass 1 counts rows and validates field counts,
//   pass 2 fills a caller-allocated COLUMN-MAJOR float64 buffer
//   (out[col * rows + row]) so each column is a contiguous numpy view —
//   zero per-column copies on the Python side.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o csv_parser.so \
//            csv_parser.cpp -lpthread
// (flinkml_tpu_torch.io.csv compiles this on demand into native/build/.)

#include <charconv>
#include <string>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Chunk {
  const char* begin;
  const char* end;
  int64_t rows = 0;
  int64_t row_offset = 0;  // filled after prefix sum
  int64_t bad_row = -1;    // chunk-local index of first malformed row
};

struct Parser {
  const char* buf;
  int64_t len;
  char delim;
  std::vector<Chunk> chunks;
  int64_t total_rows = 0;
  int64_t cols = 0;
  int64_t bad_row = -1;  // global row number of first malformed row
};

// Field count of one line (delimiters + 1); lines are never empty here.
inline int64_t count_fields(const char* p, const char* eol, char delim) {
  int64_t n = 1;
  for (; p < eol; ++p) n += (*p == delim);
  return n;
}

// Parses one line into out (nullptr = count/validate only).
// Returns the number of fields, or -1 on a malformed numeric field.
inline int64_t parse_line(const char* p, const char* eol, char delim,
                          double* out, int64_t stride, int64_t row) {
  int64_t field = 0;
  while (true) {
    const char* fstart = p;
    while (p < eol && *p != delim) ++p;
    const char* fend = p;
    // Trim surrounding spaces/tabs and a trailing '\r'.
    while (fstart < fend && (*fstart == ' ' || *fstart == '\t')) ++fstart;
    while (fend > fstart &&
           (fend[-1] == ' ' || fend[-1] == '\t' || fend[-1] == '\r'))
      --fend;
    double v;
    if (fstart == fend) {
      v = __builtin_nan("");  // empty field -> NaN
    } else {
      // from_chars: locale-free, non-copying; accept a leading '+' for
      // parity with the Python fallback's float(). Out-of-range values
      // (1e400, 1e-400) take a rare strtod path so overflow saturates to
      // +/-inf and underflow to ~0 exactly as Python does.
      const char* numstart = (*fstart == '+') ? fstart + 1 : fstart;
      auto [endp, ec] = std::from_chars(numstart, fend, v);
      if (ec == std::errc::result_out_of_range && endp == fend) {
        // Heap copy: fields like "1" + 400 zeros are valid (-> inf).
        std::string tmp(numstart, static_cast<size_t>(fend - numstart));
        v = strtod(tmp.c_str(), nullptr);
      } else if (ec != std::errc() || endp != fend) {
        return -1;
      }
    }
    if (out != nullptr) out[field * stride + row] = v;
    ++field;
    if (p >= eol) break;
    ++p;  // skip delimiter
  }
  return field;
}

// True if the line is blank (only spaces/tabs/'\r').
inline bool is_blank(const char* p, const char* eol) {
  for (; p < eol; ++p)
    if (*p != ' ' && *p != '\t' && *p != '\r') return false;
  return true;
}

void split_chunks(Parser& ps, int nthreads) {
  int64_t target = ps.len / nthreads + 1;
  const char* pos = ps.buf;
  const char* bufend = ps.buf + ps.len;
  for (int t = 0; t < nthreads && pos < bufend; ++t) {
    const char* end = pos + target;
    if (end >= bufend) {
      end = bufend;
    } else {
      while (end < bufend && *end != '\n') ++end;
      if (end < bufend) ++end;  // include the newline
    }
    Chunk c;
    c.begin = pos;
    c.end = end;
    ps.chunks.push_back(c);
    pos = end;
  }
}

void count_chunk(Chunk& c, char delim, int64_t cols) {
  const char* p = c.begin;
  int64_t local = 0;
  while (p < c.end) {
    const char* eol = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(c.end - p)));
    const char* line_end = eol ? eol : c.end;
    if (!is_blank(p, line_end)) {
      if (count_fields(p, line_end, delim) != cols && c.bad_row < 0)
        c.bad_row = local;
      ++local;
    }
    p = eol ? eol + 1 : c.end;
  }
  c.rows = local;
}

void fill_chunk(const Chunk& c, char delim, int64_t cols, int64_t total_rows,
                double* out, int64_t* bad) {
  const char* p = c.begin;
  int64_t row = c.row_offset;
  while (p < c.end) {
    const char* eol = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(c.end - p)));
    const char* line_end = eol ? eol : c.end;
    if (!is_blank(p, line_end)) {
      int64_t got = parse_line(p, line_end, delim, out, total_rows, row);
      if (got != cols && *bad < 0) *bad = row;
      ++row;
    }
    p = eol ? eol + 1 : c.end;
  }
}

}  // namespace

extern "C" {

// Pass 1: scan the buffer, return a parser handle + dimensions.
// cols_out is taken from the first non-blank line. status: 0 ok,
// 1 inconsistent/invalid row (bad_row_out = its 0-based data-row number),
// 2 empty input.
void* csv_open(const char* buf, int64_t len, int32_t nthreads, char delim,
               int64_t* rows_out, int64_t* cols_out, int64_t* bad_row_out,
               int32_t* status) {
  auto* ps = new Parser{buf, len, delim, {}, 0, 0, -1};
  *status = 0;
  *bad_row_out = -1;
  if (len <= 0) {
    *rows_out = *cols_out = 0;
    *status = 2;
    return ps;
  }
  // Column count from the first non-blank line (single-threaded peek).
  {
    const char* p = buf;
    const char* bufend = buf + len;
    while (p < bufend) {
      const char* eol = static_cast<const char*>(
          memchr(p, '\n', static_cast<size_t>(bufend - p)));
      const char* line_end = eol ? eol : bufend;
      if (!is_blank(p, line_end)) {
        ps->cols = count_fields(p, line_end, delim);
        break;
      }
      p = eol ? eol + 1 : bufend;
    }
  }
  if (ps->cols == 0) {
    *rows_out = *cols_out = 0;
    *status = 2;
    return ps;
  }
  if (nthreads <= 0) nthreads = (int32_t)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  split_chunks(*ps, nthreads);
  std::vector<std::thread> threads;
  for (auto& c : ps->chunks)
    threads.emplace_back(count_chunk, std::ref(c), delim, ps->cols);
  for (auto& t : threads) t.join();
  int64_t offset = 0;
  for (auto& c : ps->chunks) {
    if (c.bad_row >= 0 && ps->bad_row < 0) ps->bad_row = offset + c.bad_row;
    c.row_offset = offset;
    offset += c.rows;
  }
  ps->total_rows = offset;
  *rows_out = ps->total_rows;
  *cols_out = ps->cols;
  if (ps->bad_row >= 0) {
    *bad_row_out = ps->bad_row;
    *status = 1;
  }
  return ps;
}

// Pass 2: fill the caller-allocated column-major [cols x rows] buffer.
// Returns 0 ok, 1 malformed field (bad_row_out = data-row number).
int32_t csv_fill(void* handle, double* out, int64_t* bad_row_out) {
  auto* ps = static_cast<Parser*>(handle);
  *bad_row_out = -1;
  std::vector<int64_t> bads(ps->chunks.size(), -1);
  std::vector<std::thread> threads;
  for (size_t i = 0; i < ps->chunks.size(); ++i)
    threads.emplace_back(fill_chunk, std::cref(ps->chunks[i]), ps->delim,
                         ps->cols, ps->total_rows, out, &bads[i]);
  for (auto& t : threads) t.join();
  for (int64_t b : bads)
    if (b >= 0 && (*bad_row_out < 0 || b < *bad_row_out)) *bad_row_out = b;
  return *bad_row_out >= 0 ? 1 : 0;
}

void csv_close(void* handle) { delete static_cast<Parser*>(handle); }

}  // extern "C"
