// Multithreaded libsvm-format parser with a C ABI for ctypes.
//
// The port's copy of flinkml_tpu/native/libsvm_parser.cpp, unchanged but
// for these comments. Role: the GPU must not wait on ingest, and libsvm
// text (a9a, Criteo exports) is slow to parse in pure Python. This parser
// splits the buffer at line boundaries across threads, makes one counting
// pass (rows / nnz / index base) and one filling pass into caller-allocated
// numpy buffers — zero copies beyond the fill.
// The reference has no native layer at all (pure JVM, SURVEY.md §2); this is
// the framework's ingest equivalent of its record-stream sources.
//
// Parsing contract (kept in lockstep with the Python fallback in
// flinkml_tpu_torch/io/libsvm.py):
//   - a line whose label does not parse as a number is a hard error;
//   - a malformed "index:value" token (missing ':', bad index, empty or
//     bad value, whitespace after ':') ends that line's feature list;
//   - '#' starts a comment; blank lines are skipped.
// Both passes run the SAME tokenizer (parse_line with a null/real writer),
// so counts and fills can never desynchronize.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libsvm_parser.so \
//            libsvm_parser.cpp -lpthread
// (flinkml_tpu_torch.io.libsvm compiles this on demand into native/build/.)

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Writer {
  double* labels = nullptr;
  int64_t* indptr = nullptr;
  int32_t* indices = nullptr;
  float* values = nullptr;
  int64_t index_base = 0;
};

struct Chunk {
  const char* begin;
  const char* end;
  int64_t rows = 0;
  int64_t nnz = 0;
  int64_t row_offset = 0;  // filled after prefix sum
  int64_t nnz_offset = 0;
  int64_t min_index = INT64_MAX;
  bool bad_label = false;
};

struct Parser {
  const char* buf;
  int64_t len;
  std::vector<Chunk> chunks;
  int64_t total_rows = 0;
  int64_t total_nnz = 0;
  int64_t min_index = INT64_MAX;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline bool is_ws(char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\n';
}

// Parse one chunk. When `w` is null this is the counting pass; otherwise it
// writes through `w` at the chunk's offsets. Identical control flow either
// way — the single source of truth for the parsing contract above.
void parse_chunk(Chunk* c, const Writer* w) {
  const char* p = c->begin;
  int64_t row = c->row_offset;
  int64_t at = c->nnz_offset;
  while (p < c->end) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(c->end - p)));
    if (!line_end) line_end = c->end;
    const char* q = skip_ws(p, line_end);
    if (q < line_end && *q != '#') {
      // Label: must parse as a number (hard error otherwise). Copy the
      // token so strtod cannot run past line_end.
      char* after = nullptr;
      double label = strtod(q, &after);
      // Strict: the label token must be fully numeric up to whitespace.
      if (after == q || after > line_end ||
          (after < line_end && !is_ws(*after))) {
        c->bad_label = true;
        return;
      }
      q = after;
      if (w) {
        w->labels[row] = label;
        w->indptr[row] = at;
      }
      // index:value pairs.
      while (true) {
        q = skip_ws(q, line_end);
        if (q >= line_end || *q == '#') break;
        long long idx = strtoll(q, &after, 10);
        if (after == q || after >= line_end || *after != ':') break;
        q = after + 1;
        // Value must start immediately after ':' (no whitespace) and
        // actually consume characters, inside this line.
        if (q >= line_end || is_ws(*q)) break;
        double v = strtod(q, &after);
        if (after == q || after > line_end) break;
        // The value must end at whitespace or line end ('2.0x' / '2.0#c'
        // are malformed tokens and end the line without emitting).
        if (after < line_end && !is_ws(*after)) break;
        q = after;
        if (idx < c->min_index) c->min_index = idx;
        if (w) {
          w->indices[at] = static_cast<int32_t>(idx - w->index_base);
          w->values[at] = static_cast<float>(v);
        }
        ++at;
      }
      ++row;
    }
    p = line_end + 1;
  }
  c->rows = row - c->row_offset;
  c->nnz = at - c->nnz_offset;
}

}  // namespace

extern "C" {

// Phase 1: split + count. Returns an opaque handle (NULL on failure) and
// writes total rows / nnz / detected index base (0 or 1). A malformed label
// anywhere returns NULL with *out_rows = -2.
void* libsvm_open(const char* buf, int64_t len, int32_t n_threads,
                  int64_t* out_rows, int64_t* out_nnz,
                  int64_t* out_index_base) {
  if (!buf || len <= 0 || n_threads < 1) return nullptr;
  auto* parser = new Parser{buf, len, {}, 0, 0, INT64_MAX};

  // Split at line boundaries.
  int64_t target = len / n_threads;
  const char* start = buf;
  const char* end = buf + len;
  for (int t = 0; t < n_threads && start < end; ++t) {
    const char* stop =
        (t == n_threads - 1) ? end : buf + (t + 1) * target;
    if (stop > end) stop = end;
    if (stop < end) {
      const char* nl = static_cast<const char*>(
          memchr(stop, '\n', static_cast<size_t>(end - stop)));
      stop = nl ? nl + 1 : end;
    }
    if (stop > start) {
      Chunk c;
      c.begin = start;
      c.end = stop;
      parser->chunks.push_back(c);
      start = stop;
    }
  }

  std::vector<std::thread> workers;
  for (auto& c : parser->chunks)
    workers.emplace_back(parse_chunk, &c, nullptr);
  for (auto& w : workers) w.join();

  for (auto& c : parser->chunks) {
    if (c.bad_label) {
      delete parser;
      *out_rows = -2;
      return nullptr;
    }
    c.row_offset = parser->total_rows;
    c.nnz_offset = parser->total_nnz;
    parser->total_rows += c.rows;
    parser->total_nnz += c.nnz;
    if (c.min_index < parser->min_index) parser->min_index = c.min_index;
  }
  *out_rows = parser->total_rows;
  *out_nnz = parser->total_nnz;
  // libsvm convention: 1-based unless a 0 index appears.
  *out_index_base = (parser->min_index == 0) ? 0 : 1;
  return parser;
}

// Phase 2: fill caller-allocated buffers.
// labels: [rows] f64; indptr: [rows+1] i64; indices: [nnz] i32;
// values: [nnz] f32. Returns 0 on success.
int32_t libsvm_fill(void* handle, double* labels, int64_t* indptr,
                    int32_t* indices, float* values, int64_t index_base) {
  auto* parser = static_cast<Parser*>(handle);
  if (!parser) return -1;
  Writer w{labels, indptr, indices, values, index_base};
  std::vector<std::thread> workers;
  for (auto& c : parser->chunks)
    workers.emplace_back(parse_chunk, &c, &w);
  for (auto& t : workers) t.join();
  indptr[parser->total_rows] = parser->total_nnz;
  return 0;
}

void libsvm_close(void* handle) {
  delete static_cast<Parser*>(handle);
}

}  // extern "C"
