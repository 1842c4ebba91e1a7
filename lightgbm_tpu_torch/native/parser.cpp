// Native text parser for lightgbm_tpu.
//
// Equivalent of the reference's C++ Parser (src/io/parser.cpp:
// CSVParser/TSVParser/LibSVMParser + Parser::CreateParser auto-detection)
// and the hot inner loop of DatasetLoader's text path
// (src/io/dataset_loader.cpp:203 LoadFromFile). The Python front end
// (application._load_tabular) dispatches here via ctypes; numpy's
// genfromtxt is ~40x slower on wide CSVs.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -o _parser.so parser.cpp
//
// C ABI:
//   ParseDense(path, delim, skip_rows, out*, rows*, cols*) -> status
//     parses a delimiter-separated numeric file into a malloc'd
//     row-major double buffer (caller frees with FreeBuffer); empty
//     fields and non-numeric tokens become NaN.
//   ParseLibSVM(path, out*, labels*, rows*, cols*) -> status
//     parses "label idx:val ..." lines into a dense row-major buffer
//     (absent entries 0.0, matching the reference's sparse semantics).
//   FreeBuffer(ptr)

// PARSER_API lets an including translation unit (native/capi.cpp pulls
// this file in for PredictForFile) make these symbols hidden instead of
// re-exporting duplicates of _parser.so's interface
#ifndef PARSER_API
#define PARSER_API
#endif

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <limits>
#include <string>
#include <vector>

namespace {

// Read a whole file into memory (data files are loaded wholesale by the
// reference's TextReader as well).
bool ReadAll(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size < 0) { std::fclose(f); return false; }
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(&(*out)[0], 1, out->size(), f) : 0;
  std::fclose(f);
  return got == out->size();
}

inline const char* SkipSpaces(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  return p;
}

}  // namespace

extern "C" {

PARSER_API void FreeBuffer(void* p) { std::free(p); }

// status: 0 ok, 1 io error, 2 empty/parse error
PARSER_API int ParseDense(const char* path, char delim, int skip_rows,
               double** out, long* n_rows, long* n_cols) {
  std::string buf;
  if (!ReadAll(path, &buf)) return 1;
  const char* p = buf.data();
  const char* end = p + buf.size();

  // first pass: column count from the first data line
  const char* q = p;
  for (int s = 0; s < skip_rows && q < end; ++s) {
    while (q < end && *q != '\n') ++q;
    if (q < end) ++q;
  }
  const char* data_start = q;
  long cols = 0;
  {
    // first non-blank, non-comment line sets the column count
    const char* scan = q;
    while (scan < end && cols == 0) {
      const char* line_end = scan;
      while (line_end < end && *line_end != '\n') ++line_end;
      const char* content = SkipSpaces(scan, line_end);
      if (content < line_end && *content != '#') {
        cols = 1;
        for (const char* c = scan; c < line_end; ++c)
          if (*c == delim) ++cols;
      }
      scan = line_end < end ? line_end + 1 : end;
    }
    if (cols == 0) return 2;
  }

  std::vector<double> vals;
  vals.reserve(1 << 20);
  long rows = 0;
  p = data_start;
  while (p < end) {
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    const char* stripped = line_end;
    if (stripped > p && stripped[-1] == '\r') --stripped;
    const char* content = SkipSpaces(p, stripped);
    // '#' comment lines are skipped (matching numpy genfromtxt's
    // default comments='#')
    if (content < stripped && *content != '#') {
      long col = 0;
      long n_fields = 1;
      for (const char* c = p; c < stripped; ++c)
        if (*c == delim) ++n_fields;
      if (n_fields != cols) return 2;  // ragged row (either direction):
                                       // fail like the numpy fallback
      const char* field = p;
      for (const char* c = p; c <= stripped && col < cols; ++c) {
        if (c == stripped || *c == delim) {
          char* parse_end = nullptr;
          double v = c == field ? 0.0 : std::strtod(field, &parse_end);
          // strtod skips leading whitespace INCLUDING newlines, so a
          // blank field could otherwise swallow the next line's number;
          // any parse that left the field is treated as missing
          bool ok = c != field && parse_end != field && parse_end <= c;
          vals.push_back(ok ? v : std::nan(""));
          field = c + 1;
          ++col;
        }
      }
      while (col < cols) { vals.push_back(std::nan("")); ++col; }
      ++rows;
    }
    p = line_end < end ? line_end + 1 : end;
  }
  if (rows == 0) return 2;
  double* res = static_cast<double*>(
      std::malloc(sizeof(double) * vals.size()));
  if (!res) return 1;
  std::memcpy(res, vals.data(), sizeof(double) * vals.size());
  *out = res;
  *n_rows = rows;
  *n_cols = cols;
  return 0;
}

PARSER_API int ParseLibSVM(const char* path, double** out, double** labels,
                long* n_rows, long* n_cols) {
  std::string buf;
  if (!ReadAll(path, &buf)) return 1;
  const char* p = buf.data();
  const char* end = p + buf.size();

  struct Entry { long row; long col; double val; };
  std::vector<Entry> entries;
  std::vector<double> labs;
  entries.reserve(1 << 20);
  long max_col = -1;
  long rows = 0;
  while (p < end) {
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    const char* c = SkipSpaces(p, line_end);
    if (c < line_end) {
      char* parse_end = nullptr;
      double lab = std::strtod(c, &parse_end);
      if (parse_end == c) return 2;
      labs.push_back(lab);
      c = parse_end;
      while (c < line_end) {
        c = SkipSpaces(c, line_end);
        if (c >= line_end) break;
        char* colon_end = nullptr;
        long idx = std::strtol(c, &colon_end, 10);
        if (colon_end == c || colon_end >= line_end || *colon_end != ':'
            || idx < 0)  // negative index would write before the buffer
          break;
        c = colon_end + 1;
        double v = std::strtod(c, &parse_end);
        // bound the parse to this line ("3:" at end of line must not
        // swallow the next line's label)
        if (parse_end == c || parse_end > line_end) break;
        c = parse_end;
        entries.push_back({rows, idx, v});
        if (idx > max_col) max_col = idx;
      }
      ++rows;
    }
    p = line_end < end ? line_end + 1 : end;
  }
  if (rows == 0) return 2;
  long cols = max_col + 1;
  if (cols <= 0) cols = 1;
  double* res = static_cast<double*>(
      std::calloc(static_cast<size_t>(rows) * cols, sizeof(double)));
  double* lab_buf = static_cast<double*>(
      std::malloc(sizeof(double) * rows));
  if (!res || !lab_buf) { std::free(res); std::free(lab_buf); return 1; }
  for (const Entry& e : entries)
    res[e.row * cols + e.col] = e.val;
  std::memcpy(lab_buf, labs.data(), sizeof(double) * rows);
  *out = res;
  *labels = lab_buf;
  *n_rows = rows;
  *n_cols = cols;
  return 0;
}

// Greedy equal-count bin boundary search over (distinct value, count)
// pairs — the hot loop of BinMapper construction (reference:
// GreedyFindBin, src/io/bin.cpp:78-152). Must match the Python
// implementation in io/binning.py bit-for-bit: same double arithmetic,
// same nextafter-based dedup of boundaries.
//
// out must have room for max_bin + 1 doubles; returns the number of
// bounds written (the last one is +inf).
PARSER_API int GreedyFindBin(const double* distinct_values, const double* counts,
                  long num_distinct, int max_bin, double total_cnt,
                  int min_data_in_bin, double* out) {
  const double kInf = std::numeric_limits<double>::infinity();
  int n_out = 0;
  auto push_bound = [&](double val) {
    if (n_out == 0 || val > std::nextafter(out[n_out - 1], kInf)) {
      out[n_out++] = val;
    }
  };
  if (num_distinct <= max_bin) {
    double cur_cnt_inbin = 0;
    for (long i = 0; i < num_distinct - 1; ++i) {
      cur_cnt_inbin += counts[i];
      if (cur_cnt_inbin >= min_data_in_bin) {
        double mid = (distinct_values[i] + distinct_values[i + 1]) / 2.0;
        double val = std::nextafter(mid, kInf);
        int before = n_out;
        push_bound(val);
        if (n_out > before) cur_cnt_inbin = 0;
      }
    }
    out[n_out++] = kInf;
    return n_out;
  }

  if (min_data_in_bin > 0) {
    long cap = static_cast<long>(total_cnt) / min_data_in_bin;
    if (cap < max_bin) max_bin = static_cast<int>(cap);
    if (max_bin < 1) max_bin = 1;
  }
  double mean_bin_size = total_cnt / max_bin;

  std::vector<char> is_big(num_distinct);
  long n_big = 0;
  double big_cnt = 0;
  for (long i = 0; i < num_distinct; ++i) {
    is_big[i] = counts[i] >= mean_bin_size;
    if (is_big[i]) { ++n_big; big_cnt += counts[i]; }
  }
  long rest_bin_cnt = max_bin - n_big;
  double rest_sample_cnt = total_cnt - big_cnt;
  mean_bin_size = rest_sample_cnt /
      (rest_bin_cnt > 1 ? rest_bin_cnt : 1);

  std::vector<double> upper_bounds(max_bin, kInf);
  std::vector<double> lower_bounds(max_bin, kInf);
  int bin_cnt = 0;
  lower_bounds[0] = distinct_values[0];
  double cur_cnt_inbin = 0;
  for (long i = 0; i < num_distinct - 1; ++i) {
    if (!is_big[i]) rest_sample_cnt -= counts[i];
    cur_cnt_inbin += counts[i];
    double half = mean_bin_size * 0.5;
    if (half < 1.0) half = 1.0;
    if (is_big[i] || cur_cnt_inbin >= mean_bin_size ||
        (is_big[i + 1] && cur_cnt_inbin >= half)) {
      upper_bounds[bin_cnt] = distinct_values[i];
      ++bin_cnt;
      lower_bounds[bin_cnt] = distinct_values[i + 1];
      if (bin_cnt >= max_bin - 1) break;
      cur_cnt_inbin = 0;
      if (!is_big[i]) {
        --rest_bin_cnt;
        mean_bin_size = rest_sample_cnt /
            (rest_bin_cnt > 1 ? rest_bin_cnt : 1);
      }
    }
  }
  ++bin_cnt;
  for (int i = 0; i < bin_cnt - 1; ++i) {
    double mid = (upper_bounds[i] + lower_bounds[i + 1]) / 2.0;
    push_bound(std::nextafter(mid, kInf));
  }
  out[n_out++] = kInf;
  return n_out;
}

}  // extern "C"
