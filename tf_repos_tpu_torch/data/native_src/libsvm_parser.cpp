// Native libsvm parser — the C++ data-loader hot path.
//
// The reference feeds training through tf.data's C++ kernels
// (TextLineDataset + string_split, deep_ctr/Model_pipeline/DeepFM.py:63-98);
// a pure-Python parse cannot keep a TPU chip fed on real Criteo
// (45M lines x 79 tokens). This single-pass scanner parses
// ``label id:val id:val ...`` lines directly into caller-allocated
// int32/float32 buffers with no tokenization allocations. Exposed with a
// plain C ABI for ctypes (no pybind11 dependency).
//
// Contract (mirrors data/libsvm.py parse_libsvm_lines):
//   * each row fills exactly field_size (id, val) slots, zero-padded,
//     extra features truncated
//   * a feature without ':' or with an empty value gets val = 1.0
//   * malformed tokens parse as 0 (never crash the loader)

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline const char* skip_spaces(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// minimal fast float parse: [-]digits[.digits][eE[-]digits]
inline const char* parse_float(const char* p, const char* end, float* out) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  double v = 0.0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10.0 + (*p - '0');
    ++p;
  }
  if (p < end && *p == '.') {
    ++p;
    double scale = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      v += (*p - '0') * scale;
      scale *= 0.1;
      ++p;
    }
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) {
      eneg = (*p == '-');
      ++p;
    }
    int ex = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      // Clamp: a malformed token like 1:1e2000000000 must not overflow the
      // accumulator (signed UB) or spin the scaling loop for billions of
      // iterations. 60 already saturates float32 either direction.
      if (ex < 60) ex = ex * 10 + (*p - '0');
      ++p;
    }
    if (ex > 60) ex = 60;
    double f = 1.0;
    for (int i = 0; i < ex; ++i) f *= 10.0;
    v = eneg ? v / f : v * f;
  }
  *out = static_cast<float>(neg ? -v : v);
  return p;
}

inline const char* parse_int(const char* p, const char* end, int32_t* out) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
  }
  *out = static_cast<int32_t>(neg ? -v : v);
  return p;
}

}  // namespace

extern "C" {

// Parse n lines given as one concatenated buffer with per-line offsets.
//   data:      the text, length data_len
//   offsets:   int64[n + 1]; line i spans [offsets[i], offsets[i+1])
//   field_size fields per row; ids/vals are [n, field_size], labels [n]
// Returns the number of rows parsed.
int64_t parse_libsvm(const char* data, int64_t data_len,
                     const int64_t* offsets, int64_t n, int32_t field_size,
                     int32_t* ids, float* vals, float* labels) {
  (void)data_len;
  for (int64_t r = 0; r < n; ++r) {
    const char* p = data + offsets[r];
    const char* end = data + offsets[r + 1];
    int32_t* row_ids = ids + r * field_size;
    float* row_vals = vals + r * field_size;
    std::memset(row_ids, 0, sizeof(int32_t) * field_size);
    std::memset(row_vals, 0, sizeof(float) * field_size);

    p = skip_spaces(p, end);
    float label = 0.f;
    p = parse_float(p, end, &label);
    labels[r] = label;

    int32_t col = 0;
    while (col < field_size) {
      p = skip_spaces(p, end);
      if (p >= end || *p == '\n') break;
      // a token must START with a digit or a sign; anything else is
      // malformed — skip it WITHOUT consuming a column (a cursor that
      // never advanced would otherwise fill every remaining column
      // with garbage)
      char c0 = *p;
      bool leads_num =
          (c0 >= '0' && c0 <= '9') ||
          ((c0 == '-' || c0 == '+') && p + 1 < end && p[1] >= '0' && p[1] <= '9');
      if (!leads_num) {
        while (p < end && *p != ' ' && *p != '\t' && *p != '\n') ++p;
        continue;
      }
      int32_t fid = 0;
      p = parse_int(p, end, &fid);
      float fval = 1.0f;
      if (p < end && *p == ':') {
        ++p;
        if (p < end && *p != ' ' && *p != '\t' && *p != '\n') {
          p = parse_float(p, end, &fval);
        }
      }
      row_ids[col] = fid;
      row_vals[col] = fval;
      ++col;
      // always resync to the next whitespace so trailing junk in a
      // token (e.g. '5:1x') cannot stall the cursor
      while (p < end && *p != ' ' && *p != '\t' && *p != '\n') ++p;
    }
    // truncate surplus features: skip to end of line
  }
  return n;
}

// Split a text blob into line offsets (skipping empty lines).
// offsets must hold up to max_lines + 1 entries. Returns line count.
int64_t split_lines(const char* data, int64_t data_len, int64_t* offsets,
                    int64_t max_lines) {
  int64_t n = 0;
  int64_t i = 0;
  while (i < data_len && n < max_lines) {
    // skip leading newlines / blank lines
    while (i < data_len && (data[i] == '\n' || data[i] == '\r')) ++i;
    if (i >= data_len) break;
    offsets[n++] = i;
    while (i < data_len && data[i] != '\n') ++i;
  }
  offsets[n] = i;
  return n;
}

}  // extern "C"
