// Native Ali-CCP sample-line parser — C++ hot path for the DIN/ESMM
// input format (``sample_id,y,z,field:fid:val field:fid:val ...``,
// the joined/remapped lines produced by features/aliccp.py; field schema
// from the reference get_aliccp_tfrecord.py:33-35).
//
// Routing (mirrors data/ragged.py exactly):
//   common single-valued fields -> feat_ids[11] (default: 1-based position)
//   user multi-hot 109_14/110_14/127_14/150_14 -> u_{cat,shop,brand,int}
//     ids+vals padded to P (defaults 12..15 with val 1.0 when absent)
//   ad scalar 206/207/216 -> a_cat/a_shop/a_brand (defaults 16/17/19)
//   ad multi-hot 210 -> a_int ids padded to P (default 18 when absent)
// Malformed lines get mask=0.

#include <cstdint>
#include <cstring>

namespace {

inline const char* parse_f(const char* p, const char* end, float* out) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
  double v = 0.0;
  while (p < end && *p >= '0' && *p <= '9') { v = v * 10.0 + (*p - '0'); ++p; }
  if (p < end && *p == '.') {
    ++p; double s = 0.1;
    while (p < end && *p >= '0' && *p <= '9') { v += (*p - '0') * s; s *= 0.1; ++p; }
  }
  if (p < end && (*p == 'e' || *p == 'E')) {  // scientific notation, like
    ++p;                                      // Python float() in ragged.py
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) { eneg = (*p == '-'); ++p; }
    int ex = 0;
    // Clamped: 60 saturates float32; unbounded ex is UB + a multi-billion
    // iteration stall on a malformed exponent (e.g. "1e2000000000").
    while (p < end && *p >= '0' && *p <= '9') {
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

inline const char* parse_i(const char* p, const char* end, int32_t* out) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
  *out = static_cast<int32_t>(neg ? -v : v);
  return p;
}

// common field name -> 1-based position (get_aliccp_tfrecord.py schema)
inline int common_slot(const char* s, int len) {
  if (len == 3) {
    if (!std::memcmp(s, "101", 3)) return 1;
    if (!std::memcmp(s, "121", 3)) return 2;
    if (!std::memcmp(s, "122", 3)) return 3;
    if (!std::memcmp(s, "124", 3)) return 4;
    if (!std::memcmp(s, "125", 3)) return 5;
    if (!std::memcmp(s, "126", 3)) return 6;
    if (!std::memcmp(s, "127", 3)) return 7;
    if (!std::memcmp(s, "128", 3)) return 8;
    if (!std::memcmp(s, "129", 3)) return 9;
    if (!std::memcmp(s, "205", 3)) return 10;
    if (!std::memcmp(s, "301", 3)) return 11;
  }
  return 0;
}

// user multi-hot field -> 0..3
inline int umh_slot(const char* s, int len) {
  if (len == 6 && !std::memcmp(s + 3, "_14", 3)) {
    if (!std::memcmp(s, "109", 3)) return 0;
    if (!std::memcmp(s, "110", 3)) return 1;
    if (!std::memcmp(s, "127", 3)) return 2;
    if (!std::memcmp(s, "150", 3)) return 3;
  }
  return -1;
}

}  // namespace

extern "C" {

// Outputs (caller-allocated, row-major):
//   y[n], z[n], mask[n]                float32
//   feat_ids[n, 11]                    int32
//   u_ids[n, 4, P], u_vals[n, 4, P]    int32 / float32
//   a_scalar[n, 3]  (cat, shop, brand) int32
//   a_int[n, P]                        int32
int64_t parse_aliccp(const char* data, int64_t data_len, const int64_t* offsets,
                     int64_t n, int32_t P, float* y, float* z, float* mask,
                     int32_t* feat_ids, int32_t* u_ids, float* u_vals,
                     int32_t* a_scalar, int32_t* a_int) {
  (void)data_len;
  static const int32_t UMH_DEFAULT[4] = {12, 13, 14, 15};
  for (int64_t r = 0; r < n; ++r) {
    const char* p = data + offsets[r];
    const char* end = data + offsets[r + 1];
    // init defaults
    y[r] = 0.f; z[r] = 0.f; mask[r] = 1.f;
    int32_t* fi = feat_ids + r * 11;
    for (int i = 0; i < 11; ++i) fi[i] = i + 1;
    int32_t* ui = u_ids + r * 4 * P;
    float* uv = u_vals + r * 4 * P;
    std::memset(ui, 0, sizeof(int32_t) * 4 * P);
    std::memset(uv, 0, sizeof(float) * 4 * P);
    int32_t* as = a_scalar + r * 3;
    as[0] = 16; as[1] = 17; as[2] = 19;
    int32_t* ai = a_int + r * P;
    std::memset(ai, 0, sizeof(int32_t) * P);

    // malformed rows (ragged.py:59-61): mask 0, feat_ids stay zero,
    // ad-scalar defaults kept, multi-hot defaults NOT applied
    auto malformed = [&]() {
      mask[r] = 0.f;
      y[r] = 0.f;
      z[r] = 0.f;
      std::memset(fi, 0, sizeof(int32_t) * 11);
    };
    // ragged.py splits on ',' and requires exactly 4 parts
    {
      int commas = 0;
      for (const char* q = p; q < end && *q != '\n'; ++q) {
        if (*q == ',') ++commas;
      }
      if (commas != 3) { malformed(); continue; }
    }
    // sample_id (skip to first comma)
    while (p < end && *p != ',' && *p != '\n') ++p;
    if (p >= end || *p != ',') { malformed(); continue; }
    ++p;
    p = parse_f(p, end, &y[r]);
    if (p >= end || *p != ',') { malformed(); continue; }
    ++p;
    p = parse_f(p, end, &z[r]);
    if (p >= end || *p != ',') { malformed(); continue; }
    ++p;

    int umh_cnt[4] = {0, 0, 0, 0};
    int aint_cnt = 0;
    while (p < end && *p != '\n') {
      while (p < end && (*p == ' ' || *p == '\r')) ++p;
      if (p >= end || *p == '\n') break;
      const char* fstart = p;
      while (p < end && *p != ':' && *p != ' ' && *p != '\n') ++p;
      if (p >= end || *p != ':') {  // malformed token: skip to space
        while (p < end && *p != ' ' && *p != '\n') ++p;
        continue;
      }
      int flen = static_cast<int>(p - fstart);
      ++p;  // ':'
      int32_t fid = 0;
      p = parse_i(p, end, &fid);
      if (p >= end || *p != ':') {  // ragged.py drops 2-part tokens
        while (p < end && *p != ' ' && *p != '\n') ++p;
        continue;
      }
      float fval = 1.0f;
      ++p;
      p = parse_f(p, end, &fval);
      if (p < end && *p == ':') {  // >3 parts: ragged.py drops the token
        while (p < end && *p != ' ' && *p != '\n') ++p;
        continue;
      }
      int cs = common_slot(fstart, flen);
      if (cs > 0) {
        fi[cs - 1] = fid;
      } else {
        int us = umh_slot(fstart, flen);
        if (us >= 0) {
          if (umh_cnt[us] < P) {
            ui[us * P + umh_cnt[us]] = fid;
            uv[us * P + umh_cnt[us]] = fval;
            ++umh_cnt[us];
          }
        } else if (flen == 3 && !std::memcmp(fstart, "206", 3)) {
          as[0] = fid;
        } else if (flen == 3 && !std::memcmp(fstart, "207", 3)) {
          as[1] = fid;
        } else if (flen == 3 && !std::memcmp(fstart, "216", 3)) {
          as[2] = fid;
        } else if (flen == 3 && !std::memcmp(fstart, "210", 3)) {
          if (aint_cnt < P) ai[aint_cnt++] = fid;
        }
        // unknown fields are ignored (same as data/ragged.py)
      }
    }
    // absent-field defaults (data/ragged.py:92-96)
    for (int u = 0; u < 4; ++u) {
      if (umh_cnt[u] == 0) {
        ui[u * P] = UMH_DEFAULT[u];
        uv[u * P] = 1.0f;
      }
    }
    if (aint_cnt == 0) ai[0] = 18;
  }
  return n;
}

}  // extern "C"
