// Per-row duplicate-id combine for the multi-hot COO pack (--mh_coo).
//
// At the published Ali-CCP length regime (avg 250 ids/sample, Zipf 1.2)
// a sample's heavy fields repeat ids ~1.8-2.1x; every occurrence costs a
// COO slot on the device (pool fwd+bwd RMWs, expand, wire bytes). The
// reference's sum combiner (tf.nn.embedding_lookup_sparse combiner="sum",
// DeepCvrMTL.py:155-159) is LINEAR in sp_weights, so summing the weights
// of duplicate (row, id) pairs on the host is exact up to float summation
// order. numpy's per-field np.unique costs ~103 ms/batch at B=4096
// (global sort of ~1.2M int64 keys); this open-addressing per-row hash
// runs at memory speed (rows are <=512 wide).
//
// Contract (plain C ABI, ctypes-bound in data/native.py):
//   ids  [b*p] int32 row-major; id <= 0 is dead padding
//   vals [b*p] float or NULL (NULL => each occurrence weighs 1.0)
//   out_ids/out_w: caller-allocated [b*p]; combined entries are emitted
//     row-major compact, FIRST-SEEN order inside a row
//   out_cnt [b]: combined live count per row
// Returns the total combined count m (<= number of live slots).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" int64_t combine_dups(
    const int32_t* ids, const float* vals, int64_t b, int64_t p,
    int32_t* out_ids, float* out_w, int32_t* out_cnt) {
  int64_t cap = 1;
  while (cap < 2 * p) cap <<= 1;
  const uint64_t mask = static_cast<uint64_t>(cap) - 1;
  std::vector<int32_t> slot_id(static_cast<size_t>(cap));
  std::vector<int64_t> slot_pos(static_cast<size_t>(cap));
  int64_t m = 0;
  for (int64_t r = 0; r < b; ++r) {
    std::fill(slot_id.begin(), slot_id.end(), -1);
    const int32_t* row = ids + r * p;
    const float* vrow = vals ? vals + r * p : nullptr;
    const int64_t base = m;
    int32_t cnt = 0;
    for (int64_t j = 0; j < p; ++j) {
      const int32_t id = row[j];
      if (id <= 0) continue;
      const float w = vrow ? vrow[j] : 1.0f;
      uint64_t s =
          ((static_cast<uint64_t>(static_cast<uint32_t>(id)) *
            0x9E3779B97F4A7C15ull) >> 32) & mask;
      for (;;) {
        const int32_t cur = slot_id[s];
        if (cur == id) {
          out_w[slot_pos[s]] += w;
          break;
        }
        if (cur == -1) {
          slot_id[s] = id;
          slot_pos[s] = base + cnt;
          out_ids[base + cnt] = id;
          out_w[base + cnt] = w;
          ++cnt;
          break;
        }
        s = (s + 1) & mask;
      }
    }
    out_cnt[r] = cnt;
    m += cnt;
  }
  return m;
}
