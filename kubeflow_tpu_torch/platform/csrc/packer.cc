// Sequence packer: best-fit-decreasing bin packing of variable-length
// documents into fixed-length training rows.
//
// Role: the TPU build's LM data pipeline packs documents into [rows,
// seq_len] token matrices with segment ids so no FLOPs are spent on
// padding (the reference platform has no data pipeline at all — SURVEY.md
// §2.13).  Packing is a host-side hot path (per input shard, every
// epoch), hence native, mirroring how this repo's other control-plane hot
// paths (jsonpatch.cc, workqueue.cc) are C++ with Python fallbacks.
//
// Algorithm: best-fit decreasing — sort documents by length descending,
// place each into the open row with the smallest remaining capacity that
// still fits (multiset lower_bound, O(n log n)), else open a new row.
// Classical guarantee: <= 11/9 OPT + 4 rows.
//
// C ABI (ctypes):
//   int64 kfpk_pack(const int64* lengths, int64 n, int64 row_len,
//                   int64* row_assignment, int64* row_offset)
// Returns the number of rows used, or -1 if any length is < 1 or
// > row_len.  row_assignment[i] = row of doc i; row_offset[i] = first
// slot of doc i within its row.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <set>
#include <utility>
#include <vector>

extern "C" {

int64_t kfpk_pack(const int64_t* lengths, int64_t n, int64_t row_len,
                  int64_t* row_assignment, int64_t* row_offset) {
  if (n < 0 || row_len < 1) return -1;
  for (int64_t i = 0; i < n; ++i) {
    if (lengths[i] < 1 || lengths[i] > row_len) return -1;
  }
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return lengths[a] > lengths[b];
  });

  // (remaining_capacity, row_id); lower_bound finds the tightest fit.
  std::multiset<std::pair<int64_t, int64_t>> open;
  std::vector<int64_t> used;  // used[r] = filled slots in row r
  for (int64_t idx : order) {
    const int64_t len = lengths[idx];
    auto it = open.lower_bound({len, -1});
    int64_t row;
    if (it == open.end()) {
      row = static_cast<int64_t>(used.size());
      used.push_back(0);
    } else {
      row = it->second;
      open.erase(it);
    }
    row_assignment[idx] = row;
    row_offset[idx] = used[row];
    used[row] += len;
    const int64_t rem = row_len - used[row];
    if (rem > 0) open.insert({rem, row});
  }
  return static_cast<int64_t>(used.size());
}

}  // extern "C"
