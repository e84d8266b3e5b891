// nlsh_tpu native host kernels.
//
// C++ replacement for the reference's only native component, the Cython
// bit-packing kernel (reference nlsh/utils.pyx:7-32, compiled to a
// 24k-line C extension via pyximport).  Three host kernels:
//
//   * pack_codes   — pack {0,1} codes into int32 bucket ids, MSB-first
//                    (binarr_to_int semantics: out = (out << 1) | bit)
//   * pack_dedupe  — pack + per-row sort + first-occurrence mask: the
//                    fixed-shape equivalent of hash_codes' List[Set[int]]
//   * build_csr    — stable counting-sort CSR bucket-table build (the
//                    host-side twin of index/bucket_table.py)
//
// Each kernel is exported as a plain extern "C" symbol, bound with
// ctypes by nlsh_tpu_torch/native/__init__.py.  (The JAX package's copy
// of this file also registers them as XLA FFI handlers; that part
// belongs to JAX alone and has no counterpart here.)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline void pack_row(const int32_t* bits_ptr, int64_t n_bits, int32_t* out) {
  int32_t acc = 0;
  for (int64_t b = 0; b < n_bits; ++b) {
    acc = (acc << 1) | (bits_ptr[b] & 1);
  }
  *out = acc;
}

void pack_codes_impl(const int32_t* codes, int64_t n_rows, int64_t n_bits,
                     int32_t* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    pack_row(codes + i * n_bits, n_bits, out + i);
  }
}

// Per query row: pack p probe codes, sort ascending, mark first
// occurrences.  Matches nlsh_tpu.ops.packing.hash_codes exactly.
void pack_dedupe_impl(const int32_t* codes, int64_t n, int64_t p,
                      int64_t n_bits, int32_t* out_ids, bool* out_valid) {
  std::vector<int32_t> row(p);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* base = codes + i * p * n_bits;
    for (int64_t j = 0; j < p; ++j) {
      pack_row(base + j * n_bits, n_bits, &row[j]);
    }
    std::sort(row.begin(), row.end());
    for (int64_t j = 0; j < p; ++j) {
      out_ids[i * p + j] = row[j];
      out_valid[i * p + j] = (j == 0) || (row[j] != row[j - 1]);
    }
  }
}

// Stable counting sort: row_ids sorted by bucket, starts/counts per
// bucket.  Out-of-range ids (the shard-padding sentinel) are dropped
// from counts and sorted last, matching build_bucket_table.
void build_csr_impl(const int32_t* bucket_ids, int64_t n, int64_t n_buckets,
                    int32_t* row_ids, int32_t* starts, int32_t* counts) {
  std::memset(counts, 0, n_buckets * sizeof(int32_t));
  int64_t n_dropped = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t b = bucket_ids[i];
    if (b >= 0 && b < n_buckets) {
      counts[b] += 1;
    } else {
      n_dropped += 1;
    }
  }
  int32_t acc = 0;
  for (int64_t b = 0; b < n_buckets; ++b) {
    starts[b] = acc;
    acc += counts[b];
  }
  std::vector<int32_t> cursor(starts, starts + n_buckets);
  int64_t tail = n - n_dropped;
  for (int64_t i = 0; i < n; ++i) {
    int32_t b = bucket_ids[i];
    if (b >= 0 && b < n_buckets) {
      row_ids[cursor[b]++] = static_cast<int32_t>(i);
    } else {
      row_ids[tail++] = static_cast<int32_t>(i);
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// ctypes entry points
// ---------------------------------------------------------------------------

extern "C" {

void nlsh_pack_codes(const int32_t* codes, int64_t n_rows, int64_t n_bits,
                     int32_t* out) {
  pack_codes_impl(codes, n_rows, n_bits, out);
}

void nlsh_pack_dedupe(const int32_t* codes, int64_t n, int64_t p,
                      int64_t n_bits, int32_t* out_ids, uint8_t* out_valid) {
  pack_dedupe_impl(codes, n, p, n_bits, out_ids,
                   reinterpret_cast<bool*>(out_valid));
}

void nlsh_build_csr(const int32_t* bucket_ids, int64_t n, int64_t n_buckets,
                    int32_t* row_ids, int32_t* starts, int32_t* counts) {
  build_csr_impl(bucket_ids, n, n_buckets, row_ids, starts, counts);
}

}  // extern "C"
