// Host-side graph building of the PyTorch port: the CSR sort, the
// degree-bucket fill, the dense collation and the neighbour sampler.
//
// The port's own copy of the JAX package's native/graph_builder.cpp: the
// same four routines, the same outputs and, in sample_neighbors, the same
// xorshift64 draws, so one seed gives both packages the same blocks.  It
// runs on the host, not the card: dfgnn_tpu_torch/native.py builds it with
// g++ at first use and loads it with ctypes.  The routines index their
// outputs by the ids they are given and check none of them: the Python
// wrappers check every id before the call.
//
// ABI: plain C functions over caller-allocated numpy buffers.

#include <cstdint>
#include <cstring>

extern "C" {

// Stable counting sort of COO edges by row; emits CSR indptr + sorted cols
// + the edge permutation (original edge id per sorted slot).
// rows/cols: [e]; indptr out: [n+1]; cols_out/perm_out: [e].
void csr_from_coo(int64_t n, int64_t e,
                  const int64_t* rows, const int64_t* cols,
                  int64_t* indptr, int64_t* cols_out, int64_t* perm_out) {
  std::memset(indptr, 0, sizeof(int64_t) * (n + 1));
  for (int64_t i = 0; i < e; ++i) indptr[rows[i] + 1]++;
  for (int64_t r = 0; r < n; ++r) indptr[r + 1] += indptr[r];
  // cursor pass (stable: edges already arrive in original order)
  int64_t* cursor = new int64_t[n];
  std::memcpy(cursor, indptr, sizeof(int64_t) * n);
  for (int64_t i = 0; i < e; ++i) {
    int64_t slot = cursor[rows[i]]++;
    cols_out[slot] = cols[i];
    perm_out[slot] = i;
  }
  delete[] cursor;
}

// Fill one degree-bucket's padded neighbor block.
// sel: [n_sel] row ids; indptr/cols over the whole graph; outputs are
// pre-filled by the caller with sentinels/zeros and shaped [r_pad, width]
// (row-major); only the first n_sel rows are written.
void bucket_fill(int64_t n_sel, const int64_t* sel,
                 const int64_t* indptr, const int64_t* cols,
                 const float* val,  // may be null
                 int64_t width,
                 int32_t* nbr, uint8_t* emask, float* val_out) {
  for (int64_t i = 0; i < n_sel; ++i) {
    const int64_t r = sel[i];
    const int64_t s = indptr[r], t = indptr[r + 1];
    const int64_t d = t - s;
    int32_t* nrow = nbr + i * width;
    uint8_t* mrow = emask + i * width;
    for (int64_t j = 0; j < d; ++j) {
      nrow[j] = (int32_t)cols[s + j];
      mrow[j] = 1;
    }
    if (val && val_out) {
      float* vrow = val_out + i * width;
      for (int64_t j = 0; j < d; ++j) vrow[j] = val[s + j];
    }
  }
}

// Collate a batch of graphs into dense per-graph adjacency bytes.
// Edges are concatenated; edge_offsets: [B+1] prefix into rows/cols.
// adj out: [B, P, P] uint8 (caller-zeroed).
void fill_dense_adj(int64_t B, int64_t P,
                    const int64_t* edge_offsets,
                    const int64_t* rows, const int64_t* cols,
                    uint8_t* adj) {
  for (int64_t b = 0; b < B; ++b) {
    uint8_t* a = adj + b * P * P;
    for (int64_t i = edge_offsets[b]; i < edge_offsets[b + 1]; ++i) {
      a[rows[i] * P + cols[i]] = 1;
    }
  }
}

// Uniform neighbor sampling with replacement-free cap: for each seed, copy
// up to `fanout` neighbors (random subset when degree > fanout, using an
// xorshift PRNG seeded per call).  Outputs [n_seeds, fanout] padded with
// `sentinel`.
void sample_neighbors(int64_t n_seeds, const int64_t* seeds,
                      const int64_t* indptr, const int64_t* cols,
                      int64_t fanout, int64_t sentinel, uint64_t seed,
                      int32_t* out, uint8_t* mask) {
  uint64_t state = seed | 1;
  auto next = [&state]() {
    state ^= state << 13;
    state ^= state >> 7;
    state ^= state << 17;
    return state;
  };
  for (int64_t i = 0; i < n_seeds; ++i) {
    const int64_t r = seeds[i];
    const int64_t s = indptr[r], t = indptr[r + 1];
    const int64_t d = t - s;
    int32_t* orow = out + i * fanout;
    uint8_t* mrow = mask + i * fanout;
    if (d <= fanout) {
      for (int64_t j = 0; j < d; ++j) { orow[j] = (int32_t)cols[s + j]; mrow[j] = 1; }
      for (int64_t j = d; j < fanout; ++j) { orow[j] = (int32_t)sentinel; mrow[j] = 0; }
    } else {
      // reservoir sample of `fanout` distinct neighbors
      for (int64_t j = 0; j < fanout; ++j) orow[j] = (int32_t)cols[s + j];
      for (int64_t j = fanout; j < d; ++j) {
        const int64_t k = (int64_t)(next() % (uint64_t)(j + 1));
        if (k < fanout) orow[k] = (int32_t)cols[s + j];
      }
      for (int64_t j = 0; j < fanout; ++j) mrow[j] = 1;
    }
  }
}

}  // extern "C"
