// Thread-block clusters for the LSTM kernels: the two exchanges through
// distributed shared memory (DSMEM) that they need, on the cluster
// barrier, peer loads and launch helpers of cluster.cuh.
//
// The pattern: the cs blocks of a cluster (cs <= 16) split the hidden units
// between them, u = ceil(H / cs) each (the last ones ragged or empty). Each
// block writes what the others need into its own shared memory, in two
// halves by step parity; one cluster barrier (release on arrive, acquire on
// wait) makes it visible to the cluster; each block then reads it from its
// peers (ld.shared::cluster, every load in flight before the first use). A
// block writes half s % 2 at step s only after the barrier of the step it
// ran before, which every peer passed after reading that half at the start
// of that step. Reading, not writing, across blocks: on an H100 the
// remote stores took longer than a step's product, the remote loads
// (issued together) far less.
//
// - Partials, a reduce-scatter (the backward, lstm_bwd.cu): a block forms
//   a partial (rows x H) product from the columns it owns; each block reads
//   its own units' columns of the cs partials and adds them in rank order,
//   so the sum is the same on every launch (no atomics).
// - Slices, an all-gather (the forwards, lstm_fwd_cluster.cuh): a block
//   owns its units' values of a few (rows x H) matrices (h of each layer);
//   each block reads every peer's slices into a full (H x rows) tile.
//
// Needs sm_90 (mapa, ld.shared::cluster, barrier.cluster). The cluster
// routes of K1 / K2, K3 and K4 / K4-train include this header; their grid
// routes, for hidden sizes whose weight columns do not fit a cluster,
// launch as cooperative grids.
#pragma once

#include <cuda_runtime.h>

#include "cluster.cuh"

namespace lstm {

using namespace dsmem;

constexpr int MAX_CLUSTER = 16;

// A block's partial products, two halves by step parity: [2][rp][ld]
// floats, row r and column j (a global hidden unit) at (r, j).
struct Partials {
  float* base;
  int rp, ld;

  __device__ __forceinline__ float* at(int parity, int row, int j) const {
    return base + ((size_t)parity * rp + row) * ld + j;
  }

  // Entry (row, j) summed over the cs blocks of the cluster in rank order;
  // every load is issued before the first add.
  __device__ __forceinline__ float gather(int parity, int row, int j, int cs) const {
    const unsigned a = (unsigned)__cvta_generic_to_shared(at(parity, row, j));
    float v[MAX_CLUSTER];
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) v[k] = k < cs ? peer_load(peer_addr(a, k)) : 0.f;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k)
      if (k < cs) s += v[k];
    return s;
  }

  __host__ __device__ static size_t floats(int rp, int ld) { return (size_t)2 * rp * ld; }
};

// A block's own slices of `mats` (rows x H) matrices, two halves by step
// parity: [2][mats][u][ldx] floats, the rows of unit jj (0 <= jj < u, a
// global hidden unit rank * u + jj) contiguous; ldx is a multiple of 4.
struct Slices {
  float* base;
  int u, ldx, mats;

  __device__ __forceinline__ float* at(int parity, int m, int jj) const {
    return base + (((size_t)parity * mats + m) * u + jj) * ldx;
  }

  __host__ __device__ static size_t floats(int u, int ldx, int mats) {
    return (size_t)2 * mats * u * ldx;
  }
};

constexpr int GATHER_MAX = 4;  // 16-byte copies per thread in one all-gather

// One thread's share of the all-gather of Slices into a k-major tile
// [mats][tile_rows][ldt] (entry (k, r) of matrix m at (m * tile_rows + k) *
// ldt + r): the same copies at every step, so their peer addresses are
// worked out once. Each copy moves 4 rows of one unit of one matrix.
struct SliceGather {
  unsigned src[GATHER_MAX];  // shared::cluster address, parity 0
  int dst[GATHER_MAX];       // float offset in the tile
  int n;
  unsigned half;             // bytes from parity 0 to parity 1

  // H units in all, owned u to a block by the cluster's blocks in rank
  // order; the plan must give at most GATHER_MAX copies per thread.
  __device__ __forceinline__ void init(const Slices& s, int H, int tile_rows, int ldt) {
    const int n4 = s.ldx / 4, total = s.mats * H * n4;
    const unsigned a0 = (unsigned)__cvta_generic_to_shared(s.base);
    half = (unsigned)(s.mats * s.u * s.ldx * sizeof(float));
    n = 0;
#pragma unroll
    for (int i = 0; i < GATHER_MAX; ++i) {
      const int idx = threadIdx.x + i * blockDim.x;
      if (idx < total) {
        const int c = idx % n4, k = (idx / n4) % H, m = idx / (n4 * H);
        const int q = k / s.u, jj = k - q * s.u;
        src[i] = peer_addr(a0 + (unsigned)(((m * s.u + jj) * s.ldx + 4 * c) * sizeof(float)),
                           (unsigned)q);
        dst[i] = (m * tile_rows + k) * ldt + 4 * c;
        n = i + 1;
      }
    }
  }

  // Copy half `parity` of every block's slices into the tile: every load
  // in flight before the first store.
  __device__ __forceinline__ void run(int parity, float* tile) const {
    float4 v[GATHER_MAX];
#pragma unroll
    for (int i = 0; i < GATHER_MAX; ++i)
      if (i < n) v[i] = peer_load4(src[i] + (parity ? half : 0u));
#pragma unroll
    for (int i = 0; i < GATHER_MAX; ++i)
      if (i < n) *reinterpret_cast<float4*>(tile + dst[i]) = v[i];
  }
};

}  // namespace lstm
