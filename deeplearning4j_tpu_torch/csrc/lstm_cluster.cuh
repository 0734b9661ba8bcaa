// Thread-block clusters for the LSTM kernels: the two exchanges through
// distributed shared memory (DSMEM) that they need, the cluster barrier
// that orders them, and the host side that sizes and launches a cluster
// grid.
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

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace lstm {

// Rank of this block in its cluster.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives (release: its shared
// and DSMEM writes become visible to those that wait). All threads of each
// warp must reach it together.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

// Wait until every thread of the cluster has arrived (acquire). Work that
// needs nothing from the peers may sit between the arrive and the wait.
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Arrive and wait: a cluster-wide barrier, and so a block-wide one.
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The shared::cluster address of `local` (a shared-memory location of this
// block) in the block of rank `rank`: the same offset in the peer's window.
__device__ __forceinline__ unsigned peer_addr(unsigned local, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

__device__ __forceinline__ float peer_load(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// 16 bytes of a peer's shared memory (addr 16-byte aligned).
__device__ __forceinline__ float4 peer_load4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

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

// Set the kernel's shared-memory and, past 8 blocks, non-portable cluster
// attributes, which a launch of clusters of `cs` blocks and `smem` dynamic
// bytes needs.
template <typename Kernel>
inline cudaError_t cluster_attributes(Kernel kernel, int cs, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess && cs > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// Clusters of `cs` blocks of `threads` threads and `smem` dynamic bytes
// that can run at once on this device: 0 when such a cluster cannot run
// (too much shared memory, or a size past 8 the device does not allow).
// Sets the kernel's attributes for those sizes (cluster_attributes).
template <typename Kernel>
inline int max_active_clusters(Kernel kernel, int cs, int threads, size_t smem) {
  cudaError_t e = cluster_attributes(kernel, cs, smem);
  int n = 0;
  if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cs;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(cs, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // not sticky: clear it so the next call starts clean
    n = 0;
  }
  return n;
}

// The cluster plan of (device, B, H) that Search(dev, B, H, &plan, &ok)
// finds (ok false: no cluster fits, the grid route's shapes), searched once
// per shape and kept: the search asks the CUDA driver for occupancies,
// which costs more host time than a step of the kernels. One cache per
// search function.
template <auto Search, typename Plan>
inline int cached_plan(int B, int H, Plan* out, bool* ok) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, std::pair<bool, Plan>> plans;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, B, H);
  auto it = plans.find(key);
  if (it == plans.end()) {
    Plan p{};
    bool found = false;
    const int rc = Search(dev, B, H, &p, &found);
    if (rc) return rc;
    it = plans.emplace(key, std::make_pair(found, p)).first;
  }
  *ok = it->second.first;
  *out = it->second.second;
  return 0;
}

// Launch `clusters` clusters of `cs` blocks (grid cs x clusters) on the
// stream; max_active_clusters must have been called for the same sizes.
template <typename... Params, typename... Args>
inline int launch_clusters(void (*kernel)(Params...), int cs, int clusters, int threads,
                           size_t smem, cudaStream_t stream, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(cs, clusters, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace lstm
