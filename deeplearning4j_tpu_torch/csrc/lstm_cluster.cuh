// Thread-block clusters for the LSTM kernels: a reduce-scatter of partial
// products through distributed shared memory (DSMEM), the cluster barrier
// that orders it, and the host side that sizes and launches a cluster grid.
//
// The pattern: the cs blocks of a cluster (cs <= 16) split the hidden units
// between them, u = ceil(H / cs) each (the last ones ragged or empty). Each
// block forms a partial (rows x H) product from the columns it owns and
// keeps it in its own shared memory. One cluster barrier (release on
// arrive, acquire on wait) makes every partial visible to the cluster; each
// block then reads its own units' columns of the cs partials from its peers
// (ld.shared::cluster) and adds them in rank order, so the sum is the same
// on every launch (no atomics). Partials alternate between two halves by
// step parity: a block writes half s % 2 at step s only after the barrier
// of step s + 1, which every peer passed after reading that half at the
// start of step s + 1. Reading, not writing, across blocks: on an H100
// the remote stores took longer than a step's product, the remote loads
// (issued together) far less.
//
// Needs sm_90 (mapa, ld.shared::cluster, barrier.cluster). Only the
// kernels that include this header launch as clusters; K1, K2 and K4 do
// not.
#pragma once

#include <cuda_runtime.h>

#include <utility>

namespace lstm {

// Rank of this block in its cluster.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives (release: its shared
// and DSMEM writes become visible) and waits (acquire). Also a block-wide
// barrier. All threads of each warp must reach it together.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
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

// Clusters of `cs` blocks of `threads` threads and `smem` dynamic bytes
// that can run at once on this device: 0 when such a cluster cannot run
// (too much shared memory, or a size past 8 the device does not allow).
// Sets the kernel's shared-memory and, past 8, non-portable cluster
// attributes, which a launch of those sizes needs too.
template <typename Kernel>
inline int max_active_clusters(Kernel kernel, int cs, int threads, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess && cs > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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
