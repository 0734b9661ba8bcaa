// Thread-block clusters on Hopper: the cluster barrier, loads from and
// stores to a peer block's shared memory (distributed shared memory,
// DSMEM), and the host side that sizes, caches and launches a cluster
// grid. Shared by the LSTM kernels (lstm_cluster.cuh builds their
// exchanges on it) and the flash decode kernels (flash_decode.cu).
//
// Needs sm_90 (mapa, ld/st.shared::cluster, barrier.cluster).
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace dsmem {

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

// Arrive without ordering memory: for the barrier that shows every block
// of the cluster has started, which a block must know before it stores
// into a peer's shared memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
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

// Store v at a shared::cluster address (another block's shared memory, or
// this block's own); a cluster barrier makes it visible to that block.
__device__ __forceinline__ void peer_store(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

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

// Launch a grid of clusters of `cs` blocks along x (grid.x a multiple of
// cs) on the stream; max_active_clusters must have been called for the
// same sizes.
template <typename... Params, typename... Args>
inline int launch_cluster_grid(void (*kernel)(Params...), int cs, dim3 grid, int threads,
                               size_t smem, cudaStream_t stream, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Launch `clusters` clusters of `cs` blocks (grid cs x clusters: a block's
// cluster is blockIdx.y) on the stream.
template <typename... Params, typename... Args>
inline int launch_clusters(void (*kernel)(Params...), int cs, int clusters, int threads,
                           size_t smem, cudaStream_t stream, Args&&... args) {
  return launch_cluster_grid(kernel, cs, dim3(cs, clusters, 1), threads, smem, stream,
                             std::forward<Args>(args)...);
}

}  // namespace dsmem
