// Shared pieces of the persistent LSTM kernels (lstm_fwd.cu, lstm2_fwd.cu,
// lstm_bwd.cu): stream-type conversions, the cell math, the launch plan
// that sizes a cooperative grid so every block is co-resident, and the
// plan every entry point reports.
//
// Layout contract (the JAX package's, deeplearning4j_tpu/ops/lstm_pallas.py):
// gate order IFOG, z = gate_in_t + h_{t-1} @ RW, cell math in float32,
// sigmoid over [i|f|o] and tanh over g. For bfloat16 streams h is rounded
// to bfloat16 before the product and the sum is kept in float32.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace lstm {

// Rows of the batch one block handles per pass. A pass stages those rows of
// h in kc-wide slices of a ROWS x tile_ld(kc) float tile. kc is the whole
// hidden size when the tiles fit beside the weights (one slice, one round
// trip to L2 per pass), else a power of two.
constexpr int ROWS = 32;
constexpr int MAX_THREADS = 256;
constexpr int LOAD_BATCH = 8;  // independent L2 loads in flight per thread

// Row stride of an h tile: a multiple of 4 floats, so a thread reads four
// steps of its row with one 16-byte load, and not a multiple of 32, so the
// rows a warp reads sit on different shared-memory banks.
__host__ __device__ inline int tile_ld(int kc) {
  const int ld = ((kc + 3) & ~3) + 4;
  return ld % 32 == 0 ? ld + 4 : ld;
}

enum Dtype { F32 = 0, BF16 = 1 };

// Custom error codes, negative so they never collide with cudaError_t.
enum Err { ERR_DTYPE = -1, ERR_NO_PLAN = -2 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as jnp .astype
}

// Round to the stream dtype and back: what a product reads of a value
// (h in the forwards, dz in the backward).
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return to_f32(from_f32<T>(v));
}

// Load a value another block wrote before the last grid barrier. The load
// goes to L2 (ld.global.cg) so a stale line in this SM's L1 is never read.
template <typename T> __device__ __forceinline__ float load_cg(const T* p);
template <> __device__ __forceinline__ float load_cg<float>(const float* p) {
  return __ldcg(p);
}
template <> __device__ __forceinline__ float load_cg<__nv_bfloat16>(const __nv_bfloat16* p) {
  unsigned short bits = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// One cell update in float32; c is updated in place, the new h returned.
__device__ __forceinline__ float cell(float zi, float zf, float zo, float zg, float& c) {
  const float i = sigmoid(zi), f = sigmoid(zf), o = sigmoid(zo), g = tanhf(zg);
  c = f * c + i * g;
  return o * tanhf(c);
}

// The same update for training: also hands back the post-activation gates
// (i, f, o, g) and tanh(c), the reserve space the backward reads.
__device__ __forceinline__ float cell_train(float zi, float zf, float zo, float zg, float& c,
                                            float4& act, float& tc) {
  act = make_float4(sigmoid(zi), sigmoid(zf), sigmoid(zo), tanhf(zg));
  c = act.y * c + act.x * act.w;
  tc = tanhf(c);
  return act.z * tc;
}

// Store the four gates of one (row, unit) at gate stride H.
template <typename T>
__device__ __forceinline__ void store_gates(T* p, const float4& v, int H) {
  p[0] = from_f32<T>(v.x);
  p[H] = from_f32<T>(v.y);
  p[2 * H] = from_f32<T>(v.z);
  p[3 * H] = from_f32<T>(v.w);
}

// Stage rows [rc, rc + nrows) x columns [k0, k0 + kn) of one or two (B, H)
// matrices into tiles of row stride ld (src_b may be null). Each thread
// issues all its loads of a batch -- LOAD_BATCH per matrix -- before it
// stores any, so a pass waits on L2 once per batch, not once per element.
template <typename T>
__device__ __forceinline__ void stage(float* tile_a, const T* src_a, float* tile_b,
                                      const T* src_b, int rc, int nrows, int k0, int kn,
                                      int ld, int H) {
  const int n = nrows * kn;
  for (int base = threadIdx.x; base < n; base += LOAD_BATCH * blockDim.x) {
    float va[LOAD_BATCH], vb[LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int idx = base + u * blockDim.x;
      const size_t off = (size_t)(rc + idx / kn) * H + k0 + idx % kn;
      va[u] = idx < n ? load_cg(src_a + off) : 0.f;
      vb[u] = idx < n && src_b ? load_cg(src_b + off) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < n) {
        const int at = (idx / kn) * ld + idx % kn;
        tile_a[at] = va[u];
        if (src_b) tile_b[at] = vb[u];
      }
    }
  }
}

// The four gate inputs of one (row, unit), read before h is staged so their
// latency overlaps the staging's.
template <typename T>
__device__ __forceinline__ float4 load_gates(const T* gi, int H) {
  return make_float4(to_f32(gi[0]), to_f32(gi[H]), to_f32(gi[2 * H]), to_f32(gi[3 * H]));
}

// Copy the columns a block owns out of an (H, 4H) weight matrix into
// shared memory as float32, the four gates of a unit side by side so a
// thread reads them with one 16-byte load:
// dst[k][j][g] = src[k][g * H + j0 + j].
template <typename T>
__device__ __forceinline__ void load_weights(float* dst, const T* src, int H, int j0,
                                             int hsz, int nj) {
  const int W4 = 4 * hsz;
  for (int idx = threadIdx.x; idx < H * W4; idx += blockDim.x) {
    const int k = idx / W4, j = (idx % W4) / 4, g = idx % 4;
    dst[idx] = j < nj ? to_f32(src[(size_t)k * 4 * H + g * H + j0 + j]) : 0.f;
  }
}

// acc += a * w, the four gates at once.
__device__ __forceinline__ void fma4(float4& acc, float a, const float4& w) {
  acc.x += a * w.x;
  acc.y += a * w.y;
  acc.z += a * w.z;
  acc.w += a * w.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The launch plan: hsz hidden units per block (nu = ceil(H / hsz) blocks
// across the units), nbb blocks across the batch, hsz * ROWS threads each,
// h staged kc columns at a time.
struct Plan {
  int hsz, nu, nbb, threads, kc;
  size_t smem;
};

// Pick the widest unit slice, then the deepest slice of the contraction
// (length K: H for the forward products, 4H for the backward's), whose
// weights and tiles fit one block's shared memory and whose grid is
// co-resident (a cooperative launch refuses a grid that is not). n_mats
// weight matrices of H * 4 * hsz floats and n_tiles staged tiles per block.
// With fill_batch a shallower slice is taken when the deeper one leaves the
// batch fewer blocks than it has row passes (more co-resident blocks).
inline int make_plan(const void* kernel, int B, int H, int K, int n_mats, int n_tiles,
                     bool fill_batch, Plan* p) {
  int dev, sms, max_smem;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const int want = (B + ROWS - 1) / ROWS;
  for (int hsz = 8; hsz >= 1; hsz /= 2) {
    const size_t wbytes = (size_t)n_mats * H * 4 * hsz * sizeof(float);
    bool found = false;
    Plan best{};
    for (int kc = K;; kc = kc > 256 ? 256 : kc / 2) {
      const size_t smem = wbytes + (size_t)n_tiles * ROWS * tile_ld(kc) * sizeof(float);
      if (smem <= (size_t)max_smem) {
        const int threads = hsz * ROWS;
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        if (e != cudaSuccess) return (int)e;
        int per_sm = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
        if (e != cudaSuccess) return (int)e;
        const int total = per_sm * sms, nu = (H + hsz - 1) / hsz;
        if (nu > total) break;  // a shallower slice does not add blocks
        int nbb = total / nu;
        if (nbb > want) nbb = want;
        if (nbb < 1) nbb = 1;
        if (!found || nbb > best.nbb) best = Plan{hsz, nu, nbb, threads, kc, smem};
        found = true;
        if (!fill_batch || nbb >= want) break;
      }
      if (kc <= 32) break;
    }
    if (found) {
      // the attribute must cover the chosen plan, not the last one tried
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)best.smem);
      if (e != cudaSuccess) return (int)e;
      *p = best;
      return 0;
    }
  }
  return ERR_NO_PLAN;
}

// plan_out of every entry point (PLAN_LEN ints, may be null): route (1
// cluster, 0 grid), cluster size, clusters, batch rows per cluster (per
// batch block on the grid route), units per block, blocks across the
// units, blocks across the batch, threads, k slice (grid route), shared
// bytes.
enum { PLAN_LEN = 10 };

inline void report_cluster_plan(int* out, int cs, int clusters, int rows, int u, int threads,
                                size_t smem) {
  if (out) {
    const int v[PLAN_LEN] = {1, cs, clusters, rows, u, cs, clusters, threads, 0, (int)smem};
    for (int k = 0; k < PLAN_LEN; ++k) out[k] = v[k];
  }
}

inline void report_grid_plan(int* out, const Plan& p, int B) {
  if (out) {
    const int v[PLAN_LEN] = {0,     0,    0,     (B + p.nbb - 1) / p.nbb,
                             p.hsz, p.nu, p.nbb, p.threads,
                             p.kc,  (int)p.smem};
    for (int k = 0; k < PLAN_LEN; ++k) out[k] = v[k];
  }
}

inline const char* error_text(int code) {
  if (code == ERR_DTYPE) return "unsupported stream dtype (want float32 or bfloat16)";
  if (code == ERR_NO_PLAN)
    return "no launch plan fits this hidden size on this device";
  return cudaGetErrorString((cudaError_t)code);
}

}  // namespace lstm
