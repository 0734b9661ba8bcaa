// Tensor-core and copy helpers shared by the flash-attention kernels: K5
// (flash_attn_fwd.cu) and K6, K7 (flash_attn_bwd.cu).
//
// - tf32 products in float32 accuracy: mma.sync m16n8k8 on tf32 operands,
//   each float32 operand split into big = tf32(x) and small = tf32(x - big),
//   a product taken as small*big + big*small + big*big (3xTF32; the dropped
//   small*small term is ~2^-22 of the product).
// - Fragment loads from row-major shared tiles, and the column permutation
//   that turns an accumulator into the A operand of the next product.
// - cp.async copies of rows, vectors and 128-column chunks of rows into a
//   shared-memory ring.
// - Warps per block, the column-chunk split of head dims past 128, and a
//   launch that raises the dynamic shared-memory limit where it must.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARP_ROWS = 16;            // rows a warp owns (one m16 fragment)
constexpr int MAX_WARPS = 4;
constexpr int STAGES = 2;                // depth of the shared-memory ring
constexpr int PAD = 4;                   // floats after each shared row
constexpr int CHUNK = 128;               // head-dim columns a block holds
constexpr int SCORE_STEPS = 4;           // k-steps of a score summed from zero
constexpr float LOG2E = 1.4426950408889634f;

// ---- tf32 tensor-core products ------------------------------------------

// x rounded to tf32 (10 mantissa bits, to nearest, ties away from zero) as
// cvt.rna.tf32.f32 rounds it, in two integer operations
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// An operand fragment as its big and small tf32 halves.
template <int N>
struct Frag {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void set(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) split(x[i], big[i], small[i]);
  }
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// big + small (16 x 8) += a (16 x 8) b (8 x 8) in 3xTF32: the two small
// products into small, big*big into big. The tensor cores do not round an
// accumulation to nearest, so a small product added to a large sum loses
// bits with a steady sign; kept apart, and each tile's sum formed from zero
// and added to its running sum in float32, the errors stay at float32's.
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  mma(small, a.small, b.big);
  mma(small, a.big, b.small);
  mma(big, a.big, b.big);
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// sum = part (first) or sum + part in float32: a partial sum formed from
// zero on the tensor cores joins its running sum rounded to nearest
template <int N>
__device__ __forceinline__ void sum_into(float (&sum)[N][4], const float (&part)[N][4],
                                         bool first) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) sum[n][i] = first ? part[n][i] : sum[n][i] + part[n][i];
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A holds (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B holds (k = t, n = g) and
// (k = t + 4, n = g); the accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1). Shared tiles are row-major with LD floats per row.

// A = rows 0..15, columns c0..c0+7 of a tile
template <int LD>
__device__ __forceinline__ void load_a(Frag<4>& a, const float* tile, int c0, int g, int t) {
  const float* p = tile + g * LD + c0 + t;
  const float x[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
  a.set(x);
}

// load_a from a tile already split into its big and small halves
template <int LD>
__device__ __forceinline__ void load_a_split(Frag<4>& a, const uint32_t* big,
                                             const uint32_t* small, int c0, int g, int t) {
  const int i = g * LD + c0 + t;
  const int at[4] = {i, i + 8 * LD, i + 4, i + 8 * LD + 4};
#pragma unroll
  for (int j = 0; j < 4; ++j) a.big[j] = big[at[j]], a.small[j] = small[at[j]];
}

// B[k][n] = tile[r0 + n][c0 + k]: the product against a tile's transpose
template <int LD>
__device__ __forceinline__ void load_bt(Frag<2>& b, const float* tile, int r0, int c0, int g,
                                        int t) {
  const float* p = tile + (r0 + g) * LD + c0 + t;
  const float x[2] = {p[0], p[4]};
  b.set(x);
}

// B[k][n] = tile[r0 + perm(k)][c0 + n], perm = 0,2,4,6,1,3,5,7: the rows in
// the order of an A operand taken from an accumulator (a_from_acc)
template <int LD>
__device__ __forceinline__ void load_bp(Frag<2>& b, const float* tile, int r0, int c0, int g,
                                        int t) {
  const float* p = tile + (r0 + 2 * t) * LD + c0 + g;
  const float x[2] = {p[0], p[LD]};
  b.set(x);
}

__device__ __forceinline__ void a_from_acc(Frag<4>& a, const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  a.set(x);
}

// ---- asynchronous copies ------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most one group (the newest) is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// columns col0 .. col0 + DH - 1 of rows row0 .. row0 + n - 1 of a (T, Dh)
// matrix into a shared tile of DH + PAD floats per row; rows at or past T
// and columns at or past Dh are zero (Dh is a multiple of 8, so a 16-byte
// copy never straddles it)
template <int DH>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int n, int T,
                                          int Dh, int col0 = 0) {
  constexpr int LD = DH + PAD, CHUNKS = DH / 4;
  for (int i = threadIdx.x; i < n * CHUNKS; i += blockDim.x) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    const bool ok = row0 + r < T && col0 + c < Dh;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)(row0 + r) * Dh + col0 + c : src, ok);
  }
}

// entries i0 .. i0 + n - 1 of a length-T vector, zero at or past T
__device__ __forceinline__ void load_vec(float* dst, const float* src, int i0, int n, int T) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool ok = i0 + i < T;
    cp_async4(dst + i, ok ? src + i0 + i : src, ok);
  }
}

// ---- the column-chunk split and launches ----------------------------------

// Head dims past CHUNK are cut into CHUNK-wide column chunks (the last one
// ragged); a block owns the output columns of one chunk, oc, and streams
// every chunk of its operands to form the scores over the full head dim.
__host__ __device__ __forceinline__ int chunks(int Dh) { return (Dh + CHUNK - 1) / CHUNK; }

// The chunk a block streams at step cc (0 .. nc - 1) of a tile: the order
// ends at the block's own chunk oc, so the last step leaves oc's columns of
// the streamed tile in shared memory for the output products.
__device__ __forceinline__ int step_chunk(int cc, int oc, int nc) { return (oc + 1 + cc) % nc; }

// Warps per block: the most (up to 4) that still give a block per SM, for
// `blocks` (batch, head, column chunk) triples of T rows each.
inline int warps_per_block(long long blocks, int T, int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  for (int nw = MAX_WARPS; nw > 1; nw /= 2)
    if (blocks * ((T + nw * WARP_ROWS - 1) / (nw * WARP_ROWS)) >= sms) return nw;
  return 1;
}

template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                  Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
