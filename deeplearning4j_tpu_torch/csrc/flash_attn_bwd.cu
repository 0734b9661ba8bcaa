// Flash attention backward: K6 (dq) and K7 (dk, dv) over (BH, T, Dh)
// float32 q, k, v, the forward's output o, its gradient do, and the
// log-sum-exp lse (BH, T) that K5 (flash_attn_fwd.cu) writes. Both recompute
// the probabilities p = exp(q . k / sqrt(Dh) - lse) tile by tile instead of
// reading a (T, T) matrix.
//
// Replaces: deeplearning4j_tpu/ops/flash_attention.py::_dq_kernel (K6, call
// at _fa_bwd's first pallas_call) and ::_dkv_kernel (K7, the second), the
// backward of the custom VJP of flash_attention. Same function: with
// delta = rowsum(do * o), dp = do . v, ds = p * (dp - delta) * scale,
// dq = sum_j ds k_j, dk = sum_i ds q_i, dv = sum_i p do_i; causal pairs with
// key > query are dropped. The JAX package computes delta outside its
// kernels; here K6 computes it from the o and do rows of its queries and
// writes it (BH, T) for K7, which launches after K6 on the same stream.
//
// What bounds them on the card. Per (batch, head) K6 does 3 and K7 4
// products of T^2 Dh multiply-adds (halved when causal) and each moves 6 T Dh
// + 2 T floats in and out. At the training shape (BH 128, T = 64, Dh = 32,
// causal) that is 6.4 MB per kernel against 0.07 GFLOP: bytes (1.9 us at
// 3.35 TB/s), and in practice the latency of a block's first loads. At
// B = 64 x 4 heads, T = 512, causal it is about 102 MB against 6.4 and 8.6
// GFLOP: bytes still bound both kernels on the tensor cores (0.030 ms each,
// against 0.013 and 0.017 ms of operations at the 495 TFLOP/s TF32 rate).
// Float32 accuracy costs three tf32 products per product (below), which
// puts the products at 0.039 and 0.052 ms at that peak, above the byte
// bound; mma.sync issues below the peak, and splitting the operands costs
// about as many issue slots again.
//
// Design:
// - Tensor cores. Every product (s = q k^T, dp = do v^T and dq += ds k in
//   K6; s^T = k q^T, dp^T = v do^T, dv += p^T do and dk += ds^T q in K7) is
//   mma.sync m16n8k8 on tf32 operands with float32 accumulators. To keep
//   float32 accuracy each operand x is split into big = tf32(x) and small =
//   tf32(x - big) (rounded with integer operations, cheaper than the
//   conversion instruction), and a product is small*big + big*small +
//   big*big (3xTF32): the dropped small*small term is ~2^-22 of the
//   product. A single tf32 product keeps ~3 decimal digits, which the 1e-4
//   bars would not pass.
// - Accumulation. The tensor cores do not round a sum to nearest: a small
//   addend joining a large accumulator loses bits with a steady sign, and
//   over a sum of T terms the error grows with T and survives the weight
//   gradients' sums over positions. So the two small products go to an
//   accumulator of their own, and dq, dk and dv are summed per streamed
//   tile from zero and then added to their running sums with float32 adds.
//   That keeps the gradients within a few 1e-7 of the largest, as float32
//   FMAs do.
// - Warp rows. A warp owns 16 rows (one m16 fragment): K6 query rows, K7 key
//   rows; a block of 1, 2 or 4 warps owns 16, 32 or 64 rows, as many as
//   keep the grid at a block per SM or more (BH 128, T = 64: 256 blocks of
//   2 warps). The warp's lse and delta (K6) sit in registers. p and ds are
//   formed in the accumulator fragment and feed the next product as its A
//   operand without leaving registers: the contraction index of that
//   product runs over the 8 keys (K6) or queries (K7) of an accumulator
//   column block in the order 0,2,4,6 | 1,3,5,7 (accumulator columns 2t and
//   2t + 1 of thread t become A columns t and t + 4), and the B operand
//   reads its rows in the same order. A sum is the same in any order of its
//   terms, so no shuffle and no staging is needed.
// - Asynchronous copies. The streamed tiles (K6: 32 keys of k and v, 16 at
//   Dh 128; K7: 32 queries of q, do, lse and delta, 16 at Dh > 32) go
//   through a two-stage ring in shared memory filled with 16-byte
//   cp.async.cg (4-byte cp.async.ca for lse and delta), so the next tile's
//   load is in flight while the current one computes. The block's own rows
//   (q and do, or k and v) are loaded once with the first tile. Shared rows
//   are padded by 4 floats, so every fragment read is free of bank
//   conflicts. Rows past T and columns past Dh are zero-filled by the copy.
// - The causal triangle. A warp skips a tile none of whose pairs it keeps,
//   and masks per element (p = 0) only on a tile that crosses its diagonal
//   or the ragged tail. K6 orders its blocks last query tile first, K7
//   first key tile first, so the longest blocks start first.
// - Determinism. No atomics and no split of an output across blocks: K6
//   owns query rows, K7 key rows, and every output element is written once
//   in one order, so the gradients are the same run to run.
//
// Dh is a multiple of 8 up to 128, handled by instantiations for head dims
// 16, 32, 64 and 128 (a smaller Dh zero-padded in shared memory); any T.
// Registers per thread (non-causal / causal), from nvcc -Xptxas -v for
// sm_90a, no spills in any; dynamic shared memory per block of 4 warps:
//   K6 dq   Dh 16:  85 /  96, 20,480 B    Dh 32: 126 / 114, 36,864 B
//           Dh 64: 163 / 163, 69,632 B    Dh 128: 167 / 168, 101,376 B
//   K7 dkv  Dh 16: 100 / 108, 20,992 B    Dh 32: 159 / 159, 37,376 B
//           Dh 64: 168 / 173, 52,480 B    Dh 128: 255 / 255, 101,632 B
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARP_ROWS = 16;            // rows a warp owns
constexpr int MAX_WARPS = 4;
constexpr int STAGES = 2;                // depth of the shared-memory ring
constexpr int PAD = 4;                   // floats after each shared row
constexpr int MAX_DH = 128;
constexpr float LOG2E = 1.4426950408889634f;

// Tile shapes by head dim, sized so no instantiation spills: keys per
// streamed tile of K6, queries per streamed tile of K7, and the head-dim
// columns (in 8-wide fragments) of dq (K6) or dk and dv (K7) summed per
// tile before they join their running sums.
__host__ __device__ constexpr int key_tile(int dh) { return dh > 64 ? 16 : 32; }
__host__ __device__ constexpr int query_tile(int dh) { return dh > 32 ? 16 : 32; }
__host__ __device__ constexpr int dq_group(int dh) { return dh > 64 ? 2 : dh > 32 ? 4 : dh / 8; }
__host__ __device__ constexpr int dkv_group(int dh) { return dh > 64 ? 1 : dh > 32 ? 2 : dh / 8; }

enum Err { ERR_HEAD_DIM = -1, ERR_SHAPE = -2, ERR_ALIGN = -3 };

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

// rows row0 .. row0 + n - 1 of a (T, Dh) matrix into a shared tile of LD
// floats per row; rows at or past T and columns at or past Dh are zero
template <int DH>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int n, int T,
                                          int Dh) {
  constexpr int LD = DH + PAD, CHUNKS = DH / 4;
  for (int i = threadIdx.x; i < n * CHUNKS; i += blockDim.x) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    const bool ok = row0 + r < T && c < Dh;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)(row0 + r) * Dh + c : src, ok);
  }
}

// entries i0 .. i0 + n - 1 of a length-T vector, zero at or past T
__device__ __forceinline__ void load_vec(float* dst, const float* src, int i0, int n, int T) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool ok = i0 + i < T;
    cp_async4(dst + i, ok ? src + i0 + i : src, ok);
  }
}

// ---- K6 -----------------------------------------------------------------

// Shared memory: q and do of the block's rows, then the ring of key tiles
// (k then v, KT rows each, per stage).
template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    flash_attn_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ o,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ dq, float* __restrict__ delta, int T, int Dh,
                         float scale) {
  constexpr int KT = key_tile(DH), LD = DH + PAD, NK = DH / 8, NT = KT / 8, NG = dq_group(DH);
  extern __shared__ __align__(16) float smem[];
  const int rows = (blockDim.x / 32) * WARP_ROWS;
  float* q_s = smem;
  float* do_s = q_s + rows * LD;
  float* ring = do_s + rows * LD;

  const int bh = blockIdx.x;
  const int tile = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // longest first
  const int q0 = tile * rows;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r0 = q0 + warp * WARP_ROWS;  // the warp's first row
  const size_t base = (size_t)bh * T * Dh;
  const int kend = CAUSAL ? min(T, q0 + rows) : T;
  const int ntiles = (kend + KT - 1) / KT;

  load_rows<DH>(q_s, q + base, q0, rows, T, Dh);
  load_rows<DH>(do_s, dout + base, q0, rows, T, Dh);
  load_rows<DH>(ring, k + base, 0, KT, T, Dh);
  load_rows<DH>(ring + KT * LD, v + base, 0, KT, T, Dh);
  cp_async_commit();

  // delta and lse of the thread's rows ra = r0 + g and rb = r0 + g + 8,
  // while the first copies are in flight; the four threads of a row sum
  // every fourth float4 of it
  const int ra = r0 + g, rb = ra + 8;
  float dla = 0.f, dlb = 0.f;
  for (int c = 4 * t; c < Dh; c += 16) {
    if (ra < T) {
      const float4 x = *(const float4*)(o + base + (size_t)ra * Dh + c);
      const float4 y = *(const float4*)(dout + base + (size_t)ra * Dh + c);
      dla = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, dla))));
    }
    if (rb < T) {
      const float4 x = *(const float4*)(o + base + (size_t)rb * Dh + c);
      const float4 y = *(const float4*)(dout + base + (size_t)rb * Dh + c);
      dlb = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, dlb))));
    }
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    dla += __shfl_xor_sync(0xffffffffu, dla, w);
    dlb += __shfl_xor_sync(0xffffffffu, dlb, w);
  }
  if (t == 0) {
    if (ra < T) delta[(size_t)bh * T + ra] = dla;
    if (rb < T) delta[(size_t)bh * T + rb] = dlb;
  }
  // p = exp2(s * scale * log2(e) - lse * log2(e))
  const float ma = ra < T ? lse[(size_t)bh * T + ra] * LOG2E : 0.f;
  const float mb = rb < T ? lse[(size_t)bh * T + rb] * LOG2E : 0.f;
  const float sl = scale * LOG2E;

  float acc[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      float* next = ring + ((it + 1) % STAGES) * 2 * KT * LD;
      load_rows<DH>(next, k + base, (it + 1) * KT, KT, T, Dh);
      load_rows<DH>(next + KT * LD, v + base, (it + 1) * KT, KT, T, Dh);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int k0 = it * KT;
    const float* k_s = ring + (it % STAGES) * 2 * KT * LD;
    const float* v_s = k_s + KT * LD;
    // a warp whose rows are all dead, or all before the tile's first key,
    // keeps no pair of the tile
    if (r0 < T && (!CAUSAL || k0 <= r0 + WARP_ROWS - 1)) {
      float s[NT][4], dp[NT][4], s2[NT][4], dp2[NT][4];
      zero(s), zero(dp), zero(s2), zero(dp2);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        Frag<4> qa, da;
        load_a<LD>(qa, q_s + warp * WARP_ROWS * LD, kk * 8, g, t);
        load_a<LD>(da, do_s + warp * WARP_ROWS * LD, kk * 8, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          Frag<2> b;
          load_bt<LD>(b, k_s, n * 8, kk * 8, g, t);
          mma3(s[n], s2[n], qa, b);
          load_bt<LD>(b, v_s, n * 8, kk * 8, g, t);
          mma3(dp[n], dp2[n], da, b);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] += s2[n][i], dp[n][i] += dp2[n][i];
      // p and ds in the accumulators (s becomes ds); elements are masked
      // only on a tile that crosses the diagonal or the ragged tail
      const bool edge = (CAUSAL && k0 + KT - 1 > r0) || k0 + KT > T || r0 + WARP_ROWS > T;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i < 2 ? ra : rb, key = k0 + n * 8 + 2 * t + (i & 1);
          float p = exp2f(fmaf(s[n][i], sl, -(i < 2 ? ma : mb)));
          if (edge && (key >= T || row >= T || (CAUSAL && key > row))) p = 0.f;
          s[n][i] = p * (dp[n][i] - (i < 2 ? dla : dlb));
        }
      // dq += ds k, contracting over the tile's keys in a_from_acc's order;
      // the tile's sum is formed from zero, NG fragments at a time, then
      // added to the running sum
#pragma unroll
      for (int g0 = 0; g0 < NK; g0 += NG) {
        float pb[NG][4], ps[NG][4];
        zero(pb), zero(ps);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          Frag<4> a;
          a_from_acc(a, s[j]);
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            Frag<2> b;
            load_bp<LD>(b, k_s, j * 8, (g0 + n) * 8, g, t);
            mma3(pb[n], ps[n], a, b);
          }
        }
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[g0 + n][i] += pb[n][i] + ps[n][i];
      }
    }
    __syncthreads();  // the stage is refilled in the next iteration
  }

#pragma unroll
  for (int n = 0; n < NK; ++n) {
    const int c = n * 8 + 2 * t;
    if (c >= Dh) continue;
    if (ra < T)
      *(float2*)(dq + base + (size_t)ra * Dh + c) = make_float2(acc[n][0] * scale, acc[n][1] * scale);
    if (rb < T)
      *(float2*)(dq + base + (size_t)rb * Dh + c) = make_float2(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// ---- K7 -----------------------------------------------------------------

// Shared memory: k and v of the block's rows, then the ring of query tiles
// (q, do: QT rows each; lse, delta: QT floats each, per stage).
template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    flash_attn_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int T, int Dh,
                          float scale) {
  constexpr int QT = query_tile(DH), LD = DH + PAD, NK = DH / 8, NT = QT / 8, NG = dkv_group(DH);
  constexpr int STAGE = 2 * QT * LD + 2 * QT;  // floats per ring stage
  extern __shared__ __align__(16) float smem[];
  const int rows = (blockDim.x / 32) * WARP_ROWS;
  float* k_s = smem;
  float* v_s = k_s + rows * LD;
  float* ring = v_s + rows * LD;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * rows;  // causal: the first key tiles are the longest
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r0 = k0 + warp * WARP_ROWS;  // the warp's first key
  const int ra = r0 + g, rb = ra + 8;
  const size_t base = (size_t)bh * T * Dh;
  const float* lse_bh = lse + (size_t)bh * T;
  const float* delta_bh = delta + (size_t)bh * T;
  // the first query tile that sees the block's first key, aligned to QT so
  // the tiles do not depend on the block's size
  const int qbegin = CAUSAL ? k0 / QT * QT : 0;
  const int ntiles = (T - qbegin + QT - 1) / QT;

  auto load_tile = [&](int it) {
    float* st = ring + (it % STAGES) * STAGE;
    const int i0 = qbegin + it * QT;
    load_rows<DH>(st, q + base, i0, QT, T, Dh);
    load_rows<DH>(st + QT * LD, dout + base, i0, QT, T, Dh);
    load_vec(st + 2 * QT * LD, lse_bh, i0, QT, T);
    load_vec(st + 2 * QT * LD + QT, delta_bh, i0, QT, T);
  };
  load_rows<DH>(k_s, k + base, k0, rows, T, Dh);
  load_rows<DH>(v_s, v + base, k0, rows, T, Dh);
  load_tile(0);
  cp_async_commit();
  const float sl = scale * LOG2E;  // p = exp2(s * scale * log2(e) - lse * log2(e))

  float dka[NK][4], dva[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_tile(it + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int q0 = qbegin + it * QT;
    const float* q_s = ring + (it % STAGES) * STAGE;
    const float* do_s = q_s + QT * LD;
    const float* lse_s = do_s + QT * LD;
    const float* dl_s = lse_s + QT;
    if (r0 < T && (!CAUSAL || q0 + QT - 1 >= r0)) {
      // s^T = k q^T and dp^T = v do^T: rows are keys, columns queries
      float s[NT][4], dp[NT][4], s2[NT][4], dp2[NT][4];
      zero(s), zero(dp), zero(s2), zero(dp2);
      // unrolled by 4: fully, ptxas holds too many loads in flight at Dh 128
#pragma unroll 4
      for (int kk = 0; kk < NK; ++kk) {
        Frag<4> ka, va;
        load_a<LD>(ka, k_s + warp * WARP_ROWS * LD, kk * 8, g, t);
        load_a<LD>(va, v_s + warp * WARP_ROWS * LD, kk * 8, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          Frag<2> b;
          load_bt<LD>(b, q_s, n * 8, kk * 8, g, t);
          mma3(s[n], s2[n], ka, b);
          load_bt<LD>(b, do_s, n * 8, kk * 8, g, t);
          mma3(dp[n], dp2[n], va, b);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] += s2[n][i], dp[n][i] += dp2[n][i];
      // p^T in s, ds^T in dp
      const bool edge = (CAUSAL && q0 < r0 + WARP_ROWS - 1) || q0 + QT > T || r0 + WARP_ROWS > T;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = n * 8 + 2 * t + (i & 1), qi = q0 + col, key = i < 2 ? ra : rb;
          float p = exp2f(fmaf(s[n][i], sl, -lse_s[col] * LOG2E));
          if (edge && (qi >= T || key >= T || (CAUSAL && qi < key))) p = 0.f;
          dp[n][i] = p * (dp[n][i] - dl_s[col]);
          s[n][i] = p;
        }
      // dv += p^T do and dk += ds^T q, contracting over the tile's queries;
      // the tile's sums are formed from zero, NG fragments at a time, then
      // added to the running sums
#pragma unroll
      for (int g0 = 0; g0 < NK; g0 += NG) {
        float vb[NG][4], vs[NG][4], kb[NG][4], ks[NG][4];
        zero(vb), zero(vs), zero(kb), zero(ks);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          Frag<4> pa, sa;
          a_from_acc(pa, s[j]);
          a_from_acc(sa, dp[j]);
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            Frag<2> b;
            load_bp<LD>(b, do_s, j * 8, (g0 + n) * 8, g, t);
            mma3(vb[n], vs[n], pa, b);
            load_bp<LD>(b, q_s, j * 8, (g0 + n) * 8, g, t);
            mma3(kb[n], ks[n], sa, b);
          }
        }
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[g0 + n][i] += vb[n][i] + vs[n][i];
            dka[g0 + n][i] += kb[n][i] + ks[n][i];
          }
      }
    }
    __syncthreads();  // the stage is refilled in the next iteration
  }

#pragma unroll
  for (int n = 0; n < NK; ++n) {
    const int c = n * 8 + 2 * t;
    if (c >= Dh) continue;
    if (ra < T) {
      *(float2*)(dk + base + (size_t)ra * Dh + c) = make_float2(dka[n][0] * scale, dka[n][1] * scale);
      *(float2*)(dv + base + (size_t)ra * Dh + c) = make_float2(dva[n][0], dva[n][1]);
    }
    if (rb < T) {
      *(float2*)(dk + base + (size_t)rb * Dh + c) = make_float2(dka[n][2] * scale, dka[n][3] * scale);
      *(float2*)(dv + base + (size_t)rb * Dh + c) = make_float2(dva[n][2], dva[n][3]);
    }
  }
}

// ---- launches -----------------------------------------------------------

int check(const void* const* ptrs, int n, int BH, int T, int Dh, int device) {
  if (Dh < 8 || Dh > MAX_DH || Dh % 8 != 0) return ERR_HEAD_DIM;
  if (BH < 1 || T < 1 || (T + WARP_ROWS - 1) / WARP_ROWS > 65535) return ERR_SHAPE;
  for (int i = 0; i < n; ++i)
    if ((uintptr_t)ptrs[i] % 16 != 0) return ERR_ALIGN;
  return (int)cudaSetDevice(device);
}

// Warps per block: the most (up to 4) that still give a block per SM.
int warps_per_block(int BH, int T, int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  for (int nw = MAX_WARPS; nw > 1; nw /= 2)
    if ((long long)BH * ((T + nw * WARP_ROWS - 1) / (nw * WARP_ROWS)) >= sms) return nw;
  return 1;
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int BH, int T, int nw, cudaStream_t stream,
           const float* a, const float* b, const float* c, const float* d, const float* e,
           const float* f, float* x, float* y, int Dh) {
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int rows = nw * WARP_ROWS;
  const dim3 grid(BH, (T + rows - 1) / rows);
  kernel<<<grid, nw * 32, smem, stream>>>(a, b, c, d, e, f, x, y, T, Dh, 1.f / sqrtf((float)Dh));
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dq(const float* q, const float* k, const float* v, const float* o, const float* dout,
              const float* lse, float* dq, float* delta, int BH, int T, int Dh, bool causal,
              int device, cudaStream_t stream) {
  const int nw = warps_per_block(BH, T, device);
  const size_t smem = sizeof(float) * (2 * nw * WARP_ROWS + STAGES * 2 * key_tile(DH)) * (DH + PAD);
  return causal ? launch(flash_attn_dq_kernel<DH, true>, smem, BH, T, nw, stream, q, k, v, o,
                         dout, lse, dq, delta, Dh)
                : launch(flash_attn_dq_kernel<DH, false>, smem, BH, T, nw, stream, q, k, v, o,
                         dout, lse, dq, delta, Dh);
}

template <int DH>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* delta, float* dk, float* dv, int BH, int T, int Dh,
               bool causal, int device, cudaStream_t stream) {
  constexpr int QT = query_tile(DH);
  const int nw = warps_per_block(BH, T, device);
  const size_t smem =
      sizeof(float) * ((2 * nw * WARP_ROWS + STAGES * 2 * QT) * (DH + PAD) + STAGES * 2 * QT);
  return causal ? launch(flash_attn_dkv_kernel<DH, true>, smem, BH, T, nw, stream, q, k, v, dout,
                         lse, delta, dk, dv, Dh)
                : launch(flash_attn_dkv_kernel<DH, false>, smem, BH, T, nw, stream, q, k, v, dout,
                         lse, delta, dk, dv, Dh);
}

}  // namespace

// K6. q, k, v, o, dout, dq: (BH, T, Dh) float32, contiguous, 16-byte
// aligned; lse, delta: (BH, T) float32 (delta is written). Dh a multiple of
// 8 up to 128. Returns 0, a cudaError_t, or an Err.
extern "C" int flash_attn_dq(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* dq, void* delta,
                             int BH, int T, int Dh, int causal, int device, void* stream) {
  const void* ptrs[] = {q, k, v, o, dout, dq};
  const int rc = check(ptrs, 6, BH, T, Dh, device);
  if (rc != 0) return rc;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v,
              *of = (const float*)o, *df = (const float*)dout, *lf = (const float*)lse;
  float *dqf = (float*)dq, *dlf = (float*)delta;
  cudaStream_t s = (cudaStream_t)stream;
  if (Dh <= 16)
    return launch_dq<16>(qf, kf, vf, of, df, lf, dqf, dlf, BH, T, Dh, causal, device, s);
  if (Dh <= 32)
    return launch_dq<32>(qf, kf, vf, of, df, lf, dqf, dlf, BH, T, Dh, causal, device, s);
  if (Dh <= 64)
    return launch_dq<64>(qf, kf, vf, of, df, lf, dqf, dlf, BH, T, Dh, causal, device, s);
  return launch_dq<128>(qf, kf, vf, of, df, lf, dqf, dlf, BH, T, Dh, causal, device, s);
}

// K7. q, k, v, dout, dk, dv: (BH, T, Dh) float32, contiguous, 16-byte
// aligned; lse, delta: (BH, T) float32 (delta as K6 wrote it). Returns as K6.
extern "C" int flash_attn_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dk, void* dv, int BH,
                              int T, int Dh, int causal, int device, void* stream) {
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  const int rc = check(ptrs, 6, BH, T, Dh, device);
  if (rc != 0) return rc;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v,
              *df = (const float*)dout, *lf = (const float*)lse, *dlf = (const float*)delta;
  float *dkf = (float*)dk, *dvf = (float*)dv;
  cudaStream_t s = (cudaStream_t)stream;
  if (Dh <= 16)
    return launch_dkv<16>(qf, kf, vf, df, lf, dlf, dkf, dvf, BH, T, Dh, causal, device, s);
  if (Dh <= 32)
    return launch_dkv<32>(qf, kf, vf, df, lf, dlf, dkf, dvf, BH, T, Dh, causal, device, s);
  if (Dh <= 64)
    return launch_dkv<64>(qf, kf, vf, df, lf, dlf, dkf, dvf, BH, T, Dh, causal, device, s);
  return launch_dkv<128>(qf, kf, vf, df, lf, dlf, dkf, dvf, BH, T, Dh, causal, device, s);
}

extern "C" const char* flash_attn_bwd_error(int code) {
  if (code == ERR_HEAD_DIM) return "head dim must be a multiple of 8 in [8, 128]";
  if (code == ERR_SHAPE) return "BH and T must be >= 1 (and T / 16 <= 65535)";
  if (code == ERR_ALIGN) return "q, k, v, o, do and the gradients must be 16-byte aligned";
  return cudaGetErrorString((cudaError_t)code);
}
