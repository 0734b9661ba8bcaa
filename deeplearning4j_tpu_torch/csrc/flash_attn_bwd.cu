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
// - Scores past 128 columns. Summed over a 256-wide head in one tensor-core
//   accumulator, scores of magnitude ~900 carry 5x float32's error (a numpy
//   model of the truncation); so in the split s and dp are summed from zero
//   over SCORE_STEPS k-steps (32 columns) at a time and the sums added in
//   float32, as K5 sums its scores at every head dim. At Dh <= 128 the
//   scores stay one sum per tile.
// - Head dims past 128: the column-chunk split. The grid's x runs over
//   (bh, chunk) pairs, ceil(Dh / 128) chunks of 128 columns (the last one
//   ragged, down to 8). A block forms s and dp over the full Dh by
//   streaming, per tile, every chunk of its own rows and of the tile's rows
//   through the ring (its rows are no longer resident; chunks ordered to
//   end at its own, which the output products then read), and accumulates
//   and writes only its own chunk of dq (K6) or dk and dv (K7); no register
//   array grows with Dh. Every block recomputes s and dp: at Dh 256 that is
//   2x the q . k and do . v work, the price of each output element written
//   once by one block, with no atomics, so the split stays bitwise
//   repeatable. K6 computes delta from the full rows of o and do in every
//   chunk, since its own ds needs it; chunk 0 writes it.
//
// Dh is any multiple of 8: instantiations for head dims 16, 32, 64 and 128
// (a smaller Dh zero-padded in shared memory) and the 128-column split; any
// T. The tf32 products, fragment loads and copies are in flash_tc.cuh.
// Registers per thread (non-causal / causal), from nvcc -Xptxas -v for
// sm_90a (CUDA 12.8), no spills in any; dynamic shared memory per block of
// 4 warps:
//   K6 dq   Dh 16:  96 / 102, 20,480 B    Dh 32: 122 / 118, 36,864 B
//           Dh 64: 164 / 165, 69,632 B    Dh 128: 167 / 168, 101,376 B
//           split: 163 / 164, 168,960 B
//   K7 dkv  Dh 16: 100 / 108, 20,992 B    Dh 32: 159 / 159, 37,376 B
//           Dh 64: 168 / 173, 52,480 B    Dh 128: 255 / 255, 101,632 B
//           split: 241 / 241, 169,216 B
#include "flash_tc.cuh"

namespace {

// Tile shapes by head dim, sized so no instantiation spills: keys per
// streamed tile of K6, queries per streamed tile of K7, and the head-dim
// columns (in 8-wide fragments) of dq (K6) or dk and dv (K7) summed per
// tile before they join their running sums.
__host__ __device__ constexpr int key_tile(int dh) { return dh > 64 ? 16 : 32; }
__host__ __device__ constexpr int query_tile(int dh) { return dh > 32 ? 16 : 32; }
__host__ __device__ constexpr int dq_group(int dh) { return dh > 64 ? 2 : dh > 32 ? 4 : dh / 8; }
__host__ __device__ constexpr int dkv_group(int dh) { return dh > 64 ? 1 : dh > 32 ? 2 : dh / 8; }

enum Err { ERR_HEAD_DIM = -1, ERR_SHAPE = -2, ERR_ALIGN = -3 };

// ---- K6 -----------------------------------------------------------------

// Shared memory. Narrow (Dh <= DH): q and do of the block's rows, then the
// ring of key tiles (k then v, KT rows each, per stage). WIDE (DH = CHUNK <
// Dh): the ring alone, a stage holding one chunk of the block's q and do
// rows and of the tile's k and v.
template <int DH, bool CAUSAL, bool WIDE>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    flash_attn_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ o,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ dq, float* __restrict__ delta, int T, int Dh,
                         float scale) {
  constexpr int KT = key_tile(DH), LD = DH + PAD, NK = DH / 8, NT = KT / 8, NG = dq_group(DH);
  constexpr int SG = WIDE ? SCORE_STEPS : NK;  // k-steps of s and dp summed from zero
  extern __shared__ __align__(16) float smem[];
  const int rows = (blockDim.x / 32) * WARP_ROWS;
  const int nc = WIDE ? chunks(Dh) : 1;
  const int bh = blockIdx.x / nc, oc = blockIdx.x % nc;
  const int stage = (WIDE ? 2 * rows + 2 * KT : 2 * KT) * LD;  // floats per ring stage
  float* q_s = smem;
  float* do_s = q_s + rows * LD;
  float* ring = WIDE ? smem : do_s + rows * LD;

  const int tile = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // longest first
  const int q0 = tile * rows;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r0 = q0 + warp * WARP_ROWS;  // the warp's first row
  const size_t base = (size_t)bh * T * Dh;
  const int kend = CAUSAL ? min(T, q0 + rows) : T;
  const int nsteps = (kend + KT - 1) / KT * nc;

  auto load_step = [&](int s) {
    float* st = ring + (s % STAGES) * stage;
    const int k0 = s / nc * KT, col = step_chunk(s % nc, oc, nc) * DH;
    if (WIDE) {
      load_rows<DH>(st, q + base, q0, rows, T, Dh, col);
      load_rows<DH>(st + rows * LD, dout + base, q0, rows, T, Dh, col);
      st += 2 * rows * LD;
    }
    load_rows<DH>(st, k + base, k0, KT, T, Dh, col);
    load_rows<DH>(st + KT * LD, v + base, k0, KT, T, Dh, col);
  };
  if (!WIDE) {
    load_rows<DH>(q_s, q + base, q0, rows, T, Dh);
    load_rows<DH>(do_s, dout + base, q0, rows, T, Dh);
  }
  load_step(0);
  cp_async_commit();

  // delta and lse of the thread's rows ra = r0 + g and rb = r0 + g + 8,
  // while the first copies are in flight; the four threads of a row sum
  // every fourth float4 of it (every chunk's block computes delta over the
  // full rows, for its own ds; chunk 0 writes it)
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
  if (oc == 0 && t == 0) {
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
  float s[NT][4], dp[NT][4];  // the tile's q . k and do . v, summed over the chunks

  for (int it = 0; it < nsteps; ++it) {
    if (it + 1 < nsteps) load_step(it + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int k0 = it / nc * KT, cc = it % nc;
    const float* st = ring + (it % STAGES) * stage;
    const float* qw = (WIDE ? st : q_s) + warp * WARP_ROWS * LD;
    const float* dw = (WIDE ? st + rows * LD : do_s) + warp * WARP_ROWS * LD;
    const float* k_s = st + (WIDE ? 2 * rows * LD : 0);
    const float* v_s = k_s + KT * LD;
    // a warp whose rows are all dead, or all before the tile's first key,
    // keeps no pair of the tile
    if (r0 < T && (!CAUSAL || k0 <= r0 + WARP_ROWS - 1)) {
      float s2[NT][4], dp2[NT][4];
      zero(s2), zero(dp2);
      // live columns of this step's chunk, and of the block's (the last step's)
      const int cols = WIDE ? min(DH, Dh - step_chunk(cc, oc, nc) * DH) : DH;
#pragma unroll
      for (int c0 = 0; c0 < NK; c0 += SG) {
        if (WIDE && c0 * 8 >= cols) break;
        float sb[NT][4], db[NT][4];  // big products of SG k-steps, from zero
        zero(sb), zero(db);
#pragma unroll
        for (int kk = c0; kk < c0 + SG; ++kk) {
          if (WIDE && kk * 8 >= cols) break;
          Frag<4> qa, da;
          load_a<LD>(qa, qw, kk * 8, g, t);
          load_a<LD>(da, dw, kk * 8, g, t);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            Frag<2> b;
            load_bt<LD>(b, k_s, n * 8, kk * 8, g, t);
            mma3(sb[n], s2[n], qa, b);
            load_bt<LD>(b, v_s, n * 8, kk * 8, g, t);
            mma3(db[n], dp2[n], da, b);
          }
        }
        sum_into(s, sb, cc == 0 && c0 == 0), sum_into(dp, db, cc == 0 && c0 == 0);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] += s2[n][i], dp[n][i] += dp2[n][i];
      if (cc == nc - 1) {  // the scores are whole
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
          if (WIDE && g0 * 8 >= cols) break;
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
    }
    __syncthreads();  // the stage is refilled in the next iteration
  }

#pragma unroll
  for (int n = 0; n < NK; ++n) {
    const int c = oc * DH + n * 8 + 2 * t;
    if (c >= Dh) continue;
    if (ra < T)
      *(float2*)(dq + base + (size_t)ra * Dh + c) = make_float2(acc[n][0] * scale, acc[n][1] * scale);
    if (rb < T)
      *(float2*)(dq + base + (size_t)rb * Dh + c) = make_float2(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// ---- K7 -----------------------------------------------------------------

// Shared memory. Narrow (Dh <= DH): k and v of the block's rows, then the
// ring of query tiles (q, do: QT rows each; lse, delta: QT floats each, per
// stage). WIDE (DH = CHUNK < Dh): the ring alone, a stage holding one chunk
// of the tile's q and do rows, lse and delta, then that chunk of the
// block's k and v rows.
template <int DH, bool CAUSAL, bool WIDE>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    flash_attn_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int T, int Dh,
                          float scale) {
  constexpr int QT = query_tile(DH), LD = DH + PAD, NK = DH / 8, NT = QT / 8, NG = dkv_group(DH);
  constexpr int SG = WIDE ? SCORE_STEPS : NK;  // k-steps of s and dp summed from zero
  extern __shared__ __align__(16) float smem[];
  const int rows = (blockDim.x / 32) * WARP_ROWS;
  const int nc = WIDE ? chunks(Dh) : 1;
  const int bh = blockIdx.x / nc, oc = blockIdx.x % nc;
  const int stage = 2 * QT * LD + 2 * QT + (WIDE ? 2 * rows * LD : 0);  // floats per stage
  float* k_s = smem;
  float* v_s = k_s + rows * LD;
  float* ring = WIDE ? smem : v_s + rows * LD;

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
  const int nsteps = (T - qbegin + QT - 1) / QT * nc;

  auto load_step = [&](int s) {
    float* st = ring + (s % STAGES) * stage;
    const int i0 = qbegin + s / nc * QT, col = step_chunk(s % nc, oc, nc) * DH;
    load_rows<DH>(st, q + base, i0, QT, T, Dh, col);
    load_rows<DH>(st + QT * LD, dout + base, i0, QT, T, Dh, col);
    if (s % nc == nc - 1) {
      load_vec(st + 2 * QT * LD, lse_bh, i0, QT, T);
      load_vec(st + 2 * QT * LD + QT, delta_bh, i0, QT, T);
    }
    if (WIDE) {
      st += 2 * QT * LD + 2 * QT;
      load_rows<DH>(st, k + base, k0, rows, T, Dh, col);
      load_rows<DH>(st + rows * LD, v + base, k0, rows, T, Dh, col);
    }
  };
  if (!WIDE) {
    load_rows<DH>(k_s, k + base, k0, rows, T, Dh);
    load_rows<DH>(v_s, v + base, k0, rows, T, Dh);
  }
  load_step(0);
  cp_async_commit();
  const float sl = scale * LOG2E;  // p = exp2(s * scale * log2(e) - lse * log2(e))

  float dka[NK][4], dva[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;
  // s^T = k q^T and dp^T = v do^T (rows are keys, columns queries), summed
  // over the chunks
  float s[NT][4], dp[NT][4];

  for (int it = 0; it < nsteps; ++it) {
    if (it + 1 < nsteps) load_step(it + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int q0 = qbegin + it / nc * QT, cc = it % nc;
    const float* q_s = ring + (it % STAGES) * stage;
    const float* do_s = q_s + QT * LD;
    const float* lse_s = do_s + QT * LD;
    const float* dl_s = lse_s + QT;
    const float* kw = (WIDE ? dl_s + QT : k_s) + warp * WARP_ROWS * LD;
    const float* vw = (WIDE ? dl_s + QT + rows * LD : v_s) + warp * WARP_ROWS * LD;
    if (r0 < T && (!CAUSAL || q0 + QT - 1 >= r0)) {
      float s2[NT][4], dp2[NT][4];
      zero(s2), zero(dp2);
      // live columns of this step's chunk, and of the block's (the last step's)
      const int cols = WIDE ? min(DH, Dh - step_chunk(cc, oc, nc) * DH) : DH;
#pragma unroll 1
      for (int c0 = 0; c0 < NK; c0 += SG) {
        if (WIDE && c0 * 8 >= cols) break;
        float sb[NT][4], db[NT][4];  // big products of SG k-steps, from zero
        zero(sb), zero(db);
        // unrolled by 4: fully, ptxas holds too many loads in flight at Dh 128
#pragma unroll 4
        for (int kk = c0; kk < c0 + SG; ++kk) {
          if (WIDE && kk * 8 >= cols) break;
          Frag<4> ka, va;
          load_a<LD>(ka, kw, kk * 8, g, t);
          load_a<LD>(va, vw, kk * 8, g, t);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            Frag<2> b;
            load_bt<LD>(b, q_s, n * 8, kk * 8, g, t);
            mma3(sb[n], s2[n], ka, b);
            load_bt<LD>(b, do_s, n * 8, kk * 8, g, t);
            mma3(db[n], dp2[n], va, b);
          }
        }
        sum_into(s, sb, cc == 0 && c0 == 0), sum_into(dp, db, cc == 0 && c0 == 0);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] += s2[n][i], dp[n][i] += dp2[n][i];
      if (cc == nc - 1) {  // the scores are whole
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
          if (WIDE && g0 * 8 >= cols) break;
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
    }
    __syncthreads();  // the stage is refilled in the next iteration
  }

#pragma unroll
  for (int n = 0; n < NK; ++n) {
    const int c = oc * DH + n * 8 + 2 * t;
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
  if (Dh < 8 || Dh % 8 != 0) return ERR_HEAD_DIM;
  if (BH < 1 || T < 1 || (T + WARP_ROWS - 1) / WARP_ROWS > 65535 ||
      (long long)BH * chunks(Dh) > 0x7fffffff)
    return ERR_SHAPE;
  for (int i = 0; i < n; ++i)
    if ((uintptr_t)ptrs[i] % 16 != 0) return ERR_ALIGN;
  return (int)cudaSetDevice(device);
}

template <int DH, bool WIDE>
int launch_dq(const float* q, const float* k, const float* v, const float* o, const float* dout,
              const float* lse, float* dq, float* delta, int BH, int T, int Dh, bool causal,
              int device, cudaStream_t stream) {
  const int nc = WIDE ? chunks(Dh) : 1;
  const int nw = warps_per_block((long long)BH * nc, T, device), rows = nw * WARP_ROWS;
  const size_t smem = sizeof(float) * (2 * rows + STAGES * 2 * key_tile(DH) +
                                       (WIDE ? (STAGES - 1) * 2 * rows : 0)) * (DH + PAD);
  const dim3 grid(BH * nc, (T + rows - 1) / rows);
  const float scale = 1.f / sqrtf((float)Dh);
  return causal ? launch_kernel(flash_attn_dq_kernel<DH, true, WIDE>, grid, nw * 32, smem,
                                stream, q, k, v, o, dout, lse, dq, delta, T, Dh, scale)
                : launch_kernel(flash_attn_dq_kernel<DH, false, WIDE>, grid, nw * 32, smem,
                                stream, q, k, v, o, dout, lse, dq, delta, T, Dh, scale);
}

template <int DH, bool WIDE>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* delta, float* dk, float* dv, int BH, int T, int Dh,
               bool causal, int device, cudaStream_t stream) {
  constexpr int QT = query_tile(DH);
  const int nc = WIDE ? chunks(Dh) : 1;
  const int nw = warps_per_block((long long)BH * nc, T, device), rows = nw * WARP_ROWS;
  const size_t smem = sizeof(float) * ((2 * rows + STAGES * 2 * QT +
                                        (WIDE ? (STAGES - 1) * 2 * rows : 0)) * (DH + PAD) +
                                       STAGES * 2 * QT);
  const dim3 grid(BH * nc, (T + rows - 1) / rows);
  const float scale = 1.f / sqrtf((float)Dh);
  return causal ? launch_kernel(flash_attn_dkv_kernel<DH, true, WIDE>, grid, nw * 32, smem,
                                stream, q, k, v, dout, lse, delta, dk, dv, T, Dh, scale)
                : launch_kernel(flash_attn_dkv_kernel<DH, false, WIDE>, grid, nw * 32, smem,
                                stream, q, k, v, dout, lse, delta, dk, dv, T, Dh, scale);
}

}  // namespace

// K6. q, k, v, o, dout, dq: (BH, T, Dh) float32, contiguous, 16-byte
// aligned; lse, delta: (BH, T) float32 (delta is written). Dh any multiple
// of 8. Returns 0, a cudaError_t, or an Err.
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
#define DQ(DH_, WIDE_) \
  launch_dq<DH_, WIDE_>(qf, kf, vf, of, df, lf, dqf, dlf, BH, T, Dh, causal, device, s)
  if (Dh <= 16) return DQ(16, false);
  if (Dh <= 32) return DQ(32, false);
  if (Dh <= 64) return DQ(64, false);
  if (Dh <= CHUNK) return DQ(CHUNK, false);
  return DQ(CHUNK, true);
#undef DQ
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
#define DKV(DH_, WIDE_) \
  launch_dkv<DH_, WIDE_>(qf, kf, vf, df, lf, dlf, dkf, dvf, BH, T, Dh, causal, device, s)
  if (Dh <= 16) return DKV(16, false);
  if (Dh <= 32) return DKV(32, false);
  if (Dh <= 64) return DKV(64, false);
  if (Dh <= CHUNK) return DKV(CHUNK, false);
  return DKV(CHUNK, true);
#undef DKV
}

extern "C" const char* flash_attn_bwd_error(int code) {
  if (code == ERR_HEAD_DIM) return "head dim must be a positive multiple of 8";
  if (code == ERR_SHAPE) return "BH and T must be >= 1 (and T / 16 <= 65535)";
  if (code == ERR_ALIGN) return "q, k, v, o, do and the gradients must be 16-byte aligned";
  return cudaGetErrorString((cudaError_t)code);
}
