// Flash attention forward (K5): blocked online-softmax attention over
// (BH, T, Dh) float32 q, k, v, with an optional causal mask. Writes o
// (BH, T, Dh) and the log-sum-exp of each query row's scores, lse (BH, T),
// which the backward kernels (K6, K7 in flash_attn_bwd.cu) read to
// recompute the probabilities.
//
// Replaces: deeplearning4j_tpu/ops/flash_attention.py::_fwd_kernel, reached
// through _fa_fwd_call (public entry flash_attention, the forward of its
// custom VJP). Same function: s = (q . k) / sqrt(Dh), causal keys after the
// query masked, softmax over keys, o = p @ v, lse = max + log(sum).
//
// What bounds it on the card. Per (batch, head) it does two products of
// T^2 Dh multiply-adds (halved when causal) and moves 4 T Dh + T floats. At
// B = 64 x 4 heads, T = 512, Dh = 32 that is 8.6 GFLOP against 67.6 MB:
// bytes bound it on the tensor cores (0.020 ms at 3.35 TB/s, against 0.017
// ms of operations at the 495 TFLOP/s TF32 rate), and float32 FMAs outside
// them (0.128 ms at 67 TFLOP/s). Float32 accuracy costs three tf32
// products per product (below), 0.052 ms at that peak. At the serving
// shape (BH 64, T = 64) a block's work is small, and the launch and the
// first tile's load latency set the time.
//
// Design (the tensor-core machinery of K6 and K7, in flash_tc.cuh):
// - Tensor cores. s = q k^T and o += p v are mma.sync m16n8k8 on tf32
//   operands with float32 accumulators, each operand split big + small
//   (3xTF32), so the products keep float32 accuracy. q is split once per
//   block into its halves in shared memory; the streamed k and v are split
//   as their fragments are read.
// - Warp rows. A warp owns 16 query rows; a block of 1, 2 or 4 warps, as
//   many as keep the grid at a block per SM or more.
// - The online softmax in the accumulator fragment. A row's scores lie in
//   the four lanes of a quad: its max comes from two shuffles, p = exp2(s *
//   scale * log2(e) - m * scale * log2(e)) is formed in place, each lane
//   keeps its share of the denominator (summed over the quad once, at the
//   end), and o is rescaled in float32 registers when the max moves. p feeds
//   p v as the A operand through the accumulator-to-A column permutation
//   (0,2,4,6 | 1,3,5,7, with v's rows read in the same order): no staging.
// - Accumulation. The tensor cores do not round a sum to nearest, so a
//   small addend joining a large accumulator loses bits with a steady sign.
//   p v is summed per key tile from zero, its small products in an
//   accumulator of their own, and added to the running o with float32 adds.
//   The scores likewise: their small products apart, their big ones summed
//   from zero over SCORE_STEPS k-steps (32 columns) at a time and the sums
//   added in float32. Summed over all of a 256-wide head in one
//   accumulator, scores of magnitude ~900 were 5x float32's error off
//   (a numpy model of the truncation); in 32-column sums they are at
//   float32's. lse, which K6 and K7 recompute p from, is max * scale +
//   log(sum) with the max taken over the raw scores.
// - Copies. k and v tiles of 32 keys (16 at Dh 128) go through a two-stage
//   ring in shared memory filled by 16-byte cp.async.cg, so the next tile
//   loads while this one computes; rows are padded by 4 floats, so every
//   fragment read is free of bank conflicts.
// - The causal triangle and ragged edges. A block's key loop stops at its
//   last row; a warp skips tiles past its diagonal and masks per element
//   only on a tile that crosses it or the ragged tail. Key 0 is live for
//   every row, so each row's max is finite from the first tile on; rows
//   past T read zeros and are not written. Blocks run longest first. Any T.
// - Head dims past 128: the column-chunk split. The grid's x runs over
//   (bh, chunk) pairs, ceil(Dh / 128) chunks of 128 columns (the last one
//   ragged, down to 8). A block forms the scores over the full Dh by
//   streaming, per key tile, every chunk of its q rows and of the tile's k
//   through the ring (chunks ordered to end at its own), then accumulates
//   and writes only its own chunk of o; no register array grows with Dh.
//   Every block recomputes the scores: at Dh 256 that is 2x the q . k
//   work, the price of each output element written once, by one block.
//   Chunk 0 writes lse.
//
// Dh is any multiple of 8: instantiations for head dims 16, 32, 64 and 128
// (a smaller Dh zero-padded in shared memory) and the 128-column split.
// Registers per thread (non-causal / causal), from nvcc -Xptxas -v for
// sm_90a (CUDA 12.8), no spills in any; dynamic shared memory per block of
// 4 warps:
//   Dh 16:   70 /  70, 20,480 B     Dh 32:  114 / 112, 36,864 B
//   Dh 64:  128 / 128, 69,632 B     Dh 128: 125 / 123, 101,376 B
//   split:  128 / 126, 101,376 B
#include "flash_tc.cuh"

namespace {

// Keys per streamed tile, and the head-dim columns (in 8-wide fragments)
// of o summed per tile before they join the running o.
__host__ __device__ constexpr int key_tile(int dh) { return dh > 64 ? 16 : 32; }
__host__ __device__ constexpr int o_group(int dh) { return dh > 64 ? 2 : dh > 32 ? 4 : dh / 8; }

enum Err { ERR_HEAD_DIM = -1, ERR_SHAPE = -2, ERR_ALIGN = -3 };

// Shared memory. Narrow (Dh <= DH): q of the block's rows split into big
// and small halves, then the ring of key tiles (k then v, KT rows each).
// WIDE (DH = CHUNK < Dh): the ring alone, a stage holding one chunk of the
// block's q rows and of the tile's k, and on a tile's last step (its chunk
// oc) the tile's v.
template <int DH, bool CAUSAL, bool WIDE>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int T, int Dh, float scale) {
  constexpr int KT = key_tile(DH), LD = DH + PAD, NK = DH / 8, NT = KT / 8, NG = o_group(DH);
  constexpr int SG = NK < SCORE_STEPS ? NK : SCORE_STEPS;
  extern __shared__ __align__(16) float smem[];
  const int rows = (blockDim.x / 32) * WARP_ROWS;
  const int nc = WIDE ? chunks(Dh) : 1;
  const int bh = blockIdx.x / nc, oc = blockIdx.x % nc;
  const int stage = (WIDE ? rows + 2 * KT : 2 * KT) * LD;  // floats per ring stage
  uint32_t* qb_s = reinterpret_cast<uint32_t*>(smem);
  uint32_t* qs_s = qb_s + rows * LD;
  float* ring = WIDE ? smem : smem + 2 * rows * LD;

  const int tile = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // longest first
  const int q0 = tile * rows;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r0 = q0 + warp * WARP_ROWS;  // the warp's first row
  const int ra = r0 + g, rb = ra + 8;    // the thread's rows
  const size_t base = (size_t)bh * T * Dh;
  const int kend = CAUSAL ? min(T, q0 + rows) : T;
  const int nsteps = (kend + KT - 1) / KT * nc;
  const int ocols = min(DH, Dh - oc * DH);  // live columns of the block's chunk

  auto load_step = [&](int s) {
    float* st = ring + (s % STAGES) * stage;
    const int k0 = s / nc * KT, col = step_chunk(s % nc, oc, nc) * DH;
    if (WIDE) {
      load_rows<DH>(st, q + base, q0, rows, T, Dh, col);
      st += rows * LD;
    }
    load_rows<DH>(st, k + base, k0, KT, T, Dh, col);
    if (s % nc == nc - 1) load_rows<DH>(st + KT * LD, v + base, k0, KT, T, Dh, oc * DH);
  };
  load_step(0);
  cp_async_commit();
  if (!WIDE) {
    // q split once, while the first tile's copy is in flight
    constexpr int C4 = DH / 4;
    for (int i = threadIdx.x; i < rows * C4; i += blockDim.x) {
      const int r = i / C4, c = (i % C4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < T && c < Dh) x = *(const float4*)(q + base + (size_t)(q0 + r) * Dh + c);
      uint4 hi, lo;
      split(x.x, hi.x, lo.x), split(x.y, hi.y, lo.y);
      split(x.z, hi.z, lo.z), split(x.w, hi.w, lo.w);
      *(uint4*)(qb_s + r * LD + c) = hi;
      *(uint4*)(qs_s + r * LD + c) = lo;
    }
  }

  const float sl = scale * LOG2E;  // p = exp2(s * sl - max * sl)
  float acc[NK][4];                // the running o of the block's chunk
  zero(acc);
  float s[NT][4], s2[NT][4];       // the tile's scores (raw q . k)
  float ma = -INFINITY, mb = -INFINITY;  // running max of rows ra, rb
  float la = 0.f, lb = 0.f;        // this lane's share of their sums

  for (int it = 0; it < nsteps; ++it) {
    if (it + 1 < nsteps) load_step(it + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int k0 = it / nc * KT, cc = it % nc;
    const float* q_c = ring + (it % STAGES) * stage;  // WIDE only
    const float* k_s = q_c + (WIDE ? rows * LD : 0);
    const float* v_s = k_s + KT * LD;
    // a warp whose rows are all dead, or all before the tile's first key,
    // keeps no pair of the tile
    if (r0 < T && (!CAUSAL || k0 <= r0 + WARP_ROWS - 1)) {
      zero(s2);
      const int cols = WIDE ? min(DH, Dh - step_chunk(cc, oc, nc) * DH) : Dh;
#pragma unroll
      for (int c0 = 0; c0 < NK; c0 += SG) {
        if (c0 * 8 >= cols) break;
        float sb[NT][4];  // big products of SG k-steps, from zero
        zero(sb);
#pragma unroll
        for (int kk = c0; kk < c0 + SG; ++kk) {
          if (kk * 8 >= cols) break;
          Frag<4> qa;
          if (WIDE)
            load_a<LD>(qa, q_c + warp * WARP_ROWS * LD, kk * 8, g, t);
          else
            load_a_split<LD>(qa, qb_s + warp * WARP_ROWS * LD, qs_s + warp * WARP_ROWS * LD,
                             kk * 8, g, t);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            Frag<2> b;
            load_bt<LD>(b, k_s, n * 8, kk * 8, g, t);
            mma3(sb[n], s2[n], qa, b);
          }
        }
        sum_into(s, sb, cc == 0 && c0 == 0);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] += s2[n][i];

      if (cc == nc - 1) {  // the scores are whole: softmax and o += p v
        const bool edge = (CAUSAL && k0 + KT - 1 > r0) || k0 + KT > T;
        float na = ma, nb = mb;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + n * 8 + 2 * t + (i & 1);
            if (edge && (key >= T || (CAUSAL && key > (i < 2 ? ra : rb)))) s[n][i] = -INFINITY;
            if (i < 2) na = fmaxf(na, s[n][i]);
            else nb = fmaxf(nb, s[n][i]);
          }
#pragma unroll
        for (int w = 1; w < 4; w <<= 1) {
          na = fmaxf(na, __shfl_xor_sync(0xffffffffu, na, w));
          nb = fmaxf(nb, __shfl_xor_sync(0xffffffffu, nb, w));
        }
        // the old max scaled as the new one is, so an unmoved max gives
        // alpha = 1 exactly; the first tile's old max is -inf, alpha 0
        const float refa = na * sl, refb = nb * sl;
        const float alpha_a = exp2f(ma * sl - refa), alpha_b = exp2f(mb * sl - refb);
        ma = na, mb = nb;
        la *= alpha_a, lb *= alpha_b;
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          acc[n][0] *= alpha_a, acc[n][1] *= alpha_a;
          acc[n][2] *= alpha_b, acc[n][3] *= alpha_b;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = exp2f(fmaf(s[n][i], sl, -(i < 2 ? refa : refb)));
            s[n][i] = p;
            if (i < 2) la += p;
            else lb += p;
          }
        // o += p v, contracting over the tile's keys in a_from_acc's order;
        // the tile's sum is formed from zero, NG fragments at a time, then
        // added to the running o
#pragma unroll
        for (int g0 = 0; g0 < NK; g0 += NG) {
          if (g0 * 8 >= ocols) break;
          float pb[NG][4], ps[NG][4];
          zero(pb), zero(ps);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            Frag<4> a;
            a_from_acc(a, s[j]);
#pragma unroll
            for (int n = 0; n < NG; ++n) {
              Frag<2> b;
              load_bp<LD>(b, v_s, j * 8, (g0 + n) * 8, g, t);
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
  for (int w = 1; w < 4; w <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, w);
    lb += __shfl_xor_sync(0xffffffffu, lb, w);
  }
  const float ia = la > 0.f ? 1.f / la : 0.f, ib = lb > 0.f ? 1.f / lb : 0.f;
#pragma unroll
  for (int n = 0; n < NK; ++n) {
    const int c = n * 8 + 2 * t;
    if (c >= ocols) continue;
    float* out = o + base + oc * DH + c;
    if (ra < T) *(float2*)(out + (size_t)ra * Dh) = make_float2(acc[n][0] * ia, acc[n][1] * ia);
    if (rb < T) *(float2*)(out + (size_t)rb * Dh) = make_float2(acc[n][2] * ib, acc[n][3] * ib);
  }
  if (oc == 0 && t == 0) {
    if (ra < T) lse[(size_t)bh * T + ra] = fmaf(ma, scale, logf(la));
    if (rb < T) lse[(size_t)bh * T + rb] = fmaf(mb, scale, logf(lb));
  }
}

template <int DH, bool WIDE>
int launch(const float* q, const float* k, const float* v, float* o, float* lse, int BH, int T,
           int Dh, bool causal, int device, cudaStream_t stream) {
  const int nc = WIDE ? chunks(Dh) : 1;
  const int nw = warps_per_block((long long)BH * nc, T, device);
  const int rows = nw * WARP_ROWS;
  const size_t smem = sizeof(float) * (DH + PAD) *
                      (WIDE ? STAGES * (rows + 2 * key_tile(DH))
                            : 2 * rows + STAGES * 2 * key_tile(DH));
  const dim3 grid(BH * nc, (T + rows - 1) / rows);
  const float scale = 1.f / sqrtf((float)Dh);
  return causal ? launch_kernel(flash_attn_fwd_kernel<DH, true, WIDE>, grid, nw * 32, smem,
                                stream, q, k, v, o, lse, T, Dh, scale)
                : launch_kernel(flash_attn_fwd_kernel<DH, false, WIDE>, grid, nw * 32, smem,
                                stream, q, k, v, o, lse, T, Dh, scale);
}

}  // namespace

// q, k, v, o: (BH, T, Dh) float32, contiguous, 16-byte aligned; lse: (BH,
// T) float32. Dh any multiple of 8. Returns 0, a cudaError_t, or an Err.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int BH, int T, int Dh, int causal, int device, void* stream) {
  if (Dh < 8 || Dh % 8 != 0) return ERR_HEAD_DIM;
  if (BH < 1 || T < 1 || (T + WARP_ROWS - 1) / WARP_ROWS > 65535 ||
      (long long)BH * chunks(Dh) > 0x7fffffff)
    return ERR_SHAPE;
  const void* ptrs[] = {q, k, v, o};
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16 != 0) return ERR_ALIGN;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float *of = (float*)o, *lf = (float*)lse;
  cudaStream_t s = (cudaStream_t)stream;
  if (Dh <= 16) return launch<16, false>(qf, kf, vf, of, lf, BH, T, Dh, causal, device, s);
  if (Dh <= 32) return launch<32, false>(qf, kf, vf, of, lf, BH, T, Dh, causal, device, s);
  if (Dh <= 64) return launch<64, false>(qf, kf, vf, of, lf, BH, T, Dh, causal, device, s);
  if (Dh <= CHUNK) return launch<CHUNK, false>(qf, kf, vf, of, lf, BH, T, Dh, causal, device, s);
  return launch<CHUNK, true>(qf, kf, vf, of, lf, BH, T, Dh, causal, device, s);
}

extern "C" const char* flash_attn_error(int code) {
  if (code == ERR_HEAD_DIM) return "head dim must be a positive multiple of 8";
  if (code == ERR_SHAPE) return "BH and T must be >= 1 (and T / 16 <= 65535)";
  if (code == ERR_ALIGN) return "q, k, v and o must be 16-byte aligned";
  return cudaGetErrorString((cudaError_t)code);
}
