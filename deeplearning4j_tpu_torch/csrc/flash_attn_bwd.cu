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
// kernels; here K6 computes it from the o and do rows it holds anyway and
// writes it (BH, T) for K7, which launches after K6 on the same stream.
//
// What bounds them on the card: per (batch, head) K6 does 3 and K7 4
// products of T^2 Dh float32 FMAs (halved when causal) on 6 T Dh + 2 T
// input floats -- operations, not bytes, at the 67 TFLOP/s float32 FMA
// rate outside the tensor cores. At the training shape (T = 64) a block's
// work is two tiles, so the launch and the first tiles' load latency set
// the time.
//
// Design, as K5's: one block per (bh, 64-row tile), 256 threads, four
// threads per row, each holding every fourth element of its row's vectors
// in registers (a strided split: the four read neighbouring shared-memory
// words, and the eight rows of a warp read the same word, a broadcast).
// The two dot products per (query, key) pair are summed across the four
// with two warp shuffles each.
// - K6: a block owns 64 query rows and holds their q (pre-scaled), do, lse,
//   delta and the dq accumulator; key and value tiles of 32 rows stream
//   through shared memory up to the causal diagonal. dq is written once.
// - K7: a block owns 64 key rows and holds their k, v and the dk, dv
//   accumulators; tiles of 32 query rows (q pre-scaled, do, lse, delta)
//   stream through shared memory from the first query that can see the
//   block's first key (the causal lower bound) to the end. dk and dv are
//   written once.
// No atomics and no split across blocks, so the gradients are the same
// run to run; no scratch beyond delta. The ragged tail (T not a multiple
// of a tile) and dead rows are masked per element (p = 0), so any T is
// taken; Dh a multiple of 8 up to 128. Plain float32 FMAs; wgmma and TMA
// are for a later change.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 64;                 // rows a block owns
constexpr int GROUP = 4;                 // threads per row
constexpr int THREADS = ROWS * GROUP;    // 256
constexpr int TILE = 32;                 // rows per streamed shared-memory tile
constexpr int MAX_DH = 128;

enum Err { ERR_HEAD_DIM = -1, ERR_SHAPE = -2 };

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int w = 1; w < GROUP; w <<= 1) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

// DT: elements of a row each thread holds (thread g of a row holds elements
// g, g + GROUP, ...); GROUP * DT >= Dh, the padding is zero.
template <int DT, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
    flash_attn_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ o,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ dq, float* __restrict__ delta, int T, int Dh,
                         float scale) {
  constexpr int W = GROUP * DT;
  __shared__ __align__(16) float k_s[TILE][W];
  __shared__ __align__(16) float v_s[TILE][W];
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * ROWS;
  const int g = threadIdx.x % GROUP;
  const int row = q0 + threadIdx.x / GROUP;
  const bool live = row < T;
  const size_t base = (size_t)bh * T * Dh;

  float qr[DT], dor[DT], acc[DT];
  float dl = 0.f;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int e = d * GROUP + g;
    const bool ok = live && e < Dh;
    const size_t at = base + (size_t)row * Dh + e;
    qr[d] = ok ? q[at] * scale : 0.f;
    dor[d] = ok ? dout[at] : 0.f;
    dl = fmaf(dor[d], ok ? o[at] : 0.f, dl);
    acc[d] = 0.f;
  }
  dl = group_sum(dl);
  const float m = live ? lse[(size_t)bh * T + row] : 0.f;
  if (live && g == 0) delta[(size_t)bh * T + row] = dl;
  const int kend = CAUSAL ? min(T, q0 + ROWS) : T;

  for (int k0 = 0; k0 < kend; k0 += TILE) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < TILE * W; i += THREADS) {
      const int j = i / W, e = i % W, key = k0 + j;
      const bool ok = key < kend && e < Dh;
      k_s[j][e] = ok ? k[base + (size_t)key * Dh + e] : 0.f;
      v_s[j][e] = ok ? v[base + (size_t)key * Dh + e] : 0.f;
    }
    __syncthreads();
    const int nk = min(TILE, kend - k0);
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        s = fmaf(qr[d], k_s[j][d * GROUP + g], s);
        dp = fmaf(dor[d], v_s[j][d * GROUP + g], dp);
      }
      s = group_sum(s);
      dp = group_sum(dp);
      const bool ok = live && j < nk && (!CAUSAL || k0 + j <= row);
      const float ds = ok ? expf(s - m) * (dp - dl) : 0.f;
#pragma unroll
      for (int d = 0; d < DT; ++d) acc[d] = fmaf(ds, k_s[j][d * GROUP + g], acc[d]);
    }
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int e = d * GROUP + g;
    if (e < Dh) dq[base + (size_t)row * Dh + e] = acc[d] * scale;
  }
}

template <int DT, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
    flash_attn_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int T, int Dh,
                          float scale) {
  constexpr int W = GROUP * DT;
  __shared__ __align__(16) float q_s[TILE][W];  // q * scale
  __shared__ __align__(16) float do_s[TILE][W];
  __shared__ float lse_s[TILE], delta_s[TILE];
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * ROWS;
  const int g = threadIdx.x % GROUP;
  const int key = k0 + threadIdx.x / GROUP;
  const bool live = key < T;
  const size_t base = (size_t)bh * T * Dh;

  float kr[DT], vr[DT], dka[DT], dva[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int e = d * GROUP + g;
    const bool ok = live && e < Dh;
    kr[d] = ok ? k[base + (size_t)key * Dh + e] : 0.f;
    vr[d] = ok ? v[base + (size_t)key * Dh + e] : 0.f;
    dka[d] = dva[d] = 0.f;
  }
  // the first query that sees the block's first key; k0 is a multiple of
  // TILE, so the tiles stay aligned
  const int qbegin = CAUSAL ? k0 : 0;

  for (int q0 = qbegin; q0 < T; q0 += TILE) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < TILE * W; i += THREADS) {
      const int r = i / W, e = i % W, qi = q0 + r;
      const bool ok = qi < T && e < Dh;
      q_s[r][e] = ok ? q[base + (size_t)qi * Dh + e] * scale : 0.f;
      do_s[r][e] = ok ? dout[base + (size_t)qi * Dh + e] : 0.f;
    }
    if (threadIdx.x < TILE) {
      const int qi = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qi < T ? lse[(size_t)bh * T + qi] : 0.f;
      delta_s[threadIdx.x] = qi < T ? delta[(size_t)bh * T + qi] : 0.f;
    }
    __syncthreads();
    const int nq = min(TILE, T - q0);
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        s = fmaf(q_s[i][d * GROUP + g], kr[d], s);
        dp = fmaf(do_s[i][d * GROUP + g], vr[d], dp);
      }
      s = group_sum(s);
      dp = group_sum(dp);
      const bool ok = live && i < nq && (!CAUSAL || q0 + i >= key);
      const float p = ok ? expf(s - lse_s[i]) : 0.f;
      const float ds = p * (dp - delta_s[i]);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        dva[d] = fmaf(p, do_s[i][d * GROUP + g], dva[d]);
        dka[d] = fmaf(ds, q_s[i][d * GROUP + g], dka[d]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int e = d * GROUP + g;
    if (e < Dh) {
      dk[base + (size_t)key * Dh + e] = dka[d];
      dv[base + (size_t)key * Dh + e] = dva[d];
    }
  }
}

int check(int BH, int T, int Dh, int device) {
  if (Dh < 8 || Dh > MAX_DH || Dh % 8 != 0) return ERR_HEAD_DIM;
  if (BH < 1 || T < 1 || (T + ROWS - 1) / ROWS > 65535) return ERR_SHAPE;
  return (int)cudaSetDevice(device);
}

template <int DT>
int launch_dq(const float* q, const float* k, const float* v, const float* o,
              const float* dout, const float* lse, float* dq, float* delta, int BH, int T,
              int Dh, bool causal, cudaStream_t stream) {
  const dim3 grid(BH, (T + ROWS - 1) / ROWS);
  const float scale = 1.f / sqrtf((float)Dh);
  if (causal)
    flash_attn_dq_kernel<DT, true>
        <<<grid, THREADS, 0, stream>>>(q, k, v, o, dout, lse, dq, delta, T, Dh, scale);
  else
    flash_attn_dq_kernel<DT, false>
        <<<grid, THREADS, 0, stream>>>(q, k, v, o, dout, lse, dq, delta, T, Dh, scale);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* delta, float* dk, float* dv, int BH, int T,
               int Dh, bool causal, cudaStream_t stream) {
  const dim3 grid(BH, (T + ROWS - 1) / ROWS);
  const float scale = 1.f / sqrtf((float)Dh);
  if (causal)
    flash_attn_dkv_kernel<DT, true>
        <<<grid, THREADS, 0, stream>>>(q, k, v, dout, lse, delta, dk, dv, T, Dh, scale);
  else
    flash_attn_dkv_kernel<DT, false>
        <<<grid, THREADS, 0, stream>>>(q, k, v, dout, lse, delta, dk, dv, T, Dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// K6. q, k, v, o, dout, dq: (BH, T, Dh) float32, contiguous; lse, delta:
// (BH, T) float32 (delta is written). Dh a multiple of 8 up to 128.
// Returns 0, a cudaError_t, or an Err.
extern "C" int flash_attn_dq(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* dq, void* delta,
                             int BH, int T, int Dh, int causal, int device, void* stream) {
  const int rc = check(BH, T, Dh, device);
  if (rc != 0) return rc;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v,
              *of = (const float*)o, *df = (const float*)dout, *lf = (const float*)lse;
  float *dqf = (float*)dq, *dlf = (float*)delta;
  cudaStream_t s = (cudaStream_t)stream;
  const int per = (Dh + GROUP - 1) / GROUP;  // elements per thread, padded below
  if (per <= 2) return launch_dq<2>(qf, kf, vf, of, df, lf, dqf, dlf, BH, T, Dh, causal, s);
  if (per <= 4) return launch_dq<4>(qf, kf, vf, of, df, lf, dqf, dlf, BH, T, Dh, causal, s);
  if (per <= 8) return launch_dq<8>(qf, kf, vf, of, df, lf, dqf, dlf, BH, T, Dh, causal, s);
  if (per <= 16) return launch_dq<16>(qf, kf, vf, of, df, lf, dqf, dlf, BH, T, Dh, causal, s);
  return launch_dq<32>(qf, kf, vf, of, df, lf, dqf, dlf, BH, T, Dh, causal, s);
}

// K7. q, k, v, dout, dk, dv: (BH, T, Dh) float32, contiguous; lse, delta:
// (BH, T) float32 (delta as K6 wrote it). Returns as K6.
extern "C" int flash_attn_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dk, void* dv, int BH,
                              int T, int Dh, int causal, int device, void* stream) {
  const int rc = check(BH, T, Dh, device);
  if (rc != 0) return rc;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v,
              *df = (const float*)dout, *lf = (const float*)lse, *dlf = (const float*)delta;
  float *dkf = (float*)dk, *dvf = (float*)dv;
  cudaStream_t s = (cudaStream_t)stream;
  const int per = (Dh + GROUP - 1) / GROUP;
  if (per <= 2) return launch_dkv<2>(qf, kf, vf, df, lf, dlf, dkf, dvf, BH, T, Dh, causal, s);
  if (per <= 4) return launch_dkv<4>(qf, kf, vf, df, lf, dlf, dkf, dvf, BH, T, Dh, causal, s);
  if (per <= 8) return launch_dkv<8>(qf, kf, vf, df, lf, dlf, dkf, dvf, BH, T, Dh, causal, s);
  if (per <= 16)
    return launch_dkv<16>(qf, kf, vf, df, lf, dlf, dkf, dvf, BH, T, Dh, causal, s);
  return launch_dkv<32>(qf, kf, vf, df, lf, dlf, dkf, dvf, BH, T, Dh, causal, s);
}

extern "C" const char* flash_attn_bwd_error(int code) {
  if (code == ERR_HEAD_DIM) return "head dim must be a multiple of 8 in [8, 128]";
  if (code == ERR_SHAPE) return "BH and T must be >= 1 (and T / 64 <= 65535)";
  return cudaGetErrorString((cudaError_t)code);
}
