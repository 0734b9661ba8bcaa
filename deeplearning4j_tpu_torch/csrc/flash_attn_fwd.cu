// Flash attention forward (K5): blocked online-softmax attention over
// (BH, T, Dh) float32 q, k, v, with an optional causal mask. Writes o
// (BH, T, Dh) and the log-sum-exp of each query row's scores, lse (BH, T),
// the layout the backward kernels (dq, dkv) of the training slice read.
//
// Replaces: deeplearning4j_tpu/ops/flash_attention.py::_fwd_kernel, reached
// through _fa_fwd_call (public entry flash_attention, the forward of its
// custom VJP). Same function: s = (q . k) / sqrt(Dh), causal keys after the
// query masked, softmax over keys, o = p @ v, lse = max + log(sum).
//
// What bounds it on the card: at the serving shapes (T <= 512, Dh = 32)
// the work is ~4 T^2 Dh float32 FMAs per (batch, head) -- operations, not
// bytes: q, k, v and o are 16 T Dh bytes. In float32 outside the tensor
// cores that is the 67 TFLOP/s FMA rate. At T = 64 a block's work is small
// and the launch plus the first tile's load latency set the time.
//
// Design: one block per (bh, 64-row query tile), 256 threads: four threads
// per query row, each holding every fourth element of the row's q and of
// its running output in registers (a strided split, so the four read
// neighbouring shared-memory words and never share a bank). Key and value
// tiles of 32 rows stream through shared memory; the four partial dot
// products of a score are summed with two warp shuffles. The running max,
// denominator and output accumulator stay in float32 registers, rescaled
// once per tile; o and lse are written once at the end. Causal: the key
// loop stops at the tile that holds the block's last query row, and keys
// past a row are masked per element inside that tile. The ragged tail
// (T not a multiple of the tile) is masked in the kernel: any T is taken.
// Plain float32 FMAs; wgmma and TMA are for a later change.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 64;                 // query rows per block
constexpr int GROUP = 4;                 // threads per query row
constexpr int THREADS = ROWS * GROUP;    // 256
constexpr int KT = 32;                   // keys per shared-memory tile
constexpr int MAX_DH = 128;

enum Err { ERR_HEAD_DIM = -1, ERR_SHAPE = -2 };

// DT: elements of a row each thread holds (thread g of a row holds
// elements g, g + GROUP, ...); GROUP * DT >= Dh, the padding is zero.
template <int DT, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
    flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int T, int Dh, float scale) {
  constexpr int W = GROUP * DT;  // padded row width in shared memory
  __shared__ __align__(16) float k_s[KT][W];
  __shared__ __align__(16) float v_s[KT][W];
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * ROWS;
  const int g = threadIdx.x % GROUP;
  const int row = q0 + threadIdx.x / GROUP;
  const bool live = row < T;
  const size_t base = (size_t)bh * T * Dh;

  float qr[DT], acc[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int e = d * GROUP + g;
    qr[d] = (live && e < Dh) ? q[base + (size_t)row * Dh + e] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int kend = CAUSAL ? min(T, q0 + ROWS) : T;

  for (int k0 = 0; k0 < kend; k0 += KT) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < KT * W; i += THREADS) {
      const int j = i / W, e = i % W, key = k0 + j;
      const bool ok = key < kend && e < Dh;
      k_s[j][e] = ok ? k[base + (size_t)key * Dh + e] : 0.f;
      v_s[j][e] = ok ? v[base + (size_t)key * Dh + e] : 0.f;
    }
    __syncthreads();
    const int nk = min(KT, kend - k0);
    float s[KT];
    float mt = m;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float part = 0.f;
#pragma unroll
      for (int d = 0; d < DT; ++d) part = fmaf(qr[d], k_s[j][d * GROUP + g], part);
#pragma unroll
      for (int w = 1; w < GROUP; w <<= 1) part += __shfl_xor_sync(0xffffffffu, part, w);
      const bool ok = j < nk && (!CAUSAL || k0 + j <= row);
      s[j] = ok ? part : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    // a row with no live key yet keeps m = -inf; exp(-inf - 0) = 0 then
    const float mref = mt == -INFINITY ? 0.f : mt;
    const float alpha = expf(m - mref);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float p = expf(s[j] - mref);
      l += p;
#pragma unroll
      for (int d = 0; d < DT; ++d) acc[d] = fmaf(p, v_s[j][d * GROUP + g], acc[d]);
    }
    m = mt;
  }
  if (!live) return;
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int e = d * GROUP + g;
    if (e < Dh) o[base + (size_t)row * Dh + e] = acc[d] * inv;
  }
  if (g == 0) lse[(size_t)bh * T + row] = m + logf(l);
}

template <int DT>
int launch(const float* q, const float* k, const float* v, float* o, float* lse, int BH,
           int T, int Dh, bool causal, cudaStream_t stream) {
  const dim3 grid(BH, (T + ROWS - 1) / ROWS);
  const float scale = 1.f / sqrtf((float)Dh);
  if (causal)
    flash_attn_fwd_kernel<DT, true><<<grid, THREADS, 0, stream>>>(q, k, v, o, lse, T, Dh, scale);
  else
    flash_attn_fwd_kernel<DT, false><<<grid, THREADS, 0, stream>>>(q, k, v, o, lse, T, Dh,
                                                                   scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (BH, T, Dh) float32, contiguous; lse: (BH, T) float32.
// Dh a multiple of 8 up to 128. Returns 0, a cudaError_t, or an Err.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int BH, int T, int Dh, int causal, int device, void* stream) {
  if (Dh < 8 || Dh > MAX_DH || Dh % 8 != 0) return ERR_HEAD_DIM;
  if (BH < 1 || T < 1 || (T + ROWS - 1) / ROWS > 65535) return ERR_SHAPE;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float *of = (float*)o, *lf = (float*)lse;
  cudaStream_t s = (cudaStream_t)stream;
  const int per = (Dh + GROUP - 1) / GROUP;  // elements per thread, padded below
  if (per <= 2) return launch<2>(qf, kf, vf, of, lf, BH, T, Dh, causal, s);
  if (per <= 4) return launch<4>(qf, kf, vf, of, lf, BH, T, Dh, causal, s);
  if (per <= 8) return launch<8>(qf, kf, vf, of, lf, BH, T, Dh, causal, s);
  if (per <= 16) return launch<16>(qf, kf, vf, of, lf, BH, T, Dh, causal, s);
  return launch<32>(qf, kf, vf, of, lf, BH, T, Dh, causal, s);
}

extern "C" const char* flash_attn_error(int code) {
  if (code == ERR_HEAD_DIM) return "head dim must be a multiple of 8 in [8, 128]";
  if (code == ERR_SHAPE) return "BH and T must be >= 1 (and T / 64 <= 65535)";
  return cudaGetErrorString((cudaError_t)code);
}
