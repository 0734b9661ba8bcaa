// Flash decode step over a dense KV cache (K8, flash_decode) and over a
// paged block pool (K9, flash_decode_paged): one query row per (batch,
// head) against the cached keys and values at positions 0..pos[b],
// online softmax, float32 throughout.
//
// Replaces: deeplearning4j_tpu/ops/flash_decode.py::_decode_kernel (public
// entry flash_decode_step: q (B, H, Dh), cache (B, C, H, Dh), pos (B,)) and
// ::_paged_kernel (flash_decode_step_paged: pool (NB, bs, H, Dh), page
// tables (B, MB) int32 mapping logical block j of stream b to a pool
// block). Same function: softmax over c <= pos of (q . k_c) / sqrt(Dh),
// times v. Two artefacts of the TPU kernels are not carried over: the
// 8-row replication of q (a TPU tile floor) and the cast and transpose
// copies of the whole cache or pool the TPU wrappers make on every step,
// which read all C positions. These kernels read the cache and the pool in
// place, through their strides, and only the live rows 0..pos.
//
// What bounds it on the card: bytes. A (b, h) pair reads 2 (pos + 1) Dh
// float32 values of k and v once and does ~4 Dh FMAs per row: far below
// the card's operations-per-byte line. At serving batch sizes (B H of a
// few dozen to a few hundred blocks) the latency of the dependent loads in
// each thread's key loop, not HBM bandwidth, sets the time.
//
// Design: one block per (b, h), 256 threads in groups of G lanes per key
// row, each lane holding four elements of the row (one 16-byte load of k
// and of v, neighbouring lanes on neighbouring addresses). The 256 / G
// groups split the live prefix round-robin: group i takes keys i, i + NG,
// ...; a group's lanes sum their partial dot products with warp shuffles,
// so every lane of the group holds the score and runs the same online
// softmax over its own four output elements. Rounds run to the same count
// in every warp (a key past pos is a masked, unread slot), so the shuffles
// never meet an exited lane. At the end the groups' (max, denominator,
// accumulator) triples merge through shared memory. The paged kernel reads
// block_tables[b, j / bs] inside the loop and addresses
// pool[phys, j % bs, h, :]; nothing is gathered or copied.
//
// Head dims past 128: the column-chunk split. The grid runs over (b, h,
// chunk) triples, ceil(Dh / 128) chunks of 128 columns (the last one
// ragged, down to 8), with G = 32 lanes a key row. A group's lanes form
// each score over the full Dh by looping their 16-byte loads of q and k
// over the chunks, and accumulate only the block's chunk of v; no register
// array grows with Dh. Every block recomputes the scores: at Dh 256 that is
// 2x the q . k reads and work, the price of each output element written
// once, by one block.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 128;  // head-dim columns a block accumulates

enum Err { ERR_HEAD_DIM = -1, ERR_SHAPE = -2 };

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// G: lanes per key row (a power of two, 4 G >= Dh, or G = 32 and 4 G =
// CHUNK < Dh with WIDE).
template <int G, bool PAGED, bool WIDE>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                        const float* __restrict__ vc, const int* __restrict__ pos,
                        const int* __restrict__ tables, float* __restrict__ out, int H, int Dh,
                        int C, int bs, int MB, float scale) {
  constexpr int NG = THREADS / G;  // key groups per block
  constexpr int W = 4 * G;         // columns a block accumulates
  __shared__ float m_s[NG], l_s[NG];
  __shared__ __align__(16) float acc_s[NG][W];
  const int nc = WIDE ? (Dh + W - 1) / W : 1;
  const int bh = blockIdx.x / nc, oc = blockIdx.x % nc;
  const int b = bh / H, h = bh % H;
  const int gi = threadIdx.x / G, lane = threadIdx.x % G;
  const int e0 = 4 * lane, eo = oc * W + e0;  // the lane's columns: first chunk, output
  const bool has = eo < Dh;  // Dh is a multiple of 8, so eo + 4 <= Dh
  const float* qrow = q + (size_t)bh * Dh;
  float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!WIDE && has) {
    qv = load4(qrow + e0);
    qv.x *= scale; qv.y *= scale; qv.z *= scale; qv.w *= scale;
  }
  // a position past the capacity means every cached row is live
  const int p = min(max(pos[b], 0), C - 1);
  float m = -INFINITY, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 <= p; j0 += NG) {
    const int j = j0 + gi;
    const bool ok = j <= p;
    size_t row = 0;
    if (ok) {
      if (PAGED) {
        const int phys = tables[(size_t)b * MB + j / bs];
        row = ((size_t)phys * bs + j % bs) * H + h;
      } else {
        row = ((size_t)b * C + j) * H + h;
      }
    }
    float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok && has) vv = load4(vc + row * Dh + eo);
    float part = 0.f;
    if (WIDE) {
      if (ok)
        for (int e = e0; e < Dh; e += W) part += dot4(load4(qrow + e), load4(kc + row * Dh + e));
    } else if (ok && has) {
      part = dot4(qv, load4(kc + row * Dh + e0));
    }
#pragma unroll
    for (int w = 1; w < G; w <<= 1) part += __shfl_xor_sync(0xffffffffu, part, w);
    if (WIDE) part *= scale;
    if (ok) {
      const float mn = fmaxf(m, part);
      const float alpha = expf(m - mn), pe = expf(part - mn);
      l = l * alpha + pe;
      acc.x = fmaf(pe, vv.x, acc.x * alpha);
      acc.y = fmaf(pe, vv.y, acc.y * alpha);
      acc.z = fmaf(pe, vv.z, acc.z * alpha);
      acc.w = fmaf(pe, vv.w, acc.w * alpha);
      m = mn;
    }
  }
  if (lane == 0) {
    m_s[gi] = m;
    l_s[gi] = l;
  }
  *reinterpret_cast<float4*>(&acc_s[gi][e0]) = acc;
  __syncthreads();
  const int e = threadIdx.x;
  if (e < W && oc * W + e < Dh) {
    float M = -INFINITY;
    for (int i = 0; i < NG; ++i) M = fmaxf(M, m_s[i]);
    float L = 0.f, O = 0.f;
    for (int i = 0; i < NG; ++i) {
      if (l_s[i] > 0.f) {  // a group that saw no key adds nothing
        const float w = expf(m_s[i] - M);
        L = fmaf(l_s[i], w, L);
        O = fmaf(acc_s[i][e], w, O);
      }
    }
    out[(size_t)bh * Dh + oc * W + e] = O / L;
  }
}

template <bool PAGED>
int launch(const void* q, const void* kc, const void* vc, const void* pos, const void* tables,
           void* out, int B, int H, int Dh, int C, int bs, int MB, int device, void* stream) {
  if (Dh < 8 || Dh % 8 != 0) return ERR_HEAD_DIM;
  const long long nc = (Dh + CHUNK - 1) / CHUNK;
  if (B < 1 || H < 1 || C < 1 || (PAGED && (bs < 1 || MB < 1)) ||
      (long long)B * H * nc > 0x7fffffff)
    return ERR_SHAPE;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const float *qf = (const float*)q, *kf = (const float*)kc, *vf = (const float*)vc;
  const int *pf = (const int*)pos, *tf = (const int*)tables;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const float scale = 1.f / sqrtf((float)Dh);
  const int lanes = Dh / 4;
#define DECODE_LAUNCH(G_, WIDE_)                                                             \
  flash_decode_kernel<G_, PAGED, WIDE_><<<(unsigned)(B * H * (WIDE_ ? nc : 1)), THREADS, 0, \
                                          s>>>(qf, kf, vf, pf, tf, of, H, Dh, C, bs, MB, scale)
  if (lanes <= 2) DECODE_LAUNCH(2, false);
  else if (lanes <= 4) DECODE_LAUNCH(4, false);
  else if (lanes <= 8) DECODE_LAUNCH(8, false);
  else if (lanes <= 16) DECODE_LAUNCH(16, false);
  else if (lanes <= 32) DECODE_LAUNCH(32, false);
  else DECODE_LAUNCH(32, true);
#undef DECODE_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, H, Dh) float32; kc, vc: (B, C, H, Dh) float32; pos: (B,)
// int32. All contiguous; Dh any multiple of 8. Returns 0, a cudaError_t, or
// an Err.
extern "C" int flash_decode(const void* q, const void* kc, const void* vc, const void* pos,
                            void* out, int B, int H, int Dh, int C, int device, void* stream) {
  return launch<false>(q, kc, vc, pos, nullptr, out, B, H, Dh, C, 0, 0, device, stream);
}

// As flash_decode over a pool pk, pv (NB, bs, H, Dh) float32 steered by
// block_tables (B, MB) int32, whose entries must index the pool; the
// logical capacity is MB * bs.
extern "C" int flash_decode_paged(const void* q, const void* pk, const void* pv,
                                  const void* pos, const void* block_tables, void* out, int B,
                                  int H, int Dh, int bs, int MB, int device, void* stream) {
  return launch<true>(q, pk, pv, pos, block_tables, out, B, H, Dh, MB * bs, bs, MB, device,
                      stream);
}

extern "C" const char* flash_decode_error(int code) {
  if (code == ERR_HEAD_DIM) return "head dim must be a positive multiple of 8";
  if (code == ERR_SHAPE) return "B, H, the capacity and the block size must be >= 1";
  return cudaGetErrorString((cudaError_t)code);
}
