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
// times v, with pos clamped to 0..C-1. Two artefacts of the TPU kernels are
// not carried over: the 8-row replication of q (a TPU tile floor) and the
// cast and transpose copies of the whole cache or pool the TPU wrappers
// make on every step, which read all C positions (the JAX wrappers also
// widen a bfloat16 cache to float32 there, a copy of the whole pool a
// step on a paged engine). These kernels read the cache and the pool in
// place, in their own type, through their strides, and only the live rows
// 0..pos.
//
// What bounds it on the card: bytes, in principle. A (b, h) pair reads
// 2 (pos + 1) Dh values of k and v once (4 bytes each, or 2 in bfloat16)
// and does ~4 Dh FMAs per row, far below the card's operations-per-byte
// line. At serving batch
// sizes, though, the work is a few dozen (b, h) pairs of a few hundred rows
// each: what sets the time is how many SMs take part, how many dependent
// load rounds each walks, and the launch itself.
//
// Design: a thread-block cluster of S blocks per (b, h[, chunk]), S in
// {1, 2, 4, 8, 16}, and the threads of a block (128, or 256 where the
// grid has a block for every SM unsplit or a key row takes a warp),
// chosen by shape alone in the entry point (B H chunks, the capacity C
// and the SM count; never from pos, which lives on the card: reading it
// would synchronise and break the capture of a decode step in a CUDA
// graph). S is the largest split that keeps the grid within one block
// per SM and gives each block a full round of keys at capacity: on an
// H100 every doubling of S cost 0.2-0.5 us even where the keys left the
// extra blocks idle, and a longer prefix gains more from S than a short
// one loses. On the card, the live keys 0..p go to as
// many of the S blocks as get a full round each (one block at a short
// prefix, all S at a long one), in contiguous equal ranges -- for K9 in
// whole pages, so no page is split between blocks; the other blocks get
// empty ranges and add nothing.
//
// Inside a block, groups of G lanes per key row, each lane holding E
// elements of the row: one 16-byte load of k and of v, neighbouring lanes
// on neighbouring addresses (E = 4 in float32; E = 8 in bfloat16, widened
// in registers, exactly, as __bfloat1622float2 does). So a bfloat16 row
// takes half the lanes of a float32 one, a block twice the key rows a
// round, and the plan (which counts keys a round) follows the type. A round gives each group UNROLL keys of the
// block's range, and a lane issues the loads of all of them before it uses
// any; the group's lanes sum their partial dot products with warp
// shuffles, the UNROLL sums interleaved, and run one online-softmax update
// over its own four output columns (UNROLL + 1 exps, the hardware's fast
// exp). K9 stages the page-table entries of the block's range in shared
// memory before the key loop (one load per thread, in parallel, TABLE
// entries at a time), so no key load waits on a table load of its own
// round.
//
// Merges, each in a fixed order, so a launch repeats bit for bit (no
// atomics, no second kernel, no scratch in global memory): the groups of a
// warp by an xor butterfly of their (max, denominator, accumulator)
// triples; the block's warps in warp order, in every thread; then, once
// every block of the cluster is known to have started (a barrier whose
// wait comes after the key loop), each block stores its triple's columns
// into the shared memory of the block that owns them (DSMEM; a block owns
// ceil(columns / S) of the chunk's columns), and one cluster barrier makes
// them visible; each block merges its columns from the S triples in rank
// order 0..S-1 and writes them. No block touches another's shared memory
// after that barrier, so none waits for its peers before it exits.
//
// Head dims past 32 E (128 in float32, 256 in bfloat16): the column-chunk
// split. A cluster per (b, h, chunk) triple, ceil(Dh / 32 E) chunks of
// 32 E columns (the last one ragged, down to 8), with G = 32 lanes a key
// row. A group's lanes form each score over
// the full Dh by looping their 16-byte loads of q and k over the chunks,
// and accumulate only the chunk's columns of v; no register array grows
// with Dh. Every chunk recomputes the scores: at Dh 256 in float32 that is
// 2x the q . k reads and work, the price of each output element written
// once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"

using namespace dsmem;

namespace {

constexpr int UNROLL = 4;       // key rows a group loads before it uses any
constexpr int MAX_SPLIT = 16;   // blocks a cluster splits the live keys over
constexpr int MAX_THREADS = 256;
// S grows while the grid stays within this many blocks per SM
constexpr int BLOCKS_PER_SM = 1;

enum Err { ERR_HEAD_DIM = -1, ERR_SHAPE = -2, ERR_NO_PLAN = -3 };

// plan_out of the entry points (PLAN_LEN ints, may be null): blocks per
// cluster S, clusters (B H chunks), threads per block, and the keys a
// block takes at least before the live keys spread to one more block.
enum { PLAN_LEN = 4 };

// elements of a cache row a lane holds: one 16-byte load
template <typename T>
__host__ __device__ constexpr int lane_elems() {
  return 16 / (int)sizeof(T);
}

template <typename T>
struct Args {
  const float* q;
  const T *k, *v;
  const int *pos, *tables;
  float* out;
  int H, Dh, C, bs, MB;
  float scale;
};

// x[0..E) = the E float32 values at p (16-byte aligned)
template <int E>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[E]) {
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    x[i] = a.x;
    x[i + 1] = a.y;
    x[i + 2] = a.z;
    x[i + 3] = a.w;
  }
}

// a lane's E elements of a cache row, widened to float32
__device__ __forceinline__ void load_row(const float* p, float (&x)[4]) { load_f32<4>(p, x); }

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // the lower address is the low half: __bfloat1622float2's widening
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <int E>
__device__ __forceinline__ void zero(float (&x)[E]) {
#pragma unroll
  for (int i = 0; i < E; ++i) x[i] = 0.f;
}

template <int E>
__device__ __forceinline__ float dot(const float (&a)[E], const float (&b)[E]) {
  float s = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < E; ++i) s += a[i] * b[i];
  return s;
}

// Fold the softmax triple (m2, l2, a2) into (m, l, a); a side that saw no
// key (l == 0, m = -inf) has weight 0.
template <int E>
__device__ __forceinline__ void combine(float& m, float& l, float (&a)[E], float m2, float l2,
                                        const float (&a2)[E]) {
  const float M = fmaxf(m, m2);
  const float w1 = l > 0.f ? __expf(m - M) : 0.f;
  const float w2 = l2 > 0.f ? __expf(m2 - M) : 0.f;
  l = l * w1 + l2 * w2;
#pragma unroll
  for (int i = 0; i < E; ++i) a[i] = a[i] * w1 + a2[i] * w2;
  m = M;
}

// The keys [lo, hi) of block `rank` over the live keys 0..p: contiguous
// equal ranges, in whole pages of bs keys for the paged kernel, over as
// many of the S blocks as give each at least kmin keys (one round of the
// block's groups); the blocks past those get empty ranges.
template <bool PAGED>
__device__ __forceinline__ void block_range(int p, int rank, int S, int bs, int kmin, int& lo,
                                            int& hi) {
  const int n = p + 1;
  const int unit = PAGED ? bs : 1;
  const int units = (n + unit - 1) / unit;
  const int umin = (kmin + unit - 1) / unit;
  const int used = min(S, (units + umin - 1) / umin);
  const int per = (units + used - 1) / used * unit;
  lo = min(n, rank * per);
  hi = min(n, lo + per);
}

// T: the cache's element type, E = lane_elems<T>() elements a lane. G:
// lanes per key row (a power of two, E G >= Dh, or G = 32 and E G < Dh
// with WIDE, a chunk of 32 E columns); TPB threads a block. Grid: S x (B H
// chunks) blocks along x, clusters of S.
template <typename T, int G, bool PAGED, bool WIDE, int TPB>
__global__ void __launch_bounds__(TPB) flash_decode_kernel(Args<T> a, int S) {
  constexpr int E = lane_elems<T>();
  constexpr int NG = TPB / G;  // key groups per block
  constexpr int W = E * G;     // columns a block accumulates
  constexpr int WARPS = TPB / 32;
  constexpr int TABLE = 4 * TPB;  // page-table entries a block stages at a time
  __shared__ float wm[WARPS], wl[WARPS];
  __shared__ __align__(16) float wacc[WARPS][W];
  // what the S blocks send this one: their (max, denominator) and their
  // accumulators over the columns this block owns, by sender rank
  __shared__ float rm[MAX_SPLIT], rl[MAX_SPLIT];
  __shared__ float ro[MAX_SPLIT][W];
  __shared__ int tbl[PAGED ? TABLE : 1];
  const int H = a.H, Dh = a.Dh, C = a.C, bs = a.bs;
  const int nc = WIDE ? (Dh + W - 1) / W : 1;
  const int rank = (int)cluster_rank();
  const int cid = blockIdx.x / S;
  const int bh = cid / nc, oc = cid % nc;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int gi = tid / G, lane = tid % G;
  const int e0 = E * lane, eo = oc * W + e0;  // the lane's columns: first chunk, output
  const bool has = eo < Dh;  // Dh is a multiple of 8, so eo + E <= Dh
  const float* qrow = a.q + (size_t)bh * Dh;
  float qv[E];
  zero(qv);
  if (!WIDE && has) {
    load_f32<E>(qrow + e0, qv);
#pragma unroll
    for (int i = 0; i < E; ++i) qv[i] *= a.scale;
  }
  // a position past the capacity means every cached row is live
  const int p = min(max(a.pos[b], 0), C - 1);
  int lo, hi;
  block_range<PAGED>(p, rank, S, bs, NG * UNROLL, lo, hi);
  // a block stores into its peers only once they have all started: the
  // wait for this arrive comes after the key loop
  const bool one = S == 1;
  if (!one) cluster_arrive_relaxed();

  float m = -INFINITY, l = 0.f;
  float acc[E];
  zero(acc);
  // one window for the dense kernel; TABLE pages at a time for the paged
  for (int w0 = lo; w0 < hi; w0 += PAGED ? TABLE * bs : hi - lo) {
    const int w1 = PAGED ? min(hi, w0 + TABLE * bs) : hi;
    const int first = PAGED ? w0 / bs : 0;  // w0 is a page boundary
    if (PAGED) {
      if (w0 != lo) __syncthreads();  // the last window's entries are read
      const int np = (w1 - 1) / bs - first + 1;
      for (int i = tid; i < np; i += TPB) tbl[i] = a.tables[(size_t)b * a.MB + first + i];
      __syncthreads();
    }
    // every warp runs the same rounds (a key past w1 is a masked, unread
    // slot), so the shuffles never meet an exited lane
    for (int j0 = w0; j0 < w1; j0 += NG * UNROLL) {
      bool ok[UNROLL];
      size_t row[UNROLL];
      float vv[UNROLL][E];
      float s[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * NG + gi;
        ok[u] = j < w1;
        row[u] = 0;
        if (ok[u]) {
          if (PAGED) row[u] = ((size_t)tbl[j / bs - first] * bs + j % bs) * H + h;
          else row[u] = ((size_t)b * C + j) * H + h;
        }
        if (ok[u] && has) load_row(a.v + row[u] * Dh + eo, vv[u]);
        else zero(vv[u]);
        s[u] = 0.f;
      }
      if (WIDE) {
        for (int e = e0; e < Dh; e += W) {
          float qe[E];
          load_f32<E>(qrow + e, qe);
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            if (ok[u]) {
              float ke[E];
              load_row(a.k + row[u] * Dh + e, ke);
              s[u] += dot(qe, ke);
            }
        }
      } else {
        float kv[UNROLL][E];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (ok[u] && has) load_row(a.k + row[u] * Dh + e0, kv[u]);
          else zero(kv[u]);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) s[u] = dot(qv, kv[u]);
      }
#pragma unroll
      for (int w = 1; w < G; w <<= 1)
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], w);
      if (ok[0]) {  // ok[u] implies ok[u - 1]
        float mn = m;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (WIDE) s[u] *= a.scale;
          if (ok[u]) mn = fmaxf(mn, s[u]);
        }
        const float alpha = __expf(m - mn);  // 0 before the first key
        l *= alpha;
#pragma unroll
        for (int i = 0; i < E; ++i) acc[i] *= alpha;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (ok[u]) {
            const float pe = __expf(s[u] - mn);
            l += pe;
#pragma unroll
            for (int i = 0; i < E; ++i) acc[i] = fmaf(pe, vv[u][i], acc[i]);
          }
        m = mn;
      }
    }
  }

  // the groups of a warp: an xor butterfly, after which lanes 0..G-1 hold
  // the warp's triple for their columns
#pragma unroll
  for (int d = G; d < 32; d <<= 1) {
    float a2[E];
#pragma unroll
    for (int i = 0; i < E; ++i) a2[i] = __shfl_xor_sync(0xffffffffu, acc[i], d);
    combine(m, l, acc, __shfl_xor_sync(0xffffffffu, m, d), __shfl_xor_sync(0xffffffffu, l, d),
            a2);
  }
  const int warp = tid / 32;
  if (tid % 32 < G) {
#pragma unroll
    for (int i = 0; i < E; i += 4)
      *reinterpret_cast<float4*>(&wacc[warp][e0 + i]) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    if (lane == 0) {
      wm[warp] = m;
      wl[warp] = l;
    }
  }
  __syncthreads();
  // the block's warps in warp order: its (max, denominator) in every
  // thread, its accumulator one column a thread
  float M = -INFINITY, L = 0.f, x[WARPS];
#pragma unroll
  for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wm[w]);
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    x[w] = wl[w] > 0.f ? __expf(wm[w] - M) : 0.f;  // a warp that saw no key adds nothing
    L = fmaf(wl[w], x[w], L);
  }
  // send each block its share of the chunk's columns and this block's
  // (max, denominator): one cluster barrier then makes them visible
  const int wc = WIDE ? min(W, Dh - oc * W) : Dh;  // the chunk's columns
  const int per = (wc + S - 1) / S;                // columns a block owns
  if (!one) cluster_wait();
  if (tid < S) {
    if (one) {
      rm[0] = M;
      rl[0] = L;
    } else {
      peer_store(peer_addr((unsigned)__cvta_generic_to_shared(&rm[rank]), tid), M);
      peer_store(peer_addr((unsigned)__cvta_generic_to_shared(&rl[rank]), tid), L);
    }
  }
  for (int c = tid; c < wc; c += TPB) {
    float O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) O = fmaf(wacc[w][c], x[w], O);
    const int k = c / per;
    if (one) ro[0][c] = O;
    else peer_store(peer_addr((unsigned)__cvta_generic_to_shared(&ro[rank][c - k * per]), k), O);
  }
  if (one) __syncthreads();
  else cluster_sync();
  // this block's columns from the S blocks' triples, in rank order
  const int c0 = rank * per, cn = min(wc, c0 + per) - c0;
  for (int t = tid; t < cn; t += TPB) {
    float Mk = -INFINITY;
    for (int k = 0; k < S; ++k) Mk = fmaxf(Mk, rm[k]);
    float Lk = 0.f, Ok = 0.f;
    for (int k = 0; k < S; ++k)
      if (rl[k] > 0.f) {  // a block whose range is empty adds nothing
        const float y = __expf(rm[k] - Mk);
        Lk = fmaf(rl[k], y, Lk);
        Ok = fmaf(ro[k][t], y, Ok);
      }
    a.out[(size_t)bh * Dh + oc * W + c0 + t] = Ok / Lk;
  }
}

// An empty kernel: launched with a decode kernel's plan, it times the
// launch of that grid and cluster shape alone.
__global__ void empty_kernel(int) {}

struct Plan {
  int S, threads;
};

// Threads a block: 256 where the grid already has a block for every SM
// without splitting, or where a key row takes a whole warp (G = 32: 128
// threads would leave a block 4 groups), else 128.
inline int plan_threads(int n, int sms, int G) {
  return n >= sms || G == 32 ? MAX_THREADS : MAX_THREADS / 2;
}

// Blocks per cluster for n clusters over a capacity of C keys: the largest
// power of two up to MAX_SPLIT that keeps the grid within BLOCKS_PER_SM
// blocks per SM and gives each block at least one round of keys (kmin) at
// full capacity, and whose clusters the device can schedule. By shape
// alone: how many of the S blocks take keys follows pos on the card.
template <typename Kernel>
int split_for(Kernel kernel, int n, int C, int sms, int threads, int kmin, int* S) {
  int want = 1;
  while (want < MAX_SPLIT && (long long)n * want * 2 <= (long long)BLOCKS_PER_SM * sms &&
         want * 2 * kmin <= C)
    want *= 2;
  for (*S = want; *S >= 1; *S /= 2)
    if (max_active_clusters(kernel, *S, threads, 0) > 0) return 0;
  return ERR_NO_PLAN;
}

template <typename T, int G, bool PAGED, bool WIDE>
int search_plan(int dev, int n, int C, Plan* out, bool* ok) {
  int sms;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int threads = plan_threads(n, sms, G);
  int S;
  const int rc = threads == MAX_THREADS
                     ? split_for(flash_decode_kernel<T, G, PAGED, WIDE, MAX_THREADS>, n, C, sms,
                                 threads, MAX_THREADS / G * UNROLL, &S)
                     : split_for(flash_decode_kernel<T, G, PAGED, WIDE, MAX_THREADS / 2>, n, C,
                                 sms, threads, MAX_THREADS / 2 / G * UNROLL, &S);
  *ok = rc == 0;
  if (*ok) *out = Plan{S, threads};
  return 0;
}

// Launch one instance on its plan (searched once per device, type, n and
// C, and kept); the empty kernel instead where `empty`.
template <typename T, int G, bool PAGED, bool WIDE>
int run(const Args<T>& a, int n, bool empty, int* plan_out, cudaStream_t s) {
  Plan p;
  bool ok;
  const int e = cached_plan<search_plan<T, G, PAGED, WIDE>>(n, a.C, &p, &ok);
  if (e) return e;
  if (!ok) return ERR_NO_PLAN;
  if ((long long)p.S * n > 0x7fffffff) return ERR_SHAPE;
  if (plan_out) {
    const int v[PLAN_LEN] = {p.S, n, p.threads, p.threads / G * UNROLL};
    for (int k = 0; k < PLAN_LEN; ++k) plan_out[k] = v[k];
  }
  const dim3 grid((unsigned)(p.S * n));
  if (empty) {
    const cudaError_t ce = cluster_attributes(empty_kernel, p.S, 0);
    if (ce != cudaSuccess) return (int)ce;
    return launch_cluster_grid(empty_kernel, p.S, grid, p.threads, 0, s, 0);
  }
  if (p.threads == MAX_THREADS)
    return launch_cluster_grid(flash_decode_kernel<T, G, PAGED, WIDE, MAX_THREADS>, p.S, grid,
                               p.threads, 0, s, a, p.S);
  return launch_cluster_grid(flash_decode_kernel<T, G, PAGED, WIDE, MAX_THREADS / 2>, p.S, grid,
                             p.threads, 0, s, a, p.S);
}

template <typename T, bool PAGED>
int launch(Args<T> a, int B, int device, bool empty, int* plan_out, void* stream) {
  constexpr int E = lane_elems<T>();
  constexpr int CHUNK = 32 * E;  // head-dim columns a block accumulates, past which WIDE
  const int Dh = a.Dh;
  if (Dh < 8 || Dh % 8 != 0) return ERR_HEAD_DIM;
  const long long nc = (Dh + CHUNK - 1) / CHUNK;
  if (B < 1 || a.H < 1 || a.C < 1 || (PAGED && (a.bs < 1 || a.MB < 1)) ||
      (long long)B * a.H * nc > 0x7fffffff)
    return ERR_SHAPE;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  a.scale = 1.f / sqrtf((float)Dh);
  const int lanes = Dh / E, bh = B * a.H;
  if (lanes <= 2) return run<T, 2, PAGED, false>(a, bh, empty, plan_out, s);
  if (lanes <= 4) return run<T, 4, PAGED, false>(a, bh, empty, plan_out, s);
  if (lanes <= 8) return run<T, 8, PAGED, false>(a, bh, empty, plan_out, s);
  if (lanes <= 16) return run<T, 16, PAGED, false>(a, bh, empty, plan_out, s);
  if (lanes <= 32) return run<T, 32, PAGED, false>(a, bh, empty, plan_out, s);
  return run<T, 32, PAGED, true>(a, (int)(bh * nc), empty, plan_out, s);
}

template <typename T>
int run_dense(const void* q, const void* kc, const void* vc, const void* pos, void* out, int B, int H,
          int Dh, int C, int device, void* stream, int* plan_out) {
  const Args<T> a{(const float*)q, (const T*)kc, (const T*)vc, (const int*)pos, nullptr,
                  (float*)out, H, Dh, C, 1, 0, 0.f};
  return launch<T, false>(a, B, device, false, plan_out, stream);
}

template <typename T>
int run_paged(const void* q, const void* pk, const void* pv, const void* pos,
          const void* block_tables, void* out, int B, int H, int Dh, int bs, int MB, int device,
          void* stream, int* plan_out) {
  const Args<T> a{(const float*)q, (const T*)pk, (const T*)pv, (const int*)pos,
                  (const int*)block_tables, (float*)out, H, Dh, MB * bs, bs, MB, 0.f};
  return launch<T, true>(a, B, device, false, plan_out, stream);
}

template <typename T>
int run_empty(int paged, int B, int H, int Dh, int C, int bs, int device, void* stream,
                 int* plan_out) {
  const Args<T> a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, H, Dh, C,
                  paged ? bs : 1, paged ? C / bs : 0, 0.f};
  return paged ? launch<T, true>(a, B, device, true, plan_out, stream)
               : launch<T, false>(a, B, device, true, plan_out, stream);
}

}  // namespace

// q, out: (B, H, Dh) float32; kc, vc: (B, C, H, Dh), float32 (kv_bf16 0)
// or bfloat16 (kv_bf16 1); pos: (B,) int32. All contiguous; Dh any
// multiple of 8. Returns 0, a cudaError_t, or an Err; plan_out (PLAN_LEN
// ints, may be null) gets the plan.
extern "C" int flash_decode(const void* q, const void* kc, const void* vc, const void* pos,
                            void* out, int B, int H, int Dh, int C, int kv_bf16, int device,
                            void* stream, int* plan_out) {
  return kv_bf16 ? run_dense<__nv_bfloat16>(q, kc, vc, pos, out, B, H, Dh, C, device, stream,
                                        plan_out)
                 : run_dense<float>(q, kc, vc, pos, out, B, H, Dh, C, device, stream, plan_out);
}

// As flash_decode over a pool pk, pv (NB, bs, H, Dh), float32 or bfloat16
// as kv_bf16 says, steered by block_tables (B, MB) int32, whose entries
// must index the pool; the logical capacity is MB * bs.
extern "C" int flash_decode_paged(const void* q, const void* pk, const void* pv,
                                  const void* pos, const void* block_tables, void* out, int B,
                                  int H, int Dh, int bs, int MB, int kv_bf16, int device,
                                  void* stream, int* plan_out) {
  return kv_bf16 ? run_paged<__nv_bfloat16>(q, pk, pv, pos, block_tables, out, B, H, Dh, bs, MB,
                                        device, stream, plan_out)
                 : run_paged<float>(q, pk, pv, pos, block_tables, out, B, H, Dh, bs, MB, device,
                                stream, plan_out);
}

// The empty kernel on the plan flash_decode (paged 0; C the capacity, bs
// unused) or flash_decode_paged (paged 1; C = MB * bs) would launch at
// this shape and cache type: a measurement of the launch alone. Touches no
// memory.
extern "C" int flash_decode_empty(int paged, int B, int H, int Dh, int C, int bs, int kv_bf16,
                                  int device, void* stream, int* plan_out) {
  if (paged && (bs < 1 || C % bs != 0)) return ERR_SHAPE;
  return kv_bf16 ? run_empty<__nv_bfloat16>(paged, B, H, Dh, C, bs, device, stream, plan_out)
                 : run_empty<float>(paged, B, H, Dh, C, bs, device, stream, plan_out);
}

extern "C" const char* flash_decode_error(int code) {
  if (code == ERR_HEAD_DIM) return "head dim must be a positive multiple of 8";
  if (code == ERR_SHAPE) return "B, H, the capacity and the block size must be >= 1";
  if (code == ERR_NO_PLAN) return "no cluster of the decode kernel fits this device";
  return cudaGetErrorString((cudaError_t)code);
}
