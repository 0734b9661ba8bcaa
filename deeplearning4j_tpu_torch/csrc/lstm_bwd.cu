// Single-layer LSTM backward through time over the forward's reserve space.
//
// Replaces: deeplearning4j_tpu/ops/lstm_pallas.py::_bwd_kernel, reached
// through _bwd_call (the backward of fused_lstm_sequence's custom VJP, and
// twice per step of fused_lstm2_sequence's). Walks time in reverse from the
// reserves (post-activation gates (T, B, 4H), tanh(c) and c_prev (T, B, H)),
// the output cotangents dhs (T, B, H) and dcT (B, H), and RW (H, 4H).
// Writes dz (T, B, 4H), the pre-activation gate gradients, in the stream
// dtype, and dh0, dc0 (B, H) in float32. The recurrent gradient is
// dh_rec_t = dz_{t+1} @ RW^T; for bfloat16 streams dz is rounded to
// bfloat16 before that product and the sum stays float32, as in the TPU
// kernel. The weight gradients stay batched GEMMs outside the kernel.
//
// What bounds it on the card: a chain of T dependent steps, so per-step
// latency (the (rows, 4H) x (4H, H) product, the exchange of its result
// between blocks and one barrier) at the training shapes; at large batch
// the float32 FMA work of that product.
//
// Two routes, chosen by shape in lstm_bwd below (never on an error):
//
// The cluster route (lstm_bwd_cluster_kernel), wherever a block's slice of
// RW fits its shared memory beside its partial products: clusters of cs = 16
// blocks (8 where the device runs no 16-block cluster), each cluster owning
// `rows` batch rows, every block of it owning u = ceil(H / cs) hidden units
// and so the 4u dz columns it computes itself. A block keeps all H rows of
// RW at its 4u columns in shared memory (float32, which holds bfloat16
// weights exactly) and each step forms its partial product
// dz_t[:, own cols] @ RW[:, own cols]^T, (rows, H), from its own dz, which
// never leaves shared memory. A reduce-scatter through
// distributed shared memory (lstm_cluster.cuh) hands each block the cs
// partials of its units, read from the peers after one cluster barrier and
// summed in rank order: no grid barrier, no cooperative launch, no
// atomics, and batch rows in different clusters never meet, so clusters
// may run in waves. The
// product runs as register tiles: a warp owns 8 rows x 32 columns of the
// partial, a lane 8 x 4 of them over one gate's columns, so each value read
// from shared memory feeds 8 or 4 FMAs; the four gates' sums are added
// across lanes with shuffles. Step t-1's reserves are loaded into registers
// while step t computes; dc stays in registers; dz goes out with 16-byte
// stores wherever the unit slice is aligned. One more reduce-scatter after
// step 0 gives dh0.
//
// The grid route (lstm_bwd_grid_kernel) for hidden sizes whose slice does
// not fit (H past 432 on an H100): one persistent cooperative launch.
// Block (u, v) owns hidden units [j0, j0 + hsz) and a slice of batch rows,
// keeps the ROWS RW[j0 : j0 + hsz, :] in shared memory, and each step reads
// the full dz_{t+1} rows of its batch rows back from the dz output through
// L2 after a grid barrier.
#include <algorithm>

#include "lstm_cluster.cuh"
#include "lstm_common.cuh"

using namespace lstm;

// ---- the cluster route ------------------------------------------------------

constexpr int CT = 256;   // threads of a cluster-route block
constexpr int PAIRS = 4;  // (row, unit) pairs a thread carries dc for
constexpr int RT = 8;     // rows of a product tile
constexpr int KW = 32;    // columns of dh_rec a warp's product tile covers

// One pair's reserves of one step, as loaded (stream dtype).
template <typename T>
struct Reserve {
  T g[4], tc, cp, dh;
};

// Load step t's reserves of the live pairs (row r0 + pr, unit j0 + pj)
// into registers; they are read one step later.
template <typename T>
__device__ __forceinline__ void fetch(Reserve<T> (&x)[PAIRS], const T* gates, const T* tcs,
                                      const T* cprev, const T* dhs, int t, int B, int H,
                                      int r0, int j0, const int (&pr)[PAIRS],
                                      const int (&pj)[PAIRS], const bool (&live)[PAIRS]) {
#pragma unroll
  for (int p = 0; p < PAIRS; ++p)
    if (live[p]) {
      const size_t row = (size_t)t * B + r0 + pr[p], unit = j0 + pj[p];
      const T* gp = gates + row * 4 * H + unit;
#pragma unroll
      for (int g = 0; g < 4; ++g) x[p].g[g] = gp[g * H];
      x[p].tc = tcs[row * H + unit];
      x[p].cp = cprev[row * H + unit];
      x[p].dh = dhs[row * H + unit];
    }
}

// 16 bytes of dz: 16 / sizeof(T) values already rounded to T.
template <typename T> __device__ __forceinline__ void store16(T* p, const float* v);
template <> __device__ __forceinline__ void store16<float>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* p, const float* v) {
  uint4 w;
  unsigned* q = reinterpret_cast<unsigned*>(&w);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    q[k] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = w;
}

// Shared-memory layout of a cluster-route block, in floats.
struct ClusterSmem {
  int hp, ldz;
  size_t z, part, total;  // offsets (RW's slice first), and the size

  __host__ __device__ ClusterSmem(int H, int u, int rp) {
    hp = (H + KW - 1) / KW * KW;  // H padded to whole product tiles
    // a multiple of 4 (16-byte row loads), 4 past the padded rows so
    // neighbouring columns start on different banks
    ldz = rp + 4;
    z = (size_t)4 * u * hp;
    part = z + (size_t)4 * u * ldz;
    total = part + Partials::floats(rp, hp);
  }
};

inline size_t cluster_smem(int H, int cs, int rp) {
  return ClusterSmem(H, (H + cs - 1) / cs, rp).total * sizeof(float);
}

// Grid (cs, clusters), cluster (cs, 1, 1), CT threads. Block `me` of cluster
// blockIdx.y owns units [me * u, me * u + nj) of batch rows [r0, r0 + nrows);
// rp is rows rounded up to RT.
template <typename T>
__global__ void __launch_bounds__(CT, 1)
    lstm_bwd_cluster_kernel(const T* __restrict__ gates, const T* __restrict__ tcs,
                            const T* __restrict__ cprev, const T* __restrict__ rw,
                            const T* __restrict__ dhs, const T* __restrict__ dcT, T* dz,
                            float* dh0, float* dc0, int Tn, int B, int H, int u, int rows,
                            int rp) {
  extern __shared__ __align__(16) float smem[];
  const int cs = gridDim.x, me = (int)cluster_rank();
  const ClusterSmem L(H, u, rp);
  const int G = 4 * H, hp = L.hp, ldz = L.ldz;
  const int j0 = me * u, nj = max(0, min(u, H - j0));
  const int r0 = blockIdx.y * rows, nrows = min(rows, B - r0);
  // w_s[(g * u + jj) * hp + k] = RW[k][g * H + j0 + jj], zero past nj and H
  float* w_s = smem;
  // z_s[(g * u + jj) * ldz + r] = dz_t[r0 + r][g * H + j0 + jj] as the
  // product reads it (rounded to T), zero past nrows and nj
  float* z_s = smem + L.z;
  // part: this block's (rows x H) partial of each step, two halves
  const Partials part{smem + L.part, rp, hp};

  for (int idx = threadIdx.x; idx < 4 * u * hp; idx += CT) {
    const int k = idx / (4 * u), c = idx % (4 * u), g = c / u, jj = c % u;
    w_s[(size_t)c * hp + k] =
        jj < nj && k < H ? to_f32(rw[(size_t)k * G + g * H + j0 + jj]) : 0.f;
  }
  for (int idx = threadIdx.x; idx < 4 * u * ldz; idx += CT) z_s[idx] = 0.f;

  // the pairs this thread carries: pair q = threadIdx.x + p * CT is
  // (row q / u, unit q % u)
  int pr[PAIRS], pj[PAIRS];
  bool live[PAIRS];
  float dc[PAIRS];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    pr[p] = (threadIdx.x + p * CT) / u;
    pj[p] = (threadIdx.x + p * CT) % u;
    live[p] = pr[p] < nrows && pj[p] < nj;
    dc[p] = live[p] ? to_f32(dcT[(size_t)(r0 + pr[p]) * H + j0 + pj[p]]) : 0.f;
  }
  Reserve<T> cur[PAIRS], nxt[PAIRS];
  fetch(cur, gates, tcs, cprev, dhs, Tn - 1, B, H, r0, j0, pr, pj, live);
  // every block of the cluster is running before any block reads another's
  // shared memory
  cluster_sync();

  constexpr int VW = 16 / sizeof(T);
  const bool vec = H % VW == 0 && u % VW == 0;
  const int nch = (nj + VW - 1) / VW;
  // the product's tiles: RT rows x KW columns of dh_rec per warp; lane
  // (g, kq) walks gate g's columns for columns kq * 4 .. kq * 4 + 3 of it
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, gl = lane / 8;
  const int nkt = hp / KW, ntiles = (nrows + RT - 1) / RT * nkt;
  for (int t = Tn - 1; t >= 0; --t) {
    // step t reads the partials step t + 1 wrote and writes the other half
    const int par = t & 1;
    if (t > 0) fetch(nxt, gates, tcs, cprev, dhs, t - 1, B, H, r0, j0, pr, pj, live);
#pragma unroll
    for (int p = 0; p < PAIRS; ++p)
      if (live[p]) {
        const int r = pr[p], jj = pj[p];
        const float dh_rec = t + 1 < Tn ? part.gather(par ^ 1, r, j0 + jj, cs) : 0.f;
        const float i = to_f32(cur[p].g[0]), f = to_f32(cur[p].g[1]),
                    o = to_f32(cur[p].g[2]), g = to_f32(cur[p].g[3]);
        const float tc = to_f32(cur[p].tc), cp = to_f32(cur[p].cp);
        const float dh = to_f32(cur[p].dh) + dh_rec;
        const float d_o = dh * tc;
        const float dcp = dc[p] + dh * o * (1.f - tc * tc);
        const float di = dcp * g, dg = dcp * i, df = dcp * cp;
        float* zc = z_s + jj * ldz + r;
        zc[0] = rounded<T>(di * i * (1.f - i));
        zc[(size_t)u * ldz] = rounded<T>(df * f * (1.f - f));
        zc[(size_t)2 * u * ldz] = rounded<T>(d_o * o * (1.f - o));
        zc[(size_t)3 * u * ldz] = rounded<T>(dg * (1.f - g * g));
        dc[p] = dcp * f;
      }
    __syncthreads();

    // dz_t out: VW units of one gate and row per 16-byte store where aligned
    for (int idx = threadIdx.x; idx < 4 * nrows * nch; idx += CT) {
      const int ch = idx % nch, r = (idx / nch) % nrows, g = idx / (nch * nrows);
      const int jj = ch * VW;
      T* dst = dz + ((size_t)t * B + r0 + r) * G + g * H + j0 + jj;
      const float* src = z_s + (size_t)(g * u + jj) * ldz + r;
      float v[VW];
#pragma unroll
      for (int k = 0; k < VW; ++k) v[k] = src[(size_t)k * ldz];
      if (vec && jj + VW <= nj) {
        store16<T>(dst, v);
      } else {
#pragma unroll
        for (int k = 0; k < VW; ++k)
          if (jj + k < nj) dst[k] = from_f32<T>(v[k]);
      }
    }

    // the partial product dz_t[:, own cols] @ RW[:, own cols]^T, tile by
    // tile; each lane sums its gate's columns for 8 rows x 4 columns and the
    // four gates are added across lanes
    for (int tile = warp; tile < ntiles; tile += CT / 32) {
      const int rt = tile / nkt, k0 = (tile % nkt) * KW + (lane % 8) * 4;
      float acc[RT][4];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      const float* zp = z_s + (size_t)gl * u * ldz + rt * RT;
      const float* wp = w_s + (size_t)gl * u * hp + k0;
#pragma unroll 2
      for (int jj = 0; jj < nj; ++jj) {
        const float4 a0 = ld4(zp + (size_t)jj * ldz), a1 = ld4(zp + (size_t)jj * ldz + 4);
        const float4 w = ld4(wp + (size_t)jj * hp);
        const float a[RT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          acc[r][0] += a[r] * w.x;
          acc[r][1] += a[r] * w.y;
          acc[r][2] += a[r] * w.z;
          acc[r][3] += a[r] * w.w;
        }
      }
      // add the four gates' sums: lanes g and g ^ 2 swap halves of the rows,
      // then g and g ^ 1 halves of those; each add has two terms, so the
      // order of every sum is fixed
      const bool hi1 = lane & 16, hi2 = lane & 8;
      float half[4][4], out[2][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float got = __shfl_xor_sync(0xffffffffu, hi1 ? acc[r][q] : acc[r + 4][q], 16);
          half[r][q] = (hi1 ? acc[r + 4][q] : acc[r][q]) + got;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float got = __shfl_xor_sync(0xffffffffu, hi2 ? half[r][q] : half[r + 2][q], 8);
          out[r][q] = (hi2 ? half[r + 2][q] : half[r][q]) + got;
        }
      const int row0 = rt * RT + (hi1 ? 4 : 0) + (hi2 ? 2 : 0);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float4*>(part.at(par, row0 + r, k0)) =
            make_float4(out[r][0], out[r][1], out[r][2], out[r][3]);
    }
    cluster_sync();
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) cur[p] = nxt[p];
  }
  // dh0 = dz_0 @ RW^T, from the partials step 0 wrote (parity 0)
#pragma unroll
  for (int p = 0; p < PAIRS; ++p)
    if (live[p]) {
      const int r = pr[p], jj = pj[p];
      const size_t ci = (size_t)(r0 + r) * H + j0 + jj;
      dh0[ci] = part.gather(0, r, j0 + jj, cs);
      dc0[ci] = dc[p];
    }
  // no block leaves while a peer may still read its shared memory
  cluster_sync();
}

// The cluster route's plan: clusters of cs blocks, `rows` batch rows each.
struct ClusterPlan {
  int cs, u, rows, rp, clusters;
  size_t smem;
};

// Clusters of 16 blocks: on an H100 they beat clusters of 8 at the LSTM
// recipe's shape (half the columns a block, for the same exchange), so 8,
// the portable size, runs only where the device cannot co-schedule a
// 16-block cluster of this kernel. Rows per cluster: enough that the
// clusters which fit on the device at once cover B, rounded up to whole
// product tiles (fewer rows would only idle lanes and put more clusters on
// the SMs), and no more than a block's register pairs and shared memory
// hold. *ok is false when no cluster fits this H (the grid route's shapes).
template <typename T>
static int search_cluster_plan(int dev, int B, int H, ClusterPlan* out, bool* ok) {
  *ok = false;
  int max_smem;
  cudaError_t e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  for (int cs = 16; cs >= 8; cs /= 2) {
    const int u = (H + cs - 1) / cs;
    int rmax = std::min(B, PAIRS * CT / u);
    int rp = (rmax + RT - 1) / RT * RT;
    while (rp >= RT && cluster_smem(H, cs, rp) > (size_t)max_smem) rp -= RT;
    if (rp < RT || rmax < 1) continue;
    rmax = std::min(rmax, rp);
    const int n = max_active_clusters(lstm_bwd_cluster_kernel<T>, cs, CT,
                                      cluster_smem(H, cs, rp));
    if (n < 1) continue;
    const int rows = std::min(rmax, ((B + n - 1) / n + RT - 1) / RT * RT);
    rp = (rows + RT - 1) / RT * RT;
    *out = ClusterPlan{cs, u, rows, rp, (B + rows - 1) / rows, cluster_smem(H, cs, rp)};
    *ok = true;
    return 0;
  }
  return 0;
}

// The plan of (device, B, H), searched once (cached_plan), with the kernel's
// attributes set for it on every call, since another shape's plan may
// have set smaller ones.
template <typename T>
static int plan_cluster(int B, int H, ClusterPlan* out, bool* ok) {
  const int e = cached_plan<search_cluster_plan<T>>(B, H, out, ok);
  if (e || !*ok) return e;
  return (int)cluster_attributes(lstm_bwd_cluster_kernel<T>, out->cs, out->smem);
}

// ---- the grid route ---------------------------------------------------------

// Copy the rows a block owns out of RW (H, 4H) into shared memory as
// float32, four consecutive gate columns side by side so a thread reads
// them with one 16-byte load: dst[g4][j][q] = src[j0 + j][4 * g4 + q].
template <typename T>
__device__ __forceinline__ void load_weight_rows(float* dst, const T* src, int H, int j0,
                                                 int hsz, int nj) {
  const int G = 4 * H, W4 = 4 * hsz;
  for (int idx = threadIdx.x; idx < G * hsz; idx += blockDim.x) {
    const int g4 = idx / W4, j = (idx % W4) / 4, q = idx % 4;
    dst[idx] = j < nj ? to_f32(src[(size_t)(j0 + j) * G + 4 * g4 + q]) : 0.f;
  }
}

// (at least one block per SM: without it ptxas spilled 4 bytes in the
// float32 instantiation)
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    lstm_bwd_grid_kernel(const T* __restrict__ gates, const T* __restrict__ tcs,
                         const T* __restrict__ cprev, const T* __restrict__ rw,
                         const T* __restrict__ dhs, const T* __restrict__ dcT, T* dz,
                         float* dh0, float* dc0, float* dc_s, int Tn, int B, int H, int hsz,
                         int kc) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  const int j0 = blockIdx.x * hsz, nj = min(hsz, H - j0);
  const int ld = tile_ld(kc);
  float* w_s = smem;                    // [4H / 4][hsz][4]
  float* z_s = smem + (size_t)G * hsz;  // [ROWS][ld] slice of dz_{t+1}
  load_weight_rows(w_s, rw, H, j0, hsz, nj);

  const int per = (B + gridDim.y - 1) / gridDim.y;
  const int r_begin = blockIdx.y * per, r_end = min(B, r_begin + per);
  const int j = threadIdx.x % hsz, rr = threadIdx.x / hsz;
  // a block whose rows fit one pass keeps each thread's dc in a register
  const bool one_pass = r_end - r_begin <= ROWS;
  float dc_reg = 0.f;
  if (j < nj)
    for (int r = r_begin + rr; r < r_end; r += ROWS) {
      const float d = to_f32(dcT[(size_t)r * H + j0 + j]);
      if (one_pass) dc_reg = d;
      else dc_s[(size_t)r * H + j0 + j] = d;
    }

  // iteration t runs step t of the backward; t == -1 only takes dh0
  for (int t = Tn - 1; t >= -1; --t) {
    const bool has_next = t + 1 < Tn;
    const T* znext = dz + (size_t)(t + 1) * B * G;
    for (int rc = r_begin; rc < r_end; rc += ROWS) {
      const int nrows = min(ROWS, r_end - rc);
      const int r = rc + rr;
      const bool live = r < r_end && j < nj;
      const size_t ci = (size_t)r * H + j0 + j;
      // step t's reserves, read before dz_{t+1} is staged so their latency
      // overlaps the staging's
      float4 gt = make_float4(0.f, 0.f, 0.f, 0.f);
      float tc = 0.f, cp = 0.f, dh_in = 0.f;
      if (live && t >= 0) {
        const size_t at = ((size_t)t * B + r) * H + j0 + j;
        gt = load_gates(gates + ((size_t)t * B + r) * G + j0 + j, H);
        tc = to_f32(tcs[at]);
        cp = to_f32(cprev[at]);
        dh_in = to_f32(dhs[at]);
      }
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (has_next) {
        for (int k0 = 0; k0 < G; k0 += kc) {
          const int kn = min(kc, G - k0);  // a multiple of 4, as are k0 and G
          __syncthreads();
          stage(z_s, znext, (float*)nullptr, (const T*)nullptr, rc, nrows, k0, kn, ld, G);
          __syncthreads();
          const float* zrow = z_s + rr * ld;
          const float* w = w_s + (size_t)k0 * hsz + 4 * j;
          for (int kk = 0; kk < kn; kk += 4) {
            const float4 a = ld4(zrow + kk), b = ld4(w + (size_t)kk * hsz);
            acc.x += a.x * b.x;
            acc.y += a.y * b.y;
            acc.z += a.z * b.z;
            acc.w += a.w * b.w;
          }
        }
      }
      if (live) {
        const float dh_rec = (acc.x + acc.y) + (acc.z + acc.w);
        float dc = one_pass ? dc_reg : dc_s[ci];
        if (t >= 0) {
          const float i = gt.x, f = gt.y, o = gt.z, g = gt.w;
          const float dh = dh_in + dh_rec;
          const float d_o = dh * tc;
          dc = dc + dh * o * (1.f - tc * tc);
          const float di = dc * g, dg = dc * i, df = dc * cp;
          store_gates(dz + ((size_t)t * B + r) * G + j0 + j,
                      make_float4(di * i * (1.f - i), df * f * (1.f - f),
                                  d_o * o * (1.f - o), dg * (1.f - g * g)),
                      H);
          dc = dc * f;
          if (one_pass) dc_reg = dc;
          else dc_s[ci] = dc;
        } else {
          dh0[ci] = dh_rec;
          dc0[ci] = dc;
        }
      }
    }
    if (t >= 0) grid.sync();
  }
}

// ---- the entry points -------------------------------------------------------

// The route a launch at (B, H) takes: the cluster plan wherever one fits
// (*cluster, c), else the grid plan (p); ERR_NO_PLAN where neither fits.
// The launch and the plan query (lstm_bwd_plan) both ask it, so the query
// answers what the launch would do. Reports the plan in plan_out.
template <typename T>
static int choose_route(int B, int H, bool* cluster, ClusterPlan* c, Plan* p, int* plan_out) {
  int e = plan_cluster<T>(B, H, c, cluster);
  if (e) return e;
  if (*cluster) {
    report_cluster_plan(plan_out, c->cs, c->clusters, c->rows, c->u, CT, c->smem);
    return 0;
  }
  e = make_plan((const void*)lstm_bwd_grid_kernel<T>, B, H, 4 * H, 1, 1, true, p);
  if (e == 0) report_grid_plan(plan_out, *p, B);
  return e;
}

template <typename T>
static int launch(void* const* in, void* const* out, void* dc_s, int Tn, int B, int H,
                  cudaStream_t stream, int* plan_out) {
  const T *gates = (const T*)in[0], *tcs = (const T*)in[1], *cprev = (const T*)in[2],
          *rw = (const T*)in[3], *dhs = (const T*)in[4], *dcT = (const T*)in[5];
  T* dz = (T*)out[0];
  float *dh0 = (float*)out[1], *dc0 = (float*)out[2], *dcs = (float*)dc_s;
  ClusterPlan c;
  Plan p;
  bool cluster;
  const int e = choose_route<T>(B, H, &cluster, &c, &p, plan_out);
  if (e) return e;
  if (cluster)
    return launch_clusters(lstm_bwd_cluster_kernel<T>, c.cs, c.clusters, CT, c.smem, stream,
                           gates, tcs, cprev, rw, dhs, dcT, dz, dh0, dc0, Tn, B, H, c.u, c.rows,
                           c.rp);
  const void* fn = (const void*)lstm_bwd_grid_kernel<T>;
  int hsz = p.hsz, kc = p.kc;
  void* args[] = {&gates, &tcs, &cprev, &rw, &dhs, &dcT, &dz, &dh0,
                  &dc0,   &dcs, &Tn,    &B,  &H,   &hsz, &kc};
  cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(p.nu, p.nbb), dim3(p.threads), args,
                                                p.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// in: gates (T, B, 4H), tanh(c), c_prev (T, B, H), rw (H, 4H), dhs (T, B, H),
// dcT (B, H), all in the stream dtype; out: dz (T, B, 4H) in the stream
// dtype, dh0 and dc0 (B, H) float32. Scratch: dc (B, H) float32, used by the
// grid route. The route is the cluster one wherever a cluster plan fits
// this H, else the grid one. Returns 0, a cudaError_t, or a negative
// lstm::Err; plan_out as lstm_common.cuh gives it.
extern "C" int lstm_bwd(void* const* in, void* const* out, void* dc_scratch, int T, int B,
                        int H, int dtype, int device, void* stream, int* plan_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32) return launch<float>(in, out, dc_scratch, T, B, H, s, plan_out);
  if (dtype == BF16) return launch<__nv_bfloat16>(in, out, dc_scratch, T, B, H, s, plan_out);
  return ERR_DTYPE;
}

// The plan lstm_bwd would launch at (B, H) in this dtype, any T: 0 with
// plan_out filled, ERR_NO_PLAN where no route fits, or another error.
// Launches nothing.
extern "C" int lstm_bwd_plan(int B, int H, int dtype, int device, int* plan_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  ClusterPlan c;
  Plan p;
  bool cluster;
  if (dtype == F32) return choose_route<float>(B, H, &cluster, &c, &p, plan_out);
  if (dtype == BF16) return choose_route<__nv_bfloat16>(B, H, &cluster, &c, &p, plan_out);
  return ERR_DTYPE;
}

extern "C" const char* lstm_error(int code) { return error_text(code); }
