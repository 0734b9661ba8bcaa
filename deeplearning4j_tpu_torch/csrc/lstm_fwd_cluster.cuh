// The cluster route of the LSTM forwards: one layer (K1 and K2, lstm_fwd.cu)
// or two stacked on a wavefront (K4 and K4-train, lstm2_fwd.cu), in
// inference or training mode: one kernel body, a kernel for each layer
// count, and their launch plan.
//
// Clusters of cs = 16 blocks (8 where the device runs no 16-block cluster),
// each cluster owning `rows` batch rows, every block of it owning u =
// ceil(H / cs) hidden units of every layer. A block keeps the 4u gate
// columns of the weights for its units in shared memory (float32, which
// holds bfloat16 weights exactly) for the whole sequence -- RW for one
// layer, RW1, W2 and RW2 for two -- so it computes its own z columns
// entirely by itself: the exchange is an all-gather of h, not a
// reduce-scatter. After its cell updates a block writes its units of h
// (rounded to the stream dtype, as the products read them) into its own
// shared memory; after the cluster barrier every block reads the full
// rows x H of h from its peers (lstm_cluster.cuh: Slices, SliceGather)
// into k-major tiles. No grid barrier, no cooperative launch, no atomics,
// and batch rows in different clusters never meet, so clusters may run in
// waves.
//
// The products run as register tiles: 16 lanes share one unit and a tile
// of RT rows, each lane taking every 16th k, and hold RT rows x 4 gates of
// each layer's z, so each weight read from shared memory feeds RT (one
// layer) or 2 RT (two) FMAs and each h value 4 or 8; the 16 lanes' sums are
// folded by shuffles in a fixed order (bitwise repeatable), leaving each
// lane the four gates of one (layer, row), whose cell it updates with c in
// a register (one path for both layers' cells, so a warp does not diverge
// on them). The weights are stored XOR-swizzled by k and the h tiles
// padded so that the 8 lanes of a 16-byte load phase hit distinct banks.
// The outputs, which no block reads back, are stored between the barrier's
// arrive and its wait, so the arrive's release waits only on the slices;
// the next step's gate inputs are loaded there too.
//
// Two layers run on a wavefront: iteration s runs layer-1 step s and
// layer-2 step s - 1. Both read only h1_{s-1} and h2_{s-2}, which the
// previous iteration wrote, so one barrier per iteration serves both
// layers: T + 1 barriers instead of 2T. One layer runs T iterations.
#pragma once

#include <algorithm>

#include "lstm_cluster.cuh"
#include "lstm_common.cuh"

namespace lstm {

constexpr int KS = 16;  // lanes that split one product tile's contraction

// Most threads of a block: a block owns u units of each row tile with KS
// lanes each. One layer's register tiles are half the size of two layers',
// which leaves room for twice the threads: a block may own up to 32 units,
// and the weights' shared memory, not the threads, bounds H (432 on an
// H100, clusters of 16, as K3's).
__host__ __device__ constexpr int fwd_threads(int layers) { return layers == 1 ? 512 : 256; }

// What a cluster-route forward reads and writes, in the stream dtype T. For
// one layer the second layer's pointers are null; in inference mode the
// reserves are.
template <typename T>
struct FwdIO {
  const T* gate_in;          // (T, B, 4H) = x @ W1 + b1
  const T* rw1;              // (H, 4H)
  const T *w2, *b2, *rw2;    // layer 2: (H, 4H), (4H,), (H, 4H)
  const T *h0[2], *c0[2];    // (B, H) initial carries of each layer
  T* hs;                     // (T, B, H): h of the top layer
  T* h1T;                    // layer 1's final h (two layers: one layer's is hs[T - 1])
  T* cT[2];                  // (B, H) final c of each layer
  // training mode: each layer's post-activation gates (T, B, 4H), tanh(c)
  // and c_prev (T, B, H); with two layers also layer 1's h (T, B, H)
  T *g[2], *tc[2], *cp[2];
  T* hs1;
};

// Shared-memory layout of a block, in floats.
struct FwdSmem {
  int hp, ldw, ldh, ldx;
  size_t ht, x, total;  // offsets (the weights first), and the size

  __host__ __device__ FwdSmem(int H, int u, int rp, int layers) {
    hp = (H + KS - 1) / KS * KS;  // H padded to whole turns of the k split
    ldw = (u + 7) / 8 * 8;        // float4s (units) a weight row holds
    const int r4 = (rp + 3) / 4;
    ldx = 4 * r4;                 // a unit's rows in the exchange slices
    ldh = 4 * (r4 | 1);           // an odd number of float4s per tile row
    ht = (size_t)(2 * layers - 1) * hp * ldw * 4;
    x = ht + (size_t)layers * hp * ldh;
    total = x + Slices::floats(u, ldx, layers);
  }
};

// RT rows of a k-major tile row into registers (p 16-byte aligned): 16-,
// 8- and 4-byte loads.
template <int RT>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[RT]) {
#pragma unroll
  for (int i = 0; i + 4 <= RT; i += 4) {
    const float4 x = ld4(p + i);
    v[i] = x.x;
    v[i + 1] = x.y;
    v[i + 2] = x.z;
    v[i + 3] = x.w;
  }
  constexpr int i2 = RT / 4 * 4;
  if constexpr (RT % 4 >= 2) {
    const float2 x = *reinterpret_cast<const float2*>(p + i2);
    v[i2] = x.x;
    v[i2 + 1] = x.y;
  }
  if constexpr (RT % 2) v[RT - 1] = p[RT - 1];
}

// Sum N values over the KS lanes that split a contraction, leaving four.
// While more than four remain, lanes M apart swap halves (the lane with
// bit M keeps the upper half) and add; past that, they add the four they
// hold (both get the same bits: the two terms are the same). Every sum has
// a fixed order, so the result is the same on every launch.
template <int N, int M>
__device__ __forceinline__ void fold(float* acc, int ks) {
  if constexpr (M > 0) {
    if constexpr (N > 4) {
      const bool hi = ks & M;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float got = __shfl_xor_sync(0xffffffffu, hi ? acc[i] : acc[i + N / 2], M);
        acc[i] = (hi ? acc[i + N / 2] : acc[i]) + got;
      }
      fold<N / 2, M / 2>(acc, ks);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], M);
      fold<4, M / 2>(acc, ks);
    }
  }
}

__host__ __device__ constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

// The next power of two: the rows a fold lays out for a tile of n rows.
__host__ __device__ constexpr int pow2ceil(int n) { return n <= 1 ? 1 : 2 * pow2ceil((n + 1) / 2); }

// Copy this block's gate columns of the NW weight matrices (RW1; W2, RW2)
// into shared memory as float32: w_s[(m * hp + k) * ldw + (jj ^ (k & 7))]
// = the four gates of unit j0 + jj in row k of matrix m, zero past nj and
// H. LOAD_BATCH rows of loads in flight per thread before any store.
template <typename T, int NW>
__device__ __forceinline__ void load_weights_swizzled(float4* w_s, const T* rw1, const T* w2,
                                                      const T* rw2, int H, int hp, int ldw,
                                                      int j0, int nj) {
  const int n = NW * hp * ldw;
  for (int base = threadIdx.x; base < n; base += LOAD_BATCH * blockDim.x) {
    float4 v[LOAD_BATCH];
    int at[LOAD_BATCH];
#pragma unroll
    for (int i = 0; i < LOAD_BATCH; ++i) {
      const int idx = base + i * blockDim.x;
      const int jj = idx % ldw, k = (idx / ldw) % hp, m = idx / (ldw * hp);
      const T* src = m == 0 ? rw1 : m == 1 ? w2 : rw2;
      at[i] = idx < n ? (m * hp + k) * ldw + (jj ^ (k & 7)) : -1;
      v[i] = idx < n && jj < nj && k < H ? load_gates(src + (size_t)k * 4 * H + j0 + jj, H)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < LOAD_BATCH; ++i)
      if (at[i] >= 0) w_s[at[i]] = v[i];
  }
}

// The body of both kernels below. Grid (cs, clusters), cluster (cs, 1, 1),
// rp / RT * u * KS threads rounded up to a warp. Block `me` of cluster
// blockIdx.y owns units [me * u, me * u + nj) of batch rows [r0, r0 +
// nrows); RT is the rows of a product tile (rows itself up to 8, else 8),
// rp the rows rounded up to it.
template <typename T, bool TRAIN, int RT, int LAYERS>
__device__ __forceinline__ void fwd_cluster(const FwdIO<T>& io, int Tn, int B, int H, int u,
                                            int rows, int rp) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NW = 2 * LAYERS - 1;
  const int me = (int)cluster_rank();
  const FwdSmem L(H, u, rp, LAYERS);
  const int G = 4 * H, hp = L.hp, ldw = L.ldw, ldh = L.ldh;
  const int j0 = me * u, nj = max(0, min(u, H - j0));
  const int r0 = blockIdx.y * rows, nrows = min(rows, B - r0);
  // w_s: this block's weight columns, load_weights_swizzled's layout
  float4* w_s = reinterpret_cast<float4*>(smem);
  // h_t[(l * hp + k) * ldh + r] = h of layer l (h1_{s-1}, h2_{s-2}) at
  // unit k of local row r, as the products read it; zero past H and nrows
  float* h_t = smem + L.ht;
  // this block's units of h1_s (and h2_{s-1}), two halves by parity
  const Slices own{smem + L.x, u, L.ldx, LAYERS};

  // the product tile of this thread: RT local rows from rt * RT, unit jj,
  // k = ks, ks + KS, ...; the fold lays its sums out for RP rows (RT
  // rounded up to a power of two, the rows past RT zero) and leaves the
  // gates of layer `layer` at local row lr, whose cell it owns (c in a
  // register)
  constexpr int RP = pow2ceil(RT), FOLDS = log2i(LAYERS * RP), SPREAD = KS >> FOLDS;
  const int ks = threadIdx.x % KS, tile = threadIdx.x / KS;
  const bool tile_live = tile < rp / RT * u;
  const int rt = tile_live ? tile / u : 0, jj = tile_live ? tile % u : 0;
  const int q = ks / SPREAD, layer = LAYERS == 1 ? 0 : q / RP, lr = rt * RT + q % RP;
  const bool owner =
      tile_live && ks % SPREAD == 0 && q % RP < RT && jj < nj && lr < nrows;
  const int r = r0 + lr, j = j0 + jj;
  const size_t ci = (size_t)r * H + j;
  // the cell's outputs: layer 1 writes step t = s of iteration s, layer 2
  // step t = s - 1; the top layer always writes its h, layer 1 of two only
  // in the training mode, with the reserves
  const bool top = layer == LAYERS - 1;
  T* const h_out = top ? io.hs : io.hs1;
  T* const cp_out = layer == 0 ? io.cp[0] : io.cp[1];
  T* const tc_out = layer == 0 ? io.tc[0] : io.tc[1];
  T* const g_out = layer == 0 ? io.g[0] : io.g[1];
  T* const c_out = layer == 0 ? io.cT[0] : io.cT[1];
  // the initial carries and the gate inputs added to the product (gate_in
  // of the step for layer 1, b2 for layer 2) are loaded before the weights,
  // so their latency hides behind the weights'
  float c = 0.f, h0 = 0.f;
  float4 zin = make_float4(0.f, 0.f, 0.f, 0.f);
  if (owner) {
    c = to_f32(layer == 0 ? io.c0[0][ci] : io.c0[1][ci]);
    h0 = to_f32(layer == 0 ? io.h0[0][ci] : io.h0[1][ci]);
    zin = layer == 0 ? load_gates(io.gate_in + (size_t)r * G + j, H) : load_gates(io.b2 + j, H);
  }
  load_weights_swizzled<T, NW>(w_s, io.rw1, io.w2, io.rw2, H, hp, ldw, j0, nj);
  for (int idx = threadIdx.x; idx < LAYERS * hp * ldh; idx += blockDim.x) h_t[idx] = 0.f;
  for (int idx = threadIdx.x; idx < (int)Slices::floats(u, L.ldx, LAYERS); idx += blockDim.x)
    own.base[idx] = 0.f;
  __syncthreads();  // the slices are zero before the initial carries land
  if (owner) {
    if (layer == 0) own.at(1, 0, jj)[lr] = h0;
    else own.at(0, 1, jj)[lr] = own.at(1, 1, jj)[lr] = h0;  // h2_{-1}, read at s = 1
  }
  SliceGather gather;
  gather.init(own, H, hp, ldh);
  const int swz = jj ^ (ks & 7);  // k & 7 == ks & 7 for every k of this lane
  const float4* wp = w_s + (size_t)ks * ldw + swz;
  const float* ap = h_t + (size_t)ks * ldh + rt * RT;
  // every block of the cluster is running and has its initial slices in
  // place before any block reads another's shared memory
  cluster_sync();

  for (int s = 0; s < Tn + LAYERS - 1; ++s) {
    const int par = s & 1;
    gather.run(par ^ 1, h_t);  // h1_{s-1}, h2_{s-2}: written at s - 1
    __syncthreads();
    float acc[4 * LAYERS * RP];  // [layer][row][gate]
#pragma unroll
    for (int i = 0; i < 4 * LAYERS * RP; ++i) acc[i] = 0.f;
    // k steps in flight: 4 where a small tile is bound by the loads' latency
#pragma unroll(RT > 4 ? 2 : 4)
    for (int kk = 0; kk < hp; kk += KS) {
      float a[RT];
      load_rows<RT>(ap + (size_t)kk * ldh, a);
      const size_t o = (size_t)kk * ldw;
      const float4 x1 = wp[o];
      if constexpr (LAYERS == 1) {
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          float* z1 = acc + 4 * i;
          z1[0] += a[i] * x1.x;
          z1[1] += a[i] * x1.y;
          z1[2] += a[i] * x1.z;
          z1[3] += a[i] * x1.w;
        }
      } else {
        float b[RT];
        load_rows<RT>(ap + (size_t)(hp + kk) * ldh, b);
        const float4 x2 = wp[(size_t)hp * ldw + o], x3 = wp[(size_t)2 * hp * ldw + o];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          float* z1 = acc + 4 * i;
          float* z2 = acc + 4 * (RP + i);
          z1[0] += a[i] * x1.x;
          z1[1] += a[i] * x1.y;
          z1[2] += a[i] * x1.z;
          z1[3] += a[i] * x1.w;
          z2[0] += a[i] * x2.x;
          z2[1] += a[i] * x2.y;
          z2[2] += a[i] * x2.z;
          z2[3] += a[i] * x2.w;
          z2[0] += b[i] * x3.x;
          z2[1] += b[i] * x3.y;
          z2[2] += b[i] * x3.z;
          z2[3] += b[i] * x3.w;
        }
      }
    }
    fold<4 * LAYERS * RP, KS / 2>(acc, ks);

    // the cell: h and c in registers, h into this block's slice before the
    // arrive; the outputs, which no block reads back, after it, so the
    // arrive's release waits only on the slice
    const int t = s - layer;
    const bool live = owner && t >= 0 && t < Tn;
    const float cp = c;
    float h = 0.f, tc = 0.f;
    float4 act = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      const float zi = zin.x + acc[0], zf = zin.y + acc[1], zo = zin.z + acc[2],
                  zg = zin.w + acc[3];
      if (TRAIN) h = cell_train(zi, zf, zo, zg, c, act, tc);
      else h = cell(zi, zf, zo, zg, c);
      own.at(par, layer, jj)[lr] = rounded<T>(h);
    }
    cluster_arrive();
    if (live) {
      const size_t at = ((size_t)t * B + r) * H + j;
      if (TRAIN || top) h_out[at] = from_f32<T>(h);
      if (TRAIN) {
        cp_out[at] = from_f32<T>(cp);
        store_gates(g_out + ((size_t)t * B + r) * G + j, act, H);
        tc_out[at] = from_f32<T>(tc);
      }
      if (t == Tn - 1) {
        if (LAYERS == 2 && layer == 0) io.h1T[ci] = from_f32<T>(h);
        c_out[ci] = from_f32<T>(c);
      }
    }
    // the next step's gate inputs load while the cluster gathers at the
    // barrier; the last wait also keeps every block's shared memory alive
    // until no peer reads it
    if (owner && layer == 0 && s + 1 < Tn)
      zin = load_gates(io.gate_in + ((size_t)(s + 1) * B + r) * G + j, H);
    cluster_wait();
  }
}

// The kernels of one layer (K1, K2) and of two (K4, K4-train): one name
// each, so that a profile tells them apart.
template <typename T, bool TRAIN, int RT>
__global__ void __launch_bounds__(fwd_threads(1), 1)
    lstm_fwd_cluster_kernel(const FwdIO<T> io, int Tn, int B, int H, int u, int rows, int rp) {
  fwd_cluster<T, TRAIN, RT, 1>(io, Tn, B, H, u, rows, rp);
}

template <typename T, bool TRAIN, int RT>
__global__ void __launch_bounds__(fwd_threads(2), 1)
    lstm2_fwd_cluster_kernel(const FwdIO<T> io, int Tn, int B, int H, int u, int rows, int rp) {
  fwd_cluster<T, TRAIN, RT, 2>(io, Tn, B, H, u, rows, rp);
}

// The cluster route's plan: clusters of cs blocks, `rows` batch rows each,
// product tiles of rt rows (rp = rows rounded up to rt).
struct ClusterPlan {
  int cs, u, rows, rp, rt, threads, clusters;
  size_t smem;
};

template <typename T>
using ClusterKernel = void (*)(FwdIO<T>, int, int, int, int, int, int);

template <typename T, bool TRAIN, int LAYERS, int RT>
constexpr ClusterKernel<T> kernel_of() {
  if constexpr (LAYERS == 1) return lstm_fwd_cluster_kernel<T, TRAIN, RT>;
  else return lstm2_fwd_cluster_kernel<T, TRAIN, RT>;
}

template <typename T, bool TRAIN, int LAYERS>
inline ClusterKernel<T> cluster_kernel(int rt) {
  switch (rt) {
    case 1: return kernel_of<T, TRAIN, LAYERS, 1>();
    case 2: return kernel_of<T, TRAIN, LAYERS, 2>();
    case 3: return kernel_of<T, TRAIN, LAYERS, 3>();
    case 4: return kernel_of<T, TRAIN, LAYERS, 4>();
    case 5: return kernel_of<T, TRAIN, LAYERS, 5>();
    case 6: return kernel_of<T, TRAIN, LAYERS, 6>();
    case 7: return kernel_of<T, TRAIN, LAYERS, 7>();
    default: return kernel_of<T, TRAIN, LAYERS, 8>();
  }
}

// The product tile for `rows` rows: all of them up to 8, else 8.
inline int row_tile(int rows) { return rows < 8 ? rows : 8; }

// A plan of clusters of cs blocks owning `rows` rows each (clusters unset).
inline ClusterPlan sized(int cs, int H, int rows, int layers) {
  ClusterPlan p{};
  p.cs = cs;
  p.u = (H + cs - 1) / cs;
  p.rows = rows;
  p.rt = row_tile(rows);
  p.rp = (rows + p.rt - 1) / p.rt * p.rt;
  p.threads = (p.rp / p.rt * p.u * KS + 31) / 32 * 32;
  p.smem = FwdSmem(H, p.u, p.rp, layers).total * sizeof(float);
  return p;
}

// A plan the kernel takes: threads within fwd_threads, shared memory within
// the device's, and at most GATHER_MAX copies per thread in the all-gather.
inline bool fits(const ClusterPlan& p, int H, int max_smem, int layers) {
  const int copies = layers * H * FwdSmem(H, p.u, p.rp, layers).ldx / 4;
  return p.threads <= fwd_threads(layers) && p.smem <= (size_t)max_smem &&
         copies <= GATHER_MAX * p.threads;
}

// Clusters of 16 blocks (half the columns a block of 8 would hold, for the
// same exchange), 8 only where the device cannot co-schedule 16. Rows per
// cluster: enough that the clusters which fit on the device at once cover
// B, rounded up to a whole product tile, and no more than a block's threads
// and shared memory hold. *ok is false when no cluster fits this H (the
// grid route's shapes).
template <typename T, bool TRAIN, int LAYERS>
int search_cluster_plan(int dev, int B, int H, ClusterPlan* out, bool* ok) {
  *ok = false;
  int max_smem;
  cudaError_t e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  for (int cs = 16; cs >= 8; cs /= 2) {
    int rmax = B;
    while (rmax > 0 && !fits(sized(cs, H, rmax, LAYERS), H, max_smem, LAYERS)) --rmax;
    if (rmax < 1) continue;
    ClusterPlan p = sized(cs, H, rmax, LAYERS);
    const int n =
        max_active_clusters(cluster_kernel<T, TRAIN, LAYERS>(p.rt), cs, p.threads, p.smem);
    if (n < 1) continue;
    p = sized(cs, H, std::min(rmax, sized(cs, H, (B + n - 1) / n, LAYERS).rp), LAYERS);
    p.clusters = (B + p.rows - 1) / p.rows;
    if (max_active_clusters(cluster_kernel<T, TRAIN, LAYERS>(p.rt), cs, p.threads, p.smem) < 1)
      continue;
    *out = p;
    *ok = true;
    return 0;
  }
  return 0;
}

// The plan of (device, B, H), searched once (cached_plan), with the kernel's
// attributes set for it on every call, since another shape's plan may
// have set smaller ones.
template <typename T, bool TRAIN, int LAYERS>
int plan_cluster(int B, int H, ClusterPlan* out, bool* ok) {
  const int e = cached_plan<search_cluster_plan<T, TRAIN, LAYERS>>(B, H, out, ok);
  if (e || !*ok) return e;
  return (int)cluster_attributes(cluster_kernel<T, TRAIN, LAYERS>(out->rt), out->cs, out->smem);
}

// Launch the cluster route of plan c.
template <typename T, bool TRAIN, int LAYERS>
int launch_cluster_route(const ClusterPlan& c, const FwdIO<T>& io, int Tn, int B, int H,
                         cudaStream_t stream) {
  return launch_clusters(cluster_kernel<T, TRAIN, LAYERS>(c.rt), c.cs, c.clusters, c.threads,
                         c.smem, stream, io, Tn, B, H, c.u, c.rows, c.rp);
}

}  // namespace lstm
