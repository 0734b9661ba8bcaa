// Two stacked LSTMs on a wavefront: inference mode (lstm2_fwd) and training
// mode (lstm2_fwd_train).
//
// Replaces: deeplearning4j_tpu/ops/lstm_pallas.py::_fwd2_kernel, reached
// through _fwd2_call (public entry fused_lstm2_sequence), with
// save_reserve=False and save_reserve=True. Computes the layer-2 hidden
// sequence hs2 (T, B, H) and the final h1T, c1T, c2T from gate_in1
// (T, B, 4H) = x @ W1 + b1 and the weights RW1, W2, b2, RW2:
// z1 = gate_in1_t + h1_{t-1} @ RW1, z2 = h1_t @ W2 + b2 + h2_{t-1} @ RW2.
// The training mode also writes both layers' reserve space --
// post-activation gates (T, B, 4H), tanh(c) and c_prev (T, B, H) -- and
// hs1 (T, B, H), the layer-1 hidden sequence the backward's weight and
// inter-layer products read. All of them are indexed by unshifted time:
// slot t of a layer-2 reserve belongs to layer-2 step t (what _fused2_fwd
// builds after its un-shift and epilogue, not the TPU kernel's shifted
// slots).
//
// The schedule: iteration s runs layer-1 step s and layer-2 step s - 1.
// Both read only h1_{s-1} and h2_{s-2}, which the previous iteration
// wrote, so one barrier per iteration serves both layers: T + 1 barriers
// instead of 2T. Iteration T runs layer 2 alone (no shifted streams and no
// epilogue outside the kernel); iteration 0 runs layer 1 alone, so layer
// 2's initial carry is kept without a mask.
//
// What bounds it on the card: a chain of T + 1 dependent iterations, each
// three (rows x H) x (H x 4H) products, the exchange of h between the
// blocks that share them and one barrier -- latency at the serving and
// training shapes, the float32 FMA work of the products at large B.
//
// Two routes, chosen by shape in the entry points below (never on an
// error):
//
// The cluster route (lstm2_fwd_cluster_kernel), wherever a block's columns
// of the three weights fit its shared memory (H up to 256 on an H100):
// clusters of cs = 16 blocks (8 where the device runs no 16-block
// cluster), each cluster owning `rows` batch rows, every block of it owning
// u = ceil(H / cs) hidden units of BOTH layers. A block keeps the 4u gate
// columns of RW1, W2 and RW2 for its units in shared memory (float32,
// which holds bfloat16 weights exactly) for the whole sequence, so it
// computes its own z1 and z2 columns entirely by itself: the exchange is
// an all-gather of h, not a reduce-scatter. After its cell updates a block
// writes its units of h1_s and h2_{s-1} (rounded to the stream dtype, as
// the products read them) into its own shared memory; after the cluster
// barrier every block reads the full rows x H of both from its peers
// (lstm_cluster.cuh: Slices, SliceGather) into k-major tiles. No grid
// barrier, no cooperative launch, no atomics, and batch rows in different
// clusters never meet, so clusters may run in waves. The products run as
// register tiles: 16 lanes share one unit and a tile of RT rows, each lane
// taking every 16th k, and hold RT rows x 4 gates of z1 and of z2, so each
// weight read from shared memory feeds 2 RT FMAs and each h value 4 or 8;
// the 16 lanes' sums are folded by shuffles in a fixed order (bitwise
// repeatable), leaving each lane the four gates of one (layer, row), whose
// cell it updates with c in a register (one path for both layers' cells,
// so a warp does not diverge on them). The weights are stored XOR-
// swizzled by k and the h tiles padded so that the 8 lanes of a 16-byte
// load phase hit distinct banks. The outputs (hs2, hs1, the reserves, the
// finals), which no block reads back, are stored between the barrier's
// arrive and its wait, so the arrive's release waits only on the slices;
// step s + 1's gate_in1 is loaded there too.
//
// The grid route (lstm2_fwd_grid_kernel) for hidden sizes whose columns do
// not fit (H past 256 on an H100): one persistent cooperative launch.
// Block (u, v) owns hidden units [u * hsz, u * hsz + hsz) of both layers
// and a slice of batch rows, keeps its columns of RW1, W2 and RW2 in shared
// memory, and after a grid barrier each iteration reads the full rows of
// h1_{s-1} and h2_{s-2} back through L2: h1 from a two-slot exchange buffer
// (training mode: the hs1 output, which it must write anyway), h2 from
// hs2. c1 and c2 stay with their owning thread, in registers (float32
// scratch when a block has more than one pass of rows).
#include <algorithm>

#include "lstm_cluster.cuh"
#include "lstm_common.cuh"

using namespace lstm;

// Reserve space of the training mode (unused, null, in inference mode).
template <typename T>
struct Reserve2 {
  T *hs1, *tc1, *cp1, *g1;  // layer 1: h, tanh(c), c_prev, gates
  T *tc2, *cp2, *g2;        // layer 2: tanh(c), c_prev, gates
};

// ---- the cluster route ------------------------------------------------------

constexpr int FT = 256;  // most threads of a cluster-route block
constexpr int KS = 16;   // lanes that split one product tile's contraction

// Shared-memory layout of a cluster-route block, in floats.
struct Fwd2Smem {
  int hp, ldw, ldh, ldx;
  size_t ht, x, total;  // offsets (the weights first), and the size

  __host__ __device__ Fwd2Smem(int H, int u, int rp) {
    hp = (H + KS - 1) / KS * KS;  // H padded to whole turns of the k split
    ldw = (u + 7) / 8 * 8;        // float4s (units) a weight row holds
    const int r4 = (rp + 3) / 4;
    ldx = 4 * r4;                 // a unit's rows in the exchange slices
    ldh = 4 * (r4 | 1);           // an odd number of float4s per tile row
    ht = (size_t)3 * hp * ldw * 4;
    x = ht + (size_t)2 * hp * ldh;
    total = x + Slices::floats(u, ldx, 2);
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

// Grid (cs, clusters), cluster (cs, 1, 1), rp / RT * u * KS threads rounded
// up to a warp. Block `me` of cluster blockIdx.y owns units [me * u, me * u
// + nj) of batch rows [r0, r0 + nrows); RT is the rows of a product tile
// (rows itself up to 8, else 8), rp the rows rounded up to it.
template <typename T, bool TRAIN, int RT>
__global__ void __launch_bounds__(FT, 1)
    lstm2_fwd_cluster_kernel(const T* __restrict__ gate_in1, const T* __restrict__ rw1,
                             const T* __restrict__ w2, const T* __restrict__ b2,
                             const T* __restrict__ rw2, const T* __restrict__ h01,
                             const T* __restrict__ c01, const T* __restrict__ h02,
                             const T* __restrict__ c02, T* hs2, T* h1T, T* c1T, T* c2T,
                             Reserve2<T> res, int Tn, int B, int H, int u, int rows, int rp) {
  extern __shared__ __align__(16) float smem[];
  const int me = (int)cluster_rank();
  const Fwd2Smem L(H, u, rp);
  const int G = 4 * H, hp = L.hp, ldw = L.ldw, ldh = L.ldh;
  const int j0 = me * u, nj = max(0, min(u, H - j0));
  const int r0 = blockIdx.y * rows, nrows = min(rows, B - r0);
  // w_s[(m * hp + k) * ldw + (jj ^ (k & 7))] = the four gates of unit
  // j0 + jj in row k of matrix m (RW1, W2, RW2); zero past nj and H
  float4* w_s = reinterpret_cast<float4*>(smem);
  // h_t[(l * hp + k) * ldh + r] = h of layer l (h1_{s-1}, h2_{s-2}) at
  // unit k of local row r, as the products read it; zero past H and nrows
  float* h_t = smem + L.ht;
  // this block's units of h1_s and h2_{s-1}, two halves by parity
  const Slices own{smem + L.x, u, L.ldx, 2};

  for (int idx = threadIdx.x; idx < 3 * hp * 4 * ldw; idx += blockDim.x) {
    const int jj = idx % ldw, g = (idx / ldw) % 4, k = (idx / (4 * ldw)) % hp,
              m = idx / (4 * ldw * hp);
    const T* src = m == 0 ? rw1 : m == 1 ? w2 : rw2;
    reinterpret_cast<float*>(w_s + ((size_t)m * hp + k) * ldw + (jj ^ (k & 7)))[g] =
        jj < nj && k < H ? to_f32(src[(size_t)k * G + g * H + j0 + jj]) : 0.f;
  }
  for (int idx = threadIdx.x; idx < 2 * hp * ldh; idx += blockDim.x) h_t[idx] = 0.f;
  for (int idx = threadIdx.x; idx < (int)Slices::floats(u, L.ldx, 2); idx += blockDim.x)
    own.base[idx] = 0.f;

  // the product tile of this thread: RT local rows from rt * RT, unit jj,
  // k = ks, ks + KS, ...; the fold lays its sums out for RP rows (RT
  // rounded up to a power of two, the rows past RT zero) and leaves the
  // gates of layer `layer` at local row lr, whose cell it owns (c in a
  // register)
  constexpr int RP = pow2ceil(RT), FOLDS = log2i(2 * RP), SPREAD = KS >> FOLDS;
  const int ks = threadIdx.x % KS, tile = threadIdx.x / KS;
  const bool tile_live = tile < rp / RT * u;
  const int rt = tile_live ? tile / u : 0, jj = tile_live ? tile % u : 0;
  const int q = ks / SPREAD, layer = q / RP, lr = rt * RT + q % RP;
  const bool owner =
      tile_live && ks % SPREAD == 0 && q % RP < RT && jj < nj && lr < nrows;
  const int r = r0 + lr, j = j0 + jj;
  const size_t ci = (size_t)r * H + j;
  // the cell's outputs: layer 1 writes step t = s of iteration s, layer 2
  // step t = s - 1; only the training mode has layer 1's h and the reserves
  T* const h_out = layer == 0 ? res.hs1 : hs2;
  T* const cp_out = layer == 0 ? res.cp1 : res.cp2;
  T* const tc_out = layer == 0 ? res.tc1 : res.tc2;
  T* const g_out = layer == 0 ? res.g1 : res.g2;
  float c = 0.f;
  // the gate inputs added to the product: gate_in1 of the step (layer 1),
  // b2 (layer 2)
  float4 zin = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();  // the slices are zero before the initial carries land
  if (owner) {
    if (layer == 0) {
      c = to_f32(c01[ci]);
      own.at(1, 0, jj)[lr] = to_f32(h01[ci]);
      zin = load_gates(gate_in1 + (size_t)r * G + j, H);
    } else {
      c = to_f32(c02[ci]);
      // h2_{-1}, read at iteration 1 (and, unused, at iteration 0)
      own.at(0, 1, jj)[lr] = own.at(1, 1, jj)[lr] = to_f32(h02[ci]);
      zin = load_gates(b2 + j, H);
    }
  }
  SliceGather gather;
  gather.init(own, H, hp, ldh);
  const int swz = jj ^ (ks & 7);  // k & 7 == ks & 7 for every k of this lane
  const float4* wp = w_s + (size_t)ks * ldw + swz;
  const float* ap = h_t + (size_t)ks * ldh + rt * RT;
  // every block of the cluster is running and has its initial slices in
  // place before any block reads another's shared memory
  cluster_sync();

  for (int s = 0; s <= Tn; ++s) {
    const int par = s & 1;
    gather.run(par ^ 1, h_t);  // h1_{s-1}, h2_{s-2}: written at s - 1
    __syncthreads();
    float acc[8 * RP];  // [layer][row][gate]
#pragma unroll
    for (int i = 0; i < 8 * RP; ++i) acc[i] = 0.f;
    // k steps in flight: 4 where a small tile is bound by the loads' latency
#pragma unroll(RT > 4 ? 2 : 4)
    for (int kk = 0; kk < hp; kk += KS) {
      float a[RT], b[RT];
      load_rows<RT>(ap + (size_t)kk * ldh, a);
      load_rows<RT>(ap + (size_t)(hp + kk) * ldh, b);
      const size_t o = (size_t)kk * ldw;
      const float4 x1 = wp[o], x2 = wp[(size_t)hp * ldw + o], x3 = wp[(size_t)2 * hp * ldw + o];
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
    fold<8 * RP, KS / 2>(acc, ks);

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
      if (TRAIN || layer == 1) h_out[at] = from_f32<T>(h);
      if (TRAIN) {
        cp_out[at] = from_f32<T>(cp);
        store_gates(g_out + ((size_t)t * B + r) * G + j, act, H);
        tc_out[at] = from_f32<T>(tc);
      }
      if (t == Tn - 1) {
        if (layer == 0) {
          h1T[ci] = from_f32<T>(h);
          c1T[ci] = from_f32<T>(c);
        } else {
          c2T[ci] = from_f32<T>(c);
        }
      }
    }
    // the next step's gate inputs load while the cluster gathers at the
    // barrier; the last wait also keeps every block's shared memory alive
    // until no peer reads it
    if (owner && layer == 0 && s + 1 < Tn)
      zin = load_gates(gate_in1 + ((size_t)(s + 1) * B + r) * G + j, H);
    cluster_wait();
  }
}

// The cluster route's plan: clusters of cs blocks, `rows` batch rows each,
// product tiles of rt rows (rp = rows rounded up to rt).
struct ClusterPlan {
  int cs, u, rows, rp, rt, threads, clusters;
  size_t smem;
};

template <typename T, bool TRAIN>
using ClusterKernel = decltype(&lstm2_fwd_cluster_kernel<T, TRAIN, 8>);

template <typename T, bool TRAIN>
static ClusterKernel<T, TRAIN> cluster_kernel(int rt) {
  switch (rt) {
    case 1: return lstm2_fwd_cluster_kernel<T, TRAIN, 1>;
    case 2: return lstm2_fwd_cluster_kernel<T, TRAIN, 2>;
    case 3: return lstm2_fwd_cluster_kernel<T, TRAIN, 3>;
    case 4: return lstm2_fwd_cluster_kernel<T, TRAIN, 4>;
    case 5: return lstm2_fwd_cluster_kernel<T, TRAIN, 5>;
    case 6: return lstm2_fwd_cluster_kernel<T, TRAIN, 6>;
    case 7: return lstm2_fwd_cluster_kernel<T, TRAIN, 7>;
    default: return lstm2_fwd_cluster_kernel<T, TRAIN, 8>;
  }
}

// The product tile for `rows` rows: all of them up to 8, else 8.
static int row_tile(int rows) { return rows < 8 ? rows : 8; }

// A plan of clusters of cs blocks owning `rows` rows each (clusters unset).
static ClusterPlan sized(int cs, int H, int rows) {
  ClusterPlan p{};
  p.cs = cs;
  p.u = (H + cs - 1) / cs;
  p.rows = rows;
  p.rt = row_tile(rows);
  p.rp = (rows + p.rt - 1) / p.rt * p.rt;
  p.threads = (p.rp / p.rt * p.u * KS + 31) / 32 * 32;
  p.smem = Fwd2Smem(H, p.u, p.rp).total * sizeof(float);
  return p;
}

// A plan the kernel takes: threads within FT, shared memory within the
// device's, and at most GATHER_MAX copies per thread in the all-gather.
static bool fits(const ClusterPlan& p, int H, int max_smem) {
  const int copies = 2 * H * Fwd2Smem(H, p.u, p.rp).ldx / 4;
  return p.threads <= FT && p.smem <= (size_t)max_smem &&
         copies <= GATHER_MAX * p.threads;
}

// Clusters of 16 blocks (half the columns a block of 8 would hold, for the
// same exchange), 8 only where the device cannot co-schedule 16. Rows per
// cluster: enough that the clusters which fit on the device at once cover
// B, rounded up to a whole product tile, and no more than a block's threads
// and shared memory hold. *ok is false when no cluster fits this H (the
// grid route's shapes).
template <typename T, bool TRAIN>
static int search_cluster_plan(int dev, int B, int H, ClusterPlan* out, bool* ok) {
  *ok = false;
  int max_smem;
  cudaError_t e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  for (int cs = 16; cs >= 8; cs /= 2) {
    int rmax = B;
    while (rmax > 0 && !fits(sized(cs, H, rmax), H, max_smem)) --rmax;
    if (rmax < 1) continue;
    ClusterPlan p = sized(cs, H, rmax);
    const int n = max_active_clusters(cluster_kernel<T, TRAIN>(p.rt), cs, p.threads, p.smem);
    if (n < 1) continue;
    p = sized(cs, H, std::min(rmax, sized(cs, H, (B + n - 1) / n).rp));
    p.clusters = (B + p.rows - 1) / p.rows;
    if (max_active_clusters(cluster_kernel<T, TRAIN>(p.rt), cs, p.threads, p.smem) < 1) continue;
    *out = p;
    *ok = true;
    return 0;
  }
  return 0;
}

// The plan of (device, B, H), searched once (cached_plan), with the kernel's
// attributes set for it on every call, since another shape's plan may
// have set smaller ones.
template <typename T, bool TRAIN>
static int plan_cluster(int B, int H, ClusterPlan* out, bool* ok) {
  const int e = cached_plan<search_cluster_plan<T, TRAIN>>(B, H, out, ok);
  if (e || !*ok) return e;
  return (int)cluster_attributes(cluster_kernel<T, TRAIN>(out->rt), out->cs, out->smem);
}

// ---- the grid route ---------------------------------------------------------

template <typename T, bool TRAIN>
__global__ void __launch_bounds__(MAX_THREADS)
    lstm2_fwd_grid_kernel(const T* __restrict__ gate_in1, const T* __restrict__ rw1,
                     const T* __restrict__ w2, const T* __restrict__ b2,
                     const T* __restrict__ rw2, const T* __restrict__ h01,
                     const T* __restrict__ c01, const T* __restrict__ h02,
                     const T* __restrict__ c02, T* hs2, T* h1T, T* c1T, T* c2T, T* h1buf,
                     float* c1_s, float* c2_s, Reserve2<T> res, int Tn, int B, int H,
                     int hsz, int kc) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int W4 = 4 * hsz, G = 4 * H;
  const size_t wsz = (size_t)H * W4;
  const int j0 = blockIdx.x * hsz, nj = min(hsz, H - j0);
  const int ld = tile_ld(kc);
  float* rw1_s = smem;                   // [H][hsz][4] each
  float* w2_s = smem + wsz;
  float* rw2_s = smem + 2 * wsz;
  float* h1_t = smem + 3 * wsz;          // [ROWS][ld] h1_{s-1}
  float* h2_t = h1_t + ROWS * ld;        // [ROWS][ld] h2_{s-2}
  load_weights(rw1_s, rw1, H, j0, hsz, nj);
  load_weights(w2_s, w2, H, j0, hsz, nj);
  load_weights(rw2_s, rw2, H, j0, hsz, nj);

  const int per = (B + gridDim.y - 1) / gridDim.y;
  const int r_begin = blockIdx.y * per, r_end = min(B, r_begin + per);
  const int j = threadIdx.x % hsz, rr = threadIdx.x / hsz;
  // a block whose rows fit one pass keeps each thread's c1, c2 in registers
  const bool one_pass = r_end - r_begin <= ROWS;
  float c1_reg = 0.f, c2_reg = 0.f;
  float bias[4] = {0.f, 0.f, 0.f, 0.f};
  if (j < nj) {
    for (int g = 0; g < 4; ++g) bias[g] = to_f32(b2[g * H + j0 + j]);
    for (int r = r_begin + rr; r < r_end; r += ROWS) {
      const size_t ci = (size_t)r * H + j0 + j;
      if (one_pass) {
        c1_reg = to_f32(c01[ci]);
        c2_reg = to_f32(c02[ci]);
      } else {
        c1_s[ci] = to_f32(c01[ci]);
        c2_s[ci] = to_f32(c02[ci]);
      }
    }
  }

  for (int s = 0; s <= Tn; ++s) {
    const bool do1 = s < Tn, do2 = s >= 1;
    const T* h1prev = s == 0 ? h01
                      : TRAIN ? res.hs1 + (size_t)(s - 1) * B * H
                              : h1buf + (size_t)((s - 1) & 1) * B * H;
    const T* h2prev = s <= 1 ? h02 : hs2 + (size_t)(s - 2) * B * H;
    for (int rc = r_begin; rc < r_end; rc += ROWS) {
      const int nrows = min(ROWS, r_end - rc);
      const int r = rc + rr;
      const bool live = r < r_end && j < nj;
      const size_t ci = (size_t)r * H + j0 + j;
      float4 gate = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && do1) gate = load_gates(gate_in1 + ((size_t)s * B + r) * G + j0 + j, H);
      float4 z1 = make_float4(0.f, 0.f, 0.f, 0.f), z2 = z1;
      for (int k0 = 0; k0 < H; k0 += kc) {
        const int kn = min(kc, H - k0);
        __syncthreads();
        stage(h1_t, h1prev, h2_t, do2 ? h2prev : (const T*)nullptr, rc, nrows, k0, kn, ld,
              H);
        __syncthreads();
        const float* a_row = h1_t + rr * ld;
        const float* b_row = h2_t + rr * ld;
        const size_t off = (size_t)k0 * W4 + 4 * j;
        const float *u = rw1_s + off, *w = w2_s + off, *v = rw2_s + off;
        int kk = 0;
        if (do1 && do2) {
          for (; kk + 4 <= kn; kk += 4) {
            const float4 a = ld4(a_row + kk), b = ld4(b_row + kk);
            const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const size_t o = (size_t)(kk + q) * W4;
              fma4(z1, av[q], ld4(u + o));
              fma4(z2, av[q], ld4(w + o));
              fma4(z2, bv[q], ld4(v + o));
            }
          }
        }
        for (; kk < kn; ++kk) {
          const size_t o = (size_t)kk * W4;
          if (do1) fma4(z1, a_row[kk], ld4(u + o));
          if (do2) {
            fma4(z2, a_row[kk], ld4(w + o));
            fma4(z2, b_row[kk], ld4(v + o));
          }
        }
      }
      if (live) {
        if (do1) {
          float c = one_pass ? c1_reg : c1_s[ci];
          const size_t at = ((size_t)s * B + r) * H + j0 + j;
          float h;
          if (TRAIN) {
            res.cp1[at] = from_f32<T>(c);
            float4 act;
            float tc;
            h = cell_train(gate.x + z1.x, gate.y + z1.y, gate.z + z1.z, gate.w + z1.w, c,
                           act, tc);
            store_gates(res.g1 + ((size_t)s * B + r) * G + j0 + j, act, H);
            res.tc1[at] = from_f32<T>(tc);
            res.hs1[at] = from_f32<T>(h);
          } else {
            h = cell(gate.x + z1.x, gate.y + z1.y, gate.z + z1.z, gate.w + z1.w, c);
            h1buf[(size_t)(s & 1) * B * H + ci] = from_f32<T>(h);
          }
          if (one_pass) c1_reg = c;
          else c1_s[ci] = c;
          if (s == Tn - 1) {
            h1T[ci] = from_f32<T>(h);
            c1T[ci] = from_f32<T>(c);
          }
        }
        if (do2) {
          float c = one_pass ? c2_reg : c2_s[ci];
          const size_t at = ((size_t)(s - 1) * B + r) * H + j0 + j;
          float h;
          if (TRAIN) {
            res.cp2[at] = from_f32<T>(c);
            float4 act;
            float tc;
            h = cell_train(z2.x + bias[0], z2.y + bias[1], z2.z + bias[2], z2.w + bias[3], c,
                           act, tc);
            store_gates(res.g2 + ((size_t)(s - 1) * B + r) * G + j0 + j, act, H);
            res.tc2[at] = from_f32<T>(tc);
          } else {
            h = cell(z2.x + bias[0], z2.y + bias[1], z2.z + bias[2], z2.w + bias[3], c);
          }
          if (one_pass) c2_reg = c;
          else c2_s[ci] = c;
          hs2[at] = from_f32<T>(h);
          if (s == Tn) c2T[ci] = from_f32<T>(c);
        }
      }
    }
    if (s < Tn) grid.sync();
  }
}

// ---- the entry points -------------------------------------------------------

// plan_out: route (1 cluster, 0 grid), cluster size, clusters, batch rows
// per cluster (per batch block on the grid route), units per block, blocks
// across the units, blocks across the batch, threads, k slice (grid route),
// shared bytes.
enum { PLAN_LEN = 10 };

template <typename T, bool TRAIN>
static int launch(void* const* in, void* const* out, void* const* reserve, void* h1buf,
                  void* c1_s, void* c2_s, int Tn, int B, int H, cudaStream_t stream,
                  int* plan_out) {
  const T *gi = (const T*)in[0], *rw1 = (const T*)in[1], *w2 = (const T*)in[2],
          *b2 = (const T*)in[3], *rw2 = (const T*)in[4], *h01 = (const T*)in[5],
          *c01 = (const T*)in[6], *h02 = (const T*)in[7], *c02 = (const T*)in[8];
  T *hs2 = (T*)out[0], *h1T = (T*)out[1], *c1T = (T*)out[2], *c2T = (T*)out[3];
  Reserve2<T> res{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  if (TRAIN)
    res = Reserve2<T>{(T*)reserve[0], (T*)reserve[1], (T*)reserve[2], (T*)reserve[3],
                      (T*)reserve[4], (T*)reserve[5], (T*)reserve[6]};
  ClusterPlan c;
  bool ok;
  int e = plan_cluster<T, TRAIN>(B, H, &c, &ok);
  if (e) return e;
  if (ok) {
    if (plan_out) {
      const int v[PLAN_LEN] = {1, c.cs, c.clusters, c.rows, c.u, c.cs, c.clusters, c.threads, 0,
                               (int)c.smem};
      for (int k = 0; k < PLAN_LEN; ++k) plan_out[k] = v[k];
    }
    return launch_clusters(cluster_kernel<T, TRAIN>(c.rt), c.cs, c.clusters, c.threads, c.smem,
                           stream, gi, rw1, w2, b2, rw2, h01, c01, h02, c02, hs2, h1T, c1T, c2T,
                           res, Tn, B, H, c.u, c.rows, c.rp);
  }
  const void* fn = (const void*)lstm2_fwd_grid_kernel<T, TRAIN>;
  Plan p;
  e = make_plan(fn, B, H, H, 3, 2, false, &p);
  if (e) return e;
  if (plan_out) {
    const int v[PLAN_LEN] = {0,     0,    0,     (B + p.nbb - 1) / p.nbb,
                             p.hsz, p.nu, p.nbb, p.threads,
                             p.kc,  (int)p.smem};
    for (int k = 0; k < PLAN_LEN; ++k) plan_out[k] = v[k];
  }
  T* hb = (T*)h1buf;
  float *c1 = (float*)c1_s, *c2 = (float*)c2_s;
  int hsz = p.hsz, kc = p.kc;
  void* args[] = {&gi,  &rw1, &w2, &b2, &rw2, &h01, &c01, &h02, &c02, &hs2, &h1T, &c1T,
                  &c2T, &hb,  &c1, &c2, &res, &Tn,  &B,   &H,   &hsz, &kc};
  cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(p.nu, p.nbb), dim3(p.threads), args,
                                                p.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool TRAIN>
static int dispatch(void* const* in, void* const* out, void* const* reserve, void* h1buf,
                    void* c1_s, void* c2_s, int T, int B, int H, int dtype, int device,
                    void* stream, int* plan_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32)
    return launch<float, TRAIN>(in, out, reserve, h1buf, c1_s, c2_s, T, B, H, s, plan_out);
  if (dtype == BF16)
    return launch<__nv_bfloat16, TRAIN>(in, out, reserve, h1buf, c1_s, c2_s, T, B, H, s,
                                        plan_out);
  return ERR_DTYPE;
}

// in: gate_in1, rw1, w2, b2, rw2, h01, c01, h02, c02 (9 device pointers);
// out: hs2, h1T, c1T, c2T. Scratch, used by the grid route: h1buf (2, B, H)
// in the stream dtype, c1/c2 (B, H) float32. The route is the cluster one
// wherever a cluster plan fits this H, else the grid one. Returns 0, a
// cudaError_t, or a negative lstm::Err; plan_out (PLAN_LEN ints) as above.
extern "C" int lstm2_fwd(void* const* in, void* const* out, void* h1buf, void* c1_scratch,
                         void* c2_scratch, int T, int B, int H, int dtype, int device,
                         void* stream, int* plan_out) {
  return dispatch<false>(in, out, nullptr, h1buf, c1_scratch, c2_scratch, T, B, H, dtype,
                         device, stream, plan_out);
}

// As lstm2_fwd, plus the reserve space: reserve holds 7 device pointers in
// the stream dtype, hs1, tc1, cp1 (T, B, H), g1 (T, B, 4H), tc2, cp2
// (T, B, H), g2 (T, B, 4H). On the grid route hs1 is also the layer-1
// exchange buffer, so there is no h1buf.
extern "C" int lstm2_fwd_train(void* const* in, void* const* out, void* const* reserve,
                               void* c1_scratch, void* c2_scratch, int T, int B, int H,
                               int dtype, int device, void* stream, int* plan_out) {
  return dispatch<true>(in, out, reserve, nullptr, c1_scratch, c2_scratch, T, B, H, dtype,
                        device, stream, plan_out);
}

extern "C" const char* lstm_error(int code) { return error_text(code); }
