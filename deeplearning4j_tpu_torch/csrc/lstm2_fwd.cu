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
// The cluster route (lstm_fwd_cluster.cuh, two layers), wherever a block's
// columns of the three weights fit its shared memory (H up to 256 on an
// H100): clusters of 16 blocks (8 where the device runs no 16-block
// cluster), every block owning u = ceil(H / cs) hidden units of BOTH layers
// and the 4u gate columns of RW1, W2 and RW2 for them, so it computes its
// own z1 and z2 columns by itself; after one cluster barrier an iteration
// every block reads the full rows of h1_{s-1} and h2_{s-2} from its peers'
// shared memory (an all-gather through distributed shared memory). No grid
// barrier, no cooperative launch, no atomics: bitwise repeatable.
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
#include "lstm_common.cuh"
#include "lstm_fwd_cluster.cuh"

using namespace lstm;

// Reserve space of the training mode (unused, null, in inference mode).
template <typename T>
struct Reserve2 {
  T *hs1, *tc1, *cp1, *g1;  // layer 1: h, tanh(c), c_prev, gates
  T *tc2, *cp2, *g2;        // layer 2: tanh(c), c_prev, gates
};

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

// The route a launch at (B, H) takes: the cluster plan wherever one fits
// (*cluster, c), else the grid plan (p); ERR_NO_PLAN where neither fits.
// The launch and the plan query (lstm2_fwd_plan) both ask it, so the query
// answers what the launch would do. Reports the plan in plan_out.
template <typename T, bool TRAIN>
static int choose_route(int B, int H, bool* cluster, ClusterPlan* c, Plan* p, int* plan_out) {
  int e = plan_cluster<T, TRAIN, 2>(B, H, c, cluster);
  if (e) return e;
  if (*cluster) {
    report_cluster_plan(plan_out, c->cs, c->clusters, c->rows, c->u, c->threads, c->smem);
    return 0;
  }
  e = make_plan((const void*)lstm2_fwd_grid_kernel<T, TRAIN>, B, H, H, 3, 2, false, p);
  if (e == 0) report_grid_plan(plan_out, *p, B);
  return e;
}

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
  Plan p;
  bool cluster;
  const int e = choose_route<T, TRAIN>(B, H, &cluster, &c, &p, plan_out);
  if (e) return e;
  if (cluster) {
    const FwdIO<T> io{gi,  rw1, w2,         b2,
                      rw2, {h01, h02}, {c01, c02}, hs2,
                      h1T, {c1T, c2T}, {res.g1, res.g2}, {res.tc1, res.tc2},
                      {res.cp1, res.cp2}, res.hs1};
    return launch_cluster_route<T, TRAIN, 2>(c, io, Tn, B, H, stream);
  }
  const void* fn = (const void*)lstm2_fwd_grid_kernel<T, TRAIN>;
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
// cudaError_t, or a negative lstm::Err; plan_out as lstm_common.cuh gives
// it.
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

template <bool TRAIN>
static int query(int B, int H, int dtype, int device, int* plan_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  ClusterPlan c;
  Plan p;
  bool cluster;
  if (dtype == F32) return choose_route<float, TRAIN>(B, H, &cluster, &c, &p, plan_out);
  if (dtype == BF16) return choose_route<__nv_bfloat16, TRAIN>(B, H, &cluster, &c, &p, plan_out);
  return ERR_DTYPE;
}

// The plan lstm2_fwd (train 0) or lstm2_fwd_train (train 1) would launch
// at (B, H) in this dtype, any T: 0 with plan_out filled, ERR_NO_PLAN where
// no route fits, or another error. Launches nothing.
extern "C" int lstm2_fwd_plan(int train, int B, int H, int dtype, int device, int* plan_out) {
  return train ? query<true>(B, H, dtype, device, plan_out)
               : query<false>(B, H, dtype, device, plan_out);
}

extern "C" const char* lstm_error(int code) { return error_text(code); }
