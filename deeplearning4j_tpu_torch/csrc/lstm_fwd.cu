// Single-layer LSTM forward over precomputed gate inputs: inference mode
// (lstm_fwd) and training mode (lstm_fwd_train).
//
// Replaces: deeplearning4j_tpu/ops/lstm_pallas.py::_fwd_inference_kernel,
// reached through _fwd_call(save_reserve=False) (public entry
// fused_lstm_sequence), and ::_fwd_kernel, reached through
// _fwd_call(save_reserve=True) (the training forward of the custom VJP).
// Computes hs (T, B, H) and the final cell state cT (B, H) from gate_in
// (T, B, 4H) = x @ W + b, RW (H, 4H), h0, c0. The training mode also writes
// the reserve space the backward (lstm_bwd.cu) reads: the post-activation
// gates (T, B, 4H), tanh(c) (T, B, H) and c_prev (T, B, H), in the stream
// dtype.
//
// What bounds it on the card: the time loop is a chain of T dependent
// steps, each a small (B, H) x (H, 4H) product, the exchange of h between
// the blocks that share it and one barrier, so at serving and training
// shapes it is bound by per-step latency, not by bytes or operations. At
// large B the float32 FMA work of the product dominates; the training mode
// adds 6H stream writes per row and step, which overlap the next step.
//
// Two routes, chosen by shape in the entry points below (never on an
// error):
//
// The cluster route (lstm_fwd_cluster.cuh, one layer), wherever a block's
// columns of RW fit its shared memory (H up to 432 on an H100): clusters of
// 16 blocks (8 where the device runs no 16-block cluster; 16 was the faster
// at both main-path shapes on an H100), each owning u = ceil(H / cs) units,
// their 4u columns of RW in shared memory and the cells of those units;
// after one cluster barrier a step every block reads the full rows of
// h_{t-1} from its peers' shared memory (an all-gather through distributed
// shared memory). No grid barrier, no cooperative launch, no atomics:
// bitwise repeatable.
//
// The grid route (lstm_fwd_grid_kernel) past it: ONE persistent
// cooperative launch runs all T steps (the TPU kernel's sequential grid
// becomes a loop inside the kernel). Block (u, v) owns hidden units
// [u * hsz, u * hsz + hsz) -- all four gate columns of each, so the cell
// math stays inside the block -- and a contiguous slice of batch rows. Its
// columns of RW live in shared memory for the whole sequence. h_t is
// written straight into the hs output, which doubles as the exchange
// buffer: after a grid barrier every block reads the h_{t-1} rows it needs
// from L2. c never leaves its owner: it is kept in a register (or, when a
// block has more than one pass of rows, a float32 scratch row only that
// thread touches). The reserve writes are the owner thread's own values,
// so they need no exchange.
#include "lstm_common.cuh"
#include "lstm_fwd_cluster.cuh"

using namespace lstm;

// Reserve space of the training mode (unused, null, in inference mode).
template <typename T>
struct Reserve {
  T* gates;  // (T, B, 4H) post-activation i, f, o, g
  T* tc;     // (T, B, H) tanh(c_t)
  T* cprev;  // (T, B, H) c_{t-1}
};

// ---- the grid route ---------------------------------------------------------

template <typename T, bool TRAIN>
__global__ void __launch_bounds__(MAX_THREADS)
    lstm_fwd_grid_kernel(const T* __restrict__ gate_in, const T* __restrict__ rw,
                         const T* __restrict__ h0, const T* __restrict__ c0, T* hs, T* cT,
                         float* c_s, Reserve<T> res, int Tn, int B, int H, int hsz,
                         int kc) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int W4 = 4 * hsz, G = 4 * H;
  const int j0 = blockIdx.x * hsz, nj = min(hsz, H - j0);
  const int ld = tile_ld(kc);
  float* w_s = smem;                   // [H][hsz][4]
  float* h_s = smem + (size_t)H * W4;  // [ROWS][ld]
  load_weights(w_s, rw, H, j0, hsz, nj);

  const int per = (B + gridDim.y - 1) / gridDim.y;
  const int r_begin = blockIdx.y * per, r_end = min(B, r_begin + per);
  const int j = threadIdx.x % hsz, rr = threadIdx.x / hsz;
  // a block whose rows fit one pass keeps each thread's c in a register
  const bool one_pass = r_end - r_begin <= ROWS;
  float c_reg = 0.f;
  if (j < nj)
    for (int r = r_begin + rr; r < r_end; r += ROWS) {
      const float c = to_f32(c0[(size_t)r * H + j0 + j]);
      if (one_pass) c_reg = c;
      else c_s[(size_t)r * H + j0 + j] = c;
    }

  for (int t = 0; t < Tn; ++t) {
    const T* hprev = t == 0 ? h0 : hs + (size_t)(t - 1) * B * H;
    for (int rc = r_begin; rc < r_end; rc += ROWS) {
      const int nrows = min(ROWS, r_end - rc);
      const int r = rc + rr;
      const bool live = r < r_end && j < nj;
      const size_t ci = (size_t)r * H + j0 + j;
      float4 gate = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) gate = load_gates(gate_in + ((size_t)t * B + r) * G + j0 + j, H);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k0 = 0; k0 < H; k0 += kc) {
        const int kn = min(kc, H - k0);
        __syncthreads();
        stage(h_s, hprev, (float*)nullptr, (const T*)nullptr, rc, nrows, k0, kn, ld, H);
        __syncthreads();
        const float* hrow = h_s + rr * ld;
        const float* w = w_s + (size_t)k0 * W4 + 4 * j;
        int kk = 0;
        for (; kk + 4 <= kn; kk += 4) {
          const float4 a = ld4(hrow + kk);
          fma4(acc, a.x, ld4(w + (kk + 0) * W4));
          fma4(acc, a.y, ld4(w + (kk + 1) * W4));
          fma4(acc, a.z, ld4(w + (kk + 2) * W4));
          fma4(acc, a.w, ld4(w + (kk + 3) * W4));
        }
        for (; kk < kn; ++kk) fma4(acc, hrow[kk], ld4(w + kk * W4));
      }
      if (live) {
        float c = one_pass ? c_reg : c_s[ci];
        const size_t at = ((size_t)t * B + r) * H + j0 + j;
        float h;
        if (TRAIN) {
          res.cprev[at] = from_f32<T>(c);
          float4 act;
          float tc;
          h = cell_train(gate.x + acc.x, gate.y + acc.y, gate.z + acc.z, gate.w + acc.w, c,
                         act, tc);
          store_gates(res.gates + ((size_t)t * B + r) * G + j0 + j, act, H);
          res.tc[at] = from_f32<T>(tc);
        } else {
          h = cell(gate.x + acc.x, gate.y + acc.y, gate.z + acc.z, gate.w + acc.w, c);
        }
        if (one_pass) c_reg = c;
        else c_s[ci] = c;
        hs[at] = from_f32<T>(h);
        if (t == Tn - 1) cT[ci] = from_f32<T>(c);
      }
    }
    if (t + 1 < Tn) grid.sync();
  }
}

// ---- the entry points -------------------------------------------------------

// The route a launch at (B, H) takes: the cluster plan wherever one fits
// (*cluster, c), else the grid plan (p); ERR_NO_PLAN where neither fits.
// The launch and the plan query (lstm_fwd_plan) both ask it, so the query
// answers what the launch would do. Reports the plan in plan_out.
template <typename T, bool TRAIN>
static int choose_route(int B, int H, bool* cluster, ClusterPlan* c, Plan* p, int* plan_out) {
  int e = plan_cluster<T, TRAIN, 1>(B, H, c, cluster);
  if (e) return e;
  if (*cluster) {
    report_cluster_plan(plan_out, c->cs, c->clusters, c->rows, c->u, c->threads, c->smem);
    return 0;
  }
  e = make_plan((const void*)lstm_fwd_grid_kernel<T, TRAIN>, B, H, H, 1, 1, false, p);
  if (e == 0) report_grid_plan(plan_out, *p, B);
  return e;
}

template <typename T, bool TRAIN>
static int launch(const void* gate_in, const void* rw, const void* h0, const void* c0,
                  void* hs, void* cT, void* c_s, void* const* reserve, int Tn, int B, int H,
                  cudaStream_t stream, int* plan_out) {
  const T* a_gi = (const T*)gate_in;
  const T* a_rw = (const T*)rw;
  const T* a_h0 = (const T*)h0;
  const T* a_c0 = (const T*)c0;
  T* a_hs = (T*)hs;
  T* a_cT = (T*)cT;
  Reserve<T> res{nullptr, nullptr, nullptr};
  if (TRAIN) res = Reserve<T>{(T*)reserve[0], (T*)reserve[1], (T*)reserve[2]};
  ClusterPlan c;
  Plan p;
  bool cluster;
  const int e = choose_route<T, TRAIN>(B, H, &cluster, &c, &p, plan_out);
  if (e) return e;
  if (cluster) {
    FwdIO<T> io{};
    io.gate_in = a_gi;
    io.rw1 = a_rw;
    io.h0[0] = a_h0;
    io.c0[0] = a_c0;
    io.hs = a_hs;
    io.cT[0] = a_cT;
    io.g[0] = res.gates;
    io.tc[0] = res.tc;
    io.cp[0] = res.cprev;
    return launch_cluster_route<T, TRAIN, 1>(c, io, Tn, B, H, stream);
  }
  const void* fn = (const void*)lstm_fwd_grid_kernel<T, TRAIN>;
  float* a_cs = (float*)c_s;
  int hsz = p.hsz, kc = p.kc;
  void* args[] = {&a_gi, &a_rw, &a_h0, &a_c0, &a_hs, &a_cT, &a_cs, &res,
                  &Tn,   &B,    &H,    &hsz,  &kc};
  cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(p.nu, p.nbb), dim3(p.threads), args,
                                                p.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool TRAIN>
static int dispatch(const void* gate_in, const void* rw, const void* h0, const void* c0,
                    void* hs, void* cT, void* c_s, void* const* reserve, int T, int B, int H,
                    int dtype, int device, void* stream, int* plan_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32)
    return launch<float, TRAIN>(gate_in, rw, h0, c0, hs, cT, c_s, reserve, T, B, H, s,
                                plan_out);
  if (dtype == BF16)
    return launch<__nv_bfloat16, TRAIN>(gate_in, rw, h0, c0, hs, cT, c_s, reserve, T, B, H,
                                        s, plan_out);
  return ERR_DTYPE;
}

// c_scratch: (B, H) float32, used by the grid route. The route is the
// cluster one wherever a cluster plan fits this H, else the grid one.
// Returns 0, a cudaError_t, or a negative lstm::Err; plan_out as
// lstm_common.cuh gives it.
extern "C" int lstm_fwd(const void* gate_in, const void* rw, const void* h0, const void* c0,
                        void* hs, void* cT, void* c_scratch, int T, int B, int H, int dtype,
                        int device, void* stream, int* plan_out) {
  return dispatch<false>(gate_in, rw, h0, c0, hs, cT, c_scratch, nullptr, T, B, H, dtype,
                         device, stream, plan_out);
}

// As lstm_fwd, plus the reserve space: reserve holds 3 device pointers,
// gates (T, B, 4H), tanh(c) (T, B, H) and c_prev (T, B, H), all in the
// stream dtype.
extern "C" int lstm_fwd_train(const void* gate_in, const void* rw, const void* h0,
                              const void* c0, void* hs, void* cT, void* c_scratch,
                              void* const* reserve, int T, int B, int H, int dtype, int device,
                              void* stream, int* plan_out) {
  return dispatch<true>(gate_in, rw, h0, c0, hs, cT, c_scratch, reserve, T, B, H, dtype,
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

// The plan lstm_fwd (train 0) or lstm_fwd_train (train 1) would launch at
// (B, H) in this dtype, any T: 0 with plan_out filled, ERR_NO_PLAN where no
// route fits, or another error. Launches nothing.
extern "C" int lstm_fwd_plan(int train, int B, int H, int dtype, int device, int* plan_out) {
  return train ? query<true>(B, H, dtype, device, plan_out)
               : query<false>(B, H, dtype, device, plan_out);
}

extern "C" const char* lstm_error(int code) { return error_text(code); }
