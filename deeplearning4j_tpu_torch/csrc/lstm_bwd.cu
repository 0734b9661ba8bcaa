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
// bfloat16 before that product (it is read back from the bfloat16 dz
// output) and the sum stays float32, as in the TPU kernel. The weight
// gradients stay batched GEMMs outside the kernel.
//
// What bounds it on the card: like the forward, a chain of T dependent
// steps with a grid barrier each, so per-step latency at small batch; at
// large batch the f32 FMA work of the (B, 4H) x (4H, H) product per step.
//
// Design: ONE persistent cooperative launch runs the reverse time loop.
// Block (u, v) owns hidden units [j0, j0 + hsz) and a slice of batch rows,
// and keeps the ROWS RW[j0 : j0 + hsz, :] (hsz x 4H, the same bytes as the
// forward's column slice) in shared memory as float32. Each step it reads
// the full dz_{t+1} rows of its batch rows from the dz output, which
// doubles as the exchange buffer (after the barrier that follows their
// writing, through L2 with ld.global.cg), in slices of the 4H contraction.
// dc never leaves the thread that owns it (a register, or a float32
// scratch row when a block has more than one pass of rows). One extra
// product after step 0 gives dh0 = dz_0 @ RW^T.
#include "lstm_common.cuh"

using namespace lstm;

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

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    lstm_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ tcs,
                    const T* __restrict__ cprev, const T* __restrict__ rw,
                    const T* __restrict__ dhs, const T* __restrict__ dcT, T* dz, float* dh0,
                    float* dc0, float* dc_s, int Tn, int B, int H, int hsz, int kc) {
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

template <typename T>
static int launch(void* const* in, void* const* out, void* dc_s, int Tn, int B, int H,
                  cudaStream_t stream, int* plan_out) {
  const void* fn = (const void*)lstm_bwd_kernel<T>;
  Plan p;
  int e = make_plan(fn, B, H, 4 * H, 1, 1, true, &p);
  if (e) return e;
  report_plan(p, plan_out);
  const T *gates = (const T*)in[0], *tcs = (const T*)in[1], *cprev = (const T*)in[2],
          *rw = (const T*)in[3], *dhs = (const T*)in[4], *dcT = (const T*)in[5];
  T* dz = (T*)out[0];
  float *dh0 = (float*)out[1], *dc0 = (float*)out[2], *dcs = (float*)dc_s;
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
// dtype, dh0 and dc0 (B, H) float32. Scratch: dc (B, H) float32. Returns 0,
// a cudaError_t, or a negative lstm::Err; plan_out as in lstm_fwd.
extern "C" int lstm_bwd(void* const* in, void* const* out, void* dc_scratch, int T, int B,
                        int H, int dtype, int device, void* stream, int* plan_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32) return launch<float>(in, out, dc_scratch, T, B, H, s, plan_out);
  if (dtype == BF16)
    return launch<__nv_bfloat16>(in, out, dc_scratch, T, B, H, s, plan_out);
  return ERR_DTYPE;
}

extern "C" const char* lstm_error(int code) { return error_text(code); }
