// The fused Euler cell on Hopper (sm_90a): one Euler step of the ODEFunc
// for every row and every stacked network k, in one launch,
//
//     pre = inp W1 + b1                          (stored for the backward)
//     out = h + dt (act(pre) W2 + b2)            (dt per row)
//
// Replaces the TPU kernel njode_tpu/ops/fused_cell.py:_kernel (line 73),
// which the JAX package launches once per network on lane-padded tiles; the
// port takes logical shapes (no 128-lane padding) and all K networks in one
// grid.  inp = [s(h), s(x), t_rel, t_elapsed] is built by the wrapper.  The
// backward is plain PyTorch in the wrapper, as the JAX package leaves it to
// XLA (fused_cell.py:137-156).
//
// What bounds it on the H100: at the shapes of its path (1,152 rows, d_in
// 35, d 32) the call is tiny, 2 (d_in + d) d flops and (d_in + 3 d + 1)
// floats of device memory a row: launch latency and the dependent chain of
// the two products.  What the design does: a warp owns 4 rows and shares
// each weight load among them; the tile's inputs and hidden activations sit
// in shared memory, and the weights too when they fit in 100 KB; wider d
// loops over 32 CPT-column chunks, so any width runs.
//
// Layout (f32, contiguous): inp (K, R, d_in); h, out, pre (K, R, d); dt
// (R,); w1 (K, d_in, d) and w2 (K, d, d) as (in, out); b1, b2 (K, d).

#include <cuda_runtime.h>
#include <stddef.h>

#include "gap_cell.cuh"

namespace {

using namespace njode_gap;

constexpr int kWarps = 4;
constexpr int kRPW = 4;
constexpr int kTile = kWarps * kRPW;
constexpr size_t kStageBytes = 100 * 1024;

template <int CPT, bool STAGE>
__global__ void __launch_bounds__(kWarp * kWarps)
fused_cell_kernel(const float* __restrict__ inp, const float* __restrict__ h,
                  const float* __restrict__ dt, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out,
                  float* __restrict__ pre_out, int R, int d_in, int d, int act) {
  constexpr int LOAD = STAGE ? kLoadPlain : kLoadNc;
  extern __shared__ float smem[];
  const int k = blockIdx.y, lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kWarp + lane, n_threads = kWarp * blockDim.y;
  const int row0 = blockIdx.x * kTile;
  const float* W1 = w1 + (size_t)k * d_in * d;
  const float* W2 = w2 + (size_t)k * d * d;
  float* rows = smem;
  if constexpr (STAGE) {
    for (int e = tid; e < d_in * d; e += n_threads) smem[e] = W1[e];
    for (int e = tid; e < d * d; e += n_threads) smem[(size_t)d_in * d + e] = W2[e];
    W1 = smem;
    W2 = smem + (size_t)d_in * d;
    rows = smem + (size_t)(d_in + d) * d;
  }
  float* s_in = rows;                      // kTile x d_in
  float* s_hid = s_in + kTile * d_in;      // kTile x d
  const int n_valid = min(kTile, R - row0) * d_in;
  const size_t in0 = ((size_t)k * R + row0) * d_in;
  for (int e = tid; e < kTile * d_in; e += n_threads)
    s_in[e] = e < n_valid ? inp[in0 + e] : 0.0f;
  __syncthreads();

  const int r_w = warp * kRPW;
  const float* my_in = s_in + r_w * d_in;
  float* my_hid = s_hid + r_w * d;
  const float* b1_k = b1 + (size_t)k * d;
  const float* b2_k = b2 + (size_t)k * d;
  float acc[kRPW][CPT];
  for (int c0 = 0; c0 < d; c0 += kWarp * CPT) {
    rows_mm_rect<CPT, kRPW, LOAD>(my_in, d_in, kRPW, d_in, W1, d, c0, d, lane, acc);
#pragma unroll
    for (int q = 0; q < kRPW; ++q) {
      const int row = row0 + r_w + q;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = c0 + lane + kWarp * c;
        if (j < d) {
          const float p = acc[q][c] + __ldg(b1_k + j);
          my_hid[q * d + j] = activate(p, act);
          if (row < R) pre_out[((size_t)k * R + row) * d + j] = p;
        }
      }
    }
  }
  __syncwarp();
  for (int c0 = 0; c0 < d; c0 += kWarp * CPT) {
    rows_mm_rect<CPT, kRPW, LOAD>(my_hid, d, kRPW, d, W2, d, c0, d, lane, acc);
#pragma unroll
    for (int q = 0; q < kRPW; ++q) {
      const int row = row0 + r_w + q;
      if (row >= R) continue;
      const float dt_r = __ldg(dt + row);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = c0 + lane + kWarp * c;
        if (j < d) {
          const size_t o = ((size_t)k * R + row) * d + j;
          out[o] = fmaf(dt_r, acc[q][c] + __ldg(b2_k + j), __ldg(h + o));
        }
      }
    }
  }
}

}  // namespace

// One launch on `stream` for all K networks; returns cudaGetLastError()
// (0 on success).
extern "C" int njode_fused_cell(const void* inp, const void* h, const void* dt,
                                const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, void* pre, int K, int R,
                                int d_in, int d, int act, void* stream) {
  if (K < 1 || K > 65535 || R < 1 || d_in < 1 || d < 1 || act < 0 || act > kSelu)
    return (int)cudaErrorInvalidValue;
  int max_smem = 0;
  int err = max_smem_optin(&max_smem);
  if (err != 0) return err;
  // columns per lane: the power of two covering d in one chunk, at most 8
  const int chunks = (d + kWarp - 1) / kWarp;
  int cpt = 1;
  while (cpt < chunks && cpt < 8) cpt *= 2;
  const size_t rows_b = (size_t)kTile * (d_in + d) * sizeof(float);
  const size_t w_bytes = (size_t)(d_in + d) * d * sizeof(float);
  if (rows_b > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const bool stage = rows_b + w_bytes <= kStageBytes;
  const size_t smem = rows_b + (stage ? w_bytes : 0);
  const dim3 grid((R + kTile - 1) / kTile, K), block(kWarp, kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *f_in = static_cast<const float*>(inp), *f_h = static_cast<const float*>(h),
              *f_dt = static_cast<const float*>(dt), *f_w1 = static_cast<const float*>(w1),
              *f_b1 = static_cast<const float*>(b1), *f_w2 = static_cast<const float*>(w2),
              *f_b2 = static_cast<const float*>(b2);
  float *f_out = static_cast<float*>(out), *f_pre = static_cast<float*>(pre);
  cudaError_t e = cudaSuccess;
#define NJODE_CELL(C, STG)                                                               \
  {                                                                                      \
    auto kern = fused_cell_kernel<C, STG>;                                               \
    e = set_smem(kern, smem);                                                            \
    if (e == cudaSuccess)                                                                \
      kern<<<grid, block, smem, s>>>(f_in, f_h, f_dt, f_w1, f_b1, f_w2, f_b2, f_out,     \
                                     f_pre, R, d_in, d, act);                            \
  }
#define NJODE_CELL_CPT(STG)              \
  switch (cpt) {                         \
    case 1: NJODE_CELL(1, STG) break;    \
    case 2: NJODE_CELL(2, STG) break;    \
    case 4: NJODE_CELL(4, STG) break;    \
    default: NJODE_CELL(8, STG) break;   \
  }
  if (stage) {
    NJODE_CELL_CPT(true)
  } else {
    NJODE_CELL_CPT(false)
  }
#undef NJODE_CELL_CPT
#undef NJODE_CELL
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* njode_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
