// Device helpers of the gap-loop training kernels (gap_train.cu) and the
// fused Euler cell (fused_cell.cu): one predicated Euler substep of a
// warp's rows, and a warp's rows times a rectangular matrix.  The
// activations, scalings and square products come from walk_cell.cuh.
//
// The substep is written with explicit fmaf, so the forward kernel and the
// backward kernel's recompute of a checkpointed segment (two code sites)
// produce the same bits.

#pragma once

#include "walk_cell.cuh"

namespace njode_gap {

using namespace njode_walk;

// One predicated Euler substep of a warp's RPW rows (row stride d):
//
//     pre = s(h) W1h + base + t w1t       hid = act(pre)
//     h   = pred ? h + dt (hid W2 + b2) : h
//
// my_sc holds s(h) (it is my_h itself for identity scaling) and is updated
// with h; my_hid is scratch.  Lane l owns columns l + 32 c.  t itself is the
// caller's to advance.  Ends with __syncwarp.
template <int CPT, int RPW, int LOAD>
__device__ __forceinline__ void euler_substep(float* my_h, float* my_sc, float* my_hid,
                                              const float* my_base, const float (&t)[RPW],
                                              const bool (&pred)[RPW], const float* W1,
                                              const float* W2, int ld, int d, int lane,
                                              const float (&w1t)[CPT], const float (&b2)[CPT],
                                              float dt, int act, int scale) {
  float acc[RPW][CPT];
  rows_mm<CPT, RPW, false, LOAD>(my_sc, d, RPW, W1, ld, d, lane, acc);
#pragma unroll
  for (int q = 0; q < RPW; ++q)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < d) {
        const float pre = fmaf(t[q], w1t[c], acc[q][c] + my_base[q * d + j]);
        my_hid[q * d + j] = activate(pre, act);
      }
    }
  __syncwarp();
  rows_mm<CPT, RPW, false, LOAD>(my_hid, d, RPW, W2, ld, d, lane, acc);
#pragma unroll
  for (int q = 0; q < RPW; ++q)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < d && pred[q]) {
        const float hv = fmaf(dt, acc[q][c] + b2[c], my_h[q * d + j]);
        my_h[q * d + j] = hv;
        if (scale != kIdentity) my_sc[q * d + j] = scale_in(hv, scale);
      }
    }
  __syncwarp();
}

// acc[q][c] = sum_{i < n_in} x[q][i] W[i * ldw + j0 + j] for j = lane + 32 c
// (columns at or past n_out read as 0); x rows at stride x_ld, read as
// broadcasts, rows q >= nrows reading row nrows - 1.  W is (in, out).
template <int CPT, int RPW, int LOAD>
__device__ __forceinline__ void rows_mm_rect(const float* x, int x_ld, int nrows, int n_in,
                                             const float* W, int ldw, int j0, int n_out,
                                             int lane, float (&acc)[RPW][CPT]) {
#pragma unroll
  for (int q = 0; q < RPW; ++q)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[q][c] = 0.0f;
#pragma unroll 4
  for (int i = 0; i < n_in; ++i) {
    float w[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = j0 + lane + kWarp * c;
      w[c] = j < n_out ? load_w<LOAD>(W + (size_t)i * ldw + j) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const float xv = x[(q < nrows ? q : nrows - 1) * x_ld + i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[q][c] = fmaf(xv, w[c], acc[q][c]);
    }
  }
}

inline int max_smem_optin(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace njode_gap
