// Device helpers of the gap-loop training kernels (gap_train.cu) and the
// fused Euler cell (fused_cell.cu): a row's Euler substep, with its product
// on a group of warps (group_mm, walk_cell.cuh) or on one warp with the
// group's arithmetic (quarter_mm), and the launch helpers.  The activations
// and scalings come from walk_cell.cuh.
//
// One substep, one code site: the forward (rows 2-3) and the backward's
// rebuild of a checkpointed segment (rows 4-5) both call gap_substep, so a
// row's states do not depend on which kernel, walker or stride made them.
// A change to it is a change to both kernels.

#pragma once

#include "walk_cell.cuh"

namespace njode_gap {

using namespace njode_walk;

constexpr int kGroupWarps = 4;  // the warps of a long row's group

// One warp's product with the arithmetic of a group of kGroupWarps warps
// (group_mm): each quarter of the plane's rows summed as part_mm sums it (two
// accumulators a column, even and odd rows, in order), the quarters added in
// the group's order.  The vector's entries are read back from the warp's
// HP floats of shared memory (xs) as broadcasts, four at a time, in place
// of part_mm's shuffles.
template <int CPT, bool TRANS>
__device__ __forceinline__ void quarter_mm(const float (&v)[CPT], const float* W, int ld, int d,
                                           int lane, float* xs, float (&acc)[CPT]) {
  constexpr int Q = kWarp * CPT / kGroupWarps;
  const int top = (d + 15) / 16 * 16;
  __syncwarp();  // the last product's reads of xs are done
#pragma unroll
  for (int c = 0; c < CPT; ++c) xs[lane + kWarp * c] = lane + kWarp * c < d ? v[c] : 0.0f;
  __syncwarp();
#pragma unroll 1
  for (int w = 0; w < kGroupWarps; ++w) {
    float a0[CPT], a1[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) a0[c] = a1[c] = 0.0f;
    const int r_hi = min((w + 1) * Q, top);
#pragma unroll 1
    for (int rb = w * Q; rb < r_hi; rb += 16) {
      const float* Wb = TRANS ? W + rb : W + rb * ld;
#pragma unroll
      for (int s = 0; s < 16; s += 4) {
        const float4 x = *reinterpret_cast<const float4*>(xs + rb + s);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = lane + kWarp * c;
          a0[c] = fmaf(x.x, TRANS ? Wb[j * ld + s] : Wb[s * ld + j], a0[c]);
          a1[c] = fmaf(x.y, TRANS ? Wb[j * ld + s + 1] : Wb[(s + 1) * ld + j], a1[c]);
          a0[c] = fmaf(x.z, TRANS ? Wb[j * ld + s + 2] : Wb[(s + 2) * ld + j], a0[c]);
          a1[c] = fmaf(x.w, TRANS ? Wb[j * ld + s + 3] : Wb[(s + 3) * ld + j], a1[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] = w == 0 ? a0[c] + a1[c] : acc[c] + (a0[c] + a1[c]);
  }
}

// The activation and the input scaling with their derivatives; RI fixes
// relu and identity (the production recipe's) at compile time, with the
// same bits as the run-time codes.
template <bool RI>
struct Pointwise {
  int act, scale;
  __device__ __forceinline__ float actf(float x) const {
    return RI ? (x < 0.0f ? 0.0f : x) : activate(x, act);
  }
  __device__ __forceinline__ float actg(float x) const {
    return RI ? (x > 0.0f ? 1.0f : 0.0f) : act_grad(x, act);
  }
  __device__ __forceinline__ float scl(float x) const { return RI ? x : scale_in(x, scale); }
  __device__ __forceinline__ float sclg(float x) const {
    return RI ? 1.0f : scale_grad(x, scale);
  }
};

// A walker of one row: a group of kGroupWarps warps splitting every product
// (group_mm), or one warp with the group's arithmetic (quarter_mm, its
// vector staged in xs).  W1h and W2 are planes of HP x (HP + 1) floats in
// shared memory, zero past d.
template <int CPT>
struct Walker {
  bool on_group;
  Group* gr;
  float* xs;
  int d, lane;
  __device__ __forceinline__ void mm(const float (&v)[CPT], const float* W,
                                     float (&acc)[CPT]) const {
    constexpr int LDP = kWarp * CPT + 1;
    if (on_group) group_mm<CPT, false, false>(v, W, LDP, d, lane, *gr, acc);
    else quarter_mm<CPT, false>(v, W, LDP, d, lane, xs, acc);
  }
};

// One Euler substep of a row (lane l holds entries l + 32 c of h, base,
// w1t and b2; entries past d are 0):
//
//     pre = s(h) W1h + base + t w1t,    and with advance:
//     h   = h + dt (act(pre) W2 + b2),  t = t + dt
//
// each product by the walker, the adds by explicit fmaf in this order;
// on_pre(q, pre) sees entry q of pre as it is formed.
template <int CPT, bool RI, typename OnPre>
__device__ __forceinline__ void gap_substep(float (&h)[CPT], float& t, bool advance,
                                            const float (&base)[CPT], const float (&w1t)[CPT],
                                            const float (&b2)[CPT], const float* W1,
                                            const float* W2, float dt, const Walker<CPT>& wk,
                                            const Pointwise<RI>& pw, OnPre on_pre) {
  float v[CPT], acc[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) v[q] = pw.scl(h[q]);
  wk.mm(v, W1, acc);
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const float pre = fmaf(t, w1t[q], acc[q] + base[q]);
    on_pre(q, pre);
    v[q] = pw.actf(pre);
  }
  if (!advance) return;
  wk.mm(v, W2, acc);
#pragma unroll
  for (int q = 0; q < CPT; ++q) h[q] = fmaf(dt, acc[q] + b2[q], h[q]);
  t += dt;
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
