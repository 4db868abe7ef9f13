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
// What bounds it on the H100: at the shapes of its path (1,152 rows, K 2,
// d_in 35, d 32) the call is tiny, 2 (d_in + d) d flops and (d_in + 3 d + 1)
// floats of device memory a row (0.4 us of bytes): launch latency and the
// chain of dependent loads and products inside the call.  What the design
// does about it: no block-wide staging and no __syncthreads; each warp owns
// one tile of kRows rows of one network (the grid is the tiles over the
// warps, one wave at the forced default shape); at d <= 32 with d_in <=
// kRegIn each lane holds its column of W1 and of W2 in registers, read once
// a warp, and the tile's rows sit in shared memory zero-padded to kRegIn
// and 32 columns, so both products are one straight run of broadcasts and
// fmas with no bound checks (relu, the forced default recipe's activation,
// is compiled in); past those widths a lane reads its columns through L1 for
// each tile, in chunks of 32 CPT columns (any width).  Every load of a tile
// is issued before its first product: the input and state rows as one
// contiguous run each (float4 loads where aligned); pre and out leave
// through the warp's shared rows as one contiguous run each (float4 stores
// where aligned).  A warp's rows take 16 (d_in + 4 d) bytes of shared
// memory past the register instance's widths, so a block has kWarps warps
// where they fit and as many as fit wider (one warp's rows fit up to d of
// about 2,900 at d_in = d + 3 on an H100).  One tile a warp: 0.0060 ms of device time at the
// forced default shape on an H100 against 0.0083 ms at two and 0.0127 at
// four (PERF.md section 6, row 6's design).
//
// Layout (f32, contiguous): inp (K, R, d_in); h, out, pre (K, R, d); dt
// (R,); w1 (K, d_in, d) and w2 (K, d, d) as (in, out); b1, b2 (K, d).

#include <cuda_runtime.h>
#include <stddef.h>

#include "gap_cell.cuh"

namespace {

using namespace njode_gap;

constexpr int kWarps = 8;     // a block, where their rows fit the shared memory
constexpr int kRows = 4;      // rows a tile
constexpr int kRegIn = 48;    // the register instance: d_in <= kRegIn, d <= 32

// a tile's rows in shared memory: the input rows at stride ldi (kRegIn in
// the register instance, zero past d_in, else d_in), the state, hidden, pre
// and out rows at stride ldh (32 in the register instance, the hidden rows
// zero past d, else d); every part a whole number of float4s
__host__ __device__ inline int in_stride(bool reg, int d_in) { return reg ? kRegIn : d_in; }
__host__ __device__ inline int h_stride(bool reg, int d) { return reg ? kWarp : d; }
__host__ __device__ inline int warp_floats(bool reg, int d_in, int d) {
  return (kRows * in_stride(reg, d_in) + 3) / 4 * 4 + 4 * ((kRows * h_stride(reg, d) + 3) / 4 * 4);
}

// n contiguous floats of device memory (read-only) into rows of ld floats
// of shared memory (n = rows x len): float4 loads where the source is
// 16-byte aligned
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int len, int n,
                                          int lane) {
  if ((reinterpret_cast<size_t>(src) & 15) == 0) {
    const int n4 = n / 4;
    for (int e4 = lane; e4 < n4; e4 += kWarp) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src) + e4);
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = 4 * e4 + u, q = e / len;
        dst[q * ld + e - q * len] = f[u];
      }
    }
    for (int e = 4 * n4 + lane; e < n; e += kWarp) {
      const int q = e / len;
      dst[q * ld + e - q * len] = __ldg(src + e);
    }
  } else {
    for (int e = lane; e < n; e += kWarp) {
      const int q = e / len;
      dst[q * ld + e - q * len] = __ldg(src + e);
    }
  }
}

// rows of ld floats of shared memory out to n contiguous floats of device
// memory: float4 stores where the destination is 16-byte aligned and the
// rows are unpadded
__device__ __forceinline__ void store_rows(float* dst, const float* src, int ld, int len, int n,
                                           int lane) {
  if (ld == len && (reinterpret_cast<size_t>(dst) & 15) == 0) {
    const int n4 = n / 4;
    for (int e4 = lane; e4 < n4; e4 += kWarp)
      reinterpret_cast<float4*>(dst)[e4] = reinterpret_cast<const float4*>(src)[e4];
    for (int e = 4 * n4 + lane; e < n; e += kWarp) dst[e] = src[e];
  } else {
    for (int e = lane; e < n; e += kWarp) {
      const int q = e / len;
      dst[e] = src[q * ld + e - q * len];
    }
  }
}

// acc[q] = sum_i x[q][i] wr[i] over a warp's kRows rows x (shared, row
// stride ldx) and all N entries of lane j's column of W in registers (x
// and wr zero past the product's depth): a straight run of broadcasts and
// fmas
template <int N>
__device__ __forceinline__ void reg_product(float (&acc)[kRows][1], const float* x, int ldx,
                                            const float (&wr)[N]) {
#pragma unroll
  for (int q = 0; q < kRows; ++q) acc[q][0] = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int q = 0; q < kRows; ++q) acc[q][0] = fmaf(x[q * ldx + i], wr[i], acc[q][0]);
}

// acc[q][c] = sum_{i < n_in} x[q][i] W[i][j], j = c0 + lane + 32 c, over a
// warp's kRows rows x (shared, row stride ldx) and W, (n_in, d) in device
// memory, read through L1
template <int CPT>
__device__ __forceinline__ void l1_product(float (&acc)[kRows][CPT], const float* x, int ldx,
                                           int n_in, const float* W, int d, int c0, int lane) {
#pragma unroll
  for (int q = 0; q < kRows; ++q)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[q][c] = 0.0f;
#pragma unroll 4
  for (int i = 0; i < n_in; ++i) {
    float w[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = c0 + lane + kWarp * c;
      w[c] = j < d ? __ldg(W + (size_t)i * d + j) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const float xv = x[q * ldx + i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[q][c] = fmaf(xv, w[c], acc[q][c]);
    }
  }
}

// REG: d <= 32, d_in <= kRegIn, weights in registers; RELU: the activation
// compiled in (the forced default recipe's)
template <int CPT, bool REG, bool RELU>
__global__ void __launch_bounds__(kWarp * kWarps)
fused_cell_kernel(const float* __restrict__ inp, const float* __restrict__ h,
                  const float* __restrict__ dt, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out,
                  float* __restrict__ pre_out, int R, int d_in, int d, int act) {
  extern __shared__ float4 smem4[];
  const int k = blockIdx.y, lane = threadIdx.x, warp = threadIdx.y;
  const int ldi = in_stride(REG, d_in), ldh = h_stride(REG, d);
  float* s_in = reinterpret_cast<float*>(smem4) + (size_t)warp * warp_floats(REG, d_in, d);
  const int nh = (kRows * ldh + 3) / 4 * 4;
  float* s_h = s_in + (kRows * ldi + 3) / 4 * 4;
  float* s_hid = s_h + nh;
  float* s_pre = s_hid + nh;
  float* s_out = s_pre + nh;
  const float* W1 = w1 + (size_t)k * d_in * d;
  const float* W2 = w2 + (size_t)k * d * d;
  const float* B1 = b1 + (size_t)k * d;
  const float* B2 = b2 + (size_t)k * d;
  auto actf = [&](float x) { return RELU ? (x < 0.0f ? 0.0f : x) : activate(x, act); };
  // the register instance: lane j's column of W1 and W2 and its biases, and
  // the input rows' padding set to zero once
  float w1r[REG ? kRegIn : 1] = {}, w2r[REG ? kWarp : 1] = {}, b1r = 0.0f, b2r = 0.0f;
  if constexpr (REG) {
    const bool col = lane < d;
#pragma unroll
    for (int i = 0; i < kRegIn; ++i) w1r[i] = col && i < d_in ? __ldg(W1 + i * d + lane) : 0.0f;
#pragma unroll
    for (int i = 0; i < kWarp; ++i) w2r[i] = col && i < d ? __ldg(W2 + i * d + lane) : 0.0f;
    b1r = col ? __ldg(B1 + lane) : 0.0f;
    b2r = col ? __ldg(B2 + lane) : 0.0f;
    for (int e = lane; e < kRows * kRegIn; e += kWarp)
      if (e % kRegIn >= d_in) s_in[e] = 0.0f;
  }
  const int tiles = (R + kRows - 1) / kRows;
  for (int tile = blockIdx.x * blockDim.y + warp; tile < tiles; tile += gridDim.x * blockDim.y) {
    const int row0 = tile * kRows, nr = min(kRows, R - row0);
    const size_t g_in = ((size_t)k * R + row0) * d_in, g_h = ((size_t)k * R + row0) * d;
    __syncwarp();  // the last tile's reads of the warp's rows are done
    load_rows(s_in, ldi, inp + g_in, d_in, nr * d_in, lane);
    load_rows(s_h, ldh, h + g_h, d, nr * d, lane);
    const float dt_l = lane < nr ? __ldg(dt + row0 + lane) : 0.0f;
    float dt_q[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) dt_q[q] = __shfl_sync(0xffffffffu, dt_l, q);
    __syncwarp();
    float acc[kRows][CPT];
    // rows past nr compute on whatever their rows hold; nothing of them is
    // stored
    for (int c0 = 0; c0 < d; c0 += kWarp * CPT) {
      if constexpr (REG) reg_product(acc, s_in, ldi, w1r);
      else l1_product(acc, s_in, ldi, d_in, W1, d, c0, lane);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = c0 + lane + kWarp * c;
        if (j >= (REG ? kWarp : d)) continue;
        const float bj = REG ? b1r : __ldg(B1 + j);
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const float p = acc[q][c] + bj;
          s_pre[q * ldh + j] = p;
          s_hid[q * ldh + j] = j < d ? actf(p) : 0.0f;
        }
      }
    }
    __syncwarp();
    for (int c0 = 0; c0 < d; c0 += kWarp * CPT) {
      if constexpr (REG) reg_product(acc, s_hid, ldh, w2r);
      else l1_product(acc, s_hid, ldh, d, W2, d, c0, lane);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = c0 + lane + kWarp * c;
        if (j >= d) continue;
        const float bj = REG ? b2r : __ldg(B2 + j);
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          s_out[q * ldh + j] = fmaf(dt_q[q], acc[q][c] + bj, s_h[q * ldh + j]);
      }
    }
    __syncwarp();
    store_rows(pre_out + g_h, s_pre, ldh, d, nr * d, lane);
    store_rows(out + g_h, s_out, ldh, d, nr * d, lane);
  }
}

}  // namespace

// One launch on `stream` for all K networks, a tile of kRows rows a warp;
// returns cudaGetLastError() (0 on success).
extern "C" int njode_fused_cell(const void* inp, const void* h, const void* dt,
                                const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, void* pre, int K, int R,
                                int d_in, int d, int act, void* stream) {
  if (K < 1 || K > 65535 || R < 1 || d_in < 1 || d < 1 || act < 0 || act > kSelu)
    return (int)cudaErrorInvalidValue;
  int max_smem = 0;
  const int err = max_smem_optin(&max_smem);
  if (err != 0) return err;
  const bool reg = d <= kWarp && d_in <= kRegIn;
  // warps a block: kWarps, or as many as the shared memory holds
  const long long warp_bytes = (long long)warp_floats(reg, d_in, d) * sizeof(float);
  const long long fit = max_smem / warp_bytes;
  if (fit < 1) return (int)cudaErrorInvalidValue;
  const int warps = fit < kWarps ? (int)fit : kWarps;
  const size_t smem = (size_t)warps * warp_bytes;
  // columns a lane: the power of two covering d in one chunk, at most 8
  const int chunks = (d + kWarp - 1) / kWarp;
  int cpt = 1;
  while (cpt < chunks && cpt < 8) cpt *= 2;
  // a network's blocks: its tiles, one a warp
  const int tiles = (R + kRows - 1) / kRows;
  const dim3 grid((tiles + warps - 1) / warps, K), block(kWarp, warps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *f_in = static_cast<const float*>(inp), *f_h = static_cast<const float*>(h),
              *f_dt = static_cast<const float*>(dt), *f_w1 = static_cast<const float*>(w1),
              *f_b1 = static_cast<const float*>(b1), *f_w2 = static_cast<const float*>(w2),
              *f_b2 = static_cast<const float*>(b2);
  float *f_out = static_cast<float*>(out), *f_pre = static_cast<float*>(pre);
  cudaError_t e = cudaSuccess;
#define NJODE_CELL(C, REG_, RELU_)                                                       \
  {                                                                                      \
    auto kern = fused_cell_kernel<C, REG_, RELU_>;                                       \
    e = set_smem(kern, smem);                                                            \
    if (e == cudaSuccess)                                                                \
      kern<<<grid, block, smem, s>>>(f_in, f_h, f_dt, f_w1, f_b1, f_w2, f_b2, f_out,     \
                                     f_pre, R, d_in, d, act);                            \
  }
  if (reg && act == kRelu) {
    NJODE_CELL(1, true, true)
  } else if (reg) {
    NJODE_CELL(1, true, false)
  } else {
    switch (cpt) {
      case 1: NJODE_CELL(1, false, false) break;
      case 2: NJODE_CELL(2, false, false) break;
      case 4: NJODE_CELL(4, false, false) break;
      default: NJODE_CELL(8, false, false) break;
    }
  }
#undef NJODE_CELL
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* njode_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
