// The time-major grid walk on Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels njode_tpu/ops/walk_scan.py:_fwd_kernel (line 148)
// and :_bwd_kernel (line 226).  The walk integrates every inter-observation
// gap of a batch in one pass over the M cells of the grid {g dt}: the carry
// (h, t, x) of each row starts at zero; at cell g each slot s of the row
// whose cell is g first reads the arriving (pre-reset) h as its pre-jump
// state, then a valid slot resets the carry to (h_jump[s], t_s, x_s); then
// one Euler step
//
//     pre = s(h) W1h + x w1x + t w1t + cvec,   cvec = dt w1_tel + b1
//     h  += dt (act(pre) W2 + b2),             t += dt
//
// (the kernel's t_elapsed is the constant dt, folded into cvec by the
// wrapper).  A slot whose cell is M reads the final carry.  Padded slots
// never reset (reset cell -1) but still read the arrival at their cell.
//
// The TPU kernels' lane layout ([h, t, x, 1] carried in 128 lanes, row-pair
// packing, the per-cell DMA streams) is not copied: the port takes logical
// shapes and writes only the N-1 pre-jump states per row, plus, when
// autograd needs them, the per-cell post-reset (h, t, x) as residuals.
//
// What bounds it on the H100: the f32 products, 2 (d_h+2) d_h + 2 d_h^2
// flops per row, cell and network forward and about twice that backward, on
// the CUDA cores; rows are independent in the forward, so blocks own tiles
// of 4 rows, one a warp, and each warp walks its row with no block
// barrier.  Each row's slot
// cells sit in shared memory, and at every cell the lanes test 32 slots at
// once (a warp ballot).  Device memory holds only the inputs, the outputs
// and the residuals (M B d_h floats, in L2 at the training shapes).
//
// Backward: the cells in reverse, each recomputing pre from its residual;
// the carry's h-cotangent at a reset cell goes to h_jump[s], and the new
// carry is the sum of the cotangents of the pre-jump states read at that
// cell.  Blocks own 4 rows, one a warp; the weight cotangents of a cell are
// summed in shared memory, each entry by one owning thread over the 4 rows
// in order, then the blocks' partials are summed in tile order by a second
// kernel: a run repeats bitwise.
//
// Layout (f32 unless said): hj (K, B, N, d); xs, ts (B, N) (x scaled);
// reset_cell, read_cell (B, N) int32; w1 (K, d+3, d) (in, out), rows [h, x,
// t_rel, t_elapsed] (the last row unread); cvec, b2 (K, d); w2 (K, d, d)
// (in, out); hminus (K, B, N-1, d); res_h (K, M, B, d); res_t, res_x (M, B);
// partial (tiles, K, 2 d^2 + 4 d) = [dW1h, dW2, dw1x, dw1t, dcvec, db2].

#include <cuda_runtime.h>
#include <stddef.h>

#include "walk_cell.cuh"

namespace {

using namespace njode_walk;

// one row a warp: a row's walk is a chain of dependent cells, so the card
// is kept busy by many warps in flight rather than by sharing weight loads
// among a warp's rows; in the backward it also keeps a block's gradient sums
// of a cell (every entry by one thread) to 4 rows
constexpr int kWarps = 4;
constexpr int kFwdRPW = 1;
constexpr int kFwdTile = kFwdRPW * kWarps;
constexpr int kBwdRPW = 1;
constexpr int kBwdTile = kBwdRPW * kWarps;

__host__ __device__ __forceinline__ int grad_floats(int d) { return 2 * d * d + 4 * d; }

// -------------------------------------------------------------- forward

template <int CPT, bool STAGE, bool SAVE>
__global__ void __launch_bounds__(kWarp * kWarps)
walk_fwd_kernel(const float* __restrict__ hj, const float* __restrict__ xs,
                const float* __restrict__ ts, const int* __restrict__ reset_cell,
                const int* __restrict__ read_cell, const float* __restrict__ w1,
                const float* __restrict__ cvec, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ hminus,
                float* __restrict__ res_h, float* __restrict__ res_t,
                float* __restrict__ res_x, int B, int N, int d, int M, float dt,
                int act, int scale) {
  constexpr int RPW = kFwdRPW;
  extern __shared__ float smem[];
  const int k = blockIdx.y, lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kWarp + lane, n_threads = kWarp * blockDim.y;
  const int row0 = blockIdx.x * kFwdTile;
  const int ld = STAGE ? (d | 1) : d;
  const float* W1 = w1 + (size_t)k * (d + 3) * d;
  const float* W2 = w2 + (size_t)k * d * d;
  float w1x[CPT], w1t[CPT], cv[CPT], bb2[CPT];
  vec_regs<CPT>(W1 + (size_t)d * d, d, lane, w1x);
  vec_regs<CPT>(W1 + (size_t)(d + 1) * d, d, lane, w1t);
  vec_regs<CPT>(cvec + (size_t)k * d, d, lane, cv);
  vec_regs<CPT>(b2 + (size_t)k * d, d, lane, bb2);
  float* rows = smem;
  if constexpr (STAGE) {
    float* s_w1 = smem;
    float* s_w2 = smem + (size_t)d * ld;
    for (int e = tid; e < d * d; e += n_threads) {
      const int i = e / d, j = e - i * d;
      s_w1[i * ld + j] = W1[e];
      s_w2[i * ld + j] = W2[e];
    }
    W1 = s_w1;
    W2 = s_w2;
    rows = smem + 2 * (size_t)d * ld;
  }
  float* s_h = rows;
  float* s_hid = s_h + kFwdTile * d;
  float* s_sc = scale == kIdentity ? s_h : s_hid + kFwdTile * d;
  int* s_reset = reinterpret_cast<int*>(s_hid + (scale == kIdentity ? 1 : 2) * kFwdTile * d);
  int* s_read = s_reset + kFwdTile * N;
  for (int e = tid; e < kFwdTile * d; e += n_threads) {
    s_h[e] = 0.0f;
    if (scale != kIdentity) s_sc[e] = scale_in(0.0f, scale);
  }
  for (int e = tid; e < kFwdTile * N; e += n_threads) {
    const int b = row0 + e / N;
    s_reset[e] = b < B ? reset_cell[(size_t)row0 * N + e] : -2;
    s_read[e] = b < B ? read_cell[(size_t)row0 * N + e] : -2;
  }
  __syncthreads();

  const int r_w = warp * RPW;
  float* my_h = s_h + r_w * d;
  float* my_sc = s_sc + r_w * d;
  float* my_hid = s_hid + r_w * d;
  bool valid[RPW];
  float t[RPW], x[RPW];
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    valid[q] = row0 + r_w + q < B;
    t[q] = 0.0f;
    x[q] = 0.0f;
  }
  float acc[RPW][CPT];
  const int S = N - 1;

  for (int g = 0; g <= M; ++g) {
    // pre-jump reads of the arriving carry, then the resets
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      if (!valid[q]) continue;
      const int b = row0 + r_w + q;
      for_slots_at(s_read + (r_w + q) * N, N, 1, g, lane, [&](int s) {
        float* out = hminus + (((size_t)k * B + b) * S + s - 1) * d;
        for (int j = lane; j < d; j += kWarp) out[j] = my_h[q * d + j];
      });
      if (g == M) continue;
      for_slots_at(s_reset + (r_w + q) * N, N, 0, g, lane, [&](int s) {
        const float* src = hj + (((size_t)k * B + b) * N + s) * d;
        for (int j = lane; j < d; j += kWarp) {
          const float hv = src[j];
          my_h[q * d + j] = hv;
          if (scale != kIdentity) my_sc[q * d + j] = scale_in(hv, scale);
        }
        t[q] = ts[(size_t)b * N + s];
        x[q] = xs[(size_t)b * N + s];
      });
      if constexpr (SAVE) {
        float* dst = res_h + (((size_t)k * M + g) * B + b) * d;
        for (int j = lane; j < d; j += kWarp) dst[j] = my_h[q * d + j];
        if (k == 0 && lane == 0) {
          res_t[(size_t)g * B + b] = t[q];
          res_x[(size_t)g * B + b] = x[q];
        }
      }
    }
    if (g == M) break;
    __syncwarp();
    rows_mm<CPT, RPW, false, (STAGE ? kLoadPlain : kLoadNc)>(my_sc, d, RPW, W1, ld, d, lane, acc);
#pragma unroll
    for (int q = 0; q < RPW; ++q)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < d) {
          const float pre = acc[q][c] + x[q] * w1x[c] + t[q] * w1t[c] + cv[c];
          my_hid[q * d + j] = activate(pre, act);
        }
      }
    __syncwarp();
    rows_mm<CPT, RPW, false, (STAGE ? kLoadPlain : kLoadNc)>(my_hid, d, RPW, W2, ld, d, lane, acc);
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < d) {
          const float hv = my_h[q * d + j] + dt * (acc[q][c] + bb2[c]);
          my_h[q * d + j] = hv;
          if (scale != kIdentity) my_sc[q * d + j] = scale_in(hv, scale);
        }
      }
      t[q] += dt;
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------- backward

template <int CPT, bool STAGE>
__global__ void __launch_bounds__(kWarp * kWarps)
walk_bwd_kernel(const float* __restrict__ ct_hm, const float* __restrict__ res_h,
                const float* __restrict__ res_t, const float* __restrict__ res_x,
                const int* __restrict__ reset_cell, const int* __restrict__ read_cell,
                const float* __restrict__ w1, const float* __restrict__ cvec,
                const float* __restrict__ w2, float* __restrict__ ct_hj,
                float* __restrict__ partial, int B, int N, int d, int M, float dt,
                int act, int scale) {
  constexpr int RPW = kBwdRPW;
  extern __shared__ float smem[];
  const int k = blockIdx.y, K = gridDim.y, lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kWarp + lane, n_threads = kWarp * blockDim.y;
  const int row0 = blockIdx.x * kBwdTile;
  const int n_rows = min(kBwdTile, B - row0);
  const int ld = STAGE ? (d | 1) : d;
  const int S = N - 1, TD = kBwdTile * d, P = grad_floats(d);
  const float* W1 = w1 + (size_t)k * (d + 3) * d;
  const float* W2 = w2 + (size_t)k * d * d;
  float w1x[CPT], w1t[CPT], cv[CPT];
  vec_regs<CPT>(W1 + (size_t)d * d, d, lane, w1x);
  vec_regs<CPT>(W1 + (size_t)(d + 1) * d, d, lane, w1t);
  vec_regs<CPT>(cvec + (size_t)k * d, d, lane, cv);
  float* base = smem;
  if constexpr (STAGE) {
    float* s_w1 = smem;
    float* s_w2 = smem + (size_t)d * ld;
    for (int e = tid; e < d * d; e += n_threads) {
      const int i = e / d, j = e - i * d;
      s_w1[i * ld + j] = W1[e];
      s_w2[i * ld + j] = W2[e];
    }
    W1 = s_w1;
    W2 = s_w2;
    base = smem + 2 * (size_t)d * ld;
  }
  float* gacc = base;             // P
  float* s_hp = gacc + P;         // post-reset h
  float* s_pre = s_hp + TD;
  float* s_hid = s_pre + TD;
  float* s_gdh = s_hid + TD;
  float* s_gpre = s_gdh + TD;
  float* s_gh = s_gpre + TD;      // the carry's h-cotangent
  float* s_t = s_gh + TD;
  float* s_x = s_t + kBwdTile;
  float* s_sc = scale == kIdentity ? s_hp : s_x + kBwdTile;
  int* s_reset = reinterpret_cast<int*>(s_x + kBwdTile + (scale == kIdentity ? 0 : TD));
  int* s_read = s_reset + kBwdTile * N;
  for (int e = tid; e < P; e += n_threads) gacc[e] = 0.0f;
  for (int e = tid; e < TD; e += n_threads) s_gh[e] = 0.0f;
  for (int e = tid; e < kBwdTile * N; e += n_threads) {
    const int b = row0 + e / N;
    s_reset[e] = b < B ? reset_cell[(size_t)row0 * N + e] : -2;
    s_read[e] = b < B ? read_cell[(size_t)row0 * N + e] : -2;
  }

  const int r_w = warp * RPW;
  float* my_hp = s_hp + r_w * d;
  float* my_sc = s_sc + r_w * d;
  float* my_pre = s_pre + r_w * d;
  float* my_hid = s_hid + r_w * d;
  float* my_gdh = s_gdh + r_w * d;
  float* my_gpre = s_gpre + r_w * d;
  float* my_gh = s_gh + r_w * d;
  bool valid[RPW];
#pragma unroll
  for (int q = 0; q < RPW; ++q) valid[q] = row0 + r_w + q < B;
  __syncthreads();
  // the final carry's cotangent: the pre-jump states read at cell M
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    if (!valid[q]) continue;
    const int b = row0 + r_w + q;
    for_slots_at(s_read + (r_w + q) * N, N, 1, M, lane, [&](int s) {
      const float* src = ct_hm + (((size_t)k * B + b) * S + s - 1) * d;
      for (int j = lane; j < d; j += kWarp) my_gh[q * d + j] += src[j];
    });
  }
  float acc[RPW][CPT];

  for (int g = M - 1; g >= 0; --g) {
    // ---- row phase: this warp's rows
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const int b = row0 + r_w + q;
      const float* src = res_h + (((size_t)k * M + g) * B + (valid[q] ? b : 0)) * d;
      for (int j = lane; j < d; j += kWarp) {
        const float hv = valid[q] ? src[j] : 0.0f;
        my_hp[q * d + j] = hv;
        if (scale != kIdentity) my_sc[q * d + j] = scale_in(hv, scale);
      }
      if (lane == 0) {
        s_t[r_w + q] = valid[q] ? res_t[(size_t)g * B + b] : 0.0f;
        s_x[r_w + q] = valid[q] ? res_x[(size_t)g * B + b] : 0.0f;
      }
    }
    __syncwarp();
    rows_mm<CPT, RPW, false, (STAGE ? kLoadPlain : kLoadNc)>(my_sc, d, RPW, W1, ld, d, lane, acc);
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const float tq = s_t[r_w + q], xq = s_x[r_w + q];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < d) {
          const float pre = acc[q][c] + xq * w1x[c] + tq * w1t[c] + cv[c];
          my_pre[q * d + j] = pre;
          my_hid[q * d + j] = activate(pre, act);
          my_gdh[q * d + j] = dt * my_gh[q * d + j];
        }
      }
    }
    __syncwarp();
    rows_mm<CPT, RPW, true, (STAGE ? kLoadPlain : kLoadNc)>(my_gdh, d, RPW, W2, ld, d, lane, acc);
#pragma unroll
    for (int q = 0; q < RPW; ++q)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < d) my_gpre[q * d + j] = acc[q][c] * act_grad(my_pre[q * d + j], act);
      }
    __syncwarp();
    rows_mm<CPT, RPW, true, (STAGE ? kLoadPlain : kLoadNc)>(my_gpre, d, RPW, W1, ld, d, lane, acc);
#pragma unroll
    for (int q = 0; q < RPW; ++q)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < d)
          my_gh[q * d + j] += acc[q][c] * scale_grad(my_hp[q * d + j], scale);
      }
    // resets: the post-reset cotangent goes to the jump state; the carry
    // before the reset gets only the reads of this cell
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      if (!valid[q]) continue;
      const int b = row0 + r_w + q;
      bool has = false;
      for_slots_at(s_reset + (r_w + q) * N, N, 0, g, lane, [&](int s) {
        has = true;
        float* dst = ct_hj + (((size_t)k * B + b) * N + s) * d;
        for (int j = lane; j < d; j += kWarp) dst[j] = my_gh[q * d + j];
      });
      if (has)
        for (int j = lane; j < d; j += kWarp) my_gh[q * d + j] = 0.0f;
      for_slots_at(s_read + (r_w + q) * N, N, 1, g, lane, [&](int s) {
        const float* src = ct_hm + (((size_t)k * B + b) * S + s - 1) * d;
        for (int j = lane; j < d; j += kWarp) my_gh[q * d + j] += src[j];
      });
    }
    __syncthreads();
    // ---- block phase: the weight sums of this cell, every entry by its
    // owner (outer_acc, col_acc), rows in order
    outer_acc<CPT, kBwdTile>(s_sc, s_gpre, n_rows, d, gacc, warp, kWarps, lane);
    outer_acc<CPT, kBwdTile>(s_hid, s_gdh, n_rows, d, gacc + d * d, warp, kWarps, lane);
    if (warp == 0)
      col_acc<CPT, kBwdTile>(s_x, s_gpre, n_rows, d, gacc + 2 * d * d, lane);
    else if (warp == 1)
      col_acc<CPT, kBwdTile>(s_t, s_gpre, n_rows, d, gacc + 2 * d * d + d, lane);
    else if (warp == 2)
      col_acc<CPT, kBwdTile>(nullptr, s_gpre, n_rows, d, gacc + 2 * d * d + 2 * d, lane);
    else
      col_acc<CPT, kBwdTile>(nullptr, s_gdh, n_rows, d, gacc + 2 * d * d + 3 * d, lane);
    __syncthreads();
  }
  float* out = partial + ((size_t)blockIdx.x * K + k) * P;
  for (int e = tid; e < P; e += n_threads) out[e] = gacc[e];
}

// sums the tiles' partials in tile order: out[e] = sum_t partial[t][e]
__global__ void walk_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int tiles, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.0f;
  for (int t = 0; t < tiles; ++t) sum += partial[(size_t)t * n + e];
  out[e] = sum;
}

int cpt_of(int d) { return d <= 32 ? 1 : (d <= 64 ? 2 : 4); }

int max_smem_optin(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// row buffers and the rows' slot cells (reset and read, ints)
size_t fwd_rows_bytes(int d, int N, int scale) {
  return ((scale == kIdentity ? 2 : 3) * (size_t)kFwdTile * d + 2 * (size_t)kFwdTile * N) *
         sizeof(float);
}

size_t bwd_rows_bytes(int d, int N, int scale) {
  return ((size_t)grad_floats(d) + (scale == kIdentity ? 6 : 7) * (size_t)kBwdTile * d +
          2 * kBwdTile + 2 * (size_t)kBwdTile * N) * sizeof(float);
}

size_t stage_bytes(int d) { return 2 * (size_t)d * (d | 1) * sizeof(float); }

}  // namespace

#define NJODE_WALK_DISPATCH(CPT_VAL, CALL) \
  switch (CPT_VAL) {                       \
    case 1: { constexpr int C = 1; CALL; } break; \
    case 2: { constexpr int C = 2; CALL; } break; \
    default: { constexpr int C = 4; CALL; } break; \
  }

// The forward walk.  res_h/res_t/res_x may be null (no residuals kept).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int njode_walk_fwd(const void* hj, const void* xs, const void* ts,
                              const void* reset_cell, const void* read_cell,
                              const void* w1, const void* cvec, const void* w2,
                              const void* b2, void* hminus, void* res_h,
                              void* res_t, void* res_x, int K, int B, int N,
                              int d, int M, float dt, int act, int scale,
                              void* stream) {
  if (K < 1 || K > 65535 || B < 1 || N < 2 || d < 1 || d > 128 || M < 0 ||
      act < 0 || act > kSelu || scale < 0 || scale > kScaleSigmoid)
    return (int)cudaErrorInvalidValue;
  const bool save = res_h != nullptr;
  if (save && (res_t == nullptr || res_x == nullptr)) return (int)cudaErrorInvalidValue;
  int max_smem = 0;
  int err = max_smem_optin(&max_smem);
  if (err != 0) return err;
  const size_t rows_b = fwd_rows_bytes(d, N, scale);
  const bool stage = rows_b + stage_bytes(d) <= (size_t)max_smem;
  const size_t smem = rows_b + (stage ? stage_bytes(d) : 0);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kFwdTile - 1) / kFwdTile, K), block(kWarp, kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *f_hj = static_cast<const float*>(hj), *f_xs = static_cast<const float*>(xs),
              *f_ts = static_cast<const float*>(ts), *f_w1 = static_cast<const float*>(w1),
              *f_cv = static_cast<const float*>(cvec), *f_w2 = static_cast<const float*>(w2),
              *f_b2 = static_cast<const float*>(b2);
  const int *i_rs = static_cast<const int*>(reset_cell), *i_rd = static_cast<const int*>(read_cell);
  float *f_hm = static_cast<float*>(hminus), *f_rh = static_cast<float*>(res_h),
        *f_rt = static_cast<float*>(res_t), *f_rx = static_cast<float*>(res_x);
  cudaError_t e = cudaSuccess;
#define NJODE_WALK_FWD(STG, SV)                                                   \
  {                                                                               \
    auto kern = walk_fwd_kernel<C, STG, SV>;                                      \
    e = set_smem(kern, smem);                                                     \
    if (e == cudaSuccess)                                                         \
      kern<<<grid, block, smem, s>>>(f_hj, f_xs, f_ts, i_rs, i_rd, f_w1, f_cv,    \
                                     f_w2, f_b2, f_hm, f_rh, f_rt, f_rx, B, N, d, \
                                     M, dt, act, scale);                          \
  }
  const int cpt = cpt_of(d);
  if (stage && save) {
    NJODE_WALK_DISPATCH(cpt, NJODE_WALK_FWD(true, true))
  } else if (stage) {
    NJODE_WALK_DISPATCH(cpt, NJODE_WALK_FWD(true, false))
  } else if (save) {
    NJODE_WALK_DISPATCH(cpt, NJODE_WALK_FWD(false, true))
  } else {
    NJODE_WALK_DISPATCH(cpt, NJODE_WALK_FWD(false, false))
  }
#undef NJODE_WALK_FWD
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Floats of the backward's partial buffer: tiles x K x (2 d^2 + 4 d).
extern "C" long long njode_walk_partial_floats(int K, int B, int d) {
  return (long long)((B + kBwdTile - 1) / kBwdTile) * K * grad_floats(d);
}

// The backward walk.  ct_hj must be zeroed by the caller (slots that never
// reset get no cotangent); grads (K, 2 d^2 + 4 d) receives the summed weight
// cotangents [dW1h, dW2, dw1x, dw1t, dcvec, db2]; partial is scratch of
// njode_walk_partial_floats floats.  Two launches on `stream`.
extern "C" int njode_walk_bwd(const void* ct_hm, const void* res_h,
                              const void* res_t, const void* res_x,
                              const void* reset_cell, const void* read_cell,
                              const void* w1, const void* cvec, const void* w2,
                              void* ct_hj, void* partial, void* grads, int K,
                              int B, int N, int d, int M, float dt, int act,
                              int scale, void* stream) {
  if (K < 1 || K > 65535 || B < 1 || N < 2 || d < 1 || d > 128 || M < 0 ||
      act < 0 || act > kSelu || scale < 0 || scale > kScaleSigmoid)
    return (int)cudaErrorInvalidValue;
  int max_smem = 0;
  int err = max_smem_optin(&max_smem);
  if (err != 0) return err;
  const size_t rows_b = bwd_rows_bytes(d, N, scale);
  const bool stage = rows_b + stage_bytes(d) <= (size_t)max_smem;
  const size_t smem = rows_b + (stage ? stage_bytes(d) : 0);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const int tiles = (B + kBwdTile - 1) / kBwdTile;
  const dim3 grid(tiles, K), block(kWarp, kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *f_ct = static_cast<const float*>(ct_hm), *f_rh = static_cast<const float*>(res_h),
              *f_rt = static_cast<const float*>(res_t), *f_rx = static_cast<const float*>(res_x),
              *f_w1 = static_cast<const float*>(w1), *f_cv = static_cast<const float*>(cvec),
              *f_w2 = static_cast<const float*>(w2);
  const int *i_rs = static_cast<const int*>(reset_cell), *i_rd = static_cast<const int*>(read_cell);
  float *f_cj = static_cast<float*>(ct_hj), *f_pt = static_cast<float*>(partial);
  cudaError_t e = cudaSuccess;
#define NJODE_WALK_BWD(STG)                                                          \
  {                                                                                  \
    auto kern = walk_bwd_kernel<C, STG>;                                             \
    e = set_smem(kern, smem);                                                        \
    if (e == cudaSuccess)                                                            \
      kern<<<grid, block, smem, s>>>(f_ct, f_rh, f_rt, f_rx, i_rs, i_rd, f_w1, f_cv, \
                                     f_w2, f_cj, f_pt, B, N, d, M, dt, act, scale);  \
  }
  const int cpt = cpt_of(d);
  if (stage) {
    NJODE_WALK_DISPATCH(cpt, NJODE_WALK_BWD(true))
  } else {
    NJODE_WALK_DISPATCH(cpt, NJODE_WALK_BWD(false))
  }
#undef NJODE_WALK_BWD
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = K * grad_floats(d);
  walk_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(f_pt, static_cast<float*>(grads), tiles, n);
  return (int)cudaGetLastError();
}

extern "C" const char* njode_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
