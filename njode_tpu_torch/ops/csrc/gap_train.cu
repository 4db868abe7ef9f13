// Whole-gap Euler integration for training on Hopper (sm_90a): the forward
// with residuals and the reverse-loop backward.
//
// Replaces four TPU kernels of njode_tpu/ops/gap_scan.py: _fwd_kernel (line
// 134) and _fwd_kernel_ck (line 235) are one forward here, whose residual
// stride is 1 (every substep's entering state, row 2) or CK = 8 (every 8th,
// row 3); _bwd_kernel (line 422) and _bwd_kernel_ck (line 295) are one
// backward, which recomputes each stride-long segment from its checkpoint
// before walking it in reverse (nothing to recompute at stride 1).
//
// The substep (row 1's, gap_scan.cu), for every row (one gap) and network k:
//
//     pred = (t + dt) < t_tgt
//     pre  = s(h) W1h + base + t w1t        (W1h, W2 stored (in, out))
//     h    = pred ? h + dt (act(pre) W2 + b2) : h,   t = pred ? t + dt : t
//
// The backward, substep j from the last down (g: the cotangent of h):
//
//     g_dh  = pred ? dt g : 0          g_pre = (g_dh W2^T) act'(pre)
//     g    += (g_pre W1h^T) s'(h)
//     per row:    gpre_sum += g_pre,  acc_t += t g_pre,  gdh_sum += g_dh
//     over rows:  dW1h += s(h)^T g_pre,  dW2 += act(pre)^T g_dh
//
// The wrapper sums acc_t and gdh_sum over rows into the cotangents of w1t
// and b2, and gpre_sum is the cotangent of base (njode_tpu/ops/gap_scan.py
// :723-738).  t residuals are stored as their exact f32 bits (the TPU
// kernel packs them into a spare lane): the backward's predicates must
// reproduce the forward's bit for bit, which a recomputed t0 + j dt would
// not.
//
// What bounds it on the H100: by work, the f32 products, 4 d^2 flops per
// row, network and substep taken forward, and 10 d^2 backward plus 4 d^2 for
// the recompute of a checkpointed segment, on the CUDA cores; device memory
// holds only the inputs, the outputs and the residuals (n_res K R d
// floats).  In practice the latency of the longest gap of a launch: a warp
// (forward) or block (backward) runs until its last row stops, each
// substep a chain of dependent products (PERF.md, section 6).
// What the design does about it:
//   * forward: row 1's layout (h, s(h), the hidden activations and base of a
//     tile in shared memory, t in registers, weights staged in shared memory
//     when they fit in 100 KB), 2 rows a warp sharing each weight load, and
//     a warp leaves the loop once none of its rows moves, storing its
//     remaining checkpoints from the final (unchanging) state;
//   * backward: one row a warp and 4 rows a block; each warp recomputes its
//     row's segment into shared memory and runs the row algebra with no block
//     barrier; then the block sums the substep's weight cotangents in shared
//     memory (every entry by one owning thread over the tile's rows in
//     order).  A substep (or a whole segment) that no row of the tile takes
//     contributes exactly zero and is skipped on a block vote.  Blocks walk
//     row tiles in a fixed order, as many blocks as the card holds at once,
//     and a second kernel sums the blocks' partials in block order: a run
//     repeats bitwise, with no atomics.
//
// Layout (f32, contiguous): h0, base, hout (K, R, d); t0, ttgt, tout (R,);
// w1h, w2 (K, d, d) as (in, out); w1t, b2 (K, d); res_h (n_res, K, R, d);
// res_t (n_res, R), n_res = ceil(n_sub / stride); ghL, gh0, gpre_sum,
// acc_t, gdh_sum (K, R, d); partial (blocks, K, 2, d, d); dw (K, 2, d, d) =
// [dW1h, dW2] as (in, out).

#include <cuda_runtime.h>
#include <stddef.h>

#include "gap_cell.cuh"

namespace {

using namespace njode_gap;

constexpr int kFwdWarps = 4;
constexpr int kFwdRPW = 2;
constexpr int kFwdTile = kFwdWarps * kFwdRPW;
constexpr int kBwdWarps = 4;        // one row a warp
constexpr int kBwdTile = kBwdWarps;
constexpr int kMaxHidden = 128;     // 4 columns a lane
constexpr int kMaxStride = 64;
// weights are staged in shared memory only while the block stays small
// enough for several blocks an SM
constexpr size_t kStageBytes = 100 * 1024;

int cpt_of(int d) { return d <= 32 ? 1 : (d <= 64 ? 2 : 4); }

size_t stage_bytes(int d) { return 2 * (size_t)d * (d | 1) * sizeof(float); }

size_t fwd_rows_bytes(int d, int scale) {
  return (scale == kIdentity ? 3 : 4) * (size_t)kFwdTile * d * sizeof(float);
}

// gacc (2 d^2), five row buffers (s(h), hid, g_dh, g_pre, base) and the
// segment (stride states and times): at d 128 and stride 8 157,824 bytes
size_t bwd_rows_bytes(int d, int stride) {
  return (2 * (size_t)d * d + 5 * (size_t)kBwdTile * d + (size_t)stride * kBwdTile * (d + 1)) *
         sizeof(float);
}

// ---------------------------------------------------------------- forward

template <int CPT, bool STAGE>
__global__ void __launch_bounds__(kWarp * kFwdWarps)
gap_res_fwd_kernel(const float* __restrict__ h0, const float* __restrict__ base,
                   const float* __restrict__ t0, const float* __restrict__ ttgt,
                   const float* __restrict__ w1h, const float* __restrict__ w1t,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   float* __restrict__ hout, float* __restrict__ tout,
                   float* __restrict__ res_h, float* __restrict__ res_t, int R, int d,
                   float dt, int n_sub, int stride, int n_res, int act, int scale) {
  constexpr int RPW = kFwdRPW;
  constexpr int LOAD = STAGE ? kLoadPlain : kLoadNc;
  extern __shared__ float smem[];
  const int k = blockIdx.y, K = gridDim.y, lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kWarp + lane, n_threads = kWarp * blockDim.y;
  const int row0 = blockIdx.x * kFwdTile;
  const int ld = STAGE ? (d | 1) : d;
  const size_t dd = (size_t)d * d;
  const float* W1 = w1h + (size_t)k * dd;
  const float* W2 = w2 + (size_t)k * dd;
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
  float* s_base = s_hid + kFwdTile * d;
  float* s_sc = scale == kIdentity ? s_h : s_base + kFwdTile * d;
  float w1t_r[CPT], b2_r[CPT];
  vec_regs<CPT>(w1t + (size_t)k * d, d, lane, w1t_r);
  vec_regs<CPT>(b2 + (size_t)k * d, d, lane, b2_r);

  // the tile's rows are contiguous in (K, R, d)
  const size_t g0 = ((size_t)k * R + row0) * d;
  const int n_valid = min(kFwdTile, R - row0) * d;
  for (int e = tid; e < kFwdTile * d; e += n_threads) {
    const bool in = e < n_valid;
    const float hv = in ? h0[g0 + e] : 0.0f;
    s_h[e] = hv;
    s_base[e] = in ? base[g0 + e] : 0.0f;
    if (scale != kIdentity) s_sc[e] = scale_in(hv, scale);
  }
  const int r_w = warp * RPW;  // first tile row of this warp
  float t[RPW], t_tgt[RPW];
  bool valid[RPW];
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    const int row = row0 + r_w + q;
    valid[q] = row < R;
    t[q] = valid[q] ? t0[row] : 0.0f;
    t_tgt[q] = valid[q] ? ttgt[row] : 0.0f;
  }
  __syncthreads();

  float* my_h = s_h + r_w * d;
  float* my_sc = s_sc + r_w * d;
  float* my_hid = s_hid + r_w * d;
  const float* my_base = s_base + r_w * d;
  // checkpoint m: the state entering substep m * stride (lane l writes the
  // columns it owns, l + 32 c, as the substep does)
  auto store = [&](int m) {
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      if (!valid[q]) continue;
      const int row = row0 + r_w + q;
      float* dst = res_h + (((size_t)m * K + k) * R + row) * d;
      for (int j = lane; j < d; j += kWarp) dst[j] = my_h[q * d + j];
      if (k == 0 && lane == 0) res_t[(size_t)m * R + row] = t[q];
    }
  };

  int m_next = 0;
  for (int j = 0; j < n_sub; ++j) {
    if (j == m_next * stride) store(m_next++);
    bool pred[RPW];
    bool any = false;
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      pred[q] = valid[q] && (t[q] + dt) < t_tgt[q];
      any = any || pred[q];
    }
    // no row of the warp moves again (t is then fixed, so is pred)
    if (!__any_sync(0xffffffffu, any)) break;
    euler_substep<CPT, RPW, LOAD>(my_h, my_sc, my_hid, my_base, t, pred, W1, W2, ld, d,
                                  lane, w1t_r, b2_r, dt, act, scale);
#pragma unroll
    for (int q = 0; q < RPW; ++q)
      if (pred[q]) t[q] += dt;
  }
  // checkpoints past the warp's early exit hold its final state
  while (m_next < n_res) store(m_next++);

#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    if (!valid[q]) continue;
    const int row = row0 + r_w + q;
    for (int j = lane; j < d; j += kWarp) hout[((size_t)k * R + row) * d + j] = my_h[q * d + j];
    if (k == 0 && lane == 0) tout[row] = t[q];
  }
}

// --------------------------------------------------------------- backward

template <int CPT, bool STAGE>
__global__ void __launch_bounds__(kWarp * kBwdWarps)
gap_bwd_kernel(const float* __restrict__ ghL, const float* __restrict__ base,
               const float* __restrict__ ttgt, const float* __restrict__ w1h,
               const float* __restrict__ w1t, const float* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ res_h,
               const float* __restrict__ res_t, float* __restrict__ gh0,
               float* __restrict__ gpre_sum, float* __restrict__ acct,
               float* __restrict__ gdh_sum, float* __restrict__ partial, int R, int d,
               float dt, int n_sub, int stride, int n_res, int act, int scale) {
  constexpr int TR = kBwdTile;
  constexpr int LOAD = STAGE ? kLoadPlain : kLoadNc;
  extern __shared__ float smem[];
  const int k = blockIdx.y, K = gridDim.y, lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kWarp + lane, n_threads = kWarp * blockDim.y;
  const int ld = STAGE ? (d | 1) : d;
  const size_t dd = (size_t)d * d;
  const float* W1 = w1h + (size_t)k * dd;
  const float* W2 = w2 + (size_t)k * dd;
  float* rest = smem;
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
    rest = smem + 2 * (size_t)d * ld;
  }
  float* gacc = rest;                 // [dW1h | dW2], entry a * d + c
  float* s_sc = gacc + 2 * dd;        // s(h) of the substep, one row a warp
  float* s_hid = s_sc + TR * d;
  float* s_gdh = s_hid + TR * d;
  float* s_gpre = s_gdh + TR * d;
  float* s_base = s_gpre + TR * d;
  float* seg_h = s_base + TR * d;     // segment state c of warp w: (c TR + w) d
  float* seg_t = seg_h + (size_t)stride * TR * d;
  for (size_t e = tid; e < 2 * dd; e += n_threads) gacc[e] = 0.0f;
  float w1t_r[CPT], b2_r[CPT];
  vec_regs<CPT>(w1t + (size_t)k * d, d, lane, w1t_r);
  vec_regs<CPT>(b2 + (size_t)k * d, d, lane, b2_r);
  float* my_sc = s_sc + warp * d;
  float* my_hid = s_hid + warp * d;
  float* my_gdh = s_gdh + warp * d;
  float* my_gpre = s_gpre + warp * d;
  float* my_base = s_base + warp * d;
  const int n_tiles = (R + TR - 1) / TR;
  __syncthreads();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row = tile * TR + warp;
    const bool valid = row < R;
    const int n_rows = min(TR, R - tile * TR);
    const size_t g = ((size_t)k * R + (valid ? row : 0)) * d;
    const float tt = valid ? ttgt[row] : 0.0f;
    float gh[CPT], gp_sum[CPT], at_sum[CPT], gd_sum[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      gh[c] = valid && j < d ? ghL[g + j] : 0.0f;
      gp_sum[c] = at_sum[c] = gd_sum[c] = 0.0f;
    }
    for (int j = lane; j < d; j += kWarp) my_base[j] = valid ? base[g + j] : 0.0f;

    for (int s = n_res - 1; s >= 0; --s) {
      const int n_c = min(stride, n_sub - s * stride);  // substeps of segment s
      float t_c = valid ? res_t[(size_t)s * R + row] : 0.0f;
      const float* ck = res_h + (((size_t)s * K + k) * R + (valid ? row : 0)) * d;
      float* seg0 = seg_h + (size_t)warp * d;
      for (int j = lane; j < d; j += kWarp) seg0[j] = valid ? ck[j] : 0.0f;
      bool pred = valid && (t_c + dt) < tt;
      // pred never turns true again within a row: a segment whose first
      // substep no row of the tile takes is zero throughout
      if (!__syncthreads_or(pred)) continue;
      if (lane == 0) seg_t[warp] = t_c;
      // recompute the segment's entering states (this warp's row)
      for (int c = 1; c < n_c; ++c) {
        const float* prev = seg_h + ((size_t)(c - 1) * TR + warp) * d;
        float* cur = seg_h + ((size_t)c * TR + warp) * d;
        for (int j = lane; j < d; j += kWarp) {
          cur[j] = prev[j];
          if (pred && scale != kIdentity) my_sc[j] = scale_in(prev[j], scale);
        }
        __syncwarp();
        if (pred) {
          const float tq[1] = {t_c};
          const bool pq[1] = {true};
          euler_substep<CPT, 1, LOAD>(cur, scale == kIdentity ? cur : my_sc, my_hid, my_base,
                                      tq, pq, W1, W2, ld, d, lane, w1t_r, b2_r, dt, act,
                                      scale);
          t_c += dt;
          pred = (t_c + dt) < tt;
        }
        if (lane == 0) seg_t[c * TR + warp] = t_c;
      }
      __syncwarp();

      // the segment in reverse
      for (int c = n_c - 1; c >= 0; --c) {
        const float* hj = seg_h + ((size_t)c * TR + warp) * d;
        const float tj = seg_t[c * TR + warp];
        const bool p = valid && (tj + dt) < tt;
        // also the barrier between the last substep's block sums and this
        // one's row buffers
        if (!__syncthreads_or(p)) continue;
        if (p) {
          float acc[1][CPT], pre[CPT];
#pragma unroll
          for (int c2 = 0; c2 < CPT; ++c2) {
            const int j = lane + kWarp * c2;
            if (j < d) my_sc[j] = scale_in(hj[j], scale);
          }
          __syncwarp();
          rows_mm<CPT, 1, false, LOAD>(my_sc, d, 1, W1, ld, d, lane, acc);
#pragma unroll
          for (int c2 = 0; c2 < CPT; ++c2) {
            const int j = lane + kWarp * c2;
            pre[c2] = 0.0f;
            if (j < d) {
              pre[c2] = fmaf(tj, w1t_r[c2], acc[0][c2] + my_base[j]);
              my_hid[j] = activate(pre[c2], act);
              const float gdh = dt * gh[c2];
              my_gdh[j] = gdh;
              gd_sum[c2] += gdh;
            }
          }
          __syncwarp();
          rows_mm<CPT, 1, true, LOAD>(my_gdh, d, 1, W2, ld, d, lane, acc);  // g_dh W2^T
#pragma unroll
          for (int c2 = 0; c2 < CPT; ++c2) {
            const int j = lane + kWarp * c2;
            if (j < d) {
              const float gp = acc[0][c2] * act_grad(pre[c2], act);
              my_gpre[j] = gp;
              gp_sum[c2] += gp;
              at_sum[c2] = fmaf(tj, gp, at_sum[c2]);
            }
          }
          __syncwarp();
          rows_mm<CPT, 1, true, LOAD>(my_gpre, d, 1, W1, ld, d, lane, acc);  // g_pre W1h^T
#pragma unroll
          for (int c2 = 0; c2 < CPT; ++c2) {
            const int j = lane + kWarp * c2;
            if (j < d) gh[c2] = fmaf(acc[0][c2], scale_grad(hj[j], scale), gh[c2]);
          }
        } else {
          // a row that does not take the substep adds exactly zero
          for (int j = lane; j < d; j += kWarp)
            my_sc[j] = my_hid[j] = my_gdh[j] = my_gpre[j] = 0.0f;
        }
        __syncthreads();
        outer_acc<CPT, TR>(s_sc, s_gpre, n_rows, d, gacc, warp, kBwdWarps, lane);
        outer_acc<CPT, TR>(s_hid, s_gdh, n_rows, d, gacc + dd, warp, kBwdWarps, lane);
      }
    }
    if (valid) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < d) {
          gh0[g + j] = gh[c];
          gpre_sum[g + j] = gp_sum[c];
          acct[g + j] = at_sum[c];
          gdh_sum[g + j] = gd_sum[c];
        }
      }
    }
  }
  __syncthreads();
  float* out = partial + ((size_t)blockIdx.x * K + k) * 2 * dd;
  for (size_t e = tid; e < 2 * dd; e += n_threads) out[e] = gacc[e];
}

// sums the blocks' partials in block order: out[e] = sum_b partial[b][e]
__global__ void gap_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                  int blocks, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.0f;
  for (int b = 0; b < blocks; ++b) sum += partial[(size_t)b * n + e];
  out[e] = sum;
}

bool bad_args(int K, int R, int d, float dt, int n_sub, int stride, int act, int scale) {
  return K < 1 || K > 65535 || R < 1 || d < 1 || d > kMaxHidden || !(dt > 0.0f) ||
         n_sub < 1 || stride < 1 || stride > kMaxStride || act < 0 || act > kSelu ||
         scale < 0 || scale > kScaleSigmoid;
}

// the backward's shared memory and whether it stages the weights
int bwd_plan(int d, int stride, size_t* smem, bool* stage) {
  int max_smem = 0;
  const int err = max_smem_optin(&max_smem);
  if (err != 0) return err;
  const size_t rows_b = bwd_rows_bytes(d, stride);
  if (rows_b > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  *stage = rows_b + stage_bytes(d) <= kStageBytes;
  *smem = rows_b + (*stage ? stage_bytes(d) : 0);
  return 0;
}

}  // namespace

#define NJODE_GAP_DISPATCH(CPT_VAL, CALL)         \
  switch (CPT_VAL) {                              \
    case 1: { constexpr int C = 1; CALL; } break; \
    case 2: { constexpr int C = 2; CALL; } break; \
    default: { constexpr int C = 4; CALL; } break; \
  }

// The forward with residuals (stride 1: row 2, stride 8: row 3).  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int njode_gap_train_fwd(const void* h0, const void* base, const void* t0,
                                   const void* ttgt, const void* w1h, const void* w1t,
                                   const void* w2, const void* b2, void* hout, void* tout,
                                   void* res_h, void* res_t, int K, int R, int d, float dt,
                                   int n_sub, int stride, int act, int scale, void* stream) {
  if (bad_args(K, R, d, dt, n_sub, stride, act, scale)) return (int)cudaErrorInvalidValue;
  const int n_res = (n_sub + stride - 1) / stride;
  const size_t rows_b = fwd_rows_bytes(d, scale);
  const bool stage = rows_b + stage_bytes(d) <= kStageBytes;
  const size_t smem = rows_b + (stage ? stage_bytes(d) : 0);
  const dim3 grid((R + kFwdTile - 1) / kFwdTile, K), block(kWarp, kFwdWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *f_h0 = static_cast<const float*>(h0), *f_base = static_cast<const float*>(base),
              *f_t0 = static_cast<const float*>(t0), *f_tt = static_cast<const float*>(ttgt),
              *f_w1h = static_cast<const float*>(w1h), *f_w1t = static_cast<const float*>(w1t),
              *f_w2 = static_cast<const float*>(w2), *f_b2 = static_cast<const float*>(b2);
  float *f_ho = static_cast<float*>(hout), *f_to = static_cast<float*>(tout),
        *f_rh = static_cast<float*>(res_h), *f_rt = static_cast<float*>(res_t);
  cudaError_t e = cudaSuccess;
#define NJODE_GAP_FWD(STG)                                                                 \
  {                                                                                        \
    auto kern = gap_res_fwd_kernel<C, STG>;                                                \
    e = set_smem(kern, smem);                                                              \
    if (e == cudaSuccess)                                                                  \
      kern<<<grid, block, smem, s>>>(f_h0, f_base, f_t0, f_tt, f_w1h, f_w1t, f_w2, f_b2,   \
                                     f_ho, f_to, f_rh, f_rt, R, d, dt, n_sub, stride,      \
                                     n_res, act, scale);                                   \
  }
  if (stage) {
    NJODE_GAP_DISPATCH(cpt_of(d), NJODE_GAP_FWD(true))
  } else {
    NJODE_GAP_DISPATCH(cpt_of(d), NJODE_GAP_FWD(false))
  }
#undef NJODE_GAP_FWD
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The backward's grid width: as many blocks (per network) as the card
// holds at once, at most one per row tile.  The partial buffer of
// njode_gap_train_bwd has blocks x K x 2 d^2 floats.
extern "C" int njode_gap_train_bwd_blocks(int K, int R, int d, int stride, int* blocks) {
  if (bad_args(K, R, d, 1.0f, 1, stride, 0, 0)) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  bool stage = false;
  int err = bwd_plan(d, stride, &smem, &stage);
  if (err != 0) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
#define NJODE_GAP_OCC(STG)                                                                 \
  {                                                                                        \
    auto kern = gap_bwd_kernel<C, STG>;                                                    \
    if (e == cudaSuccess) e = set_smem(kern, smem);                                        \
    if (e == cudaSuccess)                                                                  \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kWarp * kBwdWarps,  \
                                                        smem);                             \
  }
  if (stage) {
    NJODE_GAP_DISPATCH(cpt_of(d), NJODE_GAP_OCC(true))
  } else {
    NJODE_GAP_DISPATCH(cpt_of(d), NJODE_GAP_OCC(false))
  }
#undef NJODE_GAP_OCC
  if (e != cudaSuccess) return (int)e;
  const int tiles = (R + kBwdTile - 1) / kBwdTile;
  const int fit = per_sm * n_sm / K;
  *blocks = fit < 1 ? 1 : (fit < tiles ? fit : tiles);
  return 0;
}

// The reverse loop (stride 1: row 4, stride > 1: row 5, recomputing each
// segment) and the block-order sum of the weight cotangents into dw.  Two
// launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int njode_gap_train_bwd(const void* ghL, const void* base, const void* ttgt,
                                   const void* w1h, const void* w1t, const void* w2,
                                   const void* b2, const void* res_h, const void* res_t,
                                   void* gh0, void* gpre_sum, void* acct, void* gdh_sum,
                                   void* partial, void* dw, int K, int R, int d, float dt,
                                   int n_sub, int stride, int blocks, int act, int scale,
                                   void* stream) {
  if (bad_args(K, R, d, dt, n_sub, stride, act, scale) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int n_res = (n_sub + stride - 1) / stride;
  size_t smem = 0;
  bool stage = false;
  int err = bwd_plan(d, stride, &smem, &stage);
  if (err != 0) return err;
  const dim3 grid(blocks, K), block(kWarp, kBwdWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *f_g = static_cast<const float*>(ghL), *f_base = static_cast<const float*>(base),
              *f_tt = static_cast<const float*>(ttgt), *f_w1h = static_cast<const float*>(w1h),
              *f_w1t = static_cast<const float*>(w1t), *f_w2 = static_cast<const float*>(w2),
              *f_b2 = static_cast<const float*>(b2), *f_rh = static_cast<const float*>(res_h),
              *f_rt = static_cast<const float*>(res_t);
  float *f_gh0 = static_cast<float*>(gh0), *f_gp = static_cast<float*>(gpre_sum),
        *f_at = static_cast<float*>(acct), *f_gd = static_cast<float*>(gdh_sum),
        *f_pt = static_cast<float*>(partial);
  cudaError_t e = cudaSuccess;
#define NJODE_GAP_BWD(STG)                                                                 \
  {                                                                                        \
    auto kern = gap_bwd_kernel<C, STG>;                                                    \
    e = set_smem(kern, smem);                                                              \
    if (e == cudaSuccess)                                                                  \
      kern<<<grid, block, smem, s>>>(f_g, f_base, f_tt, f_w1h, f_w1t, f_w2, f_b2, f_rh,    \
                                     f_rt, f_gh0, f_gp, f_at, f_gd, f_pt, R, d, dt, n_sub, \
                                     stride, n_res, act, scale);                           \
  }
  if (stage) {
    NJODE_GAP_DISPATCH(cpt_of(d), NJODE_GAP_BWD(true))
  } else {
    NJODE_GAP_DISPATCH(cpt_of(d), NJODE_GAP_BWD(false))
  }
#undef NJODE_GAP_BWD
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = K * 2 * d * d;
  gap_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(f_pt, static_cast<float*>(dw), blocks, n);
  return (int)cudaGetLastError();
}

extern "C" const char* njode_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
