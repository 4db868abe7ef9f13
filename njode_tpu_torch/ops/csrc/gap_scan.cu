// Whole-gap Euler integration on Hopper (sm_90a), primal only.
//
// Replaces the TPU kernel njode_tpu/ops/gap_scan.py:_fwd_kernel_lean (the
// serving path's substep loop).  For every row (one inter-observation gap)
// and every moment network k it runs up to n_sub predicated Euler substeps
//
//     pred = (t + dt) < t_tgt
//     pre  = s(h) W1h + base + t w1t        (W1h, W2 stored (in, out))
//     h    = pred ? h + dt (act(pre) W2 + b2) : h
//     t    = pred ? t + dt : t
//
// entirely on chip: h, s(h), the hidden activations and the hoisted
// base = s(x) W1x + dt w1dt + b1 live in shared memory for the whole loop,
// t lives in registers.  The final partial step to t_tgt stays in PyTorch
// around the kernel (njode_tpu_torch/ops/gap_scan.py), as in the JAX package.
//
// What bounds it on the H100: the two (d_h x d_h) products of every substep,
// 4 d_h^2 flops per row and substep, done here in f32 on the CUDA cores with
// one shared-memory or L1 weight load per RPW fmas (RPW rows share each
// weight load).  Every byte of device memory is touched once per gap, so the
// loop is compute- and shared-memory-bound, not HBM-bound.  What the design
// does about it: weights are staged in shared memory when they fit beside
// the row tile in 100 KB (d_h = 50 does, d_h = 256 does not), else read
// through L1/L2 with __ldg; each warp
// owns RPW rows and runs its own loop with no block barrier, and leaves the
// loop as soon as none of its rows still moves (exact: t then never changes
// again), so short gaps cost few substeps.
//
// Numerics: t advances by single f32 adds and the predicate is computed on
// exactly those values, so t_L is bitwise the plain version's.  h differs
// from it by fma contraction and summation order only.  Built without
// --use_fast_math, so expf/tanhf/expm1f are the accurate versions and
// denormals are kept.
//
// Layout: h0, base, hout (K, R, d_h); t0, ttgt, tout (R,); w1h, w2 (K, d_h,
// d_h) as (in, out); w1t, b2 (K, d_h).  All f32, contiguous.  Rows past R in
// the last tile are masked here (never loaded, never stored).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr int kRowsPerWarp = 4;
// weights are staged in shared memory only while the block stays small
// enough for several blocks per SM
constexpr size_t kStageBytes = 100 * 1024;

// codes in the order of SUPPORTED_ACTS / SCALINGS in gap_scan.py
enum Act { kRelu = 0, kTanh = 1, kSigmoid = 2, kElu = 3, kLeakyRelu = 4, kSelu = 5 };
enum Scale { kIdentity = 0, kScaleTanh = 1, kScaleSigmoid = 2 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kTanh: return tanhf(x);
    case kSigmoid: return 1.0f / (1.0f + expf(-x));
    case kElu: return x > 0.0f ? x : expm1f(x);
    case kLeakyRelu: return x >= 0.0f ? x : 0.01f * x;
    case kSelu:
      return 1.0507009873554805f * (x > 0.0f ? x : 1.6732632423543772f * expm1f(x));
    default: return x < 0.0f ? 0.0f : x;  // relu, NaN passes through
  }
}

__device__ __forceinline__ float scale_in(float x, int scale) {
  if (scale == kScaleTanh) return tanhf(x);
  if (scale == kScaleSigmoid) return 1.0f / (1.0f + expf(-x));
  return x;
}

template <bool STAGE>
__device__ __forceinline__ float load_w(const float* p) {
  if constexpr (STAGE) return *p;
  else return __ldg(p);
}

// acc[q][c] = sum_i x[q][i] * W[i][j0 + 32 c] for the warp's RPW rows x
// (shared, row stride d_h); columns past d_h read as 0.
template <int CPT, int RPW, bool STAGE>
__device__ __forceinline__ void row_times_w(const float* x, const float* W,
                                            int d_h, int j0,
                                            float (&acc)[RPW][CPT]) {
#pragma unroll
  for (int q = 0; q < RPW; ++q)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[q][c] = 0.0f;
#pragma unroll 4
  for (int i = 0; i < d_h; ++i) {
    float w[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = j0 + kWarp * c;
      w[c] = j < d_h ? load_w<STAGE>(W + (size_t)i * d_h + j) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const float xv = x[q * d_h + i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[q][c] = fmaf(xv, w[c], acc[q][c]);
    }
  }
}

// Grid (row tiles, K); block (32, warps).  Warp w owns tile rows
// [w*RPW, (w+1)*RPW); lane l owns columns l, l+32, ... of each 32*CPT-wide
// column chunk.  A warp reads and writes only its own rows' shared state, so
// after the block-wide load the warps run their loops independently.
template <int CPT, int RPW, bool STAGE>
__global__ void __launch_bounds__(kWarp * kMaxWarps)
gap_scan_fwd_kernel(const float* __restrict__ h0, const float* __restrict__ base,
                    const float* __restrict__ t0, const float* __restrict__ ttgt,
                    const float* __restrict__ w1h, const float* __restrict__ w1t,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    float* __restrict__ hout, float* __restrict__ tout,
                    int R, int d_h, float dt, int n_sub, int act, int scale) {
  extern __shared__ float smem[];
  const int k = blockIdx.y;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int n_threads = kWarp * blockDim.y;
  const int tid = warp * kWarp + lane;
  const int row0 = blockIdx.x * blockDim.y * RPW;
  const int tile = blockDim.y * RPW * d_h;
  const size_t dd = (size_t)d_h * d_h;

  float* s_h = smem;
  float* s_hid = s_h + tile;
  float* s_base = s_hid + tile;
  float* s_sc = scale == kIdentity ? s_h : s_base + tile;
  float* s_w = s_base + (scale == kIdentity ? tile : 2 * tile);

  const float* w1t_k = w1t + (size_t)k * d_h;
  const float* b2_k = b2 + (size_t)k * d_h;
  const float* W1 = w1h + (size_t)k * dd;
  const float* W2 = w2 + (size_t)k * dd;
  if constexpr (STAGE) {
    for (size_t i = tid; i < dd; i += n_threads) {
      s_w[i] = W1[i];
      s_w[dd + i] = W2[i];
    }
    W1 = s_w;
    W2 = s_w + dd;
  }

  // the tile's rows are contiguous in (K, R, d_h)
  const size_t g0 = ((size_t)k * R + row0) * d_h;
  const int n_valid = (R - row0 < tile / d_h ? R - row0 : tile / d_h) * d_h;
  for (int idx = tid; idx < tile; idx += n_threads) {
    const bool in = idx < n_valid;
    const float hv = in ? h0[g0 + idx] : 0.0f;
    s_h[idx] = hv;
    s_base[idx] = in ? base[g0 + idx] : 0.0f;
    if (scale != kIdentity) s_sc[idx] = scale_in(hv, scale);
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

  float* my_h = s_h + r_w * d_h;
  float* my_sc = s_sc + r_w * d_h;
  float* my_hid = s_hid + r_w * d_h;
  const float* my_base = s_base + r_w * d_h;
  float acc[RPW][CPT];

  for (int s = 0; s < n_sub; ++s) {
    bool pred[RPW];
    bool any = false;
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      pred[q] = valid[q] && (t[q] + dt) < t_tgt[q];
      any = any || pred[q];
    }
    if (!__any_sync(0xffffffffu, any)) break;

    // hid = act(s(h) W1h + base + t w1t)
    for (int c0 = 0; c0 < d_h; c0 += kWarp * CPT) {
      row_times_w<CPT, RPW, STAGE>(my_sc, W1, d_h, c0 + lane, acc);
#pragma unroll
      for (int q = 0; q < RPW; ++q)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = c0 + lane + kWarp * c;
          if (j < d_h) {
            const float pre = acc[q][c] + my_base[q * d_h + j] + t[q] * w1t_k[j];
            my_hid[q * d_h + j] = activate(pre, act);
          }
        }
    }
    __syncwarp();

    // h += dt (hid W2 + b2) on the rows whose predicate holds
    for (int c0 = 0; c0 < d_h; c0 += kWarp * CPT) {
      row_times_w<CPT, RPW, STAGE>(my_hid, W2, d_h, c0 + lane, acc);
#pragma unroll
      for (int q = 0; q < RPW; ++q)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = c0 + lane + kWarp * c;
          if (j < d_h && pred[q]) {
            const float hv = my_h[q * d_h + j] + dt * (acc[q][c] + b2_k[j]);
            my_h[q * d_h + j] = hv;
            if (scale != kIdentity) my_sc[q * d_h + j] = scale_in(hv, scale);
          }
        }
    }
#pragma unroll
    for (int q = 0; q < RPW; ++q)
      if (pred[q]) t[q] += dt;
    __syncwarp();
  }
  __syncwarp();

  const int n_mine = (R - row0 - r_w) * d_h;  // valid entries of my rows
  for (int idx = lane; idx < RPW * d_h && idx < n_mine; idx += kWarp)
    hout[g0 + (size_t)r_w * d_h + idx] = my_h[idx];
  if (k == 0 && lane == 0) {
#pragma unroll
    for (int q = 0; q < RPW; ++q)
      if (valid[q]) tout[row0 + r_w + q] = t[q];
  }
}

template <int CPT, bool STAGE>
cudaError_t launch(const float* h0, const float* base, const float* t0,
                   const float* ttgt, const float* w1h, const float* w1t,
                   const float* w2, const float* b2, float* hout, float* tout,
                   int K, int R, int d_h, float dt, int n_sub, int act,
                   int scale, int warps, size_t smem, cudaStream_t stream) {
  auto kernel = gap_scan_fwd_kernel<CPT, kRowsPerWarp, STAGE>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int rows = warps * kRowsPerWarp;
  const int tiles = R > 0 ? (R + rows - 1) / rows : 1;
  kernel<<<dim3(tiles, K), dim3(kWarp, warps), smem, stream>>>(
      h0, base, t0, ttgt, w1h, w1t, w2, b2, hout, tout, R, d_h, dt, n_sub,
      act, scale);
  return cudaGetLastError();
}

template <bool STAGE>
cudaError_t launch_cpt(int cpt, const float* h0, const float* base,
                       const float* t0, const float* ttgt, const float* w1h,
                       const float* w1t, const float* w2, const float* b2,
                       float* hout, float* tout, int K, int R, int d_h,
                       float dt, int n_sub, int act, int scale, int warps,
                       size_t smem, cudaStream_t stream) {
#define NJODE_LAUNCH(C)                                                      \
  return launch<C, STAGE>(h0, base, t0, ttgt, w1h, w1t, w2, b2, hout, tout, \
                          K, R, d_h, dt, n_sub, act, scale, warps, smem,    \
                          stream)
  switch (cpt) {
    case 1: NJODE_LAUNCH(1);
    case 2: NJODE_LAUNCH(2);
    case 4: NJODE_LAUNCH(4);
    default: NJODE_LAUNCH(8);
  }
#undef NJODE_LAUNCH
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int njode_gap_scan_fwd(const void* h0, const void* base,
                                  const void* t0, const void* ttgt,
                                  const void* w1h, const void* w1t,
                                  const void* w2, const void* b2, void* hout,
                                  void* tout, int K, int R, int d_h, float dt,
                                  int n_sub, int act, int scale,
                                  void* stream) {
  if (K <= 0 || K > 65535 || R < 0 || d_h <= 0 || n_sub < 0 || act < 0 ||
      act > kSelu || scale < 0 || scale > kScaleSigmoid)
    return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;

  // columns per lane: the power of two covering d_h in one chunk, at most 8
  // (wider d_h loops over 256-column chunks)
  const int chunks = (d_h + kWarp - 1) / kWarp;
  int cpt = 1;
  while (cpt < chunks && cpt < 8) cpt *= 2;

  // shared row buffers: h, hid, base (+ s(h) unless identity scaling);
  // halve the warps per block until the tile fits
  const size_t n_buf = scale == kIdentity ? 3 : 4;
  int warps = kMaxWarps;
  size_t buf = n_buf * warps * kRowsPerWarp * d_h * sizeof(float);
  while (buf > (size_t)max_smem && warps > 1) {
    warps /= 2;
    buf /= 2;
  }
  if (buf > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const size_t w_bytes = 2 * (size_t)d_h * d_h * sizeof(float);
  const bool stage = buf + w_bytes <= kStageBytes;
  const size_t smem = stage ? buf + w_bytes : buf;

  const float* f_h0 = static_cast<const float*>(h0);
  const float* f_base = static_cast<const float*>(base);
  const float* f_t0 = static_cast<const float*>(t0);
  const float* f_ttgt = static_cast<const float*>(ttgt);
  const float* f_w1h = static_cast<const float*>(w1h);
  const float* f_w1t = static_cast<const float*>(w1t);
  const float* f_w2 = static_cast<const float*>(w2);
  const float* f_b2 = static_cast<const float*>(b2);
  float* f_hout = static_cast<float*>(hout);
  float* f_tout = static_cast<float*>(tout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage)
    err = launch_cpt<true>(cpt, f_h0, f_base, f_t0, f_ttgt, f_w1h, f_w1t, f_w2,
                           f_b2, f_hout, f_tout, K, R, d_h, dt, n_sub, act,
                           scale, warps, smem, s);
  else
    err = launch_cpt<false>(cpt, f_h0, f_base, f_t0, f_ttgt, f_w1h, f_w1t,
                            f_w2, f_b2, f_hout, f_tout, K, R, d_h, dt, n_sub,
                            act, scale, warps, smem, s);
  return (int)err;
}

extern "C" const char* njode_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
