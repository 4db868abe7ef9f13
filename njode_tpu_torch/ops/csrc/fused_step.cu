// The fused whole training step on Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels njode_tpu/ops/fused_step.py:_fwd_kernel (line 223)
// and :_bwd_kernel (line 316).  Without dt_ode_step every gap is one Euler
// step and the jump resets the latent state at every observation, so per
// network kn and trajectory row the step is local to each slot s:
//
//   HJ_s   = act(... act(sum_d x_s[d] j1[d] + bj0) J_1 + bj_1 ...)      jump
//   ya_s   = readout(HJ_s)                                   after the jump
//   G      = act(s(HJ_s) W1h + BASE_s), then the mid layers       (s < N-1)
//   BASE_s = t_s w1t + DT w1d + b1 + sum_d s(x_s[d]) w1x[d],  DT = t_{s+1} - t_s
//   HM     = HJ_s + DT (G Wlast + blast),  yb_{s+1} = readout(HM)
//   readout(U) = act(... act(U O_0 + bo_0) ...) . o2 rows
//
// x enters the jump unscaled and the ODE scaled.  bo2 is added outside.
//
// What bounds it on the H100: the f32 products, 2 H^2 flops per row and
// plane pass (1.84 MFLOP per trajectory forward at H 256, K 2, N 2; the
// backward, which rematerializes the forward, three times that), on the
// CUDA cores (TF32 and the tensor cores are a later step).  The TPU kernel
// keeps every weight plane in VMEM; at H 256 one f32 plane is 256 KB, more
// than a block's shared memory, so here each block keeps its row tile's
// activations in shared memory between layers and streams each plane
// through a shared stage of kStages slices of kSliceK rows by asynchronous
// copies (tile_mm): the copies of the next slices overlap the products of
// this one, which the L2 latency otherwise bounds with 8 warps an SM.  A
// block is 8 warps over a tile of RT = 8 RPW rows (64 forward; 32 or 16
// backward, where 3 L + 3 buffers must fit): warp w owns rows w RPW .. w
// RPW + RPW - 1 and lane l the columns l + 32 c, so a product reads each
// weight row once per warp and each activation as a warp-wide broadcast,
// and holds the whole RT x H result in registers: a layer can overwrite
// its own input after a barrier.  Activations are kept as values; the
// backward takes act' from the value (relu, tanh, sigmoid, elu, leaky relu
// and selu all allow it).
//
// The weight-gradient sums cross row tiles, and blocks run concurrently, so
// no float atomics (two calls must be bitwise equal): each block writes its
// tile's partial dW and dV (A^T G for every plane, column sums for every V
// row, summed over its slots in slot order), and a second kernel sums the
// partials in tile order.  At B 4096, H 256, K 2 the partials are 128
// tiles x 2 x 1.06 MB, written and read once per call.
//
// The build: the product with its epilogue (mm_store) and the weight-
// gradient sum (outer_sum) are device functions kept out of line, one copy
// per template instance shared by both kernels, and only the instances the
// launch plan picks are built; with everything inlined the source took
// ten times as long to compile.
//
// The bf16 instances (rows 9b and 10b: compute_dtype=bfloat16, the TPU
// kernels' cdt mode, fused_step.py:236-239, :336-346) are the same kernels
// with the weight type T = __nv_bfloat16: W and WT arrive as bf16 planes
// (cast once by the wrapper), a staged slice holds twice the rows in the
// same bytes, and every product rounds its activation operand to bf16
// (operand<T>) and widens both operands to f32 before the f32 fma, which is
// JAX's dot(a.astype(bf16), w_bf16, preferred_element_type=f32): the
// product of two bf16 values is exact in f32, so only the order of the f32
// sums differs.  The weight-gradient sums round both operands.  The
// activations stay f32 in shared memory and are rounded where a product
// reads them, after their f32 epilogue; V, the epilogues, the column sums,
// the partials and the tile-order reduce stay f32.  The bf16 instances are
// built for 8 columns a lane only (the scaled recipe's H 256), which serves
// any H <= 256 with idle columns below 129, to keep the build short.
//
// Layout (contiguous): x (B, N, d_x) and t (B, N) f32; W, WT (Kn, n_mats,
// H, H) in T, W (in, out) and WT its transpose per plane; V (Kn, n_rows, H)
// f32; Y and gy (B, 2N-1, d_y, K) f32: slots 0..N-1 after the jump,
// N..2N-2 before slots 1..N-1.  Planes: J_1..J_L, O_0..O_{L-1}, W1h,
// Wmid_1..Wmid_{L-1}, Wlast.  Rows: j1[d_x], bj[0..L], w1x[d_x], w1t, w1d,
// ob[0..L], bo[0..L-1], o2 (d_y rows; shared: K d_y rows, c = d K + k).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "walk_cell.cuh"

// the blocks' dynamic shared memory (both kernels)
extern __shared__ float njode_step_smem[];

namespace {

using namespace njode_walk;

constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
constexpr int kSliceK = 8;      // f32 weight rows per staged slice
constexpr int kStages = 3;      // slices in flight

using bf16 = __nv_bfloat16;

// a staged slice is kSliceK f32 rows' bytes: 8 rows of f32, 16 of bf16
template <typename T>
constexpr int kSliceRows = kSliceK * (int)(sizeof(float) / sizeof(T));

// a weight as the product reads it
__device__ __forceinline__ float wval(float w) { return w; }
__device__ __forceinline__ float wval(bf16 w) { return __bfloat162float(w); }

// an activation operand at the product: as is, or rounded to bf16 (to
// nearest even) and widened back
template <typename T>
__device__ __forceinline__ float operand(float a) { return a; }
template <>
__device__ __forceinline__ float operand<bf16>(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

struct Layout {
  int L, d_x, d_y, K, shared, Kn, n_mats, n_rows;
  int mat_w1h, mat_last, row_j1, row_bj, row_w1x, row_w1t, row_w1d, row_ob, row_bo, row_o2;
};

Layout make_layout(int L, int d_x, int d_y, int K, int shared) {
  Layout lo;
  lo.L = L; lo.d_x = d_x; lo.d_y = d_y; lo.K = K; lo.shared = shared;
  lo.Kn = shared ? 1 : K;
  lo.n_mats = 3 * L + 1;
  lo.mat_w1h = 2 * L;
  lo.mat_last = 3 * L;
  int r = 0;
  lo.row_j1 = r; r += d_x;
  lo.row_bj = r; r += L + 1;
  lo.row_w1x = r; r += d_x;
  lo.row_w1t = r; r += 1;
  lo.row_w1d = r; r += 1;
  lo.row_ob = r; r += L + 1;
  lo.row_bo = r; r += L;
  lo.row_o2 = r;
  lo.n_rows = r + (shared ? K * d_y : d_y);
  return lo;
}

__device__ __forceinline__ int o2_row(const Layout& lo, int kk, int d) {
  return lo.row_o2 + (lo.shared ? d * lo.K + kk : d);
}

// act'(pre) from v = act(pre)
__device__ __forceinline__ float act_grad_v(float v, int act) {
  switch (act) {
    case kTanh: return 1.0f - v * v;
    case kSigmoid: return v * (1.0f - v);
    case kElu: return v > 0.0f ? 1.0f : v + 1.0f;
    case kLeakyRelu: return v > 0.0f ? 1.0f : 0.01f;
    case kSelu: return v > 0.0f ? kSeluL : v + kSeluL * kSeluA;
    default: return v > 0.0f ? 1.0f : 0.0f;
  }
}

// acc[q][c] = sum_k operand(A[(warp RPW + q) H + k]) W[k H + j], j = lane
// + 32 c: A a row tile in shared memory, W an (in, out) plane in device
// memory.  Where a row of W is whole 16-byte chunks (H % 4 == 0 in f32,
// H % 8 == 0 in bf16) the plane streams through the shared stage buffer
// (offset 0) in slices of kSliceRows<T> rows, kStages deep, by
// asynchronous copies, so the loads of later slices overlap the products
// of this one; each row of A is then read four k at a time.  Otherwise W is
// read from device memory directly.  Either way k runs in order.
template <int CPT, int RPW, typename T>
__device__ __forceinline__ void tile_mm(const float* A, const T* __restrict__ W, int H,
                                        int warp, int lane, float (&acc)[RPW][CPT]) {
  constexpr int kRows = kSliceRows<T>, kVec = 16 / (int)sizeof(T);
#pragma unroll
  for (int q = 0; q < RPW; ++q)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[q][c] = 0.0f;
  const float* a = A + (size_t)warp * RPW * H;
  auto step = [&](const T* wrow, const float (&av)[RPW]) {
    float w[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      w[c] = j < H ? wval(wrow[j]) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < RPW; ++q)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[q][c] = fmaf(av[q], w[c], acc[q][c]);
  };
  if (H % kVec != 0) {
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      float av[RPW];
#pragma unroll
      for (int q = 0; q < RPW; ++q) av[q] = operand<T>(a[q * H + k]);
      float w[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        w[c] = j < H ? wval(__ldg(W + (size_t)k * H + j)) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < RPW; ++q)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[q][c] = fmaf(av[q], w[c], acc[q][c]);
    }
    return;
  }
  T* stage = reinterpret_cast<T*>(njode_step_smem);
  const int n_slices = (H + kRows - 1) / kRows;
  auto fetch = [&](int sl) {       // every thread commits a group, maybe empty
    if (sl < n_slices) {
      const int k0 = sl * kRows, n16 = min(kRows, H - k0) * H / kVec;
      T* dst = stage + (sl % kStages) * kRows * H;
      const T* src = W + (size_t)k0 * H;
      for (int e = threadIdx.x; e < n16; e += kThreads)
        __pipeline_memcpy_async(dst + kVec * e, src + kVec * e, 16);
    }
    __pipeline_commit();
  };
  for (int sl = 0; sl + 1 < kStages; ++sl) fetch(sl);
#pragma unroll 1
  for (int sl = 0; sl < n_slices; ++sl) {
    __pipeline_wait_prior(kStages - 2);    // slice sl has landed
    __syncthreads();                       // for every thread; slice sl - 1 is done
    fetch(sl + kStages - 1);               // into the buffer of slice sl - 1
    const T* ws = stage + (sl % kStages) * kRows * H;
    const int k0 = sl * kRows, rows = min(kRows, H - k0);
#pragma unroll 1
    for (int kk = 0; kk < rows; kk += 4) {
      float4 a4[RPW];
#pragma unroll
      for (int q = 0; q < RPW; ++q)
        a4[q] = *reinterpret_cast<const float4*>(a + q * H + k0 + kk);
      float av[RPW];
#pragma unroll
      for (int q = 0; q < RPW; ++q) av[q] = operand<T>(a4[q].x);
      step(ws + kk * H, av);
#pragma unroll
      for (int q = 0; q < RPW; ++q) av[q] = operand<T>(a4[q].y);
      step(ws + (kk + 1) * H, av);
#pragma unroll
      for (int q = 0; q < RPW; ++q) av[q] = operand<T>(a4[q].z);
      step(ws + (kk + 2) * H, av);
#pragma unroll
      for (int q = 0; q < RPW; ++q) av[q] = operand<T>(a4[q].w);
      step(ws + (kk + 3) * H, av);
    }
  }
}

// out[r][j] = f(r, j, acc[q][c]) over the warp's rows and the lane's columns
template <int CPT, int RPW, typename F>
__device__ __forceinline__ void tile_store(float* out, const float (&acc)[RPW][CPT], int H,
                                           int warp, int lane, F f) {
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    const int r = warp * RPW + q;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) out[r * H + j] = f(r, j, acc[q][c]);
    }
  }
}

// out[r][j] = act(out[r][j]) over the entries tile_store gave this thread
// (no barrier needed between the two); a loop, not unrolled, so the
// activation's code appears once
template <int RPW>
__device__ __forceinline__ void tile_act(float* out, int H, int warp, int lane, int act) {
#pragma unroll 1
  for (int q = 0; q < RPW; ++q) {
    float* o = out + (warp * RPW + q) * H;
#pragma unroll 1
    for (int j = lane; j < H; j += kWarp) o[j] = activate(o[j], act);
  }
}

// the ODEFunc's first layer before act: acc + t0 w1t + DT w1d + b1 + sum_d
// s(x)[d] w1x[d], for slot s of the tile's rows (no transcendental here:
// it is unrolled over the thread's whole tile)
struct GapBase {
  const float *w1t, *w1d, *b1, *w1x;  // w1x: d_x rows of H
  const float *s_t, *s_xs;
  int N, H, d_x, s;
  __device__ __forceinline__ float dt(int r) const {
    return s_t[r * N + s + 1] - s_t[r * N + s];
  }
  __device__ __forceinline__ float operator()(int r, int j, float v) const {
    float base = s_t[r * N + s] * __ldg(w1t + j) + dt(r) * __ldg(w1d + j) + __ldg(b1 + j);
    for (int d = 0; d < d_x; ++d)
      base = base + s_xs[(r * N + s) * d_x + d] * __ldg(w1x + (size_t)d * H + j);
    return v + base;
  }
};

// what mm_store writes for the product v of entry (r, j)
enum EpiMode {
  kBias,       // v + b[j]
  kGap,        // v + BASE (GapBase)
  kEuler,      // HJ[r][j] + DT (v + b[j]), HJ at shared offset `res`
  kCopy,       // v
  kAdd,        // out[r][j] + v
  kAddScaled,  // out[r][j] + v sg[r][j], sg at shared offset `res`
};

struct Epi {
  int mode, act;  // act < 0: none, else applied after the store
  const float* b;
  GapBase gap;
  int res;
};

__device__ __forceinline__ Epi epi(int mode, int act = -1, const float* b = nullptr,
                                   GapBase gap = GapBase{}, int res = 0) {
  return Epi{mode, act, b, gap, res};
}

// out = epilogue(A W_m) for the block's row tile: A and out at offsets of
// the dynamic shared memory (out may be A: the product is held in
// registers across a barrier), W a plane in device memory.  Not inlined:
// one copy per (T, CPT, RPW), shared by both kernels, keeps the build
// short.
template <typename T, int CPT, int RPW>
__device__ __noinline__ void mm_store(int a_off, const T* __restrict__ W, int out_off, int H,
                                      Epi e) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float acc[RPW][CPT];
  tile_mm<CPT, RPW>(njode_step_smem + a_off, W, H, warp, lane, acc);
  __syncthreads();
  float* out = njode_step_smem + out_off;
  const float* res = njode_step_smem + e.res;
  const float* b = e.b;
  switch (e.mode) {
    case kBias:
      tile_store<CPT, RPW>(out, acc, H, warp, lane,
                           [&](int, int j, float v) { return v + __ldg(b + j); });
      break;
    case kGap:
      tile_store<CPT, RPW>(out, acc, H, warp, lane, e.gap);
      break;
    case kEuler: {
      const GapBase& g = e.gap;
      tile_store<CPT, RPW>(out, acc, H, warp, lane, [&](int r, int j, float v) {
        return res[r * H + j] + g.dt(r) * (v + __ldg(b + j));
      });
      break;
    }
    case kCopy:
      tile_store<CPT, RPW>(out, acc, H, warp, lane, [](int, int, float v) { return v; });
      break;
    case kAdd:
      tile_store<CPT, RPW>(out, acc, H, warp, lane,
                           [&](int r, int j, float v) { return out[r * H + j] + v; });
      break;
    default:
      tile_store<CPT, RPW>(out, acc, H, warp, lane, [&](int r, int j, float v) {
        return out[r * H + j] + v * res[r * H + j];
      });
  }
  if (e.act >= 0) tile_act<RPW>(out, H, warp, lane, e.act);
  __syncthreads();
}

// P[a H + j] (+)= sum_{r < nr} A[r H + a] G[r H + j] (A, G at shared
// offsets, each rounded as operand<T>): warp w owns the rows a of 8 at a
// time, lane l the columns l + 32 c; every entry one owner and the rows in
// order.  Not inlined.
template <typename T, int CPT>
__device__ __noinline__ void outer_sum(int a_off, int g_off, int nr, int H,
                                       float* __restrict__ P, bool first) {
  constexpr int APW = 8;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const float* A = njode_step_smem + a_off;
  const float* G = njode_step_smem + g_off;
  for (int a0 = warp * APW; a0 < H; a0 += kWarps * APW) {
    // the earlier slots' partial, loaded before the row loop so that its
    // latency overlaps the products (read at the store, it cost a quarter
    // of the backward)
    float old[APW][CPT];
#pragma unroll
    for (int i = 0; i < APW; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        old[i][c] = !first && a0 + i < H && j < H ? P[(size_t)(a0 + i) * H + j] : 0.0f;
      }
    float acc[APW][CPT];
#pragma unroll
    for (int i = 0; i < APW; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
#pragma unroll 2
    for (int r = 0; r < nr; ++r) {
      float g[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        g[c] = j < H ? operand<T>(G[r * H + j]) : 0.0f;
      }
      float av[APW];
#pragma unroll
      for (int i = 0; i < APW; ++i) av[i] = a0 + i < H ? operand<T>(A[r * H + a0 + i]) : 0.0f;
#pragma unroll
      for (int i = 0; i < APW; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(av[i], g[c], acc[i][c]);
    }
#pragma unroll
    for (int i = 0; i < APW; ++i) {
      if (a0 + i >= H) break;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < H) P[(size_t)(a0 + i) * H + j] = first ? acc[i][c] : old[i][c] + acc[i][c];
      }
    }
  }
}

// P[j] (+)= sum_{r < nr} f(r) G[r H + j], one thread a column, rows in order
template <typename F>
__device__ __forceinline__ void tile_colsum(const float* G, int nr, int H, F f,
                                            float* __restrict__ P, bool first) {
  for (int j = threadIdx.x; j < H; j += kThreads) {
    const float old = first ? 0.0f : P[j];
    float s = 0.0f;
    for (int r = 0; r < nr; ++r) s = fmaf(f(r), G[r * H + j], s);
    P[j] = first ? s : old + s;
  }
}

// the block's row scalars: x (RT, N, d_x) and t (RT, N), rows past B zero
__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* dst, int row0,
                                          int nr, int RT, int per_row) {
  for (int e = threadIdx.x; e < RT * per_row; e += kThreads)
    dst[e] = e / per_row < nr ? src[(size_t)row0 * per_row + e] : 0.0f;
}

// dst = s(src) over n entries, each thread the entries load_rows gave it
__device__ __forceinline__ void load_scaled(const float* src, float* dst, int n, int scale) {
  for (int e = threadIdx.x; e < n; e += kThreads) dst[e] = scale_in(src[e], scale);
}

// -------------------------------------------------------------- forward

template <typename T, int CPT, int RPW>
__global__ void __launch_bounds__(kThreads)
step_fwd_kernel(const float* __restrict__ x, const float* __restrict__ t,
                const T* __restrict__ W, const float* __restrict__ V,
                float* __restrict__ Y, int B, int N, int H, Layout lo, int act, int scale) {
  constexpr int RT = RPW * kWarps;
  float* smem = njode_step_smem;
  const int kn = blockIdx.y, warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int row0 = blockIdx.x * RT, nr = min(RT, B - row0);
  const int d_x = lo.d_x, n_out = 2 * N - 1, TH = RT * H;
  const int o_hj = kStages * kSliceK * H, o_wk = o_hj + TH;  // HJ, a work buffer
  float* s_hj = smem + o_hj;
  float* s_wk = smem + o_wk;
  float* s_x = smem + o_wk + TH;
  float* s_xs = s_x + RT * N * d_x;
  float* s_t = s_xs + RT * N * d_x;
  load_rows(x, s_x, row0, nr, RT, N * d_x);
  load_rows(t, s_t, row0, nr, RT, N);
  load_scaled(s_x, s_xs, RT * N * d_x, scale);
  const T* Wk = W + (size_t)kn * lo.n_mats * H * H;
  const float* Vk = V + (size_t)kn * lo.n_rows * H;
  auto plane = [&](int m) { return Wk + (size_t)m * H * H; };
  auto vrow = [&](int r) { return Vk + (size_t)r * H; };
  __syncthreads();

  // act(cur W_m + b) into out (out may be cur)
  auto layer = [&](int cur, int out, int m, int brow) {
    mm_store<T, CPT, RPW>(cur, plane(m), out, H, epi(kBias, act, vrow(brow)));
  };
  // the readout of the tile at offset `in` into Y's slot `ys`, through s_wk
  auto readout = [&](int in, int ys) {
    int cur = in;
    for (int l = 0; l < lo.L; ++l) {
      layer(cur, o_wk, lo.L + l, lo.row_bo + l);
      cur = o_wk;
    }
    const float* u = smem + cur;
    const int k_lo = lo.shared ? 0 : kn, k_hi = lo.shared ? lo.K : kn + 1;
    for (int kk = k_lo; kk < k_hi; ++kk)
      for (int d = 0; d < lo.d_y; ++d) {
        const float* o2 = vrow(o2_row(lo, kk, d));
        for (int q = 0; q < RPW; ++q) {
          const int r = warp * RPW + q;
          float s = 0.0f;
          for (int j = lane; j < H; j += kWarp) s = fmaf(u[r * H + j], __ldg(o2 + j), s);
          s = warp_sum(s);
          if (lane == 0 && r < nr)
            Y[(((size_t)(row0 + r) * n_out + ys) * lo.d_y + d) * lo.K + kk] = s;
        }
      }
    __syncthreads();
  };

  for (int s = 0; s < N; ++s) {
    // jump: layer 0 is rank d_x, elementwise
    {
      const float* b0 = vrow(lo.row_bj);
      for (int e = threadIdx.x; e < TH; e += kThreads) {
        const int r = e / H, j = e - r * H;
        float pre = __ldg(b0 + j);
        for (int d = 0; d < d_x; ++d)
          pre = pre + s_x[(r * N + s) * d_x + d] * __ldg(vrow(lo.row_j1 + d) + j);
        s_hj[e] = activate(pre, act);
      }
      __syncthreads();
    }
    for (int l = 0; l < lo.L; ++l) layer(o_hj, o_hj, l, lo.row_bj + l + 1);
    readout(o_hj, s);
    if (s == N - 1) break;

    // the gap s -> s + 1: one Euler step from HJ_s
    int src = o_hj;
    if (scale != kIdentity) {
      for (int e = threadIdx.x; e < TH; e += kThreads) s_wk[e] = scale_in(s_hj[e], scale);
      __syncthreads();
      src = o_wk;
    }
    const GapBase gap{vrow(lo.row_w1t), vrow(lo.row_w1d), vrow(lo.row_ob), vrow(lo.row_w1x),
                      s_t, s_xs, N, H, d_x, s};
    mm_store<T, CPT, RPW>(src, plane(lo.mat_w1h), o_wk, H, epi(kGap, act, nullptr, gap));
    for (int i = 0; i + 1 < lo.L; ++i) layer(o_wk, o_wk, 2 * lo.L + 1 + i, lo.row_ob + i + 1);
    mm_store<T, CPT, RPW>(o_wk, plane(lo.mat_last), o_wk, H,
                          epi(kEuler, -1, vrow(lo.row_ob + lo.L), gap, o_hj));
    readout(o_wk, N + s);
  }
}

// ------------------------------------------------------------- backward

template <typename T, int CPT, int RPW>
__global__ void __launch_bounds__(kThreads)
step_bwd_kernel(const float* __restrict__ x, const float* __restrict__ t,
                const T* __restrict__ W, const T* __restrict__ WT,
                const float* __restrict__ V, const float* __restrict__ gy,
                float* __restrict__ partial, int B, int N, int H, Layout lo, int act,
                int scale) {
  constexpr int RT = RPW * kWarps;
  float* smem = njode_step_smem;
  const int kn = blockIdx.y;
  const int row0 = blockIdx.x * RT, nr = min(RT, B - row0);
  const int L = lo.L, d_x = lo.d_x, n_out = 2 * N - 1, n_gy = n_out * lo.d_y * lo.K;
  const int TH = RT * H;
  const int o_jp = kStages * kSliceK * H;  // L buffers: the jump's layer values
  const int o_up = o_jp + L * TH;   // L: the readout's
  const int o_gp = o_up + L * TH;   // L: the ODEFunc's hidden layers
  const int o_hm = o_gp + L * TH;
  const int o_g = o_hm + TH;        // dHJ
  const int o_g2 = o_g + TH;        // the gap's cotangents, scratch
  float* s_up = smem + o_up;
  float* s_hm = smem + o_hm;
  float* s_g = smem + o_g;
  float* s_g2 = smem + o_g2;
  float* s_x = smem + o_g2 + TH;
  float* s_xs = s_x + RT * N * d_x;
  float* s_t = s_xs + RT * N * d_x;
  float* s_gy = s_t + RT * N;
  load_rows(x, s_x, row0, nr, RT, N * d_x);
  load_rows(t, s_t, row0, nr, RT, N);
  load_rows(gy, s_gy, row0, nr, RT, n_gy);
  load_scaled(s_x, s_xs, RT * N * d_x, scale);
  const size_t plane_sz = (size_t)H * H;
  const T* Wk = W + (size_t)kn * lo.n_mats * plane_sz;
  const T* WTk = WT + (size_t)kn * lo.n_mats * plane_sz;
  const float* Vk = V + (size_t)kn * lo.n_rows * H;
  const size_t psz = lo.n_mats * plane_sz + (size_t)lo.n_rows * H;
  float* Pk = partial + ((size_t)blockIdx.x * lo.Kn + kn) * psz;
  auto vrow = [&](int r) { return Vk + (size_t)r * H; };
  auto pw = [&](int m) { return Pk + m * plane_sz; };
  auto pv = [&](int r) { return Pk + lo.n_mats * plane_sz + (size_t)r * H; };
  auto one = [](int) { return 1.0f; };
  __syncthreads();

  auto layer = [&](int cur, int out, int m, int brow) {
    mm_store<T, CPT, RPW>(cur, Wk + m * plane_sz, out, H, epi(kBias, act, vrow(brow)));
  };
  // g = g W_m^T, in place
  auto back = [&](int g, int m) {
    mm_store<T, CPT, RPW>(g, WTk + m * plane_sz, g, H, epi(kCopy));
  };
  auto times_act_grad = [&](float* g, const float* val) {
    for (int e = threadIdx.x; e < TH; e += kThreads) g[e] *= act_grad_v(val[e], act);
    __syncthreads();
  };
  auto gyv = [&](int r, int ys, int d, int kk) {
    return s_gy[r * n_gy + (ys * lo.d_y + d) * lo.K + kk];
  };
  auto a1 = [&](int s) {           // the jump's layer 0 into s_g2
    for (int e = threadIdx.x; e < TH; e += kThreads) {
      const int r = e / H, j = e - r * H;
      float pre = __ldg(vrow(lo.row_bj) + j);
      for (int d = 0; d < d_x; ++d)
        pre = pre + s_x[(r * N + s) * d_x + d] * __ldg(vrow(lo.row_j1 + d) + j);
      s_g2[e] = activate(pre, act);
    }
    __syncthreads();
  };
  // the readout of the tile at `in` rematerialized, then its backward into
  // the tile at `g` for Y's slot ys: the o2 and readout rows' sums, and
  // g = dU_in
  auto readout_bwd = [&](int in, int ys, int g, bool first) {
    int cur = in;
    for (int l = 0; l < L; ++l) {
      layer(cur, o_up + l * TH, L + l, lo.row_bo + l);
      cur = o_up + l * TH;
    }
    float* gp = smem + g;
    const int k_lo = lo.shared ? 0 : kn, k_hi = lo.shared ? lo.K : kn + 1;
    for (int e = threadIdx.x; e < TH; e += kThreads) {
      const int r = e / H, j = e - r * H;
      float sum = 0.0f;
      for (int kk = k_lo; kk < k_hi; ++kk)
        for (int d = 0; d < lo.d_y; ++d)
          sum = sum + gyv(r, ys, d, kk) * __ldg(vrow(o2_row(lo, kk, d)) + j);
      gp[e] = sum;
    }
    for (int kk = k_lo; kk < k_hi; ++kk)
      for (int d = 0; d < lo.d_y; ++d)
        tile_colsum(smem + cur, nr, H, [&](int r) { return gyv(r, ys, d, kk); },
                    pv(o2_row(lo, kk, d)), first);
    __syncthreads();
    for (int l = L - 1; l >= 0; --l) {
      times_act_grad(gp, s_up + l * TH);
      outer_sum<T, CPT>(l == 0 ? in : o_up + (l - 1) * TH, g, nr, H, pw(L + l), first);
      tile_colsum(gp, nr, H, one, pv(lo.row_bo + l), first);
      __syncthreads();
      back(g, L + l);
    }
  };

  for (int s = 0; s < N; ++s) {
    const bool first = s == 0;
    // ---- rematerialize the jump
    a1(s);
    for (int l = 0; l < L; ++l)
      layer(l == 0 ? o_g2 : o_jp + (l - 1) * TH, o_jp + l * TH, l, lo.row_bj + l + 1);
    const int o_hj = o_jp + (L - 1) * TH;
    const float* hj = smem + o_hj;
    // ---- the readout after the jump: dHJ into s_g
    readout_bwd(o_hj, s, o_g, first);

    if (s < N - 1) {
      // ---- rematerialize the gap s -> s + 1
      const GapBase gap{vrow(lo.row_w1t), vrow(lo.row_w1d), vrow(lo.row_ob), vrow(lo.row_w1x),
                        s_t, s_xs, N, H, d_x, s};
      auto dt_of = [&](int r) { return gap.dt(r); };
      int src = o_hj;
      if (scale != kIdentity) {
        for (int e = threadIdx.x; e < TH; e += kThreads) s_g2[e] = scale_in(hj[e], scale);
        __syncthreads();
        src = o_g2;
      }
      mm_store<T, CPT, RPW>(src, Wk + lo.mat_w1h * plane_sz, o_gp, H,
                            epi(kGap, act, nullptr, gap));
      for (int i = 0; i + 1 < L; ++i)
        layer(o_gp + i * TH, o_gp + (i + 1) * TH, 2 * L + 1 + i, lo.row_ob + i + 1);
      mm_store<T, CPT, RPW>(o_gp + (L - 1) * TH, Wk + lo.mat_last * plane_sz, o_hm, H,
                            epi(kEuler, -1, vrow(lo.row_ob + L), gap, o_hj));
      // ---- the readout before slot s + 1: dHM into s_g2
      readout_bwd(o_hm, N + s, o_g2, false);
      // ---- the gap's backward: dHJ += dHM, dDH = DT dHM
      for (int e = threadIdx.x; e < TH; e += kThreads) {
        s_g[e] += s_g2[e];
        s_g2[e] *= dt_of(e / H);
      }
      __syncthreads();
      outer_sum<T, CPT>(o_gp + (L - 1) * TH, o_g2, nr, H, pw(lo.mat_last), first);
      tile_colsum(s_g2, nr, H, one, pv(lo.row_ob + L), first);
      __syncthreads();
      back(o_g2, lo.mat_last);
      for (int i = L - 2; i >= 0; --i) {
        times_act_grad(s_g2, smem + o_gp + (i + 1) * TH);
        outer_sum<T, CPT>(o_gp + i * TH, o_g2, nr, H, pw(2 * L + 1 + i), first);
        tile_colsum(s_g2, nr, H, one, pv(lo.row_ob + i + 1), first);
        __syncthreads();
        back(o_g2, 2 * L + 1 + i);
      }
      times_act_grad(s_g2, smem + o_gp);                // dG1_pre
      int hs = o_hj;
      if (scale != kIdentity) {
        for (int e = threadIdx.x; e < TH; e += kThreads) s_hm[e] = scale_in(hj[e], scale);
        __syncthreads();
        hs = o_hm;
      }
      outer_sum<T, CPT>(hs, o_g2, nr, H, pw(lo.mat_w1h), first);
      for (int d = 0; d < d_x; ++d)
        tile_colsum(s_g2, nr, H, [&](int r) { return s_xs[(r * N + s) * d_x + d]; },
                    pv(lo.row_w1x + d), first);
      tile_colsum(s_g2, nr, H, [&](int r) { return s_t[r * N + s]; }, pv(lo.row_w1t), first);
      tile_colsum(s_g2, nr, H, dt_of, pv(lo.row_w1d), first);
      tile_colsum(s_g2, nr, H, one, pv(lo.row_ob), first);
      // dHJ += (dG1_pre W1h^T) s'(HJ), s'(HJ) in s_up (free: the readouts
      // are done)
      if (scale != kIdentity)
        for (int e = threadIdx.x; e < TH; e += kThreads) s_up[e] = scale_grad(hj[e], scale);
      __syncthreads();
      mm_store<T, CPT, RPW>(o_g2, WTk + lo.mat_w1h * plane_sz, o_g, H,
                            scale != kIdentity ? epi(kAddScaled, -1, nullptr, GapBase{}, o_up)
                                               : epi(kAdd));
    }

    // ---- the jump's backward
    for (int l = L - 1; l >= 0; --l) {
      times_act_grad(s_g, smem + o_jp + l * TH);
      if (l == 0) a1(s);
      outer_sum<T, CPT>(l == 0 ? o_g2 : o_jp + (l - 1) * TH, o_g, nr, H, pw(l), first);
      tile_colsum(s_g, nr, H, one, pv(lo.row_bj + l + 1), first);
      __syncthreads();
      back(o_g, l);
    }
    times_act_grad(s_g, s_g2);                         // s_g2 holds layer 0
    for (int d = 0; d < d_x; ++d)
      tile_colsum(s_g, nr, H, [&](int r) { return s_x[(r * N + s) * d_x + d]; },
                  pv(lo.row_j1 + d), first);
    tile_colsum(s_g, nr, H, one, pv(lo.row_bj), first);
    __syncthreads();
  }
  if (N == 1) {                    // no gap: the ODEFunc's sums are zero
    for (size_t e = threadIdx.x; e < (size_t)(L + 1) * plane_sz; e += kThreads)
      pw(lo.mat_w1h)[e] = 0.0f;
    for (int e = threadIdx.x; e < (d_x + 2) * H; e += kThreads) pv(lo.row_w1x)[e] = 0.0f;
    for (int e = threadIdx.x; e < (L + 1) * H; e += kThreads) pv(lo.row_ob)[e] = 0.0f;
  }
}

// dW[kn][m] = sum_tiles partial[tile][kn][m], dV likewise, in tile order
__global__ void step_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dW,
                                   float* __restrict__ dV, int tiles, int Kn, long long w_per,
                                   long long v_per) {
  const long long psz = w_per + v_per;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= Kn * psz) return;
  const long long kn = e / psz, off = e - kn * psz;
  float sum = 0.0f;
  for (int t = 0; t < tiles; ++t) sum += partial[((long long)t * Kn + kn) * psz + off];
  if (off < w_per) dW[kn * w_per + off] = sum;
  else dV[kn * v_per + off - w_per] = sum;
}

int cpt_of(int H) { return H <= 32 ? 1 : (H <= 64 ? 2 : (H <= 128 ? 4 : 8)); }

// per block: the weight stage, the tile's activation buffers, then x, s(x)
// and t (and gy)
size_t fwd_smem_floats(int RT, int H, int N, int d_x) {
  return (size_t)kStages * kSliceK * H + 2 * (size_t)RT * H + (size_t)RT * N * (2 * d_x + 1);
}

size_t bwd_smem_floats(int RT, int H, int N, const Layout& lo) {
  return (size_t)kStages * kSliceK * H + (size_t)(3 * lo.L + 3) * RT * H +
         (size_t)RT * N * (2 * lo.d_x + 1) + (size_t)RT * (2 * N - 1) * lo.d_y * lo.K;
}

int check_args(int B, int N, int H, int L, int d_x, int d_y, int K, int act, int scale, int rpw,
               size_t smem) {
  if (B < 1 || N < 1 || H < 1 || H > 256 || L < 1 || d_x < 1 || d_y < 1 || K < 1 ||
      K > 65535 || act < 0 || act > kSelu || scale < 0 || scale > kScaleSigmoid ||
      (rpw != 1 && rpw != 2 && rpw != 4 && rpw != 8))
    return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const float *x, *t;
  const void *W, *WT;
  const float *V, *gy;
  float *Y, *partial;
  int B, N, H;
  Layout lo;
  int act, scale;
};

template <typename T, int C, int R>
cudaError_t launch_fwd(const Args& a, dim3 grid, size_t smem, cudaStream_t s) {
  auto kern = step_fwd_kernel<T, C, R>;
  cudaError_t e = set_smem(kern, smem);
  if (e == cudaSuccess)
    kern<<<grid, kThreads, smem, s>>>(a.x, a.t, static_cast<const T*>(a.W), a.V, a.Y, a.B, a.N,
                                      a.H, a.lo, a.act, a.scale);
  return e;
}

template <typename T, int C, int R>
cudaError_t launch_bwd(const Args& a, dim3 grid, size_t smem, cudaStream_t s) {
  auto kern = step_bwd_kernel<T, C, R>;
  cudaError_t e = set_smem(kern, smem);
  if (e == cudaSuccess)
    kern<<<grid, kThreads, smem, s>>>(a.x, a.t, static_cast<const T*>(a.W),
                                      static_cast<const T*>(a.WT), a.V, a.gy, a.partial, a.B,
                                      a.N, a.H, a.lo, a.act, a.scale);
  return e;
}

// The (T, CPT, RPW) instances: the forward's tile is 64 rows, the
// backward's 32 or 16 (ops/fused_step.py FWD_RPW, BWD_RPW); f32 for every
// CPT, bf16 at CPT 8 only (see the top of the file).
cudaError_t dispatch_fwd(bool wbf16, int cpt, int rpw, const Args& a, dim3 grid, size_t smem,
                         cudaStream_t s) {
  if (rpw != 8) return cudaErrorInvalidValue;
  if (wbf16) return launch_fwd<bf16, 8, 8>(a, grid, smem, s);
  switch (cpt) {
    case 1: return launch_fwd<float, 1, 8>(a, grid, smem, s);
    case 2: return launch_fwd<float, 2, 8>(a, grid, smem, s);
    case 4: return launch_fwd<float, 4, 8>(a, grid, smem, s);
    default: return launch_fwd<float, 8, 8>(a, grid, smem, s);
  }
}

cudaError_t dispatch_bwd(bool wbf16, int cpt, int rpw, const Args& a, dim3 grid, size_t smem,
                         cudaStream_t s) {
  if (rpw != 4 && rpw != 2) return cudaErrorInvalidValue;
  if (wbf16)
    return rpw == 4 ? launch_bwd<bf16, 8, 4>(a, grid, smem, s)
                    : launch_bwd<bf16, 8, 2>(a, grid, smem, s);
  switch (cpt) {
    case 1: return rpw == 4 ? launch_bwd<float, 1, 4>(a, grid, smem, s)
                            : launch_bwd<float, 1, 2>(a, grid, smem, s);
    case 2: return rpw == 4 ? launch_bwd<float, 2, 4>(a, grid, smem, s)
                            : launch_bwd<float, 2, 2>(a, grid, smem, s);
    case 4: return rpw == 4 ? launch_bwd<float, 4, 4>(a, grid, smem, s)
                            : launch_bwd<float, 4, 2>(a, grid, smem, s);
    default: return rpw == 4 ? launch_bwd<float, 8, 4>(a, grid, smem, s)
                             : launch_bwd<float, 8, 2>(a, grid, smem, s);
  }
}

}  // namespace

// The forward: Y (B, 2N-1, d_y, K) without bo2.  rpw: rows per warp of the
// block's tile (ops/fused_step.py launch_plan); wbf16: W is bf16 (row 9b)
// rather than f32 (row 9).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int njode_step_fwd(const void* x, const void* t, const void* W, const void* V,
                              void* Y, int B, int N, int H, int L, int d_x, int d_y, int K,
                              int shared, int act, int scale, int rpw, int wbf16,
                              void* stream) {
  const int RT = rpw * kWarps;
  const size_t smem = fwd_smem_floats(RT, H, N, d_x) * sizeof(float);
  int err = check_args(B, N, H, L, d_x, d_y, K, act, scale, rpw, smem);
  if (err != 0) return err;
  const Layout lo = make_layout(L, d_x, d_y, K, shared);
  const Args a{static_cast<const float*>(x), static_cast<const float*>(t), W, nullptr,
               static_cast<const float*>(V), nullptr, static_cast<float*>(Y), nullptr,
               B, N, H, lo, act, scale};
  const dim3 grid((B + RT - 1) / RT, lo.Kn);
  cudaError_t e = dispatch_fwd(wbf16 != 0, cpt_of(H), rpw, a, grid, smem,
                               static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Floats of the backward's partial buffer: tiles x Kn x (n_mats H^2 + n_rows H).
extern "C" long long njode_step_partial_floats(int B, int H, int L, int d_x, int d_y, int K,
                                               int shared, int rpw) {
  const Layout lo = make_layout(L, d_x, d_y, K, shared);
  const long long tiles = (B + rpw * kWarps - 1) / (rpw * kWarps);
  return tiles * lo.Kn * ((long long)lo.n_mats * H * H + (long long)lo.n_rows * H);
}

// The backward: dW (Kn, n_mats, H, H) and dV (Kn, n_rows, H), f32, the
// cotangents of W and V for gy; partial is scratch of
// njode_step_partial_floats floats; wbf16: W and WT are bf16 (row 10b).
// Two launches on `stream`.
extern "C" int njode_step_bwd(const void* x, const void* t, const void* W, const void* WT,
                              const void* V, const void* gy, void* partial, void* dW, void* dV,
                              int B, int N, int H, int L, int d_x, int d_y, int K, int shared,
                              int act, int scale, int rpw, int wbf16, void* stream) {
  const int RT = rpw * kWarps;
  const Layout lo = make_layout(L, d_x, d_y, K, shared);
  const size_t smem = bwd_smem_floats(RT, H, N, lo) * sizeof(float);
  int err = check_args(B, N, H, L, d_x, d_y, K, act, scale, rpw, smem);
  if (err != 0) return err;
  const int tiles = (B + RT - 1) / RT;
  const Args a{static_cast<const float*>(x), static_cast<const float*>(t), W, WT,
               static_cast<const float*>(V), static_cast<const float*>(gy), nullptr,
               static_cast<float*>(partial), B, N, H, lo, act, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dispatch_bwd(wbf16 != 0, cpt_of(H), rpw, a, dim3(tiles, lo.Kn), smem, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long w_per = (long long)lo.n_mats * H * H, v_per = (long long)lo.n_rows * H;
  const long long n = lo.Kn * (w_per + v_per);
  step_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      a.partial, static_cast<float*>(dW), static_cast<float*>(dV), tiles, lo.Kn, w_per, v_per);
  return (int)cudaGetLastError();
}

extern "C" const char* njode_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
