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
// What bounds it on the H100: the products, 2 H^2 flops per row and plane
// pass (1.84 MFLOP per trajectory forward at H 256, K 2, N 2; the
// backward, which rematerializes the forward, three times that).  The TPU
// kernel keeps every weight plane in VMEM; at H 256 one f32 plane is 256 KB,
// more than a block's shared memory, so here each block keeps its row
// tile's activations in shared memory between layers and streams each plane
// through shared memory by asynchronous copies.
//
// The f32 instances (rows 9 and 10) are step_f32.cuh's: 16 warps a block
// over 32 trajectories, the slots in groups so that each plane is applied
// once to all the rows of a group that use it, f32 fma on the CUDA cores
// over a register tile of contiguous rows and columns, and the backward's
// weight-gradient sums out of the slot walk: it writes each plane's input
// rows and cotangents as records, and a second kernel sums A^T G over the
// whole batch (see the note at the top of step_f32.cuh).  3xTF32 on the
// tensor cores (each operand split into hi = tf32(x) and lo = tf32(x - hi),
// lo.hi + hi.lo + hi.hi) was built and measured on the H100 for them: its
// products carry about 2^-21 of relative error a term against 2^-24 for an
// fma, which doubled the forward's distance from cuBLAS f32 and with it the
// relu kinks that flip under another summation order, and the backward came
// out 4.71e-3 and 2.69e-3 of a plane's norm from the plain version in two of
// phase 17's relu cases (limit 1e-3); it was also slower (PERF.md, section 6).
//
// The bf16 instances (rows 9b and 10b: compute_dtype=bfloat16, the TPU
// kernels' cdt mode, fused_step.py:236-239, :336-346) are the kernels of
// this file.  A block is 8 warps over a tile of RT = 8 RPW rows (64
// forward; 32 or 16 backward, where 3 L + 3 buffers must fit) and walks the
// slots one at a time.  They run their products and weight-gradient sums on
// the tensor cores, mma.sync m16n8k16 with bf16 inputs and f32
// accumulation; W and WT arrive as bf16 planes (cast once by the wrapper).
// A bf16 x bf16 product is exact in f32, so a product is JAX's
// dot(a.astype(bf16), w_bf16, preferred_element_type=f32) with only the
// order of the f32 sums changed.
//   * Products (tile_mm_tc): warp w owns the output columns of n-tiles w
//     NTW .. w NTW + NTW - 1 over all RT rows (MT = RT / 16 row tiles), so
//     each weight column is read by one warp and each activation by all
//     eight, and holds its RT x 8 NTW result in registers: a layer can
//     overwrite its own input after a barrier.  Each warp streams its own
//     columns of the plane through its own strip of the stage, kStages
//     slices of one k-step (16 rows) in flight, by asynchronous copies, so
//     the warps need no block barrier inside a product.  The activation
//     operand is rounded to bf16 (to nearest even) where its fragment is
//     packed, after its f32 epilogue: the buffer stays f32.  Activation
//     rows are act_stride(H) floats apart (8 more than a multiple of 32)
//     and the strip's 16-byte chunks are permuted by row (Strip::pos), so
//     every fragment load is free of shared-memory bank conflicts.  H need
//     not be a multiple of 16: the last k-step masks the activation columns
//     past H, the strip zero-fills its rows past H, and the columns past H
//     are computed and not stored.  Each k-step's products are summed by
//     the tensor cores into a fresh accumulator and added to the running
//     sum in f32 (add4).
//   * Gradient sums (outer_sum_tc): P = A^T G over the tile's RT rows as
//     the k dimension, both operands rounded (as JAX's outer rounds them)
//     and read from the activation buffers; rows of the tile past B carry
//     zero cotangents, so they add exact zeros.
//   * Built for NTW 4 only (the scaled recipe's H 256), which serves any H
//     <= 256 with idle warps, to keep the build short.
//
// Activations are kept as values; the backward takes act' from the value
// (relu, tanh, sigmoid, elu, leaky relu and selu all allow it).
//
// The weight-gradient sums cross row tiles, and blocks run concurrently,
// so no float atomics (two calls must be bitwise equal): each block writes
// its tile's partial dW and dV (A^T G for every plane, column sums for
// every V row, summed over its slots in slot order), and a second kernel
// sums the partials in tile order.  V, the epilogues, the column sums, the
// partials and the tile-order reduce stay f32.
//
// The build: the product with its epilogue (mm_store) and the weight-
// gradient sum (outer_sum) are device functions kept out of line, one copy
// per template instance shared by both kernels, and only the instances the
// launch plan picks are built; with everything inlined the source took
// ten times as long to compile.
//
// Layout: as step_f32.cuh, with W and WT in bf16 for the bf16 instances.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "step_f32.cuh"

namespace {

using namespace njode_step;

constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
constexpr int kSliceK = 16;     // bf16 weight rows per staged slice (one k-step)
constexpr int kStages = 3;      // slices in flight

using bf16 = __nv_bfloat16;

// floats between activation rows in shared memory: 8 more than a multiple
// of 32, so a fragment's 8 rows x 4 column pairs fall in distinct banks
__host__ __device__ __forceinline__ int act_stride(int H) { return (H + 31) / 32 * 32 + 8; }

// floats of the stage: each warp's strip of kStages slices of 16 bf16 rows
// by up to 32 columns (NTW 4)
constexpr int kStageFloats = kWarps * kStages * kSliceK * 32 / 2;

// A warp's staged strip of a bf16 weight plane: the warp's 8 NTW columns
// of 16 rows a slice, row after row, each row's 16-byte chunks (one n-tile
// each) permuted by an XOR of the row (pos), so that ldmatrix's 8 rows of
// one chunk hit distinct banks without padding.
template <int NTW>
struct Strip {
  static constexpr int kVec = 8;                      // bf16 a 16-byte chunk
  static constexpr int kCols = 8 * NTW;
  static constexpr int kCpr = kCols / kVec;           // chunks a row
  static constexpr int kRows = kSliceK;
  static constexpr int kSlice = kRows * kCols;        // elements a slice
  __device__ static int pos(int r, int c) { return c ^ ((r >> 1) & (kCpr - 1)); }
  // element (r, n) of a slice, n the strip's column
  __device__ static int at(int r, int n) {
    return r * kCols + pos(r, n / kVec) * kVec + n % kVec;
  }
};

// ------------------------------------------------- tensor-core fragments

// two f32 values rounded to bf16 (to nearest even) in one register, lo in
// the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += a b, m16n8k16, bf16 inputs, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the B fragments of two n-tiles (x4) or one (x2) of a k16 step from a
// (k, n) row-major bf16 stage: lane l addresses row (l / 8 & 1) 8 + l % 8
// of the columns n0 + (l / 16) 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&b)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_addr(p)));
}

// ------------------------------------------------------------- products

// rows k0 .. k0 + 15 of the bf16 (in, out) plane W, columns n0 .. n0 + 8
// NTW - 1, into this warp's strip slice dst: 16-byte asynchronous copies
// where a row is whole chunks (H % 8 == 0), else plain copies; rows past H
// are zero, columns past H not read
template <int NTW>
__device__ __forceinline__ void fetch_strip(bf16* dst, const bf16* __restrict__ W, int H, int k0,
                                            int n0, int lane) {
  using S = Strip<NTW>;
  for (int e = lane; e < S::kRows * S::kCpr; e += kWarp) {
    const int r = e / S::kCpr, c = e % S::kCpr, col = n0 + c * S::kVec;
    bf16* d = dst + r * S::kCols + S::pos(r, c) * S::kVec;
    if (k0 + r >= H) {
#pragma unroll
      for (int i = 0; i < S::kVec; ++i) d[i] = __float2bfloat16_rn(0.0f);
    } else if (col < H) {
      const bf16* src = W + (size_t)(k0 + r) * H + col;
      if (H % S::kVec == 0) {
        __pipeline_memcpy_async(d, src, 16);
      } else {
        for (int i = 0; i < S::kVec && col + i < H; ++i) d[i] = src[i];
      }
    }
  }
}

// activation columns c, c + 1 of a row; columns past H read as 0 where the
// k-step runs past H
__device__ __forceinline__ float2 act_pair(const float* p, int c, int H, bool tail) {
  float2 v = *reinterpret_cast<const float2*>(p);
  if (tail) {
    v.x = c < H ? v.x : 0.0f;
    v.y = c + 1 < H ? v.y : 0.0f;
  }
  return v;
}

// acc += d, one rounding to nearest each.  A k-step's products are summed
// by the tensor cores into a fresh d and added here: the tensor cores
// truncate each sum they accumulate, and chained over a whole product
// that bias grows (on the H100, 3xTF32 products chained in the
// accumulator took the f32 forward to 3e-6 of its norm against 5e-7 for
// f32 fma).
__device__ __forceinline__ void add4(float (&acc)[4], const float (&d)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] += d[c];
}

// one k16 step of the bf16 product over the warp's tiles: A the f32
// activations (row stride HS), ws the staged slice (rows k0 .. k0 + 15)
template <int NTW, int MT>
__device__ __forceinline__ void kstep(const float* A, int HS, const bf16* ws, int k0, int H,
                                      int nt0, int lane, float (&acc)[MT][NTW][4]) {
  using S = Strip<NTW>;
  const int g = lane >> 2, t = lane & 3;
  uint32_t b[NTW][2];
  if constexpr (NTW == 1) {
    ldmatrix_x2_trans(b[0][0], b[0][1], ws + S::at(lane & 15, 0));
  } else {
#pragma unroll
    for (int j = 0; j < NTW; j += 2) {
      uint32_t r[4] = {0u, 0u, 0u, 0u};
      if ((nt0 + j) * 8 < H)
        ldmatrix_x4_trans(r, ws + S::at((lane >> 3 & 1) * 8 + (lane & 7), (j + (lane >> 4)) * 8));
      b[j][0] = r[0]; b[j][1] = r[1]; b[j + 1][0] = r[2]; b[j + 1][1] = r[3];
    }
  }
  const bool tail = k0 + 16 > H;
  const int c = k0 + 2 * t;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float* p0 = A + (i * 16 + g) * HS + c;
    const float* p1 = p0 + 8 * HS;
    const float2 x00 = act_pair(p0, c, H, tail), x10 = act_pair(p1, c, H, tail);
    const float2 x01 = act_pair(p0 + 8, c + 8, H, tail), x11 = act_pair(p1 + 8, c + 8, H, tail);
    const uint32_t a[4] = {pack_bf16(x00.x, x00.y), pack_bf16(x10.x, x10.y),
                           pack_bf16(x01.x, x01.y), pack_bf16(x11.x, x11.y)};
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      if ((nt0 + j) * 8 < H) {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(d, a, b[j][0], b[j][1]);
        add4(acc[i][j], d);
      }
  }
}

// bf16: acc = bf16(A) W over the warp's tiles: A a row tile in shared
// memory (row stride HS), W an (in, out) plane in device memory.  Warp w owns the
// n-tiles nt0 = w NTW .. nt0 + NTW - 1 (a warp whose first is at or past H
// idles) and every row tile, and streams its own columns of W through its
// strip of the stage in slices of one k-step, kStages deep, so the loads
// of later slices overlap the products of this one; k runs in order.  The
// warps run apart: no block barrier until the caller's after the product.
template <int NTW, int MT>
__device__ __forceinline__ void tile_mm_tc(const float* A, const bf16* __restrict__ W, int H,
                                           int HS, int warp, int lane, float (&acc)[MT][NTW][4]) {
  using S = Strip<NTW>;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
  const int nt0 = warp * NTW;
  if (nt0 * 8 >= H) return;
  bf16* strip = reinterpret_cast<bf16*>(njode_step_smem) + warp * kStages * S::kSlice;
  const int n_slices = (H + S::kRows - 1) / S::kRows;
  auto fetch = [&](int sl) {       // every lane commits a group, maybe empty
    if (sl < n_slices)
      fetch_strip<NTW>(strip + (sl % kStages) * S::kSlice, W, H, sl * S::kRows, nt0 * 8, lane);
    __pipeline_commit();
  };
  for (int sl = 0; sl + 1 < kStages; ++sl) fetch(sl);
#pragma unroll 1
  for (int sl = 0; sl < n_slices; ++sl) {
    __pipeline_wait_prior(kStages - 2);    // slice sl has landed
    __syncwarp();                          // for every lane; slice sl - 1 is done
    fetch(sl + kStages - 1);               // into the buffer of slice sl - 1
    kstep<NTW, MT>(A, HS, strip + (sl % kStages) * S::kSlice, sl * S::kRows, H, nt0, lane, acc);
  }
}

// the (row, column) of accumulator entry (i, j, c) of this thread
__device__ __forceinline__ int acc_row(int i, int c, int lane) {
  return i * 16 + (lane >> 2) + (c >> 1) * 8;
}
__device__ __forceinline__ int acc_col(int nt0, int j, int c, int lane) {
  return (nt0 + j) * 8 + 2 * (lane & 3) + (c & 1);
}

// out[r][j] = f(r, j, acc) over the warp's tiles, columns below H
template <int NTW, int MT, typename F>
__device__ __forceinline__ void tile_store_tc(float* out, const float (&acc)[MT][NTW][4], int H,
                                              int HS, int warp, int lane, F f) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = acc_row(i, c, lane), col = acc_col(warp * NTW, j, c, lane);
        if (col < H) out[r * HS + col] = f(r, col, acc[i][j][c]);
      }
}

// out[r][j] = act(out[r][j]) over the entries tile_store_tc gave this thread
// (no barrier needed between the two); a loop, not unrolled, so the
// activation's code appears once
template <int NTW, int MT>
__device__ __forceinline__ void tile_act_tc(float* out, int H, int HS, int warp, int lane,
                                            int act) {
#pragma unroll 1
  for (int e = 0; e < MT * NTW * 4; ++e) {
    const int i = e / (NTW * 4), j = e / 4 % NTW, c = e % 4;
    const int r = acc_row(i, c, lane), col = acc_col(warp * NTW, j, c, lane);
    if (col < H) out[r * HS + col] = activate(out[r * HS + col], act);
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
// the dynamic shared memory, row stride HS (out may be A: the product is
// held in registers across a barrier), W a bf16 plane in device memory, on
// the tensor cores (C = NTW n-tiles a warp).  Not inlined: one copy per (C,
// RPW), shared by both kernels, keeps the build short.
template <int C, int RPW>
__device__ __noinline__ void mm_store(int a_off, const bf16* __restrict__ W, int out_off, int H,
                                      int HS, Epi e) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* out = njode_step_smem + out_off;
  const float* res = njode_step_smem + e.res;
  const float* b = e.b;
  // the epilogue through `store`, which writes f(r, j, product) over the
  // entries this thread holds
  auto epilogue = [&](auto store) {
    switch (e.mode) {
      case kBias:
        store([&](int, int j, float v) { return v + __ldg(b + j); });
        break;
      case kGap:
        store(e.gap);
        break;
      case kEuler: {
        const GapBase& g = e.gap;
        store([&](int r, int j, float v) { return res[r * HS + j] + g.dt(r) * (v + __ldg(b + j)); });
        break;
      }
      case kCopy:
        store([](int, int, float v) { return v; });
        break;
      case kAdd:
        store([&](int r, int j, float v) { return out[r * HS + j] + v; });
        break;
      default:
        store([&](int r, int j, float v) { return out[r * HS + j] + v * res[r * HS + j]; });
    }
  };
  constexpr int MT = RPW / 2;
  float acc[MT][C][4];
  tile_mm_tc<C, MT>(njode_step_smem + a_off, W, H, HS, warp, lane, acc);
  __syncthreads();
  epilogue([&](auto f) { tile_store_tc<C, MT>(out, acc, H, HS, warp, lane, f); });
  if (e.act >= 0) tile_act_tc<C, MT>(out, H, HS, warp, lane, e.act);
  __syncthreads();
}

// ------------------------------------------------- weight-gradient sums

// the fragments of one k-step of P = A^T G: A^T's row tile a0 (m = a, k =
// the tile's rows from r0) and G's column tile j0 (k = rows, n = j), from
// the activation buffers (row stride HS).  bf16 (k16): both rounded, slot
// 2t on row r0 + t, 2t + 1 on r0 + t + 4, 2t + 8 on r0 + t + 8, 2t + 9 on
// r0 + t + 12, so that a load's 32 lanes hit 32 banks.
__device__ __forceinline__ void sum_a_frag(const float* A, int HS, int r0, int a0, int lane,
                                           uint32_t (&a)[4]) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = A + (r0 + t) * HS + a0 + g;
  a[0] = pack_bf16(p[0], p[4 * HS]);
  a[1] = pack_bf16(p[8], p[4 * HS + 8]);
  a[2] = pack_bf16(p[8 * HS], p[12 * HS]);
  a[3] = pack_bf16(p[8 * HS + 8], p[12 * HS + 8]);
}

__device__ __forceinline__ void sum_b_frag(const float* G, int HS, int r0, int j0, int lane,
                                           uint32_t& b0, uint32_t& b1) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = G + (r0 + t) * HS + j0 + g;
  b0 = pack_bf16(p[0], p[4 * HS]);
  b1 = pack_bf16(p[8 * HS], p[12 * HS]);
}

// entries p[0], p[1] of a partial row: one 8-byte access where both are
// in the row and p is 8-byte aligned (H even), else one or two scalars
__device__ __forceinline__ float2 load_pair(const float* p, bool both) {
  if (both && (reinterpret_cast<size_t>(p) & 7) == 0) return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], both ? p[1] : 0.0f);
}
__device__ __forceinline__ void store_pair(float* p, float2 v, bool both) {
  if (both && (reinterpret_cast<size_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = v;
  } else {
    p[0] = v.x;
    if (both) p[1] = v.y;
  }
}

// bf16: P[a H + j] (+)= sum_{r < RT} bf16(A[r HS + a]) bf16(G[r HS + j])
// (A, G shared rows): warp w owns the columns of n-tiles w NTW .. w NTW +
// NTW - 1 and takes the row tiles of a two at a time; every entry one
// owner, the tile's rows summed by the tensor cores (rows past B have G =
// 0, so they add exact zeros).
template <int NTW, int RPW>
__device__ __forceinline__ void outer_sum_tc(const float* A, const float* G, int H, int HS,
                                             float* __restrict__ P, bool first) {
  constexpr int RT = RPW * kWarps, MG = 2;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2;
  const int nt0 = warp * NTW;
  if (nt0 * 8 >= H) return;
  const int n_mt = (H + 15) / 16;
#pragma unroll 1
  for (int m0 = 0; m0 < n_mt; m0 += MG) {
    // the earlier slots' partial, loaded before the products so that its
    // latency overlaps them
    float old[MG][NTW][4], acc[MG][NTW][4];
#pragma unroll
    for (int i = 0; i < MG; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int a = (m0 + i) * 16 + g + h * 8, col = acc_col(nt0, j, 0, lane);
          float2 o = make_float2(0.0f, 0.0f);
          if (!first && a < H && col < H) o = load_pair(P + (size_t)a * H + col, col + 1 < H);
          old[i][j][2 * h] = o.x;
          old[i][j][2 * h + 1] = o.y;
          acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.0f;
        }
#pragma unroll
    for (int r0 = 0; r0 < RT; r0 += 16) {
      uint32_t b[NTW][2];
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        b[j][0] = b[j][1] = 0u;
        if ((nt0 + j) * 8 < H) sum_b_frag(G, HS, r0, (nt0 + j) * 8, lane, b[j][0], b[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MG; ++i) {
        if (m0 + i >= n_mt) break;
        uint32_t a[4];
        sum_a_frag(A, HS, r0, (m0 + i) * 16, lane, a);
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          if ((nt0 + j) * 8 < H) {
            float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_bf16(d, a, b[j][0], b[j][1]);
            add4(acc[i][j], d);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < MG; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int a = (m0 + i) * 16 + g + h * 8, col = acc_col(nt0, j, 0, lane);
          if (a < H && col < H)
            store_pair(P + (size_t)a * H + col,
                       make_float2(old[i][j][2 * h] + acc[i][j][2 * h],
                                   old[i][j][2 * h + 1] + acc[i][j][2 * h + 1]),
                       col + 1 < H);
        }
  }
}

// The weight-gradient sum of a plane, P (+)= A^T G over the tile's rows (A
// and G at shared offsets, row stride HS), on the tensor cores (C = NTW).
// Not inlined: one copy per (C, RPW).
template <int C, int RPW>
__device__ __noinline__ void outer_sum(int a_off, int g_off, int H, int HS,
                                       float* __restrict__ P, bool first) {
  outer_sum_tc<C, RPW>(njode_step_smem + a_off, njode_step_smem + g_off, H, HS, P, first);
}

// P[j] (+)= sum_{r < nr} f(r) G[r HS + j], one thread a column, rows in order
template <typename F>
__device__ __forceinline__ void tile_colsum(const float* G, int nr, int H, int HS, F f,
                                            float* __restrict__ P, bool first) {
  for (int j = threadIdx.x; j < H; j += kThreads) {
    const float old = first ? 0.0f : P[j];
    float s = 0.0f;
    for (int r = 0; r < nr; ++r) s = fmaf(f(r), G[r * HS + j], s);
    P[j] = first ? s : old + s;
  }
}

// -------------------------------------------------------------- forward

template <int C, int RPW>
__global__ void __launch_bounds__(kThreads)
step_fwd_kernel(const float* __restrict__ x, const float* __restrict__ t,
                const bf16* __restrict__ W, const float* __restrict__ V,
                float* __restrict__ Y, int B, int N, int H, Layout lo, int act, int scale) {
  constexpr int RT = RPW * kWarps;
  float* smem = njode_step_smem;
  const int kn = blockIdx.y, warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int row0 = blockIdx.x * RT, nr = min(RT, B - row0);
  const int d_x = lo.d_x, n_out = 2 * N - 1, HS = act_stride(H), TH = RT * HS;
  const int o_hj = kStageFloats, o_wk = o_hj + TH;  // HJ, a work buffer
  float* s_hj = smem + o_hj;
  float* s_wk = smem + o_wk;
  float* s_x = smem + o_wk + TH;
  float* s_xs = s_x + RT * N * d_x;
  float* s_t = s_xs + RT * N * d_x;
  load_rows(x, s_x, row0, nr, RT, N * d_x);
  load_rows(t, s_t, row0, nr, RT, N);
  load_scaled(s_x, s_xs, RT * N * d_x, scale);
  const bf16* Wk = W + (size_t)kn * lo.n_mats * H * H;
  const float* Vk = V + (size_t)kn * lo.n_rows * H;
  auto plane = [&](int m) { return Wk + (size_t)m * H * H; };
  auto vrow = [&](int r) { return Vk + (size_t)r * H; };
  __syncthreads();

  // act(cur W_m + b) into out (out may be cur)
  auto layer = [&](int cur, int out, int m, int brow) {
    mm_store<C, RPW>(cur, plane(m), out, H, HS, epi(kBias, act, vrow(brow)));
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
          for (int j = lane; j < H; j += kWarp) s = fmaf(u[r * HS + j], __ldg(o2 + j), s);
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
      for (int e = threadIdx.x; e < RT * H; e += kThreads) {
        const int r = e / H, j = e - r * H;
        float pre = __ldg(b0 + j);
        for (int d = 0; d < d_x; ++d)
          pre = pre + s_x[(r * N + s) * d_x + d] * __ldg(vrow(lo.row_j1 + d) + j);
        s_hj[r * HS + j] = activate(pre, act);
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
    mm_store<C, RPW>(src, plane(lo.mat_w1h), o_wk, H, HS, epi(kGap, act, nullptr, gap));
    for (int i = 0; i + 1 < lo.L; ++i) layer(o_wk, o_wk, 2 * lo.L + 1 + i, lo.row_ob + i + 1);
    mm_store<C, RPW>(o_wk, plane(lo.mat_last), o_wk, H, HS,
                          epi(kEuler, -1, vrow(lo.row_ob + lo.L), gap, o_hj));
    readout(o_wk, N + s);
  }
}

// ------------------------------------------------------------- backward

template <int C, int RPW>
__global__ void __launch_bounds__(kThreads)
step_bwd_kernel(const float* __restrict__ x, const float* __restrict__ t,
                const bf16* __restrict__ W, const bf16* __restrict__ WT,
                const float* __restrict__ V, const float* __restrict__ gy,
                float* __restrict__ partial, int B, int N, int H, Layout lo, int act,
                int scale) {
  constexpr int RT = RPW * kWarps;
  float* smem = njode_step_smem;
  const int kn = blockIdx.y;
  const int row0 = blockIdx.x * RT, nr = min(RT, B - row0);
  const int L = lo.L, d_x = lo.d_x, n_out = 2 * N - 1, n_gy = n_out * lo.d_y * lo.K;
  const int HS = act_stride(H), TH = RT * HS;
  const int o_jp = kStageFloats;  // L buffers: the jump's layer values
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
  const bf16* Wk = W + (size_t)kn * lo.n_mats * plane_sz;
  const bf16* WTk = WT + (size_t)kn * lo.n_mats * plane_sz;
  const float* Vk = V + (size_t)kn * lo.n_rows * H;
  const size_t psz = lo.n_mats * plane_sz + (size_t)lo.n_rows * H;
  float* Pk = partial + ((size_t)blockIdx.x * lo.Kn + kn) * psz;
  auto vrow = [&](int r) { return Vk + (size_t)r * H; };
  auto pw = [&](int m) { return Pk + m * plane_sz; };
  auto pv = [&](int r) { return Pk + lo.n_mats * plane_sz + (size_t)r * H; };
  auto one = [](int) { return 1.0f; };
  __syncthreads();

  auto layer = [&](int cur, int out, int m, int brow) {
    mm_store<C, RPW>(cur, Wk + m * plane_sz, out, H, HS, epi(kBias, act, vrow(brow)));
  };
  // g = g W_m^T, in place
  auto back = [&](int g, int m) {
    mm_store<C, RPW>(g, WTk + m * plane_sz, g, H, HS, epi(kCopy));
  };
  auto times_act_grad = [&](float* g, const float* val) {
    for (int e = threadIdx.x; e < TH; e += kThreads) g[e] *= act_grad_v(val[e], act);
    __syncthreads();
  };
  auto gyv = [&](int r, int ys, int d, int kk) {
    return s_gy[r * n_gy + (ys * lo.d_y + d) * lo.K + kk];
  };
  auto a1 = [&](int s) {           // the jump's layer 0 into s_g2
    for (int e = threadIdx.x; e < RT * H; e += kThreads) {
      const int r = e / H, j = e - r * H;
      float pre = __ldg(vrow(lo.row_bj) + j);
      for (int d = 0; d < d_x; ++d)
        pre = pre + s_x[(r * N + s) * d_x + d] * __ldg(vrow(lo.row_j1 + d) + j);
      s_g2[r * HS + j] = activate(pre, act);
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
    for (int e = threadIdx.x; e < RT * H; e += kThreads) {
      const int r = e / H, j = e - r * H;
      float sum = 0.0f;
      for (int kk = k_lo; kk < k_hi; ++kk)
        for (int d = 0; d < lo.d_y; ++d)
          sum = sum + gyv(r, ys, d, kk) * __ldg(vrow(o2_row(lo, kk, d)) + j);
      gp[r * HS + j] = sum;
    }
    for (int kk = k_lo; kk < k_hi; ++kk)
      for (int d = 0; d < lo.d_y; ++d)
        tile_colsum(smem + cur, nr, H, HS, [&](int r) { return gyv(r, ys, d, kk); },
                    pv(o2_row(lo, kk, d)), first);
    __syncthreads();
    for (int l = L - 1; l >= 0; --l) {
      times_act_grad(gp, s_up + l * TH);
      outer_sum<C, RPW>(l == 0 ? in : o_up + (l - 1) * TH, g, H, HS, pw(L + l), first);
      tile_colsum(gp, nr, H, HS, one, pv(lo.row_bo + l), first);
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
      mm_store<C, RPW>(src, Wk + lo.mat_w1h * plane_sz, o_gp, H, HS,
                            epi(kGap, act, nullptr, gap));
      for (int i = 0; i + 1 < L; ++i)
        layer(o_gp + i * TH, o_gp + (i + 1) * TH, 2 * L + 1 + i, lo.row_ob + i + 1);
      mm_store<C, RPW>(o_gp + (L - 1) * TH, Wk + lo.mat_last * plane_sz, o_hm, H, HS,
                            epi(kEuler, -1, vrow(lo.row_ob + L), gap, o_hj));
      // ---- the readout before slot s + 1: dHM into s_g2
      readout_bwd(o_hm, N + s, o_g2, false);
      // ---- the gap's backward: dHJ += dHM, dDH = DT dHM
      for (int e = threadIdx.x; e < TH; e += kThreads) {
        s_g[e] += s_g2[e];
        s_g2[e] *= dt_of(e / HS);
      }
      __syncthreads();
      outer_sum<C, RPW>(o_gp + (L - 1) * TH, o_g2, H, HS, pw(lo.mat_last), first);
      tile_colsum(s_g2, nr, H, HS, one, pv(lo.row_ob + L), first);
      __syncthreads();
      back(o_g2, lo.mat_last);
      for (int i = L - 2; i >= 0; --i) {
        times_act_grad(s_g2, smem + o_gp + (i + 1) * TH);
        outer_sum<C, RPW>(o_gp + i * TH, o_g2, H, HS, pw(2 * L + 1 + i), first);
        tile_colsum(s_g2, nr, H, HS, one, pv(lo.row_ob + i + 1), first);
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
      outer_sum<C, RPW>(hs, o_g2, H, HS, pw(lo.mat_w1h), first);
      for (int d = 0; d < d_x; ++d)
        tile_colsum(s_g2, nr, H, HS, [&](int r) { return s_xs[(r * N + s) * d_x + d]; },
                    pv(lo.row_w1x + d), first);
      tile_colsum(s_g2, nr, H, HS, [&](int r) { return s_t[r * N + s]; }, pv(lo.row_w1t),
                  first);
      tile_colsum(s_g2, nr, H, HS, dt_of, pv(lo.row_w1d), first);
      tile_colsum(s_g2, nr, H, HS, one, pv(lo.row_ob), first);
      // dHJ += (dG1_pre W1h^T) s'(HJ), s'(HJ) in s_up (free: the readouts
      // are done)
      if (scale != kIdentity)
        for (int e = threadIdx.x; e < TH; e += kThreads) s_up[e] = scale_grad(hj[e], scale);
      __syncthreads();
      mm_store<C, RPW>(o_g2, WTk + lo.mat_w1h * plane_sz, o_g, H, HS,
                            scale != kIdentity ? epi(kAddScaled, -1, nullptr, GapBase{}, o_up)
                                               : epi(kAdd));
    }

    // ---- the jump's backward
    for (int l = L - 1; l >= 0; --l) {
      times_act_grad(s_g, smem + o_jp + l * TH);
      if (l == 0) a1(s);
      outer_sum<C, RPW>(l == 0 ? o_g2 : o_jp + (l - 1) * TH, o_g, H, HS, pw(l),
                           first);
      tile_colsum(s_g, nr, H, HS, one, pv(lo.row_bj + l + 1), first);
      __syncthreads();
      back(o_g, l);
    }
    times_act_grad(s_g, s_g2);                         // s_g2 holds layer 0
    for (int d = 0; d < d_x; ++d)
      tile_colsum(s_g, nr, H, HS, [&](int r) { return s_x[(r * N + s) * d_x + d]; },
                  pv(lo.row_j1 + d), first);
    tile_colsum(s_g, nr, H, HS, one, pv(lo.row_bj), first);
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

// bf16, per block: the weight stage, the tile's activation buffers (row
// stride act_stride), then x, s(x) and t (and gy)
size_t fwd_smem_floats(int RT, int H, int N, int d_x) {
  return (size_t)kStageFloats + 2 * (size_t)RT * act_stride(H) +
         (size_t)RT * N * (2 * d_x + 1);
}

size_t bwd_smem_floats(int RT, int H, int N, const Layout& lo) {
  return (size_t)kStageFloats + (size_t)(3 * lo.L + 3) * RT * act_stride(H) +
         (size_t)RT * N * (2 * lo.d_x + 1) + (size_t)RT * (2 * N - 1) * lo.d_y * lo.K;
}

// the tile: bf16, 8 RPW rows (RPW 8 forward, 4 or 2 backward); f32, 64, 32
// or 16 rows and 1 <= group <= N slots a group
bool plan_ok(bool wbf16, bool bwd, int rows, int group, int N) {
  if (wbf16) return bwd ? rows == 32 || rows == 16 : rows == 64;
  return (rows == 64 || rows == 32 || rows == 16) && group >= 1 && group <= N;
}

size_t smem_bytes(bool wbf16, bool bwd, int rows, int group, int H, int N, const Layout& lo) {
  if (!wbf16) return f32::smem_floats(bwd, rows, group, H, N, lo) * sizeof(float);
  return (bwd ? bwd_smem_floats(rows, H, N, lo) : fwd_smem_floats(rows, H, N, lo.d_x)) *
         sizeof(float);
}

int check_args(int B, int N, int H, int L, int d_x, int d_y, int K, int act, int scale,
               bool plan, size_t smem) {
  if (B < 1 || N < 1 || H < 1 || H > 256 || L < 1 || d_x < 1 || d_y < 1 || K < 1 ||
      K > 65535 || act < 0 || act > kSelu || scale < 0 || scale > kScaleSigmoid || !plan)
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
  float *Y, *scratch;
  int B, N, H;
  Layout lo;
  int act, scale;
};

// bf16: the (C, RPW) instances are NTW 4 (see the top of the file) with the
// forward's RPW 8 and the backward's 4 or 2
template <int R>
cudaError_t launch_fwd_bf16(const Args& a, dim3 grid, size_t smem, cudaStream_t s) {
  auto kern = step_fwd_kernel<4, R>;
  cudaError_t e = set_smem(kern, smem);
  if (e == cudaSuccess)
    kern<<<grid, kThreads, smem, s>>>(a.x, a.t, static_cast<const bf16*>(a.W), a.V, a.Y, a.B,
                                      a.N, a.H, a.lo, a.act, a.scale);
  return e;
}

template <int R>
cudaError_t launch_bwd_bf16(const Args& a, dim3 grid, size_t smem, cudaStream_t s) {
  auto kern = step_bwd_kernel<4, R>;
  cudaError_t e = set_smem(kern, smem);
  if (e == cudaSuccess)
    kern<<<grid, kThreads, smem, s>>>(a.x, a.t, static_cast<const bf16*>(a.W),
                                      static_cast<const bf16*>(a.WT), a.V, a.gy, a.scratch, a.B,
                                      a.N, a.H, a.lo, a.act, a.scale);
  return e;
}

// f32: the forward or the rematerializing backward of step_f32.cuh
template <bool BWD>
cudaError_t launch_f32(const Args& a, int rows, int group, size_t smem, cudaStream_t s) {
  auto kern = f32::step_kernel<BWD>;
  cudaError_t e = set_smem(kern, smem);
  if (e == cudaSuccess)
    kern<<<dim3((a.B + rows - 1) / rows, a.lo.Kn), f32::kThreads, smem, s>>>(
        a.x, a.t, static_cast<const float*>(a.W), static_cast<const float*>(a.WT), a.V, a.gy,
        a.Y, a.scratch, a.B, a.N, a.H, a.lo, a.act, a.scale, rows, group);
  return e;
}

// f32: dW from the backward's records (split-k chunk partials, then their
// sum with the tiles' dV partials)
cudaError_t launch_f32_sums(const Args& a, int rows, float* dW, float* dV, cudaStream_t s) {
  const Layout& lo = a.lo;
  const int tiles = (a.B + rows - 1) / rows, nT = (a.H + f32::kDwRows - 1) / f32::kDwRows;
  const f32::Scratch sz = f32::scratch_floats(lo, a.B, a.N, a.H, rows);
  long long units = 0;
  for (int m = 0; m < lo.n_mats; ++m)
    units += (long long)lo.Kn * f32::dw_chunks(lo, m, a.N, tiles, rows) * nT;
  if (units > 0) {
    const size_t smem = (size_t)f32::kDwStages * f32::kDwBK * (f32::kDwRows + f32::kDwCols) *
                        sizeof(float);
    cudaError_t e = set_smem(f32::step_dw_kernel, smem);
    if (e != cudaSuccess) return e;
    f32::step_dw_kernel<<<(unsigned)units, f32::kDwThreads, smem, s>>>(
        a.scratch, a.scratch + sz.rec, tiles, a.N, a.H, lo, rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const long long n = lo.Kn * ((long long)lo.n_mats * a.H * a.H + (long long)lo.n_rows * a.H);
  f32::step_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      a.scratch, dW, dV, tiles, a.N, a.H, lo, rows, sz.rec, sz.dwp);
  return cudaGetLastError();
}

}  // namespace

// The forward: Y (B, 2N-1, d_y, K) without bo2.  rows, group: the tile's
// trajectories and (f32) the slots a group (ops/fused_step.py
// kernel_plan); wbf16: W is bf16 (row 9b) rather than f32 (row 9).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int njode_step_fwd(const void* x, const void* t, const void* W, const void* V,
                              void* Y, int B, int N, int H, int L, int d_x, int d_y, int K,
                              int shared, int act, int scale, int rows, int group, int wbf16,
                              void* stream) {
  const Layout lo = make_layout(L, d_x, d_y, K, shared);
  const bool plan = plan_ok(wbf16 != 0, false, rows, group, N);
  const size_t smem = plan ? smem_bytes(wbf16 != 0, false, rows, group, H, N, lo) : 0;
  int err = check_args(B, N, H, L, d_x, d_y, K, act, scale, plan, smem);
  if (err != 0) return err;
  const Args a{static_cast<const float*>(x), static_cast<const float*>(t), W, nullptr,
               static_cast<const float*>(V), nullptr, static_cast<float*>(Y), nullptr,
               B, N, H, lo, act, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      wbf16 ? launch_fwd_bf16<8>(a, dim3((B + rows - 1) / rows, lo.Kn), smem, s)
            : launch_f32<false>(a, rows, group, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Floats of the backward's scratch: bf16, the tile partials, tiles x Kn x
// (n_mats H^2 + n_rows H); f32, the records, the dW chunk partials and the
// tiles' dV partials (step_f32.cuh).
extern "C" long long njode_step_scratch_floats(int B, int N, int H, int L, int d_x, int d_y,
                                               int K, int shared, int rows, int wbf16) {
  const Layout lo = make_layout(L, d_x, d_y, K, shared);
  if (!wbf16) {
    const f32::Scratch sz = f32::scratch_floats(lo, B, N, H, rows);
    return (long long)(sz.rec + sz.dwp + sz.dvp);
  }
  const long long tiles = (B + rows - 1) / rows;
  return tiles * lo.Kn * ((long long)lo.n_mats * H * H + (long long)lo.n_rows * H);
}

// The backward: dW (Kn, n_mats, H, H) and dV (Kn, n_rows, H), f32, the
// cotangents of W and V for gy; scratch holds njode_step_scratch_floats
// floats; wbf16: W and WT are bf16 (row 10b).  Launches on `stream`: bf16,
// the backward and the tile-order sum; f32, the backward, the dW chunks and
// their sum.
extern "C" int njode_step_bwd(const void* x, const void* t, const void* W, const void* WT,
                              const void* V, const void* gy, void* scratch, void* dW, void* dV,
                              int B, int N, int H, int L, int d_x, int d_y, int K, int shared,
                              int act, int scale, int rows, int group, int wbf16, void* stream) {
  const Layout lo = make_layout(L, d_x, d_y, K, shared);
  const bool plan = plan_ok(wbf16 != 0, true, rows, group, N);
  const size_t smem = plan ? smem_bytes(wbf16 != 0, true, rows, group, H, N, lo) : 0;
  int err = check_args(B, N, H, L, d_x, d_y, K, act, scale, plan, smem);
  if (err != 0) return err;
  const Args a{static_cast<const float*>(x), static_cast<const float*>(t), W, WT,
               static_cast<const float*>(V), static_cast<const float*>(gy), nullptr,
               static_cast<float*>(scratch), B, N, H, lo, act, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (B + rows - 1) / rows;
  if (!wbf16) {
    cudaError_t e = launch_f32<true>(a, rows, group, smem, s);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e == cudaSuccess)
      e = launch_f32_sums(a, rows, static_cast<float*>(dW), static_cast<float*>(dV), s);
    return (int)e;
  }
  const dim3 grid(tiles, lo.Kn);
  cudaError_t e = rows == 32 ? launch_bwd_bf16<4>(a, grid, smem, s)
                             : launch_bwd_bf16<2>(a, grid, smem, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long w_per = (long long)lo.n_mats * H * H, v_per = (long long)lo.n_rows * H;
  const long long n = lo.Kn * (w_per + v_per);
  step_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      a.scratch, static_cast<float*>(dW), static_cast<float*>(dV), tiles, lo.Kn, w_per, v_per);
  return (int)cudaGetLastError();
}

extern "C" const char* njode_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
