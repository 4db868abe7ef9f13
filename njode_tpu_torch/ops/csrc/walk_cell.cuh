// Device helpers shared by the grid-walk kernels (walk_scan.cu, walk_train.cu),
// train_run.cu, gap_scan.cu and, through gap_cell.cuh, gap_train.cu and
// fused_cell.cu: the
// activations and input scalings with their derivatives, a product operand's
// bf16 rounding, the small row-tile products of one warp, and the walk's
// products of one vector split over a trajectory's group of warps
// (part_mm, group_mm; walk_train.cu's walks and walk_scan.cu's backward).
//
// Codes follow the order of SUPPORTED_ACTS / SCALINGS in ops/activations.py.
// Built without --use_fast_math, so expf/tanhf/expm1f are the accurate
// versions and denormals are kept.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace njode_walk {

constexpr int kWarp = 32;

enum Act { kRelu = 0, kTanh = 1, kSigmoid = 2, kElu = 3, kLeakyRelu = 4, kSelu = 5 };
enum Scale { kIdentity = 0, kScaleTanh = 1, kScaleSigmoid = 2 };

constexpr float kSeluL = 1.0507009873554805f;
constexpr float kSeluA = 1.6732632423543772f;

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kTanh: return tanhf(x);
    case kSigmoid: return 1.0f / (1.0f + expf(-x));
    case kElu: return x > 0.0f ? x : expm1f(x);
    case kLeakyRelu: return x >= 0.0f ? x : 0.01f * x;
    case kSelu: return kSeluL * (x > 0.0f ? x : kSeluA * expm1f(x));
    default: return x < 0.0f ? 0.0f : x;  // relu, NaN passes through
  }
}

// derivative at the pre-activation (ops/activations.py _ACT_GRAD)
__device__ __forceinline__ float act_grad(float pre, int act) {
  switch (act) {
    case kTanh: { const float t = tanhf(pre); return 1.0f - t * t; }
    case kSigmoid: {
      const float s = 1.0f / (1.0f + expf(-pre));
      return s * (1.0f - s);
    }
    case kElu: return pre > 0.0f ? 1.0f : expf(fminf(pre, 0.0f));
    case kLeakyRelu: return pre > 0.0f ? 1.0f : 0.01f;
    case kSelu: return pre > 0.0f ? kSeluL : kSeluL * kSeluA * expf(fminf(pre, 0.0f));
    default: return pre > 0.0f ? 1.0f : 0.0f;
  }
}

__device__ __forceinline__ float scale_in(float x, int scale) {
  if (scale == kScaleTanh) return tanhf(x);
  if (scale == kScaleSigmoid) return 1.0f / (1.0f + expf(-x));
  return x;
}

__device__ __forceinline__ float scale_grad(float x, int scale) {
  if (scale == kScaleTanh) { const float t = tanhf(x); return 1.0f - t * t; }
  if (scale == kScaleSigmoid) {
    const float s = 1.0f / (1.0f + expf(-x));
    return s * (1.0f - s);
  }
  return 1.0f;
}

// A product's operand: with BF, x rounded to bf16 (nearest even) and back
// to f32, the TPU kernels' mxu="bfloat16" cast; else x itself.
template <bool BF>
__device__ __forceinline__ float operand(float x) {
  if constexpr (BF) return __bfloat162float(__float2bfloat16_rn(x));
  else return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// how rows_mm loads W: plain (shared memory), through the read-only cache
// (device memory the kernel never writes), or from L2 (device memory other
// blocks of the same launch write between grid barriers)
enum Load { kLoadPlain = 0, kLoadNc = 1, kLoadCg = 2 };

template <int LOAD>
__device__ __forceinline__ float load_w(const float* p) {
  if constexpr (LOAD == kLoadPlain) return *p;
  else if constexpr (LOAD == kLoadNc) return __ldg(p);
  else return __ldcg(p);
}

// One warp's product of RPW rows with a d x d matrix held (in, out):
//   TRANS false: acc[q][c] = sum_i x[q][i] W[i * ldw + j]
//   TRANS true:  acc[q][c] = sum_i x[q][i] W[j * ldw + i]   (x W^T)
// for j = lane + 32 c; x rows at stride x_ld, read as broadcasts (shared or
// device memory), rows q >= nrows reading row nrows - 1; columns past d
// read as 0.  With W in shared memory an odd ldw keeps the TRANS reads of a
// warp in distinct banks.
template <int CPT, int RPW, bool TRANS, int LOAD>
__device__ __forceinline__ void rows_mm(const float* x, int x_ld, int nrows,
                                        const float* W, int ldw, int d, int lane,
                                        float (&acc)[RPW][CPT]) {
#pragma unroll
  for (int q = 0; q < RPW; ++q)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[q][c] = 0.0f;
#pragma unroll 4
  for (int i = 0; i < d; ++i) {
    float w[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      w[c] = j < d ? load_w<LOAD>(TRANS ? W + (size_t)j * ldw + i
                                         : W + (size_t)i * ldw + j)
                   : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const float xv = x[(q < nrows ? q : nrows - 1) * x_ld + i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[q][c] = fmaf(xv, w[c], acc[q][c]);
    }
  }
}

// Calls f(s), on every lane, for each slot s in [s_lo, N) of a row whose
// cell cells[s] (shared memory) is g, in slot order: the lanes test 32
// slots at a time and a ballot names the matches.
template <typename F>
__device__ __forceinline__ void for_slots_at(const int* cells, int N, int s_lo, int g,
                                             int lane, F f) {
  for (int s0 = 0; s0 < N; s0 += kWarp) {
    const int s = s0 + lane;
    unsigned m = __ballot_sync(0xffffffffu, s >= s_lo && s < N && cells[s] == g);
    while (m) {
      const int bit = __ffs(m) - 1;
      m &= m - 1;
      f(s0 + bit);
    }
  }
}

// acc (d x d, shared memory, acc[a * d + c]) += sum_r A[r][a] B[r][c] over
// the n <= RMAX rows of A and B (row stride d).  Warp w of n_warps owns the
// rows a = w, w + n_warps, ... and each lane its columns c = lane + 32 k,
// so every entry has one owner and one summation order; B's rows stay in
// registers across a.
template <int CPT, int RMAX>
__device__ __forceinline__ void outer_acc(const float* A, const float* B, int n, int d,
                                          float* acc, int warp, int n_warps, int lane) {
  float bv[RMAX][CPT];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      bv[r][c] = (r < n && j < d) ? B[r * d + j] : 0.0f;
    }
  // two weight rows at a time: independent chains keep more loads in flight
  for (int a = warp; a < d; a += 2 * n_warps) {
    const int a2 = a + n_warps;
    const bool two = a2 < d;
    float s[2][CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) s[0][c] = s[1][c] = 0.0f;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < n) {
        const float av = A[r * d + a];
        const float av2 = two ? A[r * d + a2] : 0.0f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          s[0][c] = fmaf(av, bv[r][c], s[0][c]);
          s[1][c] = fmaf(av2, bv[r][c], s[1][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < d) {
        acc[a * d + j] += s[0][c];
        if (two) acc[a2 * d + j] += s[1][c];
      }
    }
  }
}

// lane's CPT entries of a length-d vector (0 past d)
template <int CPT>
__device__ __forceinline__ void vec_regs(const float* v, int d, int lane,
                                         float (&out)[CPT]) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = lane + kWarp * c;
    out[c] = j < d ? v[j] : 0.0f;
  }
}

// rows of a weight plane (part_mm): 32 a lane's column
__host__ __device__ __forceinline__ int plane_rows(int H) { return H <= 64 ? 64 : 128; }

// The weight planes in shared memory: an H x H matrix held (in, out) in a
// plane of HP x (HP + 1) floats, HP = 32 CPT, zero past H in both
// dimensions, so that every lane's columns and every 16-row block of the
// input read real zeros and no product loop has a branch inside a block.

// A trajectory's warps (its group, WPT of them) split each product of the
// walk by input rows: a warp sums rows [r_lo, r_hi) (multiples of 16) of
//   TRANS false: acc[c] = sum_i v[i] W[i][j],   TRANS true: sum_i v[i] W[j][i]
// for j = lane + 32 c, the vector held a lane's CPT entries at a time
// (entry j = lane + 32 c in v[c]; every warp of the group holds all of it).
// The vector's entries come by shuffles, 16 at a time, with the plane's
// entries of those rows from shared memory: an unrolled block with no
// branch, so the loads run ahead of the multiply-adds.  Two accumulators a
// column, even and odd i.  BF rounds the vector's entries (the plane is
// rounded where staged).
template <int CPT, bool TRANS, bool BF>
__device__ __forceinline__ void part_mm(const float (&v)[CPT], const float* __restrict__ W,
                                        int ld, int H, int lane, int r_lo, int r_hi,
                                        float (&acc)[CPT]) {
  float a0[CPT], a1[CPT], vm[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    a0[c] = a1[c] = 0.0f;
    vm[c] = lane + kWarp * c < H ? operand<BF>(v[c]) : 0.0f;  // entries past H add 0
  }
#pragma unroll 1
  for (int rb = r_lo; rb < r_hi; rb += 16) {
    const int cc = rb / kWarp, s0 = rb % kWarp;
    float src = vm[0];
#pragma unroll
    for (int t = 1; t < CPT; ++t)
      if (cc == t) src = vm[t];
    const float* Wb = TRANS ? W + rb : W + rb * ld;
#pragma unroll
    for (int s = 0; s < 16; s += 2) {
      const float x0 = __shfl_sync(0xffffffffu, src, s0 + s);
      const float x1 = __shfl_sync(0xffffffffu, src, s0 + s + 1);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        a0[c] = fmaf(x0, TRANS ? Wb[j * ld + s] : Wb[s * ld + j], a0[c]);
        a1[c] = fmaf(x1, TRANS ? Wb[j * ld + s + 1] : Wb[(s + 1) * ld + j], a1[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = a0[c] + a1[c];
}

// a barrier of the nt threads of named barrier id (a trajectory's group)
__device__ __forceinline__ void group_sync(int id, int nt) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nt) : "memory");
}

// A trajectory's group of warps and the shared-memory rows in which their
// partial products meet: two buffers used in turn, so one barrier a product.
struct Group {
  int wpt, wg, bar_id, bar_n, r_lo, r_hi, par;
  float* part;  // 2 x wpt x (32 CPT) floats
};

// The group's product: this warp's rows, then the group's partial sums
// added in warp order, the same order in every warp of the group.
template <int CPT, bool TRANS, bool BF>
__device__ __forceinline__ void group_mm(const float (&v)[CPT], const float* W, int ld, int H,
                                         int lane, Group& gr, float (&acc)[CPT]) {
  part_mm<CPT, TRANS, BF>(v, W, ld, H, lane, gr.r_lo, gr.r_hi, acc);
  if (gr.wpt == 1) return;
  float* pb = gr.part + gr.par * gr.wpt * (kWarp * CPT);
#pragma unroll
  for (int c = 0; c < CPT; ++c) pb[(gr.wg * CPT + c) * kWarp + lane] = acc[c];
  group_sync(gr.bar_id, gr.bar_n);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    float s = pb[c * kWarp + lane];
    for (int w = 1; w < gr.wpt; ++w) s += pb[(w * CPT + c) * kWarp + lane];
    acc[c] = s;
  }
  gr.par ^= 1;
}

}  // namespace njode_walk
