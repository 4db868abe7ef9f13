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
// the CUDA cores; in practice each row's walk, a chain of M dependent cells
// of two products each.  Device memory holds only the inputs, the outputs
// and the residuals (M B d_h floats, in L2 at the training shapes).
//
// Forward (row 7): walk_train.cu's forward walk (row 13), as the backward
// below runs it: each row on a group of WPT warps (4 at the production
// shape, 256 rows a network) that split both products by input rows
// (group_mm of walk_cell.cuh over the zero-padded planes in shared memory,
// one named barrier a product), no block barrier in the walk; the carry h
// in registers, alike in every warp of the group; each row's slot cells in
// shared memory, tested 32 at a time by a warp ballot; the jump state of
// the next cell's reset loaded a cell ahead; each cell's writes (pre-jump
// states, residuals) split between the group's warps by 16-column blocks.
//
// Backward: the cells in reverse, each recomputing pre from its residual;
// the carry's h-cotangent at a reset cell goes to h_jump[s], and the new
// carry is the sum of the cotangents of the pre-jump states read at that
// cell.  The design is walk_train.cu's backward walk (row 13) without the
// loss and Adam:
//
//   * each row walks on a group of WPT warps (4 at the production shape,
//     256 rows a network) that split every product by input rows (part_mm,
//     group_mm of walk_cell.cuh: the vector's entries by shuffles, the
//     zero-padded weight planes in shared memory, the group's partial sums
//     meeting at one named barrier a product); the carry's cotangent lives
//     in registers, alike in every warp of the group; no block barrier
//     inside the walk; each cell's residual is loaded one cell ahead;
//   * the weight cotangents leave the walk: at every cell the row writes
//     the records the sums read, hid = act(pre), gp = the pre-activation's
//     cotangent and gdh = dt x the carry's, each by one warp of the group,
//     at a place fixed in advance ((K, M, B, d), like the residuals); then
//     walk_dw_kernel computes [dW1h; dw1x; dw1t; dcvec] = [s(h), x, t, 1]^T
//     gp and [dW2; db2] = [hid, 1]^T gdh as long-k products over the M B
//     rows of a network, in split-k chunks of rows summed in row order, and
//     walk_reduce_kernel sums the chunks in chunk order: no float atomics,
//     and two calls are bitwise equal.
//
// Layout (f32 unless said): hj (K, B, N, d); xs, ts (B, N) (x scaled);
// reset_cell, read_cell (B, N) int32; w1 (K, d+3, d) (in, out), rows [h, x,
// t_rel, t_elapsed] (the last row unread); cvec, b2 (K, d); w2 (K, d, d)
// (in, out); hminus (K, B, N-1, d); res_h (K, M, B, d); res_t, res_x (M, B);
// records (3, K, M, B, d) = [hid, gp, gdh]; partial (chunks, K, 2 d^2 + 4 d)
// = [dW1h, dW2, dw1x, dw1t, dcvec, db2].  The launch plans (warps a row,
// warps a block; the backward's rows a chunk of the sums) are the caller's
// (walk_fwd_plan, walk_bwd_plan in ops/walk_scan.py) and are checked here.

#include <cuda_runtime.h>
#include <stddef.h>

#include "walk_cell.cuh"

namespace {

using namespace njode_walk;

// the walks' widest block, and the sums' staged rows and output tile
constexpr int kBwdMaxWarps = 8;
constexpr int kDwRows = 32, kTA = 4, kTB = 8;
constexpr int kDwMaxThreads = 576;  // d = 128: 33 x 16 tiles, in whole warps

__host__ __device__ __forceinline__ int grad_floats(int d) { return 2 * d * d + 4 * d; }

// -------------------------------------------------------------- forward

// The forward walk.  Grid (ceil(B / rows a block), K); block (32, warps),
// WPT warps a row (walk_fwd_plan).  Shared memory as the backward walk's:
// the W1h and W2 planes (HP x (HP + 1), zero past d), each row's two
// partial-product buffers (group_mm), each row's slot cells.  The carry h
// lives in registers, alike in every warp of the row's group; each 16-column
// block of a row's writes (pre-jump states, residuals) is one warp's.
template <int CPT, bool RI, bool SAVE>
__global__ void __launch_bounds__(kWarp * kBwdMaxWarps, 1)
walk_fwd_kernel(const float* __restrict__ hj, const float* __restrict__ xs,
                const float* __restrict__ ts, const int* __restrict__ reset_cell,
                const int* __restrict__ read_cell, const float* __restrict__ w1,
                const float* __restrict__ cvec, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ hminus,
                float* __restrict__ res_h, float* __restrict__ res_t,
                float* __restrict__ res_x, int B, int N, int d, int M, float dt,
                int act, int scale, int wpt) {
  extern __shared__ float smem[];
  const int k = blockIdx.y, lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kWarp + lane, n_thr = kWarp * blockDim.y;
  const int rpb = blockDim.y / wpt, row0 = blockIdx.x * rpb;
  const int HP = kWarp * CPT, ld = HP + 1, PL = HP * ld;
  float* sW1 = smem;
  float* sW2 = smem + PL;
  float* part = smem + 2 * PL;
  int* s_reset = reinterpret_cast<int*>(part + (size_t)rpb * 2 * wpt * HP);
  int* s_read = s_reset + rpb * N;
  const float* W1 = w1 + (size_t)k * (d + 3) * d;
  const float* W2 = w2 + (size_t)k * d * d;
  for (int e = tid; e < PL; e += n_thr) {
    const int i = e / ld, j = e - i * ld;
    const bool in = i < d && j < d;
    sW1[e] = in ? W1[i * d + j] : 0.0f;
    sW2[e] = in ? W2[i * d + j] : 0.0f;
  }
  for (int e = tid; e < rpb * N; e += n_thr) {
    const bool in = row0 + e / N < B;
    s_reset[e] = in ? reset_cell[(size_t)row0 * N + e] : -2;
    s_read[e] = in ? read_cell[(size_t)row0 * N + e] : -2;
  }
  __syncthreads();

  // this warp's row and its place in the row's group; a group whose row is
  // past B leaves at once (only its own named barrier waits for it)
  const int grp = warp / wpt, wg = warp % wpt;
  const int b = row0 + grp;
  if (b >= B) return;
  Group gr;
  gr.wpt = wpt;
  gr.wg = wg;
  gr.bar_id = 1 + grp;
  gr.bar_n = kWarp * wpt;
  gr.r_lo = wg * (HP / wpt);
  gr.r_hi = min(gr.r_lo + HP / wpt, (d + 15) / 16 * 16);
  gr.par = 0;
  gr.part = part + (size_t)grp * 2 * wpt * HP;
  // relu and identity (the production recipe's) fixed at compile time (RI)
  auto actf = [&](float x) { return RI ? (x < 0.0f ? 0.0f : x) : activate(x, act); };
  auto scl = [&](float x) { return RI ? x : scale_in(x, scale); };
  float w1x[CPT], w1t[CPT], cv[CPT], bb2[CPT];
  vec_regs<CPT>(W1 + (size_t)d * d, d, lane, w1x);
  vec_regs<CPT>(W1 + (size_t)(d + 1) * d, d, lane, w1t);
  vec_regs<CPT>(cvec + (size_t)k * d, d, lane, cv);
  vec_regs<CPT>(b2 + (size_t)k * d, d, lane, bb2);
  const int* my_reset = s_reset + grp * N;
  const int* my_read = s_read + grp * N;
  const int S = N - 1;
  // entry j = lane + 32 c lies in the row's 16-column block 2 c + lane / 16
  auto mine = [&](int c) { return (2 * c + (lane >> 4)) % wpt == wg; };

  // the carry (h, t, x); the jump state, t and x of the next cell's reset
  // (the last valid slot at that cell) are loaded a cell ahead
  float h[CPT], hn[CPT], t = 0.0f, x = 0.0f, tn = 0.0f, xn = 0.0f;
#pragma unroll
  for (int c = 0; c < CPT; ++c) h[c] = hn[c] = 0.0f;
  auto fetch = [&](int g) {
    int last = -1;
    for_slots_at(my_reset, N, 0, g, lane, [&](int s) { last = s; });
    if (last >= 0) {
      const float* src = hj + (((size_t)k * B + b) * N + last) * d;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        hn[c] = j < d ? src[j] : 0.0f;
      }
      tn = ts[(size_t)b * N + last];
      xn = xs[(size_t)b * N + last];
    }
    return last;
  };
  int next = M > 0 ? fetch(0) : -1;
  for (int g = 0; g <= M; ++g) {
    // pre-jump reads of the arriving carry, then the reset
    for_slots_at(my_read, N, 1, g, lane, [&](int s) {
      float* out = hminus + (((size_t)k * B + b) * S + s - 1) * d;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < d && mine(c)) out[j] = h[c];
      }
    });
    if (g == M) break;
    if (next >= 0) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) h[c] = hn[c];
      t = tn;
      x = xn;
    }
    next = g + 1 < M ? fetch(g + 1) : -1;
    if constexpr (SAVE) {
      float* dst = res_h + (((size_t)k * M + g) * B + b) * d;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < d && mine(c)) dst[j] = h[c];
      }
      if (k == 0 && wg == 0 && lane == 0) {
        res_t[(size_t)g * B + b] = t;
        res_x[(size_t)g * B + b] = x;
      }
    }
    // one Euler step: the group's two products
    float v[CPT], acc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) v[c] = scl(h[c]);
    group_mm<CPT, false, false>(v, sW1, ld, d, lane, gr, acc);
#pragma unroll
    for (int c = 0; c < CPT; ++c) v[c] = actf(acc[c] + x * w1x[c] + t * w1t[c] + cv[c]);
    group_mm<CPT, false, false>(v, sW2, ld, d, lane, gr, acc);
#pragma unroll
    for (int c = 0; c < CPT; ++c) h[c] = h[c] + dt * (acc[c] + bb2[c]);
    t += dt;
  }
}

// ------------------------------------------------------------- backward

// The backward walk.  Grid (ceil(B / rows a block), K); block (32, warps),
// WPT warps a row.  Shared memory: the W1h and W2 planes (HP x (HP + 1),
// zero past d), each row's two partial-product buffers (group_mm), each
// row's slot cells.  Writes ct_hj at the reset slots and the records.
template <int CPT, bool RI>
__global__ void __launch_bounds__(kWarp * kBwdMaxWarps, 1)
walk_bwd_kernel(const float* __restrict__ ct_hm, const float* __restrict__ res_h,
                const float* __restrict__ res_t, const float* __restrict__ res_x,
                const int* __restrict__ reset_cell, const int* __restrict__ read_cell,
                const float* __restrict__ w1, const float* __restrict__ cvec,
                const float* __restrict__ w2, float* __restrict__ ct_hj,
                float* __restrict__ rec_hid, float* __restrict__ rec_gp,
                float* __restrict__ rec_gdh, int B, int N, int d, int M, float dt,
                int act, int scale, int wpt) {
  extern __shared__ float smem[];
  const int k = blockIdx.y, lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kWarp + lane, n_thr = kWarp * blockDim.y;
  const int rpb = blockDim.y / wpt, row0 = blockIdx.x * rpb;
  const int HP = kWarp * CPT, ld = HP + 1, PL = HP * ld;
  float* sW1 = smem;
  float* sW2 = smem + PL;
  float* part = smem + 2 * PL;
  int* s_reset = reinterpret_cast<int*>(part + (size_t)rpb * 2 * wpt * HP);
  int* s_read = s_reset + rpb * N;
  const float* W1 = w1 + (size_t)k * (d + 3) * d;
  const float* W2 = w2 + (size_t)k * d * d;
  for (int e = tid; e < PL; e += n_thr) {
    const int i = e / ld, j = e - i * ld;
    const bool in = i < d && j < d;
    sW1[e] = in ? W1[i * d + j] : 0.0f;
    sW2[e] = in ? W2[i * d + j] : 0.0f;
  }
  for (int e = tid; e < rpb * N; e += n_thr) {
    const bool in = row0 + e / N < B;
    s_reset[e] = in ? reset_cell[(size_t)row0 * N + e] : -2;
    s_read[e] = in ? read_cell[(size_t)row0 * N + e] : -2;
  }
  __syncthreads();

  // this warp's row and its place in the row's group; a group whose row is
  // past B leaves at once (only its own named barrier waits for it)
  const int grp = warp / wpt, wg = warp % wpt;
  const int b = row0 + grp;
  if (b >= B) return;
  Group gr;
  gr.wpt = wpt;
  gr.wg = wg;
  gr.bar_id = 1 + grp;
  gr.bar_n = kWarp * wpt;
  gr.r_lo = wg * (HP / wpt);
  gr.r_hi = min(gr.r_lo + HP / wpt, (d + 15) / 16 * 16);
  gr.par = 0;
  gr.part = part + (size_t)grp * 2 * wpt * HP;
  // relu and identity (the production recipe's) fixed at compile time (RI)
  auto actf = [&](float x) { return RI ? (x < 0.0f ? 0.0f : x) : activate(x, act); };
  auto actg = [&](float x) { return RI ? (x > 0.0f ? 1.0f : 0.0f) : act_grad(x, act); };
  auto scl = [&](float x) { return RI ? x : scale_in(x, scale); };
  auto sclg = [&](float x) { return RI ? 1.0f : scale_grad(x, scale); };
  float w1x[CPT], w1t[CPT], cv[CPT];
  vec_regs<CPT>(W1 + (size_t)d * d, d, lane, w1x);
  vec_regs<CPT>(W1 + (size_t)(d + 1) * d, d, lane, w1t);
  vec_regs<CPT>(cvec + (size_t)k * d, d, lane, cv);
  const int* my_reset = s_reset + grp * N;
  const int* my_read = s_read + grp * N;
  const int S = N - 1;
  // each record by one warp of the group
  const bool w_hid = wg == 0, w_gp = wg == 1 % wpt, w_gdh = wg == 2 % wpt;

  // the carry's cotangent; at g = M only the reads of the final carry.  A
  // cell's residual (hn, tn, xn) is loaded one cell ahead, so that its
  // latency overlaps the cell before.
  float gh[CPT], hn[CPT], tn = 0.0f, xn = 0.0f;
#pragma unroll
  for (int c = 0; c < CPT; ++c) gh[c] = hn[c] = 0.0f;
  for (int g = M; g >= 0; --g) {
    float hv[CPT];
    const float tq = tn, xq = xn;
#pragma unroll
    for (int c = 0; c < CPT; ++c) hv[c] = hn[c];
    if (g > 0) {
      const size_t rn = ((size_t)k * M + g - 1) * B + b;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        hn[c] = j < d ? res_h[rn * d + j] : 0.0f;
      }
      tn = res_t[(size_t)(g - 1) * B + b];
      xn = res_x[(size_t)(g - 1) * B + b];
    }
    if (g < M) {
      const size_t rr = ((size_t)k * M + g) * B + b;  // the cell's record row
      float v[CPT], pre[CPT], acc[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) v[c] = scl(hv[c]);
      group_mm<CPT, false, false>(v, sW1, ld, d, lane, gr, acc);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        pre[c] = acc[c] + xq * w1x[c] + tq * w1t[c] + cv[c];
        v[c] = dt * gh[c];  // gdh
        if (j < d) {
          if (w_hid) rec_hid[rr * d + j] = actf(pre[c]);
          if (w_gdh) rec_gdh[rr * d + j] = v[c];
        }
      }
      group_mm<CPT, true, false>(v, sW2, ld, d, lane, gr, acc);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        v[c] = acc[c] * actg(pre[c]);  // gp
        if (j < d && w_gp) rec_gp[rr * d + j] = v[c];
      }
      group_mm<CPT, true, false>(v, sW1, ld, d, lane, gr, acc);
#pragma unroll
      for (int c = 0; c < CPT; ++c) gh[c] += acc[c] * sclg(hv[c]);
      // resets: the post-reset cotangent goes to the jump state; the carry
      // before the reset gets only the reads of this cell
      bool has = false;
      for_slots_at(my_reset, N, 0, g, lane, [&](int s) {
        has = true;
        if (wg != 0) return;
        float* dst = ct_hj + (((size_t)k * B + b) * N + s) * d;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = lane + kWarp * c;
          if (j < d) dst[j] = gh[c];
        }
      });
      if (has) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) gh[c] = 0.0f;
      }
    }
    for_slots_at(my_read, N, 1, g, lane, [&](int s) {
      const float* src = ct_hm + (((size_t)k * B + b) * S + s - 1) * d;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < d) gh[c] += src[j];
      }
    });
  }
}

// The weight sums of the backward over one chunk of a network's M B record
// rows, in row order.  Grid (chunks, K, 2): job 0 sums [s(h), x, t, 1]^T gp
// (d + 3 rows a: dW1h, dw1x, dw1t, dcvec), job 1 [hid, 1]^T gdh (d + 1
// rows: dW2, db2).  kDwRows rows at a time are staged in shared memory
// (the A rows padded to lda floats, the G rows to ldg); thread t owns the
// output tile a in [4 ta, 4 ta + 4), c in [8 tb, 8 tb + 8), read as float4.
__global__ void __launch_bounds__(kDwMaxThreads, 1)
walk_dw_kernel(const float* __restrict__ res_h, const float* __restrict__ res_t,
               const float* __restrict__ res_x, const float* __restrict__ rec_hid,
               const float* __restrict__ rec_gp, const float* __restrict__ rec_gdh,
               float* __restrict__ partial, int B, int d, int M, int chunk_rows,
               int scale) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  const int job = blockIdx.z, k = blockIdx.y, K = gridDim.y, ch = blockIdx.x;
  const int lda = (d + 3 + 3) / 4 * 4, ldg = (d + 7) / 8 * 8;
  float* sG = sA + kDwRows * lda;
  const int na = job == 0 ? d + 3 : d + 1;
  const int ntb = (d + kTB - 1) / kTB;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ta = tid / ntb, tb = tid - ta * ntb;
  const bool owner = ta * kTA < na;
  const long long MB = (long long)M * B;
  const long long r_lo = (long long)ch * chunk_rows;
  const long long r_hi = min(MB, r_lo + chunk_rows);
  const float* A = (job == 0 ? res_h : rec_hid) + (size_t)k * MB * d;
  const float* G = (job == 0 ? rec_gp : rec_gdh) + (size_t)k * MB * d;
  float acc[kTA][kTB];
#pragma unroll
  for (int i = 0; i < kTA; ++i)
#pragma unroll
    for (int j = 0; j < kTB; ++j) acc[i][j] = 0.0f;
  for (long long r0 = r_lo; r0 < r_hi; r0 += kDwRows) {
    const int nr = (int)min((long long)kDwRows, r_hi - r0);
    __syncthreads();  // the last tile is consumed
    for (int e = tid; e < kDwRows * lda; e += nt) {
      const int rr = e / lda, a = e - rr * lda;
      float v = 0.0f;
      if (rr < nr) {
        const long long r = r0 + rr;  // = g B + b, the residuals' index too
        if (a < d) {
          v = A[(size_t)r * d + a];
          if (job == 0) v = scale_in(v, scale);
        } else if (a == d) {
          v = job == 0 ? res_x[r] : 1.0f;
        } else if (job == 0 && a == d + 1) {
          v = res_t[r];
        } else if (job == 0 && a == d + 2) {
          v = 1.0f;
        }
      }
      sA[e] = v;
    }
    for (int e = tid; e < kDwRows * ldg; e += nt) {
      const int rr = e / ldg, c = e - rr * ldg;
      sG[e] = rr < nr && c < d ? G[(size_t)(r0 + rr) * d + c] : 0.0f;
    }
    __syncthreads();
    if (owner) {
#pragma unroll 4
      for (int rr = 0; rr < nr; ++rr) {
        const float4 av = *reinterpret_cast<const float4*>(sA + rr * lda + kTA * ta);
        const float4 g0 = *reinterpret_cast<const float4*>(sG + rr * ldg + kTB * tb);
        const float4 g1 = *reinterpret_cast<const float4*>(sG + rr * ldg + kTB * tb + 4);
        const float a4[kTA] = {av.x, av.y, av.z, av.w};
        const float g8[kTB] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int i = 0; i < kTA; ++i)
#pragma unroll
          for (int j = 0; j < kTB; ++j) acc[i][j] = fmaf(a4[i], g8[j], acc[i][j]);
      }
    }
  }
  if (!owner) return;
  const int dd = d * d;
  float* out = partial + ((size_t)ch * K + k) * grad_floats(d);
#pragma unroll
  for (int i = 0; i < kTA; ++i) {
    const int a = kTA * ta + i;
    if (a >= na) break;
    int off;
    if (a < d) off = (job == 0 ? 0 : dd) + a * d;
    else if (job == 1) off = 2 * dd + 3 * d;  // db2
    else off = 2 * dd + (a - d) * d;          // dw1x, dw1t, dcvec
#pragma unroll
    for (int j = 0; j < kTB; ++j) {
      const int c = kTB * tb + j;
      if (c < d) out[off + c] = acc[i][j];
    }
  }
}

// sums the chunks' partials in chunk order: out[e] = sum_t partial[t][e]
__global__ void walk_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int tiles, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.0f;
  for (int t = 0; t < tiles; ++t) sum += partial[(size_t)t * n + e];
  out[e] = sum;
}

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

// the walks' shared bytes, forward and backward (walk_fwd_plan and
// walk_bwd_plan in ops/walk_scan.py)
size_t walk_smem_bytes(int d, int N, int wpt, int warps) {
  const size_t HP = d <= 64 ? 64 : 128, rpb = warps / wpt;
  return (2 * HP * (HP + 1) + rpb * 2 * wpt * HP + 2 * rpb * (size_t)N) * sizeof(float);
}

// the sums' threads: one a 4 x 8 output tile of job 0, in whole warps
int dw_threads(int d) {
  const int tiles = (d + 3 + kTA - 1) / kTA * ((d + kTB - 1) / kTB);
  return (tiles + kWarp - 1) / kWarp * kWarp;
}

}  // namespace

// The forward walk.  res_h/res_t/res_x may be null (no residuals kept).
// plan = [wpt, warps] (walk_fwd_plan in ops/walk_scan.py), smem_bytes the
// walk's shared bytes.  Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int njode_walk_fwd(const void* hj, const void* xs, const void* ts,
                              const void* reset_cell, const void* read_cell,
                              const void* w1, const void* cvec, const void* w2,
                              const void* b2, void* hminus, void* res_h,
                              void* res_t, void* res_x, int K, int B, int N,
                              int d, int M, float dt, int act, int scale,
                              const int* plan, long long smem_bytes, void* stream) {
  const int wpt = plan[0], warps = plan[1];
  if (K < 1 || K > 65535 || B < 1 || N < 2 || d < 1 || d > 128 || M < 0 ||
      act < 0 || act > kSelu || scale < 0 || scale > kScaleSigmoid ||
      (wpt != 1 && wpt != 2 && wpt != 4) || warps < wpt || warps > kBwdMaxWarps ||
      warps % wpt != 0)
    return (int)cudaErrorInvalidValue;
  const bool save = res_h != nullptr;
  if (save && (res_t == nullptr || res_x == nullptr)) return (int)cudaErrorInvalidValue;
  int max_smem = 0;
  int err = max_smem_optin(&max_smem);
  if (err != 0) return err;
  if ((size_t)smem_bytes < walk_smem_bytes(d, N, wpt, warps) || smem_bytes > max_smem)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_bytes;
  const int rpb = warps / wpt;
  const dim3 grid((B + rpb - 1) / rpb, K), block(kWarp, warps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *f_hj = static_cast<const float*>(hj), *f_xs = static_cast<const float*>(xs),
              *f_ts = static_cast<const float*>(ts), *f_w1 = static_cast<const float*>(w1),
              *f_cv = static_cast<const float*>(cvec), *f_w2 = static_cast<const float*>(w2),
              *f_b2 = static_cast<const float*>(b2);
  const int *i_rs = static_cast<const int*>(reset_cell), *i_rd = static_cast<const int*>(read_cell);
  float *f_hm = static_cast<float*>(hminus), *f_rh = static_cast<float*>(res_h),
        *f_rt = static_cast<float*>(res_t), *f_rx = static_cast<float*>(res_x);
  cudaError_t e = cudaSuccess;
  const bool ri = act == kRelu && scale == kIdentity;
#define NJODE_WALK_FWD(C, RI, SV)                                                 \
  {                                                                               \
    auto kern = walk_fwd_kernel<C, RI, SV>;                                       \
    e = set_smem(kern, smem);                                                     \
    if (e == cudaSuccess)                                                         \
      kern<<<grid, block, smem, s>>>(f_hj, f_xs, f_ts, i_rs, i_rd, f_w1, f_cv,    \
                                     f_w2, f_b2, f_hm, f_rh, f_rt, f_rx, B, N, d, \
                                     M, dt, act, scale, wpt);                     \
  }
#define NJODE_WALK_FWD_SV(C, RI)                            \
  if (save) NJODE_WALK_FWD(C, RI, true) else NJODE_WALK_FWD(C, RI, false)
  if (d <= 64) {
    if (ri) NJODE_WALK_FWD_SV(2, true) else NJODE_WALK_FWD_SV(2, false)
  } else {
    if (ri) NJODE_WALK_FWD_SV(4, true) else NJODE_WALK_FWD_SV(4, false)
  }
#undef NJODE_WALK_FWD_SV
#undef NJODE_WALK_FWD
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The backward walk, the weight sums and their chunk-order sum: three
// launches on `stream`.  ct_hj must be zeroed by the caller (slots that
// never reset get no cotangent); records is scratch of 3 K M B d floats,
// partial of chunks K (2 d^2 + 4 d), chunks = ceil(M B / chunk_rows);
// grads (K, 2 d^2 + 4 d) receives [dW1h, dW2, dw1x, dw1t, dcvec, db2].
// plan = [wpt, warps, chunk_rows] (walk_bwd_plan in ops/walk_scan.py),
// smem_bytes the walk's shared bytes.  Returns the CUDA error (0 on success).
extern "C" int njode_walk_bwd(const void* ct_hm, const void* res_h, const void* res_t,
                              const void* res_x, const void* reset_cell,
                              const void* read_cell, const void* w1, const void* cvec,
                              const void* w2, void* ct_hj, void* records, void* partial,
                              void* grads, int K, int B, int N, int d, int M, float dt,
                              int act, int scale, const int* plan, long long smem_bytes,
                              void* stream) {
  const int wpt = plan[0], warps = plan[1], chunk_rows = plan[2];
  if (K < 1 || K > 65535 || B < 1 || N < 2 || d < 1 || d > 128 || M < 0 || act < 0 ||
      act > kSelu || scale < 0 || scale > kScaleSigmoid ||
      (wpt != 1 && wpt != 2 && wpt != 4) || warps < wpt || warps > kBwdMaxWarps ||
      warps % wpt != 0 || chunk_rows < kDwRows || chunk_rows % kDwRows != 0)
    return (int)cudaErrorInvalidValue;
  int max_smem = 0;
  int err = max_smem_optin(&max_smem);
  if (err != 0) return err;
  if ((size_t)smem_bytes < walk_smem_bytes(d, N, wpt, warps) || smem_bytes > max_smem)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_bytes;
  const int rpb = warps / wpt;
  const dim3 grid((B + rpb - 1) / rpb, K), block(kWarp, warps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *f_ct = static_cast<const float*>(ct_hm), *f_rh = static_cast<const float*>(res_h),
              *f_rt = static_cast<const float*>(res_t), *f_rx = static_cast<const float*>(res_x),
              *f_w1 = static_cast<const float*>(w1), *f_cv = static_cast<const float*>(cvec),
              *f_w2 = static_cast<const float*>(w2);
  const int *i_rs = static_cast<const int*>(reset_cell), *i_rd = static_cast<const int*>(read_cell);
  float* f_cj = static_cast<float*>(ct_hj);
  const size_t rec = (size_t)K * M * B * d;
  float* f_hid = static_cast<float*>(records);
  float *f_gp = f_hid + rec, *f_gdh = f_hid + 2 * rec;
  float* f_pt = static_cast<float*>(partial);
  cudaError_t e = cudaSuccess;
  const bool ri = act == kRelu && scale == kIdentity;
#define NJODE_WALK_BWD(C, RI)                                                             \
  {                                                                                       \
    auto kern = walk_bwd_kernel<C, RI>;                                                   \
    e = set_smem(kern, smem);                                                             \
    if (e == cudaSuccess)                                                                 \
      kern<<<grid, block, smem, s>>>(f_ct, f_rh, f_rt, f_rx, i_rs, i_rd, f_w1, f_cv, f_w2, \
                                     f_cj, f_hid, f_gp, f_gdh, B, N, d, M, dt, act, scale, \
                                     wpt);                                                \
  }
  if (d <= 64) {
    if (ri) NJODE_WALK_BWD(2, true) else NJODE_WALK_BWD(2, false)
  } else {
    if (ri) NJODE_WALK_BWD(4, true) else NJODE_WALK_BWD(4, false)
  }
#undef NJODE_WALK_BWD
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long MB = (long long)M * B;
  const int chunks = (int)((MB + chunk_rows - 1) / chunk_rows);
  if (chunks > 0) {
    const size_t dw_smem = (size_t)kDwRows * ((d + 6) / 4 * 4 + (d + 7) / 8 * 8) * sizeof(float);
    walk_dw_kernel<<<dim3(chunks, K, 2), dw_threads(d), dw_smem, s>>>(
        f_rh, f_rt, f_rx, f_hid, f_gp, f_gdh, f_pt, B, d, M, chunk_rows, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const int n = K * grad_floats(d);
  walk_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(f_pt, static_cast<float*>(grads), chunks, n);
  return (int)cudaGetLastError();
}

extern "C" const char* njode_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
