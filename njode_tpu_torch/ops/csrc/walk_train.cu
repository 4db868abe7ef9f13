// The production training run on Hopper (sm_90a): every minibatch Adam step
// of an epoch of the shared-network grid-walk model, in one launch.
//
// Replaces the TPU kernel njode_tpu/ops/walk_train.py:_walk_train_kernel
// (line 178).  Each step, as walk_train.py:305-610:
//
//   1. the jump network at all N slots of every trajectory;
//   2. the forward grid walk over the M cells of {g dt} (the tableau of
//      euler, heun or rk4; t_elapsed = dt for euler, 0 for the stages of
//      heun and rk4), keeping the post-reset carry of every cell as the
//      residual and the pre-jump state of every slot;
//   3. the readouts on the jump and pre-jump states;
//   4. the closed-form cotangents of the NJ-ODE loss (ignore_first_continuity,
//      trajectory mask, the valid count shared over the minibatch), as
//      train_kernel.py:_loss_and_cotangents;
//   5. the readout backward;
//   6. the backward walk, the cells in reverse, stages recomputed from the
//      residual; at a reset cell the carry's cotangent goes to the jump state
//      and the carry takes the cotangent of that slot's pre-jump state;
//   7. the jump backward;
//   8. the cell-invariant bias cvec = tel w1_tel + b1: its cotangent goes to
//      b1 and, times tel, to the t_elapsed column of W1;
//   9. Adam with torch's math (L2 into the gradient, bias-corrected step) on
//      every parameter entry.
//
// The TPU layout (row pairs in 128 lanes, kron(I_2, .) weight planes, the
// half-swap symmetrization, the VMEM ring and its checkpoints) is not
// copied: the parameters are one flat vector in the order and orientation
// of the model's named_parameters(), so the train state maps to the model's
// state_dict and torch.optim.Adam's state by reshaping alone.
//
// What bounds it on the H100: the walk's dependency chain.  Each step runs
// M cells forward, then M cells backward, per trajectory; a cell is 2
// dependent H-long products a stage forward and 3 backward (the recompute
// and the two transposed products).  So the design keeps every trajectory's
// walk free of any other's, and shortens each cell:
//
//   * Phase A, one group of 1-4 warps a trajectory (4 at batch <= 256,
//     where the minibatch leaves most of the card idle), up to 128 blocks of
//     at most 8 warps (at batch 256: 128 blocks of 2 trajectories x 4
//     warps, every SM sub-partition busy).  A lane owns CPT of the H
//     columns; the carry, the stages and their cotangents live in registers,
//     alike in every warp of the group; each product is split by input rows
//     over the group's warps (shuffles bring the vector's entries, W1h / W2
//     come from zero-padded planes of shared memory, two accumulators a
//     column), and the partial sums meet in shared memory at one group
//     barrier a product.  No block barrier inside the walk.  The backward
//     walk writes, per (trajectory, cell, stage), the four vectors the
//     weight cotangents are sums over (the scaled stage input with [x, t, 1]
//     beside it, the hidden activation with [1], the pre-activation
//     cotangent, the stage cotangent) to a step buffer in device memory
//     (about 21 MB at the production shape, in L2), in tiles of 32 rows
//     stored column-major.
//   * Phase B, after a grid barrier: every weight cotangent as a product
//     sum over the buffer's rows ([H x rows] by [rows x H]), and the jump
//     and readout sums over the minibatch's rows (their operands tiled
//     alike), cut into 8 x 8 output tiles spread over all blocks.  A tile's
//     threads take the rows in turn, a warp a tile of 32 rows, so its loads
//     coalesce; their partials meet by a fixed shuffle tree and a fixed
//     order over warps, so each entry is summed in one order and a call
//     repeats bitwise.  The thread that owns an entry's sum applies Adam to
//     it.  A grid barrier ends the step: two a step.
//   * Where the buffer would outgrow its cap (the wrapper's launch_plan
//     chooses the cells a chunk holds), the backward walk runs in chunks of
//     cells from the last; each chunk's sums are added to a running sum in
//     device memory in chunk order, at two barriers a chunk.
//
// Layout (all f32 unless said; njode_tpu_torch/ops/walk_train.py writes it
// down): data (G*BS, 2N+1) rows [x_0..x_{N-1}, t_0..t_{N-1}, valid];
// params, m, v (P,) in the order jump_nn.net.0.{weight (H,1), bias},
// jump_nn.net.3.{weight (H,H), bias}, ode_func.net.0.{weight (H,H+3) with
// input columns [h, x, t_rel, t_elapsed], bias}, ode_func.net.3.{weight,
// bias}, output_nn.net.0.{weight, bias}, output_nn.net.3.{weight (K,H),
// bias (K)}; stat (2,) = [b1^t, b2^t]; losses (G,); scratch of
// njode_walk_train_scratch_floats floats.
//
// The bf16 instances (BF; row 13b: the TPU kernel's mxu="bfloat16",
// walk_train.py:213-225) round both operands of every product to bf16 and
// sum in f32 (a product of two bf16 values is exact in f32, so only the
// order of the f32 sums differs), at the TPU walk's own points: its drift
// is one product of [s(state), s(x), t, 1] with [W1h; w1x; w1t; cvec] and
// one of [hidden, 1] with [W2; b2] (walk_train.py:286-303), so x, t, w1x,
// w1t, cvec (tel w1_tel + b1, rounded once after it is formed) and b2 round
// too, and so do the step buffer's records, every column of them: the
// gradients of W1, b1, w1_tel, W2 and b2 come from rounded factors.  The
// jump's J2 and the readout's O1 products round both operands, and so do
// their weight sums, but not their bias columns (bj2, bo1: column sums of
// f32 cotangents); the j1, bj1, o2 and bo2 sums and the readout's o2 stay
// f32.  Each operand is rounded once, where it is staged, formed or
// loaded, never in place of a value also read in f32 (the carry, hj, the
// pre-jump states, the cotangents dup and dhjp).
//
// Numerics: built without --use_fast_math.  Sums run in other orders than
// the plain PyTorch version's; the recompute of a cell in the backward walk
// runs the forward's own code, so it is bitwise the forward; the grid cell
// of a time is floor(t (1/dt) + 0.5) with the product and the sum rounded
// apart, as the TPU kernel computes it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "walk_cell.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace njode_walk;

constexpr int kMaxWarps = 8;
constexpr int kMaxStages = 4;
constexpr int kTO = 8, kTA = 8;  // a gradient tile: outputs x input columns
constexpr int kTile = kTO * kTA;

struct Dims {
  int K, H, N, BS, G, M, act, scale, second_moment, warps, four, n_st, chunk, wpt;
  int bf16;  // the products' operands rounded to bf16
};

struct Hyper {
  float dt, inv_dt, tel, lr, wd, b1, b2, omb1, omb2, adam_eps, eps, w0, w1, inv_n,
      w0n, w1n;
};

// explicit Runge-Kutta tableau: stage i's input is cp + sum_j da[i][j] k_j on
// the h part and t + dc[i]; the step adds dt * sum_i bw[i] k_i; gb[i] =
// dt * bw[i] (the host rounds each product from double once)
struct Tab {
  float da[kMaxStages][kMaxStages];
  float dc[kMaxStages];
  float bw[kMaxStages];
  float gb[kMaxStages];
};

// offsets of the flat parameter vector (torch order and orientation)
struct Off {
  int j1w, j1b, J2, j2b, W1, b1, W2, b2, O1, bo1, o2, bo2, P;
};

__host__ __device__ __forceinline__ Off param_offsets(int H, int K) {
  Off o;
  o.j1w = 0;
  o.j1b = H;
  o.J2 = 2 * H;
  o.j2b = o.J2 + H * H;
  o.W1 = o.j2b + H;
  o.b1 = o.W1 + H * (H + 3);
  o.W2 = o.b1 + H;
  o.b2 = o.W2 + H * H;
  o.O1 = o.b2 + H;
  o.bo1 = o.O1 + H * H;
  o.o2 = o.bo1 + H;
  o.bo2 = o.o2 + K * H;
  o.P = o.bo2 + K;
  return o;
}

// Scratch offsets (floats).  Per-trajectory arrays are [BS][rows][width];
// a width of H + 1 (or H + 3) carries a column of ones (and the x and t
// columns) beside the H-vector, so that phase B reads every sum's operands
// as plain matrices.  The step buffer's rows run [BS][cells of the chunk]
// [stages] and are stored in tiles of 32 rows, column-major inside a tile
// (tiled()), so that phase B, a row a lane, reads it coalesced.
struct Lay {
  long long a1p, a1, hjp, xj, inb, up, ua, dup, din, sct, dhjp, da1, cp, ct, cx, y, gy,
      lt;
  long long sc, hid, gp, gk;  // the step buffer
  long long gw;               // the walk's sums carried over chunks
  long long total;
};

__host__ __device__ __forceinline__ Lay layout(const Dims& d) {
  const long long H = d.H, N = d.N, R2 = 2 * d.N - 1, BS = d.BS, M = d.M, K = d.K;
  // rows of a tiled matrix, whole tiles of 32
  const long long Tj = (BS * N + kWarp - 1) / kWarp * kWarp;
  const long long Tr = (BS * R2 + kWarp - 1) / kWarp * kWarp;
  const long long Tw = (BS * d.chunk * d.n_st + kWarp - 1) / kWarp * kWarp;
  Lay l;
  long long p = 0;
  l.a1p = p; p += BS * N * H;
  l.a1 = p; p += Tj * (H + 1);
  l.hjp = p; p += BS * N * H;
  l.xj = p; p += Tj * 2;
  l.inb = p; p += Tr * (H + 1);
  l.up = p; p += BS * R2 * H;
  l.ua = p; p += Tr * (H + 1);
  l.dup = p; p += Tr * H;
  l.din = p; p += BS * R2 * H;
  l.sct = p; p += BS * N * H;
  l.dhjp = p; p += Tj * H;
  l.da1 = p; p += Tj * H;
  l.cp = p; p += BS * M * H;
  l.ct = p; p += BS * M;
  l.cx = p; p += BS * M;
  l.y = p; p += BS * R2 * K;
  l.gy = p; p += Tr * K;
  l.lt = p; p += BS;
  l.sc = p; p += Tw * (H + 3);
  l.hid = p; p += Tw * (H + 1);
  l.gp = p; p += Tw * H;
  l.gk = p; p += Tw * H;
  l.gw = p; p += H * (H + 3) + H * (H + 1);
  l.total = p;
  return l;
}

// the block's shared memory: W1h, W2, J2 and (four) O1, each in a plane
// (part_mm), a gradient tile a warp and two partial products a warp
__host__ __device__ __forceinline__ size_t smem_floats(int H, int warps, bool four) {
  const size_t hp = plane_rows(H);
  return (four ? 4 : 3) * hp * (hp + 1) + (size_t)warps * (kTile + 2 * hp);
}

// offset of (row r, column col) in a matrix of ncols columns stored in
// tiles of 32 rows, column-major inside a tile
__device__ __forceinline__ size_t tiled(size_t r, int col, int ncols) {
  return ((r / kWarp) * ncols + col) * kWarp + r % kWarp;
}

// the grid cell of an observation time, floor(t (1/dt) + 0.5), unfused
__device__ __forceinline__ int cell_of(float t, float inv_dt) {
  return (int)floorf(__fadd_rn(__fmul_rn(t, inv_dt), 0.5f));
}

// Calls f(s), on every lane, for each slot s in [s_lo, N) of a data row
// whose grid cell is g, in slot order: the lanes test 32 slots at a time
// and a ballot names the matches.  cell0 is the lane's cell of slot lane.
template <typename F>
__device__ __forceinline__ void slots_at(const float* row, int N, int s_lo, int g,
                                         int lane, int cell0, float inv_dt, F f) {
  for (int s0 = 0; s0 < N; s0 += kWarp) {
    const int s = s0 + lane;
    const int c = s0 == 0 ? cell0 : (s < N ? cell_of(__ldg(row + N + s), inv_dt) : -2);
    unsigned m = __ballot_sync(0xffffffffu, s >= s_lo && s < N && c == g);
    while (m) {
      const int bit = __ffs(m) - 1;
      m &= m - 1;
      f(s0 + bit);
    }
  }
}

// A matrix of ncols columns in device memory stored in tiles of 32 rows
// (tiled()), seen from row row0: the operands of phase B's sums.
struct TMat {
  float* p;
  int ncols;
  long long row0;
  __device__ __forceinline__ float& at(int r, int col) const {
    return p[tiled(row0 + r, col, ncols)];
  }
};

// Applies epi(r, c, j, acc), j = lane + 32 c, for the rows r = first,
// first + step, ... < nrows of in times the plane W or, TRANS, its
// transpose, 4 rows at a time; the rows' entries are read as broadcasts
// (BF: rounded as they are read; the plane is rounded where staged).
template <int CPT, bool TRANS, bool BF, typename Epi>
__device__ __forceinline__ void warp_rows(const TMat& in, int first, int step, int nrows,
                                          const float* W, int ld, int H, int lane, Epi epi) {
  for (int r0 = first; r0 < nrows; r0 += 4 * step) {
    const float* x[4];
    float acc[4][CPT];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[q] = &in.at(r0 + q * step < nrows ? r0 + q * step : r0, 0);
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[q][c] = 0.0f;
    }
#pragma unroll 4
    for (int i = 0; i < H; ++i) {
      float w[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        w[c] = TRANS ? W[j * ld + i] : W[i * ld + j];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float xv = operand<BF>(x[q][i * kWarp]);
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[q][c] = fmaf(xv, w[c], acc[q][c]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (r0 + q * step >= nrows) break;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < H) epi(r0 + q * step, c, j, acc[q][c]);
      }
    }
  }
}

// stage i's input: the carry plus the earlier stages' k by the tableau
template <int CPT, int NS>
__device__ __forceinline__ void stage_in(const float (&carry)[CPT],
                                         const float (&k)[NS][CPT], int i, const Tab& tb,
                                         float (&sin)[CPT]) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    float v = carry[c];
#pragma unroll
    for (int jj = 0; jj < NS; ++jj)
      if (jj < i && tb.da[i][jj] != 0.0f) v = fmaf(tb.da[i][jj], k[jj][c], v);
    sin[c] = v;
  }
}

// the lane's CPT entries of the length-H vector at p (device memory the
// Adam phase of other blocks writes: read from L2)
template <int CPT>
__device__ __forceinline__ void lane_vec(const float* p, int stride, int H, int lane,
                                         float (&out)[CPT]) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = lane + kWarp * c;
    out[c] = j < H ? __ldcg(p + (size_t)j * stride) : 0.0f;
  }
}

__device__ __forceinline__ void adam_entry(float* params, float* adam_m, float* adam_v,
                                           int e, float g, const Hyper& hp, float c1,
                                           float c2) {
  const float p = __ldcg(params + e);
  g = g + hp.wd * p;
  const float m = hp.b1 * __ldcg(adam_m + e) + hp.omb1 * g;
  const float v = hp.b2 * __ldcg(adam_v + e) + hp.omb2 * g * g;
  const float m_hat = m / (1.0f - c1);
  const float v_hat = v / (1.0f - c2);
  params[e] = p - hp.lr * m_hat / (sqrtf(v_hat) + hp.adam_eps);
  adam_m[e] = m;
  adam_v[e] = v;
}

// The sums of phase B: out[o][a] = sum_r B[r][o] A[r][a] over a job's rows.
enum Job { kJobW1 = 0, kJobW2, kJobO1, kJobO2, kJobJ2, kJobJ1, kNumJobs };

struct JobShape {
  const float* A;  // rows x cols (lda), stored in tiles of 32 rows
  const float* B;  // rows x outs (ldb), likewise
  long long rows;
  int lda, ldb, cols, outs;
};

__device__ __forceinline__ JobShape job_shape(int job, const float* scr, const Lay& l,
                                              const Dims& d, long long walk_rows) {
  const int H = d.H;
  const long long R2 = 2 * d.N - 1, BS = d.BS;
  switch (job) {
    case kJobW1: return {scr + l.sc, scr + l.gp, walk_rows, H + 3, H, H + 3, H};
    case kJobW2: return {scr + l.hid, scr + l.gk, walk_rows, H + 1, H, H + 1, H};
    case kJobO1: return {scr + l.inb, scr + l.dup, BS * R2, H + 1, H, H + 1, H};
    case kJobO2: return {scr + l.ua, scr + l.gy, BS * R2, H + 1, d.K, H + 1, d.K};
    case kJobJ2: return {scr + l.a1, scr + l.dhjp, BS * d.N, H + 1, H, H + 1, H};
    default: return {scr + l.xj, scr + l.da1, BS * d.N, 2, H, 2, H};
  }
}

// A thread's share of a tile's sums: rows tid, tid + n_thr, ... (n_thr a
// multiple of 32, so a warp's rows are one tile and its loads coalesce).
// BF: the columns a < round_below take both factors rounded (the matrix
// part of the J2 and O1 sums), the others (their bias columns) f32.  The
// jobs with round_below 0 take the second loop, without the per-FMA choice
// of factor: with one loop for both, the bf16 instance's epoch call at the
// production shape took 21.44 ms against the f32 instance's 17.38 (H100);
// with two, within 5% of it.
template <bool BF>
__device__ __forceinline__ void tile_rows(const JobShape& js, const int (&ac)[kTA],
                                          const int (&oc)[kTO], int tid, int n_thr,
                                          int round_below, float (&acc)[kTO][kTA]) {
  for (long long r = tid; r < js.rows; r += n_thr) {
    const float* Ar = js.A + (r / kWarp) * js.lda * kWarp + r % kWarp;
    const float* Br = js.B + (r / kWarp) * js.ldb * kWarp + r % kWarp;
    float av[kTA], bv[kTO];
#pragma unroll
    for (int q = 0; q < kTA; ++q) av[q] = __ldcg(Ar + ac[q] * kWarp);
#pragma unroll
    for (int p = 0; p < kTO; ++p) bv[p] = __ldcg(Br + oc[p] * kWarp);
    if (BF && round_below > 0) {
      float br[kTO];
#pragma unroll
      for (int p = 0; p < kTO; ++p) br[p] = operand<BF>(bv[p]);
#pragma unroll
      for (int q = 0; q < kTA; ++q)
        if (ac[q] < round_below) av[q] = operand<BF>(av[q]);
#pragma unroll
      for (int p = 0; p < kTO; ++p)
#pragma unroll
        for (int q = 0; q < kTA; ++q)
          acc[p][q] = fmaf(ac[q] < round_below ? br[p] : bv[p], av[q], acc[p][q]);
      continue;
    }
#pragma unroll
    for (int p = 0; p < kTO; ++p)
#pragma unroll
      for (int q = 0; q < kTA; ++q) acc[p][q] = fmaf(bv[p], av[q], acc[p][q]);
  }
}

__device__ __forceinline__ int job_tiles(int job, const Dims& d) {
  const int cols = job == kJobW1 ? d.H + 3 : (job == kJobJ1 ? 2 : d.H + 1);
  const int outs = job == kJobO2 ? d.K : d.H;
  return ((outs + kTO - 1) / kTO) * ((cols + kTA - 1) / kTA);
}

// Adam on the parameter entries whose gradient is out[o][a] of a job
__device__ __forceinline__ void update_from(int job, int o, int a, float s, float* params,
                                            float* adam_m, float* adam_v, const Off& of,
                                            const Dims& d, const Hyper& hp, float c1,
                                            float c2) {
  const int H = d.H;
  auto up = [&](int e, float g) { adam_entry(params, adam_m, adam_v, e, g, hp, c1, c2); };
  switch (job) {
    case kJobW1:
      if (a < H + 2) {
        up(of.W1 + o * (H + 3) + a, s);
      } else {  // cvec's cotangent: to b1, and tel x it to the t_elapsed column
        up(of.b1 + o, s);
        up(of.W1 + o * (H + 3) + H + 2, hp.tel * s);
      }
      break;
    case kJobW2: up(a < H ? of.W2 + o * H + a : of.b2 + o, s); break;
    case kJobO1: up(a < H ? of.O1 + o * H + a : of.bo1 + o, s); break;
    case kJobO2: up(a < H ? of.o2 + o * H + a : of.bo2 + o, s); break;
    case kJobJ2: up(a < H ? of.J2 + o * H + a : of.j2b + o, s); break;
    default: up(a == 0 ? of.j1w + o : of.j1b + o, s); break;
  }
}

template <int CPT, int NS, bool RI, bool BF>
__global__ void __launch_bounds__(kWarp * kMaxWarps)
walk_train_kernel(const float* __restrict__ data, float* params, float* adam_m,
                  float* adam_v, float* stat, float* losses, float* scratch, Dims d,
                  Hyper hp, Tab tb, Off of, Lay L) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int nw = blockDim.y, n_thr = kWarp * nw, tid = warp * kWarp + lane;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int H = d.H, N = d.N, R2 = 2 * N - 1, K = d.K, M = d.M, BS = d.BS;
  const int row_f = 2 * N + 1, H1 = H + 1, WPT = d.wpt;
  float* const S = scratch;  // of, L: the host's offsets, in the parameter bank

  const int HP = plane_rows(H), ld = HP + 1, PL = HP * ld;
  float* sW1 = smem;
  float* sW2 = sW1 + PL;
  float* sJ2 = sW2 + PL;
  float* sO1 = d.four ? sJ2 + PL : sJ2;  // three planes: O1 takes J2's turn
  float* red = smem + (d.four ? 4 : 3) * PL;  // nw x kTile

  // this warp's trajectory and its place in the trajectory's group
  const int grp = warp / WPT, wg = warp % WPT;
  const int b = blk * (nw / WPT) + grp;
  const bool active = b < BS;
  Group gr;
  gr.wpt = WPT;
  gr.wg = wg;
  gr.bar_id = 1 + grp;
  gr.bar_n = kWarp * WPT;
  gr.r_lo = wg * (HP / WPT);
  gr.r_hi = min(gr.r_lo + HP / WPT, (H + 15) / 16 * 16);
  gr.par = 0;
  gr.part = red + nw * kTile + grp * 2 * WPT * (kWarp * CPT);
  auto sync_group = [&]() { group_sync(gr.bar_id, gr.bar_n); };
  // the activation and the input scaling: relu and identity fixed at
  // compile time in the production instance (RI), else chosen at run time
  auto act = [&](float x) { return RI ? (x < 0.0f ? 0.0f : x) : activate(x, d.act); };
  auto actg = [&](float x) { return RI ? (x > 0.0f ? 1.0f : 0.0f) : act_grad(x, d.act); };
  auto scl = [&](float x) { return RI ? x : scale_in(x, d.scale); };
  auto sclg = [&](float x) { return RI ? 1.0f : scale_grad(x, d.scale); };
  float c1 = stat[0], c2 = stat[1];

  // the planes' padding stays zero; a step stages their H x H entries from
  // the torch (out, in) matrices, reading params in order (BF: rounded)
  for (int e = tid; e < (d.four ? 4 : 3) * PL; e += n_thr) smem[e] = 0.0f;
  __syncthreads();
  auto stage_plane = [&](float* dst, int src) {
#pragma unroll 4
    for (int e = tid; e < H * H; e += n_thr) {
      const int o = e / H, i = e - o * H;
      dst[i * ld + o] = operand<BF>(__ldcg(params + src + e));
    }
  };

  for (int step = 0; step < d.G; ++step) {
    c1 *= hp.b1;
    c2 *= hp.b2;
    const float* rows = data + (size_t)step * BS * row_f;
    const float* row = rows + (size_t)(active ? b : 0) * row_f;
    // per-trajectory device rows: its own, and its rows of phase B's tiled
    // operands
    float* a1p = S + L.a1p + (size_t)b * N * H;
    float* hjp = S + L.hjp + (size_t)b * N * H;
    float* up = S + L.up + (size_t)b * R2 * H;
    float* din = S + L.din + (size_t)b * R2 * H;
    float* sct = S + L.sct + (size_t)b * N * H;
    float* cp = S + L.cp + (size_t)b * M * H;
    float* ct = S + L.ct + (size_t)b * M;
    float* cx = S + L.cx + (size_t)b * M;
    float* yb = S + L.y + (size_t)b * R2 * K;
    const long long jr0 = (long long)b * N, rr0 = (long long)b * R2;
    const TMat a1{S + L.a1, H1, jr0}, xj{S + L.xj, 2, jr0}, dhjp{S + L.dhjp, H, jr0},
        da1{S + L.da1, H, jr0};
    const TMat inb{S + L.inb, H1, rr0}, ua{S + L.ua, H1, rr0}, dup{S + L.dup, H, rr0},
        gy{S + L.gy, K, rr0};
    // the step buffer's four records, each written by one warp of the group
    const bool rec_sc = wg == 0, rec_hid = wg == 1 % WPT, rec_gp = wg == 2 % WPT,
               rec_gk = wg == 3 % WPT;

#pragma unroll 4
    for (int e = tid; e < H * H; e += n_thr) {
      const int o = e / H, i = e - o * H;
      const float w1 = __ldcg(params + of.W1 + o * (H + 3) + i);
      const float w2 = __ldcg(params + of.W2 + e), j2 = __ldcg(params + of.J2 + e);
      const float o1 = d.four ? __ldcg(params + of.O1 + e) : 0.0f;
      sW1[i * ld + o] = operand<BF>(w1);
      sW2[i * ld + o] = operand<BF>(w2);
      sJ2[i * ld + o] = operand<BF>(j2);
      if (d.four) sO1[i * ld + o] = operand<BF>(o1);
    }
    float nv = 0.0f;  // the minibatch's valid count, every warp alike
    for (int bb = lane; bb < BS; bb += kWarp) nv += __ldg(rows + (size_t)bb * row_f + 2 * N);
    nv = fmaxf(warp_sum(nv), 1.0f);
    const int cell0 = active && lane < N ? cell_of(__ldg(row + N + lane), hp.inv_dt) : -2;

    // the walk's per-column constants (the jump network's and the
    // readout's are read in their phases, so the walk holds fewer
    // registers); BF: as the products read them, cvec rounded once formed
    float w1x[CPT], w1t[CPT], cv[CPT], bb2[CPT];
    {
      float w1tel[CPT], bb1[CPT];
      lane_vec<CPT>(params + of.W1 + H, H + 3, H, lane, w1x);
      lane_vec<CPT>(params + of.W1 + H + 1, H + 3, H, lane, w1t);
      lane_vec<CPT>(params + of.W1 + H + 2, H + 3, H, lane, w1tel);
      lane_vec<CPT>(params + of.b1, 1, H, lane, bb1);
      lane_vec<CPT>(params + of.b2, 1, H, lane, bb2);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        cv[c] = operand<BF>(hp.tel != 0.0f ? hp.tel * w1tel[c] + bb1[c] : bb1[c]);
        w1x[c] = operand<BF>(w1x[c]);
        w1t[c] = operand<BF>(w1t[c]);
        bb2[c] = operand<BF>(bb2[c]);
      }
    }
    __syncthreads();

    if (active) {
      // ---- 1. jump forward, the group's warps taking the slots in turn
      float j1w[CPT], j1b[CPT], j2b[CPT];
      lane_vec<CPT>(params + of.j1w, 1, H, lane, j1w);
      lane_vec<CPT>(params + of.j1b, 1, H, lane, j1b);
      lane_vec<CPT>(params + of.j2b, 1, H, lane, j2b);
      for (int s = wg; s < N; s += WPT) {
        const float x = __ldg(row + s);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = lane + kWarp * c;
          if (j >= H) continue;
          const float pre = x * j1w[c] + j1b[c];
          a1p[(size_t)s * H + j] = pre;
          a1.at(s, j) = act(pre);
        }
        if (lane == 0) {
          a1.at(s, H) = 1.0f;
          xj.at(s, 0) = x;
          xj.at(s, 1) = 1.0f;
        }
      }
      __syncwarp();
      warp_rows<CPT, false, BF>(a1, wg, WPT, N, sJ2, ld, H, lane,
                                [&](int r, int c, int j, float acc) {
        const float pre = acc + j2b[c];
        hjp[(size_t)r * H + j] = pre;
        inb.at(r, j) = act(pre);
      });
      for (int r = wg; r < R2; r += WPT) {
        if (lane == 0) inb.at(r, H) = 1.0f;
        if (r >= N)
          for (int j = lane; j < H; j += kWarp) inb.at(r, j) = 0.0f;
      }
      sync_group();

      // ---- 2. forward walk, every warp of the group alike; the first
      // stores the residual and the pre-jump states
      float carry[CPT], tt = 0.0f, xx = 0.0f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) carry[c] = 0.0f;
      for (int g = 0; g < M; ++g) {
        slots_at(row, N, 1, g, lane, cell0, hp.inv_dt, [&](int s) {
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int j = lane + kWarp * c;
            if (j < H && wg == 0) inb.at(N + s - 1, j) = carry[c];
          }
        });
        slots_at(row, N, 0, g, lane, cell0, hp.inv_dt, [&](int s) {
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int j = lane + kWarp * c;
            if (j < H) carry[c] = inb.at(s, j);
          }
          tt = __ldg(row + N + s);
          xx = scl(__ldg(row + s));
        });
        if (wg == 0) {
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int j = lane + kWarp * c;
            if (j < H) cp[(size_t)g * H + j] = carry[c];
          }
          if (lane == 0) {
            ct[g] = tt;
            cx[g] = xx;
          }
        }
        float k[NS][CPT];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          float sin[CPT], v[CPT], acc[CPT];
          stage_in<CPT, NS>(carry, k, i, tb, sin);
#pragma unroll
          for (int c = 0; c < CPT; ++c) v[c] = scl(sin[c]);
          group_mm<CPT, false, BF>(v, sW1, ld, H, lane, gr, acc);
          const float ts = operand<BF>(tb.dc[i] != 0.0f ? tt + tb.dc[i] : tt);
          const float xr = operand<BF>(xx);
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            v[c] = act(fmaf(ts, w1t[c], fmaf(xr, w1x[c], acc[c])) + cv[c]);
          group_mm<CPT, false, BF>(v, sW2, ld, H, lane, gr, acc);
#pragma unroll
          for (int c = 0; c < CPT; ++c) k[i][c] = acc[c] + bb2[c];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          float a = tb.bw[0] == 1.0f ? k[0][c] : tb.bw[0] * k[0][c];
#pragma unroll
          for (int i = 1; i < NS; ++i) a = a + (tb.bw[i] == 1.0f ? k[i][c] : tb.bw[i] * k[i][c]);
          carry[c] = carry[c] + hp.dt * a;
        }
        tt = tt + hp.dt;
      }
      slots_at(row, N, 1, M, lane, cell0, hp.inv_dt, [&](int s) {  // the final carry
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = lane + kWarp * c;
          if (j < H && wg == 0) inb.at(N + s - 1, j) = carry[c];
        }
      });
    }
    if (!d.four) {  // O1 takes the third plane
      __syncthreads();
      stage_plane(sO1, of.O1);
      __syncthreads();
    }

    float ga[CPT];
    if (active) {
      float bo1[CPT], o2v[2][CPT];
      lane_vec<CPT>(params + of.bo1, 1, H, lane, bo1);
      lane_vec<CPT>(params + of.o2, 1, H, lane, o2v[0]);
      lane_vec<CPT>(params + of.o2 + (K - 1) * H, 1, H, lane, o2v[1]);
      const float bo2_0 = __ldcg(params + of.bo2), bo2_1 = __ldcg(params + of.bo2 + K - 1);
      sync_group();
      // ---- 3. readouts of the 2N-1 rows, the group's warps in turn
      warp_rows<CPT, false, BF>(inb, wg, WPT, R2, sO1, ld, H, lane,
                                [&](int r, int c, int j, float acc) {
        const float pre = acc + bo1[c];
        up[(size_t)r * H + j] = pre;
        ua.at(r, j) = act(pre);
      });
      __syncwarp();
      for (int r = wg; r < R2; r += WPT) {
        if (lane == 0) ua.at(r, H) = 1.0f;
        for (int k = 0; k < K; ++k) {
          float part = 0.0f;
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int j = lane + kWarp * c;
            if (j < H) part += ua.at(r, j) * (k == 0 ? o2v[0][c] : o2v[1][c]);
          }
          part = warp_sum(part);
          if (lane == 0) yb[r * K + k] = part + (k == 0 ? bo2_0 : bo2_1);
        }
      }
      sync_group();

      // ---- 4. loss and its cotangents, the group's first warp, lanes
      // over slots
      if (wg == 0) {
        const float valid = __ldg(row + 2 * N);
        const float wrow = valid / nv;
        float sum0 = 0.0f, sum1 = 0.0f;
        for (int r = lane; r < N; r += kWarp) {
          const bool cont = r > 0;
          const int rb = N + r - 1;
          const float xs = __ldg(row + r);
          const float a0 = yb[r * K];
          const float b0 = cont ? yb[rb * K] : 0.0f;
          const float e_a = xs - a0, e_b = xs - b0;
          const float aj = e_a * e_a;
          const float ac = cont ? e_b * e_b : 0.0f;
          const float sa = sqrtf(aj + hp.eps), sc = sqrtf(ac + hp.eps);
          sum0 += (sa + sc) * (sa + sc);
          gy.at(r, 0) = wrow * hp.w0n * ((sa + sc) / sa) * 2.0f * (a0 - xs);
          if (cont) gy.at(rb, 0) = wrow * hp.w0n * ((sa + sc) / sc) * 2.0f * (b0 - xs);
          if (K == 2) {
            const float a1v = yb[r * K + 1];
            const float b1v = cont ? yb[rb * K + 1] : 0.0f;
            float V, Vb, Z, Zb, dV, dVb;
            if (d.second_moment) {
              V = a1v; Vb = b1v; Z = xs * xs; Zb = Z; dV = 1.0f; dVb = 1.0f;
            } else {
              V = a1v * a1v; Vb = b1v * b1v; Z = aj; Zb = ac; dV = 2.0f * a1v; dVb = 2.0f * b1v;
            }
            const float e_j = Z - V, e_c = Zb - Vb;
            const float sva = sqrtf(e_j * e_j + hp.eps);
            const float svc = sqrtf((cont ? e_c * e_c : 0.0f) + hp.eps);
            sum1 += (sva + svc) * (sva + svc);
            gy.at(r, 1) = wrow * hp.w1n * ((sva + svc) / sva) * 2.0f * (V - Z) * dV;
            if (cont)
              gy.at(rb, 1) = wrow * hp.w1n * ((sva + svc) / svc) * 2.0f * (Vb - Zb) * dVb;
          }
        }
        sum0 = warp_sum(sum0);
        sum1 = warp_sum(sum1);
        if (lane == 0) {
          const float L0 = sum0 * hp.inv_n;
          S[L.lt + b] =
              K == 1 ? hp.w0 * L0 * valid : (hp.w0 * L0 + hp.w1 * (sum1 * hp.inv_n)) * valid;
        }
      }
      sync_group();

      // ---- 5. readout backward: dup, then din = dup O1^T, rows in turn
      for (int r = wg; r < R2; r += WPT)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = lane + kWarp * c;
          if (j >= H) continue;
          float gsum = gy.at(r, 0) * o2v[0][c];
          if (K == 2) gsum += gy.at(r, 1) * o2v[1][c];
          dup.at(r, j) = gsum * actg(up[(size_t)r * H + j]);
        }
      __syncwarp();
      warp_rows<CPT, true, BF>(dup, wg, WPT, R2, sO1, ld, H, lane,
                           [&](int r, int c, int j, float acc) { din[(size_t)r * H + j] = acc; });
      if (wg == 0)
        for (int j = lane; j < H; j += kWarp)
          for (int s = 0; s < N; ++s) sct[(size_t)s * H + j] = 0.0f;
      sync_group();

      // ---- 6. backward walk: the carry's cotangent from the slots at cell M
#pragma unroll
      for (int c = 0; c < CPT; ++c) ga[c] = 0.0f;
      slots_at(row, N, 1, M, lane, cell0, hp.inv_dt, [&](int s) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = lane + kWarp * c;
          if (j < H) ga[c] = din[(size_t)(N + s - 1) * H + j];
        }
      });
    }

    // the cells in chunks from the last; each chunk's sums after a barrier
    for (int hi = M - 1, chunk = 0; hi >= 0; hi -= d.chunk, ++chunk) {
      const int lo = max(0, hi - d.chunk + 1), n_c = hi - lo + 1;
      const bool last = lo == 0;
      if (active) {
        for (int g = hi; g >= lo; --g) {
          float carry[CPT], sin[NS][CPT], pre[NS][CPT], k[NS][CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int j = min(lane + kWarp * c, H - 1);
            carry[c] = cp[(size_t)g * H + j];
          }
          const float tt = ct[g], xx = operand<BF>(cx[g]);
          const size_t r0 = ((size_t)b * n_c + (g - lo)) * NS;
          // recompute the stages, recording what the weight sums read (BF:
          // as the products read them)
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            float v[CPT], acc[CPT];
            stage_in<CPT, NS>(carry, k, i, tb, sin[i]);
            float* rsc = S + L.sc + tiled(r0 + i, 0, H + 3);
            float* rhid = S + L.hid + tiled(r0 + i, 0, H1);
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              v[c] = scl(sin[i][c]);
              const int j = lane + kWarp * c;
              if (j < H && rec_sc) rsc[j * kWarp] = operand<BF>(v[c]);
            }
            group_mm<CPT, false, BF>(v, sW1, ld, H, lane, gr, acc);
            const float ts = operand<BF>(tb.dc[i] != 0.0f ? tt + tb.dc[i] : tt);
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              pre[i][c] = fmaf(ts, w1t[c], fmaf(xx, w1x[c], acc[c])) + cv[c];
              v[c] = act(pre[i][c]);
              const int j = lane + kWarp * c;
              if (j < H && rec_hid) rhid[j * kWarp] = operand<BF>(v[c]);
            }
            if (lane == 0 && rec_sc) {
              rsc[H * kWarp] = xx;
              rsc[(H + 1) * kWarp] = ts;
              rsc[(H + 2) * kWarp] = 1.0f;
            }
            if (lane == 0 && rec_hid) rhid[H * kWarp] = 1.0f;
            if (i + 1 < NS) {  // the last stage's k feeds no later stage
              group_mm<CPT, false, BF>(v, sW2, ld, H, lane, gr, acc);
#pragma unroll
              for (int c = 0; c < CPT; ++c) k[i][c] = acc[c] + bb2[c];
            }
          }
          // stage cotangents: gk_i = dt b_i ga, then the stages in reverse
          float gcp[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            gcp[c] = ga[c];
#pragma unroll
            for (int i = 0; i < NS; ++i) k[i][c] = tb.gb[i] * ga[c];
          }
#pragma unroll
          for (int i = NS - 1; i >= 0; --i) {
            float gp[CPT], acc[CPT];
            float* rgk = S + L.gk + tiled(r0 + i, 0, H);
            float* rgp = S + L.gp + tiled(r0 + i, 0, H);
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              const int j = lane + kWarp * c;
              if (j < H && rec_gk) rgk[j * kWarp] = operand<BF>(k[i][c]);
            }
            group_mm<CPT, true, BF>(k[i], sW2, ld, H, lane, gr, acc);
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              gp[c] = acc[c] * actg(pre[i][c]);
              const int j = lane + kWarp * c;
              if (j < H && rec_gp) rgp[j * kWarp] = operand<BF>(gp[c]);
            }
            group_mm<CPT, true, BF>(gp, sW1, ld, H, lane, gr, acc);
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              const float gs = acc[c] * sclg(sin[i][c]);
              gcp[c] += gs;
#pragma unroll
              for (int jj = 0; jj < NS; ++jj)
                if (jj < i && tb.da[i][jj] != 0.0f) k[jj][c] += tb.da[i][jj] * gs;
            }
          }
          // resets: the post-reset cotangent to the jump state, the carry
          // takes the cotangent of the slot's pre-jump state
#pragma unroll
          for (int c = 0; c < CPT; ++c) ga[c] = gcp[c];
          slots_at(row, N, 0, g, lane, cell0, hp.inv_dt, [&](int s) {
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              const int j = lane + kWarp * c;
              if (j < H) {
                if (wg == 0) sct[(size_t)s * H + j] = gcp[c];
                ga[c] = s >= 1 ? din[(size_t)(N + s - 1) * H + j] : 0.0f;
              }
            }
          });
        }
      }
      if (last) {
        if (!d.four) {  // J2 back into the third plane
          __syncthreads();
          stage_plane(sJ2, of.J2);
          __syncthreads();
        }
        if (active) {
          // ---- 7. jump backward, slots in turn
          sync_group();
          for (int s = wg; s < N; s += WPT)
            for (int j = lane; j < H; j += kWarp) {
              const float dhj = din[(size_t)s * H + j] + sct[(size_t)s * H + j];
              dhjp.at(s, j) = dhj * actg(hjp[(size_t)s * H + j]);
            }
          __syncwarp();
          warp_rows<CPT, true, BF>(dhjp, wg, WPT, N, sJ2, ld, H, lane,
                               [&](int r, int c, int j, float acc) {
                                 da1.at(r, j) = acc * actg(a1p[(size_t)r * H + j]);
                               });
        }
      }
      grid.sync();

      // ---- phase B: the gradient sums, tile by tile over all blocks; the
      // walk's two jobs every chunk, the others and Adam with the last
      const long long walk_rows = (long long)BS * n_c * NS;
      int n_tiles = 0;
      for (int job = 0; job < (last ? (int)kNumJobs : 2); ++job) n_tiles += job_tiles(job, d);
      for (int t = blk; t < n_tiles; t += nblk) {
        int job = 0, rem = t;
        while (rem >= job_tiles(job, d)) rem -= job_tiles(job, d), ++job;
        const JobShape js = job_shape(job, S, L, d, walk_rows);
        const int n_at = (js.cols + kTA - 1) / kTA;
        const int o0 = (rem / n_at) * kTO, a0 = (rem % n_at) * kTA;
        int ac[kTA], oc[kTO];
#pragma unroll
        for (int q = 0; q < kTA; ++q) ac[q] = min(a0 + q, js.cols - 1);
#pragma unroll
        for (int p = 0; p < kTO; ++p) oc[p] = min(o0 + p, js.outs - 1);
        float acc[kTO][kTA];
#pragma unroll
        for (int p = 0; p < kTO; ++p)
#pragma unroll
          for (int q = 0; q < kTA; ++q) acc[p][q] = 0.0f;
        tile_rows<BF>(js, ac, oc, tid, n_thr,
                      job == kJobO1 || job == kJobJ2 ? H : 0, acc);
#pragma unroll
        for (int p = 0; p < kTO; ++p)
#pragma unroll
          for (int q = 0; q < kTA; ++q) acc[p][q] = warp_sum(acc[p][q]);
        if (lane == 0)
#pragma unroll
          for (int p = 0; p < kTO; ++p)
#pragma unroll
            for (int q = 0; q < kTA; ++q) red[warp * kTile + p * kTA + q] = acc[p][q];
        __syncthreads();
        for (int e = tid; e < kTile; e += n_thr) {
          const int o = o0 + e / kTA, a = a0 + e % kTA;
          if (o >= js.outs || a >= js.cols) continue;
          float s = red[e];
          for (int w = 1; w < nw; ++w) s += red[w * kTile + e];
          if (job <= kJobW2) {  // the walk's sums run over the chunks in order
            float* gw = S + L.gw + (job == kJobW1 ? o * (H + 3) + a
                                                  : H * (H + 3) + o * (H + 1) + a);
            if (chunk > 0) s = __ldcg(gw) + s;
            if (!last) {
              *gw = s;
              continue;
            }
          }
          update_from(job, o, a, s, params, adam_m, adam_v, of, d, hp, c1, c2);
        }
        __syncthreads();
      }
      if (last && blk == 0 && tid == 0) {
        float total = 0.0f;
        for (int bb = 0; bb < BS; ++bb) total += __ldcg(S + L.lt + bb);
        losses[step] = total / nv;
      }
      grid.sync();
    }
  }
  if (blk == 0 && tid == 0) {
    stat[0] = c1;
    stat[1] = c2;
  }
}

template <int CPT, int NS, bool RI, bool BF>
cudaError_t launch(const float* data, float* params, float* m, float* v, float* stat,
                   float* losses, float* scratch, const Dims& d, const Hyper& hp,
                   const Tab& tb, size_t smem, cudaStream_t stream) {
  auto kernel = walk_train_kernel<CPT, NS, RI, BF>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = kWarp * d.warps;
  const int tpb = d.warps / d.wpt;  // trajectories a block
  const int nblk = (d.BS + tpb - 1) / tpb;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm * n_sm < nblk) return cudaErrorCooperativeLaunchTooLarge;
  const float* a_data = data;
  Dims a_d = d;
  Hyper a_hp = hp;
  Tab a_tb = tb;
  Off a_of = param_offsets(d.H, d.K);
  Lay a_L = layout(d);
  void* args[] = {(void*)&a_data, (void*)&params, (void*)&m,       (void*)&v,
                  (void*)&stat,   (void*)&losses, (void*)&scratch, (void*)&a_d,
                  (void*)&a_hp,   (void*)&a_tb,   (void*)&a_of,    (void*)&a_L};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(nblk), dim3(kWarp, d.warps),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

Dims dims_of(const int* dims) {
  return Dims{dims[0], dims[1],  dims[2],  dims[3],  dims[4],  dims[5],  dims[6],  dims[7],
              dims[8], dims[9], dims[10], dims[11], dims[12], dims[13], dims[14]};
}

}  // namespace

// Floats of the scratch a launch with these dims needs (dims as for
// njode_walk_train_run).
extern "C" long long njode_walk_train_scratch_floats(const int* dims) {
  return layout(dims_of(dims)).total;
}

// dims = [K, H, N, BS, G, M, act, scale, second_moment, warps, four, n_st,
// chunk, wpt, bf16]; hyper = [dt, 1/dt, tel, lr, wd, b1, b2, 1-b1, 1-b2, adam_eps,
// eps, w0, w1, 1/N, w0/N, w1/N]; tab = [da (4 x 4), dc (4), bw (4), gb (4)]
// (host arrays).  The launch plan (warps a block, warps a trajectory,
// whether O1 has a plane of its own in shared memory, the shared-memory
// bytes, the cells of a chunk of the step buffer) is the caller's
// (launch_plan in ops/walk_train.py); the bytes are checked here against
// what the layout needs and the device's opt-in limit, and the blocks
// against what the device holds at once.  Launches cooperatively on
// `stream` and returns the CUDA error (0 on success).
extern "C" int njode_walk_train_run(const void* data, void* params, void* m, void* v,
                                    void* stat, void* losses, void* scratch,
                                    const int* dims, const float* hyper,
                                    const float* tab, long long smem_bytes,
                                    void* stream) {
  const Dims d = dims_of(dims);
  Hyper hp{hyper[0], hyper[1], hyper[2],  hyper[3],  hyper[4],  hyper[5],
           hyper[6], hyper[7], hyper[8],  hyper[9],  hyper[10], hyper[11],
           hyper[12], hyper[13], hyper[14], hyper[15]};
  Tab tb;
  for (int i = 0; i < kMaxStages; ++i) {
    for (int j = 0; j < kMaxStages; ++j) tb.da[i][j] = tab[i * kMaxStages + j];
    tb.dc[i] = tab[16 + i];
    tb.bw[i] = tab[20 + i];
    tb.gb[i] = tab[24 + i];
  }
  if (d.K < 1 || d.K > 2 || d.H < 1 || d.H > 128 || d.N < 2 || d.BS < 1 || d.G < 0 ||
      d.M < 1 || d.act < 0 || d.act > kSelu || d.scale < 0 || d.scale > kScaleSigmoid ||
      d.warps < 1 || d.warps > kMaxWarps || d.four < 0 || d.four > 1 ||
      (d.n_st != 1 && d.n_st != 2 && d.n_st != 4) || d.chunk < 1 ||
      (d.wpt != 1 && d.wpt != 2 && d.wpt != 4) || d.warps % d.wpt != 0 || d.bf16 < 0 ||
      d.bf16 > 1)
    return (int)cudaErrorInvalidValue;
  if (d.G == 0) return 0;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t need = smem_floats(d.H, d.warps, d.four) * sizeof(float);
  if ((size_t)smem_bytes < need || smem_bytes > max_smem) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_bytes;
  const float* f_data = static_cast<const float*>(data);
  float* f_p = static_cast<float*>(params);
  float* f_m = static_cast<float*>(m);
  float* f_v = static_cast<float*>(v);
  float* f_s = static_cast<float*>(stat);
  float* f_l = static_cast<float*>(losses);
  float* f_x = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NJODE_WT(C, NS, RI)                                                                  \
  err = d.bf16 ? launch<C, NS, RI, true>(f_data, f_p, f_m, f_v, f_s, f_l, f_x, d, hp, tb, smem, s) \
               : launch<C, NS, RI, false>(f_data, f_p, f_m, f_v, f_s, f_l, f_x, d, hp, tb, smem, s)
  // relu and identity (the production recipe's) at compile time with euler
  const bool ri = d.act == kRelu && d.scale == kIdentity;
  if (d.H <= 64) {
    if (d.n_st == 1 && ri) NJODE_WT(2, 1, true);
    else if (d.n_st == 1) NJODE_WT(2, 1, false);
    else if (d.n_st == 2) NJODE_WT(2, 2, false);
    else NJODE_WT(2, 4, false);
  } else {
    if (d.n_st == 1 && ri) NJODE_WT(4, 1, true);
    else if (d.n_st == 1) NJODE_WT(4, 1, false);
    else if (d.n_st == 2) NJODE_WT(4, 2, false);
    else NJODE_WT(4, 4, false);
  }
#undef NJODE_WT
  return (int)err;
}

extern "C" const char* njode_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
