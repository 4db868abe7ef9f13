// The production training run on Hopper (sm_90a): every minibatch Adam step
// of an epoch of the shared-network grid-walk model, in one launch.
//
// Replaces the TPU kernel njode_tpu/ops/walk_train.py:_walk_train_kernel
// (line 178).  Each step, as walk_train.py:305-610:
//
//   1. the jump network at all N slots of every trajectory;
//   2. the forward grid walk over the M cells of {g dt} (walk_scan.cu's cell,
//      with the tableau of euler, heun or rk4; t_elapsed = dt for euler, 0
//      for the stages of heun and rk4), keeping the post-reset carry of
//      every cell as the residual and the pre-jump state of every slot;
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
// What bounds it on the H100: the f32 products of the walk, M dependent
// cells each step, each cell 2 (H x H) products per stage forward and 4
// backward per trajectory.  One block on one SM would serialize a cell's
// products over the whole minibatch (the one-SM limit of train_run.cu), so
// the minibatch's trajectories are split over blocks of 4-8, one a warp
// (with as many warps again, up to 8 a block, that only help with the
// block's gradient sums), launched cooperatively so that every block is
// resident (64 blocks of 8 warps at batch 256): each block runs
// steps 1-7 on its own trajectories with no grid barrier, summing the weight
// cotangents of its rows in shared memory (each entry owned by one thread,
// rows in order), and writes them as a partial; after a grid barrier each
// parameter entry is summed over the partials in block order and updated
// by Adam, and a second barrier ends the step.  The result repeats bitwise.
// Per-trajectory working sets (jump activations, the readout rows, the walk
// residual, M (H + 2) floats) live in device memory, about 50 KB a
// trajectory at the production shape, so a minibatch's sit in L2.
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
// Numerics: built without --use_fast_math.  Sums run in other orders than
// the plain PyTorch version's, and the compiler contracts multiply-adds;
// the grid cell of a time is floor(t (1/dt) + 0.5) with the product and the
// sum rounded apart, as the TPU kernel computes it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

#include "walk_cell.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace njode_walk;

constexpr int RPW = 1;          // trajectories per warp
constexpr int kMaxWarps = 8;
constexpr int kMaxStages = 4;

struct Dims {
  int K, H, N, BS, G, M, act, scale, second_moment, warps, staged, n_st;
};

struct Hyper {
  float dt, inv_dt, tel, lr, wd, b1, b2, omb1, omb2, adam_eps, eps, w0, w1, inv_n,
      w0n, w1n;
};

// explicit Runge-Kutta tableau: stage i's input is cp + sum_j da[i][j] k_j on
// the h part and t + dc[i]; the step adds dt * sum_i bw[i] k_i; gb[i] =
// dt * bw[i] (the host rounds each product from double once)
struct Tab {
  int n;
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

// per-trajectory scratch in device memory, layout [BS][rows][H]
struct Rows {
  float *a1p, *a1, *hjp, *inb, *up, *dup, *din, *sct, *dhjp, *da1, *cp;  // H-wide
  float *ct, *cx, *y, *gy;                                              // scalars
};

__host__ __device__ __forceinline__ long long row_floats(int H, int N, int M, int K) {
  const int R2 = 2 * N - 1;
  return (long long)H * (7 * N + 4 * R2 + M) + 2LL * M + 2LL * K * R2;
}

__host__ __device__ __forceinline__ long long scratch_floats(const Dims& d, int nblk) {
  const Off o = param_offsets(d.H, d.K);
  return 4LL * d.H * d.H + (long long)d.BS * row_floats(d.H, d.N, d.M, d.K) +
         (long long)nblk * (o.P + 1);
}

__device__ Rows make_rows(float* base, const Dims& d) {
  const int H = d.H, N = d.N, M = d.M, R2 = 2 * N - 1;
  const size_t BS = d.BS;
  Rows r;
  float* p = base;
  r.a1p = p; p += BS * N * H;
  r.a1 = p; p += BS * N * H;
  r.hjp = p; p += BS * N * H;
  r.inb = p; p += BS * R2 * H;
  r.up = p; p += BS * R2 * H;
  r.dup = p; p += BS * R2 * H;
  r.din = p; p += BS * R2 * H;
  r.sct = p; p += BS * N * H;
  r.dhjp = p; p += BS * N * H;
  r.da1 = p; p += BS * N * H;
  r.cp = p; p += BS * M * H;
  r.ct = p; p += BS * M;
  r.cx = p; p += BS * M;
  r.y = p; p += BS * d.K * R2;
  r.gy = p;
  return r;
}

// the grid cell of an observation time, floor(t (1/dt) + 0.5), unfused
__device__ __forceinline__ int cell_of(float t, float inv_dt) {
  return (int)floorf(__fadd_rn(__fmul_rn(t, inv_dt), 0.5f));
}

// Applies epi(r, j, acc) for the warp's nrows rows of in (row stride H,
// device memory) times W (in, out) or, TRANS, W^T, 4 rows at a time.
template <int CPT, bool TRANS, int LOAD, typename Epi>
__device__ __forceinline__ void warp_rows(const float* in, int nrows, const float* W,
                                          int ldw, int H, int lane, Epi epi) {
  for (int r0 = 0; r0 < nrows; r0 += 4) {
    float acc[4][CPT];
    rows_mm<CPT, 4, TRANS, LOAD>(in + (size_t)r0 * H, H, min(4, nrows - r0), W, ldw, H,
                                 lane, acc);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (r0 + q >= nrows) break;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < H) epi(r0 + q, j, acc[q][c]);
      }
    }
  }
}

template <int CPT, bool STAGE>
__global__ void __launch_bounds__(kWarp * kMaxWarps)
walk_train_kernel(const float* __restrict__ data, float* params, float* adam_m,
                  float* adam_v, float* stat, float* losses, float* scratch, Dims d,
                  Hyper hp, Tab tb) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ float sh_nv;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int n_thr = kWarp * blockDim.y, tid = warp * kWarp + lane;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int gtid = blk * n_thr + tid, g_thr = nblk * n_thr;
  const int H = d.H, N = d.N, S = N - 1, R2 = 2 * N - 1, K = d.K, M = d.M, BS = d.BS;
  const int HH = H * H, row_f = 2 * N + 1, ns = tb.n;
  const Off o = param_offsets(H, K);
  // trajectories per block: one each for the first d.warps warps; the
  // block's other warps (as many again, up to kMaxWarps) only help with the
  // block-wide gradient sums
  const int R = RPW * d.warps;
  const bool row_warp = warp < d.warps;

  // device-memory scratch
  float* wio = scratch;  // J2, W1h, W2, O1 in (in, out) orientation
  const Rows rw = make_rows(scratch + 4 * HH, d);
  float* partial = scratch + 4 * HH + (size_t)BS * row_floats(H, N, M, K);
  float* lossp = partial + (size_t)nblk * o.P;
  float* mypart = partial + (size_t)blk * o.P;

  // shared memory: staged weights, the walk's gradient accumulator, the
  // per-row buffers of the walk, per-row scalars
  const int ld = STAGE ? (H | 1) : H;
  // weights in shared memory load plainly; in device memory from L2, since
  // the Adam phase of other blocks rewrites them between grid barriers
  constexpr int kLoad = STAGE ? kLoadPlain : kLoadCg;
  float* sw = smem;
  float* gacc = smem + (STAGE ? 4 * H * ld : 0);
  const int NA = 2 * HH + 4 * H;
  float* bufs = gacc + NA;
  const int RH = R * H;
  float* b_carry = bufs;
  float* b_ga = b_carry + RH;
  float* b_gcp = b_ga + RH;
  float* st_base = b_gcp + RH;  // per stage: sin, sc, pre, hid, kg, gp
  auto st_buf = [&](int i, int which) { return st_base + (size_t)(6 * i + which) * RH; };
  float* s_tt = st_base + (size_t)6 * ns * RH;
  float* s_xx = s_tt + R;
  float* s_tst = s_xx + R;  // ns x R stage times
  float* s_lt = s_tst + ns * R;
  int* s_cell = reinterpret_cast<int*>(s_lt + R);  // R x N grid cells of the slots

  for (int e = gtid; e < HH; e += g_thr) {
    const int r = e / H, c = e - r * H;  // torch (out = r, in = c)
    wio[c * H + r] = params[o.J2 + e];
    wio[HH + c * H + r] = params[o.W1 + r * (H + 3) + c];
    wio[2 * HH + c * H + r] = params[o.W2 + e];
    wio[3 * HH + c * H + r] = params[o.O1 + e];
  }
  float c1 = stat[0], c2 = stat[1];
  grid.sync();

  const int wr0 = blk * R + warp * RPW;                 // this warp's first trajectory
  const int n_my = row_warp ? max(0, min(RPW, BS - wr0)) : 0;
  const int br0 = blk * R;
  const int n_blk_rows = max(0, min(R, BS - br0));
  float* my_carry = b_carry + warp * RPW * H;
  float* my_ga = b_ga + warp * RPW * H;
  float* my_gcp = b_gcp + warp * RPW * H;

  for (int step = 0; step < d.G; ++step) {
    c1 *= hp.b1;
    c2 *= hp.b2;
    const float* rows = data + (size_t)step * BS * row_f;
    const float* J2;
    const float* W1h;
    const float* W2;
    const float* O1;
    if constexpr (STAGE) {
      for (int e = tid; e < 4 * HH; e += n_thr) {
        const int m = e / HH, rem = e - m * HH, i = rem / H, j = rem - i * H;
        sw[(m * H + i) * ld + j] = __ldcg(wio + e);
      }
      J2 = sw;
      W1h = sw + H * ld;
      W2 = sw + 2 * H * ld;
      O1 = sw + 3 * H * ld;
    } else {
      J2 = wio;
      W1h = wio + HH;
      W2 = wio + 2 * HH;
      O1 = wio + 3 * HH;
    }
    if (warp == 0) {  // the minibatch's valid count, every block alike
      float nv = 0.0f;
      for (int b = lane; b < BS; b += kWarp) nv += rows[(size_t)b * row_f + 2 * N];
      nv = warp_sum(nv);
      if (lane == 0) sh_nv = fmaxf(nv, 1.0f);
    }
    for (int e = tid; e < R * N; e += n_thr) {
      const int b = br0 + e / N;
      s_cell[e] = b < BS ? cell_of(rows[(size_t)b * row_f + N + e % N], hp.inv_dt) : -2;
    }
    __syncthreads();
    const float nv = sh_nv;

    if (n_my > 0) {
      // ---- 1. jump forward at all slots of the warp's trajectories
      const int nsr = n_my * N;
      float* a1p = rw.a1p + (size_t)wr0 * N * H;
      float* a1 = rw.a1 + (size_t)wr0 * N * H;
      float* hjp = rw.hjp + (size_t)wr0 * N * H;
      for (int r = 0; r < nsr; ++r) {
        const float x = rows[(size_t)(wr0 + r / N) * row_f + r % N];
        for (int j = lane; j < H; j += kWarp) {
          const float pre = x * __ldcg(params + o.j1w + j) + __ldcg(params + o.j1b + j);
          a1p[(size_t)r * H + j] = pre;
          a1[(size_t)r * H + j] = activate(pre, d.act);
        }
      }
      __syncwarp();
      warp_rows<CPT, false, kLoad>(a1, nsr, J2, ld, H, lane, [&](int r, int j, float acc) {
        const float pre = acc + __ldcg(params + o.j2b + j);
        hjp[(size_t)r * H + j] = pre;
        const int b = r / N, s = r - b * N;
        rw.inb[((size_t)(wr0 + b) * R2 + s) * H + j] = activate(pre, d.act);
      });
      __syncwarp();

      // ---- 2. forward walk
      float tt[RPW], xx[RPW];
      float w1x[CPT], w1t[CPT], w1tel[CPT], bb1[CPT], bb2[CPT], cv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        const bool in = j < H;
        w1x[c] = in ? __ldcg(params + o.W1 + j * (H + 3) + H) : 0.0f;
        w1t[c] = in ? __ldcg(params + o.W1 + j * (H + 3) + H + 1) : 0.0f;
        w1tel[c] = in ? __ldcg(params + o.W1 + j * (H + 3) + H + 2) : 0.0f;
        bb1[c] = in ? __ldcg(params + o.b1 + j) : 0.0f;
        bb2[c] = in ? __ldcg(params + o.b2 + j) : 0.0f;
        cv[c] = hp.tel != 0.0f ? hp.tel * w1tel[c] + bb1[c] : bb1[c];
      }
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        tt[q] = 0.0f;
        xx[q] = 0.0f;
        if (q < n_my)
          for (int j = lane; j < H; j += kWarp) {
            my_carry[q * H + j] = 0.0f;
            for (int s = 1; s < N; ++s) rw.inb[((size_t)(wr0 + q) * R2 + N + s - 1) * H + j] = 0.0f;
          }
      }
      __syncwarp();
      for (int g = 0; g < M; ++g) {
        for (int q = 0; q < n_my; ++q) {
          const int b = wr0 + q;
          const float* row = rows + (size_t)b * row_f;
          const int* cq = s_cell + (warp * RPW + q) * N;
          for_slots_at(cq, N, 1, g, lane, [&](int s) {
            for (int j = lane; j < H; j += kWarp)
              rw.inb[((size_t)b * R2 + N + s - 1) * H + j] = my_carry[q * H + j];
          });
          for_slots_at(cq, N, 0, g, lane, [&](int s) {
            for (int j = lane; j < H; j += kWarp)
              my_carry[q * H + j] = rw.inb[((size_t)b * R2 + s) * H + j];
            tt[q] = row[N + s];
            xx[q] = scale_in(row[s], d.scale);
          });
          for (int j = lane; j < H; j += kWarp)
            rw.cp[((size_t)b * M + g) * H + j] = my_carry[q * H + j];
          if (lane == 0) {
            rw.ct[(size_t)b * M + g] = tt[q];
            rw.cx[(size_t)b * M + g] = xx[q];
          }
        }
        __syncwarp();
        for (int i = 0; i < ns; ++i) {
          float* sin_i = st_buf(i, 0) + warp * RPW * H;
          float* sc_i = st_buf(i, 1) + warp * RPW * H;
          float* hid_i = st_buf(i, 3) + warp * RPW * H;
          float* k_i = st_buf(i, 4) + warp * RPW * H;
          for (int q = 0; q < RPW; ++q)
            for (int j = lane; j < H; j += kWarp) {
              float v = my_carry[q * H + j];
              for (int jj = 0; jj < i; ++jj)
                if (tb.da[i][jj] != 0.0f)
                  v = v + tb.da[i][jj] * st_buf(jj, 4)[(warp * RPW + q) * H + j];
              sin_i[q * H + j] = v;
              sc_i[q * H + j] = scale_in(v, d.scale);
            }
          __syncwarp();
          float acc[RPW][CPT];
          rows_mm<CPT, RPW, false, kLoad>(sc_i, H, RPW, W1h, ld, H, lane, acc);
#pragma unroll
          for (int q = 0; q < RPW; ++q) {
            const float ts = tb.dc[i] != 0.0f ? tt[q] + tb.dc[i] : tt[q];
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              const int j = lane + kWarp * c;
              if (j < H)
                hid_i[q * H + j] =
                    activate(acc[q][c] + xx[q] * w1x[c] + ts * w1t[c] + cv[c], d.act);
            }
          }
          __syncwarp();
          rows_mm<CPT, RPW, false, kLoad>(hid_i, H, RPW, W2, ld, H, lane, acc);
#pragma unroll
          for (int q = 0; q < RPW; ++q)
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              const int j = lane + kWarp * c;
              if (j < H) k_i[q * H + j] = acc[q][c] + bb2[c];
            }
          __syncwarp();
        }
        for (int q = 0; q < RPW; ++q) {
          for (int j = lane; j < H; j += kWarp) {
            const int at = (warp * RPW + q) * H + j;
            float a = tb.bw[0] == 1.0f ? st_buf(0, 4)[at] : tb.bw[0] * st_buf(0, 4)[at];
            for (int i = 1; i < ns; ++i)
              a = a + (tb.bw[i] == 1.0f ? st_buf(i, 4)[at] : tb.bw[i] * st_buf(i, 4)[at]);
            my_carry[q * H + j] = my_carry[q * H + j] + hp.dt * a;
          }
          tt[q] = tt[q] + hp.dt;
        }
        __syncwarp();
      }
      for (int q = 0; q < n_my; ++q) {  // slots at cell M read the final carry
        const int b = wr0 + q;
        for_slots_at(s_cell + (warp * RPW + q) * N, N, 1, M, lane, [&](int s) {
          for (int j = lane; j < H; j += kWarp)
            rw.inb[((size_t)b * R2 + N + s - 1) * H + j] = my_carry[q * H + j];
        });
      }
      __syncwarp();

      // ---- 3. readouts of the 2N-1 rows of each trajectory
      const int nrr = n_my * R2;
      float* inb = rw.inb + (size_t)wr0 * R2 * H;
      float* up = rw.up + (size_t)wr0 * R2 * H;
      warp_rows<CPT, false, kLoad>(inb, nrr, O1, ld, H, lane, [&](int r, int j, float acc) {
        up[(size_t)r * H + j] = acc + __ldcg(params + o.bo1 + j);
      });
      __syncwarp();
      for (int r = 0; r < nrr; ++r)
        for (int k = 0; k < K; ++k) {
          float part = 0.0f;
          for (int j = lane; j < H; j += kWarp)
            part += activate(up[(size_t)r * H + j], d.act) * __ldcg(params + o.o2 + k * H + j);
          part = warp_sum(part);
          if (lane == 0) {
            const int b = r / R2, rr = r - b * R2;
            rw.y[((size_t)(wr0 + b) * K + k) * R2 + rr] = part + __ldcg(params + o.bo2 + k);
          }
        }
      __syncwarp();

      // ---- 4. loss and its cotangents, lanes over slots
      for (int q = 0; q < n_my; ++q) {
        const int b = wr0 + q;
        const float* row = rows + (size_t)b * row_f;
        const float valid = row[2 * N];
        const float wrow = valid / nv;
        const float* y0 = rw.y + (size_t)b * K * R2;
        const float* y1 = y0 + R2;
        float* g0 = rw.gy + (size_t)b * K * R2;
        float* g1 = g0 + R2;
        float sum0 = 0.0f, sum1 = 0.0f;
        for (int r = lane; r < N; r += kWarp) {
          const bool cont = r > 0;
          const float xs = row[r];
          const float a0 = y0[r];
          const float b0 = cont ? y0[N + r - 1] : 0.0f;
          const float e_a = xs - a0, e_b = xs - b0;
          const float aj = e_a * e_a;
          const float ac = cont ? e_b * e_b : 0.0f;
          const float sa = sqrtf(aj + hp.eps), sc = sqrtf(ac + hp.eps);
          sum0 += (sa + sc) * (sa + sc);
          g0[r] = wrow * hp.w0n * ((sa + sc) / sa) * 2.0f * (a0 - xs);
          if (cont) g0[N + r - 1] = wrow * hp.w0n * ((sa + sc) / sc) * 2.0f * (b0 - xs);
          if (K == 2) {
            const float a1 = y1[r];
            const float b1v = cont ? y1[N + r - 1] : 0.0f;
            float V, Vb, Z, Zb, dV, dVb;
            if (d.second_moment) {
              V = a1; Vb = b1v; Z = xs * xs; Zb = Z; dV = 1.0f; dVb = 1.0f;
            } else {
              V = a1 * a1; Vb = b1v * b1v; Z = aj; Zb = ac; dV = 2.0f * a1; dVb = 2.0f * b1v;
            }
            const float e_j = Z - V, e_c = Zb - Vb;
            const float sva = sqrtf(e_j * e_j + hp.eps);
            const float svc = sqrtf((cont ? e_c * e_c : 0.0f) + hp.eps);
            sum1 += (sva + svc) * (sva + svc);
            g1[r] = wrow * hp.w1n * ((sva + svc) / sva) * 2.0f * (V - Z) * dV;
            if (cont) g1[N + r - 1] = wrow * hp.w1n * ((sva + svc) / svc) * 2.0f * (Vb - Zb) * dVb;
          }
        }
        sum0 = warp_sum(sum0);
        sum1 = warp_sum(sum1);
        if (lane == 0) {
          const float L0 = sum0 * hp.inv_n;
          s_lt[warp * RPW + q] =
              K == 1 ? hp.w0 * L0 * valid : (hp.w0 * L0 + hp.w1 * (sum1 * hp.inv_n)) * valid;
        }
      }
      __syncwarp();

      // ---- 5. readout backward: dup, then din = dup O1^T
      float* dup = rw.dup + (size_t)wr0 * R2 * H;
      float* din = rw.din + (size_t)wr0 * R2 * H;
      for (int r = 0; r < nrr; ++r) {
        const int b = r / R2, rr = r - b * R2;
        const float* gyb = rw.gy + (size_t)(wr0 + b) * K * R2;
        for (int j = lane; j < H; j += kWarp) {
          float gsum = gyb[rr] * __ldcg(params + o.o2 + j);
          if (K == 2) gsum += gyb[R2 + rr] * __ldcg(params + o.o2 + H + j);
          dup[(size_t)r * H + j] = gsum * act_grad(up[(size_t)r * H + j], d.act);
        }
      }
      __syncwarp();
      warp_rows<CPT, true, kLoad>(dup, nrr, O1, ld, H, lane, [&](int r, int j, float acc) {
        din[(size_t)r * H + j] = acc;
      });
      __syncwarp();
    }
    __syncthreads();

    // ---- readout gradients of the block's rows, one pass per entry
    {
      const int nr = n_blk_rows * R2;
      const float* inb = rw.inb + (size_t)br0 * R2 * H;
      const float* up = rw.up + (size_t)br0 * R2 * H;
      const float* dup = rw.dup + (size_t)br0 * R2 * H;
      const int n_e = HH + H + K * H + K;
      for (int e = tid; e < n_e; e += n_thr) {
        float sum = 0.0f;
        if (e < HH) {  // torch O1[out][in]: sum inb[in] dup[out]
          const int out = e / H, in = e - out * H;
          for (int r = 0; r < nr; ++r) sum = fmaf(inb[(size_t)r * H + in], dup[(size_t)r * H + out], sum);
          mypart[o.O1 + e] = sum;
        } else if (e < HH + H) {
          const int j = e - HH;
          for (int r = 0; r < nr; ++r) sum += dup[(size_t)r * H + j];
          mypart[o.bo1 + j] = sum;
        } else if (e < HH + H + K * H) {
          const int kj = e - HH - H, k = kj / H, j = kj - k * H;
          for (int r = 0; r < nr; ++r) {
            const int b = r / R2, rr = r - b * R2;
            sum = fmaf(activate(up[(size_t)r * H + j], d.act),
                       rw.gy[((size_t)(br0 + b) * K + k) * R2 + rr], sum);
          }
          mypart[o.o2 + kj] = sum;
        } else {
          const int k = e - HH - H - K * H;
          for (int b = 0; b < n_blk_rows; ++b)
            for (int rr = 0; rr < R2; ++rr) sum += rw.gy[((size_t)(br0 + b) * K + k) * R2 + rr];
          mypart[o.bo2 + k] = sum;
        }
      }
    }

    // ---- 6. backward walk
    for (int e = tid; e < NA; e += n_thr) gacc[e] = 0.0f;
    float w1x[CPT], w1t[CPT], cv[CPT], bb2[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      const bool in = j < H;
      w1x[c] = in ? __ldcg(params + o.W1 + j * (H + 3) + H) : 0.0f;
      w1t[c] = in ? __ldcg(params + o.W1 + j * (H + 3) + H + 1) : 0.0f;
      const float b1v = in ? __ldcg(params + o.b1 + j) : 0.0f;
      const float tel_w = in ? __ldcg(params + o.W1 + j * (H + 3) + H + 2) : 0.0f;
      cv[c] = hp.tel != 0.0f ? hp.tel * tel_w + b1v : b1v;
      bb2[c] = in ? __ldcg(params + o.b2 + j) : 0.0f;
    }
    for (int q = 0; q < RPW && row_warp; ++q) {
      for (int j = lane; j < H; j += kWarp) my_ga[q * H + j] = 0.0f;
      if (q >= n_my) continue;
      const int b = wr0 + q;
      for (int j = lane; j < H; j += kWarp)
        for (int s = 0; s < N; ++s) rw.sct[((size_t)b * N + s) * H + j] = 0.0f;
      for_slots_at(s_cell + (warp * RPW + q) * N, N, 1, M, lane, [&](int s) {
        for (int j = lane; j < H; j += kWarp)
          my_ga[q * H + j] = rw.din[((size_t)b * R2 + N + s - 1) * H + j];
      });
    }
    __syncthreads();
    for (int g = M - 1; g >= 0; --g) {
      // row phase: recompute the cell's stages from the residual
      if (row_warp) {
#pragma unroll
        for (int q = 0; q < RPW; ++q) {
          const bool in = q < n_my;
          const int b = wr0 + q;
          for (int j = lane; j < H; j += kWarp)
            my_carry[q * H + j] = in ? rw.cp[((size_t)b * M + g) * H + j] : 0.0f;
          if (lane == 0) {
            s_tt[warp * RPW + q] = in ? rw.ct[(size_t)b * M + g] : 0.0f;
            s_xx[warp * RPW + q] = in ? rw.cx[(size_t)b * M + g] : 0.0f;
          }
        }
        __syncwarp();
        for (int i = 0; i < ns; ++i) {
          float* sin_i = st_buf(i, 0) + warp * RPW * H;
          float* sc_i = st_buf(i, 1) + warp * RPW * H;
          float* pre_i = st_buf(i, 2) + warp * RPW * H;
          float* hid_i = st_buf(i, 3) + warp * RPW * H;
          float* k_i = st_buf(i, 4) + warp * RPW * H;
          for (int q = 0; q < RPW; ++q)
            for (int j = lane; j < H; j += kWarp) {
              float v = my_carry[q * H + j];
              for (int jj = 0; jj < i; ++jj)
                if (tb.da[i][jj] != 0.0f)
                  v = v + tb.da[i][jj] * st_buf(jj, 4)[(warp * RPW + q) * H + j];
              sin_i[q * H + j] = v;
              sc_i[q * H + j] = scale_in(v, d.scale);
            }
          if (lane < RPW) {
            const float t0 = s_tt[warp * RPW + lane];
            s_tst[i * R + warp * RPW + lane] = tb.dc[i] != 0.0f ? t0 + tb.dc[i] : t0;
          }
          __syncwarp();
          float acc[RPW][CPT];
          rows_mm<CPT, RPW, false, kLoad>(sc_i, H, RPW, W1h, ld, H, lane, acc);
#pragma unroll
          for (int q = 0; q < RPW; ++q) {
            const float ts = s_tst[i * R + warp * RPW + q], xq = s_xx[warp * RPW + q];
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              const int j = lane + kWarp * c;
              if (j < H) {
                const float pre = acc[q][c] + xq * w1x[c] + ts * w1t[c] + cv[c];
                pre_i[q * H + j] = pre;
                hid_i[q * H + j] = activate(pre, d.act);
              }
            }
          }
          __syncwarp();
          if (i + 1 < ns) {  // the last stage's k feeds no later stage
            rows_mm<CPT, RPW, false, kLoad>(hid_i, H, RPW, W2, ld, H, lane, acc);
#pragma unroll
            for (int q = 0; q < RPW; ++q)
#pragma unroll
              for (int c = 0; c < CPT; ++c) {
                const int j = lane + kWarp * c;
                if (j < H) k_i[q * H + j] = acc[q][c] + bb2[c];
              }
            __syncwarp();
          }
        }
        // stage cotangents: gk_i = dt b_i ga, then the stages in reverse
        for (int q = 0; q < RPW; ++q)
          for (int j = lane; j < H; j += kWarp) {
            const float ga = my_ga[q * H + j];
            for (int i = 0; i < ns; ++i) st_buf(i, 4)[(warp * RPW + q) * H + j] = tb.gb[i] * ga;
            my_gcp[q * H + j] = ga;
          }
        __syncwarp();
        for (int i = ns - 1; i >= 0; --i) {
          float* sin_i = st_buf(i, 0) + warp * RPW * H;
          float* pre_i = st_buf(i, 2) + warp * RPW * H;
          float* gk_i = st_buf(i, 4) + warp * RPW * H;
          float* gp_i = st_buf(i, 5) + warp * RPW * H;
          float acc[RPW][CPT];
          rows_mm<CPT, RPW, true, kLoad>(gk_i, H, RPW, W2, ld, H, lane, acc);
#pragma unroll
          for (int q = 0; q < RPW; ++q)
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              const int j = lane + kWarp * c;
              if (j < H) gp_i[q * H + j] = acc[q][c] * act_grad(pre_i[q * H + j], d.act);
            }
          __syncwarp();
          rows_mm<CPT, RPW, true, kLoad>(gp_i, H, RPW, W1h, ld, H, lane, acc);
#pragma unroll
          for (int q = 0; q < RPW; ++q)
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              const int j = lane + kWarp * c;
              if (j < H) {
                const float gs = acc[q][c] * scale_grad(sin_i[q * H + j], d.scale);
                my_gcp[q * H + j] += gs;
                for (int jj = 0; jj < i; ++jj)
                  if (tb.da[i][jj] != 0.0f)
                    st_buf(jj, 4)[(warp * RPW + q) * H + j] += tb.da[i][jj] * gs;
              }
            }
          __syncwarp();
        }
        // resets: the post-reset cotangent to the jump state, the carry takes
        // the cotangent of the slot's pre-jump state
        for (int q = 0; q < n_my; ++q) {
          const int b = wr0 + q;
          for (int j = lane; j < H; j += kWarp) my_ga[q * H + j] = my_gcp[q * H + j];
          for_slots_at(s_cell + (warp * RPW + q) * N, N, 0, g, lane, [&](int s) {
            for (int j = lane; j < H; j += kWarp) {
              rw.sct[((size_t)b * N + s) * H + j] = my_gcp[q * H + j];
              my_ga[q * H + j] =
                  s >= 1 ? rw.din[((size_t)b * R2 + N + s - 1) * H + j] : 0.0f;
            }
          });
        }
      }
      __syncthreads();
      // block phase: the walk weights' sums of this cell, every entry by
      // its owner (outer_acc, col_acc), stages in reverse, rows in order
      const int nw = blockDim.y;
      for (int i = ns - 1; i >= 0; --i) {
        outer_acc<CPT, kMaxWarps>(st_buf(i, 1), st_buf(i, 5), n_blk_rows, H, gacc, warp,
                                  nw, lane);
        outer_acc<CPT, kMaxWarps>(st_buf(i, 3), st_buf(i, 4), n_blk_rows, H, gacc + HH,
                                  warp, nw, lane);
        if (warp == 0)
          col_acc<CPT, kMaxWarps>(s_xx, st_buf(i, 5), n_blk_rows, H, gacc + 2 * HH, lane);
        else if (warp == 1)
          col_acc<CPT, kMaxWarps>(s_tst + i * R, st_buf(i, 5), n_blk_rows, H,
                                  gacc + 2 * HH + H, lane);
        else if (warp == 2)
          col_acc<CPT, kMaxWarps>(nullptr, st_buf(i, 5), n_blk_rows, H,
                                  gacc + 2 * HH + 2 * H, lane);
        else if (warp == 3)
          col_acc<CPT, kMaxWarps>(nullptr, st_buf(i, 4), n_blk_rows, H,
                                  gacc + 2 * HH + 3 * H, lane);
      }
      __syncthreads();
    }
    // the walk's partial, torch orientation; cvec's cotangent to b1 and tel x
    // it to W1's t_elapsed column
    for (int e = tid; e < H * (H + 3) + 2 * H + HH; e += n_thr) {
      if (e < H * (H + 3)) {
        const int out = e / (H + 3), in = e - out * (H + 3);
        float v;
        if (in < H) v = gacc[in * H + out];
        else if (in == H) v = gacc[2 * HH + out];
        else if (in == H + 1) v = gacc[2 * HH + H + out];
        else v = hp.tel * gacc[2 * HH + 2 * H + out];
        mypart[o.W1 + e] = v;
      } else if (e < H * (H + 3) + H) {
        const int j = e - H * (H + 3);
        mypart[o.b1 + j] = gacc[2 * HH + 2 * H + j];
      } else if (e < H * (H + 3) + 2 * H) {
        const int j = e - H * (H + 3) - H;
        mypart[o.b2 + j] = gacc[2 * HH + 3 * H + j];
      } else {
        const int r = e - H * (H + 3) - 2 * H, out = r / H, in = r - out * H;
        mypart[o.W2 + r] = gacc[HH + in * H + out];
      }
    }

    // ---- 7. jump backward
    if (n_my > 0) {
      const int nsr = n_my * N;
      float* dhjp = rw.dhjp + (size_t)wr0 * N * H;
      float* da1 = rw.da1 + (size_t)wr0 * N * H;
      const float* hjp = rw.hjp + (size_t)wr0 * N * H;
      const float* a1p = rw.a1p + (size_t)wr0 * N * H;
      for (int r = 0; r < nsr; ++r) {
        const int b = r / N, s = r - b * N;
        for (int j = lane; j < H; j += kWarp) {
          const float dhj = rw.din[((size_t)(wr0 + b) * R2 + s) * H + j] +
                            rw.sct[((size_t)(wr0 + b) * N + s) * H + j];
          dhjp[(size_t)r * H + j] = dhj * act_grad(hjp[(size_t)r * H + j], d.act);
        }
      }
      __syncwarp();
      warp_rows<CPT, true, kLoad>(dhjp, nsr, J2, ld, H, lane, [&](int r, int j, float acc) {
        da1[(size_t)r * H + j] = acc * act_grad(a1p[(size_t)r * H + j], d.act);
      });
    }
    __syncthreads();
    {
      const int nr = n_blk_rows * N;
      const float* a1 = rw.a1 + (size_t)br0 * N * H;
      const float* dhjp = rw.dhjp + (size_t)br0 * N * H;
      const float* da1 = rw.da1 + (size_t)br0 * N * H;
      for (int e = tid; e < HH + 3 * H; e += n_thr) {
        float sum = 0.0f;
        if (e < HH) {
          const int out = e / H, in = e - out * H;
          for (int r = 0; r < nr; ++r) sum = fmaf(a1[(size_t)r * H + in], dhjp[(size_t)r * H + out], sum);
          mypart[o.J2 + e] = sum;
        } else if (e < HH + H) {
          const int j = e - HH;
          for (int r = 0; r < nr; ++r) sum += dhjp[(size_t)r * H + j];
          mypart[o.j2b + j] = sum;
        } else if (e < HH + 2 * H) {
          const int j = e - HH - H;
          for (int r = 0; r < nr; ++r) {
            const float x = rows[(size_t)(br0 + r / N) * row_f + r % N];
            sum = fmaf(x, da1[(size_t)r * H + j], sum);
          }
          mypart[o.j1w + j] = sum;
        } else {
          const int j = e - HH - 2 * H;
          for (int r = 0; r < nr; ++r) sum += da1[(size_t)r * H + j];
          mypart[o.j1b + j] = sum;
        }
      }
      if (tid == 0) {
        float lsum = 0.0f;
        for (int r = 0; r < n_blk_rows; ++r) lsum += s_lt[r];
        lossp[blk] = lsum;
      }
    }
    grid.sync();

    // ---- 9. Adam on every entry, partials summed in block order
    for (int e = gtid; e < o.P; e += g_thr) {
      float g = 0.0f;
      for (int b = 0; b < nblk; ++b) g += __ldcg(partial + (size_t)b * o.P + e);
      const float p = params[e];
      g = g + hp.wd * p;
      const float m = hp.b1 * adam_m[e] + hp.omb1 * g;
      const float v = hp.b2 * adam_v[e] + hp.omb2 * g * g;
      const float m_hat = m / (1.0f - c1);
      const float v_hat = v / (1.0f - c2);
      const float pn = p - hp.lr * m_hat / (sqrtf(v_hat) + hp.adam_eps);
      params[e] = pn;
      adam_m[e] = m;
      adam_v[e] = v;
      if (e >= o.J2 && e < o.j2b) {
        const int r = e - o.J2, out = r / H, in = r - out * H;
        wio[in * H + out] = pn;
      } else if (e >= o.W1 && e < o.b1) {
        const int r = e - o.W1, out = r / (H + 3), in = r - out * (H + 3);
        if (in < H) wio[HH + in * H + out] = pn;
      } else if (e >= o.W2 && e < o.b2) {
        const int r = e - o.W2, out = r / H, in = r - out * H;
        wio[2 * HH + in * H + out] = pn;
      } else if (e >= o.O1 && e < o.bo1) {
        const int r = e - o.O1, out = r / H, in = r - out * H;
        wio[3 * HH + in * H + out] = pn;
      }
    }
    if (gtid == 0) {
      float total = 0.0f;
      for (int b = 0; b < nblk; ++b) total += __ldcg(lossp + b);
      losses[step] = total / nv;
    }
    grid.sync();
  }
  if (gtid == 0) {
    stat[0] = c1;
    stat[1] = c2;
  }
}

size_t smem_floats(int H, int N, int warps, int n_st, bool staged) {
  const size_t R = (size_t)RPW * warps;
  return (staged ? 4 * (size_t)H * (H | 1) : 0) + 2 * (size_t)H * H + 4 * (size_t)H +
         (3 + 6 * (size_t)n_st) * R * H + (3 + (size_t)n_st) * R + R * N;
}

template <int CPT, bool STAGE>
cudaError_t launch(const float* data, float* params, float* m, float* v, float* stat,
                   float* losses, float* scratch, const Dims& d, const Hyper& hp,
                   const Tab& tb, size_t smem, cudaStream_t stream) {
  auto kernel = walk_train_kernel<CPT, STAGE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int n_warps = std::min(kMaxWarps, 2 * d.warps);  // row warps + helpers
  const int threads = kWarp * n_warps;
  const int nblk = (d.BS + RPW * d.warps - 1) / (RPW * d.warps);
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
  void* args[] = {(void*)&a_data, (void*)&params, (void*)&m,      (void*)&v,
                  (void*)&stat,   (void*)&losses, (void*)&scratch, (void*)&a_d,
                  (void*)&a_hp,   (void*)&a_tb};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(nblk), dim3(kWarp, n_warps), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Floats of the scratch a launch with these dims needs (dims as for
// njode_walk_train_run).
extern "C" long long njode_walk_train_scratch_floats(const int* dims) {
  Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6],
         dims[7], dims[8], dims[9], dims[10], dims[11]};
  const int nblk = (d.BS + RPW * d.warps - 1) / (RPW * d.warps);
  return scratch_floats(d, nblk);
}

// dims = [K, H, N, BS, G, M, act, scale, second_moment, warps, staged, n_st];
// hyper = [dt, 1/dt, tel, lr, wd, b1, b2, 1-b1, 1-b2, adam_eps, eps, w0, w1,
// 1/N, w0/N, w1/N]; tab = [da (4 x 4), dc (4), bw (4), gb (4)] (host arrays).
// The launch plan (warps, whether the four weight matrices are staged in
// shared memory, the shared-memory bytes) is the caller's (launch_plan in
// ops/walk_train.py); the bytes are checked here against what the layout
// needs and the device's opt-in limit, and the blocks against what the
// device holds at once.  Launches cooperatively on `stream` and returns the
// CUDA error (0 on success).
extern "C" int njode_walk_train_run(const void* data, void* params, void* m, void* v,
                                    void* stat, void* losses, void* scratch,
                                    const int* dims, const float* hyper,
                                    const float* tab, long long smem_bytes,
                                    void* stream) {
  Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6],
         dims[7], dims[8], dims[9], dims[10], dims[11]};
  Hyper hp{hyper[0], hyper[1], hyper[2],  hyper[3],  hyper[4],  hyper[5],
           hyper[6], hyper[7], hyper[8],  hyper[9],  hyper[10], hyper[11],
           hyper[12], hyper[13], hyper[14], hyper[15]};
  Tab tb;
  tb.n = d.n_st;
  for (int i = 0; i < kMaxStages; ++i) {
    for (int j = 0; j < kMaxStages; ++j) tb.da[i][j] = tab[i * kMaxStages + j];
    tb.dc[i] = tab[16 + i];
    tb.bw[i] = tab[20 + i];
    tb.gb[i] = tab[24 + i];
  }
  if (d.K < 1 || d.K > 2 || d.H < 1 || d.H > 128 || d.N < 2 || d.BS < 1 || d.G < 0 ||
      d.M < 1 || d.act < 0 || d.act > kSelu || d.scale < 0 || d.scale > kScaleSigmoid ||
      d.warps < 1 || d.warps > kMaxWarps || d.staged < 0 || d.staged > 1 || d.n_st < 1 ||
      d.n_st > kMaxStages)
    return (int)cudaErrorInvalidValue;
  if (d.G == 0) return 0;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t need = smem_floats(d.H, d.N, d.warps, d.n_st, d.staged) * sizeof(float);
  if ((size_t)smem_bytes < need || smem_bytes + 64 > max_smem) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_bytes;
  const float* f_data = static_cast<const float*>(data);
  float* f_p = static_cast<float*>(params);
  float* f_m = static_cast<float*>(m);
  float* f_v = static_cast<float*>(v);
  float* f_s = static_cast<float*>(stat);
  float* f_l = static_cast<float*>(losses);
  float* f_x = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpt = d.H <= 32 ? 1 : (d.H <= 64 ? 2 : 4);
#define NJODE_WT(C, STG) \
  err = launch<C, STG>(f_data, f_p, f_m, f_v, f_s, f_l, f_x, d, hp, tb, smem, s)
  if (d.staged) {
    if (cpt == 1) NJODE_WT(1, true);
    else if (cpt == 2) NJODE_WT(2, true);
    else NJODE_WT(4, true);
  } else {
    if (cpt == 1) NJODE_WT(1, false);
    else if (cpt == 2) NJODE_WT(2, false);
    else NJODE_WT(4, false);
  }
#undef NJODE_WT
  return (int)err;
}

extern "C" const char* njode_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
