// A whole run of minibatch Adam steps on the NJ-ODE loss, in one cooperative
// launch, on Hopper (sm_90a).
//
// Replaces the TPU kernels njode_tpu/ops/train_kernel.py:_train_kernel
// (line 223, per-network planes) and :_train_kernel_dual (line 478, both
// networks block-diagonal in one lane-packed plane).  Both compute one
// function; the dual pack is a TPU lane layout and is not copied.  For each
// of the G minibatches of `data`, in order, for each moment network k:
//
//   forward  jump MLP at all N slots, after-jump readout, one Euler step per
//            gap (dt_ode_step=None), before-jump readout (slot 0's is 0);
//   loss     the closed form of nj_ode_loss_dense with ignore_first_continuity
//            and the trajectory mask, and its cotangents (train_kernel.py:119);
//   backward the slot-local chain (the jump resets the state, so no residual
//            crosses a slot);
//   Adam     torch-style: L2 into the gradient, biased moments, bias-corrected
//            step, the powers b1^t, b2^t carried across calls in `stat`
//            (train_kernel.py:199).
//
// The moment networks share no parameter: net 1's cotangents need net 0's
// predictions for the same trajectory, nothing else crosses networks.  So
// both networks run at once, and net 0's forward runs once a step (the TPU
// kernel's second forward of net 0, train_kernel.py:457-465, recomputes the
// same values to halve its VMEM footprint).
//
// What bounds it on the H100: the f32 multiply-adds of the (rows x H)(H x H)
// products, about 3 x the forward's 2 (N H^2 + (N-1) 2 H^2 + (2N-1) H^2) a
// trajectory and network, and the chain of dependent steps of one
// trajectory; the steps of a run are sequential.  So every step runs across
// the grid, two grid barriers a step:
//
//   * Phase A.  The minibatch is cut into `blocks` contiguous shares, block b
//     taking rows [b BS / blocks, (b+1) BS / blocks) (shapes alone decide;
//     at the default recipe's batch of 128, a trajectory a block on 128
//     blocks).  A block holds `slots` trajectories in flight and walks its
//     share in chunks of `slots`, in order.  A chain of `wpt` warps runs a
//     trajectory's network: the model is slot-local (the jump resets the
//     state), so the chain's warps split the N slots into contiguous
//     ranges and each runs the forward, and later the backward, of its own
//     slots with no barrier between them; lanes over the hidden units (CPT
//     = ceil(H/32) columns each), the trajectory's rows in its slot, the
//     products reading 4 rows' inputs as float4s and sharing each weight
//     load among them (H a multiple of 4: the wrapper pads H with zero
//     units, which stay zero).  A block barrier after the forwards brings
//     net 0's predictions to net 1's cotangents through the slot; the
//     chain's first warp computes the cotangents, a named barrier hands
//     them to the chain.  Then all the block's warps sum the chunk's
//     operands into the block's partial of both gradients in device memory:
//     an item is 4 / CPT rows of all four matrices of a network (16 sums in
//     flight) or half of its vectors, each entry owned by one thread and
//     summed over the trajectories and their rows in order.
//   * Phase B, after a grid barrier.  A warp's task is 8 gradient entries:
//     lane (q, e) sums entry e over the q-th quarter of the blocks'
//     partials in float64 (16 loads in flight), shuffles add the quarters,
//     and the entry's owner rounds the sum to f32 once and runs
//     torch-style Adam on it, for both networks at once, and writes the
//     new value to the weights' padded copy.  The next step's rows are
//     prefetched to L2 meanwhile.  A grid barrier ends the step.  A call
//     repeats bitwise.
//
// Why float64 across the blocks: some gradient entries are sums of
// same-signed terms (the readout bias's is near 100 at H 64, from 1,280
// rows), and Adam's first moment later cancels them down to 1e-2; f32
// additions over 128 block partials drift by 3e-5 there, outside the
// tolerance of the plain version (whose torch sums do not drift so).
// Summed in float64, every entry is the f32 partials' sum rounded once,
// whatever the order (PERF.md section 6).
//
// Both networks' weights are staged in shared memory once a step, matrix
// rows padded to H + 4 floats so that the transposed products' float4 reads
// fall in distinct banks, where they fit beside the slots (H <= 64 at
// N = 10); else the products read the padded copy in device memory, with
// plain loads: grid.sync()'s fences order them after phase B's writes.
// Where even one trajectory's two slots do not fit in shared memory (the
// largest H and N the gate admits), the slots live in device memory.
// Instances: CPT in {1, 2, 4} x {everything in shared memory, generic
// pointers} x {f32, bf16 products}.
//
// The bf16 instances (BF; rows 11b-12b: the TPU kernels' mxu="bfloat16",
// train_kernel.py:255-270 and :515-528) round both operands of each of the
// 12 plane products to bf16 and sum in f32, which is the TPU kernel's
// dot(bf16, bf16, preferred_element_type=f32): the product of two bf16
// values is exact in f32, so only the order of the f32 sums differs.  Each
// operand is rounded once, where it is formed or read, never in place of a
// value also read in f32: the weight planes when phase B writes them into
// the padded copy (params, the f32 master Adam updates, stays f32; the
// vectors stay f32); an activation or cotangent row where warp_mm loads it
// (hj feeds the readout and, scaled, W1h's product rounded, but hm and
// s'(hj) in f32); both factors of the four outer products where
// reduce_chunk loads them.  BASE, every bias, the o2 readout, every column
// sum of the gradient and Adam stay f32.

// Layout (all f32, contiguous; njode_tpu_torch/ops/train_kernel.py writes
// it down): data (G*BS, 2N+1) rows [x_0..x_{N-1}, t_0..t_{N-1}, valid];
// params, m, v (K, P) with P = 4H^2 + 10H + 1 per network: the (in, out)
// matrices J2, O1, W1h, W2, then the vectors j1, bj1, bj2, w1x, w1t, w1d, b1,
// b2, bo1, o2 and the scalar bo2; stat (2,) = [b1^t, b2^t]; losses (G,);
// scratch = [the weights' padded copy K x staged_floats(H), the slots when
// they live in device memory, the blocks' partials blocks x K P (rounded up
// to whole tasks of 8), the per-trajectory loss terms BS].  params, m, v
// and stat are updated in place.  The scratch does not grow with G.
//
// Numerics: built without --use_fast_math.  Sums run in other orders than the
// plain PyTorch version's, and the compiler contracts multiply-adds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "walk_cell.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace njode_walk;

// 8 warps leave the register cap at 255 (16 capped it at 128, and every
// instance spilled)
constexpr int kMaxWarps = 8;
constexpr int kMaxBlocks = 128;
// phase B: a warp's task is kTask entries; lane (q, e) sums entry e over
// the q-th of kParts contiguous runs of blocks, kLoads loads in flight
constexpr int kTask = 8, kParts = 4, kLoads = 16;
static_assert(kTask * kParts == kWarp, "a task's lanes fill the warp");

// matrices and vectors of one network's flat parameter block
enum Mat { kJ2 = 0, kO1 = 1, kW1h = 2, kW2 = 3 };
enum Vec { kJ1 = 0, kBJ1, kBJ2, kW1X, kW1T, kW1D, kB1, kB2, kBO1, kO2, kNumVec };
// what a chain warp's cotangents are
enum Mode {
  kMean = 1,  // net 0 (K = 1 or 2): mean cotangents
  kVar = 2,   // K = 2, net 1: variance cotangents and the loss term
};

struct Dims {
  int K, H, N, BS, G, act, scale, second_moment;
  // the launch plan (launch_plan in ops/train_kernel.py)
  int blocks, slots, wpt, warps, staged, slots_global;
  int bf16;  // the products' operands rounded to bf16
};

struct Hyper {
  float lr, wd, b1, b2, omb1, omb2, adam_eps, eps, w0, w1, inv_n, w0n, w1n;
};

// One network's weights, padded (ld = H + 4), in shared or device memory.
// mat[m](i, j) = mat[m][i * ld + j], (in, out) orientation.
struct Net {
  const float* mat[4];
  int ld;
  const float* vec;  // kNumVec vectors of H, then bo2
};

// The slot of one trajectory and network; each (rows x H) array has row
// stride H.  With identity scaling s(hj) is hj, so schj aliases in's first
// rows.  The gradients of o2, j1 and bj1 are summed over each chain warp's
// rows in the backward (do2v, dj1v, dbj1v, a row of H for each of the
// chain's warps), so u and d a1_pre need no rows of their own.
struct Slot {
  float *x, *t, *dt, *scx, *y, *gy;
  float *a1p, *a1, *hjp, *in, *schj, *g1p, *g1, *up, *dup, *ddh, *dg1p, *dhjp;
  float *do2v, *dj1v, *dbj1v;
};

__host__ __device__ __forceinline__ int slot_floats(int H, int N, int scale, int wpt) {
  const int S = N - 1, R = 2 * N - 1;
  const int rows = 4 * N + 3 * R + (scale == kIdentity ? 4 : 5) * S + 3 * wpt;
  return (rows * H + 2 * N + 2 * S + 2 * R + 3) & ~3;
}

// one network's weights as the products read them: the matrices with rows
// padded to H + 4 floats (16-byte aligned rows; the transposed products'
// float4 reads of a quarter-warp then fall in distinct banks), the vectors
// after them; rounded up to whole float4s
__host__ __device__ __forceinline__ int staged_floats(int H) {
  return (4 * H * (H + 4) + kNumVec * H + 1 + 3) & ~3;
}

__host__ __device__ __forceinline__ long long scratch_floats(const Dims& d) {
  const long long P = 4LL * d.H * d.H + kNumVec * d.H + 1;
  return (long long)d.K * staged_floats(d.H) +
         (d.slots_global
              ? (long long)d.blocks * d.slots * d.K * slot_floats(d.H, d.N, d.scale, d.wpt)
              : 0) +
         (long long)d.blocks * ((d.K * P + kTask - 1) / kTask * kTask) + d.BS;
}

__host__ __device__ __forceinline__ size_t smem_bytes(const Dims& d) {
  return ((d.staged ? (size_t)d.K * staged_floats(d.H) : 0) +
          (d.slots_global ? 0
                          : (size_t)d.slots * d.K * slot_floats(d.H, d.N, d.scale, d.wpt))) *
         sizeof(float);
}

__device__ __forceinline__ Slot make_slot(float* base, int H, int N, int scale, int wpt) {
  const int S = N - 1, R = 2 * N - 1;
  Slot s;
  float* p = base;
  s.x = p; p += N;
  s.t = p; p += N;
  s.dt = p; p += S;
  s.scx = p; p += S;
  s.y = p; p += R;
  s.gy = p; p += R;
  s.a1p = p; p += N * H;
  s.a1 = p; p += N * H;
  s.hjp = p; p += N * H;
  s.in = p; p += R * H;
  if (scale == kIdentity) {
    s.schj = s.in;
  } else {
    s.schj = p; p += S * H;
  }
  s.g1p = p; p += S * H;
  s.g1 = p; p += S * H;
  s.up = p; p += R * H;
  s.dup = p; p += R * H;
  s.ddh = p; p += S * H;
  s.dg1p = p; p += S * H;
  s.dhjp = p; p += N * H;
  s.do2v = p; p += wpt * H;
  s.dj1v = p; p += wpt * H;
  s.dbj1v = p;
  return s;
}

// The rows a chain warp owns of a (rows x H) array: [lo1, lo1 + n1), then
// [lo2, lo2 + n2) (the readout's after-jump and before-jump rows).
struct Rows {
  int lo1, n1, lo2, n2;
  __device__ __forceinline__ int n() const { return n1 + n2; }
  __device__ __forceinline__ int operator[](int k) const { return k < n1 ? lo1 + k : lo2 + k - n1; }
};

// out[r][j] = sum_i in[r][i] W(i, j) for the rows r of `rows`, with W(i, j) =
// w[i*ld+j] or, TRANS, w[j*ld+i]; lane owns columns lane + 32 c.  Four rows
// share each weight load, and in's rows are read as float4 (H % 4 == 0, rows
// and w's rows 16-byte aligned); i runs in order, as the plain version sums.
// BF rounds in's entries as they are loaded (w is rounded where staged).
template <int CPT, bool TRANS, bool BF>
__device__ void warp_mm(const float* in, const Rows& rows, const float* w, int ld, int H,
                        float* out, int lane) {
  constexpr int RB = CPT <= 2 ? 4 : 2;  // rows a block: 2 at CPT 4 (registers)
  const int nrows = rows.n();
  for (int r0 = 0; r0 < nrows; r0 += RB) {
    const float4* xr[RB];
#pragma unroll
    for (int q = 0; q < RB; ++q)
      xr[q] = reinterpret_cast<const float4*>(in + (size_t)rows[min(r0 + q, nrows - 1)] * H);
    float acc[RB][CPT];
#pragma unroll
    for (int q = 0; q < RB; ++q)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[q][c] = 0.0f;
#pragma unroll 2
    for (int i4 = 0; i4 < H / 4; ++i4) {
      float4 xv[RB];
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        xv[q] = xr[q][i4];
        if constexpr (BF)
          xv[q] = make_float4(operand<BF>(xv[q].x), operand<BF>(xv[q].y),
                              operand<BF>(xv[q].z), operand<BF>(xv[q].w));
      }
      float wv[4][CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < H) {
          if (TRANS) {
            const float4 t = *reinterpret_cast<const float4*>(w + (size_t)j * ld + 4 * i4);
            wv[0][c] = t.x; wv[1][c] = t.y; wv[2][c] = t.z; wv[3][c] = t.w;
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) wv[k][c] = w[(size_t)(4 * i4 + k) * ld + j];
          }
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) wv[k][c] = 0.0f;
        }
      }
#pragma unroll
      for (int q = 0; q < RB; ++q)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc[q][c] = fmaf(xv[q].x, wv[0][c], acc[q][c]);
          acc[q][c] = fmaf(xv[q].y, wv[1][c], acc[q][c]);
          acc[q][c] = fmaf(xv[q].z, wv[2][c], acc[q][c]);
          acc[q][c] = fmaf(xv[q].w, wv[3][c], acc[q][c]);
        }
    }
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      if (r0 + q >= nrows) break;
      float* o = out + (size_t)rows[r0 + q] * H;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < H) o[j] = acc[q][c];
      }
    }
  }
}

// lane's CPT entries of vector vi of a network
template <int CPT>
__device__ __forceinline__ void vec_regs(const float* v, int vi, int H, int lane,
                                         float (&out)[CPT]) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = lane + kWarp * c;
    out[c] = j < H ? v[vi * H + j] : 0.0f;
  }
}

// Forward of one network over the slots [s0, s1) of the trajectory in `s`
// (x, t of those slots, dt, scx of their gaps loaded): the model is
// slot-local, so a chain warp needs no other warp's rows.
template <int CPT, bool BF>
__device__ void forward(const Slot& s, const Net& net, const Dims& d, int lane, int s0,
                        int s1) {
  const int H = d.H, N = d.N, S = N - 1;
  const int g1 = min(s1, S);  // the gaps [s0, g1) leave these slots
  const Rows slots{s0, s1 - s0, 0, 0}, gaps{s0, max(g1 - s0, 0), 0, 0};
  const Rows reads{s0, s1 - s0, N + s0, max(g1 - s0, 0)};
  const float* v = net.vec;
  float va[CPT], vb[CPT], vc[CPT], vd[CPT];
  // jump: a1 = act(x j1 + bj1), hj = act(a1 J2 + bj2)
  vec_regs<CPT>(v, kJ1, H, lane, va);
  vec_regs<CPT>(v, kBJ1, H, lane, vb);
  for (int r = s0; r < s1; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) {
        const float pre = s.x[r] * va[c] + vb[c];
        s.a1p[r * H + j] = pre;
        s.a1[r * H + j] = activate(pre, d.act);
      }
    }
  __syncwarp();
  warp_mm<CPT, false, BF>(s.a1, slots, net.mat[kJ2], net.ld, H, s.hjp, lane);
  vec_regs<CPT>(v, kBJ2, H, lane, va);
  for (int r = s0; r < s1; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) {
        const float pre = s.hjp[r * H + j] + va[c];
        s.hjp[r * H + j] = pre;
        const float hj = activate(pre, d.act);
        s.in[r * H + j] = hj;
        if (r < S && d.scale != kIdentity) s.schj[r * H + j] = scale_in(hj, d.scale);
      }
    }
  __syncwarp();
  // one Euler step per gap: g1 = act(s(hj) W1h + base), hm = hj + dt (g1 W2 + b2)
  warp_mm<CPT, false, BF>(s.schj, gaps, net.mat[kW1h], net.ld, H, s.g1p, lane);
  vec_regs<CPT>(v, kW1X, H, lane, va);
  vec_regs<CPT>(v, kW1T, H, lane, vb);
  vec_regs<CPT>(v, kW1D, H, lane, vc);
  vec_regs<CPT>(v, kB1, H, lane, vd);
  for (int g = s0; g < g1; ++g)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) {
        const float base = s.scx[g] * va[c] + s.t[g] * vb[c] + s.dt[g] * vc[c] + vd[c];
        const float pre = s.g1p[g * H + j] + base;
        s.g1p[g * H + j] = pre;
        s.g1[g * H + j] = activate(pre, d.act);
      }
    }
  __syncwarp();
  warp_mm<CPT, false, BF>(s.g1, gaps, net.mat[kW2], net.ld, H, s.in + (size_t)N * H, lane);
  vec_regs<CPT>(v, kB2, H, lane, va);
  for (int g = s0; g < g1; ++g)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) {
        const float dh = s.in[(N + g) * H + j] + va[c];
        s.in[(N + g) * H + j] = s.in[g * H + j] + s.dt[g] * dh;
      }
    }
  __syncwarp();
  // readout of the after-jump states and the before-jump states of the gaps
  warp_mm<CPT, false, BF>(s.in, reads, net.mat[kO1], net.ld, H, s.up, lane);
  const float bo2 = v[kNumVec * H];
  vec_regs<CPT>(v, kBO1, H, lane, va);
  vec_regs<CPT>(v, kO2, H, lane, vb);
  for (int k = 0; k < reads.n(); ++k) {
    const int r = reads[k];
    float part = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) {
        const float pre = s.up[r * H + j] + va[c];
        s.up[r * H + j] = pre;
        part += activate(pre, d.act) * vb[c];
      }
    }
    part = warp_sum(part);
    if (lane == 0) s.y[r] = part + bo2;
  }
  __syncwarp();
}

// Closed-form cotangents of the trajectory's loss terms into s.gy, and (kMean
// with K = 1, or kVar) its weighted loss term into lt.  y0 holds net 0's
// predictions (the slot's own in kMean).  One warp, lanes over the slots.
__device__ __forceinline__ void cotangents(const Slot& s, const float* y0, int mode,
                                           float valid, float nv, const Dims& d,
                                           const Hyper& hp, float* lt, int lane) {
  const int N = d.N;
  const float wrow = valid / nv;
  float sum0 = 0.0f, sum1 = 0.0f;
  for (int r = lane; r < N; r += kWarp) {
    const bool cont = r > 0;  // slot 0's continuity term is ignored
    const float xs = s.x[r];
    const float a0 = y0[r];
    const float b0 = cont ? y0[N + r - 1] : 0.0f;
    const float e_a = xs - a0, e_b = xs - b0;
    const float aj = e_a * e_a;
    const float ac = cont ? e_b * e_b : 0.0f;
    const float sa = sqrtf(aj + hp.eps), sc = sqrtf(ac + hp.eps);
    sum0 += (sa + sc) * (sa + sc);
    if (mode == kMean) {
      s.gy[r] = wrow * hp.w0n * ((sa + sc) / sa) * 2.0f * (a0 - xs);
      if (cont) s.gy[N + r - 1] = wrow * hp.w0n * ((sa + sc) / sc) * 2.0f * (b0 - xs);
    } else {
      const float a1 = s.y[r];
      const float b1 = cont ? s.y[N + r - 1] : 0.0f;
      float V, Vb, Z, Zb, dV, dVb;
      if (d.second_moment) {
        V = a1; Vb = b1; Z = xs * xs; Zb = Z; dV = 1.0f; dVb = 1.0f;
      } else {  // direct: V = W^2 against the squared error of the detached mean
        V = a1 * a1; Vb = b1 * b1; Z = aj; Zb = ac; dV = 2.0f * a1; dVb = 2.0f * b1;
      }
      const float e_j = Z - V, e_c = Zb - Vb;
      const float sva = sqrtf(e_j * e_j + hp.eps);
      const float svc = sqrtf((cont ? e_c * e_c : 0.0f) + hp.eps);
      sum1 += (sva + svc) * (sva + svc);
      s.gy[r] = wrow * hp.w1n * ((sva + svc) / sva) * 2.0f * (V - Z) * dV;
      if (cont) s.gy[N + r - 1] = wrow * hp.w1n * ((sva + svc) / svc) * 2.0f * (Vb - Zb) * dVb;
    }
  }
  sum0 = warp_sum(sum0);
  sum1 = warp_sum(sum1);
  if (lane == 0 && lt != nullptr) {
    const float L0 = sum0 * hp.inv_n;
    *lt = d.K == 1 ? hp.w0 * L0 * valid : (hp.w0 * L0 + hp.w1 * (sum1 * hp.inv_n)) * valid;
  }
  __syncwarp();
}

// cotangents as a call of its own, with its own registers: the
// generic-pointer instances take it (inlined there, they spilled 8 and 56
// bytes; inlined in the shared-memory ones, a step is 6% shorter)
__device__ __noinline__ void cotangents_call(const Slot& s, const float* y0, int mode,
                                             float valid, float nv, const Dims& d,
                                             const Hyper& hp, float* lt, int lane) {
  cotangents(s, y0, mode, valid, nv, d, hp, lt, lane);
}

// Backward of one network from s.gy over the slots [s0, s1) (row wg of
// the partial vectors); leaves the operands of the parameter gradient in
// the slot (in/dup, g1/ddh, schj/dg1p, a1/dhjp, and the warp's do2v, dj1v,
// dbj1v rows).
template <int CPT, bool BF>
__device__ void backward(const Slot& s, const Net& net, const Dims& d, int lane, int s0,
                         int s1, int wg) {
  const int H = d.H, N = d.N, S = N - 1;
  const int g1 = min(s1, S);
  const Rows slots{s0, s1 - s0, 0, 0}, gaps{s0, max(g1 - s0, 0), 0, 0};
  const Rows reads{s0, s1 - s0, N + s0, max(g1 - s0, 0)};
  float o2[CPT], do2[CPT];
  vec_regs<CPT>(net.vec, kO2, H, lane, o2);
#pragma unroll
  for (int c = 0; c < CPT; ++c) do2[c] = 0.0f;
  for (int k = 0; k < reads.n(); ++k) {
    const int r = reads[k];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) {
        const float pre = s.up[r * H + j];
        s.dup[r * H + j] = (s.gy[r] * o2[c]) * act_grad(pre, d.act);
        do2[c] = fmaf(activate(pre, d.act), s.gy[r], do2[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = lane + kWarp * c;
    if (j < H) s.do2v[wg * H + j] = do2[c];
  }
  __syncwarp();
  // d(in) = dup O1^T, into up (rows < N: d hj, rows >= N: d hm)
  warp_mm<CPT, true, BF>(s.dup, reads, net.mat[kO1], net.ld, H, s.up, lane);
  for (int g = s0; g < g1; ++g)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) s.ddh[g * H + j] = s.dt[g] * s.up[(N + g) * H + j];
    }
  __syncwarp();
  warp_mm<CPT, true, BF>(s.ddh, gaps, net.mat[kW2], net.ld, H, s.dg1p, lane);
  for (int g = s0; g < g1; ++g)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) s.dg1p[g * H + j] *= act_grad(s.g1p[g * H + j], d.act);
    }
  __syncwarp();
  // d hj = d in[:N] + [d hm + (dg1p W1h^T) s'(hj), 0]; the product goes to g1p
  warp_mm<CPT, true, BF>(s.dg1p, gaps, net.mat[kW1h], net.ld, H, s.g1p, lane);
  for (int r = s0; r < s1; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) {
        float dhj = s.up[r * H + j];
        if (r < S)
          dhj = dhj + (s.up[(N + r) * H + j] +
                       s.g1p[r * H + j] * scale_grad(s.in[r * H + j], d.scale));
        s.dhjp[r * H + j] = dhj * act_grad(s.hjp[r * H + j], d.act);
      }
    }
  __syncwarp();
  // d a1_pre = (dhjp J2^T) act'(a1_pre), into up's after-jump rows (dead by
  // now), summed over the rows into the j1 and bj1 gradients
  warp_mm<CPT, true, BF>(s.dhjp, slots, net.mat[kJ2], net.ld, H, s.up, lane);
  float dj1[CPT], dbj1[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dj1[c] = dbj1[c] = 0.0f;
  for (int r = s0; r < s1; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) {
        const float da1p = s.up[r * H + j] * act_grad(s.a1p[r * H + j], d.act);
        dj1[c] = fmaf(s.x[r], da1p, dj1[c]);
        dbj1[c] += da1p;
      }
    }
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = lane + kWarp * c;
    if (j < H) {
      s.dj1v[wg * H + j] = dj1[c];
      s.dbj1v[wg * H + j] = dbj1[c];
    }
  }
  __syncwarp();
}

// Offsets of a slot's arrays from its base (the same for every slot).
struct Offsets {
  int x, t, dt, scx, gy, a1, in, schj, g1, dup, ddh, dg1p, dhjp, do2v, dj1v, dbj1v;
};

__device__ __forceinline__ Offsets slot_offsets(float* base, int H, int N, int scale,
                                                int wpt) {
  const Slot s = make_slot(base, H, N, scale, wpt);
  return Offsets{(int)(s.x - base),    (int)(s.t - base),     (int)(s.dt - base),
                 (int)(s.scx - base),  (int)(s.gy - base),    (int)(s.a1 - base),
                 (int)(s.in - base),   (int)(s.schj - base),  (int)(s.g1 - base),
                 (int)(s.dup - base),  (int)(s.ddh - base),   (int)(s.dg1p - base),
                 (int)(s.dhjp - base), (int)(s.do2v - base),  (int)(s.dj1v - base),
                 (int)(s.dbj1v - base)};
}

// Adds a chunk's contribution to the block's partial of both gradients
// (part, K x P, device memory; the chunk's first stores it).  An item is a
// network's group of RQ = 4 / CPT rows of all four matrices (a[r][i] b[r][j]
// into entry (i, j), four accumulator sets, so a warp keeps 16 sums in
// flight), or half of its vectors (s[r] b[r][j] into entry j; the sums
// do2v, dj1v, dbj1v over each chain warp's rows as one row each).  Items are owned by
// warps, item % nw == warp, and their columns by lanes; each sum runs over
// the chunk's trajectories in order and over their slots in order, so
// every entry has one owner and one summation order, in every chunk.  BF
// rounds both factors of the four matrices' sums (the outer products), not
// the vectors' (column sums).
template <int CPT, bool BF>
__device__ void reduce_chunk(float* slots, int slot_f, int nc, bool first,
                             const Dims& d, float* part, int warp, int nw, int lane) {
  const int H = d.H, N = d.N, S = N - 1, R = 2 * N - 1, HH = H * H, K = d.K;
  const int P = 4 * HH + kNumVec * H + 1;
  const Offsets o = slot_offsets(slots, H, N, d.scale, d.wpt);
  constexpr int RQ = 4 / CPT;
  const int groups = H / RQ, n_items = groups + 2;
  // slot (t, k) sits at slots + (t K + k) slot_f
  const size_t tstride = (size_t)K * slot_f;
  auto put = [&](float* g, float acc) { *g = first ? acc : *g + acc; };
  auto col = [&](const float* p, int c) {
    const int j = lane + kWarp * c;
    return j < H ? p[j] : 0.0f;
  };
  for (int it = warp; it < K * n_items; it += nw) {
    const int k = it / n_items, item = it - k * n_items;
    const float* sk = slots + (size_t)k * slot_f;
    float* g = part + (size_t)k * P;
    if (item < groups) {
      const int i0 = RQ * item;
      float acc[4][RQ][CPT];  // [matrix][row q][column]
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int q = 0; q < RQ; ++q)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[m][q][c] = 0.0f;
      // a[r][i0..i0+RQ-1] b[r][j] into matrix m
      auto add = [&](int m, const float* a, const float* b) {
        float av[RQ];
#pragma unroll
        for (int q = 0; q < RQ; ++q) av[q] = operand<BF>(a[i0 + q]);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float bv = operand<BF>(col(b, c));
#pragma unroll
          for (int q = 0; q < RQ; ++q) acc[m][q][c] = fmaf(av[q], bv, acc[m][q][c]);
        }
      };
      for (int t = 0; t < nc; ++t) {
        const float* sl = sk + t * tstride;
#pragma unroll 2
        for (int r = 0; r < N; ++r) {
          add(kJ2, sl + o.a1 + r * H, sl + o.dhjp + r * H);
          add(kO1, sl + o.in + r * H, sl + o.dup + r * H);
          if (r < S) {
            add(kW1h, sl + o.schj + r * H, sl + o.dg1p + r * H);
            add(kW2, sl + o.g1 + r * H, sl + o.ddh + r * H);
          }
        }
#pragma unroll 2
        for (int r = N; r < R; ++r) add(kO1, sl + o.in + r * H, sl + o.dup + r * H);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int q = 0; q < RQ; ++q)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int j = lane + kWarp * c;
            if (j < H) put(g + m * HH + (i0 + q) * H + j, acc[m][q][c]);
          }
      continue;
    }
    // a network's vectors in two halves of 5, so that 5 CPT sums are live
    const bool first_half = item == groups;
    float v[5][CPT];
#pragma unroll
    for (int vi = 0; vi < 5; ++vi)
#pragma unroll
      for (int c = 0; c < CPT; ++c) v[vi][c] = 0.0f;
    float bo2 = 0.0f;  // the total cotangent mass, in row order (lane 0)
    for (int t = 0; t < nc; ++t) {
      const float* sl = sk + t * tstride;
      if (first_half) {  // bj2, b2, bo1 over the rows; j1, bj1 over the chain
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            v[2][c] += col(sl + o.dup + r * H, c);
            if (r < N) v[0][c] += col(sl + o.dhjp + r * H, c);
            if (r < S) v[1][c] += col(sl + o.ddh + r * H, c);
          }
        for (int w = 0; w < d.wpt; ++w)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            v[3][c] += col(sl + o.dj1v + w * H, c);
            v[4][c] += col(sl + o.dbj1v + w * H, c);
          }
        if (lane == 0)
          for (int r = 0; r < R; ++r) bo2 += sl[o.gy + r];
      } else {  // w1x, w1t, w1d, b1 over the gaps; o2 over the chain
        for (int r = 0; r < S; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const float dg = col(sl + o.dg1p + r * H, c);
            v[0][c] = fmaf(sl[o.scx + r], dg, v[0][c]);
            v[1][c] = fmaf(sl[o.t + r], dg, v[1][c]);
            v[2][c] = fmaf(sl[o.dt + r], dg, v[2][c]);
            v[3][c] += dg;
          }
        for (int w = 0; w < d.wpt; ++w)
#pragma unroll
          for (int c = 0; c < CPT; ++c) v[4][c] += col(sl + o.do2v + w * H, c);
      }
    }
    const int which[2][5] = {{kBJ2, kB2, kBO1, kJ1, kBJ1}, {kW1X, kW1T, kW1D, kB1, kO2}};
    if (first_half && lane == 0) put(g + 4 * HH + kNumVec * H, bo2);
#pragma unroll
    for (int vi = 0; vi < 5; ++vi)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < H) put(g + 4 * HH + which[first_half ? 0 : 1][vi] * H + j, v[vi][c]);
      }
  }
}

// a barrier of the nt threads of named barrier id (a chain group)
__device__ __forceinline__ void group_sync(int id, int nt) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nt) : "memory");
}

// Index in a network's padded copy of entry e of its flat parameter block.
__device__ __forceinline__ int padded_index(int e, int H) {
  const int HH = H * H, ld = H + 4;
  if (e >= 4 * HH) return 4 * H * ld + (e - 4 * HH);
  const int m = e / HH, rem = e - m * HH, i = rem / H;
  return (m * H + i) * ld + (rem - i * H);
}

// SMEM: the weights staged and the slots in shared memory (the plan's
// staged and not slots_global), so every slot and weight access is a
// shared-memory one; else the pointers are generic.  BF: the bf16
// products (the header).
template <int CPT, bool SMEM, bool BF>
__global__ void __launch_bounds__(kWarp * kMaxWarps, 1)
train_run_kernel(const float* __restrict__ data, float* params, float* adam_m,
                 float* adam_v, float* stat, float* losses, float* scratch,
                 Dims d, Hyper hp) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float sh_nv;
  const int lane = threadIdx.x, warp = threadIdx.y, nw = blockDim.y;
  const int n_thr = kWarp * nw, tid = warp * kWarp + lane;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int H = d.H, N = d.N, S = N - 1, K = d.K, BS = d.BS, WPT = d.wpt;
  const int HH = H * H, P = 4 * HH + kNumVec * H + 1, E = K * P;
  const int PS = (E + kTask - 1) / kTask * kTask;  // a block's partial, whole tasks
  const int ld = H + 4, SF = staged_floats(H), slot_f = slot_floats(H, N, d.scale, WPT);
  const int row_f = 2 * N + 1;
  float* wpad = scratch;  // both networks' weights, padded: the staging's source
  float* gslots = wpad + (size_t)K * SF;
  float* partial = gslots + (d.slots_global ? (size_t)nblk * d.slots * K * slot_f : 0);
  float* lt = partial + (size_t)nblk * PS;
  float* part = partial + (size_t)blk * PS;
  float* slots = SMEM ? smem + (size_t)K * SF
                      : (d.slots_global ? gslots + (size_t)blk * d.slots * K * slot_f
                                        : smem + (d.staged ? (size_t)K * SF : 0));
  // this block's share of each minibatch
  const long long lo = (long long)blk * BS / nblk, hi = (long long)(blk + 1) * BS / nblk;
  // a chain group of WPT warps runs network ck of the chunk's trajectory ct,
  // in slot gi = ct K + ck, warp wg of the group on the slots [s0, s1); the
  // other warps help with the sums
  const int gi = warp / WPT, wg = warp - gi * WPT;
  const bool chain = gi < d.slots * K;
  const int ct = gi / K, ck = gi - ct * K;
  const int s0 = wg * N / WPT, s1 = (wg + 1) * N / WPT;
  // the slot's pointers are rebuilt where used (make_slot is arithmetic),
  // so they hold no registers across the step
  float* mine = slots + (size_t)gi * slot_f;
  Net net;
  {
    const float* w = (SMEM || d.staged ? smem : wpad) + (size_t)(chain ? ck : 0) * SF;
    for (int m = 0; m < 4; ++m) net.mat[m] = w + m * H * ld;
    net.ld = ld;
    net.vec = w + 4 * H * ld;
  }
  // phase B: this lane's run of blocks
  const int b_lo = lane / kTask * nblk / kParts, b_hi = (lane / kTask + 1) * nblk / kParts;
  const int gw = blk * nw + warp, n_gw = nblk * nw;
  float c1 = stat[0], c2 = stat[1];

  // the padded copy from params, its row padding zero, the matrices as
  // the products read them
  for (long long f = (long long)blk * n_thr + tid; f < (long long)K * SF;
       f += (long long)nblk * n_thr) {
    const int k = (int)(f / SF), r = (int)(f - (long long)k * SF);
    float val = 0.0f;
    if (r < 4 * H * ld) {
      const int m = r / (H * ld), rem = r - m * H * ld, i = rem / ld, j = rem - i * ld;
      if (j < H) val = operand<BF>(params[(size_t)k * P + m * HH + i * H + j]);
    } else if (r - 4 * H * ld < kNumVec * H + 1) {
      val = params[(size_t)k * P + 4 * HH + (r - 4 * H * ld)];
    }
    wpad[f] = val;
  }
  grid.sync();

  for (int step = 0; step < d.G; ++step) {
    c1 *= hp.b1;  // this step's bias-correction powers
    c2 *= hp.b2;
    const float* rows = data + (size_t)step * BS * row_f;
    // ---- staging: both networks' weights, and the valid count
    if (SMEM || d.staged) {
      const float4* src = reinterpret_cast<const float4*>(wpad);
#pragma unroll 8
      for (int f = tid; f < K * SF / 4; f += n_thr) smem4[f] = __ldcg(src + f);
    }
    if (warp == 0) {  // lane partials in a fixed order
      float nv = 0.0f;
      for (int b = lane; b < BS; b += kWarp) nv += rows[(size_t)b * row_f + 2 * N];
      nv = warp_sum(nv);
      if (lane == 0) sh_nv = fmaxf(nv, 1.0f);
    }
    __syncthreads();
    const float nv = sh_nv;

    // ---- phase A: the block's share, a chunk of `slots` trajectories at a time
    for (long long c0 = lo; c0 < hi; c0 += d.slots) {
      const int nc = (int)(hi - c0 < d.slots ? hi - c0 : d.slots);
      const bool live = chain && ct < nc;  // alike in all warps of a group
      const float* row = rows + (size_t)(c0 + (live ? ct : 0)) * row_f;
      // forward of both networks, each over its group's warps
      if (live) {
        const Slot sl = make_slot(mine, H, N, d.scale, WPT);
        for (int r = s0 + lane; r < s1; r += kWarp) {
          sl.x[r] = row[r];
          sl.t[r] = row[N + r];
        }
        for (int g = s0 + lane; g < min(s1, S); g += kWarp) {
          sl.dt[g] = row[N + g + 1] - row[N + g];
          sl.scx[g] = scale_in(row[g], d.scale);
        }
        __syncwarp();
        forward<CPT, BF>(sl, net, d, lane, s0, s1);
      }
      __syncthreads();  // net 0's predictions to net 1's cotangents
      // cotangents (the group's first warp) and backward
      if (live) {
        const Slot sl = make_slot(mine, H, N, d.scale, WPT);
        if (wg == 0) {
          const float* y0 = sl.y - (size_t)ck * slot_f;  // net 0's slot
          float* lt_b = ck == K - 1 ? lt + c0 + ct : nullptr;
          const int mode = ck == 0 ? kMean : kVar;
          if (SMEM)
            cotangents(sl, y0, mode, row[2 * N], nv, d, hp, lt_b, lane);
          else
            cotangents_call(sl, y0, mode, row[2 * N], nv, d, hp, lt_b, lane);
        }
        if (WPT > 1) group_sync(1 + gi, kWarp * WPT);
        backward<CPT, BF>(sl, net, d, lane, s0, s1, wg);
      }
      __syncthreads();
      // the chunk's sums into the block's partial
      reduce_chunk<CPT, BF>(slots, slot_f, nc, c0 == lo, d, part, warp, nw, lane);
      if (c0 + d.slots < hi) __syncthreads();  // the slots are reused
    }
    grid.sync();

    // ---- phase B: the partials summed in block order, Adam by the owner;
    // the next step's rows on their way to L2 meanwhile
    if (step + 1 < d.G) {
      const char* next = reinterpret_cast<const char*>(rows + (size_t)BS * row_f);
      const long long lines = ((long long)BS * row_f * sizeof(float) + 127) / 128;
      for (long long l = (long long)blk * n_thr + tid; l < lines; l += (long long)nblk * n_thr)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(next + 128 * l));
    }
    if (blk == 0 && warp == 0) {
      float total = 0.0f;
      for (int b = lane; b < BS; b += kWarp) total += __ldcg(lt + b);
      total = warp_sum(total);
      if (lane == 0) losses[step] = total / nv;
    }
    for (int task = gw; task < PS / kTask; task += n_gw) {
      const int e = task * kTask + lane % kTask;
      double acc = 0.0;  // float64: the f32 partials' sum, rounded once
      for (int b0 = b_lo; b0 < b_hi; b0 += kLoads) {
        float v[kLoads];
#pragma unroll
        for (int i = 0; i < kLoads; ++i)
          v[i] = b0 + i < b_hi ? __ldcg(partial + (size_t)(b0 + i) * PS + e) : 0.0f;
#pragma unroll
        for (int i = 0; i < kLoads; ++i) acc += v[i];
      }
#pragma unroll
      for (int off = kTask; off < kWarp; off *= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane < kTask && e < E) {
        const float p = params[e];
        const float g = (float)acc + hp.wd * p;
        const float m = hp.b1 * adam_m[e] + hp.omb1 * g;
        const float v = hp.b2 * adam_v[e] + hp.omb2 * g * g;
        const float m_hat = m / (1.0f - c1);
        const float v_hat = v / (1.0f - c2);
        const float pn = p - hp.lr * m_hat / (sqrtf(v_hat) + hp.adam_eps);
        params[e] = pn;
        adam_m[e] = m;
        adam_v[e] = v;
        const int k = e / P, ek = e - k * P;
        wpad[(size_t)k * SF + padded_index(ek, H)] = ek < 4 * HH ? operand<BF>(pn) : pn;
      }
    }
    grid.sync();
  }
  if (blk == 0 && tid == 0) {
    stat[0] = c1;
    stat[1] = c2;
  }
}

template <int CPT, bool SMEM, bool BF>
cudaError_t launch(const float* data, float* params, float* m, float* v,
                   float* stat, float* losses, float* scratch, const Dims& d,
                   const Hyper& hp, size_t smem, cudaStream_t stream) {
  auto kernel = train_run_kernel<CPT, SMEM, BF>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = kWarp * d.warps;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm * n_sm < d.blocks) return cudaErrorCooperativeLaunchTooLarge;
  const float* a_data = data;
  Dims a_d = d;
  Hyper a_hp = hp;
  void* args[] = {(void*)&a_data, (void*)&params, (void*)&m,       (void*)&v,
                  (void*)&stat,   (void*)&losses, (void*)&scratch, (void*)&a_d,
                  (void*)&a_hp};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(d.blocks), dim3(kWarp, d.warps),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

Dims dims_of(const int* dims) {
  return Dims{dims[0], dims[1],  dims[2],  dims[3],  dims[4],  dims[5],  dims[6],  dims[7],
              dims[8], dims[9], dims[10], dims[11], dims[12], dims[13], dims[14]};
}

}  // namespace

// dims = [K, H, N, BS, G, act, scale, second_moment, blocks, slots, wpt,
// warps, staged, slots_global, bf16]; hyper = [lr, wd, b1, b2, 1-b1, 1-b2, adam_eps, eps,
// w0, w1, 1/N, w0/N, w1/N] (host arrays).  The launch plan (blocks, the
// trajectories a block holds in flight, warps a chain, warps a block,
// whether the weights are staged in shared memory and whether the slots
// live in device memory)
// is the caller's (launch_plan in ops/train_kernel.py); it is checked here
// against the shapes, the scratch given, the device's opt-in shared memory
// and the blocks the device holds at once.  Launches cooperatively on
// `stream` and returns the CUDA error (0 on success).
extern "C" int njode_train_run(const void* data, void* params, void* m,
                               void* v, void* stat, void* losses,
                               void* scratch, long long scratch_n,
                               const int* dims, const float* hyper,
                               void* stream) {
  const Dims d = dims_of(dims);
  Hyper hp{hyper[0], hyper[1], hyper[2], hyper[3], hyper[4], hyper[5], hyper[6],
           hyper[7], hyper[8], hyper[9], hyper[10], hyper[11], hyper[12]};
  if (d.K < 1 || d.K > 2 || d.H < 4 || d.H > 128 || d.H % 4 || d.N < 2 || d.BS < 1 ||
      d.G < 0 || d.act < 0 || d.act > kSelu || d.scale < 0 ||
      d.scale > kScaleSigmoid || d.blocks < 1 || d.blocks > kMaxBlocks || d.blocks > d.BS ||
      d.slots < 1 || (d.wpt != 1 && d.wpt != 2 && d.wpt != 4) ||
      d.warps < d.slots * d.K * d.wpt || d.warps > kMaxWarps || d.staged < 0 ||
      d.staged > 1 || d.slots_global < 0 || d.slots_global > 1 ||
      (d.staged && d.slots_global) || d.bf16 < 0 || d.bf16 > 1 ||
      scratch_n < scratch_floats(d))
    return (int)cudaErrorInvalidValue;
  if (d.G == 0) return 0;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // the kernel's static shared memory (sh_nv) stays out of the dynamic budget
  const size_t smem = smem_bytes(d);
  if (smem + 64 > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const float* f_data = static_cast<const float*>(data);
  float* f_p = static_cast<float*>(params);
  float* f_m = static_cast<float*>(m);
  float* f_v = static_cast<float*>(v);
  float* f_stat = static_cast<float*>(stat);
  float* f_loss = static_cast<float*>(losses);
  float* f_scr = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NJODE_TR(C, BF)                                                                    \
  err = sm ? launch<C, true, BF>(f_data, f_p, f_m, f_v, f_stat, f_loss, f_scr, d, hp, smem, s) \
           : launch<C, false, BF>(f_data, f_p, f_m, f_v, f_stat, f_loss, f_scr, d, hp, smem, s)
  const bool sm = d.staged && !d.slots_global;
  if (d.H <= 32) {
    if (d.bf16) NJODE_TR(1, true);
    else NJODE_TR(1, false);
  } else if (d.H <= 64) {
    if (d.bf16) NJODE_TR(2, true);
    else NJODE_TR(2, false);
  } else {
    if (d.bf16) NJODE_TR(4, true);
    else NJODE_TR(4, false);
  }
#undef NJODE_TR
  return (int)err;
}

extern "C" const char* njode_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
