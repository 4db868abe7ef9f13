// A whole run of minibatch Adam steps on the NJ-ODE loss, in one launch, on
// Hopper (sm_90a).
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
// Order per step, as the TPU kernel's (train_kernel.py:450-465): K = 2 runs
// the forward of net 0 for its predictions, then net 1 with residuals, the
// loss, net 1's backward and Adam, then net 0 again with residuals, its
// backward and Adam.  K = 1 runs net 0 alone.
//
// What bounds it on the H100: the f32 multiply-adds of the (rows x H)(H x H)
// products, about 3 x the forward's 2 x (N H^2 + (N-1) 2 H^2 + (2N-1) H^2) per
// trajectory and network, on the CUDA cores of ONE SM: the steps are
// sequential, so one persistent block runs the whole run and loops over the
// steps.  A cluster or a cooperative grid that splits a minibatch is later
// work.  Device memory is read once (the data, G x BS x (2N+1) floats) and
// the state stays in shared memory and L2.
//
// Design: the block has C warps (C <= 12, as many as shared memory holds:
// 12 at H = 32, 4 at H = 64, 3 at H = 128 for N = 10).  Each warp owns one
// trajectory of a chunk of C: lanes over the hidden units (CPT = ceil(H/32)
// columns each), the trajectory's 2N-1 rows of activations and cotangents in
// the warp's shared-memory slot.  The products read 4 rows' inputs as
// float4s and share each weight load among the 4 rows, so H must be a
// multiple of 4.  After a chunk's forward and backward a block barrier, then
// each warp adds the chunk's contribution to the gradient items it owns
// (groups of 4 rows of a weight matrix, or a vector; lanes over the columns,
// register-blocked), summing the chunk's trajectories and rows in a fixed
// order, so the result does not change from run to run.  After the last
// chunk, each thread runs Adam on a fixed stride of entries.  The current
// network's weights are staged in shared memory, matrix rows padded to H+4
// floats so that the transposed products of the backward read float4s from
// distinct banks, when they fit beside two warps' slots (H <= 64); at
// H = 128 they are staged in the same layout at the head of the scratch and
// read through L1/L2.
//
// Layout (all f32, contiguous; njode_tpu_torch/ops/train_kernel.py writes
// it down): data (G*BS, 2N+1) rows [x_0..x_{N-1}, t_0..t_{N-1}, valid];
// params, m, v (K, P) with P = 4H^2 + 10H + 1 per network: the (in, out)
// matrices J2, O1, W1h, W2, then the vectors j1, bj1, bj2, w1x, w1t, w1d, b1,
// b2, bo1, o2 and the scalar bo2; stat (2,) = [b1^t, b2^t]; losses (G,);
// scratch (W + P + BS (2N-1) + BS,) = [the padded weights W = staged_floats(H)
// when they live in device memory, the gradient, net 0's predictions, the
// per-trajectory loss terms].  params, m, v and stat are updated in place.
//
// Numerics: built without --use_fast_math.  Sums run in other orders than the
// plain PyTorch version's, and the compiler contracts multiply-adds.

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

namespace {

constexpr int kWarp = 32;
// at most 12 warps keeps the register cap at 168 (65,536 / 384 threads)
constexpr int kMaxWarps = 12;

// codes in the order of SUPPORTED_ACTS / SCALINGS in ops/activations.py
enum Act { kRelu = 0, kTanh = 1, kSigmoid = 2, kElu = 3, kLeakyRelu = 4, kSelu = 5 };
enum Scale { kIdentity = 0, kScaleTanh = 1, kScaleSigmoid = 2 };
// matrices and vectors of one network's flat parameter block
enum Mat { kJ2 = 0, kO1 = 1, kW1h = 2, kW2 = 3 };
enum Vec { kJ1 = 0, kBJ1, kBJ2, kW1X, kW1T, kW1D, kB1, kB2, kBO1, kO2, kNumVec };
// what a pass over the minibatch does with one network
enum Mode {
  kPredOnly = 0,  // K = 2, net 0: forward, keep the predictions
  kMean = 1,      // net 0 (K = 1 or 2): mean cotangents, backward, Adam
  kVar = 2,       // K = 2, net 1: variance cotangents and the loss, backward, Adam
};

constexpr float kSeluL = 1.0507009873554805f;
constexpr float kSeluA = 1.6732632423543772f;

struct Dims {
  int K, H, N, BS, G, act, scale, second_moment;
};

struct Hyper {
  float lr, wd, b1, b2, omb1, omb2, adam_eps, eps, w0, w1, inv_n, w0n, w1n;
};

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One network's weights, padded (ld = H + 4), in shared or device memory.
// mat[m](i, j) = mat[m][i * ld + j], (in, out) orientation.
struct Net {
  const float* mat[4];
  int ld;
  const float* vec;  // kNumVec vectors of H, then bo2
};

// A warp's shared-memory slot for one trajectory; each (rows x H) array has
// row stride H.  With identity scaling s(hj) is hj, so schj aliases in's
// first rows.  The gradients of o2, j1 and bj1 are summed over the
// trajectory's rows in the backward (do2v, dj1v, dbj1v), so u and d a1_pre
// need no rows of their own.
struct Slot {
  float *x, *t, *dt, *scx, *y, *gy;
  float *a1p, *a1, *hjp, *in, *schj, *g1p, *g1, *up, *dup, *ddh, *dg1p, *dhjp;
  float *do2v, *dj1v, *dbj1v;
};

__host__ __device__ __forceinline__ int slot_floats(int H, int N, int scale) {
  const int S = N - 1, R = 2 * N - 1;
  const int rows = 4 * N + 3 * R + (scale == kIdentity ? 4 : 5) * S + 3;
  return (rows * H + 2 * N + 2 * S + 2 * R + 3) & ~3;
}

// one network's weights as the products read them: the matrices with rows
// padded to H + 4 floats (16-byte aligned rows; the transposed products'
// float4 reads of a quarter-warp then fall in distinct banks), the vectors
// after them; rounded up to whole float4s
__host__ __device__ __forceinline__ int staged_floats(int H) {
  return (4 * H * (H + 4) + kNumVec * H + 1 + 3) & ~3;
}

__device__ Slot make_slot(float* base, int H, int N, int scale) {
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
  s.do2v = p; p += H;
  s.dj1v = p; p += H;
  s.dbj1v = p;
  return s;
}

// out[r][j] = sum_i in[r][i] W(i, j) for r < nrows, with W(i, j) = w[i*ld+j]
// or, TRANS, w[j*ld+i]; lane owns columns lane + 32 c.  Four rows share each
// weight load, and in's rows are read as float4 (H % 4 == 0, rows and w's
// rows 16-byte aligned); i runs in order, as the plain version sums.
template <int CPT, bool TRANS>
__device__ void warp_mm(const float* in, int nrows, const float* w, int ld,
                        int H, float* out, int lane) {
  for (int r0 = 0; r0 < nrows; r0 += 4) {
    const float4* rows[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      rows[q] = reinterpret_cast<const float4*>(in + (size_t)min(r0 + q, nrows - 1) * H);
    float acc[4][CPT];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[q][c] = 0.0f;
#pragma unroll 2
    for (int i4 = 0; i4 < H / 4; ++i4) {
      float4 xv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = rows[q][i4];
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
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc[q][c] = fmaf(xv[q].x, wv[0][c], acc[q][c]);
          acc[q][c] = fmaf(xv[q].y, wv[1][c], acc[q][c]);
          acc[q][c] = fmaf(xv[q].z, wv[2][c], acc[q][c]);
          acc[q][c] = fmaf(xv[q].w, wv[3][c], acc[q][c]);
        }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (r0 + q >= nrows) break;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        if (j < H) out[(size_t)(r0 + q) * H + j] = acc[q][c];
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

// Forward of one network for the trajectory in `s` (x, t, dt, scx loaded).
template <int CPT>
__device__ void forward(float* base, const Net& net, const Dims& d, int lane) {
  const Slot s = make_slot(base, d.H, d.N, d.scale);
  const int H = d.H, N = d.N, S = N - 1, R = 2 * N - 1;
  const float* v = net.vec;
  float va[CPT], vb[CPT], vc[CPT], vd[CPT];
  // jump: a1 = act(x j1 + bj1), hj = act(a1 J2 + bj2)
  vec_regs<CPT>(v, kJ1, H, lane, va);
  vec_regs<CPT>(v, kBJ1, H, lane, vb);
  for (int r = 0; r < N; ++r)
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
  warp_mm<CPT, false>(s.a1, N, net.mat[kJ2], net.ld, H, s.hjp, lane);
  vec_regs<CPT>(v, kBJ2, H, lane, va);
  for (int r = 0; r < N; ++r)
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
  warp_mm<CPT, false>(s.schj, S, net.mat[kW1h], net.ld, H, s.g1p, lane);
  vec_regs<CPT>(v, kW1X, H, lane, va);
  vec_regs<CPT>(v, kW1T, H, lane, vb);
  vec_regs<CPT>(v, kW1D, H, lane, vc);
  vec_regs<CPT>(v, kB1, H, lane, vd);
  for (int g = 0; g < S; ++g)
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
  warp_mm<CPT, false>(s.g1, S, net.mat[kW2], net.ld, H, s.in + (size_t)N * H, lane);
  vec_regs<CPT>(v, kB2, H, lane, va);
  for (int g = 0; g < S; ++g)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) {
        const float dh = s.in[(N + g) * H + j] + va[c];
        s.in[(N + g) * H + j] = s.in[g * H + j] + s.dt[g] * dh;
      }
    }
  __syncwarp();
  // readout of the N after-jump and N-1 before-jump states
  warp_mm<CPT, false>(s.in, R, net.mat[kO1], net.ld, H, s.up, lane);
  const float bo2 = v[kNumVec * H];
  vec_regs<CPT>(v, kBO1, H, lane, va);
  vec_regs<CPT>(v, kO2, H, lane, vb);
  for (int r = 0; r < R; ++r) {
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
// predictions (the slot's own in kMean).
__device__ void cotangents(float* base, const float* y0, int mode,
                           float valid, float nv, const Dims& d,
                           const Hyper& hp, float* lt, int lane) {
  const int N = d.N;
  const Slot s = make_slot(base, d.H, N, d.scale);
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

// Backward of one network from s.gy; leaves the operands of the parameter
// gradient in the slot (in/dup, g1/ddh, schj/dg1p, a1/dhjp, and the
// trajectory's do2v, dj1v, dbj1v).
template <int CPT>
__device__ void backward(float* base, const Net& net, const Dims& d, int lane) {
  const Slot s = make_slot(base, d.H, d.N, d.scale);
  const int H = d.H, N = d.N, S = N - 1, R = 2 * N - 1;
  float o2[CPT], do2[CPT];
  vec_regs<CPT>(net.vec, kO2, H, lane, o2);
#pragma unroll
  for (int c = 0; c < CPT; ++c) do2[c] = 0.0f;
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) {
        const float pre = s.up[r * H + j];
        s.dup[r * H + j] = (s.gy[r] * o2[c]) * act_grad(pre, d.act);
        do2[c] = fmaf(activate(pre, d.act), s.gy[r], do2[c]);
      }
    }
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = lane + kWarp * c;
    if (j < H) s.do2v[j] = do2[c];
  }
  __syncwarp();
  // d(in) = dup O1^T, into up (rows < N: d hj, rows >= N: d hm)
  warp_mm<CPT, true>(s.dup, R, net.mat[kO1], net.ld, H, s.up, lane);
  for (int g = 0; g < S; ++g)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) s.ddh[g * H + j] = s.dt[g] * s.up[(N + g) * H + j];
    }
  __syncwarp();
  warp_mm<CPT, true>(s.ddh, S, net.mat[kW2], net.ld, H, s.dg1p, lane);
  for (int g = 0; g < S; ++g)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) s.dg1p[g * H + j] *= act_grad(s.g1p[g * H + j], d.act);
    }
  __syncwarp();
  // d hj = d in[:N] + [d hm + (dg1p W1h^T) s'(hj), 0]; the product goes to g1p
  warp_mm<CPT, true>(s.dg1p, S, net.mat[kW1h], net.ld, H, s.g1p, lane);
  for (int r = 0; r < N; ++r)
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
  // d a1_pre = (dhjp J2^T) act'(a1_pre), into up (dead by now), summed
  // over the rows into the j1 and bj1 gradients of this trajectory
  warp_mm<CPT, true>(s.dhjp, N, net.mat[kJ2], net.ld, H, s.up, lane);
  float dj1[CPT], dbj1[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dj1[c] = dbj1[c] = 0.0f;
  for (int r = 0; r < N; ++r)
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
      s.dj1v[j] = dj1[c];
      s.dbj1v[j] = dbj1[c];
    }
  }
  __syncwarp();
}

// Offsets of a slot's arrays from its base (the same for every slot).
struct Offsets {
  int x, t, dt, scx, gy, a1, in, schj, g1, dup, ddh, dg1p, dhjp, do2v, dj1v, dbj1v;
};

__device__ Offsets slot_offsets(float* base, int H, int N, int scale) {
  const Slot s = make_slot(base, H, N, scale);
  return Offsets{(int)(s.x - base),    (int)(s.t - base),     (int)(s.dt - base),
                 (int)(s.scx - base),  (int)(s.gy - base),    (int)(s.a1 - base),
                 (int)(s.in - base),   (int)(s.schj - base),  (int)(s.g1 - base),
                 (int)(s.dup - base),  (int)(s.ddh - base),   (int)(s.dg1p - base),
                 (int)(s.dhjp - base), (int)(s.do2v - base),  (int)(s.dj1v - base),
                 (int)(s.dbj1v - base)};
}

// Adds the chunk's contribution to the gradient: for each of the nc slots
// in order and each of its rows in order, a[r][i] b[r][j] into matrix entry
// (i, j) and s[r] b[r][j] into vector entry j (the per-trajectory sums
// do2v, dj1v, dbj1v as one row).  The items (groups of 4
// matrix rows, and the vectors) are owned by warps, item % C == warp, and
// their columns by lanes, so every entry has one owner and one summation
// order.
template <int CPT>
__device__ void reduce_chunk(float* slots, int slot_f, int nc,
                             const Dims& d, float* gacc,
                             int warp, int C, int lane) {
  const int H = d.H, N = d.N, S = N - 1, R = 2 * N - 1, HH = H * H;
  const Offsets o = slot_offsets(slots, H, N, d.scale);
  const int groups = H / 4;
  const int n_items = 4 * groups + kNumVec + 1;
  for (int item = warp; item < n_items; item += C) {
    if (item < 4 * groups) {
      const int m = item / groups, i0 = (item - m * groups) * 4;
      int oa, ob, rows;
      switch (m) {
        case kJ2: oa = o.a1; ob = o.dhjp; rows = N; break;
        case kO1: oa = o.in; ob = o.dup; rows = R; break;
        case kW1h: oa = o.schj; ob = o.dg1p; rows = S; break;
        default: oa = o.g1; ob = o.ddh; rows = S; break;
      }
      float acc[4][CPT];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[q][c] = 0.0f;
      for (int t = 0; t < nc; ++t) {
        const float* a = slots + (size_t)t * slot_f + oa;
        const float* b = slots + (size_t)t * slot_f + ob;
#pragma unroll 2
        for (int r = 0; r < rows; ++r) {
          float bv[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int j = lane + kWarp * c;
            bv[c] = j < H ? b[r * H + j] : 0.0f;
          }
          const float4 a4 = *reinterpret_cast<const float4*>(a + r * H + i0);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[q][c] = fmaf(av[q], bv[c], acc[q][c]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = lane + kWarp * c;
          if (j < H) gacc[m * HH + (i0 + q) * H + j] += acc[q][c];
        }
      continue;
    }
    const int vi = item - 4 * groups;
    if (vi == kNumVec) {  // bo2: the total cotangent mass
      float part = 0.0f;
      for (int t = 0; t < nc; ++t)
        for (int r = lane; r < R; r += kWarp) part += slots[(size_t)t * slot_f + o.gy + r];
      part = warp_sum(part);
      if (lane == 0) gacc[4 * HH + kNumVec * H] += part;
      continue;
    }
    int os = -1, ob, rows;  // os: the per-row scalar, -1 for none
    switch (vi) {
      case kJ1: ob = o.dj1v; rows = 1; break;
      case kBJ1: ob = o.dbj1v; rows = 1; break;
      case kBJ2: ob = o.dhjp; rows = N; break;
      case kW1X: os = o.scx; ob = o.dg1p; rows = S; break;
      case kW1T: os = o.t; ob = o.dg1p; rows = S; break;
      case kW1D: os = o.dt; ob = o.dg1p; rows = S; break;
      case kB1: ob = o.dg1p; rows = S; break;
      case kB2: ob = o.ddh; rows = S; break;
      case kBO1: ob = o.dup; rows = R; break;
      default: ob = o.do2v; rows = 1; break;  // o2
    }
    float acc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] = 0.0f;
    for (int t = 0; t < nc; ++t) {
      const float* b = slots + (size_t)t * slot_f + ob;
      const float* sc = slots + (size_t)t * slot_f + os;
      for (int r = 0; r < rows; ++r) {
        const float sv = os >= 0 ? sc[r] : 1.0f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = lane + kWarp * c;
          if (j < H) acc[c] = fmaf(sv, b[r * H + j], acc[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      if (j < H) gacc[4 * HH + vi * H + j] += acc[c];
    }
  }
}

template <int CPT>
__global__ void __launch_bounds__(kWarp * kMaxWarps)
train_run_kernel(const float* __restrict__ data, float* params, float* adam_m,
                 float* adam_v, float* stat, float* losses, float* scratch,
                 Dims d, Hyper hp, int staged, int slot_f) {
  extern __shared__ float smem[];
  __shared__ float sh_nv, sh_c1, sh_c2;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int C = blockDim.y, n_threads = kWarp * C;
  const int tid = warp * kWarp + lane;
  const int H = d.H, N = d.N, S = N - 1, R = 2 * N - 1, BS = d.BS;
  const int HH = H * H, P = 4 * HH + kNumVec * H + 1;
  const int row_f = 2 * N + 1;
  // the current network's weights, padded: in shared memory when they fit,
  // else at the head of the scratch (read through L1/L2)
  float* sw = staged ? smem : scratch;
  float* gacc = scratch + staged_floats(H);
  float* pred0 = gacc + P;
  float* lt = pred0 + (size_t)BS * R;
  float* slots = smem + (staged ? staged_floats(H) : 0);
  // the slot's pointers are rebuilt where used (make_slot is arithmetic), so
  // they hold no registers across the step
  float* mine = slots + (size_t)warp * slot_f;
  if (tid == 0) {
    sh_c1 = stat[0];
    sh_c2 = stat[1];
  }

  for (int step = 0; step < d.G; ++step) {
    const float* rows = data + (size_t)step * BS * row_f;
    if (warp == 0) {  // the valid count, lane partials in a fixed order
      float nv = 0.0f;
      for (int b = lane; b < BS; b += kWarp) nv += rows[(size_t)b * row_f + 2 * N];
      nv = warp_sum(nv);
      if (lane == 0) {
        sh_nv = fmaxf(nv, 1.0f);
        sh_c1 *= hp.b1;  // this step's bias-correction powers
        sh_c2 *= hp.b2;
      }
    }
    __syncthreads();
    const float nv = sh_nv, c1 = sh_c1, c2 = sh_c2;

    const int n_pass = d.K == 1 ? 1 : 3;
    for (int pass = 0; pass < n_pass; ++pass) {
      const int k = (d.K == 2 && pass == 1) ? 1 : 0;
      const int mode = d.K == 1 ? kMean : (pass == 0 ? kPredOnly : (pass == 1 ? kVar : kMean));
      float* pk = params + (size_t)k * P;
      const int ld = H + 4;
      for (int idx = tid; idx < 4 * HH; idx += n_threads) {
        const int m = idx / HH, rem = idx - m * HH, i = rem / H, j = rem - i * H;
        sw[(m * H + i) * ld + j] = pk[idx];
      }
      for (int idx = tid; idx < kNumVec * H + 1; idx += n_threads)
        sw[4 * H * ld + idx] = pk[4 * HH + idx];
      Net net;
      for (int m = 0; m < 4; ++m) net.mat[m] = sw + m * H * ld;
      net.ld = ld;
      net.vec = sw + 4 * H * ld;
      if (mode != kPredOnly)
        for (int e = tid; e < P; e += n_threads) gacc[e] = 0.0f;
      __syncthreads();

      for (int b0 = 0; b0 < BS; b0 += C) {
        const int b = b0 + warp;
        if (b < BS) {
          const float* row = rows + (size_t)b * row_f;
          {
            const Slot sl = make_slot(mine, H, N, d.scale);
            for (int r = lane; r < N; r += kWarp) {
              sl.x[r] = row[r];
              sl.t[r] = row[N + r];
            }
            __syncwarp();
            for (int g = lane; g < S; g += kWarp) {
              sl.dt[g] = sl.t[g + 1] - sl.t[g];
              sl.scx[g] = scale_in(sl.x[g], d.scale);
            }
            __syncwarp();
          }
          forward<CPT>(mine, net, d, lane);
          if (mode == kPredOnly) {
            const float* y = make_slot(mine, H, N, d.scale).y;
            for (int r = lane; r < R; r += kWarp) pred0[(size_t)b * R + r] = y[r];
          } else {
            const float* y0 = mode == kVar ? pred0 + (size_t)b * R
                                           : make_slot(mine, H, N, d.scale).y;
            const bool writes_loss = d.K == 1 || mode == kVar;
            cotangents(mine, y0, mode, row[2 * N], nv, d, hp,
                       writes_loss ? lt + b : nullptr, lane);
            backward<CPT>(mine, net, d, lane);
          }
        }
        if (mode != kPredOnly) {
          __syncthreads();
          const int nc = min(C, BS - b0);
          reduce_chunk<CPT>(slots, slot_f, nc, d, gacc, warp, C, lane);
          __syncthreads();
        }
      }

      if (mode != kPredOnly) {  // Adam on the entries this thread owns
        float* mk = adam_m + (size_t)k * P;
        float* vk = adam_v + (size_t)k * P;
        for (int e = tid; e < P; e += n_threads) {
          const float p = pk[e];
          const float g = gacc[e] + hp.wd * p;
          const float m = hp.b1 * mk[e] + hp.omb1 * g;
          const float v = hp.b2 * vk[e] + hp.omb2 * g * g;
          const float m_hat = m / (1.0f - c1);
          const float v_hat = v / (1.0f - c2);
          pk[e] = p - hp.lr * m_hat / (sqrtf(v_hat) + hp.adam_eps);
          mk[e] = m;
          vk[e] = v;
        }
      }
      __syncthreads();
    }

    if (warp == 0) {
      float total = 0.0f;
      for (int b = lane; b < BS; b += kWarp) total += lt[b];
      total = warp_sum(total);
      if (lane == 0) losses[step] = total / nv;
    }
  }
  if (tid == 0) {
    stat[0] = sh_c1;
    stat[1] = sh_c2;
  }
}

// The kernel's static shared memory stays out of the dynamic budget.
constexpr size_t kReserve = 64;

int max_smem_optin(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

template <int CPT>
cudaError_t launch(const float* data, float* params, float* m, float* v,
                   float* stat, float* losses, float* scratch, const Dims& d,
                   const Hyper& hp, int warps, int staged, size_t smem,
                   cudaStream_t stream) {
  auto kernel = train_run_kernel<CPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, dim3(kWarp, warps), smem, stream>>>(
      data, params, m, v, stat, losses, scratch, d, hp, staged,
      slot_floats(d.H, d.N, d.scale));
  return cudaGetLastError();
}

}  // namespace

// dims = [K, H, N, BS, G, act, scale, second_moment, warps, staged]; hyper =
// [lr, wd, b1, b2, 1-b1, 1-b2, adam_eps, eps, w0, w1, 1/N, w0/N, w1/N] (host
// arrays).  The launch plan (warps, and whether the weights are staged in
// shared memory) is the caller's (launch_plan in ops/train_kernel.py); the
// shared memory it needs is checked here against the device's opt-in limit.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int njode_train_run(const void* data, void* params, void* m,
                               void* v, void* stat, void* losses,
                               void* scratch, const int* dims,
                               const float* hyper, void* stream) {
  Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6], dims[7]};
  Hyper hp{hyper[0], hyper[1], hyper[2], hyper[3], hyper[4], hyper[5], hyper[6],
           hyper[7], hyper[8], hyper[9], hyper[10], hyper[11], hyper[12]};
  const int warps = dims[8], staged = dims[9];
  if (d.K < 1 || d.K > 2 || d.H < 4 || d.H > 128 || d.H % 4 || d.N < 2 || d.BS < 1 ||
      d.G < 0 || d.act < 0 || d.act > kSelu || d.scale < 0 ||
      d.scale > kScaleSigmoid || warps < 1 || warps > std::min(kMaxWarps, d.BS) ||
      staged < 0 || staged > 1)
    return (int)cudaErrorInvalidValue;
  if (d.G == 0) return 0;
  int max_smem = 0;
  const int err = max_smem_optin(&max_smem);
  if (err != 0) return err;
  const size_t smem =
      ((staged ? (size_t)staged_floats(d.H) : 0) +
       (size_t)warps * slot_floats(d.H, d.N, d.scale)) * sizeof(float);
  if (smem + kReserve > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const float* f_data = static_cast<const float*>(data);
  float* f_p = static_cast<float*>(params);
  float* f_m = static_cast<float*>(m);
  float* f_v = static_cast<float*>(v);
  float* f_stat = static_cast<float*>(stat);
  float* f_loss = static_cast<float*>(losses);
  float* f_scr = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (d.H <= 32)
    e = launch<1>(f_data, f_p, f_m, f_v, f_stat, f_loss, f_scr, d, hp, warps, staged, smem, s);
  else if (d.H <= 64)
    e = launch<2>(f_data, f_p, f_m, f_v, f_stat, f_loss, f_scr, d, hp, warps, staged, smem, s);
  else
    e = launch<4>(f_data, f_p, f_m, f_v, f_stat, f_loss, f_scr, d, hp, warps, staged, smem, s);
  return (int)e;
}

extern "C" const char* njode_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
