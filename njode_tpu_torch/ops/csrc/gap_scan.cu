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
// entirely on chip.  The final partial step to t_tgt stays in PyTorch around
// the kernel (njode_tpu_torch/ops/gap_scan.py), as in the JAX package.
//
// What bounds it on the H100: the two (d_h x d_h) products of every substep,
// 4 d_h^2 flops per row and substep, in f32 on the CUDA cores; device memory
// is touched once per gap.  The rows of one request take very different
// numbers of substeps (a query just after an observation takes none, one far
// from it 30-40), so what the work costs is set as much by how the rows are
// spread as by the products.  The design:
//
//   * Balance.  Block b of the grid owns the rows b, b + nb, b + 2 nb, ...
//     (a sample of the whole request; one wave of blocks).  It first counts
//     each row's substeps with the loop's own predicate and t arithmetic,
//     sorts its rows by that count, longest first (a counting sort in shared
//     memory), and its warps then take groups of rows of about equal length
//     from a counter in shared memory, longest first.  Where the weights
//     are staged, the longest rows (at least kLongQ / 4 of the pass's
//     longest count) go one a row group, so the chain that ends the block
//     is a short group, and the rest kTrStaged a row group; unstaged, every
//     row group holds kTrUnstaged rows (each weight load through L1 then
//     serves more rows) and there is no long tier.  A warp leaves a
//     group's loop as soon as none of its rows still moves (exact: t then
//     never changes again).  Which rows share a warp does not change a
//     row's arithmetic, so h_L repeats bitwise from call to call.
//   * A register micro-tile.  A warp holds G row groups of TR rows; a row
//     group is L lanes, lane l of it owning the TC columns l, l + L, ...
//     (L = ceil(d_h / TC), TC picked so that few lanes idle: 10 lanes x 5
//     columns at d_h = 50, 3 row groups a warp).  Each product step k
//     loads TC words of the weights' row k (a row group's lanes read
//     consecutive words, the other row groups the same ones: a broadcast)
//     and one word of each of its TR rows (a broadcast within the row
//     group) for TC TR fmas: every load is one shared-memory wavefront.
//     The weights sit in shared memory when the block stays small (d_h = 50
//     does, 256 does not); wider states read them through L1/L2 (__ldg),
//     coalesced over a row group's lanes; past 256 columns in chunks of 256.
//   * w1t and b2 of the owned columns live in registers for the whole loop,
//     and so does each row's base where the weights are staged; unstaged
//     (d_h past about 90) the row's base is reread through L1 each substep,
//     which keeps TR 4 x TC 8 within the registers (the 256-column chunks
//     reread w1t and b2 too).
//
// Numerics: t advances by single f32 adds and the predicate is computed on
// exactly those values, so t_L is bitwise the plain version's.  h differs
// from it by fma contraction and summation order only (each column's sum
// runs over k in order).  The activations and scalings are walk_cell.cuh's
// (built without --use_fast_math: the accurate expf/tanhf/expm1f, denormals
// kept).
//
// Layout: h0, base, hout (K, R, d_h); t0, ttgt, tout (R,); w1h, w2 (K, d_h,
// d_h) as (in, out); w1t, b2 (K, d_h).  All f32, contiguous.  The launch
// plan (TC, L, G, warps, ldx, ldw, staging, wide, shared bytes) is the
// caller's (gap_plan in ops/gap_scan.py) and is checked here.

#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

#include "walk_cell.cuh"

namespace {

using namespace njode_walk;

constexpr int kMaxWarps = 8;
constexpr int kBins = 128;      // length classes of the sort; longer rows share the last
constexpr int kMaxPass = 2048;  // rows a block sorts at once
constexpr int kWideCols = 256;  // columns of a chunk past d_h = 256 (TC 8 x 32 lanes)
constexpr int kTrStaged = 2;    // rows a row group, weights in shared memory
constexpr int kTrUnstaged = 4;  // rows a row group, weights through L1
constexpr int kLongQ = 2;       // staged: the long tier from 2 / 4 of the longest count

// acc[q][u] = sum_i x[q][i] W[i][j], j = c0 + cl + L u, for the TR rows x
// of a row group (shared memory, row stride ldx), the sum over i in order.
// STAGE: W is the plane in shared memory, W[i * ldw + j] (zero past d_h);
// else W (in, out) in device memory, read through the read-only cache
// (columns past d_h read column d_h - 1 and are never stored).  Every load
// is 32 bits: a row group's lanes read consecutive words of W (the other
// row groups the same words) and one word of x each, so each load is one
// shared-memory wavefront.
template <int TC, int TR, bool STAGE>
__device__ __forceinline__ void rows_times_w(const float* __restrict__ x, int ldx,
                                             const float* __restrict__ W, int ldw,
                                             int d_h, int c0, int cl, int L,
                                             float (&acc)[TR][TC]) {
#pragma unroll
  for (int q = 0; q < TR; ++q)
#pragma unroll
    for (int u = 0; u < TC; ++u) acc[q][u] = 0.0f;
  int col[TC];
#pragma unroll
  for (int u = 0; u < TC; ++u) col[u] = STAGE ? cl + L * u : min(c0 + cl + L * u, d_h - 1);
  const int ld = STAGE ? ldw : d_h;
#pragma unroll 4
  for (int i = 0; i < d_h; ++i) {
    float w[TC];
#pragma unroll
    for (int u = 0; u < TC; ++u) {
      const float* p = W + (size_t)i * ld + col[u];
      w[u] = STAGE ? *p : __ldg(p);
    }
#pragma unroll
    for (int q = 0; q < TR; ++q) {
      const float xv = x[q * ldx + i];
#pragma unroll
      for (int u = 0; u < TC; ++u) acc[q][u] = fmaf(xv, w[u], acc[q][u]);
    }
  }
}

// What a warp's group of rows needs: the kernel's arguments, this block's
// sort, this warp's row buffers and this lane's place in its row group.
struct Ctx {
  const float *h0, *base, *t0, *ttgt, *W1, *W2, *w1t, *b2;
  float *hout, *tout;
  const int* s_ord;
  float *my_h, *my_hid, *my_x;
  int R, d_h, n_sub, act, scale, L, G, ldx, ldw, k, blk, nb, p0, grp, cl;
  float dt;
  bool lane_on;
};

// One group of rows on one warp: the rows at sorted positions pos0 + grp TR
// + q (q < TR) before pos_end, loaded, run until none moves, stored.
template <int TC, int TR, bool STAGE, bool WIDE>
__device__ __forceinline__ void run_group(const Ctx& c, const float (&w1t_r)[TC],
                                          const float (&b2_r)[TC], int pos0, int pos_end) {
  const int d_h = c.d_h, L = c.L, cl = c.cl, ldx = c.ldx, k = c.k;
  const float dt = c.dt;
  const int my_row0 = c.grp * TR;  // first buffer row of the row group
  int row[TR];
  bool valid[TR];
  float t[TR], t_tgt[TR];
  float bse[TR][TC];
#pragma unroll
  for (int q = 0; q < TR; ++q) {
    const int pos = pos0 + my_row0 + q;
    valid[q] = c.lane_on && pos < pos_end;
    row[q] = valid[q] ? c.blk + (c.p0 + c.s_ord[pos]) * c.nb : 0;
    t[q] = valid[q] ? c.t0[row[q]] : 0.0f;
    t_tgt[q] = valid[q] ? c.ttgt[row[q]] : 0.0f;
    const size_t g0 = ((size_t)k * c.R + row[q]) * d_h;
    float* hq = c.my_h + (my_row0 + q) * ldx;
    float* xq = c.my_x + (my_row0 + q) * ldx;
    if (valid[q]) {
      for (int j = cl; j < d_h; j += L) {
        const float hv = c.h0[g0 + j];
        hq[j] = hv;
        if (c.scale != kIdentity) xq[j] = scale_in(hv, c.scale);
      }
    }
    if constexpr (STAGE) {
#pragma unroll
      for (int u = 0; u < TC; ++u) {
        const int j = cl + L * u;
        bse[q][u] = valid[q] && j < d_h ? c.base[g0 + j] : 0.0f;
      }
    }
  }
  __syncwarp();

  const float* xg = c.my_x + my_row0 * ldx;
  const float* hidg = c.my_hid + my_row0 * ldx;
  float acc[TR][TC];
  for (int s = 0; s < c.n_sub; ++s) {
    bool pred[TR];
    bool any = false;
#pragma unroll
    for (int q = 0; q < TR; ++q) {
      pred[q] = valid[q] && (t[q] + dt) < t_tgt[q];
      any = any || pred[q];
    }
    if (!__any_sync(0xffffffffu, any)) break;

    // hid = act(s(h) W1h + base + t w1t), chunk by chunk of columns
    for (int c0 = 0; c0 < d_h; c0 += WIDE ? kWideCols : d_h) {
      rows_times_w<TC, TR, STAGE>(xg, ldx, c.W1, c.ldw, d_h, c0, cl, L, acc);
#pragma unroll
      for (int u = 0; u < TC; ++u) {
        const int j = c0 + cl + L * u;
        if (!c.lane_on || j >= d_h) continue;
        const float wt = WIDE ? __ldg(c.w1t + (size_t)k * d_h + j) : w1t_r[u];
#pragma unroll
        for (int q = 0; q < TR; ++q) {
          const float bq = STAGE ? bse[q][u]
                                 : (valid[q] ? __ldg(c.base + ((size_t)k * c.R + row[q]) * d_h + j)
                                             : 0.0f);
          c.my_hid[(my_row0 + q) * ldx + j] = activate(acc[q][u] + bq + t[q] * wt, c.act);
        }
      }
    }
    __syncwarp();

    // h += dt (hid W2 + b2) on the rows whose predicate holds
    for (int c0 = 0; c0 < d_h; c0 += WIDE ? kWideCols : d_h) {
      rows_times_w<TC, TR, STAGE>(hidg, ldx, c.W2, c.ldw, d_h, c0, cl, L, acc);
#pragma unroll
      for (int u = 0; u < TC; ++u) {
        const int j = c0 + cl + L * u;
        if (!c.lane_on || j >= d_h) continue;
        const float bb = WIDE ? __ldg(c.b2 + (size_t)k * d_h + j) : b2_r[u];
#pragma unroll
        for (int q = 0; q < TR; ++q) {
          if (!pred[q]) continue;
          float* hq = c.my_h + (my_row0 + q) * ldx;
          const float hv = hq[j] + dt * (acc[q][u] + bb);
          hq[j] = hv;
          if (c.scale != kIdentity) c.my_x[(my_row0 + q) * ldx + j] = scale_in(hv, c.scale);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < TR; ++q)
      if (pred[q]) t[q] += dt;
    __syncwarp();
  }

#pragma unroll
  for (int q = 0; q < TR; ++q) {
    if (!valid[q]) continue;
    const size_t g0 = ((size_t)k * c.R + row[q]) * d_h;
    const float* hq = c.my_h + (my_row0 + q) * ldx;
    for (int j = cl; j < d_h; j += L) c.hout[g0 + j] = hq[j];
    if (k == 0 && cl == 0) c.tout[row[q]] = t[q];
  }
  __syncwarp();
}

// Grid (nb, K); block (32, warps).  See the header for the schedule.  A
// warp's row buffers: h, hid and (unless identity scaling) s(h), each TR G
// rows of ldx floats; after them the block's sort: key and order of up to
// kMaxPass rows, kBins bin starts, the group counter.
template <int TC, bool STAGE, bool WIDE>
__global__ void __launch_bounds__(kWarp * kMaxWarps, 1)
gap_scan_fwd_kernel(const float* __restrict__ h0, const float* __restrict__ base,
                    const float* __restrict__ t0, const float* __restrict__ ttgt,
                    const float* __restrict__ w1h, const float* __restrict__ w1t,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    float* __restrict__ hout, float* __restrict__ tout,
                    int R, int d_h, float dt, int n_sub, int act, int scale,
                    int L, int G, int ldx, int ldw) {
  constexpr int TR = STAGE ? kTrStaged : kTrUnstaged;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int k = blockIdx.y, blk = blockIdx.x, nb = gridDim.x;
  const int lane = threadIdx.x, warp = threadIdx.y, nwarps = blockDim.y;
  const int tid = warp * kWarp + lane, n_thr = kWarp * nwarps;
  const int RPW = G * TR;
  const int nbuf = scale == kIdentity ? 2 : 3;
  const size_t dd = (size_t)d_h * d_h;

  const float* W1 = w1h + (size_t)k * dd;
  const float* W2 = w2 + (size_t)k * dd;
  float* rows = smem;
  if constexpr (STAGE) {
    float* s_w1 = smem;
    float* s_w2 = smem + (size_t)d_h * ldw;
    for (int e = tid; e < d_h * ldw; e += n_thr) {
      const int i = e / ldw, j = e - i * ldw;
      s_w1[e] = j < d_h ? __ldg(W1 + (size_t)i * d_h + j) : 0.0f;
      s_w2[e] = j < d_h ? __ldg(W2 + (size_t)i * d_h + j) : 0.0f;
    }
    W1 = s_w1;
    W2 = s_w2;
    rows = smem + 2 * (size_t)d_h * ldw;
  }
  const int wbuf = nbuf * RPW * ldx;
  for (int e = tid; e < nwarps * wbuf; e += n_thr) rows[e] = 0.0f;  // pads stay 0
  float* my_h = rows + (size_t)warp * wbuf;
  float* my_hid = my_h + RPW * ldx;
  float* my_x = scale == kIdentity ? my_h : my_hid + RPW * ldx;
  int* s_key = reinterpret_cast<int*>(rows + (size_t)nwarps * wbuf);
  int* s_ord = s_key + kMaxPass;
  int* s_bin = s_ord + kMaxPass;
  int* s_next = s_bin + kBins;
  int* s_nlong = s_next + 1;

  // this lane's row group and columns; lanes past G row groups compute a
  // copy of the last group's columns and store nothing
  const int grp_l = lane / L;
  Ctx c;
  c.h0 = h0;
  c.base = base;
  c.t0 = t0;
  c.ttgt = ttgt;
  c.W1 = W1;
  c.W2 = W2;
  c.w1t = w1t;
  c.b2 = b2;
  c.hout = hout;
  c.tout = tout;
  c.s_ord = s_ord;
  c.my_h = my_h;
  c.my_hid = my_hid;
  c.my_x = my_x;
  c.R = R;
  c.d_h = d_h;
  c.n_sub = n_sub;
  c.act = act;
  c.scale = scale;
  c.L = L;
  c.G = G;
  c.ldx = ldx;
  c.ldw = ldw;
  c.k = k;
  c.blk = blk;
  c.nb = nb;
  c.lane_on = grp_l < G;
  c.grp = c.lane_on ? grp_l : G - 1;
  c.cl = lane - grp_l * L;
  c.dt = dt;
  const int cl = c.cl;
  float w1t_r[TC], b2_r[TC];
  if constexpr (!WIDE) {
#pragma unroll
    for (int u = 0; u < TC; ++u) {
      const int j = cl + L * u;
      w1t_r[u] = j < d_h ? __ldg(w1t + (size_t)k * d_h + j) : 0.0f;
      b2_r[u] = j < d_h ? __ldg(b2 + (size_t)k * d_h + j) : 0.0f;
    }
  }

  const int n_loc = R > blk ? (R - blk - 1) / nb + 1 : 0;
  for (int p0 = 0; p0 < n_loc; p0 += kMaxPass) {
    const int n_p = min(kMaxPass, n_loc - p0);
    for (int b = tid; b < kBins; b += n_thr) s_bin[b] = 0;
    if (tid == 0) *s_next = 0;
    __syncthreads();
    // each row's substeps, by the loop's own predicate and t arithmetic
    for (int i = tid; i < n_p; i += n_thr) {
      const int r = blk + (p0 + i) * nb;
      float t = t0[r];
      const float tg = ttgt[r];
      int n = 0;
      while (n < n_sub && t + dt < tg) {
        t += dt;
        ++n;
      }
      s_key[i] = n;
      atomicAdd(&s_bin[min(n, kBins - 1)], 1);
    }
    __syncthreads();
    // bin starts, longest bin first: lane l holds the bins at descending
    // positions 4 l .. 4 l + 3; staged, the long tier is the rows of at
    // least kLongQ / 4 of the pass's longest count (unstaged none)
    if (warp == 0) {
      int cnt[4], sum = 0, top = -1;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        cnt[q] = s_bin[kBins - 1 - (4 * lane + q)];
        sum += cnt[q];
        if (top < 0 && cnt[q] > 0) top = kBins - 1 - (4 * lane + q);
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < kWarp; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      top = __reduce_max_sync(0xffffffffu, top);
      const int thr = STAGE ? max(1, (top * kLongQ + 3) / 4) : kBins;
      if (lane == 0 && thr >= kBins) *s_nlong = 0;
      int start = incl - sum;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int b = kBins - 1 - (4 * lane + q);
        s_bin[b] = start;
        if (b == thr - 1) *s_nlong = start;
        start += cnt[q];
      }
    }
    __syncthreads();
    for (int i = tid; i < n_p; i += n_thr)
      s_ord[atomicAdd(&s_bin[min(s_key[i], kBins - 1)], 1)] = i;
    __syncthreads();

    // the long tier's groups (TR 1), then the rest's (TR), longest first
    c.p0 = p0;
    const int n_long = *s_nlong, n_lg = (n_long + G - 1) / G;
    const int n_groups = n_lg + (n_p - n_long + RPW - 1) / RPW;
    for (;;) {
      int gi = 0;
      if (lane == 0) gi = atomicAdd(s_next, 1);
      gi = __shfl_sync(0xffffffffu, gi, 0);
      if (gi >= n_groups) break;
      if constexpr (STAGE) {
        if (gi < n_lg) {
          run_group<TC, 1, STAGE, WIDE>(c, w1t_r, b2_r, gi * G, min(gi * G + G, n_long));
          continue;
        }
      }
      const int pos0 = n_long + (gi - n_lg) * RPW;
      run_group<TC, TR, STAGE, WIDE>(c, w1t_r, b2_r, pos0, min(pos0 + RPW, n_p));
    }
    __syncthreads();  // the next pass reuses the sort's arrays
  }
}

// shared floats the kernel needs for a plan (gap_plan's smem in gap_scan.py)
size_t smem_bytes_of(int d_h, int G, int warps, int ldx, int ldw, int stage, int scale) {
  const size_t nbuf = scale == kIdentity ? 2 : 3;
  const size_t TR = stage ? kTrStaged : kTrUnstaged;
  const size_t rows = (size_t)warps * nbuf * G * TR * ldx;
  const size_t sort = 2 * (size_t)kMaxPass + kBins + 4;  // + counter, long rows
  const size_t planes = stage ? 2 * (size_t)d_h * ldw : 0;
  return (rows + sort + planes) * sizeof(float);
}

// The shared-memory opt-in and one wave's blocks of an instance, for one
// device and block shape, queried once (the serving path is host-bound);
// several host threads may launch at once, so the cache is read and
// written under its lock.
struct WaveCache {
  std::mutex mu;
  int dev = -1, threads = 0, wave = 0;
  size_t smem = 0;
};

template <int TC, bool STAGE, bool WIDE>
cudaError_t launch(const float* h0, const float* base, const float* t0, const float* ttgt,
                   const float* w1h, const float* w1t, const float* w2, const float* b2,
                   float* hout, float* tout, int K, int R, int d_h, float dt, int n_sub,
                   int act, int scale, int L, int G, int warps, int ldx, int ldw,
                   size_t smem, cudaStream_t stream) {
  constexpr int TR = STAGE ? kTrStaged : kTrUnstaged;
  auto kernel = gap_scan_fwd_kernel<TC, STAGE, WIDE>;
  static WaveCache cache;
  int dev = 0, c_wave = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(cache.mu);
    if (dev != cache.dev || smem != cache.smem || kWarp * warps != cache.threads) {
      if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return err;
      }
      int n_sm = 0, per_sm = 0;
      if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
        return err;
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                               kWarp * warps, smem)) !=
          cudaSuccess)
        return err;
      cache.dev = dev;
      cache.smem = smem;
      cache.threads = kWarp * warps;
      cache.wave = per_sm * n_sm;
    }
    c_wave = cache.wave;
  }
  // one wave: as many blocks a network as the card holds at once, but no
  // more than there are groups of rows
  const int groups = (R + G * TR - 1) / (G * TR);
  const int wave = c_wave / K > 1 ? c_wave / K : 1;
  const int nb = groups < wave ? (groups > 0 ? groups : 1) : wave;
  kernel<<<dim3(nb, K), dim3(kWarp, warps), smem, stream>>>(
      h0, base, t0, ttgt, w1h, w1t, w2, b2, hout, tout, R, d_h, dt, n_sub, act, scale, L, G,
      ldx, ldw);
  return cudaGetLastError();
}

}  // namespace

// plan = [TC, L, G, warps, ldx, ldw, stage, wide] (gap_plan in
// ops/gap_scan.py); smem_bytes its shared bytes.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).  The instances are the plans
// gap_plan makes: staged TC 1, 2, 4, 5, 8; unstaged TC 4, 5, 8; wide TC 8.
extern "C" int njode_gap_scan_fwd(const void* h0, const void* base, const void* t0,
                                  const void* ttgt, const void* w1h, const void* w1t,
                                  const void* w2, const void* b2, void* hout, void* tout,
                                  int K, int R, int d_h, float dt, int n_sub, int act,
                                  int scale, const int* plan, long long smem_bytes,
                                  void* stream) {
  const int TC = plan[0], L = plan[1], G = plan[2], warps = plan[3];
  const int ldx = plan[4], ldw = plan[5], stage = plan[6], wide = plan[7];
  if (K <= 0 || K > 65535 || R < 0 || d_h <= 0 || n_sub < 0 || act < 0 || act > kSelu ||
      scale < 0 || scale > kScaleSigmoid || warps < 1 || warps > kMaxWarps || L < 1 ||
      G < 1 || G * L > kWarp || ldx < d_h || ldx % 4 != 0 ||
      (stage && (wide || ldw < L * TC)) ||
      (wide ? (TC != 8 || L != kWarp || G != 1) : (L * TC < d_h || d_h > kWideCols)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t need = smem_bytes_of(d_h, G, warps, ldx, ldw, stage, scale);
  if ((size_t)smem_bytes < need || smem_bytes > max_smem) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_bytes;

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
#define NJODE_GAP(C, STG, WD)                                                                 \
  err = launch<C, STG, WD>(f_h0, f_base, f_t0, f_ttgt, f_w1h, f_w1t, f_w2, f_b2, f_hout,     \
                           f_tout, K, R, d_h, dt, n_sub, act, scale, L, G, warps, ldx, ldw,  \
                           smem, s)
  if (wide) {
    if (TC != 8) return (int)cudaErrorInvalidValue;
    NJODE_GAP(8, false, true);
  } else if (stage) {
    switch (TC) {
      case 1: NJODE_GAP(1, true, false); break;
      case 2: NJODE_GAP(2, true, false); break;
      case 4: NJODE_GAP(4, true, false); break;
      case 5: NJODE_GAP(5, true, false); break;
      case 8: NJODE_GAP(8, true, false); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (TC) {
      case 4: NJODE_GAP(4, false, false); break;
      case 5: NJODE_GAP(5, false, false); break;
      case 8: NJODE_GAP(8, false, false); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef NJODE_GAP
  return (int)err;
}

extern "C" const char* njode_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
