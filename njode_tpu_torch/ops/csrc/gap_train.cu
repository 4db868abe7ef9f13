// Whole-gap Euler integration for training on Hopper (sm_90a): the forward
// with residuals and the reverse-loop backward.
//
// Replaces four TPU kernels of njode_tpu/ops/gap_scan.py: _fwd_kernel (line
// 134) and _fwd_kernel_ck (line 235) are one forward here, whose residual
// stride is 1 (every substep's entering state, row 2) or CK = 8 (every 8th,
// row 3); _bwd_kernel (line 422) and _bwd_kernel_ck (line 295) are one
// backward, which recomputes each stride-long segment from its checkpoint
// before walking it in reverse (nothing to recompute at stride 1).
//
// The substep (row 1's, gap_scan.cu), for every row (one gap) and network k:
//
//     pred = (t + dt) < t_tgt
//     pre  = s(h) W1h + base + t w1t        (W1h, W2 stored (in, out))
//     h    = pred ? h + dt (act(pre) W2 + b2) : h,   t = pred ? t + dt : t
//
// The backward, substep j from the last down (g: the cotangent of h):
//
//     g_dh  = pred ? dt g : 0          g_pre = (g_dh W2^T) act'(pre)
//     g    += (g_pre W1h^T) s'(h)
//     per row:    gpre_sum += g_pre,  acc_t += t g_pre,  gdh_sum += g_dh
//     over rows:  dW1h += s(h)^T g_pre,  dW2 += act(pre)^T g_dh
//
// The wrapper sums acc_t and gdh_sum over rows into the cotangents of w1t
// and b2, and gpre_sum is the cotangent of base (njode_tpu/ops/gap_scan.py
// :723-738).  t residuals are stored as their exact f32 bits (the TPU
// kernel packs them into a spare lane): the backward's predicates must
// reproduce the forward's bit for bit, which a recomputed t0 + j dt would
// not.
//
// What bounds it on the H100: by work, the f32 products, 4 d^2 flops per
// row, network and substep taken forward, and 10 d^2 backward (the
// pre-activation again, g_dh W2^T, g_pre W1h^T and the two weight sums)
// plus 2 d^2 for the recompute of a checkpointed segment's states, on the
// CUDA cores; device memory holds the inputs, the outputs, the residuals
// (n_res K R d floats) and the backward's scratch.  In practice the latency
// of the longest gaps of a launch: a row's substeps are a chain of dependent
// products, and the longest gap of a minibatch takes about 6x the mean
// (PERF.md, section 6).  What the design does about it, in both kernels:
// each row's substeps are counted by the loop's own float sequence and the
// rows sorted longest first on the device (section "the sort"); the long
// rows (at least long_num / long_den of the longest count) walk on groups of
// kGroup warps that split every product (group_mm), the rest one a warp
// (quarter_mm: the group's four row quarters added in the group's order),
// with no block barrier inside a row's walk.  Both kernels take each
// substep from one function, gap_substep (gap_cell.cuh), so a row's bits do
// not depend on its walker, on the other rows of the call or on the stride:
// the backward's rebuild of a checkpointed segment gives exactly the states
// the forward stored, and the pair at stride 1 and at stride 8 gives
// bitwise equal outputs.
//   * forward (rows 2-3, gap_fwd_kernel): one cooperative launch; after the
//     sort the groups take the long rows longest first from a counter, then
//     every warp takes the other rows one at a time from a second counter, so
//     no warp waits on a long neighbour; a walker keeps h and t in registers
//     and stores each checkpoint (and past the row's last substep its final
//     state) as it goes.  The device sort won the schedule A/B on an H100
//     (PERF.md section 6, row 3's design): 0.058 ms of device time at the
//     forced production minibatch (2,304 gaps, longest 63 substeps) against
//     0.078 ms at best for row 1's shape (gap_scan.cu: each block sorting a
//     strided sample of the rows in shared memory, no grid barrier), whose
//     blocks hold too few rows (about 17) to balance their long rows against
//     their short ones; a block an SM beat two, and the long threshold 1 / 2
//     beat 1 / 3, 1 / 4 and the longest key alone;
//   * backward (rows 4-5): segments of the sorted rows from the top down;
//     the weight cotangents leave the reverse loop as records of every
//     substep in a step buffer of one segment, which the whole grid sums
//     after a grid barrier into per-chunk accumulators in a fixed order (the
//     section "backward" below): a run repeats bitwise, with no float
//     atomics.
//
// Layout (f32, contiguous): h0, base, hout (K, R, d); t0, ttgt, tout (R,);
// w1h, w2 (K, d, d) as (in, out); w1t, b2 (K, d); res_h (n_res, K, R, d);
// res_t (n_res, R), n_res = ceil(n_sub / stride); ghL, gh0, gpre_sum,
// acc_t, gdh_sum (K, R, d); dw (K, 2, d, d) = [dW1h, dW2] as (in, out); the
// scratch as fwd_layout and bwd_layout say.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

#include "gap_cell.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace njode_gap;

constexpr int kMaxHidden = 128;     // 4 columns a lane
constexpr int kMaxStride = 64;
constexpr int kBwdWarps = 8;      // a block: two groups of kGroup warps, or 8 single warps
constexpr int kFwdWarps = 8;      // the forward's block, the same
constexpr int kGroup = 4;         // the warps of a long row
constexpr int kLongNum = 1, kLongDen = 2;  // long: count >= ceil(longest * 1 / 2)
constexpr int kBins = 1024;       // sort keys: the count, or the segment count past that
constexpr int kDwRows = 32;       // record rows a block stages at a time
constexpr int kTA = 4, kTB = 4;   // a sum thread's output tile
constexpr int kSegMin = 8;        // a segment: the multiple of the stride from CK = 8 up
// a block an SM: the backward's 190-255 registers a thread leave no room for
// a second
constexpr int kMaxBlocksPerSm = 1;
// the forward's blocks an SM: the plan's grid (its occupancy allowing)
constexpr int kFwdBlocksPerSm = 1;
constexpr int kMaxBlocks = 8 * kWarp * 8;  // the widest grid the plans give (2,048)
static_assert(kGroup == kGroupWarps, "quarter_mm adds the quarters of a group of kGroup warps");
static_assert(kFwdWarps == kBwdWarps, "the sort's scan is written for one block size");
enum Rec { kRecSh = 0, kRecGp = 1, kRecHid = 2, kRecGdh = 3 };

__host__ __device__ inline long long round32(long long x) { return (x + 31) / 32 * 32; }

// substeps a segment of the backward's walk (kSegMin's multiple of the stride)
__host__ __device__ inline int seg_of(int stride) {
  return (kSegMin + stride - 1) / stride * stride;
}

// the forward's sort keys: key = ceil(count / key_div), key_div 1 up to
// kBins - 1 substeps, else the backward's segment (so the two orders are
// one), widened by a whole factor where the segments outnumber the bins
__host__ __device__ inline int fwd_key_div(int n_sub, int stride) {
  if (n_sub + 1 <= kBins) return 1;
  const int L = seg_of(stride), n_seg = (n_sub + L - 1) / L;
  return L * ((n_seg + kBins - 2) / (kBins - 1));
}

// ------------------------------------------------------------------ the sort
//
// Both kernels sort the rows by their substep counts on the device, over
// one cooperative grid:
//   count: each block counts the substeps of a contiguous share of the rows
//     with the forward's own float sequence (t + dt < t_tgt, t += dt, from
//     t_last, whose bits res_t[0] stores) and histograms their keys;
//   rank: a key's rows are counted over the blocks in block order; each
//     block then ranks its rows longest first, by key and then by row (a
//     stable counting sort: ranks by prefix sums, no atomics decide an
//     order), into order / cs (the sorted rows and their counts).
// Scratch (ints): counts, sorted rows and their counts (R each), the keys'
// per-block counts (key-major) and totals.

struct SortLayout {
  long long cnt, order, cs, ghist, total, end;
};

__host__ __device__ inline SortLayout sort_layout(int R, int nbins, int blocks) {
  SortLayout S;
  long long o = 0;
  S.cnt = o;
  o += round32(R);
  S.order = o;
  o += round32(R);
  S.cs = o;
  o += round32(R);
  S.ghist = o;
  o += round32((long long)blocks * nbins);
  S.total = o;
  o += round32(nbins);
  S.end = o;
  return S;
}

// a row's substeps from t by the loop's own float sequence (t + dt <
// t_tgt, t += dt), at most n_sub
__device__ __forceinline__ int count_substeps(float t, float tt, float dt, int n_sub) {
  int c = 0;
  while (c < n_sub && t + dt < tt) {
    t += dt;
    ++c;
  }
  return c;
}

// this block's contiguous share [lo, hi) of the R rows
__device__ __forceinline__ void row_share(int R, int& lo, int& hi) {
  const int RB = (R + gridDim.x - 1) / gridDim.x;
  lo = min(R, (int)blockIdx.x * RB);
  hi = min(R, lo + RB);
}

// count: this block's rows counted (cnt) and their keys histogrammed into
// ghist (column blk of a key-major table).  Starts with __syncthreads (the
// caller's staging before it is then done) and ends before a grid barrier.
template <typename KeyOf>
__device__ void count_rows(const float* t_from, const float* ttgt, float dt, int n_sub, int R,
                           int nbins, int* cnt, int* ghist, int* s_key, KeyOf key_of) {
  constexpr int nthr = kWarp * kBwdWarps;
  const int tid = threadIdx.y * kWarp + threadIdx.x;
  for (int i = tid; i < nbins; i += nthr) s_key[i] = 0;
  int lo, hi;
  row_share(R, lo, hi);
  __syncthreads();
  for (int r = lo + tid; r < hi; r += nthr) {
    const int c = count_substeps(__ldg(t_from + r), __ldg(ttgt + r), dt, n_sub);
    cnt[r] = c;
    atomicAdd(&s_key[key_of(c)], 1);
  }
  __syncthreads();
  for (int i = tid; i < nbins; i += nthr) ghist[(size_t)i * gridDim.x + blockIdx.x] = s_key[i];
}

// rank, 1: each key's rows before each block (block order) and its total, a
// warp a key.  Between two grid barriers.
__device__ void rank_keys(int* ghist, int* total, int nbins) {
  const int lane = threadIdx.x, nb = gridDim.x;
  const int gw = blockIdx.x * kBwdWarps + threadIdx.y, n_gw = nb * kBwdWarps;
  for (int i = gw; i < nbins; i += n_gw) {
    int* row = ghist + (size_t)i * nb;
    int run = 0;
    for (int b0 = 0; b0 < nb; b0 += 8 * kWarp) {
      int v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int b = b0 + q * kWarp + lane;
        v[q] = b < nb ? __ldcg(row + b) : 0;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        int x = v[q];
#pragma unroll
        for (int off = 1; off < kWarp; off <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, off);
          if (lane >= off) x += y;
        }
        const int b = b0 + q * kWarp + lane;
        if (b < nb) row[b] = run + x - v[q];
        run += __shfl_sync(0xffffffffu, x, kWarp - 1);
      }
    }
    if (lane == 0) total[i] = run;
  }
}

// out[i] = sum_{j > i} in(j) for i < n <= kBins (in: the entries, read all
// before the first barrier, so out may be in's own shared array).  Ends
// with __syncthreads.
template <typename In>
__device__ void suffix_scan(In in, int* out, int n, int* warp_tot) {
  constexpr int nthr = kWarp * kBwdWarps, IPT = kBins / nthr;
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * kWarp + lane;
  int v[IPT], lt = 0;
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    const int b = tid * IPT + i;
    v[i] = b < n ? in(b) : 0;
    lt += v[i];
  }
  int x = lt;  // this lane's and the higher lanes' totals
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int y = __shfl_down_sync(0xffffffffu, x, off);
    if (lane + off < kWarp) x += y;
  }
  if (lane == 0) warp_tot[warp] = x;
  __syncthreads();
  int run = x - lt;
  for (int w = warp + 1; w < kBwdWarps; ++w) run += warp_tot[w];
#pragma unroll
  for (int i = IPT - 1; i >= 0; --i) {
    const int b = tid * IPT + i;
    if (b < n) out[b] = run;
    run += v[i];
  }
  __syncthreads();
}

// rank, 2, first part: the rows of longer keys before each key (s_key) and
// the longest key present (s_misc[8]).  Ends with __syncthreads.
__device__ void key_offsets(const int* total, int nbins, int* s_key, int* s_misc) {
  constexpr int nthr = kWarp * kBwdWarps;
  const int tid = threadIdx.y * kWarp + threadIdx.x;
  suffix_scan([&](int b) { return __ldcg(total + b); }, s_key, nbins, s_misc);
  if (tid == 0) s_misc[8] = 0;
  __syncthreads();
  for (int i = tid; i < nbins; i += nthr)
    if (__ldcg(total + i) > 0) atomicMax(&s_misc[8], i);
  __syncthreads();
}

// the long rows: those whose key is at least ceil(top * kLongNum /
// kLongDen) (top: the longest key), a prefix of the sorted order; s_key as
// key_offsets leaves it
__device__ __forceinline__ int long_rows(const int* s_key, int top) {
  const int thr = (top * kLongNum + kLongDen - 1) / kLongDen;
  return top > 0 ? s_key[max(thr, 1) - 1] : 0;
}

// rank, 2, last part: this block's rows at their ranks in order / cs (warp
// 0, 32 rows a round).  s_key as key_offsets leaves it.
template <typename KeyOf>
__device__ void place_rows(const int* ghist, const int* cnt, int* order, int* cs, int R,
                           int nbins, int* s_key, KeyOf key_of) {
  constexpr int nthr = kWarp * kBwdWarps;
  const int lane = threadIdx.x, tid = threadIdx.y * kWarp + lane;
  for (int i = tid; i < nbins; i += nthr)
    s_key[i] += __ldcg(ghist + (size_t)i * gridDim.x + blockIdx.x);
  __syncthreads();
  if (threadIdx.y != 0) return;
  int lo, hi;
  row_share(R, lo, hi);
  for (int r0 = lo; r0 < hi; r0 += kWarp) {
    const int r = r0 + lane;
    const bool in = r < hi;
    const int c = in ? __ldcg(cnt + r) : 0;
    const int key = in ? key_of(c) : -1;
    const unsigned m = __match_any_sync(0xffffffffu, key);
    if (in) {
      const int pos = s_key[key] + __popc(m & ((1u << lane) - 1u));
      order[pos] = r;
      cs[pos] = c;
    }
    __syncwarp();
    if (in && lane == __ffs(m) - 1) s_key[key] += __popc(m);
    __syncwarp();
  }
}

// The W1h and W2 planes of network kb into shared memory (HP x (HP + 1),
// zero past d), four entries a thread at a time, their loads issued
// together.  The caller's next __syncthreads publishes them.
template <int CPT>
__device__ __forceinline__ void stage_planes(const float* w1h, const float* w2, int kb, int d, float* sW1,
                             float* sW2) {
  constexpr int HP = kWarp * CPT, LDP = HP + 1, PL = HP * LDP;
  constexpr int nthr = kWarp * kBwdWarps;
  const int tid = threadIdx.y * kWarp + threadIdx.x;
  const float* W1 = w1h + (size_t)kb * d * d;
  const float* W2 = w2 + (size_t)kb * d * d;
  for (int e0 = tid; e0 < PL; e0 += 4 * nthr) {
    float v1[4], v2[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * nthr, i = e / LDP, j = e - i * LDP;
      const bool in = e < PL && i < d && j < d;
      v1[u] = in ? __ldg(W1 + i * d + j) : 0.0f;
      v2[u] = in ? __ldg(W2 + i * d + j) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u * nthr < PL) {
        sW1[e0 + u * nthr] = v1[u];
        sW2[e0 + u * nthr] = v2[u];
      }
  }
}

// stage_planes at 4 columns a lane as a call, for the backward: inlined, one
// of its two instances spilled 12 bytes at the 255-register cap (as a call
// at 2 columns a lane too, the backward took 1-2% longer on an H100)
__device__ __noinline__ void stage_planes_4(const float* w1h, const float* w2, int kb, int d,
                                            float* sW1, float* sW2) {
  stage_planes<4>(w1h, w2, kb, d, sW1, sW2);
}

// warp's group of kGroup warps (its rows of each plane, its named barrier,
// its two partial-product buffers)
template <int CPT>
__device__ __forceinline__ Group make_group(int warp, float* part, int d) {
  constexpr int HP = kWarp * CPT, Q = HP / kGroup;
  Group gr;
  gr.wpt = kGroup;
  gr.wg = warp % kGroup;
  gr.bar_id = 1 + warp / kGroup;
  gr.bar_n = kWarp * kGroup;
  gr.r_lo = gr.wg * Q;
  gr.r_hi = min(gr.r_lo + Q, (d + 15) / 16 * 16);
  gr.par = 0;
  gr.part = part + (warp / kGroup) * 2 * kGroup * HP;
  return gr;
}

// ---------------------------------------------------------------- forward
//
// One cooperative launch (grid.sync() separates the sort's phases):
//   sort: the rows counted, ranked longest first into order / cs, the long
//     rows (a prefix) counted;
//   walk: a network's blocks walk its rows: each group of kGroup warps takes
//     the next long row from the network's first counter until none is
//     left, then every warp takes the next row from its second counter, one
//     row a warp, until none is left.  A walker loads the row's h0, base and
//     t0, takes its counted substeps by gap_substep, stores checkpoint m (h
//     and t entering substep m stride) as it reaches it and, past the last
//     substep, the final state into the checkpoints left; then h_L and t_L.
//     Each store is one warp's (a group's first), 32 consecutive floats a
//     warp instruction.
//
// Scratch (ints): fwd_layout below, mirrored by gap_fwd_plan in
// ops/gap_scan.py, which is checked here.

struct FwdLayout {
  SortLayout S;
  long long ctr, ints;
};

// the sort's scratch, then two counters a network
__host__ __device__ inline FwdLayout fwd_layout(int K, int R, int nbins, int blocks) {
  FwdLayout L;
  L.S = sort_layout(R, nbins, blocks);
  L.ctr = L.S.end;
  L.ints = L.ctr + round32(2LL * K);
  return L;
}

// shared floats: the W1h and W2 planes, the two groups' partial-product
// buffers, each warp's vector of a single-warp product, the sort's keys, and
// 32 words of the scan and the groups' slots
size_t fwd_smem_bytes(int d) {
  const size_t hp = plane_rows(d);
  return (2 * hp * (hp + 1) + (size_t)(kFwdWarps / kGroup) * 2 * kGroup * hp +
          (size_t)kFwdWarps * hp + kBins + 32) *
         sizeof(float);
}

struct FwdArgs {
  const float *h0, *base, *t0, *ttgt, *w1h, *w1t, *w2, *b2;
  float *hout, *tout, *res_h, *res_t;
  int* scratch;
  int K, R, d, n_sub, stride, n_res, act, scale, nbins, key_div;
  float dt;
  FwdLayout L;
};

template <int CPT, bool RI>
__global__ void __launch_bounds__(kWarp * kFwdWarps, kFwdBlocksPerSm)
gap_fwd_kernel(const FwdArgs a) {
  constexpr int HP = kWarp * CPT, LDP = HP + 1, PL = HP * LDP;
  constexpr int nthr = kWarp * kFwdWarps;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * kWarp + lane;
  const int blk = blockIdx.x;
  const int K = a.K, R = a.R, d = a.d, stride = a.stride, n_res = a.n_res;
  const float dt = a.dt;
  float* sW1 = smem;
  float* sW2 = smem + PL;
  float* part = smem + 2 * PL;
  float* xs_all = part + (kFwdWarps / kGroup) * 2 * kGroup * HP;
  int* s_key = reinterpret_cast<int*>(xs_all + kFwdWarps * HP);
  // [0, 8) scan, 8 longest key, 9 long rows, 16-19 the groups' row slots
  int* s_misc = s_key + kBins;
  const int kb = blk % K;
  const Pointwise<RI> pw{a.act, a.scale};
  auto key_of = [&](int c) { return (c + a.key_div - 1) / a.key_div; };
  stage_planes<CPT>(a.w1h, a.w2, kb, d, sW1, sW2);
  float w1t_r[CPT], b2_r[CPT];
  vec_regs<CPT>(a.w1t + (size_t)kb * d, d, lane, w1t_r);
  vec_regs<CPT>(a.b2 + (size_t)kb * d, d, lane, b2_r);
  Group gr = make_group<CPT>(warp, part, d);

  // row r's walk of its n_t substeps, on this warp's group or on this warp
  auto walk = [&](int r, int n_t, bool on_group) {
    const Walker<CPT> wk{on_group, &gr, xs_all + warp * HP, d, lane};
    const bool writer = !on_group || gr.wg == 0;
    const size_t g = ((size_t)kb * R + r) * d;
    float h[CPT], bs[CPT];
    float t = __ldg(a.t0 + r);
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int j = lane + kWarp * q;
      const bool in = j < d;
      h[q] = in ? __ldg(a.h0 + g + j) : 0.0f;
      bs[q] = in ? __ldg(a.base + g + j) : 0.0f;
    }
    auto put = [&](float* dst_h, float* dst_t) {
      if (!writer) return;
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int j = lane + kWarp * q;
        if (j < d) dst_h[j] = h[q];
      }
      if (kb == 0 && lane == 0) *dst_t = t;
    };
    auto checkpoint = [&](int m) {
      put(a.res_h + (((size_t)m * K + kb) * R + r) * d, a.res_t + (size_t)m * R + r);
    };
    int m = 0;
    for (int j = 0; j < n_t; ++j) {
      if (j == m * stride) checkpoint(m++);
      gap_substep<CPT, RI>(h, t, true, bs, w1t_r, b2_r, sW1, sW2, dt, wk, pw,
                           [](int, float) {});
    }
    // the checkpoints past the row's last substep hold its final state
    for (; m < n_res; ++m) checkpoint(m);
    put(a.hout + g, a.tout + r);
  };

  cg::grid_group grid = cg::this_grid();
  int* cnt = a.scratch + a.L.S.cnt;
  int* order = a.scratch + a.L.S.order;
  int* cs = a.scratch + a.L.S.cs;
  int* ghist = a.scratch + a.L.S.ghist;
  int* total = a.scratch + a.L.S.total;
  int* ctr = a.scratch + a.L.ctr;
  count_rows(a.t0, a.ttgt, dt, a.n_sub, R, a.nbins, cnt, ghist, s_key, key_of);
  if (blk == 0)
    for (int i = tid; i < 2 * K; i += nthr) ctr[i] = 0;
  grid.sync();
  rank_keys(ghist, total, a.nbins);
  grid.sync();
  key_offsets(total, a.nbins, s_key, s_misc);
  if (tid == 0) s_misc[9] = long_rows(s_key, s_misc[8]);
  __syncthreads();
  const int n_long = s_misc[9];
  place_rows(ghist, cnt, order, cs, R, a.nbins, s_key, key_of);
  grid.sync();

  // the long rows on groups, from the network's first counter, then every
  // row left one a warp, from its second
  int* slot = s_misc + 16 + 2 * (warp / kGroup);  // a row a group, two in turn
  for (int par = 0;; par ^= 1) {
    if (gr.wg == 0 && lane == 0) slot[par] = atomicAdd(ctr + 2 * kb, 1);
    group_sync(gr.bar_id, gr.bar_n);
    const int p = slot[par];
    if (p >= n_long) break;
    walk(__ldcg(order + p), __ldcg(cs + p), true);
  }
  for (;;) {
    int p = 0;
    if (lane == 0) p = atomicAdd(ctr + 2 * kb + 1, 1);
    p = __shfl_sync(0xffffffffu, p, 0) + n_long;
    if (p >= R) break;
    walk(__ldcg(order + p), __ldcg(cs + p), false);
  }
}

// --------------------------------------------------------------- backward
//
// One cooperative launch; grid.sync() separates its phases.
//
//   count and rank: the sort (above), from res_t[0], keyed by the count, or
//     past kBins - 1 substeps the segment count;
//   walk, segment by segment from the top down (a segment: L substeps, the
//     residual stride's multiple from kSegMin up, so 8 at stride 1 and 8):
//     in segment s the rows whose count passes s * L (a prefix of the
//     sorted order) each rebuild the segment's states (the stored ones
//     loaded, the others recomputed with the forward's substep), keeping
//     every substep's state and pre-activation, then walk it in reverse
//     with two products a substep (g_dh W2^T, g_pre W1h^T), adding the row
//     sums into their outputs and writing the records [s(h), g_pre,
//     act(pre), g_dh] of substep c at (c, sorted row p) of step buffer s & 1
//     (zeros for the segment's substeps the row does not take).  A network's
//     blocks walk its rows: the long rows (at least kLongNum / kLongDen of
//     the longest count) one a group of kGroup warps that split every
//     product by input rows (group_mm), the rest one a warp; a single warp
//     computes the group's four row quarters and adds them in the group's
//     order, so a row's arithmetic is the same on either;
//   sums: after the walk of segment s, the whole grid adds segment s + 1's
//     records (the other buffer) into its chunk accumulators: job (chunk j
//     of chunk_rows sorted rows, network, matrix) belongs to block blocks -
//     1 - job % blocks in every segment, each output entry to one thread of
//     it, so acc_j is a sum over the segments from the top down; after
//     segment 0, dw = sum_j acc_j in chunk order.  No float atomics: two
//     calls are bitwise equal.
//
// Scratch (floats; the int arrays share it): bwd_layout below, mirrored by
// gap_bwd_plan in ops/gap_scan.py, which is checked here.

struct BwdLayout {
  long long cnt, order, cs, ghist, total, rec, rec_buf, acc, seg, seg_warp, floats;
};

// the sort's scratch, the two step buffers (K x 4 records x seg x R x d
// each), the chunk accumulators (chunks x K x 2 d^2), each warp's segment
// states (seg x (h, pre: HP each; t: a lane each))
__host__ __device__ inline BwdLayout bwd_layout(int K, int R, int d, int seg, int nbins,
                                                int blocks, int chunks) {
  BwdLayout L;
  const SortLayout S = sort_layout(R, nbins, blocks);
  L.cnt = S.cnt;
  L.order = S.order;
  L.cs = S.cs;
  L.ghist = S.ghist;
  L.total = S.total;
  long long o = S.end;
  L.rec_buf = (long long)K * 4 * seg * R * d;
  L.rec = o;
  o += round32(2 * L.rec_buf);
  L.acc = o;
  o += round32((long long)chunks * K * 2 * d * d);
  L.seg_warp = (long long)seg * (2 * plane_rows(d) + kWarp);
  L.seg = o;
  o += (long long)blocks * kBwdWarps * L.seg_warp;
  L.floats = o;
  return L;
}
__host__ __device__ inline int dw_ld(int d) { return (d + 7) / 8 * 8; }

// shared floats: the W1h and W2 planes (HP x (HP + 1), zero past d), the two
// groups' partial-product buffers, the sums' staged rows (A and G), each
// warp's vector of a single-warp product, the sort's keys (bases, then this
// block's offsets), the segments' active rows, and 32 words of the scan and
// the plan
size_t bwd_smem_bytes(int d) {
  const size_t hp = plane_rows(d);
  return (2 * hp * (hp + 1) + (size_t)(kBwdWarps / kGroup) * 2 * kGroup * hp +
          2 * (size_t)kDwRows * dw_ld(d) + (size_t)kBwdWarps * hp + 2 * (size_t)kBins + 32) *
         sizeof(float);
}

struct BwdArgs {
  const float *ghL, *base, *ttgt, *w1h, *w1t, *w2, *b2, *res_h, *res_t;
  float *gh0, *gpre_sum, *acct, *gdh_sum, *dw, *scratch;
  int K, R, d, n_sub, stride, seg, n_seg, act, scale, nbins, key_seg, chunk_rows;
  float dt;
  BwdLayout L;
};

template <int CPT, bool RI>
__global__ void __launch_bounds__(kWarp * kBwdWarps, 1) gap_bwd_kernel(const BwdArgs a) {
  constexpr int HP = kWarp * CPT, LDP = HP + 1, PL = HP * LDP;
  // output tiles a thread in a pass over a job's rows, and the passes: d 128
  // has 32 x 32 tiles, in two passes of two a thread (the registers)
  constexpr int TPT = CPT == 4 ? 2 : 1, NPASS = CPT == 4 ? 2 : 1;
  constexpr int nthr = kWarp * kBwdWarps;
  constexpr int SE = kDwRows * HP / nthr;  // staged entries a thread (ld <= HP)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * kWarp + lane;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int K = a.K, R = a.R, d = a.d, stride = a.stride, n_sub = a.n_sub, nbins = a.nbins;
  const int L = a.seg;  // substeps a segment, a multiple of the residual stride
  const int CHR = a.chunk_rows;
  const float dt = a.dt;
  const size_t dd = (size_t)d * d;
  const int ld = dw_ld(d);
  float* sW1 = smem;
  float* sW2 = smem + PL;
  float* part = smem + 2 * PL;
  float* sA = part + (kBwdWarps / kGroup) * 2 * kGroup * HP;
  float* sG = sA + kDwRows * ld;
  float* xs = sG + kDwRows * ld + warp * HP;  // this warp's vector (quarter_mm)
  int* s_key = reinterpret_cast<int*>(sG + kDwRows * ld + kBwdWarps * HP);
  int* s_nact = s_key + kBins;
  int* s_misc = s_nact + kBins;  // [0, 8) scan, 8 longest key, 9 long rows, 10 top segment
  int* cnt = reinterpret_cast<int*>(a.scratch + a.L.cnt);
  int* order = reinterpret_cast<int*>(a.scratch + a.L.order);
  int* cs = reinterpret_cast<int*>(a.scratch + a.L.cs);
  int* ghist = reinterpret_cast<int*>(a.scratch + a.L.ghist);
  int* total = reinterpret_cast<int*>(a.scratch + a.L.total);
  float* rec = a.scratch + a.L.rec;
  float* accg = a.scratch + a.L.acc;
  auto key_of = [&](int c) { return a.key_seg ? (c + L - 1) / L : c; };
  const Pointwise<RI> pw{a.act, a.scale};

  // ---- count: outputs initialised (rows that take no substep keep them),
  // this block's rows counted, its key histogram, the network's planes
  const size_t KRd = (size_t)K * R * d;
  for (size_t e = (size_t)blk * nthr + tid; e < KRd; e += (size_t)nb * nthr) {
    a.gh0[e] = __ldg(a.ghL + e);
    a.gpre_sum[e] = a.acct[e] = a.gdh_sum[e] = 0.0f;
  }
  const int kb = blk % K, bi = blk / K, nbk = (nb - kb + K - 1) / K;
  if constexpr (CPT == 4) stage_planes_4(a.w1h, a.w2, kb, d, sW1, sW2);
  else stage_planes<CPT>(a.w1h, a.w2, kb, d, sW1, sW2);
  count_rows(a.res_t, a.ttgt, dt, n_sub, R, nbins, cnt, ghist, s_key, key_of);
  grid.sync();

  // ---- rank, 1
  rank_keys(ghist, total, nbins);
  grid.sync();

  // ---- rank, 2: the rows of longer keys before each key; the segments'
  // active rows; the long rows; this block's ranks
  key_offsets(total, nbins, s_key, s_misc);
  for (int s = tid; s < a.n_seg; s += nthr) s_nact[s] = s_key[key_of(s * L)];
  __syncthreads();
  if (tid == 0) {
    s_misc[9] = long_rows(s_key, s_misc[8]);
    int s_top = -1;
    for (int s = a.n_seg - 1; s >= 0; --s)
      if (s_nact[s] > 0) {
        s_top = s;
        break;
      }
    s_misc[10] = s_top;
  }
  __syncthreads();
  place_rows(ghist, cnt, order, cs, R, nbins, s_key, key_of);
  const int n_long = s_misc[9], s_top = s_misc[10];
  grid.sync();

  // ---- the walkers of this block (network kb): the network's first nbg
  // blocks walk the long rows, a group each (round robin over their groups);
  // then every warp of the network's blocks walks the short rows, one a
  // warp, round robin over the other blocks' warps and then the group
  // blocks' (which take short rows only where they outnumber the others)
  constexpr int GPB = kBwdWarps / kGroup;
  const int nbg = min(nbk, (n_long + GPB - 1) / GPB);
  const bool grouped = bi < nbg;
  const int g_id = bi * GPB + warp / kGroup, g_n = nbg * GPB;
  const int w_id = (grouped ? bi + nbk - nbg : bi - nbg) * kBwdWarps + warp;
  const int w_n = nbk * kBwdWarps;
  Group gr = make_group<CPT>(warp, part, d);
  float w1t_r[CPT], b2_r[CPT];
  vec_regs<CPT>(a.w1t + (size_t)kb * d, d, lane, w1t_r);
  vec_regs<CPT>(a.b2 + (size_t)kb * d, d, lane, b2_r);
  float* states = a.scratch + a.L.seg + (size_t)(blk * kBwdWarps + warp) * a.L.seg_warp;
  constexpr int SLOT = 2 * HP + kWarp;
  auto walk = [&](int p, int s, int n_c, float* rbuf, bool on_group) {
    // each record and output by one warp of a group
    const int wg = on_group ? gr.wg : 0;
    auto writes = [&](int kind) { return !on_group || wg == kind; };
    const int r = __ldcg(order + p);
    const int n_t = min(__ldcg(cs + p) - s * L, n_c);
    const size_t g = ((size_t)kb * R + r) * d;
    // the stored state entering substep j0 (a multiple of the stride)
    auto load_state = [&](int j0, float (&hv)[CPT], float& tv) {
      const float* ck = a.res_h + (((size_t)(j0 / stride) * K + kb) * R + r) * d;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = lane + kWarp * c;
        hv[c] = j < d ? __ldg(ck + j) : 0.0f;
      }
      tv = __ldg(a.res_t + (size_t)(j0 / stride) * R + r);
    };
    float h[CPT], bs[CPT], gh[CPT], gps[CPT], ats[CPT], gds[CPT], t;
    load_state(s * L, h, t);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + kWarp * c;
      const bool in = j < d;
      bs[c] = in ? __ldg(a.base + g + j) : 0.0f;
      gh[c] = in ? __ldcg(a.gh0 + g + j) : 0.0f;
      gps[c] = in ? __ldcg(a.gpre_sum + g + j) : 0.0f;
      ats[c] = in ? __ldcg(a.acct + g + j) : 0.0f;
      gds[c] = in ? __ldcg(a.gdh_sum + g + j) : 0.0f;
    }
    // the segment's states and pre-activations: the stored ones loaded (a
    // substep ahead), the others recomputed with the forward's substep
    const Walker<CPT> wk{on_group, &gr, xs, d, lane};
    for (int c = 0; c < n_t; ++c) {
      float hs[CPT], ts = 0.0f;
      const int j1 = s * L + c + 1;
      const bool stored = j1 % stride == 0;
      if (stored && c + 1 < n_t) load_state(j1, hs, ts);
      float* slot = states + (size_t)c * SLOT;
      // the substep's state and pre-activation kept as its pre is formed
      gap_substep<CPT, RI>(h, t, c + 1 < n_t && !stored, bs, w1t_r, b2_r, sW1, sW2, dt, wk, pw,
                           [&](int q, float pre) {
                             slot[lane + kWarp * q] = h[q];
                             slot[HP + lane + kWarp * q] = pre;
                             if (q == CPT - 1) slot[2 * HP + lane] = t;
                           });
      if (c + 1 < n_t && stored) {
#pragma unroll
        for (int q = 0; q < CPT; ++q) h[q] = hs[q];
        t = ts;
      }
    }
    // the segment in reverse; substep c - 1's state loaded during substep c
    auto rec_row = [&](int kind, int c) {
      return rbuf + ((((size_t)kb * 4 + kind) * L + c) * R + p) * d;
    };
    float hc[CPT], pc[CPT], tc;
    {
      const float* slot = states + (size_t)(n_t - 1) * SLOT;
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        hc[q] = __ldcg(slot + lane + kWarp * q);
        pc[q] = __ldcg(slot + HP + lane + kWarp * q);
      }
      tc = __ldcg(slot + 2 * HP + lane);
    }
    for (int c = n_t - 1; c >= 0; --c) {
      float hn[CPT], pn[CPT], tn = 0.0f;
      if (c > 0) {
        const float* slot = states + (size_t)(c - 1) * SLOT;
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          hn[q] = __ldcg(slot + lane + kWarp * q);
          pn[q] = __ldcg(slot + HP + lane + kWarp * q);
        }
        tn = __ldcg(slot + 2 * HP + lane);
      }
      float gdh[CPT], gp[CPT], acc[CPT];
#pragma unroll
      for (int q = 0; q < CPT; ++q) gdh[q] = dt * gh[q];
      if (on_group) group_mm<CPT, true, false>(gdh, sW2, LDP, d, lane, gr, acc);
      else quarter_mm<CPT, true>(gdh, sW2, LDP, d, lane, xs, acc);
#pragma unroll
      for (int q = 0; q < CPT; ++q) gp[q] = acc[q] * pw.actg(pc[q]);
      if (on_group) group_mm<CPT, true, false>(gp, sW1, LDP, d, lane, gr, acc);
      else quarter_mm<CPT, true>(gp, sW1, LDP, d, lane, xs, acc);
      float* o_sh = rec_row(kRecSh, c);
      float* o_gp = rec_row(kRecGp, c);
      float* o_hid = rec_row(kRecHid, c);
      float* o_gdh = rec_row(kRecGdh, c);
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int j = lane + kWarp * q;
        gh[q] = fmaf(acc[q], pw.sclg(hc[q]), gh[q]);
        gps[q] += gp[q];
        ats[q] = fmaf(tc, gp[q], ats[q]);
        gds[q] += gdh[q];
        if (j < d) {
          if (writes(kRecSh)) o_sh[j] = pw.scl(hc[q]);
          if (writes(kRecGp)) o_gp[j] = gp[q];
          if (writes(kRecHid)) o_hid[j] = pw.actf(pc[q]);
          if (writes(kRecGdh)) o_gdh[j] = gdh[q];
        }
      }
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        hc[q] = hn[q];
        pc[q] = pn[q];
      }
      tc = tn;
    }
    // the segment's substeps this row does not take add exactly zero
    for (int c = n_t; c < n_c; ++c)
      for (int kind = 0; kind < 4; ++kind)
        if (writes(kind)) {
          float* o = rec_row(kind, c);
          for (int j = lane; j < d; j += kWarp) o[j] = 0.0f;
        }
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int j = lane + kWarp * q;
      if (j < d && wg == 0) {
        a.gh0[g + j] = gh[q];
        a.gpre_sum[g + j] = gps[q];
        a.acct[g + j] = ats[q];
        a.gdh_sum[g + j] = gds[q];
      }
    }
  };

  // the records of segment s2 into the chunk accumulators
  auto sums = [&](int s2) {
    const int na = s_nact[s2], n_c = min(L, n_sub - s2 * L);
    const float* rb = rec + (size_t)(s2 & 1) * a.L.rec_buf;
    const int nch = (na + CHR - 1) / CHR, jobs = nch * K * 2;
    const int ntb = (d + kTB - 1) / kTB, ntiles = (d + kTA - 1) / kTA * ntb;
    // job % nb runs on block nb - 1 - job % nb: the first jobs (the longest
    // rows' chunk) on the last blocks, which walk the short rows
    for (int job = nb - 1 - blk; job < jobs; job += nb) {
      const int j = job / (2 * K), k = job / 2 % K, m = job % 2;
      const int p0 = j * CHR, np = min(CHR, na - p0);
      const float* A = rb + ((size_t)k * 4 + (m ? kRecHid : kRecSh)) * L * R * d;
      const float* G = rb + ((size_t)k * 4 + (m ? kRecGdh : kRecGp)) * L * R * d;
      for (int pass = 0; pass < NPASS; ++pass) {
      float acc[TPT][kTA][kTB];
#pragma unroll
      for (int u = 0; u < TPT; ++u)
#pragma unroll
        for (int x = 0; x < kTA; ++x)
#pragma unroll
          for (int y = 0; y < kTB; ++y) acc[u][x][y] = 0.0f;
      // a round: up to kDwRows sorted rows of one substep c, in (c, p)
      // order; the next round loaded into registers while this one is
      // summed
      const int nrb = (np + kDwRows - 1) / kDwRows, rounds = n_c * nrb;
      float na_[SE], ng_[SE];
      auto fetch = [&](int rd) {
        const int c = rd / nrb, pb = (rd - c * nrb) * kDwRows;
        const int nr = min(kDwRows, np - pb);
        const size_t row0 = (size_t)c * R + p0 + pb;
#pragma unroll
        for (int u = 0; u < SE; ++u) {
          const int e = tid + u * nthr, rr = e / ld, col = e - rr * ld;
          float va = 0.0f, vg = 0.0f;
          if (rr < nr && col < d) {
            const size_t off = (row0 + rr) * d + col;
            va = __ldcg(A + off);
            vg = __ldcg(G + off);
          }
          na_[u] = va;
          ng_[u] = vg;
        }
        return nr;
      };
      int nr_next = fetch(0);
      for (int rd = 0; rd < rounds; ++rd) {
        const int nr = nr_next;
        __syncthreads();  // the last rows are consumed
#pragma unroll
        for (int u = 0; u < SE; ++u) {
          const int e = tid + u * nthr;
          if (e < kDwRows * ld) {
            sA[e] = na_[u];
            sG[e] = ng_[u];
          }
        }
        __syncthreads();
        if (rd + 1 < rounds) nr_next = fetch(rd + 1);
#pragma unroll
        for (int u = 0; u < TPT; ++u) {
          const int tile = tid + (pass * TPT + u) * nthr;
          if (tile >= ntiles) continue;
          const int ta = tile / ntb, tb = tile - ta * ntb;
#pragma unroll 4
          for (int rr = 0; rr < nr; ++rr) {
            const float4 av = *reinterpret_cast<const float4*>(sA + rr * ld + kTA * ta);
            const float4 gv = *reinterpret_cast<const float4*>(sG + rr * ld + kTB * tb);
            const float a4[kTA] = {av.x, av.y, av.z, av.w};
            const float g8[kTB] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
            for (int x = 0; x < kTA; ++x)
#pragma unroll
              for (int y = 0; y < kTB; ++y) acc[u][x][y] = fmaf(a4[x], g8[y], acc[u][x][y]);
          }
        }
      }
      // the chunk's first segment (from the top) writes, the others add
      const bool first = s2 == s_top || s_nact[s2 + 1] <= p0;
      float* out = accg + (((size_t)j * K + k) * 2 + m) * dd;
#pragma unroll
      for (int u = 0; u < TPT; ++u) {
        const int tile = tid + (pass * TPT + u) * nthr;
        if (tile >= ntiles) continue;
        const int ta = tile / ntb, tb = tile - ta * ntb;
#pragma unroll
        for (int x = 0; x < kTA; ++x) {
          const int ra = kTA * ta + x;
          if (ra >= d) break;
#pragma unroll
          for (int y = 0; y < kTB; ++y) {
            const int cc = kTB * tb + y;
            if (cc < d) {
              float* o = out + (size_t)ra * d + cc;
              *o = first ? acc[u][x][y] : __ldcg(o) + acc[u][x][y];
            }
          }
        }
      }
      }
    }
  };

  // ---- the segments from the top down: walk s, then segment s + 1's sums
  for (int s = s_top; s >= 0; --s) {
    const int na = s_nact[s], n_c = min(L, n_sub - s * L);
    float* rbuf = rec + (size_t)(s & 1) * a.L.rec_buf;
    if (grouped)
      for (int p = g_id; p < min(na, n_long); p += g_n) walk(p, s, n_c, rbuf, true);
    for (int p = n_long + w_id; p < na; p += w_n) walk(p, s, n_c, rbuf, false);
    if (s < s_top) sums(s + 1);
    grid.sync();
  }
  if (s_top >= 0) {
    sums(0);
    grid.sync();
  }
  // ---- dw = the chunks' accumulators in chunk order, an entry a thread
  const int nch0 = s_top >= 0 ? (s_nact[0] + CHR - 1) / CHR : 0;
  const size_t n_out = (size_t)K * 2 * dd, step = (size_t)K * 2 * dd;
  for (size_t e = (size_t)blk * nthr + tid; e < n_out; e += (size_t)nb * nthr) {
    float sum = 0.0f;
    for (int j = 0; j < nch0; ++j) sum += __ldcg(accg + j * step + e);
    a.dw[e] = sum;
  }
}

bool bad_args(int K, int R, int d, float dt, int n_sub, int stride, int act, int scale) {
  return K < 1 || K > 65535 || R < 1 || d < 1 || d > kMaxHidden || !(dt > 0.0f) ||
         n_sub < 1 || stride < 1 || stride > kMaxStride || act < 0 || act > kSelu ||
         scale < 0 || scale > kScaleSigmoid;
}

// blocks an SM of a kernel's instances for width d (cooperative residency;
// the fewest of the instances), cached per device and width.  Each
// instance's shared-memory limit is set once, at its widest width, so that a
// narrower width's query never lowers it.
template <int CPT>
cudaError_t bwd_occupancy(int d, int* per_sm) {
  const size_t smem_max = bwd_smem_bytes(CPT == 2 ? 64 : kMaxHidden), smem = bwd_smem_bytes(d);
  int n0 = 0, n1 = 0;
  cudaError_t e = set_smem(gap_bwd_kernel<CPT, false>, smem_max);
  if (e == cudaSuccess) e = set_smem(gap_bwd_kernel<CPT, true>, smem_max);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n0, gap_bwd_kernel<CPT, false>,
                                                      kWarp * kBwdWarps, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n1, gap_bwd_kernel<CPT, true>,
                                                      kWarp * kBwdWarps, smem);
  *per_sm = min(n0, n1);
  return e;
}

template <int CPT>
cudaError_t fwd_occupancy(int d, int* per_sm) {
  const size_t smem_max = fwd_smem_bytes(CPT == 2 ? 64 : kMaxHidden), smem = fwd_smem_bytes(d);
  int n0 = 0, n1 = 0;
  cudaError_t e = set_smem(gap_fwd_kernel<CPT, false>, smem_max);
  if (e == cudaSuccess) e = set_smem(gap_fwd_kernel<CPT, true>, smem_max);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n0, gap_fwd_kernel<CPT, false>,
                                                      kWarp * kFwdWarps, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n1, gap_fwd_kernel<CPT, true>,
                                                      kWarp * kFwdWarps, smem);
  *per_sm = min(n0, n1);
  return e;
}

// kernel 0: the backward, 1: the forward
int per_sm_of(int kernel, int d, int* per_sm, int* n_sm) {
  // one entry a kernel, device and width, read and written under the lock
  static std::mutex mu;
  static int cache[2][8][kMaxHidden + 1][2];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 8 && cache[kernel][dev][d][0] > 0) {
    *per_sm = cache[kernel][dev][d][0];
    *n_sm = cache[kernel][dev][d][1];
    return 0;
  }
  e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  const bool narrow = plane_rows(d) == 64;
  if (e == cudaSuccess) {
    if (kernel == 0) e = narrow ? bwd_occupancy<2>(d, per_sm) : bwd_occupancy<4>(d, per_sm);
    else e = narrow ? fwd_occupancy<2>(d, per_sm) : fwd_occupancy<4>(d, per_sm);
  }
  if (e != cudaSuccess) return (int)e;
  if (dev < 8) {
    cache[kernel][dev][d][0] = *per_sm;
    cache[kernel][dev][d][1] = *n_sm;
  }
  return 0;
}

// a kernel's grid: its resident blocks an SM, at most cap, times the SMs
int grid_of(int kernel, int d, int cap, int* blocks) {
  if (d < 1 || d > kMaxHidden) return (int)cudaErrorInvalidValue;
  int per_sm = 0, n_sm = 0;
  const int err = per_sm_of(kernel, d, &per_sm, &n_sm);
  if (err != 0) return err;
  *blocks = min(min(per_sm, cap) * n_sm, kMaxBlocks);
  return *blocks > 0 ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

// The forward's grid: blocks an SM (kFwdBlocksPerSm, the occupancy of its
// instances for width d allowing) times the SMs; every block is resident,
// as the cooperative launch needs.
extern "C" int njode_gap_train_fwd_grid(int d, int* blocks) {
  return grid_of(1, d, kFwdBlocksPerSm, blocks);
}

// The forward with residuals (stride 1: row 2, stride 8: row 3), one
// cooperative launch on `stream`.  plan = [blocks, nbins, key_div]
// (gap_fwd_plan in ops/gap_scan.py); scratch holds scratch_ints ints
// (fwd_layout).  Returns the CUDA error (0 on success).
extern "C" int njode_gap_train_fwd(const void* h0, const void* base, const void* t0,
                                   const void* ttgt, const void* w1h, const void* w1t,
                                   const void* w2, const void* b2, void* hout, void* tout,
                                   void* res_h, void* res_t, void* scratch,
                                   long long scratch_ints, int K, int R, int d, float dt,
                                   int n_sub, int stride, int act, int scale, const int* plan,
                                   void* stream) {
  if (bad_args(K, R, d, dt, n_sub, stride, act, scale)) return (int)cudaErrorInvalidValue;
  const int blocks = plan[0], nbins = plan[1], key_div = plan[2];
  const int kd = fwd_key_div(n_sub, stride);
  if (key_div != kd || nbins != (n_sub + kd - 1) / kd + 1 || nbins > kBins || blocks < K ||
      blocks > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  int resident = 0;
  int err = grid_of(1, d, kFwdBlocksPerSm, &resident);
  if (err != 0) return err;
  if (blocks > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  FwdArgs args;
  args.L = fwd_layout(K, R, nbins, blocks);
  if (scratch_ints < args.L.ints) return (int)cudaErrorInvalidValue;
  args.h0 = static_cast<const float*>(h0);
  args.base = static_cast<const float*>(base);
  args.t0 = static_cast<const float*>(t0);
  args.ttgt = static_cast<const float*>(ttgt);
  args.w1h = static_cast<const float*>(w1h);
  args.w1t = static_cast<const float*>(w1t);
  args.w2 = static_cast<const float*>(w2);
  args.b2 = static_cast<const float*>(b2);
  args.hout = static_cast<float*>(hout);
  args.tout = static_cast<float*>(tout);
  args.res_h = static_cast<float*>(res_h);
  args.res_t = static_cast<float*>(res_t);
  args.scratch = static_cast<int*>(scratch);
  args.K = K;
  args.R = R;
  args.d = d;
  args.n_sub = n_sub;
  args.stride = stride;
  args.n_res = (n_sub + stride - 1) / stride;
  args.act = act;
  args.scale = scale;
  args.nbins = nbins;
  args.key_div = key_div;
  args.dt = dt;
  const size_t smem = fwd_smem_bytes(d);
  void* kargs[] = {(void*)&args};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks), block(kWarp, kFwdWarps);
  const bool ri = act == kRelu && scale == kIdentity;
  cudaError_t e;
#define NJODE_GAP_FWD(C, RI_)                                                                 \
  e = cudaLaunchCooperativeKernel((const void*)gap_fwd_kernel<C, RI_>, grid, block, kargs, smem, \
                                  s);
  if (plane_rows(d) == 64) {
    if (ri) {
      NJODE_GAP_FWD(2, true)
    } else {
      NJODE_GAP_FWD(2, false)
    }
  } else {
    if (ri) {
      NJODE_GAP_FWD(4, true)
    } else {
      NJODE_GAP_FWD(4, false)
    }
  }
#undef NJODE_GAP_FWD
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The backward's grid: blocks an SM (the occupancy of the instance for
// width d, at most kMaxBlocksPerSm) times the SMs; every block is resident,
// as the cooperative launch needs.
extern "C" int njode_gap_train_bwd_grid(int d, int* blocks) {
  return grid_of(0, d, kMaxBlocksPerSm, blocks);
}

// The reverse loop (stride 1: row 4; stride > 1: row 5, recomputing each
// segment), its records and their sums into dw, in one cooperative launch
// on `stream`.  plan = [blocks, chunk_rows, nbins, key_seg] (gap_bwd_plan in
// ops/gap_scan.py); scratch holds scratch_floats floats (bwd_layout).
// Returns the CUDA error (0 on success).
extern "C" int njode_gap_train_bwd(const void* ghL, const void* base, const void* ttgt,
                                   const void* w1h, const void* w1t, const void* w2,
                                   const void* b2, const void* res_h, const void* res_t,
                                   void* gh0, void* gpre_sum, void* acct, void* gdh_sum,
                                   void* dw, void* scratch, long long scratch_floats, int K,
                                   int R, int d, float dt, int n_sub, int stride, int act,
                                   int scale, const int* plan, void* stream) {
  if (bad_args(K, R, d, dt, n_sub, stride, act, scale)) return (int)cudaErrorInvalidValue;
  const int blocks = plan[0], chunk_rows = plan[1], nbins = plan[2], key_seg = plan[3];
  const int seg = seg_of(stride), n_seg = (n_sub + seg - 1) / seg;
  // the sort's keys: the count (n_sub + 1 of them), else the segment count
  const bool seg_keys = n_sub + 1 > kBins;
  if (key_seg != (int)seg_keys || nbins != (seg_keys ? n_seg + 1 : n_sub + 1) ||
      nbins > kBins || blocks < K || blocks > kMaxBlocks || chunk_rows < 1)
    return (int)cudaErrorInvalidValue;
  int resident = 0;
  int err = grid_of(0, d, kMaxBlocksPerSm, &resident);
  if (err != 0) return err;
  if (blocks > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int chunks = (R + chunk_rows - 1) / chunk_rows;
  BwdArgs args;
  args.L = bwd_layout(K, R, d, seg, nbins, blocks, chunks);
  if (scratch_floats < args.L.floats) return (int)cudaErrorInvalidValue;
  args.ghL = static_cast<const float*>(ghL);
  args.base = static_cast<const float*>(base);
  args.ttgt = static_cast<const float*>(ttgt);
  args.w1h = static_cast<const float*>(w1h);
  args.w1t = static_cast<const float*>(w1t);
  args.w2 = static_cast<const float*>(w2);
  args.b2 = static_cast<const float*>(b2);
  args.res_h = static_cast<const float*>(res_h);
  args.res_t = static_cast<const float*>(res_t);
  args.gh0 = static_cast<float*>(gh0);
  args.gpre_sum = static_cast<float*>(gpre_sum);
  args.acct = static_cast<float*>(acct);
  args.gdh_sum = static_cast<float*>(gdh_sum);
  args.dw = static_cast<float*>(dw);
  args.scratch = static_cast<float*>(scratch);
  args.K = K;
  args.R = R;
  args.d = d;
  args.n_sub = n_sub;
  args.stride = stride;
  args.seg = seg;
  args.n_seg = n_seg;
  args.act = act;
  args.scale = scale;
  args.nbins = nbins;
  args.key_seg = key_seg;
  args.chunk_rows = chunk_rows;
  args.dt = dt;
  const size_t smem = bwd_smem_bytes(d);
  void* kargs[] = {(void*)&args};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks), block(kWarp, kBwdWarps);
  const bool ri = act == kRelu && scale == kIdentity;
  cudaError_t e;
  if (plane_rows(d) == 64) {
    if (ri)
      e = cudaLaunchCooperativeKernel((const void*)gap_bwd_kernel<2, true>, grid, block, kargs,
                                      smem, s);
    else
      e = cudaLaunchCooperativeKernel((const void*)gap_bwd_kernel<2, false>, grid, block, kargs,
                                      smem, s);
  } else {
    if (ri)
      e = cudaLaunchCooperativeKernel((const void*)gap_bwd_kernel<4, true>, grid, block, kargs,
                                      smem, s);
    else
      e = cudaLaunchCooperativeKernel((const void*)gap_bwd_kernel<4, false>, grid, block, kargs,
                                      smem, s);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* njode_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
