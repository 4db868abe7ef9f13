// The fused step's f32 instances (rows 9 and 10) on the CUDA cores, and the
// layout both fused_step.cu's instances share.  Included by fused_step.cu.
//
// Replaces, in f32, the TPU kernels njode_tpu/ops/fused_step.py:_fwd_kernel
// (line 223) and :_bwd_kernel (line 316).  Every product term is one f32
// fma, k in order from 0, as the earlier slot-serial f32 kernels summed
// them, so the forward's values are theirs bit for bit.
//
// What bounds it on the H100: the f32 products, 2 H^2 flops per row and
// plane pass (7.5 GFLOP a forward at H 256, K 2, N 2, 4,096 rows: 0.113 ms
// at the CUDA cores' 67 TFLOP/s; the backward, which rematerializes the
// forward, three times that), and the stream of each weight plane from L2
// into every block.  The design:
//   * A block is 8 warps over a tile of RT trajectories (64 at the scaled
//     recipe's shape: 128 blocks, one an SM, up to 255 registers a
//     thread), and takes the slots in groups of SG: each plane is applied
//     once to all the group's rows that use it, as the TPU kernel applies
//     it to all slots (fused_step.py:262-297): the jump to SG RT rows, the
//     ODE to the gaps' rows, the readout to both.  The group's activations
//     live in shared memory feature-major (U[j RS + r]), so that a
//     thread's rows of one feature are contiguous.
//   * Products (mm_chunk): out[r][j] = sum_k U[k][r] W[k][j] over chunks of
//     up to 128 rows.  Warp w owns TM = rows / 8 contiguous rows, lane l
//     the 8 columns l + 32 m; per k a thread loads its rows as float4 /
//     float2 (one broadcast a warp) and 8 weights (32 consecutive floats a
//     warp load), 8 TM fmas.  The plane streams through a block-wide stage
//     of kStages slices of kBK rows, each slice one bulk copy (cp.async.bulk
//     completing on an mbarrier) where H % 16 == 0, else 16-byte copies by
//     every thread; one barrier a slice.
//   * The backward keeps no weight-gradient sum in the slot walk.  As it
//     rematerializes and walks back, it writes each plane's input rows (A)
//     and pre-activation cotangents (G) as records to device memory; a second
//     kernel (step_dw_kernel) computes dW = A^T G with every row of the batch
//     as k, in 128 x 256 tiles over split-k chunks of kDwChunk rows, and a
//     third (step_reduce_kernel) sums the chunks in order.  The backward
//     reads the activation values its act' needs back from those records.
//     The bias rows' sums are column sums of each tile's rows, kept in the
//     tile's dV partial and summed over tiles in tile order.  No float
//     atomics: two calls are bitwise equal.
//   * The block's constants sit in shared memory (Blk), so that the
//     out-of-line product chunks take one short argument list.
// Measured on the H100 (PERF.md, section 6): a deeper stage and a rotated k
// order per block did not make it faster; 16 warps of 8-row tiles (at most
// 128 registers) were 3-8% faster but spilled.

// Layout (contiguous): x (B, N, d_x) and t (B, N) f32; W, WT (Kn, n_mats, H,
// H), W (in, out) and WT its transpose per plane; V (Kn, n_rows, H) f32; Y and
// gy (B, 2N-1, d_y, K) f32: slots 0..N-1 after the jump, N..2N-2 before slots
// 1..N-1.  Planes: J_1..J_L, O_0..O_{L-1}, W1h, Wmid_1..Wmid_{L-1}, Wlast.
// Rows: j1[d_x], bj[0..L], w1x[d_x], w1t, w1d, ob[0..L], bo[0..L-1], o2 (d_y
// rows; shared: K d_y rows, c = d K + k).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "walk_cell.cuh"

// the blocks' dynamic shared memory (every kernel of fused_step.cu)
extern __shared__ float njode_step_smem[];

namespace njode_step {

using namespace njode_walk;

struct Layout {
  int L, d_x, d_y, K, shared, Kn, n_mats, n_rows;
  int mat_w1h, mat_last, row_j1, row_bj, row_w1x, row_w1t, row_w1d, row_ob, row_bo, row_o2;
};

inline Layout make_layout(int L, int d_x, int d_y, int K, int shared) {
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

// the block's row scalars: x (RT, N, d_x) and t (RT, N), rows past B zero
__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* dst, int row0,
                                          int nr, int RT, int per_row) {
  for (int e = threadIdx.x; e < RT * per_row; e += blockDim.x)
    dst[e] = e / per_row < nr ? src[(size_t)row0 * per_row + e] : 0.0f;
}

// dst = s(src) over n entries, each thread the entries load_rows gave it
__device__ __forceinline__ void load_scaled(const float* src, float* dst, int n, int scale) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = scale_in(src[e], scale);
}

namespace f32 {

constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;  // a block: 8 row groups x 32 column groups
constexpr int kBK = 8;                    // weight rows of a staged slice
constexpr int kStages = 3;                // slices in flight
constexpr int kHead = 80;                 // floats before the stage: barriers, Blk
constexpr int kMaxChunk = 128;            // rows of one product pass: 8 row groups x 16
// dW = A^T G: tiles of 128 rows a x 256 columns j, 16 warps of 8 rows a
// (8 x 8 entries a thread), split-k chunks of kDwChunk record rows
constexpr int kDwRows = 128, kDwCols = 256, kDwThreads = 512, kDwBK = 16, kDwStages = 3;
constexpr int kDwChunk = 512;

// H padded to the product's step: weights and activations past H are zero
__host__ __device__ inline int pad16(int H) { return (H + 15) / 16 * 16; }
// floats a record row
__host__ __device__ inline int rec_ld(int H) { return (H + 3) / 4 * 4; }
// rows of a slot group's buffer (SG slots after the jump, their gaps)
__host__ __device__ inline int group_rows(int RT, int SG, int N) {
  return (2 * SG < 2 * N - 1 ? 2 * SG : 2 * N - 1) * RT;
}
// floats between features of the buffer
__host__ __device__ inline int row_ld(int rows) { return rows + 4; }

// slot rows of plane m's records: a jump plane's N slots, a readout plane's
// 2N - 1 (after the jump, then before slots 1..N-1), an ODE plane's N - 1 gaps
__host__ __device__ inline int plane_slots(const Layout& lo, int m, int N) {
  return m < lo.L ? N : (m < 2 * lo.L ? 2 * N - 1 : N - 1);
}

// record rows of plane m: tile t's slot row sr, trajectory i is row (t
// plane_slots + sr) RT + i
__host__ __device__ inline size_t plane_rows(const Layout& lo, int m, int N, int tiles, int RT) {
  return (size_t)plane_slots(lo, m, N) * tiles * RT;
}

// offset of plane m's records (which 0: A, 1: G) of network kn
__host__ __device__ inline size_t rec_offset(const Layout& lo, int kn, int m, int which, int N,
                                             int tiles, int RT, int HR) {
  size_t per_kn = 0, off = 0;
  for (int i = 0; i < lo.n_mats; ++i) {
    if (i == m) off = per_kn;
    per_kn += 2 * plane_rows(lo, i, N, tiles, RT) * HR;
  }
  return kn * per_kn + off + which * plane_rows(lo, m, N, tiles, RT) * HR;
}

// split-k chunks of plane m's dW
__host__ __device__ inline int dw_chunks(const Layout& lo, int m, int N, int tiles, int RT) {
  return (int)((plane_rows(lo, m, N, tiles, RT) + kDwChunk - 1) / kDwChunk);
}

// The backward's scratch, in floats: the records, the dW chunk partials
// (H x H each), the tiles' dV partials.
struct Scratch {
  size_t rec, dwp, dvp;
};

__host__ __device__ inline Scratch scratch_floats(const Layout& lo, int B, int N, int H, int RT) {
  const int tiles = (B + RT - 1) / RT;
  Scratch s{0, 0, 0};
  for (int m = 0; m < lo.n_mats; ++m) {
    s.rec += 2 * plane_rows(lo, m, N, tiles, RT) * rec_ld(H);
    s.dwp += (size_t)dw_chunks(lo, m, N, tiles, RT) * H * H;
  }
  s.rec *= lo.Kn;
  s.dwp *= lo.Kn;
  s.dvp = (size_t)tiles * lo.Kn * lo.n_rows * H;
  return s;
}

// per block: the weight stage, the group's buffer, then x, s(x) and t (and gy)
inline size_t smem_floats(bool bwd, int RT, int SG, int H, int N, const Layout& lo) {
  const int Hp = pad16(H);
  size_t f = kHead + (size_t)kStages * kBK * Hp + (size_t)Hp * row_ld(group_rows(RT, SG, N)) +
             (size_t)RT * N * (2 * lo.d_x + 1);
  if (bwd) f += (size_t)RT * (2 * N - 1) * lo.d_y * lo.K;
  return f;
}

// The record rows of a range of buffer rows: row r's record row is r +
// (r < split ? off_a : off_b); p null: no record.
struct Rec {
  float* p;
  int split, off_a, off_b;
  __device__ float* row(int r, int HR) const {
    return p + (size_t)(r + (r < split ? off_a : off_b)) * HR;
  }
};

// A block's constants, written once to shared memory after the stage's
// barriers: the kernel's phases and the out-of-line products read them
// there, so the products take short argument lists and the kernel keeps
// few values live across their calls.
struct Blk {
  Layout lo;
  int N, H, Hp, HR, RS, RT, rt_log2, SG, act, scale, kn, tile, tiles, row0, nr, u_off;
  const float *Wk, *WTk, *Vk;
  float *Y, *scratch, *dvp;
};
constexpr int kBlkOff = 16;  // floats: after the stage's barriers and slice count
static_assert(sizeof(Blk) <= (kHead - kBlkOff) * sizeof(float), "kHead holds Blk");

__device__ __forceinline__ Blk& blk() {
  return *reinterpret_cast<Blk*>(njode_step_smem + kBlkOff);
}
__device__ __forceinline__ float* smem_U(const Blk& k) { return njode_step_smem + k.u_off; }
// x (RT, N, d_x), s(x) likewise, t (RT, N), gy (RT, 2N-1, d_y, K) after the buffer
__device__ __forceinline__ float* smem_x(const Blk& k) {
  return smem_U(k) + (size_t)k.Hp * k.RS;
}
__device__ __forceinline__ float* smem_xs(const Blk& k) {
  return smem_x(k) + k.RT * k.N * k.lo.d_x;
}
__device__ __forceinline__ float* smem_t(const Blk& k) {
  return smem_xs(k) + k.RT * k.N * k.lo.d_x;
}
__device__ __forceinline__ float* smem_gy(const Blk& k) { return smem_t(k) + k.RT * k.N; }
__device__ __forceinline__ const float* vrow(const Blk& k, int r) {
  return k.Vk + (size_t)r * k.H;
}

// what a product's epilogue writes for its product v at (r, j)
enum Epi {
  kEpBias,        // v + b[j]
  kEpGap,         // v + t w1t + DT w1d + b1 + sum_d s(x)[d] w1x[d], the row's gap
  kEpEuler,       // HJg[r][j] + DT (v + b[j]), HJg at buffer row res_row + (r - out_row)
  kEpCopy,        // v
  kEpAdd,         // out[r][j] + v
  kEpAddScaled,   // out[r][j] + v s'(HJ[r][j]), HJ read from the record src
};

// One product pass: buffer rows a_row .. a_row + rows - 1 times the plane W
// (H x H, (in, out)) into buffer rows out_row .., then act (act >= 0) and
// the record of the values (rec.p not null).
struct Pass {
  const float* W;
  int a_row, out_row, rows, mode, act;
  const float* b;
  int res_row, slot0;  // kEpEuler's HJg rows; kEpGap / kEpEuler: the gap of out_row
  Rec rec, src;
};

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// rows k0 .. k0 + kBK - 1 of the plane W (H x H), columns 0 .. Hp - 1, into
// the stage slice dst (rows of Hp floats): 16-byte asynchronous copies where
// a row is whole chunks (H % 4 == 0), else plain copies; zero past H
__device__ __forceinline__ void fetch_slice(float* dst, const float* __restrict__ W, int H,
                                            int Hp, int k0) {
  const int cpr = Hp / 4;
  for (int e = threadIdx.x; e < kBK * cpr; e += kThreads) {
    const int r = e / cpr, c = (e - r * cpr) * 4, k = k0 + r;
    float* d = dst + r * Hp + c;
    if (H % 4 == 0 && k < H && c < H) {
      __pipeline_memcpy_async(d, W + (size_t)k * H + c, 16);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] = k < H && c + q < H ? W[(size_t)k * H + c + q] : 0.0f;
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The stage's barriers (mbarrier, one arrival each) and the count of
// slices the block has staged, at the start of the dynamic shared memory.
__device__ __forceinline__ uint64_t* stage_bars() {
  return reinterpret_cast<uint64_t*>(njode_step_smem);
}
__device__ __forceinline__ int* stage_count() {
  return reinterpret_cast<int*>(njode_step_smem) + 2 * kStages;
}

__device__ __forceinline__ void stage_init() {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(stage_bars() + s)));
    *stage_count() = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// bytes rows of W into dst by the bulk copy engine, completing on bar
__device__ __forceinline__ void bulk_fetch(float* dst, const float* src, uint32_t bytes,
                                           uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred P;\n WAIT%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      " @!P bra WAIT%=;\n}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TM contiguous rows of one feature (16-byte aligned where TM % 4 == 0,
// 8-byte where TM is even)
template <int TM>
__device__ __forceinline__ void load_col(const float* p, float (&a)[TM]) {
  if constexpr (TM % 4 == 0) {
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
    }
  } else if constexpr (TM % 2 == 0) {
#pragma unroll
    for (int i = 0; i < TM; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      a[i] = v.x; a[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = p[i];
  }
}

// TM contiguous rows of one feature from registers (the layout load_col reads)
template <int TM>
__device__ __forceinline__ void store_col(float* p, const float (&a)[TM]) {
  if constexpr (TM % 4 == 0) {
#pragma unroll
    for (int i = 0; i < TM; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
  } else if constexpr (TM % 2 == 0) {
#pragma unroll
    for (int i = 0; i < TM; i += 2) *reinterpret_cast<float2*>(p + i) = make_float2(a[i], a[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) p[i] = a[i];
  }
}

// One chunk of a product pass, kWarps TM rows from r0 (relative to the
// pass): out = epilogue(U[a rows] W).  Thread (rg, cg) = (warp, lane) holds
// rows rg TM .. rg TM + TM - 1 of the chunk and the columns cg + 32 m (m <
// 8) in registers until every thread has read its operands, so out may be
// the operand rows.  A warp's operand rows are one broadcast, its weights
// 32 consecutive floats a load, and its stores of a column's TM rows, at RS
// = 4 (odd) floats apart, fall in distinct banks.  Not inlined: one copy
// per TM, shared by both kernels.
template <int TM>
__device__ __noinline__ void mm_chunk(const Pass p, int r0) {
  const Blk& k = blk();
  const int rg = threadIdx.x / kWarp, cg = threadIdx.x % kWarp;
  const int Hp = k.Hp, RS = k.RS, H = k.H;
  float* U = smem_U(k);
  float* stage = njode_step_smem + kHead;
  const float* A = U + p.a_row + r0 + rg * TM;
  float acc[8][TM];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[m][i] = 0.0f;
  const int n_sl = Hp / kBK;
  // slice sl goes to buffer (base + sl) % kStages: the buffers' barriers
  // count the block's slices across passes.  A whole row of whole chunks
  // (H % 16 == 0) is a contiguous slice of the plane, one bulk copy by
  // thread 0; otherwise every thread copies its chunks and zero-fills.
  const bool bulk = H == Hp;
  const int base = *stage_count();
  auto fetch = [&](int sl) {  // every thread commits a group, maybe empty
    const int b = (base + sl) % kStages;
    if (sl < n_sl && bulk && threadIdx.x == 0)
      bulk_fetch(stage + b * kBK * Hp, p.W + (size_t)sl * kBK * H, kBK * Hp * 4,
                 stage_bars() + b);
    if (sl < n_sl && !bulk) fetch_slice(stage + b * kBK * Hp, p.W, H, Hp, sl * kBK);
    __pipeline_commit();
  };
  for (int sl = 0; sl + 1 < kStages; ++sl) fetch(sl);
#pragma unroll 1
  for (int sl = 0; sl < n_sl; ++sl) {
    const int b = (base + sl) % kStages;
    if (bulk) bulk_wait(stage_bars() + b, (base + sl) / kStages & 1);
    else __pipeline_wait_prior(kStages - 2);  // slice sl has landed
    __syncthreads();                          // for every thread; slice sl - 1 is done
    fetch(sl + kStages - 1);                  // into the buffer of slice sl - 1
    // columns past Hp read the next row (finite, not stored)
    const float* ws = stage + b * kBK * Hp + cg;
    const float* a = A + (size_t)sl * kBK * RS;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[TM];
      load_col<TM>(a + kk * RS, av);
      float wv[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) wv[m] = ws[kk * Hp + 32 * m];
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[m][i] = fmaf(av[i], wv[m], acc[m][i]);
    }
  }
  if (threadIdx.x == 0) *stage_count() = base + n_sl;
  __syncthreads();  // every operand read: out may overwrite them
  const int ro = p.out_row + r0 + rg * TM;  // this thread's first output row
  // the gap of row i (kEpGap, kEpEuler): t and s(x) at s_t[ts(i)],
  // s_xs[ts(i) d_x ..] (RT a power of two)
  const float* s_t = smem_t(k);
  auto ts = [&](int i) {
    const int rel = r0 + rg * TM + i;
    return (rel & (k.RT - 1)) * k.N + p.slot0 + (rel >> k.rt_log2);
  };
  auto dt = [&](int i) { return s_t[ts(i) + 1] - s_t[ts(i)]; };
  // out[j RS + r] = f(i, j, v) over this thread's entries below Hp, 0 past H
  auto store = [&](auto f) {
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int j = cg + 32 * m;
      if (j >= Hp) continue;
      float v[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) v[i] = j < H ? f(i, j, acc[m][i]) : 0.0f;
      store_col<TM>(U + j * RS + ro, v);
    }
  };
  const float* b = p.b;
  switch (p.mode) {
    case kEpBias:
      store([&](int, int j, float v) { return v + __ldg(b + j); });
      break;
    case kEpGap: {
      const float* s_xs = smem_xs(k);
      const float *w1t = vrow(k, k.lo.row_w1t), *w1d = vrow(k, k.lo.row_w1d);
      const float *b1 = vrow(k, k.lo.row_ob), *w1x = vrow(k, k.lo.row_w1x);
      const int d_x = k.lo.d_x;
      store([&](int i, int j, float v) {
        float base = s_t[ts(i)] * __ldg(w1t + j) + dt(i) * __ldg(w1d + j) + __ldg(b1 + j);
        for (int d = 0; d < d_x; ++d)
          base = base + s_xs[ts(i) * d_x + d] * __ldg(w1x + (size_t)d * H + j);
        return v + base;
      });
      break;
    }
    case kEpEuler:
      store([&](int i, int j, float v) {
        return U[j * RS + p.res_row + ro - p.out_row + i] + dt(i) * (v + __ldg(b + j));
      });
      break;
    case kEpCopy:
      store([](int, int, float v) { return v; });
      break;
    case kEpAdd:
      store([&](int i, int j, float v) { return U[j * RS + ro + i] + v; });
      break;
    default:
      store([&](int i, int j, float v) {
        return U[j * RS + ro + i] + v * scale_grad(p.src.row(ro + i, k.HR)[j], k.scale);
      });
  }
  // the activation and the record, over the same entries (no barrier: each
  // thread reads back its own), one loop per activation
  if (p.act >= 0 || p.rec.p) {
    auto finish = [&](auto f) {
#pragma unroll 4
      for (int e = 0; e < 8 * TM; ++e) {
        const int j = cg + 32 * (e / TM), r = ro + e % TM;
        if (j >= H) continue;
        float v = U[j * RS + r];
        if (p.act >= 0) {
          v = f(v);
          U[j * RS + r] = v;
        }
        if (p.rec.p) p.rec.row(r, k.HR)[j] = v;
      }
    };
    switch (p.act) {
      case kRelu: finish([](float v) { return activate(v, kRelu); }); break;
      case kTanh: finish([](float v) { return activate(v, kTanh); }); break;
      case kSigmoid: finish([](float v) { return activate(v, kSigmoid); }); break;
      case kElu: finish([](float v) { return activate(v, kElu); }); break;
      case kLeakyRelu: finish([](float v) { return activate(v, kLeakyRelu); }); break;
      case kSelu: finish([](float v) { return activate(v, kSelu); }); break;
      default: finish([](float v) { return v; });
    }
  }
  __syncthreads();
}

// a product pass in chunks of at most kMaxChunk rows (rows a multiple of 16)
__device__ __forceinline__ void mm(const Pass& p) {
  for (int r0 = 0; r0 < p.rows;) {
    const int left = p.rows - r0;
    const int c = left >= kMaxChunk ? kMaxChunk
                  : left >= 96        ? 96
                  : left >= 64        ? 64
                  : left >= 32        ? 32
                                      : 16;
    switch (c) {
      case kMaxChunk: mm_chunk<kMaxChunk / kWarps>(p, r0); break;
      case 96: mm_chunk<96 / kWarps>(p, r0); break;
      case 64: mm_chunk<64 / kWarps>(p, r0); break;
      case 32: mm_chunk<32 / kWarps>(p, r0); break;
      default: mm_chunk<16 / kWarps>(p, r0);
    }
    r0 += c;
  }
}

// f(r, j4) over rows [0, rows) and column quads j4 < Hp, a warp taking 8
// rows x 4 quads (rows a multiple of 8, Hp of 16); ends with a barrier
template <typename F>
__device__ __forceinline__ void for_quads(int rows, int Hp, F f) {
  const int lane = threadIdx.x % kWarp, rb = rows / 8;
  for (int w = threadIdx.x / kWarp; w < rb * (Hp / 16); w += kWarps)
    f((w % rb) * 8 + lane % 8, ((w / rb) * 4 + lane / 8) * 4);
  __syncthreads();
}

// P[j] += sum_{r < rows} f(r) G[j RS + r] for j < H: a warp a column, the
// lanes' sums in row order, then a butterfly; warp w's columns w + 16 i
// (at most 16) are added to P by lanes i together, so that their device
// memory round trips overlap; ends with a barrier
template <typename F>
__device__ __forceinline__ void colsum(const float* G, int rows, int RS, int H, F f,
                                       float* P) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  float mine = 0.0f;
  for (int i = 0, j = warp; j < H; ++i, j += kWarps) {
    float s = 0.0f;
    for (int r = lane; r < rows; r += kWarp) s = fmaf(f(r), G[j * RS + r], s);
    s = warp_sum(s);
    if (lane == i) mine = s;
  }
  if (warp + lane * kWarps < H) P[warp + lane * kWarps] += mine;
  __syncthreads();
}

// A slot group: slots s0 .. s0 + n_s - 1 after the jump in buffer rows
// [0, Rj), the gaps from its first n_g slots in rows [Rj, Ru).
struct Grp {
  int s0, n_s, n_g, Rj, Rg, Ru;
};

__device__ __forceinline__ Grp group(const Blk& k, int s0) {
  Grp g;
  g.s0 = s0;
  g.n_s = min(k.SG, k.N - s0);
  g.n_g = min(g.n_s, k.N - 1 - s0);
  g.Rj = g.n_s * k.RT;
  g.Rg = g.n_g * k.RT;
  g.Ru = g.Rj + g.Rg;
  return g;
}

// The records of plane m (which 0: A, 1: G) for the group's buffer rows:
// jump planes rows [0, Rj), ODE planes rows [base, base + Rg), readout
// planes rows [0, Ru) (after the jump, then before the next slots).
__device__ __forceinline__ float* rec_base(const Blk& k, int m, int which) {
  return k.scratch + rec_offset(k.lo, k.kn, m, which, k.N, k.tiles, k.RT, k.HR);
}
__device__ __forceinline__ Rec jump_rec(const Blk& k, const Grp& g, int m, int which) {
  return Rec{rec_base(k, m, which), 1 << 30, (k.tile * k.N + g.s0) * k.RT, 0};
}
__device__ __forceinline__ Rec ode_rec(const Blk& k, const Grp& g, int m, int which, int base) {
  return Rec{rec_base(k, m, which), 1 << 30, (k.tile * (k.N - 1) + g.s0) * k.RT - base, 0};
}
__device__ __forceinline__ Rec out_rec(const Blk& k, const Grp& g, int m, int which) {
  const int n_out = 2 * k.N - 1;
  return Rec{rec_base(k, m, which), g.Rj, (k.tile * n_out + g.s0) * k.RT,
             (k.tile * n_out + k.N + g.s0) * k.RT - g.Rj};
}
// Y's slot of a readout row
__device__ __forceinline__ int ys_of(const Blk& k, const Grp& g, int r) {
  return r < g.Rj ? g.s0 + r / k.RT : k.N + g.s0 + (r - g.Rj) / k.RT;
}
// DT of an ODE row (relative to the gaps' rows)
__device__ __forceinline__ float dt_of(const Blk& k, const Grp& g, int rel) {
  const float* s_t = smem_t(k);
  const int e = rel % k.RT * k.N + g.s0 + rel / k.RT;
  return s_t[e + 1] - s_t[e];
}

__device__ __forceinline__ Rec no_rec() { return Rec{nullptr, 0, 0, 0}; }

// The group's forward: the jump, the gaps' Euler steps and the readout's
// hidden layers, in the buffer; the backward's records with BWD.
template <bool BWD>
__device__ __forceinline__ void remat(int s0) {
  const Blk& k = blk();
  const Layout& lo = k.lo;
  const Grp g = group(k, s0);
  const int L = lo.L, H = k.H, RS = k.RS, RT = k.RT, N = k.N, HR = k.HR, act = k.act;
  float* U = smem_U(k);
  auto rec_if = [&](bool on, Rec r) { return BWD && on ? r : no_rec(); };
  auto plane = [&](int m) { return k.Wk + (size_t)m * H * H; };
  // ---- the jump: layer 0 is rank d_x, elementwise
  {
    const float* b0 = vrow(k, lo.row_bj);
    const float* s_x = smem_x(k);
    const int d_x = lo.d_x;
    const Rec ra = rec_if(true, jump_rec(k, g, 0, 0));
    for_quads(g.Rj, k.Hp, [&](int r, int j4) {
      const int e = r % RT * N + s0 + r / RT;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j4 + q;
        v[q] = 0.0f;
        if (j < H) {
          float pre = __ldg(b0 + j);
          for (int d = 0; d < d_x; ++d)
            pre = pre + s_x[e * d_x + d] * __ldg(vrow(k, lo.row_j1 + d) + j);
          v[q] = activate(pre, act);
        }
        U[j * RS + r] = v[q];
      }
      if (ra.p && j4 < H) store4(ra.row(r, HR) + j4, v);
    });
  }
  for (int l = 0; l < L; ++l)
    mm(Pass{plane(l), 0, 0, g.Rj, kEpBias, act, vrow(k, lo.row_bj + l + 1), 0, 0,
            rec_if(true, l + 1 < L ? jump_rec(k, g, l + 1, 0) : out_rec(k, g, L, 0)), no_rec()});
  // ---- the gaps s -> s + 1: one Euler step from HJ_s
  if (g.n_g > 0) {
    const int scale = k.scale;
    int src = 0;
    if (scale != kIdentity || BWD) {  // s(HJg) into rows [Rj, Ru); W1h's A record
      const Rec ra = rec_if(true, ode_rec(k, g, lo.mat_w1h, 0, 0));
      for_quads(g.Rg, k.Hp, [&](int r, int j4) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j4 + q;
          v[q] = j < H ? scale_in(U[j * RS + r], scale) : 0.0f;
          if (scale != kIdentity) U[j * RS + g.Rj + r] = v[q];
        }
        if (ra.p && j4 < H) store4(ra.row(r, HR) + j4, v);
      });
      if (scale != kIdentity) src = g.Rj;
    }
    const int after0 = L > 1 ? 2 * L + 1 : lo.mat_last;  // the plane after layer 0
    mm(Pass{plane(lo.mat_w1h), src, g.Rj, g.Rg, kEpGap, act, nullptr, 0, s0,
            rec_if(true, ode_rec(k, g, after0, 0, g.Rj)), no_rec()});
    for (int i = 1; i < L; ++i) {
      const int after = i + 1 < L ? 2 * L + i + 1 : lo.mat_last;
      mm(Pass{plane(2 * L + i), g.Rj, g.Rj, g.Rg, kEpBias, act, vrow(k, lo.row_ob + i), 0, s0,
              rec_if(true, ode_rec(k, g, after, 0, g.Rj)), no_rec()});
    }
    mm(Pass{plane(lo.mat_last), g.Rj, g.Rj, g.Rg, kEpEuler, -1, vrow(k, lo.row_ob + L), 0, s0,
            rec_if(true, out_rec(k, g, L, 0)), no_rec()});
  }
  // ---- the readout's hidden layers on [HJ; HM]
  for (int l = 0; l < L; ++l)
    mm(Pass{plane(L + l), 0, 0, g.Ru, kEpBias, act, vrow(k, lo.row_bo + l), 0, 0,
            rec_if(l + 1 < L, out_rec(k, g, L + l + 1, 0)), no_rec()});
}

// Y = U o2 for the group's readout rows, a thread a (row, output column), j
// in order
__device__ __forceinline__ void readout_out(int s0) {
  const Blk& k = blk();
  const Layout& lo = k.lo;
  const Grp g = group(k, s0);
  const float* U = smem_U(k);
  const int k_lo = lo.shared ? 0 : k.kn, n_c = (lo.shared ? lo.K : 1) * lo.d_y;
  for (int e = threadIdx.x; e < g.Ru * n_c; e += kThreads) {
    const int r = e % g.Ru, c = e / g.Ru, kk = k_lo + c / lo.d_y, d = c % lo.d_y;
    const float* o2 = vrow(k, o2_row(lo, kk, d));
    float s = 0.0f;
    for (int j = 0; j < k.H; ++j) s = fmaf(U[j * k.RS + r], __ldg(o2 + j), s);
    const int i = r % k.RT;
    if (i < k.nr)
      k.Y[(((size_t)(k.row0 + i) * (2 * k.N - 1) + ys_of(k, g, r)) * lo.d_y + d) * lo.K + kk] = s;
  }
  __syncthreads();
}

// g *= act'(value) in place over buffer rows [r_lo, r_lo + rows), the value
// from the A record va, and g written to the G record vg; the quads as
// for_quads gives them, four a thread loaded before any is used, so that
// their device memory round trips overlap
__device__ __forceinline__ void times_act_grad(int r_lo, int rows, const Rec va, const Rec vg) {
  const Blk& k = blk();
  float* U = smem_U(k);
  const int H = k.H, RS = k.RS, act = k.act;
  const int lane = threadIdx.x % kWarp, rb = rows / 8, n_w = rb * (k.Hp / 16);
  for (int w0 = threadIdx.x / kWarp; w0 < n_w; w0 += 4 * kWarps) {
    float4 a[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = w0 + u * kWarps;
      const int r = r_lo + (w % rb) * 8 + lane % 8, j4 = ((w / rb) * 4 + lane / 8) * 4;
      a[u] = w < n_w && j4 < H ? *reinterpret_cast<const float4*>(va.row(r, k.HR) + j4)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = w0 + u * kWarps;
      const int r = r_lo + (w % rb) * 8 + lane % 8, j4 = ((w / rb) * 4 + lane / 8) * 4;
      if (w >= n_w || j4 >= H) continue;
      const float av[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j4 + q;
        v[q] = j < H ? U[j * RS + r] * act_grad_v(av[q], act) : 0.0f;
        U[j * RS + r] = v[q];
      }
      if (vg.p) store4(vg.row(r, k.HR) + j4, v);
    }
  }
  __syncthreads();
}

// The readout's backward: the o2 rows' sums, g = dU_pre layer by layer
// (records and bias sums), ending with U = [dHJ; dHM].
__device__ __forceinline__ void readout_bwd(int s0) {
  const Blk& k = blk();
  const Layout& lo = k.lo;
  const Grp g = group(k, s0);
  const int L = lo.L, H = k.H, RS = k.RS, RT = k.RT, HR = k.HR, act = k.act;
  float* U = smem_U(k);
  const float* s_gy = smem_gy(k);
  const int n_gy = (2 * k.N - 1) * lo.d_y * lo.K;
  const int k_lo = lo.shared ? 0 : k.kn, k_hi = lo.shared ? lo.K : k.kn + 1;
  auto pv = [&](int r) { return k.dvp + (size_t)r * H; };
  auto one = [](int) { return 1.0f; };
  auto gyv = [&](int r, int d, int kk) {
    return s_gy[r % RT * n_gy + (ys_of(k, g, r) * lo.d_y + d) * lo.K + kk];
  };
  for (int kk = k_lo; kk < k_hi; ++kk)
    for (int d = 0; d < lo.d_y; ++d)
      colsum(U, g.Ru, RS, H, [&](int r) { return gyv(r, d, kk); }, pv(o2_row(lo, kk, d)));
  {
    const Rec rg = out_rec(k, g, L + L - 1, 1);
    for_quads(g.Ru, k.Hp, [&](int r, int j4) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j4 + q;
        v[q] = 0.0f;
        if (j < H) {
          float sum = 0.0f;
          for (int kk = k_lo; kk < k_hi; ++kk)
            for (int d = 0; d < lo.d_y; ++d)
              sum = sum + gyv(r, d, kk) * __ldg(vrow(k, o2_row(lo, kk, d)) + j);
          v[q] = sum * act_grad_v(U[j * RS + r], act);
        }
        U[j * RS + r] = v[q];
      }
      if (j4 < H) store4(rg.row(r, HR) + j4, v);
    });
  }
  for (int l = L - 1; l >= 0; --l) {
    if (l < L - 1) times_act_grad(0, g.Ru, out_rec(k, g, L + l + 1, 0), out_rec(k, g, L + l, 1));
    colsum(U, g.Ru, RS, H, one, pv(lo.row_bo + l));
    mm(Pass{k.WTk + (size_t)(L + l) * H * H, 0, 0, g.Ru, kEpCopy, -1, nullptr, 0, 0, no_rec(),
            no_rec()});
  }
}

// The gaps' backward: dHJ += dHM, dDH = DT dHM, then the ODEFunc's layers
// (records and bias sums), ending with dHJg += (dG1_pre W1h^T) s'(HJg).
__device__ __forceinline__ void gap_bwd(int s0) {
  const Blk& k = blk();
  const Layout& lo = k.lo;
  const Grp g = group(k, s0);
  if (g.n_g == 0) return;
  const int L = lo.L, H = k.H, RS = k.RS, RT = k.RT, HR = k.HR, N = k.N, d_x = lo.d_x;
  float* U = smem_U(k);
  auto pv = [&](int r) { return k.dvp + (size_t)r * H; };
  auto one = [](int) { return 1.0f; };
  auto tplane = [&](int m) { return k.WTk + (size_t)m * H * H; };
  {
    const Rec rg = ode_rec(k, g, lo.mat_last, 1, g.Rj);
    for_quads(g.Rg, k.Hp, [&](int r, int j4) {
      const float dt = dt_of(k, g, r);
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j4 + q;
        const float dhm = U[j * RS + g.Rj + r];
        U[j * RS + r] += dhm;
        v[q] = dhm * dt;
        U[j * RS + g.Rj + r] = v[q];
      }
      if (j4 < H) store4(rg.row(g.Rj + r, HR) + j4, v);
    });
  }
  float* G = U + g.Rj;
  colsum(G, g.Rg, RS, H, one, pv(lo.row_ob + L));
  for (int i = L - 1; i >= 0; --i) {
    const int after = i + 1 < L ? 2 * L + i + 1 : lo.mat_last;
    const int mine = i == 0 ? lo.mat_w1h : 2 * L + i;
    mm(Pass{tplane(after), g.Rj, g.Rj, g.Rg, kEpCopy, -1, nullptr, 0, 0, no_rec(), no_rec()});
    times_act_grad(g.Rj, g.Rg, ode_rec(k, g, after, 0, g.Rj), ode_rec(k, g, mine, 1, g.Rj));
    if (i > 0) {
      colsum(G, g.Rg, RS, H, one, pv(lo.row_ob + i));
      continue;
    }
    const float *s_xs = smem_xs(k), *s_t = smem_t(k);
    for (int d = 0; d < d_x; ++d)
      colsum(G, g.Rg, RS, H,
             [&](int r) { return s_xs[(r % RT * N + s0 + r / RT) * d_x + d]; },
             pv(lo.row_w1x + d));
    colsum(G, g.Rg, RS, H, [&](int r) { return s_t[r % RT * N + s0 + r / RT]; },
           pv(lo.row_w1t));
    colsum(G, g.Rg, RS, H, [&](int r) { return dt_of(k, g, r); }, pv(lo.row_w1d));
    colsum(G, g.Rg, RS, H, one, pv(lo.row_ob));
  }
  mm(Pass{tplane(lo.mat_w1h), g.Rj, 0, g.Rg, k.scale != kIdentity ? kEpAddScaled : kEpAdd, -1,
          nullptr, 0, 0, no_rec(), out_rec(k, g, L, 0)});
}

// The jump's backward, layer by layer (records and bias sums), then layer
// 0's rows of V.
__device__ __forceinline__ void jump_bwd(int s0) {
  const Blk& k = blk();
  const Layout& lo = k.lo;
  const Grp g = group(k, s0);
  const int L = lo.L, H = k.H, RS = k.RS, RT = k.RT, N = k.N, d_x = lo.d_x;
  float* U = smem_U(k);
  auto pv = [&](int r) { return k.dvp + (size_t)r * H; };
  auto one = [](int) { return 1.0f; };
  for (int l = L; l >= 1; --l) {
    times_act_grad(0, g.Rj, l == L ? out_rec(k, g, L, 0) : jump_rec(k, g, l, 0),
                   jump_rec(k, g, l - 1, 1));
    colsum(U, g.Rj, RS, H, one, pv(lo.row_bj + l));
    mm(Pass{k.WTk + (size_t)(l - 1) * H * H, 0, 0, g.Rj, kEpCopy, -1, nullptr, 0, 0, no_rec(),
            no_rec()});
  }
  times_act_grad(0, g.Rj, jump_rec(k, g, 0, 0), no_rec());
  const float* s_x = smem_x(k);
  for (int d = 0; d < d_x; ++d)
    colsum(U, g.Rj, RS, H, [&](int r) { return s_x[(r % RT * N + s0 + r / RT) * d_x + d]; },
           pv(lo.row_j1 + d));
  colsum(U, g.Rj, RS, H, one, pv(lo.row_bj));
}

// The forward (BWD false: Y (B, 2N-1, d_y, K) without bo2) or the backward
// (BWD true: the records and the tile's dV partial in scratch, for gy) of a
// tile of RT trajectories of network blockIdx.y, the slots in groups of SG.
template <bool BWD>
__global__ void __launch_bounds__(kThreads, 1)
step_kernel(const float* __restrict__ x, const float* __restrict__ t,
            const float* __restrict__ W, const float* __restrict__ WT,
            const float* __restrict__ V, const float* __restrict__ gy, float* __restrict__ Y,
            float* scratch, int B, int N, int H, Layout lo, int act, int scale, int RT,
            int SG) {
  if (threadIdx.x == 0) {
    Blk& k = blk();
    k.lo = lo;
    k.N = N; k.H = H; k.Hp = pad16(H); k.HR = rec_ld(H);
    k.RS = row_ld(group_rows(RT, SG, N)); k.RT = RT; k.SG = SG; k.act = act; k.scale = scale;
    k.rt_log2 = __ffs(RT) - 1;
    k.kn = blockIdx.y; k.tile = blockIdx.x; k.tiles = gridDim.x;
    k.row0 = blockIdx.x * RT; k.nr = min(RT, B - k.row0);
    k.u_off = kHead + kStages * kBK * k.Hp;
    const size_t plane_sz = (size_t)H * H;
    k.Wk = W + (size_t)blockIdx.y * lo.n_mats * plane_sz;
    k.WTk = BWD ? WT + (size_t)blockIdx.y * lo.n_mats * plane_sz : nullptr;
    k.Vk = V + (size_t)blockIdx.y * lo.n_rows * H;
    k.Y = Y;
    k.scratch = scratch;
    k.dvp = nullptr;
    if (BWD) {
      const Scratch sz = scratch_floats(lo, B, N, H, RT);
      k.dvp = scratch + sz.rec + sz.dwp + ((size_t)blockIdx.x * lo.Kn + blockIdx.y) * lo.n_rows * H;
    }
  }
  stage_init();
  __syncthreads();
  const Blk& k = blk();
  const int d_x = lo.d_x;
  load_rows(x, smem_x(k), k.row0, k.nr, RT, N * d_x);
  load_rows(t, smem_t(k), k.row0, k.nr, RT, N);
  if (BWD) load_rows(gy, smem_gy(k), k.row0, k.nr, RT, (2 * N - 1) * lo.d_y * lo.K);
  load_scaled(smem_x(k), smem_xs(k), RT * N * d_x, scale);
  float* U = smem_U(k);
  for (int e = threadIdx.x; e < k.Hp * k.RS; e += kThreads) U[e] = 0.0f;
  if (BWD)
    for (int e = threadIdx.x; e < lo.n_rows * H; e += kThreads) k.dvp[e] = 0.0f;
  __syncthreads();
  for (int s0 = 0; s0 < N; s0 += SG) {
    remat<BWD>(s0);
    if (!BWD) {
      readout_out(s0);
      continue;
    }
    readout_bwd(s0);
    gap_bwd(s0);
    jump_bwd(s0);
  }
}

// dW chunk partials: unit u of the grid is (network, plane, chunk, tile of
// kDwRows rows a); P = A^T G over the chunk's record rows, rows in order.
// Warp w holds rows a0 + 8 w .. + 7, lane l the columns l + 32 m: per k
// its A values are one broadcast and its G values 32 consecutive floats a
// load.
__global__ void __launch_bounds__(kDwThreads, 1)
step_dw_kernel(const float* scratch, float* __restrict__ dwp, int tiles, int N, int H,
               Layout lo, int RT) {
  const int HR = rec_ld(H), nT = (H + kDwRows - 1) / kDwRows;
  int u = blockIdx.x, kn = 0, m = 0;
  size_t off = 0;
  for (;; ++m) {  // the unit's network and plane; off: its first chunk's partial
    if (m == lo.n_mats) { m = 0; ++kn; }
    const int n_u = dw_chunks(lo, m, N, tiles, RT) * nT;
    if (u < n_u) break;
    u -= n_u;
    off += (size_t)dw_chunks(lo, m, N, tiles, RT) * H * H;
  }
  const int c = u / nT, a0 = u % nT * kDwRows;
  const size_t M = plane_rows(lo, m, N, tiles, RT);
  const int k_lo = c * kDwChunk;
  const int n_k = M - k_lo < (size_t)kDwChunk ? (int)(M - k_lo) : kDwChunk;
  const float* A = scratch + rec_offset(lo, kn, m, 0, N, tiles, RT, HR) + (size_t)k_lo * HR;
  const float* G = scratch + rec_offset(lo, kn, m, 1, N, tiles, RT, HR) + (size_t)k_lo * HR;
  // kDwStages x (A slice kDwBK x kDwRows, G slice kDwBK x kDwCols)
  constexpr int kSlice = kDwBK * (kDwRows + kDwCols);
  float* stage = njode_step_smem;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  auto fetch = [&](int sl) {
    if (sl * kDwBK < n_k) {
      float* d = stage + (sl % kDwStages) * kSlice;
      constexpr int cpr = (kDwRows + kDwCols) / 4;  // 16-byte chunks a row
      for (int e = threadIdx.x; e < kDwBK * cpr; e += kDwThreads) {
        const int r = e / cpr, cc = e % cpr * 4;
        const bool is_a = cc < kDwRows;
        const int col = is_a ? a0 + cc : cc - kDwRows;
        float* dst = d + (is_a ? r * kDwRows + cc : kDwBK * kDwRows + r * kDwCols + col);
        if (col < HR) {
          __pipeline_memcpy_async(dst, (is_a ? A : G) + (size_t)(sl * kDwBK + r) * HR + col, 16);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) dst[q] = 0.0f;
        }
      }
    }
    __pipeline_commit();
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.0f;
  const int n_sl = n_k / kDwBK;
  for (int sl = 0; sl + 1 < kDwStages; ++sl) fetch(sl);
#pragma unroll 1
  for (int sl = 0; sl < n_sl; ++sl) {
    __pipeline_wait_prior(kDwStages - 2);
    __syncthreads();
    fetch(sl + kDwStages - 1);
    const float* as = stage + (sl % kDwStages) * kSlice + 8 * warp;
    const float* gs = stage + (sl % kDwStages) * kSlice + kDwBK * kDwRows + lane;
#pragma unroll
    for (int kk = 0; kk < kDwBK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(as + kk * kDwRows);
      const float4 a_hi = *reinterpret_cast<const float4*>(as + kk * kDwRows + 4);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      float gv[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) gv[q] = gs[kk * kDwCols + 32 * q];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(av[i], gv[q], acc[i][q]);
    }
  }
  float* P = dwp + off + (size_t)c * H * H;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int a = a0 + 8 * warp + i;
    if (a >= H) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = lane + 32 * q;
      if (j < H) P[(size_t)a * H + j] = acc[i][q];
    }
  }
}

// dW[kn][m] = sum of its chunk partials in chunk order; dV[kn] = sum of the
// tiles' partials in tile order
__global__ void step_reduce_kernel(const float* scratch, float* __restrict__ dW,
                                   float* __restrict__ dV, int tiles, int N, int H, Layout lo,
                                   int RT, size_t rec_floats, size_t dwp_floats) {
  const size_t w_per = (size_t)lo.n_mats * H * H, v_per = (size_t)lo.n_rows * H;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= lo.Kn * (w_per + v_per)) return;
  const int kn = (int)(e / (w_per + v_per));
  const size_t off = e - kn * (w_per + v_per);
  if (off < w_per) {
    const int m = (int)(off / ((size_t)H * H));
    const size_t o = off - m * (size_t)H * H;
    size_t base = rec_floats;
    for (int k = 0; k <= kn; ++k)
      for (int i = 0; i < (k < kn ? lo.n_mats : m); ++i)
        base += (size_t)dw_chunks(lo, i, N, tiles, RT) * H * H;
    float sum = 0.0f;
    for (int c = 0; c < dw_chunks(lo, m, N, tiles, RT); ++c)
      sum += scratch[base + (size_t)c * H * H + o];
    dW[kn * w_per + off] = sum;
  } else {
    const size_t o = off - w_per;
    const float* dvp = scratch + rec_floats + dwp_floats;
    float sum = 0.0f;
    for (int t = 0; t < tiles; ++t) sum += dvp[((size_t)t * lo.Kn + kn) * v_per + o];
    dV[kn * v_per + o] = sum;
  }
}

}  // namespace f32
}  // namespace njode_step
