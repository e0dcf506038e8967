// Catalog log-partition function and its gradients (kernels K7, K8, K9).
//
// Replace the three Pallas kernels of recstudio_tpu/ops/softmax_z.py:
//   K7 _fwd_kernel:         logZ_m   = log sum_n exp(q_m . item_n)
//   K8 _bwd_dq_kernel:      dq_m     = g_m sum_n P_mn item_n
//   K9 _bwd_ditems_kernel:  ditem_n  = sum_m g_m P_mn q_m
// with P_mn = exp(q_m . item_n - logZ_m) recomputed from the saved logZ, as
// the Pallas backward does (_clse_bwd). q is [M, D], items [N, D], float32.
// The [M, N] score matrix never reaches device memory.
//
// Bound on an H100: K7 does 2 M N D operations against (M + N) D 4 bytes,
// K8 and K9 4 M N D each (they recompute the scores): at the SoftmaxLoss
// shapes (M = B L = 51,200 rows, N = 3,706 items, D = 64) that is some 2,000
// operations a byte, far above the float32 ridge, so all three are bound by
// operations. They compute in float32 on the SIMT cores (67 TFLOP/s peak),
// not on the tensor cores.
//
// Scores: every kernel computes a score as fmaf(q[d], item[d], s) from s =
// 0 for d = 0..D-1 in order, so P in K8 and K9 is exactly the P that K7's
// logZ normalises.
//
// K7 and K9: a block of 256 threads (16 x 16) owns a tile of 64 query rows
// (K7) or 64 items (K9) in shared memory and streams tiles of the other
// operand (64 items, or 64 rows) through shared memory, copied by the
// threads. Each thread computes a 4 x 4 block of the tile's scores (rows ty
// + 16 i, items tx + 16 j), reading one column at a time.
// - K7 keeps a running (max, sum) per (row, thread) across the item tiles
//   and merges the 16 threads of a row at the end. Items at index >= N get
//   -inf, and when the old and the new max are both -inf the rescale factor
//   is 0 (softmax_z.py:70-73), so an empty range contributes (-inf, 0).
// - K9 writes the tile's g o P to shared memory and accumulates (g o P)^T q
//   into a [64 items, D] tile in registers (items ty + 16 i, columns tx + 16
//   k).
// K8: the register tile of register_tile.cuh (the attention kernels' K3,
// K4-K6): a block owns 64 query rows and streams tiles of 64 items with
// cp.async (16-byte copies where D and the pointers allow, 4-byte ones
// otherwise). One item tile is both the operand of the scores (score_dots:
// float4 reads, d in order, so bitwise K7's scores) and of P items
// (pv_product: P through shared memory, the [64, D] accumulator in
// registers); the result is multiplied by g at the end. Rows past M get P =
// 0, items past N no weight.
//
// Grids. The TPU kernels walk the long axis in a sequential grid. Here that
// axis (items for K7 and K8, rows for K9) is cut into S fixed ranges, each a
// block's; with S > 1 each block writes its partial ((max, sum) or a [64, D]
// tile) to a workspace and a second launch merges the S partials in order.
// K7 and K9 cut S so that the grid has some 4 x 132 blocks where it can
// (make_plan: a function of M and N). K8 sizes S from the card (dq_plan):
// the blocks it holds at once (the kernel's occupancy times the SMs,
// queried once), so that the last wave of blocks is full or nearly so, as
// far as the bytes of S partials (written, read back by the merge, and S
// reads of the query tiles) are worth it; a function of (M, N, D) and the
// card. There are no float atomics, so the same inputs give bitwise the
// same outputs.
#include "common.cuh"
#include "register_tile.cuh"

#include <cmath>
#include <cstdint>

namespace {

constexpr int kT = 64;             // query rows or items per tile
constexpr int kLdp = kT + 1;       // K7, K9: row stride of the P tile in shared memory
constexpr int kTargetBlocks = 4 * 132;
constexpr int kMaxD = 256;
// K8's plan: the card's float32 and memory rates (H100 SXM data sheet), the
// share of the former its tile loop is taken to reach, and the most ranges.
constexpr double kPeakOps = 67e12, kPeakBytes = 3.35e12, kDqShare = 0.5;
constexpr int kMaxSplits = 1024;

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// The long axis of `inner_tiles` tiles cut into `splits` ranges of `per`
// tiles; K7's and K9's so that outer_tiles * splits reaches kTargetBlocks
// where it can.
struct Plan {
  int splits;
  int per;
};

Plan make_plan(int outer_tiles, int inner_tiles) {
  int s = cdiv(kTargetBlocks, outer_tiles);
  s = s < 1 ? 1 : (s > inner_tiles ? inner_tiles : s);
  const int per = cdiv(inner_tiles, s);
  return {cdiv(inner_tiles, per), per};
}

Plan rows_plan(int M, int N) { return make_plan(cdiv(M, kT), cdiv(N, kT)); }   // K7
Plan items_plan(int M, int N) { return make_plan(cdiv(N, kT), cdiv(M, kT)); }  // K9

// exp(mk - mn), 0 for an empty part (mk = -inf).
__device__ __forceinline__ float rescale(float mk, float mn) {
  return mk == -INFINITY ? 0.f : expf(mk - mn);
}

// K7, K9: rows [r0, r0 + kT) of a row-major [R, D] matrix into shared
// memory with row stride ld, zero in rows >= R and in columns D..W-1.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int R, int D,
                                          int W, int ld) {
  for (int idx = threadIdx.x; idx < kT * W; idx += kThreads) {
    const int r = idx / W;
    const int d = idx - r * W;
    const int gr = r0 + r;
    dst[r * ld + d] = (gr < R && d < D) ? src[(long long)gr * D + d] : 0.f;
  }
}

// K7, K9: s[i][j] = qs row (ty + 16 i) . its row (tx + 16 j), summed over d
// in order.
__device__ __forceinline__ void tile_scores(float s[4][4], const float* qs, const float* its,
                                            int D, int ld, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = its[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// ---------------------------------------------------------------------------
// K7: grid (row tiles, S); block s covers items [s per kT, (s + 1) per kT).
template <int DK>
__global__ void __launch_bounds__(kThreads)
lse_fwd_kernel(const float* __restrict__ q, const float* __restrict__ items,
               float* __restrict__ part, float* __restrict__ logz, int M, int N, int D,
               int per, int splits) {
  extern __shared__ float smem[];
  constexpr int W = 16 * DK;
  constexpr int ld = W + 1;
  float* qs = smem;
  float* its = qs + kT * ld;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * kT;
  const int s = blockIdx.y;
  const int n_begin = s * per * kT;
  const int n_end = min(N, n_begin + per * kT);
  load_rows(qs, q, r0, M, D, W, ld);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int n0 = n_begin; n0 < n_end; n0 += kT) {
    __syncthreads();                      // the previous item tile is consumed
    load_rows(its, items, n0, N, D, W, ld);
    __syncthreads();
    float sc[4][4];
    tile_scores(sc, qs, its, D, ld, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + tx + 16 * j >= n_end) sc[i][j] = -INFINITY;
        tmax = fmaxf(tmax, sc[i][j]);
      }
      const float mnew = fmaxf(m[i], tmax);
      const float alpha = (isinf(m[i]) && isinf(mnew)) ? 0.f : expf(m[i] - mnew);
      float sum = 0.f;
      if (!isinf(mnew)) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sum += expf(sc[i][j] - mnew);
      }
      l[i] = l[i] * alpha + sum;
      m[i] = mnew;
    }
  }
  // merge the 16 threads (tx) of each row; lanes 0-15 and 16-31 are two rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (int o = 8; o > 0; o >>= 1) {
      const float mo = __shfl_xor_sync(kFull, m[i], o);
      const float lo = __shfl_xor_sync(kFull, l[i], o);
      const float mn = fmaxf(m[i], mo);
      l[i] = l[i] * rescale(m[i], mn) + lo * rescale(mo, mn);
      m[i] = mn;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 16 * i;
      if (row >= M) continue;
      if (splits == 1) {
        logz[row] = m[i] + logf(l[i]);
      } else {
        part[((long long)s * M + row) * 2] = m[i];
        part[((long long)s * M + row) * 2 + 1] = l[i];
      }
    }
  }
}

// logZ from the S partial (max, sum) of each row, merged in order.
__global__ void __launch_bounds__(kThreads)
lse_merge_kernel(const float* __restrict__ part, float* __restrict__ logz, int M, int splits) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= M) return;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part[((long long)s * M + row) * 2]);
  float l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long at = ((long long)s * M + row) * 2;
    l += part[at + 1] * rescale(part[at], m);
  }
  logz[row] = m + logf(l);
}

// ---------------------------------------------------------------------------
// K8: grid (row tiles, S); block s covers items [s per kT, (s + 1) per kT).
template <int DK, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
lse_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ items,
                  const float* __restrict__ logz, const float* __restrict__ g,
                  float* __restrict__ part, float* __restrict__ dq, int M, int N, int D,
                  int per, int splits, bool vec) {
  constexpr int RI = kT / 16, CJ = kT / 16, W = 16 * DK, LD = W + 4, LDP = kT + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [kT rows][LD]
  float* its = qs + kT * LD;              // [kT items][LD]
  float* ps = its + kT * LD;              // [kT rows][LDP]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * kT;
  const int s = blockIdx.y;
  const int n_begin = s * per * kT;
  const int n_end = min(N, n_begin + per * kT);
  load_tile<kT, W, LD>(qs, q, D, r0, M, D, vec);
  cp_async_commit();
  float z[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = r0 + ty + 16 * i;
    z[i] = row < M ? logz[row] : INFINITY;      // rows past M: P = 0
  }
  float acc[RI][DK];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int k = 0; k < DK; ++k) acc[i][k] = 0.f;
  for (int n0 = n_begin; n0 < n_end; n0 += kT) {
    load_tile<kT, W, LD>(its, items, D, n0, N, D, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float sc[RI][CJ];
    score_dots<RI, CJ, LD>(sc, qs, its, D, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        ps[(ty + 16 * i) * LDP + tx + 16 * j] =
            n0 + tx + 16 * j < n_end ? expf(sc[i][j] - z[i]) : 0.f;
    __syncthreads();
    pv_product<RI, DK, kT, LD, LDP>(acc, ps, its, ty, tx);
    __syncthreads();                      // the item and P tiles are consumed
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= M) continue;
    const float gr = g[row];
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const int d = Cols<DK>::col(k, tx);
      if (d >= D) continue;
      if (splits == 1)
        dq[(long long)row * D + d] = gr * acc[i][k];
      else
        part[((long long)s * M + row) * D + d] = acc[i][k];
    }
  }
}

// out[r, d] = (scale ? g[r] : 1) * sum_s part[s, r, d], summed in order of s.
__global__ void __launch_bounds__(kThreads)
sum_parts_kernel(const float* __restrict__ part, const float* __restrict__ g,
                 float* __restrict__ out, int R, int D, int splits) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = (long long)R * D;
  if (idx >= n) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += part[s * n + idx];
  out[idx] = g != nullptr ? g[idx / D] * sum : sum;
}

// ---------------------------------------------------------------------------
// K9: grid (item tiles, S); block s covers rows [s per kT, (s + 1) per kT).
template <int DK>
__global__ void __launch_bounds__(kThreads)
lse_bwd_ditems_kernel(const float* __restrict__ q, const float* __restrict__ items,
                      const float* __restrict__ logz, const float* __restrict__ g,
                      float* __restrict__ part, float* __restrict__ ditems, int M, int N,
                      int D, int per, int splits) {
  extern __shared__ float smem[];
  constexpr int W = 16 * DK;
  constexpr int ld = W + 1;
  float* its = smem;
  float* qs = its + kT * ld;
  float* ps = qs + kT * ld;               // [kT rows][kLdp]: g_m P_mn
  float* zs = ps + kT * kLdp;
  float* gs = zs + kT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kT;
  const int s = blockIdx.y;
  const int m_begin = s * per * kT;
  const int m_end = min(M, m_begin + per * kT);
  load_rows(its, items, n0, N, D, W, ld);
  float acc[4][DK];                       // items ty + 16 i, columns tx + 16 k
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < DK; ++k) acc[i][k] = 0.f;
  for (int r0 = m_begin; r0 < m_end; r0 += kT) {
    __syncthreads();                      // the previous P and query tiles are consumed
    load_rows(qs, q, r0, M, D, W, ld);
    if (threadIdx.x < kT) {
      const int row = r0 + threadIdx.x;
      const bool ok = row < m_end;
      zs[threadIdx.x] = ok ? logz[row] : INFINITY;   // rows outside the range: P = 0
      gs[threadIdx.x] = ok ? g[row] : 0.f;
    }
    __syncthreads();
    float sc[4][4];
    tile_scores(sc, qs, its, D, ld, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[r * kLdp + tx + 16 * j] =
            n0 + tx + 16 * j < N ? gs[r] * expf(sc[i][j] - zs[r]) : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kT; ++r) {
      float a[4], b[DK];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[r * kLdp + ty + 16 * i];
#pragma unroll
      for (int k = 0; k < DK; ++k) b[k] = qs[r * ld + tx + 16 * k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < DK; ++k) acc[i][k] = fmaf(a[i], b[k], acc[i][k]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const int d = tx + 16 * k;
      if (d >= D) continue;
      if (splits == 1)
        ditems[(long long)n * D + d] = acc[i][k];
      else
        part[((long long)s * N + n) * D + d] = acc[i][k];
    }
  }
}

// ---------------------------------------------------------------------------
size_t tiles_smem(int DK) { return (size_t)2 * kT * (16 * DK + 1) * sizeof(float); }

template <int DK>
cudaError_t launch_fwd(const float* q, const float* items, float* part, float* logz, int M,
                       int N, int D, cudaStream_t stream) {
  const Plan plan = rows_plan(M, N);
  const size_t smem = tiles_smem(DK);
  cudaError_t err = cudaFuncSetAttribute(lse_fwd_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  lse_fwd_kernel<DK><<<dim3(cdiv(M, kT), plan.splits), kThreads, smem, stream>>>(
      q, items, part, logz, M, N, D, plan.per, plan.splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.splits == 1) return err;
  lse_merge_kernel<<<cdiv(M, kThreads), kThreads, 0, stream>>>(part, logz, M, plan.splits);
  return cudaGetLastError();
}

// K8: shared memory of a block, and the blocks __launch_bounds__ asks an SM
// to hold (those its shared memory holds, at most three).
template <int DK>
constexpr size_t dq_floats() {
  return (size_t)2 * kT * (16 * DK + 4) + (size_t)kT * (kT + 4);
}

template <int DK>
constexpr int dq_blocks() { return blocks_per_sm(dq_floats<DK>(), 3); }

template <int DK>
auto* dq_kernel() { return &lse_bwd_dq_kernel<DK, dq_blocks<DK>()>; }

// The blocks of K8 the card holds at once: its occupancy (from the
// registers ptxas gave it and its shared memory) times the SMs, queried
// once; 0 if the query failed (the launch then reports the error).
template <int DK>
int dq_resident() {
  static int resident = 0;
  if (resident == 0) {
    const size_t smem = dq_floats<DK>() * sizeof(float);
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
        cudaFuncSetAttribute(dq_kernel<DK>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dq_kernel<DK>(), kThreads, smem) ==
            cudaSuccess)
      resident = per_sm * sms;
  }
  return resident;
}

// K8's plan: the S ranges of the least estimated time, the fewest of equals.
// S ranges of `per` item tiles take ceil(R S / resident) waves of `per`
// tiles, a tile costing a resident block kT kT 4 D operations at kDqShare
// of the card's float32 rate shared by all resident blocks; and (3 S + 1) M
// D floats at the card's memory rate when S > 1 (S reads of the query
// tiles, S partials written and read back, dq written), 2 M D when S = 1.
Plan dq_plan(int M, int N, int D, int resident) {
  resident = resident < 1 ? 1 : resident;
  const int R = cdiv(M, kT), T = cdiv(N, kT);
  const double tile_s = (double)resident * kT * kT * 4.0 * D / (kPeakOps * kDqShare);
  const double row_s = (double)M * D * sizeof(float) / kPeakBytes;
  Plan best = {1, T};
  double best_s = INFINITY;
  for (int s = 1; s <= T && s <= kMaxSplits; ++s) {
    const int per = cdiv(T, s);
    if (cdiv(T, per) != s) continue;      // the ranges of a smaller s
    const double waves = cdiv((long long)R * s, resident);
    const double t = waves * per * tile_s + (s > 1 ? 3.0 * s + 1 : 2.0) * row_s;
    if (t < best_s) {
      best_s = t;
      best = {s, per};
    }
  }
  return best;
}

template <int DK>
Plan dq_plan(int M, int N, int D) { return dq_plan(M, N, D, dq_resident<DK>()); }

template <int DK>
cudaError_t launch_dq(const float* q, const float* items, const float* logz, const float* g,
                      float* part, float* dq, int M, int N, int D, bool vec, Plan plan,
                      cudaStream_t stream) {
  const size_t smem = dq_floats<DK>() * sizeof(float);
  auto* kernel = dq_kernel<DK>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(cdiv(M, kT), plan.splits), kThreads, smem, stream>>>(
      q, items, logz, g, part, dq, M, N, D, plan.per, plan.splits, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.splits == 1) return err;
  sum_parts_kernel<<<cdiv((long long)M * D, kThreads), kThreads, 0, stream>>>(
      part, g, dq, M, D, plan.splits);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_ditems(const float* q, const float* items, const float* logz,
                          const float* g, float* part, float* ditems, int M, int N, int D,
                          cudaStream_t stream) {
  const Plan plan = items_plan(M, N);
  const size_t smem = tiles_smem(DK) + (size_t)(kT * kLdp + 2 * kT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lse_bwd_ditems_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  lse_bwd_ditems_kernel<DK><<<dim3(cdiv(N, kT), plan.splits), kThreads, smem, stream>>>(
      q, items, logz, g, part, ditems, M, N, D, plan.per, plan.splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.splits == 1) return err;
  sum_parts_kernel<<<cdiv((long long)N * D, kThreads), kThreads, 0, stream>>>(
      part, nullptr, ditems, N, D, plan.splits);
  return cudaGetLastError();
}

// DK = columns per thread in the [64, D] accumulators: D <= 64, 128 or 256.
int dk_of(int D) { return D <= 64 ? 4 : (D <= 128 ? 8 : 16); }

bool bad_shape(int M, int N, int D) { return M < 1 || N < 1 || D < 1 || D > kMaxD; }

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

}  // namespace

// Number of partial ranges of the long axis: kind 0 for K7 (items), 1 for
// K9 (query rows), 2 for K8 (items; on the current device). The wrapper
// sizes the workspaces from it: S M 2 floats for K7, S M D for K8, S N D
// for K9 (none when S = 1).
extern "C" int rs_catalog_lse_splits(int M, int N, int D, int kind) {
  if (bad_shape(M, N, D)) return 1;
  if (kind == 0) return rows_plan(M, N).splits;
  if (kind == 1) return items_plan(M, N).splits;
  switch (dk_of(D)) {
    case 4: return dq_plan<4>(M, N, D).splits;
    case 8: return dq_plan<8>(M, N, D).splits;
    default: return dq_plan<16>(M, N, D).splits;
  }
}

extern "C" int rs_catalog_lse_fwd(const float* q, const float* items, float* part, float* logz,
                                  int M, int N, int D, void* stream) {
  if (bad_shape(M, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dk_of(D)) {
    case 4: return (int)launch_fwd<4>(q, items, part, logz, M, N, D, st);
    case 8: return (int)launch_fwd<8>(q, items, part, logz, M, N, D, st);
    default: return (int)launch_fwd<16>(q, items, part, logz, M, N, D, st);
  }
}

extern "C" int rs_catalog_lse_bwd_dq(const float* q, const float* items, const float* logz,
                                     const float* g, float* part, float* dq, int M, int N, int D,
                                     void* stream) {
  if (bad_shape(M, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = D % 4 == 0 && aligned16(q) && aligned16(items);
  switch (dk_of(D)) {
    case 4: return (int)launch_dq<4>(q, items, logz, g, part, dq, M, N, D, vec,
                                     dq_plan<4>(M, N, D), st);
    case 8: return (int)launch_dq<8>(q, items, logz, g, part, dq, M, N, D, vec,
                                     dq_plan<8>(M, N, D), st);
    default: return (int)launch_dq<16>(q, items, logz, g, part, dq, M, N, D, vec,
                                       dq_plan<16>(M, N, D), st);
  }
}

extern "C" int rs_catalog_lse_bwd_ditems(const float* q, const float* items, const float* logz,
                                         const float* g, float* part, float* ditems, int M,
                                         int N, int D, void* stream) {
  if (bad_shape(M, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dk_of(D)) {
    case 4: return (int)launch_ditems<4>(q, items, logz, g, part, ditems, M, N, D, st);
    case 8: return (int)launch_ditems<8>(q, items, logz, g, part, ditems, M, N, D, st);
    default: return (int)launch_ditems<16>(q, items, logz, g, part, ditems, M, N, D, st);
  }
}
