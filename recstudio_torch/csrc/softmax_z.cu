// Catalog log-partition function and its gradients (kernels K7, K8, K9).
//
// Replace the three Pallas kernels of recstudio_tpu/ops/softmax_z.py:
//   K7 _fwd_kernel:         logZ_m   = log sum_n exp(q_m . item_n)
//   K8 _bwd_dq_kernel:      dq_m     = g_m sum_n P_mn item_n
//   K9 _bwd_ditems_kernel:  ditem_n  = sum_m g_m P_mn q_m
// with P_mn = exp(q_m . item_n - logZ_m) recomputed from the saved logZ, as
// the Pallas backward does (_clse_bwd). q is [M, D], items [N, D], float32,
// D <= 256. The [M, N] score matrix never reaches device memory.
//
// Bound on an H100 (SXM, 700 W): K7 does 2 M N D operations against (M +
// N) D 4 bytes, K8 and K9 4 M N D each (they recompute the scores): at the
// SoftmaxLoss shapes (M = B L = 51,200 rows, N = 3,706 items, D = 64) that
// is some 2,000 operations a byte, far above the float32 ridge, so all
// three are bound by operations: 2 M N D (K7) and 4 M N D (K8, K9) at 67
// TFLOP/s. They compute in float32 on the SIMT cores, not on the tensor
// cores.
//
// Scores: every kernel computes a score as fmaf(q[d], item[d], s) from s =
// 0 for d = 0..D-1 in order (score_dots of register_tile.cuh; K9 passes
// the item as the first operand, and fmaf(a, b, s) = fmaf(b, a, s) bit for
// bit since the product inside an fma is exact), so P in K8 and K9 is
// exactly the P that K7's logZ normalises.
//
// All three run on the register tile of register_tile.cuh (the attention
// kernels' K3, K4-K6): a block of 256 threads (16 x 16) owns a tile of 64
// rows in shared memory and streams 64-row tiles of the other operand with
// cp.async (16-byte copies where D and the pointers allow, 4-byte ones
// otherwise); a thread computes the 4 x 4 scores of its rows ty + 16 i and
// streamed rows tx + 16 j with float4 reads.
// - K7: a block owns 64 query rows and streams item tiles through two
//   buffers (the next tile is copied while the scores of this one are
//   computed). It keeps a running (max, sum) per (row, thread) and merges
//   the 16 threads of a row at the end. Items past the block's range get
//   -inf, and an empty part (max -inf) is rescaled by 0, not by exp(-inf -
//   -inf) (softmax_z.py:70-73), so it contributes (-inf, 0).
// - K8: a block owns 64 query rows; one item tile is both the operand of
//   the scores and of P items (pv_product: P through shared memory, the
//   [64, D] accumulator in registers); the result is multiplied by g at the
//   end. Rows past M get P = 0, items past N no weight.
// - K9: K8 with the roles swapped: a block owns 64 items, and one query
//   tile is the operand of the scores and of (g o P)^T q; the P tile holds
//   g_m P_mn as [item][row], 0 for rows past the block's range and items
//   past N.
//
// Grids. The TPU kernels walk the long axis in a sequential grid. Here that
// axis (items for K7 and K8, rows for K9) is cut into S ranges, each a
// block's; with S > 1 each block writes its partial ((max, sum), or a [64,
// D] tile) to a workspace and a second launch merges the S partials in
// order. S comes from the card (range_plan): the blocks of the kernel it
// holds at once (occupancy times SMs, queried once), so that the last wave
// of blocks is full or nearly so, as far as the bytes of S partials are
// worth it; a function of (M, N, D) and the card. There are no float
// atomics, so the same inputs give bitwise the same outputs.
#include "common.cuh"
#include "register_tile.cuh"

#include <cmath>
#include <cstdint>

namespace {

constexpr int kT = 64;             // query rows or items per tile
constexpr int kMaxD = 256;
// The plans: the card's float32 and memory rates (H100 SXM data sheet), the
// share of the former a tile loop is taken to reach, and the most ranges.
constexpr double kPeakOps = 67e12, kPeakBytes = 3.35e12, kTileShare = 0.5;
constexpr int kMaxSplits = 1024;

// Plan kinds, as rs_catalog_lse_splits takes them.
constexpr int kFwd = 0, kDitems = 1, kDq = 2;

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// The long axis of T tiles cut into `splits` ranges of `per` tiles.
struct Plan {
  int splits;
  int per;
};

// exp(mk - mn), 0 for an empty part (mk = -inf).
__device__ __forceinline__ float rescale(float mk, float mn) {
  return mk == -INFINITY ? 0.f : expf(mk - mn);
}

// ---------------------------------------------------------------------------
// K7: grid (row tiles, S); block s covers items [s per kT, (s + 1) per kT).
template <int DK, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
lse_fwd_kernel(const float* __restrict__ q, const float* __restrict__ items,
               float* __restrict__ part, float* __restrict__ logz, int M, int N, int D,
               int per, int splits, bool vec) {
  constexpr int RI = kT / 16, CJ = kT / 16, W = 16 * DK, LD = W + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [kT rows][LD]
  float* its = qs + kT * LD;              // two buffers of [kT items][LD]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * kT;
  const int s = blockIdx.y;
  const int n_begin = s * per * kT;
  const int n_end = min(N, n_begin + per * kT);
  load_tile<kT, W, LD>(qs, q, D, r0, M, D, vec);
  load_tile<kT, W, LD>(its, items, D, n_begin, N, D, vec);
  cp_async_commit();
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  int buf = 0;
  for (int n0 = n_begin; n0 < n_end; n0 += kT, buf ^= 1) {
    if (n0 + kT < n_end)
      load_tile<kT, W, LD>(its + (buf ^ 1) * kT * LD, items, D, n0 + kT, N, D, vec);
    cp_async_commit();
    cp_async_wait<1>();                   // this tile (and the query tile) arrived
    __syncthreads();
    float sc[RI][CJ];
    score_dots<RI, CJ, LD>(sc, qs, its + buf * kT * LD, D, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        if (n0 + tx + 16 * j >= n_end) sc[i][j] = -INFINITY;
        tmax = fmaxf(tmax, sc[i][j]);
      }
      const float mnew = fmaxf(m[i], tmax);
      const float alpha = (isinf(m[i]) && isinf(mnew)) ? 0.f : expf(m[i] - mnew);
      float sum = 0.f;
      if (!isinf(mnew)) {
#pragma unroll
        for (int j = 0; j < CJ; ++j) sum += expf(sc[i][j] - mnew);
      }
      l[i] = l[i] * alpha + sum;
      m[i] = mnew;
    }
    __syncthreads();                      // this buffer is consumed before it is refilled
  }
  // merge the 16 threads (tx) of each row; lanes 0-15 and 16-31 are two rows
#pragma unroll
  for (int i = 0; i < RI; ++i) {
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
    for (int i = 0; i < RI; ++i) {
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
template <int DK, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
lse_bwd_ditems_kernel(const float* __restrict__ q, const float* __restrict__ items,
                      const float* __restrict__ logz, const float* __restrict__ g,
                      float* __restrict__ part, float* __restrict__ ditems, int M, int N,
                      int D, int per, int splits, bool vec) {
  constexpr int RI = kT / 16, CJ = kT / 16, W = 16 * DK, LD = W + 4, LDP = kT + 4;
  extern __shared__ __align__(16) float smem[];
  float* its = smem;                      // [kT items][LD]
  float* qs = its + kT * LD;              // [kT rows][LD]
  float* ps = qs + kT * LD;               // [kT items][LDP]: g_m P_mn
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kT;
  const int s = blockIdx.y;
  const int m_begin = s * per * kT;
  const int m_end = min(M, m_begin + per * kT);
  load_tile<kT, W, LD>(its, items, D, n0, N, D, vec);
  cp_async_commit();
  float acc[RI][DK];                      // items ty + 16 i, columns Cols<DK>::col(k, tx)
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int k = 0; k < DK; ++k) acc[i][k] = 0.f;
  for (int r0 = m_begin; r0 < m_end; r0 += kT) {
    load_tile<kT, W, LD>(qs, q, D, r0, M, D, vec);
    cp_async_commit();
    float z[CJ], gr[CJ];
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int row = r0 + tx + 16 * j;
      const bool ok = row < m_end;
      z[j] = ok ? logz[row] : 0.f;
      gr[j] = ok ? g[row] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    float sc[RI][CJ];
    score_dots<RI, CJ, LD>(sc, its, qs, D, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        ps[(ty + 16 * i) * LDP + tx + 16 * j] =
            r0 + tx + 16 * j < m_end && n0 + ty + 16 * i < N ? gr[j] * expf(sc[i][j] - z[j])
                                                             : 0.f;
    __syncthreads();
    pv_product<RI, DK, kT, LD, LDP>(acc, ps, qs, ty, tx);
    __syncthreads();                      // the query and P tiles are consumed
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const int d = Cols<DK>::col(k, tx);
      if (d >= D) continue;
      if (splits == 1)
        ditems[(long long)n * D + d] = acc[i][k];
      else
        part[((long long)s * N + n) * D + d] = acc[i][k];
    }
  }
}

// ---------------------------------------------------------------------------
// Shared memory of a block, and the blocks __launch_bounds__ asks an SM to
// hold (those its shared memory holds, at most four for K7 and three for
// K8 and K9, as timed on the card): K7 a query tile and two item tiles; K8
// and K9 two operand tiles and a P tile.
template <int DK>
constexpr size_t fwd_floats() { return (size_t)3 * kT * (16 * DK + 4); }

template <int DK>
constexpr size_t bwd_floats() {
  return (size_t)2 * kT * (16 * DK + 4) + (size_t)kT * (kT + 4);
}

template <int DK>
auto* fwd_kernel() { return &lse_fwd_kernel<DK, blocks_per_sm(fwd_floats<DK>(), 4)>; }

template <int DK>
auto* dq_kernel() { return &lse_bwd_dq_kernel<DK, blocks_per_sm(bwd_floats<DK>(), 3)>; }

template <int DK>
auto* ditems_kernel() { return &lse_bwd_ditems_kernel<DK, blocks_per_sm(bwd_floats<DK>(), 3)>; }

// The blocks of `kernel` the card holds at once: its occupancy (from the
// registers ptxas gave it and its shared memory) times the SMs; 0 if the
// query failed (the launch then reports the error).
template <typename Kernel>
int occupancy(Kernel kernel, size_t floats) {
  const size_t smem = floats * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) ==
          cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) ==
          cudaSuccess)
    return per_sm * sms;
  return 0;
}

// The resident blocks of a kind's kernel at accumulator width DK, queried
// once.
template <int DK>
int resident(int kind) {
  static int blocks[3] = {0, 0, 0};
  if (blocks[kind] == 0)
    blocks[kind] = kind == kFwd      ? occupancy(fwd_kernel<DK>(), fwd_floats<DK>())
                   : kind == kDitems ? occupancy(ditems_kernel<DK>(), bwd_floats<DK>())
                                     : occupancy(dq_kernel<DK>(), bwd_floats<DK>());
  return blocks[kind];
}

// The S ranges of the least estimated time, the fewest of equals, for a
// grid of R outer tiles whose T inner tiles are cut into S ranges of `per`:
// ceil(R S / resident) waves of `per` tiles, a tile costing a resident
// block `tile_ops` operations at kTileShare of the card's float32 rate
// shared by all resident blocks; and the floats the ranges move at the
// card's memory rate, (a S + b) `unit` when S > 1, c `unit` when S = 1.
Plan range_plan(int R, int T, double tile_ops, double a, double b, double c, double unit,
                int resident) {
  resident = resident < 1 ? 1 : resident;
  const double tile_s = (double)resident * tile_ops / (kPeakOps * kTileShare);
  const double unit_s = unit * sizeof(float) / kPeakBytes;
  Plan best = {1, T};
  double best_s = INFINITY;
  for (int s = 1; s <= T && s <= kMaxSplits; ++s) {
    const int per = cdiv(T, s);
    if (cdiv(T, per) != s) continue;      // the ranges of a smaller s
    const double waves = cdiv((long long)R * s, resident);
    const double t = waves * per * tile_s + (s > 1 ? a * s + b : c) * unit_s;
    if (t < best_s) {
      best_s = t;
      best = {s, per};
    }
  }
  return best;
}

// K7: row tiles by item ranges; 2 D operations a pair; with S > 1, S reads
// of the query tiles and S (max, sum) partials written and read back, and
// logZ written ((D + 4) S + 1 floats a row), else the query rows read and
// logZ written (D + 1).
Plan fwd_plan(int M, int N, int D, int resident) {
  return range_plan(cdiv(M, kT), cdiv(N, kT), (double)kT * kT * 2 * D, D + 4.0, 1.0, D + 1.0,
                    (double)M, resident);
}

// K9: item tiles by row ranges; 4 D operations a pair; (3 S + 1) N D floats
// when S > 1 (S reads of the item tiles, S partials written and read back,
// ditems written), 2 N D when S = 1.
Plan ditems_plan(int M, int N, int D, int resident) {
  return range_plan(cdiv(N, kT), cdiv(M, kT), (double)kT * kT * 4 * D, 3.0, 1.0, 2.0,
                    (double)N * D, resident);
}

// K8: row tiles by item ranges; as K9 with the roles of rows and items
// swapped.
Plan dq_plan(int M, int N, int D, int resident) {
  return range_plan(cdiv(M, kT), cdiv(N, kT), (double)kT * kT * 4 * D, 3.0, 1.0, 2.0,
                    (double)M * D, resident);
}

template <int DK>
Plan plan_of(int M, int N, int D, int kind) {
  const int res = resident<DK>(kind);
  return kind == kFwd ? fwd_plan(M, N, D, res)
         : kind == kDitems ? ditems_plan(M, N, D, res) : dq_plan(M, N, D, res);
}

// The launches of one kernel of a given plan: the kernel over (outer
// tiles, S), then with S > 1 the in-order merge of the partials.
template <typename Kernel>
cudaError_t launch_fwd(Kernel kernel, size_t floats, const float* q, const float* items,
                       float* part, float* logz, int M, int N, int D, bool vec, Plan plan,
                       cudaStream_t stream) {
  const size_t smem = floats * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(cdiv(M, kT), plan.splits), kThreads, smem, stream>>>(
      q, items, part, logz, M, N, D, plan.per, plan.splits, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.splits == 1) return err;
  lse_merge_kernel<<<cdiv(M, kThreads), kThreads, 0, stream>>>(part, logz, M, plan.splits);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t launch_dq(Kernel kernel, size_t floats, const float* q, const float* items,
                      const float* logz, const float* g, float* part, float* dq, int M, int N,
                      int D, bool vec, Plan plan, cudaStream_t stream) {
  const size_t smem = floats * sizeof(float);
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

template <typename Kernel>
cudaError_t launch_ditems(Kernel kernel, size_t floats, const float* q, const float* items,
                          const float* logz, const float* g, float* part, float* ditems, int M,
                          int N, int D, bool vec, Plan plan, cudaStream_t stream) {
  const size_t smem = floats * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(cdiv(N, kT), plan.splits), kThreads, smem, stream>>>(
      q, items, logz, g, part, ditems, M, N, D, plan.per, plan.splits, vec);
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

// 16-byte copies where every row of both operands starts on 16 bytes.
bool vec_rows(const float* q, const float* items, int D) {
  return D % 4 == 0 && aligned16(q) && aligned16(items);
}

}  // namespace

// Number of partial ranges of the long axis on the current device: kind 0
// for K7 (items), 1 for K9 (query rows), 2 for K8 (items). The wrapper
// sizes the workspaces from it: S M 2 floats for K7, S M D for K8, S N D
// for K9 (none when S = 1).
extern "C" int rs_catalog_lse_splits(int M, int N, int D, int kind) {
  if (bad_shape(M, N, D) || kind < kFwd || kind > kDq) return 1;
  switch (dk_of(D)) {
    case 4: return plan_of<4>(M, N, D, kind).splits;
    case 8: return plan_of<8>(M, N, D, kind).splits;
    default: return plan_of<16>(M, N, D, kind).splits;
  }
}

// The blocks of a kind's kernel at width D that the current device holds
// at once, from which its plan is cut (0 if the query failed).
extern "C" int rs_catalog_lse_resident(int D, int kind) {
  if (bad_shape(1, 1, D) || kind < kFwd || kind > kDq) return 0;
  switch (dk_of(D)) {
    case 4: return resident<4>(kind);
    case 8: return resident<8>(kind);
    default: return resident<16>(kind);
  }
}

extern "C" int rs_catalog_lse_fwd(const float* q, const float* items, float* part, float* logz,
                                  int M, int N, int D, void* stream) {
  if (bad_shape(M, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = vec_rows(q, items, D);
  switch (dk_of(D)) {
    case 4: return (int)launch_fwd(fwd_kernel<4>(), fwd_floats<4>(), q, items, part, logz, M,
                                   N, D, vec, plan_of<4>(M, N, D, kFwd), st);
    case 8: return (int)launch_fwd(fwd_kernel<8>(), fwd_floats<8>(), q, items, part, logz, M,
                                   N, D, vec, plan_of<8>(M, N, D, kFwd), st);
    default: return (int)launch_fwd(fwd_kernel<16>(), fwd_floats<16>(), q, items, part, logz,
                                    M, N, D, vec, plan_of<16>(M, N, D, kFwd), st);
  }
}

extern "C" int rs_catalog_lse_bwd_dq(const float* q, const float* items, const float* logz,
                                     const float* g, float* part, float* dq, int M, int N, int D,
                                     void* stream) {
  if (bad_shape(M, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = vec_rows(q, items, D);
  switch (dk_of(D)) {
    case 4: return (int)launch_dq(dq_kernel<4>(), bwd_floats<4>(), q, items, logz, g, part, dq,
                                  M, N, D, vec, plan_of<4>(M, N, D, kDq), st);
    case 8: return (int)launch_dq(dq_kernel<8>(), bwd_floats<8>(), q, items, logz, g, part, dq,
                                  M, N, D, vec, plan_of<8>(M, N, D, kDq), st);
    default: return (int)launch_dq(dq_kernel<16>(), bwd_floats<16>(), q, items, logz, g, part,
                                   dq, M, N, D, vec, plan_of<16>(M, N, D, kDq), st);
  }
}

extern "C" int rs_catalog_lse_bwd_ditems(const float* q, const float* items, const float* logz,
                                         const float* g, float* part, float* ditems, int M,
                                         int N, int D, void* stream) {
  if (bad_shape(M, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = vec_rows(q, items, D);
  switch (dk_of(D)) {
    case 4: return (int)launch_ditems(ditems_kernel<4>(), bwd_floats<4>(), q, items, logz, g,
                                      part, ditems, M, N, D, vec,
                                      plan_of<4>(M, N, D, kDitems), st);
    case 8: return (int)launch_ditems(ditems_kernel<8>(), bwd_floats<8>(), q, items, logz, g,
                                      part, ditems, M, N, D, vec,
                                      plan_of<8>(M, N, D, kDitems), st);
    default: return (int)launch_ditems(ditems_kernel<16>(), bwd_floats<16>(), q, items, logz,
                                       g, part, ditems, M, N, D, vec,
                                       plan_of<16>(M, N, D, kDitems), st);
  }
}
