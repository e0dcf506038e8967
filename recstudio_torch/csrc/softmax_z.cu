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
// operations. This first version computes in float32 on the SIMT cores
// (67 TFLOP/s peak), not on the tensor cores.
//
// Design: a block of 256 threads (16 x 16) owns a tile of 64 query rows
// (K7, K8) or 64 items (K9) in shared memory and streams tiles of the other
// operand (64 items, or 64 rows) through shared memory. Each thread computes
// a 4 x 4 block of the tile's scores (rows ty + 16 i, items tx + 16 j),
// summing over d in order, so all three kernels compute every score with the
// same arithmetic and P in K8 and K9 is exactly the P that K7's logZ
// normalises.
// - K7 keeps a running (max, sum) per (row, thread) across the item tiles
//   and merges the 16 threads of a row at the end. Items at index >= N get
//   -inf, and when the old and the new max are both -inf the rescale factor
//   is 0 (softmax_z.py:70-73), so an empty range contributes (−inf, 0).
// - K8 writes the tile's P to shared memory and accumulates P . items into a
//   [64, D] tile in registers (rows ty + 16 i, columns tx + 16 k); the result
//   is multiplied by g at the end.
// - K9 does the same with the roles swapped: (g o P)^T . q into [64 items, D].
// The TPU kernels walk the long axis in a sequential grid. Here that axis
// (items for K7 and K8, rows for K9) is cut into S fixed ranges so that the
// grid has enough blocks for 132 SMs at both of the path's shapes (51,200
// rows by 3,706 items, and 512 rows by 500,000 items); S and the ranges are
// a function of (M, N) alone. With S > 1 each block writes its partial
// ((max, sum) or a [64, D] tile) to a workspace and a second launch merges
// the S partials in order. There are no float atomics, so the same inputs
// give bitwise the same outputs.
#include "common.cuh"

#include <cmath>

namespace {

constexpr int kT = 64;             // query rows or items per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kLdp = kT + 1;       // row stride of the P tile in shared memory
constexpr int kTargetBlocks = 4 * 132;
constexpr int kMaxD = 256;
constexpr unsigned kFull = 0xffffffffu;

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// The long axis of `inner_tiles` tiles cut into `splits` ranges of `per`
// tiles, so that outer_tiles * splits reaches kTargetBlocks where it can.
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

Plan rows_plan(int M, int N) { return make_plan(cdiv(M, kT), cdiv(N, kT)); }   // K7, K8
Plan items_plan(int M, int N) { return make_plan(cdiv(N, kT), cdiv(M, kT)); }  // K9

// exp(mk - mn), 0 for an empty part (mk = -inf).
__device__ __forceinline__ float rescale(float mk, float mn) {
  return mk == -INFINITY ? 0.f : expf(mk - mn);
}

// Rows [r0, r0 + kT) of a row-major [R, D] matrix into shared memory with
// row stride ld, zero in rows >= R and in columns D..W-1.
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int R, int D,
                                          int W, int ld) {
  for (int idx = threadIdx.x; idx < kT * W; idx += kThreads) {
    const int r = idx / W;
    const int d = idx - r * W;
    const int gr = r0 + r;
    dst[r * ld + d] = (gr < R && d < D) ? src[(long long)gr * D + d] : 0.f;
  }
}

// s[i][j] = qs row (ty + 16 i) . its row (tx + 16 j), summed over d in order.
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
  load_tile(qs, q, r0, M, D, W, ld);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int n0 = n_begin; n0 < n_end; n0 += kT) {
    __syncthreads();                      // the previous item tile is consumed
    load_tile(its, items, n0, N, D, W, ld);
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
// K8: grid (row tiles, S), items split as in K7.
template <int DK>
__global__ void __launch_bounds__(kThreads)
lse_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ items,
                  const float* __restrict__ logz, const float* __restrict__ g,
                  float* __restrict__ part, float* __restrict__ dq, int M, int N, int D,
                  int per, int splits) {
  extern __shared__ float smem[];
  constexpr int W = 16 * DK;
  constexpr int ld = W + 1;
  float* qs = smem;
  float* its = qs + kT * ld;
  float* ps = its + kT * ld;              // [kT rows][kLdp]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * kT;
  const int s = blockIdx.y;
  const int n_begin = s * per * kT;
  const int n_end = min(N, n_begin + per * kT);
  load_tile(qs, q, r0, M, D, W, ld);
  float z[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    z[i] = row < M ? logz[row] : INFINITY;      // rows past M: P = 0
  }
  float acc[4][DK];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < DK; ++k) acc[i][k] = 0.f;
  for (int n0 = n_begin; n0 < n_end; n0 += kT) {
    __syncthreads();                      // the previous P and item tiles are consumed
    load_tile(its, items, n0, N, D, W, ld);
    __syncthreads();
    float sc[4][4];
    tile_scores(sc, qs, its, D, ld, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * kLdp + tx + 16 * j] =
            n0 + tx + 16 * j < n_end ? expf(sc[i][j] - z[i]) : 0.f;
    __syncthreads();
    for (int c = 0; c < kT; ++c) {
      float a[4], b[DK];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[(ty + 16 * i) * kLdp + c];
#pragma unroll
      for (int k = 0; k < DK; ++k) b[k] = its[c * ld + tx + 16 * k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < DK; ++k) acc[i][k] = fmaf(a[i], b[k], acc[i][k]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= M) continue;
    const float gr = g[row];
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const int d = tx + 16 * k;
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
  load_tile(its, items, n0, N, D, W, ld);
  float acc[4][DK];                       // items ty + 16 i, columns tx + 16 k
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < DK; ++k) acc[i][k] = 0.f;
  for (int r0 = m_begin; r0 < m_end; r0 += kT) {
    __syncthreads();                      // the previous P and query tiles are consumed
    load_tile(qs, q, r0, M, D, W, ld);
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

template <int DK>
cudaError_t launch_dq(const float* q, const float* items, const float* logz, const float* g,
                      float* part, float* dq, int M, int N, int D, cudaStream_t stream) {
  const Plan plan = rows_plan(M, N);
  const size_t smem = tiles_smem(DK) + (size_t)kT * kLdp * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lse_bwd_dq_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  lse_bwd_dq_kernel<DK><<<dim3(cdiv(M, kT), plan.splits), kThreads, smem, stream>>>(
      q, items, logz, g, part, dq, M, N, D, plan.per, plan.splits);
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

}  // namespace

// Number of partial ranges of the long axis: kind 0 for K7 and K8 (items),
// 1 for K9 (query rows). The wrapper sizes the workspaces from it: S M 2
// floats for K7, S M D for K8, S N D for K9 (none when S = 1).
extern "C" int rs_catalog_lse_splits(int M, int N, int kind) {
  if (M < 1 || N < 1) return 1;
  return (kind == 0 ? rows_plan(M, N) : items_plan(M, N)).splits;
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
  switch (dk_of(D)) {
    case 4: return (int)launch_dq<4>(q, items, logz, g, part, dq, M, N, D, st);
    case 8: return (int)launch_dq<8>(q, items, logz, g, part, dq, M, N, D, st);
    default: return (int)launch_dq<16>(q, items, logz, g, part, dq, M, N, D, st);
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
