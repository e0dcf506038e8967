// Long-sequence attention: the flash forward (K4) and its backward (K5, K6).
//
// Replace the Pallas kernels of recstudio_tpu/ops/attention.py that the JAX
// package runs when Lk > 512 (_FLASH_THRESHOLD):
//   K4 _flash_kernel:          out = P v and each row's statistics
//   K5 _flash_bwd_dq_kernel:   dq = scale * dS k           (and delta, below)
//   K6 _flash_bwd_dkv_kernel:  dv = P^T dO,  dk = scale * dS^T q
// with s = max(q k^T * scale + attn_add + pad_add, finfo.min) (masks added,
// then clamped, attention.py:147-148), P = softmax(s) over the Lk keys, and
//   dS = P o (dO v^T - delta),  delta = rowsum(dO o out).
// q, dO and out are [B, H, Lq, Dh], k, v [B, H, Lk, Dh], contiguous float32;
// pad_add [B, Lk] and attn_add [Lq, Lk] are additive masks, either may be
// null. The [Lq, Lk] scores never reach device memory.
//
// Row statistics. The Pallas forward stores lse = max + log(sum); for a row
// whose keys are all masked, max = finfo.min and lse rounds to finfo.min, so
// its backward recomputes P = 1 for every key instead of 1 / Lk. K4 stores
// the pair (max, sum) instead, stats[((b H + h) Lq + i) 2 + {0, 1}], and K5
// and K6 recompute P = exp(s - max) / sum, which is 1 / Lk on such a row.
// The gradient through the clamp follows torch.clamp_min, as autograd of the
// plain mha_plain does: it passes where the unclamped logit is >= finfo.min
// and is cut where the two masks together sum to -inf.
//
// Bound on an H100: per (example, head), K4 does 4 Dh operations for each
// (query, key) pair the masks allow, K5 6 Dh (S, dP, dq) and K6 8 Dh (S, dP,
// dv, dk), against some (4 Lq + 4 Lk) Dh bytes. With a causal mask at L 1024,
// Dh 64 that is hundreds of operations a byte: all three are bound by
// operations. This first version computes in float32 on the SIMT cores (67
// TFLOP/s peak), not on the tensor cores, and computes every pair, masked or
// not: a causal row tile's fully masked key tiles are not skipped (neither
// do the Pallas kernels skip them), and a row whose keys are all masked must
// weigh all Lk of them.
//
// Design (the softmax_z.cu tiling): a block of 256 threads (16 x 16) owns a
// tile of rows in shared memory and streams 64-row tiles of the other
// operand. Each thread computes a (RI x 4) block of the tile's scores (owned
// rows ty + 16 i, streamed rows tx + 16 j), summing over d in order with
// fmaf, so K4, K5 and K6 compute every score with bitwise the same
// arithmetic and the backward's P is exactly the P that K4's statistics
// normalise. The [rows, Dh] accumulators live in registers (rows ty + 16 i,
// columns tx + 16 k).
// - K4: 64 query rows a block; keys stream in tiles of 64 with an online
//   softmax. The row max is shared by the 16 threads of a row (a half-warp
//   shuffle); each thread keeps its own partial sum, merged at the end. P
//   goes through shared memory into the P V product.
// - K5: 64 query rows a block (32 for Dh > 128); computes delta for its rows
//   from dO and out, stores it for K6, and streams key tiles: S and dP from
//   the tiles, dS to shared memory, dq += dS k.
// - K6: 64 keys a block (32 for Dh > 128); streams query tiles with their
//   (max, sum, delta): P and dS to shared memory, dv += P^T dO, dk += dS^T q.
// Every block owns its outputs: no atomics, and the same inputs give bitwise
// the same outputs. Keys past Lk get no weight (the TPU kernel's padding of
// Lk to its tile is not copied); query rows past Lq get P = 0.
// Shared memory at Dh 64: K4 66.5 KB, K5 83 KB, K6 100 KB a block; at Dh 256
// the widest (K6, 32 owned keys) takes 215 KB of the 227 KB a block may use.
#include "common.cuh"

#include <cmath>

namespace {

constexpr int kThreads = 256;   // 16 x 16: tx = threadIdx.x & 15, ty = threadIdx.x >> 4
constexpr int kTS = 64;         // rows of a streamed tile (keys in K4, K5; queries in K6)
constexpr int kLdp = kTS + 1;   // row stride of a P or dS tile in shared memory
constexpr int kMaxDh = 256;
constexpr unsigned kFull = 0xffffffffu;

struct FlashArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* pad_add;   // [B, Lk] or nullptr
  const float* attn_add;  // [Lq, Lk] or nullptr
  const float* out;       // K5: the forward's output
  const float* dout;      // K5, K6: the output's gradient
  const float* stats;     // K5, K6: (max, sum) of each row, [B, H, Lq, 2]
  const float* delta;     // K6: rowsum(dO o out), [B, H, Lq]
  float* o;               // K4: out
  float* st;              // K4: stats
  float* dq;              // K5
  float* delta_out;       // K5
  float* dk;              // K6
  float* dv;              // K6
  int B, H, Lq, Lk, Dh;
  float scale;
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The 16 threads tx of a row are lanes 0-15 or 16-31 of a warp.
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Rows [r0, r0 + ROWS) of a row-major [L, Dh] matrix into shared memory with
// row stride ld; zero in rows >= L and in columns Dh..W-1.
template <int ROWS, int W>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int L, int Dh,
                                          int ld) {
  for (int idx = threadIdx.x; idx < ROWS * W; idx += kThreads) {
    const int r = idx / W;
    const int d = idx - r * W;
    const int gr = r0 + r;
    dst[r * ld + d] = (gr < L && d < Dh) ? src[(long long)gr * Dh + d] : 0.f;
  }
}

// s[i][j] = a row (ty + 16 i) . b row (tx + 16 j), summed over d in order.
template <int RI>
__device__ __forceinline__ void tile_dots(float s[RI][4], const float* a, const float* b,
                                          int Dh, int ld, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < Dh; ++d) {
    float x[RI], y[4];
#pragma unroll
    for (int i = 0; i < RI; ++i) x[i] = a[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// acc[i][k] += sum_c p[(ty + 16 i) ldp + c] * m[c ld + tx + 16 k], c < kTS.
template <int RI, int DK>
__device__ __forceinline__ void tile_product(float acc[RI][DK], const float* p, const float* m,
                                             int ld, int ty, int tx) {
  for (int c = 0; c < kTS; ++c) {
    float x[RI], y[DK];
#pragma unroll
    for (int i = 0; i < RI; ++i) x[i] = p[(ty + 16 * i) * kLdp + c];
#pragma unroll
    for (int k = 0; k < DK; ++k) y[k] = m[c * ld + tx + 16 * k];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int k = 0; k < DK; ++k) acc[i][k] = fmaf(x[i], y[k], acc[i][k]);
  }
}

// The key-padding term of key kj < Lk of example b.
__device__ __forceinline__ float pad_term(const FlashArgs& a, int b, int kj) {
  return a.pad_add ? a.pad_add[(long long)b * a.Lk + kj] : 0.f;
}

// The unclamped logit of (query qi < Lq, key kj < Lk) with its padding term
// pd: the same additions, in the same order, as attention.cu and the plain
// version.
__device__ __forceinline__ float raw_logit(const FlashArgs& a, float dot, int qi, int kj,
                                           float pd) {
  const float at = a.attn_add ? a.attn_add[(long long)qi * a.Lk + kj] : 0.f;
  return (dot * a.scale + at) + pd;
}

// ---------------------------------------------------------------------------
// K4: grid (query tiles of 64, H, B).
template <int DK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashArgs a) {
  constexpr int RI = 4, TQ = 16 * RI, W = 16 * DK, ld = W + 1;
  extern __shared__ float smem[];
  float* qs = smem;               // [TQ][ld]
  float* ks = qs + TQ * ld;       // [kTS][ld]
  float* vs = ks + kTS * ld;      // [kTS][ld]
  float* ps = vs + kTS * ld;      // [TQ][kLdp]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, q0 = blockIdx.x * TQ;
  const long long bh = (long long)b * a.H + blockIdx.y;
  const float* kb = a.k + bh * a.Lk * a.Dh;
  const float* vb = a.v + bh * a.Lk * a.Dh;
  load_rows<TQ, W>(qs, a.q + bh * a.Lq * a.Dh, q0, a.Lq, a.Dh, ld);

  float m[RI], l[RI], acc[RI][DK];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < DK; ++k) acc[i][k] = 0.f;
  }
  for (int k0 = 0; k0 < a.Lk; k0 += kTS) {
    __syncthreads();  // Q is loaded; the previous K, V and P tiles are consumed
    load_rows<kTS, W>(ks, kb, k0, a.Lk, a.Dh, ld);
    load_rows<kTS, W>(vs, vb, k0, a.Lk, a.Dh, ld);
    __syncthreads();
    float s[RI][4], pd[4];
    tile_dots<RI>(s, qs, ks, a.Dh, ld, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      pd[j] = kj < a.Lk ? pad_term(a, b, kj) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = min(q0 + ty + 16 * i, a.Lq - 1);  // rows past Lq: computed, never stored
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        s[i][j] = kj < a.Lk ? fmaxf(raw_logit(a, s[i][j], qi, kj, pd[j]), RS_NEG) : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      // key k0 < Lk is in this tile, so the new max is finite
      const float mnew = fmaxf(m[i], row_max(tmax));
      const float corr = expf(m[i] - mnew);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mnew);
        ps[(ty + 16 * i) * kLdp + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * corr + psum;
      m[i] = mnew;
#pragma unroll
      for (int k = 0; k < DK; ++k) acc[i][k] *= corr;
    }
    __syncthreads();
    tile_product<RI, DK>(acc, ps, vs, ld, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) l[i] = row_sum(l[i]);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= a.Lq) continue;
    const long long row = bh * a.Lq + qi;
    if (tx == 0) {
      a.st[row * 2] = m[i];
      a.st[row * 2 + 1] = l[i];
    }
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const int d = tx + 16 * k;
      if (d < a.Dh) a.o[row * a.Dh + d] = acc[i][k] / l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// K5: grid (query tiles of 16 RI, H, B).
template <int RI, int DK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const FlashArgs a) {
  constexpr int TQ = 16 * RI, W = 16 * DK, ld = W + 1;
  extern __shared__ float smem[];
  float* qs = smem;               // [TQ][ld]
  float* dos = qs + TQ * ld;      // [TQ][ld]
  float* ks = dos + TQ * ld;      // [kTS][ld]
  float* vs = ks + kTS * ld;      // [kTS][ld]
  float* dss = vs + kTS * ld;     // [TQ][kLdp]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, q0 = blockIdx.x * TQ;
  const long long bh = (long long)b * a.H + blockIdx.y;
  const float* kb = a.k + bh * a.Lk * a.Dh;
  const float* vb = a.v + bh * a.Lk * a.Dh;
  load_rows<TQ, W>(qs, a.q + bh * a.Lq * a.Dh, q0, a.Lq, a.Dh, ld);
  load_rows<TQ, W>(dos, a.dout + bh * a.Lq * a.Dh, q0, a.Lq, a.Dh, ld);
  __syncthreads();

  // each row's (max, sum) and delta = rowsum(dO o out); rows past Lq get
  // max = +inf, so P = 0 there
  float m[RI], l[RI], dl[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    const bool ok = qi < a.Lq;
    const long long row = bh * a.Lq + qi;
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const int d = tx + 16 * k;
      if (ok && d < a.Dh) part = fmaf(dos[(ty + 16 * i) * ld + d], a.out[row * a.Dh + d], part);
    }
    dl[i] = row_sum(part);
    m[i] = ok ? a.stats[row * 2] : INFINITY;
    l[i] = ok ? a.stats[row * 2 + 1] : 1.f;
    if (ok && tx == 0) a.delta_out[row] = dl[i];
  }

  float acc[RI][DK];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int k = 0; k < DK; ++k) acc[i][k] = 0.f;
  for (int k0 = 0; k0 < a.Lk; k0 += kTS) {
    __syncthreads();  // the previous K, V and dS tiles are consumed
    load_rows<kTS, W>(ks, kb, k0, a.Lk, a.Dh, ld);
    load_rows<kTS, W>(vs, vb, k0, a.Lk, a.Dh, ld);
    __syncthreads();
    float s[RI][4], dp[RI][4], pd[4];
    tile_dots<RI>(s, qs, ks, a.Dh, ld, ty, tx);
    tile_dots<RI>(dp, dos, vs, a.Dh, ld, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      pd[j] = kj < a.Lk ? pad_term(a, b, kj) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = min(q0 + ty + 16 * i, a.Lq - 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float ds = 0.f;
        if (kj < a.Lk) {
          const float raw = raw_logit(a, s[i][j], qi, kj, pd[j]);
          const float p = expf(fmaxf(raw, RS_NEG) - m[i]) / l[i];
          ds = raw >= RS_NEG ? p * (dp[i][j] - dl[i]) : 0.f;
        }
        dss[(ty + 16 * i) * kLdp + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    tile_product<RI, DK>(acc, dss, ks, ld, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= a.Lq) continue;
    const long long row = bh * a.Lq + qi;
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const int d = tx + 16 * k;
      if (d < a.Dh) a.dq[row * a.Dh + d] = acc[i][k] * a.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// K6: grid (key tiles of 16 RI, H, B).
template <int RI, int DK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const FlashArgs a) {
  constexpr int TK = 16 * RI, W = 16 * DK, ld = W + 1;
  extern __shared__ float smem[];
  float* ks = smem;               // [TK][ld]
  float* vs = ks + TK * ld;       // [TK][ld]
  float* qs = vs + TK * ld;       // [kTS][ld]
  float* dos = qs + kTS * ld;     // [kTS][ld]
  float* ps = dos + kTS * ld;     // [TK][kLdp]: P^T
  float* dss = ps + TK * kLdp;    // [TK][kLdp]: dS^T
  float* ms = dss + TK * kLdp;    // [kTS]: the query rows' max, sum and delta
  float* ls = ms + kTS;
  float* dls = ls + kTS;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, k0 = blockIdx.x * TK;
  const long long bh = (long long)b * a.H + blockIdx.y;
  const float* qb = a.q + bh * a.Lq * a.Dh;
  const float* dob = a.dout + bh * a.Lq * a.Dh;
  load_rows<TK, W>(ks, a.k + bh * a.Lk * a.Dh, k0, a.Lk, a.Dh, ld);
  load_rows<TK, W>(vs, a.v + bh * a.Lk * a.Dh, k0, a.Lk, a.Dh, ld);

  float dk[RI][DK], dv[RI][DK];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int k = 0; k < DK; ++k) dk[i][k] = dv[i][k] = 0.f;
  for (int q0 = 0; q0 < a.Lq; q0 += kTS) {
    __syncthreads();  // K, V are loaded; the previous Q, dO, P and dS tiles are consumed
    load_rows<kTS, W>(qs, qb, q0, a.Lq, a.Dh, ld);
    load_rows<kTS, W>(dos, dob, q0, a.Lq, a.Dh, ld);
    if (threadIdx.x < kTS) {
      const int qi = q0 + threadIdx.x;
      const bool ok = qi < a.Lq;            // rows past Lq: P = 0
      const long long row = bh * a.Lq + qi;
      ms[threadIdx.x] = ok ? a.stats[row * 2] : INFINITY;
      ls[threadIdx.x] = ok ? a.stats[row * 2 + 1] : 1.f;
      dls[threadIdx.x] = ok ? a.delta[row] : 0.f;
    }
    __syncthreads();
    float s[RI][4], dp[RI][4];
    tile_dots<RI>(s, ks, qs, a.Dh, ld, ty, tx);    // key ty + 16 i, query tx + 16 j
    tile_dots<RI>(dp, vs, dos, a.Dh, ld, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int kj = k0 + ty + 16 * i;
      const float pd = kj < a.Lk ? pad_term(a, b, kj) : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const int qi = min(q0 + r, a.Lq - 1);
        float p = 0.f, ds = 0.f;
        if (kj < a.Lk) {
          const float raw = raw_logit(a, s[i][j], qi, kj, pd);
          p = expf(fmaxf(raw, RS_NEG) - ms[r]) / ls[r];
          ds = raw >= RS_NEG ? p * (dp[i][j] - dls[r]) : 0.f;
        }
        ps[(ty + 16 * i) * kLdp + r] = p;
        dss[(ty + 16 * i) * kLdp + r] = ds;
      }
    }
    __syncthreads();
    tile_product<RI, DK>(dv, ps, dos, ld, ty, tx);
    tile_product<RI, DK>(dk, dss, qs, ld, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= a.Lk) continue;
    const long long row = bh * a.Lk + kj;
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const int d = tx + 16 * k;
      if (d < a.Dh) {
        a.dk[row * a.Dh + d] = dk[i][k] * a.scale;
        a.dv[row * a.Dh + d] = dv[i][k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
size_t tile_floats(int rows, int DK) { return (size_t)rows * (16 * DK + 1); }

template <typename Kernel>
cudaError_t launch(Kernel kernel, int row_tiles, size_t smem_floats, const FlashArgs& a,
                   cudaStream_t stream) {
  const size_t smem = smem_floats * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(row_tiles, a.H, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_fwd(const FlashArgs& a, cudaStream_t stream) {
  const size_t floats = tile_floats(64 + 2 * kTS, DK) + (size_t)64 * kLdp;
  return launch(flash_fwd_kernel<DK>, cdiv(a.Lq, 64), floats, a, stream);
}

template <int RI, int DK>
cudaError_t launch_dq(const FlashArgs& a, cudaStream_t stream) {
  const size_t floats = tile_floats(2 * 16 * RI + 2 * kTS, DK) + (size_t)16 * RI * kLdp;
  return launch(flash_bwd_dq_kernel<RI, DK>, cdiv(a.Lq, 16 * RI), floats, a, stream);
}

template <int RI, int DK>
cudaError_t launch_dkv(const FlashArgs& a, cudaStream_t stream) {
  const size_t floats =
      tile_floats(2 * 16 * RI + 2 * kTS, DK) + (size_t)2 * 16 * RI * kLdp + 3 * kTS;
  return launch(flash_bwd_dkv_kernel<RI, DK>, cdiv(a.Lk, 16 * RI), floats, a, stream);
}

bool bad_shape(const FlashArgs& a) {
  return a.B < 1 || a.H < 1 || a.Lq < 1 || a.Lk < 1 || a.Dh < 1 || a.Dh > kMaxDh ||
         a.B > 65535 || a.H > 65535;
}

FlashArgs make_args(const float* q, const float* k, const float* v, const float* pad_add,
                    const float* attn_add, int B, int H, int Lq, int Lk, int Dh, float scale) {
  FlashArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.pad_add = pad_add;
  a.attn_add = attn_add;
  a.B = B;
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.Dh = Dh;
  a.scale = scale;
  return a;
}

}  // namespace

// K4. q [B, H, Lq, Dh], k, v [B, H, Lk, Dh], out like q, stats [B, H, Lq, 2];
// pad_add [B, Lk] and attn_add [Lq, Lk] may be null. Returns a cudaError_t.
extern "C" int rs_flash_fwd(const float* q, const float* k, const float* v, const float* pad_add,
                            const float* attn_add, float* out, float* stats, int B, int H, int Lq,
                            int Lk, int Dh, float scale, void* stream) {
  FlashArgs a = make_args(q, k, v, pad_add, attn_add, B, H, Lq, Lk, Dh, scale);
  a.o = out;
  a.st = stats;
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh <= 64) return (int)launch_fwd<4>(a, st);
  if (Dh <= 128) return (int)launch_fwd<8>(a, st);
  return (int)launch_fwd<16>(a, st);
}

// K5: dq like q and delta [B, H, Lq] from the forward's out and stats and
// the output's gradient dout.
extern "C" int rs_flash_bwd_dq(const float* q, const float* k, const float* v,
                               const float* pad_add, const float* attn_add, const float* out,
                               const float* dout, const float* stats, float* dq, float* delta,
                               int B, int H, int Lq, int Lk, int Dh, float scale, void* stream) {
  FlashArgs a = make_args(q, k, v, pad_add, attn_add, B, H, Lq, Lk, Dh, scale);
  a.out = out;
  a.dout = dout;
  a.stats = stats;
  a.dq = dq;
  a.delta_out = delta;
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh <= 64) return (int)launch_dq<4, 4>(a, st);
  if (Dh <= 128) return (int)launch_dq<4, 8>(a, st);
  return (int)launch_dq<2, 16>(a, st);
}

// K6: dk, dv like k from the forward's stats, K5's delta and dout.
extern "C" int rs_flash_bwd_dkv(const float* q, const float* k, const float* v,
                                const float* pad_add, const float* attn_add, const float* dout,
                                const float* stats, const float* delta, float* dk, float* dv,
                                int B, int H, int Lq, int Lk, int Dh, float scale, void* stream) {
  FlashArgs a = make_args(q, k, v, pad_add, attn_add, B, H, Lq, Lk, Dh, scale);
  a.dout = dout;
  a.stats = stats;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh <= 64) return (int)launch_dkv<4, 4>(a, st);
  if (Dh <= 128) return (int)launch_dkv<4, 8>(a, st);
  return (int)launch_dkv<2, 16>(a, st);
}
