// Fused post-LN transformer encoder layer, backward (kernel K2 of the port).
//
// Replaces recstudio_tpu/ops/transformer_layer.py:_bwd_kernel, the Pallas
// kernel that recomputes the layer's forward for a tile of examples in VMEM
// and then runs the backward chain (:320-372), carrying the twelve
// weight/bias/LayerNorm gradients across its sequential grid (:375-385).
// Here the training forward (transformer_layer.cu) has kept what the chain
// reads (qkv, A, the softmax row statistics, x1, LN1's and LN2's xhat and
// 1/sigma, hpre and the dropped activation h), and the four dropout masks
// are regenerated from the layer call's seed (dropout.cuh). The chain, one
// launch per step on one stream:
//   1. LN2 backward: dr2, df = dr2 * keep_f; dLN2 scale and offset
//   2. dW2 = df^T h, db2 = colsum(df)
//   3. dhpre = (df W2) * keep_h * act'(hpre)   (act' of the tanh gelu as
//      _act_grad, :191-199, or relu)
//   4. dW1 = dhpre^T x1, db1
//   5. dx1 = dr2 + dhpre W1
//   6. LN1 backward: dr1, do = dr1 * keep_o; dLN1 scale and offset
//   7. dWo = do^T A, dbo
//   8. dA = do Wo
//   9. attention, dq: per (query tile, head, example), P recomputed from
//      the row (max, sum); D_i = dA_i . A_i = rowsum(dP o P);
//      dS = P o (dP - D), dP = (dA V^T) o keep; dq = dS K / sqrt(Dh)
//  10. attention, dk and dv: per (key tile, head, example), over the query
//      tiles: dv = (P o keep)^T dA, dk = dS^T Q / sqrt(Dh)
//  11. dWqkv = dqkv^T x, dbqkv
//  12. dx = dr1 + dqkv Wqkv
// Every product is written out here; nothing goes to cuBLAS.
//
// Deterministic sums: no float atomics. A weight or bias gradient sums
// over all M = B L rows. Step 2, 4, 7 and 11's kernel splits the rows into
// S fixed ranges (S and the ranges depend on M alone), each block writes
// the partial sum of its (64 x 64 output tile, row range) to a workspace,
// and a second launch adds the S partials in order. LayerNorm's scale and
// offset gradients go the same way, with G fixed row ranges. dq, dk and dv
// each belong to one block, which loops over the other operand's tiles.
// So the same inputs give bitwise the same gradients.
//
// Bound on an H100: the chain's operations are about twice the forward's
// (2 M D (3D + D + 2F) for each of the data and weight gradients, and
// 8 Dh per attended (query, key) pair), on the same few hundred MB, so it
// is bound by operations. This first version computes in float32 on the
// SIMT cores (67 TFLOP/s peak) and recomputes every (query, key) pair,
// masked or not, in steps 9 and 10.
#include "common.cuh"

#include <cmath>

namespace {

constexpr unsigned kFull = 0xffffffffu;
enum Act { kRelu = 1, kGelu = 2 };

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// d act(x) / dx: relu, or the tanh form of gelu (jax.nn.gelu's default).
__device__ __forceinline__ float act_grad(float x, int act) {
  if (act == kRelu) return x > 0.f ? 1.f : 0.f;
  const float c = 0.7978845608028654f, a = 0.044715f;  // sqrt(2 / pi)
  const float t = tanhf(c * (x + a * x * x * x));
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * c * (1.f + 3.f * a * x * x);
}

// ---------------------------------------------------------------------------
// C[M, N] = A[M, K] B[K, N], both row-major, then an epilogue:
//   kEpiRes:  C += aux (a residual gradient; aux may be null)
//   kEpiDact: C *= keep(site) * act'(aux), aux the pre-activation
// 64x64 tile per block of 256 threads, 4x4 outputs per thread.
constexpr int kBM = 64, kBN = 64, kBK = 16;
enum Epi { kEpiRes = 0, kEpiDact = 1 };

template <int EPI>
__global__ void __launch_bounds__(256)
gemm_nn_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ C, int M, int N, int K, const float* __restrict__ aux,
               DropParams drop, int site, int act) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + 256 * i;
      {  // A: 64 rows x 16 k, read along k
        const int r = idx / kBK, kk = idx % kBK, m = m0 + r, k = k0 + kk;
        As[kk][r] = (m < M && k < K) ? A[(long long)m * K + k] : 0.f;
      }
      {  // B: 16 k x 64 columns, read along n
        const int kk = idx / kBN, c = idx % kBN, k = k0 + kk, n = n0 + c;
        Bs[kk][c] = (k < K && n < N) ? B[(long long)k * N + n] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty * 4 + i];
        b[i] = Bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const long long o = (long long)m * N + n;
      if (EPI == kEpiRes) {
        C[o] = aux ? acc[i][j] + aux[o] : acc[i][j];
      } else {
        C[o] = acc[i][j] * rs_keep(drop, site, (unsigned long long)o) * act_grad(aux[o], act);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Split-row partial sums of dW[N, K] = A^T B, A [M, N], B [M, K] row-major:
// block (k tile, n tile, s) writes part_w[s][n][k] = sum over rows
// [s R, s R + R) of A[m, n] B[m, k]; the blocks of k tile 0 also write
// part_b[s][n] = sum of A[m, n] (the bias gradient) when part_b is set.
__global__ void __launch_bounds__(256)
gemm_tn_partial_kernel(const float* __restrict__ A, const float* __restrict__ B,
                       float* __restrict__ part_w, float* __restrict__ part_b, int M, int N,
                       int K, int rows_per_split) {
  __shared__ float As[kBK][kBM + 4];  // [row][n]
  __shared__ float Bs[kBK][kBN + 4];  // [row][k]
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBN, n0 = blockIdx.y * kBM, s = blockIdx.z;
  const int mb = s * rows_per_split, me = min(M, mb + rows_per_split);
  const int tx = tid % 16, ty = tid / 16;
  const bool bias = part_b != nullptr && blockIdx.x == 0;
  float acc[4][4] = {};
  float bsum = 0.f;

  for (int r0 = mb; r0 < me; r0 += kBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + 256 * i;
      const int rr = idx / kBM, c = idx % kBM, m = r0 + rr;
      As[rr][c] = (m < me && n0 + c < N) ? A[(long long)m * N + n0 + c] : 0.f;
      Bs[rr][c] = (m < me && k0 + c < K) ? B[(long long)m * K + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kBK; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[rr][ty * 4 + i];
        b[i] = Bs[rr][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (bias && tid < kBM) {
#pragma unroll
      for (int rr = 0; rr < kBK; ++rr) bsum += As[rr][tid];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k < K) part_w[((long long)s * N + n) * K + k] = acc[i][j];
    }
  }
  if (bias && tid < kBM && n0 + tid < N) part_b[(long long)s * N + n0 + tid] = bsum;
}

// out1[i] = sum_s part1[s][i] (i < X1), and the same for part2 when set:
// the partials are added in the order of s.
__global__ void __launch_bounds__(256)
reduce_partials_kernel(const float* __restrict__ part1, float* __restrict__ out1, long long X1,
                       const float* __restrict__ part2, float* __restrict__ out2, long long X2,
                       int S) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < X1) {
    float s = 0.f;
    for (int j = 0; j < S; ++j) s += part1[j * X1 + i];
    out1[i] = s;
  }
  if (part2 && i < X2) {
    float s = 0.f;
    for (int j = 0; j < S; ++j) s += part2[j * X2 + i];
    out2[i] = s;
  }
}

// ---------------------------------------------------------------------------
// LayerNorm backward over rows of dy [M, D] (D <= 256), one warp a row:
//   dr = (1/sigma) (dy g - mean(dy g) - xhat mean(dy g xhat))   (_ln_bwd)
//   dmask = dr * keep(site)
// and, per block, the partial sums over its rows of dy xhat and dy (the
// scale and offset gradients). Block b owns rows b W + w + i G W.
constexpr int kLnWarps = 8, kLnMaxD = 256, kLnCols = kLnMaxD / 32;

__global__ void __launch_bounds__(kLnWarps * 32)
ln_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ xhat,
              const float* __restrict__ rstd, const float* __restrict__ gamma,
              float* __restrict__ dr, float* __restrict__ dmask, float* __restrict__ part_g,
              float* __restrict__ part_b, int M, int D, DropParams drop, int site) {
  __shared__ float red_g[kLnWarps][kLnMaxD];
  __shared__ float red_b[kLnWarps][kLnMaxD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float pg[kLnCols] = {}, pb[kLnCols] = {};

  for (int row = blockIdx.x * kLnWarps + warp; row < M; row += gridDim.x * kLnWarps) {
    const long long base = (long long)row * D;
    float gx[kLnCols], xh[kLnCols];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int t = 0; t < kLnCols; ++t) {
      const int c = lane + 32 * t;
      gx[t] = xh[t] = 0.f;
      if (c < D) {
        const float g = dy[base + c], x = xhat[base + c];
        gx[t] = g * gamma[c];
        xh[t] = x;
        s1 += gx[t];
        s2 += gx[t] * x;
        pg[t] = fmaf(g, x, pg[t]);
        pb[t] += g;
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float m1 = s1 / D, m2 = s2 / D, inv = rstd[row];
#pragma unroll
    for (int t = 0; t < kLnCols; ++t) {
      const int c = lane + 32 * t;
      if (c < D) {
        const float r = inv * (gx[t] - m1 - xh[t] * m2);
        dr[base + c] = r;
        dmask[base + c] = r * rs_keep(drop, site, (unsigned long long)(base + c));
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kLnCols; ++t) {
    const int c = lane + 32 * t;
    if (c < D) {
      red_g[warp][c] = pg[t];
      red_b[warp][c] = pb[t];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float sg = 0.f, sb = 0.f;
    for (int w = 0; w < kLnWarps; ++w) {
      sg += red_g[w][c];
      sb += red_b[w][c];
    }
    part_g[(long long)blockIdx.x * D + c] = sg;
    part_b[(long long)blockIdx.x * D + c] = sb;
  }
}

// ---------------------------------------------------------------------------
// Attention backward on the packed [B*L, 3D] rows (the MhaParams view of
// the forward): the dq kernel mirrors the forward's layout (4 warps x 4
// query rows, keys in tiles of 32, one key per lane); the dk/dv kernel
// swaps the roles (4 warps x 4 key rows, queries in tiles of 32, one query
// per lane). s is computed with the forward's operand order, so P = exp(s -
// max) / sum is the forward's softmax. dS passes the clamp at finfo.min as
// torch.clamp_min's gradient does (rs_raw_logit, common.cuh): it is cut
// where both masks are finfo.min, which matters only on a row whose keys
// are all masked (P = 1 / Lk there).
constexpr int kTK = 32;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kTQ = kWarps * kRowsPerWarp;

struct MhaBwdParams {
  MhaParams f;         // q, k, v, masks, shapes, scale, stats, drop
  const float* attn;   // A (forward output, dropped), o strides
  const float* dA;     // dL/dA, o strides
  float* dq;           // q, k, v strides (the packed dqkv rows)
  float* dk;
  float* dv;
  float* Di;           // [B, H, Lq]: dA_i . A_i
};

template <int DPL>
__global__ void __launch_bounds__(kWarps * 32)
mha_bwd_dq_kernel(const MhaBwdParams bp) {
  extern __shared__ float smem[];
  const MhaParams& p = bp.f;
  const int Dh = p.Dh;
  float* Ks = smem;                  // [kTK][Dh + 1]
  float* Vs = Ks + kTK * (Dh + 1);   // [kTK][Dh + 1]
  float* Qs = Vs + kTK * (Dh + 1);   // [kTQ][Dh]
  float* Gs = Qs + kTQ * Dh;         // [kTQ][Dh]: dA rows

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const long long ooff = b * p.o_sb + h * p.o_sh;
  const float* ab = bp.attn + ooff;
  const float* gb = bp.dA + ooff;

  for (int i = threadIdx.x; i < kTQ * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i % Dh, qi = q0 + r;
    Qs[i] = qi < p.Lq ? qb[qi * p.q_sl + d] : 0.f;
    Gs[i] = qi < p.Lq ? gb[qi * p.o_sl + d] : 0.f;
  }
  __syncthreads();

  float mrow[kRowsPerWarp], lrow[kRowsPerWarp], drow[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr, qi = q0 + r;
    float s = 0.f;
    if (qi < p.Lq)
      for (int d = lane; d < Dh; d += 32) s = fmaf(Gs[r * Dh + d], ab[qi * p.o_sl + d], s);
    drow[rr] = warp_sum(s);
    mrow[rr] = 0.f;
    lrow[rr] = 1.f;
    if (qi < p.Lq) {
      const long long row = ((long long)b * p.H + h) * p.Lq + qi;
      mrow[rr] = p.stats[row * 2];
      lrow[rr] = p.stats[row * 2 + 1];
      if (lane == 0) bp.Di[row] = drow[rr];
    }
  }

  float acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[rr][t] = 0.f;

  for (int k0 = 0; k0 < p.Lk; k0 += kTK) {
    __syncthreads();  // the previous K/V tile is consumed
    for (int i = threadIdx.x; i < kTK * Dh; i += blockDim.x) {
      const int j = i / Dh, d = i % Dh, kj = k0 + j;
      const bool ok = kj < p.Lk;
      Ks[j * (Dh + 1) + d] = ok ? kb[kj * p.k_sl + d] : 0.f;
      Vs[j * (Dh + 1) + d] = ok ? vb[kj * p.v_sl + d] : 0.f;
    }
    __syncthreads();

    const int kj = k0 + lane;
    const bool kvalid = kj < p.Lk;
    const float* krow = Ks + lane * (Dh + 1);
    const float* vrow = Vs + lane * (Dh + 1);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr, qi = q0 + r;
      const float* qrow = Qs + r * Dh;
      const float* grow = Gs + r * Dh;
      float s = 0.f, dpv = 0.f;
      for (int d = 0; d < Dh; ++d) {
        s = fmaf(qrow[d], krow[d], s);
        dpv = fmaf(grow[d], vrow[d], dpv);
      }
      float ds = 0.f;
      if (kvalid && qi < p.Lq) {
        const float raw = masked_raw_logit(p, s, b, qi, kj);
        const float pr = expf(fmaxf(raw, RS_NEG) - mrow[rr]) / lrow[rr];
        const float keep = rs_keep(p.drop, kSiteAttn,
                                   (((unsigned long long)b * p.H + h) * p.Lq + qi) *
                                           (unsigned long long)p.Lk + kj);
        if (raw >= RS_NEG) ds = pr * (dpv * keep - drow[rr]);
      }
      for (int j = 0; j < kTK; ++j) {
        const float w = __shfl_sync(kFull, ds, j);
        const float* kr = Ks + j * (Dh + 1);
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          const int d = lane + 32 * t;
          if (d < Dh) acc[rr][t] = fmaf(w, kr[d], acc[rr][t]);
        }
      }
    }
  }

  float* dqb = bp.dq + b * p.q_sb + h * p.q_sh;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi >= p.Lq) continue;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) dqb[qi * p.q_sl + d] = acc[rr][t] * p.scale;
    }
  }
}

template <int DPL>
__global__ void __launch_bounds__(kWarps * 32)
mha_bwd_dkv_kernel(const MhaBwdParams bp) {
  extern __shared__ float smem[];
  const MhaParams& p = bp.f;
  const int Dh = p.Dh;
  float* Kr = smem;                  // [kTQ][Dh]: this block's keys
  float* Vr = Kr + kTQ * Dh;         // [kTQ][Dh]
  float* Qs = Vr + kTQ * Dh;         // [kTK][Dh + 1]: a tile of queries
  float* Gs = Qs + kTK * (Dh + 1);   // [kTK][Dh + 1]: their dA rows

  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * kTQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* gb = bp.dA + b * p.o_sb + h * p.o_sh;
  const long long row0 = ((long long)b * p.H + h) * p.Lq;

  for (int i = threadIdx.x; i < kTQ * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i % Dh, kj = j0 + r;
    Kr[i] = kj < p.Lk ? kb[kj * p.k_sl + d] : 0.f;
    Vr[i] = kj < p.Lk ? vb[kj * p.v_sl + d] : 0.f;
  }

  float acc_k[kRowsPerWarp][DPL], acc_v[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc_k[rr][t] = acc_v[rr][t] = 0.f;

  for (int q0 = 0; q0 < p.Lq; q0 += kTK) {
    __syncthreads();  // keys are loaded; the previous query tile is consumed
    for (int i = threadIdx.x; i < kTK * Dh; i += blockDim.x) {
      const int j = i / Dh, d = i % Dh, qi = q0 + j;
      const bool ok = qi < p.Lq;
      Qs[j * (Dh + 1) + d] = ok ? qb[qi * p.q_sl + d] : 0.f;
      Gs[j * (Dh + 1) + d] = ok ? gb[qi * p.o_sl + d] : 0.f;
    }
    __syncthreads();

    const int qi = q0 + lane;
    const bool qvalid = qi < p.Lq;
    float m_i = 0.f, l_i = 1.f, d_i = 0.f;
    if (qvalid) {
      m_i = p.stats[(row0 + qi) * 2];
      l_i = p.stats[(row0 + qi) * 2 + 1];
      d_i = bp.Di[row0 + qi];
    }
    const float* qrow = Qs + lane * (Dh + 1);
    const float* grow = Gs + lane * (Dh + 1);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr, kj = j0 + r;
      const float* krow = Kr + r * Dh;
      const float* vrow = Vr + r * Dh;
      float s = 0.f, dpv = 0.f;
      for (int d = 0; d < Dh; ++d) {
        s = fmaf(qrow[d], krow[d], s);
        dpv = fmaf(grow[d], vrow[d], dpv);
      }
      float ds = 0.f, pk = 0.f;
      if (qvalid && kj < p.Lk) {
        const float raw = masked_raw_logit(p, s, b, qi, kj);
        const float pr = expf(fmaxf(raw, RS_NEG) - m_i) / l_i;
        const float keep = rs_keep(p.drop, kSiteAttn,
                                   ((unsigned long long)(row0 + qi)) * p.Lk + kj);
        if (raw >= RS_NEG) ds = pr * (dpv * keep - d_i);
        pk = pr * keep;
      }
      for (int j = 0; j < kTK; ++j) {
        const float wv = __shfl_sync(kFull, pk, j);
        const float wk = __shfl_sync(kFull, ds, j);
        const float* qr = Qs + j * (Dh + 1);
        const float* gr = Gs + j * (Dh + 1);
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          const int d = lane + 32 * t;
          if (d < Dh) {
            acc_v[rr][t] = fmaf(wv, gr[d], acc_v[rr][t]);
            acc_k[rr][t] = fmaf(wk, qr[d], acc_k[rr][t]);
          }
        }
      }
    }
  }

  float* dkb = bp.dk + b * p.k_sb + h * p.k_sh;
  float* dvb = bp.dv + b * p.v_sb + h * p.v_sh;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int kj = j0 + warp * kRowsPerWarp + rr;
    if (kj >= p.Lk) continue;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) {
        dkb[kj * p.k_sl + d] = acc_k[rr][t] * p.scale;
        dvb[kj * p.v_sl + d] = acc_v[rr][t];
      }
    }
  }
}

template <int DPL>
cudaError_t launch_attn_bwd(const MhaBwdParams& bp, cudaStream_t stream) {
  const MhaParams& p = bp.f;
  const int Dh = p.Dh;
  const size_t smem = sizeof(float) * (2 * kTK * (Dh + 1) + 2 * kTQ * Dh);
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_dq_kernel<DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mha_bwd_dkv_kernel<DPL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 gq((p.Lq + kTQ - 1) / kTQ, p.H, p.B);
  mha_bwd_dq_kernel<DPL><<<gq, kWarps * 32, smem, stream>>>(bp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gk((p.Lk + kTQ - 1) / kTQ, p.H, p.B);
  mha_bwd_dkv_kernel<DPL><<<gk, kWarps * 32, smem, stream>>>(bp);
  return cudaGetLastError();
}

cudaError_t attn_bwd(const MhaBwdParams& bp, cudaStream_t stream) {
  const int Dh = bp.f.Dh;
  if (bp.f.B > 65535 || bp.f.H > 65535) return cudaErrorInvalidValue;
  if (Dh <= 32) return launch_attn_bwd<1>(bp, stream);
  if (Dh <= 64) return launch_attn_bwd<2>(bp, stream);
  if (Dh <= 128) return launch_attn_bwd<4>(bp, stream);
  if (Dh <= 256) return launch_attn_bwd<8>(bp, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The fixed row ranges of the deterministic sums (functions of M alone).
struct Splits {
  int rows;  // rows per range of the weight-gradient partials
  int S;     // number of those ranges
  int G;     // blocks (row ranges) of the LayerNorm partials
};

Splits splits(int M) {
  Splits s;
  int S = (M + 511) / 512;
  S = S < 1 ? 1 : (S > 64 ? 64 : S);
  s.rows = ((M + S - 1) / S + kBK - 1) / kBK * kBK;
  s.S = (M + s.rows - 1) / s.rows;
  int G = (M + 127) / 128;
  s.G = G < 1 ? 1 : (G > 512 ? 512 : G);
  return s;
}

long long workspace_floats(int B, int L, int D, int F, int H) {
  const long long M = (long long)B * L;
  const Splits s = splits((int)M);
  const long long nk = (long long)(3 * D) * D > (long long)D * F ? (long long)(3 * D) * D
                                                                 : (long long)D * F;
  const long long n = 3 * D > F ? 3 * D : F;
  // dr2, df, dx1, dr1, do, dA [M, D]; dhpre [M, F]; dqkv [M, 3D]; Di;
  // weight and bias partials; LayerNorm partials
  return M * D * 6 + M * F + M * 3 * D + (long long)B * H * L + s.S * nk + s.S * n +
         2LL * s.G * D;
}

cudaError_t gemm_nn(const float* A, const float* B, float* C, int M, int N, int K,
                    const float* aux, int epi, DropParams drop, int site, int act,
                    cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (epi == kEpiRes)
    gemm_nn_kernel<kEpiRes><<<grid, 256, 0, stream>>>(A, B, C, M, N, K, aux, drop, site, act);
  else
    gemm_nn_kernel<kEpiDact><<<grid, 256, 0, stream>>>(A, B, C, M, N, K, aux, drop, site, act);
  return cudaGetLastError();
}

cudaError_t reduce(const float* p1, float* o1, long long X1, const float* p2, float* o2,
                   long long X2, int S, cudaStream_t stream) {
  const long long X = X1 > X2 ? X1 : X2;
  reduce_partials_kernel<<<(unsigned)((X + 255) / 256), 256, 0, stream>>>(p1, o1, X1, p2, o2,
                                                                          X2, S);
  return cudaGetLastError();
}

// dW [N, K] = A^T B and db [N] = colsum(A), through the partial buffers.
cudaError_t weight_grad(const float* A, const float* B, float* dw, float* db, int M, int N,
                        int K, const Splits& s, float* part_w, float* part_b,
                        cudaStream_t stream) {
  const dim3 grid((K + kBN - 1) / kBN, (N + kBM - 1) / kBM, s.S);
  gemm_tn_partial_kernel<<<grid, 256, 0, stream>>>(A, B, part_w, part_b, M, N, K, s.rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(part_w, dw, (long long)N * K, part_b, db, N, s.S, stream);
}

cudaError_t ln_bwd(const float* dy, const float* xhat, const float* rstd, const float* gamma,
                   float* dr, float* dmask, float* dgamma, float* dbeta, int M, int D,
                   const Splits& s, float* part_g, float* part_b, DropParams drop, int site,
                   cudaStream_t stream) {
  ln_bwd_kernel<<<s.G, kLnWarps * 32, 0, stream>>>(dy, xhat, rstd, gamma, dr, dmask, part_g,
                                                   part_b, M, D, drop, site);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(part_g, dgamma, D, part_b, dbeta, D, s.G, stream);
}

}  // namespace

// Floats of scratch that rs_transformer_layer_bwd needs in `work`.
extern "C" long long rs_transformer_layer_bwd_workspace(int B, int L, int D, int F, int H) {
  return workspace_floats(B, L, D, F, H);
}

// The backward of rs_transformer_layer_fwd_train. Inputs: x, the masks,
// the weights the chain multiplies by (w_qkv [3D, D], w_o [D, D], w1
// [F, D], w2 [D, F]) and the LayerNorm scales, the forward's residuals
// (qkv, attn, stats, x1, xhat1, rstd1, hpre, h, xhat2, rstd2), the output
// gradient g [B*L, D], and the dropout of the forward call. Outputs: dx and
// the twelve parameter gradients in the [out, in] layout. Returns a
// cudaError_t.
extern "C" int rs_transformer_layer_bwd(
    const float* x, const float* pad_add, const float* attn_add, const float* w_qkv,
    const float* w_o, const float* ln1_w, const float* w1, const float* w2, const float* ln2_w,
    const float* qkv, const float* attn, const float* stats, const float* x1,
    const float* xhat1, const float* rstd1, const float* hpre, const float* h,
    const float* xhat2, const float* rstd2, const float* g, float* dx, float* dw_qkv,
    float* db_qkv, float* dw_o, float* db_o, float* dln1_w, float* dln1_b, float* dw1,
    float* db1, float* dw2, float* db2, float* dln2_w, float* dln2_b, float* work, int B,
    int L, int D, int F, int H, int act, float scale, unsigned long long seed,
    unsigned int threshold, float drop_scale, int drop_active, void* stream_ptr) {
  if (B <= 0 || L <= 0 || D <= 0 || F <= 0 || H <= 0 || D % H || D > kLnMaxD ||
      (act != kRelu && act != kGelu))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int M = B * L;
  const Splits s = splits(M);
  const DropParams drop = {seed, threshold, drop_scale, drop_active};
  const long long MD = (long long)M * D;
  float* dr2 = work;
  float* df = dr2 + MD;
  float* dx1 = df + MD;
  float* dr1 = dx1 + MD;
  float* dout = dr1 + MD;
  float* dA = dout + MD;
  float* dhpre = dA + MD;
  float* dqkv = dhpre + (long long)M * F;
  float* Di = dqkv + 3 * MD;
  float* part_w = Di + (long long)B * H * L;
  const long long nk = (long long)(3 * D) * D > (long long)D * F ? (long long)(3 * D) * D
                                                                 : (long long)D * F;
  float* part_b = part_w + s.S * nk;
  float* part_g = part_b + (long long)s.S * (3 * D > F ? 3 * D : F);
  float* part_o = part_g + (long long)s.G * D;

  cudaError_t err;
#define RS_TRY(call)             \
  err = (call);                  \
  if (err != cudaSuccess) return (int)err;
  RS_TRY(ln_bwd(g, xhat2, rstd2, ln2_w, dr2, df, dln2_w, dln2_b, M, D, s, part_g, part_o, drop,
                kSiteFfnOut, stream));
  RS_TRY(weight_grad(df, h, dw2, db2, M, D, F, s, part_w, part_b, stream));
  RS_TRY(gemm_nn(df, w2, dhpre, M, F, D, hpre, kEpiDact, drop, kSiteFfnHidden, act, stream));
  RS_TRY(weight_grad(dhpre, x1, dw1, db1, M, F, D, s, part_w, part_b, stream));
  RS_TRY(gemm_nn(dhpre, w1, dx1, M, D, F, dr2, kEpiRes, drop, 0, act, stream));
  RS_TRY(ln_bwd(dx1, xhat1, rstd1, ln1_w, dr1, dout, dln1_w, dln1_b, M, D, s, part_g, part_o,
                drop, kSiteOut, stream));
  RS_TRY(weight_grad(dout, attn, dw_o, db_o, M, D, D, s, part_w, part_b, stream));
  RS_TRY(gemm_nn(dout, w_o, dA, M, D, D, nullptr, kEpiRes, drop, 0, act, stream));

  MhaBwdParams bp = {};
  MhaParams& p = bp.f;
  const int Dh = D / H;
  p.q = qkv;
  p.k = qkv + D;
  p.v = qkv + 2 * D;
  p.pad_add = pad_add;
  p.attn_add = attn_add;
  p.B = B;
  p.H = H;
  p.Lq = L;
  p.Lk = L;
  p.Dh = Dh;
  p.q_sb = p.k_sb = p.v_sb = (long long)L * 3 * D;
  p.q_sh = p.k_sh = p.v_sh = Dh;
  p.q_sl = p.k_sl = p.v_sl = 3 * D;
  p.o_sb = (long long)L * D;
  p.o_sh = Dh;
  p.o_sl = D;
  p.scale = scale;
  p.stats = const_cast<float*>(stats);
  p.drop = drop;
  bp.attn = attn;
  bp.dA = dA;
  bp.dq = dqkv;
  bp.dk = dqkv + D;
  bp.dv = dqkv + 2 * D;
  bp.Di = Di;
  RS_TRY(attn_bwd(bp, stream));

  RS_TRY(weight_grad(dqkv, x, dw_qkv, db_qkv, M, 3 * D, D, s, part_w, part_b, stream));
  RS_TRY(gemm_nn(dqkv, w_qkv, dx, M, D, 3 * D, dr1, kEpiRes, drop, 0, act, stream));
#undef RS_TRY
  return (int)cudaSuccess;
}
