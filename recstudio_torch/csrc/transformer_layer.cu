// Fused post-LN transformer encoder layer, forward (kernel K1 of the port).
//
// Replaces recstudio_tpu/ops/transformer_layer.py:_fwd_kernel, the Pallas
// kernel that runs a whole layer in VMEM for a tile of examples:
//   qkv = x Wqkv + b;  per head A = softmax(max(Q K^T / sqrt(Dh) + masks,
//   finfo.min)) V;  x1 = LN1(x + A Wo + bo);
//   out = LN2(x1 + act(x1 W1 + b1) W2 + b2).
//
// Training mode (rs_transformer_layer_fwd_train) adds the four dropout
// sites of the Pallas kernel, drawn from dropout.cuh's Philox stream, and
// keeps what the backward (K2, transformer_layer_bwd.cu) needs besides the
// intermediates it already writes:
//   P:    dropped inside the attention kernel; its row (max, sum) are kept
//   o:    (A Wo^T + bo) * keep_o in step 3's epilogue; LN1's xhat, 1/sigma
//   hact: act(hpre) * keep_h in step 4's epilogue; hpre is kept
//   f:    (h W2^T + b2) * keep_f in step 5's epilogue; LN2's xhat, 1/sigma
// The Pallas backward keeps only x and recomputes the layer in VMEM; on the
// card device memory is not that constraint, and reading these back costs
// less than recomputing four GEMMs. Eval mode launches the same code as
// before training mode existed (the TRAIN = false instantiations).
//
// Bound on an H100: at the serving shapes (L = 20..200, D = 64..128,
// F = 128) a layer is 2 M D (3D + D + 2F) + 4 B L^2 D operations on
// M = B L rows of D floats, some 60 MFLOP per example against under 1 MB,
// so it is bound by operations. This first version computes in float32 on
// the SIMT cores (67 TFLOP/s peak); the bf16 matmul inputs that the JAX
// package offers under train.precision: bf16 (_mm_bf16_default) are not
// ported, since this slice serves in float32.
//
// Design: a whole layer does not fit one block (qkv alone is 300 KB per
// example at L = 200, D = 128), so the layer is a chain of five launches on
// one stream, with the intermediates (qkv, A, x1, h) in device memory:
//   1. tiled GEMM  qkv = x Wqkv^T + b
//   2. the attention kernel of attention.cu on strided views of qkv
//   3. GEMM whose block owns 16 full rows (D <= 256), with the epilogue
//      + bias + residual x, LayerNorm1 -> x1
//   4. tiled GEMM  h = act(x1 W1^T + b1)   (gelu in the tanh form of
//      jax.nn.gelu, or relu)
//   5. as 3 with W2, b2, residual x1, LayerNorm2 -> out
// The TPU's tiling (_choose_tiles' VMEM budget, packing several examples
// per attention group behind a block-diagonal mask) is an MXU device and is
// not carried over: attention here is per example, which is the same
// function. Weights are in PyTorch's [out, in] layout, so every product
// reads both operands along the reduction dimension. LayerNorm is two-pass
// (mean, then mean of squared deviations), as _ln_fwd.
#include "common.cuh"

#include <cmath>

namespace {

enum Act { kNone = 0, kRelu = 1, kGelu = 2 };

__device__ __forceinline__ float activate(float x, int act) {
  if (act == kRelu) return fmaxf(x, 0.f);
  if (act == kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
  }
  return x;
}

// C[M, N] = act(A[M, K] W[N, K]^T + bias[N]); 64x64 tile per block of 256
// threads, 4x4 outputs per thread, K in steps of 16. TRAIN also writes the
// pre-activation to Cpre and multiplies C by the keep factor of `site`.
constexpr int kBM = 64, kBN = 64, kBK = 16;

template <bool TRAIN>
__global__ void __launch_bounds__(256)
gemm_bias_act_kernel(const float* __restrict__ A, const float* __restrict__ W,
                     const float* __restrict__ bias, float* __restrict__ C,
                     int M, int N, int K, int act, float* __restrict__ Cpre,
                     DropParams drop, int site) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Ws[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tx = tid % 16, ty = tid / 16;  // outputs rows ty*4.., cols tx*4..
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // 64 rows x 16 k of each operand: 4 values per thread, read along k
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + 256 * i;
      const int r = idx / kBK, kk = idx % kBK;
      const int k = k0 + kk;
      const int am = m0 + r, wn = n0 + r;
      As[kk][r] = (am < M && k < K) ? A[(long long)am * K + k] : 0.f;
      Ws[kk][r] = (wn < N && k < K) ? W[(long long)wn * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty * 4 + i];
        w[i] = Ws[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
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
      if (TRAIN) {
        const float pre = acc[i][j] + bias[n];
        Cpre[o] = pre;
        C[o] = activate(pre, act) * rs_keep(drop, site, (unsigned long long)o);
      } else {
        C[o] = activate(acc[i][j] + bias[n], act);
      }
    }
  }
}

// out[M, D] = LN(A[M, K] W[D, K]^T + bias + res) * gamma + beta, D <= 256.
// A block owns 16 full rows; thread t computes row t / 16 at columns
// t % 16 + 16 j, then each warp normalises two rows from shared memory.
// TRAIN drops the projection before the residual, (A W^T + bias) * keep +
// res, and also writes xhat = (y - mean) / sigma and 1/sigma of each row.
constexpr int kLnRows = 16, kLnMaxD = 256;

template <bool TRAIN>
__global__ void __launch_bounds__(256)
gemm_residual_ln_kernel(const float* __restrict__ A, const float* __restrict__ W,
                        const float* __restrict__ bias, const float* __restrict__ res,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        float* __restrict__ out, int M, int D, int K, float eps,
                        float* __restrict__ xhat, float* __restrict__ rstd,
                        DropParams drop, int site) {
  __shared__ float As[kBK][kLnRows];
  __shared__ float Ws[kBK][kLnMaxD + 1];
  __shared__ float Ys[kLnRows][kLnMaxD + 1];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kLnRows;
  const int r = tid / 16, c0 = tid % 16;
  float acc[kLnMaxD / 16] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    {
      const int rr = tid / kBK, kk = tid % kBK, m = m0 + rr, k = k0 + kk;
      As[kk][rr] = (m < M && k < K) ? A[(long long)m * K + k] : 0.f;
    }
    for (int idx = tid; idx < D * kBK; idx += 256) {
      const int n = idx / kBK, kk = idx % kBK, k = k0 + kk;
      Ws[kk][n] = k < K ? W[(long long)n * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float a = As[kk][r];
#pragma unroll
      for (int j = 0; j < kLnMaxD / 16; ++j) {
        const int c = c0 + 16 * j;
        if (c < D) acc[j] = fmaf(a, Ws[kk][c], acc[j]);
      }
    }
    __syncthreads();
  }

  const int m = m0 + r;
#pragma unroll
  for (int j = 0; j < kLnMaxD / 16; ++j) {
    const int c = c0 + 16 * j;
    if (c >= D) continue;
    if (TRAIN) {
      Ys[r][c] = m < M ? (acc[j] + bias[c]) *
                                 rs_keep(drop, site, (unsigned long long)m * D + c) +
                             res[(long long)m * D + c]
                       : 0.f;
    } else {
      Ys[r][c] = acc[j] + bias[c] + (m < M ? res[(long long)m * D + c] : 0.f);
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int rr = warp * 2; rr < warp * 2 + 2; ++rr) {
    const int row = m0 + rr;
    if (row >= M) continue;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += Ys[rr][c];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / D;
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float dv = Ys[rr][c] - mu;
      q = fmaf(dv, dv, q);
    }
    for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float inv = rsqrtf(q / D + eps);
    for (int c = lane; c < D; c += 32)
      out[(long long)row * D + c] = (Ys[rr][c] - mu) * inv * gamma[c] + beta[c];
    if (TRAIN) {
      for (int c = lane; c < D; c += 32) xhat[(long long)row * D + c] = (Ys[rr][c] - mu) * inv;
      if (lane == 0) rstd[row] = inv;
    }
  }
}

// Cpre == nullptr: eval (no pre-activation, no dropout).
cudaError_t gemm_bias_act(const float* A, const float* W, const float* bias, float* C,
                          int M, int N, int K, int act, cudaStream_t stream,
                          float* Cpre = nullptr, DropParams drop = {}, int site = 0) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (Cpre)
    gemm_bias_act_kernel<true><<<grid, 256, 0, stream>>>(A, W, bias, C, M, N, K, act, Cpre,
                                                         drop, site);
  else
    gemm_bias_act_kernel<false><<<grid, 256, 0, stream>>>(A, W, bias, C, M, N, K, act,
                                                          nullptr, drop, site);
  return cudaGetLastError();
}

// xhat == nullptr: eval (no LN residuals, no dropout).
cudaError_t gemm_residual_ln(const float* A, const float* W, const float* bias,
                             const float* res, const float* gamma, const float* beta,
                             float* out, int M, int D, int K, float eps,
                             cudaStream_t stream, float* xhat = nullptr,
                             float* rstd = nullptr, DropParams drop = {}, int site = 0) {
  if (D > kLnMaxD || (xhat && !rstd)) return cudaErrorInvalidValue;
  const int blocks = (M + kLnRows - 1) / kLnRows;
  if (xhat)
    gemm_residual_ln_kernel<true><<<blocks, 256, 0, stream>>>(
        A, W, bias, res, gamma, beta, out, M, D, K, eps, xhat, rstd, drop, site);
  else
    gemm_residual_ln_kernel<false><<<blocks, 256, 0, stream>>>(
        A, W, bias, res, gamma, beta, out, M, D, K, eps, nullptr, nullptr, drop, site);
  return cudaGetLastError();
}

MhaParams packed_qkv_view(const float* qkv, const float* pad_add, const float* attn_add,
                          float* attn, int B, int L, int D, int H, float scale) {
  const int Dh = D / H;
  MhaParams p = {};
  p.q = qkv;
  p.k = qkv + D;
  p.v = qkv + 2 * D;
  p.pad_add = pad_add;
  p.attn_add = attn_add;
  p.out = attn;
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
  return p;
}

bool bad_shape(int B, int L, int D, int F, int H, int act) {
  return B <= 0 || L <= 0 || D <= 0 || F <= 0 || H <= 0 || D % H || D > kLnMaxD ||
         (act != kRelu && act != kGelu);
}

}  // namespace

// x, out: [B*L, D]; weights in [out, in] layout: w_qkv [3D, D], w_o [D, D],
// w1 [F, D], w2 [D, F]; pad_add [B, L] and attn_add [L, L] additive masks
// (either may be null); scratch: qkv [B*L, 3D], attn and x1 [B*L, D],
// h [B*L, F]. act: 1 relu, 2 gelu (tanh form). Returns a cudaError_t.
extern "C" int rs_transformer_layer_fwd(
    const float* x, const float* pad_add, const float* attn_add,
    const float* w_qkv, const float* b_qkv, const float* w_o, const float* b_o,
    const float* ln1_w, const float* ln1_b, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* ln2_w, const float* ln2_b,
    float* qkv, float* attn, float* x1, float* h, float* out,
    int B, int L, int D, int F, int H, int act, float eps, float scale, void* stream_ptr) {
  if (bad_shape(B, L, D, F, H, act)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int M = B * L;
  cudaError_t err = gemm_bias_act(x, w_qkv, b_qkv, qkv, M, 3 * D, D, kNone, stream);
  if (err != cudaSuccess) return (int)err;
  err = rs_launch_mha(packed_qkv_view(qkv, pad_add, attn_add, attn, B, L, D, H, scale), stream);
  if (err != cudaSuccess) return (int)err;
  err = gemm_residual_ln(attn, w_o, b_o, x, ln1_w, ln1_b, x1, M, D, D, eps, stream);
  if (err != cudaSuccess) return (int)err;
  err = gemm_bias_act(x1, w1, b1, h, M, F, D, act, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)gemm_residual_ln(h, w2, b2, x1, ln2_w, ln2_b, out, M, D, F, eps, stream);
}

// Training forward: as rs_transformer_layer_fwd, with dropout (seed,
// threshold, scale; active = 0 for p == 0) and the residuals of the
// backward: stats [B, H, L, 2] (softmax row max and sum), xhat1 and xhat2
// [B*L, D], rstd1 and rstd2 [B*L], hpre [B*L, F]; h holds the dropped
// activation act(hpre) * keep_h.
extern "C" int rs_transformer_layer_fwd_train(
    const float* x, const float* pad_add, const float* attn_add,
    const float* w_qkv, const float* b_qkv, const float* w_o, const float* b_o,
    const float* ln1_w, const float* ln1_b, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* ln2_w, const float* ln2_b,
    float* qkv, float* attn, float* x1, float* h, float* out,
    float* stats, float* xhat1, float* rstd1, float* hpre, float* xhat2, float* rstd2,
    int B, int L, int D, int F, int H, int act, float eps, float scale,
    unsigned long long seed, unsigned int threshold, float drop_scale, int drop_active,
    void* stream_ptr) {
  if (bad_shape(B, L, D, F, H, act)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int M = B * L;
  const DropParams drop = {seed, threshold, drop_scale, drop_active};
  cudaError_t err = gemm_bias_act(x, w_qkv, b_qkv, qkv, M, 3 * D, D, kNone, stream);
  if (err != cudaSuccess) return (int)err;
  MhaParams p = packed_qkv_view(qkv, pad_add, attn_add, attn, B, L, D, H, scale);
  p.stats = stats;
  p.drop = drop;
  err = rs_launch_mha_train(p, stream);
  if (err != cudaSuccess) return (int)err;
  err = gemm_residual_ln(attn, w_o, b_o, x, ln1_w, ln1_b, x1, M, D, D, eps, stream, xhat1,
                         rstd1, drop, kSiteOut);
  if (err != cudaSuccess) return (int)err;
  err = gemm_bias_act(x1, w1, b1, h, M, F, D, act, stream, hpre, drop, kSiteFfnHidden);
  if (err != cudaSuccess) return (int)err;
  return (int)gemm_residual_ln(h, w2, b2, x1, ln2_w, ln2_b, out, M, D, F, eps, stream, xhat2,
                               rstd2, drop, kSiteFfnOut);
}
