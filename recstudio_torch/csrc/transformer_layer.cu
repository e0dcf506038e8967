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
// less than recomputing four GEMMs. Eval mode launches the TRAIN = false
// instantiations of the same kernels.
//
// Bound on an H100: a layer is 2 M D (3D + D + 2F) operations in its four
// products (M = B L rows) and 4 D for each (query, key) pair the masks
// allow in its attention, on M (2 D + ...) floats: at the serving and
// training shapes (L = 20..200, D = 64..128, F = 128) about 16 operations a
// byte in the products, so bound by operations, in float32 on the SIMT
// cores (67 TFLOP/s). At phase D's shape (B 1024, L 200, d 128) the
// products are 40.3 of its 47.2 GFLOP. The bf16 matmul inputs that the JAX
// package offers under train.precision: bf16 (_mm_bf16_default) are not
// ported, since the port serves and trains in float32.
//
// Design: a whole layer does not fit one block (qkv alone is 300 KB per
// example at L = 200, D = 128), so the layer is a chain of five launches on
// one stream, with the intermediates (qkv, A, x1, h) in device memory:
//   1. qkv = x Wqkv^T + b
//   2. the attention kernel of attention.cu (K3) on strided views of qkv
//   3. x1 = LN1((A Wo^T + bo) * keep_o + x)
//   4. h = act(x1 W1^T + b1) * keep_h   (gelu in the tanh form of
//      jax.nn.gelu, or relu)
//   5. out = LN2((h W2^T + b2) * keep_f + x1)
// The four products run on sgemm_tile.cuh (block_product_nt: weights in
// PyTorch's [out, in] layout, so both operands are read along k and staged
// transposed by 4-byte cp.async copies into k-slices of 16 in two buffers;
// 8 x 8 outputs a thread read as float4s), with their epilogues fused:
// - steps 1 and 4 (bias_act_kernel): 128 x 128 output tiles, 64 wide
//   where that pads N less (N = 192 at d 64) and for step 4 in training
//   (its Philox draw and tanh per element cost half its product), 64 rows
//   where the grid of 128-row tiles would hold fewer blocks than the card
//   holds at once (the kernel's occupancy times the SMs, queried once:
//   phase A's 2,560 rows). Bias, activation, dropout and the
//   pre-activation in registers, stored as float4s where the row length
//   and pointers allow.
// - steps 3 and 5 (residual_ln_kernel): a block owns BM full rows of the
//   output (BN >= D: 128 x 64 at D <= 64, 128 x 128 at D <= 128, 64 x 256
//   at D <= 256, with 64 rows as above). bias, dropout and residual are
//   added in registers; LayerNorm is two-pass (mean, then mean of squared
//   deviations, as _ln_fwd) over the D real columns only, each row
//   reduced over the 16 threads that hold it (a half-warp) with shuffles.
// The plan is a function of (M, N, K) and the card, never of the data, and
// every output belongs to one block: no atomics, so K1 repeats bitwise.
// The TPU's tiling (_choose_tiles' VMEM budget, packing several examples
// per attention group behind a block-diagonal mask) is an MXU device and is
// not carried over: attention here is per example, which is the same
// function.
#include "common.cuh"
#include "register_tile.cuh"
#include "sgemm_tile.cuh"

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

constexpr int kLnMaxD = 256;

// Four consecutive elements v[0..3] of row-major storage at p + o, columns
// n.. of a row of N: one float4 where vec (N a multiple of 4, p 16-byte
// aligned), else the ones with n + e < N.
__device__ __forceinline__ void load4(float (&v)[4], const float* __restrict__ p, long long o,
                                      int n, int N, bool vec) {
  if (vec) {
    if (n < N) {
      const float4 t = *reinterpret_cast<const float4*>(p + o);
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
      return;
    }
    v[0] = v[1] = v[2] = v[3] = 0.f;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = n + e < N ? p[o + e] : 0.f;
}

__device__ __forceinline__ void store4(float* __restrict__ p, long long o, const float (&v)[4],
                                       int n, int N, bool vec) {
  if (vec) {
    if (n < N) *reinterpret_cast<float4*>(p + o) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (n + e < N) p[o + e] = v[e];
}

// Steps 1 and 4: C[M, N] = act(A[M, K] W[N, K]^T + bias[N]). TRAIN also
// writes the pre-activation to Cpre and multiplies C by the keep factor
// of `site` at index m N + n. vec: N a multiple of 4, bias, C and Cpre
// 16-byte aligned.
template <class T, bool TRAIN>
__global__ void __launch_bounds__(kThreads, kGemmBlocksPerSm)
bias_act_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, float* __restrict__ C, int M, int N, int K,
                int act, float* __restrict__ Cpre, DropParams drop, int site, bool vec) {
  __shared__ __align__(16) float smem[T::SMEM];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  float acc[T::TM][T::TN];
  block_product_nt<T>(acc, smem, A, W, M, N, K, m0, n0);
#pragma unroll
  for (int g = 0; g < T::TN / 4; ++g) {
    const int n = n0 + tile_col(4 * g, tx);
    float b[4];
    load4(b, bias, n, n, N, vec);
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const int m = m0 + tile_row(i, ty);
      if (m >= M) continue;
      const long long o = (long long)m * N + n;
      float pre[4], v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pre[e] = acc[i][4 * g + e] + b[e];
        v[e] = activate(pre[e], act);
        if (TRAIN) v[e] *= rs_keep(drop, site, (unsigned long long)(o + e));
      }
      if (TRAIN) store4(Cpre, o, pre, n, N, vec);
      store4(C, o, v, n, N, vec);
    }
  }
}

// Steps 3 and 5: out[M, D] = LN(y) * gamma + beta, y = (A[M, K] W[D, K]^T +
// bias) * keep(site, m D + c) + res (keep 1 in eval), D <= T::BN: a block
// owns T::BM full rows. TRAIN also writes xhat = (y - mean) / sigma and
// rstd = 1 / sigma of each row. Columns c >= D of the tile are zeros of
// the zero-padded W and enter neither the mean nor the variance. vec: D a
// multiple of 4 and every row pointer 16-byte aligned.
template <class T, bool TRAIN>
__global__ void __launch_bounds__(kThreads, kGemmBlocksPerSm)
residual_ln_kernel(const float* __restrict__ A, const float* __restrict__ W,
                   const float* __restrict__ bias, const float* __restrict__ res,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   float* __restrict__ out, int M, int D, int K, float eps,
                   float* __restrict__ xhat, float* __restrict__ rstd, DropParams drop,
                   int site, bool vec) {
  __shared__ __align__(16) float smem[T::SMEM];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * T::BM;
  float acc[T::TM][T::TN];
  block_product_nt<T>(acc, smem, A, W, M, D, K, m0, 0);
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int m = m0 + tile_row(i, ty);
    const bool row = m < M;
    const long long base = (long long)(row ? m : 0) * D;
    // y in acc[i], zero outside the real columns; the row sum alongside
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < T::TN / 4; ++g) {
      const int c = tile_col(4 * g, tx);
      float b[4], r[4];
      load4(b, bias, c, c, D, vec);
      load4(r, res, base + c, row ? c : D, D, vec);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float y = acc[i][4 * g + e] + b[e];
        if (TRAIN) y *= rs_keep(drop, site, (unsigned long long)(base + c + e));
        y += r[e];
        y = row && c + e < D ? y : 0.f;
        acc[i][4 * g + e] = y;
        s += y;
      }
    }
    // the 16 threads of a row are one half-warp: every lane reduces
    const float mu = row_sum(s) / (float)D;
    float q = 0.f;
#pragma unroll
    for (int g = 0; g < T::TN / 4; ++g) {
      const int c = tile_col(4 * g, tx);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dv = c + e < D ? acc[i][4 * g + e] - mu : 0.f;
        q = fmaf(dv, dv, q);
      }
    }
    const float inv = rsqrtf(row_sum(q) / (float)D + eps);
    if (!row) continue;
#pragma unroll
    for (int g = 0; g < T::TN / 4; ++g) {
      const int c = tile_col(4 * g, tx);
      float gm[4], bt[4], xh[4], v[4];
      load4(gm, gamma, c, c, D, vec);
      load4(bt, beta, c, c, D, vec);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xh[e] = (acc[i][4 * g + e] - mu) * inv;
        v[e] = xh[e] * gm[e] + bt[e];
      }
      store4(out, base + c, v, c, D, vec);
      if (TRAIN) store4(xhat, base + c, xh, c, D, vec);
    }
    if (TRAIN && tx == 0) rstd[m] = inv;
  }
}

// ---------------------------------------------------------------------------
// Tiles: TM, TN outputs a thread (BM = 16 TM rows, BN = 16 TN columns).
struct Tile {
  int tm, tn;
};

// LN: the 64 x 256 tile of the LayerNorm products at D > 128 exists too.
template <bool LN, class F>
auto with_tile(Tile t, F f) -> decltype(f(GemmTile<8, 8>())) {
  if constexpr (LN) {
    if (t.tn == 16) return f(GemmTile<4, 16>());
  }
  if (t.tm == 8 && t.tn == 8) return f(GemmTile<8, 8>());
  if (t.tm == 8) return f(GemmTile<8, 4>());
  if (t.tn == 8) return f(GemmTile<4, 8>());
  return f(GemmTile<4, 4>());
}

// Blocks of a kernel the card holds at once: its occupancy times the SMs,
// queried once for each kernel.
template <class Kernel>
int resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
}

template <class T, bool LN>
int resident() {
  static int r = 0;
  if (r == 0) {
    if constexpr (LN)
      r = resident_blocks(residual_ln_kernel<T, true>);
    else
      r = resident_blocks(bias_act_kernel<T, true>);
  }
  return r;
}

// The tile of a product with N output columns over M rows. LN (steps 3
// and 5): one tile across the D = N columns, 64, 128 or 256 wide (the last
// only at 64 rows). Step 4 in training (train: the pre-activation stored
// and a keep bit drawn for every element) 64 wide: its epilogue is as
// long as half its product, and narrower tiles give the card twice the
// blocks to overlap it with (scripts/torch_kernel_sweep.py k1gemm).
// Otherwise the width of 64 or 128 that pads N the least, 128 on a tie.
// Rows: 128, or 64 where the grid of 128-row tiles would hold fewer blocks
// than the card holds at once.
Tile gemm_tile(int M, int N, bool ln, bool train) {
  Tile t;
  if (ln)
    t.tn = N <= 64 ? 4 : N <= 128 ? 8 : 16;
  else
    t.tn = train || cdiv(N, 64) * 64 < cdiv(N, 128) * 128 ? 4 : 8;
  if (t.tn == 16) return {4, 16};
  t.tm = 8;
  const int blocks = cdiv(M, 128) * (ln ? 1 : cdiv(N, 16 * t.tn));
  const int held =
      ln ? with_tile<true>(t, [](auto tile) { return resident<decltype(tile), true>(); })
         : with_tile<false>(t, [](auto tile) { return resident<decltype(tile), false>(); });
  if (blocks < held) t.tm = 4;
  return t;
}

// Cpre == nullptr: eval (no pre-activation, no dropout).
cudaError_t bias_act(const float* A, const float* W, const float* bias, float* C, int M, int N,
                     int K, int act, cudaStream_t stream, float* Cpre = nullptr,
                     DropParams drop = {}, int site = 0) {
  return with_tile<false>(gemm_tile(M, N, false, Cpre != nullptr), [&](auto tile) {
    using T = decltype(tile);
    const dim3 grid(cdiv(M, T::BM), cdiv(N, T::BN));
    const bool vec = N % 4 == 0 && aligned16(bias) && aligned16(C) && (!Cpre || aligned16(Cpre));
    if (Cpre)
      bias_act_kernel<T, true><<<grid, kThreads, 0, stream>>>(A, W, bias, C, M, N, K, act, Cpre,
                                                              drop, site, vec);
    else
      bias_act_kernel<T, false><<<grid, kThreads, 0, stream>>>(A, W, bias, C, M, N, K, act,
                                                               nullptr, drop, site, vec);
    return cudaGetLastError();
  });
}

// xhat == nullptr: eval (no LN residuals, no dropout).
cudaError_t residual_ln(const float* A, const float* W, const float* bias, const float* res,
                        const float* gamma, const float* beta, float* out, int M, int D, int K,
                        float eps, cudaStream_t stream, float* xhat = nullptr,
                        float* rstd = nullptr, DropParams drop = {}, int site = 0) {
  if (D > kLnMaxD || (xhat && !rstd)) return cudaErrorInvalidValue;
  return with_tile<true>(gemm_tile(M, D, true, xhat != nullptr), [&](auto tile) {
    using T = decltype(tile);
    const bool vec = D % 4 == 0 && aligned16(bias) && aligned16(res) && aligned16(gamma) &&
                     aligned16(beta) && aligned16(out) && (!xhat || aligned16(xhat));
    const int blocks = cdiv(M, T::BM);
    if (xhat)
      residual_ln_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
          A, W, bias, res, gamma, beta, out, M, D, K, eps, xhat, rstd, drop, site, vec);
    else
      residual_ln_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
          A, W, bias, res, gamma, beta, out, M, D, K, eps, nullptr, nullptr, drop, site, vec);
    return cudaGetLastError();
  });
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

// The output tiles (rows, columns) of K1's four products on the current
// device in eval (train = 0) or training mode, written to tiles[0..7] in
// the order qkv, Wo, W1, W2.
extern "C" void rs_transformer_layer_fwd_tiles(int M, int D, int F, int train, int* tiles) {
  const Tile t[4] = {gemm_tile(M, 3 * D, false, false), gemm_tile(M, D, true, train),
                     gemm_tile(M, F, false, train), gemm_tile(M, D, true, train)};
  for (int i = 0; i < 4; ++i) {
    tiles[2 * i] = 16 * t[i].tm;
    tiles[2 * i + 1] = 16 * t[i].tn;
  }
}

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
  cudaError_t err = bias_act(x, w_qkv, b_qkv, qkv, M, 3 * D, D, kNone, stream);
  if (err != cudaSuccess) return (int)err;
  err = rs_launch_mha(packed_qkv_view(qkv, pad_add, attn_add, attn, B, L, D, H, scale), stream);
  if (err != cudaSuccess) return (int)err;
  err = residual_ln(attn, w_o, b_o, x, ln1_w, ln1_b, x1, M, D, D, eps, stream);
  if (err != cudaSuccess) return (int)err;
  err = bias_act(x1, w1, b1, h, M, F, D, act, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)residual_ln(h, w2, b2, x1, ln2_w, ln2_b, out, M, D, F, eps, stream);
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
  cudaError_t err = bias_act(x, w_qkv, b_qkv, qkv, M, 3 * D, D, kNone, stream);
  if (err != cudaSuccess) return (int)err;
  MhaParams p = packed_qkv_view(qkv, pad_add, attn_add, attn, B, L, D, H, scale);
  p.stats = stats;
  p.drop = drop;
  err = rs_launch_mha_train(p, stream);
  if (err != cudaSuccess) return (int)err;
  err = residual_ln(attn, w_o, b_o, x, ln1_w, ln1_b, x1, M, D, D, eps, stream, xhat1,
                         rstd1, drop, kSiteOut);
  if (err != cudaSuccess) return (int)err;
  err = bias_act(x1, w1, b1, h, M, F, D, act, stream, hpre, drop, kSiteFfnHidden);
  if (err != cudaSuccess) return (int)err;
  return (int)residual_ln(h, w2, b2, x1, ln2_w, ln2_b, out, M, D, F, eps, stream, xhat2,
                               rstd2, drop, kSiteFfnOut);
}
