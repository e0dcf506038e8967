// Fused post-LN transformer encoder layer, backward (kernel K2 of the port).
//
// Replaces recstudio_tpu/ops/transformer_layer.py:292 _bwd_kernel, the
// Pallas kernel that recomputes the layer's forward for a tile of examples
// in VMEM and then runs the backward chain (:320-372), carrying the twelve
// weight/bias/LayerNorm gradients across its sequential grid (:375-385).
// Here the training forward (transformer_layer.cu) has kept what the chain
// reads (qkv, A, the softmax row statistics, x1, LN1's and LN2's xhat and
// 1/sigma, hpre and the dropped activation h), and the four dropout masks
// are regenerated from the layer call's seed (dropout.cuh). The chain, one
// step after another on one stream (18 launches):
//   1. LN2 backward: dr2, df = dr2 * keep_f; dLN2 scale and offset
//   2. dW2 = df^T h, db2 = colsum(df)
//   3. dhpre = (df W2) * keep_h * act'(hpre)   (act' of the tanh gelu as
//      _act_grad, :191-199, or relu)
//   4. dW1 = dhpre^T x1, db1
//   5. dx1 = dr2 + dhpre W1
//   6. LN1 backward: dr1, do = dr1 * keep_o; dLN1 scale and offset
//   7. dWo = do^T A, dbo
//   8. dA = do Wo
//   9. attention, dq (flash_attention.cu's K5 kernel): P recomputed from
//      the row (max, sum); delta_i = dA_i . A_i = rowsum(dP o P);
//      dS = P o (dP - delta), dP = (dA V^T) o keep; dq = dS K / sqrt(Dh)
//  10. attention, dk and dv (K6's kernel): dv = (P o keep)^T dA,
//      dk = dS^T Q / sqrt(Dh)
//  11. dWqkv = dqkv^T x, dbqkv
//  12. dx = dr1 + dqkv Wqkv
// Every product is written out here; nothing goes to cuBLAS.
//
// Bound on an H100: the eight products do 2 M D (3D + D + 2F) operations
// for each of the data and weight gradients (M = B L rows), the attention
// steps 14 Dh for each (query, key) pair the masks allow, on a few hundred
// MB: bound by operations, in float32 on the SIMT cores (67 TFLOP/s). At
// phase D's shape (B 1024, L 200, d 128) the products are 80 of the 94
// GFLOP; the attention steps' pairs are a third of the B H L^2 under the
// causal mask and right padding, but each costs more (P recomputed, two
// dot products, a Philox draw for its dropout bit).
//
// Design:
// - The products (steps 2-5, 7, 8, 11, 12) run on sgemm_tile.cuh: 128 x
//   128 output tiles (128 x 64, 64 x 128 or 64 x 64 where a side of the
//   output is 64 wide or less, as at d 64), 8 x 8 outputs a thread read as
//   float4s from shared memory, k-slices of 16 staged by cp.async in two
//   buffers (chosen by timing tiles, slices and stages at phase D's and
//   F's shapes: scripts/torch_kernel_sweep.py, PERF.md). The data gradients C = A B (steps 3, 5, 8, 12) fuse their
//   epilogue: the residual gradient, or keep(site) act'(hpre).
// - Weight gradients sum over all M rows without atomics: their kernel
//   cuts the rows into S fixed ranges, each block writes the partial sum
//   of its (output tile, row range), bias column sums with it, and a
//   second launch adds the S partials in order. The ranges are sized to
//   the card (row_plan): the blocks it holds at once (the kernel's
//   occupancy times the SMs, queried once) against the output tiles, so
//   that the grid fills whole waves, as far as the partials' bytes are
//   worth it. The plan is a function of (M, N, K) and the card, never of
//   the data, so the same inputs give bitwise the same gradients.
// - The attention steps (9, 10) run flash_attention.cu's K5 and K6
//   kernels on strided views of the packed [M, 3D] qkv and dqkv rows and
//   the [M, D] A and dA, with dropout of P compiled in
//   (rs_launch_mha_bwd_train): the register tile, cp.async copies, and
//   the skip of tile pairs the masks cover fully (the causal upper half,
//   keys past an example's length); keep bits are drawn only for pairs
//   whose P is not 0. P is exactly K3's: the same score chain and logit
//   (common.cuh), and the (max, sum) K3 stored, (finfo.min, Lk) on a row
//   with no allowed key.
// - LayerNorm's backward (steps 1, 6) is one warp a row; its scale and
//   offset gradients sum per block over G fixed row ranges, then in order.
// dq, dk and dv each belong to one block, which loops over the other
// operand's tiles, so every output of K2 repeats bitwise.
#include "common.cuh"
#include "register_tile.cuh"
#include "sgemm_tile.cuh"

#include <algorithm>
#include <cmath>

namespace {

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
// vec_b: B's rows copied 16 bytes at a time; vec_c: C stored as float4s.
enum Epi { kEpiRes = 0, kEpiDact = 1 };

template <int EPI>
__device__ __forceinline__ float epilogue(float v, long long o, const float* __restrict__ aux,
                                          const DropParams& drop, int site, int act) {
  if (EPI == kEpiRes) return aux ? v + aux[o] : v;
  return v * rs_keep(drop, site, (unsigned long long)o) * act_grad(aux[o], act);
}

template <class T, int EPI>
__global__ void __launch_bounds__(kThreads, kGemmBlocksPerSm)
gemm_nn_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ C, int M, int N, int K, const float* __restrict__ aux,
               DropParams drop, int site, int act, bool vec_b, bool vec_c) {
  __shared__ __align__(16) float smem[T::SMEM];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  float acc[T::TM][T::TN];
  block_product_nn<T>(acc, smem, A, B, M, N, K, m0, n0, vec_b);
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int m = m0 + tile_row(i, ty);
    if (m >= M) continue;
#pragma unroll
    for (int g = 0; g < T::TN / 4; ++g) {
      const int n = n0 + tile_col(4 * g, tx);
      const long long o = (long long)m * N + n;
      if (vec_c && n < N) {
        float4 v = make_float4(epilogue<EPI>(acc[i][4 * g], o, aux, drop, site, act),
                               epilogue<EPI>(acc[i][4 * g + 1], o + 1, aux, drop, site, act),
                               epilogue<EPI>(acc[i][4 * g + 2], o + 2, aux, drop, site, act),
                               epilogue<EPI>(acc[i][4 * g + 3], o + 3, aux, drop, site, act));
        *reinterpret_cast<float4*>(C + o) = v;
      } else if (!vec_c) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) C[o + e] = epilogue<EPI>(acc[i][4 * g + e], o + e, aux, drop, site, act);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Split-row partial sums of dW[N, K] = A^T B, A [M, N], B [M, K] row-major:
// block (k tile, n tile, s) writes part_w[s][n][k] = sum over rows
// [s R, s R + R) of A[m, n] B[m, k]; the blocks of k tile 0 also write
// part_b[s][n] = sum of A[m, n] (the bias gradient) when part_b is set.
template <class T>
__global__ void __launch_bounds__(kThreads, kGemmBlocksPerSm)
gemm_tn_partial_kernel(const float* __restrict__ A, const float* __restrict__ B,
                       float* __restrict__ part_w, float* __restrict__ part_b, int M, int N,
                       int K, int rows_per_split, bool vec_a, bool vec_b, bool vec_w) {
  __shared__ __align__(16) float smem[T::SMEM];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * T::BN, n0 = blockIdx.y * T::BM, s = blockIdx.z;
  const int mb = s * rows_per_split, me = min(M, mb + rows_per_split);
  const bool bias = part_b != nullptr && blockIdx.x == 0;
  float acc[T::TM][T::TN];
  float bsum = 0.f;
  block_product_tn<T>(acc, smem, A, B, N, K, mb, me, n0, k0, vec_a, vec_b, bias, bsum);
  float* pw = part_w + (long long)s * N * K;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int n = n0 + tile_row(i, ty);
    if (n >= N) continue;
#pragma unroll
    for (int g = 0; g < T::TN / 4; ++g) {
      const int k = k0 + tile_col(4 * g, tx);
      const long long o = (long long)n * K + k;
      if (vec_w && k < K) {
        *reinterpret_cast<float4*>(pw + o) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
      } else if (!vec_w) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < K) pw[o + e] = acc[i][4 * g + e];
      }
    }
  }
  if (bias && threadIdx.x < T::BM && n0 + threadIdx.x < N)
    part_b[(long long)s * N + n0 + threadIdx.x] = bsum;
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
#pragma unroll 8
    for (int j = 0; j < S; ++j) s += part1[j * X1 + i];
    out1[i] = s;
  }
  if (part2 && i < X2) {
    float s = 0.f;
#pragma unroll 8
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
// Tiles of the products: 128 rows of the output by 128 columns, 64 on a side
// that is 64 wide or less (d 64: no half-empty tiles).
inline int tile_side(int n) { return n <= 64 ? 4 : 8; }

template <class F>
auto with_tile(int tm, int tn, F f) -> decltype(f(GemmTile<8, 8>())) {
  if (tm == 8 && tn == 8) return f(GemmTile<8, 8>());
  if (tm == 8) return f(GemmTile<8, 4>());
  if (tn == 8) return f(GemmTile<4, 8>());
  return f(GemmTile<4, 4>());
}

// Blocks of the weight-gradient kernel the card holds at once: its
// occupancy times the SMs, queried once.
template <class T>
int tn_resident() {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_tn_partial_kernel<T>,
                                                      kThreads, 0) == cudaSuccess)
      resident = per_sm * sms;
  }
  return resident;
}

constexpr double kPeakOps = 67e12, kPeakBytes = 3.35e12, kGemmShare = 0.5;

// S row ranges of `rows` rows each (a multiple of the k-slice) that cover
// [0, M) once, the last one possibly shorter.
struct RowPlan {
  int S;
  int rows;
};

// The ranges of dW [N, K] = A^T B over M rows of the least estimated time,
// the fewest of equals: S ranges of `per` slices over `tiles` output tiles
// take ceil(tiles S / resident) waves of per + STAGES slices (the pipeline's
// fill), a slice costing a resident block 2 BM BN BK operations at
// kGemmShare of the card's float32 rate shared by all resident blocks; and
// (2 S + 1) (N K + N) floats at the card's memory rate (the partials
// written and read back, the gradients written). At most two waves.
template <class T>
RowPlan row_plan(int M, int N, int K, int resident) {
  resident = resident < 1 ? 1 : resident;
  const int tiles = cdiv(N, T::BM) * cdiv(K, T::BN);
  const int slices = cdiv(M, T::BK);
  const double slice_s = (double)resident * T::BM * T::BN * T::BK * 2.0 / (kPeakOps * kGemmShare);
  const double out_s = ((double)N * K + N) * sizeof(float) / kPeakBytes;
  int max_s = 2 * resident / tiles;
  max_s = max_s < 1 ? 1 : (max_s > slices ? slices : max_s);
  RowPlan best = {1, slices * T::BK};
  double best_t = INFINITY;
  for (int s = 1; s <= max_s; ++s) {
    const int per = cdiv(slices, s);
    if (cdiv(slices, per) != s) continue;  // the ranges of a smaller s
    const double waves = cdiv(tiles * s, resident);
    const double t = waves * (per + T::STAGES) * slice_s + (2.0 * s + 1.0) * out_s;
    if (t < best_t) {
      best_t = t;
      best = {s, per * T::BK};
    }
  }
  return best;
}

RowPlan wgrad_plan(int M, int N, int K) {
  return with_tile(tile_side(N), tile_side(K), [&](auto tile) {
    using T = decltype(tile);
    return row_plan<T>(M, N, K, tn_resident<T>());
  });
}

// Row ranges (blocks) of the LayerNorm partials: a function of M alone.
int ln_groups(int M) {
  const int G = (M + 127) / 128;
  return G < 1 ? 1 : (G > 512 ? 512 : G);
}

long long align4(long long n) { return (n + 3) & ~3LL; }

// The scratch of one call, in floats, each buffer 16-byte aligned: dr2,
// df, dx1, dr1, do, dA [M, D]; dhpre [M, F]; dqkv [M, 3D]; delta [B, H,
// L]; the weight and bias partials of the largest plan; the LayerNorm
// partials [G, D] twice.
struct Work {
  long long MD, MF, delta, part_w, part_b, part_g;
  long long total() const { return 6 * MD + MF + 3 * MD + delta + part_w + part_b + 2 * part_g; }
};

Work work_layout(int B, int L, int D, int F, int H) {
  const int M = B * L;
  const int shapes[4][2] = {{D, F}, {F, D}, {D, D}, {3 * D, D}};  // dW2, dW1, dWo, dWqkv
  Work w;
  w.MD = align4((long long)M * D);
  w.MF = align4((long long)M * F);
  w.delta = align4((long long)B * H * L);
  w.part_w = w.part_b = 0;
  for (const auto& s : shapes) {
    const RowPlan p = wgrad_plan(M, s[0], s[1]);
    w.part_w = std::max(w.part_w, align4((long long)p.S * s[0] * s[1]));
    w.part_b = std::max(w.part_b, align4((long long)p.S * s[0]));
  }
  w.part_g = align4((long long)ln_groups(M) * D);
  return w;
}

cudaError_t gemm_nn(const float* A, const float* B, float* C, int M, int N, int K,
                    const float* aux, int epi, DropParams drop, int site, int act,
                    cudaStream_t stream) {
  return with_tile(8, tile_side(N), [&](auto tile) {
    using T = decltype(tile);
    const dim3 grid(cdiv(M, T::BM), cdiv(N, T::BN));
    const bool vec_b = N % 4 == 0 && aligned16(B), vec_c = N % 4 == 0 && aligned16(C);
    if (epi == kEpiRes)
      gemm_nn_kernel<T, kEpiRes><<<grid, kThreads, 0, stream>>>(A, B, C, M, N, K, aux, drop,
                                                                 site, act, vec_b, vec_c);
    else
      gemm_nn_kernel<T, kEpiDact><<<grid, kThreads, 0, stream>>>(A, B, C, M, N, K, aux, drop,
                                                                  site, act, vec_b, vec_c);
    return cudaGetLastError();
  });
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
                        int K, float* part_w, float* part_b, cudaStream_t stream) {
  RowPlan plan = {1, M};
  cudaError_t err = with_tile(tile_side(N), tile_side(K), [&](auto tile) {
    using T = decltype(tile);
    plan = row_plan<T>(M, N, K, tn_resident<T>());
    const dim3 grid(cdiv(K, T::BN), cdiv(N, T::BM), plan.S);
    gemm_tn_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
        A, B, part_w, part_b, M, N, K, plan.rows, N % 4 == 0 && aligned16(A),
        K % 4 == 0 && aligned16(B), K % 4 == 0 && aligned16(part_w));
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  return reduce(part_w, dw, (long long)N * K, part_b, db, N, plan.S, stream);
}

cudaError_t ln_bwd(const float* dy, const float* xhat, const float* rstd, const float* gamma,
                   float* dr, float* dmask, float* dgamma, float* dbeta, int M, int D,
                   float* part_g, float* part_b, DropParams drop, int site,
                   cudaStream_t stream) {
  const int G = ln_groups(M);
  ln_bwd_kernel<<<G, kLnWarps * 32, 0, stream>>>(dy, xhat, rstd, gamma, dr, dmask, part_g,
                                                 part_b, M, D, drop, site);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(part_g, dgamma, D, part_b, dbeta, D, G, stream);
}

}  // namespace

// Floats of scratch that rs_transformer_layer_bwd needs in `work` on the
// current device (the weight gradients' row ranges depend on the card).
extern "C" long long rs_transformer_layer_bwd_workspace(int B, int L, int D, int F, int H) {
  return work_layout(B, L, D, F, H).total();
}

// The row ranges of a weight gradient dW [N, K] summed over M rows on the
// current device: returns their number S and writes the rows of each
// (a multiple of the k-slice; the last range may be shorter) to *rows.
extern "C" int rs_transformer_layer_bwd_splits(int M, int N, int K, int* rows) {
  const RowPlan p = wgrad_plan(M, N, K);
  *rows = p.rows;
  return p.S;
}

// The backward of rs_transformer_layer_fwd_train. Inputs: x, the masks,
// the weights the chain multiplies by (w_qkv [3D, D], w_o [D, D], w1
// [F, D], w2 [D, F]) and the LayerNorm scales, the forward's residuals
// (qkv, attn, stats, x1, xhat1, rstd1, hpre, h, xhat2, rstd2), the output
// gradient g [B*L, D], and the dropout of the forward call. Outputs: dx and
// the twelve parameter gradients in the [out, in] layout. `work` holds
// work_floats floats, at least rs_transformer_layer_bwd_workspace's.
// Returns a cudaError_t.
extern "C" int rs_transformer_layer_bwd(
    const float* x, const float* pad_add, const float* attn_add, const float* w_qkv,
    const float* w_o, const float* ln1_w, const float* w1, const float* w2, const float* ln2_w,
    const float* qkv, const float* attn, const float* stats, const float* x1,
    const float* xhat1, const float* rstd1, const float* hpre, const float* h,
    const float* xhat2, const float* rstd2, const float* g, float* dx, float* dw_qkv,
    float* db_qkv, float* dw_o, float* db_o, float* dln1_w, float* dln1_b, float* dw1,
    float* db1, float* dw2, float* db2, float* dln2_w, float* dln2_b, float* work,
    long long work_floats, int B, int L, int D, int F, int H, int act, float scale,
    unsigned long long seed, unsigned int threshold, float drop_scale, int drop_active,
    void* stream_ptr) {
  if (B <= 0 || L <= 0 || D <= 0 || F <= 0 || H <= 0 || D % H || D > kLnMaxD ||
      (act != kRelu && act != kGelu))
    return (int)cudaErrorInvalidValue;
  const Work w = work_layout(B, L, D, F, H);
  if (w.total() > work_floats) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int M = B * L;
  const DropParams drop = {seed, threshold, drop_scale, drop_active};
  float* dr2 = work;
  float* df = dr2 + w.MD;
  float* dx1 = df + w.MD;
  float* dr1 = dx1 + w.MD;
  float* dout = dr1 + w.MD;
  float* dA = dout + w.MD;
  float* dhpre = dA + w.MD;
  float* dqkv = dhpre + w.MF;
  float* delta = dqkv + 3 * w.MD;
  float* part_w = delta + w.delta;
  float* part_b = part_w + w.part_w;
  float* part_g = part_b + w.part_b;
  float* part_o = part_g + w.part_g;

  cudaError_t err;
#define RS_TRY(call)             \
  err = (call);                  \
  if (err != cudaSuccess) return (int)err;
  RS_TRY(ln_bwd(g, xhat2, rstd2, ln2_w, dr2, df, dln2_w, dln2_b, M, D, part_g, part_o, drop,
                kSiteFfnOut, stream));
  RS_TRY(weight_grad(df, h, dw2, db2, M, D, F, part_w, part_b, stream));
  RS_TRY(gemm_nn(df, w2, dhpre, M, F, D, hpre, kEpiDact, drop, kSiteFfnHidden, act, stream));
  RS_TRY(weight_grad(dhpre, x1, dw1, db1, M, F, D, part_w, part_b, stream));
  RS_TRY(gemm_nn(dhpre, w1, dx1, M, D, F, dr2, kEpiRes, drop, 0, act, stream));
  RS_TRY(ln_bwd(dx1, xhat1, rstd1, ln1_w, dr1, dout, dln1_w, dln1_b, M, D, part_g, part_o,
                drop, kSiteOut, stream));
  RS_TRY(weight_grad(dout, attn, dw_o, db_o, M, D, D, part_w, part_b, stream));
  RS_TRY(gemm_nn(dout, w_o, dA, M, D, D, nullptr, kEpiRes, drop, 0, act, stream));

  // steps 9 and 10 on the packed rows: q, k, v (and dq, dk, dv) at columns
  // 0, D, 2D of the [M, 3D] rows, head h at h Dh; A and dA [M, D]
  MhaParams p = {};
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
  RS_TRY(rs_launch_mha_bwd_train(p, attn, dA, dqkv, dqkv + D, dqkv + 2 * D, delta, stream));

  RS_TRY(weight_grad(dqkv, x, dw_qkv, db_qkv, M, 3 * D, D, part_w, part_b, stream));
  RS_TRY(gemm_nn(dqkv, w_qkv, dx, M, D, 3 * D, dr1, kEpiRes, drop, 0, act, stream));
#undef RS_TRY
  return (int)cudaSuccess;
}
