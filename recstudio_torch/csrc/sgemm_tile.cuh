// Register-tiled float32 block products on the SIMT cores: the matrix
// products of the fused layer's forward (transformer_layer.cu, K1) and
// backward (transformer_layer_bwd.cu, K2), free of any epilogue so that
// each kernel fuses its own.
//
// Bound on an H100: a product of M x K by K x N does 2 M N K operations on
// (M K + K N + M N) 4 bytes; at the layer's widths (K, N >= 64, M = B L in
// the hundreds of thousands) that is 16 or more operations a byte, above
// the float32 ridge (67 TFLOP/s over 3.35 TB/s, 20 a byte) or near it, so
// the work is bound by operations once shared memory keeps up with the
// FMA pipes.
//
// Design. A block of 256 threads (16 x 16: ty = threadIdx.x >> 4, tx =
// threadIdx.x & 15) owns a BM x BN tile of the output, BM = 16 TM, BN = 16
// TN (TM 4 or 8, TN 4, 8 or 16); thread (ty, tx) owns rows tile_row(i, ty)
// = 64 (i / 4) + 4 ty + i % 4 and columns tile_col(j, tx) = 64 (j / 4) + 4
// tx + j % 4, a TM x TN block in registers. Both operands sit in shared
// memory k-major (as[k][m], bs[k][n]), so for each k a thread reads its TM
// values of A and its TN values of B as float4s (TM / 4 + TN / 4 reads for
// TM TN FMAs: 4 for 64 at 8 x 8, 5 at 4 x 16) and a warp's reads meet no
// bank conflict (two rows of A, 64 consecutive columns of B). The k axis is
// walked in slices of BK staged by cp.async in STAGES buffers, so the
// copies of the next slices overlap the FMAs of this one:
// - rows of an operand whose k index is the row (B of C = A B; A and B of
//   dW = A^T B) are copied as they lie, 16 bytes at a time where the row
//   length and the pointer allow, else 4;
// - an operand whose rows run along k (A of C = A B and of C = A W^T, both
//   [rows, K] row-major; W of C = A W^T, PyTorch's [out, in] weight) is
//   transposed while it is staged: each element is its own 4-byte copy to
//   as[k][m] or bs[k][n]; at the row stride BM + 4 (BN + 4) a warp's 32
//   copies (two rows, sixteen k) land two to a bank.
// The 16 threads tx of one row group are the lanes 0-15 or 16-31 of a warp
// (tid = 16 ty + tx), so an epilogue can reduce a row of the tile with
// row_sum (register_tile.cuh) and no shared memory.
// Elements past the operands' edges are copied as zeros, so ragged tiles
// need no other care; the caller stores only the real outputs.
#pragma once

#include <cuda_runtime.h>

#include "register_tile.cuh"

namespace {

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

// Blocks of 256 threads that hold at most 128 registers a thread: two an SM
// (the __launch_bounds__ of the kernels built on these products).
constexpr int kGemmBlocksPerSm = 2;

template <int TM_, int TN_, int BK_ = 16, int STAGES_ = 2>
struct GemmTile {
  static_assert((TM_ == 4 || TM_ == 8) && (TN_ == 4 || TN_ == 8 || TN_ == 16),
                "4 or 8 rows, 4, 8 or 16 columns a thread");
  static constexpr int TM = TM_, TN = TN_, BK = BK_, STAGES = STAGES_;
  static constexpr int BM = 16 * TM, BN = 16 * TN;
  static constexpr int LDA = BM + 4, LDB = BN + 4;     // row strides of as[k][m], bs[k][n]
  static constexpr int STAGE = BK * (LDA + LDB);       // floats of one buffer
  static constexpr int SMEM = STAGES * STAGE;
};

__device__ __forceinline__ int tile_row(int i, int ty) { return (i >> 2) * 64 + ty * 4 + (i & 3); }
__device__ __forceinline__ int tile_col(int j, int tx) { return (j >> 2) * 64 + tx * 4 + (j & 3); }

// dst[r][c] (row stride LD) = src[(r0 + r) ld + c0 + c] for r < ROWS, c <
// COLS; zero where r0 + r >= rend or c0 + c >= cend. Issued, not waited.
// vec: 16-byte copies (ld, c0 and cend multiples of 4, src 16-byte aligned).
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long ld, int r0,
                                           int rend, int c0, int cend, bool vec) {
  if (vec) {
    constexpr int Q = COLS / 4;
    for (int idx = threadIdx.x; idx < ROWS * Q; idx += kThreads) {
      const int r = idx / Q, c = (idx - r * Q) * 4;
      const bool ok = r0 + r < rend && c0 + c < cend;
      cp_async16(dst + r * LD + c, ok ? src + (long long)(r0 + r) * ld + c0 + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * COLS; idx += kThreads) {
      const int r = idx / COLS, c = idx - r * COLS;
      const bool ok = r0 + r < rend && c0 + c < cend;
      cp_async4(dst + r * LD + c, ok ? src + (long long)(r0 + r) * ld + c0 + c : src,
                ok ? 4 : 0);
    }
  }
}

// The transpose: dst[c][r] (row stride LD) = src[(r0 + r) ld + c0 + c].
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_cols(float* dst, const float* src, long long ld, int r0,
                                           int rend, int c0, int cend) {
  for (int idx = threadIdx.x; idx < ROWS * COLS; idx += kThreads) {
    const int r = idx / COLS, c = idx - r * COLS;
    const bool ok = r0 + r < rend && c0 + c < cend;
    cp_async4(dst + c * LD + r, ok ? src + (long long)(r0 + r) * ld + c0 + c : src, ok ? 4 : 0);
  }
}

// acc[i][j] += sum over the BK k of one buffer: as[k][tile_row(i)] bs[k][tile_col(j)].
template <class T>
__device__ __forceinline__ void slice_fma(float (&acc)[T::TM][T::TN], const float* as,
                                          const float* bs, int ty, int tx) {
#pragma unroll
  for (int k = 0; k < T::BK; ++k) {
    float a[T::TM], b[T::TN];
#pragma unroll
    for (int g = 0; g < T::TM / 4; ++g) {
      const float4 t = *reinterpret_cast<const float4*>(as + k * T::LDA + g * 64 + ty * 4);
      a[4 * g] = t.x;
      a[4 * g + 1] = t.y;
      a[4 * g + 2] = t.z;
      a[4 * g + 3] = t.w;
    }
#pragma unroll
    for (int g = 0; g < T::TN / 4; ++g) {
      const float4 t = *reinterpret_cast<const float4*>(bs + k * T::LDB + g * 64 + tx * 4);
      b[4 * g] = t.x;
      b[4 * g + 1] = t.y;
      b[4 * g + 2] = t.z;
      b[4 * g + 3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The pipeline over `slices` k-slices: stage(t, as, bs) issues the copies of
// slice t into a buffer; each slice is then multiplied into acc, and
// visit(as) (if any) sees its A buffer before the next is staged over it.
// Every slice's terms are added in k order, so the result does not depend
// on the number of stages.
template <class T, class Stage, class Visit>
__device__ __forceinline__ void pipeline(float (&acc)[T::TM][T::TN], float* smem, int slices,
                                         Stage stage, Visit visit) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < slices) stage(s, smem + s * T::STAGE, smem + s * T::STAGE + T::BK * T::LDA);
    cp_async_commit();
  }
  for (int t = 0; t < slices; ++t) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // slice t has landed; slice t - 1's buffer is free
    const int next = t + T::STAGES - 1;
    if (next < slices) {
      float* buf = smem + (next % T::STAGES) * T::STAGE;
      stage(next, buf, buf + T::BK * T::LDA);
    }
    cp_async_commit();
    const float* as = smem + (t % T::STAGES) * T::STAGE;
    slice_fma<T>(acc, as, as + T::BK * T::LDA, ty, tx);
    visit(as);
  }
  cp_async_wait<0>();
}

struct NoVisit {
  __device__ void operator()(const float*) const {}
};

// acc = the block's tile of C = A B, rows m0.., columns n0..: A [M, K] and B
// [K, N] row-major. vec_b: 16-byte copies of B's rows (N a multiple of 4,
// B 16-byte aligned). Needs T::SMEM floats of shared memory.
template <class T>
__device__ __forceinline__ void block_product_nn(float (&acc)[T::TM][T::TN], float* smem,
                                                 const float* A, const float* B, int M, int N,
                                                 int K, int m0, int n0, bool vec_b) {
  pipeline<T>(acc, smem, (K + T::BK - 1) / T::BK,
              [&](int t, float* as, float* bs) {
                const int k0 = t * T::BK;
                stage_cols<T::BM, T::BK, T::LDA>(as, A, K, m0, M, k0, K);
                stage_rows<T::BK, T::BN, T::LDB>(bs, B, N, k0, K, n0, N, vec_b);
              },
              NoVisit());
}

// acc = the block's tile of C = A W^T, rows m0.., columns n0..: A [M, K] and
// W [N, K] row-major (a weight in PyTorch's [out, in] layout), both read
// along k and staged transposed. Needs T::SMEM floats of shared memory.
template <class T>
__device__ __forceinline__ void block_product_nt(float (&acc)[T::TM][T::TN], float* smem,
                                                 const float* A, const float* W, int M, int N,
                                                 int K, int m0, int n0) {
  pipeline<T>(acc, smem, (K + T::BK - 1) / T::BK,
              [&](int t, float* as, float* bs) {
                const int k0 = t * T::BK;
                stage_cols<T::BM, T::BK, T::LDA>(as, A, K, m0, M, k0, K);
                stage_cols<T::BN, T::BK, T::LDB>(bs, W, K, n0, N, k0, K);
              },
              NoVisit());
}

// acc = the block's tile of dW = A^T B over rows [mb, me), rows n0.. and
// columns k0.. of dW: A [M, N] and B [M, K] row-major. vec_a, vec_b: 16-byte
// copies of A's and B's rows. With sum_cols, thread x < BM adds A's column
// n0 + x over the rows, in order, to colsum.
template <class T>
__device__ __forceinline__ void block_product_tn(float (&acc)[T::TM][T::TN], float* smem,
                                                 const float* A, const float* B, int N, int K,
                                                 int mb, int me, int n0, int k0, bool vec_a,
                                                 bool vec_b, bool sum_cols, float& colsum) {
  pipeline<T>(acc, smem, (me - mb + T::BK - 1) / T::BK,
              [&](int t, float* as, float* bs) {
                const int r0 = mb + t * T::BK;
                stage_rows<T::BK, T::BM, T::LDA>(as, A, N, r0, me, n0, N, vec_a);
                stage_rows<T::BK, T::BN, T::LDB>(bs, B, K, r0, me, k0, K, vec_b);
              },
              [&](const float* as) {
                if (sum_cols && threadIdx.x < T::BM) {
#pragma unroll
                  for (int r = 0; r < T::BK; ++r) colsum += as[r * T::LDA + threadIdx.x];
                }
              });
}

}  // namespace
