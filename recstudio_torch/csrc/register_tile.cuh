// The register tile of the attention kernels (attention.cu: K3;
// flash_attention.cu: K4, K5, K6) and of the catalog query gradient
// (softmax_z.cu: K8), shared so that all compute a score the same way. A block of kThreads = 256 threads is 16 x 16: tx = threadIdx.x & 15
// and ty = threadIdx.x >> 4. A thread owns rows ty + 16 i of the block's
// tile and streamed rows tx + 16 j. Tiles sit in shared memory with a row
// stride LD that is an odd number of 16-byte words, so the float4 reads of
// the 16 streamed rows of a quarter-warp meet no bank conflict.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The 16 threads tx of a row are lanes 0-15 or 16-31 of a warp.
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// cp.async copies of 16 or 4 bytes; src_bytes 0 fills the destination with
// zeros (src must still be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

// Blocks an SM can hold by shared memory (227 KB, 1 KB of it reserved for
// each block), at most `cap`: the register budget __launch_bounds__ gives.
constexpr int blocks_per_sm(size_t floats, int cap = 4) {
  const size_t n = 232448 / (floats * sizeof(float) + 1024);
  return n < 1 ? 1 : n > (size_t)cap ? cap : (int)n;
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + ROWS) of a strided [L, Dh] operand into shared memory
// (row stride LD), columns Dh..W-1 and rows >= L zero. Issued, not waited.
template <int ROWS, int W, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long sl, int r0,
                                          int L, int Dh, bool vec) {
  if (vec) {
    constexpr int Q4 = W / 4;
    for (int idx = threadIdx.x; idx < ROWS * Q4; idx += kThreads) {
      const int r = idx / Q4, c = (idx - r * Q4) * 4, gr = r0 + r;
      const bool ok = gr < L && c < Dh;
      cp_async16(dst + r * LD + c, ok ? src + gr * sl + c : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * W; idx += kThreads) {
      const int r = idx / W, c = idx - r * W, gr = r0 + r;
      const bool ok = gr < L && c < Dh;
      cp_async4(dst + r * LD + c, ok ? src + gr * sl + c : src, ok ? 4 : 0);
    }
  }
}

// s[i][j] = q row (ty + 16 i) . k row (tx + 16 j): fmaf over d in order.
template <int RI, int CJ, int LD>
__device__ __forceinline__ void score_dots(float s[RI][CJ], const float* qs, const float* ks,
                                           int Dh, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
  const int Dh4 = Dh & ~3;
#pragma unroll 1
  for (int d = 0; d < Dh4; d += 4) {
    float4 x[RI], y[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) x[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < CJ; ++j) y[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        float a = s[i][j];
        a = fmaf(x[i].x, y[j].x, a);
        a = fmaf(x[i].y, y[j].y, a);
        a = fmaf(x[i].z, y[j].z, a);
        s[i][j] = fmaf(x[i].w, y[j].w, a);
      }
  }
  for (int d = Dh4; d < Dh; ++d) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        s[i][j] = fmaf(qs[(ty + 16 * i) * LD + d], ks[(tx + 16 * j) * LD + d], s[i][j]);
  }
}

// Accumulator column k of thread tx: groups of VEC adjacent columns, so the
// P V product reads V with 8- or 16-byte loads.
template <int DK>
struct Cols {
  static constexpr int VEC = DK >= 4 ? 4 : DK;
  __device__ static __forceinline__ int col(int k, int tx) {
    return (k / VEC) * 16 * VEC + tx * VEC + k % VEC;
  }
};

// acc[i][k] += sum_c ps[(ty + 16 i) LDP + c] vs[c LD + col(k)], c < TK.
template <int RI, int DK, int TK, int LD, int LDP>
__device__ __forceinline__ void pv_product(float acc[RI][DK], const float* ps, const float* vs,
                                           int ty, int tx) {
  constexpr int VEC = Cols<DK>::VEC;
#pragma unroll 1
  for (int c = 0; c < TK; c += 4) {
    float4 x[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) x[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * LDP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float y[DK];
      const float* row = vs + (c + cc) * LD + tx * VEC;
#pragma unroll
      for (int g = 0; g < DK / VEC; ++g) {
        if (VEC == 4) {
          const float4 t = *reinterpret_cast<const float4*>(row + g * 64);
          y[g * VEC] = t.x;
          y[g * VEC + 1] = t.y;
          y[g * VEC + 2] = t.z;
          y[g * VEC + 3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(row + g * 32);
          y[g * VEC] = t.x;
          y[g * VEC + 1] = t.y;
        }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float w = cc == 0 ? x[i].x : cc == 1 ? x[i].y : cc == 2 ? x[i].z : x[i].w;
#pragma unroll
        for (int k = 0; k < DK; ++k) acc[i][k] = fmaf(w, y[k], acc[i][k]);
      }
    }
  }
}

}  // namespace
