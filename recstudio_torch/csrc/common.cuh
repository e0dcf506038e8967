// Shared declarations of the port's CUDA kernels (sm_90a, float32).
#pragma once

#include <cuda_runtime.h>
#include <cfloat>

#include "dropout.cuh"

// jnp.finfo(float32).min: masked logits are clamped here, never -inf, so a
// row whose keys are all masked stays finite (softmax over equal values).
#define RS_NEG (-FLT_MAX)

// Strided view of multi-head attention operands: element (b, h, row, d) of
// a tensor lives at ptr[b * sb + h * sh + row * sl + d]. The [B, H, L, Dh]
// layout of ops/attention.py and the packed [B*L, 3D] qkv rows of the fused
// layer are both such views, so one kernel serves both.
struct MhaParams {
  const float* q;
  const float* k;
  const float* v;
  const float* pad_add;   // [B, Lk] additive key-padding mask, or nullptr
  const float* attn_add;  // [Lq, Lk] additive mask, or nullptr
  float* out;
  int B, H, Lq, Lk, Dh;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  float scale;
  // Training forward only (rs_launch_mha_train): the row statistics
  // stats[((b H + h) Lq + i) 2 + {0, 1}] = (max, sum of exp(s - max)) of
  // each softmax row, and dropout of the probabilities (site kSiteAttn,
  // index ((b H + h) Lq + i) Lk + j).
  float* stats;
  DropParams drop;
};

// The masked logit of a real (query, key) pair from its raw dot product s
// and the two additive mask terms: scaled, + attn, + pad, clamped at
// finfo.min, in that order. Every kernel that computes a score calls it:
// the forwards (attention.cu K3, flash_attention.cu K4) and the backwards
// that recompute their P (transformer_layer_bwd.cu, flash_attention.cu K5
// and K6), so a backward's P is exactly the P whose (max, sum) its forward
// stored. The rounded intrinsics (one fma for the scale and the attention
// term, then the padding term) fix the arithmetic, so nvcc cannot contract
// it in one kernel and not in the other; for the port's masks (0 or
// finfo.min) the result equals the unfused one bit for bit. rs_raw_logit
// is the logit before the clamp: the gradient passes the clamp where it is
// >= finfo.min (torch.clamp_min's rule) and is cut where both masks are
// finfo.min (the sum is -inf).
__device__ __forceinline__ float rs_raw_logit(float s, float scale, float attn, float pad) {
  return __fadd_rn(__fmaf_rn(s, scale, attn), pad);
}

__device__ __forceinline__ float rs_logit(float s, float scale, float attn, float pad) {
  return fmaxf(rs_raw_logit(s, scale, attn, pad), RS_NEG);
}

// rs_raw_logit with the mask terms read from p's masks (either may be null).
__device__ __forceinline__ float masked_raw_logit(const MhaParams& p, float s, int b, int qi,
                                                  int kj) {
  const float a = p.attn_add ? p.attn_add[qi * p.Lk + kj] : 0.f;
  const float pad = p.pad_add ? p.pad_add[b * p.Lk + kj] : 0.f;
  return rs_raw_logit(s, p.scale, a, pad);
}

// Launches the masked attention kernel of attention.cu on `stream`.
cudaError_t rs_launch_mha(const MhaParams& p, cudaStream_t stream);
// The same kernel in training mode: dropout of the probabilities and the
// row statistics the backward (transformer_layer_bwd.cu) recomputes P from.
cudaError_t rs_launch_mha_train(const MhaParams& p, cudaStream_t stream);
// The attention backward of the fused layer (transformer_layer_bwd.cu,
// K2's steps 9 and 10) on flash_attention.cu's K5 and K6 kernels: dq and
// delta = rowsum(dout o out), then dk and dv, with P recomputed from
// p.stats and dropped as p.drop says. q, k, v and dq, dk, dv at p's q, k, v
// strides; out (the forward's dropped output) and dout at its o strides;
// delta [B, H, Lq].
cudaError_t rs_launch_mha_bwd_train(const MhaParams& p, const float* out, const float* dout,
                                    float* dq, float* dk, float* dv, float* delta,
                                    cudaStream_t stream);
