// Shared declarations of the port's CUDA kernels (sm_90a, float32).
#pragma once

#include <cuda_runtime.h>
#include <cfloat>

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
};

// Launches the masked attention kernel of attention.cu on `stream`.
cudaError_t rs_launch_mha(const MhaParams& p, cudaStream_t stream);
