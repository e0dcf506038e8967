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

// Launches the masked attention kernel of attention.cu on `stream`.
cudaError_t rs_launch_mha(const MhaParams& p, cudaStream_t stream);
// The same kernel in training mode: dropout of the probabilities and the
// row statistics the backward (transformer_layer_bwd.cu) recomputes P from.
cudaError_t rs_launch_mha_train(const MhaParams& p, cudaStream_t stream);
