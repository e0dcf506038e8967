// Masked multi-head attention forward (kernel K3 of the port).
//
// Replaces recstudio_tpu/ops/attention.py:_mha_kernel, the Pallas kernel
// that holds one (example, head) pair's whole [Lk, Dh] K and V tiles and the
// [Lq, Lk] score tile in VMEM and computes
//   out = softmax(max(q k^T * scale + attn_add + pad_add, finfo.min)) v.
//
// Bound on an H100: per (example, head) the work is 4 Dh operations for
// each (query, key) pair the masks allow, against (2 Lq + 2 Lk) Dh 4 bytes.
// With a causal mask and right padding a row allows about Lk / 3 keys, so
// the work is near the card's float32 ridge (some 20 operations a byte):
// bound by bytes at L = 200 and by operations at L = 384, Dh = 64. This
// first version computes every pair, masked or not, in float32 on the SIMT
// cores (67 TFLOP/s peak), not on the tensor cores.
//
// Design: one block per (query tile of 16 rows, head, example); four warps
// own four query rows each. Keys stream through shared memory in tiles of
// 32, one key per lane, with an online softmax (running max, running sum
// and the [Dh] accumulator in registers). Shared memory therefore does not
// grow with Lk: a whole K and V at Lk = 512, Dh = 128 in float32 would need
// 512 KB, past the 227 KB a block may use. The TPU kernel's padding of Lk
// and Dh to 128 lanes is layout, not semantics, and is dropped; masks are
// added in the kernel and clamped at finfo.min, so a row whose keys are all
// masked comes out as the uniform average of its Lk values.
#include "common.cuh"

#include <cmath>

namespace {

constexpr int kTK = 32;           // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kTQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// DPL: accumulator values per lane (Dh <= 32 * DPL).
template <int DPL>
__global__ void __launch_bounds__(kWarps * 32)
mha_fwd_kernel(const MhaParams p) {
  extern __shared__ float smem[];
  const int Dh = p.Dh;
  float* Ks = smem;                       // [kTK][Dh + 1]: conflict-free column reads
  float* Vs = Ks + kTK * (Dh + 1);        // [kTK][Dh]
  float* Qs = Vs + kTK * Dh;              // [kTQ][Dh]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  float* ob = p.out + b * p.o_sb + h * p.o_sh;

  for (int i = threadIdx.x; i < kTQ * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i % Dh, qi = q0 + r;
    Qs[i] = qi < p.Lq ? qb[qi * p.q_sl + d] : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] = 0.f;
  }

  for (int k0 = 0; k0 < p.Lk; k0 += kTK) {
    __syncthreads();  // Q is loaded; the previous K/V tile is consumed
    for (int i = threadIdx.x; i < kTK * Dh; i += blockDim.x) {
      const int j = i / Dh, d = i % Dh, kj = k0 + j;
      const bool ok = kj < p.Lk;
      Ks[j * (Dh + 1) + d] = ok ? kb[kj * p.k_sl + d] : 0.f;
      Vs[j * Dh + d] = ok ? vb[kj * p.v_sl + d] : 0.f;
    }
    __syncthreads();

    const int kj = k0 + lane;
    const bool kvalid = kj < p.Lk;
    const float pad = (kvalid && p.pad_add) ? p.pad_add[b * p.Lk + kj] : 0.f;
    const float* krow = Ks + lane * (Dh + 1);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr, qi = q0 + r;
      const float* qrow = Qs + r * Dh;
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s = fmaf(qrow[d], krow[d], s);
      s *= p.scale;
      if (kvalid) {
        const float a = (p.attn_add && qi < p.Lq) ? p.attn_add[qi * p.Lk + kj] : 0.f;
        s = fmaxf((s + a) + pad, RS_NEG);
      } else {
        s = -INFINITY;  // past the end of the keys: no weight at all
      }
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float corr = expf(m[rr] - m_new);
      const float pj = kvalid ? expf(s - m_new) : 0.f;
      l[rr] = l[rr] * corr + warp_sum(pj);
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[rr][t] *= corr;
      for (int j = 0; j < kTK; ++j) {
        const float w = __shfl_sync(kFull, pj, j);
        const float* vrow = Vs + j * Dh;
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          const int d = lane + 32 * t;
          if (d < Dh) acc[rr][t] = fmaf(w, vrow[d], acc[rr][t]);
        }
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi >= p.Lq) continue;
    const float inv = 1.f / l[rr];
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) ob[qi * p.o_sl + d] = acc[rr][t] * inv;
    }
  }
}

template <int DPL>
cudaError_t launch(const MhaParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kTK * (p.Dh + 1) + kTK * p.Dh + kTQ * p.Dh);
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_kernel<DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kTQ - 1) / kTQ, p.H, p.B);
  mha_fwd_kernel<DPL><<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

cudaError_t rs_launch_mha(const MhaParams& p, cudaStream_t stream) {
  if (p.B <= 0 || p.H <= 0 || p.Lq <= 0 || p.Lk <= 0 || p.Dh <= 0 || p.B > 65535 ||
      p.H > 65535)
    return cudaErrorInvalidValue;
  if (p.Dh <= 32) return launch<1>(p, stream);
  if (p.Dh <= 64) return launch<2>(p, stream);
  if (p.Dh <= 128) return launch<4>(p, stream);
  if (p.Dh <= 256) return launch<8>(p, stream);
  return cudaErrorInvalidValue;
}

// q, k, v, out: contiguous [B, H, L, Dh]; pad_add [B, Lk] and attn_add
// [Lq, Lk] additive float masks, either may be null. Returns a cudaError_t.
extern "C" int rs_mha_fwd(const float* q, const float* k, const float* v,
                          const float* pad_add, const float* attn_add, float* out,
                          int B, int H, int Lq, int Lk, int Dh, float scale,
                          void* stream) {
  MhaParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.pad_add = pad_add;
  p.attn_add = attn_add;
  p.out = out;
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.Dh = Dh;
  p.q_sb = (long long)H * Lq * Dh;
  p.q_sh = (long long)Lq * Dh;
  p.q_sl = Dh;
  p.k_sb = p.v_sb = (long long)H * Lk * Dh;
  p.k_sh = p.v_sh = (long long)Lk * Dh;
  p.k_sl = p.v_sl = Dh;
  p.o_sb = p.q_sb;
  p.o_sh = p.q_sh;
  p.o_sl = Dh;
  p.scale = scale;
  return (int)rs_launch_mha(p, (cudaStream_t)stream);
}
