// Masked multi-head attention forward (kernel K3 of the port).
//
// Replaces recstudio_tpu/ops/attention.py:_mha_kernel, the Pallas kernel
// that holds one (example, head) pair's whole [Lk, Dh] K and V tiles and the
// [Lq, Lk] score tile in VMEM and computes
//   out = softmax(max(q k^T * scale + attn_add + pad_add, finfo.min)) v
// for Lk <= 512. The TPU kernel's padding of Lk and Dh to 128 lanes is
// layout, not semantics, and is dropped: keys past Lk get no weight. A row
// whose keys are all masked comes out as the average of its Lk values.
//
// Bound on an H100: per (example, head) the work is 4 Dh operations for
// each (query, key) pair the masks allow, against (2 Lq + 2 Lk) Dh 4 bytes.
// With a causal mask and right padding a row allows about Lk / 3 keys, so
// the work sits near the card's float32 ridge (some 20 operations a byte):
// bound by bytes at L 200 (phase B) and by operations at L 384 (phase C),
// Dh 64.
//
// Design (the register tile of register_tile.cuh, shared with the flash
// backward K5, K6; after flash_attention.cu's K4). A block of 256
// threads (16 x 16: tx = threadIdx.x & 15, ty = threadIdx.x >> 4) owns TQ
// query rows in shared memory and streams tiles of TK keys and values,
// copied with cp.async (16-byte copies where Dh, the strides and the
// pointers allow, 4-byte ones otherwise). Each thread computes a (TQ/16 x
// TK/16) block of scores, rows ty + 16 i and keys tx + 16 j, reading Q and
// K four columns at a time (conflict-free: the row stride is an odd number
// of 16-byte words), and keeps its [rows, Dh] accumulator columns in
// registers; the probabilities go through shared memory into the P V
// product. Online softmax: the row max is shared by the row's 16 threads
// (a half-warp shuffle); each keeps its own partial sum, merged at the end.
// Each mask value is read by the thread that owns its pair: once when the
// block marks its tiles and once when the tile is computed.
//
// Tile plan: TQ 32 x TK 32 at every Dh, four blocks an SM at Dh <= 64 (64
// registers, no spills) and the inner loops not unrolled, chosen by
// timing plans at phases B, C and F on the card (PERF.md, tile sweep): at
// L 200 (3 x 64 + 8 keys) 64 x 64 computes more padding and skips less;
// uncapped, ptxas takes 95-121 registers and two blocks an SM, 30-45 %
// slower. Overlapping the next tile's copy with this one's compute (a
// second K/V buffer) measured no gain, so each copy is waited for. Shared
// memory: 30 KB a block at Dh 64, 102 KB at Dh 256.
//
// Skipped tiles. Before streaming, the block marks each key tile that
// holds an allowed pair: a real query row (qi < Lq) and a real key
// (kj < Lk) with attn_add != finfo.min and pad_add != finfo.min
// (__syncthreads_or, so every thread takes the same branch around the
// barriers). The other tiles are not loaded or computed: causal tiles above
// the diagonal, and key tiles past an example's length under right
// padding. A skipped pair's logit is finfo.min, whose exp(finfo.min - m)
// is exactly 0 on a row with an allowed key, so skipping changes nothing
// there. A row with no allowed key ends with max finfo.min (or -inf when
// every tile was skipped); only blocks holding such a row make one more
// pass over all Lk values, which sets it to sum_j keep_j v_j / Lk (the
// mean of v in eval mode) with statistics (finfo.min, Lk): what the
// unskipped softmax over Lk equal logits gives.
//
// Scores. Each pair's dot product is fmaf(q[d], k[d], s) from s = 0 for d
// = 0..Dh-1 in order, then rs_logit (common.cuh): bitwise the score the
// backward (transformer_layer_bwd.cu) recomputes. That identity is why
// this kernel computes in float32 on the SIMT cores (67 TFLOP/s peak) and
// not on the tensor cores: a TF32 score would need the backward changed
// with it.
//
// Training mode (TRAIN, rs_launch_mha_train), the forward of SASRec
// training: the probabilities are dropped (site kSiteAttn of dropout.cuh)
// where they weigh V, while the running sum l keeps every term, so
// out = (P o keep) V with P = softmax(s), as the Pallas kernel's P * keep.
// Each row's (max, sum) is stored for the backward, which recomputes P
// tile by tile instead of reading it.
#include "common.cuh"
#include "register_tile.cuh"

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxTiles = 64;  // key tiles a block can mark (a 64-bit word)
// The tile plan at every Dh: query rows TQ and keys TK of a block
// (ops/attention.py MHA_TILE), each thread a 2 x 2 block of scores.
constexpr int kTileRows = 32, kTileKeys = 32;
constexpr int kRI = kTileRows / 16, kCJ = kTileKeys / 16;

__device__ __forceinline__ unsigned long long drop_index(const MhaParams& p, int b, int h, int qi,
                                                         int kj) {
  return (((unsigned long long)b * p.H + h) * p.Lq + qi) * (unsigned long long)p.Lk + kj;
}

// Bit t set: key tile t holds an allowed pair of this block's rows.
template <int RI, int CJ>
__device__ unsigned long long tiles_to_compute(const MhaParams& p, int b, int q0, int nt, int ty,
                                               int tx) {
  if (!p.attn_add && !p.pad_add) return nt == 64 ? ~0ull : (1ull << nt) - 1;
  unsigned long long todo = 0;
  for (int t = 0; t < nt; ++t) {
    int any = 0;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int kj = t * 16 * CJ + tx + 16 * j;
      if (kj >= p.Lk || (p.pad_add && p.pad_add[b * p.Lk + kj] == RS_NEG)) continue;
      if (!p.attn_add) {
        any = 1;
        continue;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int qi = q0 + ty + 16 * i;
        if (qi < p.Lq && p.attn_add[qi * p.Lk + kj] != RS_NEG) any = 1;
      }
    }
    if (__syncthreads_or(any)) todo |= 1ull << t;
  }
  return todo;
}

__device__ __forceinline__ int next_tile(unsigned long long todo, int t) {
  const unsigned long long rest = t + 1 >= 64 ? 0ull : todo & (~0ull << (t + 1));
  return rest ? __ffsll((long long)rest) - 1 : -1;
}

// Grid (query tiles of TQ, H, B). DK: accumulator columns a thread (Dh <= 16 DK).
template <int RI, int CJ, int DK, bool TRAIN>
__global__ void __launch_bounds__(kThreads, DK <= 4 ? 4 : DK <= 8 ? 3 : 1)
    mha_fwd_kernel(const MhaParams p, const bool vec) {
  constexpr int TQ = 16 * RI, TK = 16 * CJ, W = 16 * DK, LD = W + 4, LDP = TK + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [TQ][LD]
  float* ks = qs + TQ * LD;              // [TK][LD]
  float* vs = ks + TK * LD;              // [TK][LD]
  float* ps = vs + TK * LD;              // [TQ][LDP]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  float* ob = p.out + b * p.o_sb + h * p.o_sh;
  const int nt = (p.Lk + TK - 1) / TK;

  load_tile<TQ, W, LD>(qs, qb, p.q_sl, q0, p.Lq, p.Dh, vec);  // in flight while the masks are read
  const unsigned long long todo = tiles_to_compute<RI, CJ>(p, b, q0, nt, ty, tx);
  cp_async_commit();

  float m[RI], l[RI], acc[RI][DK];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < DK; ++k) acc[i][k] = 0.f;
  }

  for (int t = next_tile(todo, -1); t >= 0; t = next_tile(todo, t)) {
    load_tile<TK, W, LD>(ks, kb, p.k_sl, t * TK, p.Lk, p.Dh, vec);
    load_tile<TK, W, LD>(vs, vb, p.v_sl, t * TK, p.Lk, p.Dh, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    const int k0 = t * TK;
    float s[RI][CJ], pd[CJ];
    score_dots<RI, CJ, LD>(s, qs, ks, p.Dh, ty, tx);
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int kj = k0 + tx + 16 * j;
      pd[j] = (kj < p.Lk && p.pad_add) ? p.pad_add[b * p.Lk + kj] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qr = q0 + ty + 16 * i;
      const int qi = min(qr, p.Lq - 1);  // rows past Lq: computed, never stored
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj < p.Lk) {
          const float a = p.attn_add ? p.attn_add[qi * p.Lk + kj] : 0.f;
          s[i][j] = rs_logit(s[i][j], p.scale, a, pd[j]);
        } else {
          s[i][j] = -INFINITY;  // past the end of the keys: no weight at all
        }
        tmax = fmaxf(tmax, s[i][j]);
      }
      // key k0 < Lk is in this tile, so the new max is finite
      const float mnew = fmaxf(m[i], row_max(tmax));
      const float corr = expf(m[i] - mnew);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float e = expf(s[i][j] - mnew);
        psum += e;
        float w = e;
        if (TRAIN && qr < p.Lq && kj < p.Lk)
          w = e * rs_keep(p.drop, kSiteAttn, drop_index(p, b, h, qr, kj));
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = w;
      }
      l[i] = l[i] * corr + psum;
      m[i] = mnew;
#pragma unroll
      for (int k = 0; k < DK; ++k) acc[i][k] *= corr;
    }
    __syncthreads();
    pv_product<RI, DK, TK, LD, LDP>(acc, ps, vs, ty, tx);
    __syncthreads();  // P, K and V are consumed
  }
  cp_async_wait<0>();  // Q, when no tile was computed

  // Rows with no allowed key: all Lk values, weighed by keep (1 in eval).
  bool masked[RI];
  int any = 0;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    masked[i] = q0 + ty + 16 * i < p.Lq && !(m[i] > RS_NEG);
    any |= masked[i];
  }
  if (__syncthreads_or(any)) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int k = 0; k < DK; ++k)
        if (masked[i]) acc[i][k] = 0.f;
    for (int tt = 0; tt < nt; ++tt) {
      const int k0 = tt * TK;
      load_tile<TK, W, LD>(vs, vb, p.v_sl, k0, p.Lk, p.Dh, vec);
      cp_async_commit();
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int qi = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int kj = k0 + tx + 16 * j;
          float w = masked[i] && kj < p.Lk ? 1.f : 0.f;
          if (TRAIN && w != 0.f) w = rs_keep(p.drop, kSiteAttn, drop_index(p, b, h, qi, kj));
          ps[(ty + 16 * i) * LDP + tx + 16 * j] = w;
        }
      }
      cp_async_wait<0>();
      __syncthreads();
      pv_product<RI, DK, TK, LD, LDP>(acc, ps, vs, ty, tx);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    float lrow = row_sum(l[i]);
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Lq) continue;
    if (masked[i]) {
      m[i] = RS_NEG;
      lrow = (float)p.Lk;
    }
    if (TRAIN && tx == 0) {
      float* st = p.stats + (((long long)b * p.H + h) * p.Lq + qi) * 2;
      st[0] = m[i];
      st[1] = lrow;
    }
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const int d = Cols<DK>::col(k, tx);
      if (d < p.Dh) ob[qi * p.o_sl + d] = acc[i][k] / lrow;
    }
  }
}

template <int RI, int CJ, int DK, bool TRAIN>
cudaError_t launch(const MhaParams& p, bool vec, cudaStream_t stream) {
  constexpr int TQ = 16 * RI, TK = 16 * CJ, LD = 16 * DK + 4;
  const size_t smem =
      sizeof(float) * (TQ * LD + 2 * TK * LD + TQ * (TK + 4));
  cudaError_t err = cudaFuncSetAttribute(mha_fwd_kernel<RI, CJ, DK, TRAIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + TQ - 1) / TQ, p.H, p.B);
  mha_fwd_kernel<RI, CJ, DK, TRAIN><<<grid, kThreads, smem, stream>>>(p, vec);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

template <bool TRAIN>
cudaError_t dispatch(const MhaParams& p, cudaStream_t stream) {
  if (p.B <= 0 || p.H <= 0 || p.Lq <= 0 || p.Lk <= 0 || p.Dh <= 0 || p.Dh > 256 ||
      p.B > 65535 || p.H > 65535 || (TRAIN && !p.stats) ||
      (p.Lk + kTileKeys - 1) / kTileKeys > kMaxTiles)
    return cudaErrorInvalidValue;
  const bool vec = p.Dh % 4 == 0 && p.q_sl % 4 == 0 && p.k_sl % 4 == 0 && p.v_sl % 4 == 0 &&
                   p.q_sb % 4 == 0 && p.q_sh % 4 == 0 && p.k_sb % 4 == 0 &&
                   p.k_sh % 4 == 0 && p.v_sb % 4 == 0 && p.v_sh % 4 == 0 && aligned16(p.q) &&
                   aligned16(p.k) && aligned16(p.v);
  if (p.Dh <= 32) return launch<kRI, kCJ, 2, TRAIN>(p, vec, stream);
  if (p.Dh <= 64) return launch<kRI, kCJ, 4, TRAIN>(p, vec, stream);
  if (p.Dh <= 128) return launch<kRI, kCJ, 8, TRAIN>(p, vec, stream);
  return launch<kRI, kCJ, 16, TRAIN>(p, vec, stream);
}

}  // namespace

cudaError_t rs_launch_mha(const MhaParams& p, cudaStream_t stream) {
  return dispatch<false>(p, stream);
}

cudaError_t rs_launch_mha_train(const MhaParams& p, cudaStream_t stream) {
  return dispatch<true>(p, stream);
}

// q, k, v, out: contiguous [B, H, L, Dh]; pad_add [B, Lk] and attn_add
// [Lq, Lk] additive float masks, either may be null. Returns a cudaError_t.
extern "C" int rs_mha_fwd(const float* q, const float* k, const float* v,
                          const float* pad_add, const float* attn_add, float* out,
                          int B, int H, int Lq, int Lk, int Dh, float scale,
                          void* stream) {
  MhaParams p = {};
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
