// Long-sequence attention: the flash forward (K4) and its backward (K5, K6).
//
// Replace the Pallas kernels of recstudio_tpu/ops/attention.py that the JAX
// package runs when Lk > 512 (_FLASH_THRESHOLD):
//   K4 _flash_kernel (:133):          out = P v and each row's statistics
//   K5 _flash_bwd_dq_kernel (:220):   dq = scale * dS k           (and delta, below)
//   K6 _flash_bwd_dkv_kernel (:246):  dv = P^T dO,  dk = scale * dS^T q
// with s = max(q k^T * scale + attn_add + pad_add, finfo.min) (masks added,
// then clamped, attention.py:147-148), P = softmax(s) over the Lk keys, and
//   dS = P o (dO v^T - delta),  delta = rowsum(dO o out).
// q, dO and out are [B, H, Lq, Dh], k, v [B, H, Lk, Dh], contiguous float32;
// pad_add [B, Lk] and attn_add [Lq, Lk] are additive masks, either may be
// null. The [Lq, Lk] scores never reach device memory. Keys past Lk get no
// weight (the TPU kernel's padding of Lk to its tile is not copied); query
// rows past Lq get P = 0.
//
// Row statistics. The Pallas forward stores lse = max + log(sum); for a row
// whose keys are all masked, max = finfo.min and lse rounds to finfo.min, so
// its backward recomputes P = 1 for every key instead of 1 / Lk. K4 stores
// the pair (max, sum) instead, stats[((b H + h) Lq + i) 2 + {0, 1}], and K5
// and K6 recompute P = exp(s - max) / sum, which is 1 / Lk on such a row.
// The gradient through the clamp follows torch.clamp_min, as autograd of the
// plain mha_plain does: it passes where the unclamped logit is >= finfo.min
// and is cut where the two masks together sum to -inf.
//
// Bound on an H100: per (example, head), K4 does 4 Dh operations for each
// (query, key) pair the masks allow, K5 6 Dh (S, dP, dq) and K6 8 Dh (S, dP,
// dv, dk), against some (4 Lq + 4 Lk) Dh bytes. With a causal mask at L 1024,
// Dh 64 that is hundreds of operations a byte: all three are bound by
// operations, counted at the pairs the masks allow (a third of them under
// the causal mask with right padding, phase H).
//
// Scores, and why no tensor cores. Each kernel computes a pair's dot product
// as fmaf(q[d], k[d], s) from s = 0 for d = 0..Dh-1 in order, then
// rs_raw_logit (common.cuh), so K5's and K6's S is bitwise K4's and their P
// is exactly the P that K4's (max, sum) normalise. A TF32 or 3xTF32 S or dP
// on the tensor cores would break that identity unless K4 moved with them,
// so all three compute in float32 on the SIMT cores (67 TFLOP/s peak) until
// they move to the tensor cores together.
//
// Design: K3's register tile (register_tile.cuh) on the tiles the masks
// leave work in. Of a pair of tiles, TQ query rows and TK keys (kFlashRows x
// kFlashKeys at Dh <= 128, ops/attention.py FLASH_TILE; kWideRows x
// kWideKeys above), a K4 or K5 block owns the query tile and streams key
// tiles, a K6 block owns the key tile and streams query tiles. Owned and
// streamed tiles sit in shared memory, copied with cp.async (16-byte copies
// where Dh and the pointers allow, 4-byte ones otherwise); each streamed
// tile's copy is waited for while the SM's other blocks compute (K4 waits
// for its V tile only after the scores). Each thread computes a block of S
// (and dP) reading both operands four columns at a time (row stride an odd
// number of 16-byte words: no bank conflicts), keeps its accumulator
// columns in registers, and sends P (K4), dS (K5), or P and dS (K6) through
// shared memory into out += P v, dq += dS k, dv += P^T dO and dk += dS^T q,
// read as float4. K4 keeps an online softmax: the row max is shared by the
// row's 16 threads (a half-warp shuffle), each keeps its own partial sum,
// merged at the end.
//
// Tile plan: 64 x 64 at Dh <= 128 (4 x 4 scores a thread), 32 x 32 above
// (shared memory); __launch_bounds__ from the blocks an SM's shared memory
// holds (blocks_per_sm): at Dh <= 64 K4 three (at most), K5 and K6 two,
// one at 128. Chosen by timing plans at phase H's shape and the masked case
// on the card (PERF.md, tile sweeps; scripts/torch_kernel_sweep.py for K4):
// for K5 and K6, 64 x 32, 32 x 64, 32 x 32 and one block an SM took longer
// for the two together. K4 shares their plan: at phase H, two blocks an SM
// (128 registers) took 14 % longer than three (80 registers, a few bytes
// spilled), 32 x 64 and 32 x 32 longer too, and 64 x 32 at four blocks an
// SM 4 % less but with more spilled; running the last query tiles first
// changed nothing. Shared memory at Dh 64: K4 68 KB, K5 87 KB, K6 105 KB a
// block; at Dh 256 (32 x 32) K4 102 KB, K5 138 KB, K6 143 KB.
//
// Skipped tiles. Before it streams a tile, every kernel's block decides with
// __syncthreads_or whether the pair of tiles holds an allowed pair: a real
// row (qi < Lq) and a real key (kj < Lk) with attn_add != finfo.min and
// pad_add != finfo.min; tile by tile, so any Lk works. Pairs of tiles that
// hold none are neither copied nor computed: causal tiles above the
// diagonal, and key tiles past an example's length under right padding. On
// a row with an allowed key, max > finfo.min, so a skipped pair's P =
// exp(finfo.min - max) / sum is exactly 0 and its dS is 0: skipping changes
// nothing but the order of the sums. A row whose statistics hold max =
// finfo.min has no allowed key, and its P = 1 / Lk on every key: its dS
// passes the clamp wherever only one mask is finfo.min. K4 ends the pass
// with max <= finfo.min on such a row (-inf when every tile was skipped);
// only a block holding one makes one more pass over all Lk values, which
// sets the row to their mean and its statistics to exactly (finfo.min, Lk),
// what the unskipped softmax over Lk equal logits gives (as K3 does). In
// the backward, a query tile holding such a row is computed against every
// key tile (K5 computes all of them for its block; K6 streams every query
// tile that holds one). A block whose tiles are all skipped still writes
// its outputs: K6's key tiles past every row's reach get dk = dv = 0.
//
// Every block owns its outputs: no atomics, and the same inputs give bitwise
// the same outputs. K5 writes delta for its rows; K6 reads it.
//
// The fused layer's backward (K2, transformer_layer_bwd.cu) runs its
// attention steps on K5's and K6's kernels (rs_launch_mha_bwd_train). Two
// things differ there, and both are compiled in only where they are used:
// - Operands are strided views (FlashArgs' strides, MhaParams' layout):
//   q, k, v and their gradients are column ranges of the packed [B L, 3D]
//   rows, out (A) and dout (dA) of the [B L, D] rows. The flash entry
//   points pass contiguous [B, H, L, Dh] strides; K4 keeps its computed
//   contiguous offsets (strides cost it registers it spills at Dh 64).
// - Dropout of P (the DROP template flag; off for K4-K6): dv = (P o
//   keep)^T dO, dS = P o (dP o keep - delta), delta = rowsum(dO o out) as
//   before since out is the dropped output. The keep bit of pair (i, j) is
//   dropout.cuh's at site kSiteAttn, index ((b H + h) Lq + i) Lk + j, drawn
//   only where P is not 0: a skipped tile draws none, and neither does a
//   masked pair of a computed one.
// K2's tile plan (kLayerRows x kLayerKeys, ops/transformer_layer.py
// K2_ATTN_TILE) is its own, chosen at L <= 256 by timing at phase D's and
// F's shapes (scripts/torch_kernel_sweep.py, PERF.md); at Dh <= 32 it
// keeps 32 accumulator columns a row (DK 2).
#include "common.cuh"
#include "register_tile.cuh"

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxDh = 256;
// K4, K5, K6: query rows and keys of a pair of tiles at Dh <= 128, and above.
constexpr int kFlashRows = 64, kFlashKeys = 64;
constexpr int kWideRows = 32, kWideKeys = 32;
// K2's attention steps (L <= 256): query rows and keys of a pair of tiles
// at Dh <= 128; above, kWideRows x kWideKeys.
constexpr int kLayerRows = 32, kLayerKeys = 32;

// K5's and K6's operands are strided views (element (b, h, row, d) at
// p[b sb + h sh + row sl + d], as MhaParams): q and dq share q's strides, k
// and dk k's, v and dv v's, out and dout the o strides. The flash entry
// points pass contiguous [B, H, L, Dh] tensors (K4 takes only those); K2
// the packed rows of the fused layer. The row statistics and delta are
// contiguous [B, H, Lq(, 2)].
struct FlashArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* pad_add;   // [B, Lk] or nullptr
  const float* attn_add;  // [Lq, Lk] or nullptr
  const float* out;       // K5: the forward's output
  const float* dout;      // K5, K6: the output's gradient
  const float* stats;     // K5, K6: (max, sum) of each row, [B, H, Lq, 2]
  const float* delta;     // K6: rowsum(dO o out), [B, H, Lq]
  float* o;               // K4: out
  float* st;              // K4: stats
  float* dq;              // K5
  float* delta_out;       // K5
  float* dk;              // K6
  float* dv;              // K6
  int B, H, Lq, Lk, Dh;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  float scale;
  DropParams drop;        // K5, K6 with DROP: dropout of P (site kSiteAttn)
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Head (b, h) of a strided operand.
template <typename P>
__device__ __forceinline__ P* head(P* p, long long sb, long long sh, int b, int h) {
  return p + b * sb + h * sh;
}

// The dropout factor of P at (row = (b H + h) Lq + qi, key kj): 0 where P
// is 0 (no bit drawn; dS and P keep are 0 there whatever the bit), else
// rs_keep's.
__device__ __forceinline__ float p_keep(const FlashArgs& a, long long row, int kj, float p) {
  return p != 0.f ? rs_keep(a.drop, kSiteAttn, (unsigned long long)row * a.Lk + kj) : 0.f;
}

// The key-padding term of key kj < Lk of example b.
__device__ __forceinline__ float pad_term(const FlashArgs& a, int b, int kj) {
  return a.pad_add ? a.pad_add[(long long)b * a.Lk + kj] : 0.f;
}

// The attention-mask term of (query qi < Lq, key kj < Lk).
__device__ __forceinline__ float attn_term(const FlashArgs& a, int qi, int kj) {
  return a.attn_add ? a.attn_add[(long long)qi * a.Lk + kj] : 0.f;
}

// 1 if one of the thread's pairs (query q + 16 i, key k + 16 j), i < NQ,
// j < NK, is allowed: a real row and key that neither mask removes.
template <int NQ, int NK>
__device__ __forceinline__ int any_allowed(const FlashArgs& a, int b, int q, int k) {
  int any = 0;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const int kj = k + 16 * j;
    if (kj >= a.Lk || pad_term(a, b, kj) == RS_NEG) continue;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int qi = q + 16 * i;
      if (qi < a.Lq && attn_term(a, qi, kj) != RS_NEG) any = 1;
    }
  }
  return any;
}

// Row qi < Lq has no allowed key: its statistics' max is finfo.min.
__device__ __forceinline__ bool no_allowed_key(const FlashArgs& a, long long bh, int qi) {
  return qi < a.Lq && !(a.stats[(bh * a.Lq + qi) * 2] > RS_NEG);
}

// ---------------------------------------------------------------------------
// K4: grid (query tiles of TQ = 16 RI, H, B); key tiles of TK = 16 CJ.
// K4 reads contiguous [B, H, L, Dh] operands, its entry point's only layout
// (FlashArgs' strides serve K5 and K6): computed offsets keep its register
// budget.
template <int RI, int CJ, int DK, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    flash_fwd_kernel(const FlashArgs a, const bool vec) {
  constexpr int TQ = 16 * RI, TK = 16 * CJ, W = 16 * DK, LD = W + 4, LDP = TK + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [TQ][LD]
  float* ks = qs + TQ * LD;       // [TK][LD]
  float* vs = ks + TK * LD;       // [TK][LD]
  float* ps = vs + TK * LD;       // [TQ][LDP]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, q0 = blockIdx.x * TQ;
  const long long bh = (long long)b * a.H + blockIdx.y;
  const float* kb = a.k + bh * a.Lk * a.Dh;
  const float* vb = a.v + bh * a.Lk * a.Dh;
  load_tile<TQ, W, LD>(qs, a.q + bh * a.Lq * a.Dh, a.Dh, q0, a.Lq, a.Dh, vec);
  cp_async_commit();

  float m[RI], l[RI], acc[RI][DK];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < DK; ++k) acc[i][k] = 0.f;
  }
  const bool masked = a.pad_add || a.attn_add;
  const int nt = (a.Lk + TK - 1) / TK;
  for (int t = 0; t < nt; ++t) {
    const int k0 = t * TK;
    if (masked && !__syncthreads_or(any_allowed<RI, CJ>(a, b, q0 + ty, k0 + tx))) continue;
    load_tile<TK, W, LD>(ks, kb, a.Dh, k0, a.Lk, a.Dh, vec);
    cp_async_commit();
    load_tile<TK, W, LD>(vs, vb, a.Dh, k0, a.Lk, a.Dh, vec);
    cp_async_commit();
    cp_async_wait<1>();  // Q and K; V still in flight
    __syncthreads();

    float s[RI][CJ], pd[CJ];
    score_dots<RI, CJ, LD>(s, qs, ks, a.Dh, ty, tx);
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int kj = k0 + tx + 16 * j;
      pd[j] = kj < a.Lk ? pad_term(a, b, kj) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = min(q0 + ty + 16 * i, a.Lq - 1);  // rows past Lq: computed, never stored
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kj = k0 + tx + 16 * j;
        s[i][j] = kj < a.Lk ? rs_logit(s[i][j], a.scale, attn_term(a, qi, kj), pd[j]) : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      // key k0 < Lk is in this tile, so the new max is finite
      const float mnew = fmaxf(m[i], row_max(tmax));
      const float corr = expf(m[i] - mnew);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - mnew);
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * corr + psum;
      m[i] = mnew;
#pragma unroll
      for (int k = 0; k < DK; ++k) acc[i][k] *= corr;
    }
    cp_async_wait<0>();
    __syncthreads();
    pv_product<RI, DK, TK, LD, LDP>(acc, ps, vs, ty, tx);
    __syncthreads();  // K, V and P are consumed
  }
  cp_async_wait<0>();  // Q, when no tile was computed

  // Rows with no allowed key: the mean of all Lk values.
  bool empty[RI];
  int any = 0;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    empty[i] = q0 + ty + 16 * i < a.Lq && !(m[i] > RS_NEG);
    any |= empty[i];
  }
  if (__syncthreads_or(any)) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int k = 0; k < DK; ++k)
        if (empty[i]) acc[i][k] = 0.f;
    for (int t = 0; t < nt; ++t) {
      const int k0 = t * TK;
      load_tile<TK, W, LD>(vs, vb, a.Dh, k0, a.Lk, a.Dh, vec);
      cp_async_commit();
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          ps[(ty + 16 * i) * LDP + tx + 16 * j] =
              empty[i] && k0 + tx + 16 * j < a.Lk ? 1.f : 0.f;
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
    if (qi >= a.Lq) continue;
    const long long row = bh * a.Lq + qi;
    if (empty[i]) lrow = (float)a.Lk;
    if (tx == 0) {
      a.st[row * 2] = empty[i] ? RS_NEG : m[i];
      a.st[row * 2 + 1] = lrow;
    }
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const int d = Cols<DK>::col(k, tx);
      if (d < a.Dh) a.o[row * a.Dh + d] = acc[i][k] / lrow;
    }
  }
}

// ---------------------------------------------------------------------------
// K5: grid (query tiles of TQ = 16 RI, H, B); key tiles of TK = 16 CJ.
// DROP: P is dropped (K2's attention): dP = (dO v^T) o keep.
template <int RI, int CJ, int DK, int MINB, bool DROP>
__global__ void __launch_bounds__(kThreads, MINB)
    flash_bwd_dq_kernel(const FlashArgs a, const bool vec) {
  constexpr int TQ = 16 * RI, TK = 16 * CJ, W = 16 * DK, LD = W + 4, LDP = TK + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [TQ][LD]
  float* dos = qs + TQ * LD;      // [TQ][LD]
  float* ks = dos + TQ * LD;      // [TK][LD]
  float* vs = ks + TK * LD;       // [TK][LD]
  float* dss = vs + TK * LD;      // [TQ][LDP]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const long long bh = (long long)b * a.H + h;
  const float* kb = head(a.k, a.k_sb, a.k_sh, b, h);
  const float* vb = head(a.v, a.v_sb, a.v_sh, b, h);
  const float* ob = head(a.out, a.o_sb, a.o_sh, b, h);
  load_tile<TQ, W, LD>(qs, head(a.q, a.q_sb, a.q_sh, b, h), a.q_sl, q0, a.Lq, a.Dh, vec);
  load_tile<TQ, W, LD>(dos, head(a.dout, a.o_sb, a.o_sh, b, h), a.o_sl, q0, a.Lq, a.Dh, vec);
  cp_async_commit();

  // each row's max and 1 / sum; rows past Lq get max = +inf, so P = 0 there
  float m[RI], il[RI], dl[RI];
  int empty = 0;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    const bool ok = qi < a.Lq;
    const long long row = bh * a.Lq + qi;
    m[i] = ok ? a.stats[row * 2] : INFINITY;
    il[i] = ok ? 1.f / a.stats[row * 2 + 1] : 1.f;
    empty |= ok && !(m[i] > RS_NEG);
  }
  // A row with no allowed key (max finfo.min) weighs every key: its block
  // computes every key tile.
  const bool every = __syncthreads_or(empty) || (!a.pad_add && !a.attn_add);
  cp_async_wait<0>();
  __syncthreads();

  // delta = rowsum(dO o out)
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    const long long row = bh * a.Lq + qi;
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const int d = tx + 16 * k;
      if (qi < a.Lq && d < a.Dh)
        part = fmaf(dos[(ty + 16 * i) * LD + d], ob[qi * a.o_sl + d], part);
    }
    dl[i] = row_sum(part);
    if (qi < a.Lq && tx == 0) a.delta_out[row] = dl[i];
  }

  float acc[RI][DK];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int k = 0; k < DK; ++k) acc[i][k] = 0.f;
  const int nt = (a.Lk + TK - 1) / TK;
  for (int t = 0; t < nt; ++t) {
    const int k0 = t * TK;
    if (!every && !__syncthreads_or(any_allowed<RI, CJ>(a, b, q0 + ty, k0 + tx))) continue;
    load_tile<TK, W, LD>(ks, kb, a.k_sl, k0, a.Lk, a.Dh, vec);
    load_tile<TK, W, LD>(vs, vb, a.v_sl, k0, a.Lk, a.Dh, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ], pd[CJ];
    score_dots<RI, CJ, LD>(s, qs, ks, a.Dh, ty, tx);
    score_dots<RI, CJ, LD>(dp, dos, vs, a.Dh, ty, tx);
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int kj = k0 + tx + 16 * j;
      pd[j] = kj < a.Lk ? pad_term(a, b, kj) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = min(q0 + ty + 16 * i, a.Lq - 1);  // rows past Lq: P = 0
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kj = k0 + tx + 16 * j;
        float ds = 0.f;
        if (kj < a.Lk) {
          const float raw = rs_raw_logit(s[i][j], a.scale, attn_term(a, qi, kj), pd[j]);
          const float p = expf(fmaxf(raw, RS_NEG) - m[i]) * il[i];
          float dpk = dp[i][j];
          if (DROP) dpk *= p_keep(a, bh * a.Lq + qi, kj, p);
          ds = raw >= RS_NEG ? p * (dpk - dl[i]) : 0.f;
        }
        dss[(ty + 16 * i) * LDP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    pv_product<RI, DK, TK, LD, LDP>(acc, dss, ks, ty, tx);
    __syncthreads();  // K, V and dS are consumed
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= a.Lq) continue;
    float* dqrow = head(a.dq, a.q_sb, a.q_sh, b, h) + qi * a.q_sl;
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const int d = Cols<DK>::col(k, tx);
      if (d < a.Dh) dqrow[d] = acc[i][k] * a.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// K6: grid (key tiles of TK = 16 RI, H, B); query tiles of TQ = 16 CJ.
// DROP: P is dropped (K2's attention): dv = (P o keep)^T dO and dP = (dO
// v^T) o keep.
template <int RI, int CJ, int DK, int MINB, bool DROP>
__global__ void __launch_bounds__(kThreads, MINB)
    flash_bwd_dkv_kernel(const FlashArgs a, const bool vec) {
  constexpr int TK = 16 * RI, TQ = 16 * CJ, W = 16 * DK, LD = W + 4, LDP = TQ + 4;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;               // [TK][LD]
  float* vs = ks + TK * LD;       // [TK][LD]
  float* qs = vs + TK * LD;       // [TQ][LD]
  float* dos = qs + TQ * LD;      // [TQ][LD]
  float* ps = dos + TQ * LD;      // [TK][LDP]: P^T
  float* dss = ps + TK * LDP;     // [TK][LDP]: dS^T
  float* ms = dss + TK * LDP;     // [TQ]: the query rows' max, 1 / sum and delta
  float* ils = ms + TQ;
  float* dls = ils + TQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * TK;
  const long long bh = (long long)b * a.H + h;
  const float* qb = head(a.q, a.q_sb, a.q_sh, b, h);
  const float* dob = head(a.dout, a.o_sb, a.o_sh, b, h);
  load_tile<TK, W, LD>(ks, head(a.k, a.k_sb, a.k_sh, b, h), a.k_sl, k0, a.Lk, a.Dh, vec);
  load_tile<TK, W, LD>(vs, head(a.v, a.v_sb, a.v_sh, b, h), a.v_sl, k0, a.Lk, a.Dh, vec);
  cp_async_commit();

  float pd[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kj = k0 + ty + 16 * i;
    pd[i] = kj < a.Lk ? pad_term(a, b, kj) : 0.f;
  }
  const bool masked = a.pad_add || a.attn_add;
  float dk[RI][DK], dv[RI][DK];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int k = 0; k < DK; ++k) dk[i][k] = dv[i][k] = 0.f;
  const int nq = (a.Lq + TQ - 1) / TQ;
  for (int t = 0; t < nq; ++t) {
    const int q0 = t * TQ;
    if (masked) {
      // an allowed pair, or a row with no allowed key, which weighs every key
      int need = any_allowed<CJ, RI>(a, b, q0 + tx, k0 + ty);
#pragma unroll
      for (int j = 0; j < CJ; ++j) need |= no_allowed_key(a, bh, q0 + tx + 16 * j);
      if (!__syncthreads_or(need)) continue;
    }
    load_tile<TQ, W, LD>(qs, qb, a.q_sl, q0, a.Lq, a.Dh, vec);
    load_tile<TQ, W, LD>(dos, dob, a.o_sl, q0, a.Lq, a.Dh, vec);
    cp_async_commit();
    if (threadIdx.x < TQ) {
      const int qi = q0 + threadIdx.x;
      const bool ok = qi < a.Lq;            // rows past Lq: P = 0
      const long long row = bh * a.Lq + qi;
      ms[threadIdx.x] = ok ? a.stats[row * 2] : INFINITY;
      ils[threadIdx.x] = ok ? 1.f / a.stats[row * 2 + 1] : 1.f;
      dls[threadIdx.x] = ok ? a.delta[row] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
    score_dots<RI, CJ, LD>(s, ks, qs, a.Dh, ty, tx);    // key ty + 16 i, query tx + 16 j
    score_dots<RI, CJ, LD>(dp, vs, dos, a.Dh, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int kj = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int r = tx + 16 * j;
        const int qi = min(q0 + r, a.Lq - 1);
        float p = 0.f, ds = 0.f;
        if (kj < a.Lk) {
          const float raw = rs_raw_logit(s[i][j], a.scale, attn_term(a, qi, kj), pd[i]);
          p = expf(fmaxf(raw, RS_NEG) - ms[r]) * ils[r];
          float dpk = dp[i][j], keep = 1.f;
          if (DROP) {
            keep = p_keep(a, bh * a.Lq + qi, kj, p);
            dpk *= keep;
          }
          ds = raw >= RS_NEG ? p * (dpk - dls[r]) : 0.f;
          if (DROP) p *= keep;
        }
        ps[(ty + 16 * i) * LDP + r] = p;
        dss[(ty + 16 * i) * LDP + r] = ds;
      }
    }
    __syncthreads();
    pv_product<RI, DK, TQ, LD, LDP>(dv, ps, dos, ty, tx);
    pv_product<RI, DK, TQ, LD, LDP>(dk, dss, qs, ty, tx);
    __syncthreads();  // Q, dO, P and dS are consumed
  }
  cp_async_wait<0>();  // K and V, when no tile was computed
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= a.Lk) continue;
    float* dkrow = head(a.dk, a.k_sb, a.k_sh, b, h) + kj * a.k_sl;
    float* dvrow = head(a.dv, a.v_sb, a.v_sh, b, h) + kj * a.v_sl;
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const int d = Cols<DK>::col(k, tx);
      if (d < a.Dh) {
        dkrow[d] = dk[i][k] * a.scale;
        dvrow[d] = dv[i][k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int row_tiles, size_t smem_floats, int H, int B,
                   cudaStream_t stream, const Args&... args) {
  const size_t smem = smem_floats * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(row_tiles, H, B), kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// K4 owns TQ = 16 RI query rows and streams TK = 16 CJ keys.
template <int RI, int CJ, int DK>
cudaError_t launch_fwd(const FlashArgs& a, bool vec, cudaStream_t stream) {
  constexpr int TQ = 16 * RI, TK = 16 * CJ, LD = 16 * DK + 4;
  constexpr size_t floats = (size_t)(TQ + 2 * TK) * LD + (size_t)TQ * (TK + 4);
  return launch(flash_fwd_kernel<RI, CJ, DK, blocks_per_sm(floats, 3)>, cdiv(a.Lq, TQ),
                floats, a.H, a.B, stream, a, vec);
}

// K5 owns TQ = 16 RI query rows and streams TK = 16 CJ keys; K6 owns TK =
// 16 RI keys and streams TQ = 16 CJ query rows.
// DROP: dropout of P (K2); CAP: the most blocks an SM is asked to hold.
template <int RI, int CJ, int DK, bool DROP = false, int CAP = 4>
cudaError_t launch_dq(const FlashArgs& a, bool vec, cudaStream_t stream) {
  constexpr int TQ = 16 * RI, TK = 16 * CJ, LD = 16 * DK + 4;
  constexpr size_t floats = (size_t)2 * (TQ + TK) * LD + (size_t)TQ * (TK + 4);
  return launch(flash_bwd_dq_kernel<RI, CJ, DK, blocks_per_sm(floats, CAP), DROP>,
                cdiv(a.Lq, TQ), floats, a.H, a.B, stream, a, vec);
}

template <int RI, int CJ, int DK, bool DROP = false, int CAP = 4>
cudaError_t launch_dkv(const FlashArgs& a, bool vec, cudaStream_t stream) {
  constexpr int TK = 16 * RI, TQ = 16 * CJ, LD = 16 * DK + 4;
  constexpr size_t floats = (size_t)2 * (TK + TQ) * LD + (size_t)2 * TK * (TQ + 4) + 3 * TQ;
  return launch(flash_bwd_dkv_kernel<RI, CJ, DK, blocks_per_sm(floats, CAP), DROP>,
                cdiv(a.Lk, TK), floats, a.H, a.B, stream, a, vec);
}

// K2's attention steps: K5 then K6 with TQ = 16 RI query rows and TK = 16
// CJ keys, P dropped when DROP.
template <int RI, int CJ, int DK, bool DROP, int CAP = 4>
cudaError_t launch_bwd(const FlashArgs& a, bool vec, cudaStream_t stream) {
  const cudaError_t err = launch_dq<RI, CJ, DK, DROP, CAP>(a, vec, stream);
  if (err != cudaSuccess) return err;
  return launch_dkv<CJ, RI, DK, DROP, CAP>(a, vec, stream);
}

bool bad_shape(const FlashArgs& a) {
  return a.B < 1 || a.H < 1 || a.Lq < 1 || a.Lk < 1 || a.Dh < 1 || a.Dh > kMaxDh ||
         a.B > 65535 || a.H > 65535;
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

// 16-byte copies of every row of q, k, v and dout: Dh and every stride a
// multiple of 4 and the tensors 16-byte aligned.
bool vec_rows(const FlashArgs& a) {
  const long long strides[] = {a.q_sb, a.q_sh, a.q_sl, a.k_sb, a.k_sh, a.k_sl,
                               a.v_sb, a.v_sh, a.v_sl, a.o_sb, a.o_sh, a.o_sl};
  for (long long st : strides)
    if (st % 4) return false;
  return a.Dh % 4 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
         aligned16(a.dout);
}

FlashArgs make_args(const float* q, const float* k, const float* v, const float* pad_add,
                    const float* attn_add, int B, int H, int Lq, int Lk, int Dh, float scale) {
  FlashArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.pad_add = pad_add;
  a.attn_add = attn_add;
  a.B = B;
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.Dh = Dh;
  a.q_sl = a.k_sl = a.v_sl = a.o_sl = Dh;
  a.q_sh = a.o_sh = (long long)Lq * Dh;
  a.k_sh = a.v_sh = (long long)Lk * Dh;
  a.q_sb = a.o_sb = (long long)H * Lq * Dh;
  a.k_sb = a.v_sb = (long long)H * Lk * Dh;
  a.scale = scale;
  return a;
}

// FlashArgs of K2's attention steps (rs_launch_mha_bwd_train).
FlashArgs layer_args(const MhaParams& p, const float* out, const float* dout, float* dq,
                     float* dk, float* dv, float* delta) {
  FlashArgs a = make_args(p.q, p.k, p.v, p.pad_add, p.attn_add, p.B, p.H, p.Lq, p.Lk, p.Dh,
                          p.scale);
  a.q_sb = p.q_sb;
  a.q_sh = p.q_sh;
  a.q_sl = p.q_sl;
  a.k_sb = p.k_sb;
  a.k_sh = p.k_sh;
  a.k_sl = p.k_sl;
  a.v_sb = p.v_sb;
  a.v_sh = p.v_sh;
  a.v_sl = p.v_sl;
  a.o_sb = p.o_sb;
  a.o_sh = p.o_sh;
  a.o_sl = p.o_sl;
  a.out = out;
  a.dout = dout;
  a.stats = p.stats;
  a.delta = delta;
  a.dq = dq;
  a.delta_out = delta;
  a.dk = dk;
  a.dv = dv;
  a.drop = p.drop;
  return a;
}

}  // namespace

// K4. q [B, H, Lq, Dh], k, v [B, H, Lk, Dh], out like q, stats [B, H, Lq, 2];
// pad_add [B, Lk] and attn_add [Lq, Lk] may be null. Returns a cudaError_t.
extern "C" int rs_flash_fwd(const float* q, const float* k, const float* v, const float* pad_add,
                            const float* attn_add, float* out, float* stats, int B, int H, int Lq,
                            int Lk, int Dh, float scale, void* stream) {
  FlashArgs a = make_args(q, k, v, pad_add, attn_add, B, H, Lq, Lk, Dh, scale);
  a.o = out;
  a.st = stats;
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = vec_rows(a);
  constexpr int RI = kFlashRows / 16, CJ = kFlashKeys / 16;
  if (Dh <= 32) return (int)launch_fwd<RI, CJ, 2>(a, vec, st);
  if (Dh <= 64) return (int)launch_fwd<RI, CJ, 4>(a, vec, st);
  if (Dh <= 128) return (int)launch_fwd<RI, CJ, 8>(a, vec, st);
  return (int)launch_fwd<kWideRows / 16, kWideKeys / 16, 16>(a, vec, st);
}

// K5: dq like q and delta [B, H, Lq] from the forward's out and stats and
// the output's gradient dout.
extern "C" int rs_flash_bwd_dq(const float* q, const float* k, const float* v,
                               const float* pad_add, const float* attn_add, const float* out,
                               const float* dout, const float* stats, float* dq, float* delta,
                               int B, int H, int Lq, int Lk, int Dh, float scale, void* stream) {
  FlashArgs a = make_args(q, k, v, pad_add, attn_add, B, H, Lq, Lk, Dh, scale);
  a.out = out;
  a.dout = dout;
  a.stats = stats;
  a.dq = dq;
  a.delta_out = delta;
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = vec_rows(a);
  constexpr int RI = kFlashRows / 16, CJ = kFlashKeys / 16;
  if (Dh <= 64) return (int)launch_dq<RI, CJ, 4>(a, vec, st);
  if (Dh <= 128) return (int)launch_dq<RI, CJ, 8>(a, vec, st);
  return (int)launch_dq<kWideRows / 16, kWideKeys / 16, 16>(a, vec, st);
}

// K6: dk, dv like k from the forward's stats, K5's delta and dout.
extern "C" int rs_flash_bwd_dkv(const float* q, const float* k, const float* v,
                                const float* pad_add, const float* attn_add, const float* dout,
                                const float* stats, const float* delta, float* dk, float* dv,
                                int B, int H, int Lq, int Lk, int Dh, float scale, void* stream) {
  FlashArgs a = make_args(q, k, v, pad_add, attn_add, B, H, Lq, Lk, Dh, scale);
  a.dout = dout;
  a.stats = stats;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = vec_rows(a);
  constexpr int RI = kFlashKeys / 16, CJ = kFlashRows / 16;
  if (Dh <= 64) return (int)launch_dkv<RI, CJ, 4>(a, vec, st);
  if (Dh <= 128) return (int)launch_dkv<RI, CJ, 8>(a, vec, st);
  return (int)launch_dkv<kWideKeys / 16, kWideRows / 16, 16>(a, vec, st);
}

// K2's attention steps (transformer_layer_bwd.cu, steps 9 and 10): K5's
// kernel writes dq and delta, then K6's dk and dv, on p's strided operands
// (q, k, v and their gradients at p's q, k, v strides; out, the forward's
// output, and dout at its o strides), with dropout of P from p.drop.
cudaError_t rs_launch_mha_bwd_train(const MhaParams& p, const float* out, const float* dout,
                                    float* dq, float* dk, float* dv, float* delta,
                                    cudaStream_t stream) {
  const FlashArgs a = layer_args(p, out, dout, dq, dk, dv, delta);
  if (bad_shape(a)) return cudaErrorInvalidValue;
  const bool vec = vec_rows(a);
  constexpr int RI = kLayerRows / 16, CJ = kLayerKeys / 16;
  constexpr int WR = kWideRows / 16, WC = kWideKeys / 16;
  if (p.drop.active) {
    if (p.Dh <= 32) return launch_bwd<RI, CJ, 2, true>(a, vec, stream);
    if (p.Dh <= 64) return launch_bwd<RI, CJ, 4, true>(a, vec, stream);
    if (p.Dh <= 128) return launch_bwd<RI, CJ, 8, true>(a, vec, stream);
    return launch_bwd<WR, WC, 16, true>(a, vec, stream);
  }
  if (p.Dh <= 32) return launch_bwd<RI, CJ, 2, false>(a, vec, stream);
  if (p.Dh <= 64) return launch_bwd<RI, CJ, 4, false>(a, vec, stream);
  if (p.Dh <= 128) return launch_bwd<RI, CJ, 8, false>(a, vec, stream);
  return launch_bwd<WR, WC, 16, false>(a, vec, stream);
}
