// Dropout keep masks from Philox-4x32-10, in device code.
//
// The same function as recstudio_torch/ops/dropout.py (the plain version):
// the keep bit of an element is a pure function of (seed, site, index),
//   w = philox4x32_10(counter = (index lo, index hi, site, 0),
//                     key = (seed lo, seed hi))[0]
//   keep <=> (w >> 8) >= threshold,  threshold = min(ceil(p 2^24), 2^24 - 1)
// as recstudio_tpu/ops/transformer_layer.py:_DropRng.keep (24 high bits
// against a threshold), kept elements scaled by 1 / (1 - p). index is the
// element's row-major position in the tensor its site drops from, so the
// forward and backward kernels regenerate a mask instead of storing it.
#pragma once

#include <cstdint>

// Sites of one layer call, in the order of the JAX stream: attention
// probabilities, attention output projection, FFN hidden, FFN output.
enum DropSite : uint32_t { kSiteAttn = 0, kSiteOut = 1, kSiteFfnHidden = 2, kSiteFfnOut = 3 };

struct DropParams {
  unsigned long long seed;
  unsigned int threshold;  // 24-bit keep threshold
  float scale;             // 1 / (1 - p)
  int active;              // 0: no dropout (eval, or p == 0)
};

__device__ __forceinline__ uint32_t rs_philox_word0(unsigned long long index, uint32_t site,
                                                   unsigned long long seed) {
  uint32_t c0 = (uint32_t)index, c1 = (uint32_t)(index >> 32), c2 = site, c3 = 0u;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

// The factor an element is multiplied by: scale if kept, 0 if dropped, 1
// when dropout is off.
__device__ __forceinline__ float rs_keep(const DropParams& d, uint32_t site,
                                         unsigned long long index) {
  if (!d.active) return 1.f;
  return (rs_philox_word0(index, site, d.seed) >> 8) >= d.threshold ? d.scale : 0.f;
}
