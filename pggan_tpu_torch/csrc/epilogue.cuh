// The layer epilogue shared by conv3x3.cu and conv_chain.cu, in the order
// of the TPU kernels (pggan_tpu/ops/pallas_conv.py:_kernel,
// pggan_tpu/ops/pallas_chain.py:_row_conv): bias, then
// where(z >= 0, z, slope * z), then z * rsqrt(mean_K(z^2) + eps).
#pragma once

#include <cuda_runtime.h>

namespace pggan {

// Epilogue modes of the conv kernels.
enum Epi : int { kEpiNone = 0, kEpiAct = 1, kEpiActPn = 2 };

// Applies bias + leaky ReLU (+ pixelnorm over the first K of KT channels)
// to one pixel's accumulators in place and returns the pixelnorm scale r
// (1 without pixelnorm). Channels K..KT-1 are zero padding: their weights
// and bias are zero, so they hold exact zeros and add nothing to the sum.
template <int KT, bool PN>
__device__ __forceinline__ float bias_act_pn(float (&acc)[KT],
                                             const float* __restrict__ b,
                                             int K, float slope, float eps) {
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    float z = acc[k] + __ldg(b + k);
    z = z >= 0.f ? z : z * slope;
    acc[k] = z;
    ss = fmaf(z, z, ss);
  }
  if (!PN) return 1.f;
  const float r = rsqrtf(ss / (float)K + eps);
#pragma unroll
  for (int k = 0; k < KT; ++k) acc[k] *= r;
  return r;
}

}  // namespace pggan
