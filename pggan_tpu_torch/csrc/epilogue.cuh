// The layer epilogue shared by conv3x3.cu and conv_chain.cu, in the order
// of the TPU kernels (pggan_tpu/ops/pallas_conv.py:_kernel,
// pggan_tpu/ops/pallas_chain.py:_row_conv): bias, then
// where(z >= 0, z, slope * z), then z * rsqrt(mean_K(z^2) + eps).
#pragma once

#include <cuda_runtime.h>

namespace pggan {

// Epilogue modes of the conv kernels.
enum Epi : int { kEpiNone = 0, kEpiAct = 1, kEpiActPn = 2 };

// Bias + leaky ReLU (+ pixelnorm over K channels) in place on one m64
// wgmma row-set's accumulators, acc[4j + 2h + e] = (pixel g + 8h, channel
// 8j + 2t + e) of the fragment (hopper.cuh), t = lane % 4: a pixel's
// channels sit in one quad of lanes, so the mean over K is two shuffles.
// Channels >= K are zero padding (zero weights, no bias): they hold exact
// zeros and add nothing to the sum. rr gets r = rsqrt(mean_K(z^2) + eps)
// of pixels g and g + 8 (1 without pixelnorm). All 32 lanes must call it.
template <int NR>
__device__ __forceinline__ void bias_act_pn(float (&acc)[NR],
                                            const float* __restrict__ b,
                                            int K, bool pn, float slope,
                                            float eps, int t,
                                            float (&rr)[2]) {
  float ss[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NR / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * j + 2 * t + e;
        float z = acc[4 * j + 2 * h + e];
        if (k < K) z += __ldg(b + k);
        z = z >= 0.f ? z : z * slope;
        acc[4 * j + 2 * h + e] = z;
        ss[h] = fmaf(z, z, ss[h]);
      }
  rr[0] = rr[1] = 1.f;
  if (!pn) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
    ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
    rr[h] = rsqrtf(ss[h] / (float)K + eps);
  }
#pragma unroll
  for (int e = 0; e < NR; ++e) acc[e] *= rr[(e >> 1) & 1];
}

}  // namespace pggan
