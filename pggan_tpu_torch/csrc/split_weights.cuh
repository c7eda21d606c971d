// The weight pre-split shared by conv3x3.cu and conv_chain.cu: each f32
// weight becomes a (hi, lo) pair of TF32 values (tf32_mma.cuh), once per
// call, in the layout the kernels copy into shared memory as it is. The
// template argument is a tag type of the calling kernel, so that a profile
// names each caller's split apart.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace pggan {
namespace {

// ws[grp][tap][c][k] = (hi, lo) for c < C8, k < KS: the split of
// w[tap][c][grp KT + k] (w is (3, 3, C, K) HWIO), zero for c >= C, k >= KT
// or grp KT + k >= K. Rows of KS = KT + 4 pairs (= 4 mod 16) keep the
// kernels' 8-byte B-fragment loads conflict-free.
template <typename Caller>
__global__ void split_weights(const float* __restrict__ w,
                              float2* __restrict__ ws, int C, int K, int KT,
                              int C8, int KS, long long E) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < E;
       e += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(e % KS);
    const long long rest = e / KS;
    const int c = (int)(rest % C8);
    const int tap = (int)(rest / C8 % 9), kk = (int)(rest / C8 / 9) * KT + k;
    const float a = c < C && k < KT && kk < K
                        ? __ldg(w + ((long long)tap * C + c) * K + kk)
                        : 0.f;
    uint32_t hi, lo;
    tf32_split(a, hi, lo);
    ws[e] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
  }
}

// Splits w into ws ((groups, 9, C8, KS) pairs) on the stream; returns the
// launch's error code.
template <typename Caller>
inline int launch_split_weights(const float* w, float2* ws, int C, int K,
                                int KT, int C8, int KS, int groups,
                                cudaStream_t stream) {
  const long long E = (long long)groups * 9 * C8 * KS;
  split_weights<Caller><<<(unsigned)((E + 255) / 256), 256, 0, stream>>>(
      w, ws, C, K, KT, C8, KS, E);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace pggan
