// Forward-only fused conv pair on (N, H, C, W) f32:
//   y = ep(conv3x3(ep(conv3x3(x, w1) + b1), w2) + b2),
// ep = leaky ReLU, then optional pixelnorm over channels. The intermediate
// activation stays in shared memory and never goes to device memory.
//
// Replaces the TPU kernel pggan_tpu/ops/pallas_chain.py:conv3x3_chain (body
// _chain_kernel). The TPU kernel held whole rows per block, so only
// out-of-image intermediate ROWS had to be forced to zero; this kernel tiles
// W too, so out-of-image intermediate COLUMNS are zeroed the same way. They
// are the second conv's zero padding, not ep(conv(0)), which is nonzero.
//
// Bound: f32 FMAs, as in conv3x3.cu; the fusion saves the intermediate's
// write and read (4 * K1 bytes per pixel each way). Design: a block owns an
// 8 x 32 output tile. It stages the (8+4) x C x (32+4) input halo tile
// (zeros outside the image) in dynamic shared memory, then computes the
// (8+2) x K1 x (32+2) intermediate tile into shared memory, one position
// per thread with all K1 channels in registers so the pixelnorm mean stays
// in the thread, then the output tile from it, one pixel per thread with
// all K2 channels in registers. Weights are read as warp-uniform 16-byte
// loads through the read-only cache, [u][v][c][0..KT) with the output
// channels zero-padded to KT in {8, 16, 32, 64}. At the 256 px serving stage
// (C = 64, K1 = 32) the two tiles take 154 KB, above the 48 KB static limit,
// hence cudaFuncSetAttribute before every launch.

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kTH = 8;    // output tile rows (= threadIdx.y range)
constexpr int kTW = 32;   // output tile columns (= threadIdx.x range)
constexpr int kXW = kTW + 4;  // staged input row width (2-col halo)
constexpr int kIW = kTW + 2;  // intermediate row width (1-col halo)
constexpr int kThreads = kTH * kTW;

template <int K1T, int K2T, bool PN>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ x, const float* __restrict__ w1,
             const float* __restrict__ b1, const float* __restrict__ w2,
             const float* __restrict__ b2, float* __restrict__ y, int H,
             int C, int W, int K1, int K2, float slope, float eps) {
  extern __shared__ float sm[];
  float* xs = sm;                          // [kTH + 4][C][kXW]
  float* zs = sm + (kTH + 4) * C * kXW;    // [kTH + 2][K1][kIW]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int n = blockIdx.z;
  const int row0 = blockIdx.y * kTH, col0 = blockIdx.x * kTW;
  const float* xn = x + (long long)n * H * C * W;

  // input halo tile: staged row s, column t hold x[row0-2+s, :, col0-2+t]
  const int x_floats = (kTH + 4) * C * kXW;
  for (int i = tid; i < x_floats; i += kThreads) {
    const int t = i % kXW;
    const int rest = i / kXW;
    const int c = rest % C;
    const int s = rest / C;
    const int gr = row0 - 2 + s, gc = col0 - 2 + t;
    float v = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      v = __ldg(xn + ((long long)gr * C + c) * W + gc);
    xs[i] = v;
  }
  __syncthreads();

  // stage 1: intermediate row s, column t is global (row0-1+s, col0-1+t)
  for (int p = tid; p < (kTH + 2) * kIW; p += kThreads) {
    const int s = p / kIW, t = p % kIW;
    const int gr = row0 - 1 + s, gc = col0 - 1 + t;
    float* zp = zs + s * K1 * kIW + t;
    if (gr < 0 || gr >= H || gc < 0 || gc >= W) {
      for (int k = 0; k < K1; ++k) zp[k * kIW] = 0.f;  // zero padding
      continue;
    }
    float acc[K1T];
#pragma unroll
    for (int k = 0; k < K1T; ++k) acc[k] = 0.f;
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const float* xr = xs + ((s + u) * C + c) * kXW + t;
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const float xv = xr[v];
          const float4* wq = reinterpret_cast<const float4*>(
              w1 + ((long long)(u * 3 + v) * C + c) * K1T);
#pragma unroll
          for (int k4 = 0; k4 < K1T / 4; ++k4) {
            const float4 q = __ldg(wq + k4);
            acc[4 * k4 + 0] = fmaf(xv, q.x, acc[4 * k4 + 0]);
            acc[4 * k4 + 1] = fmaf(xv, q.y, acc[4 * k4 + 1]);
            acc[4 * k4 + 2] = fmaf(xv, q.z, acc[4 * k4 + 2]);
            acc[4 * k4 + 3] = fmaf(xv, q.w, acc[4 * k4 + 3]);
          }
        }
      }
    }
    pggan::bias_act_pn<K1T, PN>(acc, b1, K1, slope, eps);
#pragma unroll
    for (int k = 0; k < K1T; ++k)
      if (k < K1) zp[k * kIW] = acc[k];
  }
  __syncthreads();

  // stage 2: output pixel (row0+ty, col0+tx) from intermediate rows ty..ty+2
  float acc[K2T];
#pragma unroll
  for (int k = 0; k < K2T; ++k) acc[k] = 0.f;
  for (int k1 = 0; k1 < K1; ++k1) {
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const float* zr = zs + ((ty + u) * K1 + k1) * kIW + tx;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const float zv = zr[v];
        const float4* wq = reinterpret_cast<const float4*>(
            w2 + ((long long)(u * 3 + v) * K1 + k1) * K2T);
#pragma unroll
        for (int k4 = 0; k4 < K2T / 4; ++k4) {
          const float4 q = __ldg(wq + k4);
          acc[4 * k4 + 0] = fmaf(zv, q.x, acc[4 * k4 + 0]);
          acc[4 * k4 + 1] = fmaf(zv, q.y, acc[4 * k4 + 1]);
          acc[4 * k4 + 2] = fmaf(zv, q.z, acc[4 * k4 + 2]);
          acc[4 * k4 + 3] = fmaf(zv, q.w, acc[4 * k4 + 3]);
        }
      }
    }
  }
  const int gr = row0 + ty, gc = col0 + tx;
  if (gr >= H || gc >= W) return;
  pggan::bias_act_pn<K2T, PN>(acc, b2, K2, slope, eps);
  float* yp = y + ((long long)n * H + gr) * K2 * W + gc;
#pragma unroll
  for (int k = 0; k < K2T; ++k)
    if (k < K2) yp[(long long)k * W] = acc[k];
}

struct Args {
  const float* x;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  float* y;
  int N, H, C, W, K1, K2;
  float slope, eps;
  cudaStream_t stream;
};

template <int K1T, int K2T, bool PN>
int launch(const Args& a) {
  const size_t smem = sizeof(float) * ((size_t)(kTH + 4) * a.C * kXW +
                                       (size_t)(kTH + 2) * a.K1 * kIW);
  auto kern = chain_kernel<K1T, K2T, PN>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.W + kTW - 1) / kTW, (a.H + kTH - 1) / kTH, a.N);
  dim3 block(kTW, kTH);
  kern<<<grid, block, smem, a.stream>>>(a.x, a.w1, a.b1, a.w2, a.b2, a.y,
                                        a.H, a.C, a.W, a.K1, a.K2, a.slope,
                                        a.eps);
  return (int)cudaGetLastError();
}

template <int K1T, int K2T>
int launch_pn(bool pn, const Args& a) {
  return pn ? launch<K1T, K2T, true>(a) : launch<K1T, K2T, false>(a);
}

template <int K1T>
int launch_k2(int k2t, bool pn, const Args& a) {
  switch (k2t) {
    case 8: return launch_pn<K1T, 8>(pn, a);
    case 16: return launch_pn<K1T, 16>(pn, a);
    case 32: return launch_pn<K1T, 32>(pn, a);
    case 64: return launch_pn<K1T, 64>(pn, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (N, H, C, W); w1 (3, 3, C, K1T), b1 (K1T,); w2 (3, 3, K1, K2T),
// b2 (K2T,), output channels zero-padded to their tiers; y (N, H, K2, W).
extern "C" int pggan_conv3x3_chain(const float* x, const float* w1,
                                   const float* b1, const float* w2,
                                   const float* b2, float* y, int N, int H,
                                   int C, int W, int K1, int K2, int K1T,
                                   int K2T, int pn, float slope, float eps,
                                   void* stream) {
  Args a{x, w1, b1, w2, b2, y, N, H, C, W, K1, K2, slope, eps,
         static_cast<cudaStream_t>(stream)};
  switch (K1T) {
    case 8: return launch_k2<8>(K2T, pn != 0, a);
    case 16: return launch_k2<16>(K2T, pn != 0, a);
    case 32: return launch_k2<32>(K2T, pn != 0, a);
    case 64: return launch_k2<64>(K2T, pn != 0, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
