// Same-padding 3x3 convolution on (N, H, C, W) f32, with an optional fused
// epilogue: none, bias + leaky ReLU, or bias + leaky ReLU + pixelnorm over
// the output channels (which also writes r = rsqrt(mean_K(z^2) + eps),
// shape (N, H, W)).
//
// Replaces the TPU kernels pggan_tpu/ops/pallas_conv.py:conv3x3_small_c and
// conv3x3_act_small_c (body _kernel), whose (TH+2)-row halo slabs were DMAed
// into VMEM with double buffering and contracted on the MXU. Those are TPU
// devices; this kernel keeps only what they compute.
//
// Bound: f32 FMAs. At the serving tail's shapes (C <= 64, K <= 32) the conv
// does 18 * C * K FLOPs per output pixel against 4 * (C + K) bytes moved, far
// above the card's f32 ridge, and f32 has no tensor-core path without TF32
// (which would break parity). Design: a block owns an 8-row x TW-column
// output tile and all K output channels, so pixelnorm's mean over K stays
// inside one thread. Input channels are staged 8 at a time as a zero-padded
// (8+2) x 8 x (TW+2) halo tile in shared memory (zeros outside the image, so
// no separate padded copy is made). Each thread keeps PW pixels x KT
// channels of accumulators in registers (PW * KT = 64), reads each staged
// input value once per tap, and reads the weights [u][v][c][0..KT) as
// warp-uniform 16-byte loads through the read-only cache. KT is K rounded
// up to 8, 16, 32 or 64; the wrapper zero-pads w and b to KT. Pixels of a
// thread are 32 columns apart, so a warp's shared loads hit 32 banks.
// Faster designs (wgmma on TF32/bf16, TMA) are later work.

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kTX = 32;  // threads along W
constexpr int kTY = 8;   // threads along H = tile rows
constexpr int kCC = 8;   // input channels staged per pass

template <int KT>
struct Tile {
  static constexpr int PW = 64 / KT;      // pixels per thread along W
  static constexpr int TW = kTX * PW;     // tile width
  static constexpr int SW = TW + 2;       // staged row width (1-col halo)
  static constexpr int kSmemFloats = (kTY + 2) * kCC * SW;
};

template <int KT, int EPI>
__global__ void __launch_bounds__(kTX * kTY)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, float* __restrict__ y,
               float* __restrict__ r, int H, int C, int W, int K, int KY,
               float slope, float eps) {
  using T = Tile<KT>;
  constexpr int PW = T::PW, TW = T::TW, SW = T::SW;
  extern __shared__ float xs[];  // [kTY + 2][kCC][SW]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int n = blockIdx.z;
  const int row0 = blockIdx.y * kTY, col0 = blockIdx.x * TW;
  const float* xn = x + (long long)n * H * C * W;

  float acc[PW][KT];
#pragma unroll
  for (int j = 0; j < PW; ++j)
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[j][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    const int cn = min(kCC, C - c0);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < T::kSmemFloats; i += kTX * kTY) {
      const int t = i % SW;
      const int rest = i / SW;
      const int c = rest % kCC;
      const int s = rest / kCC;
      const int gr = row0 - 1 + s, gc = col0 - 1 + t;
      float v = 0.f;
      if (c < cn && gr >= 0 && gr < H && gc >= 0 && gc < W)
        v = __ldg(xn + ((long long)gr * C + c0 + c) * W + gc);
      xs[i] = v;
    }
    __syncthreads();
    for (int c = 0; c < cn; ++c) {
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const float* xr = xs + ((ty + u) * kCC + c) * SW + tx;
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          float xv[PW];
#pragma unroll
          for (int j = 0; j < PW; ++j) xv[j] = xr[j * kTX + v];
          const float4* wq = reinterpret_cast<const float4*>(
              w + ((long long)(u * 3 + v) * C + c0 + c) * KT);
#pragma unroll
          for (int k4 = 0; k4 < KT / 4; ++k4) {
            const float4 q = __ldg(wq + k4);
#pragma unroll
            for (int j = 0; j < PW; ++j) {
              acc[j][4 * k4 + 0] = fmaf(xv[j], q.x, acc[j][4 * k4 + 0]);
              acc[j][4 * k4 + 1] = fmaf(xv[j], q.y, acc[j][4 * k4 + 1]);
              acc[j][4 * k4 + 2] = fmaf(xv[j], q.z, acc[j][4 * k4 + 2]);
              acc[j][4 * k4 + 3] = fmaf(xv[j], q.w, acc[j][4 * k4 + 3]);
            }
          }
        }
      }
    }
  }

  const int gr = row0 + ty;
  if (gr >= H) return;
  float* yrow = y + ((long long)n * H + gr) * KY * W;
#pragma unroll
  for (int j = 0; j < PW; ++j) {
    const int gc = col0 + tx + j * kTX;
    if (gc >= W) continue;
    if (EPI != pggan::kEpiNone) {
      const float rr = pggan::bias_act_pn<KT, EPI == pggan::kEpiActPn>(
          acc[j], b, K, slope, eps);
      if (EPI == pggan::kEpiActPn) r[((long long)n * H + gr) * W + gc] = rr;
    }
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if (k < K) yrow[(long long)k * W + gc] = acc[j][k];
  }
}

struct Args {
  const float* x;
  const float* w;
  const float* b;
  float* y;
  float* r;
  int N, H, C, W, K, KY;
  float slope, eps;
  cudaStream_t stream;
};

template <int KT, int EPI>
int launch(const Args& a) {
  using T = Tile<KT>;
  const size_t smem = sizeof(float) * T::kSmemFloats;
  auto kern = conv3x3_kernel<KT, EPI>;
  // above 48 KB only as opted-in dynamic shared memory (KT = 8 needs 82 KB)
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.W + T::TW - 1) / T::TW, (a.H + kTY - 1) / kTY, a.N);
  dim3 block(kTX, kTY);
  kern<<<grid, block, smem, a.stream>>>(a.x, a.w, a.b, a.y, a.r, a.H, a.C,
                                        a.W, a.K, a.KY, a.slope, a.eps);
  return (int)cudaGetLastError();
}

template <int KT>
int launch_epi(int epi, const Args& a) {
  switch (epi) {
    case pggan::kEpiNone: return launch<KT, pggan::kEpiNone>(a);
    case pggan::kEpiAct: return launch<KT, pggan::kEpiAct>(a);
    case pggan::kEpiActPn: return launch<KT, pggan::kEpiActPn>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (N, H, C, W); w (3, 3, C, KT) HWIO with K zero-padded to KT; b (KT,)
// (unused for epi 0); y points at channel 0 of a K-channel slice of an
// (N, H, KY, W) output, KY >= K (the wrapper launches once per slice of at
// most 64 channels when KY > 64); r (N, H, W) for epi 2 only (KY == K).
extern "C" int pggan_conv3x3(const float* x, const float* w, const float* b,
                             float* y, float* r, int N, int H, int C, int W,
                             int K, int KY, int KT, int epi, float slope,
                             float eps, void* stream) {
  Args a{x, w, b, y, r, N, H, C, W, K, KY, slope, eps,
         static_cast<cudaStream_t>(stream)};
  switch (KT) {
    case 8: return launch_epi<8>(epi, a);
    case 16: return launch_epi<16>(epi, a);
    case 32: return launch_epi<32>(epi, a);
    case 64: return launch_epi<64>(epi, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
