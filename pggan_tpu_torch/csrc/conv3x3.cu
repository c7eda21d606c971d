// Same-padding 3x3 convolution on (N, H, C, W) f32, with an optional fused
// epilogue: none, bias + leaky ReLU, or bias + leaky ReLU + pixelnorm over
// the output channels (which also writes r = rsqrt(mean_K(z^2) + eps),
// shape (N, H, W)).
//
// Replaces the TPU kernels pggan_tpu/ops/pallas_conv.py:conv3x3_small_c and
// conv3x3_act_small_c (body _kernel), whose (TH+2)-row halo slabs were DMAed
// into VMEM with double buffering and contracted on the MXU in f32 (several
// bf16 passes). This kernel keeps what they compute, on the tensor cores.
//
// Bound: 18 C K FLOPs per output pixel against 4 (C + K) bytes, so
// operations at the 128-256 px shapes (C = 32-128) and bytes at 512-1024 px
// (C, K <= 32) on the H100. The design:
// - An implicit GEMM on the tensor cores: per block, M = a tile of output
//   pixels (TH rows x 64 columns of one image), N = KT output channels,
//   reduced over 9 taps x C. For tap (u, v) the A operand is the staged halo
//   tile shifted by (u, v). KT is K rounded up to 8, 16, 32 or 64; K > 64
//   (no pixelnorm) runs as groups of 64 channels in the grid's z, next to
//   the image index, in one launch.
// - Arithmetic: mma.sync.m16n8k8 in TF32 with the three-product split of
//   tf32_mma.cuh (f32 accuracy; each tap's products are summed from zero
//   and added to the accumulators with a rounded f32 add). Against float64
//   this is at least as close as the f32 plain version (cuDNN) at every
//   shape measured on the H100. A is split in registers as it is loaded; the
//   weights are split once per call by split_weights into a (groups, 9, C8,
//   KT + 4) workspace of (hi, lo) pairs (C8 = C rounded up to 8, zeros
//   beyond C and K) that the main kernel copies as it is.
// - mma.sync, not wgmma: TF32 wgmma wants K-major operands in shared
//   memory (only 16-bit types may be transposed), and the NHCW halo tile is
//   pixel-major, so A would come from registers anyway; m16n8k8 takes any
//   shared-memory layout. wgmma is the next step for the C >= 64 shapes.
// - Staging: input channels in chunks of 8 (one MMA k-step), double
//   buffered with cp.async: chunk i + 1's halo ((TH + 2) x 8 x 72 floats,
//   the 16-byte-aligned span [col0 - 4, col0 + 68)) and weights are in
//   flight while the tensor cores work on chunk i. Elements outside the
//   image are zero-filled by the copy (src-size 0), which is the padding.
//   Halo rows of 72 floats (= 8 mod 32) and weight rows of (KT + 4) (hi, lo)
//   pairs (= 4 mod 16 pairs, one 8-byte load per B register pair) make
//   every fragment load conflict-free. W not a multiple of 4 (or an
//   unaligned x) takes 4-byte copies into the same layout.
// - Warps: 8; each owns MT m-tiles (16 pixels of one row) and all KT / 8
//   n-tiles, so a pixel's K outputs sit in one quad of lanes and
//   pixelnorm's mean over K is two shuffles. TH = 2, 4, 8, 8 rows at KT =
//   64, 32, 16, 8 (MT = 1, 2, 4, 4): 32, 32, 32, 16 accumulators a thread.
//   Two blocks (16 warps) per SM at KT >= 32, three at KT <= 16 (register
//   caps 128 and 80; 97, 69, 69, 60 KB of shared memory a block).
// - Epilogue: epilogue.cuh's arithmetic (bias, where(z >= 0, z, slope z),
//   z rsqrt(mean_K z^2 + eps)) on the fragments; each store instruction
//   writes four full 32-byte runs along W.

#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "split_weights.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kTW = 64;        // output columns per tile
constexpr int kCC = 8;         // input channels per stage (one k-step)
constexpr int kSW = kTW + 8;   // staged halo row, floats (= 8 mod 32)

struct conv3x3_split;  // names this kernel's weight split in a profile

template <int KT>
struct Tile {
  static constexpr int TH = KT == 64 ? 2 : KT == 32 ? 4 : 8;  // output rows
  static constexpr int NT = KT / 8;                    // n-tiles
  static constexpr int MPR = kTW / 16;                 // m-tiles per row
  static constexpr int MT = TH * MPR / 8;              // m-tiles per warp
  static constexpr int KS = KT + 4;  // weight row, (hi, lo) pairs: 4 mod 16
  static constexpr int kXFloats = (TH + 2) * kCC * kSW;
  static constexpr int kWFloats = 9 * kCC * KS * 2;
  static constexpr int kStageFloats = kXFloats + kWFloats;
  static constexpr size_t kSmemBytes = 2 * kStageFloats * sizeof(float);
};

template <int KT, int EPI>
__global__ void __launch_bounds__(kThreads, KT <= 16 ? 3 : 2)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ ws,
               const float* __restrict__ b, float* __restrict__ y,
               float* __restrict__ r, int H, int C, int W, int K, int C8,
               int groups, int vec, float slope, float eps) {
  using T = Tile<KT>;
  constexpr int TH = T::TH, NT = T::NT, MT = T::MT, KS = T::KS;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // output channels [k0, k0 + Kg) of image n
  const int n = blockIdx.z / groups, k0 = blockIdx.z % groups * KT;
  const int Kg = min(KT, K - k0);
  const int row0 = blockIdx.y * TH, col0 = blockIdx.x * kTW;
  const float* xn = x + (long long)n * H * C * W;
  ws += (long long)(k0 / KT) * 9 * C8 * KS * 2;

  // chunk c0's halo and weights into stage buffer s, as one commit group
  auto issue = [&](int c0, int s) {
    float* xs = smem + s * T::kStageFloats;
    float* wsm = xs + T::kXFloats;
    if (vec) {
      constexpr int V = kSW / 4;
      for (int e = tid; e < (TH + 2) * kCC * V; e += kThreads) {
        const int q = e % V, rest = e / V;
        const int c = rest % kCC, sr = rest / kCC;
        const int gr = row0 - 1 + sr, gc = col0 - 4 + 4 * q;
        const bool ok = gr >= 0 && gr < H && c0 + c < C && gc >= 0 && gc < W;
        pggan::cp_async16(xs + (sr * kCC + c) * kSW + 4 * q,
                          ok ? xn + ((long long)gr * C + c0 + c) * W + gc : x,
                          ok);
      }
    } else {
      for (int e = tid; e < (TH + 2) * kCC * kSW; e += kThreads) {
        const int q = e % kSW, rest = e / kSW;
        const int c = rest % kCC, sr = rest / kCC;
        const int gr = row0 - 1 + sr, gc = col0 - 4 + q;
        const bool ok = gr >= 0 && gr < H && c0 + c < C && gc >= 0 && gc < W;
        pggan::cp_async4(xs + e,
                         ok ? xn + ((long long)gr * C + c0 + c) * W + gc : x,
                         ok);
      }
    }
    constexpr int WV = kCC * KS * 2 / 4;  // 16-byte vectors per tap
    for (int e = tid; e < 9 * WV; e += kThreads) {
      const int q = e % WV, tap = e / WV;
      pggan::cp_async16(wsm + tap * kCC * KS * 2 + 4 * q,
                        ws + ((long long)tap * C8 + c0) * KS * 2 + 4 * q,
                        true);
    }
    pggan::cp_async_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  const int chunks = C8 / kCC;
  issue(0, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    pggan::cp_async_wait_all();
    __syncthreads();  // chunk ch landed for all; chunk ch - 1 is done
    if (ch + 1 < chunks) issue((ch + 1) * kCC, (ch + 1) & 1);
    const float* xs = smem + (ch & 1) * T::kStageFloats;
    const float* wsm = xs + T::kXFloats;
#pragma unroll
    for (int u = 0; u < 3; ++u) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        // B (c, k) = w[u][v][c][k]: b0 (c = t, k = g), b1 (c = t + 4, k = g),
        // one 8-byte (hi, lo) load each
        const float2* wt = reinterpret_cast<const float2*>(wsm) +
                           (u * 3 + v) * kCC * KS + t * KS + g;
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 p0 = wt[j * 8], p1 = wt[4 * KS + j * 8];
          bh[j][0] = __float_as_uint(p0.x);
          bl[j][0] = __float_as_uint(p0.y);
          bh[j][1] = __float_as_uint(p1.x);
          bl[j][1] = __float_as_uint(p1.y);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          // A (pixel, c) = x at output pixel + (u - 1, v - 1); staged column
          // s holds image column col0 - 4 + s
          const int i = warp * MT + m;
          const int orow = i / T::MPR, ocol = (i % T::MPR) * 16;
          const float* xa =
              xs + ((orow + u) * kCC + t) * kSW + ocol + g + v + 3;
          uint32_t ah[4], al[4];
          pggan::tf32_split(xa[0], ah[0], al[0]);
          pggan::tf32_split(xa[8], ah[1], al[1]);
          pggan::tf32_split(xa[4 * kSW], ah[2], al[2]);
          pggan::tf32_split(xa[4 * kSW + 8], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            pggan::mma_3xtf32(acc[m][j], ah, al, bh[j], bl[j]);
        }
      }
    }
  }

  // acc[m][j][2h + e]: pixel column (m-tile column) + g + 8h, channel
  // 8j + 2t + e; channels >= K hold exact zeros (zero weights)
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int i = warp * MT + m;
    const int gr = row0 + i / T::MPR;
    const int pc = col0 + (i % T::MPR) * 16 + g;
    float rr[2] = {1.f, 1.f};
    if (EPI != pggan::kEpiNone) {
      float ss[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 8 * j + 2 * t + e;
            float z = acc[m][j][2 * h + e];
            if (k < Kg) z += __ldg(b + k0 + k);
            z = z >= 0.f ? z : z * slope;
            acc[m][j][2 * h + e] = z;
            ss[h] = fmaf(z, z, ss[h]);
          }
      if (EPI == pggan::kEpiActPn) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
          ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
          rr[h] = rsqrtf(ss[h] / (float)K + eps);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] *= rr[e >> 1];
      }
    }
    if (gr >= H) continue;
    float* yrow = y + (((long long)n * H + gr) * K + k0) * W;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = pc + 8 * h;
      if (gc >= W) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * j + 2 * t + e;
          if (k < Kg) yrow[(long long)k * W + gc] = acc[m][j][2 * h + e];
        }
      if (EPI == pggan::kEpiActPn && t == 0)
        r[((long long)n * H + gr) * W + gc] = rr[h];
    }
  }
}

struct Args {
  const float* x;
  const float* w;
  const float* b;
  float* y;
  float* r;
  float* ws;
  int N, H, C, W, K;
  float slope, eps;
  cudaStream_t stream;
};

template <int KT, int EPI>
int launch(const Args& a) {
  using T = Tile<KT>;
  const int C8 = (a.C + kCC - 1) / kCC * kCC;
  const int groups = (a.K + KT - 1) / KT;
  const int split = pggan::launch_split_weights<conv3x3_split>(
      a.w, reinterpret_cast<float2*>(a.ws), a.C, a.K, KT, C8, T::KS, groups,
      a.stream);
  if (split != 0) return split;
  auto kern = conv3x3_kernel<KT, EPI>;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int vec = a.W % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  dim3 grid((a.W + kTW - 1) / kTW, (a.H + T::TH - 1) / T::TH,
            a.N * groups);
  kern<<<grid, kThreads, T::kSmemBytes, a.stream>>>(
      a.x, a.ws, a.b, a.y, a.r, a.H, a.C, a.W, a.K, C8, groups, vec, a.slope,
      a.eps);
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

// x (N, H, C, W); w (3, 3, C, K) HWIO; b (K,) (unused for epi 0); y (N, H,
// K, W); r (N, H, W) for epi 2 only. KT is the output-channel tile: K
// rounded up to 8, 16, 32 or 64, and 64 for K > 64, which runs ceil(K / 64)
// channel groups in one grid (not with pixelnorm: its mean needs all K in
// one block). ws is scratch for the split weights: at least
// 2 * 9 * C8 * (KT + 4) * ceil(K / KT) floats, C8 = C rounded up to 8.
extern "C" int pggan_conv3x3(const float* x, const float* w, const float* b,
                             float* y, float* r, float* ws, int N, int H,
                             int C, int W, int K, int KT, int epi, float slope,
                             float eps, void* stream) {
  if (epi == pggan::kEpiActPn && K > KT) return (int)cudaErrorInvalidValue;
  Args a{x, w, b, y, r, ws, N, H, C, W, K, slope, eps,
         static_cast<cudaStream_t>(stream)};
  switch (KT) {
    case 8: return launch_epi<8>(epi, a);
    case 16: return launch_epi<16>(epi, a);
    case 32: return launch_epi<32>(epi, a);
    case 64: return launch_epi<64>(epi, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
