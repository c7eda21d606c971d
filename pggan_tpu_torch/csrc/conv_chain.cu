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
// Bound: 18 (C K1 + K1 K2) FLOPs per output pixel against 4 (C + K2) bytes:
// operations at the 256-512 px serve stages (C = 64, 32), bytes at 1024 px
// (C = 16, K1 = K2 = 8) on the H100. The fusion saves the intermediate's
// write and read (4 K1 bytes per pixel each way). The design:
// - Two implicit GEMMs on the tensor cores, mma.sync.m16n8k8 in TF32 with
//   the three-product split of tf32_mma.cuh (f32 accuracy), as conv3x3.cu.
//   The weights are split once per call by split_weights.cuh into (hi, lo)
//   pairs; A is split in registers as it is loaded.
// - Stage 1: M = the (TH + 2) x (TW + 2) intermediate positions of the tile
//   (its 1-pixel halo included), taken as m-tiles of 16 consecutive
//   positions of the flattened (row, column) walk, so the 34-wide rows waste
//   no m-tile columns; N = K1 rounded to 8/16/32/64; reduced over 9 taps x
//   C in chunks of 8 input channels. Each chunk's input halo ((TH + 4) rows
//   x 8 x 40 floats, the 16-byte-aligned span [col0 - 4, col0 + 36)) and
//   w1 rows are double buffered with cp.async, so shared memory no longer
//   grows with C (the previous kernel staged the whole C-deep halo: 154 KB
//   at 256 px). Bias, leaky ReLU and pixelnorm run on the fragments; a warp
//   owns all of K1, so the mean over K1 is two quad shuffles. Intermediate
//   positions outside the image are written as 0.
// - Stage 2: M = the TH x TW output pixels (m-tiles of 16 along a row), N =
//   K2 rounded, reduced over 9 taps x K1 from the intermediate in shared
//   memory (rows of 40 floats per channel, = 8 mod 32, so A-fragment loads
//   are conflict-free), with w2 rows double buffered like w1's. The
//   intermediate and the w2 buffers reuse stage 1's staging memory. Each
//   store instruction writes full 32-byte runs along W.
// - Tile plan (TW = 32 columns; 8 warps), chosen by timing variants on an
//   H100: TH = 8 rows where K1 or K2 is above 16, 16 rows otherwise. At
//   256 px (C 64, K1 32) TH = 8 takes 92.7 KB, so two blocks (16 warps) an
//   SM; stage 1 computes 340 positions in 22 m-tiles for 256 output pixels
//   (3 m-tiles a warp). TH = 16 there needs 134 KB (one block an SM) or a
//   single w2 buffer and 128 registers (spills): both were slower. At 512
//   and 1024 px TH = 16 takes 74 and 65 KB (two and three blocks an SM by
//   the launch bounds) and stage 1 computes 612 positions in 39 m-tiles for
//   512 pixels: 1.2x recompute; TH = 8 there was slower. Splitting each
//   staged input chunk once into (hi, lo) pairs in shared memory, instead of
//   at every tap, was slower too (one more pass and barrier a chunk, more
//   registers). The halo recompute is what the unfused pair of conv3x3.cu
//   calls does not pay, and it costs more than the intermediate's round
//   trip through device memory saves at these shapes.
// - mma.sync, not wgmma: TF32 wgmma wants K-major operands in shared
//   memory, and a tap's A is a one-pixel shift of the pixel-major tile (see
//   conv3x3.cu).

#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "split_weights.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTW = 32;       // output columns per tile
constexpr int kIW = kTW + 2;  // intermediate positions per row (1-col halo)
constexpr int kMPR = kTW / 16;  // output m-tiles a row
constexpr int kCC = 8;        // channels per stage (one k-step)
constexpr int kXS = kTW + 8;  // staged input row, floats (= 8 mod 32)
constexpr int kZS = kTW + 8;  // intermediate row of one channel (= 8 mod 32)

constexpr int cmax(int a, int b) { return a > b ? a : b; }

struct chain_split;  // names this kernel's weight split in a profile

template <int K1T, int K2T>
struct Plan {
  static constexpr int KT = cmax(K1T, K2T);
  static constexpr int TH = KT > 16 ? 8 : 16;  // output rows
  static constexpr int NT1 = K1T / 8, NT2 = K2T / 8;
  static constexpr int P1 = (TH + 2) * kIW;  // intermediate positions
  static constexpr int M1 = (P1 + 15) / 16;  // their m-tiles
  static constexpr int MT1 = (M1 + kWarps - 1) / kWarps;  // a warp's
  static constexpr int MT2 = TH * kTW / 16 / kWarps;  // output m-tiles a warp
  static constexpr int KS1 = K1T + 4, KS2 = K2T + 4;  // (hi, lo) pairs a row
  static constexpr int kXFloats = (TH + 4) * kCC * kXS;
  static constexpr int kW1Floats = 9 * kCC * KS1 * 2;
  static constexpr int kW2Floats = 9 * kCC * KS2 * 2;
  static constexpr int kStage1 = kXFloats + kW1Floats;
  static constexpr int kZFloats = (TH + 2) * K1T * kZS;
  static constexpr size_t kSmemBytes =
      sizeof(float) * cmax(2 * kStage1, kZFloats + 2 * kW2Floats);
  static constexpr int kMinBlocks = KT > 32 ? 1 : KT > 8 ? 2 : 3;
  static_assert(MT2 * kWarps * 16 == TH * kTW, "output m-tiles per warp");
};

// chunk c0 (8 rows of the reduction) of split weights ws (rows of KS
// pairs, C8 rows a tap) into wsm, without committing
template <int KS>
__device__ __forceinline__ void copy_weights(float* wsm, const float* ws,
                                             int c0, int C8, int tid) {
  constexpr int WV = kCC * KS * 2 / 4;  // 16-byte vectors per tap
  for (int e = tid; e < 9 * WV; e += kThreads) {
    const int q = e % WV, tap = e / WV;
    pggan::cp_async16(wsm + tap * kCC * KS * 2 + 4 * q,
                      ws + ((long long)tap * C8 + c0) * KS * 2 + 4 * q, true);
  }
}

template <int K1T, int K2T, bool PN>
__global__ void __launch_bounds__(kThreads, Plan<K1T, K2T>::kMinBlocks)
chain_kernel(const float* __restrict__ x, const float* __restrict__ w1s,
             const float* __restrict__ b1, const float* __restrict__ w2s,
             const float* __restrict__ b2, float* __restrict__ y, int H,
             int C, int W, int K1, int K2, int C8, int K18, int vec,
             float slope, float eps) {
  using P = Plan<K1T, K2T>;
  constexpr int TH = P::TH, NT1 = P::NT1, NT2 = P::NT2;
  constexpr int MT1 = P::MT1, MT2 = P::MT2, KS1 = P::KS1, KS2 = P::KS2;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.z;
  const int row0 = blockIdx.y * TH, col0 = blockIdx.x * kTW;
  const float* xn = x + (long long)n * H * C * W;

  // stage 1's chunk c0 (input channels c0 .. c0 + 7) into buffer s: the
  // halo, staged row sr and column q holding x[row0 - 2 + sr, c0 + c,
  // col0 - 4 + q] (zero outside the image), and w1's rows
  auto issue1 = [&](int c0, int s) {
    float* xs = smem + s * P::kStage1;
    if (vec) {
      constexpr int V = kXS / 4;
      for (int e = tid; e < (TH + 4) * kCC * V; e += kThreads) {
        const int q = e % V, rest = e / V;
        const int c = rest % kCC, sr = rest / kCC;
        const int gr = row0 - 2 + sr, gc = col0 - 4 + 4 * q;
        const bool ok = gr >= 0 && gr < H && c0 + c < C && gc >= 0 && gc < W;
        pggan::cp_async16(xs + (sr * kCC + c) * kXS + 4 * q,
                          ok ? xn + ((long long)gr * C + c0 + c) * W + gc : x,
                          ok);
      }
    } else {
      for (int e = tid; e < (TH + 4) * kCC * kXS; e += kThreads) {
        const int q = e % kXS, rest = e / kXS;
        const int c = rest % kCC, sr = rest / kCC;
        const int gr = row0 - 2 + sr, gc = col0 - 4 + q;
        const bool ok = gr >= 0 && gr < H && c0 + c < C && gc >= 0 && gc < W;
        pggan::cp_async4(xs + e,
                         ok ? xn + ((long long)gr * C + c0 + c) * W + gc : x,
                         ok);
      }
    }
    copy_weights<KS1>(xs + P::kXFloats, w1s, c0, C8, tid);
    pggan::cp_async_commit();
  };

  // ---- stage 1: intermediate position p = s * kIW + u of the tile is
  // global (row0 - 1 + s, col0 - 1 + u); m-tile i holds p in [16 i, 16 i +
  // 16), m-tile m of this warp is i = m * kWarps + warp. xo: the staged
  // offset of this lane's two positions (g, g + 8) at tap (0, 0), channel 0
  int xo[MT1][2];
#pragma unroll
  for (int m = 0; m < MT1; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int p = (m * kWarps + warp) * 16 + g + 8 * h;
      if (p >= P::P1) p = 0;  // the last m-tile's padding: any valid address
      xo[m][h] = p / kIW * kCC * kXS + p % kIW + 2;
    }

  float acc1[MT1][NT1][4];
#pragma unroll
  for (int m = 0; m < MT1; ++m)
#pragma unroll
    for (int j = 0; j < NT1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[m][j][e] = 0.f;

  const int chunks1 = C8 / kCC;
  issue1(0, 0);
  for (int ch = 0; ch < chunks1; ++ch) {
    pggan::cp_async_wait_all();
    __syncthreads();  // chunk ch landed for all; chunk ch - 1 is done
    if (ch + 1 < chunks1) issue1((ch + 1) * kCC, (ch + 1) & 1);
    const float* xs = smem + (ch & 1) * P::kStage1;
    const float* wsm = xs + P::kXFloats;
#pragma unroll
    for (int u = 0; u < 3; ++u) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        // B (c, k) = w1[u][v][c][k]: b0 (c = t, k = g), b1 (c = t + 4)
        const float2* wt = reinterpret_cast<const float2*>(wsm) +
                           (u * 3 + v) * kCC * KS1 + t * KS1 + g;
        uint32_t bh[NT1][2], bl[NT1][2];
#pragma unroll
        for (int j = 0; j < NT1; ++j) {
          const float2 p0 = wt[j * 8], p1 = wt[4 * KS1 + j * 8];
          bh[j][0] = __float_as_uint(p0.x);
          bl[j][0] = __float_as_uint(p0.y);
          bh[j][1] = __float_as_uint(p1.x);
          bl[j][1] = __float_as_uint(p1.y);
        }
        const int tap = (u * kCC + t) * kXS + v;
#pragma unroll
        for (int m = 0; m < MT1; ++m) {
          if (m * kWarps + warp >= P::M1) continue;  // warp-uniform
          uint32_t ah[4], al[4];
          pggan::tf32_split(xs[xo[m][0] + tap], ah[0], al[0]);
          pggan::tf32_split(xs[xo[m][1] + tap], ah[1], al[1]);
          pggan::tf32_split(xs[xo[m][0] + tap + 4 * kXS], ah[2], al[2]);
          pggan::tf32_split(xs[xo[m][1] + tap + 4 * kXS], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < NT1; ++j)
            pggan::mma_3xtf32(acc1[m][j], ah, al, bh[j], bl[j]);
        }
      }
    }
  }

  // every warp is done with the staging buffers, which the intermediate
  // zs [(TH + 2)][K1T][kZS] and the two w2 buffers after it reuse
  __syncthreads();
  float* zs = smem;
  float* w2buf = smem + P::kZFloats;
  copy_weights<KS2>(w2buf, w2s, 0, K18, tid);
  pggan::cp_async_commit();

  // acc1[m][j][2h + e]: position 16 i + g + 8h, channel 8j + 2t + e;
  // channels >= K1 hold exact zeros (zero weights and bias)
#pragma unroll
  for (int m = 0; m < MT1; ++m) {
    const int i = m * kWarps + warp;
    if (i >= P::M1) continue;  // warp-uniform
    float ss[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT1; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * j + 2 * t + e;
          float z = acc1[m][j][2 * h + e];
          if (k < K1) z += __ldg(b1 + k);
          z = z >= 0.f ? z : z * slope;
          acc1[m][j][2 * h + e] = z;
          ss[h] = fmaf(z, z, ss[h]);
        }
    if (PN) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
        ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
        const float r = rsqrtf(ss[h] / (float)K1 + eps);
#pragma unroll
        for (int j = 0; j < NT1; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc1[m][j][2 * h + e] *= r;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = i * 16 + g + 8 * h;
      if (p >= P::P1) continue;
      const int s = p / kIW, u = p % kIW;
      const int gr = row0 - 1 + s, gc = col0 - 1 + u;
      // outside the image: the second conv's zero padding
      const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
      float* zp = zs + s * K1T * kZS + u;
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          zp[(8 * j + 2 * t + e) * kZS] =
              inside ? acc1[m][j][2 * h + e] : 0.f;
    }
  }

  // ---- stage 2: output m-tile i = warp * MT2 + m is row i / kMPR,
  // columns (i % kMPR) * 16 + [0, 16) of the tile; tap (u, v) reads
  // intermediate row (row + u), column (column + v)
  float acc2[MT2][NT2][4];
#pragma unroll
  for (int m = 0; m < MT2; ++m)
#pragma unroll
    for (int j = 0; j < NT2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[m][j][e] = 0.f;

  const int chunks2 = K18 / kCC;
  for (int ch = 0; ch < chunks2; ++ch) {
    pggan::cp_async_wait_all();
    __syncthreads();  // zs written; w2 chunk ch landed; chunk ch - 1 done
    if (ch + 1 < chunks2) {
      copy_weights<KS2>(w2buf + ((ch + 1) & 1) * P::kW2Floats, w2s,
                        (ch + 1) * kCC, K18, tid);
      pggan::cp_async_commit();
    }
    const float* wsm = w2buf + (ch & 1) * P::kW2Floats;
    const float* zc = zs + (ch * kCC + t) * kZS + g;
#pragma unroll
    for (int u = 0; u < 3; ++u) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const float2* wt = reinterpret_cast<const float2*>(wsm) +
                           (u * 3 + v) * kCC * KS2 + t * KS2 + g;
        uint32_t bh[NT2][2], bl[NT2][2];
#pragma unroll
        for (int j = 0; j < NT2; ++j) {
          const float2 p0 = wt[j * 8], p1 = wt[4 * KS2 + j * 8];
          bh[j][0] = __float_as_uint(p0.x);
          bl[j][0] = __float_as_uint(p0.y);
          bh[j][1] = __float_as_uint(p1.x);
          bl[j][1] = __float_as_uint(p1.y);
        }
#pragma unroll
        for (int m = 0; m < MT2; ++m) {
          const int i = warp * MT2 + m;
          const float* za =
              zc + (i / kMPR + u) * K1T * kZS + (i % kMPR) * 16 + v;
          uint32_t ah[4], al[4];
          pggan::tf32_split(za[0], ah[0], al[0]);
          pggan::tf32_split(za[8], ah[1], al[1]);
          pggan::tf32_split(za[4 * kZS], ah[2], al[2]);
          pggan::tf32_split(za[4 * kZS + 8], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < NT2; ++j)
            pggan::mma_3xtf32(acc2[m][j], ah, al, bh[j], bl[j]);
        }
      }
    }
  }

  // acc2[m][j][2h + e]: output column (m-tile column) + g + 8h, channel
  // 8j + 2t + e
#pragma unroll
  for (int m = 0; m < MT2; ++m) {
    const int i = warp * MT2 + m;
    const int gr = row0 + i / kMPR;
    const int pc = col0 + (i % kMPR) * 16 + g;
    float ss[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * j + 2 * t + e;
          float z = acc2[m][j][2 * h + e];
          if (k < K2) z += __ldg(b2 + k);
          z = z >= 0.f ? z : z * slope;
          acc2[m][j][2 * h + e] = z;
          ss[h] = fmaf(z, z, ss[h]);
        }
    if (PN) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
        ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
        const float r = rsqrtf(ss[h] / (float)K2 + eps);
#pragma unroll
        for (int j = 0; j < NT2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc2[m][j][2 * h + e] *= r;
      }
    }
    if (gr >= H) continue;
    float* yrow = y + ((long long)n * H + gr) * K2 * W;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = pc + 8 * h;
      if (gc >= W) continue;
#pragma unroll
      for (int j = 0; j < NT2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * j + 2 * t + e;
          if (k < K2) yrow[(long long)k * W + gc] = acc2[m][j][2 * h + e];
        }
    }
  }
}

struct Args {
  const float* x;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  float* y;
  float* ws;
  int N, H, C, W, K1, K2;
  float slope, eps;
  cudaStream_t stream;
};

template <int K1T, int K2T, bool PN>
int launch(const Args& a) {
  using P = Plan<K1T, K2T>;
  const int C8 = (a.C + kCC - 1) / kCC * kCC;
  const int K18 = (a.K1 + kCC - 1) / kCC * kCC;
  float2* ws1 = reinterpret_cast<float2*>(a.ws);
  float2* ws2 = ws1 + 9LL * C8 * P::KS1;
  int e = pggan::launch_split_weights<chain_split>(a.w1, ws1, a.C, a.K1, K1T,
                                                   C8, P::KS1, 1, a.stream);
  if (e != 0) return e;
  e = pggan::launch_split_weights<chain_split>(a.w2, ws2, a.K1, a.K2, K2T,
                                               K18, P::KS2, 1, a.stream);
  if (e != 0) return e;
  auto kern = chain_kernel<K1T, K2T, PN>;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int vec = a.W % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  dim3 grid((a.W + kTW - 1) / kTW, (a.H + P::TH - 1) / P::TH, a.N);
  kern<<<grid, kThreads, P::kSmemBytes, a.stream>>>(
      a.x, reinterpret_cast<const float*>(ws1), a.b1,
      reinterpret_cast<const float*>(ws2), a.b2, a.y, a.H, a.C, a.W, a.K1,
      a.K2, C8, K18, vec, a.slope, a.eps);
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

// x (N, H, C, W); w1 (3, 3, C, K1), b1 (K1,); w2 (3, 3, K1, K2), b2 (K2,),
// HWIO; y (N, H, K2, W). K1T, K2T: K1, K2 rounded up to 8, 16, 32 or 64.
// ws is scratch for the split weights: at least 2 * 9 * (C8 (K1T + 4) +
// K18 (K2T + 4)) floats, C8 and K18 = C and K1 rounded up to 8.
extern "C" int pggan_conv3x3_chain(const float* x, const float* w1,
                                   const float* b1, const float* w2,
                                   const float* b2, float* y, float* ws,
                                   int N, int H, int C, int W, int K1, int K2,
                                   int K1T, int K2T, int pn, float slope,
                                   float eps, void* stream) {
  if (K1 > K1T || K2 > K2T) return (int)cudaErrorInvalidValue;
  Args a{x, w1, b1, w2, b2, y, ws, N, H, C, W, K1, K2, slope, eps,
         static_cast<cudaStream_t>(stream)};
  switch (K1T) {
    case 8: return launch_k2<8>(K2T, pn != 0, a);
    case 16: return launch_k2<16>(K2T, pn != 0, a);
    case 32: return launch_k2<32>(K2T, pn != 0, a);
    case 64: return launch_k2<64>(K2T, pn != 0, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
