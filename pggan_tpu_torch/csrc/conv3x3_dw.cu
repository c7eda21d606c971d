// Weight gradient of the same-padding 3x3 convolution on (N, H, C, W) f32:
//
//   dw[u][v][c][k] = sum_{n,i,j} x[n][i+u-1][c][j+v-1] * ct[n][i][k][j]
//
// with x zero outside the image; dw is (3, 3, C, K) HWIO.
//
// Replaces the TPU kernel pggan_tpu/ops/pallas_conv.py:conv3x3_dw_small_c
// (body _dw_kernel). That kernel walked its grid in order on one core and
// carried the (3, 3C, K) sum in VMEM from step to step; blocks on the card
// run in no order, so here the sum is split in two passes.
//
// Bound: f32 FMAs (9 C K per pixel, no TF32, for parity) and, second, the
// partial sums' traffic. Per tap this is a matrix product of M = C by N = K
// whose reduction runs over all N*H*W pixels: up to 6.3 M pixels in the
// discriminator's paired pass at 1024 px, against at most 9 * 64 * 128
// outputs. Design:
// - pass 1 (conv3x3_dw_partial): the grid is (P pixel slices, C / 8,
//   K / KT). A pixel slice is a run of image rows of one 128-column tile. For
//   each row the block stages the three x halo rows of its 8 input channels
//   (zeros outside the image) and the ct row of its KT output channels in
//   shared memory. A thread owns one input channel and 8 output channels for
//   all 9 taps (72 accumulators in registers) and a segment of the tile's
//   columns, which it walks with a sliding 3x3 window of x, so each step
//   loads 3 x values and 8 ct values for 72 FMAs. The threads that share a
//   (c, k) pair but hold other column segments are summed through shared
//   memory in lane order, and the block writes one partial (9, C, K) tile to
//   a workspace (P, 9, C, K).
// - pass 2 (conv3x3_dw_reduce): sums the P partials of each output in a
//   fixed order (8 contiguous runs, then the 8 run sums in order).
// No atomics, so the result is the same from run to run.
//
// KT is 8, 16 or 32 (K rounded up, tiles of 32 above 32): the thread count
// per (c, k-group) pair grows as KT shrinks, so small K still fills a block.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCT = 8;         // input channels per block tile
constexpr int kTW = 128;       // columns per block tile
constexpr int kKS = 8;         // output channels per thread
constexpr int kXW = kTW + 2;   // staged x row: 1-column halo each side
constexpr int kCTW = kTW + 1;  // staged ct row stride: +1 spreads the banks

template <int KT>
struct DwTile {
  static constexpr int PAIRS = kCT * (KT / kKS);  // (c, k-group) pairs
  static constexpr int LANES = kThreads / PAIRS;  // column segments per pair
  static constexpr int SEG = kTW / LANES;         // columns per segment
  static constexpr int kXFloats = 3 * kCT * kXW;
  static constexpr int kCtFloats = KT * kCTW;
  static_assert(kThreads * kKS <= kXFloats, "lane reduction reuses xs");
};

template <int KT>
__global__ void __launch_bounds__(kThreads)
conv3x3_dw_partial(const float* __restrict__ x, const float* __restrict__ ct,
                   float* __restrict__ ws, int NH, int H, int C, int W, int K,
                   int rows_per_block, int col_tiles) {
  using T = DwTile<KT>;
  __shared__ float xs[T::kXFloats];   // [u][c][kXW]: rows i-1, i, i+1
  __shared__ float cts[T::kCtFloats];  // [k][kCTW]: row i

  const int tid = threadIdx.x;
  const int pair = tid % T::PAIRS, lane = tid / T::PAIRS;
  const int cl = pair % kCT, kg = pair / kCT;
  const int p = blockIdx.x;
  const int j0 = (p % col_tiles) * kTW;
  const int c0 = blockIdx.y * kCT, k0 = blockIdx.z * KT;
  const int r_begin = (p / col_tiles) * rows_per_block;
  const int r_end = min(NH, r_begin + rows_per_block);
  const int jb = lane * T::SEG;

  float acc[9][kKS];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) acc[t][kk] = 0.f;

  for (int r = r_begin; r < r_end; ++r) {
    const int n = r / H, i = r - n * H;
    __syncthreads();  // the previous row's reads are done
    for (int e = tid; e < T::kXFloats; e += kThreads) {
      const int t = e % kXW;
      const int rest = e / kXW;
      const int c = c0 + rest % kCT;
      const int gi = i - 1 + rest / kCT, gc = j0 - 1 + t;
      float v = 0.f;
      if (gi >= 0 && gi < H && gc >= 0 && gc < W && c < C)
        v = __ldg(x + (((long long)n * H + gi) * C + c) * W + gc);
      xs[e] = v;
    }
    for (int e = tid; e < KT * kTW; e += kThreads) {
      const int t = e % kTW, kl = e / kTW;
      const int gc = j0 + t, k = k0 + kl;
      float v = 0.f;
      if (gc < W && k < K)
        v = __ldg(ct + (((long long)n * H + i) * K + k) * W + gc);
      cts[kl * kCTW + t] = v;
    }
    __syncthreads();

    // xw[u][v] = x at row i+u-1, column j+v-1 (staged column j+v)
    float xw[3][3];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const float* xr = xs + (u * kCT + cl) * kXW + jb;
      xw[u][0] = xr[0];
      xw[u][1] = xr[1];
    }
#pragma unroll
    for (int s = 0; s < T::SEG; ++s) {
      const int j = jb + s;
#pragma unroll
      for (int u = 0; u < 3; ++u) xw[u][2] = xs[(u * kCT + cl) * kXW + j + 2];
      float cv[kKS];
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) cv[kk] = cts[(kg * kKS + kk) * kCTW + j];
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v)
#pragma unroll
          for (int kk = 0; kk < kKS; ++kk)
            acc[u * 3 + v][kk] = fmaf(xw[u][v], cv[kk], acc[u * 3 + v][kk]);
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        xw[u][0] = xw[u][1];
        xw[u][1] = xw[u][2];
      }
    }
  }

  // Sum the LANES segments of each (pair, tap, kk) in lane order, one tap at
  // a time through shared memory, and write this block's partial tile.
  float* red = xs;  // [lane][pair][kKS] == [tid][kKS]
  float* part = ws + (long long)p * 9 * C * K;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) red[tid * kKS + kk] = acc[t][kk];
    __syncthreads();
    for (int e = tid; e < T::PAIRS * kKS; e += kThreads) {
      float sum = 0.f;
      for (int l = 0; l < T::LANES; ++l) sum += red[l * T::PAIRS * kKS + e];
      const int pr = e / kKS, kk = e % kKS;
      const int c = c0 + pr % kCT, k = k0 + (pr / kCT) * kKS + kk;
      if (c < C && k < K) part[((long long)t * C + c) * K + k] = sum;
    }
  }
}

constexpr int kRedE = 32;  // outputs per reduce block (one warp wide)
constexpr int kRedG = 8;   // runs of partials per output

__global__ void __launch_bounds__(kRedE * kRedG)
conv3x3_dw_reduce(const float* __restrict__ ws, float* __restrict__ dw,
                  int P, long long E) {
  __shared__ float runs[kRedG][kRedE];
  const int el = threadIdx.x % kRedE, g = threadIdx.x / kRedE;
  const long long e = blockIdx.x * (long long)kRedE + el;
  float s = 0.f;
  if (e < E) {
    const int per = (P + kRedG - 1) / kRedG;
    const int p1 = min(P, (g + 1) * per);
    for (int p = g * per; p < p1; ++p) s += __ldg(ws + (long long)p * E + e);
  }
  runs[g][el] = s;
  __syncthreads();
  if (g == 0 && e < E) {
    float t = runs[0][el];
#pragma unroll
    for (int q = 1; q < kRedG; ++q) t += runs[q][el];
    dw[e] = t;
  }
}

template <int KT>
int launch_partial(const float* x, const float* ct, float* ws, int N, int H,
                   int C, int W, int K, int rows_per_block, int P,
                   cudaStream_t s) {
  const int col_tiles = (W + kTW - 1) / kTW;
  dim3 grid(P, (C + kCT - 1) / kCT, (K + KT - 1) / KT);
  conv3x3_dw_partial<KT><<<grid, kThreads, 0, s>>>(
      x, ct, ws, N * H, H, C, W, K, rows_per_block, col_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, C, W); ct (N, H, K, W); ws (P, 9, C, K) scratch; dw (3, 3, C, K).
// P = ceil(N * H / rows_per_block) * ceil(W / 128) pixel slices; KT is the
// k tile (8, 16 or 32).
extern "C" int pggan_conv3x3_dw(const float* x, const float* ct, float* ws,
                                float* dw, int N, int H, int C, int W, int K,
                                int KT, int rows_per_block, int P,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e;
  switch (KT) {
    case 8:
      e = launch_partial<8>(x, ct, ws, N, H, C, W, K, rows_per_block, P, s);
      break;
    case 16:
      e = launch_partial<16>(x, ct, ws, N, H, C, W, K, rows_per_block, P, s);
      break;
    case 32:
      e = launch_partial<32>(x, ct, ws, N, H, C, W, K, rows_per_block, P, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  const long long E = 9LL * C * K;
  const long long blocks = (E + kRedE - 1) / kRedE;
  conv3x3_dw_reduce<<<(unsigned)blocks, kRedE * kRedG, 0, s>>>(ws, dw, P, E);
  return (int)cudaGetLastError();
}
