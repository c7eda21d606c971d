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
// Bound: 18 C K FLOPs per pixel against 4 (C + K) bytes, so bytes at the
// 512-1024 px shapes (C, K <= 32) and operations at 128-256 px on the
// H100. The design:
// - A GEMM on the tensor cores, per block: M = 9 taps x 8 input channels
//   (pairs of taps make the 16 rows of an m-tile; the fifth m-tile's second
//   half is empty), N = a tile of KT output channels (8, 16, 32 or 64),
//   reduced over the pixels of the block's slice: a run of image rows of
//   one 128-column tile. A[(u, v, c)][j] is the staged x row i + u - 1 shifted
//   by v; B[j][k] is the staged cotangent row i. Both are pixel-contiguous
//   in shared memory, as mma.m16n8k8's row-major A and column-major B want.
// - Arithmetic: the three-product TF32 split of tf32_mma.cuh with f32
//   accumulators (f32 accuracy, see there). Each x row is split once, into
//   hi / lo rows of a four-row ring (rows i - 1, i, i + 1 and the one being
//   split), because every x value feeds 9 taps; the cotangent is split in
//   registers, where each fragment feeds all five m-tiles.
// - Staging: one new x row and one cotangent row per image row, copied
//   with cp.async into double buffers while the tensor cores work on the
//   row before; out-of-image elements are zero-filled by the copy. Row
//   strides of 140 (x, = 12 mod 32) and 132 (ct, = 4 mod 32) floats make
//   the fragment loads conflict-free; 4-byte copies when W is not a
//   multiple of 4 or a pointer is unaligned.
// - Warps: 8, in NG groups over the n-tiles (two n-tiles a warp) times PS
//   warps that split the tile's columns; each warp keeps 5 x 2 x 4 (5 x 4
//   at KT = 8) accumulators. At the end the PS warps' sums are added in
//   warp order through shared memory and the block writes its partial
//   (9, C, K) tile to a workspace (P, 9, C, K). 53, 61, 78, 112 KB of
//   shared memory a block at KT = 8, 16, 32, 64; three blocks per SM at
//   KT = 8, two above (register caps 80 and 128).
// - Pass 2 (conv3x3_dw_reduce) sums the P partials of each output in a
//   fixed order (8 contiguous runs, then the 8 run sums in order).
// No atomics, so the result is the same from run to run.

#include <cstdint>

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCT = 8;         // input channels per block
constexpr int kTW = 128;       // columns per block tile
constexpr int kXR = kTW + 8;   // raw x row: the aligned span [j0-4, j0+TW+4)
constexpr int kXS = kTW + 12;  // split x row stride (= 12 mod 32)
constexpr int kCR = kTW + 4;   // cotangent row stride (= 4 mod 32)
constexpr int kMT = 5;         // m-tiles: 9 taps x 8 channels, taps in pairs

template <int KT>
struct DwTile {
  static constexpr int NT = KT / 8;              // n-tiles of the block
  static constexpr int NW = NT < 2 ? NT : 2;     // n-tiles per warp
  static constexpr int NG = NT / NW;             // warp groups over n-tiles
  static constexpr int PS = 8 / NG;              // warps splitting columns
  static constexpr int KSTEPS = kTW / 8 / PS;    // 8-pixel steps per warp
  static constexpr int kXRaw = 2 * kCT * kXR;    // [buf][c][kXR]
  static constexpr int kCtRaw = 2 * KT * kCR;    // [buf][k][kCR]
  static constexpr int kRing = 4 * kCT * kXS;    // [slot][c][kXS], hi or lo
  static constexpr size_t kSmemBytes =
      (kXRaw + kCtRaw + 2 * kRing) * sizeof(float);
  static_assert(kThreads * NW * 4 <= kXRaw + kCtRaw + 2 * kRing,
                "the final reduction reuses the staging buffers");
};

template <int KT>
__global__ void __launch_bounds__(kThreads, KT == 8 ? 3 : 2)
conv3x3_dw_partial(const float* __restrict__ x, const float* __restrict__ ct,
                   float* __restrict__ ws, int H, int C, int W, int K,
                   int rows_per_block, int row_chunks, int col_tiles,
                   int vec) {
  using T = DwTile<KT>;
  constexpr int NW = T::NW, PS = T::PS;
  extern __shared__ __align__(16) float smem[];
  float* xraw = smem;
  float* ctraw = xraw + T::kXRaw;
  float* xhi = ctraw + T::kCtRaw;
  float* xlo = xhi + T::kRing;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ng = warp / PS, ps = warp % PS;
  const int p = blockIdx.x;
  const int j0 = (p % col_tiles) * kTW;
  const int chunk = (p / col_tiles) % row_chunks;
  const int n = p / col_tiles / row_chunks;
  const int i0 = chunk * rows_per_block;
  const int i1 = min(H, i0 + rows_per_block);
  const int c0 = blockIdx.y * kCT, k0 = blockIdx.z * KT;

  // x row i of channels c0.. (zeros outside the image) into xraw[buf]
  auto issue_x = [&](int i, int buf) {
    float* dst = xraw + buf * kCT * kXR;
    const bool row_ok = i >= 0 && i < H;
    const float* xr = x + ((long long)n * H + i) * C * W;
    if (vec) {
      constexpr int V = kXR / 4;
      for (int e = tid; e < kCT * V; e += kThreads) {
        const int q = e % V, c = e / V;
        const int gc = j0 - 4 + 4 * q;
        const bool ok = row_ok && c0 + c < C && gc >= 0 && gc < W;
        pggan::cp_async16(dst + c * kXR + 4 * q,
                          ok ? xr + (long long)(c0 + c) * W + gc : x, ok);
      }
    } else {
      for (int e = tid; e < kCT * kXR; e += kThreads) {
        const int q = e % kXR, c = e / kXR;
        const int gc = j0 - 4 + q;
        const bool ok = row_ok && c0 + c < C && gc >= 0 && gc < W;
        pggan::cp_async4(dst + e, ok ? xr + (long long)(c0 + c) * W + gc : x,
                         ok);
      }
    }
  };
  // cotangent row i of channels k0.. into ctraw[buf]
  auto issue_ct = [&](int i, int buf) {
    float* dst = ctraw + buf * KT * kCR;
    const float* cr = ct + ((long long)n * H + i) * K * W;
    if (vec) {
      constexpr int V = kTW / 4;
      for (int e = tid; e < KT * V; e += kThreads) {
        const int q = e % V, kl = e / V;
        const int gc = j0 + 4 * q;
        const bool ok = k0 + kl < K && gc < W;
        pggan::cp_async16(dst + kl * kCR + 4 * q,
                          ok ? cr + (long long)(k0 + kl) * W + gc : ct, ok);
      }
    } else {
      for (int e = tid; e < KT * kTW; e += kThreads) {
        const int q = e % kTW, kl = e / kTW;
        const int gc = j0 + q;
        const bool ok = k0 + kl < K && gc < W;
        pggan::cp_async4(dst + kl * kCR + q,
                         ok ? cr + (long long)(k0 + kl) * W + gc : ct, ok);
      }
    }
  };
  // the landed x row in xraw[buf] -> hi / lo ring slot
  auto split_x = [&](int buf, int slot) {
    const float* src = xraw + buf * kCT * kXR;
    float* hi = xhi + slot * kCT * kXS;
    float* lo = xlo + slot * kCT * kXS;
    for (int e = tid; e < kCT * kXR; e += kThreads) {
      const int s = e % kXR, c = e / kXR;
      uint32_t h, l;
      pggan::tf32_split(src[e], h, l);
      hi[c * kXS + s] = __uint_as_float(h);
      lo[c * kXS + s] = __uint_as_float(l);
    }
  };

  float acc[kMT][NW][4];
#pragma unroll
  for (int q = 0; q < kMT; ++q)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.f;

  // prologue: rows i0 - 1 and i0 into the ring, then x row i0 + 1 and
  // cotangent row i0 in flight
  issue_x(i0 - 1, 0);
  issue_x(i0, 1);
  pggan::cp_async_commit();
  pggan::cp_async_wait_all();
  __syncthreads();
  split_x(0, (i0 - 1) & 3);
  split_x(1, i0 & 3);
  __syncthreads();
  issue_x(i0 + 1, (i0 + 1) & 1);
  issue_ct(i0, i0 & 1);
  pggan::cp_async_commit();

  for (int i = i0; i < i1; ++i) {
    pggan::cp_async_wait_all();
    __syncthreads();  // x row i + 1 and ct row i landed; row i - 1 is done
    split_x((i + 1) & 1, (i + 1) & 3);
    if (i + 1 < i1) {
      issue_x(i + 2, i & 1);
      issue_ct(i + 1, (i + 1) & 1);
    }
    pggan::cp_async_commit();
    __syncthreads();  // the split row is visible

    // B (j, k) = ct row i: b0 (pixel t, k = g), b1 (pixel t + 4, k = g)
    const float* cb =
        ctraw + (i & 1) * KT * kCR + (ng * NW * 8 + g) * kCR + t;
#pragma unroll
    for (int s = 0; s < T::KSTEPS; ++s) {
      const int jj = (ps * T::KSTEPS + s) * 8;  // first pixel of the step
      uint32_t bh[NW][2], bl[NW][2];
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        pggan::tf32_split(cb[j * 8 * kCR + jj], bh[j][0], bl[j][0]);
        pggan::tf32_split(cb[j * 8 * kCR + jj + 4], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int q = 0; q < kMT; ++q) {
        // A rows g (tap 2q) and g + 8 (tap 2q + 1), channel c0 + g; pixel
        // jj + t (a0, a1) and jj + t + 4 (a2, a3); ring column s holds
        // image column j0 - 4 + s
        uint32_t ah[4], al[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int tap = 2 * q + half;
          if (tap < 9) {
            const int u = tap / 3, v = tap % 3;
            const int off =
                (((i + u - 1) & 3) * kCT + g) * kXS + jj + t + v + 3;
            ah[half] = __float_as_uint(xhi[off]);
            al[half] = __float_as_uint(xlo[off]);
            ah[half + 2] = __float_as_uint(xhi[off + 4]);
            al[half + 2] = __float_as_uint(xlo[off + 4]);
          } else {
            ah[half] = al[half] = ah[half + 2] = al[half + 2] = 0u;
          }
        }
#pragma unroll
        for (int j = 0; j < NW; ++j)
          pggan::mma_3xtf32(acc[q][j], ah, al, bh[j], bl[j]);
      }
    }
  }

  // Sum the PS column-splitting warps of each group in warp order, one
  // m-tile at a time, and write the block's partial tile.
  // acc[q][j][e]: tap 2q + e / 2, channel c0 + g,
  // output channel k0 + (ng NW + j) 8 + 2t + e % 2
  float* red = smem;  // [warp][lane][NW * 4]
  float* part = ws + (long long)p * 9 * C * K;
#pragma unroll
  for (int q = 0; q < kMT; ++q) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(tid * NW + j) * 4 + e] = acc[q][j][e];
    __syncthreads();
    for (int o = tid; o < T::NG * 32 * NW * 4; o += kThreads) {
      const int e4 = o % (NW * 4);
      const int ln = (o / (NW * 4)) % 32, gg = o / (NW * 4 * 32);
      float sum = 0.f;
      for (int w = 0; w < PS; ++w)
        sum += red[((gg * PS + w) * 32 + ln) * NW * 4 + e4];
      const int j = e4 / 4, e = e4 % 4;
      const int tap = 2 * q + (e >> 1);
      const int c = c0 + (ln >> 2);
      const int k = k0 + (gg * NW + j) * 8 + 2 * (ln & 3) + (e & 1);
      if (tap < 9 && c < C && k < K)
        part[((long long)tap * C + c) * K + k] = sum;
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
                   int C, int W, int K, int rows_per_block, int row_chunks,
                   int col_tiles, cudaStream_t s) {
  using T = DwTile<KT>;
  auto kern = conv3x3_dw_partial<KT>;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(ct) % 16 == 0;
  dim3 grid(N * row_chunks * col_tiles, (C + kCT - 1) / kCT,
            (K + KT - 1) / KT);
  kern<<<grid, kThreads, T::kSmemBytes, s>>>(x, ct, ws, H, C, W, K,
                                             rows_per_block, row_chunks,
                                             col_tiles, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, C, W); ct (N, H, K, W); ws (P, 9, C, K) scratch with
// P = N * row_chunks * col_tiles pixel slices (row_chunks runs of
// rows_per_block image rows, col_tiles = ceil(W / 128)); dw (3, 3, C, K).
// KT is the k tile (8, 16, 32 or 64).
extern "C" int pggan_conv3x3_dw(const float* x, const float* ct, float* ws,
                                float* dw, int N, int H, int C, int W, int K,
                                int KT, int rows_per_block, int row_chunks,
                                int col_tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e;
  switch (KT) {
    case 8:
      e = launch_partial<8>(x, ct, ws, N, H, C, W, K, rows_per_block,
                            row_chunks, col_tiles, s);
      break;
    case 16:
      e = launch_partial<16>(x, ct, ws, N, H, C, W, K, rows_per_block,
                             row_chunks, col_tiles, s);
      break;
    case 32:
      e = launch_partial<32>(x, ct, ws, N, H, C, W, K, rows_per_block,
                             row_chunks, col_tiles, s);
      break;
    case 64:
      e = launch_partial<64>(x, ct, ws, N, H, C, W, K, rows_per_block,
                             row_chunks, col_tiles, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  const int P = N * row_chunks * col_tiles;
  const long long E = 9LL * C * K;
  const long long blocks = (E + kRedE - 1) / kRedE;
  conv3x3_dw_reduce<<<(unsigned)blocks, kRedE * kRedG, 0, s>>>(ws, dw, P, E);
  return (int)cudaGetLastError();
}
