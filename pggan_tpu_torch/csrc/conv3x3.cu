// Same-padding 3x3 convolution on (N, H, C, W) f32, with an optional fused
// epilogue: none, bias + leaky ReLU, or bias + leaky ReLU + pixelnorm over
// the output channels (which also writes r = rsqrt(mean_K(z^2) + eps),
// shape (N, H, W)).
//
// Replaces the TPU kernels pggan_tpu/ops/pallas_conv.py:conv3x3_small_c and
// conv3x3_act_small_c (body _kernel), whose (TH+2)-row halo slabs were DMAed
// into VMEM with double buffering and contracted on the MXU in f32 (several
// bf16 passes). This kernel keeps what they compute, on Hopper's warpgroup
// MMAs fed by the Tensor Memory Accelerator.
//
// Bound: 18 C K FLOPs per output pixel against 4 (C + K) bytes, so
// operations at the 128-256 px shapes (C = 32-128) and bytes at 512-1024 px
// (C, K <= 32) on the H100. The design:
// - An implicit GEMM: per tile, M = TH output rows x 64 columns of one
//   image (one wgmma M of 64 pixels a row), N = KT output channels, reduced
//   over 9 taps x C. KT is K rounded up to 8, 16, 32 or 64; K > 64 (no
//   pixelnorm) runs as groups of 64 channels, tiles of one launch.
// - A persistent grid, one block per SM walking the tiles in order, so that
//   a tile's epilogue overlaps the loads of the next. A block is one
//   producer warpgroup and two consumer warpgroups (TH / 2 rows each);
//   setmaxnreg moves registers from the producer (56) to the consumers
//   (224).
// - A ring of 4 stages with full / empty mbarriers, each stage 8 input
//   channels. The halo arrives by TMA: a (72 columns, 8 channels, TH + 2
//   rows) box of a 4-D tensor map over NHCW from (col0 - 4, c0, row0 - 1)
//   (a box's innermost start must be 16-byte aligned, so it starts 4
//   columns left, not 1); the map's zero fill outside the tensor is the
//   conv's padding, with no branch in the kernel. Rows of 72 floats (= 8
//   mod 32) make the A-fragment loads conflict-free. The raw (9, 8, KT)
//   weights of those channels arrive by TMA a stage ahead (a 3-D map over
//   (K, C, 9), zeros beyond C and K) into the producer's own two buffers,
//   and its threads split them into hi and lo B operands in the stage
//   (core matrices of 8 output x 4 input channels): no weight-split launch
//   and no workspace. (Plain loads or 4-byte cp.async copies in place of
//   the weights' TMA box left the producer behind at KT = 64.)
// - Arithmetic: wgmma.m64nKTk8 in TF32 with the three-product split of
//   hopper.cuh (f32 accuracy), split in integer arithmetic (hopper.cuh's
//   tf32_split_fast: cvt.rna.tf32.f32 issues at a fraction of the rate).
//   TF32 wgmma reads shared memory K-major only and the halo is
//   pixel-major, so A (pixels x channels) comes from registers, split as
//   it is loaded, the next tap's while this tap's MMAs run
//   (wgmma.wait_group 1 frees the registers of the tap before).
// - A stage's 9 taps are chained in the tensor cores from zero (scale-d =
//   0 at the first): the 9 hi x hi products in one chain, the 18 small
//   cross terms (hi x lo, lo x hi) in another, the rows' chains
//   interleaved so that consecutive MMAs are independent; then both are
//   added to the f32 accumulators with a rounded add. The tensor cores
//   truncate when they add into an accumulator, which costs about half an
//   ulp of the running sum an add: over all of C (hundreds of MMAs) that
//   drifts by tens of ulps, and even one chain of a stage's 27 products
//   came close to CONV_TOL's bar at 1024 px; with the cross terms apart
//   (9 adds at full size) it stays well inside.
// - Rows per warpgroup RW = 1, 2, 4, 4 at KT = 64, 32, 16, 8: RW x KT / 2
//   accumulators, twice as many chain registers and 2 x RW x 8 A
//   registers a thread.
// - Epilogue: epilogue.cuh's arithmetic (bias, where(z >= 0, z, slope z),
//   z rsqrt(mean_K z^2 + eps)) on the accumulators; a pixel's KT outputs
//   sit in one quad of lanes, so pixelnorm's mean is two shuffles. Each
//   store instruction writes four 32-byte runs along W.
// TMA's global strides are multiples of 16 bytes: W must be a multiple of
// 4, the weights' rows (K) are padded to one, and x and w are 16-byte
// aligned; the wrapper pads a ragged W or K with zeros.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kTW = 64;                    // output columns a tile (wgmma M)
constexpr int kCC = 8;                     // input channels a stage (k8)
constexpr int kSW = kTW + 8;               // staged halo row, floats
constexpr int kStages = 4;
// registers a thread after setmaxnreg: 128 x 56 + 256 x 224 = 384 x 168
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
// B descriptors: the two k-halves of a core-matrix pair, then 8-channel
// groups of N (see hopper.cuh)
constexpr uint32_t kLbo = 128, kSbo = 256;

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <int KT>
struct Plan {
  static constexpr int RW = KT == 64 ? 1 : KT == 32 ? 2 : 4;  // rows a WG
  static constexpr int TH = 2 * RW;                            // rows a tile
  static constexpr int NR = KT / 2;  // accumulators a row, a thread
  static constexpr int kXFloats = (TH + 2) * kCC * kSW;
  static constexpr int kWFloats = 9 * kCC * KT;  // raw, hi or lo weights
  static constexpr int kStageBytes =
      round_up((kXFloats + 2 * kWFloats) * 4, 1024);
  // the stages, then the producer's two raw weight boxes
  static constexpr int kRawOffset = kStages * kStageBytes;
  static constexpr int kBarOffset = kRawOffset + 2 * kWFloats * 4;
  // + 1024 to align the base, + the barriers
  static constexpr size_t kSmemBytes =
      kBarOffset + (2 * kStages + 2) * 8 + 1024;
};

template <int KT, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgmma(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap,
              const float* __restrict__ b, float* __restrict__ y,
              float* __restrict__ r, int H, int K, int W, int chunks,
              int groups, int row_tiles, int col_tiles, int tiles,
              float slope, float eps) {
  using P = Plan<KT>;
  constexpr int RW = P::RW, TH = P::TH, NR = P::NR;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (pggan::smem_addr(smem_raw) & 1023)) & 1023);
  auto xbox = [&](int s) {
    return reinterpret_cast<float*>(smem + s * P::kStageBytes);
  };
  auto bsplit = [&](int s, int lo) {
    return xbox(s) + P::kXFloats + lo * P::kWFloats;
  };
  auto raw = [&](int i) {
    return reinterpret_cast<float*>(smem + P::kRawOffset) + i * P::kWFloats;
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* rawbar = empty + kStages;
  // the tile of this block's q-th stage, and its first row, column,
  // output channel and image
  auto decode = [&](int q, int& row0, int& col0, int& k0, int& n) {
    int rest = blockIdx.x + q / chunks * gridDim.x;
    col0 = rest % col_tiles * kTW;
    rest /= col_tiles;
    row0 = rest % row_tiles * TH;
    rest /= row_tiles;
    k0 = rest % groups * KT;
    n = rest / groups;
  };
  const int my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int total = my_tiles * chunks;  // stages this block walks

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the producer's expect-tx arrival and its 128 threads' arrivals
      // once their part of the split weights is written
      pggan::mbar_init(&full[s], 129);
      pggan::mbar_init(&empty[s], kConsumers / 32);
    }
    pggan::mbar_init(&rawbar[0], 1);
    pggan::mbar_init(&rawbar[1], 1);
    pggan::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup
    pggan::setmaxnreg_dec<kProducerRegs>();
    const int pt = threadIdx.x - kConsumers;
    int row0, col0, k0, n;
    // the raw (9, 8, KT) weights of stage q, one box of a 3-D map over
    // (K, C, 9), zero beyond C and K, in flight a stage ahead
    auto load_raw = [&](int q) {
      decode(q, row0, col0, k0, n);
      pggan::mbar_arrive_expect_tx(&rawbar[q & 1], P::kWFloats * 4);
      pggan::tma_load_3d(raw(q & 1), &wmap, &rawbar[q & 1], k0,
                         q % chunks * kCC, 0);
    };
    if (pt == 0 && total > 0) load_raw(0);
    for (int q = 0; q < total; ++q) {
      const int s = q % kStages, ch = q % chunks;
      if (pt == 0 && q + 1 < total) load_raw(q + 1);
      decode(q, row0, col0, k0, n);
      pggan::mbar_wait(&empty[s], ((q / kStages) & 1) ^ 1);
      if (pt == 0) {
        pggan::mbar_arrive_expect_tx(&full[s], P::kXFloats * 4);
        pggan::tma_load_4d(xbox(s), &xmap, &full[s], col0 - 4, ch * kCC,
                           row0 - 1, n);
      }
      // raw w[tap][c][k] -> hi / lo B[tap][k / 8][c / 4][k % 8][c % 4]
      pggan::mbar_wait(&rawbar[q & 1], (q >> 1) & 1);
      const float* rw = raw(q & 1);
      float* bh = bsplit(s, 0);
      float* bl = bsplit(s, 1);
      // eight loads in flight before their splits are stored
      for (int e0 = pt; e0 < P::kWFloats; e0 += 8 * 128) {
        float v[8];
#pragma unroll
        for (int b8 = 0; b8 < 8; ++b8) {
          const int e = e0 + 128 * b8;
          const int c4 = e & 3, k8 = (e >> 2) & 7, half = (e >> 5) & 1;
          const int blk = e >> 6;  // tap * (KT / 8) + k / 8
          const int k = blk % (KT / 8) * 8 + k8, tap = blk / (KT / 8);
          v[b8] = e < P::kWFloats ? rw[(tap * kCC + half * 4 + c4) * KT + k]
                                  : 0.f;
        }
#pragma unroll
        for (int b8 = 0; b8 < 8; ++b8) {
          const int e = e0 + 128 * b8;
          if (e < P::kWFloats) {
            uint32_t h, l;
            pggan::tf32_split_fast(v[b8], h, l);
            bh[e] = __uint_as_float(h);
            bl[e] = __uint_as_float(l);
          }
        }
      }
      pggan::fence_proxy_async();
      pggan::mbar_arrive(&full[s]);
      // every producer thread has read raw box q & 1: it may be refilled
      pggan::named_barrier(1, 128);
    }
    return;
  }

  // the consumer warpgroups
  pggan::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane / 4, t = lane % 4;
  int q = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int row0, col0, k0, n;
    decode(q, row0, col0, k0, n);
    const int Kg = min(KT, K - k0);

    // acc: the f32 sums; per stage, p1 chains the hi x hi products and p2
    // the small cross terms (hi x lo, lo x hi)
    float acc[RW][NR], p1[RW][NR], p2[RW][NR];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int e = 0; e < NR; ++e) acc[i][e] = p1[i][e] = p2[i][e] = 0.f;

    for (int ch = 0; ch < chunks; ++ch, ++q) {
      const int s = q % kStages;
      pggan::mbar_wait(&full[s], (q / kStages) & 1);
      const float* xs = xbox(s);
      const float* bh = bsplit(s, 0);
      const float* bl = bsplit(s, 1);
      // A (pixel, c) of tap (u, v) for this warpgroup's row i: x at output
      // pixel + (u - 1, v - 1); staged row sr and column sc hold image row
      // row0 - 1 + sr and column col0 - 4 + sc. Two register sets: tap
      // tp's in set tp % 2.
      uint32_t ah[2][RW][4], al[2][RW][4];
      auto load_a = [&](int tp, int set) {
        const int u = tp / 3, v = tp % 3;
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float* xa = xs + ((wg * RW + i + u) * kCC + t) * kSW +
                            wl * 16 + g + v + 3;
          uint32_t* h = ah[set][i];
          uint32_t* l = al[set][i];
          pggan::tf32_split_fast(xa[0], h[0], l[0]);
          pggan::tf32_split_fast(xa[8], h[1], l[1]);
          pggan::tf32_split_fast(xa[4 * kSW], h[2], l[2]);
          pggan::tf32_split_fast(xa[4 * kSW + 8], h[3], l[3]);
        }
      };
      load_a(0, 0);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        pggan::fence_operand(p1[i]);
        pggan::fence_operand(p2[i]);
      }
      // the stage's 9 taps, chained in the tensor cores from zero: 9
      // hi x hi products in p1, 18 cross terms in p2; the rows' and the
      // two sums' chains interleave
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int set = tap & 1;
        const uint64_t dh = pggan::wgmma_desc(bh + tap * kCC * KT, kLbo, kSbo);
        const uint64_t dl = pggan::wgmma_desc(bl + tap * kCC * KT, kLbo, kSbo);
        pggan::wgmma_fence();
#pragma unroll
        for (int i = 0; i < RW; ++i)
          pggan::Wgmma<KT>::mma(p1[i], ah[set][i], dh, tap > 0);
#pragma unroll
        for (int i = 0; i < RW; ++i)
          pggan::Wgmma<KT>::mma(p2[i], ah[set][i], dl, tap > 0);
#pragma unroll
        for (int i = 0; i < RW; ++i)
          pggan::Wgmma<KT>::mma(p2[i], al[set][i], dh, 1);
        pggan::wgmma_commit();
        if (tap < 8) {
          // the tap before has completed: its A registers are free
          pggan::wgmma_wait<1>();
          load_a(tap + 1, set ^ 1);
        }
      }
      pggan::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        pggan::fence_operand(p1[i]);
        pggan::fence_operand(p2[i]);
#pragma unroll
        for (int e = 0; e < NR; ++e) acc[i][e] += p1[i][e] + p2[i][e];
      }
      __syncwarp();
      if (lane == 0) pggan::mbar_arrive(&empty[s]);
    }

    // acc[i][4j + 2h + e]: output row row0 + wg RW + i, column col0 +
    // 16 wl + g + 8h, channel k0 + 8j + 2t + e; channels >= K hold exact
    // zeros (zero weights)
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int gr = row0 + wg * RW + i;
      float rr[2] = {1.f, 1.f};
      // with pixelnorm K <= KT: one group, Kg = K
      if (EPI != pggan::kEpiNone)
        pggan::bias_act_pn(acc[i], b + k0, Kg, EPI == pggan::kEpiActPn,
                           slope, eps, t, rr);
      if (gr >= H) continue;
      float* yrow = y + (((long long)n * H + gr) * K + k0) * W;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gc = col0 + wl * 16 + g + 8 * h;
        if (gc >= W) continue;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 8 * j + 2 * t + e;
            if (k < Kg)
              yrow[(long long)k * W + gc] = acc[i][4 * j + 2 * h + e];
          }
        if (EPI == pggan::kEpiActPn && t == 0)
          r[((long long)n * H + gr) * W + gc] = rr[h];
      }
    }
  }
}

struct Args {
  const float* x;
  const float* w;
  const float* b;
  float* y;
  float* r;
  int N, H, C, W, K;
  float slope, eps;
  cudaStream_t stream;
};

template <int KT, int EPI>
int launch(const Args& a) {
  using P = Plan<KT>;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[4] = {(uint64_t)a.W, (uint64_t)a.C, (uint64_t)a.H,
                             (uint64_t)a.N};
  const uint32_t xbox[4] = {kSW, kCC, P::TH + 2, 1};
  int e = pggan::host::tensor_map_f32(&xmap, a.x, 4, xdims, xbox);
  if (e != 0) return e;
  // w's rows hold K rounded up to 4 (zero columns)
  const uint64_t wdims[3] = {(uint64_t)(a.K + 3) / 4 * 4, (uint64_t)a.C, 9};
  const uint32_t wbox[3] = {KT, kCC, 9};
  e = pggan::host::tensor_map_f32(&wmap, a.w, 3, wdims, wbox);
  if (e != 0) return e;
  auto kern = conv3x3_wgmma<KT, EPI>;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kSmemBytes);
  if (ce != cudaSuccess) return (int)ce;
  int dev, sms;
  if ((ce = cudaGetDevice(&dev)) != cudaSuccess) return (int)ce;
  ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return (int)ce;
  const int groups = (a.K + KT - 1) / KT;
  const int row_tiles = (a.H + P::TH - 1) / P::TH;
  const int col_tiles = (a.W + kTW - 1) / kTW;
  const int tiles = a.N * groups * row_tiles * col_tiles;
  const int chunks = (a.C + kCC - 1) / kCC;
  kern<<<tiles < sms ? tiles : sms, kThreads, P::kSmemBytes, a.stream>>>(
      xmap, wmap, a.b, a.y, a.r, a.H, a.K, a.W, chunks, groups, row_tiles,
      col_tiles, tiles, a.slope, a.eps);
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

// x (N, H, C, W); w (3, 3, C, K rounded up to 4) HWIO, zero beyond K; b
// (K,) (unused for epi 0); y (N, H, K, W); r (N, H, W) for epi 2 only. KT
// is the output-channel tile: K rounded up to 8, 16, 32 or 64, and 64 for
// K > 64, which runs ceil(K / 64) channel groups in one launch (not with
// pixelnorm: its mean needs all K in one tile). W a multiple of 4, x and w
// 16-byte aligned (TMA).
extern "C" int pggan_conv3x3(const float* x, const float* w, const float* b,
                             float* y, float* r, int N, int H, int C, int W,
                             int K, int KT, int epi, float slope, float eps,
                             void* stream) {
  if (epi == pggan::kEpiActPn && K > KT) return (int)cudaErrorInvalidValue;
  if (W % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return (int)cudaErrorInvalidValue;
  Args a{x, w, b, y, r, N, H, C, W, K, slope, eps,
         static_cast<cudaStream_t>(stream)};
  switch (KT) {
    case 8: return launch_epi<8>(epi, a);
    case 16: return launch_epi<16>(epi, a);
    case 32: return launch_epi<32>(epi, a);
    case 64: return launch_epi<64>(epi, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
