// Same-padding 3x3 convolution of the low-resolution NCHW stages, f32, for
// wide channels on small images, and its weight gradient:
//
//   y[n][k][i][j]   = sum_{c,u,v} w[k][u][v][c] x[n][c][i+u-1][j+v-1]
//   dw[k][u][v][c]  = sum_{n,i,j} gy[n][k][i][j] x[n][c][i+u-1][j+v-1]
//
// with x zero outside the image; w and dw are (K, 3, 3, C) (OHWI). The
// forward kernel is also the input gradient, with flip_io'd weights.
//
// It replaces no TPU kernel: the JAX package left these convolutions to
// XLA, and the port to cuDNN, which at float32 with TF32 off runs them as
// FFTs and CUDA-core GEMMs, at about a sixth of the tensor cores' 3xTF32
// rate. It takes the stages of 16-128 px with 64-512 channels (a multiple
// of 64 in and out; ops/wide_conv.py's shape rule); the 4-8 px stages stay
// on cuDNN.
//
// Bound: 18 C K FLOPs per output pixel against 4 (C + K) bytes, 1,150
// FLOP/B at C = K = 512 and 290 at 64: every shape is far above the
// H100's ridge (165 TFLOP/s of 3xTF32 over 3.35 TB/s, 49 FLOP/B), so both
// kernels are bound by operations, and their design is about keeping the
// tensor cores fed. Measured on an H100 at every call of the benchmark's
// train steps (chip_smoke.py phase W): the forward 74-78 TFLOP/s, 45-47%
// of that bound, at batch 16-32 and every stage (16 px x 512 channels to
// 128 px x 64); 53-77 at batch 6-12; 26-71 at batch 3, the least where
// 16-32 px stages make 48-96 tiles for 132 SMs. The weight gradient 48-73
// TFLOP/s at batch 16-32 (the least at 16 px x 512: 200 work items a
// slice on 132 SMs), 26-66 at batch 3-12. Neither the stage drains, the
// chains' dependences nor the producer's lead moved the forward when
// changed.
//
// Why NCHW: the stages keep it, and a permute to NHCW and back would cost
// as much as a 64-channel conv at these sizes. In NCHW a channel's image
// plane is contiguous, so every tile is a TMA box of whole rows and the
// weight gradient's pixels are one flat run per channel.
//
// The forward (wide_conv_fwd), an implicit GEMM:
// - M = 128 output pixels of one image (128 / W whole rows; the two
//   consumer warpgroups take 64 each, one wgmma M), N = 64 output
//   channels, reduced over 9 taps x C in stages of 8 input channels.
// - A persistent grid, one block an SM walking the tiles; a producer
//   warpgroup and two consumer warpgroups on a ring of 4 stages with
//   full / empty mbarriers.
// - A stage's halo arrives by TMA from a 4-D map over NCHW: a (SW
//   columns, RB rows, 8 channels) box from (-4, row0 - 1), whose zero fill
//   is the padding. SW and RB are the smallest box whose channel planes lie
//   8 or 24 floats apart modulo 32, so that the A-fragment loads (8 pixels
//   by 4 channels a warp) hit 32 banks.
// - TF32 wgmma reads shared memory K-major only and the halo is
//   pixel-major, so A comes from registers, split into hi and lo as it is
//   loaded (hopper.cuh's tf32_split_fast), the next tap's while this tap's
//   MMAs run.
// - B, the weights of a stage, is one contiguous run of the packed weights
//   (ops/wide_conv.py's pack: per 64 output and 8 input channels, the
//   9 taps' core matrices of 8 output x 4 input channels), so it arrives by
//   one bulk copy, already in wgmma's K-major layout; the producer's
//   threads split it in place into hi and lo.
// - Accuracy: a stage's 9 taps are chained in the tensor cores from zero,
//   the 9 hi x hi products in one chain and the 18 small cross terms in
//   another, then both are added to the f32 sums with a rounded add (as
//   conv3x3.cu: the tensor cores truncate when they add into an
//   accumulator, and over C = 512, 576 k-steps of one chain would drift by
//   hundreds of ulps; with the chains apart and flushed a stage, a few).
//
// The weight gradient (wide_conv_dw, then wide_conv_dw_sum), a GEMM of
// (9 taps x 21 input channels) by 64 output channels reduced over pixels:
// - A stage is 64 flat pixels of one image (64 / W rows, or half a row at
//   W = 128): an x box with its own halo (21 channels) and a (68 pixels,
//   64 channels) box of the output gradient over the flat image, rows of
//   68 floats (4 mod 32) for conflict-free transposing reads.
// - Work items are (pixel slice, 21 input channels, 64 output channels);
//   the two consumer warpgroups take alternate stages of an item, each
//   splitting its stage's output gradient into hi and lo B operands of
//   its own (core matrices of 8 channels x 4 pixels), each keeping its own
//   sums: a partial a warpgroup and a slice in a workspace.
// - A = x shifted by the tap, from registers (a one-pixel shift moves an
//   operand by 4 bytes, which a wgmma descriptor cannot express): 189
//   (tap, channel) rows in 3 m-tiles. 21 channels an item leave 3 of the
//   192 rows idle, where 16 left 48; a last item of C = 64, 128, 256,
//   512 runs 20, 2, 4, 8 channels past C on zeros (the TMA box's fill),
//   whose sums are never stored.
// - Accuracy, as the forward's: per m-tile, a stage's 8 k-steps are
//   chained in the tensor cores from zero, hi x hi and the cross terms
//   apart, then added to the f32 sums with one rounded add. (A rounded
//   add after each k-step's three products cost 32 adds a thread every 3
//   MMAs, which held the kernel at a third of the forward's rate.)
// - The second pass sums the partials of each output in a fixed order:
//   no atomics, so a graph replay equals the eager call bit for bit.
//
// W must be 16, 32, 64 or 128 and H a multiple of 128 / W (the forward)
// or of 64 / W (the weight gradient); x, the packed weights and the output
// gradient 16-byte aligned (TMA).

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr uint32_t kLbo = 128, kSbo = 256;  // B core matrices (hopper.cuh)
constexpr int kSmemLimit = 232448;  // the H100's shared memory a block

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// one contiguous run of global memory into shared memory, completing
// `bytes` of `bar`'s transaction count (16-byte aligned, a multiple of 16)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(pggan::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(pggan::smem_addr(bar))
      : "memory");
}

// The smallest TMA box (sw columns from width + 8, rb rows from rows + 2)
// whose channel planes lie `mod` apart modulo 32 floats, in units of 4
// floats: odd (4 mod 8) for the weight gradient's (channel, pixel) lanes,
// 2 mod 4 (8 or 24 mod 32) for the forward's (pixel, channel) lanes.
void plan_box(int width, int rows, bool fwd, int& sw, int& rb) {
  int best = 1 << 30;
  for (int r = rows + 2; r <= rows + 5; ++r)
    for (int s = width + 8; s <= width + 40; s += 4) {
      const int units = r * s / 4;
      const bool ok = fwd ? units % 4 == 2 : units % 2 == 1;
      if (ok && r * s < best) {
        best = r * s;
        sw = s;
        rb = r;
      }
    }
}

int sm_count(int& sms) {
  int dev;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
}

// -- the forward -------------------------------------------------------------

constexpr int kKT = 64;   // output channels a tile (wgmma N)
constexpr int kCC = 8;    // input channels a stage (k8)
constexpr int kBM = 128;  // output pixels a tile
constexpr int kWFloats = 9 * kCC * kKT;  // a stage's weights (hi or lo)
constexpr int kXCap = 3328;  // a stage's x box, floats (W = 128: 8 x 3 x 136)
constexpr int kStages = 4;
constexpr int kStageBytes = (kXCap + 2 * kWFloats) * 4;
constexpr int kBarOffset = kStages * kStageBytes;
// + 1024 to align the base, + the barriers
constexpr size_t kSmemBytes = kBarOffset + 3 * kStages * 8 + 1024;
static_assert(kStageBytes % 1024 == 0, "stages 1024-byte aligned");
static_assert(kSmemBytes <= kSmemLimit, "a block's shared memory");
// registers a thread after setmaxnreg: 128 x 56 + 256 x 224 = 384 x 168
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

__global__ void __launch_bounds__(kThreads, 1)
wide_conv_fwd(const __grid_constant__ CUtensorMap xmap,
              const float* __restrict__ wp, float* __restrict__ y, int H,
              int W, int K, int TR, int SW, int RB, int chunks, int groups,
              int row_tiles, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (pggan::smem_addr(smem_raw) & 1023)) & 1023);
  auto xs = [&](int s) {
    return reinterpret_cast<float*>(smem + s * kStageBytes);
  };
  auto bh = [&](int s) { return xs(s) + kXCap; };
  auto bl = [&](int s) { return xs(s) + kXCap + kWFloats; };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* wbar = empty + kStages;
  // the tile of this block's q-th stage: its output-channel group, row
  // tile and image (groups fastest, so neighbouring blocks share x)
  auto decode = [&](int q, int& kg, int& rt, int& n) {
    int rest = blockIdx.x + q / chunks * gridDim.x;
    kg = rest % groups;
    rest /= groups;
    rt = rest % row_tiles;
    n = rest / row_tiles;
  };
  const int my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int total = my_tiles * chunks;  // stages this block walks

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the producer's expect-tx arrival for x and its 128 threads'
      // arrivals once their part of the weights is split
      pggan::mbar_init(&full[s], 129);
      pggan::mbar_init(&empty[s], kConsumers / 32);
      pggan::mbar_init(&wbar[s], 1);
    }
    pggan::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup
    pggan::setmaxnreg_dec<kProducerRegs>();
    const int pt = threadIdx.x - kConsumers;
    // thread 0 loads stage q once its slot is free: the weights by one
    // bulk copy, the x box by TMA
    auto issue = [&](int q) {
      const int s = q % kStages, ch = q % chunks;
      int kg, rt, n;
      decode(q, kg, rt, n);
      pggan::mbar_wait(&empty[s], ((q / kStages) & 1) ^ 1);
      pggan::mbar_arrive_expect_tx(&wbar[s], kWFloats * 4);
      bulk_load(bh(s), wp + ((long long)kg * chunks + ch) * kWFloats,
                kWFloats * 4, &wbar[s]);
      pggan::mbar_arrive_expect_tx(&full[s], kCC * RB * SW * 4);
      pggan::tma_load_4d(xs(s), &xmap, &full[s], -4, rt * TR - 1, ch * kCC,
                         n);
    };
    if (pt == 0 && total > 0) issue(0);
    for (int q = 0; q < total; ++q) {
      const int s = q % kStages;
      if (pt == 0 && q + 1 < total) issue(q + 1);
      // the stage's weights, split in place: hi where they landed, lo
      // beside them
      pggan::mbar_wait(&wbar[s], (q / kStages) & 1);
      float4* h4 = reinterpret_cast<float4*>(bh(s));
      float4* l4 = reinterpret_cast<float4*>(bl(s));
#pragma unroll 3
      for (int i = pt; i < kWFloats / 4; i += 128) {
        const float4 v = h4[i];
        uint32_t h[4], l[4];
        pggan::tf32_split_fast(v.x, h[0], l[0]);
        pggan::tf32_split_fast(v.y, h[1], l[1]);
        pggan::tf32_split_fast(v.z, h[2], l[2]);
        pggan::tf32_split_fast(v.w, h[3], l[3]);
        h4[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                            __uint_as_float(h[2]), __uint_as_float(h[3]));
        l4[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                            __uint_as_float(l[2]), __uint_as_float(l[3]));
      }
      pggan::fence_proxy_async();
      pggan::mbar_arrive(&full[s]);
    }
    return;
  }

  // the consumer warpgroups
  pggan::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane / 4, t = lane % 4;
  // this thread's A rows: tile pixels tp and tp + 8, in tile row pr at
  // columns pc and pc + 8 (W >= 16: one row); the staged x of channel c,
  // box row r, column col is at (c RB + r) SW + col, and box row pr + u,
  // column pc + v + 3 hold tap (u, v)'s input
  const int tp = wg * 64 + wl * 16 + g;
  const int pr = tp / W, pc = tp % W;
  const int abase = (t * RB + pr) * SW + pc + 3;
  const int c4 = 4 * RB * SW;  // channel t + 4
  int q = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int kg, rt, n;
    decode(q, kg, rt, n);

    // acc: the f32 sums; per stage, p1 chains the hi x hi products and p2
    // the small cross terms (hi x lo, lo x hi)
    float acc[32], p1[32], p2[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = p1[e] = p2[e] = 0.f;

    for (int ch = 0; ch < chunks; ++ch, ++q) {
      const int s = q % kStages;
      pggan::mbar_wait(&full[s], (q / kStages) & 1);
      const float* xa0 = xs(s) + abase;
      const float* bhs = bh(s);
      const float* bls = bl(s);
      // A (pixel, channel) of tap tp in register set tp % 2
      uint32_t ah[2][4], al[2][4];
      auto load_a = [&](int tap, int set) {
        const float* xa = xa0 + (tap / 3) * SW + tap % 3;
        pggan::tf32_split_fast(xa[0], ah[set][0], al[set][0]);
        pggan::tf32_split_fast(xa[8], ah[set][1], al[set][1]);
        pggan::tf32_split_fast(xa[c4], ah[set][2], al[set][2]);
        pggan::tf32_split_fast(xa[c4 + 8], ah[set][3], al[set][3]);
      };
      load_a(0, 0);
      pggan::fence_operand(p1);
      pggan::fence_operand(p2);
      // the stage's 9 taps, chained in the tensor cores from zero: 9
      // hi x hi products in p1, 18 cross terms in p2
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int set = tap & 1;
        const uint64_t dh = pggan::wgmma_desc(bhs + tap * kCC * kKT, kLbo,
                                              kSbo);
        const uint64_t dl = pggan::wgmma_desc(bls + tap * kCC * kKT, kLbo,
                                              kSbo);
        pggan::wgmma_fence();
        pggan::Wgmma<kKT>::mma(p1, ah[set], dh, tap > 0);
        pggan::Wgmma<kKT>::mma(p2, ah[set], dl, tap > 0);
        pggan::Wgmma<kKT>::mma(p2, al[set], dh, 1);
        pggan::wgmma_commit();
        if (tap < 8) {
          // the tap before has completed: its A registers are free
          pggan::wgmma_wait<1>();
          load_a(tap + 1, set ^ 1);
        }
      }
      pggan::wgmma_wait<0>();
      pggan::fence_operand(p1);
      pggan::fence_operand(p2);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += p1[e] + p2[e];
      __syncwarp();
      if (lane == 0) pggan::mbar_arrive(&empty[s]);
    }

    // acc[4j + 2h + e]: output row rt TR + pr, column pc + 8h, channel
    // 64 kg + 8j + 2t + e
    const int row = rt * TR + pr;
    if (row < H) {
      const long long plane = (long long)H * W;
      float* yb = y + ((long long)n * K + kg * kKT + 2 * t) * plane +
                  (long long)row * W + pc;
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            yb[(8 * j + e) * plane + 8 * h] = acc[4 * j + 2 * h + e];
    }
  }
}

// -- the weight gradient -----------------------------------------------------

constexpr int kDCC = 21;   // input channels an item (9 x 21 = 189 rows)
constexpr int kDKT = 64;   // output channels an item (wgmma N)
constexpr int kDPix = 64;  // flat pixels a stage
constexpr int kDMT = 3;    // m-tiles of the 144 (tap, channel) rows
constexpr int kDRows = 9 * kDCC;
constexpr int kDGyPitch = kDPix + 4;  // = 4 mod 32
// the largest x box (W = 64: 3 x 76), rounded to 32 floats so that the
// output gradient's box after it is 128-byte aligned
constexpr int kDXCap = round_up(kDCC * 228, 32);
constexpr int kDGyFloats = kDKT * kDGyPitch;
constexpr int kDStageBytes = round_up((kDXCap + kDGyFloats) * 4, 128);
constexpr int kDBFloats = kDPix * kDKT;  // a warpgroup's hi (or lo) B
constexpr int kDSideBytes = 2 * 2 * kDBFloats * 4;
constexpr int kDStages =
    (kSmemLimit - 128 - kDSideBytes - 2 * 8 * 8) / kDStageBytes;
static_assert(kDStages >= 4, "two warpgroups hold two stages each");
constexpr int kDBarOffset = kDStages * kDStageBytes + kDSideBytes;
constexpr size_t kDSmemBytes = kDBarOffset + 2 * kDStages * 8 + 128;
static_assert(kDSmemBytes <= kSmemLimit, "a block's shared memory");
static_assert((kDXCap * 4) % 128 == 0, "the output gradient's box aligned");
// registers a thread after setmaxnreg: 128 x 24 + 256 x 240 = 384 x 168
// (the launch's), the producer one thread's TMA loop
constexpr int kDProducerRegs = 24, kDConsumerRegs = 240;

__global__ void __launch_bounds__(kThreads, 1)
wide_conv_dw(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap gmap, float* __restrict__ ws,
             int C, int K, int W, int TW, int SW, int RB, int per_image,
             int total, int slice_len, int c_chunks, int k_tiles,
             int items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((128 - (pggan::smem_addr(smem_raw) & 127)) & 127);
  auto xst = [&](int s) {
    return reinterpret_cast<float*>(smem + s * kDStageBytes);
  };
  auto gst = [&](int s) { return xst(s) + kDXCap; };
  float* side = reinterpret_cast<float*>(smem + kDStages * kDStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDBarOffset);
  uint64_t* empty = full + kDStages;
  // item it: pixel slice sl (global stages g0 .. g0 + steps), input
  // channels c0 .., output channels k0 ..
  struct Item {
    int sl, g0, steps, c0, k0;
  };
  auto item = [&](int it) {
    Item m;
    m.k0 = it % k_tiles * kDKT;
    const int rest = it / k_tiles;
    m.c0 = rest % c_chunks * kDCC;
    m.sl = rest / c_chunks;
    m.g0 = m.sl * slice_len;
    m.steps = min(total - m.g0, slice_len);
    return m;
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDStages; ++s) {
      pggan::mbar_init(&full[s], 1);
      pggan::mbar_init(&empty[s], 4);  // the warps of the one reader
    }
    pggan::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one thread
    pggan::setmaxnreg_dec<kDProducerRegs>();
    if (threadIdx.x == kConsumers) {
      const uint32_t bytes = (kDCC * RB * SW + kDKT * kDGyPitch) * 4;
      int Q = 0;  // stages filled so far, over all of this block's items
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const Item m = item(it);
        for (int j = 0; j < m.steps; ++j, ++Q) {
          const int s = Q % kDStages, gs = m.g0 + j;
          const int n = gs / per_image, p0 = gs % per_image * kDPix;
          pggan::mbar_wait(&empty[s], ((Q / kDStages) & 1) ^ 1);
          pggan::mbar_arrive_expect_tx(&full[s], bytes);
          pggan::tma_load_4d(xst(s), &xmap, &full[s], p0 % W - 4,
                             p0 / W - 1, m.c0, n);
          pggan::tma_load_3d(gst(s), &gmap, &full[s], p0, m.k0, n);
        }
      }
    }
    return;
  }

  // the consumer warpgroups: of an item, warpgroup wg takes the stages
  // wg, wg + 2, ...
  pggan::setmaxnreg_inc<kDConsumerRegs>();
  const int wg = warp / 4, wl = warp % 4, wtid = threadIdx.x % 128;
  const int g = lane / 4, t = lane % 4;
  // this thread's A rows 64 m + 16 wl + g + 8 hf: tap (u, v), channel c;
  // the staged x of the tap for flat pixel 0 of the stage sits at
  // (c RB + u) SW + v + 3. Rows past the 144 read row 143's x: their sums
  // are never stored.
  int off[kDMT][2];
#pragma unroll
  for (int m = 0; m < kDMT; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = min(64 * m + 16 * wl + g + 8 * hf, kDRows - 1);
      const int tap = row / kDCC, c = row % kDCC;
      off[m][hf] = (c * RB + tap / 3) * SW + tap % 3 + 3;
    }
  float* bh = side + (2 * wg) * kDBFloats;
  float* bl = bh + kDBFloats;
  constexpr int KS = kDPix / 8;  // k-steps a stage

  int Q0 = 0;  // the block's stage count at this item's first stage
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item mi = item(it);
    float acc[kDMT][32];
#pragma unroll
    for (int m = 0; m < kDMT; ++m)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[m][e] = 0.f;

    for (int j = wg; j < mi.steps; j += 2) {
      const int Q = Q0 + j, s = Q % kDStages;
      pggan::mbar_wait(&full[s], (Q / kDStages) & 1);
      // the output gradient -> hi / lo B[ks][k / 8][px / 4 % 2][k % 8]
      // [px % 4]; this warpgroup's MMAs of its previous stage have
      // completed. Eight loads in flight before their splits are stored.
      {
        const float* raw = gst(s);
        static_assert(kDBFloats % (8 * 128) == 0, "whole batches");
        for (int e0 = wtid; e0 < kDBFloats; e0 += 8 * 128) {
          float v[8];
#pragma unroll
          for (int b8 = 0; b8 < 8; ++b8) {
            const int e = e0 + 128 * b8;
            const int p4 = e & 3, k8 = (e >> 2) & 7, half = (e >> 5) & 1;
            const int blk = e >> 6;  // ks * 8 + k / 8
            const int k = blk % 8 * 8 + k8, ks = blk / 8;
            v[b8] = raw[k * kDGyPitch + ks * 8 + half * 4 + p4];
          }
#pragma unroll
          for (int b8 = 0; b8 < 8; ++b8) {
            uint32_t h, l;
            pggan::tf32_split_fast(v[b8], h, l);
            bh[e0 + 128 * b8] = __uint_as_float(h);
            bl[e0 + 128 * b8] = __uint_as_float(l);
          }
        }
      }
      pggan::fence_proxy_async();
      pggan::named_barrier(1 + wg, 128);

      const float* xs = xst(s);
      // A of m-tile m, k-step ks in register set ks % 2: flat pixels
      // 8 ks + t (+ 4) lie in stage row 8 ks / TW
      uint32_t ah[2][4], al[2][4];
      auto load_a = [&](int m, int ks, int set) {
        const int p = ks * 8, pix = p / TW * SW + p % TW + t;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* xa = xs + off[m][hf] + pix;
          pggan::tf32_split_fast(xa[0], ah[set][hf], al[set][hf]);
          pggan::tf32_split_fast(xa[4], ah[set][hf + 2], al[set][hf + 2]);
        }
      };
      load_a(0, 0, 0);
      // per m-tile, the stage's 8 k-steps chained in the tensor cores from
      // zero: 8 hi x hi products in p1, 16 cross terms in p2; then both
      // are added to the m-tile's f32 sums with a rounded add
#pragma unroll
      for (int m = 0; m < kDMT; ++m) {
        float p1[32], p2[32];
        pggan::fence_operand(p1);
        pggan::fence_operand(p2);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int set = ks & 1;
          const uint64_t dh =
              pggan::wgmma_desc(bh + ks * 8 * kDKT, kLbo, kSbo);
          const uint64_t dl =
              pggan::wgmma_desc(bl + ks * 8 * kDKT, kLbo, kSbo);
          pggan::wgmma_fence();
          pggan::Wgmma<kDKT>::mma(p1, ah[set], dh, ks > 0);
          pggan::Wgmma<kDKT>::mma(p2, ah[set], dl, ks > 0);
          pggan::Wgmma<kDKT>::mma(p2, al[set], dh, 1);
          pggan::wgmma_commit();
          // the k-step before has completed: its A registers are free
          // for the next k-step, or the next m-tile's first
          pggan::wgmma_wait<1>();
          if (ks + 1 < KS)
            load_a(m, ks + 1, set ^ 1);
          else if (m + 1 < kDMT)
            load_a(m + 1, 0, set ^ 1);
        }
        pggan::wgmma_wait<0>();
        pggan::fence_operand(p1);
        pggan::fence_operand(p2);
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[m][e] += p1[e] + p2[e];
      }
      __syncwarp();
      if (lane == 0) pggan::mbar_arrive(&empty[s]);
    }

    // this warpgroup's sums, partial 2 sl + wg of the workspace (2 P, K,
    // 9, C): acc[m][4j + 2h + e] is row 64 m + 16 wl + g + 8h (tap,
    // c0 + c), output channel k0 + 8j + 2t + e
    float* part = ws + (2LL * mi.sl + wg) * K * 9 * C;
#pragma unroll
    for (int m = 0; m < kDMT; ++m)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int row = 64 * m + 16 * wl + g + 8 * ((e >> 1) & 1);
        const int k = mi.k0 + (e >> 2) * 8 + 2 * t + (e & 1);
        if (row < kDRows && mi.c0 + row % kDCC < C)
          part[((long long)k * 9 + row / kDCC) * C + mi.c0 + row % kDCC] =
              acc[m][e];
      }
    Q0 += mi.steps;
  }
}

constexpr int kSumE = 32;  // outputs a block (one warp wide)
constexpr int kSumG = 8;   // runs of partials an output

// pass 2: dw[e] = sum over p of ws[p][e], e < E = 9 C K, in a fixed order
// (8 contiguous runs, then the 8 run sums in order)
__global__ void __launch_bounds__(kSumE * kSumG)
wide_conv_dw_sum(const float* __restrict__ ws, float* __restrict__ dw, int P,
                 long long E) {
  __shared__ float runs[kSumG][kSumE];
  const int el = threadIdx.x % kSumE, g = threadIdx.x / kSumE;
  const long long e = blockIdx.x * (long long)kSumE + el;
  float s = 0.f;
  if (e < E) {
    const int per = (P + kSumG - 1) / kSumG;
    const int p1 = min(P, (g + 1) * per);
    for (int p = g * per; p < p1; ++p) s += __ldg(ws + (long long)p * E + e);
  }
  runs[g][el] = s;
  __syncthreads();
  if (g == 0 && e < E) {
    float t = runs[0][el];
#pragma unroll
    for (int q = 1; q < kSumG; ++q) t += runs[q][el];
    dw[e] = t;
  }
}

bool width_ok(int W) { return W == 16 || W == 32 || W == 64 || W == 128; }

bool aligned(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

}  // namespace

// x (N, C, H, W); wp the packed weights: (K / 64, C / 8, 9, 8, 2, 8, 4),
// per 64 output and 8 input channels the 9 taps' B operand of wgmma (core
// matrices of 8 output x 4 input channels, output groups of 8 outer); y
// (N, K, H, W). C a multiple of 8, K of 64.
extern "C" int pggan_wide_conv(const float* x, const float* wp, float* y,
                               int N, int C, int H, int W, int K,
                               void* stream) {
  if (C % kCC || K % kKT || !width_ok(W) || H % (kBM / W) ||
      !aligned(x, wp))
    return (int)cudaErrorInvalidValue;
  const int TR = kBM / W;
  int SW = 0, RB = 0;
  plan_box(W, TR, true, SW, RB);
  if (kCC * RB * SW > kXCap) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap;
  const uint64_t dims[4] = {(uint64_t)W, (uint64_t)H, (uint64_t)C,
                            (uint64_t)N};
  const uint32_t box[4] = {(uint32_t)SW, (uint32_t)RB, kCC, 1};
  int e = pggan::host::tensor_map_f32(&xmap, x, 4, dims, box);
  if (e != 0) return e;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t ce = cudaFuncSetAttribute(
      wide_conv_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (ce != cudaSuccess) return (int)ce;
  int sms = 0;
  if ((e = sm_count(sms)) != 0) return e;
  const int chunks = C / kCC, groups = K / kKT, row_tiles = H / TR;
  const int tiles = N * row_tiles * groups;
  wide_conv_fwd<<<tiles < sms ? tiles : sms, kThreads, kSmemBytes,
                  static_cast<cudaStream_t>(stream)>>>(
      xmap, wp, y, H, W, K, TR, SW, RB, chunks, groups, row_tiles, tiles);
  return (int)cudaGetLastError();
}

// x (N, C, H, W); gy (N, K, H, W); ws (2 P, K, 9, C) scratch with P =
// ceil(N H W / 64 / slice_len) pixel slices of slice_len stages (64 flat
// pixels each); dw (K, 3, 3, C). K a multiple of 64.
extern "C" int pggan_wide_conv_dw(const float* x, const float* gy, float* ws,
                                  float* dw, int N, int C, int H, int W,
                                  int K, int slice_len, void* stream) {
  const int TW = W < kDPix ? W : kDPix;
  if (K % kDKT || !width_ok(W) || H % (kDPix / TW) ||
      slice_len < 1 || !aligned(x, gy))
    return (int)cudaErrorInvalidValue;
  int SW = 0, RB = 0;
  plan_box(TW, kDPix / TW, false, SW, RB);
  if (kDCC * RB * SW > kDXCap) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap xmap, gmap;
  const uint64_t xdims[4] = {(uint64_t)W, (uint64_t)H, (uint64_t)C,
                             (uint64_t)N};
  const uint32_t xbox[4] = {(uint32_t)SW, (uint32_t)RB, kDCC, 1};
  int e = pggan::host::tensor_map_f32(&xmap, x, 4, xdims, xbox);
  if (e != 0) return e;
  // the output gradient as flat images: (H W, K, N)
  const uint64_t gdims[3] = {(uint64_t)H * W, (uint64_t)K, (uint64_t)N};
  const uint32_t gbox[3] = {kDGyPitch, kDKT, 1};
  e = pggan::host::tensor_map_f32(&gmap, gy, 3, gdims, gbox);
  if (e != 0) return e;
  cudaError_t ce = cudaFuncSetAttribute(
      wide_conv_dw, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDSmemBytes);
  if (ce != cudaSuccess) return (int)ce;
  int sms = 0;
  if ((e = sm_count(sms)) != 0) return e;
  const int per_image = H * W / kDPix, total = N * per_image;
  const int slices = (total + slice_len - 1) / slice_len;
  const int c_chunks = (C + kDCC - 1) / kDCC, k_tiles = K / kDKT;
  const int items = slices * c_chunks * k_tiles;
  wide_conv_dw<<<items < sms ? items : sms, kThreads, kDSmemBytes, s>>>(
      xmap, gmap, ws, C, K, W, TW, SW, RB, per_image, total, slice_len,
      c_chunks, k_tiles, items);
  if ((ce = cudaGetLastError()) != cudaSuccess) return (int)ce;
  const long long E = 9LL * C * K;
  wide_conv_dw_sum<<<(unsigned)((E + kSumE - 1) / kSumE), kSumE * kSumG, 0,
                     s>>>(ws, dw, 2 * slices, E);
  return (int)cudaGetLastError();
}
