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
// - A GEMM per work item: M = the 9 taps x CC input channels stacked,
//   (tap, c) rows in tap-major order (CC = 8 for C <= 8 at KT <= 16, else
//   16); N = KT output channels (K in tiles of KT); reduced over the pixels
//   of the item's slice: a run of image rows of one TW-column tile. A
//   persistent grid, one block an SM, walks the items (about eight an SM),
//   so that the loads of an item's first rows overlap the last rows of the
//   one before.
// - A producer warpgroup (one thread issues the TMA loads; setmaxnreg
//   gives its registers to the consumers: 40 and 232 a thread)
//   and two consumer warpgroups, on a ring of stages (as many as fit,
//   6-12) with full / empty mbarriers that runs on from item to item. An
//   item's stage q holds x row i0 - 1 + q, a (TW + 36, CC) box from
//   column j0 - 4 (a box's innermost start must be 16-byte aligned; the
//   three column taps are three shifts of it), and cotangent row
//   i0 + q - 2, a (TW + 4, KT) box; rows and columns outside the image
//   arrive as zeros, which is the padding. Row i reads x rows i - 1, i,
//   i + 1 from stages q - 2, q - 1, q, which is why a stage is released
//   two rows after it lands. The two consumer warpgroups take alternate
//   rows; each warpgroup's sums are a partial (9, CC, KT) tile of its
//   own in a workspace (2 P, 9, C, K): two slices for each of the P pixel
//   slices.
// - Arithmetic: TF32 tensor-core products with the three-product split
//   of hopper.cuh (f32 accuracy), split in integer arithmetic
//   (tf32_split_fast). A one-pixel tap shift moves an operand by 4 bytes,
//   which a wgmma descriptor cannot express, so A (taps x channels by
//   pixels) comes from registers, loaded at any shift and split as it is
//   loaded; staged rows of = 4 mod 32 floats make those loads
//   conflict-free. Each k-step's three products are summed from zero in
//   the tensor cores and added to the f32 sums with a rounded add, in
//   k-step order: the tensor cores truncate when they add into an
//   accumulator, and longer chains of a row's k-steps pushed the
//   difference between a step on two half batches and one on the whole
//   (chip_smoke.py's phase A) past its bar.
// - Three tile families, by KT:
//   * KT <= 16 (the 512-1024 px shapes): warp-level mma.sync.m16n8k8
//     tiles. wgmma's 64-row tiles left 25% (CC = 16) and 44% (CC = 8) of
//     M as padding, where m16 tiles leave 0% and 10% (9 and 5 m-tiles),
//     and its n8 / n16 products were too short to chain well. B comes
//     from the raw staged cotangent through registers, split as loaded
//     (no B buffers, no barrier a row). The four warps of a warpgroup take
//     a quarter of the row's 16 k-steps each, all m- and n-tiles; at an
//     item's end their sums meet in shared memory and are added in warp
//     order (fixed, so the result repeats bit for bit).
//   * KT = 32: wgmma.m64n32k8 over MT = 3 m-tiles of 64 rows. A warpgroup
//     splits its row's cotangent into hi and lo B operands in shared
//     memory (core matrices of 8 channels x 4 pixels); each k-step's
//     products of all m-tiles are one group, in one of two chains, so
//     that one group's MMAs run while the group before is added
//     (wgmma.wait_group 1).
//   * KT = 64 (K >= 64, the 128-256 px shapes): wgmma.m64n64k8, x loaded
//     once for 64 output channels. 3 x 32 accumulators and two chains of
//     all m-tiles would need 288 registers a thread, so a group is one
//     m-tile's k-step (m-tiles outer, k-steps inner): two chains of 32.
//     The hi / lo B of a 128-column row would take 128 KB, so items are
//     64 columns wide (TW = 64), which leaves room for 6 stages.
// - Pass 2 (conv3x3_dw_reduce) sums the 2 P partials of each output in a
//   fixed order (8 contiguous runs, then the 8 run sums in order).
// No atomics, so the result is the same from run to run.
// W must be a multiple of 4 (TMA's 16-byte strides) and the tensors
// 16-byte aligned: the wrapper pads a ragged W with zero columns.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 <= 384 x 170
// (the producer is one thread's TMA loop; KT = 64's accumulators and
// chains spilled at 224)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr uint32_t kLbo = 128, kSbo = 256;  // B core matrices (hopper.cuh)
constexpr int kSmemLimit = 232448;  // the H100's shared memory a block

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <int KT, int CC>
struct DwPlan {
  // m16n8k8 tiles (mma.sync) at KT <= 16, m64 wgmma tiles above
  static constexpr bool kSmall = KT <= 16;
  static constexpr int TW = KT == 64 ? 64 : 128;  // columns an item
  // staged x row from column j0 - 4, floats: TW + 2 columns of halo from
  // a 16-byte aligned start, = 4 mod 32 for conflict-free A loads
  static constexpr int XPX = TW + 36;
  static constexpr int XPC = TW + 4;  // staged cotangent row (= 4 mod 32)
  static constexpr int KS = TW / 8;  // k-steps a row
  static constexpr int MROWS = kSmall ? 16 : 64;  // rows an m-tile
  static constexpr int MT = (9 * CC + MROWS - 1) / MROWS;  // m-tiles
  static constexpr int NR = KT / 2;  // accumulators an m-tile, a thread
  static constexpr int kXFloats = CC * XPX, kCtFloats = KT * XPC;
  static constexpr int kStageBytes = round_up((kXFloats + kCtFloats) * 4,
                                             128);  // TMA: 128-byte aligned
  // wgmma: the hi and lo B operands of each warpgroup's row; mma.sync: the
  // sums of each warp, added in warp order at an item's end
  static constexpr int kBFloats = KS * 8 * KT;
  static constexpr int kSideFloats =
      kSmall ? 2 * 4 * 32 * MT * NR : 4 * kBFloats;
  // stages: as many as the H100's 227 KB a block holds beside that (at
  // most 12), so that TMA's latency hides behind the rows the two
  // warpgroups hold
  static constexpr int kMaxStages =
      (kSmemLimit - 128 - kSideFloats * 4 - 2 * 12 * 8) / kStageBytes;
  static constexpr int kStages = kMaxStages < 12 ? kMaxStages : 12;
  static_assert(kStages >= 5, "two warpgroups hold up to four stages");
  static constexpr int kBarOffset = kStages * kStageBytes + kSideFloats * 4;
  // + 128 to align the base, + the barriers
  static constexpr size_t kSmemBytes = kBarOffset + 2 * kStages * 8 + 128;
  static_assert(kSmemBytes <= kSmemLimit, "a block's shared memory");
};

template <int KT, int CC>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_dw_partial(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap ctmap,
                   float* __restrict__ ws, int H, int C, int K,
                   int rows_per_block, int row_chunks, int col_tiles,
                   int c_chunks, int items) {
  using P = DwPlan<KT, CC>;
  constexpr int MT = P::MT, NR = P::NR, XPX = P::XPX, XPC = P::XPC;
  constexpr int kStages = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((128 - (pggan::smem_addr(smem_raw) & 127)) & 127);
  auto xst = [&](int s) {
    return reinterpret_cast<float*>(smem + s * P::kStageBytes);
  };
  auto ctst = [&](int s) { return xst(s) + P::kXFloats; };
  float* side = reinterpret_cast<float*>(smem + kStages * P::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBarOffset);
  uint64_t* empty = full + kStages;
  // item it: pixel slice p (image n, rows i0 .., columns j0 ..), channel
  // chunk c0, k tile k0; its steps (rows + 2: x rows i0 - 1 .. i0 + rows)
  struct Item {
    int p, n, i0, j0, c0, k0, steps;
  };
  auto item = [&](int it) {
    Item m;
    m.k0 = it % ((K + KT - 1) / KT) * KT;
    int rest = it / ((K + KT - 1) / KT);
    m.c0 = rest % c_chunks * CC;
    m.p = rest / c_chunks;
    m.j0 = m.p % col_tiles * P::TW;
    m.i0 = m.p / col_tiles % row_chunks * rows_per_block;
    m.n = m.p / col_tiles / row_chunks;
    m.steps = min(H - m.i0, rows_per_block) + 2;
    return m;
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      pggan::mbar_init(&full[s], 1);
      pggan::mbar_init(&empty[s], kConsumers / 32);
    }
    pggan::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one thread
    pggan::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      int Q = 0;  // stages filled so far, over all of this block's items
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const Item m = item(it);
        for (int q = 0; q < m.steps; ++q, ++Q) {
          const int s = Q % kStages;
          pggan::mbar_wait(&empty[s], ((Q / kStages) & 1) ^ 1);
          pggan::mbar_arrive_expect_tx(
              &full[s], (P::kXFloats + (q >= 2 ? P::kCtFloats : 0)) * 4);
          pggan::tma_load_4d(xst(s), &xmap, &full[s], m.j0 - 4, m.c0,
                             m.i0 - 1 + q, m.n);
          if (q >= 2)
            pggan::tma_load_4d(ctst(s), &ctmap, &full[s], m.j0, m.k0,
                               m.i0 + q - 2, m.n);
        }
      }
    }
    return;
  }

  // the consumer warpgroups: of an item, warpgroup wg takes the rows
  // i0 + wg, i0 + wg + 2, ... (steps q = 2 + wg, 4 + wg, ...). A
  // warpgroup releases each stage of an item once, when no later step of
  // its own reads it (after step q: the stages before q).
  pggan::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, wl = warp % 4, wtid = threadIdx.x % 128;
  const int g = lane / 4, t = lane % 4;
  auto release = [&](int from, int to) {  // stages [from, to) of all
    __syncwarp();
    if (lane == 0)
      for (int S = from; S < to; ++S) pggan::mbar_arrive(&empty[S % kStages]);
  };
  // the x rows i - 1, i, i + 1 of step Q's row i, once they have landed
  auto wait_row = [&](int Q) {
    pggan::mbar_wait(&full[(Q - 2) % kStages], ((Q - 2) / kStages) & 1);
    pggan::mbar_wait(&full[(Q - 1) % kStages], ((Q - 1) / kStages) & 1);
    pggan::mbar_wait(&full[Q % kStages], (Q / kStages) & 1);
  };

  if constexpr (P::kSmall) {
    // -- m16n8k8 tiles: warp wl takes k-steps 4 wl .. 4 wl + 3 of each of
    // its warpgroup's rows, every m-tile (16 (tap, c) rows) and n-tile (8
    // output channels). Row 16 m + g + 8 hf of m-tile m is tap
    // (16 m + 8 hf) / CC, channel (16 m + 8 hf) % CC + g; a tap past 8
    // (CC = 8: the last m-tile's second half) reads tap 8's x, and its
    // sums are never stored.
    constexpr int NT = KT / 8, KW = P::KS / 4;
    // k-steps unrolled together (of a warp's four a row): two at 9 x 2
    // tiles (all four spilled registers), else all four
    constexpr int KU = MT * NT > 10 ? 2 : 4;
    float* scr = side + wg * 4 * 32 * MT * NR;  // [warp][e][lane]
    int Q0 = 0;  // the block's stage count at this item's first step
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const Item mi = item(it);
      float acc[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
      int freed = 0;  // the item's stages this warpgroup has released
      for (int q = 2 + wg; q < mi.steps; q += 2) {
        const int Q = Q0 + q;
        wait_row(Q);
        const float* xrow[3] = {xst((Q - 2) % kStages),
                                xst((Q - 1) % kStages), xst(Q % kStages)};
        const float* cr = ctst(Q % kStages) + g * XPC + t;
#pragma unroll 1
        for (int k0 = 0; k0 < KW; k0 += KU)
#pragma unroll
        for (int k4 = k0; k4 < k0 + KU; ++k4) {
          const int jj = (wl * KW + k4) * 8;  // the k-step's first pixel
          // B (pixel, k) = the cotangent: b0 (pixel t, k = g), b1 (t + 4)
          uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            pggan::tf32_split_fast(cr[j * 8 * XPC + jj], bh[j][0], bl[j][0]);
            pggan::tf32_split_fast(cr[j * 8 * XPC + jj + 4], bh[j][1],
                                   bl[j][1]);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            uint32_t ah[4], al[4];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int r0 = 16 * m + 8 * hf;
              const int tap = r0 / CC < 9 ? r0 / CC : 8;
              const int u = tap / 3, v = tap % 3;
              // staged column sc holds image column j0 - 4 + sc
              const float* xa = (u == 0 ? xrow[0] : u == 1 ? xrow[1]
                                                           : xrow[2]) +
                                (r0 % CC + g) * XPX + jj + t + v + 3;
              pggan::tf32_split_fast(xa[0], ah[hf], al[hf]);
              pggan::tf32_split_fast(xa[4], ah[hf + 2], al[hf + 2]);
            }
#pragma unroll
            for (int j = 0; j < NT; ++j)
              pggan::mma_m16n8k8_3x(acc[m][j], ah, al, bh[j], bl[j]);
          }
        }
        release(Q0 + freed, Q);
        freed = q;
      }
      release(Q0 + freed, Q0 + mi.steps);

      // the four warps' sums, added in warp order: slice 2 p + wg of the
      // workspace. Element e = 4 (m NT + j) + el of a lane is row 16 m +
      // lane / 4 + 8 (el / 2), output channel 8 j + 2 (lane % 4) + el % 2.
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int el = 0; el < 4; ++el)
            scr[(wl * MT * NR + 4 * (m * NT + j) + el) * 32 + lane] =
                acc[m][j][el];
      pggan::named_barrier(1 + wg, 128);
      float* part = ws + (2LL * mi.p + wg) * 9 * C * K;
#pragma unroll
      for (int i = 0; i < MT * NR / 4; ++i) {
        const int idx = wtid + 128 * i, ln = idx % 32, e = idx / 32;
        float sum = scr[e * 32 + ln];
#pragma unroll
        for (int w = 1; w < 4; ++w) sum += scr[(w * MT * NR + e) * 32 + ln];
        const int m = e / (4 * NT), j = e / 4 % NT, el = e % 4;
        const int row = 16 * m + ln / 4 + 8 * (el >> 1);
        const int c = mi.c0 + row % CC;
        const int k = mi.k0 + 8 * j + 2 * (ln % 4) + (el & 1);
        if (row < 9 * CC && c < C && k < K)
          part[((long long)(row / CC) * C + c) * K + k] = sum;
      }
      // every warp has read the sums: the next item may write them
      pggan::named_barrier(1 + wg, 128);
      Q0 += mi.steps;
    }
  } else {
    // -- m64 wgmma tiles: this thread's A rows 64 m + 16 wl + g + 8 hf:
    // tap (u, v), channel c; the x element of pixel column j0 + jj for it
    // is staged at xst(row u) + off + jj (staged column sc holds image
    // column j0 - 4 + sc). Rows past the 9 CC taps x channels read row
    // 9 CC - 1's x: their sums are never stored, and real operands keep
    // ptxas from serializing the MMAs over constant registers.
    // m-tiles a group of MMAs (one wait each): all of them at KT = 32, one
    // at KT = 64 (registers); two chains of groups
    constexpr int MG = KT == 64 ? 1 : MT, IL = 2, KS = P::KS;
    constexpr int GROUPS = MT / MG * KS;  // group gi: m-tiles gi / KS,
                                          // k-step gi % KS
    int tap_u[MT][2], off[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = min(64 * m + 16 * wl + g + 8 * hf, 9 * CC - 1);
        const int tap = row / CC, c = row % CC;
        tap_u[m][hf] = tap / 3;
        off[m][hf] = c * XPX + tap % 3 + 3;
      }
    float* bh = side + (2 * wg) * P::kBFloats;
    float* bl = bh + P::kBFloats;

    int Q0 = 0;  // the block's stage count at this item's first step
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const Item mi = item(it);
      float acc[MT][NR], prod[IL][MG][NR];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < NR; ++e) acc[m][e] = 0.f;
#pragma unroll
      for (int c = 0; c < IL; ++c)
#pragma unroll
        for (int m = 0; m < MG; ++m)
#pragma unroll
          for (int e = 0; e < NR; ++e) prod[c][m][e] = 0.f;
      int freed = 0;  // the item's stages this warpgroup has released

      for (int q = 2 + wg; q < mi.steps; q += 2) {
        const int Q = Q0 + q, s = Q % kStages;
        wait_row(Q);
        // the cotangent row -> hi / lo B[ks][k / 8][j / 4 % 2][k % 8][j % 4];
        // this warpgroup's MMAs of its previous row have completed
        {
          // eight loads in flight before their splits are stored
          const float* raw = ctst(s);
          static_assert(P::kBFloats % (8 * 128) == 0, "whole batches");
          for (int e0 = wtid; e0 < P::kBFloats; e0 += 8 * 128) {
            float v[8];
#pragma unroll
            for (int b8 = 0; b8 < 8; ++b8) {
              const int e = e0 + 128 * b8;
              const int j4 = e & 3, k8 = (e >> 2) & 7, half = (e >> 5) & 1;
              const int blk = e >> 6;  // ks * (KT / 8) + k / 8
              const int k = blk % (KT / 8) * 8 + k8, ks = blk / (KT / 8);
              v[b8] = raw[k * XPC + ks * 8 + half * 4 + j4];
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

        const float* xrow[3] = {xst((Q - 2) % kStages),
                                xst((Q - 1) % kStages), xst(s)};
        // A of group gi's m-tiles and k-step, in register set gi % 2
        uint32_t ah[2][MG][4], al[2][MG][4];
        auto load_a = [&](int gi, int set) {
          const int jj = gi % KS * 8 + t;  // pixel column j - j0
#pragma unroll
          for (int mm = 0; mm < MG; ++mm)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int m = gi / KS * MG + mm;
              const int u = tap_u[m][hf];
              const float* xa =
                  (u == 0 ? xrow[0] : u == 1 ? xrow[1] : xrow[2]) +
                  off[m][hf] + jj;
              pggan::tf32_split_fast(xa[0], ah[set][mm][hf],
                                     al[set][mm][hf]);
              pggan::tf32_split_fast(xa[4], ah[set][mm][hf + 2],
                                     al[set][mm][hf + 2]);
            }
        };
        // the row's groups: each k-step's three products summed from zero
        // in the tensor cores (scale-d = 0 at its first), in chain gi % IL;
        // once a group has completed (wgmma.wait_group 1, the next group's
        // MMAs queued), its sums are added to the accumulators with
        // rounded f32 adds, in k-step order for each m-tile, and its A
        // registers take the group after next
        auto add_group = [&](int gi) {
          const int c = gi % IL;
#pragma unroll
          for (int mm = 0; mm < MG; ++mm) {
            pggan::fence_operand(prod[c][mm]);
#pragma unroll
            for (int e = 0; e < NR; ++e)
              acc[gi / KS * MG + mm][e] += prod[c][mm][e];
          }
        };
        load_a(0, 0);
#pragma unroll
        for (int gi = 0; gi < GROUPS; ++gi) {
          const int set = gi & 1, c = gi % IL, ks = gi % KS;
#pragma unroll
          for (int mm = 0; mm < MG; ++mm) pggan::fence_operand(prod[c][mm]);
          pggan::wgmma_fence();
          const uint64_t dh = pggan::wgmma_desc(bh + ks * 8 * KT, kLbo, kSbo);
          const uint64_t dl = pggan::wgmma_desc(bl + ks * 8 * KT, kLbo, kSbo);
#pragma unroll
          for (int mm = 0; mm < MG; ++mm)
            pggan::Wgmma<KT>::mma(prod[c][mm], al[set][mm], dh, 0);
#pragma unroll
          for (int mm = 0; mm < MG; ++mm)
            pggan::Wgmma<KT>::mma(prod[c][mm], ah[set][mm], dl, 1);
#pragma unroll
          for (int mm = 0; mm < MG; ++mm)
            pggan::Wgmma<KT>::mma(prod[c][mm], ah[set][mm], dh, 1);
          pggan::wgmma_commit();
          if (gi > 0) {
            pggan::wgmma_wait<1>();
            add_group(gi - 1);
          }
          if (gi + 1 < GROUPS) load_a(gi + 1, set ^ 1);
        }
        pggan::wgmma_wait<0>();
        add_group(GROUPS - 1);
        release(Q0 + freed, Q);
        freed = q;
      }
      release(Q0 + freed, Q0 + mi.steps);

      // each warpgroup's sums, a partial (9, CC, KT) tile of its own: slice
      // 2 p + wg of the workspace. acc[m][4j + 2h + e]: row 64 m + 16 wl +
      // g + 8h (tap, c0 + c), output channel k0 + 8j + 2t + e
      float* part = ws + (2LL * mi.p + wg) * 9 * C * K;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < NR; ++e) {
          const int row = 64 * m + 16 * wl + g + 8 * ((e >> 1) & 1);
          const int c = mi.c0 + row % CC;
          const int k = mi.k0 + (e >> 2) * 8 + 2 * t + (e & 1);
          if (row < 9 * CC && c < C && k < K)
            part[((long long)(row / CC) * C + c) * K + k] = acc[m][e];
        }
      Q0 += mi.steps;
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

template <int KT, int CC>
int launch_partial(const float* x, const float* ct, float* ws, int N, int H,
                   int C, int W, int K, int rows_per_block, int row_chunks,
                   int col_tiles, cudaStream_t s) {
  using P = DwPlan<KT, CC>;
  CUtensorMap xmap, ctmap;
  const uint64_t xdims[4] = {(uint64_t)W, (uint64_t)C, (uint64_t)H,
                             (uint64_t)N};
  const uint32_t xbox[4] = {P::XPX, CC, 1, 1};
  int e = pggan::host::tensor_map_f32(&xmap, x, 4, xdims, xbox);
  if (e != 0) return e;
  const uint64_t cdims[4] = {(uint64_t)W, (uint64_t)K, (uint64_t)H,
                             (uint64_t)N};
  const uint32_t cbox[4] = {P::XPC, KT, 1, 1};
  e = pggan::host::tensor_map_f32(&ctmap, ct, 4, cdims, cbox);
  if (e != 0) return e;
  auto kern = conv3x3_dw_partial<KT, CC>;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kSmemBytes);
  if (ce != cudaSuccess) return (int)ce;
  int dev, sms;
  if ((ce = cudaGetDevice(&dev)) != cudaSuccess) return (int)ce;
  ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return (int)ce;
  const int c_chunks = (C + CC - 1) / CC;
  const int items =
      N * row_chunks * col_tiles * c_chunks * ((K + KT - 1) / KT);
  kern<<<items < sms ? items : sms, kThreads, P::kSmemBytes, s>>>(
      xmap, ctmap, ws, H, C, K, rows_per_block, row_chunks, col_tiles,
      c_chunks, items);
  return (int)cudaGetLastError();
}

// pass 2: dw[e] = sum over p of ws[p][e], e < E = 9 C K, in a fixed order
int reduce(const float* ws, float* dw, int P, long long E, cudaStream_t s) {
  const long long blocks = (E + kRedE - 1) / kRedE;
  conv3x3_dw_reduce<<<(unsigned)blocks, kRedE * kRedG, 0, s>>>(ws, dw, P, E);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, C, W); ct (N, H, K, W); ws (2 P, 9, C, K) scratch with
// P = N * row_chunks * col_tiles pixel slices (row_chunks runs of
// rows_per_block image rows, col_tiles = ceil(W / TW), TW = 64 at KT = 64,
// else 128); dw (3, 3, C, K). KT is the k tile (8, 16, 32 or 64), CC the
// channel chunk (8 for C <= 8 at KT <= 16, else 16). W a multiple of 4, x
// and ct 16-byte aligned.
extern "C" int pggan_conv3x3_dw(const float* x, const float* ct, float* ws,
                                float* dw, int N, int H, int C, int W, int K,
                                int KT, int CC, int rows_per_block,
                                int row_chunks, int col_tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(ct)) % 16)
    return (int)cudaErrorInvalidValue;
  int e;
  const int a = KT * 100 + CC;
  switch (a) {
#define PGGAN_DW_CASE(kt, cc)                                              \
  case kt * 100 + cc:                                                      \
    e = launch_partial<kt, cc>(x, ct, ws, N, H, C, W, K, rows_per_block,   \
                               row_chunks, col_tiles, s);                  \
    break;
    PGGAN_DW_CASE(8, 8)
    PGGAN_DW_CASE(8, 16)
    PGGAN_DW_CASE(16, 8)
    PGGAN_DW_CASE(16, 16)
    PGGAN_DW_CASE(32, 16)
    PGGAN_DW_CASE(64, 16)
#undef PGGAN_DW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  return reduce(ws, dw, 2 * N * row_chunks * col_tiles, 9LL * C * K, s);
}
