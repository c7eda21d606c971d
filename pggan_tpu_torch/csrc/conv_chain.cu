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
// write and read (4 K1 bytes per pixel each way). The design, conv3x3.cu's
// for each of the two convs:
// - A persistent grid, one block an SM, walks work items: a strip of 64
//   output columns of one image over a run of L rows (L from the wrapper,
//   ops/conv_chain.py:chain_rows). A block is one producer warpgroup and
//   two consumer warpgroups; setmaxnreg moves registers from the producer
//   (56) to the consumers (224).
// - Halo columns. Stage 1 computes the intermediate at the strip's 66
//   columns (64 + one each side) of rows i0 - 1 .. i0 + L, flattened: a
//   run's intermediate positions p = 66 row + column are taken in order,
//   64 to a wgmma M-tile, 2 MW M-tiles a band (MW = 1, 2, 4, 5 a
//   warpgroup at KT = 64, 32, 16, 8). A's rows come from registers, so a
//   tile may span rows at no cost, and no M row is padding but at a run's
//   end. (Output tiles of 62 columns, whose 64 intermediate columns fill
//   one M-tile a row, would waste 17% of the tiles at W = 256; a third
//   M-tile for the 2 halo columns would double stage 1.)
// - Halo rows. A block walks down its run band by band and keeps the
//   intermediate rows that the next output rows need in a ring of
//   SPAN + 2 rows in shared memory (SPAN = the rows a band's positions
//   touch), so stage 1 computes each intermediate row once a run; the only
//   recompute is a run's two halo rows (2 / L; L = 129, 512 and 1024 rows
//   at the serve's 256, 512 and 1024 px stages, batch 16).
//   After each band, stage 2 computes every output row whose three
//   intermediate rows are complete: at most 2 MW rows, one wgmma M-tile
//   (64 pixels) each, MW a warpgroup. Two consumer barriers a band: before
//   a band's intermediate is stored (the band before has read the ring)
//   and after it (stage 2 reads what both warpgroups stored).
// - Loads. The producer walks the same stages as the consumers through a
//   ring of mbarrier stages (4; 2 at KT = 64, whose stages are larger): a
//   band's stage-1 stages carry 8 input channels each, x's halo as a TMA
//   box of a 4-D map over NHCW ((72 columns from col0 - 4, 16-byte
//   aligned; 8 channels; SPAN + 2 rows), zero outside the tensor: the first
//   conv's padding) and w1's (9, 8, KT) rows; its stage-2 stages carry
//   w2's rows for 8 intermediate channels. The raw weights arrive by TMA
//   (3-D maps over (K, C, 9), zero beyond C and K) a stage ahead into the
//   producer's two buffers, and its threads split them into hi and lo B
//   operands in the stage (core matrices of 8 output x 4 input channels):
//   no weight-split launch and no workspace.
// - Arithmetic: wgmma.m64nKTk8 in TF32 with hopper.cuh's three-product
//   split (f32 accuracy), A split as it is loaded (tf32_split_fast), the
//   next tap's while this tap's MMAs run. A stage's 9 taps are chained in
//   the tensor cores from zero, hi x hi in one chain and the 18 cross terms
//   in another, then both added to the f32 sums with a rounded add (the
//   tensor cores truncate when they add into an accumulator).
// - Epilogues: epilogue.cuh's bias_act_pn on the fragments; stage 1
//   stores the intermediate in the ring (rows of 72 floats a channel, = 8
//   mod 32, so stage 2's A loads are conflict-free), positions outside the
//   image as 0; stage 2 stores y, each store instruction four 32-byte runs
//   along W.
// - KT = max(K1, K2) rounded up to 8, 16, 32 or 64: one instantiation a
//   tier (pixelnorm is a run-time flag); the generator's pairs have
//   K1 = K2.
// TMA's global strides are multiples of 16 bytes: the wrapper pads a ragged
// W (x) and K1, K2 (the weights' rows) with zeros; W gives the image, Wy
// the row length of x and y.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kTW = 64;       // output columns a strip (wgmma M)
constexpr int kIW = kTW + 2;  // intermediate positions a row
constexpr int kCC = 8;        // channels a stage (k8)
constexpr int kSW = 72;       // staged x row, floats (= 8 mod 32)
constexpr int kZS = 72;       // intermediate row of one channel (= 8 mod 32)
// registers a thread after setmaxnreg: 128 x 56 + 256 x 224 = 384 x 168
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
// B descriptors: the two k-halves of a core-matrix pair, then 8-channel
// groups of N (see hopper.cuh)
constexpr uint32_t kLbo = 128, kSbo = 256;
constexpr int kSmemLimit = 232448;  // the H100's shared memory a block

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <int KT>
struct Plan {
  // M-tiles a warpgroup: as many as the registers hold (5 spilled at
  // KT = 16, 6 at KT = 8)
  static constexpr int MW = KT == 64 ? 1 : KT == 32 ? 2 : KT == 16 ? 4 : 5;
  static constexpr int BP = 2 * MW * kTW;  // intermediate positions a band
  // the most rows a band's BP consecutive positions touch
  static constexpr int SPAN = (kIW - 1 + BP - 1) / kIW + 1;
  static constexpr int XR = SPAN + 2;  // x rows a stage-1 box
  static constexpr int ZR = SPAN + 2;  // intermediate rows in the ring
  static constexpr int NR = KT / 2;    // accumulators an M-tile, a thread
  static constexpr int kStages = KT == 64 ? 2 : 4;
  static constexpr int kXFloats = XR * kCC * kSW;
  static constexpr int kWFloats = 9 * kCC * KT;  // raw, hi or lo weights
  static constexpr int kStageBytes =
      round_up((kXFloats + 2 * kWFloats) * 4, 1024);
  // the stages, the producer's two raw weight boxes, the intermediate
  static constexpr int kRawOffset = kStages * kStageBytes;
  static constexpr int kZOffset = kRawOffset + 2 * kWFloats * 4;
  static constexpr int kZFloats = ZR * KT * kZS;
  static constexpr int kBarOffset = kZOffset + kZFloats * 4;
  // + 1024 to align the base, + the barriers
  static constexpr size_t kSmemBytes =
      kBarOffset + (2 * kStages + 2) * 8 + 1024;
  static_assert(kSmemBytes <= kSmemLimit, "a block's shared memory");
};

// The stages of a block's walk, in the order both sides take them: per
// item (strip, run) and band, the stage-1 chunks of 8 input channels, then
// the stage-2 chunks of 8 intermediate channels.
struct Walk {
  int it, band, phase, chunk;  // phase 0: stage 1, 1: stage 2
  int n, col0, i0, rows, bands;
};

struct Dims {
  int H, C, L, col_tiles, runs, items, chunks1, chunks2, bp;
};

__device__ __forceinline__ void walk_item(Walk& w, const Dims& d) {
  w.band = w.phase = w.chunk = 0;
  if (w.it >= d.items) return;
  w.col0 = w.it % d.col_tiles * kTW;
  const int rest = w.it / d.col_tiles;
  w.i0 = rest % d.runs * d.L;
  w.n = rest / d.runs;
  w.rows = min(d.L, d.H - w.i0);
  // intermediate rows i0 - 1 .. i0 + rows: (rows + 2) x 66 positions
  w.bands = ((w.rows + 2) * kIW + d.bp - 1) / d.bp;
}

__device__ __forceinline__ void walk_next(Walk& w, const Dims& d) {
  if (++w.chunk < (w.phase == 0 ? d.chunks1 : d.chunks2)) return;
  w.chunk = 0;
  if (w.phase == 0) {
    w.phase = 1;
    return;
  }
  w.phase = 0;
  if (++w.band < w.bands) return;
  w.it += gridDim.x;
  walk_item(w, d);
}

// One ring stage's 9 taps on a warpgroup's MW M-tiles, A loaded by
// load_a(tap, set) into register set `set` (the next tap's while this
// tap's MMAs run), B from the stage's split weights bh, bl: chained in the
// tensor cores from zero (scale-d = 0 at the first tap), the 9 hi x hi
// products in p1 and the 18 cross terms in p2, the M-tiles' and the two
// sums' chains interleaved; then both added to acc with a rounded add.
template <int KT, int MW, typename LoadA>
__device__ __forceinline__ void stage_mmas(
    const float* bh, const float* bl, float (&acc)[MW][KT / 2],
    float (&p1)[MW][KT / 2], float (&p2)[MW][KT / 2],
    uint32_t (&ah)[2][MW][4], uint32_t (&al)[2][MW][4], LoadA&& load_a) {
  load_a(0, 0);
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    pggan::fence_operand(p1[i]);
    pggan::fence_operand(p2[i]);
  }
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int set = tap & 1;
    const uint64_t dh = pggan::wgmma_desc(bh + tap * kCC * KT, kLbo, kSbo);
    const uint64_t dl = pggan::wgmma_desc(bl + tap * kCC * KT, kLbo, kSbo);
    pggan::wgmma_fence();
#pragma unroll
    for (int i = 0; i < MW; ++i)
      pggan::Wgmma<KT>::mma(p1[i], ah[set][i], dh, tap > 0);
#pragma unroll
    for (int i = 0; i < MW; ++i)
      pggan::Wgmma<KT>::mma(p2[i], ah[set][i], dl, tap > 0);
#pragma unroll
    for (int i = 0; i < MW; ++i)
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
  for (int i = 0; i < MW; ++i) {
    pggan::fence_operand(p1[i]);
    pggan::fence_operand(p2[i]);
#pragma unroll
    for (int e = 0; e < KT / 2; ++e) acc[i][e] += p1[i][e] + p2[i][e];
  }
}

template <int KT>
__global__ void __launch_bounds__(kThreads, 1)
chain_kernel(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap w1map,
             const __grid_constant__ CUtensorMap w2map,
             const float* __restrict__ b1, const float* __restrict__ b2,
             float* __restrict__ y, Dims d, int W, int Wy, int K1, int K2,
             int pn, float slope, float eps) {
  using P = Plan<KT>;
  constexpr int MW = P::MW, NR = P::NR, ZR = P::ZR;
  constexpr int kStages = P::kStages;
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
  float* zs = reinterpret_cast<float*>(smem + P::kZOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* rawbar = empty + kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the producer's (expect-tx) arrival and its 128 threads' arrivals
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
    Walk cur, ahead;
    cur.it = blockIdx.x;
    walk_item(cur, d);
    // the raw (9, 8, KT) weights of a stage: w1's rows of its 8 input
    // channels, or w2's of its 8 intermediate channels; one box of a 3-D
    // map over (K, C, 9), zero beyond C and K
    auto load_raw = [&](const Walk& w, int i) {
      pggan::mbar_arrive_expect_tx(&rawbar[i], P::kWFloats * 4);
      pggan::tma_load_3d(raw(i), w.phase == 0 ? &w1map : &w2map, &rawbar[i],
                         0, w.chunk * kCC, 0);
    };
    if (pt == 0) {
      ahead = cur;
      if (cur.it < d.items) load_raw(cur, 0);
    }
    for (int q = 0; cur.it < d.items; ++q, walk_next(cur, d)) {
      const int s = q % kStages;
      if (pt == 0) {
        walk_next(ahead, d);  // stage q + 1, its raw weights in flight
        if (ahead.it < d.items) load_raw(ahead, (q + 1) & 1);
      }
      pggan::mbar_wait(&empty[s], ((q / kStages) & 1) ^ 1);
      if (pt == 0) {
        if (cur.phase == 0) {
          // x rows i0 - 1 + r - 1 .. for the band's first intermediate
          // row r, columns from col0 - 4, channels of the chunk
          const int r = cur.band * d.bp / kIW;
          pggan::mbar_arrive_expect_tx(&full[s], P::kXFloats * 4);
          pggan::tma_load_4d(xbox(s), &xmap, &full[s], cur.col0 - 4,
                             cur.chunk * kCC, cur.i0 + r - 2, cur.n);
        } else {
          pggan::mbar_arrive(&full[s]);
        }
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

  // the consumer warpgroups: warpgroup wg takes M-tiles wg MW .. wg MW +
  // MW - 1 of each band, in both stages
  pggan::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane / 4, t = lane % 4;
  // acc: the f32 sums; per stage, p1 chains the hi x hi products and p2
  // the small cross terms (hi x lo, lo x hi)
  float acc[MW][NR], p1[MW][NR], p2[MW][NR];
  uint32_t ah[2][MW][4], al[2][MW][4];

  auto clear = [&]() {
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int e = 0; e < NR; ++e) acc[i][e] = p1[i][e] = p2[i][e] = 0.f;
  };

  int q = 0;  // stages consumed
  Walk w;
  w.it = blockIdx.x;
  walk_item(w, d);
  for (; w.it < d.items; w.it += gridDim.x, walk_item(w, d)) {
    for (int band = 0; band < w.bands; ++band) {
      // ---- stage 1: M-tile wg MW + i of the band holds run positions
      // P0 + 64 (wg MW + i) + [0, 64); this thread's rows g, g + 8 of it
      // are positions p = 66 rr + cc: intermediate row i0 - 1 + rr, column
      // col0 - 1 + cc. The band's x box holds rows from i0 + fr - 2 (fr =
      // the band's first intermediate row) and columns from col0 - 4.
      const int P0 = band * d.bp, fr = P0 / kIW;
      // position p of this thread's row h of M-tile i
      auto pos = [&](int i, int h) {
        return P0 + kTW * (wg * MW + i) + 16 * wl + g + 8 * h;
      };
      int xo[MW][2];
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = pos(i, h), rr = p / kIW, cc = p % kIW;
          // tap (u, v) of channel t: staged row rr - fr + u, column
          // cc + v + 2
          xo[i][h] = (rr - fr) * kCC * kSW + t * kSW + cc + 2;
        }
      clear();
      for (int ch = 0; ch < d.chunks1; ++ch, ++q) {
        const int s = q % kStages;
        pggan::mbar_wait(&full[s], (q / kStages) & 1);
        const float* xs = xbox(s);
        stage_mmas<KT, MW>(bsplit(s, 0), bsplit(s, 1), acc, p1, p2, ah, al,
                           [&](int tp, int set) {
          const int uv = (tp / 3) * kCC * kSW + tp % 3;
#pragma unroll
          for (int i = 0; i < MW; ++i) {
            const float* x0 = xs + xo[i][0] + uv;
            const float* x1 = xs + xo[i][1] + uv;
            pggan::tf32_split_fast(x0[0], ah[set][i][0], al[set][i][0]);
            pggan::tf32_split_fast(x1[0], ah[set][i][1], al[set][i][1]);
            pggan::tf32_split_fast(x0[4 * kSW], ah[set][i][2],
                                   al[set][i][2]);
            pggan::tf32_split_fast(x1[4 * kSW], ah[set][i][3],
                                   al[set][i][3]);
          }
        });
        __syncwarp();
        if (lane == 0) pggan::mbar_arrive(&empty[s]);
      }
      float rn[2];  // pixelnorm's r, not kept
#pragma unroll
      for (int i = 0; i < MW; ++i)
        pggan::bias_act_pn(acc[i], b1, K1, pn != 0, slope, eps, t, rn);
      // the band before has read the ring: store the intermediate,
      // positions outside the image as 0 (the second conv's padding)
      pggan::named_barrier(2, kConsumers);
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // position p: intermediate row i0 - 1 + rr, column col0 - 1 +
          // cc, in ring row rr % ZR
          const int p = pos(i, h), rr = p / kIW, cc = p % kIW;
          const int gr = w.i0 - 1 + rr, gc = w.col0 - 1 + cc;
          const bool inside = gr >= 0 && gr < d.H && gc >= 0 && gc < W;
          float* zp = zs + rr % ZR * KT * kZS + cc;
#pragma unroll
          for (int j = 0; j < KT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              zp[(8 * j + 2 * t + e) * kZS] =
                  inside ? acc[i][4 * j + 2 * h + e] : 0.f;
        }
      pggan::named_barrier(2, kConsumers);

      // ---- stage 2: the output rows whose intermediate rows i0 - 1 + o ..
      // i0 + 1 + o (ring rows o .. o + 2) are complete after this band and
      // were not before: run rows o_first .. o_last (at most 2 MW). M-tile
      // wg MW + i is row o = o_first + wg MW + i, columns col0 .. col0 +
      // 63; tap (u, v) of output column q reads the ring's row o + u,
      // column q + v.
      const int done = (P0 + d.bp) / kIW - 1;  // last complete ring row
      const int o_first = max(0, fr - 2);
      const int o_last = min(w.rows - 1, done - 2);
      int zb[MW][3];
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int u = 0; u < 3; ++u)
          zb[i][u] = (o_first + wg * MW + i + u) % ZR * KT * kZS +
                     t * kZS + 16 * wl + g;
      clear();
      for (int ch = 0; ch < d.chunks2; ++ch, ++q) {
        const int s = q % kStages;
        pggan::mbar_wait(&full[s], (q / kStages) & 1);
        const float* zc = zs + ch * kCC * kZS;
        stage_mmas<KT, MW>(bsplit(s, 0), bsplit(s, 1), acc, p1, p2, ah, al,
                           [&](int tp, int set) {
          const int u = tp / 3, v = tp % 3;
#pragma unroll
          for (int i = 0; i < MW; ++i) {
            const float* za = zc + zb[i][u] + v;
            pggan::tf32_split_fast(za[0], ah[set][i][0], al[set][i][0]);
            pggan::tf32_split_fast(za[8], ah[set][i][1], al[set][i][1]);
            pggan::tf32_split_fast(za[4 * kZS], ah[set][i][2],
                                   al[set][i][2]);
            pggan::tf32_split_fast(za[4 * kZS + 8], ah[set][i][3],
                                   al[set][i][3]);
          }
        });
        __syncwarp();
        if (lane == 0) pggan::mbar_arrive(&empty[s]);
      }
      // acc[i][4j + 2h + e]: output row i0 + o, column col0 + 16 wl + g +
      // 8h, channel 8j + 2t + e
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        pggan::bias_act_pn(acc[i], b2, K2, pn != 0, slope, eps, t, rn);
        const int o = o_first + wg * MW + i;
        if (o > o_last) continue;
        float* yrow = y + (((long long)w.n * d.H + w.i0 + o) * K2) * Wy;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gc = w.col0 + 16 * wl + g + 8 * h;
          if (gc >= W) continue;
#pragma unroll
          for (int j = 0; j < KT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = 8 * j + 2 * t + e;
              if (k < K2)
                yrow[(long long)k * Wy + gc] = acc[i][4 * j + 2 * h + e];
            }
        }
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
  int N, H, C, W, Wy, K1, K2, L, pn;
  float slope, eps;
  cudaStream_t stream;
};

template <int KT>
int launch(const Args& a) {
  using P = Plan<KT>;
  CUtensorMap xmap, w1map, w2map;
  const uint64_t xdims[4] = {(uint64_t)a.Wy, (uint64_t)a.C, (uint64_t)a.H,
                             (uint64_t)a.N};
  const uint32_t xbox[4] = {kSW, kCC, P::XR, 1};
  int e = pggan::host::tensor_map_f32(&xmap, a.x, 4, xdims, xbox);
  if (e != 0) return e;
  // the weights' rows hold K rounded up to 4 (zero columns)
  const uint32_t wbox[3] = {KT, kCC, 9};
  const uint64_t w1dims[3] = {(uint64_t)(a.K1 + 3) / 4 * 4, (uint64_t)a.C,
                              9};
  e = pggan::host::tensor_map_f32(&w1map, a.w1, 3, w1dims, wbox);
  if (e != 0) return e;
  const uint64_t w2dims[3] = {(uint64_t)(a.K2 + 3) / 4 * 4, (uint64_t)a.K1,
                              9};
  e = pggan::host::tensor_map_f32(&w2map, a.w2, 3, w2dims, wbox);
  if (e != 0) return e;
  auto kern = chain_kernel<KT>;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kSmemBytes);
  if (ce != cudaSuccess) return (int)ce;
  int dev, sms;
  if ((ce = cudaGetDevice(&dev)) != cudaSuccess) return (int)ce;
  ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return (int)ce;
  Dims d;
  d.H = a.H;
  d.C = a.C;
  d.L = a.L;
  d.col_tiles = (a.W + kTW - 1) / kTW;
  d.runs = (a.H + a.L - 1) / a.L;
  d.items = a.N * d.runs * d.col_tiles;
  d.chunks1 = (a.C + kCC - 1) / kCC;
  d.chunks2 = (a.K1 + kCC - 1) / kCC;
  d.bp = P::BP;
  kern<<<d.items < sms ? d.items : sms, kThreads, P::kSmemBytes, a.stream>>>(
      xmap, w1map, w2map, a.b1, a.b2, a.y, d, a.W, a.Wy, a.K1, a.K2, a.pn,
      a.slope, a.eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, C, Wy); w1 (3, 3, C, K1 rounded up to 4), b1 (K1,); w2 (3, 3,
// K1, K2 rounded up to 4), b2 (K2,), HWIO, zero beyond K1, K2; y (N, H, K2,
// Wy), written at columns < W. KT: max(K1, K2) rounded up to 8, 16, 32 or
// 64; L: image rows a work item walks. Wy a multiple of 4, x and the
// weights 16-byte aligned (TMA).
extern "C" int pggan_conv3x3_chain(const float* x, const float* w1,
                                   const float* b1, const float* w2,
                                   const float* b2, float* y, int N, int H,
                                   int C, int W, int Wy, int K1, int K2,
                                   int KT, int L, int pn, float slope,
                                   float eps, void* stream) {
  if (K1 > KT || K2 > KT || L < 1 || W > Wy || Wy % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
       reinterpret_cast<uintptr_t>(w2)) % 16)
    return (int)cudaErrorInvalidValue;
  Args a{x, w1, b1, w2, b2, y, N, H, C, W, Wy, K1, K2, L, pn, slope, eps,
         static_cast<cudaStream_t>(stream)};
  switch (KT) {
    case 8: return launch<8>(a);
    case 16: return launch<16>(a);
    case 32: return launch<32>(a);
    case 64: return launch<64>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
