// StyleGAN's synthesis-layer epilogue (AdaIN) and its [1, 2, 1] blur, f32,
// on one plane layout that covers the NCHW stages and the NHCW tail.
//
// No TPU kernel is replaced: the JAX package has no StyleGAN. The epilogue
// of synthesis layer i (NVlabs/stylegan training/networks_stylegan.py,
// layer_epilogue) is, for each sample n and channel c,
//   y0 = x + strength[c] * noise[n, h, w] + bias[c]
//   a  = y0 >= 0 ? y0 : slope * y0
//   o  = (a - mean_hw(a)) * rsqrt(mean_hw((a - mean_hw(a))^2) + eps)
//        * (s[n, c] + 1) + b[n, c]
// with [s, b] = style[n, 0:C], style[n, C:2C]. It is a reduction over the
// H x W plane of each (n, c) and an elementwise pass, on the largest
// tensors of the step (4 x 16 x 1024 x 1024 at 1024 px); written in plain
// torch it is some eight passes over x forward and more backward.
//
// Layout: element (n, c, h, w) of x, y, g and dx sits at n * sN + c * sC +
// h * sH + w (W contiguous): NCHW is (C H W, H W, W), NHCW (H C W, W, C W).
// noise is (N, H, W) contiguous in both.
//
// Design: each plane (n, c) is cut into S chunks of whole rows, one block
// a chunk, so that the 64 planes of the 1024 px layer still fill the card.
// Forward, two kernels: style_adain_stats sums, per chunk, d = a - K and
// d^2 with K the plane's first element (a shift that keeps the variance
// from cancelling when the mean is far from zero), each thread in f32 over
// its elements, the block as a fixed tree; style_adain_apply merges a
// plane's S partials in f64 in chunk order, so every block of the plane
// gets the same mean and rsqrt, then writes y (block 0 of the plane also
// writes (mean, rsqrt) for the backward). Backward, two more:
// style_adain_bwd_stats sums g and g * xhat a chunk; style_adain_bwd_apply
// merges them (d s = sum g xhat, d b = sum g; block 0 writes both) and
// writes dx = (r (s + 1)) (g - mean g - xhat mean(g xhat)) * act'(y0), and
// each chunk's sums of dx * noise and of dx, which the caller adds over n
// and the chunks (d strength, d bias). Every sum runs in a fixed order:
// two calls agree bit for bit. Loads are 16 bytes where W is a multiple of
// 4 (every row then starts 16-byte aligned), else one element.
//
// style_blur4 / style_blur: y = blur(x), the depthwise [1, 2, 1]^T [1, 2,
// 1] / 16 with a zero border of one, four outputs a thread where W % 4 ==
// 0 (16-byte loads and stores), else one: the rows' sums (x[w - 1] + 2
// x[w]) + x[w + 1], then (v[h - 1] + 2 v[h]) + v[h + 1], times 1 / 16, the
// plain twin's order (ops/style.py), so the two agree bit for bit. The
// kernel is symmetric, so the blur is its own transpose: its gradient is a
// blur again.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

struct Plane {
  long long sN, sC, sH;
  int C, H, W;
};

__device__ __forceinline__ long long base_of(const Plane& L, int p) {
  const int n = p / L.C, c = p - (p / L.C) * L.C;
  return n * L.sN + c * L.sC;
}

// The plane's chunk s of S: rows [h0, h1).
__device__ __forceinline__ void chunk_rows(int H, int S, int s, int& h0,
                                           int& h1) {
  h0 = (int)((long long)s * H / S);
  h1 = (int)((long long)(s + 1) * H / S);
}

// Sum of two floats over the block, in a fixed order; the result in lane 0
// of warp 0 (and returned to every thread).
__device__ __forceinline__ float2 block_sum2(float2 v) {
  __shared__ float2 warp_sums[kMaxThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, o);
    v.y += __shfl_down_sync(0xffffffffu, v.y, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
    const int warps = (blockDim.x + 31) >> 5;
    for (int i = 0; i < warps; ++i) {
      t.x += warp_sums[i].x;
      t.y += warp_sums[i].y;
    }
  }
  return t;
}

__device__ __forceinline__ float act(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// Visit every element of rows [h0, h1) of a plane: f(offset in the plane's
// layout, offset in noise), four at a time where W % 4 == 0.
template <bool kVec, typename F>
__device__ __forceinline__ void for_rows(const Plane& L, int h0, int h1,
                                         F&& f) {
  const int per_row = kVec ? L.W / 4 : L.W;
  const long long count = (long long)(h1 - h0) * per_row;
  for (long long e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = (int)(e / per_row);
    const int j = (int)(e - (long long)r * per_row);
    const int h = h0 + r;
    const int w = kVec ? 4 * j : j;
    f(h * L.sH + w, (long long)h * L.W + w);
  }
}

template <bool kVec>
__global__ void style_adain_stats(const float* __restrict__ x,
                                  const float* __restrict__ noise,
                                  const float* __restrict__ strength,
                                  const float* __restrict__ bias,
                                  float2* __restrict__ part, Plane L, int S,
                                  float slope) {
  const int p = blockIdx.x / S, s = blockIdx.x - (blockIdx.x / S) * S;
  const int n = p / L.C, c = p - n * L.C;
  const long long base = base_of(L, p);
  const float* nz = noise + (long long)n * L.H * L.W;
  const float st = strength[c], bi = bias[c];
  const float K = act(x[base] + st * nz[0] + bi, slope);
  int h0, h1;
  chunk_rows(L.H, S, s, h0, h1);
  float2 acc = make_float2(0.f, 0.f);
  for_rows<kVec>(L, h0, h1, [&](long long o, long long on) {
    if (kVec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + base + o));
      const float4 z = __ldg(reinterpret_cast<const float4*>(nz + on));
      const float d0 = act(v.x + st * z.x + bi, slope) - K;
      const float d1 = act(v.y + st * z.y + bi, slope) - K;
      const float d2 = act(v.z + st * z.z + bi, slope) - K;
      const float d3 = act(v.w + st * z.w + bi, slope) - K;
      acc.x += (d0 + d1) + (d2 + d3);
      acc.y += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    } else {
      const float d = act(__ldg(x + base + o) + st * __ldg(nz + on) + bi,
                          slope) - K;
      acc.x += d;
      acc.y += d * d;
    }
  });
  const float2 t = block_sum2(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = t;
}

// (mean, rsqrt) of plane p from its S partials, in f64, in chunk order.
__device__ __forceinline__ void plane_stats(const float2* part, int p, int S,
                                            float K, long long M, float eps,
                                            float& mu, float& r) {
  double s1 = 0.0, s2 = 0.0;
  for (int i = 0; i < S; ++i) {
    const float2 v = part[(long long)p * S + i];
    s1 += v.x;
    s2 += v.y;
  }
  const double md = s1 / (double)M;
  const double var = fmax(s2 / (double)M - md * md, 0.0);
  mu = (float)((double)K + md);
  r = (float)(1.0 / sqrt(var + (double)eps));
}

template <bool kVec>
__global__ void style_adain_apply(const float* __restrict__ x,
                                  const float* __restrict__ noise,
                                  const float* __restrict__ strength,
                                  const float* __restrict__ bias,
                                  const float* __restrict__ style,
                                  const float2* __restrict__ part,
                                  float* __restrict__ y,
                                  float2* __restrict__ stats, Plane L, int S,
                                  float slope, float eps) {
  const int p = blockIdx.x / S, s = blockIdx.x - (blockIdx.x / S) * S;
  const int n = p / L.C, c = p - n * L.C;
  const long long base = base_of(L, p);
  const float* nz = noise + (long long)n * L.H * L.W;
  const float st = strength[c], bi = bias[c];
  const float K = act(x[base] + st * nz[0] + bi, slope);
  float mu, r;
  plane_stats(part, p, S, K, (long long)L.H * L.W, eps, mu, r);
  if (s == 0 && threadIdx.x == 0) stats[p] = make_float2(mu, r);
  const float scale = style[(long long)n * 2 * L.C + c] + 1.f;
  const float shift = style[(long long)n * 2 * L.C + L.C + c];
  int h0, h1;
  chunk_rows(L.H, S, s, h0, h1);
  for_rows<kVec>(L, h0, h1, [&](long long o, long long on) {
    if (kVec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + base + o));
      const float4 z = __ldg(reinterpret_cast<const float4*>(nz + on));
      float4 out;
      out.x = (act(v.x + st * z.x + bi, slope) - mu) * r * scale + shift;
      out.y = (act(v.y + st * z.y + bi, slope) - mu) * r * scale + shift;
      out.z = (act(v.z + st * z.z + bi, slope) - mu) * r * scale + shift;
      out.w = (act(v.w + st * z.w + bi, slope) - mu) * r * scale + shift;
      *reinterpret_cast<float4*>(y + base + o) = out;
    } else {
      y[base + o] = (act(__ldg(x + base + o) + st * __ldg(nz + on) + bi,
                         slope) - mu) * r * scale + shift;
    }
  });
}

template <bool kVec>
__global__ void style_adain_bwd_stats(const float* __restrict__ x,
                                      const float* __restrict__ noise,
                                      const float* __restrict__ strength,
                                      const float* __restrict__ bias,
                                      const float2* __restrict__ stats,
                                      const float* __restrict__ g,
                                      float2* __restrict__ part, Plane L,
                                      int S, float slope) {
  const int p = blockIdx.x / S, s = blockIdx.x - (blockIdx.x / S) * S;
  const int n = p / L.C, c = p - n * L.C;
  const long long base = base_of(L, p);
  const float* nz = noise + (long long)n * L.H * L.W;
  const float st = strength[c], bi = bias[c];
  const float2 mr = stats[p];
  int h0, h1;
  chunk_rows(L.H, S, s, h0, h1);
  float2 acc = make_float2(0.f, 0.f);
  for_rows<kVec>(L, h0, h1, [&](long long o, long long on) {
    if (kVec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + base + o));
      const float4 z = __ldg(reinterpret_cast<const float4*>(nz + on));
      const float4 gg = __ldg(reinterpret_cast<const float4*>(g + base + o));
      const float x0 = (act(v.x + st * z.x + bi, slope) - mr.x) * mr.y;
      const float x1 = (act(v.y + st * z.y + bi, slope) - mr.x) * mr.y;
      const float x2 = (act(v.z + st * z.z + bi, slope) - mr.x) * mr.y;
      const float x3 = (act(v.w + st * z.w + bi, slope) - mr.x) * mr.y;
      acc.x += (gg.x + gg.y) + (gg.z + gg.w);
      acc.y += (gg.x * x0 + gg.y * x1) + (gg.z * x2 + gg.w * x3);
    } else {
      const float xh = (act(__ldg(x + base + o) + st * __ldg(nz + on) + bi,
                            slope) - mr.x) * mr.y;
      const float gv = __ldg(g + base + o);
      acc.x += gv;
      acc.y += gv * xh;
    }
  });
  const float2 t = block_sum2(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = t;
}

template <bool kVec>
__global__ void style_adain_bwd_apply(
    const float* __restrict__ x, const float* __restrict__ noise,
    const float* __restrict__ strength, const float* __restrict__ bias,
    const float* __restrict__ style, const float2* __restrict__ stats,
    const float* __restrict__ g, const float2* __restrict__ part,
    float* __restrict__ dx, float* __restrict__ dstyle,
    float2* __restrict__ dsb, Plane L, int S, float slope) {
  const int p = blockIdx.x / S, s = blockIdx.x - (blockIdx.x / S) * S;
  const int n = p / L.C, c = p - n * L.C;
  const long long base = base_of(L, p);
  const float* nz = noise + (long long)n * L.H * L.W;
  const float st = strength[c], bi = bias[c];
  const float2 mr = stats[p];
  double sg = 0.0, sgx = 0.0;
  for (int i = 0; i < S; ++i) {
    const float2 v = part[(long long)p * S + i];
    sg += v.x;
    sgx += v.y;
  }
  if (s == 0 && threadIdx.x == 0) {
    dstyle[(long long)n * 2 * L.C + c] = (float)sgx;
    dstyle[(long long)n * 2 * L.C + L.C + c] = (float)sg;
  }
  const double M = (double)L.H * L.W;
  const float scale = style[(long long)n * 2 * L.C + c] + 1.f;
  const float k = mr.y * scale;
  const float mg = (float)(sg / M), mgx = (float)(sgx / M);
  int h0, h1;
  chunk_rows(L.H, S, s, h0, h1);
  float2 acc = make_float2(0.f, 0.f);
  auto one = [&](float xv, float zv, float gv) {
    const float y0 = xv + st * zv + bi;
    const float xh = (act(y0, slope) - mr.x) * mr.y;
    const float d = k * ((gv - mg) - xh * mgx) * (y0 >= 0.f ? 1.f : slope);
    acc.x += d * zv;
    acc.y += d;
    return d;
  };
  for_rows<kVec>(L, h0, h1, [&](long long o, long long on) {
    if (kVec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + base + o));
      const float4 z = __ldg(reinterpret_cast<const float4*>(nz + on));
      const float4 gg = __ldg(reinterpret_cast<const float4*>(g + base + o));
      float4 out;
      out.x = one(v.x, z.x, gg.x);
      out.y = one(v.y, z.y, gg.y);
      out.z = one(v.z, z.z, gg.z);
      out.w = one(v.w, z.w, gg.w);
      *reinterpret_cast<float4*>(dx + base + o) = out;
    } else {
      dx[base + o] = one(__ldg(x + base + o), __ldg(nz + on),
                         __ldg(g + base + o));
    }
  });
  const float2 t = block_sum2(acc);
  if (threadIdx.x == 0) dsb[blockIdx.x] = t;
}

// One thread per output; any W.
__global__ void style_blur(const float* __restrict__ x, float* __restrict__ y,
                           Plane L, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int w = (int)(i % L.W);
  const long long q = i / L.W;
  const int h = (int)(q % L.H);
  const int p = (int)(q / L.H);
  const long long base = base_of(L, p);
  float v[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int hh = h + a - 1;
    if (hh < 0 || hh >= L.H) {
      v[a] = 0.f;
      continue;
    }
    const float* row = x + base + hh * L.sH;
    const float l = w > 0 ? __ldg(row + w - 1) : 0.f;
    const float m = __ldg(row + w);
    const float r = w + 1 < L.W ? __ldg(row + w + 1) : 0.f;
    v[a] = (l + 2.f * m) + r;
  }
  y[base + h * L.sH + w] = ((v[0] + 2.f * v[1]) + v[2]) * 0.0625f;
}

// Four neighbouring outputs a thread (W % 4 == 0): each of the three input
// rows as one 16-byte load and its two outer neighbours, one 16-byte
// store; 32-bit index math (fewer than 2^31 vectors).
__global__ void style_blur4(const float* __restrict__ x, float* __restrict__ y,
                            Plane L, unsigned total) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const unsigned vw = (unsigned)L.W / 4;
  const unsigned q = i / vw;
  const int w = (int)(i - q * vw) * 4;
  const unsigned p = q / (unsigned)L.H;
  const int h = (int)(q - p * (unsigned)L.H);
  const long long base = base_of(L, (int)p);
  float v[3][4];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int hh = h + a - 1;
    if (hh < 0 || hh >= L.H) {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[a][k] = 0.f;
      continue;
    }
    const float* row = x + base + (long long)hh * L.sH + w;
    const float4 m = __ldg(reinterpret_cast<const float4*>(row));
    const float l = w > 0 ? __ldg(row - 1) : 0.f;
    const float r = w + 4 < L.W ? __ldg(row + 4) : 0.f;
    v[a][0] = (l + 2.f * m.x) + m.y;
    v[a][1] = (m.x + 2.f * m.y) + m.z;
    v[a][2] = (m.y + 2.f * m.z) + m.w;
    v[a][3] = (m.z + 2.f * m.w) + r;
  }
  float4 out;
  out.x = ((v[0][0] + 2.f * v[1][0]) + v[2][0]) * 0.0625f;
  out.y = ((v[0][1] + 2.f * v[1][1]) + v[2][1]) * 0.0625f;
  out.z = ((v[0][2] + 2.f * v[1][2]) + v[2][2]) * 0.0625f;
  out.w = ((v[0][3] + 2.f * v[1][3]) + v[2][3]) * 0.0625f;
  *reinterpret_cast<float4*>(y + base + (long long)h * L.sH + w) = out;
}

int threads_for(long long per_block) {
  long long t = (per_block + 3) / 4;  // at least four items a thread
  t = (t + 31) / 32 * 32;
  return (int)(t < 32 ? 32 : t > kMaxThreads ? kMaxThreads : t);
}

Plane plane(int C, int H, int W, long long sN, long long sC, long long sH) {
  Plane L;
  L.sN = sN;
  L.sC = sC;
  L.sH = sH;
  L.C = C;
  L.H = H;
  L.W = W;
  return L;
}

}  // namespace

// Forward. x, y: (n, c, h, w) at n sN + c sC + h sH + w; noise (N, H, W);
// strength, bias (C); style (N, 2C); part (N C S) float2 scratch; stats
// (N C) float2 out: each plane's (mean, rsqrt).
extern "C" int pggan_style_adain(const float* x, const float* noise,
                                 const float* strength, const float* bias,
                                 const float* style, float* y, float* stats,
                                 float* part, int N, int C, int H, int W,
                                 long long sN, long long sC, long long sH,
                                 int S, float slope, float eps,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plane L = plane(C, H, W, sN, sC, sH);
  const unsigned blocks = (unsigned)((long long)N * C * S);
  const bool vec = W % 4 == 0;
  const long long per = (long long)(H / S + 1) * (vec ? W / 4 : W);
  const int t = threads_for(per);
  auto* pt = reinterpret_cast<float2*>(part);
  auto* sp = reinterpret_cast<float2*>(stats);
  if (vec) {
    style_adain_stats<true><<<blocks, t, 0, st>>>(x, noise, strength, bias,
                                                  pt, L, S, slope);
    style_adain_apply<true><<<blocks, t, 0, st>>>(
        x, noise, strength, bias, style, pt, y, sp, L, S, slope, eps);
  } else {
    style_adain_stats<false><<<blocks, t, 0, st>>>(x, noise, strength, bias,
                                                   pt, L, S, slope);
    style_adain_apply<false><<<blocks, t, 0, st>>>(
        x, noise, strength, bias, style, pt, y, sp, L, S, slope, eps);
  }
  return (int)cudaGetLastError();
}

// Backward. g, dx in x's layout; dstyle (N, 2C) out: d s, d b; dsb (N C S)
// float2 out: each chunk's sums of dx * noise and of dx; part scratch.
extern "C" int pggan_style_adain_bwd(const float* x, const float* noise,
                                     const float* strength,
                                     const float* bias, const float* style,
                                     const float* stats, const float* g,
                                     float* dx, float* dstyle, float* dsb,
                                     float* part, int N, int C, int H, int W,
                                     long long sN, long long sC, long long sH,
                                     int S, float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plane L = plane(C, H, W, sN, sC, sH);
  const unsigned blocks = (unsigned)((long long)N * C * S);
  const bool vec = W % 4 == 0;
  const long long per = (long long)(H / S + 1) * (vec ? W / 4 : W);
  const int t = threads_for(per);
  auto* pt = reinterpret_cast<float2*>(part);
  auto* sp = reinterpret_cast<const float2*>(stats);
  auto* ds = reinterpret_cast<float2*>(dsb);
  if (vec) {
    style_adain_bwd_stats<true><<<blocks, t, 0, st>>>(
        x, noise, strength, bias, sp, g, pt, L, S, slope);
    style_adain_bwd_apply<true><<<blocks, t, 0, st>>>(
        x, noise, strength, bias, style, sp, g, pt, dx, dstyle, ds, L, S,
        slope);
  } else {
    style_adain_bwd_stats<false><<<blocks, t, 0, st>>>(
        x, noise, strength, bias, sp, g, pt, L, S, slope);
    style_adain_bwd_apply<false><<<blocks, t, 0, st>>>(
        x, noise, strength, bias, style, sp, g, pt, dx, dstyle, ds, L, S,
        slope);
  }
  return (int)cudaGetLastError();
}

// y = blur(x); both in the layout (sN, sC, sH), W contiguous.
extern "C" int pggan_style_blur(const float* x, float* y, int N, int C,
                                int H, int W, long long sN, long long sC,
                                long long sH, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plane L = plane(C, H, W, sN, sC, sH);
  const long long total = (long long)N * C * H * W;
  if (W % 4 == 0 && total / 4 < (1LL << 31)) {
    const unsigned vectors = (unsigned)(total / 4);
    const unsigned blocks = (vectors + kMaxThreads - 1) / kMaxThreads;
    style_blur4<<<blocks, kMaxThreads, 0, st>>>(x, y, L, vectors);
  } else {
    const long long blocks = (total + kMaxThreads - 1) / kMaxThreads;
    style_blur<<<(unsigned)blocks, kMaxThreads, 0, st>>>(x, y, L, total);
  }
  return (int)cudaGetLastError();
}
