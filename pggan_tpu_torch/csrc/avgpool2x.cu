// 2x2 stride-2 average pool, (N, H, C, W) -> (N, H/2, C, W/2), f32 or bf16;
// H and W even.
//
// Replaces the TPU kernel pggan_tpu/ops/pallas_resample.py:avgpool2x_nhcw
// (body _pool_kernel). On the TPU the lane halving ran as an MXU dot against
// a constant pair-sum matrix at HIGHEST precision, because Mosaic cannot
// gather every other lane; here each thread reads its lanes directly. The
// TPU kernel is f32 only; the bf16 instantiation serves the port's bf16
// models, whose NCHW pools (and the upsample's transpose) run here.
//
// Bound: bytes. Each output element reads four inputs and writes one: 20
// bytes in f32, 10 in bf16, and three adds. Design: when W is a multiple of
// the 16-byte vector (4 f32 or 8 bf16 values) and x is 16-byte aligned, one
// thread per vector: a 16-byte load from each of the two input rows 2i and
// 2i+1 and one 8-byte store of half as many outputs, neighbouring threads on
// neighbouring addresses. Otherwise (ragged W, or a view at an unaligned
// offset) one thread per output, reading each row's pair as one 4-byte load
// (one value at a time in f32, and in bf16 where x is not 4-byte aligned).
//
// The sums are taken in a fixed order, the same as the plain version's, so
// the output equals it bit for bit (adds and a multiply by a power of two:
// nothing to contract). f32, as the TPU kernel: 0.25 * ((x[2i][2j] +
// x[2i+1][2j]) + (x[2i][2j+1] + x[2i+1][2j+1])). bf16, as the JAX package's
// bf16 pool (a reduce_window over the window in row order, each add
// rounded to bf16): ((x[2i][2j] + x[2i][2j+1]) + x[2i+1][2j]) +
// x[2i+1][2j+1], each add in f32 and rounded to bf16 with
// __float2bfloat16_rn, then times 0.25. Rounding once instead would be
// within one bf16 ulp of it, but those ulps, passed on through the convs,
// put the bf16 D outside the quarter bar of tests/test_torch_port_bf16.py
// against JAX's bf16 D.

// Output row r = (n * Ho + i) * C + c reads input rows
// (2 * (n * Ho + i) + a) * C + c for a in {0, 1}, Ho = H / 2.

#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a: row 2i, b: row 2i+1; columns 2j, 2j+1; in f32 or bf16 (as f32)
__device__ __forceinline__ float pool4(float a0, float a1, float b0, float b1,
                                       float* /*f32*/) {
  return ((a0 + b0) + (a1 + b1)) * 0.25f;
}
__device__ __forceinline__ float pool4(float a0, float a1, float b0, float b1,
                                       __nv_bfloat16* /*bf16*/) {
  return bf16_round(bf16_round(bf16_round(a0 + a1) + b0) + b1) * 0.25f;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void round_to(float v, float* out) { *out = v; }
__device__ __forceinline__ void round_to(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// A row's two neighbouring values (columns 2j, 2j+1) in f32.
__device__ __forceinline__ void load_pair(const float* p, bool /*paired*/,
                                          float& v0, float& v1) {
  v0 = __ldg(p);
  v1 = __ldg(p + 1);
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, bool paired,
                                          float& v0, float& v1) {
  if (paired) {  // one 4-byte load
    const __nv_bfloat162 q =
        __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
    v0 = __low2float(q);
    v1 = __high2float(q);
  } else {
    v0 = __bfloat162float(__ldg(p));
    v1 = __bfloat162float(__ldg(p + 1));
  }
}

// One thread per 16-byte vector of V = 16 / sizeof(T) inputs of a row:
// V / 2 outputs, stored as 8 bytes. vw = W / V vectors a row.
template <typename T>
__global__ void avgpool2x_vec(const uint4* __restrict__ x, T* __restrict__ y,
                              long long rows, int C, int vw) {
  constexpr int V = 16 / sizeof(T);
  long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= rows * vw) return;
  long long r = i / vw;  // output row
  int j = (int)(i - r * vw);
  long long nh = r / C;
  long long c = r - nh * C;
  long long in0 = (2 * nh * C + c) * vw + j;
  const uint4 a = __ldg(x + in0);
  const uint4 b = __ldg(x + in0 + (long long)C * vw);
  T pa[V], pb[V], out[V / 2];
  memcpy(pa, &a, 16);
  memcpy(pb, &b, 16);
#pragma unroll
  for (int k = 0; k < V / 2; ++k) {
    round_to(pool4(to_f32(pa[2 * k]), to_f32(pa[2 * k + 1]),
                   to_f32(pb[2 * k]), to_f32(pb[2 * k + 1]), &out[k]),
             &out[k]);
  }
  uint2 u;
  memcpy(&u, out, 8);
  reinterpret_cast<uint2*>(y)[i] = u;
}

template <typename T>
__global__ void avgpool2x_single(const T* __restrict__ x, T* __restrict__ y,
                                 long long rows, int C, int half_w,
                                 bool paired) {
  long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= rows * half_w) return;
  long long r = i / half_w;
  int j = (int)(i - r * half_w);
  long long nh = r / C;
  long long c = r - nh * C;
  const T* a = x + (2 * nh * C + c) * (2LL * half_w) + 2 * j;
  const T* b = a + (long long)C * 2 * half_w;
  float a0, a1, b0, b1;
  load_pair(a, paired, a0, a1);
  load_pair(b, paired, b0, b1);
  round_to(pool4(a0, a1, b0, b1, y + i), y + i);
}

template <typename T>
int pool(const T* x, T* y, int N, int H, int C, int W, void* stream) {
  constexpr int V = 16 / sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  long long rows = (long long)N * (H / 2) * C;  // output rows
  // y comes from torch.empty (aligned); x may be a view at any offset
  const std::uintptr_t addr = reinterpret_cast<std::uintptr_t>(x);
  if (W % V == 0 && addr % 16 == 0) {
    long long total = rows * (W / V);
    long long blocks = (total + kThreads - 1) / kThreads;
    avgpool2x_vec<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        reinterpret_cast<const uint4*>(x), y, rows, C, W / V);
  } else {
    long long total = rows * (W / 2);
    long long blocks = (total + kThreads - 1) / kThreads;
    avgpool2x_single<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        x, y, rows, C, W / 2, addr % 4 == 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, C, W) with H, W even; y (N, H/2, C, W/2).
extern "C" int pggan_avgpool2x(const float* x, float* y, int N, int H, int C,
                               int W, void* stream) {
  return pool<float>(x, y, N, H, C, W, stream);
}

extern "C" int pggan_avgpool2x_bf16(const __nv_bfloat16* x, __nv_bfloat16* y,
                                    int N, int H, int C, int W,
                                    void* stream) {
  return pool<__nv_bfloat16>(x, y, N, H, C, W, stream);
}
