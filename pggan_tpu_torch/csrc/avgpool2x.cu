// 2x2 stride-2 average pool, (N, H, C, W) -> (N, H/2, C, W/2), f32; H and W
// even.
//
// Replaces the TPU kernel pggan_tpu/ops/pallas_resample.py:avgpool2x_nhcw
// (body _pool_kernel). On the TPU the lane halving ran as an MXU dot against
// a constant pair-sum matrix at HIGHEST precision, because Mosaic cannot
// gather every other lane; here each thread reads its lanes directly.
//
// Bound: bytes. Each output element reads four inputs and writes one, 20
// bytes and three adds. Design: when W is a multiple of 4 and x is 16-byte
// aligned, one thread per output pair: a 16-byte load from each of the two
// input rows 2i and 2i+1 (columns 4j..4j+3) and one 8-byte store,
// neighbouring threads on neighbouring addresses. Otherwise (ragged W, or a
// view at an unaligned offset) one thread per output with 4-byte loads. The
// sum order is fixed and the same as the plain version's and the TPU
// kernel's: 0.25 * ((x[2i][2j] + x[2i+1][2j]) +
// (x[2i][2j+1] + x[2i+1][2j+1])), so the output equals both bit for bit
// (three adds and a multiply by a power of two: nothing to contract).
//
// Output row r = (n * Ho + i) * C + c reads input rows
// (2 * (n * Ho + i) + a) * C + c for a in {0, 1}, Ho = H / 2.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float pool4(float a0, float a1, float b0,
                                       float b1) {
  // a: row 2i, b: row 2i+1; columns 2j, 2j+1
  return ((a0 + b0) + (a1 + b1)) * 0.25f;
}

__global__ void avgpool2x_quads(const float4* __restrict__ x,
                                float2* __restrict__ y, long long rows, int C,
                                int quarter_w) {
  long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= rows * quarter_w) return;
  long long r = i / quarter_w;  // output row
  int j = (int)(i - r * quarter_w);
  long long nh = r / C;
  long long c = r - nh * C;
  // input row 2*nh*C + c holds W floats = quarter_w float4s
  long long in0 = (2 * nh * C + c) * quarter_w + j;
  float4 a = __ldg(x + in0);
  float4 b = __ldg(x + in0 + (long long)C * quarter_w);
  y[i] = make_float2(pool4(a.x, a.y, b.x, b.y), pool4(a.z, a.w, b.z, b.w));
}

__global__ void avgpool2x_single(const float* __restrict__ x,
                                 float* __restrict__ y, long long rows, int C,
                                 int half_w) {
  long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= rows * half_w) return;
  long long r = i / half_w;
  int j = (int)(i - r * half_w);
  long long nh = r / C;
  long long c = r - nh * C;
  const float* a = x + (2 * nh * C + c) * (2LL * half_w) + 2 * j;
  const float* b = a + (long long)C * 2 * half_w;
  y[i] = pool4(__ldg(a), __ldg(a + 1), __ldg(b), __ldg(b + 1));
}

}  // namespace

// x (N, H, C, W) with H, W even; y (N, H/2, C, W/2).
extern "C" int pggan_avgpool2x(const float* x, float* y, int N, int H, int C,
                               int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  long long rows = (long long)N * (H / 2) * C;  // output rows
  // y comes from torch.empty (aligned); x may be a view at any offset
  if (W % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0) {
    long long total = rows * (W / 4);
    long long blocks = (total + kThreads - 1) / kThreads;
    avgpool2x_quads<<<(unsigned)blocks, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float2*>(y),
        rows, C, W / 4);
  } else {
    long long total = rows * (W / 2);
    long long blocks = (total + kThreads - 1) / kThreads;
    avgpool2x_single<<<(unsigned)blocks, kThreads, 0, s>>>(x, y, rows, C,
                                                          W / 2);
  }
  return (int)cudaGetLastError();
}
