// Nearest-neighbour 2x upsample, (N, H, C, W) -> (N, 2H, C, 2W), f32.
//
// Replaces the TPU kernel pggan_tpu/ops/pallas_resample.py:upsample2x_nhcw
// (body _up_kernel). On the TPU the lane doubling ran as an MXU dot against
// a constant pairing matrix because Mosaic cannot interleave lanes; here it
// is a plain copy.
//
// Bound: bytes. Each input element is read once and written four times, so
// the kernel moves 5 * 4 bytes per input element and does no arithmetic.
// Design: when W is even, one thread per input pair (x[w], x[w+1]): one
// 8-byte load and two 16-byte stores (a, a, b, b) into output rows 2h and
// 2h+1, neighbouring threads on neighbouring addresses. Odd W takes a
// one-element-per-thread variant with 8-byte stores. Nothing is computed,
// so the output equals the plain version bit for bit.
//
// Input row r = (n * H + h) * C + c lands on output rows
// (2 * (n * H + h) + a) * C + c for a in {0, 1}.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void upsample2x_pairs(const float2* __restrict__ x,
                                 float4* __restrict__ y, long long rows,
                                 int C, int half_w) {
  long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= rows * half_w) return;
  long long r = i / half_w;
  int j = (int)(i - r * half_w);
  long long nh = r / C;
  long long c = r - nh * C;
  float2 v = __ldg(x + i);
  float4 o = make_float4(v.x, v.x, v.y, v.y);
  long long out0 = (2 * nh * C + c) * half_w + j;  // row 2h: 2W floats = half_w float4s
  y[out0] = o;
  y[out0 + (long long)C * half_w] = o;             // row 2h + 1
}

__global__ void upsample2x_single(const float* __restrict__ x,
                                  float2* __restrict__ y, long long rows,
                                  int C, int W) {
  long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= rows * W) return;
  long long r = i / W;
  int j = (int)(i - r * W);
  long long nh = r / C;
  long long c = r - nh * C;
  float v = __ldg(x + i);
  float2 o = make_float2(v, v);
  long long out0 = (2 * nh * C + c) * W + j;  // row 2h: 2W floats = W float2s
  y[out0] = o;
  y[out0 + (long long)C * W] = o;
}

}  // namespace

extern "C" int pggan_upsample2x(const float* x, float* y, int N, int H, int C,
                                int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long rows = (long long)N * H * C;
  // y comes from torch.empty (aligned); x may be a view at an odd offset
  if (W % 2 == 0 && reinterpret_cast<std::uintptr_t>(x) % 8 == 0) {
    long long total = rows * (W / 2);
    long long blocks = (total + kThreads - 1) / kThreads;
    upsample2x_pairs<<<(unsigned)blocks, kThreads, 0, s>>>(
        reinterpret_cast<const float2*>(x), reinterpret_cast<float4*>(y),
        rows, C, W / 2);
  } else {
    long long total = rows * W;
    long long blocks = (total + kThreads - 1) / kThreads;
    upsample2x_single<<<(unsigned)blocks, kThreads, 0, s>>>(
        x, reinterpret_cast<float2*>(y), rows, C, W);
  }
  return (int)cudaGetLastError();
}

// The library's one error-text helper, for the wrappers' exceptions.
extern "C" const char* pggan_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
