// Nearest-neighbour 2x upsample, (N, H, C, W) -> (N, 2H, C, 2W), f32.
//
// Replaces the TPU kernel pggan_tpu/ops/pallas_resample.py:upsample2x_nhcw
// (body _up_kernel). On the TPU the lane doubling ran as an MXU dot against
// a constant pairing matrix because Mosaic cannot interleave lanes; here it
// is a plain copy.
//
// Bound: bytes. Each input element is read once and written four times, so
// the kernel moves 5 * 4 bytes per input element and does no arithmetic.
// Design: a 2-D grid, input rows r = (n * H + h) * C + c on x in a fixed
// count per block and W chunks on y. A block's 256 threads are 2^lx
// columns by 256 / 2^lx rows (lx from W), and each thread moves kE vectors
// of one row, 2^lx vectors apart, so every load and store instruction of a
// warp covers neighbouring addresses. When W is even and x is 8-byte
// aligned, a vector is an input pair (8-byte load) written as one 16-byte
// store (a, a, b, b) into each of the output rows 2h and 2h + 1; otherwise
// (odd W, a view at an odd offset) one element written as an 8-byte store
// into each. A thread issues its kE loads before its stores. Index math is
// 32-bit within a row; a thread divides once (r / C, 32 bits).
// It runs at 83-86% of the bytes bound at the serve's shapes (chip_smoke.py
// phase 3, calls back to back); no device-time gain over the previous
// kernel (one pair a thread, a 1-D grid, two 64-bit divisions a thread)
// was measured. 16-byte loads were slower in tuning: each lane then writes
// two 16-byte stores 32 bytes apart, so every store instruction fills half
// of each sector it touches.
// Nothing is computed, so the output equals the plain version bit for bit.
//
// Input row r lands on output rows (2 * (n * H + h) + a) * C + c = r +
// (r / C + a) * C for a in {0, 1}.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kE = 2;  // vectors a thread moves

__device__ __forceinline__ void put(float4* y, float2 v) {
  *y = make_float4(v.x, v.x, v.y, v.y);
}

__device__ __forceinline__ void put(float2* y, float v) {
  *y = make_float2(v, v);
}

// In: float2 (Out float4) or float (Out float2); wv input vectors a row,
// and as many output vectors an output row; rows = N * H * C
template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
upsample2x_rows(const In* __restrict__ x, Out* __restrict__ y, int rows,
                int C, int wv, int lx) {
  const int tx = threadIdx.x & ((1 << lx) - 1);
  const int r = blockIdx.x * (kThreads >> lx) + (threadIdx.x >> lx);
  if (r >= rows) return;
  const int nh = r / C;
  const In* xr = x + (long long)r * wv;
  Out* y0 = y + ((long long)r + (long long)nh * C) * wv;  // row 2h
  Out* y1 = y0 + (long long)C * wv;                       // row 2h + 1
  const int j0 = blockIdx.y * (kE << lx) + tx;
  In v[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int j = j0 + (e << lx);
    if (j < wv) v[e] = __ldg(xr + j);
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int j = j0 + (e << lx);
    if (j < wv) {
      put(y0 + j, v[e]);
      put(y1 + j, v[e]);
    }
  }
}

}  // namespace

extern "C" int pggan_upsample2x(const float* x, float* y, int N, int H, int C,
                                int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)N * H * C;
  if (rows > INT_MAX || C < 1) return (int)cudaErrorInvalidValue;
  // y comes from torch.empty (aligned); x may be a view at any offset
  const bool v2 = W % 2 == 0 && reinterpret_cast<std::uintptr_t>(x) % 8 == 0;
  const int wv = v2 ? W / 2 : W;
  int lx = 0;  // 2^lx columns of threads: enough for wv in kE passes
  while (lx < 8 && (kE << lx) < wv) ++lx;
  const int rows_per_block = kThreads >> lx;
  dim3 grid((unsigned)((rows + rows_per_block - 1) / rows_per_block),
            (unsigned)((wv + (kE << lx) - 1) / (kE << lx)));
  if (v2) {
    upsample2x_rows<float2, float4><<<grid, kThreads, 0, s>>>(
        reinterpret_cast<const float2*>(x), reinterpret_cast<float4*>(y),
        (int)rows, C, wv, lx);
  } else {
    upsample2x_rows<float, float2><<<grid, kThreads, 0, s>>>(
        x, reinterpret_cast<float2*>(y), (int)rows, C, wv, lx);
  }
  return (int)cudaGetLastError();
}

// The library's one error-text helper, for the wrappers' exceptions.
extern "C" const char* pggan_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
