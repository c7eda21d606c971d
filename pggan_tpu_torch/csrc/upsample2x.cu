// Nearest-neighbour 2x upsample, (N, H, C, W) -> (N, 2H, C, 2W), f32 or
// bf16.
//
// Replaces the TPU kernel pggan_tpu/ops/pallas_resample.py:upsample2x_nhcw
// (body _up_kernel). On the TPU the lane doubling ran as an MXU dot against
// a constant pairing matrix because Mosaic cannot interleave lanes; here it
// is a plain copy. The TPU kernel is f32 only; the bf16 instantiation serves
// the port's bf16 models (G's fade and the pool's transpose).
//
// Bound: bytes. Each input element is read once and written four times, so
// the kernel moves 5 * 4 bytes per input element in f32 (5 * 2 in bf16) and
// does no arithmetic.
// Design: a 2-D grid, input rows r = (n * H + h) * C + c on x in a fixed
// count per block and W chunks on y. A block's 256 threads are 2^lx
// columns by 256 / 2^lx rows (lx from W), and each thread moves kE vectors
// of one row, 2^lx vectors apart, so every load and store instruction of a
// warp covers neighbouring addresses. When W is even and x is 8-byte
// aligned, a vector is an input pair (8-byte load) written as one 16-byte
// store (a, a, b, b) into each of the output rows 2h and 2h + 1; otherwise
// (odd W, a view at an odd offset) one element written as an 8-byte store
// into each. In bf16 the same with twice the values: when W is a multiple
// of 4 and x is 8-byte aligned, four inputs (8-byte load) as one 16-byte
// store (a, a, b, b, c, c, d, d), each word doubled by a byte permute;
// otherwise one element written as a 4-byte store (a, a). A thread issues its kE loads before its stores. Index math is
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

#include <cuda_bf16.h>
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

// four bf16 values (two words: a | b << 16, c | d << 16) -> eight
__device__ __forceinline__ void put(uint4* y, uint2 v) {
  *y = make_uint4(__byte_perm(v.x, 0, 0x1010), __byte_perm(v.x, 0, 0x3232),
                  __byte_perm(v.y, 0, 0x1010), __byte_perm(v.y, 0, 0x3232));
}

__device__ __forceinline__ void put(__nv_bfloat162* y, __nv_bfloat16 v) {
  *y = __halves2bfloat162(v, v);
}

// The vectors of element type T: a vector of kWide inputs and its doubled
// output, and the single element and its pair.
template <typename T>
struct Vectors;
template <>
struct Vectors<float> {
  using Wide = float2;
  using WideOut = float4;
  using One = float;
  using OneOut = float2;
  static constexpr int kWide = 2;
};
template <>
struct Vectors<__nv_bfloat16> {
  using Wide = uint2;
  using WideOut = uint4;
  using One = __nv_bfloat16;
  using OneOut = __nv_bfloat162;
  static constexpr int kWide = 4;
};

// In: a wide vector (Out its doubled output) or one element (Out its pair);
// wv input vectors a row, and as many output vectors an output row;
// rows = N * H * C
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

template <typename T>
int upsample(const T* x, T* y, int N, int H, int C, int W, void* stream) {
  using Vec = Vectors<T>;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)N * H * C;
  if (rows > INT_MAX || C < 1) return (int)cudaErrorInvalidValue;
  // y comes from torch.empty (aligned); x may be a view at any offset
  const bool wide = W % Vec::kWide == 0 &&
                    reinterpret_cast<std::uintptr_t>(x) % 8 == 0;
  const int wv = wide ? W / Vec::kWide : W;
  int lx = 0;  // 2^lx columns of threads: enough for wv in kE passes
  while (lx < 8 && (kE << lx) < wv) ++lx;
  const int rows_per_block = kThreads >> lx;
  dim3 grid((unsigned)((rows + rows_per_block - 1) / rows_per_block),
            (unsigned)((wv + (kE << lx) - 1) / (kE << lx)));
  if (wide) {
    upsample2x_rows<typename Vec::Wide, typename Vec::WideOut>
        <<<grid, kThreads, 0, s>>>(
            reinterpret_cast<const typename Vec::Wide*>(x),
            reinterpret_cast<typename Vec::WideOut*>(y), (int)rows, C, wv,
            lx);
  } else {
    upsample2x_rows<typename Vec::One, typename Vec::OneOut>
        <<<grid, kThreads, 0, s>>>(
            reinterpret_cast<const typename Vec::One*>(x),
            reinterpret_cast<typename Vec::OneOut*>(y), (int)rows, C, wv,
            lx);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pggan_upsample2x(const float* x, float* y, int N, int H, int C,
                                int W, void* stream) {
  return upsample<float>(x, y, N, H, C, W, stream);
}

extern "C" int pggan_upsample2x_bf16(const __nv_bfloat16* x, __nv_bfloat16* y,
                                     int N, int H, int C, int W,
                                     void* stream) {
  return upsample<__nv_bfloat16>(x, y, N, H, C, W, stream);
}

// The library's one error-text helper, for the wrappers' exceptions.
extern "C" const char* pggan_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
