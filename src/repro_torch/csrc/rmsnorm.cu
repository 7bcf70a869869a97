// Fused RMSNorm for Hopper (sm_90a): one CTA per row.
//
// Replaces src/repro/kernels/rmsnorm.py::_rmsnorm_kernel, the Pallas kernel
// that normalises a VMEM-resident block of rows (the wrapper pads the rows
// to whole row blocks).
//
// Computes, per row of x (n, d) with weight w (d,), in float32:
//   ms = mean(x * x); y = (x * rsqrt(ms + eps)) * w
// and stores y in x's dtype (bfloat16 rounded to nearest even).
//
// Bound: HBM bytes.  Each element of x is read once and each of y written
// once (4 B per element in bfloat16, 8 B in float32, plus w once) against
// ~4 flops, far below the card's flop-per-byte balance.  What the design
// does about it: one pass over x.  A row's values stay in registers (16 per
// thread, rows up to 4096 wide; wider rows re-read their tail, from L2)
// between the sum of squares and the scaled store; the sum reduces with warp
// shuffles and one shared-memory step, in a fixed order.  No padded copy:
// the grid has one CTA per row, so there is no ragged row block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXV = 16;  // values a thread holds in registers

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }

template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS) rmsnorm_kernel(const TX* __restrict__ x,
                                                          const TW* __restrict__ w,
                                                          TX* __restrict__ y, int d, float eps) {
  __shared__ float warp_sums[WARPS];
  const long long row = blockIdx.x;
  const TX* xr = x + row * d;
  TX* yr = y + row * d;

  float vals[MAXV];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    const int c = threadIdx.x + j * THREADS;
    vals[j] = c < d ? to_f32(xr[c]) : 0.f;
    ss = fmaf(vals[j], vals[j], ss);
  }
  for (int c = threadIdx.x + MAXV * THREADS; c < d; c += THREADS) {
    const float t = to_f32(xr[c]);
    ss = fmaf(t, t, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) total += warp_sums[i];
  const float r = rsqrtf(total / static_cast<float>(d) + eps);

#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    const int c = threadIdx.x + j * THREADS;
    if (c < d) store(yr + c, (vals[j] * r) * to_f32(w[c]));
  }
  for (int c = threadIdx.x + MAXV * THREADS; c < d; c += THREADS)
    store(yr + c, (to_f32(xr[c]) * r) * to_f32(w[c]));
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* y, long long n, int d, float eps,
           cudaStream_t stream) {
  rmsnorm_kernel<TX, TW><<<static_cast<unsigned>(n), THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(y), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// RMSNorm of n contiguous rows of d elements into y on ``stream`` (no
// synchronisation); returns the CUDA error code of the launch (0 on
// success).  x_dtype (x and y) and w_dtype: 0 = float32, 1 = bfloat16.
int rmsnorm_launch(int x_dtype, int w_dtype, const void* x, const void* w, void* y,
                   long long n, int d, float eps, int device, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || d <= 0 || x_dtype < 0 || x_dtype > 1 || w_dtype < 0 ||
      w_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(x, w, y, n, d, eps, st);
  if (x_dtype == 0) return launch<float, __nv_bfloat16>(x, w, y, n, d, eps, st);
  if (w_dtype == 0) return launch<__nv_bfloat16, float>(x, w, y, n, d, eps, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, n, d, eps, st);
}

}  // extern "C"
