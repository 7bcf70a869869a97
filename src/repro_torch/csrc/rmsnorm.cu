// Fused RMSNorm for Hopper (sm_90a): one warp per row, eight rows per CTA,
// 16-byte loads and stores.
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
// ~4 flops, far below the card's flop-per-byte balance: 0.030 ms at (8192,
// 3072) bfloat16.  What the design does about it: one pass over x, with
// enough bytes in flight per SM to cover the memory latency.
// - Each lane moves 16 bytes per access (8 bfloat16 or 4 float32).  One warp
//   owns a row, so a 3072-wide bfloat16 row is 384 vectors, 12 per lane,
//   all loaded before the first is used and held in registers (as loaded)
//   between the sum of squares and the scaled store.  Rows up to 12 vectors
//   per lane (3072 bfloat16, 1536 float32) stay in registers; the tail of a
//   wider row is read again, from L2, for the store.
// - y is stored with the streaming hint (__stcs): at these sizes it would
//   not stay in L2 for its reader anyway.
// - Eight rows per 256-thread CTA, two CTAs per SM (at most 128 registers
//   a thread): every resident warp has a whole row of 16-byte loads in
//   flight, where one row per CTA had 12 scalar 2-byte loads a thread.  The
//   hardware hands out CTAs as others finish, so no round of rows runs
//   part-empty as in a persistent grid-stride loop.
// - w is read once per CTA into shared memory as float32 (its first 12288
//   columns; wider rows read the rest from global memory).  At (8192, 3072)
//   bfloat16 on an H100 this was 4-8% faster than 16-byte __ldg reads of w
//   from L1 for every vector of x (chip_smoke.py --rmsnorm-compare).
// - A row whose x or y address is not 16-byte aligned (a view at an odd
//   offset, or every other row of a width that is not a multiple of the
//   vector) takes the scalar loop of the same kernel; so do a vectorised
//   row's last d % VEC columns.  That is part of this kernel, not a fallback.
// - The sum of squares is taken in a fixed order (per lane in column order,
//   then a butterfly over the warp), so results are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;   // rows per CTA, one per warp
constexpr int MAXV = 12;             // 16-byte vectors a lane holds in registers
constexpr int W_SMEM = 12288;        // columns of w staged in shared memory (48 KB)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }

// One 16-byte vector of T as float32 values, and back.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename TX>
__device__ __forceinline__ float sum_sq(const uint4& u, float ss) {
  float f[Vec<TX>::N];
  Vec<TX>::unpack(u, f);
#pragma unroll
  for (int i = 0; i < Vec<TX>::N; ++i) ss = fmaf(f[i], f[i], ss);
  return ss;
}

// y's vector from x's, the row's scale r and w's columns [c, c + N)
template <typename TX, typename TW>
__device__ __forceinline__ uint4 scaled(const uint4& u, float r, const float* ws, const TW* w,
                                        int c, int nws) {
  constexpr int N = Vec<TX>::N;
  float f[N], wf[N];
  Vec<TX>::unpack(u, f);
  if (c + N <= nws) {   // 16-byte shared-memory loads (c is a multiple of 4)
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 t = reinterpret_cast<const float4*>(ws + c)[k];
      wf[4 * k] = t.x;
      wf[4 * k + 1] = t.y;
      wf[4 * k + 2] = t.z;
      wf[4 * k + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) wf[i] = c + i < nws ? ws[c + i] : to_f32(w[c + i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = (f[i] * r) * wf[i];
  return Vec<TX>::pack(f);
}

// One row: 16-byte vectors when x's and y's rows are 16-byte aligned, held
// in registers between the sum of squares and the store; scalar otherwise.
template <typename TX, typename TW>
__device__ __forceinline__ void rmsnorm_row(const TX* __restrict__ xr, const TW* __restrict__ w,
                                            TX* __restrict__ yr, int d, float eps,
                                            const float* ws, int nws, int lane) {
  constexpr int N = Vec<TX>::N;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(yr)) & 15u) == 0;
  const int nv = aligned ? d / N : 0;       // 16-byte vectors of the row
  const uint4* xv = reinterpret_cast<const uint4*>(xr);
  uint4* yv = reinterpret_cast<uint4*>(yr);

  uint4 buf[MAXV];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    const int i = lane + 32 * j;
    if (i < nv) buf[j] = __ldg(xv + i);
  }
#pragma unroll
  for (int j = 0; j < MAXV; ++j)
    if (lane + 32 * j < nv) ss = sum_sq<TX>(buf[j], ss);
  for (int i = lane + 32 * MAXV; i < nv; i += 32) ss = sum_sq<TX>(__ldg(xv + i), ss);
  for (int c = nv * N + lane; c < d; c += 32) {   // scalar columns
    const float t = to_f32(xr[c]);
    ss = fmaf(t, t, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    const int i = lane + 32 * j;
    if (i < nv) __stcs(yv + i, scaled<TX, TW>(buf[j], r, ws, w, i * N, nws));
  }
  for (int i = lane + 32 * MAXV; i < nv; i += 32)
    __stcs(yv + i, scaled<TX, TW>(__ldg(xv + i), r, ws, w, i * N, nws));
  for (int c = nv * N + lane; c < d; c += 32) {
    const float wc = c < nws ? ws[c] : to_f32(w[c]);
    store(yr + c, (to_f32(xr[c]) * r) * wc);
  }
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS, 2) rmsnorm_kernel(const TX* __restrict__ x,
                                                          const TW* __restrict__ w,
                                                          TX* __restrict__ y, long long n, int d,
                                                          float eps) {
  extern __shared__ __align__(16) float ws[];
  const int nws = min(d, W_SMEM);
  for (int c = threadIdx.x; c < nws; c += THREADS) ws[c] = to_f32(w[c]);
  __syncthreads();

  const long long row = static_cast<long long>(blockIdx.x) * ROWS + threadIdx.x / 32;
  if (row < n) rmsnorm_row<TX, TW>(x + row * d, w, y + row * d, d, eps, ws, nws, threadIdx.x % 32);
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* y, long long n, int d, float eps,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(d < W_SMEM ? d : W_SMEM);
  const long long blocks = (n + ROWS - 1) / ROWS;
  rmsnorm_kernel<TX, TW><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(y), n, d, eps);
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
