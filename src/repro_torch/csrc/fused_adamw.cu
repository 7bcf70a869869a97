// Fused AdamW step for Hopper (sm_90a): one launch per parameter leaf.
//
// Replaces src/repro/kernels/fused_adamw.py::_adamw_kernel, the Pallas
// kernel that updates one (1, 64Ki) VMEM tile of p, g, m, v per grid step
// after the wrapper pads the flat leaf to a whole number of tiles.
//
// Computes, per element (f32 arithmetic, as the reference kernel):
//   g' = g * gscale
//   m' = b1 * m + (1 - b1) * g'
//   v' = b2 * v + (1 - b2) * g' * g'
//   p' = p - lr * ((m' * c1) / (sqrt(v' * c2) + eps) + wd * p)
// and stores p' in p's dtype (bf16 rounded to nearest even), m', v' in f32.
//
// Bound: HBM bytes.  Each element reads p, g, m, v once and writes p', m',
// v' once: 28 B for an f32 leaf, 22 B for a bf16 leaf, against ~15 flops,
// far below the card's flop-per-byte balance.  What the design does about
// it: one pass over the leaf with 16-byte (f32) or 8-byte (bf16) vector
// loads and stores of four elements per thread and iteration, a grid-stride
// loop sized to the SM count, and no padded copy: the ragged tail (and any
// leaf whose pointers are not vector-aligned) takes a scalar loop.
// lr, b1, b2, c1, c2 and gscale arrive as an (8,) f32 device row read
// through a pointer, so the step needs no host read of device scalars.
// Outputs are fresh buffers (the reference update is functional).
//
// Built with IEEE sqrtf and division (never --use_fast_math); nvcc's
// default FMA contraction applies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

struct Scalars {
  float lr, b1, b2, c1, c2, gscale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* dst, long long i, float x) { dst[i] = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, long long i, float x) {
  dst[i] = __float2bfloat16_rn(x);
}

// Four consecutive elements starting at 4 * i.
__device__ __forceinline__ void load4(const float* src, long long i, float out[4]) {
  const float4 t = reinterpret_cast<const float4*>(src)[i];
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* src, long long i, float out[4]) {
  const uint2 t = reinterpret_cast<const uint2*>(src)[i];
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &t.x, sizeof(lo));
  memcpy(&hi, &t.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void store4(float* dst, long long i, const float in[4]) {
  reinterpret_cast<float4*>(dst)[i] = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, long long i, const float in[4]) {
  const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(in[0]),
                                               __float2bfloat16_rn(in[1]));
  const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(in[2]),
                                               __float2bfloat16_rn(in[3]));
  uint2 t;
  memcpy(&t.x, &lo, sizeof(lo));
  memcpy(&t.y, &hi, sizeof(hi));
  reinterpret_cast<uint2*>(dst)[i] = t;
}

// Same operation order as _adamw_kernel.
__device__ __forceinline__ void adamw(const Scalars& s, float eps, float wd,
                                      float p, float g, float& m, float& v,
                                      float& p_out) {
  g = g * s.gscale;
  m = s.b1 * m + (1.f - s.b1) * g;
  v = s.b2 * v + (1.f - s.b2) * g * g;
  const float mhat = m * s.c1;
  const float vhat = v * s.c2;
  const float update = mhat / (sqrtf(vhat) + eps) + wd * p;
  p_out = p - s.lr * update;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_adamw_kernel(const T* __restrict__ p, const T* __restrict__ g,
                   const float* __restrict__ m, const float* __restrict__ v,
                   const float* __restrict__ sc, T* __restrict__ p_out,
                   float* __restrict__ m_out, float* __restrict__ v_out,
                   long long n, long long n_vec, float eps, float wd) {
  const Scalars s{sc[0], sc[1], sc[2], sc[3], sc[4], sc[5]};
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;

  for (long long i = tid; i < n_vec; i += stride) {
    float pf[4], gf[4], mf[4], vf[4], po[4];
    load4(p, i, pf);
    load4(g, i, gf);
    load4(m, i, mf);
    load4(v, i, vf);
#pragma unroll
    for (int k = 0; k < 4; ++k) adamw(s, eps, wd, pf[k], gf[k], mf[k], vf[k], po[k]);
    store4(p_out, i, po);
    store4(m_out, i, mf);
    store4(v_out, i, vf);
  }
  for (long long i = 4 * n_vec + tid; i < n; i += stride) {
    float mi = m[i], vi = v[i], po;
    adamw(s, eps, wd, to_f32(p[i]), to_f32(g[i]), mi, vi, po);
    store(p_out, i, po);
    m_out[i] = mi;
    v_out[i] = vi;
  }
}

template <typename T>
int launch(const void* p, const void* g, const void* m, const void* v,
           const void* sc, void* p_out, void* m_out, void* v_out, long long n,
           int vectorized, float eps, float wd, int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_vec = vectorized ? n / 4 : 0;
  const long long items = n_vec + (n - 4 * n_vec);
  long long blocks = (items + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sms) * BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  fused_adamw_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(g),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<const float*>(sc), static_cast<T*>(p_out),
      static_cast<float*>(m_out), static_cast<float*>(v_out), n, n_vec, eps, wd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* fused_adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One AdamW step over a flat leaf of n elements on ``stream`` (no
// synchronisation); returns the CUDA error code of the launch (0 on
// success).  dtype: 0 = float32, 1 = bfloat16, for p, g and p_out; m, v,
// m_out, v_out and the (8,) scalar row sc are float32.  ``vectorized``
// promises that every pointer is 16-byte aligned (f32) or 8-byte (bf16).
int fused_adamw_launch(int dtype, const void* p, const void* g, const void* m,
                       const void* v, const void* sc, void* p_out, void* m_out,
                       void* v_out, long long n, int vectorized, float eps,
                       float wd, int device, void* stream) {
  if (n <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(p, g, m, v, sc, p_out, m_out, v_out, n, vectorized,
                         eps, wd, device, st);
  return launch<__nv_bfloat16>(p, g, m, v, sc, p_out, m_out, v_out, n,
                               vectorized, eps, wd, device, st);
}

}  // extern "C"
