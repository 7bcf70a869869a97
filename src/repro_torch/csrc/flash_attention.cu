// Blocked (flash) attention for Hopper (sm_90a): online softmax over key
// tiles, one CTA per (batch * q_head, 64-query tile).
//
// Replaces src/repro/kernels/flash_attention.py::_attn_kernel, the Pallas
// kernel whose grid (B*Hq, Sq/BQ, Sk/BK) walks the key blocks of one query
// tile in order, keeping the (m, l, acc) state in VMEM scratch.
//
// Computes, for q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), kv head = q head
// // (Hq / Hkv) (MHA, GQA, MQA), in float32 whatever the input dtype:
//   s = (q . k) * sm_scale; s = -1e30 where masked (causal: q >= k; window:
//   k > q - window; ragged tails: k >= Sk); m_new = max(m, rowmax s);
//   p = exp(s - m_new), 0 where masked; alpha = exp(m - m_new);
//   l = alpha * l + rowsum p; acc = alpha * acc + p . v;
//   out = acc / (l == 0 ? 1 : l), cast to the input dtype (rows that see no
//   key give 0).  Key tiles that the causal mask or the window excludes for
//   every row of the query tile are skipped: for them the reference step
//   leaves (m, l, acc) unchanged, so skipping is exact.  Ragged Sq and Sk are
//   masked here; the reference asserts that they divide the blocks.
//
// Bound: at gemma-7b's prefill shape (4, 16, 2048, 256) causal the work is
// 4*B*H*S^2*D/2 = 1.37e11 flop against 268 MB of q, k, v and out, so the
// card's operation rate bounds it.  This first version does its products on
// the CUDA cores in float32 (no mma/wgmma, no TMA): it is simple and exact
// to float32 rounding, and it is far from the tensor-core bound.  What the
// design does about the bound it can reach: q, k, v tiles are held in shared
// memory as float32 (row stride D + 4 so that 16-byte loads of neighbouring
// rows fall in distinct banks); each of 256 threads keeps a 4 x 4 block of
// the 64 x 64 score tile and a 4 x (D / 16) block of the accumulator in
// registers, so every 16-byte shared-memory load feeds 4 to 16 FMAs; the
// row max and row sum reduce over the 16 lanes that share a row with warp
// shuffles; probabilities go through shared memory (transposed, so a
// thread's 4 rows are one 16-byte load) into the P.V product.  Query tiles
// run longest-first so the causal tail of the grid is short.  Head dims up to
// 256 (instantiated at 64, 128 and 256, zero-padded between); the 217 KB of
// shared memory at D = 256 is above the 48 KB static limit, so the launch
// raises the kernel's dynamic shared-memory attribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16: ty picks 4 rows, tx 4 key columns
constexpr int PLD = BQ + 4;   // row stride of the transposed probability tile
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, group, Sq, Sk, D;
  long long q_sb, q_sh, q_ss;  // element strides of batch, head, position
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int causal, has_window;
  long long window;
  float sm_scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * (DP + 4) +
                          static_cast<size_t>(BK) * PLD);
}

// rows [row0, row0 + nrows) of src into dst (row stride DP + 4) as float32,
// zero outside [0, rows_end) x [0, D).
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int nrows,
                                          int rows_end, long long row_stride, int D) {
  for (int i = threadIdx.x; i < nrows * DP; i += THREADS) {
    const int r = i / DP, d = i % DP;
    const int row = row0 + r;
    float x = 0.f;
    if (row < rows_end && d < D) x = to_f32(src[static_cast<long long>(row) * row_stride + d]);
    dst[r * (DP + 4) + d] = x;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_kernel(const Params P) {
  constexpr int LD = DP + 4;
  constexpr int NJ = DP / 64;  // 16-byte column groups of the accumulator per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Pt = Vs + BK * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / P.Hq, h = bh % P.Hq, hk = h / P.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  const T* qp = static_cast<const T*>(P.q) + b * P.q_sb + h * P.q_sh;
  const T* kp = static_cast<const T*>(P.k) + b * P.k_sb + hk * P.k_sh;
  const T* vp = static_cast<const T*>(P.v) + b * P.v_sb + hk * P.v_sh;

  load_tile<T, DP>(Qs, qp, q0, BQ, P.Sq, P.q_ss, P.D);

  // key tiles holding a key that some row of this tile may see
  const int q_hi = min(q0 + BQ, P.Sq) - 1;
  int kt_end = (P.Sk + BK - 1) / BK;
  if (P.causal) kt_end = min(kt_end, q_hi / BK + 1);
  int kt_begin = 0;
  if (P.has_window) {
    const long long lo = static_cast<long long>(q0) - P.window + 1;  // first visible key of row q0
    if (lo > 0) kt_begin = static_cast<int>(min(lo / BK, static_cast<long long>(kt_end)));
  }

  float m_i[4], l_i[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed (and Q is stored)
    load_tile<T, DP>(Ks, kp, k0, BK, P.Sk, P.k_ss, P.D);
    load_tile<T, DP>(Vs, vp, k0, BK, P.Sk, P.v_ss, P.D);
    __syncthreads();

    // s[i][j]: row ty*4+i, key tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = NEG_INF;
      unsigned vis = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool ok = kj < P.Sk;
        if (P.causal) ok = ok && qi >= kj;
        if (P.has_window) ok = ok && static_cast<long long>(kj) > static_cast<long long>(qi) - P.window;
        const float x = ok ? s[i][j] * P.sm_scale : NEG_INF;
        s[i][j] = x;
        vis |= (ok ? 1u : 0u) << j;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ((vis >> j) & 1u) ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        Pt[(tx + 16 * j) * PLD + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_i[i] = alpha * l_i[i] + psum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the whole probability tile is written

    // acc[i][4*j + c]: row ty*4+i, column tx*4 + 64*j + c
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + kk * PLD + ty * 4);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 w = *reinterpret_cast<const float4*>(Vs + kk * LD + tx * 4 + 64 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * j + 0] = fmaf(pr[i], w.x, acc[i][4 * j + 0]);
          acc[i][4 * j + 1] = fmaf(pr[i], w.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(pr[i], w.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(pr[i], w.w, acc[i][4 * j + 3]);
        }
      }
    }
  }

  // out is contiguous (B, Hq, Sq, D)
  T* op = static_cast<T*>(P.o) + static_cast<long long>(bh) * P.Sq * P.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= P.Sq) continue;
    const float safe = l_i[i] == 0.f ? 1.f : l_i[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = tx * 4 + 64 * j + c;
        if (d < P.D) store(op + static_cast<long long>(qi) * P.D + d, acc[i][4 * j + c] / safe);
      }
  }
}

template <typename T, int DP>
int launch(const Params& P, int batch_heads, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch_heads), static_cast<unsigned>((P.Sq + BQ - 1) / BQ));
  flash_attention_kernel<T, DP><<<grid, THREADS, smem, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dp(const Params& P, int batch_heads, cudaStream_t stream) {
  if (P.D <= 64) return launch<T, 64>(P, batch_heads, stream);
  if (P.D <= 128) return launch<T, 128>(P, batch_heads, stream);
  return launch<T, 256>(P, batch_heads, stream);
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Attention of q (B, Hq, Sq, D) over k, v (B, Hkv, Sk, D) into a contiguous
// o (B, Hq, Sq, D) on ``stream`` (no synchronisation); returns the CUDA
// error code of the launch (0 on success).  dtype: 0 = float32, 1 =
// bfloat16 for q, k, v and o.  Strides are in elements (the last dimension's
// is 1).  window is read only when has_window is set.
int flash_attention_launch(int dtype, const void* q, const void* k, const void* v, void* o,
                           int B, int Hq, int Hkv, int Sq, int Sk, int D,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss,
                           int causal, int has_window, long long window, float sm_scale,
                           int device, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk < 0 || D <= 0 ||
      D > 256 || (Sq + BQ - 1) / BQ > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params P{q, k, v, o, Hq, Hq / Hkv, Sq, Sk, D,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 causal, has_window, window, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dp<float>(P, B * Hq, st);
  return launch_dp<__nv_bfloat16>(P, B * Hq, st);
}

}  // extern "C"
