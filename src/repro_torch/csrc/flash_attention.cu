// Blocked (flash) attention for Hopper (sm_90a), in two variants: a
// tensor-core variant for bfloat16 ("tc") and a CUDA-core variant ("simt").
//
// Replaces src/repro/kernels/flash_attention.py::_attn_kernel, the Pallas
// kernel whose grid (B*Hq, Sq/BQ, Sk/BK) walks the key blocks of one query
// tile in order, keeping the (m, l, acc) state in VMEM scratch.
//
// Computes, for q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), kv head = q head
// // (Hq / Hkv) (MHA, GQA, MQA), with (m, l, acc) in float32:
//   s = (q . k) * sm_scale; s = -1e30 where masked (causal: q >= k; window:
//   k > q - window; ragged tails: k >= Sk); m_new = max(m, rowmax s);
//   p = exp(s - m_new), 0 where masked; alpha = exp(m - m_new);
//   l = alpha * l + rowsum p; acc = alpha * acc + p . v;
//   out = acc / (l == 0 ? 1 : l), cast to the input dtype (rows that see no
//   key give 0).  Key tiles that the causal mask or the window excludes for
//   every row of a query tile are skipped: for them the reference step
//   leaves (m, l, acc) unchanged, so skipping is exact.  Ragged Sq and Sk are
//   masked here; the reference asserts that they divide the blocks.  Query
//   tiles run longest-first so the causal tail of the grid is short.
//
// Bound: at gemma-7b's prefill shape (4, 16, 2048, 256) causal the work is
// 4*B*H*S^2*D/2 = 1.375e11 flop against 268 MB of q, k, v and out, so the
// card's operation rate bounds it: 0.139 ms at 989 TFLOP/s of bfloat16 on
// the tensor cores, against 0.080 ms for the bytes.
//
// What the tc variant does about that bound (bfloat16 only):
// - Both products run on the tensor cores as wgmma.mma_async m64n64k16
//   (bfloat16 in, float32 sums).  S = Q.K^T takes Q and K from shared
//   memory, both K-major.  O += P.V takes P from registers: the float32
//   fragment of S maps onto the bfloat16 A fragments of four k16 steps, so
//   P never goes through shared memory.  V is the MN-major B operand (the
//   transpose bit), read as it lies.  A head dim of 64 j columns is j
//   m64n64 products per k step.
// - A CTA is two consumer warpgroups of 64 query rows each (128 rows share
//   every K/V tile) and a producer warpgroup.  One thread of it loads
//   the Q tiles once and streams 64 x D K and V tiles through a 2-stage ring
//   in shared memory with TMA (cp.async.bulk.tensor, 128-byte swizzle,
//   64-column boxes), completing on an mbarrier per stage; the consumers
//   release a stage through a second mbarrier.  So tile k+1 loads while
//   tile k is multiplied, and one warpgroup's softmax overlaps the other's
//   products.  At D = 256: Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB of
//   dynamic shared memory, one CTA per SM; setmaxnreg moves registers from
//   the producer warpgroup to the consumers (240 each), so the 128
//   accumulator registers of O do not spill.
// - The 4-D tensor maps over (D, S, H, B) carry the caller's strides, so the
//   model's head-split views load without a copy; TMA's out-of-bounds zero
//   fill covers ragged Sq/Sk and a D below the instantiated width (64, 128,
//   256).  cuTensorMapEncodeTiled is fetched from the driver through
//   cudaGetDriverEntryPoint, so the library links nothing beyond cudart.
// - Masking and the online softmax run on the accumulator fragment in
//   registers: each row's max and sum reduce over the 4 lanes that share it.
//   Tiles wholly visible to a warpgroup's rows skip the mask tests.
// Numerics: p is rounded to bfloat16 before P.V (the reference keeps it in
// float32); products of bfloat16 values are exact in float32 and the sums
// are float32 (l sums the float32 p), so the output differs from the plain
// version by a few bfloat16 ulps, inside the bfloat16 tolerance of 2e-2.
//
// The simt variant (the port's first kernel, unchanged) does its products
// on the CUDA cores in float32 and is exact to float32 rounding, which the
// float32 tolerance of 2e-5 needs: q, k, v tiles live in shared memory as
// float32 (row stride D + 4 so 16-byte loads of neighbouring rows fall in
// distinct banks); each of 256 threads keeps a 4 x 4 block of the 64 x 64
// score tile and a 4 x (D / 16) block of the accumulator in registers; row
// max and sum reduce over 16 lanes with shuffles; probabilities go through
// shared memory (transposed) into P.V.  217 KB of shared memory at D = 256.
//
// Which variant runs is the wrapper's rule (kernels/flash_attention.py,
// _variant): tc when q, k and v are bfloat16, D is a multiple of 16 and at
// most 256, Sk >= 1, every base address is 16-byte aligned and every stride
// of a dimension longer than 1 is a multiple of 8 elements (TMA's 16-byte
// rule); simt otherwise (float32, or the inputs TMA cannot describe).

#include <cuda.h>
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

// ---------------------------------------------------------------------------
// The tc variant: bfloat16, wgmma on the tensor cores, a TMA K/V ring.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int WG_ROWS = 64;                // query rows per consumer warpgroup
constexpr int NWG = 2;                     // consumer warpgroups per CTA
constexpr int BQ = WG_ROWS * NWG;          // query rows per CTA
constexpr int BK = 64;                     // keys per tile
constexpr int STAGES = 2;                  // K/V ring depth
constexpr int CONSUMERS = NWG * 128;
constexpr int THREADS = CONSUMERS + 128;   // + a producer warpgroup (one thread loads)
// Registers per thread after setmaxnreg: the launch grants each of the 384
// threads 168; the producer warpgroup drops to 24 so that the consumers,
// whose O accumulator alone is 128 registers at D = 256, may hold 240
// (256 x 240 + 128 x 24 = 64512 <= 65536).
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int BOX_BYTES = 64 * 64 * 2;     // one TMA box: 64 rows x 64 bfloat16 (128 B)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Dynamic shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 B): Q[NWG][NDB] boxes, K[STAGES][NDB],
// V[STAGES][NDB], then the mbarriers full[STAGES], empty[STAGES], q.
template <int DP>
struct Smem {
  static constexpr int NDB = DP / 64;      // 64-column boxes per row
  static constexpr int Q = 0;
  static constexpr int K = Q + NWG * NDB * BOX_BYTES;
  static constexpr int V = K + STAGES * NDB * BOX_BYTES;
  static constexpr int BAR = V + STAGES * NDB * BOX_BYTES;
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;
};

struct Params {
  void* o;
  int Hq, group, Sq, Sk, D;
  int q_sfirst, k_sfirst, v_sfirst;  // the tensor map's dim 1 is S (else H)
  int causal, has_window;
  long long window;
  float scale_log2;                  // sm_scale * log2(e)
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64 x 64 box at (column c0, row, head, batch) of ``map`` into ``dst``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int sfirst, int c0, int row, int head, int batch) {
  const int c1 = sfirst ? row : head, c2 = sfirst ? head : row;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled operand: 8-row
// groups 1024 B apart (SBO); ``lbo`` is the byte stride between 64-element
// column blocks of an MN-major operand (unused for K-major ones).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Pin register values to this point of the instruction stream, so that the
// compiler moves no access of a wgmma operand across the fence or the wait.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void keep(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (+)= A . B, m64n64k16, A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A . B, m64n64k16, A (bfloat16 pairs) from registers, B MN-major in
// shared memory (the transpose bit).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap, const Params P) {
  using L = Smem<DP>;
  constexpr int NDB = L::NDB;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full0 = base + L::BAR;         // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * STAGES;   // empty[s] = empty0 + 8 s
  const uint32_t qbar = empty0 + 8 * STAGES;

  const int bh = blockIdx.x;
  const int b = bh / P.Hq, h = bh % P.Hq, hk = h / P.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  // key tiles holding a key that some row of this CTA may see
  const int q_last = min(q0 + BQ, P.Sq) - 1;
  int kt_end = (P.Sk + BK - 1) / BK;
  if (P.causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (P.has_window) {
    const long long lo = static_cast<long long>(q0) - P.window + 1;
    if (lo > 0) kt_begin = static_cast<int>(min(lo / BK, static_cast<long long>(kt_end)));
  }

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= CONSUMERS / 32) {
    // producer warpgroup: one thread issues every load; no CTA-wide barrier
    // follows.  It gives up registers for the consumers' accumulators.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMERS / 32 && lane == 0) {
      mbar_expect_tx(qbar, NWG * NDB * BOX_BYTES);
      for (int w = 0; w < NWG; ++w)
        for (int j = 0; j < NDB; ++j)
          tma_load(base + L::Q + (w * NDB + j) * BOX_BYTES, &qmap, qbar, P.q_sfirst, 64 * j,
                   q0 + WG_ROWS * w, h, b);
      for (int i = 0, kt = kt_begin; kt < kt_end; ++i, ++kt) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty0 + 8 * s, ((i / STAGES) - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, 2 * NDB * BOX_BYTES);
        for (int j = 0; j < NDB; ++j) {
          tma_load(base + L::K + (s * NDB + j) * BOX_BYTES, &kmap, full0 + 8 * s, P.k_sfirst,
                   64 * j, kt * BK, hk, b);
          tma_load(base + L::V + (s * NDB + j) * BOX_BYTES, &vmap, full0 + 8 * s, P.v_sfirst,
                   64 * j, kt * BK, hk, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [qw0, qw0 + 64); this thread
  // holds rows r0 and r0 + 8 of them and key/column pairs 8 j + 2 (lane % 4)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int qw0 = q0 + WG_ROWS * wg;
  int my_begin = kt_begin, my_end = kt_end;
  if (qw0 >= P.Sq) {
    my_end = my_begin;
  } else {
    if (P.causal) my_end = min(my_end, min(qw0 + WG_ROWS - 1, P.Sq - 1) / BK + 1);
    if (P.has_window) {
      const long long lo = static_cast<long long>(qw0) - P.window + 1;
      if (lo > 0)
        my_begin = max(my_begin, static_cast<int>(min(lo / BK, static_cast<long long>(my_end))));
    }
  }

  float o[NDB][32];
#pragma unroll
  for (int bb = 0; bb < NDB; ++bb)
#pragma unroll
    for (int c = 0; c < 32; ++c) o[bb][c] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
  const uint32_t qs = base + L::Q + wg * NDB * BOX_BYTES;

  mbar_wait(qbar, 0);
  for (int i = 0, kt = kt_begin; kt < kt_end; ++i, ++kt) {
    const int s = i % STAGES;
    mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
    if (kt >= my_begin && kt < my_end) {
      const uint32_t ks = base + L::K + s * NDB * BOX_BYTES;
      const uint32_t vs = base + L::V + s * NDB * BOX_BYTES;
      const int k0 = kt * BK;

      // S = Q . K^T over D in k16 steps: step kk is 32 B into box kk / 4
      float sc[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        mma_ss(sc, smem_desc(qs + off, 16), smem_desc(ks + off, 16), kk > 0);
      }
      wg_commit();
      wg_wait0();
      keep(sc);

      // mask and online softmax in the log2 domain; sc[4 j + 2 hh + c] is
      // row r0 + 8 hh, key k0 + 8 j + 2 (lane % 4) + c
      const bool dense =
          k0 + BK <= P.Sk && (!P.causal || k0 + BK - 1 <= qw0) &&
          (!P.has_window ||
           static_cast<long long>(k0) > static_cast<long long>(qw0) + WG_ROWS - 1 - P.window);
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qi = qw0 + r0 + 8 * hh;
        float mx = NEG_INF;
        unsigned vis = 0xffffu;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int idx = 4 * j + 2 * hh + c;
            float x = sc[idx] * P.scale_log2;
            if (!dense) {
              const int kj = k0 + 8 * j + 2 * (lane % 4) + c;
              bool ok = kj < P.Sk;
              if (P.causal) ok = ok && qi >= kj;
              if (P.has_window)
                ok = ok && static_cast<long long>(kj) > static_cast<long long>(qi) - P.window;
              if (!ok) {
                x = NEG_INF;
                vis &= ~(1u << (2 * j + c));
              }
            }
            sc[idx] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[hh], mx);
        alpha[hh] = ex2(m_i[hh] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int idx = 4 * j + 2 * hh + c;
            const float p = ((vis >> (2 * j + c)) & 1u) ? ex2(sc[idx] - m_new) : 0.f;
            sc[idx] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_i[hh] = alpha[hh] * l_i[hh] + sum;
        m_i[hh] = m_new;
      }
#pragma unroll
      for (int bb = 0; bb < NDB; ++bb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[bb][4 * j + 0] *= alpha[0];
          o[bb][4 * j + 1] *= alpha[0];
          o[bb][4 * j + 2] *= alpha[1];
          o[bb][4 * j + 3] *= alpha[1];
        }
      // key step kk (keys 16 kk .. 16 kk + 15): the accumulator pairs of key
      // chunks 2 kk and 2 kk + 1 are exactly its k16 A fragment
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);

      // O += P . V: V's key step kk is 16 rows (2048 B) into each box
#pragma unroll
      for (int bb = 0; bb < NDB; ++bb) keep(o[bb]);
      keep(pa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int bb = 0; bb < NDB; ++bb)
          mma_rs(o[bb], pa[kk], smem_desc(vs + bb * BOX_BYTES + kk * 2048, BOX_BYTES));
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int bb = 0; bb < NDB; ++bb) keep(o[bb]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // out is contiguous (B, Hq, Sq, D); D is even, so no pair straddles it
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(P.o) + static_cast<long long>(bh) * P.Sq * P.D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = qw0 + r0 + 8 * hh;
    if (qi >= P.Sq) continue;
    const float safe = l_i[hh] == 0.f ? 1.f : l_i[hh];
#pragma unroll
    for (int bb = 0; bb < NDB; ++bb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * bb + 8 * j + 2 * (lane % 4);
        if (d < P.D)
          *reinterpret_cast<__nv_bfloat162*>(op + static_cast<long long>(qi) * P.D + d) =
              __floats2bfloat162_rn(o[bb][4 * j + 2 * hh] / safe,
                                    o[bb][4 * j + 2 * hh + 1] / safe);
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int ERR_NO_ENCODE = -1;   // the driver has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = -2;      // the driver refused a tensor map

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (D, S, H, B) of a bfloat16 tensor with element strides ss,
// sh, sb (the last dimension contiguous), 64 x 64 boxes, 128-byte swizzle,
// zero fill out of bounds.  The middle dimensions go in the order of their
// strides (*sfirst: S before H), so (B, H, S, D) tensors and their
// head-split (B, S, H, D) views both give increasing strides; a dimension of
// size 1 takes the stride that keeps them increasing.
int make_map(CUtensorMap* map, const void* ptr, int D, int S, int H, int B, long long ss,
             long long sh, long long sb, int* sfirst) {
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return ERR_NO_ENCODE;
  const bool s_first = S == 1 ? false : (H == 1 ? true : ss <= sh);
  const int n1 = s_first ? S : H, n2 = s_first ? H : S;
  long long st1 = s_first ? ss : sh, st2 = s_first ? sh : ss;
  if (n1 == 1) st1 = D;
  if (n2 == 1) st2 = st1 * n1;
  const long long stb = B == 1 ? st2 * n2 : sb;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st1) * 2,
                                 static_cast<cuuint64_t>(st2) * 2,
                                 static_cast<cuuint64_t>(stb) * 2};
  const cuuint32_t box[4] = {64, s_first ? 64u : 1u, s_first ? 1u : 64u, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  *sfirst = s_first ? 1 : 0;
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <int DP>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, const Params& P,
           int batch_heads, cudaStream_t stream) {
  constexpr int smem = Smem<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_tc_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch_heads), static_cast<unsigned>((P.Sq + BQ - 1) / BQ));
  flash_attention_tc_kernel<DP><<<grid, THREADS, smem, stream>>>(qm, km, vm, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  if (code == tc::ERR_NO_ENCODE) return "the driver has no cuTensorMapEncodeTiled";
  if (code == tc::ERR_ENCODE) return "cuTensorMapEncodeTiled refused a tensor map";
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

// The tc variant: bfloat16 q, k, v and o, arguments as flash_attention_launch.
// The caller guarantees TMA's rules: 16-byte aligned bases, strides of
// dimensions longer than 1 multiples of 8 elements, D a multiple of 16 and
// at most 256, Sk >= 1.  Returns 0, a CUDA error code, or a negative code
// for a tensor map the driver would not make (flash_attention_error_string).
int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* o,
                              int B, int Hq, int Hkv, int Sq, int Sk, int D,
                              long long q_sb, long long q_sh, long long q_ss,
                              long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss,
                              int causal, int has_window, long long window, float sm_scale,
                              int device, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      D > 256 || D % 16 != 0 || (Sq + tc::BQ - 1) / tc::BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qm, km, vm;
  tc::Params P{o, Hq, Hq / Hkv, Sq, Sk, D, 0, 0, 0, causal, has_window, window,
               sm_scale * tc::LOG2E};
  int rc = tc::make_map(&qm, q, D, Sq, Hq, B, q_ss, q_sh, q_sb, &P.q_sfirst);
  if (rc == 0) rc = tc::make_map(&km, k, D, Sk, Hkv, B, k_ss, k_sh, k_sb, &P.k_sfirst);
  if (rc == 0) rc = tc::make_map(&vm, v, D, Sk, Hkv, B, v_ss, v_sh, v_sb, &P.v_sfirst);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return tc::launch<64>(qm, km, vm, P, B * Hq, st);
  if (D <= 128) return tc::launch<128>(qm, km, vm, P, B * Hq, st);
  return tc::launch<256>(qm, km, vm, P, B * Hq, st);
}

}  // extern "C"
