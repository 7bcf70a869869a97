// Split-pipeline kernel for Hopper (sm_90a): one Mozart stage per launch.
//
// Replaces src/repro/kernels/split_pipeline.py::_pipeline_kernel, the Pallas
// kernel that calls the stage's unmodified library functions on a VMEM tile.
// A CUDA kernel cannot call Python, so core/cuda_exec.py lowers the stage's
// chain into a straight-line program (kernels/program.py) and this one fixed
// kernel interprets any such program.
//
// Bound: HBM bytes.  A stage reads each split input once and writes each
// escaping output once (Black-Scholes: 5 f32 inputs + 2 f32 outputs = 28 B
// per element) and does a few dozen flops per element, far below the card's
// ~20 flop/B balance.  What the design does about it: every intermediate of
// the chain lives in shared-memory slots of the block's tile and never
// reaches HBM, so traffic is the stage's inputs and escaping outputs only —
// an un-fused library chain instead writes and re-reads every intermediate.
//
// Layout: each block owns one TILE of elements.  It loads a tile of every
// split input into shared memory (bool inputs as 1.0/0.0), then walks the
// program once; every instruction is applied across the tile by all
// threads, so opcode dispatch is uniform across the block.  Thread t only
// ever touches elements t, t + THREADS, ..., so no barrier is needed between
// instructions.  Concat outputs are stored per tile; each reduction writes
// one partial per block, masking the ragged tail with the op's identity
// (no padded copy of the inputs is ever made).  The wrapper combines the
// partials after the launch.  All arithmetic is IEEE float32 (never built
// with --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;          // elements per block (power of two)
constexpr int THREADS = 256;
constexpr int MAX_IN = 16;
constexpr int MAX_OUT = 16;
constexpr int MAX_SCALARS = 64;
constexpr int MAX_INSTR = 256;
constexpr int MAX_ROWS = 56;        // split inputs + slots: 56 x 4 KB tiles
constexpr int WARPS = THREADS / 32;

// Same order as OPCODES in kernels/program.py.
enum Op : uint8_t {
  OP_COPY, OP_NEG, OP_ABS, OP_EXP, OP_LOG, OP_LOG1P, OP_SQRT, OP_ERF, OP_SIN,
  OP_COS, OP_TANH, OP_SIGN, OP_ASIN, OP_ACOS, OP_EXPM1, OP_SQUARE, OP_RECIP,
  OP_FLOOR, OP_ISNAN, OP_NOT, OP_BOOL,
  OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_POW, OP_MAX, OP_MIN, OP_GT, OP_LT, OP_GE,
  OP_LE, OP_EQ, OP_NE, OP_AND, OP_OR, OP_ATAN2, OP_MOD,
  OP_WHERE,
  OP_COUNT
};

enum OutKind : uint8_t { OUT_F32, OUT_BOOL, OUT_ADD, OUT_MUL, OUT_MAX, OUT_MIN };

struct Instr {
  uint8_t op, dst;
  uint16_t a, b, c;                 // operands: kind << 14 | index
};

struct Params {
  long long n;
  const void* in[MAX_IN];
  void* out[MAX_OUT];               // concat output, or partials[grid]
  int n_in, n_slots, n_scalars, n_instr, n_out, pad_;
  uint8_t in_bool[MAX_IN];
  uint8_t out_kind[MAX_OUT];
  uint16_t out_src[MAX_OUT];
  float scalars[MAX_SCALARS];
  Instr code[MAX_INSTR];
};

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__device__ __forceinline__ float identity(uint8_t kind) {
  switch (kind) {
    case OUT_MUL: return 1.f;
    case OUT_MAX: return -INFINITY;
    case OUT_MIN: return INFINITY;
    default: return 0.f;
  }
}

__device__ __forceinline__ float combine(uint8_t kind, float a, float b) {
  switch (kind) {
    case OUT_MUL: return a * b;
    case OUT_MAX: return max_nan(a, b);
    case OUT_MIN: return min_nan(a, b);
    default: return a + b;
  }
}

// Block-wide reduction; the result is valid in thread 0.
__device__ float block_reduce(uint8_t kind, float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v = combine(kind, v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                  // scratch free from any earlier reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? scratch[lane] : identity(kind);
    for (int off = 16; off > 0; off >>= 1)
      v = combine(kind, v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// Shared-memory address and stride (0 for a broadcast scalar) of an operand.
__device__ __forceinline__ const float* operand(const float* sc, const float* rows,
                                                int n_in, uint16_t code, int& stride) {
  const int kind = code >> 14, idx = code & 0x3fff;
  if (kind == 1) { stride = 0; return sc + idx; }
  stride = 1;
  return rows + (kind == 0 ? idx : n_in + idx) * TILE;
}

#define UNARY(OPC, EXPR)                                          \
  case OPC:                                                       \
    for (int e = threadIdx.x; e < TILE; e += THREADS) {           \
      const float x = A[e * sa];                                  \
      D[e] = (EXPR);                                              \
    }                                                             \
    break;

#define BINARY(OPC, EXPR)                                         \
  case OPC:                                                       \
    for (int e = threadIdx.x; e < TILE; e += THREADS) {           \
      const float a = A[e * sa], b = B[e * sb];                   \
      D[e] = (EXPR);                                              \
    }                                                             \
    break;

__device__ __forceinline__ float mod_floor(float a, float b) {
  float r = fmodf(a, b);            // torch.remainder / jnp.mod: divisor's sign
  if (r != 0.f && ((r < 0.f) != (b < 0.f))) r += b;
  return r;
}

__global__ void __launch_bounds__(THREADS)
split_pipeline_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  float* sc = smem;                               // scalars
  float* rows = smem + MAX_SCALARS;               // inputs, then slots
  float* scratch = rows + (p.n_in + p.n_slots) * TILE;
  const long long base = (long long)blockIdx.x * TILE;
  const long long n = p.n;

  for (int i = threadIdx.x; i < p.n_scalars; i += THREADS) sc[i] = p.scalars[i];
  for (int j = 0; j < p.n_in; ++j) {
    float* dst = rows + j * TILE;
    if (p.in_bool[j]) {
      const uint8_t* src = static_cast<const uint8_t*>(p.in[j]);
      for (int e = threadIdx.x; e < TILE; e += THREADS)
        dst[e] = (base + e < n && src[base + e]) ? 1.f : 0.f;
    } else {
      const float* src = static_cast<const float*>(p.in[j]);
      for (int e = threadIdx.x; e < TILE; e += THREADS)
        dst[e] = base + e < n ? src[base + e] : 0.f;
    }
  }
  __syncthreads();                                // scalars visible to all

  for (int pc = 0; pc < p.n_instr; ++pc) {
    const Instr ins = p.code[pc];
    int sa, sb, sc3;
    const float* A = operand(sc, rows, p.n_in, ins.a, sa);
    const float* B = operand(sc, rows, p.n_in, ins.b, sb);
    const float* C = operand(sc, rows, p.n_in, ins.c, sc3);
    float* D = rows + (p.n_in + ins.dst) * TILE;
    switch (ins.op) {
      UNARY(OP_COPY, x)
      UNARY(OP_NEG, -x)
      UNARY(OP_ABS, fabsf(x))
      UNARY(OP_EXP, expf(x))
      UNARY(OP_LOG, logf(x))
      UNARY(OP_LOG1P, log1pf(x))
      UNARY(OP_SQRT, sqrtf(x))
      UNARY(OP_ERF, erff(x))
      UNARY(OP_SIN, sinf(x))
      UNARY(OP_COS, cosf(x))
      UNARY(OP_TANH, tanhf(x))
      UNARY(OP_SIGN, x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f))
      UNARY(OP_ASIN, asinf(x))
      UNARY(OP_ACOS, acosf(x))
      UNARY(OP_EXPM1, expm1f(x))
      UNARY(OP_SQUARE, x * x)
      UNARY(OP_RECIP, 1.f / x)
      UNARY(OP_FLOOR, floorf(x))
      UNARY(OP_ISNAN, x != x ? 1.f : 0.f)
      UNARY(OP_NOT, x == 0.f ? 1.f : 0.f)
      UNARY(OP_BOOL, x != 0.f ? 1.f : 0.f)
      BINARY(OP_ADD, a + b)
      BINARY(OP_SUB, a - b)
      BINARY(OP_MUL, a * b)
      BINARY(OP_DIV, a / b)
      BINARY(OP_POW, powf(a, b))
      BINARY(OP_MAX, max_nan(a, b))
      BINARY(OP_MIN, min_nan(a, b))
      BINARY(OP_GT, a > b ? 1.f : 0.f)
      BINARY(OP_LT, a < b ? 1.f : 0.f)
      BINARY(OP_GE, a >= b ? 1.f : 0.f)
      BINARY(OP_LE, a <= b ? 1.f : 0.f)
      BINARY(OP_EQ, a == b ? 1.f : 0.f)
      BINARY(OP_NE, a != b ? 1.f : 0.f)
      BINARY(OP_AND, (a != 0.f && b != 0.f) ? 1.f : 0.f)
      BINARY(OP_OR, (a != 0.f || b != 0.f) ? 1.f : 0.f)
      BINARY(OP_ATAN2, atan2f(a, b))
      BINARY(OP_MOD, mod_floor(a, b))
      case OP_WHERE:
        for (int e = threadIdx.x; e < TILE; e += THREADS)
          D[e] = A[e * sa] != 0.f ? B[e * sb] : C[e * sc3];
        break;
      default:
        break;
    }
  }

  for (int j = 0; j < p.n_out; ++j) {
    int s;
    const float* V = operand(sc, rows, p.n_in, p.out_src[j], s);
    const uint8_t kind = p.out_kind[j];
    if (kind == OUT_F32) {
      float* o = static_cast<float*>(p.out[j]);
      for (int e = threadIdx.x; e < TILE; e += THREADS)
        if (base + e < n) o[base + e] = V[e * s];
    } else if (kind == OUT_BOOL) {
      uint8_t* o = static_cast<uint8_t*>(p.out[j]);
      for (int e = threadIdx.x; e < TILE; e += THREADS)
        if (base + e < n) o[base + e] = V[e * s] != 0.f;
    } else {
      float acc = identity(kind);
      for (int e = threadIdx.x; e < TILE; e += THREADS)
        if (base + e < n) acc = combine(kind, acc, V[e * s]);
      acc = block_reduce(kind, acc, scratch);
      if (threadIdx.x == 0) static_cast<float*>(p.out[j])[blockIdx.x] = acc;
    }
  }
}

}  // namespace

extern "C" {

int split_pipeline_params_size() { return (int)sizeof(Params); }
int split_pipeline_num_opcodes() { return OP_COUNT; }
int split_pipeline_tile() { return TILE; }
const char* split_pipeline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches one stage on ``stream`` (no synchronisation); returns the CUDA
// error code of the launch (0 on success).
// (The parameter block is passed as void*: a signature naming a type of the
// anonymous namespace would give this entry point internal linkage.)
int split_pipeline_launch(const void* params, int device, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  if (p.n <= 0 || p.n_in < 1 || p.n_in > MAX_IN || p.n_out > MAX_OUT ||
      p.n_scalars > MAX_SCALARS || p.n_instr > MAX_INSTR ||
      p.n_in + p.n_slots > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = (p.n + TILE - 1) / TILE;
  const size_t smem =
      (MAX_SCALARS + static_cast<size_t>(p.n_in + p.n_slots) * TILE + WARPS) *
      sizeof(float);
  err = cudaFuncSetAttribute(split_pipeline_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  split_pipeline_kernel<<<static_cast<unsigned>(grid), THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
