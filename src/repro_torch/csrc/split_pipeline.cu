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
// ~20 flop/B balance.  Every intermediate of the chain stays on chip, so
// traffic is the stage's inputs and escaping outputs only.  What stands
// between an interpreter and that bound is its own cost per instruction
// (decode, dispatch, operand traffic through shared memory) and exposed
// load latency; the design attacks both:
//
// * Persistent CTAs.  The grid is min(tiles, SMs x CTAs per SM); CTA b
//   walks tiles b, b + grid, ...  The program is decoded once per CTA into
//   shared memory: 16 bytes per instruction, the opcode with the slot row it
//   writes, and per operand one word, its shared-memory offset and flags
//   (input, slot, scalar, bool, forwarded).  The scalars are stored four
//   times over, so a scalar operand is read like a row quad (a broadcast),
//   with no stride multiply.
// * A TMA ring.  Each split input's tile is copied into a ring of stages in
//   shared memory with 1-D bulk copies (cp.async.bulk ...
//   mbarrier::complete_tx): thread 0 issues the copies of tile k + stages - 1
//   once every warp has released tile k - 1's stage (an empty mbarrier per
//   stage), and the warps wait on the stage's full mbarrier.  A ring row is
//   the input's tile itself: instructions read inputs there, nothing is
//   copied twice.  Bool inputs arrive as bytes and are widened to 1.0/0.0
//   when read.  A tile that bulk copies cannot take (a base that is not
//   16-byte aligned, the ragged last tile) is loaded by each thread, its
//   own elements only, with plain loads into the same ring; the wrapper's
//   rule (kernels/split_pipeline.py::load_paths) says which.  There is no
//   producer warp: its registers would cost a fifth of a 1024-element CTA's
//   allocation, and registers cap the CTAs per SM.  The tile size (512, 1024
//   or 2048) and the ring's depth (1-3) come from the wrapper's ``geometry``
//   rule, which maximises the warps resident per SM: the interpreter is
//   bound by issue and latency, and with one stage the other CTAs on the SM
//   hide a CTA's loads (PERF.md has the measured alternatives).
// * Wide dispatch.  Each thread owns VEC = 8 elements of a tile,
//   as two float4 quads TILE/2 elements apart (so a warp's 16-byte
//   shared-memory accesses are contiguous and conflict-free).  One decode
//   (read one instruction ahead) and one dispatch serve all 8 elements,
//   which are computed in registers; MUL, ADD and SUB, the commonest
//   opcodes, and unary opcodes take paths that read a forwarded operand in
//   place, without a register copy.
// * Register forwarding.  The lowering marks results read only by the next
//   instruction (kernels/program.py::assemble): their readers take them
//   from registers and the instruction writes no slot.  Other results go
//   to their slot row with 16-byte stores.  A thread only ever touches its
//   own elements of a row, so no barrier separates instructions.
// * Outputs.  Concat outputs leave from registers with 16-byte streaming
//   stores (bools as bytes); reductions combine each thread's elements in
//   order into a per-thread accumulator in shared memory, and the CTA
//   writes one partial per reduction at its end, which the wrapper
//   combines.  Out-of-range elements of the last tile are masked; no
//   padded copy is made.
//
// * Dtypes.  Inputs and outputs are bool, int8/16/32, uint8/16/32, float16,
//   bfloat16 or float32, each read and written at its own width (an input's
//   ring row holds its tile at that width, so a bulk copy moves exactly its
//   bytes).  In between every value is one 32-bit word in registers and slot
//   rows: a float-class value as the float32 it rounds to (a bool as
//   1.0/0.0), a signed integer sign-extended, an unsigned one
//   zero-extended; a 1- or 2-byte input's row is widened to words as an
//   operand is loaded.  That load path exists only in the kernel's NARROW
//   variant, launched for programs with such an input: a program of 32-bit
//   inputs runs the variant whose operand loads are plain 16-byte loads.  Each instruction carries the dtype it computes in and
//   the dtype of its result (kernels/program.py): float instructions
//   compute in float32 and round a float16/bfloat16 result after every
//   instruction, as torch's eager half ops do; integer instructions compute
//   with 32-bit wrapping arithmetic and wrap an 8/16-bit result; CAST
//   converts a word between dtypes.  The float32 path is the first
//   version's: its opcodes keep their numbers and their fast paths, and
//   the result dtype adds one test per instruction.
//
// Float arithmetic is IEEE float32 (never built with --use_fast_math), with
// the plain version's semantics (NaN-aware max/min, floor-mod, sign(0) = 0).
// Integer MOD is the floor mod with a zero divisor giving 0 (jnp.mod); POW
// of integers is exact (by squaring); comparisons of unsigned words are
// unsigned.  Reductions accumulate each thread's elements in the output's
// class (float32, or wrapping 32-bit integers) from its identity.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;              // elements per thread
constexpr int QUADS = VEC / 4;      // ... as float4 quads, TILE / QUADS apart
constexpr int MAX_IN = 16;
constexpr int MAX_OUT = 16;
constexpr int MAX_SCALARS = 64;
constexpr int MAX_INSTR = 256;
constexpr int MAX_ROWS = 56;        // split inputs + stored slots
constexpr int MAX_STAGES = 3;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a CTA may use
constexpr uint8_t NO_STORE = 0x80;  // kernels/program.py
constexpr int ABI_VERSION = 2;      // kernels/split_pipeline.py::ABI_VERSION

// Same order as OPCODES in kernels/program.py.
enum Op : uint8_t {
  OP_COPY, OP_NEG, OP_ABS, OP_EXP, OP_LOG, OP_LOG1P, OP_SQRT, OP_ERF, OP_SIN,
  OP_COS, OP_TANH, OP_SIGN, OP_ASIN, OP_ACOS, OP_EXPM1, OP_SQUARE, OP_RECIP,
  OP_FLOOR, OP_ISNAN, OP_NOT, OP_BOOL,
  OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_POW, OP_MAX, OP_MIN, OP_GT, OP_LT, OP_GE,
  OP_LE, OP_EQ, OP_NE, OP_AND, OP_OR, OP_ATAN2, OP_MOD,
  OP_WHERE,
  OP_CAST,
  OP_COUNT
};

// Same order as DTYPES in kernels/program.py.  A code below 8 is also the
// load/store format of a row (0: 32-bit words).
enum DType : uint8_t { DT_F32, DT_BOOL, DT_I8, DT_U8, DT_I16, DT_U16, DT_F16, DT_BF16,
                       DT_I32, DT_U32, DT_COUNT };
// Word classes.
enum Class : uint32_t { C_FLOAT, C_SIGNED, C_UNSIGNED };

__host__ __device__ inline uint32_t itemsize(uint32_t dt) {
  return (dt == DT_F32 || dt >= DT_I32) ? 4u : (dt >= DT_I16 ? 2u : 1u);
}
__host__ __device__ inline uint32_t dclass(uint32_t dt) {
  switch (dt) {
    case DT_I8: case DT_I16: case DT_I32: return C_SIGNED;
    case DT_U8: case DT_U16: case DT_U32: return C_UNSIGNED;
    default: return C_FLOAT;
  }
}
// What follows an instruction with result dtype ``dt``: 0 nothing, 1/2
// rounding to float16/bfloat16, 3/4 wrapping to int8/int16, 5/6 to
// uint8/uint16.
enum Post : uint32_t { P_NONE, P_F16, P_BF16, P_I8, P_I16, P_U8, P_U16 };
__host__ __device__ inline uint32_t post_of(uint32_t dt) {
  switch (dt) {
    case DT_F16: return P_F16;
    case DT_BF16: return P_BF16;
    case DT_I8: return P_I8;
    case DT_I16: return P_I16;
    case DT_U8: return P_U8;
    case DT_U16: return P_U16;
    default: return P_NONE;
  }
}

// out_kind: a concat output (0 or 1, stored at its dtype's width) or a
// reduction.
enum OutKind : uint8_t { OUT_F32, OUT_BOOL, OUT_ADD, OUT_MUL, OUT_MAX, OUT_MIN };
// A decoded concat output of 1- or 2-byte elements (not bool); a decoded
// 4-byte concat output (float32, int32, uint32) is OUT_F32.
constexpr uint32_t OUT_NARROW = 6;

// Operand kinds as the program encodes them (top two bits of an operand).
enum Kind : uint32_t { K_IN, K_SCALAR, K_SLOT, K_FWD };

// A decoded operand is one word: the byte offset of its row (of its scalar
// quad) in shared memory below bit 20, its row's format (a DType below 8)
// in bits 20-22, and flags.  F_ROW: a row, each thread reads its own
// quads; else every thread reads the same quad.  F_IN: an input row,
// offset from the current ring stage.  F_NARROW: a row of 1- or 2-byte
// elements (of the format's dtype).  F_FWD: the previous instruction's
// result, in registers.
constexpr uint32_t F_FWD = 1u << 31, F_ROW = 1u << 30, F_IN = 1u << 29, F_NARROW = 1u << 28;
constexpr uint32_t FMT_SHIFT = 20;
constexpr uint32_t ADDR = (1u << 20) - 1;
// Decoded instruction: x = opcode | class << 6 | STORE | post << 9 | slot
// row offset << 12, then the three operand words (for CAST the second is
// its conversion: source class << 2 | target kind, 0 float, 1 signed, 2
// unsigned, 3 bool).  The class field is the operand dtype's class, or
// F_POST for a float instruction rounding its result (and CAST): so the
// low byte is the bare opcode exactly for a float32 instruction, which the
// fast paths take with no rounding step.
constexpr uint32_t F_POST = 3;
constexpr uint32_t STORE = 1u << 8;

struct Instr {
  uint8_t op, dst;                  // dst: slot, or NO_STORE | register slot
  uint16_t a, b, c;                 // operands: kind << 14 | index
  uint8_t sdt, dt;                  // operand (compute) dtype, result dtype
};

struct Params {
  long long n;
  const void* in[MAX_IN];
  void* out[MAX_OUT];               // concat output, or partials[grid]
  int n_in, n_slots, n_scalars, n_instr, n_out;   // n_slots: stored slots
  int tile, stages, grid, aligned, smem;
  uint8_t in_dtype[MAX_IN];
  uint8_t out_kind[MAX_OUT];
  uint8_t out_dtype[MAX_OUT];       // concat: its dtype; reduction: its accumulator's
  uint16_t out_src[MAX_OUT];
  uint32_t scalars[MAX_SCALARS];    // 32-bit words at each scalar's dtype
  Instr code[MAX_INSTR];
};

// Shared memory: the ring's mbarriers (full[MAX_STAGES], empty[MAX_STAGES]),
// the scalars (each four times, so that a scalar operand is read like a
// row quad), the decoded program (one spare entry: the loop reads one
// instruction ahead), the decoded outputs, the reduction accumulators and
// scratch, then the ring (stages x one row per input, each at its input's
// width) and the stored slot rows (32-bit words).
// kernels/split_pipeline.py::smem_bytes mirrors this.
struct Layout {
  uint32_t scal, dec, outs, red, ring, stage_bytes, slots, total;
  uint32_t narrow;                  // bit j: input j has 1- or 2-byte elements
  bool any_red;                     // some output is a reduction
};

__host__ __device__ inline uint32_t align128(uint32_t x) { return (x + 127u) & ~127u; }

__host__ __device__ inline Layout layout(const Params& p) {
  bool any_red = false;
  for (int j = 0; j < p.n_out; ++j) any_red |= p.out_kind[j] >= OUT_ADD;
  const uint32_t cons = static_cast<uint32_t>(p.tile) / VEC;
  Layout L;
  L.any_red = any_red;
  L.scal = 16u * MAX_STAGES;
  L.dec = L.scal + 16u * p.n_scalars;
  L.outs = L.dec + 16u * (p.n_instr + 1);
  L.red = align128(L.outs + 8u * MAX_OUT);
  L.ring = align128(L.red + (any_red ? 4u * (p.n_out * cons + 32u) : 0u));
  L.stage_bytes = 0;
  L.narrow = 0;
  for (int j = 0; j < p.n_in; ++j) {
    L.stage_bytes += itemsize(p.in_dtype[j]) * p.tile;
    if (itemsize(p.in_dtype[j]) != 4u || p.in_dtype[j] == DT_BOOL) L.narrow |= 1u << j;
  }
  L.slots = L.ring + L.stage_bytes * p.stages;
  L.total = L.slots + 4u * p.tile * p.n_slots;
  return L;
}

// Byte offset of input ``j``'s row within a ring stage.
__device__ __forceinline__ uint32_t in_offset(const Params& p, int j, uint32_t tile) {
  uint32_t off = 0;
  for (int i = 0; i < j && i < MAX_IN; ++i) off += itemsize(p.in_dtype[i]) * tile;
  return off;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__device__ __forceinline__ float iw(int32_t x) { return __int_as_float(x); }
__device__ __forceinline__ float uw(uint32_t x) { return __uint_as_float(x); }

// A reduction's identity and combining step, as words of its class.
__device__ __forceinline__ float identity(uint32_t kind, uint32_t cls) {
  if (kind == OUT_ADD) return 0.f;  // the zero word in every class
  if (kind == OUT_MUL) return cls == C_FLOAT ? 1.f : uw(1u);
  if (cls == C_SIGNED) return iw(kind == OUT_MAX ? INT32_MIN : INT32_MAX);
  if (cls == C_UNSIGNED) return uw(kind == OUT_MAX ? 0u : 0xffffffffu);
  return kind == OUT_MAX ? -INFINITY : INFINITY;
}

__device__ __forceinline__ float combine(uint32_t kind, uint32_t cls, float a, float b) {
  if (cls == C_FLOAT) {
    switch (kind) {
      case OUT_MUL: return a * b;
      case OUT_MAX: return max_nan(a, b);
      case OUT_MIN: return min_nan(a, b);
      default: return a + b;
    }
  }
  const uint32_t x = __float_as_uint(a), y = __float_as_uint(b);
  switch (kind) {
    case OUT_MUL: return uw(x * y);
    case OUT_MAX:
      return cls == C_SIGNED ? iw(max((int32_t)x, (int32_t)y)) : uw(max(x, y));
    case OUT_MIN:
      return cls == C_SIGNED ? iw(min((int32_t)x, (int32_t)y)) : uw(min(x, y));
    default: return uw(x + y);
  }
}

__device__ __forceinline__ float mod_floor(float a, float b) {
  float r = fmodf(a, b);            // torch.remainder / jnp.mod: divisor's sign
  if (r != 0.f && ((r < 0.f) != (b < 0.f))) r += b;
  return r;
}

// -- mbarriers and bulk copies ------------------------------------------------

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
// ``bytes`` (a multiple of 16) from global ``src`` (16-byte aligned) to
// shared ``dst``; completion is counted on ``bar``.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}


// -- one instruction across a thread's VEC elements ----------------------------

// Element v of a thread sits at (v / 4) * TILE / QUADS + 4 ct + v % 4;
// ``toff`` is 16 ct, the byte offset of its first quad in a row.  Loads a
// decoded operand that is not forwarded.
// A row of 1- or 2-byte elements (format ``fmt``) widened to words.
template <int TILE>
__device__ __forceinline__ void load_narrow(uint32_t fmt, const unsigned char* row, uint32_t toff,
                                         float (&X)[VEC]) {
  if (itemsize(fmt) == 1) {
#pragma unroll
    for (int q = 0; q < QUADS; ++q) {
      const uint32_t b = *reinterpret_cast<const uint32_t*>(row + toff / 4 + q * (TILE / QUADS));
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const uint32_t e = (b >> (8 * v)) & 0xffu;
        X[4 * q + v] = fmt == DT_BOOL ? (e ? 1.f : 0.f)
                       : fmt == DT_I8 ? iw(static_cast<int8_t>(e)) : uw(e);
      }
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    const uint2 h = *reinterpret_cast<const uint2*>(row + toff / 2 + q * TILE);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const uint32_t e = ((v < 2 ? h.x : h.y) >> (16 * (v & 1))) & 0xffffu;
      float x;
      switch (fmt) {
        case DT_I16: x = iw(static_cast<int16_t>(e)); break;
        case DT_F16: x = __half2float(__ushort_as_half(static_cast<unsigned short>(e))); break;
        case DT_BF16: x = uw(e << 16); break;
        default: x = uw(e); break;
      }
      X[4 * q + v] = x;
    }
  }
}

template <int TILE, bool NARROW>
__device__ __forceinline__ void load(uint32_t w, const unsigned char* smem, uint32_t stage,
                                     uint32_t toff, float (&X)[VEC]) {
  const uint32_t a = (w & ADDR) + ((w & F_IN) ? stage : 0u);
  if (NARROW && (w & F_NARROW)) {
    load_narrow<TILE>((w >> FMT_SHIFT) & 7u, smem + a, toff, X);
    return;
  }
  const bool row = w & F_ROW;
  const uint32_t at = a + (row ? toff : 0u);
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    const float4 x = *reinterpret_cast<const float4*>(
        smem + at + (row ? q * (4u * TILE / QUADS) : 0u));
    X[4 * q] = x.x; X[4 * q + 1] = x.y; X[4 * q + 2] = x.z; X[4 * q + 3] = x.w;
  }
}

// Any decoded operand, forwarded ones copied from the result registers.
template <int TILE, bool NARROW>
__device__ __forceinline__ void fetch(uint32_t w, const unsigned char* smem, uint32_t stage,
                                      uint32_t toff, const float (&R)[VEC], float (&X)[VEC]) {
  if (w & F_FWD) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) X[v] = R[v];
  } else {
    load<TILE, NARROW>(w, smem, stage, toff, X);
  }
}

// R = f(a, b) with each forwarded operand read from R in place (no copy):
// the commonest opcodes take this path.
template <int TILE, bool NARROW, class F>
__device__ __forceinline__ void binary(F f, uint32_t wa, uint32_t wb, const unsigned char* smem,
                                       uint32_t stage, uint32_t toff, float (&R)[VEC]) {
  float A[VEC], B[VEC];
  if (wa & F_FWD) {
    if (wb & F_FWD) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) R[v] = f(R[v], R[v]);
    } else {
      load<TILE, NARROW>(wb, smem, stage, toff, B);
#pragma unroll
      for (int v = 0; v < VEC; ++v) R[v] = f(R[v], B[v]);
    }
  } else {
    load<TILE, NARROW>(wa, smem, stage, toff, A);
    if (wb & F_FWD) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) R[v] = f(A[v], R[v]);
    } else {
      load<TILE, NARROW>(wb, smem, stage, toff, B);
#pragma unroll
      for (int v = 0; v < VEC; ++v) R[v] = f(A[v], B[v]);
    }
  }
}

struct Mul { __device__ float operator()(float a, float b) const { return a * b; } };
struct Add { __device__ float operator()(float a, float b) const { return a + b; } };
struct Sub { __device__ float operator()(float a, float b) const { return a - b; } };

#define UNARY(OPC, EXPR)                                 \
  case OPC:                                              \
    _Pragma("unroll") for (int v = 0; v < VEC; ++v) {    \
      const float x = A[v];                              \
      R[v] = (EXPR);                                     \
    }                                                    \
    break;

#define BINARY(OPC, EXPR)                                \
  case OPC:                                              \
    _Pragma("unroll") for (int v = 0; v < VEC; ++v) {    \
      const float a = A[v], b = B[v];                    \
      R[v] = (EXPR);                                     \
    }                                                    \
    break;

__device__ __forceinline__ void apply(uint32_t op, const float (&A)[VEC], const float (&B)[VEC],
                                      const float (&C)[VEC], float (&R)[VEC]) {
  switch (op) {
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
    // OP_ADD, OP_SUB and OP_MUL take ``binary``
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
#pragma unroll
      for (int v = 0; v < VEC; ++v) R[v] = A[v] != 0.f ? B[v] : C[v];
      break;
    default:
      break;
  }
}

// Integer opcodes on 32-bit words (``uns``: the unsigned class).  Opcodes
// computing in float only (program.FLOAT_ONLY) never come here: the
// lowering casts their operands and the wrapper checks it.
#define IUNARY(OPC, EXPR)                                \
  case OPC:                                              \
    _Pragma("unroll") for (int v = 0; v < VEC; ++v) {    \
      const uint32_t a = __float_as_uint(A[v]);          \
      const int32_t sa = static_cast<int32_t>(a);        \
      (void)sa;                                          \
      R[v] = (EXPR);                                     \
    }                                                    \
    break;

#define IBINARY(OPC, EXPR)                               \
  case OPC:                                              \
    _Pragma("unroll") for (int v = 0; v < VEC; ++v) {    \
      const uint32_t a = __float_as_uint(A[v]), b = __float_as_uint(B[v]); \
      const int32_t sa = static_cast<int32_t>(a), sb = static_cast<int32_t>(b); \
      (void)sa; (void)sb;                                \
      R[v] = (EXPR);                                     \
    }                                                    \
    break;

__device__ __forceinline__ uint32_t imod(uint32_t a, uint32_t b, bool uns) {
  if (uns) return b ? a % b : 0u;
  const int32_t x = static_cast<int32_t>(a), y = static_cast<int32_t>(b);
  if (y == 0 || y == -1) return 0u;  // jnp.mod: 0 for a zero divisor; never INT_MIN % -1
  int32_t r = x % y;
  if (r != 0 && ((r < 0) != (y < 0))) r += y;
  return static_cast<uint32_t>(r);
}

__device__ __forceinline__ uint32_t ipow(uint32_t a, uint32_t b, bool uns) {
  if (!uns && static_cast<int32_t>(b) < 0) {
    const int32_t x = static_cast<int32_t>(a);
    return x == 1 ? 1u : (x == -1 ? ((b & 1u) ? 0xffffffffu : 1u) : 0u);
  }
  uint32_t acc = 1u;
  for (uint32_t e = b; e; e >>= 1, a *= a)
    if (e & 1u) acc *= a;
  return acc;
}

__device__ __forceinline__ void apply_int(uint32_t op, bool uns, const float (&A)[VEC],
                                       const float (&B)[VEC], const float (&C)[VEC],
                                       float (&R)[VEC]) {
  switch (op) {
    IUNARY(OP_COPY, A[v])
    IUNARY(OP_FLOOR, A[v])
    IUNARY(OP_NEG, uw(0u - a))
    IUNARY(OP_ABS, uw((!uns && sa < 0) ? 0u - a : a))
    IUNARY(OP_SIGN, uns ? uw(a != 0u) : iw((sa > 0) - (sa < 0)))
    IUNARY(OP_SQUARE, uw(a * a))
    IUNARY(OP_ISNAN, 0.f)
    IUNARY(OP_NOT, a == 0u ? 1.f : 0.f)
    IUNARY(OP_BOOL, a != 0u ? 1.f : 0.f)
    IBINARY(OP_ADD, uw(a + b))
    IBINARY(OP_SUB, uw(a - b))
    IBINARY(OP_MUL, uw(a * b))
    IBINARY(OP_POW, uw(ipow(a, b, uns)))
    IBINARY(OP_MAX, uns ? uw(max(a, b)) : iw(max(sa, sb)))
    IBINARY(OP_MIN, uns ? uw(min(a, b)) : iw(min(sa, sb)))
    IBINARY(OP_GT, (uns ? a > b : sa > sb) ? 1.f : 0.f)
    IBINARY(OP_LT, (uns ? a < b : sa < sb) ? 1.f : 0.f)
    IBINARY(OP_GE, (uns ? a >= b : sa >= sb) ? 1.f : 0.f)
    IBINARY(OP_LE, (uns ? a <= b : sa <= sb) ? 1.f : 0.f)
    IBINARY(OP_EQ, a == b ? 1.f : 0.f)
    IBINARY(OP_NE, a != b ? 1.f : 0.f)
    IBINARY(OP_AND, (a != 0u && b != 0u) ? 1.f : 0.f)
    IBINARY(OP_OR, (a != 0u || b != 0u) ? 1.f : 0.f)
    IBINARY(OP_MOD, uw(imod(a, b, uns)))
    case OP_WHERE:
#pragma unroll
      for (int v = 0; v < VEC; ++v) R[v] = A[v] != 0.f ? B[v] : C[v];
      break;
    default:
      break;
  }
}

// CAST: ``mode`` = source class << 2 | target kind (0 float, 1 signed,
// 2 unsigned, 3 bool); the rounding or wrapping to the target's width
// follows as the instruction's post step.  A float becomes an integer by
// truncation to 64 bits, then wrapping (as torch's ``.to``).
__device__ __forceinline__ void cast(uint32_t mode, const float (&A)[VEC], float (&R)[VEC]) {
  const uint32_t src = mode >> 2, dst = mode & 3u;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const float x = A[v];
    const uint32_t u = __float_as_uint(x);
    if (dst == 3u) {
      R[v] = (src == C_FLOAT ? x != 0.f : u != 0u) ? 1.f : 0.f;
    } else if (dst == 0u) {
      R[v] = src == C_FLOAT ? x
             : (src == C_SIGNED ? static_cast<float>(static_cast<int32_t>(u))
                                : static_cast<float>(u));
    } else {
      R[v] = src == C_FLOAT ? uw(static_cast<uint32_t>(static_cast<long long>(x))) : x;
    }
  }
}

// Round or wrap a result to its dtype (``Post``).
__device__ __forceinline__ void finish(uint32_t post, float (&R)[VEC]) {
  if (post == P_F16 || post == P_BF16) {     // two values per conversion
#pragma unroll
    for (int v = 0; v < VEC; v += 2) {
      float2 r;
      if (post == P_F16)
        r = __half22float2(__floats2half2_rn(R[v], R[v + 1]));
      else
        r = __bfloat1622float2(__floats2bfloat162_rn(R[v], R[v + 1]));
      R[v] = r.x;
      R[v + 1] = r.y;
    }
    return;
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const uint32_t u = __float_as_uint(R[v]);
    switch (post) {
      case P_F16: R[v] = __half2float(__float2half_rn(R[v])); break;
      case P_BF16: R[v] = __bfloat162float(__float2bfloat16_rn(R[v])); break;
      case P_I8: R[v] = iw(static_cast<int8_t>(u & 0xffu)); break;
      case P_I16: R[v] = iw(static_cast<int16_t>(u & 0xffffu)); break;
      case P_U8: R[v] = uw(u & 0xffu); break;
      case P_U16: R[v] = uw(u & 0xffffu); break;
      default: break;
    }
  }
}

template <int TILE>
__device__ __forceinline__ uint32_t decode_operand(const Params& p, const Layout& L,
                                                   uint32_t code) {
  const uint32_t kind = code >> 14, idx = code & 0x3fffu;
  switch (kind) {
    case K_IN: {
      const uint32_t dt = p.in_dtype[idx];
      return F_ROW | F_IN | ((L.narrow >> idx & 1u) ? F_NARROW | dt << FMT_SHIFT : 0u) |
             in_offset(p, idx, TILE);
    }
    case K_SCALAR:
      return L.scal + 16u * idx;
    case K_SLOT:
      return F_ROW | (L.slots + idx * 4u * TILE);
    default:
      return F_FWD;
  }
}

// One instruction that is not a float32 one, on its fetched operands: a
// float instruction whose result rounds to float16/bfloat16, an integer
// instruction (wrapping an 8/16-bit result) or a CAST (``mode`` its
// conversion); ``post`` rounds or wraps the result.
__device__ __forceinline__ void typed(uint32_t op, uint32_t mode, uint32_t post,
                                      const float (&A)[VEC], const float (&B)[VEC],
                                      const float (&C)[VEC], float (&R)[VEC]) {
  const uint32_t base = op & 63u, cls = op >> 6;
  if (base == OP_CAST) {
    cast(mode, A, R);
  } else if (cls == F_POST) {
    switch (base) {
      BINARY(OP_ADD, a + b)
      BINARY(OP_SUB, a - b)
      BINARY(OP_MUL, a * b)
      default:
        apply(base, A, B, C, R);
    }
  } else {
    apply_int(base, cls == C_UNSIGNED, A, B, C, R);
  }
  if (post) finish(post, R);
}

// A concat output of 1- or 2-byte elements from words: the thread's two
// quads as 4- or 8-byte stores, or element by element on a ragged tail.
template <int TILE>
__device__ __forceinline__ void store_narrow(uint32_t dt, unsigned char* out, long long first,
                                          long long n, bool whole, const float (&V)[VEC]) {
  const uint32_t es = itemsize(dt);
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    const long long at = first + q * (TILE / QUADS);
    uint32_t e[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float x = V[4 * q + v];
      e[v] = dt == DT_F16    ? __half_as_ushort(__float2half_rn(x))
             : dt == DT_BF16 ? (__float_as_uint(x) >> 16)
                             : (__float_as_uint(x) & (es == 1u ? 0xffu : 0xffffu));
    }
    if (es == 1u) {
      if (whole) {
        *reinterpret_cast<uint32_t*>(out + at) = e[0] | e[1] << 8 | e[2] << 16 | e[3] << 24;
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (at + v < n) out[at + v] = static_cast<unsigned char>(e[v]);
      }
    } else {
      uint16_t* o = reinterpret_cast<uint16_t*>(out) + at;
      if (whole) {
        *reinterpret_cast<uint2*>(o) = make_uint2(e[0] | e[1] << 16, e[2] | e[3] << 16);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (at + v < n) o[v] = static_cast<uint16_t>(e[v]);
      }
    }
  }
}

// CTAs per SM the register allocation must allow: a cap of REGS registers
// for each of a CTA's TILE / VEC threads (64 is the least that spills
// nothing).
constexpr int REGS = 64;
template <int TILE>
constexpr int min_ctas() { return 65536 / (REGS * (TILE / VEC)); }

template <int TILE, bool NARROW>
__global__ void __launch_bounds__(TILE / VEC, min_ctas<TILE>())
split_pipeline_kernel(const __grid_constant__ Params p) {
  constexpr int CONS = TILE / VEC;  // threads of the CTA
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(p);
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t full0 = sbase, empty0 = sbase + 8u * MAX_STAGES;
  uint4* dec = reinterpret_cast<uint4*>(smem + L.dec);
  uint2* odec = reinterpret_cast<uint2*>(smem + L.outs);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const long long n = p.n;
  const long long n_tiles = (n + TILE - 1) / TILE;
  const int stages = p.stages;
  const uint32_t stage_bytes = L.stage_bytes;

  // Decode the program once per CTA (the spare last entry is never executed).
  for (int i = threadIdx.x; i < p.n_scalars; i += blockDim.x) {
    const float w = uw(p.scalars[i]);
    reinterpret_cast<float4*>(smem + L.scal)[i] = make_float4(w, w, w, w);
  }
  for (int i = threadIdx.x; i <= p.n_instr; i += blockDim.x) {
    const Instr ins = i < p.n_instr ? p.code[i] : Instr{0, NO_STORE, 0, 0, 0, 0, 0};
    const uint32_t store = (ins.dst & NO_STORE) ? 0u : STORE | (L.slots + (ins.dst & 0x3fu) *
                                                                 4u * TILE) << 12;
    const bool is_cast = ins.op == OP_CAST;
    const uint32_t post = post_of(ins.dt) << 9;
    const uint32_t cls = (is_cast || (dclass(ins.sdt) == C_FLOAT && post)) ? F_POST
                                                                          : dclass(ins.sdt);
    const uint32_t b = is_cast ? (dclass(ins.sdt) << 2 |
                                  (ins.dt == DT_BOOL ? 3u : dclass(ins.dt)))
                               : decode_operand<TILE>(p, L, ins.b);
    dec[i] = make_uint4(ins.op | cls << 6 | post | store, decode_operand<TILE>(p, L, ins.a), b,
                        decode_operand<TILE>(p, L, ins.c));
  }
  for (int j = threadIdx.x; j < p.n_out; j += blockDim.x) {
    const uint32_t dt = p.out_dtype[j];
    const uint32_t kind = p.out_kind[j] >= OUT_ADD ? p.out_kind[j]
                          : dt == DT_BOOL          ? OUT_BOOL
                          : itemsize(dt) == 4u     ? OUT_F32
                                                   : OUT_NARROW;
    odec[j] = make_uint2(decode_operand<TILE>(p, L, p.out_src[j]), kind | dt << 8);
  }
  if (L.any_red)                    // each thread's reduction accumulators
    for (int j = 0; j < p.n_out; ++j)
      red[j * CONS + threadIdx.x] = identity(p.out_kind[j], dclass(p.out_dtype[j]));
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8u * s, 1);             // the issuing thread arrives
      mbar_init(empty0 + 8u * s, CONS / 32);    // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Thread ct owns elements q * TILE / QUADS + 4 ct .. + 3 of every row, for
  // each quad q.  Thread 0 also issues the bulk copies: tile k + stages - 1
  // of this CTA goes into the stage of tile k - 1 once every warp is done
  // with tile k - 1.
  const int ct = threadIdx.x, warp = ct / 32, lane = ct % 32;
  const uint32_t toff = 16u * ct;
  const long long step = gridDim.x;
  auto bulk = [&](long long t) {      // tile t takes bulk copies
    return p.aligned && t < n_tiles && (t + 1) * TILE <= n;
  };
  auto issue = [&](long long t, int s) {
    mbar_expect_tx(full0 + 8u * s, stage_bytes);
    uint32_t off = 0;
    for (int j = 0; j < p.n_in; ++j) {
      const uint32_t esize = itemsize(p.in_dtype[j]);
      bulk_load(sbase + L.ring + s * stage_bytes + off,
                static_cast<const unsigned char*>(p.in[j]) + t * TILE * esize, esize * TILE,
                full0 + 8u * s);
      off += esize * TILE;
    }
  };
  if (ct == 0)
    for (int k = 0; k < stages - 1; ++k)
      if (bulk(blockIdx.x + k * step)) issue(blockIdx.x + k * step, k);

  float R[VEC];                     // the previous instruction's result
#pragma unroll
  for (int v = 0; v < VEC; ++v) R[v] = 0.f;
  int s = 0, ahead = stages - 1;    // stages of tiles k and k + stages - 1
  uint32_t phase = 0, prev_phase = 1;   // parity of tile k's, k - 1's round
  for (long long t = blockIdx.x, k = 0; t < n_tiles; t += step, ++k) {
    const long long t_ahead = t + (stages - 1) * step;
    if (ct == 0 && bulk(t_ahead)) {
      if (k > 0) mbar_wait(empty0 + 8u * ahead, prev_phase);   // tile k - 1 released
      issue(t_ahead, ahead);
    }
    const uint32_t stage = L.ring + s * stage_bytes;
    if (bulk(t)) {
      mbar_wait(full0 + 8u * s, phase);
    } else {
      // Plain loads of this thread's own elements: any alignment, the
      // ragged tail zero-filled.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const long long first = t * TILE + 4 * ct;
      uint32_t off = 0;
      for (int j = 0; j < p.n_in; ++j) {
        unsigned char* row = smem + stage + off;
        const uint32_t esize = itemsize(p.in_dtype[j]);
        off += esize * TILE;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const int e = (v / 4) * (TILE / QUADS) + 4 * ct + v % 4;
          const long long i = first - 4 * ct + e;
          if (esize == 1u)
            row[e] = i < n ? static_cast<const unsigned char*>(p.in[j])[i] : 0;
          else if (esize == 2u)
            reinterpret_cast<uint16_t*>(row)[e] =
                i < n ? static_cast<const uint16_t*>(p.in[j])[i] : 0;
          else
            reinterpret_cast<uint32_t*>(row)[e] =
                i < n ? static_cast<const uint32_t*>(p.in[j])[i] : 0u;
        }
      }
    }

#pragma unroll 1
    for (int pc = 0; pc < p.n_instr; ++pc) {
      const uint4 d = dec[pc];
      const uint32_t op = d.x & 0xffu;
      // the commonest opcodes first, then the rest by a switch
      if (op == OP_MUL) {
        binary<TILE, NARROW>(Mul{}, d.y, d.z, smem, stage, toff, R);
      } else if (op == OP_ADD) {
        binary<TILE, NARROW>(Add{}, d.y, d.z, smem, stage, toff, R);
      } else if (op == OP_SUB) {
        binary<TILE, NARROW>(Sub{}, d.y, d.z, smem, stage, toff, R);
      } else if (op < OP_ADD && (d.y & F_FWD)) {
        apply(op, R, R, R, R);                     // float unary on the forwarded value
      } else {
        const uint32_t base = op & 63u;
        float A[VEC], B[VEC], C[VEC];
        fetch<TILE, NARROW>(d.y, smem, stage, toff, R, A);
        if (base >= OP_ADD && base <= OP_WHERE) fetch<TILE, NARROW>(d.z, smem, stage, toff, R, B);
        if (base == OP_WHERE) fetch<TILE, NARROW>(d.w, smem, stage, toff, R, C);
        if (op < 64u)
          apply(op, A, B, C, R);
        else
          typed(op, d.z, d.x >> 9 & 7u, A, B, C, R);   // halves, integers, CAST
      }
      if (d.x & STORE) {
        unsigned char* row = smem + (d.x >> 12) + toff;
#pragma unroll
        for (int q = 0; q < QUADS; ++q)
          *reinterpret_cast<float4*>(row + q * (4 * TILE / QUADS)) =
              make_float4(R[4 * q], R[4 * q + 1], R[4 * q + 2], R[4 * q + 3]);
      }
    }

    const long long first = t * TILE + 4 * ct;     // element 0 of this thread
    const bool whole = first + (QUADS - 1) * (TILE / QUADS) + 4 <= n;
    for (int j = 0; j < p.n_out; ++j) {
      const uint2 od = odec[j];
      float V[VEC];
      fetch<TILE, NARROW>(od.x, smem, stage, toff, R, V);
      const uint32_t kind = od.y & 0xffu;
      if (kind == OUT_F32) {
        float* o = static_cast<float*>(p.out[j]) + first;
#pragma unroll
        for (int q = 0; q < QUADS; ++q) {
          float* oq = o + q * (TILE / QUADS);
          if (whole) {
            __stcs(reinterpret_cast<float4*>(oq),
                   make_float4(V[4 * q], V[4 * q + 1], V[4 * q + 2], V[4 * q + 3]));
          } else {
#pragma unroll
            for (int v = 0; v < 4; ++v)
              if (first + q * (TILE / QUADS) + v < n) oq[v] = V[4 * q + v];
          }
        }
      } else if (kind == OUT_BOOL) {
        unsigned char* o = static_cast<unsigned char*>(p.out[j]) + first;
#pragma unroll
        for (int q = 0; q < QUADS; ++q) {
          unsigned char* oq = o + q * (TILE / QUADS);
          if (whole) {
            uint32_t b = 0u;
#pragma unroll
            for (int v = 0; v < 4; ++v) b |= (V[4 * q + v] != 0.f ? 1u : 0u) << (8 * v);
            *reinterpret_cast<uint32_t*>(oq) = b;
          } else {
#pragma unroll
            for (int v = 0; v < 4; ++v)
              if (first + q * (TILE / QUADS) + v < n) oq[v] = V[4 * q + v] != 0.f;
          }
        }
      } else if (kind == OUT_NARROW) {
        store_narrow<TILE>(od.y >> 8, static_cast<unsigned char*>(p.out[j]), first, n, whole, V);
      } else {
        const uint32_t cls = dclass(od.y >> 8);
        float acc = red[j * CONS + ct];
        if (cls == C_FLOAT) {
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            if (first + (v / 4) * (TILE / QUADS) + v % 4 < n) acc = combine(kind, C_FLOAT, acc, V[v]);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            if (first + (v / 4) * (TILE / QUADS) + v % 4 < n) acc = combine(kind, cls, acc, V[v]);
        }
        red[j * CONS + ct] = acc;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8u * s);   // this warp is done with the stage
    ahead = s;
    prev_phase = phase;
    if (++s == stages) s = 0, phase ^= 1u;
  }

  // One partial per reduction: the threads' accumulators, combined in a
  // fixed order.
  float* scratch = red + p.n_out * CONS;
  for (int j = 0; j < p.n_out; ++j) {
    const uint32_t kind = p.out_kind[j], cls = dclass(p.out_dtype[j]);
    if (kind < OUT_ADD) continue;
    float v = red[j * CONS + ct];
    for (int off = 16; off > 0; off >>= 1)
      v = combine(kind, cls, v, __shfl_down_sync(0xffffffffu, v, off));
    __syncthreads();                // scratch free from the previous reduction
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    if (ct == 0) {
      for (int w = 1; w < CONS / 32; ++w) v = combine(kind, cls, v, scratch[w]);
      static_cast<float*>(p.out[j])[blockIdx.x] = v;
    }
  }
}

template <int TILE, bool NARROW>
cudaError_t allow_smem(int device) {
  static bool done[64] = {};        // per device: the attribute is set once
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(split_pipeline_kernel<TILE, NARROW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_LIMIT);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

template <int TILE, bool NARROW>
cudaError_t occupancy(int smem, int device, int* blocks) {
  cudaError_t err = allow_smem<TILE, NARROW>(device);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks,
                                                       split_pipeline_kernel<TILE, NARROW>,
                                                       TILE / VEC, smem);
}

template <int TILE, bool NARROW>
cudaError_t launch(const Params& p, int device, cudaStream_t stream) {
  cudaError_t err = allow_smem<TILE, NARROW>(device);
  if (err != cudaSuccess) return err;
  split_pipeline_kernel<TILE, NARROW><<<p.grid, TILE / VEC, p.smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool NARROW>
cudaError_t occupancy_of(int tile, int smem, int device, int* blocks) {
  switch (tile) {
    case 2048: return occupancy<2048, NARROW>(smem, device, blocks);
    case 1024: return occupancy<1024, NARROW>(smem, device, blocks);
    case 512: return occupancy<512, NARROW>(smem, device, blocks);
    default: return cudaErrorInvalidValue;
  }
}

template <bool NARROW>
cudaError_t launch_of(const Params& p, int device, cudaStream_t stream) {
  switch (p.tile) {
    case 2048: return launch<2048, NARROW>(p, device, stream);
    case 1024: return launch<1024, NARROW>(p, device, stream);
    case 512: return launch<512, NARROW>(p, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

}  // namespace

extern "C" {

int split_pipeline_params_size() { return (int)sizeof(Params); }
int split_pipeline_num_opcodes() { return OP_COUNT; }
int split_pipeline_vec() { return VEC; }
int split_pipeline_abi_version() { return ABI_VERSION; }
int split_pipeline_num_dtypes() { return DT_COUNT; }
const char* split_pipeline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// CTAs of ``tile`` elements that fit on one SM with ``smem`` bytes of
// dynamic shared memory each (>= 0), or minus a CUDA error code; ``narrow``
// picks the variant for programs with a 1- or 2-byte input.
int split_pipeline_occupancy(int tile, int smem, int device, int narrow) {
  cudaError_t err = use_device(device);
  int blocks = 0;
  if (err == cudaSuccess)
    err = narrow ? occupancy_of<true>(tile, smem, device, &blocks)
                 : occupancy_of<false>(tile, smem, device, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Launches one stage on ``stream`` (no synchronisation); returns the CUDA
// error code of the launch (0 on success).
// (The parameter block is passed as void*: a signature naming a type of the
// anonymous namespace would give this entry point internal linkage.)
int split_pipeline_launch(const void* params, int device, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  for (int j = 0; j < p.n_in && j < MAX_IN; ++j)
    if (p.in_dtype[j] >= DT_COUNT) return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < p.n_out && j < MAX_OUT; ++j)
    if (p.out_dtype[j] >= DT_COUNT) return static_cast<int>(cudaErrorInvalidValue);
  if (p.n <= 0 || p.n_in < 1 || p.n_in > MAX_IN || p.n_out > MAX_OUT ||
      p.n_scalars > MAX_SCALARS || p.n_instr > MAX_INSTR ||
      p.n_in + p.n_slots > MAX_ROWS || p.stages < 1 || p.stages > MAX_STAGES ||
      p.grid < 1 || p.smem > SMEM_LIMIT || static_cast<uint32_t>(p.smem) < layout(p).total)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(layout(p).narrow ? launch_of<true>(p, device, st)
                                           : launch_of<false>(p, device, st));
}

}  // extern "C"
