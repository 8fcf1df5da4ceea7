// Shared pieces of the bf16 operand mode of the EPS kernels for Hopper
// (sm_90a): the *_bf16 entries of eps_fwd.cu, eps_dcore.cu and
// eps_dviews_t.cu, the port of the TPU kernels' mm_dtype = bfloat16
// (dctn_tpu/pallas/eps_pallas.py:227-391).
//
// The mode. The Khatri-Rao operands (u, and kr2 = g * v) are formed in
// float32, as the f32 mode forms them, and only then rounded to bf16 (to
// nearest even, __float2bfloat16_rn); cmt is read as bf16 (the wrapper
// rounds the float32 parameter once per call). One bf16 product per pair:
// the product of two bf16 values is exact in float32, so the result
// differs from a float32 sum of the rounded operands only in the order of
// the sums. Every sum is float32. At 989 TFLOP/s dense bf16 on an H100 SXM
// (700 W) against 495/3 = 165 for 3xTF32.
//
// Fragments of mma.m16n8k16 (bf16): thread (g = lane / 4, tig = lane % 4)
// holds A rows g and g + 8 at K columns 2 tig, 2 tig + 1 and 2 tig + 8,
// 2 tig + 9 (four registers of two bf16: (g, 2tig), (g + 8, 2tig),
// (g, 2tig + 8), (g + 8, 2tig + 8)); B column g at K rows 2 tig, 2 tig + 1
// and 2 tig + 8, 2 tig + 9 (two registers); the f32 sums c[0..1] at row g,
// columns 2 tig and 2 tig + 1, c[2..3] at row g + 8. The kernels stage both
// operands K-contiguous in shared memory, a step of K values in rows of
// K / 2 + 4 words (op_words: the eight rows of a fragment fall on distinct
// banks), so each register is one 32-bit load.
//
// Accumulation. The tensor cores truncate as they add into a fragment
// (tf32x3.cuh); the kernels sum one step of K (at most 128 values) in a
// fragment and then add it into float32 totals with ordinary adds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16op {

// limits shared by the three sources' bf16 entries (the Python wrappers
// check them first): n*q staged factor rows, q^(n-n1) rows of v, 227 KB of
// shared memory a block
constexpr int kMaxFactorRows = 256;
constexpr long long kMaxB2 = 512;
constexpr long long kMaxSmemBytes = 227 * 1024;

__host__ __device__ constexpr long long ipow(long long base, int exp) {
  long long r = 1;
  for (int i = 0; i < exp; ++i) r *= base;
  return r;
}

// bf16 a row of an operand tile 32 K values deep (eps_dcore.cu's step)
constexpr int kOpStride = 40;
constexpr int kOpWords = kOpStride / 2;

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x rounded to bf16, to nearest even, as its 16 bits
__device__ __forceinline__ uint16_t to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// two values rounded to bf16 and packed, lo in the low half (the element
// of the lower K index, as the fragments take it)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return static_cast<uint32_t>(to_bf16(lo)) | (static_cast<uint32_t>(to_bf16(hi)) << 16);
}

// a bf16 value (its 16 bits) in float32, exact
__device__ __forceinline__ float widen(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// the words a row of an operand tile staged kChunk K values deep takes: 4
// more than the step's, so that (kChunk / 2 + 4) mod 32 is 4 and the eight
// rows of a fragment fall on distinct banks (kChunk a multiple of 64, or
// 32: kOpWords)
template <int kChunk>
constexpr int op_words() { return kChunk / 2 + 4; }

// the A fragment of the 16 rows at `rows` (row-major, K contiguous, kWords
// words a row), K step at word `k2` (= K column / 2)
template <int kWords = kOpWords>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint32_t* rows, int k2) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const uint32_t* p = rows + g * kWords + k2 + tig;
  a[0] = p[0];
  a[1] = p[8 * kWords];
  a[2] = p[4];
  a[3] = p[8 * kWords + 4];
}

// the B fragment of the 8 columns at `cols` (one row of K values each, K
// contiguous, kWords words a row), K step at word `k2`
template <int kWords = kOpWords>
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const uint32_t* cols, int k2) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const uint32_t* p = cols + g * kWords + k2 + tig;
  b[0] = p[0];
  b[1] = p[4];
}

// rows x kChunk bf16 of a row-major (.., ld) bf16 matrix at (r0, c0) into
// an operand tile of kWords words a row, zeros past rows_valid and ld: as
// 16-byte copies where `vec` (ld a multiple of 8, the base 16-byte aligned;
// c0 a multiple of 8), else one value at a time
template <int kChunk, int kWords, int kThreads>
__device__ __forceinline__ void stage_rows(uint32_t* tile, const uint16_t* __restrict__ m,
                                           long long r0, int rows, int rows_valid, long long c0,
                                           long long ld, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kVecs = kChunk / 8;  // 16-byte vectors a row
    for (int i = tid; i < rows * kVecs; i += kThreads) {
      const int r = i / kVecs, v = i % kVecs;
      const long long c = c0 + 8 * v;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid && c < ld)
        val = *reinterpret_cast<const uint4*>(m + (r0 + r) * ld + c);
      *reinterpret_cast<uint4*>(tile + r * kWords + 4 * v) = val;
    }
  } else {
    uint16_t* h = reinterpret_cast<uint16_t*>(tile);
    for (int i = tid; i < rows * kChunk; i += kThreads) {
      const int r = i / kChunk, c = i % kChunk;
      uint16_t val = 0;
      if (r < rows_valid && c0 + c < ld) val = m[(r0 + r) * ld + c0 + c];
      h[r * 2 * kWords + c] = val;
    }
  }
}

// lets `kernel` take up to 227 KB of dynamic shared memory (a host call of
// about a microsecond, made before each launch)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
}

}  // namespace bf16op
