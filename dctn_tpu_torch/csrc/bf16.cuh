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
//
// Every bf16 mode runs wgmma (below: m64n64k16 and m64n128k16 with both
// operands K-major in shared memory, in the 128-byte swizzle of
// smem_desc_sw128). K1's and eps_dcore's form u (eps_dcore also kr2) once a
// pixel into device memory, a chunk of pixels at a time, each entry's chain
// by suffix_chains; the product kernels stream the rounded operands through
// a cp.async ring. The d_views kernels build their operand per step.

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
// rows of a fragment fall on distinct banks (kChunk a multiple of 64)
template <int kChunk>
constexpr int op_words() { return kChunk / 2 + 4; }

// the A fragment of the 16 rows at `rows` (row-major, K contiguous, kWords
// words a row), K step at word `k2` (= K column / 2)
template <int kWords>
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
template <int kWords>
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

// --- wgmma (sm_90a) on bf16, both operands K-major in shared memory (the
// fences, commit and wait are tf32x3.cuh's)

// d (64 x 64 over the warpgroup, f32) (+)= a (64 x 16) * b (16 x 64, stored
// as 64 rows of K), bf16 in, both K-major in shared memory (no transpose);
// d = a * b where scale_d is 0. Thread (warp w of the warpgroup, g = lane /
// 4, tig = lane % 4) holds d[4 j + e] at row 16 w + g (+8 for e >= 2),
// column 8 j + 2 tig (+1 for odd e).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a_desc, uint64_t b_desc,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// d (64 x 128 over the warpgroup, f32) (+)= a (64 x 16) * b (16 x 128, stored
// as 128 rows of K), bf16 in, both K-major in shared memory (no transpose);
// d = a * b where scale_d is 0. Thread (warp w of the warpgroup, g = lane /
// 4, tig = lane % 4) holds d[4 j + e] at row 16 w + g (+8 for e >= 2),
// column 8 j + 2 tig (+1 for odd e).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a_desc, uint64_t b_desc,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// The descriptor of a K-major bf16 tile in the 128-byte swizzle: row r's
// 64 values (128 bytes) at 128 r, its 16-byte chunk c stored at chunk c ^
// (r % 8); 8-row groups 1024 bytes apart (SBO; LBO is unused in a swizzled
// K-major layout). The tile is 1024-byte aligned; its k16 step k starts 32 k
// bytes in.
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFFu) >> 4) | (1ULL << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ULL << 62);
}

// where 16-byte chunk c of row r of a 128-byte swizzled tile lies
__device__ __forceinline__ int sw128_offset(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// keeps the compiler from moving reads or writes of d across the
// asynchronous products
__device__ __forceinline__ void wgmma_pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// cp.async of 16 bytes from a 16-byte aligned src
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// n / d for a runtime divisor d >= 1 and 0 <= n < 2^31 with one 64-bit
// multiply (the round-up method of Granlund and Montgomery): m = ceil(2^p /
// d), p = 31 + ceil(log2 d); m < 2^33, so n * m fits 64 bits, and the error
// of m is below 2^(p - 31), so the floor is exact
struct FastDiv {
  unsigned long long m;
  int p;
  __host__ explicit FastDiv(long long d) {
    int l = 0;
    while ((1LL << l) < d) ++l;
    p = 31 + l;
    m = ((1ULL << p) + static_cast<unsigned long long>(d) - 1) / static_cast<unsigned long long>(d);
  }
  __device__ __forceinline__ int operator()(int n) const {
    return static_cast<int>((static_cast<unsigned long long>(n) * m) >> p);
  }
};

// x0[i], x1[i] (pixels j and j + 1) times the chain of the factors `first`
// down to `last` at the digits of rem[i] (the least significant digit is
// factor first's), in the JAX suffix chain's order: f_last[..] * (... *
// (f_first[..] * x)). Factor k's row for digit d lies at (k q + d) * stride
// floats of fac. The rows' loads are interleaved a factor at a time, so that
// their latencies overlap; rem is consumed. The operands kernels of K1 and
// eps_dcore form their u (and kr2's v) by it.
template <int kRows>
__device__ __forceinline__ void suffix_chains(float (&x0)[kRows], float (&x1)[kRows],
                                              int (&rem)[kRows], const float* fac, int stride,
                                              int j, int first, int last, int q,
                                              const FastDiv& div_q) {
  for (int k = first; k >= last; --k) {
    float2 f[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int next = div_q(rem[i]);
      f[i] = *reinterpret_cast<const float2*>(fac + (k * q + rem[i] - next * q) * stride + j);
      rem[i] = next;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      x0[i] = f[i].x * x0[i];
      x1[i] = f[i].y * x1[i];
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
