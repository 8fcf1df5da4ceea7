// Shared pieces of the float32-accurate tensor-core kernels for Hopper
// (sm_90a): eps_dcore.cu and eps_dviews_t.cu.
//
// 3xTF32. A TF32 operand keeps 10 explicit mantissa bits, so one TF32
// product of float32 data is good to about 1e-3. Split each value x into
//   hi = rna_tf32(x),  lo = x - hi
// (x - hi is exact in float32; the tensor cores read its top 19 bits, so
// hi + lo carries 21-22 significant bits) and
// issue three products into the same float32 accumulator:
//   lo_a*hi_b + hi_a*lo_b + hi_a*hi_b
// (the dropped lo_a*lo_b is below 2^-22 of the product). That is the accuracy
// of a float32 FMA GEMM at a third of the TF32 tensor-core rate: 495/3 = 165
// TFLOP/s dense on an H100 SXM (of which mma.sync reaches about half),
// against 67 TFLOP/s for float32 FMA on the CUDA cores.
//
// Accumulation. The tensor cores add each product into the f32 fragment
// with truncation, not rounding to nearest: over tens of thousands of mma
// into one fragment the sum drifts toward zero (4e-4 of the largest entry of
// d_cmt over 67,712 pixels, measured on an H100). So the kernels sum at
// most 4 steps of 32 K values (48 mma: a drift below 3e-6) in the fragments
// and then add them into f32 totals with ordinary adds, which round to
// nearest.
//
// Fragments. In mma.m16n8k8 thread (g = lane / 4, tig = lane % 4) holds A
// rows g and g + 8 at K columns tig and tig + 4, and B column g at K rows
// tig and tig + 4. The kernels read two adjacent K values per load (a
// float2) and map K column tig to the first and tig + 4 to the second, for
// both operands alike, so the product sums the same terms as the plain
// version, in another order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// round to TF32, to nearest with ties away from zero (what cvt.rna.tf32.f32
// computes, in two integer operations: the conversion instruction runs on a
// slow pipe and held the operand builds back); the result is a float32 whose
// low 13 mantissa bits are 0
__device__ __forceinline__ float round_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// x as the hi and lo TF32 operands of an mma fragment register: hi in TF32,
// lo = x - hi exact in float32 (|lo| <= 2^-11 |x|), of which the tensor
// cores read the top 19 bits, an error below 2^-21 |x|
__device__ __forceinline__ void split_frag(float x, uint32_t& hi, uint32_t& lo) {
  const float h = round_tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(x - h);
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i][j] += (a_hi[i] + a_lo[i])(b_hi[j] + b_lo[j]) for every fragment pair,
// without a_lo*b_lo: all the lo*hi products, then all hi*lo, then all hi*hi,
// so that the three products into one fragment are MI*NJ mma apart and not
// waiting on each other.
template <int MI, int NJ>
__device__ __forceinline__ void mma3_tiles(float (&d)[MI][NJ][4], const uint32_t (&a_hi)[MI][4],
                                           const uint32_t (&a_lo)[MI][4],
                                           const uint32_t (&b_hi)[NJ][2],
                                           const uint32_t (&b_lo)[NJ][2]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma(d[i][j], a_lo[i], b_hi[j]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma(d[i][j], a_hi[i], b_lo[j]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma(d[i][j], a_hi[i], b_hi[j]);
}

// d[j] += (a_hi + a_lo)(b_hi[j] + b_lo[j]) along one row of fragments, in
// the order of mma3_tiles
template <int NJ>
__device__ __forceinline__ void mma3_row(float (&d)[NJ][4], const uint32_t (&a_hi)[4],
                                         const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[NJ][2],
                                         const uint32_t (&b_lo)[NJ][2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma(d[j], a_lo, b_hi[j]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma(d[j], a_hi, b_lo[j]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma(d[j], a_hi, b_hi[j]);
}

// cp.async of `bytes` (0 or 4) from src, zero-filling the rest of 4 bytes
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

// cp.async of `bytes` (0 to 16, a multiple of 4) from a 16-byte aligned src,
// zero-filling the rest of 16 bytes
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace tf32x3
