// Shared pieces of the float32-accurate tensor-core kernels for Hopper
// (sm_90a): eps_fwd.cu, eps_dcore.cu and eps_dviews_t.cu; the int8 forward
// (eps_fwd_q8.cu) takes its wgmma pieces (descriptors, fences, commit and
// wait, and the s8 product at the end) from here too.
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

// waits until at most kPending of this thread's latest cp.async groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// --- wgmma (sm_90a): warpgroup products with both operands in shared memory

// The descriptor of a K-major operand tile without swizzle: core matrices of
// 8 rows x 16 bytes (4 TF32 values), the two of a k8 step `kLbo` bytes apart
// along K, row groups of 8 `kSbo` bytes apart. The tile starts at p.
template <int kLbo, int kSbo>
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(kLbo >> 4) << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32);
}

// d (64 x 128 over the warpgroup, f32) += a (64 x 8) * b (8 x 128, stored
// as 128 rows of K), TF32 in. Thread (warp w of the warpgroup, g = lane / 4,
// tig = lane % 4) holds d[4 j + e] at row 16 w + g (+8 for e >= 2), column
// 8 j + 2 tig (+1 for odd e), as mma.sync's fragments side by side.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t a_desc, uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(1));
}

// before a warpgroup's first wgmma after its registers were touched
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits for every wgmma this warpgroup committed
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// waits until at most kPending of this warpgroup's latest wgmma groups are in flight
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keeps the compiler from moving reads or writes of d across the
// asynchronous products
__device__ __forceinline__ void wgmma_pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// makes this thread's shared-memory writes visible to the wgmma that read them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma on int8 (eps_fwd_q8.cu)

// d (64 x 256 over the warpgroup, s32) += a (64 x 32) * b (32 x 256, stored
// as 256 rows of K), s8 x s8, both operands K-major in shared memory (the
// only layout wgmma takes for 8-bit types); d = a * b when scale_d is 0. A
// k32 step of int8 is 32 bytes deep: two core matrices of 8 rows x 16 bytes
// along K, as a k8 step of TF32. Thread (warp w of the warpgroup, g = lane /
// 4, tig = lane % 4) holds d[4 j + e] at row 16 w + g (+8 for e >= 2),
// column 8 j + 2 tig (+1 for odd e), as wgmma_m64n128k8 does. The sums are
// exact: int32, no rounding.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t a_desc, uint64_t b_desc,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// keeps the compiler from moving reads or writes of d across the
// asynchronous products
__device__ __forceinline__ void wgmma_pin(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

}  // namespace tf32x3
