// EPS forward for Hopper (sm_90a): the serving forward of one EPS layer in
// the fast (cmt) parameter layout.
//
// Replaces the TPU kernel _fwd_kernel_factory (dctn_tpu/pallas/eps_pallas.py:227)
// in its save_t=False form. For one output channel o and pixel p:
//   u[a, p]   = prod_{k < n1}  views[k, digit_k(a), p]     (A  = q^n1 rows)
//   t[b, p]   = sum_a cmt[o*B2 + b, a] * u[a, p]            (B2 = q^(n-n1))
//   v[b, p]   = prod_{k >= n1} views[k, digit_k(b), p]
//   out[o, p] = sum_b t[b, p] * v[b, p]                     (out = t if n2 == 0)
// Digits are row-major: factor 0 (resp. n1) is the slowest-varying digit.
//
// What bounds it on this card: the t = cmt.u product, 2*Z*A flops per pixel
// (about 255 GFLOP for the flagship forward at batch 128), run in float32 on
// the CUDA cores (67 TFLOP/s peak on an H100 SXM at 700 W). The TPU kernel
// keeps the whole (Z, A) core resident in VMEM; here the flagship's second
// layer core is 1536 x 1024 f32 (6.3 MB), far above the 227 KB a block may
// hold, so the core is streamed in column chunks.
//
// Design: one CTA per (64-pixel tile, output channel o). The CTA stages its
// tile of every factor in shared memory once, then loops over A in chunks of
// 32 columns: it stages the chunk of cmt rows [o*B2, (o+1)*B2) and builds the
// matching 32 x 64 block of u from the staged factors, then every thread
// accumulates an 8 (b) x 8 (pixel) register tile of t in f32 FMA. The
// epilogue forms v from the staged factors, contracts each thread's tile over
// its b rows, and sums the per-thread partials across the CTA in shared
// memory in a fixed order. No atomics and no cross-CTA sums: the result is
// deterministic. t never leaves registers (the TPU kernel's optional t output
// belongs to the training backward and is not built here).
//
// Limits (checked by the Python wrapper, again here): B2 <= 512 (one 8-row
// register tile per thread, at most 512 threads); n*q <= 256 staged factor
// rows; O <= 65535 (grid.y).

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kTilePix = 64;                      // pixels per CTA
constexpr int kRowsPerThread = 8;                 // b rows per thread
constexpr int kPixPerThread = 8;                  // pixels per thread
constexpr int kThreadsPerRowGroup = kTilePix / kPixPerThread;  // 8
constexpr int kChunkA = 32;                       // A columns per chunk
constexpr int kCmtStride = kChunkA + 1;           // pad: no bank conflicts
constexpr int kMaxThreads = 512;
constexpr int kMaxB2 = kMaxThreads / kThreadsPerRowGroup * kRowsPerThread;
constexpr int kMaxFactorRows = 256;               // n * q
// dynamic shared memory at the limits above: staged factors, the u chunk,
// the cmt chunk and the reduction rows (157,696 B of the 227 KB a block has)
constexpr size_t kMaxSmemBytes =
    sizeof(float) * (kMaxFactorRows * kTilePix + kChunkA * kTilePix +
                     kMaxB2 * kCmtStride +
                     kMaxThreads / kThreadsPerRowGroup * kTilePix);
static_assert(kMaxSmemBytes <= 227 * 1024, "over a Hopper block's shared memory");
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kMaxThreads)
eps_fwd_kernel(const float* __restrict__ views, const float* __restrict__ cmt,
               float* __restrict__ out, int n, int q, int n1, int a_dim,
               int b2, long long npix) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nthreads = blockDim.x;
  const int row_groups = nthreads / kThreadsPerRowGroup;
  const int rows = row_groups * kRowsPerThread;   // b2 rounded up
  float* vs = smem;                               // (n*q, kTilePix)
  float* us = vs + n * q * kTilePix;              // (kChunkA, kTilePix)
  float* cs = us + kChunkA * kTilePix;            // (rows, kCmtStride)
  float* red = cs + rows * kCmtStride;            // (row_groups, kTilePix)

  const int tid = threadIdx.x;
  const int tp = tid % kThreadsPerRowGroup;
  const int tb = tid / kThreadsPerRowGroup;
  const long long p0 = static_cast<long long>(blockIdx.x) * kTilePix;
  const int o = blockIdx.y;

  for (int i = tid; i < n * q * kTilePix; i += nthreads) {
    const int p = i % kTilePix;
    const long long gp = p0 + p;
    vs[i] = gp < npix ? views[static_cast<long long>(i / kTilePix) * npix + gp]
                      : 0.f;
  }

  float acc[kRowsPerThread][kPixPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kPixPerThread; ++j) acc[i][j] = 0.f;

  const float* cmt_o = cmt + static_cast<long long>(o) * b2 * a_dim;
  for (int a0 = 0; a0 < a_dim; a0 += kChunkA) {
    __syncthreads();  // the previous chunk is consumed; vs is staged
    for (int i = tid; i < rows * kChunkA; i += nthreads) {
      const int a = i % kChunkA;
      const int b = i / kChunkA;
      cs[b * kCmtStride + a] =
          (b < b2 && a0 + a < a_dim)
              ? cmt_o[static_cast<long long>(b) * a_dim + a0 + a]
              : 0.f;
    }
    for (int i = tid; i < kChunkA * kTilePix; i += nthreads) {
      const int p = i % kTilePix;
      const int a = a0 + i / kTilePix;
      float prod = 0.f;
      if (a < a_dim) {
        // the JAX suffix chain's order: f_{n1-1} first, f_0 last
        prod = 1.f;
        int rem = a;
        for (int k = n1 - 1; k >= 0; --k) {
          const int d = rem % q;
          rem /= q;
          prod *= vs[(k * q + d) * kTilePix + p];
        }
      }
      us[i] = prod;
    }
    __syncthreads();
#pragma unroll 4
    for (int a = 0; a < kChunkA; ++a) {
      float cv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        cv[i] = cs[(tb * kRowsPerThread + i) * kCmtStride + a];
      const float4 u0 =
          *reinterpret_cast<const float4*>(&us[a * kTilePix + tp * kPixPerThread]);
      const float4 u1 = *reinterpret_cast<const float4*>(
          &us[a * kTilePix + tp * kPixPerThread + 4]);
      const float uv[kPixPerThread] = {u0.x, u0.y, u0.z, u0.w,
                                       u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kPixPerThread; ++j)
          acc[i][j] = fmaf(cv[i], uv[j], acc[i][j]);
    }
  }

  // epilogue: contract this thread's t rows with v, then sum across the CTA
  float part[kPixPerThread];
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) part[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int b = tb * kRowsPerThread + i;
    if (b < b2) {
      float v[kPixPerThread];
#pragma unroll
      for (int j = 0; j < kPixPerThread; ++j) v[j] = 1.f;
      int rem = b;
      for (int k = n - 1; k >= n1; --k) {
        const int d = rem % q;
        rem /= q;
        const float* f = &vs[(k * q + d) * kTilePix + tp * kPixPerThread];
#pragma unroll
        for (int j = 0; j < kPixPerThread; ++j) v[j] *= f[j];
      }
#pragma unroll
      for (int j = 0; j < kPixPerThread; ++j)
        part[j] = fmaf(acc[i][j], v[j], part[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j)
    red[tb * kTilePix + tp * kPixPerThread + j] = part[j];
  __syncthreads();
  for (int p = tid; p < kTilePix; p += nthreads) {
    float s = 0.f;
    for (int g = 0; g < row_groups; ++g) s += red[g * kTilePix + p];
    const long long gp = p0 + p;
    if (gp < npix) out[static_cast<long long>(o) * npix + gp] = s;
  }
}

// Raises the kernel's dynamic shared memory cap to kMaxSmemBytes, once per
// device, so the launch path makes no attribute call.
cudaError_t ensure_smem_cap() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(eps_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmemBytes));
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

long long ipow(long long base, int exp) {
  long long r = 1;
  for (int i = 0; i < exp; ++i) r *= base;
  return r;
}

}  // namespace

// views (n, q, npix) f32, cmt (O*B2, A) f32, out (O, npix) f32, all
// contiguous on the current device; launches on `stream` and does not
// synchronise. Returns cudaGetLastError() (0 on success).
extern "C" int dctn_eps_fwd(const void* views, const void* cmt, void* out,
                            int n, int q, int n1, int out_size,
                            long long npix, void* stream) {
  if (n < 1 || q < 1 || n1 < 1 || n1 > n || out_size < 1 ||
      out_size > 65535 || npix < 1 || n * q > kMaxFactorRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long a_dim = ipow(q, n1);
  const long long b2 = ipow(q, n - n1);
  if (b2 > kMaxB2 || a_dim > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  int row_groups = static_cast<int>((b2 + kRowsPerThread - 1) / kRowsPerThread);
  row_groups = (row_groups + 3) / 4 * 4;  // whole warps: 4 row groups each
  const int nthreads = row_groups * kThreadsPerRowGroup;
  const int rows = row_groups * kRowsPerThread;
  const size_t smem_bytes =
      sizeof(float) * (static_cast<size_t>(n) * q * kTilePix +
                       kChunkA * kTilePix + static_cast<size_t>(rows) * kCmtStride +
                       static_cast<size_t>(row_groups) * kTilePix);
  const cudaError_t err = ensure_smem_cap();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((npix + kTilePix - 1) / kTilePix),
                  static_cast<unsigned>(out_size));
  eps_fwd_kernel<<<grid, nthreads, smem_bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(views), static_cast<const float*>(cmt),
      static_cast<float*>(out), n, q, n1, static_cast<int>(a_dim),
      static_cast<int>(b2), npix);
  return static_cast<int>(cudaGetLastError());
}
