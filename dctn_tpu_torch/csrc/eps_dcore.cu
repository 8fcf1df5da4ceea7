// EPS core gradient for Hopper (sm_90a): d_cmt of one EPS layer in the fast
// (cmt) parameter layout, from the factor stack and the output cotangent g.
//
// Replaces the TPU kernel _dcore_kernel_factory (dctn_tpu/pallas/eps_pallas.py:348;
// K3 with pix_axis=0, and the o-tiled K5 with pix_axis=1, whose tiling over
// o is here just the choice of Z tile) and the d_cmt half of
// _bwd_fused_t_kernel_factory (eps_pallas.py:303, lines 322-332). With the
// digits of the forward (row-major, factor 0 slowest; rows z = o*B2 + b):
//   u[a, p]     = prod_{k < n1}  views[k, digit_k(a), p]         (A  = q^n1)
//   kr2[z, p]   = g[o, p] * prod_{k >= n1} views[k, digit_k(b), p] (kr2 = g if n2 = 0)
//   d_cmt[z, a] = sum_p kr2[z, p] * u[a, p]
// The core itself is not read.
//
// What bounds it on this card: 2*Z*A*npix flops in float32 on the CUDA cores
// (67 TFLOP/s peak on an H100 SXM at 700 W): 41.9 GFLOP (0.63 ms) for the
// flagship's first layer and 213.0 GFLOP (3.18 ms) for its second at batch
// 128. The bytes are few: the factors and g, read once per (Z, A) tile pair
// and served from L2.
//
// Design: a GEMM with K = npix whose operands are built on the fly. The TPU
// kernel carries the sum over pixel tiles in VMEM across its sequential
// grid; on Hopper blocks run in parallel and nothing carries over, so each
// CTA owns one 64 x 64 (Z, A) tile of d_cmt and loops over pixels inside
// the CTA, 32 at a time: it stages the chunk of every factor in shared
// memory, builds the 64 x 32 blocks of u and kr2 from digit tables made once
// per CTA, and each of its 256 threads accumulates a 4 (z) x 4 (a) register
// tile in f32 FMA. Rebuilding u and kr2 in every CTA costs about
// (64*n1 + 64*(n2+1)) multiplies per pixel per CTA against 64*64 FMAs, some
// 15% more work for the flagship layers (n = 8 and 9).
// Where the (Z, A) tiles are too few to fill the card (the flagship's first
// layer: 1024 x 256, 64 tiles for 132 SMs), the pixels are split into
// `slices` fixed ranges: each CTA writes its partial tile to scratch that
// the caller allocates, and a second kernel sums the slices in a fixed
// order. No float atomics: the result is the same from run to run.
//
// Limits (checked by the Python wrapper, again here): n*q <= 256 staged
// factor rows; slices <= 64; the grid's Z tiles <= 65535.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kTileZ = 64;
constexpr int kTileA = 64;
constexpr int kChunkP = 32;                // pixels per step of the loop
constexpr int kVsStride = kChunkP + 1;     // pad: distinct rows, distinct banks
constexpr int kThreads = 256;              // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxFactorRows = 256;        // n * q
constexpr int kMaxSlices = 64;
constexpr int kMaxDevices = 64;
// floats of staged factors, rounded up so the blocks after them stay
// 16-byte aligned for float4 loads
__host__ __device__ constexpr int vs_floats(int rows) {
  return (rows * kVsStride + 3) / 4 * 4;
}
// the most dynamic shared memory a launch within the limits asks for:
// staged factors, the u and kr2 blocks, and the digit tables (n <= n*q)
constexpr size_t kMaxSmemBytes =
    sizeof(float) * (vs_floats(kMaxFactorRows) + 2 * kChunkP * kTileA) +
    sizeof(int) * (kMaxFactorRows * kTileA + kTileZ);
static_assert(kMaxSmemBytes <= 227 * 1024, "over a Hopper block's shared memory");

__global__ void __launch_bounds__(kThreads)
eps_dcore_kernel(const float* __restrict__ views, const float* __restrict__ g,
                 float* __restrict__ dst, int n, int q, int n1, int a_dim,
                 int b2, int z_dim, long long npix, long long pix_per_slice) {
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);    // (n*q, kVsStride)
  float* us = vs + vs_floats(n * q);               // (kChunkP, kTileA)
  float* ks = us + kChunkP * kTileA;               // (kChunkP, kTileZ)
  int* uoff = reinterpret_cast<int*>(ks + kChunkP * kTileZ);  // (n1, kTileA)
  int* voff = uoff + n1 * kTileA;                  // (n2, kTileZ)
  int* zo = voff + (n - n1) * kTileZ;              // (kTileZ)

  const int n2 = n - n1;
  const int tid = threadIdx.x;
  const int ta = tid % 16;
  const int tz = tid / 16;
  const int a0 = blockIdx.x * kTileA;
  const int z0 = blockIdx.y * kTileZ;
  dst += static_cast<long long>(blockIdx.z) * z_dim * a_dim;

  // digit tables: the staged row (k*q + digit) of each factor for each a and
  // z of the tile; -1 marks a row past A (u = 0) or past Z (kr2 = 0)
  for (int i = tid; i < n1 * kTileA; i += kThreads) {
    const int k = i / kTileA;
    const int a = a0 + i % kTileA;
    int rem = a;
    for (int j = n1 - 1; j > k; --j) rem /= q;
    uoff[i] = a < a_dim ? k * q + rem % q : -1;
  }
  for (int i = tid; i < n2 * kTileZ; i += kThreads) {
    const int k = i / kTileZ;
    int rem = (z0 + i % kTileZ) % b2;
    for (int j = n2 - 1; j > k; --j) rem /= q;
    voff[i] = (n1 + k) * q + rem % q;
  }
  for (int i = tid; i < kTileZ; i += kThreads)
    zo[i] = z0 + i < z_dim ? (z0 + i) / b2 : -1;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const long long p_begin = blockIdx.z * pix_per_slice;
  const long long p_end = min(npix, p_begin + pix_per_slice);
  for (long long pc = p_begin; pc < p_end; pc += kChunkP) {
    __syncthreads();  // the previous chunk is consumed; the tables are made
    for (int i = tid; i < n * q * kChunkP; i += kThreads) {
      const int p = i % kChunkP;
      const long long gp = pc + p;
      vs[(i / kChunkP) * kVsStride + p] =
          gp < p_end ? views[static_cast<long long>(i / kChunkP) * npix + gp] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kChunkP * kTileA; i += kThreads) {
      const int al = i % kTileA;
      const int p = i / kTileA;
      float prod = 0.f;
      if (uoff[al] >= 0) {
        // the JAX suffix chain's order: f_{n1-1} first, f_0 last
        prod = 1.f;
        for (int k = n1 - 1; k >= 0; --k)
          prod *= vs[uoff[k * kTileA + al] * kVsStride + p];
      }
      us[i] = prod;
    }
    for (int i = tid; i < kChunkP * kTileZ; i += kThreads) {
      const int zl = i % kTileZ;
      const int p = i / kTileZ;
      const int o = zo[zl];
      float val = 0.f;
      if (o >= 0 && pc + p < p_end) {
        val = 1.f;
        for (int k = n2 - 1; k >= 0; --k)
          val *= vs[voff[k * kTileZ + zl] * kVsStride + p];
        val *= g[static_cast<long long>(o) * npix + pc + p];
      }
      ks[i] = val;
    }
    __syncthreads();
#pragma unroll 8
    for (int p = 0; p < kChunkP; ++p) {
      const float4 kz = *reinterpret_cast<const float4*>(&ks[p * kTileZ + tz * 4]);
      const float4 ua = *reinterpret_cast<const float4*>(&us[p * kTileA + ta * 4]);
      const float kv[4] = {kz.x, kz.y, kz.z, kz.w};
      const float uv[4] = {ua.x, ua.y, ua.z, ua.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(kv[i], uv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int z = z0 + tz * 4 + i;
    if (z >= z_dim) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = a0 + ta * 4 + j;
      if (a < a_dim) dst[static_cast<long long>(z) * a_dim + a] = acc[i][j];
    }
  }
}

// out[i] = sum_s parts[s, i], the slices in a fixed order
__global__ void sum_slices_kernel(const float* __restrict__ parts,
                                  float* __restrict__ out, long long count,
                                  int slices) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < count; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < slices; ++k) s += parts[k * count + i];
    out[i] = s;
  }
}

cudaError_t ensure_smem_cap() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(eps_dcore_kernel,
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

// views (n, q, npix) f32, g (O, npix) f32, d_cmt (O*B2, A) f32 and, when
// slices > 1, scratch (slices, O*B2, A) f32, all contiguous on the current
// device. slices == 1 writes d_cmt directly; slices > 1 writes partial sums
// over `slices` pixel ranges to scratch, then sums them into d_cmt (two
// kernels). Launches on `stream` and does not synchronise. Returns
// cudaGetLastError() (0 on success).
extern "C" int dctn_eps_dcore(const void* views, const void* g, void* d_cmt,
                              void* scratch, int n, int q, int n1, int out_size,
                              long long npix, int slices, void* stream) {
  if (n < 1 || q < 1 || n1 < 1 || n1 > n || out_size < 1 || npix < 1 ||
      n * q > kMaxFactorRows || slices < 1 || slices > kMaxSlices ||
      (slices > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long a_dim = ipow(q, n1);
  const long long b2 = ipow(q, n - n1);
  const long long z_dim = b2 * out_size;
  if (a_dim > (1LL << 30) || z_dim > (1LL << 30) ||
      (z_dim + kTileZ - 1) / kTileZ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = ensure_smem_cap();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_bytes =
      sizeof(float) * (static_cast<size_t>(vs_floats(n * q)) + 2 * kChunkP * kTileA) +
      sizeof(int) * (static_cast<size_t>(n) * kTileA + kTileZ);
  const long long chunks = (npix + kChunkP - 1) / kChunkP;
  const long long pix_per_slice = (chunks + slices - 1) / slices * kChunkP;
  const dim3 grid(static_cast<unsigned>((a_dim + kTileA - 1) / kTileA),
                  static_cast<unsigned>((z_dim + kTileZ - 1) / kTileZ),
                  static_cast<unsigned>(slices));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = slices > 1 ? static_cast<float*>(scratch) : static_cast<float*>(d_cmt);
  eps_dcore_kernel<<<grid, kThreads, smem_bytes, s>>>(
      static_cast<const float*>(views), static_cast<const float*>(g), dst, n, q,
      n1, static_cast<int>(a_dim), static_cast<int>(b2), static_cast<int>(z_dim),
      npix, pix_per_slice);
  if (slices > 1) {
    const long long count = z_dim * a_dim;
    const unsigned blocks = static_cast<unsigned>(std::min((count + 255) / 256, 4096LL));
    sum_slices_kernel<<<blocks, 256, 0, s>>>(dst, static_cast<float*>(d_cmt),
                                             count, slices);
  }
  return static_cast<int>(cudaGetLastError());
}
