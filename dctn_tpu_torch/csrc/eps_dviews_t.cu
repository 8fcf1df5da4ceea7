// EPS input gradient for Hopper (sm_90a): the cotangent of every window
// factor of one EPS layer, from the forward-saved t (`dctn_eps_dviews_t`) or
// with t recomputed inside the kernel (`dctn_eps_dviews_recompute`).
//
// The saved-t form replaces the d_views half of the TPU kernel
// _bwd_fused_t_kernel_factory (dctn_tpu/pallas/eps_pallas.py:303, lines
// 334-343), which is also _dviews_kernel_factory with use_t (eps_pallas.py:391).
// The recompute form replaces the d_views half of _bwd_fused_kernel_factory
// (K4, eps_pallas.py:254, lines 283-297) and _dviews_kernel_factory without t
// (K6, eps_pallas.py:391): the backward of a layer whose t was not saved
// (A = q^n1 < 512, or t over its 4 GiB cap). With the digits of the forward
// (row-major, factor 0 slowest; rows z = o*B2 + b):
//   d_u[a, p] = sum_z cmt[z, a] * g[o, p] * v[b, p]
//             = sum_o g[o, p] * sum_b cmt[o*B2 + b, a] * v[b, p]
//   t[z, p]   = sum_a cmt[z, a] * u[a, p]          (saved, or recomputed)
//   d_v[b, p] = sum_o t[o*B2 + b, p] * g[o, p]
// then the chain backward over each half: factor k's cotangent collects, for
// every a (resp. b), d_u (resp. d_v) times the product of the half's other
// factors at that index's digits. Output (n, q, npix).
//
// What bounds it on this card: the products, in float32 on the CUDA cores
// (67 TFLOP/s peak on an H100 SXM at 700 W). Saved t: the d_u product,
// 2*Z*A*npix flops, 213.0 GFLOP (3.18 ms) for the flagship's second layer at
// batch 128; reading the saved t (416 MB there) takes about 0.12 ms at
// 3.35 TB/s. Recompute: d_u and t, 4*Z*A*npix flops, 426 GFLOP (6.36 ms) at
// that shape and twice that (12.7 ms) at the deep (4,4),(3,12),(2,24)
// model's middle layer (O = 12, Z = 3072); no t crosses HBM.
//
// Design: one CTA of 256 threads per 64-pixel tile, so nothing is summed
// across CTAs. The CTA stages its tile of every factor and of g in shared
// memory and builds v (B2 x 64) there once. d_u (A x 64) and kr2 (Z x 64)
// are 256 KB and 384 KB for the flagship's second layer, over the 227 KB a
// block may hold, so the work streams: for each chunk of 64 rows of A, for
// each o, the CTA streams cmt's rows o*B2 + b in chunks of 32 through shared
// memory and accumulates sum_b cmt*v in a 4 (a) x 4 (pixel) register tile per
// thread, then adds g[o] times it to the chunk's d_u tile (kr2 = g*v is never
// formed). Each finished d_u chunk is folded at once into per-pixel
// accumulators of the n1 u factors' cotangents (n1*q values per pixel): for
// each a, d_u times the product of the other u factors. d_v streams the
// saved t once. Without t, the tile's u (A x 64) and t (Z x 64) do not fit
// beside each other either (256 KB and 768 KB at the deep middle layer), so
// t is recomputed as eps_fwd.cu computes it, chunk by chunk: for each chunk
// of 64 rows of Z, the CTA streams cmt in 32-column chunks beside the
// matching 32 x 64 block of u (rebuilt from the staged factors, some n1/64
// of the chunk's FMAs) and accumulates a 4 (z) x 4 (pixel) register tile;
// the tile times g[o] goes to shared memory, and the rows of each b are
// added into d_v in a fixed order (rows of a chunk in order, chunks in
// order). These buffers reuse the d_u pass's, so both forms take the same
// shared memory. The v factors' cotangents come from the front-peel order of
// the TPU kernel's _chain_bwd (eps_pallas.py:206-224), in place in shared
// memory. No atomics: the result is the same from run to run. No
// leave-one-out product is formed by division: the default feature map is
// exactly 0 on black pixels, so factors hold many zeros.
//
// Limits (checked by the Python wrapper, again here): the shared memory below,
// at most 227 KB; n2 = 0 takes no t (kr2 = g, and there is no v half).

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kTileP = 64;                 // pixels per CTA
constexpr int kChunkA = 64;                // rows of A per chunk
constexpr int kChunkB = 32;                // rows of cmt per streamed chunk
constexpr int kChunkZ = 64;                // rows of Z per recomputed t chunk
constexpr int kChunkT = 32;                // columns of cmt per t step
constexpr int kCzStride = kChunkT + 1;     // pad: distinct rows, distinct banks
constexpr int kThreads = 256;              // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr long long round_up(long long v, long long m) {
  return (v + m - 1) / m * m;
}

// dynamic shared memory of one launch: staged factors, their cotangents, v
// (then d_v) rounded up to whole chunks, g, the cmt chunk, the d_u chunk,
// and the u digit table
__host__ __device__ constexpr long long smem_bytes(long long n, long long q,
                                                   long long n1, long long b2,
                                                   long long o) {
  return 4 * (kTileP * (2 * n * q + round_up(b2, kChunkB) + o) +
              kChunkB * kChunkA + kChunkA * kTileP) +
         4 * n1 * kChunkA;
}
// the recompute form's buffers live in the d_u pass's cmt and d_u chunks
static_assert(kChunkT * kTileP <= kChunkB * kChunkA, "u chunk over the cmt chunk");
static_assert(kChunkZ * kCzStride <= kChunkA * kTileP, "cmt chunk over the d_u chunk");
static_assert(kChunkZ * kTileP <= kChunkB * kChunkA + kChunkA * kTileP,
              "t chunk over both");
static_assert(kChunkZ * kTileP == kThreads * 16, "one 4 x 4 t tile per thread");

// d_v (b2 rows of vbuf) with t recomputed: d_v[b, p] = sum_o t[o*B2 + b, p] *
// g[o, p], t = cmt . u, streamed as the header says. `cs` and `dus` are the
// d_u pass's chunks (free once its last fold is done), `vs` the staged
// factors, `gs` the staged g.
__device__ __forceinline__ void recompute_dv(const float* __restrict__ cmt,
                                             const float* vs, const float* gs,
                                             float* cs, float* dus, float* vbuf,
                                             int q, int n1, int a_dim, int b2,
                                             int out_size) {
  float* us = cs;    // (kChunkT, kTileP): u rows a0 .. a0 + 31
  float* czs = dus;  // (kChunkZ, kCzStride): cmt rows z0 .., columns a0 ..
  float* tg = cs;    // (kChunkZ, kTileP): t * g, over both after the A loop
  const int tid = threadIdx.x;
  const int tz = tid / 16;
  const int tp = tid % 16;
  const int z_dim = out_size * b2;
  for (int i = tid; i < b2 * kTileP; i += kThreads) vbuf[i] = 0.f;
  for (int z0 = 0; z0 < z_dim; z0 += kChunkZ) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int a0 = 0; a0 < a_dim; a0 += kChunkT) {
      __syncthreads();  // the previous chunk (or t chunk) is consumed
      for (int i = tid; i < kChunkZ * kChunkT; i += kThreads) {
        const int z = z0 + i / kChunkT;
        const int a = a0 + i % kChunkT;
        czs[(i / kChunkT) * kCzStride + i % kChunkT] =
            z < z_dim && a < a_dim ? cmt[static_cast<long long>(z) * a_dim + a] : 0.f;
      }
      for (int i = tid; i < kChunkT * kTileP; i += kThreads) {
        const int p = i % kTileP;
        const int a = a0 + i / kTileP;
        float prod = 0.f;
        if (a < a_dim) {
          // the JAX suffix chain's order: f_{n1-1} first, f_0 last
          prod = 1.f;
          int rem = a;
          for (int k = n1 - 1; k >= 0; --k) {
            prod *= vs[(k * q + rem % q) * kTileP + p];
            rem /= q;
          }
        }
        us[i] = prod;
      }
      __syncthreads();
#pragma unroll 4
      for (int al = 0; al < kChunkT; ++al) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = czs[(tz * 4 + i) * kCzStride + al];
        const float4 u4 = *reinterpret_cast<const float4*>(&us[al * kTileP + tp * 4]);
        const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], uv[j], acc[i][j]);
      }
    }
    __syncthreads();  // every thread is done with us and czs, which tg covers
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int zl = tz * 4 + i;
      const int o = min(z0 + zl, z_dim - 1) / b2;
      const float4 gv4 = *reinterpret_cast<const float4*>(&gs[o * kTileP + tp * 4]);
      *reinterpret_cast<float4*>(&tg[zl * kTileP + tp * 4]) =
          make_float4(acc[i][0] * gv4.x, acc[i][1] * gv4.y, acc[i][2] * gv4.z,
                      acc[i][3] * gv4.w);
    }
    __syncthreads();
    // rows b', b' + B2, ... of the chunk all belong to b = (z0 + b') % B2:
    // item (b', p) is the only writer of that row of d_v at pixel p
    const int rows = min(kChunkZ, z_dim - z0);
    const int classes = min(b2, rows);
    for (int item = tid; item < classes * kTileP; item += kThreads) {
      const int bl = item / kTileP;
      const int p = item % kTileP;
      float s = 0.f;
      for (int r = bl; r < rows; r += b2) s += tg[r * kTileP + p];
      vbuf[((z0 + bl) % b2) * kTileP + p] += s;
    }
  }
}

template <bool kRecompute>
__global__ void __launch_bounds__(kThreads)
eps_dviews_kernel(const float* __restrict__ views, const float* __restrict__ cmt,
                  const float* __restrict__ g, const float* __restrict__ t,
                  float* __restrict__ dviews, int n, int q, int n1, int a_dim,
                  int b2, int out_size, long long npix) {
  extern __shared__ float4 smem4[];
  const int rows_v = static_cast<int>(round_up(b2, kChunkB));
  float* vs = reinterpret_cast<float*>(smem4);    // (n*q, kTileP)
  float* dvs = vs + n * q * kTileP;                // (n*q, kTileP)
  float* vbuf = dvs + n * q * kTileP;              // (rows_v, kTileP)
  float* gs = vbuf + rows_v * kTileP;              // (O, kTileP)
  float* cs = gs + out_size * kTileP;              // (kChunkB, kChunkA)
  float* dus = cs + kChunkB * kChunkA;             // (kChunkA, kTileP)
  int* uoff = reinterpret_cast<int*>(dus + kChunkA * kTileP);  // (n1, kChunkA)

  const int n2 = n - n1;
  const int tid = threadIdx.x;
  const int ta = tid / 16;
  const int tp = tid % 16;
  const long long p0 = static_cast<long long>(blockIdx.x) * kTileP;

  for (int i = tid; i < n * q * kTileP; i += kThreads) {
    const long long gp = p0 + i % kTileP;
    vs[i] = gp < npix ? views[static_cast<long long>(i / kTileP) * npix + gp] : 0.f;
    dvs[i] = 0.f;
  }
  for (int i = tid; i < out_size * kTileP; i += kThreads) {
    const long long gp = p0 + i % kTileP;
    gs[i] = gp < npix ? g[static_cast<long long>(i / kTileP) * npix + gp] : 0.f;
  }
  __syncthreads();
  // v[b, p], the JAX suffix chain's order (f_{n-1} first); zero rows past B2
  for (int i = tid; i < rows_v * kTileP; i += kThreads) {
    const int b = i / kTileP;
    const int p = i % kTileP;
    float val = 0.f;
    if (b < b2) {
      val = 1.f;
      int rem = b;
      for (int k = n - 1; k >= n1; --k) {
        val *= vs[(k * q + rem % q) * kTileP + p];
        rem /= q;
      }
    }
    vbuf[i] = val;
  }

  for (int a0 = 0; a0 < a_dim; a0 += kChunkA) {
    __syncthreads();  // v is built; the previous chunk's fold is done
    for (int i = tid; i < n1 * kChunkA; i += kThreads) {
      const int k = i / kChunkA;
      const int a = a0 + i % kChunkA;
      int rem = a;
      for (int j = n1 - 1; j > k; --j) rem /= q;
      uoff[i] = a < a_dim ? k * q + rem % q : -1;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int o = 0; o < out_size; ++o) {
      float acc_o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_o[i][j] = 0.f;
      for (int b0 = 0; b0 < rows_v; b0 += kChunkB) {
        __syncthreads();  // the previous cmt chunk is consumed
        for (int i = tid; i < kChunkB * kChunkA; i += kThreads) {
          const int b = b0 + i / kChunkA;
          const int a = a0 + i % kChunkA;
          cs[i] = b < b2 && a < a_dim
                      ? cmt[(static_cast<long long>(o) * b2 + b) * a_dim + a]
                      : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int bl = 0; bl < kChunkB; ++bl) {
          const float4 c = *reinterpret_cast<const float4*>(&cs[bl * kChunkA + ta * 4]);
          const float4 v = *reinterpret_cast<const float4*>(
              &vbuf[(b0 + bl) * kTileP + tp * 4]);
          const float cv[4] = {c.x, c.y, c.z, c.w};
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc_o[i][j] = fmaf(cv[i], vv[j], acc_o[i][j]);
        }
      }
      const float4 gv4 = *reinterpret_cast<const float4*>(&gs[o * kTileP + tp * 4]);
      const float gv[4] = {gv4.x, gv4.y, gv4.z, gv4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(acc_o[i][j], gv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&dus[(ta * 4 + i) * kTileP + tp * 4]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
    // fold the d_u chunk into the u factors' cotangents; item (k, p) is the
    // only writer of factor k's rows at pixel p
    for (int item = tid; item < n1 * kTileP; item += kThreads) {
      const int k = item / kTileP;
      const int p = item % kTileP;
      for (int al = 0; al < kChunkA && uoff[al] >= 0; ++al) {
        float prod = dus[al * kTileP + p];
        for (int j = 0; j < n1; ++j)
          if (j != k) prod *= vs[uoff[j * kChunkA + al] * kTileP + p];
        dvs[uoff[k * kChunkA + al] * kTileP + p] += prod;
      }
    }
  }

  if (n2 > 0) {
    __syncthreads();
    // d_v[b, p] = sum_o t[o*B2 + b, p] * g[o, p], into vbuf
    if constexpr (kRecompute) {
      recompute_dv(cmt, vs, gs, cs, dus, vbuf, q, n1, a_dim, b2, out_size);
    } else {
      for (int i = tid; i < b2 * kTileP; i += kThreads) {
        const int b = i / kTileP;
        const int p = i % kTileP;
        const long long gp = p0 + p;
        float s = 0.f;
        if (gp < npix)
          for (int o = 0; o < out_size; ++o)
            s += t[(static_cast<long long>(o) * b2 + b) * npix + gp] * gs[o * kTileP + p];
        vbuf[i] = s;
      }
    }
    // front peel over the v factors: d holds rows (digit_k, ..., digit_{n-1})
    int rows = b2;
    for (int k = n1; k < n - 1; ++k) {
      const int rest = rows / q;
      __syncthreads();
      for (int item = tid; item < q * kTileP; item += kThreads) {
        const int d = item / kTileP;
        const int p = item % kTileP;
        float s = 0.f;
        for (int r = 0; r < rest; ++r) {
          float suf = 1.f;
          int rem = r;
          for (int j = n - 1; j > k; --j) {
            suf *= vs[(j * q + rem % q) * kTileP + p];
            rem /= q;
          }
          s += vbuf[(d * rest + r) * kTileP + p] * suf;
        }
        dvs[(k * q + d) * kTileP + p] = s;
      }
      __syncthreads();
      // d[r] = sum_d d[d*rest + r] * f_k[d], in place: row r < rest is read
      // only by the item that writes it
      for (int item = tid; item < rest * kTileP; item += kThreads) {
        const int r = item / kTileP;
        const int p = item % kTileP;
        float s = vbuf[r * kTileP + p] * vs[k * q * kTileP + p];
        for (int d = 1; d < q; ++d)
          s += vbuf[(d * rest + r) * kTileP + p] * vs[(k * q + d) * kTileP + p];
        vbuf[r * kTileP + p] = s;
      }
      rows = rest;
    }
    __syncthreads();
    for (int item = tid; item < q * kTileP; item += kThreads)
      dvs[(n - 1) * q * kTileP + item] = vbuf[item];
  }

  __syncthreads();
  for (int i = tid; i < n * q * kTileP; i += kThreads) {
    const long long gp = p0 + i % kTileP;
    if (gp < npix) dviews[static_cast<long long>(i / kTileP) * npix + gp] = dvs[i];
  }
}

template <bool kRecompute>
cudaError_t ensure_smem_cap() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(eps_dviews_kernel<kRecompute>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmemBytes);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

long long ipow(long long base, int exp) {
  long long r = 1;
  for (int i = 0; i < exp; ++i) r *= base;
  return r;
}

// One launch of either form; t is null in the recompute form and when n2 == 0.
template <bool kRecompute>
int launch(const void* views, const void* cmt, const void* g, const void* t,
           void* dviews, int n, int q, int n1, int out_size, long long npix,
           void* stream) {
  if (n < 1 || q < 1 || n1 < 1 || n1 > n || out_size < 1 || npix < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long a_dim = ipow(q, n1);
  const long long b2 = ipow(q, n - n1);
  const long long bytes = smem_bytes(n, q, n1, b2, out_size);
  if (a_dim > (1LL << 30) || b2 * out_size > (1LL << 30) || bytes > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = ensure_smem_cap<kRecompute>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((npix + kTileP - 1) / kTileP);
  eps_dviews_kernel<kRecompute><<<grid, kThreads, static_cast<size_t>(bytes),
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(views), static_cast<const float*>(cmt),
      static_cast<const float*>(g), static_cast<const float*>(t),
      static_cast<float*>(dviews), n, q, n1, static_cast<int>(a_dim),
      static_cast<int>(b2), out_size, npix);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// views (n, q, npix) f32, cmt (O*B2, A) f32, g (O, npix) f32, t (O*B2, npix)
// f32 (null when n2 == 0) and dviews (n, q, npix) f32, all contiguous on the
// current device; launches on `stream` and does not synchronise. Returns
// cudaGetLastError() (0 on success).
extern "C" int dctn_eps_dviews_t(const void* views, const void* cmt, const void* g,
                                 const void* t, void* dviews, int n, int q, int n1,
                                 int out_size, long long npix, void* stream) {
  if ((n1 < n) != (t != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(views, cmt, g, t, dviews, n, q, n1, out_size, npix, stream);
}

// The same cotangent with t recomputed in the kernel: the arguments of
// dctn_eps_dviews_t without t.
extern "C" int dctn_eps_dviews_recompute(const void* views, const void* cmt,
                                         const void* g, void* dviews, int n, int q,
                                         int n1, int out_size, long long npix,
                                         void* stream) {
  return launch<true>(views, cmt, g, nullptr, dviews, n, q, n1, out_size, npix, stream);
}
