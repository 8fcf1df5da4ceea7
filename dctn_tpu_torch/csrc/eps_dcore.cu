// EPS core gradient for Hopper (sm_90a): d_cmt of one EPS layer in the fast
// (cmt) parameter layout, from the factor stack and the output cotangent g.
//
// Replaces the TPU kernel _dcore_kernel_factory (dctn_tpu/pallas/eps_pallas.py:348;
// K3 with pix_axis=0, and the o-tiled K5 with pix_axis=1, whose tiling over
// o is here just the choice of Z tile) and the d_cmt halves of
// _bwd_fused_t_kernel_factory (eps_pallas.py:303, lines 322-332; K2) and of
// _bwd_fused_kernel_factory (eps_pallas.py:254; K4). With the digits of the
// forward (row-major, factor 0 slowest; rows z = o*B2 + b):
//   u[a, p]     = prod_{k < n1}  views[k, digit_k(a), p]         (A  = q^n1)
//   kr2[z, p]   = g[o, p] * prod_{k >= n1} views[k, digit_k(b), p] (kr2 = g if n2 = 0)
//   d_cmt[z, a] = sum_p kr2[z, p] * u[a, p]
// The core itself is not read.
//
// What bounds it on this card: the product, 2*Z*A*npix flops, at the
// fastest float32-accurate rate of an H100 SXM (700 W), 3xTF32 on the tensor
// cores at 495/3 = 165 TFLOP/s (tf32x3.cuh): 41.9 GFLOP (0.254 ms) for the
// flagship's first layer and 213.0 GFLOP (1.29 ms) for its second at batch
// 128, 426 GFLOP (2.58 ms) at the deep (4,4),(3,12),(2,24) model's middle
// layer. The bytes are few: the factors and g, read once per (Z, A) tile pair
// (mostly from L2), and d_cmt written once.
//
// Design: a GEMM with M = Z, N = A and K = npix whose two operands exist
// only on chip. Each CTA of 8 warps owns one 128 x 128 (Z, A) tile of d_cmt
// and walks its pixel range in chunks of 32:
// 1. Staging. cp.async brings the chunk of every factor row (n*q x 32) and
//    of the g rows the tile's Z range touches, double-buffered: chunk c + 2
//    is in flight while chunk c is multiplied.
// 2. Build. Both operands are Kronecker products over their rows: a row
//    index r (a of u, z of kr2) splits into r / s and r % s with s = q^lv,
//    the lv trailing digits (the most with q^lv <= 16). Per chunk the CTA
//    forms in shared memory X[r / s] (the leading factors, and g[o] for
//    kr2) for the few values the tile's 128 rows take, and Y[r % s] (the
//    trailing factors), from the staged factors: some 50 rows of 32 pixels
//    at the flagship's layers, where the tile's operands have 256. The
//    product order differs from the JAX suffix chain's (f_{n1-1} first),
//    within the float32 rounding the tests and chip_smoke.py allow (1e-4 of
//    max|ref|).
// 3. Product. Each warp owns 64 (z) x 32 (a) of the tile, 4 x 4 fragments
//    of mma.sync.m16n8k8 TF32, three mma per fragment pair (3xTF32,
//    tf32x3.cuh). A thread forms its own fragment entries as X times Y, read
//    from shared memory as float2 (row stride 40 floats: no bank conflict
//    where the rows of a fragment are consecutive), and splits them into
//    TF32 hi and lo in registers. An entry is so formed by each of the 4
//    (kr2) or 2 (u) warps that share it, but nothing is written back to
//    shared memory and no barrier stands between the build and the
//    product: on an H100, writing the entries as hi and lo planes for all
//    warps cost more than the product itself. The fragments sum 4 chunks
//    (128 pixels); then they are added into per-thread f32 totals in shared
//    memory (the tensor cores' accumulation truncates: a sum kept in the
//    fragments over 67,712 pixels drifts by ~4e-4 of max|ref|). Where the
//    grid has more CTAs than the card has SMs, two CTAs share an SM and
//    one's build runs beside the other's product: that kernel is held to
//    128 registers a thread, and ptxas (CUDA 12.8) spills some 300 bytes a
//    thread for it (a 240 B stack frame, 312 B of spill stores, 304 B of
//    loads). A grid of fewer CTAs (the flagship's layer 1: 96) takes the
//    kernel built for one CTA per SM (220 registers, no spill).
// One barrier per chunk: it shows chunk c's X and Y (built while chunk c - 1
// was multiplied) and chunk c + 1's staged rows.
// Where the (Z, A) tiles are too few to fill the card (the flagship's first
// layer: 1024 x 256, 16 tiles for 132 SMs), the pixels are split into
// `slices` fixed ranges: each CTA writes its partial tile to scratch that
// the caller allocates, and a second kernel sums the slices in a fixed
// order. No float atomics: the result is the same from run to run.
//
// Limits (checked by the Python wrapper, again here): n*q <= 256 staged
// factor rows; slices <= 64; the grid's Z tiles <= 65535; the shared memory
// of `make_plan`, at most 227 KB (the flagship's layers take about 91 KB,
// n*q = 256 with O = 2 about 213 KB).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "tf32x3.cuh"

namespace {

constexpr int kTile = 128;                 // rows of Z and of A per CTA
constexpr int kChunkP = 32;                // pixels per step of the loop
constexpr int kXYStride = kChunkP + 8;     // X, Y rows: 8*row + 2*tig banks
constexpr int kThreads = 256;              // 8 warps: 2 (z) x 4 (a)
constexpr int kWarpZ = 64;
constexpr int kWarpA = 32;
constexpr int kMI = kWarpZ / 16;           // m16 fragments per warp
constexpr int kNJ = kWarpA / 8;            // n8 fragments per warp
constexpr int kFlush = 4;                  // chunks summed in the fragments
constexpr int kTotals = kThreads * kMI * kNJ * 4;  // f32 totals, per thread
constexpr int kMaxFactorRows = 256;        // n * q
constexpr int kMaxSlices = 64;
constexpr int kMaxKron = 16;               // the largest s = q^lv
constexpr long long kMaxSmemBytes = 227 * 1024;
constexpr int kMaxDevices = 64;
static_assert(kThreads == (kTile / kWarpZ) * (kTile / kWarpA) * 32, "8 warps cover the tile");

__host__ __device__ constexpr long long ipow(long long base, int exp) {
  long long r = 1;
  for (int i = 0; i < exp; ++i) r *= base;
  return r;
}

// the number of trailing digits a Kronecker operand splits off: the most
// with q^lv <= kMaxKron, and at most the factors it has
__host__ __device__ constexpr int trailing_digits(int q, int factors) {
  int lv = 0;
  long long s = 1;
  while (lv < factors && s * q <= kMaxKron) {
    s *= q;
    ++lv;
  }
  return lv;
}

// The shared memory of one launch. In order: each thread's f32 totals of its
// 64 fragment entries (kTotals), two stages of staged rows (n*q
// factor rows, then g_rows rows of g, 32 pixels each), two buffers of X and
// Y rows (u's X, u's Y, kr2's X, kr2's Y, then a row of zeros for the rows
// past the tensor; kXYStride apart), then the int table: for each X, Y row,
// the row_factors staged rows whose product it is (g's row first in kr2's X;
// a row of ones where a row has fewer factors, zeros for a g row past O).
struct Plan {
  int lv_u, s_u, cx_u, lv_k, s_k, cx_k, g_rows, xy_rows, row_factors;
  long long f_floats, xy_floats, ints, bytes;
};

__host__ __device__ inline Plan make_plan(int n, int q, int n1, long long b2,
                                          int out_size) {
  Plan p;
  const int n2 = n - n1;
  p.lv_u = trailing_digits(q, n1);
  p.s_u = static_cast<int>(ipow(q, p.lv_u));
  p.cx_u = (kTile - 1) / p.s_u + 2;  // X rows a tile of 128 consecutive rows spans
  p.lv_k = trailing_digits(q, n2);
  p.s_k = static_cast<int>(ipow(q, p.lv_k));
  p.cx_k = (kTile - 1) / p.s_k + 2;
  p.g_rows = static_cast<int>(out_size < (kTile - 1) / b2 + 2 ? out_size : (kTile - 1) / b2 + 2);
  p.xy_rows = p.cx_u + p.s_u + p.cx_k + p.s_k + 1;
  // staged rows: the n*q factor rows, g_rows rows of g, a row of ones and a
  // row of zeros
  p.f_floats = static_cast<long long>(n * q + p.g_rows + 2) * kChunkP;
  p.xy_floats = static_cast<long long>(p.xy_rows) * kXYStride;
  // the staged rows each X, Y row multiplies (kr2's X: g's row first)
  const int lead_u = n1 - p.lv_u;
  const int lead_k = n2 - p.lv_k + 1;
  p.row_factors = lead_u > p.lv_u ? lead_u : p.lv_u;
  p.row_factors = lead_k > p.row_factors ? lead_k : p.row_factors;
  p.row_factors = p.lv_k > p.row_factors ? p.lv_k : p.row_factors;
  p.ints = static_cast<long long>(p.xy_rows - 1) * p.row_factors;
  p.bytes = 4 * (kTotals + 2 * p.f_floats + 2 * p.xy_floats + p.ints);
  return p;
}

// One chunk of staged rows: the n*q factor rows and g rows o0 .. o0 +
// g_rows - 1 (zero past O), pixels pc .. pc + 31 (zero past p_end).
__device__ __forceinline__ void stage_chunk(float* f, const float* __restrict__ views,
                                            const float* __restrict__ g, int nq,
                                            int g_rows, int o0, int out_size,
                                            long long npix, long long pc,
                                            long long p_end, bool vec) {
  const int rows = nq + g_rows;
  if (vec) {
    for (int i = threadIdx.x; i < rows * (kChunkP / 4); i += kThreads) {
      const int r = i / (kChunkP / 4);
      const int seg = (i % (kChunkP / 4)) * 4;
      const long long gp = pc + seg;
      const float* row = r < nq ? views + r * npix : g + (o0 + r - nq) * npix;
      const bool ok = r < nq || o0 + r - nq < out_size;
      const long long left = p_end - gp;
      const int bytes = !ok || left <= 0 ? 0 : left >= 4 ? 16 : 4 * static_cast<int>(left);
      tf32x3::cp_async16(f + r * kChunkP + seg, bytes > 0 ? row + gp : views, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kChunkP; i += kThreads) {
      const int r = i / kChunkP;
      const long long gp = pc + i % kChunkP;
      const float* row = r < nq ? views + r * npix : g + (o0 + r - nq) * npix;
      const bool ok = gp < p_end && (r < nq || o0 + r - nq < out_size);
      tf32x3::cp_async4(f + i, ok ? row + gp : views, ok ? 4 : 0);
    }
  }
}

// X and Y of both operands for one chunk, from its staged rows: row r is the
// product of the staged rows tab[r * row_factors ...]. Four items in flight
// per thread, their loads issued side by side.
__device__ __forceinline__ void build_xy(float* __restrict__ xy, const float* __restrict__ f,
                                         const int* __restrict__ tab, const Plan& pl) {
  const int items = (pl.xy_rows - 1) * kChunkP;
  for (int i0 = threadIdx.x; i0 < items; i0 += 4 * kThreads) {
    float v[4] = {1.f, 1.f, 1.f, 1.f};
    for (int k = 0; k < pl.row_factors; ++k) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int i = min(i0 + h * kThreads, items - 1);
        v[h] *= f[tab[(i / kChunkP) * pl.row_factors + k] * kChunkP + i % kChunkP];
      }
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int i = i0 + h * kThreads;
      if (i < items) xy[(i / kChunkP) * kXYStride + i % kChunkP] = v[h];
    }
  }
}

// the digits of `value` over `count` factors starting at factor `first`,
// as staged rows (factor * q + digit), most significant first
__device__ __forceinline__ void digit_rows(int* out, long long value, int first, int count,
                                           int q) {
  for (int k = count - 1; k >= 0; --k) {
    out[k] = (first + k) * q + static_cast<int>(value % q);
    value /= q;
  }
}

// A thread's fragment entries at k8 step s: X times Y at pixels 8s + 2 tig
// and 8s + 2 tig + 1 of the rows at offsets x and y of the X, Y buffer
__device__ __forceinline__ float2 entry_pair(const float* xy, int x, int y, int col) {
  const float2 a = *reinterpret_cast<const float2*>(xy + x + col);
  const float2 b = *reinterpret_cast<const float2*>(xy + y + col);
  return make_float2(a.x * b.x, a.y * b.y);
}

template <int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
eps_dcore_kernel(const float* __restrict__ views, const float* __restrict__ g,
                 float* __restrict__ dst, int n, int q, int n1, int a_dim,
                 int b2, int z_dim, int out_size, long long npix,
                 long long pix_per_slice, bool vec) {
  extern __shared__ float4 smem4[];
  const Plan pl = make_plan(n, q, n1, b2, out_size);
  const int n2 = n - n1;
  const int nq = n * q;
  float* totals = reinterpret_cast<float*>(smem4);  // entry e of thread t at e * kThreads + t
  float* fbuf = totals + kTotals;
  float* xybuf = fbuf + 2 * pl.f_floats;
  int* tab = reinterpret_cast<int*>(xybuf + 2 * pl.xy_floats);
  const int tid = threadIdx.x;
  const int a0 = blockIdx.x * kTile;
  const int z0 = blockIdx.y * kTile;
  const int i0_u = a0 / pl.s_u;
  const int i0_k = z0 / pl.s_k;
  const int o0 = z0 / b2;
  const int b_hi = b2 / pl.s_k;  // values of the leading digits of b
  dst += static_cast<long long>(blockIdx.z) * z_dim * a_dim;

  const int ones = nq + pl.g_rows;  // the staged row of ones, then of zeros
  const int lead_u = n1 - pl.lv_u;
  const int lead_k = n2 - pl.lv_k;
  for (int r = tid; r < pl.xy_rows - 1; r += kThreads) {
    int* row = tab + r * pl.row_factors;
    int used;
    if (r < pl.cx_u) {  // u's X: the leading factors at the digits of a / s_u
      digit_rows(row, i0_u + r, 0, lead_u, q);
      used = lead_u;
    } else if (r < pl.cx_u + pl.s_u) {  // u's Y: the trailing factors
      digit_rows(row, r - pl.cx_u, lead_u, pl.lv_u, q);
      used = pl.lv_u;
    } else if (r < pl.cx_u + pl.s_u + pl.cx_k) {  // kr2's X: g[o], then the leading v factors
      const int iz = i0_k + r - pl.cx_u - pl.s_u;
      const int o = iz / b_hi;
      row[0] = o < out_size && o - o0 < pl.g_rows ? nq + o - o0 : ones + 1;
      digit_rows(row + 1, iz % b_hi, n1, lead_k, q);
      used = lead_k + 1;
    } else {  // kr2's Y: the trailing v factors
      digit_rows(row, r - pl.cx_u - pl.s_u - pl.cx_k, n1 + lead_k, pl.lv_k, q);
      used = pl.lv_k;
    }
    for (int k = used; k < pl.row_factors; ++k) row[k] = ones;
  }
  // the rows of ones and zeros of both stages
  for (int i = tid; i < 2 * 2 * kChunkP; i += kThreads)
    fbuf[(i / (2 * kChunkP)) * pl.f_floats + ones * kChunkP + i % (2 * kChunkP)] =
        i % (2 * kChunkP) < kChunkP ? 1.f : 0.f;
  const int zero_row = (pl.xy_rows - 1) * kXYStride;
  for (int i = tid; i < 2 * kXYStride; i += kThreads)
    xybuf[(i / kXYStride) * pl.xy_floats + zero_row + i % kXYStride] = 0.f;

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tig = lane % 4;
  const int wz = (warp / (kTile / kWarpA)) * kWarpZ;
  const int wa = (warp % (kTile / kWarpA)) * kWarpA;
  const bool busy = z0 + wz < z_dim && a0 + wa < a_dim;
  // the X and Y rows (as offsets into an X, Y buffer) of this thread's
  // fragment rows: kr2 rows wz + 16 i + gq (+8), u rows wa + 8 j + gq; a row
  // past the tensor takes the zero row
  int kx[kMI][2], ky[kMI][2], ux[kNJ], uy[kNJ];
  const int k_base = pl.cx_u + pl.s_u;
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int z = z0 + wz + 16 * i + gq + 8 * h;
      kx[i][h] = z < z_dim ? (k_base + z / pl.s_k - i0_k) * kXYStride : zero_row;
      ky[i][h] = (k_base + pl.cx_k + z % pl.s_k) * kXYStride;
    }
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int a = a0 + wa + 8 * j + gq;
    ux[j] = a < a_dim ? (a / pl.s_u - i0_u) * kXYStride : zero_row;
    uy[j] = (pl.cx_u + a % pl.s_u) * kXYStride;
  }
  // the last kFlush chunks' sums, in the fragments; every kFlush chunks
  // they are added into the totals (f32 adds, which round to nearest)
  float acc[kMI][kNJ][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        totals[((i * kNJ + j) * 4 + e) * kThreads + tid] = 0.f;
      }

  const long long p_begin = blockIdx.z * pix_per_slice;
  const long long p_end = min(npix, p_begin + pix_per_slice);
  const int chunks = p_end > p_begin ? static_cast<int>((p_end - p_begin + kChunkP - 1) / kChunkP) : 0;
  for (int c = 0; c < min(chunks, 2); ++c) {
    stage_chunk(fbuf + c * pl.f_floats, views, g, nq, pl.g_rows, o0, out_size, npix,
                p_begin + c * kChunkP, p_end, vec);
    tf32x3::cp_async_commit();
  }
  tf32x3::cp_async_wait_all();
  __syncthreads();  // the tables and chunks 0 and 1 are in
  if (chunks > 0) build_xy(xybuf, fbuf, tab, pl);

  for (int c = 0; c < chunks; ++c) {
    tf32x3::cp_async_wait_all();  // this thread's copies of chunk c + 1
    __syncthreads();  // chunk c's X, Y and chunk c + 1's rows are in; the other buffers are free
    if (c + 2 < chunks) {
      stage_chunk(fbuf + (c % 2) * pl.f_floats, views, g, nq, pl.g_rows, o0, out_size, npix,
                  p_begin + static_cast<long long>(c + 2) * kChunkP, p_end, vec);
      tf32x3::cp_async_commit();
    }
    if (c + 1 < chunks)
      build_xy(xybuf + ((c + 1) % 2) * pl.xy_floats, fbuf + ((c + 1) % 2) * pl.f_floats, tab, pl);
    if (!busy) continue;  // the warp's whole 64 x 32 lies past Z or A
    const float* xy = xybuf + (c % 2) * pl.xy_floats;
#pragma unroll
    for (int s = 0; s < kChunkP / 8; ++s) {
      const int col = 8 * s + 2 * tig;
      uint32_t bh[kNJ][2], bl[kNJ][2];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        // b0: k = tig (pixel col), b1: k = tig + 4 (pixel col + 1)
        const float2 v = entry_pair(xy, ux[j], uy[j], col);
        tf32x3::split_frag(v.x, bh[j][0], bl[j][0]);
        tf32x3::split_frag(v.y, bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // a0/a1: row gq / gq + 8 at pixel col, a2/a3 at pixel col + 1
          const float2 v = entry_pair(xy, kx[i][h], ky[i][h], col);
          tf32x3::split_frag(v.x, ah[h], al[h]);
          tf32x3::split_frag(v.y, ah[h + 2], al[h + 2]);
        }
        tf32x3::mma3_row(acc[i], ah, al, bh, bl);
      }
    }
    if (c % kFlush == kFlush - 1) {
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            totals[((i * kNJ + j) * 4 + e) * kThreads + tid] += acc[i][j][e];
            acc[i][j][e] = 0.f;
          }
    }
  }

  // fragment element e: row gq (+8 for e >= 2), column 2 tig (+1 for odd e)
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int z = z0 + wz + 16 * i + gq + (e >= 2 ? 8 : 0);
      if (z >= z_dim) continue;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int a = a0 + wa + 8 * j + 2 * tig + (e & 1);
        if (a < a_dim)
          dst[static_cast<long long>(z) * a_dim + a] =
              totals[((i * kNJ + j) * 4 + e) * kThreads + tid] + acc[i][j][e];
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

template <int kMinBlocks>
cudaError_t ensure_smem_cap() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(eps_dcore_kernel<kMinBlocks>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmemBytes));
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// views (n, q, npix) f32, g (O, npix) f32, d_cmt (O*B2, A) f32 and, when
// slices > 1, scratch (slices, O*B2, A) f32, all contiguous on the current
// device, whose SM count is `sms`. slices == 1 writes d_cmt directly; slices
// > 1 writes partial sums over `slices` pixel ranges to scratch, then sums
// them into d_cmt (two kernels). Launches on `stream` and does not
// synchronise. Returns cudaGetLastError() (0 on success).
extern "C" int dctn_eps_dcore(const void* views, const void* g, void* d_cmt,
                              void* scratch, int n, int q, int n1, int out_size,
                              long long npix, int slices, int sms, void* stream) {
  if (n < 1 || q < 1 || n1 < 1 || n1 > n || out_size < 1 || npix < 1 ||
      n * q > kMaxFactorRows || slices < 1 || slices > kMaxSlices || sms < 1 ||
      (slices > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long a_dim = ipow(q, n1);
  const long long b2 = ipow(q, n - n1);
  const long long z_dim = b2 * out_size;
  if (a_dim > (1LL << 30) || z_dim > (1LL << 30) ||
      (z_dim + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = make_plan(n, q, n1, b2, out_size);
  if (pl.bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  // two CTAs per SM (at most 128 registers a thread, some spilled) where
  // the grid has more CTAs than the card has SMs; else one, with all the
  // registers it can use
  const long long a_tiles = (a_dim + kTile - 1) / kTile;
  const long long z_tiles = (z_dim + kTile - 1) / kTile;
  const bool pair = a_tiles * z_tiles * slices > sms;
  const cudaError_t err = pair ? ensure_smem_cap<2>() : ensure_smem_cap<1>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long chunks = (npix + kChunkP - 1) / kChunkP;
  const long long pix_per_slice = (chunks + slices - 1) / slices * kChunkP;
  const bool vec = npix % 4 == 0 && reinterpret_cast<uintptr_t>(views) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(a_tiles), static_cast<unsigned>(z_tiles),
                  static_cast<unsigned>(slices));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = slices > 1 ? static_cast<float*>(scratch) : static_cast<float*>(d_cmt);
  auto* kernel = pair ? eps_dcore_kernel<2> : eps_dcore_kernel<1>;
  kernel<<<grid, kThreads, static_cast<size_t>(pl.bytes), s>>>(
      static_cast<const float*>(views), static_cast<const float*>(g), dst, n, q,
      n1, static_cast<int>(a_dim), static_cast<int>(b2), static_cast<int>(z_dim),
      out_size, npix, pix_per_slice, vec);
  if (slices > 1) {
    const long long count = z_dim * a_dim;
    const unsigned blocks = static_cast<unsigned>(std::min((count + 255) / 256, 4096LL));
    sum_slices_kernel<<<blocks, 256, 0, s>>>(dst, static_cast<float*>(d_cmt),
                                             count, slices);
  }
  return static_cast<int>(cudaGetLastError());
}
