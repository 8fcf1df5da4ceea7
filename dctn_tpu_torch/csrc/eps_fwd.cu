// EPS forward for Hopper (sm_90a): the forward of one EPS layer in the fast
// (cmt) parameter layout, for serving and for training.
//
// Replaces the TPU kernel _fwd_kernel_factory (dctn_tpu/pallas/eps_pallas.py:227),
// both forms: without t (serving) and with save_t (training: the backward's
// d_views pass reads t instead of recomputing it). With the digits row-major
// (factor 0, resp. n1, the slowest) and rows z = o*B2 + b:
//   u[a, p]   = prod_{k < n1}  views[k, digit_k(a), p]     (A  = q^n1 rows)
//   t[z, p]   = sum_a cmt[z, a] * u[a, p]                   (B2 = q^(n-n1))
//   v[b, p]   = prod_{k >= n1} views[k, digit_k(b), p]
//   out[o, p] = sum_b t[o*B2 + b, p] * v[b, p]              (out = t if n2 == 0)
//
// What bounds it on this card: the t = cmt.u product, 2*Z*A flops per pixel,
// at the fastest float32-accurate rate of an H100 SXM (700 W), 3xTF32 on the
// tensor cores at 495/3 = 165 TFLOP/s (tf32x3.cuh): 41.9 GFLOP (0.254 ms)
// for the flagship's first layer and 213.0 GFLOP (1.29 ms) for its second at
// batch 128, 61.7 GFLOP (0.374 ms) at the deep (4,4),(3,12),(2,24) model's
// last layer. The bytes are few: the factors read once, cmt once per pixel
// tile (mostly from L2), out written once; with save_t also t, Z*npix*4
// bytes (416 MB at the flagship's second layer, about 0.12 ms at 3.35 TB/s).
//
// Design: a GEMM with M = Z, N = pixels and K = A. cmt is a real matrix in
// memory; u exists only on chip. Each CTA of 8 warps owns one 128-pixel tile
// and a Z tile of whole outputs: G = floor(128 / B2) outputs where B2 <= 128
// (the rows past G*B2 are masked), else one output, whose B2 rows it walks
// in passes of 128 rows. So the sum over b never crosses CTAs, and u is
// built once per pixel tile for all the outputs of the Z tile, not once per
// output channel. The CTA stages its tile of every factor row (n*q rows of
// 128 pixels) in shared memory once, and u's Kronecker factor Y (the product
// of u's lv trailing factors, the most with s = q^lv <= 16); a step of 32
// columns of A forms u = X[a / s] * Y[a % s] (X: the n1 - lv leading
// factors), one multiply per entry. The product order differs from the JAX
// suffix chain's, within the float32 rounding the tests and chip_smoke.py
// allow (1e-4 of max|ref|). Both operands are split into TF32 hi and lo and
// multiplied in 3xTF32 (tf32x3.cuh); the sums of 128 values of A at most stay
// in the tensor cores' accumulators (which truncate), then go into f32
// totals in registers. Two kernels run the product:
// - wgmma (s % 4 == 0 and its plan fits: every layer of the flagship and
//   deep models, and the three-EPS model's first two). cmt streams in with
//   cp.async (16-byte, three raw stages, up to three steps ahead); per step
//   the CTA writes both operands as hi and lo planes in shared memory (cmt's
//   128 rows and u's 128 pixels x 32 columns, K-major, without swizzle), and
//   each warpgroup issues 12 asynchronous wgmma.m64n128k8 on its 64 rows
//   (lo*hi, hi*lo, hi*hi per k8) while the CTA writes the next step's
//   planes. Each entry is split once per CTA.
// - mma.sync (any other shape, n*q up to 256): cmt's tile streams in with
//   cp.async, double-buffered; each warp owns 64 (z) x 32 (pixels) of the
//   pass, 4 x 4 fragments of mma.sync.m16n8k8, three mma per fragment pair,
//   its cmt entries read as float2 and its u entries formed as X times Y
//   (X per step, one warp per row), both split in registers.
// Epilogue, per pass: t = totals + accumulators; with save_t each thread
// stores its t entries (float2 rows of two pixels). Each entry times v[b, p]
// (the v factors' product, from the staged rows) goes to a 128 x 128 tile in
// shared memory; then one thread per (output, pixel) adds the output's rows
// in order, and, where B2 > 128, onto the sum of the earlier passes. The
// serving form and the save_t form run the same sums: their outputs are the
// same bits. No atomics and no cross-CTA sums: the result is the same from
// run to run.
//
// Limits (checked by the Python wrapper, again here): B2 <= 512; n*q <= 256
// staged factor rows; O <= 65535 (the Z tiles along grid.y). The mma.sync
// kernel's shared memory is at most 218 KB at those limits (n*q = 256),
// within the 227 KB a block may use; the wgmma kernel's (210-218 KB at the
// flagship's and the deep model's layers) fits up to n*q of about 60.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int kTileZ = 128;               // rows of Z per pass
constexpr int kTileP = 128;               // pixels per CTA
constexpr int kChunkA = 32;               // columns of A per step
constexpr int kFlush = 128 / kChunkA;     // steps summed in the accumulators
constexpr int kRowStride = kTileP + 4;    // factor, X and Y rows: 4*row + pixel banks
constexpr int kEpiStride = kTileP + 8;    // epilogue rows: float2 stores without conflict
constexpr int kMaxKron = 16;              // the largest s = q^lv
constexpr int kMaxB2 = 512;
constexpr int kMaxFactorRows = 256;       // n * q
constexpr long long kMaxSmemBytes = 227 * 1024;
constexpr int kMaxDevices = 64;

// mma.sync: 8 warps of 64 (z) x 32 (pixels), cmt stage rows 40 floats apart
// (8*row + 2*tig banks: no conflict)
constexpr int kWarpZ = 64;
constexpr int kWarpP = 32;
constexpr int kMI = kWarpZ / 16;          // m16 fragments per warp
constexpr int kNJ = kWarpP / 8;           // n8 fragments per warp
constexpr int kCmtStride = kChunkA + 8;
static_assert(kThreads == (kTileZ / kWarpZ) * (kTileP / kWarpP) * 32, "8 warps cover the tile");

// wgmma: a step's four operand planes (cmt hi, cmt lo, u hi, u lo), each 128
// rows x 32 columns, K-major without swizzle: row r, column a at float
// (r / 8) * kGroupFloats + (a / 4) * 32 + (r % 8) * 4, so the two core
// matrices of a k8 step are 128 bytes apart and row groups 1024 bytes
constexpr int kPlaneFloats = kTileZ * kChunkA;
constexpr int kStepFloats = 4 * kPlaneFloats;  // 64 KB
constexpr int kGroupFloats = 8 * kChunkA;
// cmt's raw stages, rows 36 floats apart (a quarter warp's 16-byte reads of
// 8 rows fall in 8 bank groups); the latest two in flight
constexpr int kRawStride = kChunkA + 4;
constexpr int kRawFloats = kTileZ * kRawStride;
constexpr int kRawStages = 3;
static_assert(kTileZ == kTileP && kThreads == 2 * 128, "two warpgroups, one layout for both planes");

__host__ __device__ constexpr long long ipow(long long base, int exp) {
  long long r = 1;
  for (int i = 0; i < exp; ++i) r *= base;
  return r;
}

// the wgmma kernel's Y is pixel-major, Y[p][y], so a 16-byte read gives a
// column quad's 4 values; rows s + 4 or s + 8 floats apart (4 mod 8: a
// quarter warp's reads of 8 pixels fall in 8 bank groups)
__host__ __device__ constexpr int y_stride(int s) { return s + (s % 8 == 0 ? 4 : 8); }

// The launch plan and the shared memory of each kernel. Both hold the staged
// factor rows (n*q rows of kRowStride), Y, the int table of each pass row's
// v factors (n2 staged row offsets a row) and a region that the epilogue's
// 128 x 128 tile of t*v entries (kEpiStride apart) takes over: the mma.sync
// kernel's two cmt stages and two X buffers (x_rows rows each), the wgmma
// kernel's two steps of planes (its raw cmt stages lie beside them).
struct Plan {
  int lv, s, lead, x_rows, g, passes, n2;
  long long region_floats, mma_bytes, wgmma_bytes;
};

__host__ __device__ inline Plan make_plan(int n, int q, int n1, long long b2, int out_size) {
  Plan p;
  p.lv = 0;
  long long s = 1;
  while (p.lv < n1 && s * q <= kMaxKron) {
    s *= q;
    ++p.lv;
  }
  p.s = static_cast<int>(s);
  p.lead = n1 - p.lv;
  // X rows a step spans, starting at any a0 % s
  p.x_rows = (p.s - 1 + kChunkA - 1) / p.s + 1;
  const long long g = b2 <= kTileZ ? kTileZ / b2 : 1;
  p.g = static_cast<int>(g < out_size ? g : out_size);
  p.passes = static_cast<int>((p.g * b2 + kTileZ - 1) / kTileZ);
  p.n2 = n - n1;
  const long long epi = static_cast<long long>(kTileZ) * kEpiStride;
  const long long stages = 2LL * kTileZ * kCmtStride + 2LL * p.x_rows * kRowStride;
  p.region_floats = stages > epi ? stages : epi;
  const long long common = static_cast<long long>(n) * q * kRowStride + static_cast<long long>(kTileZ) * p.n2;
  p.mma_bytes = 4 * (common + static_cast<long long>(p.s) * kRowStride + p.region_floats);
  const long long planes = 2LL * kStepFloats;
  p.wgmma_bytes = 4 * (common + static_cast<long long>(kTileP) * y_stride(p.s) +
                       (planes > epi ? planes : epi) + kRawStages * kRawFloats);
  return p;
}

// x / d for 0 <= x < 2^31 by a multiply and a shift (Granlund-Montgomery, as
// CUTLASS's FastDivmod): the digit loops divide by q once per digit
struct FastDiv {
  unsigned d, mul, shift;
};

__host__ __device__ inline FastDiv make_fastdiv(unsigned d) {
  FastDiv f{d, 0u, 0u};
  if (d == 1) return f;
  unsigned l = 0;
  while ((1u << l) < d) ++l;  // ceil(log2 d)
  f.mul = static_cast<unsigned>(((1ULL << (31 + l)) + d - 1) / d);
  f.shift = l - 1;
  return f;
}

__device__ __forceinline__ unsigned fast_div(unsigned x, const FastDiv& f) {
  return f.d == 1 ? x : __umulhi(x, f.mul) >> f.shift;
}

// the product of `count` staged factor rows, starting at factor `first`, at
// the digits of `value` (most significant first), for the 4 pixels at `px`;
// the empty product is 1
__device__ __forceinline__ float4 row_product(const float* f, unsigned value, int first,
                                              int count, const FastDiv& q, int px) {
  float4 r = make_float4(1.f, 1.f, 1.f, 1.f);
  for (int k = count - 1; k >= 0; --k) {
    const unsigned next = fast_div(value, q);
    const int d = static_cast<int>(value - next * q.d);
    value = next;
    const float4 x = *reinterpret_cast<const float4*>(
        f + ((first + k) * static_cast<int>(q.d) + d) * kRowStride + px);
    r.x *= x.x;
    r.y *= x.y;
    r.z *= x.z;
    r.w *= x.w;
  }
  return r;
}

// the CTA's tile of every factor row, zero past npix
__device__ __forceinline__ void stage_factors(float* fs, const float* __restrict__ views, int nq,
                                              long long p0, long long npix, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < nq * (kTileP / 4); i += kThreads) {
      const int r = i / (kTileP / 4);
      const int px = (i % (kTileP / 4)) * 4;
      const long long gp = p0 + px;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gp < npix) v = *reinterpret_cast<const float4*>(views + r * npix + gp);
      *reinterpret_cast<float4*>(fs + r * kRowStride + px) = v;
    }
  } else {
    for (int i = threadIdx.x; i < nq * kTileP; i += kThreads) {
      const int r = i / kTileP;
      const long long gp = p0 + i % kTileP;
      fs[r * kRowStride + i % kTileP] = gp < npix ? views[r * npix + gp] : 0.f;
    }
  }
}

// the v factors of each pass row's b (rows zp .. zp + 127 of the CTA), as
// offsets into the staged rows
__device__ __forceinline__ void fill_vtab(int* vtab, int zp, int b2, int n1, int n2, int q) {
  const int r = threadIdx.x;
  if (r >= kTileZ) return;
  int b = (zp + r) % b2;
  for (int k = n2 - 1; k >= 0; --k) {
    vtab[r * n2 + k] = ((n1 + k) * q + b % q) * kRowStride;
    b /= q;
  }
}

// cmt's tile of one step: rows z_first .. z_first + 127 (zero at and past
// row `rows` of the pass), columns a0 .. a0 + 31 (zero past A), rows kStride
// floats apart
template <int kStride>
__device__ __forceinline__ void stage_cmt(float* dst, const float* __restrict__ cmt,
                                          long long z_first, int rows, int a_dim, int a0,
                                          bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < kTileZ * (kChunkA / 4); i += kThreads) {
      const int r = i / (kChunkA / 4);
      const int seg = (i % (kChunkA / 4)) * 4;
      const int left = a_dim - a0 - seg;
      const int bytes = r >= rows || left <= 0 ? 0 : left >= 4 ? 16 : 4 * left;
      const float* src = bytes > 0 ? cmt + (z_first + r) * a_dim + a0 + seg : cmt;
      tf32x3::cp_async16(dst + r * kStride + seg, src, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < kTileZ * kChunkA; i += kThreads) {
      const int r = i / kChunkA;
      const int a = i % kChunkA;
      const bool ok = r < rows && a0 + a < a_dim;
      tf32x3::cp_async4(dst + r * kStride + a, ok ? cmt + (z_first + r) * a_dim + a0 + a : cmt,
                        ok ? 4 : 0);
    }
  }
}

// The epilogue of one t entry pair, at row r of the pass and pixels px and px
// + 1 of the tile: with save_t, t0 and t1 go to t's row `t_row`; times v,
// to the epilogue tile
template <bool kSaveT>
__device__ __forceinline__ void emit_pair(float* __restrict__ t, float* epi, const float* fs,
                                          const int* vtab, int n2, long long t_row, long long p0,
                                          long long npix, int r, int px, float t0, float t1) {
  if (kSaveT) {
    const long long gp = p0 + px;
    float* row = t + t_row * npix + gp;
    if (npix % 2 == 0) {
      if (gp < npix) *reinterpret_cast<float2*>(row) = make_float2(t0, t1);
    } else {
      if (gp < npix) row[0] = t0;
      if (gp + 1 < npix) row[1] = t1;
    }
  }
  float2 v = make_float2(1.f, 1.f);
  for (int k = 0; k < n2; ++k) {
    const float2 f = *reinterpret_cast<const float2*>(fs + vtab[r * n2 + k] + px);
    v.x *= f.x;
    v.y *= f.y;
  }
  *reinterpret_cast<float2*>(epi + r * kEpiStride + px) = make_float2(t0 * v.x, t1 * v.y);
}

// out[o, p] from the epilogue tile: the rows of each of the CTA's outputs in
// order, onto the earlier passes' sum (B2 > 128: one output, so at most one
// (output, pixel) a thread, whose sum `carry` holds); written after the
// last pass
__device__ __forceinline__ void sum_outputs(float* __restrict__ out, const float* epi,
                                            const Plan& pl, int pass, int outs, int b2, int zp,
                                            int rows, int o0, long long p0, long long npix,
                                            float& carry) {
  const int outs_here = pl.passes > 1 ? 1 : outs;
  for (int pair = threadIdx.x; pair < outs_here * kTileP; pair += kThreads) {
    const int ol = pair / kTileP;
    const int px = pair % kTileP;
    const int r_begin = max(ol * b2 - zp, 0);
    const int r_end = min((ol + 1) * b2 - zp, rows);
    float s = pass > 0 ? carry : 0.f;
    for (int r = r_begin; r < r_end; ++r) s += epi[r * kEpiStride + px];
    carry = s;
    if (pass == pl.passes - 1 && p0 + px < npix) out[(o0 + ol) * npix + p0 + px] = s;
  }
}

// --- the mma.sync kernel

// X rows x0 .. x0 + count - 1 (zero from x_end on), one warp per row, 4
// pixels a lane
__device__ __forceinline__ void build_x(float* xb, const float* fs, const Plan& pl,
                                        const FastDiv& q, int x0, int count, int x_end) {
  const int warp = threadIdx.x / 32;
  const int px = (threadIdx.x % 32) * 4;
  for (int r = warp; r < count; r += kThreads / 32) {
    const int x = x0 + r;
    const float4 v = x < x_end ? row_product(fs, x, 0, pl.lead, q, px)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(xb + r * kRowStride + px) = v;
  }
}

template <bool kSaveT>
__global__ void __launch_bounds__(kThreads, 1)
eps_fwd_mma_kernel(const float* __restrict__ views, const float* __restrict__ cmt,
                   float* __restrict__ out, float* __restrict__ t, int n, int q, int n1,
                   int a_dim, int b2, int out_size, long long npix, bool vec_views,
                   bool vec_cmt) {
  extern __shared__ float4 smem4[];
  const Plan pl = make_plan(n, q, n1, b2, out_size);
  const int nq = n * q;
  float* fs = reinterpret_cast<float*>(smem4);          // (n*q, kRowStride)
  float* ys = fs + nq * kRowStride;                     // (s, kRowStride)
  float* region = ys + pl.s * kRowStride;
  float* cbuf = region;                                 // 2 x (kTileZ, kCmtStride)
  float* xbuf = region + 2 * kTileZ * kCmtStride;       // 2 x (x_rows, kRowStride)
  float* epi = region;                                  // (kTileZ, kEpiStride)
  int* vtab = reinterpret_cast<int*>(region + pl.region_floats);  // (kTileZ, n2)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tig = lane % 4;
  const int wz = (warp / (kTileP / kWarpP)) * kWarpZ;
  const int wp = (warp % (kTileP / kWarpP)) * kWarpP;
  const long long p0 = static_cast<long long>(blockIdx.x) * kTileP;
  const int o0 = blockIdx.y * pl.g;
  const int outs = min(pl.g, out_size - o0);            // outputs of this CTA
  const int cta_rows = outs * b2;
  const long long z_cta = static_cast<long long>(o0) * b2;
  const int x_end = a_dim / pl.s;                       // X rows of u
  const FastDiv qd = make_fastdiv(q);
  const int chunks = (a_dim + kChunkA - 1) / kChunkA;
  // a / s for a < s + 31 by a multiply and a shift (exact there for s <= 16)
  const int inv_s = (65536 + pl.s - 1) / pl.s;

  stage_factors(fs, views, nq, p0, npix, vec_views);
  __syncthreads();
  for (int r = warp; r < pl.s; r += kThreads / 32) {
    const int px = lane * 4;
    *reinterpret_cast<float4*>(ys + r * kRowStride + px) =
        row_product(fs, r, pl.lead, pl.lv, qd, px);
  }

  float carry = 0.f;
  for (int pass = 0; pass < pl.passes; ++pass) {
    const int zp = pass * kTileZ;                       // first CTA row of the pass
    const int rows = min(kTileZ, cta_rows - zp);        // rows of the pass
    fill_vtab(vtab, zp, b2, n1, pl.n2, q);
    float acc[kMI][kNJ][4], tot[kMI][kNJ][4];
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;

    stage_cmt<kCmtStride>(cbuf, cmt, z_cta + zp, rows, a_dim, 0, vec_cmt);
    tf32x3::cp_async_commit();
    build_x(xbuf, fs, pl, qd, 0, pl.x_rows, x_end);
    for (int c = 0; c < chunks; ++c) {
      tf32x3::cp_async_wait_all();  // this thread's copies of step c
      __syncthreads();  // step c's cmt and X are in; step c - 1's buffers are free
      const int a0 = c * kChunkA;
      if (c + 1 < chunks) {
        const int a1 = a0 + kChunkA;
        stage_cmt<kCmtStride>(cbuf + ((c + 1) % 2) * kTileZ * kCmtStride, cmt, z_cta + zp, rows,
                              a_dim, a1, vec_cmt);
        tf32x3::cp_async_commit();
        const int x1 = a1 / pl.s;
        build_x(xbuf + ((c + 1) % 2) * pl.x_rows * kRowStride, fs, pl, qd, x1,
                (a1 - x1 * pl.s + kChunkA - 1) / pl.s + 1, x_end);
      }
      if (wz < rows) {  // else the warp's 64 rows all lie past the pass
        const float* cs = cbuf + (c % 2) * kTileZ * kCmtStride;
        const float* xb = xbuf + (c % 2) * pl.x_rows * kRowStride;
        const int m = a0 - (a0 / pl.s) * pl.s;            // a0 % s
#pragma unroll
        for (int k = 0; k < kChunkA / 8; ++k) {
          // b0: K column 2 tig of the step (k = tig), b1: 2 tig + 1 (k = tig + 4)
          int xo[2], yo[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int tt = m + 8 * k + 2 * tig + h;
            const int xq = (tt * inv_s) >> 16;
            xo[h] = xq * kRowStride;
            yo[h] = (tt - xq * pl.s) * kRowStride;
          }
          uint32_t bh[kNJ][2], bl[kNJ][2];
#pragma unroll
          for (int j = 0; j < kNJ; ++j) {
            const int px = wp + 8 * j + gq;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              tf32x3::split_frag(xb[xo[h] + px] * ys[yo[h] + px], bh[j][h], bl[j][h]);
          }
          uint32_t ah[kMI][4], al[kMI][4];
#pragma unroll
          for (int i = 0; i < kMI; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              // a0/a1: row gq / gq + 8 at column 2 tig, a2/a3 at 2 tig + 1
              const float2 v = *reinterpret_cast<const float2*>(
                  cs + (wz + 16 * i + gq + 8 * h) * kCmtStride + 8 * k + 2 * tig);
              tf32x3::split_frag(v.x, ah[i][h], al[i][h]);
              tf32x3::split_frag(v.y, ah[i][h + 2], al[i][h + 2]);
            }
          // the three products of one fragment 16 mma apart
          tf32x3::mma3_tiles(acc, ah, al, bh, bl);
        }
      }
      if (c % kFlush == kFlush - 1) {
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int j = 0; j < kNJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[i][j][e] += acc[i][j][e];
              acc[i][j][e] = 0.f;
            }
      }
    }
    __syncthreads();  // every warp is done with the stages: the region takes the epilogue

    // fragment element e: row gq (+8 for e >= 2), pixel 2 tig (+1 for odd e)
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wz + 16 * i + gq + 8 * h;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          emit_pair<kSaveT>(t, epi, fs, vtab, pl.n2, z_cta + zp + r, p0, npix, r,
                            wp + 8 * j + 2 * tig, tot[i][j][2 * h] + acc[i][j][2 * h],
                            tot[i][j][2 * h + 1] + acc[i][j][2 * h + 1]);
      }
    __syncthreads();
    sum_outputs(out, epi, pl, pass, outs, b2, zp, rows, o0, p0, npix, carry);
    __syncthreads();  // the region and the table are free for the next pass
  }
}

// --- the wgmma kernel

// x split into TF32 hi and lo, stored as float4s at offset o of both planes
__device__ __forceinline__ void store_split(float* hi, float* lo, int o, float4 x) {
  const float4 h = make_float4(tf32x3::round_tf32(x.x), tf32x3::round_tf32(x.y),
                               tf32x3::round_tf32(x.z), tf32x3::round_tf32(x.w));
  *reinterpret_cast<float4*>(hi + o) = h;
  *reinterpret_cast<float4*>(lo + o) = make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
}

// One step's planes, columns a0 .. a0 + 31 of A: cmt's from its raw stage
// (zero past the pass's rows and past A) and u at the CTA's 128 pixels. Each
// thread writes 16-byte units of 4 columns: cmt's in 8 rows x 4 column quads
// a warp, u's in one column quad x 32 pixels a warp (s % 4 == 0, so a quad
// lies in one X row: u = X[a / s] * Y[a % s + e]).
__device__ __forceinline__ void build_step(float* buf, const float* raw, int a0, const float* fs,
                                           const float* ys, const Plan& pl, const FastDiv& qd,
                                           int x_end) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int m = 0; m < kTileZ * kChunkA / 4 / kThreads; ++m) {
    const int unit = tid + kThreads * m;
    const int zl = unit % 8, aq = (unit / 8) % 8, zg = unit / 64;
    const float4 v = *reinterpret_cast<const float4*>(raw + (8 * zg + zl) * kRawStride + 4 * aq);
    store_split(buf, buf + kPlaneFloats, zg * kGroupFloats + aq * 32 + zl * 4, v);
  }
  const int aq = tid / 32;
  const int a = a0 + 4 * aq;
  const int x = a / pl.s;
  const int y = a - x * pl.s;
  float xv[kTileP / 32];
#pragma unroll
  for (int m = 0; m < kTileP / 32; ++m) xv[m] = x < x_end ? 1.f : 0.f;
  unsigned rest = x;
  for (int k = pl.lead - 1; k >= 0; --k) {  // the X factors at the digits of x
    const unsigned next = fast_div(rest, qd);
    const float* f =
        fs + (k * static_cast<int>(qd.d) + static_cast<int>(rest - next * qd.d)) * kRowStride;
    rest = next;
#pragma unroll
    for (int m = 0; m < kTileP / 32; ++m) xv[m] *= f[tid % 32 + 32 * m];
  }
  const int ys_stride = y_stride(pl.s);
#pragma unroll
  for (int m = 0; m < kTileP / 32; ++m) {
    const int px = tid % 32 + 32 * m;
    const float4 yq = *reinterpret_cast<const float4*>(ys + px * ys_stride + y);
    const float4 u = make_float4(xv[m] * yq.x, xv[m] * yq.y, xv[m] * yq.z, xv[m] * yq.w);
    store_split(buf + 2 * kPlaneFloats, buf + 3 * kPlaneFloats,
                (px / 8) * kGroupFloats + aq * 32 + (px % 8) * 4, u);
  }
}

template <bool kSaveT>
__global__ void __launch_bounds__(kThreads, 1)
eps_fwd_wgmma_kernel(const float* __restrict__ views, const float* __restrict__ cmt,
                     float* __restrict__ out, float* __restrict__ t, int n, int q, int n1,
                     int a_dim, int b2, int out_size, long long npix, bool vec_views,
                     bool vec_cmt) {
  extern __shared__ float4 smem4[];
  const Plan pl = make_plan(n, q, n1, b2, out_size);
  const int nq = n * q;
  float* planes = reinterpret_cast<float*>(smem4);      // 2 steps x kStepFloats
  float* epi = planes;                                   // (kTileZ, kEpiStride)
  float* raws = planes + max(2 * kStepFloats, kTileZ * kEpiStride);  // kRawStages x kRawFloats
  float* fs = raws + kRawStages * kRawFloats;            // (n*q, kRowStride)
  float* ys = fs + nq * kRowStride;                      // (kTileP, y_stride(s))
  int* vtab = reinterpret_cast<int*>(ys + kTileP * y_stride(pl.s));  // (kTileZ, n2)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tig = lane % 4;
  const int wg = warp / 4;                               // warpgroup: rows 64 wg ..
  const long long p0 = static_cast<long long>(blockIdx.x) * kTileP;
  const int o0 = blockIdx.y * pl.g;
  const int outs = min(pl.g, out_size - o0);
  const int cta_rows = outs * b2;
  const long long z_cta = static_cast<long long>(o0) * b2;
  const int x_end = a_dim / pl.s;
  const int chunks = (a_dim + kChunkA - 1) / kChunkA;
  const FastDiv qd = make_fastdiv(q);

  stage_factors(fs, views, nq, p0, npix, vec_views);
  __syncthreads();
  for (int r = warp; r < pl.s; r += kThreads / 32) {
    const int px = lane * 4;
    const float4 v = row_product(fs, r, pl.lead, pl.lv, qd, px);
    const int st = y_stride(pl.s);
    ys[px * st + r] = v.x;
    ys[(px + 1) * st + r] = v.y;
    ys[(px + 2) * st + r] = v.z;
    ys[(px + 3) * st + r] = v.w;
  }

  float carry = 0.f;
  for (int pass = 0; pass < pl.passes; ++pass) {
    const int zp = pass * kTileZ;
    const int rows = min(kTileZ, cta_rows - zp);
    fill_vtab(vtab, zp, b2, n1, pl.n2, q);
    float acc[64], tot[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
    // cmt's raw stages run up to three steps ahead of the products
    for (int c = 0; c < kRawStages; ++c) {
      if (c < chunks)
        stage_cmt<kRawStride>(raws + c * kRawFloats, cmt, z_cta + zp, rows, a_dim, c * kChunkA,
                              vec_cmt);
      tf32x3::cp_async_commit();  // an empty group past the last step keeps the count
    }
    tf32x3::cp_async_wait_group<kRawStages - 2>();  // steps 0 and 1
    __syncthreads();
    build_step(planes, raws, 0, fs, ys, pl, qd, x_end);
    tf32x3::fence_async_smem();
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      const float* buf = planes + (c % 2) * kStepFloats;
      // both warpgroups multiply, also one whose rows lie past the pass (its
      // planes are zero there): a branch around wgmma serializes them
      tf32x3::wgmma_fence();
      tf32x3::wgmma_pin(acc);
#pragma unroll
      for (int kk = 0; kk < kChunkA / 8; ++kk) {
        const int ao = 8 * wg * kGroupFloats + 2 * kk * 32;  // rows 64 wg .., K groups 2 kk, 2 kk + 1
        const uint64_t ah = tf32x3::smem_desc<128, 1024>(buf + ao);
        const uint64_t al = tf32x3::smem_desc<128, 1024>(buf + kPlaneFloats + ao);
        const uint64_t bh = tf32x3::smem_desc<128, 1024>(buf + 2 * kPlaneFloats + 2 * kk * 32);
        const uint64_t bl = tf32x3::smem_desc<128, 1024>(buf + 3 * kPlaneFloats + 2 * kk * 32);
        tf32x3::wgmma_m64n128k8(acc, al, bh);
        tf32x3::wgmma_m64n128k8(acc, ah, bl);
        tf32x3::wgmma_m64n128k8(acc, ah, bh);
      }
      tf32x3::wgmma_commit();
      if (c + kRawStages < chunks)  // step c's raw stage was read in step c - 1
        stage_cmt<kRawStride>(raws + (c % kRawStages) * kRawFloats, cmt, z_cta + zp, rows, a_dim,
                              (c + kRawStages) * kChunkA, vec_cmt);
      tf32x3::cp_async_commit();  // an empty group past the last step keeps the count
      if (c + 1 < chunks) {  // the next step's planes, beside the products
        build_step(planes + ((c + 1) % 2) * kStepFloats, raws + ((c + 1) % kRawStages) * kRawFloats,
                   (c + 1) * kChunkA, fs, ys, pl, qd, x_end);
        tf32x3::fence_async_smem();
      }
      tf32x3::wgmma_wait_all();
      tf32x3::wgmma_pin(acc);
      if (c % kFlush == kFlush - 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          tot[i] += acc[i];
          acc[i] = 0.f;
        }
      }
      tf32x3::cp_async_wait_group<kRawStages - 2>();  // this thread's copies of step c + 2
      __syncthreads();  // step c's planes are free; step c + 1's planes and c + 2's stage are in
    }
    tf32x3::cp_async_wait_all();

    // accumulator element 4 j + e: row 16 (warp % 4) + gq (+8 for e >= 2) of
    // the warpgroup's 64, pixel 8 j + 2 tig (+1 for odd e)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * (warp % 4) + gq + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < kTileP / 8; ++j)
        emit_pair<kSaveT>(t, epi, fs, vtab, pl.n2, z_cta + zp + r, p0, npix, r, 8 * j + 2 * tig,
                          tot[4 * j + 2 * h] + acc[4 * j + 2 * h],
                          tot[4 * j + 2 * h + 1] + acc[4 * j + 2 * h + 1]);
    }
    __syncthreads();
    sum_outputs(out, epi, pl, pass, outs, b2, zp, rows, o0, p0, npix, carry);
    __syncthreads();  // the region and the table are free for the next pass
  }
}

// Raises a kernel's dynamic shared memory cap to kMaxSmemBytes, once per
// device and kernel (`Tag`), so the launch path makes no attribute call.
template <class Tag, class Kernel>
cudaError_t ensure_smem_cap(Kernel kernel) {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmemBytes));
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

template <bool kWgmma, bool kSaveT>
struct KernelTag {};

template <bool kWgmma, bool kSaveT>
int launch(const Plan& pl, const void* views, const void* cmt, void* out, void* t, int n, int q,
           int n1, long long a_dim, long long b2, int out_size, long long npix, void* stream) {
  const auto kernel = kWgmma ? eps_fwd_wgmma_kernel<kSaveT> : eps_fwd_mma_kernel<kSaveT>;
  const cudaError_t err = ensure_smem_cap<KernelTag<kWgmma, kSaveT>>(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((npix + kTileP - 1) / kTileP),
                  static_cast<unsigned>((out_size + pl.g - 1) / pl.g));
  const size_t bytes = static_cast<size_t>(kWgmma ? pl.wgmma_bytes : pl.mma_bytes);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(views), static_cast<const float*>(cmt), static_cast<float*>(out),
      static_cast<float*>(t), n, q, n1, static_cast<int>(a_dim), static_cast<int>(b2), out_size,
      npix, npix % 4 == 0 && reinterpret_cast<uintptr_t>(views) % 16 == 0,
      a_dim % 4 == 0 && reinterpret_cast<uintptr_t>(cmt) % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// views (n, q, npix) f32, cmt (O*B2, A) f32, out (O, npix) f32 and, unless
// null, t (O*B2, npix) f32, all contiguous on the current device; launches
// the wgmma kernel where s % 4 == 0 and its plan fits, else the mma.sync
// kernel, on `stream`, and does not synchronise. Returns cudaGetLastError()
// (0 on success).
extern "C" int dctn_eps_fwd(const void* views, const void* cmt, void* out,
                            void* t, int n, int q, int n1, int out_size,
                            long long npix, void* stream) {
  if (n < 1 || q < 1 || n1 < 1 || n1 > n || out_size < 1 ||
      out_size > 65535 || npix < 1 || n * q > kMaxFactorRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long a_dim = ipow(q, n1);
  const long long b2 = ipow(q, n - n1);
  if (b2 > kMaxB2 || a_dim > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = make_plan(n, q, n1, b2, out_size);
  const bool wgmma = pl.s % 4 == 0 && pl.wgmma_bytes <= kMaxSmemBytes;
  if (!wgmma && pl.mma_bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const auto go = t != nullptr ? (wgmma ? launch<true, true> : launch<false, true>)
                               : (wgmma ? launch<true, false> : launch<false, false>);
  return go(pl, views, cmt, out, t, n, q, n1, a_dim, b2, out_size, npix, stream);
}

// ---------------------------------------------------------------------------
// The bf16 operand mode (dctn_eps_fwd_bf16): _fwd_kernel_factory with
// cmt_ref.dtype bf16 (eps_pallas.py:227-250). u is formed in float32 as the
// JAX suffix chain forms it, u[a] = f_0[d_0] * (f_1[d_1] * (... *
// f_{n1-1}[d_{n1-1}])), the same float32 products as the plain version, and
// rounded to bf16; cmt arrives in bf16; t = cmt . u in one bf16 product a
// pair with float32 sums (bf16.cuh); the epilogue sums the unrounded float32
// t times the float32 v; with save_t, t is stored in bf16.
//
// What bounds it: the product, 2*Z*A flops per pixel at the dense bf16 rate
// of an H100 SXM (989 TFLOP/s at 700 W): 0.042 ms for the flagship's first
// layer at batch 128 and 0.215 ms for its second; bytes are fewer than in
// the float32 mode (cmt and t at 2 bytes an entry, u written and read once).
//
// Two routes, by Z = O * B2 (make_plan_bf16): the mma.sync route where Z <=
// 128 (fwd_bf16::mma below: one Z tile, u formed on chip), else wgmma.
// Design of the wgmma route, in chunks of pixels, as the bf16 eps_dcore
// (eps_dcore.cu):
// 1. eps_fwd_bf16_operands_kernel forms u of the chunk once a pixel and
//    writes it to device memory in bf16, a row of A (rounded up to a whole
//    step of 64, zeros past A) a pixel: the K-major layout of the product's
//    N operand. A CTA stages 64 pixels' columns of u's factors; a lane forms
//    8 consecutive values of A at two pixels (bf16op::suffix_chains) and
//    writes them as two 16-byte units, eight lanes a pixel's 128 bytes.
// 2. eps_fwd_bf16_kernel: t = cmt . u^T with M = Z, N = pixels, K = A. A CTA
//    of two warpgroups owns 128 pixels and a Z tile of whole outputs (G =
//    floor(128 / B2) where B2 <= 128, else one output walked in passes of
//    128 rows), so the sum over b stays in the CTA. cmt's 128-row and u's
//    128-pixel step tiles (64 values of A, 128 contiguous bytes a row) come
//    by cp.async, eight threads a row, into a ring of 4 stages in the
//    128-byte swizzle, two steps ahead; each warpgroup runs four
//    wgmma.m64n128k16 a step on its 64 rows, leaves a step's group in flight
//    while the CTA goes on to the next, and adds its accumulators into f32
//    totals every two steps (128 values of A: the tensor cores truncate as
//    they add). Where B2 > 128 a pass reads u's tiles again (from L2); it
//    never forms them again.
//    Epilogue, per pass, over the ring: each thread multiplies its t
//    entries by v (f_{n1} * (... * f_{n-1}), the chain's order, from the
//    staged v factors through a table of each row's digits) into a 128 x
//    128 f32 tile and, with save_t, puts t rounded to bf16 in a second tile,
//    which the CTA then stores in 16-byte units; one thread per (output,
//    pixel) adds the output's rows in order onto the earlier passes' sum.
//    The serving form and the save_t form run the same sums: their outputs
//    are the same bits. No atomics: the same bits from run to run.
// Why device memory: formed on chip per pass and per output tile, u was
// built 24 times a pixel at the flagship's second layer, and those builds,
// not the products, bounded the kernel. Formed once, u of the flagship's
// layer 1 at batch 128 is 139 MB of bf16, written once and read through L2;
// a chunk holds at most the wrapper's cap of it.
// cmt is read with a row of A rounded up to 64 values (the wrapper's
// zero-padded copy where A is not a multiple of 64); its rows past Z read
// its last row, whose sums are never used. Limits: B2 <= 512, n*q <= 256,
// pixel tiles of a chunk along grid.y (<= 65535). Shared memory 131072 +
// 4 (132 n2 q + 128 n2) bytes (the ring and v's factors), at most 198 KB at
// those limits (n2 q <= 128 where q^n2 <= 512 and n1 >= 1).

#include "bf16.cuh"

namespace {
namespace fwd_bf16 {

constexpr int kThreads = 256;                    // two warpgroups, 64 rows of a pass each
constexpr int kTileZ = 128;                      // rows of Z a pass (M)
constexpr int kTileP = 128;                      // pixels a CTA (N)
constexpr int kStepA = 64;                       // A a step (K): four k16 products, 128 bytes
constexpr int kStages = 4;                       // the ring
constexpr int kOpBytes = kTileZ * kStepA * 2;    // one operand's tile of a step
constexpr int kRingBytes = kStages * 2 * kOpBytes;
constexpr int kRow = kTileP + 4;                 // floats a staged v factor row
constexpr int kEpiRow = kTileP + 8;              // floats a row of the t*v tile
constexpr int kTRow = kTileP + 8;                // bf16 a row of the t tile (16-byte rows)
static_assert(kTileZ == kTileP, "one staging loop for both operands' tiles");
static_assert(4 * kTileZ * kEpiRow + 2 * kTileZ * kTRow <= kRingBytes,
              "the epilogue's tiles fit over the ring");
constexpr int kBuildP = 64;                      // pixels a CTA of the operands kernel
constexpr int kBuildRow = kBuildP + 8;           // floats a staged factor row there

// The mma.sync route, for Z <= kTileZ (one Z tile of the wgmma route, so
// its u would be used once: the three-EPS model's layers): the first bf16 kernel.
// A CTA of 4 warps owns 64 pixels and a Z tile of whole outputs (G =
// floor(64 / B2) where B2 <= 64, else one output in passes of 64 rows),
// stages its factor columns once and, per step of 64 columns of A, stages
// cmt's 64 x 64 bf16 and builds u's 64 x 64 on chip (each entry once per
// pass and step; Z <= 128 makes that once or twice a pixel), each warp 16
// rows x 64 pixels of mma.m16n8k16 summed per step into float32 totals;
// the epilogue puts the pass's t in shared memory (bf16 to t when asked)
// and one thread per (output, pixel) adds t times v over the output's rows
// onto the earlier passes' sum. Its digits by multiply-shift divisions.
// There the device-memory round trip of u and a second launch cost more
// than they save (PERF.md, section 6).
namespace mma {

constexpr int kThreads = 128;     // 4 warps, 16 rows of a pass each
constexpr int kTileZ = 64;        // rows of Z per pass
constexpr int kTileP = 64;        // pixels per CTA
constexpr int kChunkA = 64;       // columns of A per step: four k16 steps
constexpr int kWords = bf16op::op_words<kChunkA>();
constexpr int kRow = kTileP + 4;  // floats a row of the factor and t tiles
constexpr int kNj = kTileP / 8;   // n8 fragments a warp holds

__global__ void __launch_bounds__(kThreads)
    eps_fwd_bf16_mma_kernel(const float* __restrict__ views, const uint16_t* __restrict__ cmt,
                        float* __restrict__ out, uint16_t* __restrict__ t, int n, int q, int n1,
                        int a_dim, int b2, long long npix, int outputs, int passes,
                        int out_size, bool vec, bf16op::FastDiv div_q) {
  extern __shared__ __align__(16) float fsmem[];
  const int nq = n * q;
  float* fac = fsmem;                 // nq rows
  float* ts = fac + nq * kRow;        // kTileZ rows
  float* osum = ts + kTileZ * kRow;   // outputs x kTileP
  uint32_t* cm_op = reinterpret_cast<uint32_t*>(osum + outputs * kTileP);
  uint32_t* u_op = cm_op + kTileZ * kWords;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const long long p0 = static_cast<long long>(blockIdx.x) * kTileP;
  const int o0 = blockIdx.y * outputs;
  const int n_out = min(outputs, out_size - o0);
  const int rows = n_out * b2;
  const long long z0 = static_cast<long long>(o0) * b2;

  for (int i = tid; i < nq * kTileP; i += kThreads) {
    const int r = i / kTileP, j = i % kTileP;
    const long long p = p0 + j;
    fac[r * kRow + j] = p < npix ? views[r * npix + p] : 0.f;
  }
  for (int i = tid; i < outputs * kTileP; i += kThreads) osum[i] = 0.f;

  // the u build: a pair of columns of A (2 ap, 2 ap + 1) over 16 pixels
  const int ap = tid % (kChunkA / 2), jb = (tid / (kChunkA / 2)) * 16;
  for (int pass = 0; pass < passes; ++pass) {
    const int r0 = pass * kTileZ;
    float tot[kNj][4];
#pragma unroll
    for (int nj = 0; nj < kNj; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[nj][e] = 0.f;
    for (int a0 = 0; a0 < a_dim; a0 += kChunkA) {
      __syncthreads();  // the last step's operands are read (and fac staged)
      bf16op::stage_rows<kChunkA, kWords, kThreads>(cm_op, cmt, z0 + r0, kTileZ, rows - r0, a0,
                                                    a_dim, vec);
      {
        const int a = a0 + 2 * ap;
        const bool ok0 = a < a_dim, ok1 = a + 1 < a_dim;
        int rem0 = ok0 ? a : 0, rem1 = ok1 ? a + 1 : 0;
        float x0[16], x1[16];
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) x0[jj] = x1[jj] = 1.f;
        for (int k = n1 - 1; k >= 0; --k) {
          const int next0 = div_q(rem0), next1 = div_q(rem1);
          const float* f0 = fac + (k * q + rem0 - next0 * q) * kRow + jb;
          const float* f1 = fac + (k * q + rem1 - next1 * q) * kRow + jb;
          rem0 = next0;
          rem1 = next1;
#pragma unroll
          for (int jj = 0; jj < 16; ++jj) {
            x0[jj] = f0[jj] * x0[jj];
            x1[jj] = f1[jj] * x1[jj];
          }
        }
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
          u_op[(jb + jj) * kWords + ap] = bf16op::pack(ok0 ? x0[jj] : 0.f, ok1 ? x1[jj] : 0.f);
      }
      __syncthreads();
      float acc[kNj][4];
#pragma unroll
      for (int nj = 0; nj < kNj; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nj][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kChunkA / 16; ++ks) {
        uint32_t af[4];
        bf16op::load_a<kWords>(af, cm_op + warp * 16 * kWords, ks * 8);
#pragma unroll
        for (int nj = 0; nj < kNj; ++nj) {
          uint32_t bf[2];
          bf16op::load_b<kWords>(bf, u_op + nj * 8 * kWords, ks * 8);
          bf16op::mma(acc[nj], af, bf);
        }
      }
#pragma unroll
      for (int nj = 0; nj < kNj; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[nj][e] += acc[nj][e];
    }
    // the pass's t, unrounded, to shared memory
#pragma unroll
    for (int nj = 0; nj < kNj; ++nj) {
      const int r = warp * 16 + g, c = nj * 8 + 2 * tig;
      ts[r * kRow + c] = tot[nj][0];
      ts[r * kRow + c + 1] = tot[nj][1];
      ts[(r + 8) * kRow + c] = tot[nj][2];
      ts[(r + 8) * kRow + c + 1] = tot[nj][3];
    }
    __syncthreads();
    if (t != nullptr) {
      for (int i = tid; i < kTileZ * kTileP; i += kThreads) {
        const int r = i / kTileP, j = i % kTileP;
        if (r0 + r < rows && p0 + j < npix)
          t[(z0 + r0 + r) * npix + p0 + j] = bf16op::to_bf16(ts[r * kRow + j]);
      }
    }
    // out += t v over each output's rows of the pass, v[b] = f_{n1}[d] *
    // (... * f_{n-1}[d]) as the plain suffix chain (1 when n2 = 0)
    const int j = tid % kTileP, r_end = min(r0 + kTileZ, rows);
    for (int ol = tid / kTileP; ol < n_out; ol += kThreads / kTileP) {
      const int rb = max(ol * b2, r0), re = min((ol + 1) * b2, r_end);
      float s = osum[ol * kTileP + j];
      for (int r = rb; r < re; ++r) {
        int rem = r - ol * b2;
        float v = 1.f;
        for (int k = n - 1; k >= n1; --k) {
          const int next = div_q(rem);
          v = fac[(k * q + rem - next * q) * kRow + j] * v;
          rem = next;
        }
        s += ts[(r - r0) * kRow + j] * v;
      }
      osum[ol * kTileP + j] = s;
    }
  }
  __syncthreads();
  for (int i = tid; i < n_out * kTileP; i += kThreads) {
    const int ol = i / kTileP, j = i % kTileP;
    if (p0 + j < npix) out[(o0 + ol) * npix + p0 + j] = osum[i];
  }
}

}  // namespace mma

struct Plan {
  bool wgmma;  // else the mma.sync route
  int outputs, passes;
  long long product_bytes, build_bytes, smem_bytes;
};

__host__ inline Plan make_plan_bf16(int n, int q, int n1, long long b2, int out_size) {
  Plan p;
  p.wgmma = b2 * out_size > kTileZ;
  const long long tile = p.wgmma ? kTileZ : mma::kTileZ;
  p.outputs = b2 <= tile ? static_cast<int>(tile / b2 < out_size ? tile / b2 : out_size) : 1;
  p.passes = static_cast<int>((p.outputs * b2 + tile - 1) / tile);
  const int n2 = n - n1;
  if (p.wgmma) {
    p.product_bytes = kRingBytes + 4LL * (static_cast<long long>(n2) * q * kRow + kTileZ * n2);
    p.build_bytes = 4LL * n1 * q * kBuildRow;
  } else {
    p.product_bytes = 4LL * (mma::kRow * (n * q + mma::kTileZ) + p.outputs * mma::kTileP) +
                      4LL * 2 * mma::kTileZ * mma::kWords;
    p.build_bytes = 0;
  }
  p.smem_bytes = p.product_bytes > p.build_bytes ? p.product_bytes : p.build_bytes;
  return p;
}

// u of the chunk's pixels [c0, c0 + pc) into ops, a row of a_pad values a
// pixel (row 0: pixel c0), zero past A and past pc
__global__ void __launch_bounds__(kThreads)
    eps_fwd_bf16_operands_kernel(const float* __restrict__ views, uint16_t* __restrict__ ops,
                                 int q, int n1, int a_dim, int a_pad, long long npix,
                                 long long c0, int pc, bf16op::FastDiv div_q) {
  extern __shared__ __align__(16) float fac[];  // n1*q rows of kBuildRow
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int j0 = blockIdx.x * kBuildP;
  for (int i = tid; i < n1 * q * kBuildP; i += kThreads) {
    const int r = i / kBuildP, j = i % kBuildP;
    fac[r * kBuildRow + j] = j0 + j < pc ? views[r * npix + c0 + j0 + j] : 0.f;
  }
  __syncthreads();
  // a warp's 8 pixels x 64 values of A a round: lane (pixels j, j + 1;
  // values a .. a + 7)
  const int j = 8 * warp + 2 * (lane % 4);
  uint16_t* row0 = ops + static_cast<long long>(j0 + j) * a_pad;
  for (int a = kStepA * blockIdx.y + 8 * (lane / 4); a < a_pad; a += kStepA * gridDim.y) {
    int rem[8];
    float x0[8], x1[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      rem[i] = a + i < a_dim ? a + i : 0;
      x0[i] = x1[i] = 1.f;
    }
    bf16op::suffix_chains<8>(x0, x1, rem, fac, kBuildRow, j, n1 - 1, 0, q, div_q);
    uint32_t w0[4], w1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool lo = a + 2 * i < a_dim, hi = a + 2 * i + 1 < a_dim;
      w0[i] = bf16op::pack(lo ? x0[2 * i] : 0.f, hi ? x0[2 * i + 1] : 0.f);
      w1[i] = bf16op::pack(lo ? x1[2 * i] : 0.f, hi ? x1[2 * i + 1] : 0.f);
    }
    *reinterpret_cast<uint4*>(row0 + a) = make_uint4(w0[0], w0[1], w0[2], w0[3]);
    *reinterpret_cast<uint4*>(row0 + a_pad + a) = make_uint4(w1[0], w1[1], w1[2], w1[3]);
  }
}

// out (and, with kSaveT, t) at the chunk's pixels: the CTA's pixels
// c0 + 128 blockIdx.y .., its Z tile of `outputs` outputs from blockIdx.x
template <bool kSaveT>
__global__ void __launch_bounds__(kThreads, 1)
    eps_fwd_bf16_kernel(const float* __restrict__ views, const uint16_t* __restrict__ cmt,
                        const uint16_t* __restrict__ ops, float* __restrict__ out,
                        uint16_t* __restrict__ t, int n, int q, int n1, int a_pad, int b2,
                        int z_dim, int out_size, int outputs, int passes, long long npix,
                        long long c0, int pc, bool vec_t) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int n2 = n - n1;
  unsigned char* ring = smem;                             // kStages x (cmt tile, u tile)
  float* epi = reinterpret_cast<float*>(smem);            // kTileZ x kEpiRow, over the ring
  uint16_t* ts = reinterpret_cast<uint16_t*>(epi + kTileZ * kEpiRow);  // kTileZ x kTRow
  float* fs = reinterpret_cast<float*>(smem + kRingBytes);  // n2*q rows: v's factors
  int* vtab = reinterpret_cast<int*>(fs + n2 * q * kRow);   // kTileZ x n2

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wg = warp / 4;
  const int g = lane / 4, tig = lane % 4;
  const int pl = kTileP * blockIdx.y;  // the CTA's first pixel in the chunk
  const long long p0 = c0 + pl;
  const int o0 = blockIdx.x * outputs;
  const int outs = min(outputs, out_size - o0);
  const int cta_rows = outs * b2;
  const long long z_cta = static_cast<long long>(o0) * b2;
  const int steps = a_pad / kStepA;
  const uint16_t* urows = ops + static_cast<long long>(pl) * a_pad;

  for (int i = tid; i < n2 * q * kTileP; i += kThreads) {
    const int r = i / kTileP, j = i % kTileP;
    fs[r * kRow + j] = pl + j < pc ? views[(n1 * q + r) * npix + p0 + j] : 0.f;
  }

  float carry = 0.f;
  for (int pass = 0; pass < passes; ++pass) {
    const int zp = pass * kTileZ;
    const int rows = min(kTileZ, cta_rows - zp);
    if (tid < kTileZ) {  // each pass row's v factors (digit 0 the slowest), as offsets into fs
      int b = (zp + tid) % b2;
      for (int k = n2 - 1; k >= 0; --k) {
        vtab[tid * n2 + k] = (k * q + b % q) * kRow;
        b /= q;
      }
    }
    // step s's tiles (cmt's rows of the pass, then u's pixels) into ring
    // stage s % kStages, eight threads a row
    const auto stage = [&](int s) {
      unsigned char* d = ring + (s % kStages) * 2 * kOpBytes;
      const long long col = static_cast<long long>(s) * kStepA;
#pragma unroll
      for (int i = tid; i < 2 * kTileZ * 8; i += kThreads) {
        const int half = i / (kTileZ * 8), r = (i / 8) % kTileZ, c = i % 8;
        const long long zr = min(z_cta + zp + r, static_cast<long long>(z_dim) - 1);
        const uint16_t* src = half ? urows + static_cast<long long>(r) * a_pad + col + 8 * c
                                   : cmt + zr * a_pad + col + 8 * c;
        bf16op::cp_async16(d + half * kOpBytes + bf16op::sw128_offset(r, c), src);
      }
    };
    float acc[64], tot[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
    stage(0);
    tf32x3::cp_async_commit();
    if (steps > 1) stage(1);
    tf32x3::cp_async_commit();
    for (int s = 0; s < steps; ++s) {
      tf32x3::cp_async_wait_group<1>();  // this thread's copies of step s
      tf32x3::fence_async_smem();
      // step s is in; step s - 2's products are done in both warpgroups
      // (each waits for all its groups at every odd step)
      __syncthreads();
      const unsigned char* st = ring + (s % kStages) * 2 * kOpBytes;
      tf32x3::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kStepA / 16; ++ks) {
        const uint64_t ad = bf16op::smem_desc_sw128(st + 64 * 128 * wg + 32 * ks);
        const uint64_t bd = bf16op::smem_desc_sw128(st + kOpBytes + 32 * ks);
        // an even step starts the accumulators anew: two steps, 128 values of A
        bf16op::wgmma_m64n128k16(acc, ad, bd, (s & 1) | (ks > 0));
      }
      tf32x3::wgmma_commit();
      if (s + 2 < steps) stage(s + 2);  // over step s - 2's stage
      tf32x3::cp_async_commit();
      if (s & 1) {
        tf32x3::wgmma_wait<0>();
        tf32x3::wgmma_pin(acc);
#pragma unroll
        for (int i = 0; i < 64; ++i) tot[i] += acc[i];
      }
    }
    tf32x3::wgmma_wait<0>();
    tf32x3::wgmma_pin(acc);
    if (steps & 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    }
    tf32x3::cp_async_wait_group<0>();
    __syncthreads();  // every product is done: the epilogue's tiles take the ring

    // total 4 jn + e: row 64 wg + 16 (warp % 4) + g (+8 for e >= 2), pixel
    // 8 jn + 2 tig (+1 for odd e)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * (warp % 4) + g + 8 * h;
      if (r >= rows) continue;
      const int* vt = vtab + r * n2;
#pragma unroll
      for (int jn = 0; jn < kTileP / 8; ++jn) {
        const int px = 8 * jn + 2 * tig;
        const float t0 = tot[4 * jn + 2 * h], t1 = tot[4 * jn + 2 * h + 1];
        float2 v = make_float2(1.f, 1.f);
        for (int k = n2 - 1; k >= 0; --k) {
          const float2 f = *reinterpret_cast<const float2*>(fs + vt[k] + px);
          v.x = f.x * v.x;
          v.y = f.y * v.y;
        }
        *reinterpret_cast<float2*>(epi + r * kEpiRow + px) = make_float2(t0 * v.x, t1 * v.y);
        if (kSaveT) *reinterpret_cast<uint32_t*>(ts + r * kTRow + px) = bf16op::pack(t0, t1);
      }
    }
    __syncthreads();
    if (kSaveT) {  // the pass's t rows, 8 pixels (16 bytes) a unit
      for (int i = tid; i < rows * (kTileP / 8); i += kThreads) {
        const int r = i / (kTileP / 8), c = 8 * (i % (kTileP / 8));
        uint16_t* dst = t + (z_cta + zp + r) * npix + p0 + c;
        const uint16_t* src = ts + r * kTRow + c;
        if (vec_t && pl + c + 8 <= pc) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && pl + c + e < pc; ++e) dst[e] = src[e];
        }
      }
    }
    // out from the t*v tile: each output's rows in order, onto the earlier
    // passes' sum (B2 > 128: one output, at most one (output, pixel) a
    // thread, whose sum `carry` holds); written after the last pass
    const int outs_here = passes > 1 ? 1 : outs;
    for (int pair = tid; pair < outs_here * kTileP; pair += kThreads) {
      const int ol = pair / kTileP, px = pair % kTileP;
      const int r_begin = max(ol * b2 - zp, 0), r_end = min((ol + 1) * b2 - zp, rows);
      float sum = pass > 0 ? carry : 0.f;
      for (int r = r_begin; r < r_end; ++r) sum += epi[r * kEpiRow + px];
      carry = sum;
      if (pass == passes - 1 && pl + px < pc)
        out[static_cast<long long>(o0 + ol) * npix + p0 + px] = sum;
    }
    __syncthreads();  // the ring and the table are free for the next pass
  }
}

}  // namespace fwd_bf16
}  // namespace

// dctn_eps_fwd's bf16 mode: views (n, q, npix) float32, out (O, npix)
// float32, t (Z, npix) bf16 or null. On the wgmma route (Z > 128), one chunk
// of pixels: cmt (Z, A rounded up to 64) bf16 (zero past A, 16-byte
// aligned), ops the u of a chunk of `chunk` pixels (a multiple of 128):
// chunk x (A rounded up to 64) bf16, 16-byte aligned; forms u of pixels
// [c0, c0 + chunk) (c0 a multiple of chunk), then writes their out (and t);
// the caller runs the chunks of npix in order. On the mma.sync route (Z <=
// 128), all of npix in one call: cmt (Z, A) bf16; ops, c0 and chunk unused.
// On `stream`; no synchronisation. Returns cudaGetLastError() (0 on
// success).
extern "C" int dctn_eps_fwd_bf16(const void* views, const void* cmt, void* out, void* t,
                                 void* ops, int n, int q, int n1, int out_size, long long npix,
                                 long long c0, long long chunk, void* stream) {
  namespace fb = fwd_bf16;
  if (n < 1 || q < 1 || n1 < 1 || n1 > n || out_size < 1 || npix < 1 ||
      n * q > bf16op::kMaxFactorRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long a_dim = bf16op::ipow(q, n1);
  const long long b2 = bf16op::ipow(q, n - n1);
  if (b2 > bf16op::kMaxB2 || a_dim > (1LL << 30) || b2 * out_size > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const fb::Plan pl = fb::make_plan_bf16(n, q, n1, b2, out_size);
  if (pl.smem_bytes > bf16op::kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!pl.wgmma) {  // Z <= 128: at most 128 Z tiles along grid.y
    const cudaError_t err = bf16op::allow_smem(fb::mma::eps_fwd_bf16_mma_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool vec = a_dim % 8 == 0 && reinterpret_cast<uintptr_t>(cmt) % 16 == 0;
    const dim3 grid(static_cast<unsigned>((npix + fb::mma::kTileP - 1) / fb::mma::kTileP),
                    static_cast<unsigned>((out_size + pl.outputs - 1) / pl.outputs));
    fb::mma::eps_fwd_bf16_mma_kernel<<<grid, fb::mma::kThreads,
                                       static_cast<size_t>(pl.product_bytes), s>>>(
        static_cast<const float*>(views), static_cast<const uint16_t*>(cmt),
        static_cast<float*>(out), static_cast<uint16_t*>(t), n, q, n1, static_cast<int>(a_dim),
        static_cast<int>(b2), npix, pl.outputs, pl.passes, out_size, vec, bf16op::FastDiv(q));
    return static_cast<int>(cudaGetLastError());
  }
  if (ops == nullptr || chunk < fb::kTileP || chunk % fb::kTileP != 0 ||
      chunk / fb::kTileP > 65535 || c0 < 0 || c0 >= npix || c0 % chunk != 0 ||
      reinterpret_cast<uintptr_t>(cmt) % 16 != 0 || reinterpret_cast<uintptr_t>(ops) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long a_pad = (a_dim + fb::kStepA - 1) / fb::kStepA * fb::kStepA;
  const auto kernel = t != nullptr ? fb::eps_fwd_bf16_kernel<true> : fb::eps_fwd_bf16_kernel<false>;
  cudaError_t err = bf16op::allow_smem(kernel);
  if (err == cudaSuccess) err = bf16op::allow_smem(fb::eps_fwd_bf16_operands_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pc = static_cast<int>(npix - c0 < chunk ? npix - c0 : chunk);
  const int tiles = (pc + fb::kTileP - 1) / fb::kTileP;
  const long long a_blocks = a_pad / (4 * fb::kStepA);  // about four rounds a CTA
  const dim3 bgrid(static_cast<unsigned>(tiles * (fb::kTileP / fb::kBuildP)),
                   static_cast<unsigned>(a_blocks < 1 ? 1 : a_blocks > 65535 ? 65535 : a_blocks));
  fb::eps_fwd_bf16_operands_kernel<<<bgrid, fb::kThreads, static_cast<size_t>(pl.build_bytes), s>>>(
      static_cast<const float*>(views), static_cast<uint16_t*>(ops), q, n1,
      static_cast<int>(a_dim), static_cast<int>(a_pad), npix, c0, pc, bf16op::FastDiv(q));
  const dim3 grid(static_cast<unsigned>((out_size + pl.outputs - 1) / pl.outputs),
                  static_cast<unsigned>(tiles));
  const bool vec_t = npix % 8 == 0 && reinterpret_cast<uintptr_t>(t) % 16 == 0;
  kernel<<<grid, fb::kThreads, static_cast<size_t>(pl.product_bytes), s>>>(
      static_cast<const float*>(views), static_cast<const uint16_t*>(cmt),
      static_cast<const uint16_t*>(ops), static_cast<float*>(out), static_cast<uint16_t*>(t), n,
      q, n1, static_cast<int>(a_pad), static_cast<int>(b2), static_cast<int>(b2 * out_size),
      out_size, pl.outputs, pl.passes, npix, c0, pc, vec_t);
  return static_cast<int>(cudaGetLastError());
}

// The plan of one bf16 launch at this shape (fwd_bf16::make_plan_bf16; the
// wrapper's plan mirrors it and its tests hold the two equal): the shared
// memory, the larger of the product kernel's and the operands kernel's, and
// the route, 1 for wgmma and 0 for mma.sync.
extern "C" long long dctn_eps_fwd_bf16_smem_bytes(int n, int q, int n1, int out_size) {
  return fwd_bf16::make_plan_bf16(n, q, n1, bf16op::ipow(q, n - n1), out_size).smem_bytes;
}

extern "C" long long dctn_eps_fwd_bf16_route(int n, int q, int n1, int out_size) {
  return fwd_bf16::make_plan_bf16(n, q, n1, bf16op::ipow(q, n - n1), out_size).wgmma ? 1 : 0;
}
