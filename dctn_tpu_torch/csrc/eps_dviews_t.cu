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
//   d_u[a, p] = sum_z cmt[z, a] * kr2[z, p],   kr2[z, p] = g[o, p] * v[b, p]
//   t[z, p]   = sum_a cmt[z, a] * u[a, p]          (saved, or recomputed)
//   d_v[b, p] = sum_o t[o*B2 + b, p] * g[o, p]
// then the chain backward over each half: factor k's cotangent collects, for
// every a (resp. b), d_u (resp. d_v) times the product of the half's other
// factors at that index's digits. Output (n, q, npix).
//
// What bounds it on this card: the products at the fastest float32-accurate
// rate of an H100 SXM (700 W), 3xTF32 on the tensor cores at 495/3 = 165
// TFLOP/s (tf32x3.cuh). Saved t: the d_u product, 2*Z*A*npix flops, 213.0
// GFLOP (1.29 ms) for the flagship's second layer at batch 128; reading the
// saved t (416 MB there) takes about 0.12 ms at 3.35 TB/s. Recompute: d_u and
// t, 4*Z*A*npix flops, 426 GFLOP (2.58 ms) at that shape and twice that
// (5.16 ms) at the deep (4,4),(3,12),(2,24) model's middle layer (O = 12, Z =
// 3072); no t crosses HBM. Besides, every CTA streams cmt from L2 once per
// product: at the flagship's second layer (cmt 6.29 MB, 1,058 CTAs of 64
// pixels) 6.66 GB per call for the saved-t form and 13.3 GB for the
// recompute form. A wider pixel tile would divide those bytes, but v and d_v
// (B2 x pixels, 72 KB at B2 = 256 for 64 pixels) already take a third of
// the shared memory.
//
// Design: one CTA of 8 warps per 64-pixel tile, so nothing is summed across
// CTAs. The CTA stages its tile of every factor and of g in shared memory and
// builds v (B2 x 64) there once, and u's two Kronecker factors X[a / s] and
// Y[a % s] (s = q^lv, the lv = n1 / 2 trailing digits: some 2*sqrt(A)
// rows). Both products run on the tensor cores in 3xTF32 (mma.sync.m16n8k8,
// three mma per fragment pair, tf32x3.cuh), with the pixels as the M side
// (two 16-row fragments per warp) and a chunk of MA = 128 rows of A (64
// where the shared memory is short) as the N side. In each step of 32 K
// rows, cmt's tile streams in with cp.async (step c + 1 in flight while step
// c is multiplied; one barrier per step), and each thread forms its own
// fragment entries in registers and splits them into TF32 hi and lo: cmt's
// from the stage, the pixel side's as the product of two rows in shared
// memory (g[o] * v[b] for kr2, X * Y for u), one multiply per entry. Each
// step sums in fresh fragments, added into the totals with f32 adds.
// - d_u, for each chunk of MA rows of A: K = Z. The finished d_u chunk (MA x
//   64) goes to shared memory and is folded at once: u = X (x) Y per pixel,
//   so the chunk adds d_u * X into dY and d_u * Y into dX (two multiply-adds
//   per entry); after the last chunk dX and dY go into the u factors'
//   cotangents, each row times the product of its other factors. Where
//   dX and dY do not fit beside the rest, each entry of the chunk goes
//   straight into the n1 u factors' cotangents, times the product of the
//   other u factors (the leave-one-out fold).
// - t (recompute form), for each chunk of MA rows of Z: K = A. The chunk of
//   t times g[o] goes to shared memory, and the rows of each b are added
//   into d_v in a fixed order (rows of a chunk in order, chunks in order).
//   The saved-t form reads t instead.
// The chain folds stay on the CUDA cores: the v factors' cotangents come from
// the front-peel order of the TPU kernel's _chain_bwd (eps_pallas.py:206-224),
// in place in shared memory. No atomics: the result is the same from run to
// run. No leave-one-out product is formed by division: the default feature
// map is exactly 0 on black pixels, so factors hold many zeros. The products
// sum in other orders than the plain version's (and u's entries multiply in
// another order than the JAX suffix chain's), within the float32 rounding the
// tests and chip_smoke.py allow (1e-4 of max|ref|).
//
// Limits (checked by the Python wrapper, again here): the shared memory of
// `smem_bytes`, at most 227 KB; n2 = 0 takes no t (kr2 = g, and there is no
// v half).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tf32x3.cuh"

namespace {

constexpr int kTileP = 64;                 // pixels per CTA (the M side)
constexpr int kRS = kTileP + 8;            // rows of v, g, X, Y: 8*row + p banks
constexpr int kStepK = 32;                 // K rows per pipeline step
constexpr int kWarpsN = 4;                 // warps along the N side
constexpr int kThreads = 2 * kWarpsN * 32;  // 8 warps: 2 (32 pixels each) x 4 (N side)
constexpr long long kMaxSmemBytes = 227 * 1024;
constexpr long long kSmemPerSm = 228 * 1024 - 2 * 1024;  // less 1 KB reserved per CTA
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr long long ipow(long long base, int exp) {
  long long r = 1;
  for (int i = 0; i < exp; ++i) r *= base;
  return r;
}

// floats of one cmt stage: the d_u pass's 32 x MA tile (row stride MA + 8:
// 8*k + n banks) or the t pass's MA x 32 tile (row stride 36: 4*n + k
// banks); the d_u chunk and t * g (MA x 64) take both stages afterwards
__host__ __device__ constexpr long long stage_floats(int ma) {
  return 32LL * (ma + 8) > ma * 36LL ? 32LL * (ma + 8) : ma * 36LL;
}
static_assert(128 * kTileP <= 2 * stage_floats(128) && 64 * kTileP <= 2 * stage_floats(64),
              "the d_u chunk fits the two stages");

// Dynamic shared memory of one launch, in floats then ints, in order:
// staged factors and their cotangents (n*q x 64 each), v then d_v (B2
// rows), g (O rows and a zero row), two cmt stages; u's Kronecker factors X and
// Y (q^(n1-lv) + q^lv rows, lv = n1 / 2: the fewest rows, and a zero row)
// for the Kronecker fold and for the recompute form's u (n2 > 0); with the
// Kronecker fold the cotangents dX and dY (rows of 64), else the u digit
// table of the leave-one-out fold (n1 x MA ints). v, g, X and Y rows are kRS
// floats apart.
__host__ __device__ constexpr long long smem_bytes(int n, int q, int n1, long long b2,
                                                   int o, bool recompute, int ma, bool kron) {
  const int lv = n1 / 2;
  const long long xy_rows = ipow(q, n1 - lv) + ipow(q, lv);
  const long long uxy = kron || (recompute && n1 < n) ? (xy_rows + 1) * kRS : 0;
  return 4 * (kTileP * 2LL * n * q + kRS * (b2 + 1 + o) + 2 * stage_floats(ma) + uxy +
              (kron ? xy_rows * kTileP : 0)) +
         (kron ? 0 : 4LL * n1 * ma);
}

// The launch's MA and fold: MA = 128 with the Kronecker fold where that
// fits, then 64 with it, then the leave-one-out fold at 128 and at 64
// (ma = 0 when none fits).
struct Config {
  int ma;
  bool kron;
};

__host__ __device__ constexpr Config choose_config(int n, int q, int n1, long long b2, int o,
                                                   bool recompute) {
  const Config order[4] = {{128, true}, {64, true}, {128, false}, {64, false}};
  for (const Config& c : order)
    if (smem_bytes(n, q, n1, b2, o, recompute, c.ma, c.kron) <= kMaxSmemBytes) return c;
  return {0, false};
}

// Row offsets of the pixel-side operand: entry (p, k) of step c is
// lhs[lo[m] + p] * rhs[ro[m] + p] for the K index k = 4m + tig (m < 8) of a
// thread; row r = c*32 + tig + 4m of a Kronecker pair (r / s, r % s) of
// rows kRS apart, and zero_row where r >= rows.
__device__ __forceinline__ void kron_rows(int (&lo)[8], int (&ro)[8], int r, int s, int rows,
                                          int lhs_row0, int rhs_row0, int zero_row) {
  int i = r / s;
  int j = r - i * s;
#pragma unroll
  for (int m = 0; m < 8; ++m, r += 4, j += 4) {
    while (j >= s) {
      j -= s;
      ++i;
    }
    lo[m] = r < rows ? (lhs_row0 + i) * kRS : zero_row;
    ro[m] = (rhs_row0 + j) * kRS;
  }
}

// One product of the CTA: acc[p, n] += sum_k A[p, k] * B[k, n] over `steps`
// steps of 32 K rows. B is staged by `stage` with cp.async into a cmt stage,
// where B[k, n] sits at k*ldk + n*ldn; A[p, k] is the product of two rows of
// `lhs` and `rhs` (kron_rows, from `offsets(c, lo, ro)`). Each thread forms
// its fragment entries in registers and splits them into TF32 hi and lo
// (both operands' entries are shared by 2 or 4 warps, which each split them;
// nothing is written back). One barrier per step: step c + 1's copy is in
// flight while step c is multiplied. A warp whose N columns all lie at or
// past n_valid skips the product.
template <int kNT, long long kSF, class Stage, class Offsets>
__device__ __forceinline__ void product(float (&acc)[2][kNT][4], int steps, float* stages,
                                        const float* lhs, const float* rhs, int ldk, int ldn,
                                        int n_valid, Stage stage, Offsets offsets) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int tig = lane % 4;
  const int wp = (warp / kWarpsN) * 32;       // the warp's pixels
  const int wn = (warp % kWarpsN) * (8 * kNT);  // the warp's N columns
  stage(0, stages);
  tf32x3::cp_async_commit();
  for (int c = 0; c < steps; ++c) {
    tf32x3::cp_async_wait_all();  // this thread's copies of step c
    __syncthreads();  // step c is in; step c - 1's stage is free
    if (c + 1 < steps) stage(c + 1, stages + ((c + 1) % 2) * kSF);
    tf32x3::cp_async_commit();
    if (wn >= n_valid) continue;  // the warp's N columns all lie past the tensor
    const float* b = stages + (c % 2) * kSF;
    int lo[8], ro[8];
    offsets(c, lo, ro);
    float part[2][kNT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < kStepK / 8; ++s) {
      // K index 8s + tig (m = 2s) and 8s + tig + 4 (m = 2s + 1)
      const int k0 = 8 * s + tig;
      uint32_t bh[kNT][2], bl[kNT][2], ah[2][4], al[2][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int nn = (wn + 8 * j + gq) * ldn;
        tf32x3::split_frag(b[k0 * ldk + nn], bh[j][0], bl[j][0]);
        tf32x3::split_frag(b[(k0 + 4) * ldk + nn], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // a0/a1: pixel row gq / gq + 8 at k0; a2/a3 at k0 + 4
          const int p = wp + 16 * i + gq + 8 * h;
          tf32x3::split_frag(lhs[lo[2 * s] + p] * rhs[ro[2 * s] + p], ah[i][h], al[i][h]);
          tf32x3::split_frag(lhs[lo[2 * s + 1] + p] * rhs[ro[2 * s + 1] + p], ah[i][h + 2],
                             al[i][h + 2]);
        }
      tf32x3::mma3_tiles(part, ah, al, bh, bl);
    }
    // the step's sums into the totals, rounded to nearest
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  tf32x3::cp_async_wait_all();
}

// A (rows x cols) block of cmt from (row0, col0) into a stage of row stride
// `ld`, zero past Z or A; 16-byte copies when `vec` (A % 4 == 0, aligned).
__device__ __forceinline__ void stage_cmt(float* dst, const float* __restrict__ cmt, int rows,
                                          int cols, int ld, int row0, int col0, int z_dim,
                                          int a_dim, bool vec) {
  if (vec) {
    const int segs = cols / 4;
    for (int i = threadIdx.x; i < rows * segs; i += kThreads) {
      const int r = i / segs;
      const int c = (i % segs) * 4;
      const int z = row0 + r;
      const int a = col0 + c;
      const int left = z < z_dim ? a_dim - a : 0;
      const int bytes = left <= 0 ? 0 : left >= 4 ? 16 : 4 * left;
      tf32x3::cp_async16(dst + r * ld + c,
                         bytes > 0 ? cmt + static_cast<long long>(z) * a_dim + a : cmt, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols;
      const int c = i % cols;
      const int z = row0 + r;
      const int a = col0 + c;
      const bool ok = z < z_dim && a < a_dim;
      tf32x3::cp_async4(dst + r * ld + c, ok ? cmt + static_cast<long long>(z) * a_dim + a : cmt,
                        ok ? 4 : 0);
    }
  }
}

template <bool kRecompute, int kMA, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
eps_dviews_kernel(const float* __restrict__ views, const float* __restrict__ cmt,
                  const float* __restrict__ g, const float* __restrict__ t,
                  float* __restrict__ dviews, int n, int q, int n1, int a_dim,
                  int b2, int out_size, long long npix, bool vec, bool kron) {
  constexpr int kNT = kMA / (8 * kWarpsN);  // n8 fragments per warp on the N side
  constexpr long long kSF = stage_floats(kMA);
  extern __shared__ float4 smem4[];
  const int n2 = n - n1;
  const int nq = n * q;
  const int z_dim = out_size * b2;
  const int lv = n1 / 2;  // u's trailing digits in Y
  const int s_u = static_cast<int>(ipow(q, lv));
  const int x_rows = static_cast<int>(ipow(q, n1 - lv));
  float* vs = reinterpret_cast<float*>(smem4);     // (n*q, kTileP)
  float* dvs = vs + nq * kTileP;                    // (n*q, kTileP)
  float* vbuf = dvs + nq * kTileP;                  // (B2, kRS): v, then d_v
  float* gs = vbuf + b2 * kRS;                      // (O + 1, kRS): g, a zero row
  float* stages = gs + (out_size + 1) * kRS;        // 2 cmt stages
  float* uxy = stages + 2 * kSF;                    // (x_rows + s_u + 1, kRS): X, Y, a zero row
  const bool has_uxy = kron || (kRecompute && n2 > 0);
  float* duxy = uxy + (has_uxy ? (x_rows + s_u + 1) * kRS : 0);  // dX, dY: (., kTileP)
  int* uoff = reinterpret_cast<int*>(duxy);         // (n1, kMA) (leave-one-out fold)
  float* x_u = uxy;
  float* y_u = uxy + x_rows * kRS;

  const int tid = threadIdx.x;
  const long long p0 = static_cast<long long>(blockIdx.x) * kTileP;

  for (int i = tid; i < nq * kTileP; i += kThreads) {
    const long long gp = p0 + i % kTileP;
    vs[i] = gp < npix ? views[static_cast<long long>(i / kTileP) * npix + gp] : 0.f;
    dvs[i] = 0.f;
  }
  for (int i = tid; i < (out_size + 1) * kTileP; i += kThreads) {
    const int o = i / kTileP;
    const long long gp = p0 + i % kTileP;
    gs[o * kRS + i % kTileP] =
        o < out_size && gp < npix ? g[static_cast<long long>(o) * npix + gp] : 0.f;
  }
  __syncthreads();
  // v[b, p], the JAX suffix chain's order (f_{n-1} first)
  for (int i = tid; i < b2 * kTileP; i += kThreads) {
    const int p = i % kTileP;
    float val = 1.f;
    int rem = i / kTileP;
    for (int k = n - 1; k >= n1; --k) {
      val *= vs[(k * q + rem % q) * kTileP + p];
      rem /= q;
    }
    vbuf[(i / kTileP) * kRS + p] = val;
  }
  // X[i, p]: factors 0 .. n1 - lv - 1 at the digits of i; Y[j, p]: the last
  // lv factors at the digits of j; u[a] = X[a / s_u] * Y[a % s_u]; then a
  // zero row
  if (has_uxy) {
    for (int i = tid; i < (x_rows + s_u + 1) * kTileP; i += kThreads) {
      const int r = i / kTileP;
      const int p = i % kTileP;
      const bool is_x = r < x_rows;
      int rem = is_x ? r : r - x_rows;
      const int first = is_x ? 0 : n1 - lv;
      float val = r < x_rows + s_u ? 1.f : 0.f;
      for (int k = (is_x ? n1 - lv : n1) - 1; k >= first && r < x_rows + s_u; --k) {
        val *= vs[(k * q + rem % q) * kTileP + p];
        rem /= q;
      }
      uxy[r * kRS + p] = val;
      if (kron && r < x_rows + s_u) duxy[r * kTileP + p] = 0.f;
    }
  }

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gq = lane / 4;
  const int tig = lane % 4;
  const int wp = (warp / kWarpsN) * 32;
  const int wn = (warp % kWarpsN) * (8 * kNT);
  float acc[2][kNT][4];

  // d_u, MA rows of A at a time, each folded at once into the u factors'
  // cotangents
  for (int a0 = 0; a0 < a_dim; a0 += kMA) {
    __syncthreads();  // v, X, Y are built; the previous chunk's fold is done
    for (int i = tid; i < (kron ? 0 : n1 * kMA); i += kThreads) {
      const int k = i / kMA;
      const int a = a0 + i % kMA;
      int rem = a;
      for (int j = n1 - 1; j > k; --j) rem /= q;
      uoff[i] = a < a_dim ? k * q + rem % q : -1;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    // B[k, n] = cmt[c*32 + k, a0 + n]; A[p, k] = kr2[z, p] = g[o, p] * v[b, p]
    // for z = c*32 + k = o*B2 + b (g's row O is zero, for z past Z)
    product<kNT, kSF>(
        acc, (z_dim + kStepK - 1) / kStepK, stages, gs, vbuf, kMA + 8, 1, a_dim - a0,
        [&](int c, float* dst) {
          stage_cmt(dst, cmt, kStepK, kMA, kMA + 8, c * kStepK, a0, z_dim, a_dim, vec);
        },
        [&](int c, int (&lo)[8], int (&ro)[8]) {
          kron_rows(lo, ro, c * kStepK + tig, b2, z_dim, 0, 0, out_size * kRS);
        });
    __syncthreads();  // every warp is done with the stages, which dus covers
    float* dus = stages;  // (kMA, kTileP)
    // fragment element e: pixel row gq (+8 for e >= 2), column 2 tig (+1 odd e)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dus[(wn + 8 * j + 2 * tig + (e & 1)) * kTileP + wp + 16 * i + gq + (e >= 2 ? 8 : 0)] =
              acc[i][j][e];
    __syncthreads();
    if (kron) {
      // u = X (x) Y per pixel, so d_u's chunk adds to dY[j] the sum over its
      // rows a = i*s_u + j of d_u[a] * X[i], and to dX[i] the sum over
      // j of d_u[a] * Y[j]; item (row of dX or dY, p) is the only writer
      const int rows = min(kMA, a_dim - a0);
      const int i_lo = a0 / s_u;
      const int nx = (a0 + rows - 1) / s_u - i_lo + 1;
      float* dx_u = duxy;
      float* dy_u = duxy + x_rows * kTileP;
      for (int item = tid; item < (s_u + nx) * kTileP; item += kThreads) {
        const int r = item / kTileP;
        const int p = item % kTileP;
        float sum = 0.f;
        if (r < s_u) {
          int a = a0 + (r - a0 % s_u + s_u) % s_u;
          for (; a < a0 + rows; a += s_u) sum += dus[(a - a0) * kTileP + p] * x_u[(a / s_u) * kRS + p];
          dy_u[r * kTileP + p] += sum;
        } else {
          const int i = i_lo + r - s_u;
          const int a_end = min(a0 + rows, (i + 1) * s_u);
          for (int a = max(a0, i * s_u); a < a_end; ++a)
            sum += dus[(a - a0) * kTileP + p] * y_u[(a - i * s_u) * kRS + p];
          dx_u[i * kTileP + p] += sum;
        }
      }
    } else {
      // fold the d_u chunk into the u factors' cotangents; item (k, p) is the
      // only writer of factor k's rows at pixel p
      for (int item = tid; item < n1 * kTileP; item += kThreads) {
        const int k = item / kTileP;
        const int p = item % kTileP;
        for (int al = 0; al < kMA && uoff[al] >= 0; ++al) {
          float prod = dus[al * kTileP + p];
          for (int j = 0; j < n1; ++j)
            if (j != k) prod *= vs[uoff[j * kMA + al] * kTileP + p];
          dvs[uoff[k * kMA + al] * kTileP + p] += prod;
        }
      }
    }
  }
  if (kron) {
    __syncthreads();
    // dX, dY into the u factors' cotangents: factor k < n1 - lv collects,
    // for each row i of X, dX[i] times the other X factors at i's digits
    // (and k >= n1 - lv the same over Y); item (k, p) is the only writer of
    // factor k's rows at pixel p
    for (int item = tid; item < n1 * kTileP; item += kThreads) {
      const int k = item / kTileP;
      const int p = item % kTileP;
      const bool in_x = k < n1 - lv;
      const int first = in_x ? 0 : n1 - lv;
      const int count = in_x ? n1 - lv : lv;
      const int rows = in_x ? x_rows : s_u;
      const float* d = duxy + (in_x ? 0 : x_rows * kTileP);
      for (int r = 0; r < rows; ++r) {
        float prod = d[r * kTileP + p];
        int own = 0;
        int rem = r;
        for (int j = first + count - 1; j >= first; --j) {
          const int digit = rem % q;
          rem /= q;
          if (j == k)
            own = digit;
          else
            prod *= vs[(j * q + digit) * kTileP + p];
        }
        dvs[(k * q + own) * kTileP + p] += prod;
      }
    }
  }

  if (n2 > 0) {
    __syncthreads();
    // d_v[b, p] = sum_o t[o*B2 + b, p] * g[o, p], into vbuf
    if constexpr (kRecompute) {
      for (int i = tid; i < b2 * kTileP; i += kThreads) vbuf[(i / kTileP) * kRS + i % kTileP] = 0.f;
      for (int z0 = 0; z0 < z_dim; z0 += kMA) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
        // B[k, n] = cmt[z0 + n, c*32 + k]; A[p, k] = u[c*32 + k, p]
        product<kNT, kSF>(
            acc, (a_dim + kStepK - 1) / kStepK, stages, x_u, y_u, 1, 36, z_dim - z0,
            [&](int c, float* dst) {
              stage_cmt(dst, cmt, kMA, kStepK, 36, z0, c * kStepK, z_dim, a_dim, vec);
            },
            [&](int c, int (&lo)[8], int (&ro)[8]) {
              kron_rows(lo, ro, c * kStepK + tig, s_u, a_dim, 0, 0, (x_rows + s_u) * kRS);
            });
        __syncthreads();  // the stages are free; tg covers them
        float* tg = stages;  // (kMA, kTileP): t * g
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int zl = wn + 8 * j + 2 * tig + (e & 1);
              const int p = wp + 16 * i + gq + (e >= 2 ? 8 : 0);
              const int z = min(z0 + zl, z_dim - 1);
              tg[zl * kTileP + p] = acc[i][j][e] * gs[(z / b2) * kRS + p];
            }
        __syncthreads();
        // rows b', b' + B2, ... of the chunk all belong to b = (z0 + b') % B2:
        // item (b', p) is the only writer of that row of d_v at pixel p
        const int rows = min(kMA, z_dim - z0);
        const int classes = min(b2, rows);
        for (int item = tid; item < classes * kTileP; item += kThreads) {
          const int bl = item / kTileP;
          const int p = item % kTileP;
          float s = 0.f;
          for (int r = bl; r < rows; r += b2) s += tg[r * kTileP + p];
          vbuf[((z0 + bl) % b2) * kRS + p] += s;
        }
        __syncthreads();  // tg is read before the next chunk stages over it
      }
    } else {
      for (int i = tid; i < b2 * kTileP; i += kThreads) {
        const int b = i / kTileP;
        const int p = i % kTileP;
        const long long gp = p0 + p;
        float s = 0.f;
        if (gp < npix)
          for (int o = 0; o < out_size; ++o)
            s += t[(static_cast<long long>(o) * b2 + b) * npix + gp] * gs[o * kRS + p];
        vbuf[b * kRS + p] = s;
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
          s += vbuf[(d * rest + r) * kRS + p] * suf;
        }
        dvs[(k * q + d) * kTileP + p] = s;
      }
      __syncthreads();
      // d[r] = sum_d d[d*rest + r] * f_k[d], in place: row r < rest is read
      // only by the item that writes it
      for (int item = tid; item < rest * kTileP; item += kThreads) {
        const int r = item / kTileP;
        const int p = item % kTileP;
        float s = vbuf[r * kRS + p] * vs[k * q * kTileP + p];
        for (int d = 1; d < q; ++d)
          s += vbuf[(d * rest + r) * kRS + p] * vs[(k * q + d) * kTileP + p];
        vbuf[r * kRS + p] = s;
      }
      rows = rest;
    }
    __syncthreads();
    for (int item = tid; item < q * kTileP; item += kThreads)
      dvs[(n - 1) * q * kTileP + item] = vbuf[(item / kTileP) * kRS + item % kTileP];
  }

  __syncthreads();
  for (int i = tid; i < nq * kTileP; i += kThreads) {
    const long long gp = p0 + i % kTileP;
    if (gp < npix) dviews[static_cast<long long>(i / kTileP) * npix + gp] = dvs[i];
  }
}

template <bool kRecompute, int kMA, int kMinBlocks>
cudaError_t ensure_smem_cap() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(eps_dviews_kernel<kRecompute, kMA, kMinBlocks>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmemBytes));
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

// Two CTAs per SM (at most 128 registers a thread) where two fit in the
// SM's shared memory; else one, with all the registers it can use. Of the
// two-CTA kernels, ptxas (CUDA 12.8) spills only in the recompute form at
// MA = 128: a 104 B stack frame, 168 B of spill stores, 180 B of loads.
template <bool kRecompute, int kMA, int kMinBlocks>
int launch_ma(const float* views, const float* cmt, const float* g, const float* t,
              float* dviews, int n, int q, int n1, int a_dim, int b2, int out_size,
              long long npix, bool vec, bool kron, cudaStream_t stream) {
  const cudaError_t err = ensure_smem_cap<kRecompute, kMA, kMinBlocks>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bytes = smem_bytes(n, q, n1, b2, out_size, kRecompute, kMA, kron);
  const unsigned grid = static_cast<unsigned>((npix + kTileP - 1) / kTileP);
  eps_dviews_kernel<kRecompute, kMA, kMinBlocks><<<grid, kThreads, static_cast<size_t>(bytes), stream>>>(
      views, cmt, g, t, dviews, n, q, n1, a_dim, b2, out_size, npix, vec, kron);
  return static_cast<int>(cudaGetLastError());
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
  if (a_dim > (1LL << 30) || b2 * out_size > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = choose_config(n, q, n1, b2, out_size, kRecompute);
  const bool vec = a_dim % 4 == 0 && reinterpret_cast<uintptr_t>(cmt) % 16 == 0;
  const auto* v = static_cast<const float*>(views);
  const auto* c = static_cast<const float*>(cmt);
  const auto* gg = static_cast<const float*>(g);
  const auto* tt = static_cast<const float*>(t);
  auto* out = static_cast<float*>(dviews);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool pair = 2 * smem_bytes(n, q, n1, b2, out_size, kRecompute, cfg.ma, cfg.kron) <= kSmemPerSm;
  const int ad = static_cast<int>(a_dim);
  const int bb = static_cast<int>(b2);
  if (cfg.ma == 128)
    return pair ? launch_ma<kRecompute, 128, 2>(v, c, gg, tt, out, n, q, n1, ad, bb, out_size,
                                                npix, vec, cfg.kron, s)
                : launch_ma<kRecompute, 128, 1>(v, c, gg, tt, out, n, q, n1, ad, bb, out_size,
                                                npix, vec, cfg.kron, s);
  if (cfg.ma == 64)
    return pair ? launch_ma<kRecompute, 64, 2>(v, c, gg, tt, out, n, q, n1, ad, bb, out_size,
                                               npix, vec, cfg.kron, s)
                : launch_ma<kRecompute, 64, 1>(v, c, gg, tt, out, n, q, n1, ad, bb, out_size,
                                               npix, vec, cfg.kron, s);
  return static_cast<int>(cudaErrorInvalidValue);
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

// ---------------------------------------------------------------------------
// The bf16 operand mode (dctn_eps_dviews_t_bf16, dctn_eps_dviews_recompute_bf16):
// the d_views half of K2 and K4, and K6, with mm_dtype bf16
// (eps_pallas.py:254-345, :391):
//   d_u[a, p] = sum_z cmt[z, a] * bf16(kr2[z, p])       (cmt in bf16)
//   d_v[b, p] = sum_o t[(o, b), p] * g[o, p]
// with t the saved bf16 t read as float32 (K2), or recomputed, t = cmt .
// bf16(u) in float32 and not rounded (K4, K6); kr2 = g * v and u formed in
// float32 as the plain version forms them (the JAX suffix chain), then
// rounded; one bf16 product a pair, float32 sums (bf16.cuh). Each factor's
// cotangent is then the leave-one-out sum
//   d f_k[i, p] = sum_{a: d_k(a) = i} d_u[a, p] * prod_{j != k} f_j[d_j(a), p]
// (and the same over b for the factors of v), the front-peel sweep of the
// plain version in another order of float32 operations.
//
// What bounds it: the products, 2*Z*A flops per pixel (d_u; twice that on
// the recompute arm) at the dense bf16 rate (989 TFLOP/s, H100 SXM at
// 700 W): 0.215 ms (K2) at the flagship's second layer at batch 128.
//
// Design: GEMMs on wgmma.m64n64k16 (bf16) with N = the CTA's 64 pixels,
// both operands K-major in the 128-byte swizzle. A CTA of two warpgroups
// stages its pixels' factor columns and g, and forms v (every b) once, in
// shared memory. Then d_u, a tile of 128 rows of A at a time (M = A, K = Z):
// cmtT's 128 x 64 step tiles (from a zero-padded transposed copy the wrapper
// makes, so every tile is whole and 16-byte aligned) come by cp.async, eight
// threads a row (128 contiguous bytes), into a ring of 3 stages, two steps
// ahead; the step's kr2 (64 pixels x 64 rows of Z, 8 consecutive z of a
// pixel a thread: g[o] * v[b], one 16-byte store) is built into one of two
// buffers while the tensor cores multiply the last step; each warpgroup owns
// 64 rows of A, four wgmma a step, the sums in registers across the whole Z
// loop (a step's product added into f32 totals: the tensor cores truncate as
// they add). One barrier a step. A finished tile goes to shared memory (over
// the ring) and every thread, a pixel and a quarter of the tile's rows, adds
// its leave-one-out terms into that quarter's cotangent rows, each factor's
// sum kept in a register while its digit stays (the digits stepped on, not
// divided). The recompute arm runs t the same way, tiles of 128 rows of Z of
// a padded copy of cmt over steps of 64 of A, u built as kr2 is: each entry a
// table row of its last lt factors' chain (q^lt <= 160 rows, formed once per
// CTA) times its leading factors, the chain's order; the saved arm's t comes
// through the same ring in tiles of 128 rows. Either way each (b, pixel)'s
// d_v = sum_o t * g is added by one thread, in the order of o, where v was.
// The four quarters' cotangents are added in a fixed order at the end: no
// atomics, the same bits from run to run.
// Where the time goes (phase probes at the flagship's layer 1, batch 128:
// scratch copies with one part removed, timed in turns): not the products
// (removing them saves ~5%); the kr2 build ~30%, the leave-one-out ~20%, d_v
// ~12%, the staging ~10% of the saved arm; the u build half of the recompute
// arm. One CTA an SM (its shared memory) leaves 8 warps to hide the builds'
// latencies.
// Limits: n1 and n - n1 at most 8 (the leave-one-out products in
// registers), B2 <= 512, n*q <= 256, shared memory 65536 + 260 (n q + O +
// B2 [+ q^lt]) + 1024 n q bytes (176 KB at the flagship's second layer).

#include "bf16.cuh"

namespace {
namespace dviews_bf16 {

constexpr int kThreads = 256;      // two warpgroups
constexpr int kTileP = 64;         // pixels per CTA (N)
constexpr int kTileM = 128;        // rows of A (d_u) or of Z (t) per product tile, 64 a warpgroup
constexpr int kStepK = 64;         // K (rows of Z, or of A) a step: four k16 products
constexpr int kStages = 3;         // the cmt ring (and the saved t's tiles)
constexpr int kRow = kTileP + 1;   // floats a row of the factors, g, v / d_v, the table and the
                                   // tile: an odd stride, so rows 8 apart fall on other banks
constexpr int kMaxChain = 8;       // factors of a half in the leave-one-out products
constexpr int kMaxTable = 160;     // rows of the recompute arm's table of u's trailing factors
// both operands K-major in the 128-byte swizzle (bf16op::smem_desc_sw128):
// a step's row of 64 values is 128 bytes
constexpr int kRingBytes = kTileM * kStepK * 2;
constexpr int kOpBytes = kTileP * kStepK * 2;

// the trailing factors of u that the recompute arm tabulates: the most
// with q^lt <= kMaxTable
int table_factors(int q, int n1) {
  int lt = 0;
  long long rows = 1;
  while (lt < n1 && rows * q <= kMaxTable) {
    rows *= q;
    ++lt;
  }
  return lt;
}

long long smem_bytes(int n, int q, int n1, long long b2, int out_size, bool recompute) {
  const long long table = recompute ? bf16op::ipow(q, table_factors(q, n1)) : 0;
  return static_cast<long long>(kStages) * kRingBytes + 2LL * kOpBytes +
         4LL * kRow * (n * q + out_size + b2 + table) + 4LL * 4 * n * q * kTileP;
}

// the digits (factor 0 slowest) of idx over `count` factors of q values
__device__ __forceinline__ void digits_of(int (&dig)[kMaxChain], int idx, int count, int q) {
#pragma unroll
  for (int i = kMaxChain - 1; i >= 0; --i)
    if (i < count) {
      dig[i] = idx % q;
      idx /= q;
    }
}

// the leave-one-out sums of `rows` consecutive indices from idx0 over the
// `count` factors from `first` (digit 0 the slowest), at pixel pj: index
// idx0 + r (cotangent d_of(r)) adds d * prod_{j != i} f_{first + j}[its digit
// j] into dq's row of factor first + i and its digit i. Each factor's sum
// stays in a register while its digit does, and goes into dq when the digit
// changes (the digits step on with the index, from the last, as a counter)
template <typename D>
__device__ __forceinline__ void leave_one_out_run(float* dq, const float* fac, int first,
                                                  int count, int q, int idx0, int rows,
                                                  const D& d_of, int pj) {
  int dig[kMaxChain];
  digits_of(dig, idx0, count, q);
  float fv[kMaxChain], acc[kMaxChain];
#pragma unroll
  for (int i = 0; i < kMaxChain; ++i)
    if (i < count) {
      fv[i] = fac[((first + i) * q + dig[i]) * kRow + pj];
      acc[i] = 0.f;
    }
  for (int r = 0; r < rows; ++r) {
    const float d = d_of(r);
    float suf[kMaxChain];
    float s = 1.f;
#pragma unroll
    for (int i = kMaxChain - 1; i >= 0; --i)
      if (i < count) {
        suf[i] = s;
        s *= fv[i];
      }
    float pre = 1.f;
#pragma unroll
    for (int i = 0; i < kMaxChain; ++i)
      if (i < count) {
        acc[i] += d * (pre * suf[i]);
        pre *= fv[i];
      }
    bool carry = true;  // the digits that change with the next index: their sums go out
#pragma unroll
    for (int i = kMaxChain - 1; i >= 0; --i)
      if (i < count && carry) {
        float* row = dq + ((first + i) * q + dig[i]) * kTileP + pj;
        *row += acc[i];
        acc[i] = 0.f;
        carry = ++dig[i] == q;
        if (carry) dig[i] = 0;
        fv[i] = fac[((first + i) * q + dig[i]) * kRow + pj];
      }
  }
#pragma unroll
  for (int i = 0; i < kMaxChain; ++i)
    if (i < count) dq[((first + i) * q + dig[i]) * kTileP + pj] += acc[i];
}

// this warpgroup's 64 rows x 64 pixels of the M tile, summed over every K
// step: the A rows m0.. of `src` (bf16, `ld` values a row, whole steps)
// through the ring, the built operand from `build(s, dst)`; leaves the
// ring and both built buffers free (every product done)
template <typename Build>
__device__ __forceinline__ void gemm_tile(float (&tot)[32], const uint16_t* __restrict__ src,
                                          long long ld, int m0, int steps, unsigned char* ring,
                                          unsigned char* bop, const Build& build) {
  const int tid = threadIdx.x, wg = tid / 128;
  const auto stage = [&](int s) {
    unsigned char* d = ring + (s % kStages) * kRingBytes;
    const uint16_t* base = src + static_cast<long long>(m0) * ld + static_cast<long long>(s) * kStepK;
#pragma unroll
    for (int i = tid; i < kTileM * (kStepK / 8); i += kThreads) {
      const int r = i / 8, c = i % 8;  // eight threads a row: 128 contiguous bytes
      bf16op::cp_async16(d + bf16op::sw128_offset(r, c), base + r * ld + 8 * c);
    }
  };
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) tot[i] = acc[i] = 0.f;
  stage(0);
  tf32x3::cp_async_commit();
  if (steps > 1) stage(1);
  tf32x3::cp_async_commit();
  build(0, bop);
  for (int s = 0; s < steps; ++s) {
    tf32x3::cp_async_wait_group<1>();  // this thread's copies of step s
    tf32x3::fence_async_smem();
    __syncthreads();  // step s's stage and operand are in; step s - 1's products are done
    const unsigned char* a_st = ring + (s % kStages) * kRingBytes;
    const unsigned char* b_op = bop + (s & 1) * kOpBytes;
    tf32x3::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kStepK / 16; ++ks) {
      const uint64_t ad = bf16op::smem_desc_sw128(a_st + 64 * 128 * wg + 32 * ks);
      const uint64_t bd = bf16op::smem_desc_sw128(b_op + 32 * ks);
      bf16op::wgmma_m64n64k16(acc, ad, bd, ks > 0);
    }
    tf32x3::wgmma_commit();
    if (s + 2 < steps) stage(s + 2);  // over step s - 1's stage
    tf32x3::cp_async_commit();
    if (s + 1 < steps) build(s + 1, bop + ((s + 1) & 1) * kOpBytes);
    tf32x3::wgmma_wait<0>();
    bf16op::wgmma_pin(acc);
#pragma unroll
    for (int i = 0; i < 32; ++i) tot[i] += acc[i];
  }
  tf32x3::cp_async_wait_group<0>();
  __syncthreads();  // every product is done: the ring and the buffers may be reused
}

// this warpgroup's totals (rows 64 wg + .., 64 pixels) into the shared tile
__device__ __forceinline__ void totals_to_tile(float* ts, const float (&tot)[32]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int r = 16 * warp + g;  // 64 (warp / 4) + 16 (warp % 4) + g
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tig;
    ts[r * kRow + c] = tot[4 * j];
    ts[r * kRow + c + 1] = tot[4 * j + 1];
    ts[(r + 8) * kRow + c] = tot[4 * j + 2];
    ts[(r + 8) * kRow + c + 1] = tot[4 * j + 3];
  }
}

template <bool kRecompute>
__global__ void __launch_bounds__(kThreads, 1)
    eps_dviews_bf16_kernel(const float* __restrict__ views, const uint16_t* __restrict__ cmt_p,
                           const uint16_t* __restrict__ cmt_tp, const float* __restrict__ gcot,
                           const uint16_t* __restrict__ t, float* __restrict__ dviews, int n,
                           int q, int n1, int a_dim, int b2, int z_dim, int out_size,
                           long long npix, int lt) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int nq = n * q, n2 = n - n1;
  unsigned char* ring = smem;                       // kStages stages; a finished tile
  unsigned char* bop = ring + kStages * kRingBytes;  // 2 built operands
  float* fac = reinterpret_cast<float*>(bop + 2 * kOpBytes);  // nq rows
  float* gs = fac + nq * kRow;                      // out_size rows
  float* vd = gs + out_size * kRow;                 // b2 rows: v, then d_v
  float* dfac = vd + b2 * kRow;                     // 4 quarters x nq rows x kTileP
  float* tab = dfac + 4 * nq * kTileP;              // the recompute arm's q^lt rows
  float* ts = reinterpret_cast<float*>(ring);       // kTileM rows

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long p0 = static_cast<long long>(blockIdx.x) * kTileP;
  for (int i = tid; i < nq * kTileP; i += kThreads) {
    const int r = i / kTileP, j = i % kTileP;
    fac[r * kRow + j] = p0 + j < npix ? views[r * npix + p0 + j] : 0.f;
  }
  for (int i = tid; i < out_size * kTileP; i += kThreads) {
    const int r = i / kTileP, j = i % kTileP;
    gs[r * kRow + j] = p0 + j < npix ? gcot[r * npix + p0 + j] : 0.f;
  }
  for (int i = tid; i < 4 * nq * kTileP; i += kThreads) dfac[i] = 0.f;
  __syncthreads();
  // v[b] = f_{n1}[..] * (... * f_{n-1}[..]) (one row of ones when n2 = 0)
  for (int i = tid; i < b2 * kTileP; i += kThreads) {
    const int b = i / kTileP, j = i % kTileP;
    int rem = b;
    float x = 1.f;
    for (int k = n - 1; k >= n1; --k) {
      x = fac[(k * q + rem % q) * kRow + j] * x;
      rem /= q;
    }
    vd[b * kRow + j] = x;
  }
  // the recompute arm's table of u's last lt factors, in the chain's order
  const int m_lead = n1 - lt;
  int s_tab = 1;
  for (int k = 0; k < lt; ++k) s_tab *= q;
  if (kRecompute)
    for (int i = tid; i < s_tab * kTileP; i += kThreads) {
      const int r = i / kTileP, j = i % kTileP;
      int rem = r;
      float x = 1.f;
      for (int k = n1 - 1; k >= m_lead; --k) {
        x = fac[(k * q + rem % q) * kRow + j] * x;
        rem /= q;
      }
      tab[r * kRow + j] = x;
    }
  __syncthreads();
  // the accumulating roles: a pixel and a quarter, every thread
  const int pj = tid % kTileP, qt = tid / kTileP;
  float* dq = dfac + qt * nq * kTileP;
  // the built operands: pixel p = 8 warp + lane % 8, K chunks lane / 8 and
  // lane / 8 + 4 of a step (8 values each, one 16-byte store)
  const int bp = 8 * warp + lane % 8;
  const auto store8 = [&](unsigned char* dst, int c, const float (&x)[8]) {
    uint4 w;
    w.x = bf16op::pack(x[0], x[1]);
    w.y = bf16op::pack(x[2], x[3]);
    w.z = bf16op::pack(x[4], x[5]);
    w.w = bf16op::pack(x[6], x[7]);
    *reinterpret_cast<uint4*>(dst + bf16op::sw128_offset(bp, c)) = w;
  };
  // kr2 of step s: z = 64 s + 8 c + j, g[o] * v[b], zero past Z
  const auto build_kr2 = [&](int s, unsigned char* dst) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane / 8 + 4 * h;
      const int z0 = s * kStepK + 8 * c;
      int o = z0 / b2, b = z0 - o * b2;
      float gv = z0 < z_dim ? gs[o * kRow + bp] : 0.f;
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[j] = z0 + j < z_dim ? gv * vd[b * kRow + bp] : 0.f;
        if (++b == b2) {
          b = 0;
          ++o;
          if (z0 + j + 1 < z_dim) gv = gs[o * kRow + bp];
        }
      }
      store8(dst, c, x);
    }
  };
  // u of step s: a = 64 s + 8 c + j, f_0[..] * (... * (f_{m-1}[..] *
  // tab[a % q^lt])), the chain's order; zero past A. A unit's 8 values of a
  // take at most two leading indices where q^lt >= 8 (their factors loaded
  // once), else one each.
  const auto leading = [&](float (&lf)[kMaxChain], int lead) {
    int dig[kMaxChain];
    digits_of(dig, lead, m_lead, q);
#pragma unroll
    for (int i = 0; i < kMaxChain; ++i)
      if (i < m_lead) lf[i] = fac[(i * q + dig[i]) * kRow + bp];
  };
  const auto build_u = [&](int s, unsigned char* dst) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane / 8 + 4 * h;
      const int a_first = s * kStepK + 8 * c;
      const int lead = a_first / s_tab, r0 = a_first - lead * s_tab;
      float x[8];
      if (s_tab >= 8) {
        float lf0[kMaxChain], lf1[kMaxChain];
        leading(lf0, lead);
        if (r0 + 7 >= s_tab) leading(lf1, lead + 1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool next = r0 + j >= s_tab;
          float y = tab[(next ? r0 + j - s_tab : r0 + j) * kRow + bp];
#pragma unroll
          for (int i = kMaxChain - 1; i >= 0; --i)
            if (i < m_lead) y = (next ? lf1[i] : lf0[i]) * y;
          x[j] = a_first + j < a_dim ? y : 0.f;
        }
      } else {
        for (int j = 0; j < 8; ++j) {
          float lf[kMaxChain];
          const int lj = (a_first + j) / s_tab;
          leading(lf, lj);
          float y = tab[(a_first + j - lj * s_tab) * kRow + bp];
#pragma unroll
          for (int i = kMaxChain - 1; i >= 0; --i)
            if (i < m_lead) y = lf[i] * y;
          x[j] = a_first + j < a_dim ? y : 0.f;
        }
      }
      store8(dst, c, x);
    }
  };

  // d_u, tile by tile over A, and the cotangents of u's factors: a thread's
  // 32 consecutive rows of each tile, their digits stepped on, not divided
  const int z_steps = (z_dim + kStepK - 1) / kStepK;
  const long long z_ld = static_cast<long long>(z_steps) * kStepK;
  constexpr int kQuarter = kTileM / 4;
  for (int a0 = 0; a0 < a_dim; a0 += kTileM) {
    float tot[32];
    gemm_tile(tot, cmt_tp, z_ld, a0, z_steps, ring, bop, build_kr2);
    totals_to_tile(ts, tot);
    __syncthreads();
    const int r0 = qt * kQuarter;
    leave_one_out_run(dq, fac, 0, n1, q, a0 + r0, max(0, min(kQuarter, a_dim - a0 - r0)),
                      [&](int r) { return ts[(r0 + r) * kRow + pj]; }, pj);
    __syncthreads();  // the tile is read: the ring may be refilled
  }

  if (n2 > 0) {
    // d_v takes v's place: d_v[b] = sum_o t[(o, b)] * g[o], each (b, pixel)
    // by one thread, the owner of b's quarter, over the rows of t in order
    for (int i = tid; i < b2 * kRow; i += kThreads) vd[i] = 0.f;
    const int blk = (b2 + 3) / 4, b_lo = qt * blk, b_hi = min(b_lo + blk, b2);
    const auto accumulate = [&](int z0, const auto& row_value) {
      int o = z0 / b2, b = z0 - o * b2;
      for (int r = 0; r < kTileM && z0 + r < z_dim; ++r) {
        if (b >= b_lo && b < b_hi) vd[b * kRow + pj] += row_value(r) * gs[o * kRow + pj];
        if (++b == b2) {
          b = 0;
          ++o;
        }
      }
    };
    const int z_tiles = (z_dim + kTileM - 1) / kTileM;
    if (kRecompute) {
      // t = cmt . bf16(u), float32 and unrounded, tile by tile over Z
      const int a_steps = (a_dim + kStepK - 1) / kStepK;
      const long long a_ld = static_cast<long long>(a_steps) * kStepK;
      for (int zi = 0; zi < z_tiles; ++zi) {
        float tot[32];
        gemm_tile(tot, cmt_p, a_ld, zi * kTileM, a_steps, ring, bop, build_u);
        totals_to_tile(ts, tot);
        __syncthreads();
        accumulate(zi * kTileM, [&](int r) { return ts[r * kRow + pj]; });
        __syncthreads();
      }
    } else {
      // the saved t (bf16, read as float32) in tiles of 128 rows through
      // the ring, two tiles ahead: rows of 64 pixels, by cp.async where
      // they are whole and 16-byte aligned
      const bool vec = npix % 8 == 0 && p0 + kTileP <= npix &&
                       reinterpret_cast<uintptr_t>(t) % 16 == 0;
      const auto stage_t = [&](int zi) {
        unsigned char* d = ring + (zi % kStages) * kRingBytes;
        const int z0 = zi * kTileM;
        if (vec) {
          for (int i = tid; i < kTileM * 8; i += kThreads) {
            const int r = i / 8, c = i % 8;
            if (z0 + r < z_dim)
              bf16op::cp_async16(d + r * 128 + c * 16,
                                 t + static_cast<long long>(z0 + r) * npix + p0 + 8 * c);
          }
        } else {
          uint16_t* h = reinterpret_cast<uint16_t*>(d);
          for (int i = tid; i < kTileM * kTileP; i += kThreads) {
            const int r = i / kTileP, j = i % kTileP;
            h[i] = z0 + r < z_dim && p0 + j < npix
                       ? t[static_cast<long long>(z0 + r) * npix + p0 + j]
                       : static_cast<uint16_t>(0);
          }
        }
      };
      stage_t(0);
      tf32x3::cp_async_commit();
      if (z_tiles > 1) stage_t(1);
      tf32x3::cp_async_commit();
      for (int zi = 0; zi < z_tiles; ++zi) {
        tf32x3::cp_async_wait_group<1>();
        __syncthreads();  // tile zi is in; every thread is done with tile zi - 1
        if (zi + 2 < z_tiles) stage_t(zi + 2);  // over tile zi - 1's stage
        tf32x3::cp_async_commit();
        const uint16_t* h = reinterpret_cast<const uint16_t*>(ring + (zi % kStages) * kRingBytes);
        accumulate(zi * kTileM, [&](int r) { return bf16op::widen(h[r * kTileP + pj]); });
      }
      tf32x3::cp_async_wait_group<0>();
    }
    __syncthreads();
    leave_one_out_run(dq, fac, n1, n2, q, b_lo, max(0, b_hi - b_lo),
                      [&](int r) { return vd[(b_lo + r) * kRow + pj]; }, pj);
  }
  __syncthreads();
  for (int i = tid; i < nq * kTileP; i += kThreads) {
    const int r = i / kTileP, j = i % kTileP;
    if (p0 + j < npix)
      dviews[r * npix + p0 + j] = ((dfac[r * kTileP + j] + dfac[(nq + r) * kTileP + j]) +
                                   dfac[(2 * nq + r) * kTileP + j]) +
                                  dfac[(3 * nq + r) * kTileP + j];
  }
}

template <bool kRecompute>
int launch_bf16(const void* views, const void* cmt_p, const void* cmt_tp, const void* g,
                const void* t, void* dviews, int n, int q, int n1, int out_size, long long npix,
                void* stream) {
  if (n < 1 || q < 1 || n1 < 1 || n1 > n || out_size < 1 || npix < 1 ||
      n * q > bf16op::kMaxFactorRows || n1 > kMaxChain || n - n1 > kMaxChain ||
      cmt_tp == nullptr || (kRecompute && n1 < n && cmt_p == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long a_dim = bf16op::ipow(q, n1);
  const long long b2 = bf16op::ipow(q, n - n1);
  const long long z_dim = b2 * out_size;
  if (b2 > bf16op::kMaxB2 || a_dim > (1LL << 30) || z_dim > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = smem_bytes(n, q, n1, b2, out_size, kRecompute);
  if (bytes > bf16op::kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = bf16op::allow_smem(eps_dviews_bf16_kernel<kRecompute>);
  if (err != cudaSuccess) return static_cast<int>(err);
  eps_dviews_bf16_kernel<kRecompute>
      <<<static_cast<unsigned>((npix + kTileP - 1) / kTileP), kThreads, static_cast<size_t>(bytes),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(views), static_cast<const uint16_t*>(cmt_p),
          static_cast<const uint16_t*>(cmt_tp), static_cast<const float*>(g),
          static_cast<const uint16_t*>(t), static_cast<float*>(dviews), n, q, n1,
          static_cast<int>(a_dim), static_cast<int>(b2), static_cast<int>(z_dim), out_size, npix,
          table_factors(q, n1));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dviews_bf16
}  // namespace

// dctn_eps_dviews_t's bf16 mode: cmt_tp, the transposed cmt (A, Z) in bf16
// zero-padded to (A rounded up to 128, Z rounded up to 64), t (Z, npix) in
// bf16 (t null when n1 == n), views, g and dviews float32; cmt_p unused.
extern "C" int dctn_eps_dviews_t_bf16(const void* views, const void* cmt_p, const void* cmt_tp,
                                      const void* g, const void* t, void* dviews, int n, int q,
                                      int n1, int out_size, long long npix, void* stream) {
  if ((n1 < n) != (t != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  return dviews_bf16::launch_bf16<false>(views, cmt_p, cmt_tp, g, t, dviews, n, q, n1, out_size,
                                         npix, stream);
}

// dctn_eps_dviews_recompute's bf16 mode: t recomputed in float32, not
// rounded, from cmt_p, cmt (Z, A) in bf16 zero-padded to (Z rounded up to
// 128, A rounded up to 64), and cmt_tp as above.
extern "C" int dctn_eps_dviews_recompute_bf16(const void* views, const void* cmt_p,
                                              const void* cmt_tp, const void* g, void* dviews,
                                              int n, int q, int n1, int out_size,
                                              long long npix, void* stream) {
  return dviews_bf16::launch_bf16<true>(views, cmt_p, cmt_tp, g, nullptr, dviews, n, q, n1,
                                        out_size, npix, stream);
}

// The shared memory of one bf16 launch at this shape, either form
// (dviews_bf16::smem_bytes; the wrapper's plan mirrors it and its tests hold
// the two equal).
extern "C" long long dctn_eps_dviews_bf16_smem_bytes(int n, int q, int n1, int out_size,
                                                     int recompute) {
  return dviews_bf16::smem_bytes(n, q, n1, bf16op::ipow(q, n - n1), out_size, recompute != 0);
}
