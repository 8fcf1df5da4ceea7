// K13 on Hopper: the fused log-space matrix product.
//
// Replaces `_kernel` of dctn_tpu/pallas/logmatmulexp_pallas.py:32 (its
// pallas_call at :67). For f32 log_a (Θ, R), log_b (R, I), row maxima amax
// (Θ) and column maxima bmax (I), computed by the caller with a non-finite
// maximum replaced by 0:
//
//   out[i, j] = log( Σ_r exp(a[i,r] − amax[i]) · exp(b[r,j] − bmax[j]) )
//               + amax[i] + bmax[j]
//
// What bounds it on an H100: for large R the 2·Θ·R·I f32 operations at
// 67 TFLOP/s (the CUDA cores; the exponentials add Θ·R·⌈I/64⌉ + R·I·⌈Θ/64⌉
// `expf` calls on top); at the entries' shapes (Θ, I ≤ 512, R ≤ 256) the
// launch and the few CTAs that 64×64 output tiles give.
//
// The design: a CTA owns a 64×64 output tile, 256 threads with 4×4 outputs
// each in f32 registers. It streams R through shared memory in chunks of
// 32, exponentiating each element with its shift as it is loaded, so
// exp(A) and exp(B) never reach device memory, which is the point of the
// TPU kernel. The epilogue is logf(acc) + amax + bmax. The kernel masks the
// ragged edges itself (an entry outside the operands contributes 0) and pads
// nothing. R has no limit: the TPU kernel kept all of R in VMEM.
//
// Few tiles at the entries' shapes (256×256 is 16 CTAs on 132 SMs), so R
// may be split: the host picks `splits` so that tiles·splits reaches about
// two CTAs per SM with at least two chunks per split (`_splits` in
// kernels/logmatmulexp_kernels.py). Each split writes its partial sums to
// `partial` (splits, Θ, I), and a second kernel adds them in split order and
// takes the log. The split points depend on the shape alone and there are
// no atomics, so every run gives the same bits.
//
// −inf is kept as the JAX kernel keeps it: expf(−inf − m) is exactly 0, and
// a row or column that is all −inf has the shift 0, so its sums are 0 and
// its outputs logf(0) = −inf, never NaN. The TPU kernel's clamp of the
// inputs at −1e30 served only its padding at −1e30 (the shift arithmetic of
// a padded row must stay finite); this kernel pads nothing and drops it.
// The accurate expf / logf are used, not the __expf / __logf intrinsics.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;  // output rows per CTA
constexpr int BN = 64;  // output columns per CTA
constexpr int BK = 32;  // R per chunk
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);
constexpr int FINISH_THREADS = 256;

static_assert(THREADS == 256, "the tile loads assume 256 threads");
static_assert(THREADS % BK == 0 && THREADS % BN == 0, "tile loads");

__global__ void __launch_bounds__(THREADS)
lme_kernel(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ amax, const float* __restrict__ bmax,
           float* __restrict__ out, float* __restrict__ partial,
           int theta, int r, int n_i, int chunks, int splits) {
  // A's tile as rows of R (+1: the two rows a warp reads fall in other
  // banks); B's tile as rows of I, read four columns at a time
  __shared__ float as[BM][BK + 1];
  __shared__ __align__(16) float bs[BK][BN];
  __shared__ float s_am[BM];
  __shared__ float s_bm[BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.z;
  const int c_begin = (int)((long long)split * chunks / splits);
  const int c_end = (int)((long long)(split + 1) * chunks / splits);

  if (tid < BM) {
    const int m = m0 + tid;
    s_am[tid] = m < theta ? amax[m] : 0.f;
  } else if (tid < BM + BN) {
    const int n = n0 + tid - BM;
    s_bm[tid - BM] = n < n_i ? bmax[n] : 0.f;
  }
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    const int k0 = c * BK;
    // A: consecutive threads read consecutive r of one row
#pragma unroll
    for (int l = 0; l < BM * BK / THREADS; ++l) {
      const int kk = tid % BK;
      const int mm = tid / BK + l * (THREADS / BK);
      const int m = m0 + mm;
      const int k = k0 + kk;
      as[mm][kk] = (m < theta && k < r) ? expf(a[(long long)m * r + k] - s_am[mm]) : 0.f;
    }
    // B: consecutive threads read consecutive columns of one row
#pragma unroll
    for (int l = 0; l < BK * BN / THREADS; ++l) {
      const int nn = tid % BN;
      const int kk = tid / BN + l * (THREADS / BN);
      const int n = n0 + nn;
      const int k = k0 + kk;
      bs[kk][nn] = (n < n_i && k < r) ? expf(b[(long long)k * n_i + n] - s_bm[nn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[ty * TM + i][kk];
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[kk][tx * TN]);
      const float bv[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (m >= theta || n >= n_i) continue;
      const long long at = (long long)m * n_i + n;
      if (splits == 1) {
        out[at] = logf(acc[i][j]) + s_am[ty * TM + i] + s_bm[tx * TN + j];
      } else {
        partial[(long long)split * theta * n_i + at] = acc[i][j];
      }
    }
  }
}

// The sum over the splits of R, in split order, then the log and the shifts.
__global__ void __launch_bounds__(FINISH_THREADS)
lme_finish_kernel(const float* __restrict__ partial, const float* __restrict__ amax,
                  const float* __restrict__ bmax, float* __restrict__ out, int theta,
                  int n_i, int splits) {
  const long long total = (long long)theta * n_i;
  const long long at = (long long)blockIdx.x * FINISH_THREADS + threadIdx.x;
  if (at >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[k * total + at];
  out[at] = logf(s) + amax[at / n_i] + bmax[at % n_i];
}

}  // namespace

// log_a (Θ, R), log_b (R, I), amax (Θ), bmax (I), out (Θ, I): contiguous
// f32 on the device. `partial` holds splits·Θ·I floats when splits > 1 (else
// unused). Returns the CUDA error of the launches (0 on success).
extern "C" int dctn_lme_fwd(const float* a, const float* b, const float* amax,
                            const float* bmax, float* out, float* partial, int theta,
                            int r, int n_i, int splits, cudaStream_t stream) {
  if (theta <= 0 || n_i <= 0) return 0;
  const int chunks = (r + BK - 1) / BK;
  dim3 grid((n_i + BN - 1) / BN, (theta + BM - 1) / BM, splits);
  lme_kernel<<<grid, THREADS, 0, stream>>>(a, b, amax, bmax, out, partial, theta, r, n_i,
                                           chunks, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)theta * n_i;
  lme_finish_kernel<<<(unsigned)((total + FINISH_THREADS - 1) / FINISH_THREADS),
                      FINISH_THREADS, 0, stream>>>(partial, amax, bmax, out, theta, n_i,
                                                   splits);
  return (int)cudaGetLastError();
}
