// K13 on Hopper: the fused log-space matrix product, and its shifts.
//
// Replaces `_kernel` of dctn_tpu/pallas/logmatmulexp_pallas.py:32 (its
// pallas_call at :67) and the shifts `_forward` computes around it (:53-57).
// For f32 log_a (Θ, R), log_b (R, I):
//
//   amax[i] = max_r a[i, r],  bmax[j] = max_r b[r, j]   (a non-finite max → 0)
//   out[i, j] = log( Σ_r exp(a[i,r] − amax[i]) · exp(b[r,j] − bmax[j]) )
//               + amax[i] + bmax[j]
//
// Two kernels, one launch each: `lme_shifts_kernel` (the maxima) and
// `lme_kernel` (the product, with the sum of R's splits in the same launch).
//
// What bounds the product on an H100: for large R its 2·Θ·R·I operations at
// the 3xTF32 rate (165 TFLOP/s) and the exponentials, Θ·R·⌈I/64⌉ + R·I·⌈Θ/64⌉
// accurate `expf` on the CUDA cores; at the entries' shapes (Θ, I ≤ 512, R ≤
// 256) the launch.
//
// The design. A CTA owns a 64×64 output tile and walks its part of R in
// chunks of 32. The raw log operands arrive by cp.async, two chunks ahead;
// the CTA then writes exp(x − shift) of each entry once, as TF32 hi and lo
// planes in shared memory (csrc/tf32x3.cuh), so each entry is exponentiated
// and split once per CTA, not once per warp fragment. Each thread first loads
// its raw entries of the chunk (16 bytes at a time) and only then writes
// planes: interleaved, each load waited for the store before it (the
// compiler cannot tell the buffers apart); an entry outside the operands is
// exponentiated from −inf, so no branch. The warps multiply their part of
// the tile from the planes in 3xTF32 mma.sync (m16n8k8), and add their
// fragments into f32 totals every 4 chunks (128 values of R): the tensor
// cores truncate their sums. exp(A) and exp(B) never reach device memory,
// which is the point of the TPU kernel. Ragged edges are masked (an entry
// outside the operands contributes 0); nothing is padded, and R has no
// limit. Two forms of the CTA (`Layout`): 8 warps of 32×16, two CTAs per SM,
// where the grid fits on the card at two per SM; else 4 warps of 32×32,
// three CTAs per SM (73 KB of shared memory each), so that R = 32768's 272
// CTAs (16 tiles, 17 splits) run in one wave on 132 SMs.

// The split of R. At the entries' shapes there are few tiles (256×256 is 16
// CTAs on 132 SMs), so the host splits R (`_splits` in
// kernels/logmatmulexp_kernels.py, by the shape alone). Each split writes its
// totals to `partial` (splits, Θ, I), makes them visible (__threadfence) and
// counts itself in the tile's arrival counter; the CTA that arrives last adds
// the tile's partials in split order, takes the log, adds the shifts and sets
// the counter back to 0 for the next launch. No float atomics: every run
// gives the same bits. The counters are the caller's persistent zeroed
// buffer, so two launches must not run at once on different streams.
//
// The shifts. `lme_shifts_kernel` takes the row maxima of A (a warp per row)
// and the column maxima of B (32 columns per block, 8 rows at a time), each
// over R in slices of `kShiftSlice`; where R has more than one slice, each
// block writes its slice's maxima to `part` and the last block of each row or
// column group (an arrival counter, as above) takes the maximum over the
// slices. A maximum is exact in any order, so the result is the same bits as
// torch.amax; a non-finite maximum becomes 0.
//
// −inf is kept as the JAX kernel keeps it: expf(−inf − m) is exactly 0, zero
// planes stay zero, and a row or column that is all −inf has the shift 0, so
// its sums are 0 and its outputs logf(0) = −inf, never NaN. The TPU kernel's
// clamp of the inputs at −1e30 served only its padding; nothing is padded
// here. The accurate expf / logf are used, not the __expf / __logf intrinsics.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "tf32x3.cuh"

namespace {

constexpr int BM = 64;     // output rows per CTA
constexpr int BN = 64;     // output columns per CTA
constexpr int BK = 32;     // R per chunk
constexpr int kStages = 2;           // raw chunks in flight
constexpr int kFlushChunks = 4;      // chunks summed in the fragments (128 of R)
constexpr int RAP = BK + 4;          // raw A row stride: 16-byte rows for cp.async
constexpr int RBP = BN + 4;          // raw B row stride
constexpr int AP = BK + 4;           // A plane row stride: fragment loads in 32 banks
constexpr int BP = BN + 8;           // B plane row stride
constexpr int kRawFloats = BM * RAP + BK * RBP;
constexpr int kPlaneFloats = 2 * (BM * AP + BK * BP);
constexpr int kSmemBytes = 4 * (kStages * kRawFloats + kPlaneFloats + BM + BN);

// The CTA's warps: 2 along M by kWarpsN along N, each 32 rows by 64 / kWarpsN
// columns. Both forms give every output the same mma sequence, so the same
// bits: 8 warps (32×16 each, two CTAs per SM) where the grid fits on the card
// at two CTAs per SM, 4 warps (32×32, three CTAs per SM) where it does not.
template <int kWarpsN>
struct Layout {
  static constexpr int kThreads = 64 * kWarpsN;
  static constexpr int kNJ = 8 / kWarpsN;  // n8 fragments per warp
  static constexpr int kQuadsA = BM * BK / 4 / kThreads;  // raw float4 per thread and chunk
  static constexpr int kQuadsB = BK * BN / 4 / kThreads;
  static constexpr int kMinBlocks = kWarpsN == 4 ? 2 : 3;
  static_assert(kThreads >= BM + BN, "one thread per shift");
  static_assert(BM * BK % (4 * kThreads) == 0 && BK * BN % (4 * kThreads) == 0, "tile loads");
};

// the shifts kernel: rows of A per block (a warp each), columns of B per
// block, R per slice
constexpr int kShiftThreads = 256;
constexpr int kShiftRows = kShiftThreads / 32;
constexpr int kShiftCols = 32;
constexpr int kShiftSlice = 2048;

// the shifts kernel's slices of R, and its blocks of rows and columns
constexpr int shift_slices(int r) { return r < 1 ? 1 : (r + kShiftSlice - 1) / kShiftSlice; }
constexpr int shift_groups(int theta, int n_i) {
  return (theta + kShiftRows - 1) / kShiftRows + (n_i + kShiftCols - 1) / kShiftCols;
}

// cp.async of one chunk of raw A (BM × BK from row m0, column k0) and raw B
// (BK × BN from row k0, column n0) into one stage; entries outside the
// operands are zero-filled (and masked again when exponentiated)
template <bool kVec, int kThreads>
__device__ __forceinline__ void load_chunk(float* raw, const float* __restrict__ a,
                                           const float* __restrict__ b, int theta, int r,
                                           int n_i, int m0, int n0, int k0, int tid) {
  float* ra = raw;
  float* rb = raw + BM * RAP;
  if (kVec) {
#pragma unroll
    for (int l = 0; l < BM * BK / 4 / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int mm = e / (BK / 4), kk = 4 * (e % (BK / 4));
      const int m = m0 + mm, k = k0 + kk;
      const int bytes = m < theta ? 4 * max(0, min(4, r - k)) : 0;
      tf32x3::cp_async16(ra + mm * RAP + kk, bytes > 0 ? a + (long long)m * r + k : a, bytes);
    }
#pragma unroll
    for (int l = 0; l < BK * BN / 4 / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int kk = e / (BN / 4), nn = 4 * (e % (BN / 4));
      const int k = k0 + kk, n = n0 + nn;
      const int bytes = k < r ? 4 * max(0, min(4, n_i - n)) : 0;
      tf32x3::cp_async16(rb + kk * RBP + nn, bytes > 0 ? b + (long long)k * n_i + n : b, bytes);
    }
  } else {
#pragma unroll
    for (int l = 0; l < BM * BK / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int mm = e / BK, kk = e % BK;
      const int m = m0 + mm, k = k0 + kk;
      const bool ok = m < theta && k < r;
      tf32x3::cp_async4(ra + mm * RAP + kk, ok ? a + (long long)m * r + k : a, ok ? 4 : 0);
    }
#pragma unroll
    for (int l = 0; l < BK * BN / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int kk = e / BN, nn = e % BN;
      const int k = k0 + kk, n = n0 + nn;
      const bool ok = k < r && n < n_i;
      tf32x3::cp_async4(rb + kk * RBP + nn, ok ? b + (long long)k * n_i + n : b, ok ? 4 : 0);
    }
  }
}

// exp(x − shift) of four entries as TF32 hi and lo planes (16 bytes each).
// An entry outside the operands (its index at or past `end`, or the whole
// quad with `live` false) is exponentiated from −inf, which gives exactly 0
// without a branch.
__device__ __forceinline__ void store_quad(float* hi, float* lo, float4 x, float4 sh,
                                           bool live, int first, int end) {
  const float xs[4] = {x.x - sh.x, x.y - sh.y, x.z - sh.z, x.w - sh.w};
  float h[4], l[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float e = expf(live && first + q < end ? xs[q] : -INFINITY);
    h[q] = tf32x3::round_tf32(e);
    l[q] = e - h[q];
  }
  *reinterpret_cast<float4*>(hi) = make_float4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<float4*>(lo) = make_float4(l[0], l[1], l[2], l[3]);
}

template <bool kVec, int kWarpsN>
__global__ void __launch_bounds__(Layout<kWarpsN>::kThreads, Layout<kWarpsN>::kMinBlocks)
lme_kernel(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ amax, const float* __restrict__ bmax,
           float* __restrict__ out, float* __restrict__ partial, int* __restrict__ counters,
           int theta, int r, int n_i, int chunks, int splits) {
  using Ly = Layout<kWarpsN>;
  constexpr int T = Ly::kThreads, NJ = Ly::kNJ;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;
  float* a_hi = raw + kStages * kRawFloats;
  float* a_lo = a_hi + BM * AP;
  float* b_hi = a_lo + BM * AP;
  float* b_lo = b_hi + BK * BP;
  float* s_am = b_lo + BK * BP;
  float* s_bm = s_am + BM;
  __shared__ bool s_last;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;  // the warp's 32 × 8·NJ part
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
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (c_begin + s < c_end)
      load_chunk<kVec, T>(raw + s * kRawFloats, a, b, theta, r, n_i, m0, n0, (c_begin + s) * BK,
                          tid);
    tf32x3::cp_async_commit();
  }

  float d[2][NJ][4], tot[2][NJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][j][e] = tot[i][j][e] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    const int stage = (c - c_begin) % kStages;
    const int k0 = c * BK;
    tf32x3::cp_async_wait_group<kStages - 1>();
    __syncthreads();  // chunk c is in; every warp is done with the last planes
    {
      // A, then B: each thread's raw entries first, then its planes
      const float* ra = raw + stage * kRawFloats;
      const float* rb = ra + BM * RAP;
      float4 x[Ly::kQuadsA];
      float sh[Ly::kQuadsA];
#pragma unroll
      for (int l = 0; l < Ly::kQuadsA; ++l) {
        const int e = tid + l * T;
        const int mm = e / (BK / 4), kk = 4 * (e % (BK / 4));
        x[l] = *reinterpret_cast<const float4*>(ra + mm * RAP + kk);
        sh[l] = s_am[mm];
      }
#pragma unroll
      for (int l = 0; l < Ly::kQuadsA; ++l) {
        const int e = tid + l * T;
        const int mm = e / (BK / 4), kk = 4 * (e % (BK / 4));
        store_quad(a_hi + mm * AP + kk, a_lo + mm * AP + kk, x[l],
                   make_float4(sh[l], sh[l], sh[l], sh[l]), m0 + mm < theta, k0 + kk, r);
      }
      float4 y[Ly::kQuadsB], shb[Ly::kQuadsB];
#pragma unroll
      for (int l = 0; l < Ly::kQuadsB; ++l) {
        const int e = tid + l * T;
        const int kk = e / (BN / 4), nn = 4 * (e % (BN / 4));
        y[l] = *reinterpret_cast<const float4*>(rb + kk * RBP + nn);
        shb[l] = *reinterpret_cast<const float4*>(s_bm + nn);
      }
#pragma unroll
      for (int l = 0; l < Ly::kQuadsB; ++l) {
        const int e = tid + l * T;
        const int kk = e / (BN / 4), nn = 4 * (e % (BN / 4));
        store_quad(b_hi + kk * BP + nn, b_lo + kk * BP + nn, y[l], shb[l], k0 + kk < r, n0 + nn,
                   n_i);
      }
    }
    __syncthreads();  // the planes are written; the raw stage is free
    if (c + kStages < c_end)
      load_chunk<kVec, T>(raw + stage * kRawFloats, a, b, theta, r, n_i, m0, n0,
                          (c + kStages) * BK, tid);
    tf32x3::cp_async_commit();

#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      uint32_t ah[2][4], al[2][4], bh[NJ][2], bl[NJ][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm * 32 + i * 16 + g;
        const int col = ks * 8 + tig;
        const int at[4] = {row * AP + col, (row + 8) * AP + col, row * AP + col + 4,
                           (row + 8) * AP + col + 4};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[i][e] = __float_as_uint(a_hi[at[e]]);
          al[i][e] = __float_as_uint(a_lo[at[e]]);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = wn * 8 * NJ + j * 8 + g;
        const int row = ks * 8 + tig;
        bh[j][0] = __float_as_uint(b_hi[row * BP + col]);
        bh[j][1] = __float_as_uint(b_hi[(row + 4) * BP + col]);
        bl[j][0] = __float_as_uint(b_lo[row * BP + col]);
        bl[j][1] = __float_as_uint(b_lo[(row + 4) * BP + col]);
      }
      tf32x3::mma3_tiles<2, NJ>(d, ah, al, bh, bl);
    }
    if ((c - c_begin) % kFlushChunks == kFlushChunks - 1 || c + 1 == c_end) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[i][j][e] += d[i][j][e];
            d[i][j][e] = 0.f;
          }
    }
  }
  tf32x3::cp_async_wait_all();
  __syncthreads();  // the shifts in shared memory, also for a split without chunks

  // the fragment element (i, j, e) of this thread: row wm·32 + i·16 + g (+8
  // for e ≥ 2), column wn·8·NJ + j·8 + 2·tig (+1 for odd e)
  const long long total = (long long)theta * n_i;
  if (splits > 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + wm * 32 + i * 16 + g + (e >= 2 ? 8 : 0);
          const int n = n0 + wn * 8 * NJ + j * 8 + 2 * tig + (e & 1);
          if (m < theta && n < n_i) partial[split * total + (long long)m * n_i + n] = tot[i][j][e];
        }
    __threadfence();
    __syncthreads();
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) s_last = atomicAdd(counters + tile, 1) == splits - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
  }
  // the sum over the splits in split order, every load of a split in flight
  // at once (one at a time, each waited for the L2)
  if (splits > 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[i][j][e] = 0.f;
    for (int k = 0; k < splits; ++k) {
      const float* pk = partial + k * total;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = m0 + wm * 32 + i * 16 + g + (e >= 2 ? 8 : 0);
            const int n = n0 + wn * 8 * NJ + j * 8 + 2 * tig + (e & 1);
            if (m < theta && n < n_i) tot[i][j][e] += __ldcg(pk + (long long)m * n_i + n);
          }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int mm = wm * 32 + i * 16 + g + (e >= 2 ? 8 : 0);
        const int nn = wn * 8 * NJ + j * 8 + 2 * tig + (e & 1);
        const int m = m0 + mm, n = n0 + nn;
        if (m < theta && n < n_i) out[(long long)m * n_i + n] = logf(tot[i][j][e]) + s_am[mm] + s_bm[nn];
      }
  if (splits > 1 && tid == 0) counters[blockIdx.y * gridDim.x + blockIdx.x] = 0;
}

// A non-finite maximum becomes 0 (logmatmulexp.py:39-42).
__device__ __forceinline__ float finite_or_zero(float m) { return isfinite(m) ? m : 0.f; }

// Blocks [0, row_blocks) take kShiftRows rows of A each, the others kShiftCols
// columns of B; blockIdx.y is the slice of R. With one slice the block writes
// the shifts; with more, its slice's maxima go to part (slices, Θ + I) and the
// last block of the group to arrive writes the shifts.
__global__ void __launch_bounds__(kShiftThreads)
lme_shifts_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ amax, float* __restrict__ bmax, float* __restrict__ part,
                  int* __restrict__ counters, int theta, int r, int n_i, int row_blocks) {
  __shared__ float s_max[kShiftThreads];
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int slices = gridDim.y, slice = blockIdx.y;
  const int k_begin = slice * kShiftSlice;
  const int k_end = min(r, k_begin + kShiftSlice);
  const bool rows = (int)blockIdx.x < row_blocks;
  // the rows (or columns) of this block, and where their maxima go
  int first, count;
  float* dst;
  int part_off;
  if (rows) {
    first = blockIdx.x * kShiftRows;
    count = min(kShiftRows, theta - first);
    dst = amax;
    part_off = 0;
    const int m = first + warp;
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    if (warp < count) {
      const float* row = a + (long long)m * r;
      int k = k_begin + lane;
      for (; k + 96 < k_end; k += 128) {
#pragma unroll
        for (int u = 0; u < 4; ++u) mx[u] = fmaxf(mx[u], row[k + 32 * u]);
      }
      for (; k < k_end; k += 32) mx[0] = fmaxf(mx[0], row[k]);
    }
    float v = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, w));
    if (lane == 0) s_max[warp] = v;
  } else {
    first = (blockIdx.x - row_blocks) * kShiftCols;
    count = min(kShiftCols, n_i - first);
    dst = bmax;
    part_off = theta;
    const int n = first + lane;
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    if (lane < count) {
      int k = k_begin + warp;
      for (; k + 3 * kShiftRows < k_end; k += 4 * kShiftRows) {
#pragma unroll
        for (int u = 0; u < 4; ++u) mx[u] = fmaxf(mx[u], b[(long long)(k + u * kShiftRows) * n_i + n]);
      }
      for (; k < k_end; k += kShiftRows) mx[0] = fmaxf(mx[0], b[(long long)k * n_i + n]);
    }
    s_max[tid] = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    __syncthreads();
    if (warp == 0) {
      float v = s_max[lane];
      for (int w = 1; w < kShiftRows; ++w) v = fmaxf(v, s_max[w * 32 + lane]);
      s_max[lane] = v;
    }
  }
  __syncthreads();
  // s_max[x] is the maximum of row (or column) first + x over this slice
  if (slices == 1) {
    if (tid < count) dst[first + tid] = finite_or_zero(s_max[tid]);
    return;
  }
  const int stride = theta + n_i;
  if (tid < count) part[(long long)slice * stride + part_off + first + tid] = s_max[tid];
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + blockIdx.x, 1) == slices - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (tid < count) {
    float v = -INFINITY;
    for (int s = 0; s < slices; ++s)
      v = fmaxf(v, __ldcg(part + (long long)s * stride + part_off + first + tid));
    dst[first + tid] = finite_or_zero(v);
  }
  if (tid == 0) counters[blockIdx.x] = 0;
}

constexpr int kMaxDevices = 64;

template <bool kVec, int kWarpsN>
cudaError_t ensure_smem_cap() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(lme_kernel<kVec, kWarpsN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

template <bool kVec, int kWarpsN>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* a, const float* b,
                   const float* amax, const float* bmax, float* out, float* partial,
                   int* counters, int theta, int r, int n_i, int chunks, int splits) {
  const cudaError_t err = ensure_smem_cap<kVec, kWarpsN>();
  if (err != cudaSuccess) return err;
  lme_kernel<kVec, kWarpsN><<<grid, Layout<kWarpsN>::kThreads, kSmemBytes, stream>>>(
      a, b, amax, bmax, out, partial, counters, theta, r, n_i, chunks, splits);
  return cudaGetLastError();
}

}  // namespace

// The product's shared memory per CTA, in bytes (the host's plan checks it).
extern "C" int dctn_lme_smem_bytes() { return kSmemBytes; }

// log_a (Θ, R), log_b (R, I), amax (Θ), bmax (I), out (Θ, I): contiguous f32
// on the device. `partial` holds splits·Θ·I floats when splits > 1 (else
// unused); `counters` one zeroed int per output tile, left zeroed. `warps_n`
// is the CTA's form: 4 (8 warps) or 2 (4 warps). Returns the CUDA error of
// the launch (0 on success).
extern "C" int dctn_lme_fwd(const float* a, const float* b, const float* amax,
                            const float* bmax, float* out, float* partial, int* counters,
                            int theta, int r, int n_i, int splits, int warps_n,
                            cudaStream_t stream) {
  if (theta <= 0 || n_i <= 0) return 0;
  if (r < 0 || splits < 1 || (splits > 1 && (partial == nullptr || counters == nullptr)) ||
      (warps_n != 2 && warps_n != 4))
    return (int)cudaErrorInvalidValue;
  const int chunks = (r + BK - 1) / BK;
  dim3 grid((n_i + BN - 1) / BN, (theta + BM - 1) / BM, splits);
  // 16-byte cp.async where every row starts on 16 bytes
  const bool vec = r % 4 == 0 && n_i % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const auto run = vec ? (warps_n == 4 ? launch<true, 4> : launch<true, 2>)
                       : (warps_n == 4 ? launch<false, 4> : launch<false, 2>);
  return (int)run(grid, stream, a, b, amax, bmax, out, partial, counters, theta, r, n_i, chunks,
                  splits);
}

// amax (Θ) and bmax (I) of log_a (Θ, R) and log_b (R, I), contiguous f32 on
// the device. `part` holds slices·(Θ + I) floats and `counters` one zeroed
// int per group (`shift_groups`), left zeroed, when R has more than
// one slice (else both unused). Returns the CUDA error of the launch.
extern "C" int dctn_lme_shifts(const float* a, const float* b, float* amax, float* bmax,
                               float* part, int* counters, int theta, int r, int n_i,
                               cudaStream_t stream) {
  if (theta <= 0 || n_i <= 0) return 0;
  if (r < 0) return (int)cudaErrorInvalidValue;
  const int slices = shift_slices(r);
  if (slices > 65535 || (slices > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int row_blocks = (theta + kShiftRows - 1) / kShiftRows;
  dim3 grid(shift_groups(theta, n_i), slices);
  lme_shifts_kernel<<<grid, kShiftThreads, 0, stream>>>(a, b, amax, bmax, part, counters, theta,
                                                        r, n_i, row_blocks);
  return (int)cudaGetLastError();
}
