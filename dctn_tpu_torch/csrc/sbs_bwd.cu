// ConvSBS string backward for Hopper (sm_90a): d_cores and, when asked,
// d_views of one string's tensor-train fold, from the output cotangent g.
//
// Replaces the TPU kernels _sbs_bwd_mim_kernel_factory (K11,
// dctn_tpu/pallas/sbs_pallas.py:471) and _sbs_bwd_kernel_factory (K12's
// backward, :281). Per pixel it refolds the two half-chains of the forward
// (sbs_fwd.cu), keeping every state, and reverses them:
//   merge:  dA[(b, s, O_pre)] = sum_Q g[(O_pre, Q)] * U[(s, b, Q)],
//           dU[(s, b, Q)]     = sum_O g[(O, Q)] * A[(b, s, O)];
//   a prefix step  dst[(b,s,O,o)] = sum_rp src[(b,rp,O)] m[(rp,s,o)]  gives
//           dm[(rp,s,o)] = sum_{b,O} d_dst * src,  d_src = sum_{s,o} d_dst * m;
//   a suffix step  dst[(b1,b,o,Q)] = sum_s m[(b1,s,o)] src[(s,b,Q)]  gives
//           dm[(b1,s,o)] = sum_{b,Q} d_dst * src,  d_src = sum_{b1,o} d_dst * m;
//   and core 0's dm is the prefix cotangent that reaches it. Then
//           d_core[(row), j] += dm[row] * view[j]   (summed over pixels)
//           d_view[j]         = sum_row core[row, j] * dm[row].
// With mcut = P (the sequential fold) the suffix is the bare delta(b0) seed
// and only the prefix chain is reversed. The TPU's sequential backward builds
// per-core prefix and suffix tables instead; reversing the fold gives the same
// gradients with the prefix states alone.
//
// What bounds it on this card: as the forward, neither peak. It reads the
// factors and g once and writes d_views once (a few MB at the legacy shapes)
// and does about three times the forward's FMAs.
//
// Design: one thread per pixel as in the forward, the fold states in shared
// memory at state[k * T + t]. The TPU kernel carries the d_core sum over
// pixel tiles in VMEM across its sequential grid; Hopper blocks run in no
// order, so here a fixed number of CTAs (as many as are resident on the card)
// each walk over an equal share of the pixels in tiles of T. The pixel
// tile's output cotangent g is staged in shared memory once, and the merge
// reads it there.
// The d_core sum is a contraction over the pixel tile: each pixel writes the
// dm rows of a core, 16 at a time, into a (rows × pixels) tile beside the
// core's views (qc × pixels), and then the CTA forms
//   d_core[row, j] += Σ_pix dm[row, pix] · view[j, pix]
// for those rows, each (row, j) by a few threads over interleaved quads of
// pixels (the segments of `Tile`), their partials added in segment order
// into the CTA's one d_core accumulator in shared memory. A second kernel adds the
// CTAs' rows in order. No warp shuffles and no float atomics: the result is
// the same from run to run. The product runs on the CUDA cores: with q^C = 2
// to 4 its N is below the tensor cores' n = 8. Without d_views (need_dviews
// false) the d_view sums and the (P, qc, npix) write are skipped.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

#include "sbs_plan.cuh"

namespace {

using sbs::Lane;
using sbs::Plan;
using sbs::kMaxQc;

// dm rows of a core that the pixels write before the CTA sums them
constexpr int kDmRows = 16;

// The d_core contraction's shared memory and split: `dmt` holds dm row k of
// pixel t at k * tp + t (k < kDmRows), `vt` the current core's view j at
// j * tp + t, `part` one partial per (element, segment). The pixels are read
// four at a time (float4); segment s takes the quads s, s + nseg, s + 2 nseg,
// ... The row stride tp = T + 4 nseg keeps the quads a warp reads in
// distinct banks.
struct Tile {
  float* acc;  // the CTA's d_core sums (nelem)
  float* dmt;
  float* vt;
  float* part;
  int T, tp, nseg, tid;
  int quads;  // the quads of this tile that hold pixels of the CTA's range
};

__host__ __device__ __forceinline__ int tile_segments(int threads, int qc) {
  const int n = threads / (kDmRows * qc);
  return n > 1 ? n : 1;
}

__host__ __device__ __forceinline__ int tile_stride(int threads, int qc) {
  return threads + 4 * tile_segments(threads, qc);
}

// floats of the contraction's tiles (dmt, vt, part) and of the staged g
// (prod o floats per pixel, at k * T + t), a multiple of 4
__host__ __device__ __forceinline__ long long tile_floats(const Plan& p, int threads) {
  int o_total = 1;
  for (int i = 0; i < p.P; ++i) o_total *= p.o[i];
  return static_cast<long long>(kDmRows + p.qc) * tile_stride(threads, p.qc) + threads +
         static_cast<long long>(o_total) * threads;
}

// where the tiles start in shared memory: after the cores and the d_core
// sums, on 16 bytes
__host__ __device__ __forceinline__ int tile_offset(int nelem) { return (2 * nelem + 3) / 4 * 4; }

// shared memory of a launch: the cores, the d_core sums, every thread's fold
// states and, unless they spill to device memory, the tiles and g
__host__ __device__ __forceinline__ long long bwd_smem_bytes(const Plan& p, int threads) {
  const long long states = static_cast<long long>(threads) * p.S;
  if (p.spill) return 4LL * (2LL * p.nelem + states);
  return 4LL * (tile_offset(p.nelem) + tile_floats(p, threads) + states);
}

// Σ_t dm[t] · v[t] over the quads q0, q0 + step, ... below quads
__device__ __forceinline__ float quad_dot(const float* dm, const float* v, int q0, int step,
                                          int quads) {
  const float4* d4 = reinterpret_cast<const float4*>(dm);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float s = 0.f;
  for (int q = q0; q < quads; q += step) {
    const float4 a = d4[q], b = v4[q];
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    s = fmaf(a.w, b.w, s);
  }
  return s;
}

// d_core[row0 + k, j] += Σ_t dmt[k, t] · vt[j, t] over this pixel tile, for
// k < nr, into the CTA's sums; every thread of the CTA calls it
__device__ void flush(const Tile& tl, const Plan& p, int core, int row0, int nr) {
  __syncthreads();  // every pixel's dm rows and views are in
  const int qc = p.qc, ne = nr * qc, quads = tl.quads;
  float* acc = tl.acc + p.core_off[core] + row0 * qc;
  if (tl.nseg == 1) {
    for (int e = tl.tid; e < ne; e += tl.T)
      acc[e] += quad_dot(tl.dmt + (e / qc) * tl.tp, tl.vt + (e % qc) * tl.tp, 0, 1, quads);
    __syncthreads();  // the tiles are read
    return;
  }
  // ne * nseg <= kDmRows * qc * nseg <= T
  if (tl.tid < ne * tl.nseg) {
    const int e = tl.tid / tl.nseg, seg = tl.tid % tl.nseg;
    tl.part[tl.tid] =
        quad_dot(tl.dmt + (e / qc) * tl.tp, tl.vt + (e % qc) * tl.tp, seg, tl.nseg, quads);
  }
  __syncthreads();  // the tiles are read, the partials written
  if (tl.tid < ne) {
    float s = 0.f;
    for (int k = 0; k < tl.nseg; ++k) s += tl.part[tl.tid * tl.nseg + k];
    acc[tl.tid] += s;
  }
}

struct Grad {
  const float* cs;  // the cores in shared memory
  Tile tile;
  bool need_dviews;
};

// this pixel's views of the core about to be reversed, for the contraction
template <int N>
__device__ __forceinline__ void stage_views(const Grad& gr, int qc, const float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < qc) gr.tile.vt[j * gr.tile.tp + gr.tile.tid] = v[j];
}

// one dm element of core i (row `row` of its `rows`): its d_view terms, and
// its place in the contraction tile, which the CTA sums every kDmRows rows
template <int N>
__device__ __forceinline__ void emit(const Grad& gr, const Plan& p, int core, int row, int rows,
                                     float dm, float (&dv)[N]) {
  if (gr.need_dviews) {
    const float* c = gr.cs + p.core_off[core] + row * p.qc;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < p.qc) dv[j] = fmaf(c[j], dm, dv[j]);
  }
  const int k = row % kDmRows;
  gr.tile.dmt[k * gr.tile.tp + gr.tile.tid] = dm;
  if (k == kDmRows - 1 || row == rows - 1) flush(gr.tile, p, core, row - k, k + 1);
}

template <int N>
__device__ __forceinline__ void store_dviews(float* __restrict__ dviews, int core, int qc,
                                             long long npix, long long pix, bool active,
                                             const float (&dv)[N]) {
  if (dviews == nullptr || !active) return;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < qc) dviews[(static_cast<long long>(core) * qc + j) * npix + pix] = dv[j];
}

// kQ: the length of a pixel's view arrays, 4 where q^C <= 4 (the legacy
// model's strings: fewer registers) and kMaxQc else
template <int kQ>
__global__ void __launch_bounds__(256, 2)
sbs_bwd_kernel(const float* __restrict__ views, const float* __restrict__ cores,
               const float* __restrict__ g, float* __restrict__ dviews,
               float* __restrict__ partial, float* __restrict__ scratch, long long npix,
               const Plan p) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int nseg = tile_segments(T, p.qc);
  const int tp = tile_stride(T, p.qc);
  float* cs = smem;
  float* acc = cs + p.nelem;
  float* dmt;
  float* state;
  if (p.spill) {
    dmt = scratch + blockIdx.x * tile_floats(p, T);
    state = acc + p.nelem;
  } else {
    dmt = smem + tile_offset(p.nelem);
    state = dmt + tile_floats(p, T);
  }
  float* vt = dmt + kDmRows * tp;
  float* part = vt + p.qc * tp;
  float* gbase = part + T;
  for (int k = tid; k < p.nelem; k += T) {
    cs[k] = cores[k];
    acc[k] = 0.f;
  }
  __syncthreads();

  float* mine = state + tid;
  auto buf = [&](int off) { return Lane{mine + off * T, T}; };
  const int P = p.P, b0 = p.b0, mcut = p.mcut, qc = p.qc;
  int o_total = 1;
  for (int i = 0; i < P; ++i) o_total *= p.o[i];
  float v[kQ], dv[kQ];

  // this CTA's pixels, an equal share of npix (so no CTA takes a tile more
  // than another's), in tiles of T; a thread past the share skips the
  // arithmetic and gives dm = 0 to the contraction
  const long long begin = npix * blockIdx.x / gridDim.x;
  const long long end = npix * (blockIdx.x + 1) / gridDim.x;
  for (long long t0 = begin; t0 < end; t0 += T) {
    const long long pix = t0 + tid;
    const bool active = pix < end;
    const long long gp = active ? pix : 0;
    const int live = static_cast<int>(end - t0 < T ? end - t0 : T);
    const Grad gr{cs, Tile{acc, dmt, vt, part, T, tp, nseg, tid, (live + 3) / 4},
                  dviews != nullptr};

    // this pixel's output cotangent, read once
    const Lane gs{gbase + tid, T};
    for (int k = 0; k < o_total; ++k)
      gs[k] = active ? g[static_cast<long long>(k) * npix + pix] : 0.f;

    // the forward's two half-chains, every state kept
    sbs::load_views(views, 0, qc, npix, gp, active, v);
    const int rm = mcut < P ? p.l[mcut] : b0;
    Lane dacc = buf(p.da_a), dprev = buf(p.da_b);
    Lane dt = buf(p.dt_a), dtn = buf(p.dt_b);
    int opre = p.o[0], osuf = 1;
    for (int i = 1; i < mcut; ++i) opre *= p.o[i];
    for (int i = P - 1; i >= mcut; --i) osuf *= p.o[i];
    if (active) {
      const Lane l0 = buf(p.lstate[0]);
      for (int row = 0; row < p.l[0] * p.r[0] * p.o[0]; ++row)
        l0[row] = sbs::core_row_dot(cs + p.core_off[0], row, qc, v);
      int o_pre = p.o[0];
      for (int i = 1; i < mcut; ++i) {
        sbs::load_views(views, i, qc, npix, gp, active, v);
        sbs::fold_left(p, cs + p.core_off[i], p.o[i], p.l[i], p.r[i], o_pre, v,
                       buf(p.lstate[i - 1]), buf(p.lstate[i]));
        o_pre *= p.o[i];
      }
      sbs::write_seed(b0, buf(mcut < P ? p.tnext[P - 1] : p.suf));
      int o_suf = 1;
      for (int i = P - 1; i >= mcut; --i) {
        sbs::load_views(views, i, qc, npix, gp, active, v);
        sbs::fold_right(p, cs + p.core_off[i], p.o[i], p.l[i], p.r[i], o_suf, v,
                        buf(p.tnext[i]), buf(i > mcut ? p.tnext[i - 1] : p.suf));
        o_suf *= p.o[i];
      }

      // the merge's transposes
      const Lane pre = buf(p.lstate[mcut - 1]), suf = buf(p.suf);
      for (int b = 0; b < b0; ++b)
        for (int s = 0; s < rm; ++s)
          for (int op = 0; op < opre; ++op) {
            float a = 0.f;
            for (int q = 0; q < osuf; ++q)
              a = fmaf(gs[op * osuf + q], suf[(s * b0 + b) * osuf + q], a);
            dacc[(b * rm + s) * opre + op] = a;
          }
      if (mcut < P)
        for (int s = 0; s < rm; ++s)
          for (int b = 0; b < b0; ++b)
            for (int q = 0; q < osuf; ++q) {
              float a = 0.f;
              for (int op = 0; op < opre; ++op)
                a = fmaf(gs[op * osuf + q], pre[(b * rm + s) * opre + op], a);
              dt[(s * b0 + b) * osuf + q] = a;
            }
    }

    // reverse the prefix chain
    for (int i = mcut - 1; i >= 1; --i) {
      const int o = p.o[i], l = p.l[i], r = p.r[i];
      int op_prev = 1;
      for (int k = 0; k < i; ++k) op_prev *= p.o[k];
      const Lane prev = buf(p.lstate[i - 1]);
      if (active)
        for (int k = 0; k < b0 * l * op_prev; ++k) dprev[k] = 0.f;
      sbs::load_views(views, i, qc, npix, gp, active, v);
      stage_views(gr, qc, v);
#pragma unroll
      for (int j = 0; j < kQ; ++j) dv[j] = 0.f;
      for (int rp = 0; rp < l; ++rp)
        for (int s = 0; s < r; ++s)
          for (int oo = 0; oo < o; ++oo) {
            const int row = (rp * r + s) * o + oo;
            float dm = 0.f;
            if (active) {
              const float m = sbs::core_row_dot(cs + p.core_off[i], row, qc, v);
              for (int b = 0; b < b0; ++b)
                for (int q = 0; q < op_prev; ++q) {
                  const float d = dacc[((b * r + s) * op_prev + q) * o + oo];
                  const int k = (b * l + rp) * op_prev + q;
                  dm = fmaf(d, prev[k], dm);
                  dprev[k] += d * m;
                }
            }
            emit(gr, p, i, row, l * r * o, dm, dv);
          }
      store_dviews(dviews, i, qc, npix, pix, active, dv);
      const Lane t = dacc;
      dacc = dprev;
      dprev = t;
    }
    // core 0: the prefix cotangent that reaches it is its dm
    sbs::load_views(views, 0, qc, npix, gp, active, v);
    stage_views(gr, qc, v);
#pragma unroll
    for (int j = 0; j < kQ; ++j) dv[j] = 0.f;
    const int rows0 = p.l[0] * p.r[0] * p.o[0];
    for (int row = 0; row < rows0; ++row) emit(gr, p, 0, row, rows0, active ? dacc[row] : 0.f, dv);
    store_dviews(dviews, 0, qc, npix, pix, active, dv);

    // reverse the suffix chain
    int on = osuf;  // the O of the suffix state at core i, before folding it
    for (int i = mcut; i < P; ++i) {
      const int o = p.o[i], l = p.l[i], r = p.r[i];
      on /= o;
      const Lane tn = buf(p.tnext[i]);
      if (active)
        for (int k = 0; k < r * b0 * on; ++k) dtn[k] = 0.f;
      sbs::load_views(views, i, qc, npix, gp, active, v);
      stage_views(gr, qc, v);
#pragma unroll
      for (int j = 0; j < kQ; ++j) dv[j] = 0.f;
      for (int b1 = 0; b1 < l; ++b1)
        for (int s = 0; s < r; ++s)
          for (int oo = 0; oo < o; ++oo) {
            const int row = (b1 * r + s) * o + oo;
            float dm = 0.f;
            if (active) {
              const float m = sbs::core_row_dot(cs + p.core_off[i], row, qc, v);
              for (int b = 0; b < b0; ++b)
                for (int q = 0; q < on; ++q) {
                  const float d = dt[((b1 * b0 + b) * o + oo) * on + q];
                  const int k = (s * b0 + b) * on + q;
                  dm = fmaf(d, tn[k], dm);
                  dtn[k] += d * m;
                }
            }
            emit(gr, p, i, row, l * r * o, dm, dv);
          }
      store_dviews(dviews, i, qc, npix, pix, active, dv);
      const Lane t = dt;
      dt = dtn;
      dtn = t;
    }
  }

  // this CTA's partial d_cores
  __syncthreads();
  for (int e = tid; e < p.nelem; e += T)
    partial[static_cast<long long>(blockIdx.x) * p.nelem + e] = acc[e];
}

// dcores[e] = sum_k partial[k, e], the CTAs' rows in a fixed order
__global__ void sbs_dcore_sum_kernel(const float* __restrict__ partial,
                                     float* __restrict__ dcores, int nelem, int rows) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < nelem; e += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < rows; ++k) s += partial[static_cast<long long>(k) * nelem + e];
    dcores[e] = s;
  }
}

constexpr int kMaxDevices = 64;

template <int kQ>
cudaError_t ensure_smem_cap() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(sbs_bwd_kernel<kQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sbs::kMaxSmemBytes);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

template <int kQ>
cudaError_t launch_bwd(int blocks, int threads, long long smem, cudaStream_t s,
                       const void* views, const void* cores, const void* g, void* dviews,
                       void* partial, void* scratch, long long npix, const Plan& p) {
  const cudaError_t err = ensure_smem_cap<kQ>();
  if (err != cudaSuccess) return err;
  sbs_bwd_kernel<kQ><<<blocks, threads, static_cast<size_t>(smem), s>>>(
      static_cast<const float*>(views), static_cast<const float*>(cores),
      static_cast<const float*>(g), static_cast<float*>(dviews), static_cast<float*>(partial),
      static_cast<float*>(scratch), npix, p);
  return cudaGetLastError();
}

}  // namespace

// views (P, qc, npix) f32, cores the P (l*r*o, qc) matrices back to back f32,
// g (prod o, npix) f32, dviews (P, qc, npix) f32 or null (no d_views),
// partial (blocks, nelem) f32 scratch, scratch (blocks, tile_floats) f32 where
// the plan spills (else unused), dcores (nelem) f32, all contiguous
// on the current device; plan the Plan's fields as plan_ints ints; threads per
// block a multiple of 32, at most 256; blocks the CTAs that walk the pixel
// tiles. Launches the fold's backward and the fixed-order sum of its partials
// on `stream` and does not synchronise. Returns cudaGetLastError() (0 on
// success).
extern "C" int dctn_sbs_bwd(const void* views, const void* cores, const void* g,
                            void* dviews, void* partial, void* scratch, void* dcores,
                            const int* plan, int plan_ints, long long npix, int threads,
                            int blocks, void* stream) {
  if (plan == nullptr || plan_ints != sbs::kPlanInts || npix < 1 || threads < 32 ||
      threads > 256 || threads % 32 != 0 || blocks < 1 || partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const int* src = plan;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < sbs::kPlanInts; ++i) dst[i] = src[i];
  const long long smem = bwd_smem_bytes(p, threads);
  if (!sbs::plan_dims_ok(p) || smem > sbs::kMaxSmemBytes || (p.spill && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      p.qc <= 4 ? launch_bwd<4>(blocks, threads, smem, s, views, cores, g, dviews, partial,
                                scratch, npix, p)
                : launch_bwd<kMaxQc>(blocks, threads, smem, s, views, cores, g, dviews, partial,
                                     scratch, npix, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sum_blocks = std::min((p.nelem + 255) / 256, 1024);
  sbs_dcore_sum_kernel<<<sum_blocks, 256, 0, s>>>(static_cast<const float*>(partial),
                                                  static_cast<float*>(dcores), p.nelem,
                                                  blocks);
  return static_cast<int>(cudaGetLastError());
}
