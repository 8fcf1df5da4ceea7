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
// order, so here a fixed number of CTAs (about as many as are resident on the
// card) each walk over pixel tiles of T pixels. Each d_core element is summed
// over a warp's 32 pixels by a butterfly of shuffles, lane 0 adds it to the
// warp's own accumulator in shared memory, the CTA adds its warps in order
// into its partial row, and a second kernel adds the rows in order. No float
// atomics: the result is the same from run to run. Without d_views
// (need_dviews false) the d_view sums and the (P, qc, npix) write are skipped.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

#include "sbs_plan.cuh"

namespace {

using sbs::Lane;
using sbs::Plan;
using sbs::kMaxQc;

struct Grad {
  const float* cs;  // the cores in shared memory
  float* accw;      // this warp's d_core accumulators
  int lane;
  bool need_dviews;
};

// one dm element of core i: its d_core terms (warp-summed) and its d_view terms
__device__ __forceinline__ void emit(const Grad& gr, const Plan& p, int core, int row,
                                     float dm, const float (&v)[kMaxQc],
                                     float (&dv)[kMaxQc]) {
  const int base = p.core_off[core] + row * p.qc;
#pragma unroll
  for (int j = 0; j < kMaxQc; ++j) {
    if (j < p.qc) {
      float x = dm * v[j];
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) x += __shfl_xor_sync(0xffffffffu, x, w);
      if (gr.lane == 0) gr.accw[base + j] += x;
      if (gr.need_dviews) dv[j] = fmaf(gr.cs[base + j], dm, dv[j]);
    }
  }
}

__device__ __forceinline__ void store_dviews(float* __restrict__ dviews, int core, int qc,
                                             long long npix, long long pix, bool active,
                                             const float (&dv)[kMaxQc]) {
  if (dviews == nullptr || !active) return;
#pragma unroll
  for (int j = 0; j < kMaxQc; ++j)
    if (j < qc) dviews[(static_cast<long long>(core) * qc + j) * npix + pix] = dv[j];
}

__global__ void sbs_bwd_kernel(const float* __restrict__ views,
                               const float* __restrict__ cores,
                               const float* __restrict__ g, float* __restrict__ dviews,
                               float* __restrict__ partial, long long npix, const Plan p) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int warps = T / 32;
  float* cs = smem;
  float* accw_all = cs + p.nelem;
  float* state = accw_all + warps * p.nelem;
  for (int k = tid; k < p.nelem; k += T) cs[k] = cores[k];
  for (int k = tid; k < warps * p.nelem; k += T) accw_all[k] = 0.f;
  __syncthreads();

  const Grad gr{cs, accw_all + (tid / 32) * p.nelem, tid % 32, dviews != nullptr};
  float* mine = state + tid;
  auto buf = [&](int off) { return Lane{mine + off * T, T}; };
  const int P = p.P, b0 = p.b0, mcut = p.mcut, qc = p.qc;
  float v[kMaxQc], dv[kMaxQc];

  const long long tiles = (npix + T - 1) / T;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long pix = tile * T + tid;
    const bool active = pix < npix;  // the others fold zeros: g = 0 there
    const long long gp = active ? pix : 0;

    // the forward's two half-chains, every state kept
    sbs::load_views(views, 0, qc, npix, gp, active, v);
    {
      const Lane l0 = buf(p.lstate[0]);
      for (int row = 0; row < p.l[0] * p.r[0] * p.o[0]; ++row)
        l0[row] = sbs::core_row_dot(cs + p.core_off[0], row, qc, v);
    }
    int opre = p.o[0];
    for (int i = 1; i < mcut; ++i) {
      sbs::load_views(views, i, qc, npix, gp, active, v);
      sbs::fold_left(p, cs + p.core_off[i], p.o[i], p.l[i], p.r[i], opre, v,
                     buf(p.lstate[i - 1]), buf(p.lstate[i]));
      opre *= p.o[i];
    }
    sbs::write_seed(b0, buf(mcut < P ? p.tnext[P - 1] : p.suf));
    int osuf = 1;
    for (int i = P - 1; i >= mcut; --i) {
      sbs::load_views(views, i, qc, npix, gp, active, v);
      sbs::fold_right(p, cs + p.core_off[i], p.o[i], p.l[i], p.r[i], osuf, v,
                      buf(p.tnext[i]), buf(i > mcut ? p.tnext[i - 1] : p.suf));
      osuf *= p.o[i];
    }

    // the merge's transposes
    const int rm = mcut < P ? p.l[mcut] : b0;
    const Lane pre = buf(p.lstate[mcut - 1]), suf = buf(p.suf);
    Lane dacc = buf(p.da_a), dprev = buf(p.da_b);
    for (int b = 0; b < b0; ++b)
      for (int s = 0; s < rm; ++s)
        for (int op = 0; op < opre; ++op) {
          float acc = 0.f;
          for (int q = 0; q < osuf; ++q) {
            const float gv = active ? g[static_cast<long long>(op * osuf + q) * npix + pix] : 0.f;
            acc = fmaf(gv, suf[(s * b0 + b) * osuf + q], acc);
          }
          dacc[(b * rm + s) * opre + op] = acc;
        }
    Lane dt = buf(p.dt_a), dtn = buf(p.dt_b);
    if (mcut < P)
      for (int s = 0; s < rm; ++s)
        for (int b = 0; b < b0; ++b)
          for (int q = 0; q < osuf; ++q) {
            float acc = 0.f;
            for (int op = 0; op < opre; ++op) {
              const float gv = active ? g[static_cast<long long>(op * osuf + q) * npix + pix] : 0.f;
              acc = fmaf(gv, pre[(b * rm + s) * opre + op], acc);
            }
            dt[(s * b0 + b) * osuf + q] = acc;
          }

    // reverse the prefix chain
    for (int i = mcut - 1; i >= 1; --i) {
      const int o = p.o[i], l = p.l[i], r = p.r[i];
      int op_prev = 1;
      for (int k = 0; k < i; ++k) op_prev *= p.o[k];
      const Lane prev = buf(p.lstate[i - 1]);
      for (int k = 0; k < b0 * l * op_prev; ++k) dprev[k] = 0.f;
      sbs::load_views(views, i, qc, npix, gp, active, v);
#pragma unroll
      for (int j = 0; j < kMaxQc; ++j) dv[j] = 0.f;
      for (int rp = 0; rp < l; ++rp)
        for (int s = 0; s < r; ++s)
          for (int oo = 0; oo < o; ++oo) {
            const int row = (rp * r + s) * o + oo;
            const float m = sbs::core_row_dot(cs + p.core_off[i], row, qc, v);
            float dm = 0.f;
            for (int b = 0; b < b0; ++b)
              for (int q = 0; q < op_prev; ++q) {
                const float d = dacc[((b * r + s) * op_prev + q) * o + oo];
                const int k = (b * l + rp) * op_prev + q;
                dm = fmaf(d, prev[k], dm);
                dprev[k] += d * m;
              }
            emit(gr, p, i, row, dm, v, dv);
          }
      store_dviews(dviews, i, qc, npix, pix, active, dv);
      const Lane t = dacc;
      dacc = dprev;
      dprev = t;
    }
    // core 0: the prefix cotangent that reaches it is its dm
    sbs::load_views(views, 0, qc, npix, gp, active, v);
#pragma unroll
    for (int j = 0; j < kMaxQc; ++j) dv[j] = 0.f;
    for (int row = 0; row < p.l[0] * p.r[0] * p.o[0]; ++row) emit(gr, p, 0, row, dacc[row], v, dv);
    store_dviews(dviews, 0, qc, npix, pix, active, dv);

    // reverse the suffix chain
    int on = osuf;  // the O of the suffix state at core i, before folding it
    for (int i = mcut; i < P; ++i) {
      const int o = p.o[i], l = p.l[i], r = p.r[i];
      on /= o;
      const Lane tn = buf(p.tnext[i]);
      for (int k = 0; k < r * b0 * on; ++k) dtn[k] = 0.f;
      sbs::load_views(views, i, qc, npix, gp, active, v);
#pragma unroll
      for (int j = 0; j < kMaxQc; ++j) dv[j] = 0.f;
      for (int b1 = 0; b1 < l; ++b1)
        for (int s = 0; s < r; ++s)
          for (int oo = 0; oo < o; ++oo) {
            const int row = (b1 * r + s) * o + oo;
            const float m = sbs::core_row_dot(cs + p.core_off[i], row, qc, v);
            float dm = 0.f;
            for (int b = 0; b < b0; ++b)
              for (int q = 0; q < on; ++q) {
                const float d = dt[((b1 * b0 + b) * o + oo) * on + q];
                const int k = (s * b0 + b) * on + q;
                dm = fmaf(d, tn[k], dm);
                dtn[k] += d * m;
              }
            emit(gr, p, i, row, dm, v, dv);
          }
      store_dviews(dviews, i, qc, npix, pix, active, dv);
      const Lane t = dt;
      dt = dtn;
      dtn = t;
    }
  }

  // this CTA's partial d_cores: its warps' sums, added in warp order
  __syncthreads();
  for (int e = tid; e < p.nelem; e += T) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += accw_all[w * p.nelem + e];
    partial[static_cast<long long>(blockIdx.x) * p.nelem + e] = s;
  }
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

cudaError_t ensure_smem_cap() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(sbs_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sbs::kMaxSmemBytes);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// views (P, qc, npix) f32, cores the P (l*r*o, qc) matrices back to back f32,
// g (prod o, npix) f32, dviews (P, qc, npix) f32 or null (no d_views),
// partial (blocks, nelem) f32 scratch, dcores (nelem) f32, all contiguous on
// the current device; plan the Plan's fields as plan_ints ints; threads per
// block a multiple of 32; blocks the CTAs that walk the pixel tiles. Launches
// the fold's backward and the fixed-order sum of its partials on `stream` and
// does not synchronise. Returns cudaGetLastError() (0 on success).
extern "C" int dctn_sbs_bwd(const void* views, const void* cores, const void* g,
                            void* dviews, void* partial, void* dcores, const int* plan,
                            int plan_ints, long long npix, int threads, int blocks,
                            void* stream) {
  if (plan == nullptr || plan_ints != sbs::kPlanInts || npix < 1 || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || blocks < 1 || partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const int* src = plan;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < sbs::kPlanInts; ++i) dst[i] = src[i];
  const long long smem =
      4LL * (p.nelem + static_cast<long long>(threads / 32) * p.nelem +
             static_cast<long long>(threads) * p.S);
  if (!sbs::plan_dims_ok(p) || smem > sbs::kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = ensure_smem_cap();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sbs_bwd_kernel<<<blocks, threads, static_cast<size_t>(smem), s>>>(
      static_cast<const float*>(views), static_cast<const float*>(cores),
      static_cast<const float*>(g), static_cast<float*>(dviews),
      static_cast<float*>(partial), npix, p);
  const int sum_blocks = std::min((p.nelem + 255) / 256, 1024);
  sbs_dcore_sum_kernel<<<sum_blocks, 256, 0, s>>>(static_cast<const float*>(partial),
                                                  static_cast<float*>(dcores), p.nelem,
                                                  blocks);
  return static_cast<int>(cudaGetLastError());
}
