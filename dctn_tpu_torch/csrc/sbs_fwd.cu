// ConvSBS string forward for Hopper (sm_90a): the tensor-train fold of one
// string over the (P, qc, npix) stack of merged window factors.
//
// Replaces the TPU kernels _sbs_fwd_mim_kernel_factory (K10,
// dctn_tpu/pallas/sbs_pallas.py:430) and _sbs_fwd_kernel_factory (K12's
// forward, :256). Per pixel, with m_i[(l, r, o)] = sum_qc core_i * view_i:
//   prefix  A[(b0, r, O_pre)] = fold of cores 0..mcut-1 from m_0;
//   suffix  U[(l, b0, O_suf)] = fold of cores P-1..mcut from delta(b0);
//   out[(O_pre, O_suf)] = sum_{b0, r_m} A[(b, s, O_pre)] * U[(s, b, O_suf)].
// mcut = P is the sequential fold: the prefix runs over every core, the
// suffix is the bare delta(b0) seed, and the merge is the ring trace.
//
// What bounds it on this card: nothing of the card's peaks. The work per
// pixel is a few hundred to a few thousand FMAs on bonds <= 8 (tensor cores
// are of no use at K = qc <= 16), the bytes are the factors read once and the
// output written once (a layer-0 string of the legacy model at batch 100:
// 4.87 MB read, 0.54 MB written, ~1.6 us at 3.35 TB/s). At the legacy shapes
// the launch and the host's work around it take longer than either bound.
//
// Design: one thread per pixel, consecutive threads on consecutive flat
// pixels (coalesced factor loads and output stores). The cores sit in shared
// memory, read alike by every thread (broadcast). The fold's state is sized
// at run time by the string's bonds and outputs, so it is kept in shared
// memory too, element k of thread t at state[k * T + t] (no bank conflicts),
// in two prefix and two suffix buffers used in turn; an element of m is
// computed where it is used, once per fold step. The wrapper picks T (a
// multiple of 32, at most 256) so the state fits in 227 KB.

#include <cuda_runtime.h>

#include <atomic>

#include "sbs_plan.cuh"

namespace {

using sbs::Lane;
using sbs::Plan;
using sbs::kMaxQc;

__global__ void sbs_fwd_kernel(const float* __restrict__ views,
                               const float* __restrict__ cores, float* __restrict__ out,
                               long long npix, const Plan p) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  float* cs = smem;
  float* state = smem + p.nelem;
  for (int k = threadIdx.x; k < p.nelem; k += T) cs[k] = cores[k];
  __syncthreads();
  const long long pix = static_cast<long long>(blockIdx.x) * T + threadIdx.x;
  if (pix >= npix) return;

  float* mine = state + threadIdx.x;
  Lane a{mine + p.pre_a * T, T}, a2{mine + p.pre_b * T, T};
  Lane u{mine + p.suf_a * T, T}, u2{mine + p.suf_b * T, T};
  float v[kMaxQc];

  // prefix: core 0's rows (l, r, o) are the state rows (b0, r, O)
  sbs::load_views(views, 0, p.qc, npix, pix, true, v);
  for (int row = 0; row < p.l[0] * p.r[0] * p.o[0]; ++row)
    a[row] = sbs::core_row_dot(cs + p.core_off[0], row, p.qc, v);
  int opre = p.o[0];
  for (int i = 1; i < p.mcut; ++i) {
    sbs::load_views(views, i, p.qc, npix, pix, true, v);
    sbs::fold_left(p, cs + p.core_off[i], p.o[i], p.l[i], p.r[i], opre, v, a, a2);
    const Lane t = a;
    a = a2;
    a2 = t;
    opre *= p.o[i];
  }

  // suffix from the delta(b0) seed
  sbs::write_seed(p.b0, u);
  int osuf = 1;
  for (int i = p.P - 1; i >= p.mcut; --i) {
    sbs::load_views(views, i, p.qc, npix, pix, true, v);
    sbs::fold_right(p, cs + p.core_off[i], p.o[i], p.l[i], p.r[i], osuf, v, u, u2);
    const Lane t = u;
    u = u2;
    u2 = t;
    osuf *= p.o[i];
  }

  // merge over (b0, r_m)
  const int rm = p.mcut < p.P ? p.l[p.mcut] : p.b0;
  for (int op = 0; op < opre; ++op)
    for (int q = 0; q < osuf; ++q) {
      float acc = 0.f;
      for (int b = 0; b < p.b0; ++b)
        for (int s = 0; s < rm; ++s)
          acc = fmaf(a[(b * rm + s) * opre + op], u[(s * p.b0 + b) * osuf + q], acc);
      out[static_cast<long long>(op * osuf + q) * npix + pix] = acc;
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
  err = cudaFuncSetAttribute(sbs_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sbs::kMaxSmemBytes);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// views (P, qc, npix) f32, cores the P (l*r*o, qc) matrices back to back f32,
// out (prod o, npix) f32, all contiguous on the current device; plan the
// Plan's fields as plan_ints ints; threads per block a multiple of 32. Launches
// on `stream` and does not synchronise. Returns cudaGetLastError() (0 on
// success).
extern "C" int dctn_sbs_fwd(const void* views, const void* cores, void* out,
                            const int* plan, int plan_ints, long long npix, int threads,
                            void* stream) {
  if (plan == nullptr || plan_ints != sbs::kPlanInts || npix < 1 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const int* src = plan;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < sbs::kPlanInts; ++i) dst[i] = src[i];
  const long long smem = 4LL * (p.nelem + static_cast<long long>(threads) * p.S);
  if (!sbs::plan_dims_ok(p) || smem > sbs::kMaxSmemBytes ||
      (npix + threads - 1) / threads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = ensure_smem_cap();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((npix + threads - 1) / threads);
  sbs_fwd_kernel<<<blocks, threads, static_cast<size_t>(smem),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(views), static_cast<const float*>(cores),
      static_cast<float*>(out), npix, p);
  return static_cast<int>(cudaGetLastError());
}
