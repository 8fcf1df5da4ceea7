// ConvSBS string forward for Hopper (sm_90a): the tensor-train fold of one
// string over the (P, qc, npix) stack of merged window factors.
//
// Replaces the TPU kernels _sbs_fwd_mim_kernel_factory (K10,
// dctn_tpu/pallas/sbs_pallas.py:430) and _sbs_fwd_kernel_factory (K12's
// forward, :256). Per pixel p, with core i's TT matrix
//   M_i(p)[(l, r, o)] = sum_j core_i[(l, r, o), j] * view_i[j, p],
// the output is out[o_0, ..., o_{P-1}] = trace(M_0 M_1 ... M_{P-1}) over the
// bonds, the ring bond b0 closing the trace (b0 = 1 for an open string).
// The two TPU kernels compute this one function in two orders (K10 meets in
// the middle at a merge position, K12 folds from left to right); they differ
// only in rounding.
//
// What bounds it on this card: nothing of the card's peaks. The work per
// pixel is a few hundred to a few thousand FMAs on bonds <= 8, the bytes are
// the factors read once and the output written once (a layer-0 string of the
// legacy model at batch 100: 4.87 MB read, 0.54 MB written, ~1.6 us at
// 3.35 TB/s; its FMAs ~0.5 us at 67 TFLOP/s). The kernels are bound by
// latency: each pixel is a chain of dependent fold steps, and at batch 100 a
// launch is about one wave (the register route: 9-12 us a launch there, 2.6-
// 3.8x its bound at batch 512 on an H100, PERF.md §6). Tensor cores do
// not apply: a fold step is a product (pixels * b0) x (B * qc) by
// (B * qc) x B with N = B = 4 at the legacy shapes and K = 8 or 16; mma needs
// N >= 8, and so short a K leaves nothing to amortise a fragment's build.
//
// Two routes; the wrapper (kernels/sbs_kernels.py, _fwd_route) picks one
// from the string's shape alone.
//
// The register route (sbs_fwd_reg_kernel) takes every string with at most
// one core of o > 1 (the output core c; the middle core where every o is 1),
// bonds <= 8, b0 <= 4, qc <= 16, P <= 16 and its staged cores within the
// shared memory. It folds both ends toward the output core, so the outputs
// never travel through the fold:
//   X_pre = M_0 ... M_{c-1}                 (b0 x l_c),
//   X_suf = (M_{c+1} ... M_{P-1})^T         (b0 x r_c),
//   W[s, t] = sum_b X_pre[b, s] * X_suf[b, t],
//   out[o] = sum_j view_c[j] * sum_{s,t} core_c[(s, t, o), j] * W[s, t].
// The states are registers: X is a b0 x B matrix with the bonds padded with
// zeros to a compile-time B (4 or 8) and b0 to B0 (1, 2 or 4); a step
// X <- X M_i builds M_i one row at a time from the cores in shared memory,
// which every thread of a half-chain reads at the same address (a broadcast),
// as float4, with every loop unrolled (qc under a guarded unroll to KQ).
// The suffix folds the transposed matrices, so both half-chains run the same
// code: the CTA stages each core as qc B x B slabs, (j, s, t) for the
// prefix's cores and (j, t, s) for the suffix's, zeros in the padding; the
// output core as (o, j, s, t). One lane takes a pixel and folds its two
// half-chains in one loop, a step of each in turn (two independent chains
// of dependent steps), their views a step ahead in registers where q^C <= 4.
// Consecutive lanes are consecutive flat pixels, so the views are read and
// the outputs written coalesced, 128 bytes a row and instruction. The cores
// are read from where the caller keeps them (no copy into one buffer). On the
// H100 this layout was measured against three others (the two half-chains
// on neighbouring lanes joined by one __shfl_xor_sync, two pixels a lane, and
// both): it was the fastest at the ring shapes and near it at the rest, and
// it never spills (PERF.md §6). The family (mcut) does not change the
// arithmetic: K10 and K12's forward are this one kernel on this route.
//
// The shared-memory route (sbs_fwd_kernel) takes every other string the
// kernels take: one thread per pixel, the cores in shared memory read alike
// by every thread; the fold's state sized at run time by the string's bonds
// and outputs, so it is kept in shared memory too, element k of thread t at
// state[k * T + t] (no bank conflicts), in two prefix and two suffix buffers
// used in turn; an element of m is computed where it is used, once per fold
// step. With a merge position mcut it folds cores 0..mcut-1 as prefix states
// A[(b0, r, O_pre)] and cores P-1..mcut from delta(b0) as suffix states
// U[(l, b0, O_suf)], out[(O_pre, O_suf)] = sum_{b0, r_m} A * U; mcut = P is the
// sequential fold, closed by the ring trace. The wrapper picks T (a multiple
// of 32, at most 256) so the state fits in 227 KB.

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

// ---------------------------------------------------------------------------
// the register route

constexpr int kRegThreads = 256;

// The register route's plan, filled by the wrapper (_fwd_route) as ints in
// this order: the output core c and its o, the compile-time shape the string
// is padded to (B, B0, KQ), and the bonds.
struct RegPlan {
  int P, qc, b0, c, oc, B, B0, KQ;
  int l[sbs::kMaxCores], r[sbs::kMaxCores];
};

constexpr int kRegPlanInts = sizeof(RegPlan) / sizeof(int);

// each core's (l*r*o, qc) matrix, where the caller keeps it: no copy into
// one buffer before the launch. The kernel indexes both structs by core at
// run time; as __grid_constant__ parameters they are read where the launch
// put them, with no copy to each thread's stack.
struct CorePtrs {
  const float* p[sbs::kMaxCores];
};

// the shared memory slabs: core i's qc B x B matrices at slab_of(...) * qc * B * B,
// for the output core c with oc outputs
__device__ __forceinline__ int slab_of(int i, int c, int oc) { return i <= c ? i : i + oc - 1; }

inline long long reg_smem_bytes(const RegPlan& p) {
  return 4LL * (p.P - 1 + p.oc) * p.qc * p.B * p.B;
}

// X <- X N, N = sum_j v[j] * slab[j] (B x B, row a at slab[(j * B + a) * B]);
// N is built a row at a time
template <int B, int B0, int KQ>
__device__ __forceinline__ void fold_step(const float4* __restrict__ slab, int qc,
                                          const float (&v)[KQ], float (&X)[B0][B]) {
  float Y[B0][B];
#pragma unroll
  for (int b = 0; b < B0; ++b)
#pragma unroll
    for (int t = 0; t < B; ++t) Y[b][t] = 0.f;
#pragma unroll
  for (int a = 0; a < B; ++a) {
    float row[B];
#pragma unroll
    for (int t = 0; t < B; ++t) row[t] = 0.f;
#pragma unroll
    for (int j = 0; j < KQ; ++j) {
      if (j < qc) {
#pragma unroll
        for (int t4 = 0; t4 < B / 4; ++t4) {
          const float4 w = slab[(j * B + a) * (B / 4) + t4];
          row[4 * t4 + 0] = fmaf(v[j], w.x, row[4 * t4 + 0]);
          row[4 * t4 + 1] = fmaf(v[j], w.y, row[4 * t4 + 1]);
          row[4 * t4 + 2] = fmaf(v[j], w.z, row[4 * t4 + 2]);
          row[4 * t4 + 3] = fmaf(v[j], w.w, row[4 * t4 + 3]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < B0; ++b)
#pragma unroll
      for (int t = 0; t < B; ++t) Y[b][t] = fmaf(X[b][a], row[t], Y[b][t]);
  }
#pragma unroll
  for (int b = 0; b < B0; ++b)
#pragma unroll
    for (int t = 0; t < B; ++t) X[b][t] = Y[b][t];
}

template <int B, int B0, int KQ>
__global__ void __launch_bounds__(kRegThreads)
    sbs_fwd_reg_kernel(const float* __restrict__ views, const __grid_constant__ CorePtrs cores,
                       float* __restrict__ out, long long npix,
                       const __grid_constant__ RegPlan p) {
  constexpr int BB = B * B;
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);
  const int qc = p.qc, P = p.P, c = p.c;
  const int slab = qc * BB;

  // stage the cores as B x B slabs, zeros in the padding
  const int nstage = (P - 1 + p.oc) * slab;
  for (int k = threadIdx.x; k < nstage; k += blockDim.x) {
    const int blk = k / slab, rem = k - blk * slab;
    const int j = rem / BB, a = (rem % BB) / B, b = rem % B;
    const int i = blk < c ? blk : (blk < c + p.oc ? c : blk - p.oc + 1);
    const int o = i == c ? blk - c : 0;
    const int s = i > c ? b : a, t = i > c ? a : b;  // the suffix's slabs transposed
    float x = 0.f;
    if (s < p.l[i] && t < p.r[i])
      x = cores.p[i][((s * p.r[i] + t) * (i == c ? p.oc : 1) + o) * qc + j];
    cs[k] = x;
  }
  __syncthreads();

  const long long pix = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = pix < npix;

  // the output core's views, loaded now, used at the end
  float vc[KQ];
  sbs::load_views(views, c, qc, npix, pix, live, vc);

  // fold: half-chain 0 the prefix (cores 0..c-1), 1 the transposed suffix
  // (cores P-1..c+1); both start from the identity on the first b0 rows
  const int len[2] = {c, P - 1 - c};
  float X[2][B0][B];
#pragma unroll
  for (int d = 0; d < 2; ++d)
#pragma unroll
    for (int b = 0; b < B0; ++b)
#pragma unroll
      for (int t = 0; t < B; ++t) X[d][b][t] = (b == t && b < p.b0) ? 1.f : 0.f;
  const int steps = len[0] > len[1] ? len[0] : len[1];
  // a step's views are loaded a step ahead where they take at most 16
  // registers (q^C <= 4); wider ones are loaded at their step, which keeps
  // every instantiation free of spills
  constexpr bool kAhead = 2 * KQ <= 16;
  constexpr int ahead = kAhead ? 1 : 0;
  float v[2][KQ];
  if (kAhead) {
    sbs::load_views(views, 0, qc, npix, pix, live, v[0]);
    sbs::load_views(views, P - 1, qc, npix, pix, live, v[1]);
  }
  for (int k = 0; k < steps; ++k) {
    float vn[2][KQ];
#pragma unroll
    for (int d = 0; d < 2; ++d)
      sbs::load_views(views, d == 0 ? k + ahead : P - 1 - k - ahead, qc, npix, pix,
                      live && k + ahead < len[d], kAhead ? vn[d] : v[d]);
#pragma unroll
    for (int d = 0; d < 2; ++d)
      if (k < len[d]) {
        const int core = d == 0 ? k : P - 1 - k;
        fold_step<B, B0, KQ>(smem4 + slab_of(core, c, p.oc) * (slab / 4), qc, v[d], X[d]);
      }
    if (kAhead) {
#pragma unroll
      for (int d = 0; d < 2; ++d)
#pragma unroll
        for (int j = 0; j < KQ; ++j) v[d][j] = vn[d][j];
    }
  }

  // join: W[s][t] = sum_b pre[b][s] * suf[b][t]
  float W[B][B];
#pragma unroll
  for (int s = 0; s < B; ++s)
#pragma unroll
    for (int t = 0; t < B; ++t) {
      float w = 0.f;
#pragma unroll
      for (int b = 0; b < B0; ++b) w = fmaf(X[0][b][s], X[1][b][t], w);
      W[s][t] = w;
    }

  // out[o] = sum_j vc[j] * sum_{s,t} core_c[o][j][s][t] * W[s][t]
  const float4* oc_slabs = smem4 + slab_of(c, c, p.oc) * (slab / 4);
  for (int o = 0; o < p.oc; ++o) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < KQ; ++j) {
      if (j < qc) {
        const float4* w4 = oc_slabs + (o * qc + j) * (BB / 4);
        float dot = 0.f;
#pragma unroll
        for (int st4 = 0; st4 < BB / 4; ++st4) {
          const float4 w = w4[st4];
          const int s = (4 * st4) / B, t = (4 * st4) % B;
          dot = fmaf(w.x, W[s][t + 0], dot);
          dot = fmaf(w.y, W[s][t + 1], dot);
          dot = fmaf(w.z, W[s][t + 2], dot);
          dot = fmaf(w.w, W[s][t + 3], dot);
        }
        acc = fmaf(vc[j], dot, acc);
      }
    }
    if (live) out[static_cast<long long>(o) * npix + pix] = acc;
  }
}

constexpr int kMaxDevices = 64;

// lets `kernel` take up to kMaxSmemBytes of dynamic shared memory, once per
// device; `done` is the kernel's own flags
template <typename Kernel>
cudaError_t ensure_smem_cap(Kernel kernel, std::atomic<bool> (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sbs::kMaxSmemBytes);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

template <int B, int B0, int KQ>
cudaError_t launch_reg(unsigned blocks, long long smem, cudaStream_t stream, const void* views,
                       const CorePtrs& cores, void* out, long long npix, const RegPlan& p) {
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t err = ensure_smem_cap(sbs_fwd_reg_kernel<B, B0, KQ>, done);
  if (err != cudaSuccess) return err;
  sbs_fwd_reg_kernel<B, B0, KQ><<<blocks, kRegThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const float*>(views), cores, static_cast<float*>(out), npix, p);
  return cudaGetLastError();
}

template <int B, int B0>
cudaError_t launch_reg_qc(unsigned blocks, long long smem, cudaStream_t stream,
                          const void* views, const CorePtrs& cores, void* out, long long npix,
                          const RegPlan& p) {
  return p.KQ == 4 ? launch_reg<B, B0, 4>(blocks, smem, stream, views, cores, out, npix, p)
                   : launch_reg<B, B0, kMaxQc>(blocks, smem, stream, views, cores, out, npix, p);
}

template <int B>
cudaError_t launch_reg_b0(unsigned blocks, long long smem, cudaStream_t stream,
                          const void* views, const CorePtrs& cores, void* out, long long npix,
                          const RegPlan& p) {
  switch (p.B0) {
    case 1: return launch_reg_qc<B, 1>(blocks, smem, stream, views, cores, out, npix, p);
    case 2: return launch_reg_qc<B, 2>(blocks, smem, stream, views, cores, out, npix, p);
    default: return launch_reg_qc<B, 4>(blocks, smem, stream, views, cores, out, npix, p);
  }
}

// The register route's plan as the kernel indexes it: every core but c of
// o = 1, bonds within B, the chain closed, b0 within B0, the padded shape one
// of the instantiated ones, and the staged cores within the shared memory.
bool reg_plan_ok(const RegPlan& p) {
  if (p.P < 1 || p.P > sbs::kMaxCores || p.qc < 1 || p.qc > p.KQ || p.b0 < 1 ||
      p.b0 > p.B0 || p.c < 0 || p.c >= p.P || p.oc < 1 || (p.B != 4 && p.B != 8) ||
      (p.B0 != 1 && p.B0 != 2 && p.B0 != 4) || (p.KQ != 4 && p.KQ != kMaxQc) ||
      p.l[0] != p.b0 || reg_smem_bytes(p) > sbs::kMaxSmemBytes)
    return false;
  for (int i = 0; i < p.P; ++i)
    if (p.l[i] < 1 || p.l[i] > p.B || p.r[i] < 1 || p.r[i] > p.B || p.r[i] != p.l[(i + 1) % p.P])
      return false;
  return true;
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
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t err = ensure_smem_cap(sbs_fwd_kernel, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((npix + threads - 1) / threads);
  sbs_fwd_kernel<<<blocks, threads, static_cast<size_t>(smem),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(views), static_cast<const float*>(cores),
      static_cast<float*>(out), npix, p);
  return static_cast<int>(cudaGetLastError());
}

// The register route: views (P, qc, npix) f32, cores a host array of the P
// cores' device pointers, each core's (l*r*o, qc) matrix f32, out (prod o,
// npix) f32, all contiguous on the current device; plan the RegPlan's fields
// as plan_ints ints. Launches on `stream` and does not synchronise. Returns
// cudaGetLastError() (0 on success).
extern "C" int dctn_sbs_fwd_reg(const void* views, const void* const* cores, void* out,
                                const int* plan, int plan_ints, long long npix, void* stream) {
  if (plan == nullptr || cores == nullptr || plan_ints != kRegPlanInts || npix < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  RegPlan p;
  const int* src = plan;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < kRegPlanInts; ++i) dst[i] = src[i];
  if (p.P < 1 || p.P > sbs::kMaxCores) return static_cast<int>(cudaErrorInvalidValue);
  CorePtrs ptrs{};
  for (int i = 0; i < p.P; ++i) {
    if (cores[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    ptrs.p[i] = static_cast<const float*>(cores[i]);
  }
  if (!reg_plan_ok(p) || (npix + kRegThreads - 1) / kRegThreads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((npix + kRegThreads - 1) / kRegThreads);
  const long long smem = reg_smem_bytes(p);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      p.B == 4 ? launch_reg_b0<4>(blocks, smem, s, views, ptrs, out, npix, p)
               : launch_reg_b0<8>(blocks, smem, s, views, ptrs, out, npix, p);
  return static_cast<int>(err);
}
