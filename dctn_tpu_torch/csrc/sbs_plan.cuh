// The launch plan shared by the ConvSBS fold kernels (sbs_fwd.cu, sbs_bwd.cu)
// and the device helpers both use. The Python wrapper
// (dctn_tpu_torch/kernels/sbs_kernels.py, _launch_plan) fills the Plan as a
// flat array of ints in this field order.
//
// Per-pixel fold state lives in shared memory, element k of thread t at
// state[k * T + t] (T threads per block): consecutive threads touch
// consecutive banks, and every thread walks the same index sequence.

#pragma once

#include <cuda_runtime.h>

namespace sbs {

constexpr int kMaxCores = 16;
constexpr int kMaxQc = 16;
constexpr int kMaxSmemBytes = 227 * 1024;

struct Plan {
  int P;      // cores
  int qc;     // merged factor size q^C
  int b0;     // ring bond (1 for an open string)
  int mcut;   // merge position in [1, P]; P is the sequential fold
  int S;      // fold-state floats per thread
  int nelem;  // sum of l*r*o*qc over the cores
  int o[kMaxCores], l[kMaxCores], r[kMaxCores];
  int core_off[kMaxCores];  // each core's (l*r*o, qc) matrix in the flat buffer
  // forward buffers (offsets in floats per thread)
  int pre_a, pre_b, suf_a, suf_b;
  // backward buffers
  int lstate[kMaxCores];  // prefix after core i, i < mcut
  int tnext[kMaxCores];   // suffix that core i folds into, i >= mcut
  int suf, da_a, da_b, dt_a, dt_b;
  // backward: 1 where the d_core contraction's tiles and the staged g go to
  // a per-CTA scratch in device memory (the string's states leave no room
  // for them in shared memory), else 0
  int spill;
};

constexpr int kPlanInts = sizeof(Plan) / sizeof(int);

// The dims a kernel indexes with, checked before a launch: core and factor
// counts within the limits, a closed bond chain, the cores' offsets packed.
inline bool plan_dims_ok(const Plan& p) {
  if (p.P < 1 || p.P > kMaxCores || p.qc < 1 || p.qc > kMaxQc || p.b0 < 1 ||
      p.mcut < 1 || p.mcut > p.P || p.S < 1 || p.l[0] != p.b0)
    return false;
  int off = 0;
  for (int i = 0; i < p.P; ++i) {
    if (p.o[i] < 1 || p.l[i] < 1 || p.r[i] < 1 || p.core_off[i] != off) return false;
    if (p.r[i] != p.l[(i + 1) % p.P]) return false;
    off += p.l[i] * p.r[i] * p.o[i] * p.qc;
  }
  return off == p.nelem;
}

// one thread's slice of a state buffer
struct Lane {
  float* base;
  int stride;
  __device__ __forceinline__ float& operator[](int k) const { return base[k * stride]; }
};

// the functions below take a pixel's views in an array of N >= qc floats
template <int N>
__device__ __forceinline__ void load_views(const float* __restrict__ views, int core,
                                           int qc, long long npix, long long pix,
                                           bool active, float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    v[j] = (j < qc && active) ? views[(static_cast<long long>(core) * qc + j) * npix + pix]
                              : 0.f;
}

// m[row] = sum_j core[row, j] * v[j]: one element of core i's TT matrix at
// this pixel (the cores in shared memory, read alike by every thread)
template <int N>
__device__ __forceinline__ float core_row_dot(const float* core, int row, int qc,
                                              const float (&v)[N]) {
  const float* c = core + row * qc;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < qc) s = fmaf(c[j], v[j], s);
  return s;
}

// prefix fold: dst[(b, s, O, o)] = sum_rp src[(b, rp, O)] * m[(rp, s, o)],
// src rows (b0, l, opre), dst rows (b0, r, opre*o)
template <int N>
__device__ __forceinline__ void fold_left(const Plan& p, const float* core, int o, int l,
                                          int r, int opre, const float (&v)[N],
                                          const Lane& src, const Lane& dst) {
  const int n = p.b0 * r * opre * o;
  for (int k = 0; k < n; ++k) dst[k] = 0.f;
  for (int rp = 0; rp < l; ++rp)
    for (int s = 0; s < r; ++s)
      for (int oo = 0; oo < o; ++oo) {
        const float m = core_row_dot(core, (rp * r + s) * o + oo, p.qc, v);
        for (int b = 0; b < p.b0; ++b)
          for (int q = 0; q < opre; ++q)
            dst[((b * r + s) * opre + q) * o + oo] += src[(b * l + rp) * opre + q] * m;
      }
}

// suffix fold: dst[(b1, b, o, Q)] = sum_s m[(b1, s, o)] * src[(s, b, Q)],
// src rows (r, b0, osuf), dst rows (l, b0, o*osuf)
template <int N>
__device__ __forceinline__ void fold_right(const Plan& p, const float* core, int o, int l,
                                           int r, int osuf, const float (&v)[N],
                                           const Lane& src, const Lane& dst) {
  const int n = l * p.b0 * o * osuf;
  for (int k = 0; k < n; ++k) dst[k] = 0.f;
  for (int b1 = 0; b1 < l; ++b1)
    for (int s = 0; s < r; ++s)
      for (int oo = 0; oo < o; ++oo) {
        const float m = core_row_dot(core, (b1 * r + s) * o + oo, p.qc, v);
        for (int b = 0; b < p.b0; ++b)
          for (int q = 0; q < osuf; ++q)
            dst[((b1 * p.b0 + b) * o + oo) * osuf + q] += m * src[(s * p.b0 + b) * osuf + q];
      }
}

// the delta(b0) rows (s, b) that start the suffix: the ring closure
__device__ __forceinline__ void write_seed(int b0, const Lane& dst) {
  for (int s = 0; s < b0; ++s)
    for (int b = 0; b < b0; ++b) dst[s * b0 + b] = s == b ? 1.f : 0.f;
}

}  // namespace sbs
