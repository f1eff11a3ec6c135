// The formulas of the posterior glue's kernels, G1 and G2 (posterior_glue.cu).
//
// Exactness. Every f64 and f32 operation that the plain version rounds on
// its own is a round-to-nearest intrinsic (__dmul_rn, __dadd_rn, __ddiv_rn,
// __fmul_rn, ...), which nvcc never contracts into an FMA, in the plain
// version's order; the transcendental functions are libdevice's log, log1p,
// exp and f32 log1pf, expf, as torch's CUDA kernels call them (no fast-math
// flag).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace glue {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ double warp_sum(double v) {
  // A butterfly: every lane ends with the same sum (IEEE addition commutes).
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __dadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// torch.maximum / torch.amax: NaN wins, otherwise the larger.
__device__ __forceinline__ double nan_max(double a, double b) {
  return (isnan(a) || a > b) ? a : b;
}

// (a, ia) beats (b, ib) under torch.argmax's rule: NaN counts as the
// largest value, and of equal values (−inf included) the lower flat index
// — the first occurrence — wins. A strict order on distinct indices, so any
// reduction tree gives the same winner.
__device__ __forceinline__ bool better(double a, int ia, double b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

// ---------------------------------------------------------------------------
// G1's formulas: core/posterior.py logpro_constants, operation for operation
// ---------------------------------------------------------------------------

// One (o, c, frequency) term of ssq_c·ntot: |p|²·h·|ctf|² in f64, the f32
// inputs squared exactly and each product and sum rounded once.
__device__ __forceinline__ double mag2(float re, float im) {
  const double a = re, b = im;
  return __dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b));
}

// conv's DC term, Re(p₀₀·conj(ctf₀₀)), in f32 as the plain version rounds it
__device__ __forceinline__ float dc_term(float pr0, float pi0, float cr0, float ci0) {
  return __fadd_rn(__fmul_rn(pr0, cr0), __fmul_rn(pi0, ci0));
}

// What F0 and K take from one (o, c) pair alone.
struct PairConsts {
  float sc32;  // sum_c
  double ssc;  // ssq_c (f32-rounded, widened)
  double k_forlog, g, log_ssc, log_g;
};

__device__ __forceinline__ PairConsts pair_consts(float sc32, float ssc32, double ntot) {
  PairConsts q;
  q.sc32 = sc32;
  const double sc = sc32;
  q.ssc = ssc32;
  const double forlog = __dsub_rn(__dmul_rn(q.ssc, ntot), __dmul_rn(sc, sc));
  q.k_forlog = __dmul_rn(__dsub_rn(__dmul_rn(ntot, 0.5), 2.0),
                         log(__dmul_rn(__dsub_rn(ntot, 2.0), forlog)));
  q.g = __ddiv_rn(forlog, q.ssc);
  q.log_ssc = log(q.ssc);
  q.log_g = log(q.g);
  return q;
}

// What F0 and K take from one image alone: log ssr and, for normalised
// images, h = sr²/ssr.
struct ImageConsts {
  double log_ssr, hh;
};

__device__ __forceinline__ ImageConsts image_consts(float sr32, float ssr32) {
  const double sr = sr32, ssr = ssr32;
  return ImageConsts{log(ssr), __ddiv_rn(__dmul_rn(sr, sr), ssr)};
}

// One (o, c, i) entry: F0, K (−inf where the orientation is masked) and
// the u coefficients a_u = 2·sr·sc/f0 and b_u = (1/f0)·ntot in f32 (torch's
// scalar/tensor is a reciprocal and a product).
__device__ __forceinline__ void entry(const PairConsts& q, const ImageConsts& im, float sr32,
                                      float ssr32, double pri, bool live, int normalized,
                                      double ntot, double ln_ntot, double a_coef, float ntot32,
                                      double* f0_out, double* k_out, float* a_out,
                                      float* b_out) {
  const double ssr = ssr32;
  double f0v, log_f0;
  if (normalized) {
    // F0 = ssr·ssc·(g − h); log F0 = log ssr + log ssc + log g + log1p(−h/g),
    // the last in f32 of the f32-rounded ratio, as the plain version.
    f0v = __dmul_rn(__dmul_rn(ssr, q.ssc), __dsub_rn(q.g, im.hh));
    const float corr = log1pf(-__double2float_rn(__ddiv_rn(im.hh, q.g)));
    log_f0 = __dadd_rn(__dadd_rn(__dadd_rn(im.log_ssr, q.log_ssc), q.log_g), (double)corr);
  } else {
    // the DC-capable point F0 = ntot·ssr·ssc (the hybrid's f64 u)
    f0v = __dmul_rn(__dmul_rn(ntot, ssr), q.ssc);
    log_f0 = __dadd_rn(__dadd_rn(ln_ntot, im.log_ssr), q.log_ssc);
  }
  const double kv = __dsub_rn(__dadd_rn(__dmul_rn(a_coef, log_f0), q.k_forlog), pri);
  *f0_out = f0v;
  *k_out = live ? kv : -(double)INFINITY;
  const float f0_32 = __double2float_rn(f0v);
  *a_out = __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, sr32), q.sc32), f0_32);
  *b_out = __fmul_rn(__frcp_rn(f0_32), ntot32);
}

// ---------------------------------------------------------------------------
// G2's formulas
// ---------------------------------------------------------------------------

struct MergeArgs {
  const float* m;  // (O, C, I) f32 varying max, or null: repair from ccs
  const float* se;
  const int* ds;
  const float* ccs;
  const double* k;
  const double* f0;
  const float* sum_c;
  const float* ssq_c;
  const float* sum_ref;
  const int* disp;
  const long long* orient_offset;
  const long long* ang_offset;
  int O, C, I, D, n_cols;
  double ntot, a_coef;
  double* total;
  double* cnst;
  int* best_orient;
  int* best_conv;
  int* best_cx;
  int* best_cy;
  double* best_norm;
  double* best_mu;
  double* ang_total;  // (I, n_cols) or null
  double* ang_const;
  double* m_out;  // (O, C, I) f64 or null: the varying max used
};

// The varying max of pair oc for image i: the given f32 m (a DC-dominated
// bank's), or refine_varying_max: u = (2·sr·sc·cc − ntot·cc·cc)/F0,
// A·log1p(u), one f64 log1p.
__device__ __forceinline__ double varying_max(const MergeArgs& a, int oc, int i, size_t at) {
  if (a.m != nullptr) return a.m[at];
  const double cc = a.ccs[at];
  const double t = __dmul_rn(__dmul_rn(__dmul_rn(2.0, (double)a.sum_ref[i]), (double)a.sum_c[oc]), cc);
  const double u = __ddiv_rn(__dsub_rn(t, __dmul_rn(__dmul_rn(a.ntot, cc), cc)), a.f0[at]);
  return __dmul_rn(a.a_coef, log1p(u));
}

// se·expf(f32(lm − mx)) in f32, 0 where the difference is NaN (−inf − −inf:
// a masked pair), widened for an f64 sum
__device__ __forceinline__ double weighted(float se, double lm, double mx) {
  const float diff = __double2float_rn(__dsub_rn(lm, mx));
  const float ex = isnan(diff) ? 0.f : expf(diff);
  return (double)__fmul_rn(se, ex);
}

// The online log-sum-exp update of one (total, const) accumulator, whose
// values were (t0, c0), with a block's (sum, max): a fully masked block
// (max −inf, sum 0) leaves it as it was (exp(0) = 1).
__device__ __forceinline__ void lse_fold(double t0, double c0, double sum, double mx,
                                         double* total, double* cnst) {
  const double nc = nan_max(c0, mx);
  *total = __dadd_rn(__dmul_rn(t0, exp(__dsub_rn(c0, nc))), __dmul_rn(sum, exp(__dsub_rn(mx, nc))));
  *cnst = nc;
}

// The argmax tuple of image i from pair `best` (bioem_algorithm.h:106-111),
// from that pair's sum_c, ssq_c, cc and flat displacement d, the
// displacements read from `disp` (a.disp or a copy of it).
__device__ __forceinline__ void write_tuple(const MergeArgs& a, int best, int i, double sc,
                                            double ssc, double cc, int d, const int* disp) {
  const int os = best / a.C, cs = best - os * a.C;
  const double sr = a.sum_ref[i];
  const double denom = __dsub_rn(__dmul_rn(sc, sc), __dmul_rn(ssc, a.ntot));
  a.best_norm[i] = -__ddiv_rn(__dadd_rn(__dmul_rn(-sc, sr), __dmul_rn(a.ntot, cc)), denom);
  a.best_mu[i] = -__ddiv_rn(__dadd_rn(__dmul_rn(-sc, cc), __dmul_rn(ssc, sr)), denom);
  a.best_orient[i] = (int)(*a.orient_offset + os);
  a.best_conv[i] = cs;
  a.best_cx[i] = -disp[d / a.D];
  a.best_cy[i] = -disp[d % a.D];
}

}  // namespace glue
